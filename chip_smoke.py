#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  ``python3 chip_smoke.py``

Phases (one JSON line each; any failure is an uncaught exception):

  env          torch / CUDA / nvcc versions, the card's name and power limit
  build        builds the CUDA kernels from ``src/repro_torch/kernels/csrc``
  kernels      every kernel against its plain PyTorch version on the card,
               bit-identical (the scan within a float32 tolerance), timed with
               CUDA events beside its bound and on a cold L2; the three VMM
               kernels also at their tile edges, ragged N and K and extreme
               codes or cells (the fast one past its int32 fold too, and
               timed at every projection and head shape of the three dense
               configs, of kimi-k2's rank share, of deepseek-v2's MoE FFN
               and its rank slices, of jamba's share and of musicgen-large
               and pixtral-12b; the paper and noisy ones
               at K = 4096 and 14336), the
               scan at ragged dh, dh = 2048, 5 and 9 batch rows and one head,
               each scan case with the launch plan it ran; the scan's saving
               forward (against the serving kernel and, its planes, the plain
               version) and its backward kernel (against the plain reverse
               loop on the same planes: g, carries, dR) at the xlstm train
               shape, one row of 48, the reduced dh 32, 9 rows, dh 100 and
               2048, in bf16 and float32
  planned_datapaths  the planned divide-and-conquer datapaths (Karatsuba
               levels 1 and 2, Strassen) at the main-path shapes, M = 4 and
               32: output codes equal to the fast kernel's, with TF32 allowed
               too, timed beside the fast kernel and a float64 matmul of the
               same codes; one planned noisy projection equal to the noisy
               kernel's unplanned one
  cpu_vs_card_projections  a reduced chip programmed on the CPU, carried to
               the card through the store: every projection bit-equal
               (ideal, paper-datapath, noisy and planned chips)
  serve_ideal  smollm-360m at full width, 4 of its 32 layers
               (SERVE_CUT_LAYERS: the script's time limit), served by
               ``ServingEngine`` from an ideal programmed chip (fast kernel),
               incl. a store save -> restore round trip
  serve_ideal_paper_datapath  the same from a ``fast=False`` chip under the
               adaptive ADC (the paper datapath, paper_mma_kernel)
  serve_noisy  the same from a chip programmed with stuck cells and
               programming variation (noisy kernel)
  serve_planned  the same from a chip programmed under
               ``planner.plan_model`` (Karatsuba level 2 on every
               projection): no VMM kernel runs, tokens and one prompt's
               logits equal to the ideal chip's, and the saved chip passes
               ``verify_store`` before it is restored
  serve_planned_repaired  the planned chip on a device with stuck cells
               (NOISY_DEVICE): ``plan_model(device=...)`` provisions spare
               columns, the repair planner programs them, and every projection
               serves on the noisy kernel (25 x 38 launches asserted, no planned
               call); the repair totals, the repair planning's seconds apart
               from the programming's, and the logits' rel-L2 to the
               plain-matmul model (printed, not gated)
  repair_recovery  a 2-layer full-width copy on RECOVERY_DEVICE: logits MSE
               of a stuck-free chip, a faulty one without spares and one with
               the plan's spares; ``recovered_frac`` > 0 asserted; and one
               repaired 960 x 5120 slab programmed on the card and on the CPU
               from the same fields, plan and cells ``torch.equal``
  lifecycle    smollm-360m at full width, 4 layers, on LIFECYCLE_DEVICE, mid
               run: age (the captured tick and prefills dropped and captured
               again, 3 replayed ticks bit-equal to eager on the aged chip,
               the next admission's prefill ``torch.equal`` to an eager one,
               the health monitor's worst layer up), compensate (worst down,
               >= 0.5 of the probe MSE recovered), refresh in memory (the
               fresh program; the run's tokens those of an uninterrupted
               run); then ``refresh(directory)`` twice on a 2-layer copy
               (slots A, B), each dropping the prefill graphs
  serve_xlstm  xlstm-350m at full width and depth (24 layers, mLSTM / sLSTM)
               from an ideal programmed chip: the tied head on the fast
               kernel, every sLSTM recurrence on the scan kernel (12 launches
               per forward), incl. a store save -> restore round trip
  serve_gemma2, serve_minitron, serve_starcoder2  gemma2-9b (post-norm
               blocks, local / global attention, softcaps, a scaled
               embedding), minitron-4b (untied head) and starcoder2-3b at full
               width, 4 layers each (SERVE_CUT_LAYERS), from ideal chips the
               engine programs: 25 fast-kernel launches a forward (6 a layer
               + the head),
               asserted, and no other kernel; the logits within each config's
               rel-L2 gate of the plain-matmul model (``REL_L2_MAX``); a store
               save -> ``verify_store`` -> restore round trip on a copy of the
               chip cut to 2 layers at full width (the full gemma2-9b store
               would be 37 GB of npz)
               Every serve phase runs its decode ticks by replaying the
               pool's captured CUDA graph (``graph_replays`` = ``decode_ticks``,
               ``capture_seconds``) and an attention model's prefills by
               replaying its bucket's captured graph (``prefill_graphs``: the
               buckets captured, ``prefill_capture_seconds`` and
               ``prefill_pool_bytes`` of each, ``prefill_replays`` = the
               admissions); ``prefill_seconds`` times the admissions that
               replayed (each: the prefill and the copy into the slot) apart
               from the ticks, ``capturing_admission_seconds`` those that
               captured.  xlstm's prefills, at each prompt's exact length,
               stay eager.
  serve_kimi   kimi-k2-1t-a32b as rank 0 of an 8-way expert-parallel
               deployment (experts 0-47 of 384; router, attention, shared
               expert and head replicated; the other ranks' experts and the
               psum over ranks are not part of it) at full width, cut to its
               dense layer and 2 MoE layers, from an ideal chip: every
               projection on the fast kernel, one launch an expert's
               projection (311 a forward, derived from the config and
               asserted), the logits' rel-L2 to the plain-matmul model of
               the same share gated < 1 (a broken-datapath check) with each
               MoE layer's routing agreement, peak memory, and a store round
               trip on a copy cut to the dense layer and one MoE layer (a
               4-D expert-bank artifact), then tick_profile_kimi,
               graph_vs_eager_kimi, prefill_vs_eager_kimi
  moe_expert_chips  one full-width kimi-k2 MoE FFN of 8 experts (the rank
               share of EP48) programmed on NOISY_DEVICE with one chip
               identity an expert, at 4 and 32 tokens: each noisy-kernel
               call equal to its plain version, a CUDA-graph replay equal to
               eager; one slab on two identities differs, on expert 0's
               reproduces the bank's
  moe_dispatch_card_vs_cpu  routing, slot tables and the combine from the
               same router logits (on a grid, with ties) on the card and the
               CPU: equal, at 4 and 256 tokens, with drops
  serve_jamba  jamba-v0.1-52b as rank 0 of a 4-way expert-parallel
               deployment (experts 0-3 of each MoE layer's 16, top 2, no
               shared expert) at full width, its 8-layer period once (7 mamba
               blocks, 1 attention block, 4 dense and 4 MoE FFNs), random bf16
               weights, an ideal chip: 65 K1 launches a forward (attention,
               FFNs, router, experts, head) asserted, each at a (K, N) the
               kernels phase holds (the 28 mamba matmuls a forward stay
               digital),
               each prompt prefilled eagerly at its exact length with its
               first token from the prefill, the tick captured with the mamba
               state beside the attention cache; the logits' rel-L2 to the
               plain-matmul model of the same share < 1 with the routing
               agreement, and < JAMBA_FORCED_REL_L2_MAX to it routed as the
               chip routed; the logits torch.equal to the same forward's with
               K1's plain version in every launch; layer 0's mamba block card
               vs CPU (float32, prefill
               then 4 decode steps, JAMBA_MAMBA_CPU_GATE); a store round trip
               on a copy cut to the period's first 4 positions; then
               tick_profile_jamba, tick_mamba_jamba (the mamba blocks' decode
               step replayed alone: no kernel of ours), tick_classes_jamba
               (busy ms a tick: K1, the mamba blocks, the rest as a difference
               of the two windows) and graph_vs_eager_jamba
  serve_musicgen  musicgen-large (an embedding front end: precomputed
               frame embeddings in place of tokens) at full width, 24 of its
               48 layers (EMBED_LAYERS: the script's time limit),
               random bf16 weights, an ideal chip that ``ServingEngine``
               programs and checks (its ``submit`` refuses a frame prompt and
               a token prompt, as the reference's engine fails on them):
               4 seeded 32-frame prompts, each prefilled alone into its slot
               of a pool cache, then 16 decode steps of the pool, each fed
               the next frame, through the model's ``prefill`` and
               ``decode_step``; 145 K1 launches a forward asserted, each at
               an (M, K, N) the kernels phase holds; the logits of every
               served position ``torch.equal`` to the same run with K1's
               plain version in every launch and within EMBED_REL_L2_MAX of
               the plain-matmul model's; the digital serving within
               EMBED_TEACHER_REL_L2_MAX of a teacher-forced forward; prefill
               and step ms, programming s, peak GB; a store round trip on a
               2-layer cut (the same logits); tick_profile_musicgen-large
               (K1's share of busy time over 3 decode steps)
  serve_pixtral  the same for pixtral-12b at full width and vocabulary, 4 of
               its 40 layers, 8 decode steps: 25 K1 launches a forward
  moe_ranks_deepseek  deepseek-v2's MoE FFN at published widths (160 experts
               top 6, 2 shared, d_model 5120, expert d_ff 1536; one layer,
               bf16 params, the router x5.59: the logit spread of the
               reference's x100 at d_model 16) on an ideal chip: a one-device
               process programs it, serves a decode (4 x 1) and a prefill
               (1 x 32) input and saves the 15.3 GB store with the EP
               sharding of a (1, 4) mesh recorded; then 4 rank processes on
               the card (gloo; every CUDA operand through the card's
               mailboxes, none staged through host memory) restore their slices with ``mesh=`` and run EP (decode,
               prefill) and all-to-all (prefill) on a (1, 4) mesh, expert-TP
               (decode) on a (2, 2) mesh from the same store laid out anew;
               each body on the chip (float32 and bf16 activations) and
               digitally (float32): K1 launches a rank asserted (124 EP, 244
               expert-TP), each at a shape the kernels phase holds; every
               digital body and EP on the chip within 5e-3 of the one-device
               run; every chip run within DEEPSEEK_CHIP_GATE of the digital
               run routed as it routed (router logits and output), and three
               planted faults (zeroed colsums, another rank's banks under
               expert-TP and all-to-all) outside it; spawn / restore /
               forward seconds, peak GB a rank, the collectives' wire bytes
  serve_deepseek  deepseek-v2-236b served whole at published widths, cut to
               depth 2 (its dense layer and its first MoE layer), random
               bf16 weights, an ideal chip, in a process of its own:
               serve_phase's traffic (6 x 16, max_batch 4, max_seq 256,
               prompts of at most 32 tokens) through multi-head latent
               attention and the MoE FFN, 493 K1 launches a forward
               asserted, the tick and the bucket-32 prefill captured; the
               store saved, verified, restored and serving the same
               tokens; layer 0's MLA block on the card against the CPU
               (float32, crossbar off, <= 1e-5); the logits' rel-L2 to the
               plain-matmul model < 1; then tick_profile_deepseek (busy time
               split into K1, the MLA einsums and the rest),
               graph_vs_eager_deepseek, prefill_vs_eager_deepseek (bucket
               32).  It saves the chip and the bf16 weights for the ranks
               and serves and teacher-forces their requests
  serve_deepseek_ranks  4 gloo rank processes on the card, each a
               ``ServingEngine(mesh=, restore_artifacts=)`` of its slices of
               that store and its slices of the memory-mapped weights, on an
               ``ep_only`` (1, 4) and an ``expert_tp`` (2, 2) mesh: 4
               requests x 8 tokens (identical on every rank; EP's the one
               device's where the margins say they must be), teacher-forced
               logits against one device's (EP on the chip within
               DEEPSEEK_LOGITS_GATE; EP digitally and expert-TP digitally,
               uncapped and routed as one device routed, within
               DEEPSEEK_DIGITAL_GATE; expert-TP's own routing alike to one
               device's on DEEPSEEK_ROUTED_ALIKE_MIN of the rows;
               expert-TP on the chip printed), a planted swap of two
               ranks' bank slices outside the chip gate, 133 / 253 K1
               launches a forward of the engine's serving run on each rank
               (the kernels line counts that run; the teacher-forced and
               planted runs' launches are printed apart), the
               collectives (none staged through host memory)
  serve_launcher  ``python -m repro_torch.launch.serve --arch
               deepseek-v2-236b --reduced --crossbar`` as a user runs it:
               exit 0, its lines parsed
  Every K1 launch of the deepseek phases is at an (M, K, N) that the
  kernels phase holds (DEEPSEEK_SHAPES).
  tick_profile_*  three steady decode ticks of each chip under torch.profiler
               (ideal, paper, noisy, planned, xlstm, gemma2, minitron,
               starcoder2, kimi), and 24 ticks of serve_traffic's mix (traffic):
               device busy time and idle share, launches per tick, the
               heaviest kernels, and each of our kernels' device time and
               calls a tick, held equal to the launches the window added to
               the wrappers' counters
  graph_vs_eager_*  12 ticks of a full pool by replay and, alternating,
               eagerly on a clone of the cache: logits bit-equal every tick,
               caches after the last; both tick medians and a replay's
               device span
  prefill_vs_eager_*  (ideal, paper, noisy, planned, gemma2, kimi) admissions at
               buckets 32, 64, 128 and 256 (max_seq 256) through the
               runner's prefill graph and, alternating, eagerly (a fresh
               one-slot cache, the prefill, the copy into a slot): logits,
               the one-slot cache and the slot ``torch.equal``, for a full
               bucket's prompt and then the bucket's shortest, twice; both
               admission medians, a replay's device span, each capture's
               seconds and pool bytes
  The traffic tier, after tick_profile_ideal on the same chip (xlstm's after
  tick_profile_xlstm):
  serve_traffic_exact  smollm-360m at full width, 4 layers, from an ideal
               chip (max_batch 4, max_seq 256): the short_long_full mix's 32
               requests submitted up front through the slot-loop engine, then
               through ``ContinuousBatchingScheduler`` on its runner (default
               pool; the scheduler first, so its first admission of each
               bucket captures), then the slot-loop engine: tokens equal, one
               decode capture and a replay a decode tick, a prefill replay an
               admission, the fast kernel on every projection of every
               prefill and tick
  serve_traffic  the same chip under the seeded Poisson mix (short: 24-token
               prompts, 8 new tokens, a 16-tick deadline; long: 192 tokens, 32
               new, no deadline; 0.5 arrivals a tick) on a 40-block pool of 16
               tokens: a preemption and a resume at least, the first resumed
               prefix ``torch.equal`` to its page-out snapshot, the schedule
               equal to the port's on the CPU (2 layers, digital), a second
               run identical, one decode capture a run, a prefill replay an
               admission; tokens/s, latency in ticks, step ms by kind (decode
               only, paging, an admission, an admission that captured its
               bucket's prefill), admission ms by bucket, page-out / page-in
               ms and bytes; a third run, identical too, profiles ticks 52-75
               (tick_profile_traffic; run anew, up to 3 runs, where the
               profiler dropped records of our kernels)
  farm         ``ChipFarm`` replicas restored from one store of that chip
               (max_batch 2): the mix under round_robin and least_loaded
               (placements equal to the CPU farm's), one replica against a bare
               engine (tokens equal), ticks to drain on 1 and 2 replicas (gate
               > 1.3x), a decode capture and a prefill capture a bucket on
               each replica; wall-clock tokens/s printed, not gated: the
               replicas share one card and step one after the other
  farm_lifecycle  two replicas of a 2-layer full-width copy on
               LIFECYCLE_DEVICE (noisy kernel): replica 0 aged, drained,
               refreshed through the store's slots and undrained while replica
               1 serves: each swap drops replica 0's decode and prefill graphs
               and no other; one recapture of the tick on replica 0, whose
               next admission recaptures its bucket's prefill, ``torch.equal``
               to an eager one on the new chip; replica 1's decode and prefill
               graphs the same objects throughout; replica 0's tokens a fresh
               restore's
  serve_traffic_xlstm  xlstm-350m through the scheduler against its slot
               loop (tokens equal, the first token of each request from its
               prefill; the scan kernel on each sLSTM layer of every forward;
               one block a request) and one live slot paged out and into
               another free slot (every state leaf equal)

  Training, after the served paths:
  train_smollm  smollm-360m trained at full width and depth (bf16 params,
               remat, AdamW under cosine_with_warmup, B = 4, S = 1024: two
               loss chunks): (a) 6 uninterrupted ``TrainLoop`` steps against
               3 steps with a checkpoint at 3, fresh params and state restored
               by ``maybe_resume`` and 3 more: every param and optimizer-state
               leaf ``torch.equal``; (b) 20 steps on one fixed batch: none
               skipped, every loss finite, every param leaf moved, the last
               loss below 0.9 x the first; (c) one poisoned step (loss x NaN):
               skipped, params and state ``torch.equal`` to before; (d) the
               port's loss and grads of the reduced config in float32 on the
               card and on the CPU (loss rel 1e-5, each leaf's rel-L2 1e-4).
               Step ms p50 / p99, tokens/s, model TFLOP/s (6 x params x
               tokens), the optimizer's ms, peak GB, ``save_async`` snapshot
               and write seconds, restore seconds; train_profile: two steps
               under ``torch.profiler`` (device busy ms, idle share, launches
               and device ms by kernel class a step)
  train_then_serve  the trained params programmed onto an ideal chip and
               served (6 x 16) through the fast kernel: 193 launches a
               forward (from the chip, held to the config's count), the
               logits within smollm's rel-L2 gate of the plain-matmul model,
               every replayed tick ``torch.equal`` to eager
               (graph_vs_eager_trained); the fixed batch's loss on the chip
               beside the plain model's
  train_launcher  ``python -m repro_torch.launch.train --arch smollm-360m
               --steps 4 --batch 4 --seq 256 --ckpt-dir <tmp>`` then the same
               with ``--steps 8``: both exit 0, the second resumes from step 4
  train_musicgen  musicgen-large at full width, 6 of its 48 layers (bf16,
               remat, AdamW), on the stub dataset's frame embeddings and
               token targets (``make_dataset``: B = 4, S = 1024): 20 steps on
               one fixed batch, none skipped, every loss finite, the last
               below 0.9 x the first; the reduced config's loss and grads in
               float32 on the card and on the CPU; step ms, tokens/s, peak GB
  train_xlstm  xlstm-350m trained at full width and depth (24 layers, 12 of
               them sLSTM; bf16, remat, AdamW, B = 4, S = 1024) through
               ``SlstmScan``: per step 24 launches of the scan's saving
               forward and 12 of its backward kernel asserted, 20 steps on
               one fixed batch (none skipped, every loss finite, every leaf
               and every sLSTM layer's w_in / r_* moved, the last loss below
               0.9 x the first), one profiled window of 2 steps
               (train_profile_xlstm: busy ms by class, the profiler's kernel
               calls held to the counters), the dR products timed apart; the
               reduced config's loss and grads in float32 on the card and on
               the CPU at 256 positions (at 1024 the loss, the grads printed:
               the gradient jumps where n_t crosses 1, xlstm_grad_spread.py)
  train_mesh   training over a (data 2, model 2) mesh of 4 gloo rank
               processes sharing the card (one spawn): smollm-360m whole and
               gemma2-9b at 2 of 42 layers under ``tp``, xlstm-350m at 4
               layers under ``pure_dp``, each rank holding its specs' blocks
               of params and AdamW moments (asserted beside one device's
               bytes); step 1 against one device on the card in bf16 (loss
               and every gradient leaf, each within the larger of 1e-2 and
               twice its own bf16-vs-float32 distance on one device) and
               float32 (loss and every gradient leaf); bf16
               steps none skipped, ms per rank, collective bytes by axis;
               xlstm's K5 saving and backward launches a step on every rank

Needs one CUDA device; exits non-zero without one.  ``--quick`` (not used by
the default run) cuts the kernel cases and the model depth for a fast check
that the kernels build and agree.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.analysis import verify_store  # noqa: E402
from repro_torch.configs import StageSpec, get_config, reduced  # noqa: E402
from repro_torch.core import adc  # noqa: E402
from repro_torch.core.crossbar import CrossbarSpec, DEFAULT_SPEC, layer_scaled_spec, quantize_input  # noqa: E402
from repro_torch.core.karatsuba import karatsuba_vmm  # noqa: E402
from repro_torch.core.planner import LayerPlan, plan_model  # noqa: E402
from repro_torch.core.strassen import strassen_matmul  # noqa: E402
from repro_torch.checkpoint import active_slot, latest_step, restore_programmed, save_programmed  # noqa: E402
from repro_torch.data import EmbeddingStubDataset, SyntheticLMDataset, make_dataset  # noqa: E402
from repro_torch.device import DeviceConfig, effective_cell_codes  # noqa: E402
from repro_torch.device import programmed as tprog  # noqa: E402
from repro_torch.device import repair as trepair  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import crossbar_vmm as kvmm  # noqa: E402
from repro_torch.kernels.crossbar_vmm import crossbar_vmm_cuda, crossbar_vmm_plain  # noqa: E402
from repro_torch.kernels.noisy_vmm import noisy_vmm_cuda, noisy_vmm_plain  # noqa: E402
from repro_torch.kernels import slstm_scan as kscan  # noqa: E402
from repro_torch.kernels.slstm_scan import slstm_scan_cuda, slstm_scan_plain  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_local_mesh, run_ranks  # noqa: E402
from repro_torch.convert import tensor_to_numpy  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models import xlstm as xlstm_mod  # noqa: E402
from repro_torch.models.moe import ExpertShare, expert_share  # noqa: E402
from repro_torch.models.layers import (  # noqa: E402
    CrossbarMode, crossbar_misses, crossbar_mode, layout_overrides, reset_crossbar_misses, use_mesh,
)
from repro_torch.optim import Optimizer, cosine_with_warmup, make_optimizer  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    BlockCacheConfig, ChipFarm, ContinuousBatchingScheduler, ModelRunner, Request, ServingEngine,
)
from repro_torch.serving.farm import POLICIES  # noqa: E402
from repro_torch.serving.graphs import cache_leaves, clone_cache, named_leaves  # noqa: E402
from repro_torch.train import TrainLoop, make_train_step, value_and_grad  # noqa: E402
from repro_torch.tree import flatten, leaves, tree_map  # noqa: E402

# Published peaks of one H100 SXM (dense): HBM bytes/s, int8 tensor ops/s and
# float32 ops/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12

NOISY_DEVICE = DeviceConfig(sigma=0.02, p_stuck_on=1e-3, p_stuck_off=1e-3)
# the planned_datapaths phase holds one planned noisy projection without
# stuck cells (no repair) to the noisy kernel's unplanned one;
# serve_planned_repaired serves the planned chip on NOISY_DEVICE, repaired
STUCK_FREE_DEVICE = DeviceConfig(sigma=0.02)
# repair_recovery: a stuck-cell rate (1e-2 in all) where repair has much to do
RECOVERY_DEVICE = DeviceConfig(sigma=0.02, p_stuck_on=5e-3, p_stuck_off=5e-3)
# lifecycle: a drifting chip with stuck cells and 4 spares a column group
LIFECYCLE_DEVICE = DeviceConfig(sigma=0.02, p_stuck_on=1e-3, p_stuck_off=1e-3, drift_nu=0.05, spare_cols=4)
LIFECYCLE_AGE_S = 1e7
# The smollm-360m served paths (ideal, paper-datapath, noisy, planned and
# repaired chips, the traffic tier, the lifecycle) and the three dense
# families run at full width cut to this many layers: at full depth, beside
# the embedding front ends' phases, the script took 1185-1256 s on an NVIDIA
# H100 80GB HBM3 at 700 W (PERF.md §6), past the 1200 s it must finish
# in; at 8 layers, with the training mesh beside them, 1172.6 s on a slow
# host (PERF.md §6).  Training stays at full depth: at 8 layers its
# steps memorise the fixed batch, and train_then_serve's loss check cannot
# read a loss near 0.
SERVE_CUT_LAYERS = 4
# the traffic phases (smollm-360m from an ideal chip, xlstm-350m): a pool of
# 4 slots of 256 tokens; serve_traffic's block pool holds 40 blocks of 16
# tokens against the 64 a dense pool would, so the mix below preempts
TRAFFIC_BATCH, TRAFFIC_SEQ = 4, 256
TRAFFIC_POOL = BlockCacheConfig(block_size=16, n_blocks=40)
# deadlines in ticks from arrival by prompt class (None: no deadline)
TRAFFIC_DEADLINE = {"short": 16, "long": None}
# serve_traffic's profiled window: (phase, first tick, ticks); at seed 0 it
# holds 6 admissions and a page move
TRAFFIC_WINDOW = ("tick_profile_traffic", 52, 24)
# the profiled traffic run is run again, up to this many runs in all, when
# the profiler dropped device records of our kernels in its window (it saw
# fewer than were credited, none more): torch.profiler has dropped part or
# all of one replay's records from a window of this size (PERF.md §7)
TRAFFIC_PROFILE_RUNS = 3
# the reference's gate on a farm's ticks to drain, 1 replica against 2
# (benchmarks/serving_traffic.py), both at max_batch FARM_BATCH
FARM_SPEEDUP_MIN, FARM_BATCH = 1.3, 2
PLANNED = ("karatsuba1", "karatsuba2", "strassen")
MAIN_SHAPES = [(960, 960), (960, 320), (960, 5120), (2560, 960), (960, 49152)]
XLSTM_HEAD = (1024, 50304)  # the tied head of xlstm-350m, K x N
# the three dense configs served from an ideal chip: (phase, arch); and, K x
# N, each projection shape they add to the fast kernel's main path (wq, wk /
# wv, wo, wi, the FFN's wo; a shape another config already has is listed
# once) and their heads, each held at M = 4 (a decode tick) and M = 32 (a
# prefill bucket), gemma2's 256000-wide head at M = 4 only; each head also
# at M = 1 (a prefill's last position), untimed
DENSE_SERVES = (("serve_gemma2", "gemma2-9b"), ("serve_minitron", "minitron-4b"), ("serve_starcoder2", "starcoder2-3b"))
DENSE_SHAPES = {
    "gemma2-9b": [(3584, 4096), (3584, 2048), (4096, 3584), (3584, 28672), (14336, 3584)],
    "minitron-4b": [(3072, 3072), (3072, 1024), (3072, 9216), (9216, 3072)],
    "starcoder2-3b": [(3072, 256), (3072, 12288), (12288, 3072)],
}
DENSE_HEADS = {"gemma2-9b": (3584, 256000), "minitron-4b": (3072, 256000), "starcoder2-3b": (3072, 49152)}
# the prefill buckets past 32 that prefill_vs_eager_gemma2 runs gemma2's
# projections at
DENSE_BUCKETS = (64, 128, 256)
# K of the deepest projections of gemma2 (its attention wo, its FFN wo),
# where the paper and noisy kernels are held to their plain versions at N =
# 3584, M = 4 (off this slice's served path: untimed)
DEEP_K = (4096, 14336)
# widest column block of one plain-version call: its int64 copies of a
# 256000-wide head would take tens of GB (test-only code; every output
# column depends on its own weight column alone)
PLAIN_N_CHUNK = 16384
# the rel-L2 gate of each ideal chip's logits against the plain-matmul
# model on one 16-token prompt (PERF.md §2 says how each was set)
REL_L2_MAX = {"smollm-360m": 0.25, "gemma2-9b": 0.6, "minitron-4b": 0.45, "starcoder2-3b": 0.25}
# the store round trip of a dense chip runs on a copy of it cut to this
# depth at full width: a full gemma2-9b store is 37 GB of npz
STORE_CHECK_LAYERS = 2
# kimi-k2-1t-a32b on one card: rank 0 of an 8-way expert-parallel
# deployment (experts 0-47 of 384; the router, attention, shared expert and
# head replicated), at full width, cut to its dense layer and 2 MoE layers;
# the store round trip on a copy cut to the dense layer and 1 MoE layer
KIMI, KIMI_SHARE, KIMI_LAYERS, KIMI_STORE_LAYERS = "kimi-k2-1t-a32b", ExpertShare(rank=0, ranks=8), 3, 2
# K1 launches a forward at KIMI_LAYERS: attention 4 a layer, the dense
# layer's FFN 2, each MoE layer's router + 3 x (48 experts + 1 shared), the head
KIMI_K1_PER_FORWARD = 311
# the logits' rel-L2 to the plain-matmul model of the same share: a check
# for a broken datapath (>= 1), printed, not a fidelity target
KIMI_REL_L2_MAX = 1.0
# kimi's projections on the fast kernel (K x N: the rows they run at): an
# expert's wi / wg and wo at the capacity of 8 rows every expert buffer
# holds at every served size (also the shared expert's shapes, at a decode
# tick and a bucket); the router, attention q / k-v / o and the dense
# layer's fused wi and wo at a decode tick and every prefill bucket; the
# head at a prefill's last position and a decode tick
KIMI_SHAPES = [
    ((7168, 2048), (8, 4, 32)), ((2048, 7168), (8, 4, 32)), ((7168, 384), (4, 32, 64, 128, 256)),
    ((7168, 8192), (4, 32, 64, 128, 256)), ((7168, 1024), (4, 32, 64, 128, 256)),
    ((8192, 7168), (4, 32, 64, 128, 256)), ((7168, 36864), (4, 32, 64, 128, 256)),
    ((18432, 7168), (4, 32, 64, 128, 256)), ((7168, 163840), (1, 4)),
]
# the kimi rows timed (the rest, prefill_vs_eager_kimi's buckets past 32,
# are held to the plain version untimed)
KIMI_TIMED_M = (1, 4, 8, 32)
# moe_ranks_deepseek: deepseek-v2's MoE FFN at published widths (160
# experts top 6 + 2 shared, d_model 5120, expert d_ff 1536), one layer on an
# ideal chip, over 4 rank processes sharing the card by gloo (NCCL refuses
# two ranks on one GPU): EP and all-to-all on a (1, 4) mesh, expert-TP on a
# (2, 2) mesh; (B, S) of a decode tick and a prefill.  The router is scaled
# so its logits have the spread of the reference's sharded tests (x100 at
# d_model 16; the router is drawn at 0.02 a weight, so its logits' std grows
# as sqrt(d_model): x100 * sqrt(16 / 5120), a logit std of ~8)
DEEPSEEK, DEEPSEEK_RANKS, DEEPSEEK_BACKEND = "deepseek-v2-236b", 4, "gloo"
DEEPSEEK_DECODE, DEEPSEEK_PREFILL = (4, 1), (1, 32)
DEEPSEEK_ROUTER_SCALE = 100.0 * math.sqrt(16 / 5120)
# EP and every digital body are held to the reference's bar against the
# one-device run (EP quantizes one device's buffers; a digital body differs
# only in its sums' order)
DEEPSEEK_REL_MAX = 5e-3
# The all-to-all and expert-TP ranks quantize buffers of their own (each
# call's input shift and scale are its buffer's), and at K = 5120 the ideal
# chip's 16-bit output codes carry a projection to ~2 % of its signal: a
# router logit moves by ~0.1-0.2, which reorders close experts and
# reweights the rest, so two sound layouts of the chip part by far more
# than 5e-3.  Every chip run (one device's and each body's) is held instead
# to the digital run of the same body routed as the chip run routed (its
# top-k ids and gates): max |dlogits| / max |logits| of the router, and
# max |dy| / max |y|, each at most its limit here.  The limits sit between
# the sound runs' readings on the H100 (logits 0.021-0.042, y 0.065-0.128)
# and the planted faults' (DEEPSEEK_PLANTS: a zeroed colsum reads logits
# 3.3, y 114; swapped banks y 1.2-2.3), which each run must fail.
DEEPSEEK_CHIP_GATE = {"router_logits": 0.2, "y_same_routing": 0.4}
# (datapath, activations) each body runs in.  "chip": the programmed chip,
# K1 on every projection; "digital": the same bodies with the crossbar off
# in float32 (the bf16 params widened exactly): dispatch, collectives and
# combine at published widths.
DEEPSEEK_RUNS = (("chip", torch.float32), ("chip", torch.bfloat16), ("digital", torch.float32))
# (body, mesh, layout, dispatch, input) the rank phase runs, in order
DEEPSEEK_BODIES = (
    ("ep/decode", (1, 4), "ep_only", "allreduce", DEEPSEEK_DECODE),
    ("ep/prefill", (1, 4), "ep_only", "allreduce", DEEPSEEK_PREFILL),
    ("alltoall/prefill", (1, 4), "ep_only", "alltoall", DEEPSEEK_PREFILL),
    ("expert_tp/decode", (2, 2), "expert_tp", "allreduce", DEEPSEEK_DECODE),
)
# faults planted in the chip runs (float32) of a body, each of which the
# gate above must catch: (name, body, fault).  "zeroed_colsum": every
# K-partial projection (router and banks) served without its local column
# sums; "swapped_banks": the banks restored as another rank's slices (the
# other model rank's rows under expert-TP, the next rank's experts under
# EP), the router sound
DEEPSEEK_PLANTS = (
    ("expert_tp/zeroed_colsum", "expert_tp/decode", "zeroed_colsum"),
    ("expert_tp/swapped_banks", "expert_tp/decode", "swapped_banks"),
    ("alltoall/swapped_banks", "alltoall/prefill", "swapped_banks"),
)
# deepseek's projections on the fast kernel (K x N: rows), each at the rows
# a run of moe_ranks_deepseek gives it (the phase asserts it launched no
# other): an expert's wi / wg and wo at the capacity of a decode tick (8
# slots) and of a prefill (32; an all-to-all rank's 4 sources x 8); their
# expert-TP row slices at 2 data ranks x 8 slots; the router at a decode
# tick, an all-to-all rank's 8-token block and a prefill, its expert-TP
# slice at a data rank's 2 tokens; the shared expert (2 x 1536 wide), which
# every rank runs on every token, at a decode tick and a prefill.  Then the
# rows the whole model adds (serve_deepseek, serve_deepseek_ranks): the
# expert-TP slices at an uncapped prefill's 2 data ranks x 32 slots and the
# router slice at a prefill (32) and at the engine's coverage forward (4);
# MLA's wq (5120 x 128 heads x (128 + 64), also the dense layer's fused wi,
# 2 x 12288), w_kv_down (kv_lora_rank 512 + rope 64) and wo, and the dense
# wo, at a decode tick and a bucket-32 prefill; the head at a prefill's last
# position and a decode tick
DEEPSEEK_SHAPES = [
    ((5120, 1536), (8, 32)), ((1536, 5120), (8, 32)), ((2560, 1536), (16,)), ((768, 5120), (16,)),
    ((5120, 160), (4, 8, 32)), ((2560, 160), (2,)), ((5120, 3072), (4, 32)), ((3072, 5120), (4, 32)),
    ((2560, 1536), (64,)), ((768, 5120), (64,)), ((2560, 160), (4, 32)),
    ((5120, 24576), (4, 32)), ((5120, 576), (4, 32)), ((16384, 5120), (4, 32)), ((12288, 5120), (4, 32)),
    ((5120, 102400), (1, 4)),
]
# serve_deepseek: deepseek-v2 at published widths cut to its dense first
# layer and its first MoE layer (a second MoE layer adds a chip of 15.3 GB,
# as moe_ranks_deepseek holds it on an NVIDIA H100 80GB HBM3 at 700 W, a
# copy, which 4 rank copies of the rest would not leave room for), random
# bf16 weights, an ideal chip; serve_phase's traffic at max_seq 256 with
# prompts of at most 32 tokens (one prefill bucket)
DEEPSEEK_LAYERS, DEEPSEEK_PROMPT_MAX, DEEPSEEK_SEQ = 2, 32, 256
# K1 launches a forward: layer 0's 3 MLA projections (wq, w_kv_down, wo) and
# its dense FFN's 2; layer 1's 3 MLA projections, its router, 160 experts x
# 3 and the shared expert's 3; the head: 5 + 3 + 484 + 1
DEEPSEEK_K1_PER_FORWARD = 493
# a rank's forward: its 40 (EP on 1 x 4) or 80 (expert-TP on 2 x 2) experts
# x 3 in place of 160 x 3
DEEPSEEK_RANK_K1 = {"ep": 133, "expert_tp": 253}
# serve_deepseek_ranks: (name, mesh, layout), in order; the ranks' requests
# and new tokens a request, also the teacher-forced decode steps
DEEPSEEK_MESHES = (("ep", (1, 4), "ep_only"), ("expert_tp", (2, 2), "expert_tp"))
DEEPSEEK_RANK_REQUESTS, DEEPSEEK_RANK_NEW = 4, 8
# The ranks' teacher-forced logits against one device's, max |d| / max
# |logit|.  On the chip, EP (PERF.md §6 says how it was reckoned before the
# first run): the bf16 partial sums of the EP psum (5.9e-3 of the MoE
# output in moe_ranks_deepseek on an NVIDIA H100 80GB HBM3 at 700 W) pass
# through the last residual, which the MoE output dominates, and one output
# code of the head (K = 5120: 2**29 x_scale w_scale, reckoned at ~4 % of the
# largest logit) flips wherever its input moved; the planted bank swap must
# read above it.
DEEPSEEK_LOGITS_GATE = 0.1
# Digitally, EP and expert-TP routed as one device routed: the bf16 psum
# alone, with no head code to flip (0.0061 and 0.0076 on an NVIDIA H100
# 80GB HBM3 at 700 W, 5e-3 predicted from the FFN's reading)
DEEPSEEK_DIGITAL_GATE = 0.02
# Expert-TP's own routing, digitally: the share of token rows whose top-k
# expert set equals one device's, on every rank.  Its router sums two bf16
# K-partials (the reference's body does too), which reorders near-tied
# experts (0.958 on an NVIDIA H100 80GB HBM3 at 700 W); a router that drops
# or doubles a K-half routes most rows apart
DEEPSEEK_ROUTED_ALIKE_MIN = 0.9
# the chip's logits against the plain-matmul model's, rel-L2: a check for a
# broken datapath, as KIMI_REL_L2_MAX
DEEPSEEK_REL_L2_MAX = 1.0
# layer 0's MLA block card against CPU, crossbar off, float32 (TF32 off)
DEEPSEEK_MLA_CPU_GATE = 1e-5
# tick_profile_deepseek's split of busy time: K1, the MLA einsums (the
# only float32 GEMMs of a chip's tick: cuBLAS), the rest
DEEPSEEK_TICK_CLASSES = {"k1": ("fast_kernel",), "mla_einsums": ("gemm", "gemv", "splitK", "dot_kernel")}
# serve_jamba: jamba-v0.1-52b as rank 0 of a 4-way expert-parallel
# deployment (experts 0-3 of each MoE layer's 16; the rest replicated) at
# full width, its 8-layer period once (repeats 4 -> 1: 7 mamba blocks, the
# attention block, 4 dense and 4 MoE FFNs); the store round trip on a copy
# cut to the period's first JAMBA_STORE_POSITIONS positions (3 mamba blocks,
# the attention block, 2 MoE FFNs)
JAMBA, JAMBA_SHARE, JAMBA_STORE_POSITIONS = "jamba-v0.1-52b", ExpertShare(rank=0, ranks=4), 4
# K1 launches a forward: attention 4, dense FFNs 4 x 2, MoE FFNs 4 x (router
# + 3 x 4 experts), the head; the mamba projections are digital
JAMBA_K1_PER_FORWARD = 65
# the logits' rel-L2 to the plain-matmul model of the same share: a check
# for a broken datapath, as KIMI_REL_L2_MAX; printed with the routing
# agreement, whose flips compound over the MoE layers
JAMBA_REL_L2_MAX = 1.0
# the logits' rel-L2 to the plain-matmul model of the same share routed as
# the chip routed: the 16-bit datapath's own error.  Set before the first
# run from rel_l2_cpu.py at full width (the period's first 1 / 2 / 4 / 8
# positions of rank 0 of EP16, vocabulary 4096: 0.195 / 0.285 / 0.436 /
# 0.665; EP4's 4 experts a layer read 1.16x EP16's at 2 positions): 0.77
# predicted here
JAMBA_FORCED_REL_L2_MAX = 0.9
# layer 0's mamba block card against CPU, float32 (TF32 off), max |dy| / max
# |y| and of the cache leaves over a 32-token prefill and 4 decode steps.
# Set before the first run: float32 against float64 on the CPU reads <= 3.4e-6
# over those steps, and card and CPU round apart independently
JAMBA_MAMBA_CPU_GATE = 2e-5
# jamba's K1 shapes (K x N) and the rows timed: q / o and k / v, the dense
# fused wi, the dense wo (also an expert's wo), an expert's wi / wg, the
# router at a tick (4) and a prefill (32); the experts also at their
# capacity of 8 rows (every served size: 4 x 2 / 16 x 1.25 -> 8); the head
# at a prefill's last position and a tick
JAMBA_SHAPES = [
    ((4096, 4096), (4, 32)), ((4096, 1024), (4, 32)), ((4096, 28672), (4, 32)),
    ((14336, 4096), (4, 8, 32)), ((4096, 14336), (4, 8, 32)), ((4096, 16), (4, 32)), ((4096, 65536), (1, 4)),
]
# serve_musicgen / serve_pixtral: the embedding front ends (precomputed
# frames / patches in place of tokens) from ideal chips the engine
# programs, served through the model's prefill and decode_step (the engine
# refuses their requests, as the reference's fails on them).  EMBED_SLOTS
# prompts of EMBED_FRAMES seeded N(0, 1) frames, each prefilled alone into
# its slot of a float32 pool cache (K1 at M = 32, the head at M = 1), then
# the decode steps of the pool (M = 4), each fed the next frame.
# musicgen-large runs at full width, 24 of its 48 layers (the script's time
# limit); pixtral-12b at full width and vocabulary, cut to 4 of its 40 layers
# for memory (1.76 G weights: 3.5 GB
# of bf16 params and about 7.1 GB of chip; its whole chip would be 47 GB).
MUSICGEN, PIXTRAL = "musicgen-large", "pixtral-12b"
EMBED_SLOTS, EMBED_FRAMES = 4, 32
EMBED_LAYERS = {MUSICGEN: 24, PIXTRAL: 4}
EMBED_STEPS = {MUSICGEN: 16, PIXTRAL: 8}
# K1 launches a forward: 6 a layer (wq, wk, wv, wo, the FFN's wi and wo) +
# the untied head
EMBED_K1_PER_FORWARD = {MUSICGEN: 145, PIXTRAL: 25}
# The chip's logits against the plain-matmul model's over every served
# position (each prefill's last and every decode step's), rel-L2.  Set
# before the first chip run from ``python3 rel_l2_cpu.py <arch>`` (the same
# serving at full width on the CPU): musicgen at depth 2 / 4 / 8 / 16 reads
# 0.0334 / 0.0396 / 0.0441 / 0.0472, about 0.052 projected to 48 layers;
# pixtral at depth 1 / 2 / 4 with a 32768-token vocabulary 0.115 / 0.153 /
# 0.213.  A broken projection reads far above either gate.
EMBED_REL_L2_MAX = {MUSICGEN: 0.1, PIXTRAL: 0.35}
# The digital serving (prefills into the pool's slots, then decode steps)
# against a teacher-forced forward over the whole sequence, on the card in
# bf16: rel-L2 over the served positions.  Both round every activation to
# bf16, and the prefill (M = 32), the decode (M = 4) and the forward (M =
# 192) run their matmuls with other tilings, so they differ by bf16
# roundings that compound over the layers (a few 1e-3 a layer); a cache
# written at the wrong position or slot reads O(1).
EMBED_TEACHER_REL_L2_MAX = 0.05
# each phase's K1 shapes (K x N) and the rows it runs them at; musicgen's
# head is 2048 x 2048, its attention projections' shape
EMBED_SHAPES = {
    MUSICGEN: [((2048, 2048), (1, 4, 32)), ((2048, 8192), (4, 32)), ((8192, 2048), (4, 32))],
    PIXTRAL: [
        ((5120, 4096), (4, 32)), ((5120, 1024), (4, 32)), ((4096, 5120), (4, 32)), ((5120, 28672), (4, 32)),
        ((14336, 5120), (4, 32)), ((5120, 131072), (1, 4)),
    ],
}
# the store round trip runs on a copy of the chip cut to this depth
EMBED_STORE_LAYERS = 2
# train_musicgen: musicgen-large at full width cut to 6 of its 48 layers,
# bf16, remat, AdamW, on the stub dataset's embeddings (B x S as
# train_smollm's), EMBED_TRAIN_STEPS steps on one fixed batch
EMBED_TRAIN_LAYERS, EMBED_TRAIN_STEPS = 6, 20
# moe_expert_chips: one full-width MoE FFN of the rank share of EP48 (8
# experts) on NOISY_DEVICE, one chip identity an expert, at these token
# counts
EXPERT_CHIPS_SHARE, EXPERT_CHIPS_M = ExpertShare(rank=0, ranks=48), (4, 32)
# (B, S) of the scan on the xlstm path: a decode tick of the slot pool, one
# decode row, and prefills of 24 / 192 (the traffic mix's short and long
# prompts), 32 / 48 (the longest prompt served) / 256 tokens
SCAN_SHAPES = [(4, 1), (1, 1), (1, 24), (1, 32), (1, 48), (1, 192), (1, 256)]
SCAN_HEADS, SCAN_DH = 4, 512  # xlstm-350m: 4 heads of 2048 / 4
# (label, B, S, H, dh) held against the plain version, untimed: dh not a
# multiple of the cluster's 16-byte column units (48, 100), dh = 2048 (R
# partly resident), more batch rows than a power of two (5) and than a CTA
# takes (9, two batch groups), one head, and decode (S = 1) past 8 rows
SCAN_EDGES = [
    ("ragged", 2, 5, 3, 48), ("dh100", 5, 4, 2, 100), ("dh2048", 2, 3, 1, 2048),
    ("B5", 5, 3, 4, 512), ("B9", 9, 3, 4, 512), ("B9_decode", 9, 1, 4, 512), ("H1", 1, 8, 1, 512),
]
SCAN_KERNEL = "slstm_cluster_kernel"  # its name in a profiler trace (serving and saving forward)
SCAN_BWD_KERNEL = "slstm_scan_bwd_kernel"
# the scan's saving forward and its backward (training), held to their plain
# versions on the same inputs from the training state (c = 0, n = 1, h = 0):
# (label, B, S, H, dh, timed).  train: xlstm-350m's train step (B 4 x S 1024,
# 4 heads of 512); S48: one row; reduced: the reduced config that
# train_card_vs_cpu trains (dh 32, float32 there); B9: three batch groups of
# 3 rows; dh100 / dh2048: ragged columns, and R partly resident
SCAN_TRAIN_CASES = [
    ("train", 4, 1024, 4, 512, True), ("S48", 1, 48, 4, 512, True), ("reduced", 2, 1024, 4, 32, True),
    ("B9", 9, 24, 4, 512, False), ("dh100", 5, 16, 2, 100, False), ("dh2048", 2, 8, 1, 2048, False),
]
# the spin kernels (torch.cuda._sleep) that open each profiled window to
# take the profiler's loss of a session's first records (profiler_session)
PROFILE_PROLOGUE, PROLOGUE_SPIN_CYCLES, PROLOGUE_KERNEL = 4096, 1000, "spin_kernel"
# profiled windows a tick_profile or train_profile may take before it fails
PROFILE_RUNS = 3
# the kernel each launch counter counts, by its name in a profiler trace
TRACE_NAMES = {
    "fast": "fast_kernel", "planes": "paper_mma_kernel", "noisy": "noisy_mma_kernel", "slstm_scan": SCAN_KERNEL,
    "slstm_scan_save": SCAN_KERNEL, "slstm_scan_bwd": SCAN_BWD_KERNEL,
}
VMM_COUNTERS = tuple(kvmm.LAUNCHES)  # the three VMM kernels' launch counters
# the head is the only projection of an xlstm chip: its logits stay close to
# the plain-matmul model's (smollm-360m's projections allow 0.25)
XLSTM_REL_L2_MAX = 0.1
# training (train_smollm): smollm-360m at full width, B x S tokens a step
# (S = 1024: two loss chunks of 512); AdamW under cosine_with_warmup(lr,
# steps // 10 + 1, steps), as the launcher sets it
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 4, 1024, 1e-3
RESUME_STEPS = 6  # the uninterrupted run; the resumed one checkpoints at half
LEARN_STEPS = 20  # on one fixed batch: the last loss below 0.9 x the first
# train_xlstm: xlstm-350m at full width and depth (12 sLSTM layers), B x S =
# TRAIN_BATCH x XLSTM_TRAIN_SEQ, LEARN_STEPS steps; per step, with remat, each
# sLSTM layer's saving forward runs twice (forward, recompute) and its
# backward once
XLSTM_TRAIN_SEQ = 1024
# the reduced xlstm's loss and grads card vs CPU are held to CARD_VS_CPU_* at
# 256 positions.  Its gradient jumps where n_t crosses 1 (the weight of
# max(n_t, 1)), and over 2 x 1024 positions a cell may sit within float32
# rounding of 1: at seed 63 params scaled by 1 + 1e-7 N(0, 1) move r_i's
# gradient by 1.9e-3 on the CPU alone (at 256 positions <= 5.2e-6, seeds
# 63-65; xlstm_grad_spread.py).  At 1024 the line prints the card vs CPU
# reading (``at_1024``), gated on the loss only
XLSTM_CARD_VS_CPU_SEQ = 256
# the port's loss and grads on the card against the CPU, reduced smollm in
# float32 (TF32 off): reduction orders only
CARD_VS_CPU_LOSS_REL = 1e-5
CARD_VS_CPU_GRAD_REL_L2 = 1e-4
# the trained chip's loss on the fixed batch against the plain-matmul
# model's (train_then_serve): readings 1.3e-6 and 1.3e-4 (quantisation,
# averaged over 4096 tokens); a wrong K1 above 256 rows moves it by far more
TRAINED_LOSS_REL_MAX = 1e-2
# train_mesh: training over one (data 2, model 2) mesh of 4 gloo ranks that
# share the card: (case, arch, layers (None: full depth), steps).  smollm and
# gemma2 under the ``tp`` layout (heads, FFN units and the vocabulary over
# "model", the batch over "data"), xlstm under ``pure_dp`` (the batch over
# both axes; its sLSTM blocks through K5's saving forward and backward).
# B x S = TRAIN_BATCH x TRAIN_SEQ, AdamW under cosine_with_warmup
MESH_SHAPE = (2, 2)
MESH_CASES = (
    ("smollm", "smollm-360m", None, 4),
    ("gemma2", "gemma2-9b", 2, 3),
    ("xlstm", "xlstm-350m", 4, 3),
)
# step-1 loss against one device on the card: the reference's own bar for a
# DP+TP loss (tests/test_distributed.py: 2e-3 x max(1, |loss|)), in bf16 and
# in float32.  The gradients are held in float32 (the same params cast, TF32
# off), every gathered step-1 leaf within MESH_GRAD_REL_L2[case] (rel-L2) of
# one device's: reduction orders only, the bar of the card-vs-CPU grads
# (CARD_VS_CPU_GRAD_REL_L2); xlstm's sLSTM gradient jumps where n_t crosses
# 1 (xlstm_grad_spread.py: up to 1.9e-3 from a 1e-7 change of the params).
# In bf16 no split of a sum can keep one device's roundings: each bf16
# step-1 gradient leaf against one device's is printed beside that leaf's own
# bf16 distance from float32 on one device (``bf16_vs_f32_one_device``), and
# held to 1e-2 where that distance allows, else to MESH_BF16_NOISE_X times
# it, leaf by leaf (mesh_bf16_noise.py, CPU, 6 layers at smollm's width: the
# mesh 1.5e-2 from one device where one device's bf16 is 2.0e-2 from its
# float32)
MESH_LOSS_REL = 2e-3
MESH_GRAD_REL_L2 = {"smollm": 1e-4, "gemma2": 1e-4, "xlstm": 1e-2}
MESH_BF16_GRAD_REL_L2 = 1e-2
MESH_BF16_NOISE_X = 2.0
CSRC = "src/repro_torch/kernels/csrc/crossbar_vmm.cu"
BIT_IDENTICAL = "bit-identical (torch.equal)"
SCAN_TOLERANCE = (
    "float32 outputs (h_all of a float32 call, c1, n1, h1): |kernel - plain| <= 1e-5 + 1e-5 |plain|, "
    "the JAX package's kernel-vs-scan bar; bfloat16 h_all: at most one bfloat16 ULP from the plain "
    "version's (or 1e-5 where |h| is so small that this spans several bfloat16 spacings). Not "
    "bit-identical: the kernel sums the dh products of a dot in order, the plain version through "
    "cuBLAS in another order, so the float32 state differs by a few ULPs and a bfloat16 rounding of "
    "h can land on the neighbouring value"
)

def scan_train_rel_max(S: int) -> float:
    """The rel-L2 bar of the backward (g, carries, dR) and of the saving
    forward's planes against their plain versions at S steps."""
    return 1e-5 if S <= 48 else 1e-4


SCAN_TRAIN_TOLERANCE = (
    "the backward's float32 g, dc0, dn0, dh0 and dR (the product over B S of h_{t-1} and g) against the "
    "plain backward on the same saved planes, and the saving forward's planes against the plain version's: "
    "rel-L2 <= 1e-5 up to S = 48, <= 1e-4 at S = 1024 (the same float32 arithmetic, the dh products "
    "summed in another order, carried through S steps); the saving forward's h_all / c1 / n1 / h1 against "
    "the serving kernel's within the scan tolerance (the same arithmetic: bit-equal expected, reported)"
)

KERNELS = {
    "fast": dict(
        name="crossbar_vmm_fast", counter="fast", source=CSRC, tolerance=BIT_IDENTICAL,
        replaces="src/repro/kernels/crossbar_vmm.py:190 (_fast_kernel) + :149 (_requantize_block)",
        headline=dict(M=4, K=960, N=5120),
    ),
    "planes": dict(
        name="crossbar_vmm_planes", counter="planes", source=CSRC, tolerance=BIT_IDENTICAL,
        replaces="src/repro/kernels/crossbar_vmm.py:78 (_vmm_kernel) + :149 (_requantize_block)",
        headline=dict(M=4, K=960, N=5120),
    ),
    "noisy": dict(
        name="noisy_vmm_planes", counter="noisy", source=CSRC, tolerance=BIT_IDENTICAL,
        replaces="src/repro/kernels/noisy_vmm.py:52 (_noisy_kernel) + crossbar_vmm.py:149 (_requantize_block)",
        headline=dict(M=4, K=960, N=5120),
    ),
    "slstm": dict(
        name="slstm_scan", counter="slstm_scan", source="src/repro_torch/kernels/csrc/slstm_scan.cuh",
        tolerance=SCAN_TOLERANCE,
        replaces="src/repro/kernels/slstm_scan.py:70 (slstm_scan_pallas) -> :31 (_kernel)",
        headline=dict(dtype="bfloat16", B=4, S=1),
    ),
    "slstm_save": dict(
        name="slstm_scan_save", counter="slstm_scan_save", source="src/repro_torch/kernels/csrc/slstm_scan.cuh",
        tolerance=SCAN_TRAIN_TOLERANCE,
        replaces="src/repro/kernels/slstm_scan.py:70 (slstm_scan_pallas) -> :31 (_kernel); training: the "
                 "forward of the jax.lax.scan at src/repro/models/xlstm.py:213 under autodiff",
        headline=dict(dtype="bfloat16", B=4, S=1024),
    ),
    "slstm_bwd": dict(
        name="slstm_scan_bwd", counter="slstm_scan_bwd", source="src/repro_torch/kernels/csrc/slstm_scan.cuh",
        tolerance=SCAN_TRAIN_TOLERANCE,
        replaces="src/repro/models/xlstm.py:213 (JAX's autodiff of slstm_block's jax.lax.scan; no Pallas kernel)",
        headline=dict(dtype="bfloat16", B=4, S=1024),
    ),
}


_T0 = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line; a phase's line also carries the script's
    seconds so far (``at_s``), so the time each phase took can be read."""
    if "phase" in obj:
        obj = dict(obj, at_s=time.perf_counter() - _T0)
    print(json.dumps(obj), flush=True)


def require(cond, message) -> None:
    """A check of the run (kept under ``python -O``, unlike ``assert``)."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {message}")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cold_ms(fn, reps: int = 10) -> float:
    """Median device milliseconds of one call of ``fn`` on a cold L2: before
    each call a 64 MB buffer is written (the L2 holds 50 MB), then a spin
    kernel holds the device while the host enqueues the call, so that the
    CUDA events bracket the kernel alone and not the host's launch time."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    times = []
    for i in range(reps):
        flush.fill_(i & 0xFF)
        torch.cuda._sleep(1_000_000)  # ~0.5 ms of device time
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, launches: int = 20, reps: int = 10) -> float:
    """Device milliseconds per call of ``fn``: ``launches`` calls captured
    into one CUDA graph and replayed, so no host time sits between them."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return cuda_ms(graph.replay, reps=reps, warmup=1) / launches


# ---------------------------------------------------------------------------
# kernels phase
# ---------------------------------------------------------------------------

def make_x(rng, M, K, bits, sparse, dev):
    if sparse:  # post-ReLU style: mostly zero, codes confined to low planes
        x = rng.integers(0, 1 << min(9, bits), size=(M, K)) * (rng.random((M, K)) < 0.3)
    else:
        x = rng.integers(0, 1 << bits, size=(M, K))
    return torch.from_numpy(x.astype(np.int32)).to(dev)


def make_w(rng, K, N, spec, dev):
    """Uniform weight codes, drawn on ``dev`` from a seed ``rng`` gives: a
    head's 1.2 G codes drawn by numpy took seconds of host time a case."""
    lo = -(1 << (spec.weight_bits - 1)) if spec.signed_weights else 0
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(1 << 62)))
    return torch.randint(lo, lo + (1 << spec.weight_bits), (K, N), generator=gen, device=dev, dtype=torch.int32)


def active_planes(x, spec):
    """(row, row group, iteration) triples whose input plane is non-zero —
    the conversions this input actually needs."""
    M, K = x.shape
    pad = (-K) % spec.rows
    xp = torch.nn.functional.pad(x, (0, pad)).reshape(M, -1, spec.rows)
    group_or = torch.zeros(xp.shape[:2], dtype=torch.int32, device=x.device)
    for r in range(spec.rows):  # bitwise-or reduction over the rows of a group
        group_or |= xp[:, :, r]
    dmask = (1 << spec.dac_bits) - 1
    return sum(
        int(((group_or >> (t * spec.dac_bits)) & dmask).ne(0).sum()) for t in range(spec.n_iters)
    )


def bound_ms(kind, x, N, spec):
    """Least time for the work: max(bytes / HBM rate, operations / int8
    tensor rate).  Bytes: x, the weight operand and the output once each, at
    the width the function needs, not the width the tensors are stored in —
    ``input_bits`` per input code, ``out_bits`` per output code,
    ``weight_bits`` per weight code and, for the noisy kernel, ``cell_bits +
    8`` bits per cell (a conductance on the 1/256 grid in [0, cell_max]).
    Operations: fast — one 16x16-bit multiply-add per (m, k, n), counted as
    four 8x8-bit multiply-adds = 8 ops; plane kernels — one multiply-add
    (2 ops) per row of every column conversion of every *active* plane.
    Also returns the byte bound at the stored widths (int32 codes, float32
    cells), the bytes the kernels move today."""
    M, K = x.shape
    if kind == "noisy":
        w_bits, w_stored = spec.n_slices * (spec.cell_bits + 8), 4 * spec.n_slices
    else:
        w_bits, w_stored = spec.weight_bits, 4
    needed = (M * K * spec.input_bits + K * N * w_bits + M * N * spec.out_bits) / 8
    stored = M * K * 4 + K * N * w_stored + M * N * 4
    t_bytes = needed / HBM_BYTES_PER_S
    if kind == "fast":
        ops = 8.0 * M * K * N
    else:
        ops = 2.0 * active_planes(x, spec) * spec.rows * spec.n_slices * N
    t_ops = ops / INT8_OPS_PER_S
    bound = 1e3 * max(t_bytes, t_ops)
    return bound, ("bytes" if t_bytes >= t_ops else "operations"), 1e3 * stored / HBM_BYTES_PER_S


def extreme_codes(M, K, N, spec, dev):
    """Every input code at its maximum; weights at the two ends of their
    range in alternating columns: the largest byte-plane partial sums."""
    x = torch.full((M, K), (1 << spec.input_bits) - 1, dtype=torch.int32, device=dev)
    lo = -(1 << (spec.weight_bits - 1)) if spec.signed_weights else 0
    hi = lo + (1 << spec.weight_bits) - 1
    w = torch.where(torch.arange(N, device=dev) % 2 == 0, lo, hi).to(torch.int32).expand(K, N).contiguous()
    return x, w


def run_case(kind, label, M, K, N, spec, adc_cfg, sparse, skip, seed, dev, timed, extreme=False, cells=None):
    """``extreme``: extreme codes (fast and paper kernels); ``cells`` (noisy kernel):
    "max" puts every cell at 2**cell_bits - 1 and every input code at its
    maximum (every partial reaches partial_max), "zero" every cell at 0."""
    rng = np.random.default_rng(seed)
    if extreme:
        x, w = extreme_codes(M, K, N, spec, dev)
    else:
        x = make_x(rng, M, K, spec.input_bits, sparse, dev)
        w = make_w(rng, K, N, spec, dev)
    if cells == "max":
        x = torch.full((M, K), (1 << spec.input_bits) - 1, dtype=torch.int32, device=dev)
    if kind == "noisy":
        if cells is None:
            cells = effective_cell_codes(w + spec.weight_bias, spec, NOISY_DEVICE.replace(sigma=0.1))
        else:
            level = (1 << spec.cell_bits) - 1 if cells == "max" else 0
            cells = torch.full((spec.n_slices, K, N), float(level), dtype=torch.float32, device=dev)
        kernel = lambda: noisy_vmm_cuda(x, cells, spec, adc_cfg, skip_zero_planes=skip)
        plain = lambda: noisy_vmm_plain(x, cells, spec, adc_cfg)
    else:
        fast = kind == "fast"
        kernel = lambda: crossbar_vmm_cuda(x, w, spec, adc_cfg, fast=fast, skip_zero_planes=skip)
        plain = lambda: torch.cat([
            crossbar_vmm_plain(x, w[:, n0:n0 + PLAIN_N_CHUNK], spec, adc_cfg, fast=fast)
            for n0 in range(0, N, PLAIN_N_CHUNK)
        ], dim=-1)
    y = kernel()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y_ref = plain()
    torch.cuda.synchronize()
    plain_first_s = time.perf_counter() - t0
    equal = bool(torch.equal(y, y_ref))
    out_min, out_max = spec.out_range
    case = dict(
        kernel=KERNELS[kind]["name"], case=label, M=M, K=K, N=N, shape=[M, K, N], drop_lsb=spec.drop_lsb,
        adc=(adc_cfg.mode if adc_cfg else "full"), signed=spec.signed_weights,
        sparse_x=sparse, skip_zero_planes=skip, equal=equal,
        max_abs_err=int((y.long() - y_ref.long()).abs().max()),
        saturated_frac=float(((y_ref == out_min) | (y_ref == out_max)).float().mean()),
        out_max_frac=float((y_ref == out_max).float().mean()),
    )
    if not equal:
        emit({"phase": "kernels", "failed_case": case})
        raise AssertionError(f"kernel {kind} disagrees with its plain version: {case}")
    if timed:
        # call_ms: one eager call of the wrapper, host time included (what
        # the main path pays); kernel_ms: device time alone (graph replay)
        case["call_ms"] = cuda_ms(kernel, reps=10)
        case["kernel_ms"] = graph_ms(kernel)
        case["kernel_ms_cold"] = cold_ms(kernel)  # a real tick finds its weights cold
        # the plain version of a wide layer takes seconds: time it once then
        case["plain_ms"] = cuda_ms(plain, reps=(1 if plain_first_s > 1.0 else 3), warmup=0)
        case["bound_ms"], case["bound_by"], case["stored_bytes_ms"] = bound_ms(kind, x, N, spec)
        case["library_ms"] = None
        if kind == "fast":
            # yardstick only, never used by the port: one float64 matmul
            # gives the exact accumulator (sums stay below 2**53)
            xd, wd = x.double(), (w + spec.weight_bias).double()
            case["library_ms"] = cuda_ms(lambda: torch.matmul(xd, wd), reps=10)
    return case


def kernels_phase(dev, quick: bool):
    unsigned = DEFAULT_SPEC.replace(signed_weights=False)
    variants = [
        ("cell4dac2", CrossbarSpec(cell_bits=4, dac_bits=2)),
        ("w8a8", CrossbarSpec(weight_bits=8, input_bits=8, out_bits=8, drop_lsb=7)),
        ("rows64", CrossbarSpec(rows=64)),
        # 3-bit digits and cells: digits and cell slices that straddle the
        # byte planes the paper and noisy kernels cut them from (drop_lsb of
        # layer_scaled_spec at K = 200, so that the outputs do not saturate)
        ("cell3dac3", CrossbarSpec(cell_bits=3, dac_bits=3, drop_lsb=24)),
    ]
    # (kind, tag, base spec, adc config)
    families = [
        ("fast", "ideal", DEFAULT_SPEC, None),
        ("fast", "ideal_unsigned", unsigned, None),
        ("planes", "safe_adaptive_signed", DEFAULT_SPEC, adc.SAFE_ADAPTIVE),
        ("planes", "safe_adaptive_unsigned", unsigned, adc.SAFE_ADAPTIVE),
        ("noisy", "safe_adaptive_signed", DEFAULT_SPEC, adc.SAFE_ADAPTIVE),
        ("noisy", "full_adc_unsigned", unsigned, None),
    ]
    cases = []
    seed = 0
    for kind, tag, base, cfg in families:
        main = tag in ("ideal", "safe_adaptive_signed")
        # main-path shapes, layer-scaled spec (drop_lsb >= 20): M = 4 is a
        # decode tick, 32 and 64 are prefill buckets (256 below)
        for K, N in (MAIN_SHAPES[:2] if quick else MAIN_SHAPES):
            for M in ((4,) if quick else (4, 32, 64) if main else (4, 32)):
                seed += 1
                cases.append(run_case(
                    kind, f"{tag}/main", M, K, N, layer_scaled_spec(base, K), cfg,
                    sparse=False, skip=True, seed=seed, dev=dev, timed=main,
                ))
        if main and not quick:
            # M = 256 and 128: the prefill buckets past 64 (the traffic mix's
            # long prompts at 256, prefill_vs_eager_* at both), on each
            # kernel of a served chip; seeds of their own: the other cases
            # keep theirs.  A prefill's head runs on its last position only
            # (M = 1, the case after the 256 ones): the head at M = 256 is
            # timed on the fast and noisy kernels but is off the path
            for K, N in (MAIN_SHAPES[:-1] if kind == "planes" else MAIN_SHAPES):
                cases.append(run_case(
                    kind, f"{tag}/main", 256, K, N, layer_scaled_spec(base, K), cfg,
                    sparse=False, skip=True, seed=9000 + len(cases), dev=dev, timed=True,
                ))
            K, N = MAIN_SHAPES[-1]
            cases.append(run_case(
                kind, f"{tag}/prefill_head", 1, K, N, layer_scaled_spec(base, K), cfg,
                sparse=False, skip=True, seed=9000 + len(cases), dev=dev, timed=True,
            ))
            for K, N in MAIN_SHAPES[:-1]:
                cases.append(run_case(
                    kind, f"{tag}/main", 128, K, N, layer_scaled_spec(base, K), cfg,
                    sparse=False, skip=True, seed=9000 + len(cases), dev=dev, timed=True,
                ))
        if kind == "fast" and tag == "ideal":
            # the xlstm-350m head: M = 1 is a prefill's last position, M = 4
            # a decode tick of the slot pool
            for M in (1, 4):
                seed += 1
                cases.append(run_case(
                    kind, f"{tag}/xlstm_head", M, *XLSTM_HEAD, layer_scaled_spec(base, XLSTM_HEAD[0]),
                    cfg, sparse=False, skip=True, seed=seed, dev=dev, timed=True,
                ))
            # the dense configs' projections and heads (seeds of their own:
            # the other cases keep theirs); gemma2's projections also at
            # every bucket prefill_vs_eager_gemma2 runs, and each head at M =
            # 1, a prefill's last position (untimed)
            for arch, shapes in DENSE_SHAPES.items():
                for K, N in (shapes[:1] if quick else shapes + [DENSE_HEADS[arch]]):
                    head = (K, N) == DENSE_HEADS[arch]
                    if quick:
                        rows = (4,)
                    elif head:
                        rows = (4, 1) if arch == "gemma2-9b" else (4, 32, 1)
                    else:
                        rows = (4, 32) + (DENSE_BUCKETS if arch == "gemma2-9b" else ())
                    for M in rows:
                        cases.append(run_case(
                            kind, f"{tag}/{arch}", M, K, N, layer_scaled_spec(base, K), cfg,
                            sparse=False, skip=True, seed=7000 + len(cases), dev=dev, timed=True,
                        ))
                        torch.cuda.empty_cache()
            # kimi-k2's projections and head (seeds of their own)
            for (K, N), rows in (KIMI_SHAPES[:1] if quick else KIMI_SHAPES):
                for M in (rows[:1] if quick else rows):
                    cases.append(run_case(
                        kind, f"{tag}/{KIMI}", M, K, N, layer_scaled_spec(base, K), cfg,
                        sparse=False, skip=True, seed=6000 + len(cases), dev=dev, timed=M in KIMI_TIMED_M,
                    ))
                    torch.cuda.empty_cache()
            # deepseek-v2's MoE projections, whole and as rank slices (seeds
            # of their own)
            for (K, N), rows in (DEEPSEEK_SHAPES[:1] if quick else DEEPSEEK_SHAPES):
                for M in (rows[:1] if quick else rows):
                    cases.append(run_case(
                        kind, f"{tag}/{DEEPSEEK}", M, K, N, layer_scaled_spec(base, K), cfg,
                        sparse=False, skip=True, seed=6800 + len(cases), dev=dev, timed=True,
                    ))
            # jamba-v0.1-52b's projections and head (seeds of their own)
            for (K, N), rows in (JAMBA_SHAPES[:1] if quick else JAMBA_SHAPES):
                for M in (rows[:1] if quick else rows):
                    cases.append(run_case(
                        kind, f"{tag}/{JAMBA}", M, K, N, layer_scaled_spec(base, K), cfg,
                        sparse=False, skip=True, seed=6900 + len(cases), dev=dev, timed=True,
                    ))
                    torch.cuda.empty_cache()
            # musicgen-large's and pixtral-12b's projections and heads
            # (seeds of their own)
            for arch, shapes in EMBED_SHAPES.items():
                for (K, N), rows in (shapes[:1] if quick else shapes):
                    for M in (rows[:1] if quick else rows):
                        cases.append(run_case(
                            kind, f"{tag}/{arch}", M, K, N, layer_scaled_spec(base, K), cfg,
                            sparse=False, skip=True, seed=6950 + len(cases), dev=dev, timed=True,
                        ))
                        torch.cuda.empty_cache()
            if not quick:
                # the trained chip's loss (train_then_serve): every projection
                # at the training batch's B x S rows, the tied head at one loss
                # chunk's B x c rows (untimed; seeds of their own)
                rows = TRAIN_BATCH * TRAIN_SEQ
                head_rows = TRAIN_BATCH * model_lib.loss_chunk(TRAIN_SEQ)
                for K, N in MAIN_SHAPES:
                    cases.append(run_case(
                        kind, f"{tag}/train_loss", head_rows if (K, N) == MAIN_SHAPES[-1] else rows, K, N,
                        layer_scaled_spec(base, K), cfg, sparse=False, skip=True, seed=9500 + len(cases),
                        dev=dev, timed=False,
                    ))
                torch.cuda.empty_cache()
            seed = fast_edge_cases(cases, base, seed, dev, quick)
        if tag == "safe_adaptive_signed" and not quick:
            # off this slice's path: their deepest K loops yet, untimed
            for K in DEEP_K:
                cases.append(run_case(
                    kind, f"{tag}/deep_k", 4, K, 3584, layer_scaled_spec(base, K), cfg,
                    sparse=False, skip=True, seed=8000 + len(cases), dev=dev, timed=False,
                ))
        if kind == "noisy" and tag == "safe_adaptive_signed" and not quick:
            # an expert's wi / wg and wo of kimi-k2 at its capacity of 8 rows
            # (moe_expert_chips; seeds of their own)
            for K, N in KIMI_SHAPES[0][0], KIMI_SHAPES[1][0]:
                cases.append(run_case(
                    kind, f"{tag}/{KIMI}", 8, K, N, layer_scaled_spec(base, K), cfg,
                    sparse=False, skip=True, seed=6500 + len(cases), dev=dev, timed=True,
                ))
        if kind == "noisy":
            seed = mma_edge_cases(kind, cases, tag, base, cfg, seed, dev, quick)
        if kind == "planes":  # seeds of their own: the other cases keep theirs
            mma_edge_cases(kind, cases, tag, base, cfg, 5000 + 100 * len(cases), dev, quick)
        # ragged K=160 (1.25 row groups), N=16: dense / sparse x, both skips,
        # DEFAULT_SPEC (drop 10, the d < 20 branch) and the layer-scaled spec
        for spec in (base, layer_scaled_spec(base, 160)):
            for sparse in (False, True):
                for skip in (True, False):
                    seed += 1
                    cases.append(run_case(
                        kind, f"{tag}/ragged", 2, 160, 16, spec, cfg, sparse, skip, seed, dev,
                        timed=False,
                    ))
        for vname, vspec in variants:
            vspec = vspec.replace(signed_weights=base.signed_weights)
            vcfg = None if cfg is None else adc.ADCConfig(guard_bits=2)
            seed += 1
            cases.append(run_case(
                kind, f"{tag}/{vname}", 4, 200, 24, vspec, vcfg, False, True, seed, dev, timed=False,
            ))
    for name in (KERNELS["planes"]["name"], KERNELS["noisy"]["name"]):
        flagged = [
            c for c in cases
            if c["kernel"] == name and not c["signed"] and c["adc"] != "full" and c["out_max_frac"] > 0
        ]
        require(flagged, f"no unsigned adaptive case of {name} saturated: its detect flags were never exercised")
    return cases


def fast_edge_cases(cases, base, seed, dev, quick):
    """The fast kernel's edges: row counts on both sides of its wmma tiles
    and row blocks (decode up to 8 rows, prefill blocks of 32) at the main
    shapes; ragged N and K, incl. N and K that are no multiple of 4 (4 B
    copies instead of 16 B); extreme codes, and the int32 fold."""
    for K, N in (MAIN_SHAPES[:1] if quick else MAIN_SHAPES):
        for M in ((5, 33) if quick else (1, 3, 5, 8, 9, 33)):
            seed += 1
            cases.append(run_case(
                "fast", "ideal/tile_edge", M, K, N, layer_scaled_spec(base, K), None,
                sparse=False, skip=True, seed=seed, dev=dev, timed=False,
            ))
    ragged = [(960, n) for n in (16, 40, 100, 37)] + [(k, 64) for k in (160, 1000, 1001)]
    for K, N in ragged:
        for M in (3, 33):
            seed += 1
            cases.append(run_case(
                "fast", "ideal/ragged_nk", M, K, N, layer_scaled_spec(base, K), None,
                sparse=False, skip=True, seed=seed, dev=dev, timed=False,
            ))
    for M, K in ((4, 33024), (64, 40960)):
        cases.append(run_case(
            "fast", "ideal/extreme_codes", M, K, 64, layer_scaled_spec(base, K), None,
            sparse=False, skip=True, seed=0, dev=dev, timed=False, extreme=True,
        ))
    cases.append(fold_case(base, dev))
    return seed


def mma_edge_cases(kind, cases, tag, base, cfg, seed, dev, quick):
    """The edges of the paper ("planes") and noisy kernels, one pipeline.
    Main family: row counts on both sides of their blocks (64 digit rows: 4
    input rows at 16 digits) at a wide and a narrow layer (the narrow one
    splits K over a cluster); ragged N and K, incl. N and K that are no
    multiple of 4 (cp.async copies instead of TMA); one-bit cells under
    8-bit digits (the int64 shift-add).  Every family, paper kernel: every
    input code at its maximum with the weight codes at both ends of their
    range, at the layer-scaled spec and at DEFAULT_SPEC's drop_lsb of 10
    (where the unsigned family's detect flags fire); noisy kernel: all cells
    at their maximum with every input code at its maximum (every partial
    saturates at partial_max), and all cells at 0, and the unsigned spec
    also through the adaptive ADC, whose detect flags fire there."""
    if tag == "safe_adaptive_signed":
        for K, N in ((960, 5120),) if quick else ((960, 5120), (960, 320)):
            for M in ((5, 33) if quick else (1, 3, 5, 8, 9, 33)):
                seed += 1
                cases.append(run_case(
                    kind, f"{tag}/tile_edge", M, K, N, layer_scaled_spec(base, K), cfg,
                    sparse=False, skip=True, seed=seed, dev=dev, timed=False,
                ))
        ragged = [(960, n) for n in (16, 40, 100, 37)] + [(k, 64) for k in (160, 1000, 1001)]
        for K, N in ragged:
            for M in (3, 33):
                seed += 1
                cases.append(run_case(
                    kind, f"{tag}/ragged_nk", M, K, N, layer_scaled_spec(base, K), cfg,
                    sparse=False, skip=True, seed=seed, dev=dev, timed=False,
                ))
        # one-bit cells under 8-bit digits: a row group's shift-add no longer
        # fits the kernel's int32 path and takes its int64 one
        for vcfg in (None, adc.ADCConfig(guard_bits=2)):
            seed += 1
            cases.append(run_case(
                kind, f"{tag}/cell1dac8", 9, 300, 40,
                layer_scaled_spec(CrossbarSpec(cell_bits=1, dac_bits=8), 300), vcfg,
                sparse=False, skip=True, seed=seed, dev=dev, timed=False,
            ))
    if kind == "planes":
        for spec in (layer_scaled_spec(base, 1000), base):
            cases.append(run_case(
                kind, f"{tag}/extreme_codes", 5, 1000, 100, spec, cfg,
                sparse=False, skip=True, seed=0, dev=dev, timed=False, extreme=True,
            ))
        return seed
    for cells in ("max", "zero"):
        seed += 1
        cases.append(run_case(
            "noisy", f"{tag}/cells_{cells}", 5, 1000, 100, layer_scaled_spec(base, 1000), cfg,
            sparse=False, skip=True, seed=seed, dev=dev, timed=False, cells=cells,
        ))
    if not base.signed_weights:
        # the adaptive ADC has detect positions only at a small drop_lsb
        # (DEFAULT_SPEC's 10): sparse and dense codes, and every cell at its
        # maximum
        for sparse, cells in ((True, None), (False, None), (False, "max")):
            seed += 1
            cases.append(run_case(
                "noisy", "safe_adaptive_unsigned/detect", 5, 1000, 100, base, adc.SAFE_ADAPTIVE,
                sparse=sparse, skip=True, seed=seed, dev=dev, timed=False, cells=cells,
            ))
    return seed


def fold_case(base, dev):
    """Extreme codes where every warp's int32 byte-plane sums must be folded
    into int64 on the way: M = 32 (each warp of a prefill block sums all K
    rows of its tile), K = 33792 > 33025 rows (the most an int32 holds at
    255 * 255 a row) and a grid of two blocks an SM, so that K is not split
    over blocks.  Held against the exact product in float64 (the sums stay
    below 2**53) requantized in int64, which is the plain version's function:
    the plain datapath itself would need tens of GB at this size."""
    M, K = 32, 33792
    N = 64 * 2 * torch.cuda.get_device_properties(dev).multi_processor_count
    spec = layer_scaled_spec(base, K)
    x, w = extreme_codes(M, K, N, spec, dev)
    y = crossbar_vmm_cuda(x, w, spec, None, fast=True)
    acc = torch.matmul(x.double(), w.double()).round().long()
    out_min, out_max = spec.out_range
    y_ref = torch.clamp((acc + (1 << (spec.drop_lsb - 1))) >> spec.drop_lsb, out_min, out_max).int()
    equal = bool(torch.equal(y, y_ref))
    case = dict(
        kernel=KERNELS["fast"]["name"], case="ideal/int32_fold", M=M, K=K, N=N, shape=[M, K, N],
        drop_lsb=spec.drop_lsb, adc="full", signed=spec.signed_weights, sparse_x=False,
        skip_zero_planes=True, equal=equal, max_abs_err=int((y.long() - y_ref.long()).abs().max()),
        saturated_frac=float(((y_ref == out_min) | (y_ref == out_max)).float().mean()),
        reference="exact float64 product, requantized",
    )
    del x, w, acc
    torch.cuda.empty_cache()
    if not equal:
        emit({"phase": "kernels", "failed_case": case})
        raise AssertionError(f"kernel fast disagrees with the exact product: {case}")
    return case


def scan_bound_ms(B, S, H, dh, esize, saved=False):
    """Least time for one scan: max(bytes / HBM rate, operations / float32
    rate).  Bytes: the four recurrent matrices, ``pre`` and ``h_all`` at
    ``esize`` bytes a value, the six (B, H, dh) float32 state tensors, each
    once, and with ``saved`` the six float32 planes the saving forward
    writes.  Operations: the four h . R products of every step, 2 B S 4 H
    dh^2 (float32: the function sums float32 products).  The S sequential
    steps are not part of it."""
    nbytes = 4 * H * dh * dh * esize + B * S * 5 * H * dh * esize + 6 * B * H * dh * 4
    nbytes += B * S * H * dh * 4 * len(kscan.SAVED_PLANES) if saved else 0
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2.0 * B * S * 4 * H * dh * dh / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _bf16_ulps(a, b):
    """Distance in bfloat16 ULPs (ordered view of the bit patterns)."""
    def ordered(t):
        i = t.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


def scan_agreement(got, ref, dtype):
    """``SCAN_TOLERANCE`` on (h_all, c1, n1, h1): whether each output is
    within it, each one's max |error|, and h_all's max bfloat16 ULPs."""
    err = [(g.float() - r.float()).abs() for g, r in zip(got, ref)]
    within = [bool((e <= 1e-5 + 1e-5 * r.float().abs()).all()) for e, r in zip(err, ref)]
    max_ulps = None
    if dtype == torch.bfloat16:
        ulps = _bf16_ulps(got[0], ref[0])
        max_ulps = int(ulps.max())
        within[0] = bool(((ulps <= 1) | (err[0] <= 1e-5)).all())
    return within, [float(e.max()) for e in err], max_ulps


def run_scan_case(label, B, S, H, dh, dtype, seed, dev, timed):
    """The scan kernel against its plain version from a mid-sequence state
    (8 plain steps from the initial c = 0, n = 1, h = 0)."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    pre = normal(B, S, 4, H, dh).to(dtype)
    rs = [(normal(H, dh, dh) * dh**-0.5).to(dtype) for _ in range(4)]
    zero = torch.zeros((B, H, dh), device=dev)
    _, c0, n0, h0 = slstm_scan_plain(normal(B, 8, 4, H, dh).to(dtype), *rs, zero, zero + 1.0, zero)
    kernel = lambda: slstm_scan_cuda(pre, *rs, c0, n0, h0)
    plain = lambda: slstm_scan_plain(pre, *rs, c0, n0, h0)
    plan = kscan.plan_scan(B, S, H, dh, pre.element_size(), kscan.card_max_cluster(dtype))
    got = kernel()
    torch.cuda.synchronize()
    ref = plain()
    torch.cuda.synchronize()
    require(
        [(t.shape, t.dtype) for t in got] == [(t.shape, t.dtype) for t in ref],
        f"scan outputs {[(t.shape, t.dtype) for t in got]} != {[(t.shape, t.dtype) for t in ref]}",
    )
    within, err, max_ulps = scan_agreement(got, ref, dtype)
    case = dict(
        kernel=KERNELS["slstm"]["name"], case=label, dtype=str(dtype).replace("torch.", ""),
        B=B, S=S, H=H, dh=dh, shape=[B, S, H, dh], steps=S, equal=all(within),
        max_abs_err=max(err), max_bf16_ulps=max_ulps,
        equal_by_output=dict(zip(("h_all", "c1", "n1", "h1"), within)),
        plan=plan._asdict(),
    )
    if not case["equal"]:
        emit({"phase": "kernels", "failed_case": case})
        raise AssertionError(f"scan kernel disagrees with its plain version: {case}")
    if timed:
        case["call_ms"] = cuda_ms(kernel, reps=10)
        case["kernel_ms"] = graph_ms(kernel)
        case["kernel_ms_cold"] = cold_ms(kernel)  # a real tick finds R cold
        case["plain_ms"] = cuda_ms(plain, reps=3, warmup=1)
        case["bound_ms"], case["bound_by"] = scan_bound_ms(B, S, H, dh, pre.element_size())
        case["library_ms"] = None  # no one PyTorch call computes the sLSTM scan
    return case


def scan_bwd_bound_ms(B, S, H, dh, esize):
    """Least time for one backward: max(bytes / HBM rate, operations /
    float32 rate).  Bytes: the six saved float32 planes and ``dh_all`` read,
    ``g`` (four float32 planes) written, the four recurrent matrices and the
    eight (B, H, dh) float32 states and carries, each once.  Operations: the
    four R . g products of every step, 2 B S 4 H dh^2 float32."""
    nbytes = B * S * H * dh * (4 * len(kscan.SAVED_PLANES) + esize + 4 * 4) + 4 * H * dh * dh * esize
    nbytes += 8 * B * H * dh * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2.0 * B * S * 4 * H * dh * dh / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def timed_once(fn):
    """``fn()`` and its milliseconds by CUDA events (one call)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def torch_rel_l2(a, ref) -> float:
    a, ref = a.double(), ref.double()
    return float((a - ref).norm() / ref.norm().clamp(min=1e-300))


def run_scan_train_case(label, B, S, H, dh, dtype, seed, dev, timed):
    """The saving forward and the backward of the scan against their plain
    versions, from the training state (c = 0, n = 1, h = 0), with seeded
    gradients for h_all and the final state.  The saving forward's h_all /
    c1 / n1 / h1 against the serving kernel's (``SCAN_TOLERANCE``) and its
    planes against the plain version's; the backward on the kernel's planes
    against the plain backward on the same, on g, the carries and dR
    (``scan_train_rel_max``).  Returns the two cases."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    pre = normal(B, S, 4, H, dh).to(dtype)
    rs = [(normal(H, dh, dh) * dh**-0.5).to(dtype) for _ in range(4)]
    c0, h0, n0 = torch.zeros((B, H, dh), device=dev), torch.zeros((B, H, dh), device=dev), torch.ones((B, H, dh), device=dev)
    dh_all = normal(B, S, H, dh).to(dtype)
    carries = [normal(B, H, dh) for _ in range(3)]
    save = lambda: kscan.slstm_scan_save_cuda(pre, *rs, c0, n0, h0)  # noqa: E731
    got = save()
    served = slstm_scan_cuda(pre, *rs, c0, n0, h0)
    plain_saved, save_plain_ms = timed_once(lambda: kscan.slstm_scan_save_plain(pre, *rs, c0, n0, h0)[4])
    bar = scan_train_rel_max(S)
    within, err, max_ulps = scan_agreement(got[:4], served, dtype)
    plane_err = {n: torch_rel_l2(got[4][k], plain_saved[k]) for k, n in enumerate(kscan.SAVED_PLANES)}
    save_case = dict(
        kernel=KERNELS["slstm_save"]["name"], case=label, dtype=str(dtype).replace("torch.", ""),
        B=B, S=S, H=H, dh=dh, shape=[B, S, H, dh], steps=S,
        equal=all(within) and all(e <= bar for e in plane_err.values()),
        max_abs_err=max(err), max_bf16_ulps=max_ulps,
        equal_to_serving_kernel=dict(zip(("h_all", "c1", "n1", "h1"), within)),
        bit_equal_to_serving_kernel=all(torch.equal(a, b) for a, b in zip(got[:4], served)),
        planes_rel_l2_to_plain=plane_err, rel_l2_max=bar,
        plan=kscan.plan_scan(B, S, H, dh, pre.element_size(), kscan.card_max_cluster(dtype))._asdict(),
    )
    del served, plain_saved
    saved = got[4]
    bwd = lambda: kscan.slstm_scan_bwd_cuda(dh_all, saved, *rs, c0, n0, *carries)  # noqa: E731
    plain = lambda: kscan.slstm_scan_bwd_plain(dh_all, saved, *rs, c0, n0, *carries)  # noqa: E731
    kg = bwd()
    pg, bwd_plain_ms = timed_once(plain)
    h_prev = kscan.h_before_each_step(saved, h0)
    d_r = [torch.einsum("bshd,bsghe->ghde", h_prev, g[0]) for g in (kg, pg)]
    errs = {n: torch_rel_l2(k, p) for n, k, p in zip(("g", "dc0", "dn0", "dh0"), kg, pg)}
    errs["dR"] = torch_rel_l2(*d_r)
    bwd_case = dict(
        kernel=KERNELS["slstm_bwd"]["name"], case=label, dtype=str(dtype).replace("torch.", ""),
        B=B, S=S, H=H, dh=dh, shape=[B, S, H, dh], steps=S, equal=all(e <= bar for e in errs.values()),
        max_abs_err=max(float((k - p).abs().max()) for k, p in zip(kg, pg)),
        rel_l2_to_plain=errs, rel_l2_max=bar,
        plan=kscan.plan_scan_bwd(B, S, H, dh, pre.element_size(), kscan.card_max_cluster(dtype, True))._asdict(),
    )
    del kg, pg, d_r, h_prev
    for case, name in ((save_case, "saving forward"), (bwd_case, "backward")):
        if not case["equal"]:
            emit({"phase": "kernels", "failed_case": case})
            raise AssertionError(f"scan {name} disagrees with its plain version: {case}")
    if timed:
        for case, kernel, plain_ms, bound in (
            (save_case, save, save_plain_ms, scan_bound_ms(B, S, H, dh, pre.element_size(), saved=True)),
            (bwd_case, bwd, bwd_plain_ms, scan_bwd_bound_ms(B, S, H, dh, pre.element_size())),
        ):
            case["call_ms"] = cuda_ms(kernel, reps=10)
            case["kernel_ms"] = graph_ms(kernel, launches=5 if S > 48 else 20)
            case["plain_ms"] = plain_ms  # the comparison's call: a loop of S steps
            case["bound_ms"], case["bound_by"] = bound
            case["library_ms"] = None  # no one PyTorch call computes the scan or its backward
    torch.cuda.empty_cache()
    return [save_case, bwd_case]


def scan_train_cases(dev, quick: bool):
    cases = []
    seed = 1500
    for dtype in ((torch.bfloat16,) if quick else (torch.bfloat16, torch.float32)):
        for label, B, S, H, dh, timed in (SCAN_TRAIN_CASES[1:2] if quick else SCAN_TRAIN_CASES):
            seed += 1
            cases += run_scan_train_case(label, B, S, H, dh, dtype, seed, dev, timed)
    return cases


def scan_cases(dev, quick: bool):
    cases = []
    seed = 1000
    for dtype in ((torch.bfloat16,) if quick else (torch.bfloat16, torch.float32)):
        for B, S in (SCAN_SHAPES[::3] if quick else SCAN_SHAPES):
            seed += 1
            cases.append(run_scan_case("main", B, S, SCAN_HEADS, SCAN_DH, dtype, seed, dev, timed=True))
        for label, B, S, H, dh in (SCAN_EDGES[:1] if quick else SCAN_EDGES):
            seed += 1
            cases.append(run_scan_case(label, B, S, H, dh, dtype, seed, dev, timed=False))
    return cases


def kernel_summary(cases, launches, launches_by_path):
    """One entry per kernel: the contract's keys (headline numbers are those
    of the case ``KERNELS[...]["headline"]`` names: for the VMM kernels the
    decode shape M=4, 960x5120, the widest per-layer projection of
    smollm-360m; for the scan a bf16 decode tick of xlstm-350m) and every case
    it was held against its plain version in, each with ``equal`` and, where
    timed, its times and bound."""
    out = []
    for kind, meta in KERNELS.items():
        mine = [{k: v for k, v in c.items() if k != "kernel"} for c in cases if c["kernel"] == meta["name"]]
        timed = [c for c in mine if "kernel_ms" in c]
        head = next(
            (c for c in timed if all(c[k] == v for k, v in meta["headline"].items())), timed[0]
        )
        out.append(dict(
            name=meta["name"], route="cuda", source=meta["source"], replaces=meta["replaces"],
            launches=launches[meta["counter"]],
            launches_by_path={p: n[meta["counter"]] for p, n in launches_by_path.items()},
            max_abs_err=max(c["max_abs_err"] for c in mine),
            shape=head["shape"],
            ms=head["kernel_ms"], kernel_ms=head["kernel_ms"], call_ms=head["call_ms"],
            kernel_ms_cold=head.get("kernel_ms_cold"),
            plain_ms=head["plain_ms"], bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            stored_bytes_ms=head.get("stored_bytes_ms"),
            library_ms=head["library_ms"], tolerance=meta["tolerance"],
            equal=all(c["equal"] for c in mine), cases=mine,
        ))
    return out


# ---------------------------------------------------------------------------
# planned datapaths phase
# ---------------------------------------------------------------------------

def _dnc_codes(datapath, xq, art):
    """Output codes of a planned artifact's datapath (the function
    ``programmed_matmul`` routes it to)."""
    if datapath == "strassen":
        return strassen_matmul(xq, art.w_codes, art.spec, levels=1)
    return karatsuba_vmm(xq, art.w_codes, art.spec, levels=art.plan.karatsuba_levels)


def planned_datapaths(dev, quick: bool):
    """Each planned divide-and-conquer datapath against the fast kernel on
    the artifacts ``program_layer(plan=)`` compiles, at the main-path
    shapes: output codes ``torch.equal`` to K1's (and again with TF32
    allowed for the call: the sub-products are float64 matmuls, which TF32
    does not touch), the planned ``programmed_matmul`` equal to the
    unplanned one, each timed with CUDA events (median of 10 eager calls,
    and per call of a captured graph) beside K1 and beside one float64
    ``torch.matmul`` of the same codes; then one planned noisy projection
    on a stuck-free chip equal to the unplanned noisy chip's (the noisy
    kernel serves both under the plan's ADC schedule)."""
    rng = np.random.default_rng(77)
    cases = []
    for K, N in (MAIN_SHAPES[:2] if quick else MAIN_SHAPES):
        w = torch.from_numpy((rng.normal(size=(K, N)) * K**-0.5).astype(np.float32)).to(dev)
        base = tprog.program_layer(w)
        arts = {dp: tprog.program_layer(w, plan=LayerPlan(name=f"{K}x{N}", datapath=dp, adc_mode="safe_adaptive"))
                for dp in PLANNED}
        spec = base.spec
        wd = (base.w_codes + spec.weight_bias).double()
        for M in ((4,) if quick else (4, 32)):
            x = torch.from_numpy(np.abs(rng.normal(size=(M, K))).astype(np.float32)).to(dev)
            x_scale = torch.clamp(torch.max(x), min=1e-9) / ((1 << spec.input_bits) - 1)
            xq = quantize_input(x, spec, x_scale)
            k1 = lambda: crossbar_vmm_cuda(xq, base.w_codes, spec, None, fast=True)
            y_k1 = k1()
            y_base = tprog.programmed_matmul(x, base)
            xd = xq.double()
            k1_ms = cuda_ms(k1, reps=10)
            f64_ms = cuda_ms(lambda: torch.matmul(xd, wd), reps=10)
            for dp, art in arts.items():
                fn = lambda: _dnc_codes(dp, xq, art)
                y = fn()
                torch.backends.cuda.matmul.allow_tf32 = True
                try:
                    y_tf32 = fn()
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = False
                tprog.reset_planned_calls()
                y_art = tprog.programmed_matmul(x, art)
                routed = dict(tprog.PLANNED_CALLS)
                case = dict(
                    datapath=dp, M=M, K=K, N=N, drop_lsb=spec.drop_lsb, equal=bool(torch.equal(y, y_k1)),
                    equal_tf32=bool(torch.equal(y_tf32, y_k1)),
                    programmed_matmul_equal=bool(torch.equal(y_art, y_base)),
                    routed=routed[dp] == 1 and sum(routed.values()) == 1,
                    max_abs_err=int((y.long() - y_k1.long()).abs().max()),
                    ms=cuda_ms(fn, reps=10), graph_ms=graph_ms(fn, launches=5, reps=5),
                    k1_ms=k1_ms, float64_matmul_ms=f64_ms,
                )
                cases.append(case)
                if not (case["equal"] and case["equal_tf32"] and case["programmed_matmul_equal"] and case["routed"]):
                    emit({"phase": "planned_datapaths", "failed_case": case})
                    raise AssertionError(f"planned datapath {dp} disagrees with the fast kernel: {case}")
        del base, arts, wd
        torch.cuda.empty_cache()
    # a planned noisy projection: the noisy kernel under the plan's ADC
    K, N = MAIN_SHAPES[2]
    w = torch.from_numpy((rng.normal(size=(K, N)) * K**-0.5).astype(np.float32)).to(dev)
    x = torch.from_numpy(np.abs(rng.normal(size=(4, K))).astype(np.float32)).to(dev)
    noisy = tprog.program_layer(w, device_cfg=STUCK_FREE_DEVICE)
    planned = tprog.program_layer(
        w, device_cfg=STUCK_FREE_DEVICE, plan=LayerPlan(name="noisy", datapath="karatsuba2", adc_mode="safe_adaptive")
    )
    kvmm.reset_counters()
    tprog.reset_planned_calls()
    y_planned = tprog.programmed_matmul(x, planned)
    launches, planned_calls = dict(kvmm.LAUNCHES), sum(tprog.PLANNED_CALLS.values())
    noisy_case = dict(
        M=4, K=K, N=N, device=dataclasses.asdict(STUCK_FREE_DEVICE), adc=dataclasses.asdict(planned.adc_cfg),
        equal=bool(torch.equal(y_planned, tprog.programmed_matmul(x, noisy))),
        noisy_launches=launches["noisy"], planned_calls=planned_calls,
    )
    require(
        noisy_case["equal"] and launches == {"fast": 0, "planes": 0, "noisy": 1} and planned_calls == 0,
        f"planned noisy projection: {noisy_case}",
    )
    kvmm.reset_counters()
    line = dict(
        phase="planned_datapaths", n_cases=len(cases), all_equal=all(c["equal"] for c in cases),
        all_equal_tf32=all(c["equal_tf32"] for c in cases), cases=cases, noisy=noisy_case,
    )
    emit(line)
    return line


# ---------------------------------------------------------------------------
# serve phases
# ---------------------------------------------------------------------------

def make_requests(cfg, seed, n=6, longest=48):
    """``n`` prompts of 8 to ``longest`` tokens from ``seed``."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=int(rng.integers(8, longest + 1))) for _ in range(n)]


class timed_admissions:
    """Within the block, every admission of ``runner`` (its prefill and the
    copy into the slot) is timed, device synchronised on both sides, by the
    length of the prefill that ran (``runner.prefill_len``: a bucket; a
    recurrent prompt's exact length): ``seconds[length]`` afterwards for
    the admissions that replayed their bucket's prefill graph (or, on a
    recurrent model, ran the prefill eagerly), ``capturing[length]`` for
    those that captured it first (warm-up, capture, then the replay): those
    after which the runner holds one prefill graph more."""

    def __init__(self, runner):
        self.runner, self.seconds, self.capturing = runner, {}, {}

    @property
    def count(self) -> int:
        return self.captures + sum(len(v) for v in self.seconds.values())

    @property
    def captures(self) -> int:
        return sum(len(v) for v in self.capturing.values())

    def __enter__(self):
        runner = self.runner

        def admit(cache, slot, req):
            length = runner.prefill_len(runner.check_prompt(req.prompt, req.truncate))
            graphs = len(runner.prefill_graphs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = type(runner).admit_slot(runner, cache, slot, req)
            torch.cuda.synchronize()
            times = self.capturing if len(runner.prefill_graphs) > graphs else self.seconds
            times.setdefault(length, []).append(time.perf_counter() - t0)
            return out

        runner.admit_slot = admit
        return self

    def __exit__(self, *exc):
        del self.runner.admit_slot


def drive(eng, prompts, max_new):
    """Submit, then step until drained; returns (requests, prefills, ticks,
    seconds, pure decode-tick seconds, tokens appended by decode ticks, the
    ``timed_admissions`` of the run: each request's prefill and the copy of
    its cache into its slot, timed apart from the ticks)."""
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)
    ticks = decoded = 0
    tick_s = []
    with timed_admissions(eng.runner) as adm:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while eng.pending or any(s is not None for s in eng.slots):
            admitted = len(eng.pending)
            t1 = time.perf_counter()
            n = eng.step()
            if n and len(eng.pending) == admitted:  # a pure decode tick
                tick_s.append(time.perf_counter() - t1)
            ticks += 1 if n else 0
            decoded += n
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    reqs = eng.run_until_done(max_ticks=0)  # the completion ledger
    return reqs, len(prompts), ticks, seconds, tick_s, decoded, adm


def prefill_fields(runner, adm, attention_admissions):
    """A run's prefill numbers for its line: the prefill graphs the runner
    holds (each bucket's capture seconds and pool bytes), their replays,
    held equal to ``attention_admissions`` (graphs built in the run, every
    one replayed once an admission), and the admissions' seconds (``adm``,
    a ``timed_admissions``), replaying and capturing apart."""
    graphs = runner.prefill_graphs
    replays = sum(g.replays for g in graphs.values())
    require(
        replays == attention_admissions and all(g.graph is not None for g in graphs.values()),
        f"{replays} prefill replays for {attention_admissions} attention admissions",
    )
    replayed = [x for v in adm.seconds.values() for x in v]
    return dict(
        prefill_graphs=sorted(graphs), prefill_replays=replays,
        prefill_capture_seconds={str(b): g.capture_seconds for b, g in sorted(graphs.items())},
        prefill_pool_bytes={str(b): g.pool_bytes for b, g in sorted(graphs.items())},
        prefill_seconds=sum(replayed), prefill_admissions=len(replayed),
        prefill_seconds_by_bucket={str(b): v for b, v in sorted(adm.seconds.items())},
        prefill_ms_median=1e3 * statistics.median(replayed) if replayed else None,
        capturing_admission_seconds={str(b): v for b, v in sorted(adm.capturing.items())},
    )


def serve_phase(phase, cfg, params, crossbar, counter, dev, seed, restore_check, plan=None, share=None, longest=48):
    """``counter``: the launch counter (or, for a planned chip, the
    ``PLANNED_CALLS`` datapath) that must count every projection of every
    forward; every other counter must stay at 0.  ``share``: the
    ``ExpertShare`` an MoE model's params hold.  ``longest``: the longest
    prompt of the traffic (``make_requests``)."""
    t0 = time.perf_counter()
    eng = ServingEngine(
        cfg, params, max_batch=4, max_seq=256, crossbar=crossbar, plan=plan, share=share, device=dev,
    )
    torch.cuda.synchronize()
    program_s = time.perf_counter() - t0
    n_proj = eng.programmed.calls_per_forward
    n_scan = sum(spec.repeats * spec.kinds.count("slstm") for spec in cfg.stages)
    prompts = make_requests(cfg, seed, longest=longest)
    reset_crossbar_misses()
    kvmm.reset_counters()  # counts are read for the serving run alone
    kscan.reset_counters()
    tprog.reset_planned_calls()
    reqs, prefills, ticks, seconds, tick_s, decoded, adm = drive(eng, prompts, max_new=16)
    launches = dict(kvmm.LAUNCHES, **kscan.LAUNCHES, **tprog.PLANNED_CALLS)
    graph = eng.runner.decode_graph
    require(
        graph is not None and graph.graph is not None and graph.replays == ticks,
        f"{graph.replays if graph else None} graph replays for {ticks} decode ticks",
    )
    plain_calls = dict(kvmm.PLAIN_CALLS, **kscan.PLAIN_CALLS)
    tokens = [r.generated for r in reqs]
    n_tok = sum(len(t) for t in tokens)
    require(len(reqs) == len(prompts) and all(r.done for r in reqs), "not every request finished")
    require(all(len(t) == 16 for t in tokens), f"token counts {[len(t) for t in tokens]}")
    require(all(0 <= tok < cfg.vocab_size for t in tokens for tok in t), "token id out of range")
    require(crossbar_misses() == (), f"crossbar misses under strict: {crossbar_misses()}")
    # a recurrent model samples each request's first token from its prefill
    # logits, an attention model from its first decode tick
    recurrent = cfg.family in ("ssm", "hybrid")
    require(
        decoded == n_tok - (len(reqs) if recurrent else 0),
        f"{decoded} tokens came from decode ticks out of {n_tok} (recurrent={recurrent})",
    )
    require(sum(plain_calls.values()) == 0, f"plain versions ran on the card path: {plain_calls}")
    forwards = prefills + ticks
    require(
        launches[counter] == n_proj * forwards,
        f"launches {launches} != {n_proj} projections x {forwards} forwards",
    )
    require(
        launches["slstm_scan"] == n_scan * forwards,
        f"scan launches {launches['slstm_scan']} != {n_scan} sLSTM layers x {forwards} forwards",
    )
    require(
        all(v == 0 for k, v in launches.items() if k not in (counter, "slstm_scan")),
        f"stray launches {launches}",
    )
    line = dict(
        phase=phase, arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        vocab=cfg.vocab_size, requests=len(reqs), prompt_lens=[len(p) for p in prompts],
        new_tokens=n_tok, prefills=prefills, decode_ticks=ticks, projections=n_proj,
        slstm_layers=n_scan, first_token_at_prefill=recurrent,
        launches=launches, plain_calls=plain_calls, misses=0,
        program_seconds=program_s, serve_seconds=seconds, tokens_per_s=n_tok / seconds,
        **prefill_fields(eng.runner, adm, 0 if recurrent else prefills),
        decode_tick_ms_median=(1e3 * statistics.median(tick_s) if tick_s else None),
        graph_replays=graph.replays, capture_seconds=graph.capture_seconds, capture_pool_bytes=graph.pool_bytes,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, tokens=tokens,
    )
    if restore_check:
        line.update(store_round_trip(phase, cfg, params, eng, prompts, tokens, dev))
    return line, launches, eng


def store_round_trip(phase, cfg, params, eng, prompts, tokens, dev):
    """Save ``eng``'s chip, pass it through ``verify_store``, restore it into
    a new engine and serve ``prompts`` again: the same ``tokens``."""
    crossbar = eng.crossbar
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        eng.save_artifacts(d)
        save_s = time.perf_counter() - t0
        expected = tprog.expected_artifact_names(params, tie_lm_head=eng.runner._tie_lm_head)
        report = verify_store(d, expected=expected)
        require(report.ok, f"{phase}: the saved chip fails verify_store: {report.summary()}")
        t0 = time.perf_counter()
        eng2 = ServingEngine(
            cfg, params, max_batch=4, max_seq=256, device=dev, restore_artifacts=d, share=eng.share,
            crossbar=CrossbarMode(enabled=True, strict=True, fast=crossbar.fast, device=crossbar.device),
        )
        restore_s = time.perf_counter() - t0
    reqs2 = drive(eng2, prompts, max_new=16)[0]
    require([r.generated for r in reqs2] == tokens, f"{phase}: the restored chip served different tokens")
    del eng2
    return dict(
        verify_store_findings=len(report.findings), verified_artifacts=report.n_artifacts,
        restore_identical=True, save_seconds=save_s, restore_seconds=restore_s,
    )


def depth_config(cfg, layers):
    """A one-stage config cut to its first ``layers`` layers (whole repeats
    of the stage's block pattern), at full width."""
    require(len(cfg.stages) == 1, f"{cfg.name}: a depth cut takes one stage")
    spec = cfg.stages[0]
    repeats = layers // len(spec.kinds)
    return dataclasses.replace(
        cfg, n_layers=repeats * len(spec.kinds), stages=(StageSpec(kinds=spec.kinds, repeats=repeats, moe=spec.moe),)
    )


def cut_depth(cfg, params, chip, layers):
    """A copy of a one-stage model and its programmed chip cut to its first
    ``layers`` layers: the stacked leaves and artifacts are sliced (views,
    no copies)."""
    cut_cfg, cut_p = cut_params(cfg, params, layers)
    repeats = cut_cfg.stages[0].repeats

    def cut(tree):
        return {k: cut(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.map_arrays(
            lambda t: t[:repeats]
        )

    cut_arts = {k: (cut(v) if k == "stage0" else v) for k, v in chip.artifacts.items()}
    return cut_cfg, cut_p, tprog.ProgrammedModel(cut_arts)


def cut_params(cfg, params, layers):
    """A one-stage model's config and params cut to its first ``layers``
    layers at full width (the stacked leaves sliced: views, no copies)."""
    cut_cfg = depth_config(cfg, layers)
    repeats = cut_cfg.stages[0].repeats

    def cut(tree):
        return {k: cut(v) for k, v in tree.items()} if isinstance(tree, dict) else tree[:repeats]

    return cut_cfg, {k: (cut(v) if k == "stage0" else v) for k, v in params.items()}


def serve_dense(phase, arch, dev, seed, quick):
    """One dense config at full width, ``SERVE_CUT_LAYERS`` layers (2 under
    ``--quick``), from an ideal chip the engine programs: every projection on
    the fast kernel (6 a layer + the head, each forward), the decode ticks
    replayed, the logits within the config's rel-L2 gate of the plain-matmul
    model, and a store round trip on a copy of the chip cut to
    ``STORE_CHECK_LAYERS`` layers.  Returns the serving run's launch counts."""
    cfg = depth_config(get_config(arch), 2 if quick else SERVE_CUT_LAYERS)
    params = model_lib.init_model(cfg, seed=seed, device=dev)
    torch.cuda.reset_peak_memory_stats()
    ideal = CrossbarMode(enabled=True, strict=True)
    line, launches, eng = serve_phase(phase, cfg, params, ideal, "fast", dev, seed + 1, False)
    want = 6 * cfg.n_layers + 1
    forwards = line["prefills"] + line["decode_ticks"]
    require(
        line["projections"] == want and launches["fast"] == want * forwards,
        f"{phase}: {launches['fast']} fast-kernel launches of {line['projections']} projections in "
        f"{forwards} forwards, expected {want} x {forwards}",
    )
    line["logits_rel_l2_vs_plain_matmul"] = reference_check(cfg, params, eng, dev)[0]
    line["rel_l2_gate"] = REL_L2_MAX[arch]
    require(
        line["logits_rel_l2_vs_plain_matmul"] < REL_L2_MAX[arch],
        f"{phase}: the chip is {line['logits_rel_l2_vs_plain_matmul']} (rel-L2) away from the plain "
        f"matmul model, gate {REL_L2_MAX[arch]}",
    )
    # the store round trip on a copy of the chip cut to STORE_CHECK_LAYERS
    cut_cfg, cut_params, cut_chip = cut_depth(cfg, params, eng.programmed, STORE_CHECK_LAYERS)
    cut_eng = ServingEngine(
        cut_cfg, cut_params, max_batch=4, max_seq=256, device=dev,
        crossbar=dataclasses.replace(ideal, programmed=cut_chip),
    )
    prompts = make_requests(cfg, seed + 1)
    cut_tokens = [r.generated for r in drive(cut_eng, prompts, max_new=16)[0]]
    line["store_round_trip"] = dict(
        layers=cut_cfg.n_layers, width="full",
        why="a copy of the served chip cut in depth: the full store would be "
            f"{sum(a.w_codes.numel() for a in eng.programmed.by_name.values()) * 4 / 1e9:.1f} GB of npz",
        **store_round_trip(phase, cut_cfg, cut_params, cut_eng, prompts, cut_tokens, dev),
    )
    del cut_eng, cut_chip, cut_params
    emit(line)
    replayed_tick_checks(
        phase.replace("serve_", ""), eng, cfg, seed, {"fast_kernel": line["projections"]}, prefill=arch == "gemma2-9b",
    )
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def kimi_config(layers):
    """kimi-k2-1t-a32b at full width cut to ``layers`` layers: its dense
    first layer, then ``layers - 1`` MoE layers."""
    cfg = get_config(KIMI)
    dense, moe = cfg.stages
    return dataclasses.replace(
        cfg, n_layers=layers, stages=(dense, dataclasses.replace(moe, repeats=layers - dense.repeats)),
    )


def moe_vmm_calls(cfg, share):
    """VMM launches one forward makes, from the config, block position by
    position: an attention mixer's 4 projections (q, k, v, o; MLA's 3: wq,
    w_kv_down, wo, its w_uk / w_uv contractions being digital einsums, as in
    the reference), a mamba mixer's none (its projections are digital, as
    in the reference); a dense FFN's fused wi and its wo; an MoE FFN's
    router, wi / wg / wo of each expert of the share and of the shared
    expert (a GLU FFN); and the untied head."""
    ffn = 3 if cfg.mlp_kind in ("swiglu", "geglu") else 2
    attn = 3 if cfg.kv_lora_rank else 4
    n = 0 if cfg.tie_embeddings else 1
    for spec in cfg.stages:
        for kind, moe in zip(spec.kinds, spec.moe):
            mixer = attn if kind.startswith("attn") else 0
            per_ffn = (1 + ffn * (share.local_experts(cfg) + (1 if cfg.moe_shared_experts else 0))) if moe else 2
            n += spec.repeats * (mixer + per_ffn)
    return n


def cut_stage(tree, si, keep):
    """``tree`` (params or an artifact tree) with stage ``si``'s stacked
    leaves cut to their first ``keep`` layers (views, no copies)."""
    def cut(t):
        if isinstance(t, dict):
            return {k: cut(v) for k, v in t.items()}
        return t.map_arrays(lambda a: a[:keep]) if isinstance(t, tprog.ProgrammedLinear) else t[:keep]

    return {k: (cut(v) if k == f"stage{si}" else v) for k, v in tree.items()}


def routed_reference_check(cfg, params, eng, dev, share):
    """``reference_check`` of an MoE share, and how the chip's routing
    compares with the plain-matmul model's on that prompt: for each MoE
    layer, the share of tokens whose top-k sets agree and of (token,
    expert) choices both made, and for each model the router logits'
    distinct values a row (of ``moe_experts``), their spread and the share
    of rows with a tie across the top-k cut."""
    seen, logit_stats = [], []
    real = moe_mod.route_from_logits

    def spy(logits, cfg_, dtype):
        out = real(logits, cfg_, dtype)
        seen.append(out[0].reshape(-1, cfg_.moe_top_k).sort(dim=-1).values)
        rows = logits.reshape(-1, logits.shape[-1]).float()
        top = torch.sort(rows, dim=-1, descending=True).values
        logit_stats.append(dict(
            distinct_per_row=sum(len(torch.unique(r)) for r in rows) / rows.shape[0],
            std=float(rows.std()),
            rows_tied_at_cut=float((top[:, cfg_.moe_top_k - 1] == top[:, cfg_.moe_top_k]).float().mean()),
        ))
        return out

    moe_mod.route_from_logits = spy
    try:
        with expert_share(share):
            rel = reference_check(cfg, params, eng, dev)[0]
    finally:
        moe_mod.route_from_logits = real
    n = len(seen) // 2  # the chip's forward, then the plain one
    routing = []
    for i, (chip_idx, plain_idx) in enumerate(zip(seen[:n], seen[n:])):
        shared = (chip_idx[:, :, None] == plain_idx[:, None, :]).any(dim=-1).float().mean()
        routing.append(dict(
            top_k_sets_equal=float((chip_idx == plain_idx).all(dim=-1).float().mean()),
            choices_shared=float(shared), chip_logits=logit_stats[i], plain_logits=logit_stats[n + i],
        ))
    return rel, routing


def forced_reference_check(cfg, params, eng, dev, share):
    """The chip's logits on ``chip_logits``' prompt against (a) the
    plain-matmul model of the same share routed as the chip routed (each MoE
    layer handed the chip's top-k ids, gates and probabilities): rel-L2 and
    max |d| / max |logit|, the 16-bit datapath's own error without routing
    flips; and (b) the same forward with every K1 launch served by its plain
    version (``k1_plain``), routed by its own logits: the same codes give the
    same logits, at the rows a served prompt gives K1."""
    routes, real = [], moe_mod.route_from_logits

    def record(logits, cfg_, dtype):
        routes.append(real(logits, cfg_, dtype))
        return routes[-1]

    moe_mod.route_from_logits = record
    try:
        with expert_share(share):
            tok, xbar = chip_logits(cfg, params, eng, dev)
            replay = iter(routes)
            moe_mod.route_from_logits = lambda logits, cfg_, dtype: next(replay)
            plain = model_lib.forward(params, cfg, tok).float()
            require(next(replay, None) is None, "forced_reference_check: the plain model routed fewer times")
            moe_mod.route_from_logits = real
            with k1_plain():
                emulated = chip_logits(cfg, params, eng, dev)[1]
    finally:
        moe_mod.route_from_logits = real
    return dict(
        moe_layers=len(routes), rel_l2_vs_plain_matmul=float((xbar - plain).norm() / plain.norm()),
        max_abs_vs_plain_matmul=float((xbar - plain).abs().max() / plain.abs().max()),
        k1_plain_equal=bool(torch.equal(xbar, emulated)),
        k1_plain_max_abs=float((xbar - emulated).abs().max() / emulated.abs().max()),
    )


def serve_kimi(dev, seed, quick):
    """The rank-0 share of kimi-k2's 8-way expert-parallel deployment at
    full width and depth 3 (``KIMI_LAYERS``), from an ideal chip the engine
    programs: every projection on the fast kernel, one launch an expert's
    projection (``moe_vmm_calls`` a forward, asserted), the logits within
    ``KIMI_REL_L2_MAX`` of the plain-matmul model of the same share, a
    store round trip on a copy cut to the dense layer and one MoE layer (a
    4-D expert-bank artifact written and restored), then
    ``tick_profile_kimi``, ``graph_vs_eager_kimi`` and
    ``prefill_vs_eager_kimi``.  Returns the serving run's launch counts."""
    cfg = kimi_config(2 if quick else KIMI_LAYERS)
    t0 = time.perf_counter()
    params = model_lib.init_model(cfg, seed=seed, device=dev, share=KIMI_SHARE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_gb = sum(t.numel() * t.element_size() for t in leaves(params)) / 1e9
    torch.cuda.reset_peak_memory_stats()
    ideal = CrossbarMode(enabled=True, strict=True)
    line, launches, eng = serve_phase("serve_kimi", cfg, params, ideal, "fast", dev, seed + 1, False, share=KIMI_SHARE)
    want = moe_vmm_calls(cfg, KIMI_SHARE)
    forwards = line["prefills"] + line["decode_ticks"]
    require(
        line["projections"] == want and launches["fast"] == want * forwards
        and (quick or want == KIMI_K1_PER_FORWARD),
        f"serve_kimi: {launches['fast']} fast-kernel launches of {line['projections']} projections in "
        f"{forwards} forwards, the config gives {want} a forward, expected {KIMI_K1_PER_FORWARD}",
    )
    lo = KIMI_SHARE.first_expert(cfg)
    line["logits_rel_l2_vs_plain_matmul"], line["routing_vs_plain_matmul"] = routed_reference_check(
        cfg, params, eng, dev, KIMI_SHARE,
    )
    line.update(
        share=dict(rank=KIMI_SHARE.rank, ranks=KIMI_SHARE.ranks, experts=[lo, lo + KIMI_SHARE.local_experts(cfg) - 1],
                   of=cfg.moe_experts, top_k=cfg.moe_top_k, capacity_at_decode=moe_mod._capacity(4, cfg, 48)),
        widths=dict(d_model=cfg.d_model, heads=cfg.n_heads, head_dim=cfg.head_dim, kv_heads=cfg.n_kv_heads,
                    dense_d_ff=cfg.d_ff, expert_d_ff=cfg.moe_d_ff, shared_experts=cfg.moe_shared_experts),
        vmm_launches_per_forward=want, rel_l2_gate=KIMI_REL_L2_MAX, init_seconds=init_s, param_gb=param_gb,
        chip_gb=sum(
            getattr(a, f).numel() * getattr(a, f).element_size()
            for a in eng.programmed.by_name.values() for f in tprog.ARTIFACT_ARRAY_FIELDS
            if getattr(a, f) is not None
        ) / 1e9,
    )
    require(
        line["logits_rel_l2_vs_plain_matmul"] < KIMI_REL_L2_MAX,
        f"serve_kimi: the chip is {line['logits_rel_l2_vs_plain_matmul']} (rel-L2) away from the plain "
        f"matmul model, gate {KIMI_REL_L2_MAX}",
    )
    # the store round trip on the dense layer and one MoE layer
    cut_cfg = kimi_config(KIMI_STORE_LAYERS)
    keep = cut_cfg.stages[1].repeats
    cut_params = cut_stage(params, 1, keep)
    cut_chip = tprog.ProgrammedModel(cut_stage(eng.programmed.artifacts, 1, keep))
    require(cut_chip.by_name["stage1/b0/ffn/wi"].w_codes.ndim == 4, "serve_kimi: the cut chip has no expert bank")
    cut_eng = ServingEngine(
        cut_cfg, cut_params, max_batch=4, max_seq=256, device=dev, share=KIMI_SHARE,
        crossbar=dataclasses.replace(ideal, programmed=cut_chip),
    )
    prompts = make_requests(cfg, seed + 1)
    cut_tokens = [r.generated for r in drive(cut_eng, prompts, max_new=16)[0]]
    line["store_round_trip"] = dict(
        layers=cut_cfg.n_layers, width="full", expert_bank_shape=list(cut_chip.by_name["stage1/b0/ffn/wi"].shape),
        why="a copy of the served chip cut in depth to its dense layer and one MoE layer",
        **store_round_trip("serve_kimi", cut_cfg, cut_params, cut_eng, prompts, cut_tokens, dev),
    )
    del cut_eng, cut_chip, cut_params
    gc.collect()
    torch.cuda.empty_cache()
    emit(line)
    replayed_tick_checks("kimi", eng, cfg, seed, {"fast_kernel": want}, prefill=True)
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def moe_expert_chips(dev, seed):
    """One full-width kimi-k2 MoE FFN of the rank share of EP48 (8 experts)
    programmed on NOISY_DEVICE with ``expert_chips`` (one chip identity an
    expert), at ``EXPERT_CHIPS_M`` tokens: every noisy-kernel call's output
    codes ``torch.equal`` to its plain version on the same inputs (each
    expert's wi / wg / wo, the router, the shared expert), the FFN replayed
    from a CUDA graph ``torch.equal`` to eager; the same slab programmed on
    two chip identities differs, and on expert 0's identity reproduces the
    bank's expert 0.  Returns the launch counts of the eager runs."""
    cfg, share = get_config(KIMI), EXPERT_CHIPS_SHARE
    n_local = share.local_experts(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    ffn = moe_mod.init_moe(
        cfg, 1, lambda shape, scale: model_lib._normal(gen, shape, scale, torch.bfloat16, dev), share,
    )
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chip = tprog.program_model({"ffn": ffn}, device_cfg=NOISY_DEVICE, expert_chips=tuple(range(n_local)), device=dev)
    torch.cuda.synchronize()
    program_s = time.perf_counter() - t0
    mode = CrossbarMode(enabled=True, strict=True, device=NOISY_DEVICE, programmed=chip)
    layer = {k: v[0] for k, v in ffn.items()}
    layer_map = chip.stage_layer_maps("ffn")[0]

    def run(x):
        with crossbar_mode(mode), chip.bind(), tprog._push_bind_map(layer_map), tprog.name_scope("ffn"):
            return moe_mod.moe_ffn(layer, x, cfg, share=share)

    real = tprog.noisy_vmm_cuda
    calls = []

    def spy(xq, g_eff, spec, adc_cfg=None, skip_zero_planes=True):
        y = real(xq, g_eff, spec, adc_cfg=adc_cfg, skip_zero_planes=skip_zero_planes)
        calls.append((xq.clone(), g_eff, spec, adc_cfg, y.clone()))
        return y

    rng = np.random.default_rng(seed)
    cases, launches = [], {k: 0 for k in (*kvmm.LAUNCHES, *kscan.LAUNCHES)}
    for M in EXPERT_CHIPS_M:
        x = torch.from_numpy(rng.normal(size=(1, M, cfg.d_model)).astype(np.float32)).to(dev, torch.bfloat16)
        calls.clear()
        kvmm.reset_counters()
        tprog.noisy_vmm_cuda = spy
        try:
            eager = run(x)
        finally:
            tprog.noisy_vmm_cuda = real
        torch.cuda.synchronize()
        counts = dict(kvmm.LAUNCHES)
        for k, n in counts.items():
            launches[k] += n
        want = 1 + 3 * (n_local + 1)  # router, wi / wg / wo of each expert and the shared one
        equal = [bool(torch.equal(y, noisy_vmm_plain(xq, g, spec, adc_cfg))) for xq, g, spec, adc_cfg, y in calls]
        eager_ms = cuda_ms(lambda: run(x), reps=3, warmup=1)
        # the FFN captured as one CUDA graph on a static copy of x
        static = x.clone()
        stream = torch.cuda.Stream(device=dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            run(static)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            replayed = run(static)
        graph.replay()
        torch.cuda.synchronize()
        case = dict(
            M=M, capacity=moe_mod._capacity(M, cfg, n_local), noisy_launches=counts["noisy"], expected=want,
            noisy_calls_equal_plain=sum(equal), noisy_calls=len(equal), replay_equal_eager=bool(torch.equal(replayed, eager)),
            finite=bool(torch.isfinite(eager.float()).all()), eager_ms=eager_ms,
            replay_ms=cuda_ms(graph.replay, reps=5, warmup=1),
        )
        cases.append(case)
        del graph, replayed
        require(
            counts == {"fast": 0, "planes": 0, "noisy": want} and len(equal) == want and all(equal)
            and case["replay_equal_eager"] and case["finite"],
            f"moe_expert_chips: {case}, launches {counts}",
        )
    kvmm.reset_counters()
    w = ffn["wi"][0, 0]
    one = tprog.program_layer(w, device_cfg=NOISY_DEVICE.replace(chip=0))
    two = tprog.program_layer(w, device_cfg=NOISY_DEVICE.replace(chip=1))
    bank = chip.by_name["ffn/wi"]
    line = dict(
        phase="moe_expert_chips", arch=KIMI, share=dict(rank=share.rank, ranks=share.ranks, experts=n_local),
        device=dataclasses.asdict(NOISY_DEVICE), expert_chips=list(range(n_local)), program_seconds=program_s,
        chip_gb=sum(
            getattr(a, f).numel() * getattr(a, f).element_size()
            for a in chip.by_name.values() for f in tprog.ARTIFACT_ARRAY_FIELDS if getattr(a, f) is not None
        ) / 1e9,
        identities_differ=not torch.equal(one.g_eff, two.g_eff),
        identity_reproduces_bank=bool(torch.equal(one.g_eff, bank.g_eff[0, 0])),
        cases=cases, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
    )
    emit(line)
    require(
        line["identities_differ"] and line["identity_reproduces_bank"],
        f"moe_expert_chips: chip identities {line}",
    )
    del chip, ffn, one, two, bank
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def moe_dispatch_card_vs_cpu(dev, seed):
    """Routing, slots and the combine on the card against the CPU from the
    same router logits (float32 on a grid of 1/64, as dequantised codes
    lie: ties are real) at kimi-k2's 384 experts and top 8, for the rank-0
    share of EP8 (48 experts, 8 slots each) at a decode tick (4 rows) and
    a 256-token bucket: top-k ids, gates and probabilities, the slot tables
    and the combined bf16 output of the same expert outputs, each
    ``torch.equal``."""
    cfg, share = get_config(KIMI), KIMI_SHARE
    n_local, lo = share.local_experts(cfg), share.first_expert(cfg)
    rng = np.random.default_rng(seed)
    cases = []
    for n in (4, 256):
        logits = (np.round(rng.normal(size=(n, cfg.moe_experts)) * 64) / 64).astype(np.float32)
        cap = moe_mod._capacity(n, cfg, n_local)
        expert_out = rng.normal(size=(n_local * cap, cfg.d_model)).astype(np.float32)
        got = []
        for d in (torch.device("cpu"), dev):
            idx, gates, probs = moe_mod.route_from_logits(torch.from_numpy(logits).to(d), cfg, torch.bfloat16)
            tok_slot, gate_slot, token_slots = moe_mod.slot_tables(idx, gates, n_local, cap, lo)
            out = torch.from_numpy(expert_out).to(d, torch.bfloat16)
            y = moe_mod.combine(out * gate_slot[:, None], token_slots)
            got.append(dict(
                idx=idx, gates=gates, probs=probs, tok_slot=tok_slot, gate_slot=gate_slot,
                token_slots=token_slots, combined=y,
            ))
        cpu, card = got
        equal = {k: bool(torch.equal(cpu[k], card[k].cpu())) for k in cpu}
        sorted_p = torch.sort(cpu["probs"], dim=-1, descending=True).values
        cases.append(dict(
            tokens=n, capacity=cap, equal=equal,
            ties_at_the_cut=int((sorted_p[:, cfg.moe_top_k - 1] == sorted_p[:, cfg.moe_top_k]).sum()),
            local_assignments=int(((cpu["idx"] >= lo) & (cpu["idx"] < lo + n_local)).sum()),
            kept=int((cpu["token_slots"] < n_local * cap).sum()),
        ))
    line = dict(phase="moe_dispatch_card_vs_cpu", arch=KIMI, share=[share.rank, share.ranks], cases=cases,
                all_equal=all(all(c["equal"].values()) for c in cases))
    emit(line)
    require(line["all_equal"], f"moe_dispatch_card_vs_cpu: {cases}")
    require(any(c["kept"] < c["local_assignments"] for c in cases), "moe_dispatch_card_vs_cpu: nothing dropped")
    return line


# ---------------------------------------------------------------------------
# deepseek-v2's MoE FFN over rank processes
# ---------------------------------------------------------------------------

def jamba_config(positions=None):
    """jamba-v0.1-52b at full width, its 8-layer period once (repeats 4 ->
    1), or cut to the period's first ``positions`` positions."""
    cfg = get_config(JAMBA)
    (period,) = cfg.stages
    p = positions or len(period.kinds)
    return dataclasses.replace(
        cfg, n_layers=p, stages=(StageSpec(kinds=period.kinds[:p], repeats=1, moe=period.moe[:p]),),
    )


def jamba_cut(tree, positions):
    """``tree`` (params or an artifact tree) with the period's block
    positions past ``positions`` taken out (the rest shared, no copies)."""
    return {
        k: ({b: v for b, v in sub.items() if int(b[1:]) < positions} if k == "stage0" else sub)
        for k, sub in tree.items()
    }


def mamba_layers(params, cfg):
    """The mamba mixers of the period, layer 0 of each (views)."""
    kinds = cfg.stages[0].kinds
    return [
        {k: v[0] for k, v in params["stage0"][f"b{i}"]["mixer"].items()} for i, kind in enumerate(kinds)
        if kind == "mamba"
    ]


def mamba_card_vs_cpu(params, cfg, dev, seed):
    """Layer 0's mamba block at full width in float32 (the bf16 weights
    widened), on the card and on the CPU: a 1 x 32 prompt into a zero
    cache, then 4 decode steps; max |dy| / max |y| and of both cache leaves,
    each step."""
    mixer = {k: v.to(torch.float32) for k, v in mamba_layers(params, cfg)[0].items()}
    cpu_mixer = {k: v.cpu() for k, v in mixer.items()}
    gen = torch.Generator().manual_seed(seed)
    steps = [torch.randn((1, 32, cfg.d_model), generator=gen)] + [
        torch.randn((1, 1, cfg.d_model), generator=gen) for _ in range(4)
    ]
    caches = {d: ssm_mod.init_mamba_cache(cfg, 1, torch.float32, d) for d in (dev, "cpu")}
    worst, readings = 0.0, []
    for t, x in enumerate(steps):
        ys = {}
        for d, m in ((dev, mixer), ("cpu", cpu_mixer)):
            ys[d], _ = ssm_mod.mamba_block(m, x.to(d), cfg, caches[d], decode=t > 0)
        r = dict(step=t, y=rel_max(ys[dev].cpu().numpy(), ys["cpu"].numpy()), **{
            n: rel_max(caches[dev][n].cpu().numpy(), caches["cpu"][n].numpy()) for n in ("h", "conv")
        })
        readings.append(r)
        worst = max(worst, r["y"], r["h"], r["conv"])
    return dict(worst=worst, gate=JAMBA_MAMBA_CPU_GATE, steps=readings)


def mamba_tick_profile(params, cfg, dev, batch, seed, ticks):
    """``tick_mamba_jamba``: one decode step of each of the period's mamba
    blocks at ``batch`` rows (bf16 activations, the float32 state of a
    served pool), captured as one CUDA graph and replayed ``ticks`` times in
    a ``profile_window`` (the same kernels at the same shapes as inside the
    replayed tick, where a graph replay does not say which block launched a
    kernel); no kernel of ours may run in it."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((batch, 1, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
    blocks = [(m, ssm_mod.init_mamba_cache(cfg, batch, torch.float32, dev)) for m in mamba_layers(params, cfg)]

    def tick():
        for m, cache in blocks:
            ssm_mod.mamba_block(m, x, cfg, cache, decode=True)

    tick()  # warm-up: library handles and workspaces, before capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        tick()

    def replays():
        for _ in range(ticks):
            graph.replay()

    return retried_window("tick_mamba_jamba", lambda: profile_window("tick_mamba_jamba", replays, ticks, ours=False))


def serve_jamba(dev, seed, quick):
    """The rank-0 share of jamba-v0.1-52b's 4-way expert-parallel
    deployment at full width, its 8-layer period once, from an ideal chip
    the engine programs: every attention, FFN, router, expert and head
    projection on the fast kernel (``JAMBA_K1_PER_FORWARD`` a forward,
    asserted, each at a (K, N) of ``JAMBA_SHAPES``; the mamba projections
    stay digital);
    the logits within ``JAMBA_REL_L2_MAX`` of the plain-matmul model of the
    same share with each MoE layer's routing agreement, and within
    ``JAMBA_FORCED_REL_L2_MAX`` of it routed as the chip routed; the
    logits ``torch.equal`` to those of the same forward with every K1 launch
    served by its plain version (``forced_reference_check``); layer 0's mamba
    block card against CPU (``JAMBA_MAMBA_CPU_GATE``); a store round trip
    on a copy cut to the period's first ``JAMBA_STORE_POSITIONS`` positions
    (a 4-D expert bank and mamba blocks); then ``tick_profile_jamba``,
    ``mamba_tick_profile``, the busy time a tick by class
    (``tick_classes_jamba``: K1, the mamba blocks, the rest) and
    ``graph_vs_eager_jamba``.  Returns the serving
    run's launch counts."""
    t_phase = time.perf_counter()
    cfg = jamba_config(JAMBA_STORE_POSITIONS if quick else None)
    t0 = time.perf_counter()
    params = model_lib.init_model(cfg, seed=seed, device=dev, share=JAMBA_SHARE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_gb = sum(t.numel() * t.element_size() for t in leaves(params)) / 1e9
    torch.cuda.reset_peak_memory_stats()
    ideal = CrossbarMode(enabled=True, strict=True)
    shapes = set()
    with k1_shapes(shapes):
        line, launches, eng = serve_phase(
            "serve_jamba", cfg, params, ideal, "fast", dev, seed + 1, False, share=JAMBA_SHARE,
        )
    want = moe_vmm_calls(cfg, JAMBA_SHARE)
    forwards = line["prefills"] + line["decode_ticks"]
    require(
        line["projections"] == want and launches["fast"] == want * forwards
        and (quick or want == JAMBA_K1_PER_FORWARD),
        f"serve_jamba: {launches['fast']} fast-kernel launches of {line['projections']} projections in "
        f"{forwards} forwards, the config gives {want} a forward, expected {JAMBA_K1_PER_FORWARD}",
    )
    kn = {(k, n) for _, k, n in shapes}
    require(kn <= {s for s, _ in JAMBA_SHAPES}, f"serve_jamba: K1 at shapes the kernels phase does not hold: {kn}")
    lo = JAMBA_SHARE.first_expert(cfg)
    line["logits_rel_l2_vs_plain_matmul"], line["routing_vs_plain_matmul"] = routed_reference_check(
        cfg, params, eng, dev, JAMBA_SHARE,
    )
    line["routed_as_the_chip"] = forced_reference_check(cfg, params, eng, dev, JAMBA_SHARE)
    line.update(
        share=dict(rank=JAMBA_SHARE.rank, ranks=JAMBA_SHARE.ranks, experts=[lo, lo + JAMBA_SHARE.local_experts(cfg) - 1],
                   of=cfg.moe_experts, top_k=cfg.moe_top_k, capacity_at_decode=moe_mod._capacity(4, cfg, 4)),
        period=list(cfg.stages[0].kinds), moe=list(cfg.stages[0].moe),
        reduced=[f"depth {get_config(JAMBA).n_layers} -> {cfg.n_layers} (one period)",
                 f"experts {cfg.moe_experts} -> {JAMBA_SHARE.local_experts(cfg)} (rank 0 of EP{JAMBA_SHARE.ranks})"],
        widths=dict(d_model=cfg.d_model, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                    d_ff=cfg.d_ff, expert_d_ff=cfg.moe_d_ff, shared_experts=cfg.moe_shared_experts,
                    d_inner=ssm_mod.d_inner_of(cfg), d_state=cfg.mamba_d_state, d_conv=cfg.mamba_d_conv,
                    dt_rank=ssm_mod.dt_rank_of(cfg), vocab=cfg.vocab_size),
        k1_launches_per_forward=want,
        k1_reckoning="attention 4; dense FFNs 4 x 2; MoE FFNs 4 x (router + 3 x 4 experts); head 1; mamba 0",
        k1_shapes_mkn=sorted(shapes), digital_mamba_matmuls_per_forward=4 * len(mamba_layers(params, cfg)),
        rel_l2_gate=JAMBA_REL_L2_MAX, forced_rel_l2_gate=JAMBA_FORCED_REL_L2_MAX, init_seconds=init_s,
        param_gb=param_gb,
        chip_gb=sum(
            getattr(a, f).numel() * getattr(a, f).element_size()
            for a in eng.programmed.by_name.values() for f in tprog.ARTIFACT_ARRAY_FIELDS
            if getattr(a, f) is not None
        ) / 1e9,
        mamba_card_vs_cpu=mamba_card_vs_cpu(params, cfg, dev, seed + 7),
    )
    require(
        line["logits_rel_l2_vs_plain_matmul"] < JAMBA_REL_L2_MAX,
        f"serve_jamba: the chip is {line['logits_rel_l2_vs_plain_matmul']} (rel-L2) away from the plain "
        f"matmul model, gate {JAMBA_REL_L2_MAX}",
    )
    forced = line["routed_as_the_chip"]
    require(
        forced["rel_l2_vs_plain_matmul"] < JAMBA_FORCED_REL_L2_MAX and forced["k1_plain_equal"],
        f"serve_jamba: routed as the chip routed, the chip is {forced['rel_l2_vs_plain_matmul']} (rel-L2) away "
        f"from the plain-matmul model, gate {JAMBA_FORCED_REL_L2_MAX}; K1's plain version gives the same logits: "
        f"{forced['k1_plain_equal']}",
    )
    require(
        line["mamba_card_vs_cpu"]["worst"] <= JAMBA_MAMBA_CPU_GATE,
        f"serve_jamba: the mamba block card vs CPU {line['mamba_card_vs_cpu']}",
    )
    # the store round trip on the period's first positions: mamba blocks,
    # the attention block and two MoE FFNs (4-D expert banks)
    positions = min(JAMBA_STORE_POSITIONS, cfg.n_layers)
    cut_cfg = jamba_config(positions)
    cut_params = jamba_cut(params, positions)
    cut_chip = tprog.ProgrammedModel(jamba_cut(eng.programmed.artifacts, positions))
    require(
        cut_chip.by_name["stage0/b1/ffn/wi"].w_codes.ndim == 4 and "mamba" in cut_cfg.stages[0].kinds,
        "serve_jamba: the cut chip has no expert bank or no mamba block",
    )
    cut_eng = ServingEngine(
        cut_cfg, cut_params, max_batch=4, max_seq=256, device=dev, share=JAMBA_SHARE,
        crossbar=dataclasses.replace(ideal, programmed=cut_chip),
    )
    prompts = make_requests(cfg, seed + 1)
    cut_tokens = [r.generated for r in drive(cut_eng, prompts, max_new=16)[0]]
    line["store_round_trip"] = dict(
        positions=list(cut_cfg.stages[0].kinds), width="full",
        expert_bank_shape=list(cut_chip.by_name["stage0/b1/ffn/wi"].shape),
        why="a copy of the served chip cut to the period's first positions",
        **store_round_trip("serve_jamba", cut_cfg, cut_params, cut_eng, prompts, cut_tokens, dev),
    )
    del cut_eng, cut_chip, cut_params
    gc.collect()
    torch.cuda.empty_cache()
    line["peak_mem_gb_with_store_round_trip"] = torch.cuda.max_memory_allocated() / 1e9
    emit(line)
    # where a tick goes: K1 by name in the replayed ticks, the mamba blocks
    # in a window of their own, the rest the difference of the two windows;
    # then replay against eager
    prof = tick_profile("tick_profile_jamba", eng, make_requests(cfg, seed + 3), classes={"k1": ("fast_kernel",)})
    require(
        {k["name"]: k["calls_per_tick"] for k in prof["kernels"]} == {"fast_kernel": want},
        f"tick_profile_jamba: kernels a tick {prof['kernels']}",
    )
    mamba = mamba_tick_profile(params, cfg, dev, eng.max_batch, seed + 8, prof["ticks"])
    busy, k1, mamba_ms = prof["device_busy_ms_per_tick"], prof["busy_ms_per_tick_by_class"]["k1"], mamba["device_busy_ms_per_tick"]
    emit(dict(
        phase="tick_classes_jamba", busy_ms_per_tick=busy,
        busy_ms_per_tick_by_class=dict(k1=k1, mamba_blocks=mamba_ms, rest_two_windows=busy - k1 - mamba_ms),
        launches_per_tick=prof["device_launches_per_tick"], mamba_launches_per_tick=mamba["device_launches_per_tick"],
        how="k1: the profiled replayed ticks by kernel name (tick_profile_jamba); mamba_blocks: one decode step of "
            "each mamba block at the pool's rows, replayed from a graph of its own (tick_mamba_jamba); "
            "rest_two_windows: the first window's busy time less both, a difference of two windows",
    ))
    graph_vs_eager("jamba", eng, make_requests(cfg, seed + 6))
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    emit(dict(phase="serve_jamba_done", seconds=time.perf_counter() - t_phase))
    return launches


@contextlib.contextmanager
def timed(times, key):
    """Append to ``times[key]`` (if ``times`` is given) the block's host
    seconds and its CUDA-event milliseconds, the device synchronised on
    both sides."""
    if times is None:
        yield
        return
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    yield
    end.record()
    torch.cuda.synchronize()
    times.setdefault(key, []).append((time.perf_counter() - t0, start.elapsed_time(end)))


def slot_view(cache, b):
    """Slot ``b`` of a pool cache as a one-slot cache (views: a prefill into
    it writes the pool in place)."""
    return [{blk: {n: t[:, b:b + 1] for n, t in leaves.items()} for blk, leaves in stage.items()} for stage in cache]


def frame_logits(params, cfg, frames, steps, times=None):
    """An embedding front end served from ``frames`` (B, S + steps, D): each
    slot's S-frame prompt prefilled alone into its slot of a float32 pool
    cache, then ``steps`` decode steps of the pool, each fed the next frame.
    Returns the logits (B, 1 + steps, V) in float32 and the cache;
    ``times`` (a dict) collects each prefill's and each tick's seconds."""
    B, S = frames.shape[0], frames.shape[1] - steps
    cache = model_lib.init_cache(cfg, B, S + steps, dtype=torch.float32, device=frames.device)
    first = []
    for b in range(B):
        with timed(times, "prefill"):
            first.append(model_lib.prefill(params, cfg, frames[b:b + 1, :S], slot_view(cache, b))[0])
    out = [torch.cat(first)]
    for t in range(steps):
        pos = torch.tensor(S + t, device=frames.device)
        with timed(times, "tick"):
            out.append(model_lib.decode_step(params, cfg, frames[:, S + t:S + t + 1], pos, cache)[0])
    return torch.stack(out, 1).float(), cache


def embed_config(arch, quick):
    """``arch`` at full width, cut to ``EMBED_LAYERS[arch]`` layers (2
    under ``--quick``)."""
    cfg = get_config(arch)
    layers = 2 if quick else EMBED_LAYERS[arch]
    return cfg if layers == cfg.n_layers else depth_config(cfg, layers)


def embed_store_round_trip(cfg, params, chip, frames, steps, dev):
    """The chip cut to ``EMBED_STORE_LAYERS`` layers at full width: saved by
    an engine, passed through ``verify_store``, restored into a new engine,
    and its logits on the same frames ``torch.equal`` to the cut chip's."""
    cut_cfg, cut_p, cut_chip = cut_depth(cfg, params, chip, EMBED_STORE_LAYERS)
    ideal = CrossbarMode(enabled=True, strict=True)
    eng = ServingEngine(cut_cfg, cut_p, max_batch=EMBED_SLOTS, max_seq=frames.shape[1], device=dev,
                        crossbar=dataclasses.replace(ideal, programmed=cut_chip))
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        eng.save_artifacts(d)
        save_s = time.perf_counter() - t0
        report = verify_store(d, expected=tprog.expected_artifact_names(cut_p))
        require(report.ok, f"the saved chip fails verify_store: {report.summary()}")
        t0 = time.perf_counter()
        back = ServingEngine(cut_cfg, cut_p, max_batch=EMBED_SLOTS, max_seq=frames.shape[1], device=dev,
                             crossbar=ideal, restore_artifacts=d)
        restore_s = time.perf_counter() - t0
    logits = []
    for e in (eng, back):
        with crossbar_mode(e.crossbar), e.programmed.bind():
            logits.append(frame_logits(cut_p, cut_cfg, frames, steps)[0])
    names = sorted(back.programmed.by_name)
    require(torch.equal(*logits), "the restored chip's logits differ from the saved chip's")
    require("head" in names and not any(n.startswith("embed") for n in names), f"store names {names}")
    return dict(
        layers=cut_cfg.n_layers, width="full", artifacts=names, verify_store_findings=len(report.findings),
        verified_artifacts=report.n_artifacts, logits_equal=True, save_seconds=save_s, restore_seconds=restore_s,
    )


def serve_embed(phase, arch, dev, seed, quick):
    """An embedding front end at full width (``embed_config``) from an
    ideal chip ``ServingEngine`` programs and checks (its ``submit`` must
    refuse a frame prompt and a token prompt), served through the model's
    ``prefill`` and ``decode_step`` on seeded frames (``frame_logits``):
    ``EMBED_K1_PER_FORWARD`` K1 launches a forward, asserted, each at an
    (M, K, N) of ``EMBED_SHAPES``; the logits ``torch.equal`` to the same
    run with every K1 launch served by its plain version, and within
    ``EMBED_REL_L2_MAX`` of the plain-matmul model's; the digital serving
    within ``EMBED_TEACHER_REL_L2_MAX`` of a teacher-forced forward; a
    store round trip on a 2-layer cut; then K1's share of busy time over 3
    decode steps (``tick_profile_<arch>``).  Returns the serving run's
    launch counts."""
    t_phase = time.perf_counter()
    cfg = embed_config(arch, quick)
    steps = EMBED_STEPS[arch]
    t0 = time.perf_counter()
    params = model_lib.init_model(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_gb = sum(t.numel() * t.element_size() for t in leaves(params)) / 1e9
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    frames = torch.randn((EMBED_SLOTS, EMBED_FRAMES + steps, cfg.d_model), generator=gen, device=dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, params, max_batch=EMBED_SLOTS, max_seq=EMBED_FRAMES + steps, device=dev,
                        crossbar=CrossbarMode(enabled=True, strict=True))
    torch.cuda.synchronize()
    program_s = time.perf_counter() - t0
    refusals = []
    for prompt in (frames[0, :EMBED_FRAMES].cpu().numpy(), np.arange(1, EMBED_FRAMES + 1)):
        try:
            eng.submit(prompt)
        except ValueError as e:
            refusals.append(str(e))
    require(len(refusals) == 2 and not eng.pending, f"{phase}: the engine took an embedding model's request")
    chip, n_proj = eng.programmed, eng.programmed.calls_per_forward
    want = moe_vmm_calls(cfg, moe_mod.SINGLE_DEVICE)
    forwards = EMBED_SLOTS + steps

    # the serving run: every count at 0 just before, read just after
    shapes, times = set(), {}
    reset_crossbar_misses()
    kvmm.reset_counters()
    kscan.reset_counters()
    tprog.reset_planned_calls()
    with k1_shapes(shapes), crossbar_mode(eng.crossbar), chip.bind():
        xbar, _ = frame_logits(params, cfg, frames, steps, times)
    launches = dict(kvmm.LAUNCHES, **kscan.LAUNCHES)
    plain_calls = dict(kvmm.PLAIN_CALLS, **kscan.PLAIN_CALLS)
    require(crossbar_misses() == (), f"{phase}: crossbar misses under strict: {crossbar_misses()}")
    require(sum(plain_calls.values()) == 0, f"{phase}: plain versions ran on the card path: {plain_calls}")
    require(
        n_proj == want and launches["fast"] == want * forwards and (quick or want == EMBED_K1_PER_FORWARD[arch]),
        f"{phase}: {launches['fast']} K1 launches of {n_proj} projections in {forwards} forwards, the config "
        f"gives {want} a forward, expected {EMBED_K1_PER_FORWARD[arch]}",
    )
    require(all(v == 0 for k, v in launches.items() if k != "fast") and sum(tprog.PLANNED_CALLS.values()) == 0,
            f"{phase}: stray launches {launches}, planned calls {tprog.PLANNED_CALLS}")
    allowed = {(M, K, N) for (K, N), rows in EMBED_SHAPES[arch] for M in rows}
    require(shapes <= allowed, f"{phase}: K1 at (M, K, N) the kernels phase does not hold: {shapes - allowed}")
    require(
        xbar.shape == (EMBED_SLOTS, 1 + steps, cfg.vocab_size) and bool(torch.isfinite(xbar).all()),
        f"{phase}: logits of shape {tuple(xbar.shape)} or not finite",
    )
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # the same run with K1's plain version in every launch; the plain-matmul
    # model; the digital serving against a teacher-forced forward
    with k1_plain(), crossbar_mode(eng.crossbar), chip.bind():
        plain = frame_logits(params, cfg, frames, steps)[0]
    k1_plain_equal = bool(torch.equal(xbar, plain))
    del plain
    digital = frame_logits(params, cfg, frames, steps)[0]
    forced = model_lib.forward(params, cfg, frames)[:, EMBED_FRAMES - 1:].float()
    rel = float((xbar - digital).norm() / digital.norm())
    teacher = float((digital - forced).norm() / forced.norm())
    teacher_max = float((digital - forced).abs().max() / forced.abs().max())
    del digital, forced
    store = embed_store_round_trip(cfg, params, chip, frames[:, :EMBED_FRAMES + 2], 2, dev)
    prefill_s = [s for s, _ in times["prefill"]]
    tick_s, tick_ev = [s for s, _ in times["tick"]], [ms for _, ms in times["tick"]]
    line = dict(
        phase=phase, arch=arch, n_layers=cfg.n_layers, layers_of=get_config(arch).n_layers, d_model=cfg.d_model,
        heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim, d_ff=cfg.d_ff, mlp=cfg.mlp_kind,
        vocab=cfg.vocab_size, frontend=cfg.frontend, param_dtype=cfg.param_dtype,
        reduced=([] if cfg.n_layers == get_config(arch).n_layers
                 else [f"depth {get_config(arch).n_layers} -> {cfg.n_layers}"]),
        slots=EMBED_SLOTS, prompt_frames=EMBED_FRAMES, decode_steps=steps, positions_compared=1 + steps,
        engine_submit_refused=refusals[0], k1_launches_per_forward=want, forwards=forwards, launches=launches,
        plain_calls=plain_calls, misses=0, k1_shapes_mkn=sorted(shapes),
        k1_plain_equal=k1_plain_equal, logits_rel_l2_vs_plain_matmul=rel, rel_l2_gate=EMBED_REL_L2_MAX[arch],
        digital_vs_teacher_forced_rel_l2=teacher, digital_vs_teacher_forced_rel_max=teacher_max,
        teacher_gate=EMBED_TEACHER_REL_L2_MAX,
        init_seconds=init_s, program_seconds=program_s, param_gb=param_gb,
        chip_gb=sum(
            getattr(a, f).numel() * getattr(a, f).element_size()
            for a in chip.by_name.values() for f in tprog.ARTIFACT_ARRAY_FIELDS if getattr(a, f) is not None
        ) / 1e9,
        prefill_ms_median=1e3 * statistics.median(prefill_s), prefill_ms=[1e3 * s for s in prefill_s],
        tick_ms_median_host=1e3 * statistics.median(tick_s), tick_ms_median_events=statistics.median(tick_ev),
        tick_ms_host=[1e3 * s for s in tick_s], frames_per_s_decode=EMBED_SLOTS / statistics.median(tick_s),
        peak_mem_gb=peak_gb, store_round_trip=store,
        peak_mem_gb_with_checks=torch.cuda.max_memory_allocated() / 1e9,
    )
    emit(line)
    require(k1_plain_equal, f"{phase}: the logits differ from the same run with K1's plain version")
    require(rel < EMBED_REL_L2_MAX[arch], f"{phase}: the chip is {rel} (rel-L2) from the plain-matmul model")
    require(teacher < EMBED_TEACHER_REL_L2_MAX, f"{phase}: digital serving vs teacher forcing {teacher}")

    # K1's share of a decode step's busy time: 3 steps of the pool at the
    # last positions (a step scores the whole cache, masked by position)
    cache = model_lib.init_cache(cfg, EMBED_SLOTS, EMBED_FRAMES + steps, dtype=torch.float32, device=dev)
    S = EMBED_FRAMES + steps - 3

    def ticks():
        with crossbar_mode(eng.crossbar), chip.bind():
            for t in range(3):
                pos = torch.tensor(S + t, device=dev)
                model_lib.decode_step(params, cfg, frames[:, S + t:S + t + 1], pos, cache)

    retried_window(f"tick_profile_{arch}", lambda: profile_window(
        f"tick_profile_{arch}", ticks, 3, classes={"k1": ("fast_kernel",)},
    ))
    del eng, chip, params
    gc.collect()
    torch.cuda.empty_cache()
    emit(dict(phase=f"{phase}_done", seconds=time.perf_counter() - t_phase))
    return launches


def deepseek_config(layout, dispatch="allreduce"):
    """deepseek-v2 under ``layout``, capacity factor E / k: every expert has
    a slot for every token, so no run drops an assignment.  The all-to-all
    body bounds each (source rank, expert) pair by its own capacity (GShard),
    one device each expert over all tokens, so at the config's 1.25 the two
    drop different assignments (the reference's mesh tests uncap it too)."""
    cfg = get_config(DEEPSEEK)
    return dataclasses.replace(cfg, layout=layout, moe_dispatch=dispatch,
                               moe_capacity_factor=cfg.moe_experts / cfg.moe_top_k)


def deepseek_params(cfg, seed, dev):
    """One layer of deepseek-v2's MoE FFN from ``moe.init_moe`` (bf16; a
    bank drawn one expert slab at a time, so the float32 draw is one slab's),
    under the artifact scope "moe"; the router scaled by
    ``DEEPSEEK_ROUTER_SCALE``.  Every process draws the same tensors."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def draw(shape, scale):
        out = torch.empty(shape, dtype=torch.bfloat16, device=dev)
        for i in range(shape[0]):
            out[i] = (torch.randn(shape[1:], generator=gen, device=dev) * scale).to(torch.bfloat16)
        return out

    ffn = moe_mod.init_moe(cfg, 1, draw)
    ffn["router"] = ffn["router"] * DEEPSEEK_ROUTER_SCALE
    return {"moe": ffn}


def deepseek_input(cfg, shape, seed, dev, dtype):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1000 + shape[0] * 100 + shape[1])
    return torch.randn((*shape, cfg.d_model), generator=gen, device=dev).to(dtype)


@contextlib.contextmanager
def zeroed_partial_colsums():
    """A planted fault: every ``programmed_linear`` call given local column
    sums (expert-TP's K-partial projections) served with zeros instead."""
    real = tprog.programmed_linear

    def planted(x, art, colsum=None):
        return real(x, art, colsum=None if colsum is None else torch.zeros_like(colsum))

    tprog.programmed_linear = planted
    try:
        yield
    finally:
        tprog.programmed_linear = real


@contextlib.contextmanager
def k1_shapes(shapes: set):
    """Record in ``shapes`` the (M, K, N) of every K1 launch in the block."""
    real = tprog.crossbar_vmm_cuda

    def spy(xq, w_codes, *args, **kwargs):
        shapes.add((xq.numel() // xq.shape[-1], int(w_codes.shape[-2]), int(w_codes.shape[-1])))
        return real(xq, w_codes, *args, **kwargs)

    tprog.crossbar_vmm_cuda = spy
    try:
        yield shapes
    finally:
        tprog.crossbar_vmm_cuda = real


@contextlib.contextmanager
def k1_plain():
    """Every K1 launch in the block served by K1's plain version instead, in
    column blocks of ``PLAIN_N_CHUNK`` (no launch counted)."""
    real = tprog.crossbar_vmm_cuda

    def plain(xq, w_codes, spec, adc_cfg=None, fast=True, skip_zero_planes=True):
        x2 = xq.reshape(-1, xq.shape[-1])
        y = torch.cat([
            crossbar_vmm_plain(x2, w_codes[:, n0:n0 + PLAIN_N_CHUNK], spec, adc_cfg, fast=fast)
            for n0 in range(0, w_codes.shape[-1], PLAIN_N_CHUNK)
        ], dim=-1)
        return y.reshape(*xq.shape[:-1], y.shape[-1])

    tprog.crossbar_vmm_cuda = plain
    try:
        yield
    finally:
        tprog.crossbar_vmm_cuda = real


def deepseek_layer(params, chip, cfg, mesh, x, fault=None, forced=None):
    """The MoE FFN from ``chip`` (its layer-0 views bound under "moe"; None:
    the crossbar off, the params widened to ``x``'s dtype), under ``mesh``
    when given, with ``fault`` planted ("zeroed_colsum") when given, routed
    by ``forced`` (a ``deepseek_result`` of the same rank: its top-k ids and
    gates in place of the run's own, whose logits are still computed) when
    given: (y, (this rank's router logits, top-k ids, gates), K1 launches,
    the (M, K, N) K1 launched at, device-synchronised seconds)."""
    routes, shapes = [], set()
    real_route = moe_mod.route_from_logits

    def spy(logits, cfg_, dtype):
        out = real_route(logits, cfg_, dtype)
        routes.append(tuple(t.reshape(-1, t.shape[-1]).float().cpu() for t in (logits, *out[:2])))
        if forced is not None:
            out = (torch.from_numpy(forced["route"]).to(out[0].device).reshape(out[0].shape),
                   torch.from_numpy(forced["gates"]).to(out[1].device, dtype).reshape(out[1].shape), out[2])
        return out

    kvmm.reset_counters()
    reset_crossbar_misses()
    ffn = {k: (v[0] if chip is not None else v[0].to(x.dtype)) for k, v in params["moe"].items()}
    mode = CrossbarMode(enabled=True, programmed=chip, strict=True) if chip is not None else CrossbarMode()
    planted = zeroed_partial_colsums() if fault == "zeroed_colsum" else contextlib.nullcontext()
    moe_mod.route_from_logits = spy
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with k1_shapes(shapes), planted, crossbar_mode(mode), use_mesh(mesh, layout_overrides(cfg) if mesh is not None else None), \
                tprog._push_bind_map(chip.stage_layer_maps("moe")[0] if chip is not None else {}), \
                tprog.name_scope("moe"):
            y = moe_mod.moe_ffn(ffn, x, cfg)
        torch.cuda.synchronize()
    finally:
        moe_mod.route_from_logits = real_route
    require(crossbar_misses() == (), f"moe_ranks_deepseek: artifact misses {crossbar_misses()}")
    require(len(routes) == 1, f"moe_ranks_deepseek: {len(routes)} routings in one layer")
    return y, routes[0], dict(kvmm.LAUNCHES), sorted(shapes), time.perf_counter() - t0


def deepseek_result(run):
    """The host copy of a ``deepseek_layer`` result."""
    y, (logits, route, gates), launches, shapes, sec = run
    return dict(y=y.float().cpu().numpy(), logits=logits.numpy(), route=route.to(torch.int64).numpy(),
                gates=gates.numpy(), launches=launches["fast"], shapes=shapes, seconds=sec)


def deepseek_one_device(rank, store_dir, seed, device):
    """The one-device run, in a process of its own: the MoE FFN programmed
    whole, served at the decode and prefill inputs, and saved to the store
    with the EP layout of a (1, ``DEEPSEEK_RANKS``) mesh recorded."""
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = deepseek_config("ep_only")
    t0 = time.perf_counter()
    params = deepseek_params(cfg, seed, dev)
    torch.cuda.synchronize()
    out = dict(params_seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    chip = tprog.program_model(params, device=dev)
    torch.cuda.synchronize()
    out["program_seconds"] = time.perf_counter() - t0
    out["chip_gb"] = sum(
        getattr(a, f).numel() * getattr(a, f).element_size()
        for a in chip.by_name.values() for f in tprog.ARTIFACT_ARRAY_FIELDS if getattr(a, f) is not None
    ) / 1e9
    for name, shape in (("decode", DEEPSEEK_DECODE), ("prefill", DEEPSEEK_PREFILL)):
        for path, dt in DEEPSEEK_RUNS:
            x = deepseek_input(cfg, shape, seed, dev, dt)
            served = chip if path == "chip" else None
            deepseek_layer(params, served, cfg, None, x)  # warm
            out[(name, path, dt)] = deepseek_result(deepseek_layer(params, served, cfg, None, x))
        x = deepseek_input(cfg, shape, seed, dev, torch.float32)
        for path, dt in DEEPSEEK_RUNS:
            if path == "chip":  # the digital run on the chip run's routing
                out[(name, "forced", dt)] = deepseek_result(
                    deepseek_layer(params, None, cfg, None, x, forced=out[(name, path, dt)]))
    mesh = Mesh((1, DEEPSEEK_RANKS), ("data", "model"))
    t0 = time.perf_counter()
    save_programmed(store_dir, tprog.shard_artifacts(chip, mesh, moe_mod.param_specs(params, cfg, mesh)))
    out["save_seconds"] = time.perf_counter() - t0
    with open(os.path.join(store_dir, "programmed", "manifest.json")) as f:
        out["recorded"] = json.load(f)["artifacts"]["moe/wi"]["sharding"]
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def deepseek_rank(rank, store_dir, seed, t_spawn, device):
    """One rank: its slices restored from the store with ``mesh=`` (by the
    recorded EP spec on a (1, 4) mesh; laid out anew by the expert-TP specs
    on a (2, 2) mesh), its params ``moe.rank_params`` of the one-device
    run's, then the bodies of ``DEEPSEEK_BODIES``, each warmed once then
    timed, each body's ``DEEPSEEK_PLANTS`` right after it (a swapped chip:
    the banks restored by the next model rank's coordinates, the router the
    sound slice)."""
    up_s = time.time() - t_spawn
    dev = torch.device(device)
    torch.cuda.set_device(dev)  # before the meshes: the ranks share its mailboxes
    torch.backends.cuda.matmul.allow_tf32 = False
    meshes = {(1, 4): make_local_mesh(1, 4), (2, 2): make_local_mesh(2, 2)}
    whole = deepseek_params(deepseek_config("ep_only"), seed, dev)
    params = {
        (shape, layout): moe_mod.rank_params(whole, deepseek_config(layout), meshes[shape])
        for _, shape, layout, _, _ in DEEPSEEK_BODIES
    }
    specs = {shape: moe_mod.param_specs(whole, deepseek_config(layout), meshes[shape])
             for _, shape, layout, _, _ in DEEPSEEK_BODIES}
    layouts = {shape: layout for _, shape, layout, _, _ in DEEPSEEK_BODIES}
    del whole
    torch.cuda.empty_cache()
    out = dict(spawn_seconds=up_s, bodies={}, plants={}, restore_seconds={})
    held = dict(chip=None, key=None, router={})

    def chip_for(shape, swapped):
        if held["key"] == (shape, swapped):
            return held["chip"]
        held["chip"] = None
        torch.cuda.empty_cache()
        mesh = meshes[shape]
        # the EP mesh restores by the recorded spec; expert-TP lays it out anew
        laid = specs[shape] if layouts[shape] == "expert_tp" else None
        t0 = time.perf_counter()
        if swapped:
            other = dict(mesh.coords, model=(mesh.coords["model"] + 1) % mesh.shape["model"])
            chip = restore_programmed(store_dir, device=dev, mesh=SimpleNamespace(shape=mesh.shape, coords=other),
                                      specs=laid)
            chip = tprog.ProgrammedModel({"moe": dict(chip.artifacts["moe"], router=held["router"][shape])})
        else:
            chip = restore_programmed(store_dir, device=dev, mesh=mesh, specs=laid)
            held["router"][shape] = chip.artifacts["moe"]["router"]
            out["restore_seconds"][f"{shape[0]}x{shape[1]}"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        held.update(chip=chip, key=(shape, swapped))
        return chip

    for name, shape, layout, dispatch, x_shape in DEEPSEEK_BODIES:
        mesh, cfg = meshes[shape], deepseek_config(layout, dispatch)
        for path, dt in DEEPSEEK_RUNS:
            x = deepseek_input(cfg, x_shape, seed, dev, dt)
            served = chip_for(shape, False) if path == "chip" else None
            deepseek_layer(params[(shape, layout)], served, cfg, mesh, x)  # warm
            out["bodies"][(name, path, dt)] = dict(
                deepseek_result(deepseek_layer(params[(shape, layout)], served, cfg, mesh, x)),
                coords=mesh.coords, bank=list(chip_for(shape, False).by_name["moe/wi"].shape),
            )
        x = deepseek_input(cfg, x_shape, seed, dev, torch.float32)
        # the digital run on each chip run's routing
        for path, dt in DEEPSEEK_RUNS:
            if path == "chip":
                out["bodies"][(name, "forced", dt)] = deepseek_result(deepseek_layer(
                    params[(shape, layout)], None, cfg, mesh, x, forced=out["bodies"][(name, path, dt)]))
        for plant, body, fault in DEEPSEEK_PLANTS:
            if body == name:
                served = chip_for(shape, fault == "swapped_banks")
                run = deepseek_result(deepseek_layer(params[(shape, layout)], served, cfg, mesh, x, fault=fault))
                out["plants"][plant] = dict(run, coords=mesh.coords, forced=deepseek_result(
                    deepseek_layer(params[(shape, layout)], None, cfg, mesh, x, forced=run)))
    out["traffic"] = {f"{k[0]}x{k[1]}": m.traffic for k, m in meshes.items()}
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def _routes_of(body, res):
    """The body's routing of every token, in token order, from its ranks'
    results ``res``: EP routes every token on every rank; all-to-all a
    sequence block a rank (model order); expert-TP a batch block a data
    rank."""
    if body.startswith("ep/"):
        return res[0]["route"]
    if body.startswith("alltoall/"):
        return np.concatenate([r["route"] for r in res])  # B = 1
    return np.concatenate([r["route"] for r in res if r["coords"]["model"] == 0])


def _alike(y, route, y_ref, route_ref):
    """Against a reference run: the share of tokens routed to the same
    experts, and on those max |y - y_ref| / max |y_ref| (None: no token)."""
    same = np.array([set(a) == set(b) for a, b in zip(route.tolist(), route_ref.tolist())])
    same = same.reshape(y_ref.shape[:2])
    rel = float(np.max(np.abs(y - y_ref)[same]) / np.max(np.abs(y_ref))) if same.any() else None
    return dict(tokens_routed_alike=float(same.mean()), max_abs_diff_over_max_abs_y_routed_alike=rel)


def _chip_reading(chip, forced):
    """A chip run against the digital run on its routing (``chip`` /
    ``forced``: the runs' results, one a rank): max |dlogits| / max |logits|
    of the router (the worst rank), and max |dy| / max |y|."""
    logits = max(float(np.max(np.abs(c["logits"] - f["logits"])) / np.max(np.abs(f["logits"])))
                 for c, f in zip(chip, forced))
    y = float(np.max(np.abs(chip[0]["y"] - forced[0]["y"])) / np.max(np.abs(forced[0]["y"])))
    return dict(router_logits=logits, y_same_routing=y)


def _chip_sound(reading):
    """The chip gate (``DEEPSEEK_CHIP_GATE``)."""
    return all(reading[k] <= v for k, v in DEEPSEEK_CHIP_GATE.items())


def moe_ranks_deepseek(dev, seed):
    """deepseek-v2's MoE FFN at published widths over ``DEEPSEEK_RANKS``
    rank processes on the card (``DEEPSEEK_BACKEND``), from rank slices of
    one programmed chip whose store keeps its sharding: the one-device run
    in a process of its own, then the ranks' bodies.  EP and every digital
    body within ``DEEPSEEK_REL_MAX`` of the one-device run; every chip run
    (one device's and each body's) within ``DEEPSEEK_CHIP_GATE`` of the
    digital run on its routing, every planted fault outside it; K1's
    launches on every rank asserted, and each at a shape of
    ``DEEPSEEK_SHAPES``.  The line is printed before the checks fail the
    phase.  Returns the launches of the path."""
    t_phase = time.perf_counter()
    cfg = deepseek_config("ep_only")
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="deepseek_store_") as store:
        t0 = time.perf_counter()
        one = run_ranks(deepseek_one_device, 1, (store, seed, str(dev)), backend=DEEPSEEK_BACKEND, timeout_s=200)[0]
        one_s = time.perf_counter() - t0
        store_gb = sum(os.path.getsize(os.path.join(dp, f)) for dp, _, fs in os.walk(store) for f in fs) / 1e9
        t0 = time.perf_counter()
        ranks = run_ranks(deepseek_rank, DEEPSEEK_RANKS, (store, seed, time.time(), str(dev)),
                          backend=DEEPSEEK_BACKEND, timeout_s=240)
        ranks_s = time.perf_counter() - t0
    fails = []
    per_ffn = 3 if cfg.mlp_kind in ("swiglu", "geglu") else 2
    shared = per_ffn if cfg.moe_shared_experts else 0
    want_one = 1 + per_ffn * cfg.moe_experts + shared
    f32 = torch.float32
    chip_runs = [v["launches"] for k, v in one.items() if isinstance(k, tuple) and k[1] == "chip"]
    if any(n != want_one for n in chip_runs):
        fails.append(f"one device ran {chip_runs} K1 launches a forward, expected {want_one}")
    one_chip = {}
    for name in ("decode", "prefill"):
        digital = one[(name, "digital", f32)]
        for dt in (f32, torch.bfloat16):
            run = one[(name, "chip", dt)]
            one_chip[f"{name}/{str(dt).replace('torch.', '')}"] = reading = dict(
                _chip_reading([run], [one[(name, "forced", dt)]]),
                **_alike(run["y"], run["route"], digital["y"], digital["route"]),
            )
            if not _chip_sound(reading):
                fails.append(f"one device {name} chip/{dt}: {reading}")
    bodies, total = {}, sum(chip_runs)
    shapes = {tuple(s) for v in one.values() if isinstance(v, dict) and "shapes" in v for s in v["shapes"]}
    for name, shape, layout, dispatch, x_shape in DEEPSEEK_BODIES:
        n_local = cfg.moe_experts // (shape[0] if layout == "expert_tp" else shape[1])
        want = 1 + per_ffn * n_local + shared
        entry = dict(mesh=list(shape), layout=layout, dispatch=dispatch, input=list(x_shape),
                     experts_per_rank=n_local, bank_per_rank=ranks[0]["bodies"][(name, "chip", f32)]["bank"])
        for path, dt in DEEPSEEK_RUNS:
            key = (name, path, dt)
            res = [r["bodies"][key] for r in ranks]
            ref = one[(name.split("/")[1], path, dt)]
            ys = [r["y"] for r in res]
            route = _routes_of(name, res)
            rel = float(np.max(np.abs(ys[0] - ref["y"])) / np.max(np.abs(ref["y"])))
            run = f"{path}/{str(dt).replace('torch.', '')}"
            entry[run] = dict(
                max_abs_diff_over_max_abs_y=rel,
                routing_choices_agree=float(np.mean([len(set(a) & set(b)) / len(a)
                                                     for a, b in zip(route.tolist(), ref["route"].tolist())])),
                **_alike(ys[0], route, ref["y"], ref["route"]),
                k1_launches_per_rank=[r["launches"] for r in res],
                forward_seconds_per_rank=[r["seconds"] for r in res], one_device_seconds=ref["seconds"],
                ranks_equal=all(np.array_equal(y, ys[0]) for y in ys), finite=bool(np.isfinite(ys[0]).all()),
            )
            shapes.update(tuple(s) for r in res for s in r["shapes"])
            total += sum(r["launches"] for r in res)
            if any(r["launches"] != (want if path == "chip" else 0) for r in res):
                fails.append(f"{name} {run}: K1 launches a rank {[r['launches'] for r in res]}, "
                             f"expected {want if path == 'chip' else 0}")
            if not (entry[run]["finite"] and entry[run]["ranks_equal"] and ys[0].shape == ref["y"].shape):
                fails.append(f"{name} {run}: outputs not finite, of another shape or differing across ranks")
            if path == "digital" or (name.startswith("ep/") and dt == f32):
                entry[run]["gate"] = f"one device: {DEEPSEEK_REL_MAX}"
                if not rel < DEEPSEEK_REL_MAX:
                    fails.append(f"{name} {run}: {rel} from the one-device run")
            if path == "chip":
                entry[run]["vs_digital_same_routing"] = reading = _chip_reading(
                    res, [r["bodies"][(name, "forced", dt)] for r in ranks])
                entry[run]["gate"] = (entry[run].get("gate", "") + "; " if "gate" in entry[run] else "") + "chip"
                if not _chip_sound(reading):
                    fails.append(f"{name} {run} against the digital run on its routing: {reading}")
        bodies[name] = entry
    plants = {}
    for plant, body, fault in DEEPSEEK_PLANTS:
        res = [r["plants"][plant] for r in ranks]
        plants[plant] = dict(body=body, fault=fault, **_chip_reading(res, [r["forced"] for r in res]))
        plants[plant]["caught"] = not _chip_sound(plants[plant])
        shapes.update(tuple(s) for r in res for s in r["shapes"])
        total += sum(r["launches"] for r in res)
        if not plants[plant]["caught"]:
            fails.append(f"planted fault {plant} passed the chip gate: {plants[plant]}")
    covered = {(M, K, N) for (K, N), rows in DEEPSEEK_SHAPES for M in rows}
    if not shapes <= covered:
        fails.append(f"K1 launched at (M, K, N) {sorted(shapes - covered)}, not held in the kernels phase")
    traffic = ranks[0]["traffic"]
    line = dict(
        phase="moe_ranks_deepseek", arch=DEEPSEEK, ranks=DEEPSEEK_RANKS, backend=DEEPSEEK_BACKEND,
        widths=dict(d_model=cfg.d_model, experts=cfg.moe_experts, top_k=cfg.moe_top_k,
                    shared_experts=cfg.moe_shared_experts, expert_d_ff=cfg.moe_d_ff, mlp=cfg.mlp_kind),
        chip="ideal", router_scale=DEEPSEEK_ROUTER_SCALE, params="bfloat16",
        capacity_factor=cfg.moe_capacity_factor,
        gates=dict(one_device=DEEPSEEK_REL_MAX, chip=DEEPSEEK_CHIP_GATE),
        bodies=bodies, one_device_chip_vs_digital=one_chip, plants=plants, k1_shapes=sorted(shapes),
        one_device=dict(
            seconds=one_s, params_seconds=one["params_seconds"], program_seconds=one["program_seconds"],
            save_seconds=one["save_seconds"], chip_gb=one["chip_gb"], store_gb=store_gb, peak_gb=one["peak_gb"],
            k1_launches_per_forward=want_one, recorded_sharding_of_wi=one["recorded"],
        ),
        ranks_seconds=ranks_s, spawn_seconds_per_rank=[r["spawn_seconds"] for r in ranks],
        restore_seconds_per_rank=[r["restore_seconds"] for r in ranks],
        peak_gb_per_rank=[r["peak_gb"] for r in ranks],
        wire=traffic,
        staged_through_host=sorted({c for t in traffic.values() for c, by in t.items()
                                    if any(v["staged"] for v in by.values())}),
        fails=fails, seconds=time.perf_counter() - t_phase,
    )
    emit(line)
    require(not fails, f"moe_ranks_deepseek: {fails}")
    require(not line["staged_through_host"], f"moe_ranks_deepseek: staged through host {line['staged_through_host']}")
    launches = {k: 0 for k in (*kvmm.LAUNCHES, *kscan.LAUNCHES)}
    launches["fast"] = total
    return launches


def deepseek_serve_config(layout=None, uncapped=False):
    """deepseek-v2 at published widths cut to ``DEEPSEEK_LAYERS`` layers (its
    dense first layer, then its first MoE layer), under ``layout`` when
    given; ``uncapped``: capacity factor E / k, so that no dispatch drops an
    assignment."""
    cfg = get_config(DEEPSEEK)
    dense, moe = cfg.stages
    cfg = dataclasses.replace(
        cfg, n_layers=DEEPSEEK_LAYERS, stages=(dense, dataclasses.replace(moe, repeats=DEEPSEEK_LAYERS - dense.repeats)),
    )
    if layout is not None:
        cfg = dataclasses.replace(cfg, layout=layout)
    if uncapped:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=cfg.moe_experts / cfg.moe_top_k)
    return cfg


def deepseek_rank_traffic(cfg, seed):
    """The ranks' requests (``DEEPSEEK_RANK_REQUESTS`` prompts of at most
    ``DEEPSEEK_PROMPT_MAX`` tokens) and the teacher-forced tokens fed after
    them: (prompts, feed), ``feed[t]`` the tokens of decode step t (step 0
    re-issues each prompt's last token, as an admission does)."""
    prompts = make_requests(cfg, seed, n=DEEPSEEK_RANK_REQUESTS, longest=DEEPSEEK_PROMPT_MAX)
    rng = np.random.default_rng(seed + 1)
    feed = rng.integers(0, cfg.vocab_size, size=(DEEPSEEK_RANK_NEW, len(prompts)))
    feed[0] = [p[-1] for p in prompts]
    return prompts, feed


@contextlib.contextmanager
def recorded_routing(record=None, replay=None, mesh=None):
    """Within the block, every MoE routing (``moe.route_from_logits``) is
    appended to ``record`` as host (top-k ids, gates) when given, and, when
    ``replay`` (such a list from another run, one entry a routing call in
    order) is given, takes the replayed ids and gates in place of its own
    (its logits are still computed): a call over fewer rows than the
    recorded one (an expert-TP rank's batch block) takes this rank's block
    of the mesh's "data" axis."""
    real = moe_mod.route_from_logits
    calls = iter(replay) if replay is not None else None

    def spy(logits, cfg_, dtype):
        idx, gates, probs = real(logits, cfg_, dtype)
        if record is not None:
            record.append((idx.cpu().numpy(), gates.to(torch.float32).cpu().numpy()))
        if calls is not None:
            ids, g = next(calls)
            k = idx.shape[-1]
            ids, g = ids.reshape(-1, k), g.reshape(-1, k)
            n = idx.numel() // k
            if n < ids.shape[0]:
                lo = mesh.axis_index("data") * n
                ids, g = ids[lo:lo + n], g[lo:lo + n]
            idx = torch.from_numpy(np.ascontiguousarray(ids)).to(idx.device).reshape(idx.shape)
            gates = torch.from_numpy(np.ascontiguousarray(g)).to(gates.device, dtype).reshape(gates.shape)
        return idx, gates, probs

    moe_mod.route_from_logits = spy
    try:
        yield
    finally:
        moe_mod.route_from_logits = real


def forced_logits(params, cfg, chip, mesh, dev, prompts, feed, record=None, replay=None):
    """Teacher-forced logits, eager: each prompt prefilled alone (zero-padded
    to its bucket, on a fresh one-slot cache) and copied into its slot of a
    pool, then ``len(feed)`` decode steps of the pool fed ``feed``, each
    slot at its own position; ``chip`` None: the crossbar off; under
    ``mesh`` when given; the routing recorded or replayed as
    ``recorded_routing`` says.  Returns (logits (steps, B, V) float32 on the
    host, K1 launches, forwards)."""
    mode = CrossbarMode(enabled=True, programmed=chip, strict=True) if chip is not None else CrossbarMode()
    B, seq = len(prompts), DEEPSEEK_SEQ
    out = []
    kvmm.reset_counters()
    with contextlib.ExitStack() as stack:
        stack.enter_context(recorded_routing(record, replay, mesh))
        stack.enter_context(crossbar_mode(mode))
        if chip is not None:
            stack.enter_context(chip.bind())
        stack.enter_context(use_mesh(mesh, layout_overrides(cfg) if mesh is not None else None))
        pool = model_lib.init_cache(cfg, B, seq, dtype=torch.float32, device=dev)
        for slot, p in enumerate(prompts):
            one = model_lib.init_cache(cfg, 1, seq, dtype=torch.float32, device=dev)
            tokens = np.zeros((1, DEEPSEEK_PROMPT_MAX), np.int64)
            tokens[0, : len(p)] = p
            model_lib.prefill(params, cfg, torch.from_numpy(tokens).to(dev), one)
            for big, small in zip(cache_leaves(pool), cache_leaves(one)):
                big[:, slot] = small[:, 0]
        pos = torch.tensor([len(p) - 1 for p in prompts], device=dev)
        for t in range(len(feed)):
            tok = torch.from_numpy(np.asarray(feed[t], np.int64)[:, None]).to(dev)
            logits, _ = model_lib.decode_step(params, cfg, tok, pos + t, pool)
            out.append(logits.to(torch.float32).cpu().numpy())
    return np.stack(out), kvmm.LAUNCHES["fast"], B + len(feed)


def serve_logged(eng, prompts, max_new):
    """Serve ``prompts`` to the end: (tokens by request, every tick's logits
    of the whole pool, each step's seconds on the host clock)."""
    ticks, step_s = [], []
    real = eng.runner.sample

    def sample(logits):
        ticks.append(np.array(logits))
        return real(logits)

    eng.runner.sample = sample
    try:
        rids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
        while eng.pending or any(s is not None for s in eng.slots):
            t0 = time.perf_counter()
            eng.step()
            step_s.append(time.perf_counter() - t0)
        done = {r.rid: r for r in eng.run_until_done(max_ticks=0)}
    finally:
        del eng.runner.sample
    return [done[i].generated for i in rids], ticks, step_s


def rel_max(a, ref) -> float:
    """max |a - ref| / max |ref|."""
    return float(np.max(np.abs(a - ref)) / np.max(np.abs(ref)))


def rel_l2(a, ref) -> float:
    return float(np.linalg.norm((a - ref).ravel()) / np.linalg.norm(ref.ravel()))


def tokens_held(one, rank):
    """Served tokens against the one-device run's (``one``, ``rank``: the
    ``serve_logged`` results of the same requests, admitted alike).  A
    request's tokens are compared tick by tick: where both sides' top-2
    margin exceeds twice the largest logit gap between them the tokens must
    be equal (``tests/_moe_serving.py`` ``same_tokens``'s rule), elsewhere
    they may part; after its first differing token the request's inputs
    differ and the comparison stops.  Returns (ticks held, ticks compared,
    failures)."""
    held = compared = 0
    fails = []
    for i, (a_tok, b_tok) in enumerate(zip(one[0], rank[0])):
        for t, (a, b) in enumerate(zip(a_tok, b_tok)):
            la, lb = one[1][t][i], rank[1][t][i]
            top_a, top_b = np.sort(la)[-2:], np.sort(lb)[-2:]
            margin = min(top_a[1] - top_a[0], top_b[1] - top_b[0])
            decisive = margin > 2 * float(np.max(np.abs(la - lb)))
            compared += 1
            if decisive and a != b:
                fails.append(f"request {i} tick {t}: tokens {a} / {b} at margin {margin}")
            held += int(decisive)
            if a != b:
                break
    return held, compared, fails


def save_weights(params, directory):
    """Every leaf as an ``.npy`` (bf16 as its 16-bit words) and an index
    {name: [file, dtype]}, for the ranks to memory-map."""
    os.makedirs(directory)
    index = {}
    for i, (name, t) in enumerate(flatten(params).items()):
        index[name] = [f"{i}.npy", str(t.dtype).replace("torch.", "")]
        np.save(os.path.join(directory, index[name][0]), tensor_to_numpy(t))
    with open(os.path.join(directory, "index.json"), "w") as f:
        json.dump(index, f)


def load_rank_weights(directory, cfg, mesh, dev):
    """This rank's copy of the saved params: every MoE FFN's router and banks
    cut to the rank's slices of the memory-mapped files (``moe.param_specs``
    under ``cfg``'s layout), every other leaf whole."""
    with open(os.path.join(directory, "index.json")) as f:
        index = json.load(f)
    flat = {n: np.load(os.path.join(directory, fname), mmap_mode="r") for n, (fname, _) in index.items()}
    tree = {}
    for name, a in flat.items():
        node = tree
        *path, last = name.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = a
    specs = moe_mod.param_specs(tree, cfg, mesh)

    def leaf(node, path):
        if isinstance(node, dict):
            return {k: leaf(v, path + (k,)) for k, v in node.items()}
        name = "/".join(path)
        if name in specs:
            node = tprog.local_slice(node, specs[name], mesh.shape, mesh.coords)
        t = torch.from_numpy(np.ascontiguousarray(node))
        return (t.view(torch.bfloat16) if index[name][1] == "bfloat16" else t).to(dev)

    return leaf(tree, ())


def mla_card_vs_cpu(params, cfg, dev, seed):
    """Layer 0's MLA block at full width with the crossbar off, in float32
    (the bf16 weights widened), on the card and on the CPU: a 1 x 32 prompt
    into a cache of ``DEEPSEEK_SEQ``, then 4 decode steps; max |dy| / max |y|
    and of the caches, each step."""
    mixer = {k: v[0].to(torch.float32) for k, v in params["stage0"]["b0"]["mixer"].items()}
    cpu_mixer = {k: v.cpu() for k, v in mixer.items()}
    gen = torch.Generator().manual_seed(seed)
    steps = [torch.randn((1, 32, cfg.d_model), generator=gen)] + [
        torch.randn((1, 1, cfg.d_model), generator=gen) for _ in range(4)
    ]
    caches = {d: attn_mod.init_attention_cache(cfg, 1, DEEPSEEK_SEQ, torch.float32, d) for d in (dev, "cpu")}
    worst, readings = 0.0, []
    for t, x in enumerate(steps):
        pos = torch.arange(32) if t == 0 else torch.tensor([31 + t])
        ys = {}
        for d, m in ((dev, mixer), ("cpu", cpu_mixer)):
            decode = None if t == 0 else pos.to(d)
            positions = pos.to(d) if t == 0 else pos.to(d)[:, None]
            ys[d], _ = attn_mod.attention_block(m, x.to(d), cfg, "attn", positions, caches[d], decode)
        y_card, y_cpu = ys[dev].cpu().numpy(), ys["cpu"].numpy()
        r = dict(step=t, y=rel_max(y_card, y_cpu), **{
            n: rel_max(caches[dev][n].cpu().numpy(), caches["cpu"][n].numpy()) for n in ("latent", "k_rope")
        })
        readings.append(r)
        worst = max(worst, r["y"], r["latent"], r["k_rope"])
    return dict(worst=worst, gate=DEEPSEEK_MLA_CPU_GATE, steps=readings)


def serve_deepseek_one(rank, workdir, seed, device, t0):
    """The one-device process of serve_deepseek: deepseek-v2 at depth 2 on
    an ideal chip through ``ServingEngine`` (``serve_phase``), its store round
    trip (the store the ranks then restore), the bf16 weights saved for the
    ranks, the MLA block card against CPU, the ranks' requests served and
    teacher-forced (chip and crossbar off, at the config's capacity and
    uncapped), then tick_profile_deepseek, graph_vs_eager_deepseek and
    prefill_vs_eager_deepseek.  Its lines are printed here; what the ranks
    are held to is written under ``workdir``."""
    global _T0
    _T0 = t0  # the parent's clock (perf_counter is one monotonic clock a machine)
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    shapes = set()
    with k1_shapes(shapes):
        cfg = deepseek_serve_config()
        t = time.perf_counter()
        params = model_lib.init_model(cfg, seed=seed, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        torch.cuda.reset_peak_memory_stats()
        ideal = CrossbarMode(enabled=True, strict=True)
        line, launches, eng = serve_phase(
            "serve_deepseek", cfg, params, ideal, "fast", dev, seed + 1, False, longest=DEEPSEEK_PROMPT_MAX,
        )
        want = moe_vmm_calls(cfg, moe_mod.SINGLE_DEVICE)
        require(
            line["projections"] == want == DEEPSEEK_K1_PER_FORWARD,
            f"serve_deepseek: {line['projections']} projections a forward, the config gives {want}, "
            f"expected {DEEPSEEK_K1_PER_FORWARD}",
        )
        require(line["prefill_graphs"] == [DEEPSEEK_PROMPT_MAX], f"serve_deepseek: buckets {line['prefill_graphs']}")
        param_gb = sum(x.numel() * x.element_size() for x in leaves(params)) / 1e9
        chip_gb = sum(
            getattr(a, f).numel() * getattr(a, f).element_size()
            for a in eng.programmed.by_name.values() for f in tprog.ARTIFACT_ARRAY_FIELDS if getattr(a, f) is not None
        ) / 1e9
        # the store: saved, verified, restored into a second engine that
        # serves the same tokens; the ranks restore their slices from it
        store = os.path.join(workdir, "store")
        t = time.perf_counter()
        eng.save_artifacts(store)
        save_s = time.perf_counter() - t
        report = verify_store(store, expected=tprog.expected_artifact_names(params))
        require(report.ok, f"serve_deepseek: the saved chip fails verify_store: {report.summary()}")
        t = time.perf_counter()
        eng2 = ServingEngine(cfg, params, max_batch=4, max_seq=DEEPSEEK_SEQ, device=dev, restore_artifacts=store,
                             crossbar=CrossbarMode(enabled=True, strict=True))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        prompts = make_requests(cfg, seed + 1, longest=DEEPSEEK_PROMPT_MAX)
        again = [r.generated for r in drive(eng2, prompts, max_new=16)[0]]
        require(again == line["tokens"], "serve_deepseek: the restored chip served different tokens")
        del eng2
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        save_weights(params, os.path.join(workdir, "weights"))
        weights_s = time.perf_counter() - t
        # the ranks' requests on this engine, then teacher-forced
        rank_prompts, feed = deepseek_rank_traffic(cfg, seed + 5)
        served = serve_logged(eng, rank_prompts, DEEPSEEK_RANK_NEW)
        forced, forced_k1, routes = {}, {}, []
        for capped in (True, False):
            c = deepseek_serve_config(uncapped=not capped)
            for path, chip in (("chip", eng.programmed), ("digital", None)):
                key = f"{path}/{'capped' if capped else 'uncapped'}"
                forced[key], k1, forwards = forced_logits(
                    params, c, chip, None, dev, rank_prompts, feed, record=routes if key == "digital/uncapped" else None)
                forced_k1[key] = k1
                require(k1 == (want * forwards if chip is not None else 0),
                        f"serve_deepseek: {k1} K1 launches in {forwards} teacher-forced forwards ({key})")
        np.savez(os.path.join(workdir, "one_device.npz"), tokens=np.array(served[0]), ticks=np.stack(served[1]),
                 **{k.replace("/", "__"): v for k, v in forced.items()})
        # the digital uncapped run's routing, which expert-TP's digital run replays
        np.savez(os.path.join(workdir, "routes.npz"), **{
            f"{f}{i}": a for i, r in enumerate(routes) for f, a in zip(("ids", "gates"), r)})
        rel = rel_l2(forced["chip/capped"], forced["digital/capped"])
        head = eng.programmed.by_name["head"]
        line.update(
            layers=cfg.n_layers, reduced=[f"depth {get_config(DEEPSEEK).n_layers} -> {cfg.n_layers}"],
            widths=dict(d_model=cfg.d_model, heads=cfg.n_heads, head_dim=cfg.head_dim, kv_lora_rank=cfg.kv_lora_rank,
                        qk_rope_dim=cfg.qk_rope_dim, dense_d_ff=cfg.d_ff, experts=cfg.moe_experts,
                        top_k=cfg.moe_top_k, expert_d_ff=cfg.moe_d_ff, shared_experts=cfg.moe_shared_experts,
                        vocab=cfg.vocab_size),
            capacity_factor=cfg.moe_capacity_factor, k1_launches_per_forward=want,
            k1_reckoning="layer 0: 3 MLA + 2 dense FFN; layer 1: 3 MLA + router + 160 experts x 3 + shared 3; head 1",
            init_seconds=init_s, param_gb=param_gb, chip_gb=chip_gb, save_seconds=save_s, restore_seconds=restore_s,
            weights_save_seconds=weights_s, store_restored_tokens_equal=True,
            verify_store_findings=len(report.findings), verified_artifacts=report.n_artifacts,
            capture_seconds_total=line["capture_seconds"] + sum(line["prefill_capture_seconds"].values()),
            logits_rel_l2_vs_plain_matmul=rel, rel_l2_gate=DEEPSEEK_REL_L2_MAX,
            head_w_scale=float(head.w_scale), head_drop_lsb=layer_scaled_spec(head.spec, cfg.d_model).drop_lsb,
            mla_card_vs_cpu=mla_card_vs_cpu(params, cfg, dev, seed + 7),
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        )
        emit(line)
        require(rel < DEEPSEEK_REL_L2_MAX, f"serve_deepseek: rel-L2 {rel} to the plain-matmul model")
        mla = line["mla_card_vs_cpu"]
        require(mla["worst"] <= DEEPSEEK_MLA_CPU_GATE, f"serve_deepseek: the MLA block card vs CPU {mla}")
        # where a tick goes, then replay against eager, tick and admission
        prof = tick_profile("tick_profile_deepseek", eng, make_requests(cfg, seed + 3, longest=DEEPSEEK_PROMPT_MAX),
                            ticks=3, classes=DEEPSEEK_TICK_CLASSES)
        require(
            {k["name"]: k["calls_per_tick"] for k in prof["kernels"]} == {"fast_kernel": want},
            f"tick_profile_deepseek: kernels a tick {prof['kernels']}",
        )
        graph_vs_eager("deepseek", eng, make_requests(cfg, seed + 6, longest=DEEPSEEK_PROMPT_MAX))
        prefill_vs_eager("deepseek", eng.runner, seed + 9, buckets=(DEEPSEEK_PROMPT_MAX,))
    return dict(launches=launches, shapes=sorted(shapes), forced_k1=forced_k1,
                head_lsb=dict(w_scale=float(head.w_scale), drop_lsb=line["head_drop_lsb"]))


def serve_deepseek_rank(rank, workdir, seed, t_spawn, device):
    """One rank of serve_deepseek_ranks, on each mesh of
    ``DEEPSEEK_MESHES`` in turn: its copy of the weights (its slices of the
    memory-mapped banks), a ``ServingEngine(mesh=, restore_artifacts=)`` of
    its slices of the store, the ranks' requests served, then teacher-forced
    on the chip and with the crossbar off (EP at the config's capacity,
    expert-TP uncapped); on EP also with ranks 0 and 1's bank slices
    swapped (a planted fault)."""
    up_s = time.time() - t_spawn
    dev = torch.device(device)
    torch.cuda.set_device(dev)  # before the meshes: the ranks share its mailboxes
    torch.backends.cuda.matmul.allow_tf32 = False
    meshes = {shape: make_local_mesh(*shape) for _, shape, _ in DEEPSEEK_MESHES}
    out = dict(spawn_seconds=up_s, meshes={})
    shapes = set()
    with k1_shapes(shapes):
        for name, shape, layout in DEEPSEEK_MESHES:
            mesh = meshes[shape]
            cfg = deepseek_serve_config(layout)
            rank_prompts, feed = deepseek_rank_traffic(cfg, seed + 5)
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            params = load_rank_weights(os.path.join(workdir, "weights"), cfg, mesh, dev)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t
            t = time.perf_counter()
            eng = ServingEngine(cfg, params, max_batch=4, max_seq=DEEPSEEK_SEQ, mesh=mesh, device=dev,
                                restore_artifacts=os.path.join(workdir, "store"),
                                crossbar=CrossbarMode(enabled=True, strict=True))
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t
            kvmm.reset_counters()  # the engine's serving run alone
            tokens, ticks, step_s = serve_logged(eng, rank_prompts, DEEPSEEK_RANK_NEW)
            res = dict(coords=mesh.coords, load_seconds=load_s, restore_seconds=restore_s, step_seconds=step_s,
                       serve_k1=dict(kvmm.LAUNCHES), serve_forwards=len(rank_prompts) + len(ticks),
                       tokens=tokens, ticks=np.stack(ticks) if rank == 0 else None,
                       graphs=(eng.runner.decode_graph is None and not eng.runner.prefill_graphs),
                       k1_per_forward=eng.programmed.calls_per_forward,
                       bank=list(eng.programmed.by_name["stage1/b0/ffn/wi"].shape))
            forced_cfg = deepseek_serve_config(layout, uncapped=(layout == "expert_tp"))
            own = []
            for path, chip in (("chip", eng.programmed), ("digital", None)):
                t = time.perf_counter()
                res[path], res[f"{path}_k1"], res["forwards"] = forced_logits(
                    params, forced_cfg, chip, mesh, dev, rank_prompts, feed, record=own if path == "digital" else None)
                res[f"{path}_seconds"] = time.perf_counter() - t
            if layout == "expert_tp":
                # digitally again, routed as one device's digital run routed
                # (a bf16 K-partial of the router reorders near-tied experts)
                with np.load(os.path.join(workdir, "routes.npz")) as z:
                    one_routes = [(z[f"ids{i}"], z[f"gates{i}"]) for i in range(len(z.files) // 2)]
                res["digital_one_routing"] = forced_logits(
                    params, forced_cfg, None, mesh, dev, rank_prompts, feed, replay=one_routes)[0]
                alike = []
                for (mine, _), (theirs, _) in zip(own, one_routes):
                    k = mine.shape[-1]
                    a, b = mine.reshape(-1, k), theirs.reshape(-1, k)
                    if a.shape[0] < b.shape[0]:
                        lo = mesh.axis_index("data") * a.shape[0]
                        b = b[lo:lo + a.shape[0]]
                    alike += [set(x) == set(y) for x, y in zip(a.tolist(), b.tolist())]
                res["tokens_routed_alike"] = float(np.mean(alike))
            if name == "ep":
                chip = eng.programmed
                del eng
                if mesh.coords["model"] in (0, 1):  # ranks 0 and 1 serve each other's bank slices
                    chip = None
                    gc.collect()
                    torch.cuda.empty_cache()
                    other = SimpleNamespace(shape=mesh.shape, coords=dict(mesh.coords, model=1 - mesh.coords["model"]))
                    chip = restore_programmed(os.path.join(workdir, "store"), device=dev, mesh=other,
                                              specs=moe_mod.param_specs(params, cfg, mesh))
                res["swapped"], res["swapped_k1"], _ = forced_logits(params, forced_cfg, chip, mesh, dev, rank_prompts, feed)
            eng = chip = params = None
            gc.collect()
            torch.cuda.empty_cache()
            res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            out["meshes"][name] = res
    out["traffic"] = {f"{k[0]}x{k[1]}": m.traffic for k, m in meshes.items()}
    out["shapes"] = sorted(shapes)
    return out


def serve_deepseek(dev, seed):
    """serve_deepseek (its own process), then serve_deepseek_ranks: the
    ranks' tokens identical on every rank; EP teacher-forced on the chip
    within ``DEEPSEEK_LOGITS_GATE`` of one device, EP and expert-TP
    digitally within ``DEEPSEEK_DIGITAL_GATE``, expert-TP's own routing
    alike on ``DEEPSEEK_ROUTED_ALIKE_MIN`` of the rows; the planted swap
    outside the chip gate; EP's served tokens the one device's where
    ``tokens_held`` says they must be; K1's launches a forward of each
    rank's serving run asserted and every K1 launch of both phases at a
    shape the kernels phase holds.  Returns the launches of the two
    phases' serving runs."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    covered = {(M, K, N) for (K, N), rows in DEEPSEEK_SHAPES for M in rows}
    with tempfile.TemporaryDirectory(prefix="deepseek_serve_") as work:
        one = run_ranks(serve_deepseek_one, 1, (work, seed, str(dev), _T0), backend=DEEPSEEK_BACKEND,
                        timeout_s=400)[0]
        one_s = time.perf_counter() - t_phase
        require(set(map(tuple, one["shapes"])) <= covered,
                f"serve_deepseek: K1 launched at {sorted(set(map(tuple, one['shapes'])) - covered)}, not held")
        with np.load(os.path.join(work, "one_device.npz")) as z:
            ref = {k.replace("__", "/"): z[k] for k in z.files}
        t = time.perf_counter()
        ranks = run_ranks(serve_deepseek_rank, DEEPSEEK_RANKS, (work, seed, time.time(), str(dev)),
                          backend=DEEPSEEK_BACKEND, timeout_s=400)
        ranks_s = time.perf_counter() - t
    fails, meshes, total, forced_total, planted_total = [], {}, 0, 0, 0
    for name, shape, layout in DEEPSEEK_MESHES:
        res = [r["meshes"][name] for r in ranks]
        cap = "capped" if layout != "expert_tp" else "uncapped"
        entry = dict(mesh=list(shape), layout=layout, capacity=cap, bank_per_rank=res[0]["bank"],
                     k1_per_forward=[r["k1_per_forward"] for r in res])
        if any(r["k1_per_forward"] != DEEPSEEK_RANK_K1[name] for r in res):
            fails.append(f"{name}: K1 a forward {entry['k1_per_forward']}, expected {DEEPSEEK_RANK_K1[name]}")
        entry["serve_forwards"] = [r["serve_forwards"] for r in res]
        entry["serve_k1_launches"] = [r["serve_k1"]["fast"] for r in res]
        for r in res:
            # the engine's serving run: K1 once a projection of each of its
            # forwards (its prefills and ticks), and no other kernel
            want = {k: DEEPSEEK_RANK_K1[name] * r["serve_forwards"] if k == "fast" else 0 for k in r["serve_k1"]}
            total += r["serve_k1"]["fast"]
            if r["serve_k1"] != want:
                fails.append(f"{name} rank {r['coords']}: serving launches {r['serve_k1']}, expected {want}")
            want = DEEPSEEK_RANK_K1[name] * r["forwards"]
            forced_total += r["chip_k1"]
            planted_total += r.get("swapped_k1", 0)
            if r["chip_k1"] != want or r["digital_k1"] != 0:
                fails.append(f"{name} rank {r['coords']}: teacher-forced K1 launches {r['chip_k1']} / "
                             f"{r['digital_k1']}, expected {want} / 0")
        entry["tokens_equal_across_ranks"] = all(r["tokens"] == res[0]["tokens"] for r in res)
        entry["forced_equal_across_ranks"] = all(
            np.array_equal(r[p], res[0][p]) for r in res for p in ("chip", "digital"))
        if not (entry["tokens_equal_across_ranks"] and entry["forced_equal_across_ranks"]):
            fails.append(f"{name}: the ranks' tokens or logits differ")
        entry["no_capture"] = all(r["graphs"] for r in res)
        entry["chip_vs_one_device"] = rel_max(res[0]["chip"], ref[f"chip/{cap}"])
        entry["digital_vs_one_device"] = rel_max(res[0]["digital"], ref[f"digital/{cap}"])
        entry["chip_rel_l2_vs_plain_matmul"] = rel_l2(res[0]["chip"], ref[f"digital/{cap}"])
        entry["finite"] = bool(np.isfinite(res[0]["chip"]).all() and np.isfinite(res[0]["digital"]).all())
        if not entry["finite"] or entry["chip_rel_l2_vs_plain_matmul"] >= DEEPSEEK_REL_L2_MAX:
            fails.append(f"{name}: chip logits not finite or rel-L2 {entry['chip_rel_l2_vs_plain_matmul']}")
        if layout == "expert_tp":
            entry["digital_same_routing_vs_one_device"] = rel_max(res[0]["digital_one_routing"], ref["digital/uncapped"])
            entry["digital_tokens_routed_alike"] = [r["tokens_routed_alike"] for r in res]
            gated = {"digital_same_routing_vs_one_device": DEEPSEEK_DIGITAL_GATE}
            if min(entry["digital_tokens_routed_alike"]) < DEEPSEEK_ROUTED_ALIKE_MIN:
                fails.append(f"{name}: tokens routed as one device routed {entry['digital_tokens_routed_alike']}, "
                             f"floor {DEEPSEEK_ROUTED_ALIKE_MIN}")
        else:
            gated = {"digital_vs_one_device": DEEPSEEK_DIGITAL_GATE, "chip_vs_one_device": DEEPSEEK_LOGITS_GATE}
        entry["gated"] = gated
        for k, gate in gated.items():
            if not entry[k] < gate:
                fails.append(f"{name}: {k} {entry[k]}, gate {gate}")
        if name == "ep":
            entry["swapped_banks_vs_one_device"] = rel_max(res[0]["swapped"], ref["chip/capped"])
            entry["swapped_banks_caught"] = entry["swapped_banks_vs_one_device"] >= DEEPSEEK_LOGITS_GATE
            if not entry["swapped_banks_caught"]:
                fails.append(f"ep: the planted bank swap passed the gate ({entry['swapped_banks_vs_one_device']})")
            held, compared, tok_fails = tokens_held(
                (ref["tokens"].tolist(), list(ref["ticks"])), (res[0]["tokens"], list(res[0]["ticks"])))
            entry.update(served_ticks_held=held, served_ticks_compared=compared,
                         served_tokens_equal_one_device=res[0]["tokens"] == ref["tokens"].tolist())
            fails += [f"ep served: {f}" for f in tok_fails]
        entry.update(
            load_seconds_per_rank=[r["load_seconds"] for r in res],
            restore_seconds_per_rank=[r["restore_seconds"] for r in res],
            step_ms_median=1e3 * statistics.median(res[0]["step_seconds"]),
            forced_chip_seconds=[r["chip_seconds"] for r in res],
            forced_digital_seconds=[r["digital_seconds"] for r in res],
            peak_gb_per_rank=[r["peak_gb"] for r in res],
        )
        meshes[name] = entry
    shapes = {tuple(s) for r in ranks for s in r["shapes"]}
    if not shapes <= covered:
        fails.append(f"K1 launched at (M, K, N) {sorted(shapes - covered)}, not held in the kernels phase")
    traffic = ranks[0]["traffic"]
    line = dict(
        phase="serve_deepseek_ranks", arch=DEEPSEEK, ranks=DEEPSEEK_RANKS, backend=DEEPSEEK_BACKEND,
        layers=DEEPSEEK_LAYERS, reduced=[f"depth {get_config(DEEPSEEK).n_layers} -> {DEEPSEEK_LAYERS}"],
        requests=DEEPSEEK_RANK_REQUESTS, new_tokens=DEEPSEEK_RANK_NEW, chip_gate=DEEPSEEK_LOGITS_GATE,
        digital_gate=DEEPSEEK_DIGITAL_GATE, routed_alike_min=DEEPSEEK_ROUTED_ALIKE_MIN,
        meshes=meshes, one_device_seconds=one_s, ranks_seconds=ranks_s,
        spawn_seconds_per_rank=[r["spawn_seconds"] for r in ranks], wire=traffic,
        staged_through_host=sorted({c for t in traffic.values() for c, by in t.items()
                                    if any(v["staged"] for v in by.values())}),
        wire_dtypes=sorted({d for t in traffic.values() for by in t.values() for d in by}),
        k1_shapes=sorted(shapes), k1_launches_serving=total, k1_launches_teacher_forced=forced_total,
        k1_launches_planted_swap=planted_total, fails=fails, seconds=time.perf_counter() - t_phase,
    )
    emit(line)
    require(not fails, f"serve_deepseek_ranks: {fails}")
    require(not line["staged_through_host"], f"serve_deepseek_ranks: staged through host {line['staged_through_host']}")
    launches = {k: 0 for k in (*kvmm.LAUNCHES, *kscan.LAUNCHES)}
    launches["fast"] = total
    return one["launches"], launches


def serve_launcher():
    """The serving launcher as a user runs it, on the card:
    ``python -m repro_torch.launch.serve --arch deepseek-v2-236b --reduced
    --crossbar``; exit 0 and its lines parsed."""
    t = time.perf_counter()
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", DEEPSEEK, "--reduced", "--crossbar"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    lines = proc.stdout.splitlines()
    served = next((ln for ln in lines if ln.startswith("[serve]")), "")
    energy = next((ln for ln in lines if ln.startswith("[newton]")), "")
    words = served.split()
    line = dict(phase="serve_launcher", command=" ".join(cmd[1:]), returncode=proc.returncode,
                seconds=time.perf_counter() - t, serve_line=served, energy_line=energy,
                requests=int(words[1]) if len(words) > 1 else None,
                tokens=int(words[3]) if len(words) > 3 else None,
                stderr_tail=proc.stderr[-2000:] if proc.returncode else "")
    emit(line)
    require(proc.returncode == 0, f"serve_launcher exited {proc.returncode}")
    require(line["requests"] == 8 and line["tokens"] == 8 * 16 and "[crossbar datapath]" in served and energy,
            f"serve_launcher: unexpected output {lines[:3]}")


def tick_profile(phase, eng, prompts, ticks=3, classes=None):
    """Where one decode tick goes: ``ticks`` steady decode ticks of a full
    slot pool (graph replays) in one ``profile_window`` (``classes`` as
    there).  Where the profiler dropped records of the window, the pool is
    drained and filled anew (``retried_window``)."""
    def steps():
        for _ in range(ticks):
            eng.step()

    def window():
        for p in prompts[:4]:
            eng.submit(p, max_new_tokens=ticks + 8)
        for _ in range(3):  # admission and warm ticks
            eng.step()
        try:
            return profile_window(phase, steps, ticks, classes)
        finally:
            eng.run_until_done()

    return retried_window(phase, window)


def retried_window(phase, window):
    """``window()`` (a ``profile_window``) taken anew where the profiler
    dropped records of it, up to ``PROFILE_RUNS`` windows in all."""
    dropped = []
    while True:
        try:
            return window()
        except RecordsDropped as e:
            dropped.append(e.short)
            require(len(dropped) < PROFILE_RUNS, f"{phase}: the profiler dropped records in {len(dropped)} windows: {dropped}")


class RecordsDropped(RuntimeError):
    """The profiler dropped device records of a window: it saw fewer calls
    of our kernels than the window credited, and of no kernel more, or none
    of the window's prologue (``short["prologue"]``)."""

    def __init__(self, phase, short):
        super().__init__(f"chip_smoke check failed: {phase}: the profiler dropped records, calls a tick short {short}")
        self.short = short


@contextlib.contextmanager
def profiler_session():
    """A ``torch.profiler`` session (CPU + CUDA activities) opened by
    ``PROFILE_PROLOGUE`` spin kernels and a synchronise; yields the profile.
    The profiler loses a session's first device records: a count that grows
    with the process's age (about one every 14 s on an H100, whatever the
    spins' length, and whether or not the host waits before or after the
    session opens), and at times a run of hundreds anywhere in the session
    (``profiler_loss_probe.py``).  The steady loss falls on the prologue; a
    session that kept none of it may have lost records of its own, and a
    run lost later shows as kernels short of their count (``profile_window``)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PROLOGUE):
            torch.cuda._sleep(PROLOGUE_SPIN_CYCLES)
        torch.cuda.synchronize()
        yield prof


def device_entries(prof):
    """The device-side entries of a ``profiler_session`` (kernels, memcpys)
    as (name, ms, calls), heaviest first, and the prologue's spins seen.  A
    CPU op's entry counts the device time of the kernels it launched a
    second time, so it is left out."""
    from torch.autograd import DeviceType

    kernels, prologue_seen = [], 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            if PROLOGUE_KERNEL in e.key:
                prologue_seen += e.count
            else:
                kernels.append((e.key, e.self_device_time_total / 1e3, e.count))
    kernels.sort(key=lambda k: -k[1])
    return kernels, prologue_seen


def profile_window(phase, run, ticks, classes=None, ours=True):
    """``run()`` (``ticks`` steps of a serve loop; it may return a dict of
    fields for the line) under ``torch.profiler``
    (CPU + CUDA activities).  Device busy time is the sum of the kernels' own
    device time; the wall time is taken with the profiler on and is not the
    tick time reported by the serve phases.  ``kernels``: each of our kernels
    that ran in the window, its device time and calls a tick as the profiler
    saw them (replayed or eager), held equal to the launches a tick that the
    window added to the wrappers' counters (summed over every trace entry that
    names the kernel).

    The window runs in a ``profiler_session``, and the line reports how
    many of its prologue's spins the profiler lost
    (``prologue_records_lost``).  A window that saw none of them may have
    lost records of its own: it raises ``RecordsDropped``, as does a window
    in which the profiler saw fewer calls of some kernel than were credited,
    and of none more (its line is emitted as ``<phase>_dropped``); any other
    disagreement fails.  ``classes``
    ({class: names}, in order) splits the busy time a tick by kernel name:
    a kernel goes to the first class one of whose names its name holds,
    else to "rest".  ``ours=False``: a window that must credit no launch of
    our kernels and no planned call (a digital block's)."""
    counters = lambda: (dict(kvmm.LAUNCHES, **kscan.LAUNCHES), dict(tprog.PLANNED_CALLS))
    torch.cuda.synchronize()
    before = counters()
    with profiler_session() as prof:
        t0 = time.perf_counter()
        extra = run() or {}
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    after = counters()
    credited = {k: n - before[0].get(k, 0) for k, n in after[0].items() if n - before[0].get(k, 0)}
    planned = {k: (n - before[1].get(k, 0)) / ticks for k, n in after[1].items() if n - before[1].get(k, 0)}
    kernels, prologue_seen = device_entries(prof)
    busy_ms = sum(k[1] for k in kernels)
    line = dict(
        phase=phase, ticks=ticks, **extra, wall_ms_per_tick_profiled=wall_ms / ticks,
        device_busy_ms_per_tick=busy_ms / ticks,
        device_idle_share=(1.0 - busy_ms / wall_ms) if wall_ms else None,
        device_launches_per_tick=sum(k[2] for k in kernels) / ticks,
        top_device_time=[dict(name=k[0][:60], ms_per_tick=k[1] / ticks, calls_per_tick=k[2] / ticks) for k in kernels[:8]],
        kernels=[], planned_calls_per_tick=planned, prologue_records_lost=PROFILE_PROLOGUE - prologue_seen,
        # trace entries of our three VMM kernels, credited or not
        vmm_kernel_calls_per_tick=sum(
            k[2] for k in kernels if any(TRACE_NAMES[c] in k[0] for c in VMM_COUNTERS)
        ) / ticks,
    )
    if classes:
        by = dict.fromkeys((*classes, "rest"), 0.0)
        for name, ms, _ in kernels:
            by[next((c for c, keys in classes.items() if any(key in name for key in keys)), "rest")] += ms / ticks
        line["busy_ms_per_tick_by_class"] = by
    for counter, n in credited.items():
        name = TRACE_NAMES[counter]
        mine = [k for k in kernels if name in k[0]]
        line["kernels"].append(dict(
            name=name, counter=counter, entries=[k[0][:80] for k in mine],
            ms_per_tick=sum(k[1] for k in mine) / ticks, calls_per_tick=sum(k[2] for k in mine) / ticks,
            credited_per_tick=n / ticks, share_of_busy=(sum(k[1] for k in mine) / busy_ms if busy_ms else None),
        ))
    line["profiler_sees_graph_kernels"] = all(k["calls_per_tick"] > 0 for k in line["kernels"])
    short = {k["name"]: k["credited_per_tick"] - k["calls_per_tick"] for k in line["kernels"]}
    if prologue_seen == 0:
        short["prologue"] = PROFILE_PROLOGUE
    if prologue_seen == 0 or (any(v > 0 for v in short.values()) and all(v >= 0 for v in short.values())):
        emit(dict(line, phase=f"{phase}_dropped"))
        raise RecordsDropped(phase, short)
    emit(line)
    require(
        bool(line["kernels"] or planned) == ours,
        f"{phase}: kernels of ours {line['kernels']} and planned calls {planned} in the window, expected "
        f"{'some' if ours else 'none'}",
    )
    for k in line["kernels"]:
        require(
            k["calls_per_tick"] == k["credited_per_tick"],
            f"{phase}: the profiler saw {k['calls_per_tick']} {k['name']} a tick, the counters were "
            f"credited {k['credited_per_tick']}",
        )
    return line


def replayed_tick_checks(path, eng, cfg, seed, per_tick, planned_per_tick=None, prefill=False):
    """``tick_profile_<path>`` with our kernels' calls a tick held to
    ``per_tick`` ({trace name: calls}: every projection of a smollm tick on
    the path's VMM kernel; every sLSTM layer on the scan and the head on the
    fast kernel for xlstm; none for a planned chip, whose planned calls a
    tick are held to ``planned_per_tick`` and whose trace must hold no VMM
    kernel), then ``graph_vs_eager_<path>`` and, with ``prefill``,
    ``prefill_vs_eager_<path>``."""
    prof = tick_profile(f"tick_profile_{path}", eng, make_requests(cfg, seed + 3), ticks=3)
    seen = {k["name"]: k["calls_per_tick"] for k in prof["kernels"]}
    require(seen == per_tick, f"tick_profile_{path}: kernels a tick {seen}, expected {per_tick}")
    require(
        prof["planned_calls_per_tick"] == (planned_per_tick or {}),
        f"tick_profile_{path}: planned calls a tick {prof['planned_calls_per_tick']}, expected {planned_per_tick}",
    )
    if planned_per_tick:
        require(prof["vmm_kernel_calls_per_tick"] == 0, f"tick_profile_{path}: a VMM kernel ran on a planned chip")
    graph_vs_eager(path, eng, make_requests(cfg, seed + 6))
    if prefill:
        prefill_vs_eager(path, eng.runner, seed + 9)


def replay_vs_eager_ticks(eng, ticks):
    """``ticks`` ticks of the pool as it stands, each run twice in
    alternating order — by graph replay on the live cache, and eagerly
    (``decode_step`` under the runner's crossbar mode, inputs copied from the
    host as the eager runner did) on a clone of it — with the greedy tokens of
    the replay fed to both.  Returns the ticks whose logits differ, whether
    the two caches agree after the last, the largest logit difference and
    each tick's seconds on the host clock (to the end of its device-to-host
    copy of the logits), replayed and eager."""
    runner, dev = eng.runner, eng.runner.device
    last, pos = eng.last_tok.astype(np.int64), eng.pos.astype(np.int64)
    eager_cache = clone_cache(eng.cache)
    replay_s, eager_s, unequal, max_diff = [], [], [], 0.0

    def replay():
        return torch.from_numpy(runner.decode(last, pos, eng.cache)[0])

    def eager():
        toks = torch.from_numpy(last[:, None]).to(dev)
        pos_t = torch.from_numpy(pos).to(dev)
        logits, _ = runner._with_crossbar(
            lambda: model_lib.decode_step(runner.params, runner.cfg, toks, pos_t, eager_cache)
        )
        return logits.to(torch.float32).cpu()

    for t in range(ticks):
        out = {}
        for name in (("replay", "eager") if t % 2 == 0 else ("eager", "replay")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[name] = replay() if name == "replay" else eager()
            (replay_s if name == "replay" else eager_s).append(time.perf_counter() - t0)
        max_diff = max(max_diff, float((out["replay"] - out["eager"]).abs().max()))
        if not torch.equal(out["replay"], out["eager"]):
            unequal.append(t)
        last = out["replay"].argmax(dim=-1).numpy().astype(np.int64)
        pos = pos + 1
    caches_equal = all(torch.equal(a, b) for a, b in zip(cache_leaves(eng.cache), cache_leaves(eager_cache)))
    return unequal, caches_equal, max_diff, replay_s, eager_s


def graph_vs_eager(path, eng, prompts, ticks=12):
    """The replayed tick against the eager one on the same pool: a full pool
    after admission, then ``ticks`` ticks by ``replay_vs_eager_ticks``:
    logits bit-equal at every tick and the two caches after the last; then
    the device span of one replay alone."""
    runner = eng.runner
    for p in prompts[: eng.max_batch]:
        eng.submit(p, max_new_tokens=ticks + 8)
    eng.step()  # admits the pool full
    require(all(s is not None for s in eng.slots), f"graph_vs_eager_{path}: the pool is not full")
    unequal, caches_equal, max_diff, replay_s, eager_s = replay_vs_eager_ticks(eng, ticks)
    # the device span of one replay (kernels and the gaps between them),
    # CUDA events around the graph alone; it rewrites the pool, which is
    # not used after this check
    replay_device_ms = cuda_ms(runner.decode_graph.graph.replay, reps=10)
    line = dict(
        phase=f"graph_vs_eager_{path}", ticks=ticks, batch=eng.max_batch, logits_equal=not unequal,
        unequal_ticks=unequal, caches_equal=caches_equal, max_abs_logit_diff=max_diff,
        decode_tick_ms_median=1e3 * statistics.median(replay_s),
        eager_decode_tick_ms_median=1e3 * statistics.median(eager_s), replay_device_ms=replay_device_ms,
        decode_tick_ms=[1e3 * x for x in replay_s], eager_decode_tick_ms=[1e3 * x for x in eager_s],
    )
    emit(line)
    require(not unequal and caches_equal, f"graph_vs_eager_{path}: replay != eager (max |dlogit| {max_diff})")
    require(
        line["decode_tick_ms_median"] < line["eager_decode_tick_ms_median"],
        f"graph_vs_eager_{path}: the replayed tick is not faster than the eager one",
    )
    return line


def padded_prompt(runner, prompt):
    """``prompt`` zero-padded to the length of its prefill, (1, length) int64."""
    out = np.zeros((1, runner.prefill_len(len(prompt))), np.int64)
    out[0, : len(prompt)] = prompt
    return out


def eager_admission(runner, pool, slot, prompt):
    """An admission as the runner made it before its prefill was compiled:
    a fresh one-slot cache, the eager prefill of the zero-padded prompt,
    the copy into ``pool``'s ``slot``.  Returns (logits, one-slot cache)."""
    cache = runner.init_cache(1)
    tokens = torch.from_numpy(padded_prompt(runner, prompt)).to(runner.device)
    logits, _ = runner._with_crossbar(lambda: model_lib.prefill(runner.params, runner.cfg, tokens, cache))
    for big, one in zip(cache_leaves(pool), cache_leaves(cache)):
        big[:, slot] = one[:, 0]
    return logits, cache


def admission_vs_eager(runner, prompt, pools, eager_first=False):
    """Admit ``prompt`` through ``runner.admit_slot`` (its bucket's prefill
    graph) into slot 0 of ``pools[0]`` and eagerly (``eager_admission``)
    into slot 0 of ``pools[1]``, the eager one first if asked.  Returns whether the graph's
    logits, its one-slot cache and the filled slot are ``torch.equal`` to
    the eager ones, the graph, and each admission's seconds (host clock,
    device synchronised), through the graph and eager."""
    graph_pool, eager_pool = pools
    seconds, out = {}, {}
    for name in (("eager", "graph") if eager_first else ("graph", "eager")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "graph":
            runner.admit_slot(graph_pool, 0, Request(rid=0, prompt=prompt))
        else:
            out["eager"] = eager_admission(runner, eager_pool, 0, prompt)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
    graph = runner.prefill_graphs[runner.prefill_len(len(prompt))]
    logits, cache = out["eager"]
    equal = dict(
        logits=bool(torch.equal(graph.logits, logits)),
        cache=all(torch.equal(a, b) for a, b in zip(cache_leaves(graph.cache), cache_leaves(cache))),
        slot=all(torch.equal(a, b) for a, b in zip(cache_leaves(graph_pool), cache_leaves(eager_pool))),
    )
    return equal, graph, seconds["graph"], seconds["eager"]


def prefill_vs_eager(path, runner, seed, buckets=(32, 64, 128, 256)):
    """Every bucket's admission through the runner's prefill graph against
    the eager admission (``eager_admission``) on one-slot pools of their
    own, alternating which goes first: a full bucket's prompt (a capture
    where the bucket had no graph yet), then the bucket's shortest prompt,
    the full one and the shortest again — after a longer prompt in the
    bucket, the shorter one's cache must hold nothing of it.  Logits, the
    one-slot cache and the slot ``torch.equal`` every time; both admission
    medians over the three last pairs (host clock), a replay's device span
    (CUDA events), the capture's seconds and the graph's pool bytes."""
    require(runner.max_seq >= buckets[-1], f"prefill_vs_eager_{path}: max_seq {runner.max_seq}")
    rng = np.random.default_rng(seed)
    pools = [runner.init_cache(1), runner.init_cache(1)]
    lines, shortest = [], 1
    for b in buckets:
        full = rng.integers(1, runner.cfg.vocab_size, size=b)
        short = rng.integers(1, runner.cfg.vocab_size, size=shortest)
        held = len(runner.prefill_graphs)
        checks, replay_s, eager_s = [], [], []
        for i, prompt in enumerate((full, short, full, short)):
            equal, graph, r_s, e_s = admission_vs_eager(runner, prompt, pools, eager_first=i % 2 == 1)
            checks.append(dict(prompt_len=len(prompt), **equal))
            if i == 0:
                first_ms = 1e3 * r_s
            else:
                replay_s.append(r_s)
                eager_s.append(e_s)
        lines.append(dict(
            bucket=b, prompt_lens=[len(full), len(short)], captured_here=len(runner.prefill_graphs) > held,
            capture_seconds=graph.capture_seconds, pool_bytes=graph.pool_bytes, first_admission_ms=first_ms,
            admission_ms_median=1e3 * statistics.median(replay_s),
            eager_admission_ms_median=1e3 * statistics.median(eager_s),
            replay_device_ms=cuda_ms(graph.graph.replay, reps=5, warmup=1),
            admission_ms=[1e3 * x for x in replay_s], eager_admission_ms=[1e3 * x for x in eager_s],
            checks=checks, equal=all(c["logits"] and c["cache"] and c["slot"] for c in checks),
        ))
        shortest = b + 1
    line = dict(
        phase=f"prefill_vs_eager_{path}", arch=runner.cfg.name, max_seq=runner.max_seq,
        all_equal=all(x["equal"] for x in lines), buckets=lines,
    )
    emit(line)
    require(line["all_equal"], f"prefill_vs_eager_{path}: a replayed prefill differs from the eager one")
    return line


def recaptured_prefill(phase, runner, prompt):
    """After a chip swap: the runner holds no prefill graph; the next
    admission (``prompt``, into a pool of its own) captures its bucket's
    graph anew, and its logits, cache and slot are ``torch.equal`` to an
    eager admission on the new chip."""
    require(not runner.prefill_graphs, f"{phase}: the swap kept prefill graphs {sorted(runner.prefill_graphs)}")
    equal, graph, replay_s, eager_s = admission_vs_eager(runner, prompt, (runner.init_cache(1), runner.init_cache(1)))
    require(
        list(runner.prefill_graphs) == [graph.bucket] and graph.graph is not None and graph.replays == 1,
        f"{phase}: the admission after the swap did not capture bucket {graph.bucket} anew",
    )
    require(all(equal.values()), f"{phase}: the recaptured prefill differs from an eager one on the new chip {equal}")
    return dict(
        bucket=graph.bucket, capture_seconds=graph.capture_seconds, admission_ms=1e3 * replay_s,
        eager_admission_ms=1e3 * eager_s, **{f"{k}_equal_eager": v for k, v in equal.items()},
    )


def chip_logits(cfg, params, eng, dev):
    """The chip's logits on one short prompt (the same prompt every call)."""
    tok = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab_size, size=(1, 16))).to(dev)
    with crossbar_mode(eng.crossbar), eng.programmed.bind():
        xbar = model_lib.forward(params, cfg, tok).float()
    require(
        xbar.shape == (1, 16, cfg.vocab_size) and bool(torch.isfinite(xbar).all()),
        f"full-width logits have shape {tuple(xbar.shape)} or are not finite",
    )
    return tok, xbar


def reference_check(cfg, params, eng, dev):
    """Crossbar logits against the plain-matmul forward of the same params
    on one short prompt: the chip computes x @ w to W16A16 accuracy.
    Returns the rel-L2 and the chip's logits (on the host)."""
    tok, xbar = chip_logits(cfg, params, eng, dev)
    digital = model_lib.forward(params, cfg, tok).float()
    return float((xbar - digital).norm() / digital.norm()), xbar.cpu()


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def cpu_vs_card_projections(dev):
    """Reduced smollm, float32: one chip programmed on the CPU is carried over
    to the card through the artifact store, and every projection is held
    bit-equal on the same float input — the plain versions on the CPU against
    the kernels on the card — for an ideal chip (fast kernel), a ``fast=False``
    one under the adaptive ADC (paper kernel), a noisy one, and a planned one
    (Karatsuba level 2, float64 matmuls on both sides)."""
    from repro_torch.device.programmed import programmed_linear

    cfg = reduced(get_config("smollm-360m"))
    p_cpu = model_lib.init_model(cfg, seed=3, device="cpu")
    p_dev = _to(p_cpu, dev)
    rng = np.random.default_rng(5)
    out = {}
    chips = (
        ("ideal", True, None, None), ("paper", False, None, None), ("noisy", True, NOISY_DEVICE, None),
        ("planned", True, None, plan_model(p_cpu, tie_lm_head=True)),
    )
    for name, fast, dcfg, plan in chips:
        mode = CrossbarMode(enabled=True, strict=True, fast=fast, device=dcfg)
        eng_cpu = ServingEngine(cfg, p_cpu, max_batch=2, max_seq=32, crossbar=mode, plan=plan, device="cpu")
        with tempfile.TemporaryDirectory() as d:
            eng_cpu.save_artifacts(d)
            eng_dev = ServingEngine(
                cfg, p_dev, max_batch=2, max_seq=32, crossbar=mode, restore_artifacts=d, device=dev
            )
        n_proj = 0
        for key, art_c in eng_cpu.programmed.by_name.items():
            art_d = eng_dev.programmed.by_name[key]
            layers = range(art_c.shape[0]) if art_c.stacked else [None]
            for i in layers:
                ac, ad = (art_c, art_d) if i is None else (art_c.layer(i), art_d.layer(i))
                x = torch.from_numpy(rng.normal(size=(3, ac.shape[0])).astype(np.float32))
                y_c = programmed_linear(x, ac)
                y_d = programmed_linear(x.to(dev), ad).cpu()
                require(torch.equal(y_c, y_d), f"{name} chip, {key}[{i}]: card != CPU")
                n_proj += 1
        out[name] = dict(projections_bit_equal=n_proj)
    return out


# ---------------------------------------------------------------------------
# repair and the chip lifecycle
# ---------------------------------------------------------------------------

def repair_summary(reports):
    """Totals over ``repair_reports()``: artifacts (slabs) repaired, logical
    columns with a repaired unit, unit slots used of the budget, and the
    planner-model salience before and after."""
    flat = [r for v in reports.values() for r in (v if isinstance(v, tuple) else (v,)) if r is not None]
    return dict(
        slabs=len(flat), slabs_repaired=sum(r.n_repaired > 0 for r in flat),
        columns_repaired=sum(len(r.repaired_cols) for r in flat),
        units_repaired=sum(r.n_repaired for r in flat), unit_budget=sum(r.budget for r in flat),
        salience_before=sum(r.salience_before for r in flat), salience_after=sum(r.salience_after for r in flat),
    )


class timed_repair_planning:
    """Within the block, every ``repair.plan_repair`` call is timed (device
    synchronised on both sides): ``seconds`` and ``calls`` afterwards."""

    def __enter__(self):
        self.seconds, self.calls, self._real = 0.0, 0, trepair.plan_repair

        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self._real(*args, **kw)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            return out

        trepair.plan_repair = timed
        return self

    def __exit__(self, *exc):
        trepair.plan_repair = self._real


def serve_planned_repaired(cfg, params, dev, seed, quick):
    """The planned ("Newton") chip on a device with stuck cells: the plan
    provisions spare columns for NOISY_DEVICE's stuck-cell rate, the repair
    planner programs them, and the chip serves every projection on the noisy
    kernel (a noisy chip keeps the device kernel under a plan; the plan picks
    its ADC schedule).  Returns the serving run's launch counts."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    plan = plan_model(params, device=NOISY_DEVICE, tie_lm_head=True)
    plan_s = time.perf_counter() - t0
    spares = sorted({p.spare_cols for p in plan.layers.values()})
    require(spares[-1] > 0, f"serve_planned_repaired: the plan provisions no spare columns ({spares})")
    noisy = CrossbarMode(enabled=True, strict=True, device=NOISY_DEVICE)
    with timed_repair_planning() as rp:
        line, launches, eng = serve_phase(
            "serve_planned_repaired", cfg, params, noisy, "noisy", dev, seed + 1, False, plan=plan,
        )
    n_slabs = sum(a.shape[0] if a.stacked else 1 for a in eng.programmed.by_name.values())
    require(rp.calls == n_slabs, f"serve_planned_repaired: {rp.calls} repair plans for {n_slabs} slabs")
    require(
        all(a.g_spare is not None and a.out_gather is not None for a in eng.programmed.by_name.values()),
        "serve_planned_repaired: an artifact has no spare block",
    )
    want = 6 * cfg.n_layers + 1  # 4 attention projections, the fused wi and wo a layer, the tied head
    if not quick:  # 6 prefills + 32 decode ticks
        require(
            line["projections"] == want and line["prefills"] + line["decode_ticks"] == 38
            and launches["noisy"] == want * 38,
            f"serve_planned_repaired: {launches['noisy']} noisy-kernel launches of {line['projections']} "
            f"projections in {line['prefills']} + {line['decode_ticks']} forwards, expected {want} x 38",
        )
    line.update(
        plan_seconds=plan_s, plan_spare_cols=spares, repair_planning_seconds=rp.seconds,
        repair_plans=rp.calls, repair=repair_summary(eng.repair_reports()),
        g_spare_gb=sum(a.g_spare.numel() * 4 for a in eng.programmed.by_name.values()) / 1e9,
    )
    line["logits_rel_l2_vs_plain_matmul"] = reference_check(cfg, params, eng, dev)[0]
    emit(line)
    replayed_tick_checks("planned_repaired", eng, cfg, seed, {"noisy_mma_kernel": line["projections"]})
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def program_logits(cfg, params, prog, tok):
    """Logits of one prompt through a programmed chip."""
    with crossbar_mode(CrossbarMode(enabled=True, strict=True, programmed=prog)), prog.bind():
        return model_lib.forward(params, cfg, tok).float()


def repaired_layer_card_vs_cpu(dcfg, dev, seed, K=960, N=5120):
    """One repaired K x N slab programmed on the CPU and on the card from the
    same random fields (drawn on the CPU, copied to the card): the repair
    plan (victims, routing tables), the spare block and the repaired cells
    ``torch.equal`` — the greedy's argmax ties and its batched steps pinned
    on the card."""
    spec = layer_scaled_spec(DEFAULT_SPEC, K)
    S, B = spec.n_slices, trepair.spare_budget(N, spec, dcfg)
    gen = torch.Generator().manual_seed(seed)
    wb = torch.randint(0, 1 << spec.weight_bits, (K, N), generator=gen)
    fields = dict(
        u=torch.rand((S, K, N), generator=gen),
        z_pulses=[torch.randn((S, K, N), generator=gen) for _ in range(max(1, dcfg.write_verify_iters))],
        u_spare=torch.rand((S, K, B), generator=gen),
        z_spare_pulses=[torch.randn((S, K, B), generator=gen) for _ in range(max(1, dcfg.write_verify_iters))],
    )
    t0 = time.perf_counter()
    g_c, p_c, _ = trepair.repaired_effective_cells(wb, spec, dcfg, **fields)
    cpu_s = time.perf_counter() - t0
    on_card = {k: ([t.to(dev) for t in v] if isinstance(v, list) else v.to(dev)) for k, v in fields.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g_d, p_d, _ = trepair.repaired_effective_cells(wb.to(dev), spec, dcfg, **on_card)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    equal = {
        "victim": torch.equal(p_c.victim, p_d.victim.cpu()),
        "out_gather": torch.equal(p_c.out_gather, p_d.out_gather.cpu()),
        "g_spare": torch.equal(p_c.g_spare, p_d.g_spare.cpu()),
        "g_eff": torch.equal(g_c, g_d.cpu()),
    }
    out = dict(
        K=K, N=N, spare_cols=dcfg.spare_cols, budget=B, units_repaired=int((p_c.victim >= 0).sum()),
        equal=equal, cells_differing=int((g_c != g_d.cpu()).sum()), cpu_seconds=cpu_s, card_seconds=card_s,
    )
    require(all(equal.values()), f"repair_recovery: the repaired layer differs between card and CPU: {out}")
    return out


def repair_recovery(cfg, params, dev, seed):
    """A 2-layer full-width copy of smollm on RECOVERY_DEVICE, three chips
    under one plan (the same ADC schedule): no stuck cells, stuck cells
    without spares, stuck cells with the plan's spares.  Each one's logits
    against the plain-matmul model on one prompt; ``recovered_frac`` =
    (MSE_norepair - MSE_repair) / (MSE_norepair - MSE_stuck_free) must be
    positive.  Then one repaired 960 x 5120 slab on the card and on the CPU.
    Returns the launch counts of the three chips' forwards."""
    torch.cuda.reset_peak_memory_stats()
    cut_cfg, cparams = cut_params(cfg, params, 2) if cfg.n_layers > 2 else (cfg, params)
    plan = plan_model(cparams, device=RECOVERY_DEVICE, tie_lm_head=True)
    no_spares = dataclasses.replace(
        plan, layers={n: dataclasses.replace(p, spare_cols=0) for n, p in plan.layers.items()}
    )
    stuck_free = RECOVERY_DEVICE.replace(p_stuck_on=0.0, p_stuck_off=0.0)
    tok = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(1, 16))).to(dev)
    digital = model_lib.forward(cparams, cut_cfg, tok).float()
    mse, seconds = {}, {}
    kvmm.reset_counters()
    for name, dcfg, chip_plan in (
        ("stuck_free", stuck_free, no_spares), ("no_repair", RECOVERY_DEVICE, no_spares),
        ("repair", RECOVERY_DEVICE, plan),
    ):
        t0 = time.perf_counter()
        prog = tprog.program_model(cparams, device_cfg=dcfg, tie_lm_head=True, plan=chip_plan, device=dev)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        logits = program_logits(cut_cfg, cparams, prog, tok)
        require(bool(torch.isfinite(logits).all()), f"repair_recovery: {name} logits are not finite")
        mse[name] = float(torch.mean((logits - digital) ** 2))
        if name == "repair":
            summary = repair_summary(prog.repair_reports())
        del prog, logits
        torch.cuda.empty_cache()
    launches = dict(kvmm.LAUNCHES, **kscan.LAUNCHES, **tprog.PLANNED_CALLS)
    frac = (mse["no_repair"] - mse["repair"]) / (mse["no_repair"] - mse["stuck_free"])
    wi_spares = plan.layers["stage0/b0/ffn/wi"].spare_cols
    line = dict(
        phase="repair_recovery", arch=cfg.name, n_layers=cut_cfg.n_layers, d_model=cfg.d_model,
        device=dataclasses.asdict(RECOVERY_DEVICE), plan_spare_cols=sorted({p.spare_cols for p in plan.layers.values()}),
        logits_mse_vs_plain_matmul=mse, recovered_frac=frac, program_seconds=seconds, repair=summary,
        launches=launches, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        card_vs_cpu_layer=repaired_layer_card_vs_cpu(RECOVERY_DEVICE.replace(spare_cols=wi_spares), dev, seed),
    )
    emit(line)
    require(frac > 0.0, f"repair_recovery: repair recovered nothing ({mse})")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def drain(eng):
    """Step until every submitted request is done; returns their tokens."""
    while eng.pending or any(s is not None for s in eng.slots):
        eng.step()
    return [r.generated for r in eng.run_until_done(max_ticks=0)]


def lifecycle(cfg, params, dev, seed):
    """smollm-360m at full width (the caller cuts its depth) on
    LIFECYCLE_DEVICE (drifting, stuck cells, 4 spares a group), a pool of
    the serve phases' 6 requests two ticks into its run, then: age the chip LIFECYCLE_AGE_S seconds,
    compensate it, refresh it in memory — after each, the captured tick must
    be gone, and 3 ticks replayed by the newly captured graph bit-equal to
    eager ``decode_step`` on a clone (the pool is put back afterwards); the
    health monitor's worst layer rises with age and falls with compensation,
    which recovers at least half of the probe MSE aging added; the refreshed
    chip is the fresh program, and the run, finished after the refresh,
    serves the tokens of an uninterrupted run on a fresh chip.  Last, on a
    2-layer full-width copy, ``refresh(directory)`` twice: slots A then B,
    each serving a fresh engine's tokens.  Returns the phase's launch
    counts."""
    torch.cuda.reset_peak_memory_stats()
    mode = CrossbarMode(enabled=True, strict=True, device=LIFECYCLE_DEVICE)
    prompts = make_requests(cfg, seed)
    kvmm.reset_counters()
    kscan.reset_counters()
    t0 = time.perf_counter()
    ref = ServingEngine(cfg, params, max_batch=4, max_seq=256, crossbar=mode, device=dev)
    torch.cuda.synchronize()
    program_s = time.perf_counter() - t0
    ref_tokens = [r.generated for r in drive(ref, prompts, max_new=16)[0]]
    fresh_chip = ref.programmed
    del ref
    eng = ServingEngine(cfg, params, max_batch=4, max_seq=256, crossbar=mode, device=dev)
    for p in prompts:
        eng.submit(p, max_new_tokens=16)
    eng.step()
    eng.step()
    graphs = [eng.runner.decode_graph]
    require(graphs[0] is not None and graphs[0].graph is not None, "lifecycle: the first ticks were not captured")
    steps = {}

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    health = {"fresh": timed(eng.health_check)}

    def rebind(name, action):
        seconds = timed(action)[1]
        require(eng.runner.decode_graph is None, f"lifecycle: {name} kept the captured tick")
        prefill = recaptured_prefill(f"lifecycle {name}", eng.runner, prompts[0])
        saved = clone_cache(eng.cache)
        unequal, caches_equal, max_diff, replay_s, eager_s = replay_vs_eager_ticks(eng, 3)
        for a, b in zip(cache_leaves(eng.cache), cache_leaves(saved)):
            a.copy_(b)  # the pool as it was: the run goes on from here
        graph = eng.runner.decode_graph
        require(
            graph is not None and graph.graph is not None and all(graph is not g for g in graphs),
            f"lifecycle: no new capture after {name}",
        )
        graphs.append(graph)
        steps[name] = dict(
            seconds=seconds, capture_seconds=graph.capture_seconds, prefill=prefill, logits_equal=not unequal,
            caches_equal=caches_equal, max_abs_logit_diff=max_diff,
            decode_tick_ms=[1e3 * x for x in replay_s], eager_decode_tick_ms=[1e3 * x for x in eager_s],
        )
        require(not unequal and caches_equal, f"lifecycle: after {name}, replay != eager (max {max_diff})")

    rebind("age", lambda: eng.age(LIFECYCLE_AGE_S))
    health["aged"] = timed(eng.health_check)
    rebind("compensate", eng.compensate)
    health["compensated"] = timed(eng.health_check)
    worst = {k: h.worst for k, (h, _) in health.items()}
    mse = {k: sum(x.mse for x in h.layers) / len(h.layers) for k, (h, _) in health.items()}
    recovered = (mse["aged"] - mse["compensated"]) / (mse["aged"] - mse["fresh"])
    rebind("refresh", eng.refresh)
    refreshed_equal = sorted(eng.programmed.by_name) == sorted(fresh_chip.by_name) and all(
        tprog.artifacts_equal(a, fresh_chip.by_name[n]) for n, a in eng.programmed.by_name.items()
    )
    del fresh_chip
    tokens = drain(eng)
    require(len(tokens) == len(prompts) and all(len(t) == 16 for t in tokens), "lifecycle: the run did not finish")
    uptime_after_refresh = eng.uptime_s
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # the store's two slots, on a 2-layer full-width copy
    cut_cfg, cparams = cut_params(cfg, params, 2) if cfg.n_layers > 2 else (cfg, params)
    small = ServingEngine(cut_cfg, cparams, max_batch=4, max_seq=256, crossbar=mode, device=dev)
    for p in prompts:
        small.submit(p, max_new_tokens=16)
    want = drain(small)
    slots = []
    with tempfile.TemporaryDirectory() as d:
        for _ in range(2):
            slot, seconds = timed(lambda: small.refresh(d))
            require(not small.runner.prefill_graphs, "lifecycle: refresh(directory) kept prefill graphs")
            for p in prompts:
                small.submit(p, max_new_tokens=16)
            got = drain(small)[-len(prompts):]
            slots.append(dict(slot=slot, active=active_slot(d), seconds=seconds, tokens_equal_fresh=got == want))
        store_ok = verify_store(d).ok
    del small
    launches = dict(kvmm.LAUNCHES, **kscan.LAUNCHES, **tprog.PLANNED_CALLS)
    line = dict(
        phase="lifecycle", arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        device=dataclasses.asdict(LIFECYCLE_DEVICE), age_s=LIFECYCLE_AGE_S, program_seconds=program_s,
        captures=len(graphs), steps=steps,
        health={k: dict(worst=worst[k], mean_probe_mse=mse[k], flagged=len(h.flagged), layers=len(h.layers),
                        seconds=s) for k, (h, s) in health.items()},
        compensation_recovered_frac=recovered, refreshed_equals_fresh_program=refreshed_equal,
        uptime_after_refresh=uptime_after_refresh, tokens_equal_uninterrupted=tokens == ref_tokens,
        store_refreshes=slots, store_verified=store_ok, store_layers=cut_cfg.n_layers,
        launches=launches, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
    )
    emit(line)
    require(worst["aged"] > worst["fresh"], f"lifecycle: aging did not raise the worst layer's error {worst}")
    require(worst["compensated"] < worst["aged"], f"lifecycle: compensation did not help {worst}")
    require(recovered >= 0.5, f"lifecycle: compensation recovered {recovered} of the aged probe MSE")
    require(refreshed_equal, "lifecycle: the refreshed chip is not the fresh program")
    require(line["tokens_equal_uninterrupted"], "lifecycle: the refreshed run's tokens differ from a fresh run's")
    require(len(graphs) == 4, f"lifecycle: {len(graphs)} captures, expected 4")
    require(
        [(x["slot"], x["active"]) for x in slots] == [("A", "A"), ("B", "B")]
        and all(x["tokens_equal_fresh"] for x in slots) and store_ok,
        f"lifecycle: store refreshes {slots}",
    )
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# traffic phases: the continuous-batching scheduler, the block pool, the farm
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PromptClass:
    """One request shape in a traffic mix (a copy of the one in
    ``benchmarks/serving_traffic.py``, which imports the JAX package)."""

    name: str
    prompt_len: int
    max_new_tokens: int
    weight: float  # relative admission probability within the mix


@dataclasses.dataclass(frozen=True)
class TrafficMix:
    """A seeded Poisson arrival process over prompt classes (a copy of the
    one in ``benchmarks/serving_traffic.py``).  ``rate`` is the mean number
    of arrivals per decode tick; class choice and prompt tokens draw from the
    mix's own seeded generator, so one value is one request schedule."""

    name: str
    classes: tuple
    rate: float
    n_requests: int
    seed: int = 0

    def sample_arrivals(self, vocab: int):
        """(arrival_tick, class, prompt) for each request, tick-ordered."""
        rng = np.random.default_rng(self.seed)
        w = np.asarray([c.weight for c in self.classes], np.float64)
        w = w / w.sum()
        out = []
        tick = 0
        while len(out) < self.n_requests:
            for _ in range(int(rng.poisson(self.rate))):
                if len(out) >= self.n_requests:
                    break
                cls = self.classes[int(rng.choice(len(self.classes), p=w))]
                prompt = rng.integers(1, vocab, size=cls.prompt_len).astype(np.int32)
                out.append((tick, cls, prompt))
            tick += 1
        return out


# the reference's short/long mix at smollm-360m's scale: mostly short
# interactive prompts (one 32-token prefill bucket) with a long-prompt tail
# (the 256 bucket), one arrival every other tick on average; the seed is
# the run's --seed
SHORT_LONG_FULL = TrafficMix(
    name="short_long_full",
    classes=(
        PromptClass("short", prompt_len=24, max_new_tokens=8, weight=0.7),
        PromptClass("long", prompt_len=192, max_new_tokens=32, weight=0.3),
    ),
    rate=0.5,
    n_requests=32,
)


def slot_state(cache, cfg, slot, pos):
    """Views of one slot's live cache: each sequence leaf's positions < pos,
    each state leaf whole (``model.cache_axes`` says which is which)."""
    axes = dict(named_leaves(model_lib.cache_axes(cfg)))
    return [t[:, slot, :pos] if "cache_seq" in axes[n] else t[:, slot] for n, t in named_leaves(cache)]


def ms_stats(seconds):
    """Count, p50 and p99 milliseconds of a list of host seconds."""
    if not seconds:
        return dict(n=0, p50_ms=None, p99_ms=None)
    ms = 1e3 * np.asarray(seconds)
    return dict(n=len(ms), p50_ms=float(np.percentile(ms, 50)), p99_ms=float(np.percentile(ms, 99)))


def traffic_run(runner, arrivals, block=None, deadlines=None, window=None):
    """Serve ``arrivals`` through a new ``ContinuousBatchingScheduler`` on
    ``runner``.  ``deadlines=None``: every request submitted up front with no
    deadline (the run held to the slot loop); else each at its arrival tick
    with its class's deadline.  The scheduler keeps no clock and no counts, so
    they are taken from outside: each step's host seconds, by whether it ran
    an admission that captured its bucket's prefill graph, an admission (a
    prefill), a page-out or page-in, or only the decode tick; each
    admission's seconds by bucket, replaying and capturing apart; each
    page-out's and page-in's seconds and host bytes; the decode graphs the
    run used (and the seconds of the step that captured it: each run's pool
    is new, so its first decode step captures) and the prefill replays it
    made.  At the first page-out the
    slot's prefix is cloned, and held ``torch.equal`` to the slot its page-in
    fills.  ``window`` = (phase, first tick, ticks): those ticks run in one
    ``profile_window`` (its line is the result's ``profile``).  The launch
    counters and the crossbar misses count this run only."""
    sched = ContinuousBatchingScheduler(runner, max_batch=TRAFFIC_BATCH, block=block)
    kv = sched.kv
    paging = dict(out_s=[], in_s=[], bytes=[])
    first = {}
    real_out, real_in = kv.page_out, kv.page_in

    def page_out(rid, slot, pos, last_tok):
        prefix = slot_state(kv.cache, runner.cfg, slot, pos)
        if not first:
            first.update(rid=rid, prefix=[t.clone() for t in prefix])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_out(rid, slot, pos, last_tok)
        paging["out_s"].append(time.perf_counter() - t0)
        paging["bytes"].append(sum(t.numel() * t.element_size() for t in prefix))

    def page_in(rid, slot):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pos, last_tok = real_in(rid, slot)
        torch.cuda.synchronize()
        paging["in_s"].append(time.perf_counter() - t0)
        if first.get("rid") == rid and "equal" not in first:
            back = slot_state(kv.cache, runner.cfg, slot, pos)
            first["equal"] = all(torch.equal(a, b) for a, b in zip(first["prefix"], back))
        return pos, last_tok

    kv.page_out, kv.page_in = page_out, page_in
    queue = list(arrivals)
    steps = dict(admission_with_capture=[], admission=[], paging=[], decode_only=[])
    replays = lambda: sum(g.replays for g in runner.prefill_graphs.values())  # noqa: E731
    graphs, counts = [], dict(decode_ticks=0, idle_ticks=0, decoded_tokens=0)
    decode_capture_s = []  # the step that captured the run's decode tick (in its kind too)

    def one_step():
        while queue and (deadlines is None or queue[0][0] <= sched.tick):
            _, cls, prompt = queue.pop(0)
            sched.submit(
                prompt, max_new_tokens=cls.max_new_tokens,
                deadline=None if deadlines is None else deadlines[cls.name],
            )
        admitted, captured, paged = adm.count, adm.captures, len(paging["out_s"]) + len(paging["in_s"])
        t0 = time.perf_counter()
        n = sched.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if not n:
            counts["idle_ticks"] += 1
            return
        counts["decode_ticks"] += 1
        counts["decoded_tokens"] += n
        if not graphs or runner.decode_graph is not graphs[-1]:
            graphs.append(runner.decode_graph)
            decode_capture_s.append(dt)
        if adm.captures > captured:
            steps["admission_with_capture"].append(dt)
        elif adm.count > admitted:
            steps["admission"].append(dt)
        elif len(paging["out_s"]) + len(paging["in_s"]) > paged:
            steps["paging"].append(dt)
        else:
            steps["decode_only"].append(dt)

    def window_steps():
        admitted, paged = adm.count, len(paging["out_s"]) + len(paging["in_s"])
        for _ in range(window[2]):
            one_step()
        return dict(prefills=adm.count - admitted, page_moves=len(paging["out_s"]) + len(paging["in_s"]) - paged)

    profiled = None
    reset_crossbar_misses()
    kvmm.reset_counters()
    kscan.reset_counters()
    tprog.reset_planned_calls()
    replays_before = replays()
    with timed_admissions(runner) as adm:
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        while queue or sched.load:
            if window is not None and profiled is None and sched.tick == window[1]:
                profiled = profile_window(window[0], window_steps, window[2])
            else:
                one_step()
        seconds = time.perf_counter() - t_start
    reqs = sorted({**sched.completed, **sched.expired}.values(), key=lambda r: r.rid)
    n_tok = sum(len(r.generated) for r in reqs)
    latency = [r.finish - r.arrival for r in reqs if not r.expired]
    return dict(
        block_size=kv.block_size, pool_blocks=kv.n_blocks, requests=len(reqs), completed=len(sched.completed), expired=len(sched.expired),
        ticks=sched.tick, **counts, prefills=adm.count,
        preemptions=len(paging["out_s"]), resumes=len(paging["in_s"]),
        first_page_in_equal=first.get("equal"), new_tokens=n_tok, seconds=seconds,
        tokens_per_s=n_tok / seconds, tokens_per_tick=n_tok / max(1, sched.tick),
        latency_ticks_p50=float(np.percentile(latency, 50)) if latency else None,
        latency_ticks_p99=float(np.percentile(latency, 99)) if latency else None,
        step_ms={k: ms_stats(v) for k, v in steps.items()},
        admission_ms={str(b): ms_stats(v) for b, v in sorted(adm.seconds.items())},
        capturing_admission_ms={str(b): [1e3 * x for x in v] for b, v in sorted(adm.capturing.items())},
        decode_capture_step_ms=[1e3 * x for x in decode_capture_s],
        prefill_graphs=sorted(runner.prefill_graphs), prefill_replays=replays() - replays_before,
        page_out_ms=[1e3 * x for x in paging["out_s"]], page_in_ms=[1e3 * x for x in paging["in_s"]],
        page_out_bytes=paging["bytes"], captures=len(graphs),
        graph_replays=graphs[-1].replays if graphs else 0,
        launches=dict(kvmm.LAUNCHES, **kscan.LAUNCHES, **tprog.PLANNED_CALLS),
        plain_calls=dict(kvmm.PLAIN_CALLS, **kscan.PLAIN_CALLS), misses=len(crossbar_misses()),
        schedule=[(r.rid, r.arrival, r.finish, r.expired, len(r.generated)) for r in reqs],
        tokens=[r.generated for r in reqs], profile=profiled,
    )


def require_kernels(phase, run, per_forward, forwards=None):
    """The run's launches (``run``: a dict with ``launches``, ``plain_calls``,
    ``misses``): ``per_forward`` ({counter: launches a forward}) on every
    forward (``forwards``, default the run's prefills + decode ticks), no
    other kernel, no plain version, no crossbar miss."""
    forwards = run["prefills"] + run["decode_ticks"] if forwards is None else forwards
    launches = run["launches"]
    want = {k: per_forward.get(k, 0) * forwards for k in launches}
    require(launches == want, f"{phase}: launches {launches}, expected {want} ({forwards} forwards)")
    require(sum(run["plain_calls"].values()) == 0, f"{phase}: plain versions ran: {run['plain_calls']}")
    require(not run["misses"], f"{phase}: {run['misses']} crossbar misses")


def public(run):
    """A run's numbers for its JSON line (without the token lists)."""
    return {k: v for k, v in run.items() if k not in ("tokens", "schedule", "profile")}


def farm_run(farm, arrivals):
    """Submit every request to ``farm`` up front and step it until every
    replica is idle (placement is decided at submission).  Returns the rids,
    the farm ticks, the seconds, the tokens by rid, and each replica's
    admissions, decode graphs and replays (and their totals, the run's
    forwards), prefill graphs, prefill captures and prefill replays; the
    launch counters and crossbar misses count this run only."""
    reset_crossbar_misses()
    kvmm.reset_counters()
    kscan.reset_counters()
    rids = [farm.submit(p, max_new_tokens=c.max_new_tokens) for _, c, p in arrivals]
    graphs = [[] for _ in farm.replicas]
    adms = [timed_admissions(e.runner) for e in farm.replicas]
    ticks = 0
    with contextlib.ExitStack() as stack:
        for a in adms:
            stack.enter_context(a)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while not all(farm.is_idle(i) for i in range(farm.n_replicas)):
            farm.step()
            ticks += 1
            for seen, eng in zip(graphs, farm.replicas):
                g = eng.runner.decode_graph
                if g is not None and (not seen or seen[-1] is not g):
                    seen.append(g)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    reqs = farm.run_until_done(max_ticks=0)
    n_tok = sum(len(r.generated) for r in reqs)
    replays = [g[-1].replays if g else 0 for g in graphs]
    return dict(
        replicas=farm.n_replicas, policy=farm.policy, rids=rids,
        placements=[farm.replica_of(r) for r in rids], ticks=ticks, seconds=seconds,
        new_tokens=n_tok, wall_tokens_per_s=n_tok / seconds, tokens={r.rid: r.generated for r in reqs},
        prefills_by_replica=[a.count for a in adms], captures=[len(g) for g in graphs],
        replays_by_replica=replays, prefills=sum(a.count for a in adms), decode_ticks=sum(replays),
        prefill_graphs_by_replica=[sorted(e.runner.prefill_graphs) for e in farm.replicas],
        prefill_captures_by_replica=[a.captures for a in adms],
        prefill_replays_by_replica=[sum(g.replays for g in e.runner.prefill_graphs.values()) for e in farm.replicas],
        launches=dict(kvmm.LAUNCHES, **kscan.LAUNCHES), plain_calls=dict(kvmm.PLAIN_CALLS, **kscan.PLAIN_CALLS),
        misses=len(crossbar_misses()),
    )


def schedule_on_cpu(cfg, seed, arrivals):
    """The traffic run's schedule from the port's scheduler on the CPU: the
    same mix and pool on a 2-layer full-width copy of the config, served
    digitally in float32 (no eos_id is set, so who is admitted, preempted,
    expired and finished at which tick depends on the lengths alone)."""
    cut = depth_config(cfg, 2)
    params = model_lib.init_model(cut, seed=seed, device="cpu", dtype=torch.float32)
    runner = ModelRunner(cut, params, max_seq=TRAFFIC_SEQ, device="cpu")
    return traffic_run(runner, arrivals, TRAFFIC_POOL, TRAFFIC_DEADLINE), cut, params


def traffic_phases(cfg, params, dev, seed):
    """``serve_traffic_exact``, ``serve_traffic`` and ``farm`` on smollm-360m
    (``cfg``) from one ideal chip (programmed once; the farms'
    replicas restore its store).  Returns {phase: launches}."""
    torch.cuda.reset_peak_memory_stats()
    ideal = CrossbarMode(enabled=True, strict=True)
    arrivals = dataclasses.replace(SHORT_LONG_FULL, seed=seed).sample_arrivals(cfg.vocab_size)
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, params, max_batch=TRAFFIC_BATCH, max_seq=TRAFFIC_SEQ, crossbar=ideal, device=dev)
    program_s = time.perf_counter() - t0
    n_proj = sum(a.shape[0] if a.stacked else 1 for a in eng.programmed.by_name.values())
    by_phase = {}

    # serve_traffic_exact: the scheduler, then the slot loop on the same
    # runner, every request submitted up front: identical batches (the
    # scheduler first: its first admission of each bucket captures the
    # bucket's prefill graph)
    t_phase = time.perf_counter()
    exact = traffic_run(eng.runner, arrivals)
    for _, cls, prompt in arrivals:
        eng.submit(prompt, max_new_tokens=cls.max_new_tokens)
    kvmm.reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slot_tokens = drain(eng)
    slot_s = time.perf_counter() - t0
    slot_launches = dict(kvmm.LAUNCHES)
    line = dict(
        phase="serve_traffic_exact", arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        mix=SHORT_LONG_FULL.name, seed=seed, max_batch=TRAFFIC_BATCH, max_seq=TRAFFIC_SEQ,
        program_seconds=program_s,
        slot_loop=dict(seconds=slot_s, tokens_per_s=sum(map(len, slot_tokens)) / slot_s, launches=slot_launches),
        tokens_equal_slot_loop=exact["tokens"] == slot_tokens, **public(exact),
        phase_seconds=time.perf_counter() - t_phase,
    )
    emit(line)
    require(line["tokens_equal_slot_loop"], "serve_traffic_exact: the scheduler's tokens differ from the slot loop's")
    require(exact["completed"] == len(arrivals), f"serve_traffic_exact: {exact['completed']} requests finished")
    require(
        exact["captures"] == 1 and exact["graph_replays"] == exact["decode_ticks"],
        f"serve_traffic_exact: {exact['captures']} captures, {exact['graph_replays']} replays for "
        f"{exact['decode_ticks']} decode ticks",
    )
    require(
        exact["prefill_replays"] == exact["prefills"] and exact["prefill_graphs"] == [32, 256]
        and {b: len(v) for b, v in exact["capturing_admission_ms"].items()} == {"32": 1, "256": 1}
        and exact["step_ms"]["admission_with_capture"]["n"] >= 1,
        f"serve_traffic_exact: {exact['prefill_replays']} prefill replays for {exact['prefills']} admissions, "
        f"graphs {exact['prefill_graphs']}, capturing admissions {exact['capturing_admission_ms']}",
    )
    require_kernels("serve_traffic_exact", exact, {"fast": n_proj})
    by_phase["serve_traffic_exact"] = {k: v + slot_launches.get(k, 0) for k, v in exact["launches"].items()}

    # serve_traffic: the Poisson mix with deadlines under a pool that
    # preempts, twice on the card, and its schedule from the CPU
    t_phase = time.perf_counter()
    runs = [traffic_run(eng.runner, arrivals, TRAFFIC_POOL, TRAFFIC_DEADLINE) for _ in range(2)]
    # a third run with ticks [TRAFFIC_WINDOW[1], + TRAFFIC_WINDOW[2]) in one
    # profiled window (tick_profile_traffic); its step times are not kept.
    # Run anew where the profiler dropped records of the window
    dropped = []
    while len(runs) < 3:
        try:
            runs.append(traffic_run(eng.runner, arrivals, TRAFFIC_POOL, TRAFFIC_DEADLINE, window=TRAFFIC_WINDOW))
        except RecordsDropped as e:
            dropped.append(e.short)
            require(
                len(dropped) < TRAFFIC_PROFILE_RUNS,
                f"tick_profile_traffic: the profiler dropped records in {len(dropped)} runs: {dropped}",
            )
    cpu, cpu_cfg, cpu_params = schedule_on_cpu(cfg, seed, arrivals)
    run, prof = runs[0], runs[2]
    line = dict(
        phase="serve_traffic", arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        mix=dict(name=SHORT_LONG_FULL.name, seed=seed, rate=SHORT_LONG_FULL.rate,
                 classes=[dataclasses.asdict(c) for c in SHORT_LONG_FULL.classes], deadlines=TRAFFIC_DEADLINE),
        **public(run),
        repeat=dict(schedule_equal=runs[1]["schedule"] == run["schedule"], tokens_equal=runs[1]["tokens"] == run["tokens"],
                    seconds=runs[1]["seconds"], tokens_per_s=runs[1]["tokens_per_s"], step_ms=runs[1]["step_ms"]),
        profiled_run=dict(schedule_equal=prof["schedule"] == run["schedule"], tokens_equal=prof["tokens"] == run["tokens"],
                          window_ticks=TRAFFIC_WINDOW[1:], window_prefills=prof["profile"]["prefills"],
                          runs_with_dropped_records=dropped),
        cpu_schedule=dict(n_layers=cpu_cfg.n_layers, equal=cpu["schedule"] == run["schedule"],
                          preemptions=cpu["preemptions"], ticks=cpu["ticks"], seconds=cpu["seconds"]),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, phase_seconds=time.perf_counter() - t_phase,
    )
    emit(line)
    require(run["preemptions"] >= 1 and run["resumes"] >= 1, f"serve_traffic: no preemption and resume ({run['preemptions']})")
    require(run["first_page_in_equal"], "serve_traffic: the first resumed slot's prefix differs from its page-out snapshot")
    for (rid, _, _, expired, n), (_, cls, _) in zip(run["schedule"], arrivals):
        require(expired or n == cls.max_new_tokens, f"serve_traffic: request {rid} neither finished nor expired")
    require(
        line["cpu_schedule"]["equal"] and cpu["preemptions"] == run["preemptions"],
        "serve_traffic: the card's schedule differs from the CPU's",
    )
    require(line["repeat"]["schedule_equal"] and line["repeat"]["tokens_equal"], "serve_traffic: the repeat run differs")
    require(
        line["profiled_run"]["schedule_equal"] and line["profiled_run"]["tokens_equal"],
        "serve_traffic: the profiled run differs",
    )
    require(prof["profile"]["prefills"] > 0, "serve_traffic: no admission in the profiled window")
    for r in runs:
        require(
            r["captures"] == 1 and r["graph_replays"] == r["decode_ticks"],
            f"serve_traffic: {r['captures']} captures for one run (page-ins must keep the graph)",
        )
        require(
            r["prefill_replays"] == r["prefills"] and not r["capturing_admission_ms"],
            f"serve_traffic: {r['prefill_replays']} prefill replays for {r['prefills']} admissions, captures "
            f"{r['capturing_admission_ms']} (the buckets were captured in serve_traffic_exact)",
        )
        require_kernels("serve_traffic", r, {"fast": n_proj})
    by_phase["serve_traffic"] = {k: sum(r["launches"][k] for r in runs) for k in run["launches"]}
    del runs, cpu

    # farm: replicas restored from one store of this chip
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        eng.save_artifacts(d)
        save_s = time.perf_counter() - t0
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        by_phase["farm"] = farm_phase(cfg, params, dev, arrivals, d, save_s, n_proj, cpu_cfg, cpu_params)
    by_phase["farm_lifecycle"] = farm_lifecycle(cfg, params, dev, arrivals)
    return by_phase


def farm_phase(cfg, params, dev, arrivals, store, save_s, n_proj, cpu_cfg, cpu_params):
    """Two replicas restored from ``store``: the mix submitted up front under
    each policy (placements equal to the CPU farm's for the same
    submissions); one replica against a bare engine that programs the chip
    itself (tokens equal); the ticks to drain on 1 and on 2 replicas.  All at
    ``FARM_BATCH`` slots a replica.  Returns the launches of the farms'
    runs."""
    ideal = CrossbarMode(enabled=True, strict=True)
    t_phase = time.perf_counter()

    def farm(n, policy="round_robin"):
        t0 = time.perf_counter()
        f = ChipFarm(cfg, params, n_replicas=n, policy=policy, max_batch=FARM_BATCH, max_seq=TRAFFIC_SEQ,
                     crossbar=ideal, restore_artifacts=store, device=dev)
        return f, time.perf_counter() - t0

    runs, restore_s = {}, {}
    for name, n, policy in (("round_robin", 2, "round_robin"), ("least_loaded", 2, "least_loaded"),
                            ("one_replica", 1, "round_robin")):
        f, restore_s[name] = farm(n, policy)
        runs[name] = farm_run(f, arrivals)
        r = runs[name]
        require(all(c == 1 for c in r["captures"]), f"farm {name}: captures {r['captures']}")
        require(
            r["prefill_replays_by_replica"] == r["prefills_by_replica"]
            and r["prefill_captures_by_replica"] == [len(b) for b in r["prefill_graphs_by_replica"]],
            f"farm {name}: prefill replays {r['prefill_replays_by_replica']} for admissions "
            f"{r['prefills_by_replica']}, captures {r['prefill_captures_by_replica']}",
        )
        require_kernels(f"farm {name}", runs[name], {"fast": n_proj})
        del f
        gc.collect()
        torch.cuda.empty_cache()
    bare = ServingEngine(cfg, params, max_batch=FARM_BATCH, max_seq=TRAFFIC_SEQ, crossbar=ideal, device=dev)
    for _, cls, prompt in arrivals:
        bare.submit(prompt, max_new_tokens=cls.max_new_tokens)
    bare_tokens = drain(bare)
    del bare
    cpu_placements = {}
    for policy in POLICIES:  # placement is decided at submission
        cpu_farm = ChipFarm(cpu_cfg, cpu_params, n_replicas=2, policy=policy, max_batch=FARM_BATCH,
                            max_seq=TRAFFIC_SEQ, device="cpu")
        cpu_placements[policy] = [
            cpu_farm.replica_of(cpu_farm.submit(p, max_new_tokens=c.max_new_tokens)) for _, c, p in arrivals
        ]
    speedup = runs["one_replica"]["ticks"] / runs["round_robin"]["ticks"]
    line = dict(
        phase="farm", arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model, max_batch=FARM_BATCH,
        requests=len(arrivals), store_save_seconds=save_s, restore_seconds=restore_s,
        runs={k: {x: y for x, y in r.items() if x not in ("tokens", "rids")} for k, r in runs.items()},
        placements_equal_cpu={p: runs[p]["placements"] == cpu_placements[p] for p in POLICIES},
        one_replica_tokens_equal_bare_engine=[runs["one_replica"]["tokens"][r] for r in runs["one_replica"]["rids"]]
        == bare_tokens,
        least_loaded_tokens_equal_round_robin=runs["least_loaded"]["tokens"] == runs["round_robin"]["tokens"],
        tick_speedup_2_vs_1=speedup, tick_speedup_gate=FARM_SPEEDUP_MIN,
        wall_tokens_per_s={k: r["wall_tokens_per_s"] for k, r in runs.items()},
        wall_clock_note="both replicas share one card and their ticks run one after the other: "
                        "wall-clock tokens/s is printed, not gated",
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, phase_seconds=time.perf_counter() - t_phase,
    )
    emit(line)
    require(all(line["placements_equal_cpu"].values()), f"farm: placements differ from the CPU farm's {cpu_placements}")
    require(line["one_replica_tokens_equal_bare_engine"], "farm: one replica's tokens differ from a bare engine's")
    require(speedup > FARM_SPEEDUP_MIN, f"farm: 2 replicas drain in {speedup}x fewer ticks, gate {FARM_SPEEDUP_MIN}")
    return {k: sum(r["launches"][k] for r in runs.values()) for k in runs["round_robin"]["launches"]}


def farm_lifecycle(cfg, params, dev, arrivals):
    """Two replicas of a 2-layer full-width copy on LIFECYCLE_DEVICE (the
    noisy kernel), each programming the same chip, one slot each, both
    serving: age replica 0 (its health worst above replica 1's), drain it,
    submit (routed to replica 1), refresh replica 0 into a store slot once it
    is idle (program, save, commit, hot swap), undrain, submit (routed to
    replica 0).  Aging and the refresh each drop replica 0's decode and
    prefill graphs and none of replica 1's; after the refresh replica 0's
    next admission captures its bucket's prefill anew, ``torch.equal`` to an
    eager one on the new chip, and its tick is captured exactly once;
    replica 1's decode and prefill graphs are the same objects throughout;
    replica 0's tokens after the refresh equal a fresh restore's.  Returns
    the launches of the serving after the refresh."""
    torch.cuda.reset_peak_memory_stats()
    cut_cfg, cparams = cut_params(cfg, params, 2) if cfg.n_layers > 2 else (cfg, params)
    mode = CrossbarMode(enabled=True, strict=True, device=LIFECYCLE_DEVICE)
    short = [p for _, c, p in arrivals if c.name == "short"]
    long_ = next(p for _, c, p in arrivals if c.name == "long")
    kw = dict(max_batch=1, max_seq=TRAFFIC_SEQ, crossbar=mode, device=dev)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        farm = ChipFarm(cut_cfg, cparams, n_replicas=2, **kw)
        r_a = farm.submit(short[0], max_new_tokens=8)
        r_b = farm.submit(long_, max_new_tokens=32)
        while not farm.is_idle(0):
            farm.step()
        r0, r1 = (e.runner for e in farm.replicas)
        g1, p1 = r1.decode_graph, dict(r1.prefill_graphs)
        require(
            g1 is not None and r0.decode_graph is not None and r0.prefill_graphs and p1,
            "farm_lifecycle: no captures",
        )
        # replica 1 keeps its tick and every prefill graph it had (it may
        # capture another bucket's meanwhile)
        kept = lambda: r1.decode_graph is g1 and all(r1.prefill_graphs.get(b) is g for b, g in p1.items())  # noqa: E731
        farm.replicas[0].age(LIFECYCLE_AGE_S)
        aging_dropped = r0.decode_graph is None and not r0.prefill_graphs and kept()
        health = [h.worst for h in farm.health()]
        uptimes_aged = farm.uptimes()
        farm.drain(0)
        keep = farm.submit(short[1], max_new_tokens=8)
        idle_before_refresh = farm.is_idle(0)
        farm.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slot = farm.refresh(0, d)
        torch.cuda.synchronize()
        refresh_s = time.perf_counter() - t0
        dropped = r0.decode_graph is None and not r0.prefill_graphs and kept()
        prefill = recaptured_prefill("farm_lifecycle", r0, short[2])
        farm.undrain(0)
        back = farm.submit(short[2], max_new_tokens=8)
        reset_crossbar_misses()
        kvmm.reset_counters()
        kscan.reset_counters()
        g0_seen, g1_kept, replays1 = [], True, g1.replays
        with timed_admissions(farm.replicas[0].runner) as a0, timed_admissions(farm.replicas[1].runner) as a1:
            while not all(farm.is_idle(i) for i in range(2)):
                farm.step()
                g = farm.replicas[0].runner.decode_graph
                if g is not None and (not g0_seen or g0_seen[-1] is not g):
                    g0_seen.append(g)
                g1_kept = g1_kept and kept()
        served = dict(
            launches=dict(kvmm.LAUNCHES, **kscan.LAUNCHES), plain_calls=dict(kvmm.PLAIN_CALLS, **kscan.PLAIN_CALLS),
            misses=len(crossbar_misses()),
        )
        # forwards after the refresh: both replicas' admissions and replays
        forwards = a0.count + a1.count + (g0_seen[-1].replays if g0_seen else 0) + g1.replays - replays1
        res = {r.rid: r for r in farm.run_until_done(max_ticks=0)}
        fresh = ServingEngine(cut_cfg, cparams, restore_artifacts=d, **kw)
        fresh.submit(short[2], max_new_tokens=8)
        fresh_tokens = drain(fresh)[0]
        active = active_slot(d)
    n_proj = 6 * cut_cfg.n_layers + 1
    line = dict(
        phase="farm_lifecycle", arch=cfg.name, n_layers=cut_cfg.n_layers, d_model=cfg.d_model,
        device=dataclasses.asdict(LIFECYCLE_DEVICE), age_s=LIFECYCLE_AGE_S, health_worst_after_aging=health,
        uptimes_after_aging=uptimes_aged, uptimes_after_refresh=farm.uptimes(), keep_routed_to=farm.replica_of(keep),
        back_routed_to=farm.replica_of(back), idle_before_refresh=idle_before_refresh, refresh_slot=slot,
        active_slot=active, refresh_seconds=refresh_s, aging_dropped_replica0_graphs=aging_dropped,
        refresh_dropped_graph=dropped, replica0_prefill_after_refresh=prefill,
        replica0_captures_after_refresh=len(g0_seen), replica1_graph_kept=g1_kept,
        tokens_equal_fresh_restore=res[back].generated == fresh_tokens,
        finished=[res[r].done for r in (r_a, r_b, keep, back)], **served,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, phase_seconds=time.perf_counter() - t_phase,
    )
    emit(line)
    require(health[0] > health[1] and uptimes_aged[0] > 0 == uptimes_aged[1], f"farm_lifecycle: aging {line}")
    require(line["keep_routed_to"] == 1 and line["back_routed_to"] == 0, "farm_lifecycle: routing around the drain")
    require(aging_dropped, "farm_lifecycle: aging replica 0 kept its graphs or touched replica 1's")
    require(idle_before_refresh and dropped and slot == active, "farm_lifecycle: the refresh")
    require(line["uptimes_after_refresh"][0] == 0.0, "farm_lifecycle: the refreshed replica has aged")
    require(len(g0_seen) == 1 and g1_kept, f"farm_lifecycle: captures {len(g0_seen)}, replica 1 kept {g1_kept}")
    require(line["tokens_equal_fresh_restore"], "farm_lifecycle: the refreshed replica's tokens differ from a fresh restore's")
    require(all(line["finished"]), "farm_lifecycle: a request did not finish")
    require_kernels("farm_lifecycle", served, {"noisy": n_proj}, forwards)
    return served["launches"]


def serve_traffic_xlstm(cfg, params, dev, seed):
    """xlstm-350m (a pure-recurrent pool) at full width and depth from an
    ideal chip: the mix's requests submitted up front, through the slot loop
    and then the scheduler on its runner (tokens equal; each request's first
    token sampled from its prefill and streamed); the scan kernel on every
    sLSTM layer and the fast kernel on the head of every forward; every
    request holds one block; one live slot paged out and into another free
    slot leaves every state leaf ``torch.equal``.  Returns the launches of
    both runs."""
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    arrivals = dataclasses.replace(SHORT_LONG_FULL, seed=seed).sample_arrivals(cfg.vocab_size)
    eng = ServingEngine(cfg, params, max_batch=TRAFFIC_BATCH, max_seq=TRAFFIC_SEQ,
                        crossbar=CrossbarMode(enabled=True, strict=True), device=dev)
    n_scan = sum(spec.repeats * spec.kinds.count("slstm") for spec in cfg.stages)
    for _, cls, prompt in arrivals:
        eng.submit(prompt, max_new_tokens=cls.max_new_tokens)
    kvmm.reset_counters()
    kscan.reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slot_tokens = drain(eng)
    slot_s = time.perf_counter() - t0
    slot_launches = dict(kvmm.LAUNCHES, **kscan.LAUNCHES)
    run = traffic_run(eng.runner, arrivals)

    # one live slot paged out and into another free slot, by hand
    sched = ContinuousBatchingScheduler(eng.runner, max_batch=TRAFFIC_BATCH)
    kv = sched.kv
    rids = [sched.submit(p, max_new_tokens=c.max_new_tokens) for _, c, p in arrivals[:2]]
    for _ in range(3):
        sched.step()
    tables = [kv.table(r) for r in rids]
    slot, free = 0, sched.slots.index(None)
    want = [t.clone() for t in slot_state(kv.cache, cfg, slot, 0)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kv.page_out(rids[0], slot, int(sched.pos[slot]), int(sched.last_tok[slot]))
    out_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    kv.page_in(rids[0], free)
    torch.cuda.synchronize()
    in_s = time.perf_counter() - t0
    state_equal = all(torch.equal(a, b) for a, b in zip(want, slot_state(kv.cache, cfg, free, 0)))
    line = dict(
        phase="serve_traffic_xlstm", arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        slstm_layers=n_scan, mix=SHORT_LONG_FULL.name, seed=seed,
        slot_loop=dict(seconds=slot_s, tokens_per_s=sum(map(len, slot_tokens)) / slot_s, launches=slot_launches),
        tokens_equal_slot_loop=run["tokens"] == slot_tokens, **public(run),
        blocks_held=[len(t) for t in tables], blocks_for_max_seq=kv.blocks_for(TRAFFIC_SEQ),
        page_round_trip=dict(state_equal=state_equal, bytes=sum(t.numel() * t.element_size() for t in want),
                             page_out_ms=1e3 * out_s, page_in_ms=1e3 * in_s),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, phase_seconds=time.perf_counter() - t_phase,
    )
    emit(line)
    require(line["tokens_equal_slot_loop"], "serve_traffic_xlstm: the scheduler's tokens differ from the slot loop's")
    require(
        run["completed"] == len(arrivals) and run["new_tokens"] == run["decoded_tokens"] + run["prefills"],
        f"serve_traffic_xlstm: {run['new_tokens']} tokens, {run['decoded_tokens']} decoded, {run['prefills']} "
        "prefills: the first token of each request comes from its prefill",
    )
    require(
        run["captures"] == 1 and run["graph_replays"] == run["decode_ticks"],
        f"serve_traffic_xlstm: {run['captures']} captures, {run['graph_replays']} replays",
    )
    require(
        not run["prefill_graphs"] and run["prefill_replays"] == 0 and not run["capturing_admission_ms"],
        f"serve_traffic_xlstm: prefill graphs {run['prefill_graphs']} on a recurrent model",
    )
    require_kernels("serve_traffic_xlstm", run, {"fast": 1, "slstm_scan": n_scan})
    require(line["blocks_held"] == [1, 1] and line["blocks_for_max_seq"] == 1, "serve_traffic_xlstm: blocks")
    require(state_equal, "serve_traffic_xlstm: the paged state differs")
    del eng, sched
    gc.collect()
    torch.cuda.empty_cache()
    return {k: v + slot_launches.get(k, 0) for k, v in run["launches"].items()}


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def tree_equal(a, b) -> bool:
    fa, fb = flatten(a), flatten(b)
    return fa.keys() == fb.keys() and all(torch.equal(fa[k], fb[k]) for k in fa)


def on_device(batch, dev):
    return {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in batch.items()}


def step_stats(seconds, tokens, n_params):
    """Step ms p50 / p99 (host clock, each step ended by a sync), tokens/s
    and the model's TFLOP/s by 6 x params x tokens a step at the median."""
    ms = sorted(1e3 * x for x in seconds)
    p50 = statistics.median(ms)
    return dict(
        steps_timed=len(ms), step_ms_p50=p50, step_ms_p99=ms[min(len(ms) - 1, int(0.99 * len(ms)))],
        tokens_per_s=tokens / (p50 / 1e3),
        model_tflops_per_s=6 * n_params * tokens / (p50 / 1e3) / 1e12,
        model_flops_formula="6 x params x tokens a step / step time (p50); remat's extra forward not counted",
    )


def train_smollm(cfg, dev, seed):
    """smollm-360m trained on the card at full width (bf16 params, remat,
    AdamW under cosine_with_warmup, B = 4, S = 1024: two loss chunks).
    (a) resume: ``RESUME_STEPS`` uninterrupted ``TrainLoop`` steps against
    half of them with a checkpoint there, fresh params and state restored by
    ``maybe_resume`` and the other half: every param and state leaf
    ``torch.equal``; (b) learning:
    ``LEARN_STEPS`` steps on one fixed batch, none skipped, every loss finite, every
    param leaf moved, the last loss below 0.9 x the first; (c) one poisoned
    step (loss x NaN): skipped, params and state ``torch.equal`` to before;
    (d) the port's loss and grads of the reduced config in float32 on the
    card and on the CPU.  Returns the trained params and the fixed batch."""
    tokens = TRAIN_BATCH * TRAIN_SEQ
    ds = SyntheticLMDataset(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=seed)

    def fresh(opt):
        p = model_lib.init_model(cfg, seed, device=dev)
        return p, opt.init(p)

    # (a) resume
    opt = make_optimizer("adamw", cosine_with_warmup(TRAIN_LR, RESUME_STEPS // 10 + 1, RESUME_STEPS))
    step_fn = make_train_step(cfg, opt)
    torch.cuda.reset_peak_memory_stats()
    p, o = fresh(opt)
    whole = TrainLoop(cfg, step_fn, ds, ckpt_dir=None, log_every=100)
    n_params = sum(t.numel() for t in flatten(p).values())
    p_ref, o_ref = whole.run(p, o, RESUME_STEPS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with tempfile.TemporaryDirectory() as d:
        first = TrainLoop(cfg, step_fn, ds, ckpt_dir=d, ckpt_every=RESUME_STEPS // 2, log_every=100)
        p, o = fresh(opt)
        first.run(p, o, RESUME_STEPS // 2)
        snapshot_s, write_s = first.ckpt.snapshot_seconds, first.ckpt.write_seconds
        del p, o
        second = TrainLoop(cfg, step_fn, ds, ckpt_dir=d, ckpt_every=100, log_every=100)
        p, o = fresh(opt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, o, start = second.maybe_resume(p, o)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        require(start == RESUME_STEPS // 2, f"train_smollm: resumed at step {start}, expected {RESUME_STEPS // 2}")
        p, o = second.run(p, o, RESUME_STEPS, start_step=start)
        ckpt_bytes = sum(os.path.getsize(os.path.join(d, f"step_{start:09d}", f))
                         for f in os.listdir(os.path.join(d, f"step_{start:09d}")))
    resumed_equal = tree_equal({"p": p_ref, "o": o_ref}, {"p": p, "o": o})
    del p, o, p_ref, o_ref
    torch.cuda.empty_cache()

    # (b) learning on one fixed batch; the optimizer's update timed apart
    # by CUDA events
    opt = make_optimizer("adamw", cosine_with_warmup(TRAIN_LR, LEARN_STEPS // 10 + 1, LEARN_STEPS))
    update_events = []

    def timed_update(*args, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = opt.update(*args, **kw)
        end.record()
        update_events.append((start, end))
        return out

    step_fn = make_train_step(cfg, Optimizer(opt.init, timed_update))
    batch = on_device(ds.batch_at(0), dev)
    p, o = fresh(opt)
    initial = {k: v.clone() for k, v in flatten(p).items()}
    step = torch.tensor(0, dtype=torch.int32, device=dev)
    losses, skipped, learn_s = [], 0, []
    for _ in range(LEARN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, o, step, m = step_fn(p, o, step, batch)
        torch.cuda.synchronize()
        learn_s.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        skipped += int(m["skipped"])
    moved = [k for k, v in flatten(p).items() if not torch.equal(v, initial[k])]
    update_ms = sorted(start.elapsed_time(end) for start, end in update_events[1:])
    del initial

    # (c) the NaN guard: one poisoned step leaves params and state as they were
    poisoned = make_train_step(cfg, opt, loss_fn=lambda q, b: model_lib.loss_fn(q, cfg, b) * float("nan"))
    before = tree_map(torch.clone, {"p": p, "o": o})
    p, o, step, m = poisoned(p, o, step, batch)
    nan_skipped = int(m["skipped"])
    nan_kept = tree_equal(before, {"p": p, "o": o})
    del before
    train_profile(step_fn, p, o, step, batch)
    del o
    torch.cuda.empty_cache()

    line = dict(
        phase="train_smollm", arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model, vocab=cfg.vocab_size,
        params=n_params, param_dtype=cfg.param_dtype, remat=cfg.remat, optimizer="adamw", batch=TRAIN_BATCH,
        seq=TRAIN_SEQ, loss_chunks=TRAIN_SEQ // model_lib.loss_chunk(TRAIN_SEQ), lr=TRAIN_LR,
        resume_steps=RESUME_STEPS, resumed_at=start, resumed_equal=resumed_equal,
        loop_step_ms=[1e3 * x for x in whole.step_seconds],
        **step_stats(learn_s[1:], tokens, n_params),
        update_ms_p50=statistics.median(update_ms), cold_first_step_ms=1e3 * whole.step_seconds[0],
        peak_gb=peak_gb,
        save_async_snapshot_seconds=snapshot_s, save_async_write_seconds=write_s, restore_seconds=restore_s,
        checkpoint_gb=ckpt_bytes / 1e9,
        learn_steps=LEARN_STEPS, first_loss=losses[0], last_loss=losses[-1], losses=losses, learn_skipped=skipped,
        leaves_moved=f"{len(moved)}/{len(flatten(p))}", nan_skipped=nan_skipped, nan_kept_params_and_state=nan_kept,
        **train_card_vs_cpu(dev, seed),
    )
    emit(line)
    require(resumed_equal, "train_smollm: the resumed run differs from the uninterrupted one")
    require(skipped == 0 and all(np.isfinite(losses)), f"train_smollm: skipped {skipped}, losses {losses}")
    require(len(moved) == len(flatten(p)), f"train_smollm: only {len(moved)} param leaves moved")
    require(losses[-1] < 0.9 * losses[0], f"train_smollm: loss {losses[0]} -> {losses[-1]}, not below 0.9x")
    require(nan_skipped == 1 and nan_kept, "train_smollm: the poisoned step was applied")
    require(line["card_vs_cpu_loss_rel"] <= CARD_VS_CPU_LOSS_REL, f"train_smollm: card vs CPU loss {line}")
    require(line["card_vs_cpu_grad_rel_l2_max"] <= CARD_VS_CPU_GRAD_REL_L2, f"train_smollm: card vs CPU grads {line}")
    return p, batch


def gemm_kind(name):
    """A device kernel's class by its name: a float32 matmul (the plain
    attention's products: TF32 is off and every projection is bf16), a
    16-bit matmul, or anything else."""
    n = name.lower()
    if not any(t in n for t in ("gemm", "nvjet", "xmma", "cutlass")):
        return "other"
    return "matmul_f32" if any(t in n for t in ("f32f32", "sgemm", "_sss", "tf32")) else "matmul_16bit"


def train_profile(step_fn, p, o, step, batch, steps=2):
    """``steps`` train steps in a ``profiler_session``: device busy ms and
    launches a step, the device's idle share, device ms by kernel class
    (``gemm_kind``) and the heaviest kernels.  A window whose prologue the
    profiler lost whole is taken anew, up to ``PROFILE_RUNS`` windows."""
    for run in range(PROFILE_RUNS):
        with profiler_session() as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                p, o, step, _ = step_fn(p, o, step, batch)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        kernels, prologue_seen = device_entries(prof)
        if prologue_seen:
            break
        emit(dict(phase="train_profile_dropped", window=run, prologue_records_lost=PROFILE_PROLOGUE))
    busy_ms = sum(k[1] for k in kernels)
    by_kind = {}
    for name, ms, _ in kernels:
        by_kind[gemm_kind(name)] = by_kind.get(gemm_kind(name), 0.0) + ms / steps
    line = dict(
        phase="train_profile", steps=steps, wall_ms_per_step_profiled=wall_ms / steps,
        device_busy_ms_per_step=busy_ms / steps, device_idle_share=1.0 - busy_ms / wall_ms,
        device_launches_per_step=sum(k[2] for k in kernels) / steps, device_ms_per_step_by_kind=by_kind,
        top_device_time=[dict(name=k[0][:70], ms_per_step=k[1] / steps, calls_per_step=k[2] / steps) for k in kernels[:10]],
        prologue_records_lost=PROFILE_PROLOGUE - prologue_seen,
    )
    emit(line)
    require(
        prologue_seen > 0,
        f"train_profile: the profiler lost all {PROFILE_PROLOGUE} prologue records in {PROFILE_RUNS} windows",
    )
    require(busy_ms > 0, "train_profile: no device time in the window")
    return line


def train_card_vs_cpu(dev, seed, arch="smollm-360m", seq=1024):
    """The port's loss and grads of the reduced ``arch`` in float32 (B = 2,
    ``seq`` positions: two loss chunks of 512 at 1024) on the card and on
    the CPU, from the same params and batch (``make_dataset``'s: synthetic
    tokens, or the stub's embeddings for an embedding front end)."""
    cfg = reduced(get_config(arch))
    params = model_lib.init_model(cfg, seed, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in make_dataset(cfg, seq, 2, seed).batch_at(0).items()}
    loss_fn = lambda q, b: model_lib.loss_fn(q, cfg, b)  # noqa: E731
    cpu_loss, cpu_grads = value_and_grad(loss_fn, params, batch)
    card_loss, card_grads = value_and_grad(loss_fn, tree_map(lambda t: t.to(dev), params), on_device(batch, dev))
    cg, kg = flatten(cpu_grads), flatten(card_grads)
    errs = {k: float((kg[k].cpu() - cg[k]).norm() / cg[k].norm()) for k in cg}
    return dict(
        card_vs_cpu_seq=seq, card_vs_cpu_loss=[float(card_loss), float(cpu_loss)],
        card_vs_cpu_loss_rel=abs(float(card_loss) - float(cpu_loss)) / abs(float(cpu_loss)),
        card_vs_cpu_grad_rel_l2_max=max(errs.values()), card_vs_cpu_worst_leaf=max(errs, key=errs.get),
    )


def train_musicgen(dev, seed, quick):
    """musicgen-large trained on the card at full width, cut to
    ``EMBED_TRAIN_LAYERS`` layers (2 under ``--quick``): bf16 params,
    remat, AdamW under cosine_with_warmup, on the stub dataset's frame
    embeddings and token targets (``make_dataset``, B = 4, S = 1024: two
    loss chunks).  ``EMBED_TRAIN_STEPS`` steps on one fixed batch: none
    skipped, every loss finite, the last below 0.9 x the first; the port's
    loss and grads of the reduced config in float32 on the card and on the
    CPU (``train_smollm``'s tolerances)."""
    cfg = depth_config(get_config(MUSICGEN), 2 if quick else EMBED_TRAIN_LAYERS)
    ds = make_dataset(cfg, TRAIN_SEQ, TRAIN_BATCH, seed=seed)
    require(isinstance(ds, EmbeddingStubDataset), f"train_musicgen: make_dataset gave {type(ds).__name__}")
    batch = on_device(ds.batch_at(0), dev)
    opt = make_optimizer("adamw", cosine_with_warmup(TRAIN_LR, EMBED_TRAIN_STEPS // 10 + 1, EMBED_TRAIN_STEPS))
    step_fn = make_train_step(cfg, opt)
    torch.cuda.reset_peak_memory_stats()
    p = model_lib.init_model(cfg, seed, device=dev)
    o = opt.init(p)
    n_params = sum(t.numel() for t in flatten(p).values())
    step = torch.tensor(0, dtype=torch.int32, device=dev)
    losses, skipped, learn_s = [], 0, []
    for _ in range(EMBED_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, o, step, m = step_fn(p, o, step, batch)
        torch.cuda.synchronize()
        learn_s.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        skipped += int(m["skipped"])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del p, o
    torch.cuda.empty_cache()
    line = dict(
        phase="train_musicgen", arch=cfg.name, n_layers=cfg.n_layers, layers_of=get_config(MUSICGEN).n_layers,
        d_model=cfg.d_model, vocab=cfg.vocab_size, frontend=cfg.frontend, dataset=type(ds).__name__,
        inputs_shape=list(batch["inputs"].shape), inputs_dtype=str(batch["inputs"].dtype),
        params=n_params, param_dtype=cfg.param_dtype, remat=cfg.remat, optimizer="adamw", batch=TRAIN_BATCH,
        seq=TRAIN_SEQ, loss_chunks=TRAIN_SEQ // model_lib.loss_chunk(TRAIN_SEQ), lr=TRAIN_LR,
        reduced=[f"depth {get_config(MUSICGEN).n_layers} -> {cfg.n_layers}"],
        **step_stats(learn_s[1:], TRAIN_BATCH * TRAIN_SEQ, n_params), cold_first_step_ms=1e3 * learn_s[0],
        peak_gb=peak_gb, learn_steps=EMBED_TRAIN_STEPS, first_loss=losses[0], last_loss=losses[-1], losses=losses,
        learn_skipped=skipped, **train_card_vs_cpu(dev, seed, MUSICGEN),
    )
    emit(line)
    require(skipped == 0 and all(np.isfinite(losses)), f"train_musicgen: skipped {skipped}, losses {losses}")
    require(losses[-1] < 0.9 * losses[0], f"train_musicgen: loss {losses[0]} -> {losses[-1]}, not below 0.9x")
    require(line["card_vs_cpu_loss_rel"] <= CARD_VS_CPU_LOSS_REL, f"train_musicgen: card vs CPU loss {line}")
    require(line["card_vs_cpu_grad_rel_l2_max"] <= CARD_VS_CPU_GRAD_REL_L2, f"train_musicgen: card vs CPU grads {line}")


def train_xlstm(dev, seed, quick):
    """xlstm-350m trained on the card at full width and depth (2 layers
    under ``--quick``): bf16 params, remat, AdamW under cosine_with_warmup,
    B = 4, S = ``XLSTM_TRAIN_SEQ`` (two loss chunks), ``LEARN_STEPS`` steps
    on one fixed batch, the sLSTM layers through ``SlstmScan`` (the saving
    forward and the backward kernel).  Each step must launch the saving
    forward 2 x and the backward 1 x per sLSTM layer and the serving scan
    never; none skipped, every loss finite, every param leaf moved (each
    sLSTM layer's ``r_*`` and ``w_in`` included), the last loss below 0.9 x
    the first; then one profiled window of 2 steps (device ms by class: the
    two scan kernels, float32 and 16-bit matmuls, the rest; the dR products
    timed apart by CUDA events) and the port's loss and grads of the reduced
    config in float32 on the card and on the CPU: at
    ``XLSTM_CARD_VS_CPU_SEQ`` positions within ``train_smollm``'s
    tolerances, at 1024 the loss within them and the grads printed.
    Returns the launches of the learning steps."""
    cfg = get_config("xlstm-350m")
    if quick:
        cfg = dataclasses.replace(cfg, n_layers=2, stages=(StageSpec(kinds=("mlstm", "slstm"), repeats=1),))
    n_slstm = sum(spec.repeats * spec.kinds.count("slstm") for spec in cfg.stages)
    ds = SyntheticLMDataset(cfg.vocab_size, XLSTM_TRAIN_SEQ, TRAIN_BATCH, seed=seed)
    batch = on_device(ds.batch_at(0), dev)
    opt = make_optimizer("adamw", cosine_with_warmup(TRAIN_LR, LEARN_STEPS // 10 + 1, LEARN_STEPS))
    step_fn = make_train_step(cfg, opt)
    torch.cuda.reset_peak_memory_stats()
    p = model_lib.init_model(cfg, seed, device=dev)
    o = opt.init(p)
    initial = {k: v.clone() for k, v in flatten(p).items()}
    n_params = sum(t.numel() for t in flatten(p).values())
    step = torch.tensor(0, dtype=torch.int32, device=dev)
    losses, skipped, learn_s, per_step = [], 0, [], []
    kvmm.reset_counters()
    kscan.reset_counters()
    for _ in range(LEARN_STEPS):
        before = dict(kscan.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, o, step, m = step_fn(p, o, step, batch)
        torch.cuda.synchronize()
        learn_s.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        skipped += int(m["skipped"])
        per_step.append({k: n - before[k] for k, n in kscan.LAUNCHES.items()})
    launches = dict(kvmm.LAUNCHES, **kscan.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    moved = [k for k, v in flatten(p).items() if not torch.equal(v, initial[k])]
    # each sLSTM layer's slice of its stacked w_in and r_* leaves
    slstm_moved = {
        f"{k}[{r}]": not torch.equal(v[r], initial[k][r])
        for k, v in flatten(p).items() if k.split("/")[-1] in ("w_in", "r_z", "r_i", "r_f", "r_o")
        for r in range(v.shape[0])
    }
    n_leaves = len(initial)
    del initial

    def two_steps():
        for _ in range(2):
            step_fn(p, o, step, batch)  # params and state in place

    profile = retried_window("train_profile_xlstm", lambda: profile_window(
        "train_profile_xlstm", two_steps, 2, classes={
            "k5_save": (SCAN_KERNEL,), "k5_bwd": (SCAN_BWD_KERNEL,),
            "matmul_f32": ("f32f32", "sgemm", "_sss", "tf32"), "matmul_16bit": ("gemm", "nvjet", "xmma", "cutlass"),
        },
    ))
    # the dR products of one sLSTM layer at the train shape, as the backward runs them
    B, S, H, dh = TRAIN_BATCH, XLSTM_TRAIN_SEQ, cfg.n_heads, xlstm_mod.d_inner_of(cfg) // cfg.n_heads
    h_prev = torch.randn((B, S, H, dh), device=dev)
    g = torch.randn((B, S, 4, H, dh), device=dev)
    dr_ms = cuda_ms(lambda: torch.einsum("bshd,bsghe->ghde", h_prev, g), reps=10)
    del p, o, h_prev, g
    torch.cuda.empty_cache()
    want = {"slstm_scan": 0, "slstm_scan_save": 2 * n_slstm if cfg.remat else n_slstm, "slstm_scan_bwd": n_slstm}
    line = dict(
        phase="train_xlstm", arch=cfg.name, n_layers=cfg.n_layers, slstm_layers=n_slstm, d_model=cfg.d_model,
        n_heads=cfg.n_heads, head_dim=dh, vocab=cfg.vocab_size, params=n_params, param_dtype=cfg.param_dtype,
        remat=cfg.remat, optimizer="adamw", batch=TRAIN_BATCH, seq=XLSTM_TRAIN_SEQ,
        loss_chunks=XLSTM_TRAIN_SEQ // model_lib.loss_chunk(XLSTM_TRAIN_SEQ), lr=TRAIN_LR,
        **step_stats(learn_s[1:], TRAIN_BATCH * XLSTM_TRAIN_SEQ, n_params), cold_first_step_ms=1e3 * learn_s[0],
        peak_gb=peak_gb, scan_launches_per_step=per_step[-1], scan_launches_per_step_expected=want,
        launches=launches, learn_steps=LEARN_STEPS, first_loss=losses[0], last_loss=losses[-1], losses=losses,
        learn_skipped=skipped, leaves_moved=f"{len(moved)}/{n_leaves}",
        slstm_slices_moved=f"{sum(slstm_moved.values())}/{len(slstm_moved)}",
        dr_products_ms_per_layer=dr_ms, dr_products_ms_per_step=dr_ms * n_slstm,
        profile_busy_ms_per_step_by_class=profile.get("busy_ms_per_tick_by_class"),
        **train_card_vs_cpu(dev, seed, "xlstm-350m", seq=XLSTM_CARD_VS_CPU_SEQ),
        at_1024={k.replace("card_vs_cpu_", ""): v for k, v in train_card_vs_cpu(dev, seed, "xlstm-350m").items()},
    )
    emit(line)
    require(all(n == want for n in per_step), f"train_xlstm: scan launches a step {per_step}, expected {want}")
    require(skipped == 0 and all(np.isfinite(losses)), f"train_xlstm: skipped {skipped}, losses {losses}")
    require(len(moved) == n_leaves, f"train_xlstm: only {len(moved)} of {n_leaves} param leaves moved")
    require(len(slstm_moved) == 5 * n_slstm and all(slstm_moved.values()),
            f"train_xlstm: sLSTM layers' w_in / r_* that did not move: {[k for k, v in slstm_moved.items() if not v]}")
    require(losses[-1] < 0.9 * losses[0], f"train_xlstm: loss {losses[0]} -> {losses[-1]}, not below 0.9x")
    require(line["card_vs_cpu_loss_rel"] <= CARD_VS_CPU_LOSS_REL, f"train_xlstm: card vs CPU loss {line}")
    require(line["card_vs_cpu_grad_rel_l2_max"] <= CARD_VS_CPU_GRAD_REL_L2, f"train_xlstm: card vs CPU grads {line}")
    require(line["at_1024"]["loss_rel"] <= CARD_VS_CPU_LOSS_REL, f"train_xlstm: card vs CPU loss at 1024 {line}")
    return launches


def mesh_config(arch, layers, quick):
    cfg = get_config(arch)
    if quick:
        layers = len(cfg.stages[0].kinds) * (2 if arch == "xlstm-350m" else 1)
    return cfg if layers is None else depth_config(cfg, layers)


def train_mesh_batch(cfg, seed, step, dev):
    """Step ``step``'s whole global batch (process 0 of 1: a rank's step
    takes its rows)."""
    ds = SyntheticLMDataset(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=seed, process_index=0, process_count=1)
    return on_device(ds.batch_at(step), dev)


def _grad_path(directory, case, dtype, key):
    return os.path.join(directory, case, dtype, key.replace("/", "__") + ".pt")


def _sq_sums(a, ref, chunk=1 << 26):
    """(sum (a - ref)^2, sum ref^2) in float32, a chunk of elements at a
    time (a vocabulary table's float32 copies would not fit beside the
    ranks)."""
    num = den = 0.0
    for x, y in zip(a.reshape(-1).split(chunk), ref.reshape(-1).split(chunk)):
        x, y = x.to(torch.float32), y.to(torch.float32)
        num += float(torch.sum(torch.square(x - y)))
        den += float(torch.sum(torch.square(y)))
    return num, den


def _rel_l2(a, ref) -> float:
    num, den = _sq_sums(a, ref)
    return math.sqrt(num / max(den, 1e-60))


def train_mesh_reference(case, cfg, dev, seed, directory):
    """The one-device step 1 on the card (the parent's), in bf16 and on the
    same params cast to float32: both losses, both gradients saved leaf by
    leaf for rank 0, bf16's distance from float32 leaf by leaf, and the
    one-device bytes of params and AdamW moments.  Freed before it
    returns."""
    batch = train_mesh_batch(cfg, seed, 0, dev)
    params = model_lib.init_model(cfg, seed, device=dev)
    numel = sum(t.numel() for t in flatten(params).values())
    out = dict(params=numel, param_bytes=_tree_bytes(params), moment_bytes=2 * 4 * numel, loss={}, grad_seconds={})
    grads = {}
    for dtype in ("bfloat16", "float32"):
        p = params if dtype == "bfloat16" else tree_map(lambda t: t.to(torch.float32), params)
        c = dataclasses.replace(cfg, param_dtype=dtype)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, g = value_and_grad(lambda q, b: model_lib.loss_fn(q, c, b), p, batch)
        torch.cuda.synchronize()
        out["grad_seconds"][dtype], out["loss"][dtype] = time.perf_counter() - t0, float(loss)
        os.makedirs(os.path.join(directory, case, dtype))
        for k, v in flatten(g).items():
            torch.save(v.cpu(), _grad_path(directory, case, dtype, k))
        grads[dtype] = flatten(g)
        del p, g, loss
    out["bf16_vs_f32_by_leaf"] = {k: _rel_l2(v, grads["float32"][k]) for k, v in grads["bfloat16"].items()}
    del params, grads, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in flatten(tree).values())


def _share_bytes(specs, shapes, mesh) -> int:
    """The bytes of a rank's blocks of a tree of ``shapes`` by ``specs``."""
    from repro_torch.launch import sharding
    shapes = flatten(shapes)
    return sum(
        math.prod(sharding.local_shape(shapes[k].shape, s, mesh)) * shapes[k].element_size()
        for k, s in flatten(specs).items()
    )


def _held_to_one_device(grads, specs, mesh, directory, case, dtype):
    """{leaf: rel-L2} of the step's gradients to one device's of ``dtype``:
    each rank holds its blocks to the same blocks of the saved leaves (read
    through ``mmap``), and the squared sums are added over the axes each
    leaf is split over; no leaf is gathered."""
    from repro_torch.launch import sharding

    out, flat_specs = {}, flatten(specs)
    for k, g in flatten(grads).items():
        spec = flat_specs[k]
        ref = torch.load(_grad_path(directory, case, dtype, k), mmap=True)
        sums = torch.tensor(_sq_sums(g, sharding.local_block(ref, spec, mesh).to(g.device)), dtype=torch.float64)
        if sharding.spec_axes(spec):
            sums = mesh.psum(sums, sharding.spec_axes(spec))
        out[k] = math.sqrt(float(sums[0]) / max(float(sums[1]), 1e-60))
    return out


def mailboxes_vs_staged(mesh, dev):
    """Each collective through the card's mailboxes against the same one
    staged through host memory (the mesh with its mailboxes set aside), on
    integer-valued float32 and bf16 operands of 8 MB: {case: equal}."""
    gen = torch.Generator(device=dev).manual_seed(mesh.rank)
    out = {}
    for axis in ("data", "model", ("data", "model")):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randint(-8, 8, (4, (8 << 20) // 16), generator=gen, device=dev).to(dtype)
            ops = {
                "psum": lambda: mesh.psum(x, axis), "pmax": lambda: mesh.pmax(x, axis),
                "all_gather": lambda: mesh.all_gather(x, axis, 0),
                "psum_scatter": lambda: mesh.psum_scatter(x, axis, 0), "all_to_all": lambda: mesh.all_to_all(x, axis),
            }
            for name, op in ops.items():
                card = op()
                box, mesh._card = mesh._card, None
                staged = op()
                mesh._card = box
                out[f"{name} {axis} {str(dtype).replace('torch.', '')}"] = bool(torch.equal(card, staged))
    mesh.collectives.clear()
    return out


def train_mesh_rank(rank, directory, seed, quick, t_spawn, device):
    """One rank of the (2, 2) mesh on the card: for each case, the whole
    params drawn as the parent drew them and the rank's blocks kept by
    ``train_specs``; step 1 in float32 (the same params cast, SGD), its
    gathered gradients held to one device's on rank 0; then ``steps`` bf16
    AdamW steps (step 1's gradients gathered too), each timed on the host
    clock, with the collectives' bytes by axis and the scan's launches;
    resident bytes of params and moments beside the specs' share."""
    from repro_torch.launch import sharding

    up_s = time.time() - t_spawn
    dev = torch.device(device)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_local_mesh(*MESH_SHAPE)
    out = dict(spawn_seconds=up_s, coords=mesh.coords, cases={}, mailboxes=mesh._card is not None,
               mailboxes_vs_staged=mailboxes_vs_staged(mesh, dev))
    kvmm.reset_counters()
    kscan.reset_counters()
    keep, keeping_next = {}, [False]

    def keeping(opt):
        """``opt``, keeping a step's gradients where ``keeping_next`` asks
        (the step does not touch them after the update); no ``opt``: an
        update that applies nothing."""
        def update(grads, state, params, step, ok=None, norm=None):
            if keeping_next[0]:
                keep.update(grads)
                keeping_next[0] = False
            return (params, state) if opt is None else opt.update(grads, state, params, step, ok=ok, norm=norm)
        return Optimizer(lambda p: {} if opt is None else opt.init(p), update)

    for case, arch, layers, steps in MESH_CASES:
        cfg = mesh_config(arch, layers, quick)
        t_case = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        whole = model_lib.init_model(cfg, seed, device=dev)
        specs = sharding.train_specs(cfg, whole, "adamw", mesh)
        shapes = sharding.abstract(whole)
        p = sharding.local_slice(whole, specs["params"], mesh)
        del whole
        torch.cuda.empty_cache()
        # float32: the gradients held (a step that applies nothing)
        c32 = dataclasses.replace(cfg, param_dtype="float32")
        p32 = tree_map(lambda t: t.to(torch.float32), p)
        step32 = make_train_step(c32, keeping(None), mesh=mesh, specs=specs["params"])
        keeping_next[0] = True
        _, _, _, m32 = step32(p32, {}, torch.tensor(0, dtype=torch.int32, device=dev), train_mesh_batch(cfg, seed, 0, dev))
        errs32 = _held_to_one_device(keep, specs["params"], mesh, directory, case, "float32")
        loss32 = float(m32["loss"])
        keep.clear()
        del p32, step32, m32
        gc.collect()
        torch.cuda.empty_cache()
        # bf16 training
        opt = make_optimizer("adamw", cosine_with_warmup(TRAIN_LR, steps // 10 + 1, steps))
        o = opt.init(p)
        held = dict(params=_tree_bytes(p), moments=_tree_bytes(o),
                    params_share=_share_bytes(specs["params"], shapes, mesh),
                    moments_share=_share_bytes(specs["opt"], sharding.abstract(opt.init(shapes)), mesh))
        step_fn = make_train_step(cfg, keeping(opt), mesh=mesh, specs=specs["params"])
        step = torch.tensor(0, dtype=torch.int32, device=dev)
        losses, skipped, step_s, traffic, scans, errs16 = [], [], [], [], [], {}
        for i in range(steps):
            batch = train_mesh_batch(cfg, seed, i, dev)
            before_scan = dict(kscan.LAUNCHES)
            mesh.collectives.clear()
            keeping_next[0] = i == 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, o, step, m = step_fn(p, o, step, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
            skipped.append(int(m["skipped"]))
            traffic.append({a: dict(r) for a, r in mesh.traffic_by_axis.items()})
            scans.append({k: n - before_scan[k] for k, n in kscan.LAUNCHES.items()})
            if i == 0:  # step 1's bf16 gradients against one device's (outside the timed step)
                errs16 = _held_to_one_device(keep, specs["params"], mesh, directory, case, "bfloat16")
                keep.clear()
        if rank == 0:
            emit(dict(train_mesh_rank0=case, seconds=time.perf_counter() - t_case,
                      peak_gb=torch.cuda.max_memory_allocated() / 1e9, step_seconds=step_s))
        out["cases"][case] = dict(
            n_layers=cfg.n_layers, layout=cfg.layout, loss_f32=loss32, grad_rel_l2_f32=errs32,
            grad_rel_l2_bf16=errs16, losses=losses, skipped=skipped, step_seconds=step_s,
            traffic_by_axis=traffic, scan_launches=scans, held_bytes=held,
            peak_gb=torch.cuda.max_memory_allocated() / 1e9, seconds=time.perf_counter() - t_case,
        )
        del p, o
        gc.collect()
        torch.cuda.empty_cache()
    out["launches"] = dict(kvmm.LAUNCHES, **kscan.LAUNCHES)
    return out


def _worst(errs):
    return dict(max=max(errs.values()), worst_leaf=max(errs, key=errs.get), median=statistics.median(errs.values()),
                leaves=len(errs)) if errs else None


def train_mesh(dev, seed, quick):
    """smollm-360m (full depth) and gemma2-9b (2 of 42 layers) at full width
    over a (data 2, model 2) mesh under ``tp``, xlstm-350m (4 layers, 2 of
    them sLSTM) at full width under ``pure_dp`` over the same 4 ranks: one
    spawn of 4 gloo rank processes on ``cuda:0`` for the three, each case's
    one-device step first run here and freed.  Held: the step-1 loss in
    bf16 and in float32 within ``MESH_LOSS_REL`` x max(1, |loss|) of one
    device's on every rank, every float32 step-1 gradient leaf within
    ``MESH_GRAD_REL_L2`` of one device's (block by block, summed over the
    ranks), every bf16 leaf within ``MESH_BF16_GRAD_REL_L2`` or
    ``MESH_BF16_NOISE_X`` times the same leaf's bf16 distance from float32
    on one device, whichever is larger, no bf16 step skipped, each rank's resident
    params and moments equal to its specs' share, and on every xlstm rank
    K5's saving forward twice and its backward once a sLSTM layer a step.
    Returns the ranks' launches."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        refs = {}
        for case, arch, layers, _ in MESH_CASES:
            refs[case] = train_mesh_reference(case, mesh_config(arch, layers, quick), dev, seed, d)
        gc.collect()
        torch.cuda.empty_cache()  # the card to the ranks
        t_spawn = time.perf_counter()
        ranks = run_ranks(train_mesh_rank, MESH_SHAPE[0] * MESH_SHAPE[1], (d, seed, quick, time.time(), str(dev)),
                          timeout_s=900)
        ranks_s = time.perf_counter() - t_spawn
    for case, arch, layers, steps in MESH_CASES:
        cfg = mesh_config(arch, layers, quick)
        ref, rk = refs[case], [r["cases"][case] for r in ranks]
        first = [r["losses"][0] for r in rk]
        bar = {dt: MESH_LOSS_REL * max(1.0, abs(ref["loss"][dt])) for dt in ref["loss"]}
        loss_err = dict(bfloat16=max(abs(x - ref["loss"]["bfloat16"]) for x in first),
                        float32=max(abs(r["loss_f32"] - ref["loss"]["float32"]) for r in rk))
        n_slstm = sum(spec.repeats * spec.kinds.count("slstm") for spec in cfg.stages)
        want_scan = {"slstm_scan": 0, "slstm_scan_save": 2 * n_slstm if cfg.remat else n_slstm,
                     "slstm_scan_bwd": n_slstm}
        g32, g16 = _worst(rk[0]["grad_rel_l2_f32"]), _worst(rk[0]["grad_rel_l2_bf16"])
        own16 = ref["bf16_vs_f32_by_leaf"]
        bf16_by_leaf = {k: dict(mesh=e, one_device_bf16_vs_f32=own16[k],
                                bar=max(MESH_BF16_GRAD_REL_L2, MESH_BF16_NOISE_X * own16[k]))
                        for k, e in rk[0]["grad_rel_l2_bf16"].items()}
        over16 = {k: v for k, v in bf16_by_leaf.items() if not v["mesh"] <= v["bar"]}
        line = dict(
            phase="train_mesh", case=case, arch=arch, n_layers=cfg.n_layers, d_model=cfg.d_model,
            vocab=cfg.vocab_size, layout=cfg.layout, mesh=dict(data=MESH_SHAPE[0], model=MESH_SHAPE[1]),
            ranks=len(ranks), device=f"{dev} (shared)",
            transport="the card's mailboxes (CUDA IPC), a shared-memory barrier around each round",
            mailboxes_by_rank=[r["mailboxes"] for r in ranks],
            mailbox_collectives_equal_staged=all(all(r["mailboxes_vs_staged"].values()) for r in ranks),
            params=ref["params"], param_dtype=cfg.param_dtype, remat=cfg.remat, optimizer="adamw",
            batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=steps,
            one_device_loss=ref["loss"], one_device_grad_seconds=ref["grad_seconds"],
            step1_loss_bf16_by_rank=first, step1_loss_f32_by_rank=[r["loss_f32"] for r in rk],
            step1_loss_abs_err=loss_err, step1_loss_bar=bar,
            grad_f32=g32, grad_f32_bar=MESH_GRAD_REL_L2[case], grad_bf16=g16,
            bf16_vs_f32_one_device=_worst(own16), grad_bf16_by_leaf=bf16_by_leaf,
            losses_rank0=rk[0]["losses"], skipped_by_rank=[r["skipped"] for r in rk],
            step_ms_p50_by_rank=[statistics.median(1e3 * x for x in r["step_seconds"][1:]) for r in rk],
            first_step_ms_by_rank=[1e3 * r["step_seconds"][0] for r in rk],
            tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (statistics.median(rk[0]["step_seconds"][1:])),
            collectives_per_step_by_axis_rank0=rk[0]["traffic_by_axis"][-1],
            held_bytes_by_rank=[r["held_bytes"] for r in rk],
            one_device_bytes=dict(params=ref["param_bytes"], moments=ref["moment_bytes"]),
            peak_gb_by_rank=[r["peak_gb"] for r in rk], rank_seconds=[r["seconds"] for r in rk],
            scan_launches_per_step_rank0=rk[0]["scan_launches"][-1],
            spawn_seconds=[r["spawn_seconds"] for r in ranks], ranks_seconds=ranks_s,
        )
        emit(line)
        require(all(line["mailboxes_by_rank"]), f"train_mesh: a rank without the card's mailboxes {line['mailboxes_by_rank']}")
        require(line["mailbox_collectives_equal_staged"],
                f"train_mesh: mailbox collectives off the staged ones {[r['mailboxes_vs_staged'] for r in ranks]}")
        for dt in ("bfloat16", "float32"):
            require(loss_err[dt] <= bar[dt], f"train_mesh {case}: {dt} step-1 loss off one device's: {line}")
        require(g32["max"] <= MESH_GRAD_REL_L2[case],
                f"train_mesh {case}: float32 gradient {g32['worst_leaf']} rel-L2 {g32['max']}")
        require(not over16, f"train_mesh {case}: bf16 gradients over their bars {over16}")
        require(all(max(r["skipped"]) == 0 for r in rk), f"train_mesh {case}: skipped steps {line['skipped_by_rank']}")
        require(all(all(np.isfinite(r["losses"])) for r in rk), f"train_mesh {case}: losses {line['losses_rank0']}")
        require(all(r["held_bytes"]["params"] == r["held_bytes"]["params_share"]
                    and r["held_bytes"]["moments"] == r["held_bytes"]["moments_share"] for r in rk),
                f"train_mesh {case}: resident bytes off the specs' share {line['held_bytes_by_rank']}")
        if cfg.layout == "tp":
            require(all(r["held_bytes"]["params"] < ref["param_bytes"] for r in rk),
                    f"train_mesh {case}: a rank holds the whole params")
        if n_slstm:
            require(all(s == want_scan for r in rk for s in r["scan_launches"]),
                    f"train_mesh {case}: scan launches a step {[r['scan_launches'] for r in rk]}, expected {want_scan}")
    emit(dict(phase="train_mesh_done", seconds=time.perf_counter() - t_phase))
    return {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}

def train_then_serve(cfg, params, batch, dev, seed):
    """The trained params programmed onto an ideal chip and served (6 x 16,
    max_batch 4, max_seq 256) through K1: one launch a projection of every
    forward, the logits within smollm's rel-L2 gate of the plain-matmul
    model of the same params, every replayed tick ``torch.equal`` to eager;
    the fixed batch's loss on the chip (``loss_fn`` without grad under the
    crossbar mode) within ``TRAINED_LOSS_REL_MAX`` of the plain model's: K1
    runs there at the training batch's rows, which ``kernels_phase`` holds
    to its plain version."""
    ideal = CrossbarMode(enabled=True, strict=True)
    torch.cuda.reset_peak_memory_stats()
    line, launches, eng = serve_phase("train_then_serve", cfg, params, ideal, "fast", dev, seed, False)
    # 4 attention projections, the fused wi and wo a layer, and the tied head
    expected = sum(spec.repeats * 6 * len(spec.kinds) for spec in cfg.stages) + 1
    require(
        line["projections"] == expected,
        f"train_then_serve: the chip serves {line['projections']} projections a forward, the config {expected}",
    )
    line["logits_rel_l2_vs_plain_matmul"] = reference_check(cfg, params, eng, dev)[0]
    with torch.no_grad():
        plain_loss = float(model_lib.loss_fn(params, cfg, batch))
        with crossbar_mode(eng.crossbar), eng.programmed.bind():
            chip_loss = float(model_lib.loss_fn(params, cfg, batch))
    line.update(
        fixed_batch_loss_chip=chip_loss, fixed_batch_loss_plain_matmul=plain_loss,
        fixed_batch_loss_rel=abs(chip_loss - plain_loss) / abs(plain_loss),
    )
    emit(line)
    require(
        line["logits_rel_l2_vs_plain_matmul"] < REL_L2_MAX[cfg.name],
        f"train_then_serve: the trained chip is {line['logits_rel_l2_vs_plain_matmul']} (rel-L2) from plain",
    )
    require(np.isfinite(chip_loss) and np.isfinite(plain_loss), f"train_then_serve: losses {chip_loss}, {plain_loss}")
    require(
        line["fixed_batch_loss_rel"] < TRAINED_LOSS_REL_MAX,
        f"train_then_serve: the chip's loss {chip_loss} is {line['fixed_batch_loss_rel']} (rel) from plain {plain_loss}",
    )
    graph_vs_eager("trained", eng, make_requests(cfg, seed + 6))
    del eng
    torch.cuda.empty_cache()
    return launches


def train_launcher(steps=4, more=8):
    """``python -m repro_torch.launch.train`` at full width (B = 4, S =
    256) for ``steps`` steps, then the same command to ``more``: the second
    run resumes from the first one's checkpoint."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src")] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])
    ))
    runs = []
    with tempfile.TemporaryDirectory() as d:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "smollm-360m",
               "--batch", "4", "--seq", "256", "--ckpt-dir", d]
        for n in (steps, more):
            t0 = time.perf_counter()
            r = subprocess.run(cmd + ["--steps", str(n)], capture_output=True, text=True, env=env, timeout=600)
            runs.append(dict(steps=n, rc=r.returncode, seconds=time.perf_counter() - t0, stdout=r.stdout,
                             stdout_tail=r.stdout.strip().splitlines()[-4:], stderr_tail=r.stderr.strip()[-2000:]))
        latest = latest_step(d)
    resumed = f"[train] resumed from step {steps}"
    outs = [r.pop("stdout") for r in runs]
    emit(dict(phase="train_launcher", runs=runs, latest_step=latest))
    require(all(r["rc"] == 0 for r in runs), f"train_launcher: exit codes {[r['rc'] for r in runs]}")
    require(
        "resumed" not in outs[0] and resumed in outs[1], f"train_launcher: the second run did not print '{resumed}'"
    )
    require(latest == more, f"train_launcher: newest checkpoint {latest}, expected {more}")


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true", help="fewer kernel cases, 2 layers")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    # the plain versions are the yardsticks: full float32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True, text=True, check=True)
    emit(dict(
        phase="env", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, nvcc=nvcc.stdout.strip().splitlines()[-2:],
        gpu_name_power_limit=smi, allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
    ))

    t0 = time.perf_counter()
    _build.load_library()
    emit(dict(phase="build", seconds=time.perf_counter() - t0, built=_build.last_build_seconds is not None,
              build_dir=os.path.relpath(_build.build_dir())))

    t0 = time.perf_counter()
    cases = kernels_phase(dev, args.quick) + scan_cases(dev, args.quick) + scan_train_cases(dev, args.quick)
    emit(dict(
        phase="kernels", n_cases=len(cases), all_equal=all(c["equal"] for c in cases),
        seconds=time.perf_counter() - t0,
    ))
    planned_datapaths(dev, args.quick)
    emit(dict(phase="cpu_vs_card_projections", **cpu_vs_card_projections(dev)))

    cfg = depth_config(get_config("smollm-360m"), 2 if args.quick else SERVE_CUT_LAYERS)
    params = model_lib.init_model(cfg, seed=args.seed, device=dev)

    torch.cuda.reset_peak_memory_stats()
    ideal = CrossbarMode(enabled=True, strict=True)
    line, launches_ideal, eng = serve_phase("serve_ideal", cfg, params, ideal, "fast", dev, args.seed + 1, True)
    line["logits_rel_l2_vs_plain_matmul"], ideal_logits = reference_check(cfg, params, eng, dev)
    ideal_tokens = line["tokens"]
    require(
        line["logits_rel_l2_vs_plain_matmul"] < REL_L2_MAX["smollm-360m"],
        f"ideal chip is {line['logits_rel_l2_vs_plain_matmul']} (rel-L2) away from the plain matmul model",
    )
    emit(line)
    replayed_tick_checks("ideal", eng, cfg, args.seed, {"fast_kernel": line["projections"]}, prefill=True)
    del eng
    torch.cuda.empty_cache()

    # the traffic tier on the same chip: the scheduler against the slot
    # loop, the Poisson mix with deadlines and preemption (one window of it
    # profiled), the farm and a replica's refresh
    launches_traffic = traffic_phases(cfg, params, dev, args.seed)
    gc.collect()
    torch.cuda.empty_cache()

    # the paper datapath: fast=False artifacts under the default adaptive ADC
    # (SAFE_ADAPTIVE), the same model.  Its logits are printed,
    # not held to the ideal chip's bound: on signed weights SAFE_ADAPTIVE
    # rounds the low (t, s) conversions of the biased cells away, a mean error
    # of about -0.4 output LSB a projection in the JAX package's datapath as
    # in the port's, which compounds over the layers.  The kernel is held
    # bit-identical to its plain version in the kernels phase and on every
    # projection of the cpu_vs_card_projections phase
    torch.cuda.reset_peak_memory_stats()
    line, launches_planes, eng = serve_phase(
        "serve_ideal_paper_datapath", cfg, params,
        CrossbarMode(enabled=True, strict=True, fast=False), "planes", dev, args.seed + 2, False,
    )
    # 4 attention projections, the fused wi and wo a layer, the tied head
    n_proj = 6 * cfg.n_layers + 1
    if not args.quick:  # 6 prefills + 32 decode ticks
        require(
            line["projections"] == n_proj and line["prefills"] + line["decode_ticks"] == 38
            and launches_planes["planes"] == n_proj * 38,
            f"paper datapath: {launches_planes['planes']} launches of {line['projections']} projections "
            f"in {line['prefills']} + {line['decode_ticks']} forwards, expected {n_proj} x 38",
        )
    line["logits_rel_l2_vs_plain_matmul"] = reference_check(cfg, params, eng, dev)[0]
    emit(line)
    replayed_tick_checks("paper", eng, cfg, args.seed, {"paper_mma_kernel": line["projections"]}, prefill=True)
    del eng
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    noisy = CrossbarMode(enabled=True, strict=True, device=NOISY_DEVICE)
    line, launches_noisy, eng = serve_phase("serve_noisy", cfg, params, noisy, "noisy", dev, args.seed + 1, False)
    line["logits_rel_l2_vs_plain_matmul"] = reference_check(cfg, params, eng, dev)[0]
    emit(line)
    replayed_tick_checks("noisy", eng, cfg, args.seed, {"noisy_mma_kernel": line["projections"]}, prefill=True)
    del eng
    torch.cuda.empty_cache()

    # the planned ("Newton") chip: plan_model picks Karatsuba level 2 under
    # the adaptive ADC for every projection of an ideal chip; the planned
    # datapath is exact, so its tokens and logits are the ideal chip's
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    plan = plan_model(params, tie_lm_head=True)
    plan_s = time.perf_counter() - t0
    line, launches_planned, eng = serve_phase(
        "serve_planned", cfg, params, ideal, "karatsuba2", dev, args.seed + 1, True, plan=plan,
    )
    served = {}  # planned projections a forward, by datapath (stacked layers each count)
    for name, art in eng.programmed.by_name.items():
        served[art.plan.datapath] = served.get(art.plan.datapath, 0) + (art.shape[0] if art.stacked else 1)
    line.update(
        plan_seconds=plan_s, plan_histogram=plan.datapath_histogram(), served_histogram=served,
        plan_adc_modes=sorted({p.adc_mode for p in plan.layers.values()}),
        planned_calls=launches_planned["karatsuba2"],
        vmm_kernel_launches={k: launches_planned[k] for k in VMM_COUNTERS},
        tokens_equal_ideal=line["tokens"] == ideal_tokens,
    )
    line["logits_rel_l2_vs_plain_matmul"], planned_logits = reference_check(cfg, params, eng, dev)
    line["logits_equal_ideal"] = bool(torch.equal(planned_logits, ideal_logits))
    emit(line)
    require(
        line["plan_histogram"] == {"karatsuba2": len(plan.layers)} and served == {"karatsuba2": line["projections"]},
        f"serve_planned: plan {line['plan_histogram']}, served {served}",
    )
    require(all(v == 0 for v in line["vmm_kernel_launches"].values()), f"VMM kernels ran: {launches_planned}")
    if not args.quick:  # 6 prefills + 32 decode ticks
        require(
            line["projections"] == n_proj and line["prefills"] + line["decode_ticks"] == 38
            and line["planned_calls"] == n_proj * 38,
            f"serve_planned: {line['planned_calls']} planned calls of {line['projections']} projections "
            f"in {line['prefills']} + {line['decode_ticks']} forwards, expected {n_proj} x 38",
        )
    require(line["tokens_equal_ideal"], "serve_planned: tokens differ from the ideal chip's")
    require(line["logits_equal_ideal"], "serve_planned: logits differ from the ideal chip's")
    replayed_tick_checks(
        "planned", eng, cfg, args.seed, {}, planned_per_tick={"karatsuba2": line["projections"]}, prefill=True,
    )
    del eng, ideal_logits, planned_logits
    torch.cuda.empty_cache()

    # the planned chip with stuck cells, repaired; repair's recovery on a
    # 2-layer copy; a drifting chip aged, compensated and refreshed
    launches_repaired = serve_planned_repaired(cfg, params, dev, args.seed, args.quick)
    launches_recovery = repair_recovery(cfg, params, dev, args.seed + 7)
    launches_lifecycle = lifecycle(cfg, params, dev, args.seed + 1)

    # xlstm-350m at full width and depth; only the tied head is programmed
    xcfg = get_config("xlstm-350m")
    if args.quick:
        xcfg = dataclasses.replace(xcfg, n_layers=2, stages=(StageSpec(kinds=("mlstm", "slstm"), repeats=1),))
    del params
    torch.cuda.empty_cache()
    xparams = model_lib.init_model(xcfg, seed=args.seed, device=dev)
    torch.cuda.reset_peak_memory_stats()
    line, launches_xlstm, eng = serve_phase("serve_xlstm", xcfg, xparams, ideal, "fast", dev, args.seed + 4, True)
    line["logits_rel_l2_vs_plain_matmul"] = reference_check(xcfg, xparams, eng, dev)[0]
    require(
        line["logits_rel_l2_vs_plain_matmul"] < XLSTM_REL_L2_MAX,
        f"xlstm chip is {line['logits_rel_l2_vs_plain_matmul']} (rel-L2) away from the plain matmul model",
    )
    if not args.quick:  # 6 prefills + 30 decode ticks, 12 sLSTM layers each
        require(
            line["slstm_layers"] == 12 and launches_xlstm["slstm_scan"] == 432,
            f"xlstm: {launches_xlstm['slstm_scan']} scan launches of {line['slstm_layers']} sLSTM layers, "
            f"expected 12 x 36 = 432",
        )
    emit(line)
    replayed_tick_checks("xlstm", eng, xcfg, args.seed, {SCAN_KERNEL: line["slstm_layers"], "fast_kernel": 1})
    del eng
    launches_traffic["serve_traffic_xlstm"] = serve_traffic_xlstm(xcfg, xparams, dev, args.seed)
    del xparams
    gc.collect()
    torch.cuda.empty_cache()

    by_path = dict(
        serve_ideal=launches_ideal, serve_ideal_paper_datapath=launches_planes,
        serve_noisy=launches_noisy, serve_planned=launches_planned,
        serve_planned_repaired=launches_repaired, repair_recovery=launches_recovery, lifecycle=launches_lifecycle,
        serve_xlstm=launches_xlstm, **launches_traffic,
    )
    # gemma2-9b, minitron-4b and starcoder2-3b at full width from ideal chips
    for i, (phase, arch) in enumerate(DENSE_SERVES):
        by_path[phase] = serve_dense(phase, arch, dev, args.seed + 10 * (i + 1), args.quick)
    # kimi-k2's rank-0 share of EP8 at full width; an MoE FFN of 8 experts on
    # a noisy device with one chip identity an expert; dispatch card vs CPU
    by_path["serve_kimi"] = serve_kimi(dev, args.seed + 50, args.quick)
    by_path["moe_expert_chips"] = moe_expert_chips(dev, args.seed + 51)
    moe_dispatch_card_vs_cpu(dev, args.seed + 52)
    # jamba's rank-0 share of EP4 at full width, one period: mamba blocks
    # beside attention and an MoE FFN with no shared expert
    by_path["serve_jamba"] = serve_jamba(dev, args.seed + 55, args.quick)
    # the embedding front ends: musicgen-large at full width, 24 of its 48
    # layers, pixtral-12b at full width, 4 of its 40 layers
    by_path["serve_musicgen"] = serve_embed("serve_musicgen", MUSICGEN, dev, args.seed + 56, args.quick)
    by_path["serve_pixtral"] = serve_embed("serve_pixtral", PIXTRAL, dev, args.seed + 57, args.quick)
    # deepseek-v2's MoE FFN at published widths over 4 rank processes
    by_path["moe_ranks_deepseek"] = moe_ranks_deepseek(dev, args.seed + 53)
    # deepseek-v2 served whole at depth 2 on one device, then over 4 rank
    # processes through ServingEngine(mesh=); the serving launcher
    by_path["serve_deepseek"], by_path["serve_deepseek_ranks"] = serve_deepseek(dev, args.seed + 54)
    serve_launcher()
    # training: smollm-360m at full width on the card, its trained weights
    # then served from an ideal chip, and the launcher as a user runs it
    tcfg = get_config("smollm-360m")
    if args.quick:
        tcfg = dataclasses.replace(tcfg, n_layers=2, stages=())
    trained, batch = train_smollm(tcfg, dev, args.seed + 60)
    by_path["train_then_serve"] = train_then_serve(tcfg, trained, batch, dev, args.seed + 61)
    del trained, batch
    gc.collect()
    torch.cuda.empty_cache()
    train_launcher()
    # training on the stub's frame embeddings: musicgen-large at full width
    train_musicgen(dev, args.seed + 62, args.quick)
    # training through the sLSTM scan's backward: xlstm-350m at full width and depth
    by_path["train_xlstm"] = train_xlstm(dev, args.seed + 63, args.quick)
    # training over a (data 2, model 2) mesh of 4 rank processes on the card:
    # smollm-360m and gemma2-9b tensor- and data-parallel, xlstm-350m pure DP
    by_path["train_mesh"] = train_mesh(dev, args.seed + 64, args.quick)
    # kernel launches only: the planned datapaths run no kernel of ours
    launches = {k: sum(n[k] for n in by_path.values()) for k in (*kvmm.LAUNCHES, *kscan.LAUNCHES)}
    require(all(v > 0 for v in launches.values()), f"a kernel never ran on the main path: {launches}")
    emit(dict(phase="done", seconds=time.perf_counter() - t_start))
    print(smi, flush=True)
    emit({"kernels": kernel_summary(cases, launches, by_path)})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
