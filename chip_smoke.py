#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases (each check raises, and the script then exits non-zero):
  1. device   the card's name and power limit (nvidia-smi), torch
              version, and the build of the kernel library from
              src/repro_torch/csrc/ (nvcc, sm_90a).
  2. kernels  each hand-written kernel against its plain PyTorch version
              on the card, at the main paths' shapes: fused BNN GEMM
              (bit-exact, four modes), weight packing (bit-exact), paged
              GQA attention (float32, MAX_ATTN_ERR); the ring variant at
              mixtral's shapes (C = 1 and a C = 128 causal chunk, rows
              below and above the ring's capacity and one under a block;
              MAX_ATTN_ERR) and the MLA variant at deepseek-v2-lite's
              (C = 1, C = 128 causal, a ring case; MAX_MLA_REL_ERR;
              untimed at C = 2, 4, 17 around its decode block and
              prefill tile, with a window cutting a block, and ring
              chunks over a ring that has just wrapped).  The GQA, ring
              and MLA decode walks also at kv_len around their part
              boundaries (and 0, 1, BS - 1), over rings whose visible
              arc wraps at a part boundary, under windows that cut a
              part; each row of a C = 1 call bit-equal to the same row
              run alone (B = 1); GQA and ring timed at B = 8 and B = 1.
              The speculative verify's shape, timed: C = 5 over B = 8
              with ragged kv_len and each row's real queries 1-5
              (n_valid), GQA at bnn-lm-100m's and jamba's heads, the
              ring at mixtral's over a ring whose visible arc has just
              wrapped, MLA at deepseek-v2-lite's.  Each is timed (device time, from CUDA-graph replays; and
              called from Python, eager) beside its plain version, one
              library call as a yardstick (for MLA the absorbed form in
              PyTorch calls, k_up matmul + SDPA over the latents + v_up
              matmul, with the decompressing form beside it), and its
              bound on this card; a kernel faster than its bound fails
              the run.  MLA rows add the device time of each launch by
              kernel name (torch.profiler).  The fixed-order row ops
              (row_gemm, row_norm): bit-equal to their plain versions
              at the LM heads of bnn-lm-100m (tied) and mixtral-8x7b,
              M = 1, 8, 128, each over half the vocab as a rank holds
              it too (its logits bit-equal to the whole's same
              columns), the routers of deepseek-v2-lite and mixtral,
              RMSNorm and LayerNorm at D = 768-8192; timed beside
              torch.matmul in float32 and ATen's rms_norm; untimed at
              the tiles' edges and at unaligned rows.
  3. serving  bnn-lm-100m at full width (precision="bnn", seeded random
              weights) served by the port's Engine: 16 requests, 8 of
              them submitted after 10 steps (no prefix cache, recompute
              preemption, as phases 4 and 7 too: their decode replays
              assume no adopted blocks).  The serving kernels'
              launch counts over this run must be > 0.  After phase 4,
              its first 4 prompts again under each mixed pair of impls
              (attn_impl "torch" with bnn_impl "auto", and the
              reverse): paged_attention launches 0 with fused_bnn > 0,
              then the reverse; tokens equal this run's, or part only
              after a sign flip phase 4's rule accepts (printed).
  ranks       the serving forward over several ranks (after phase 3:
              bnn-lm-100m at published width, SERVE_LAYERS (4) of its
              12 layers, phase 3's traffic; every part's one-rank
              references first, then every part in one world of 2
              ranks and one of 4 spawned by launch/mesh.spawn_ranks
              (``run_ranks``), each rank drawing the seeded weights and
              keeping its slices by the decode rules; on one card the
              ranks share it under gloo over the card's tensors, with a
              card a rank NCCL):
              (a) the tensor-parallel fused_bnn (column-parallel q, k,
              v, gate, up; row-parallel o, down: integer partial dots
              summed, then alpha) at every projection shape of
              bnn-lm-100m and 1, 8, 128 rows, at tp 2 ((1, 2) mesh)
              and 4 ((1, 4)), bit-equal to one rank's kernel; (b) two
              prompts of 512 tokens through prefill_chunk in chunks of
              128 over (1, 2) and (2, 2): every projection input and
              layer output bit-equal to one rank, the logits
              bit-equal (max |diff| 0: the LM head runs as each rank's
              vocab slice on its rows through row_gemm, whose sums do
              not depend on M or N); (c) the engine over (2, 2) serves phase 3's 16
              prompts, 64 new, on its schedule, greedy and sampled
              (C's sampling), the ranks' tokens compared at every
              step: tokens equal the one-rank engine's (served first,
              same weights and schedule); fused_bnn,
              paged_attention and binarize_pack launch on every rank;
              (d) printed: the backend and cards, per-rank peak
              memory, the collectives and DTensor wraps of a decode
              step and the host's us a wrap, tokens/s beside the
              one-rank run and the host's launch us; which collectives
              gloo runs on a card's tensors.  Then (after [ranks]'s
              bnn-lm-100m part, its weights freed) mixtral-8x7b and
              deepseek-v2-lite at published width and 2 layers, each
              rank drawing the seeded weights a layer at a time and
              keeping its slices (launch/mesh.init_on_ranks; the
              weight bytes a rank are reckoned first and printed):
              (e) prefill_chunk in chunks of 128 over (1, 2) (and
              (2, 2) for deepseek) against one rank: every tap of
              every chunk (projection inputs, MoE routing and down
              inputs, layer outputs) equal one rank's by an exact
              checksum, the logits bit-equal (max |diff| 0); mixtral
              one prompt of 4352 tokens (its 4224-token ring wraps),
              deepseek 8 rows of 256 then 4 decode steps at B = 8 (the
              MLA decode route), tapped too; a row-parallel fused_bnn
              at K = 10944 over 4 ranks (85.5 words a rank) bit-equal
              to one rank's kernel; (f) the engine serves 8 prompts,
              32 new each, greedy and sampled, over (1, 4) (mixtral:
              over (2, 2) its experts' two copies and four one-layer
              draws would take about 67 GiB of the card) and (2, 2)
              (deepseek): every rank's tokens equal one rank's; printed:
              weight bytes and peak a rank, tokens/s beside one rank's,
              a decode step's collectives, launches summed over ranks
              (fused_bnn, paged_attention_ring / paged_attention_mla
              and binarize_pack must launch).  Then (g)-(h), built
              alike, for the SSM mixer and the jamba hybrid:
              mamba2-1.3b at published width and 2 layers over (1, 2)
              and (2, 2), the jamba window (published layers 2-4:
              ssm, gqa + moe, ssm; 24 GiB of weights a rank, the two
              ranks drawing in turns) over (1, 2).  (g) prefill_chunk
              (mamba2: 8 rows of 512 tokens in one chunk; jamba: 8
              x 128), then 4 decode steps at B = 8: every tap, the
              logits and each rank's slices of the pools (the slots'
              h by heads and conv tails, jamba's K/V) bit-equal to one
              rank's; (h) the engine (mamba2 over (2, 2), jamba over
              (1, 2)) serves 8 prompts, 32 new, greedy and sampled:
              every rank's tokens one rank's; then under the JAX
              engine's defaults (slot snapshots, swap) 6 prompts on 2
              shared heads of 256 tokens, 16 new, with two forced
              preemptions (one parked at a snapshot, one mid-decode):
              one rank's tokens and counts on every rank, snapshot
              hits, the mid-decode slot back from the host bit-equal
              on every rank; printed as (e)-(f) (fused_bnn and
              binarize_pack, for jamba paged_attention too, must
              launch).  Then (i)-(j), training: bnn-lm-100m at
              published width, RANKS_TRAIN_LAYERS (6) of its 12
              layers, precision "bnn_train", over
              (2, 2) (FSDP: the params placed by the train rules, the
              ranks drawing the seeded weights), batch 8 x 256,
              microbatches 2, remat, 3 steps of launch.train, held to
              one rank's run in this process (freed before the ranks
              start): (i) step 0's loss and gradient norm within
              RANKS_TRAIN_LOSS_REL, every leaf's gradient within
              RANKS_TRAIN_GRAD_REL of its largest element, none all
              zeros where one rank's is not; launch.train's first step
              likewise; the last step taken again by one rank from the
              mesh's own checkpoint before it (launch.train writes it
              whole over the mesh) within RANKS_TRAIN_PARAM, its loss
              and norm within RANKS_TRAIN_LOSS_REL (the free runs part
              from step 2 on, as one rank's own at microbatches 1 and
              2 do: printed beside); printed: every BNN projection
              input at step 0 against one rank's (bit-equal, STE sign
              flips), a step's collectives against
              train_step_collectives' prediction, a rank's bytes as
              reckoned and its peak (beside the whole-vocab loss's,
              RANKS_TRAIN_PEAK_WHOLE_VOCAB_GIB), step ms and tokens/s
              beside one rank's; (j) the trained shards re-placed by the decode
              rules, served over (2, 2) by the engine (8 prompts, 16
              new, greedy) through the kernels: every rank's tokens
              equal one rank's engine on the gathered weights.
  4. e2e      two finished requests re-run by two routes, each once
              through the kernels and once through the plain versions,
              each attention and each FFN / MoE sublayer on the kernel
              route's input: the sign bits of every BNN projection's
              input equal (a flip is accepted only within 1e-5 x its
              row's RMS of zero, and printed), an MoE routing
              difference only at a router near-tie of the plain path
              (gap < MAX_ROUTE_GAP, printed), the outputs within
              MAX_HIDDEN_ERR elsewhere.  Route 1, a decode replay: the
              prompt in the engine's prefill chunks, then every
              generated position as a C = 1 decode step at the row,
              padded batch and table width the engine gave it; its
              kernel route's greedy tokens equal the engine's exactly.
              Route 2, teacher-forced prefill_chunk chunks of the whole
              sequence: held to the replay sublayer by sublayer (the
              first difference must be one of the accepted kinds, and
              is printed), its greedy tokens equal the engine's up to
              that point.
  serve       the server as users start it: bnn-lm-100m at published
              width, SERVE_LAYERS (4) of its 12 layers (precision
              "bnn", seeded weights; [tenants], [shards] and [spec]
              alike) through
              repro_torch.launch.serve's run functions.  24 requests:
              one of 4 system prompts of 384 tokens, then a unique
              suffix of 32-256 tokens in whole blocks (3 repeat an
              earlier prompt whole), 64 new tokens each, 8 at step 0
              and 16 after 8 steps, max_batch=8, prefill_chunk=128.
              A: greedy with the JAX engine's defaults (prefix cache,
              swap preemption) over 193 blocks: prefix hits, a
              copy-on-write copy, swap-outs and swap-ins must occur,
              and every swap-in's blocks must be bit-equal to their
              bytes at swap-out.  B: greedy, no prefix cache,
              recompute, 1025 blocks: tokens equal A's.  C: sampled
              (temperature 0.8, top-k 50, top-p 0.95, seed 1000 +
              request) under A's config; D: the same requests all at
              once under B's: tokens equal C's; C': C with a stop
              token for two requests (their token 10 in C): each ends
              at the stop token's first occurrence, equal to C up to
              there.  E: the legacy loop (batch 4, prompts of 128, 64
              new, greedy) equals the paged serve on the same prompts.
              Prints tokens/s, prefill tokens skipped, swaps and the
              bytes and ms of their copies, what sampling adds to a
              decode step, and peak memory; the serving kernels'
              launches over A-E must be > 0.  Then the sampled bits on
              the card against the CPU's: random_bits and uniform
              bit-equal at seeded (seed, index) keys, gumbel within
              GUMBEL_ULPS ulps, sample_tokens on fixed logits equal
              except at a printed near-tie (NEAR_TIE, TOP_P_ULPS).
  tenants     the policies, the engine's trace file, the streaming
              front-end and scoring, on [serve]'s weights and traffic
              under A's config, through launch.serve's run functions.
              priority (request b at priority b % 3) and slo (TENANTS:
              chat latency-class with a budget of 2048 tokens in
              flight, batch throughput-class; request b's tenant b %
              2): every request's greedy tokens equal A's; chat's
              in-flight tokens within its budget after every admission
              pass.  [trace]: the slo run with start_trace into a
              temporary file: it validates, its step records' dur_s
              sum to stats()["wall_s"] and its swap spans to the swap
              section's times (float equality), tokens equal A's; from
              its request records, at least one preemption and one
              tenant_budget defer, and a chat request preempted only
              while no batch request ran; its photonic replay report
              printed, its Perfetto export with a track per request;
              tokens/s traced against untraced (two runs each, in
              turns).  [stream]: the 24
              requests through the asyncio front-end (run_stream) with
              4 scoring requests (the 4 system prompts, each with a
              128-token suffix: 4 chunks), the last request cancelled
              after 8 streamed tokens: each uncancelled stream equals
              A's tokens; after reset_stats(flush_prefix=True) every
              block is free; scored tokens = Σ(prompt_len − 1); no
              scoring request adopted a prefix.  [score]: each scoring
              request's logprobs against a teacher-forced pass of its
              prompt through the plain versions on the card (phase 4's
              two routes) within MAX_SCORE_GAP.  fused_bnn and
              paged_attention must launch on the phase's runs.
  shards      worker roles and sharded serving, on [serve]'s weights and
              traffic with every shard under A's config, all shards on
              the one card (they step in turn), through launch.serve's
              run functions with shards and roles.  S2: two mixed
              shards, after SHARDS_MIGRATE_AT steps the first request
              in mid-decode migrates (swap-to-peer): tokens equal A's,
              both shards decode, one migration.  S2 kill: after
              SHARDS_KILL_AT steps shard 1 stops beating and reap,
              given an explicit clock, kills it: every request finishes
              on shard 0 with A's tokens.  PD (roles 1:2, one prefill
              and two decode shards), greedy, traced per shard: tokens
              equal A's, each request handed off once, the decode
              shards prefill nothing, the bytes they adopt sum to
              handoff_bytes, the three traces validate, the merged
              Perfetto export has one handoff flow per handoff, the
              replays' handoffs_in sum to the handoffs; PD sampled (C's
              sampling): tokens equal C's; PD through the asyncio
              front-end: each stream equals A's.  The slot path:
              mamba2-1.3b at published width, 8 of its 48 layers, 8 of
              its traffic's requests under 1:1 with the defaults:
              tokens equal one engine's, and handoffs carry recurrent
              slots.  Every count (handoffs, bytes, defers, steps,
              preemptions, rescues) equals the CPU run's at reduced
              width with the full width's handoff bytes and cost model
              (tests/test_torch_shards_phase*.py); fused_bnn,
              paged_attention and binarize_pack must launch.
  train       training (after [shards]): bnn-lm-100m at published width
              and precision="bnn_train" (the STE forward and backward:
              float matmuls of the signs, no kernel, as in the JAX
              package), the port's torch init from seed 0, SyntheticLM
              batches of 8 x 256 from seed 0, lr 1e-3.  (a) the card
              against the CPU at step 0, the same code and weights on 2
              of the batch's sequences: loss within 1e-4 relative, the
              global gradient norm within 1e-3, every leaf's gradient
              at cosine >= 0.999 (a miss passes only if every STE sign
              flip of a projection's input lies within 1e-5 x RMS of
              zero, printed); (b) one build_train_step step with 2
              microbatches against 1: loss and gradient norm within
              1e-5 relative, parameters within rtol 5e-3 / atol 1e-4
              (the JAX package's bound scaled to this lr); (c) remat on
              against off: each leaf's gradient within 1e-6 of its
              largest element; (d) launch.train stopped at 10 with a
              checkpoint every 5 (keep 2), resumed to 16: the last loss
              within 1e-4 relative of an uninterrupted 16-step run
              (schedule_total 16 both); (e) launch.train for 60 steps
              (warm-up 6): the mean of the last 5 losses at least 0.05
              nats below the first 5's; prints the curve, the median
              step ms as launch.train records it and training tokens/s
              beside the host's us per tiny launch, peak device memory,
              and a checkpoint's bytes and save/restore ms.  (f) the trained
              weights served at precision "bnn" (phase 3's engine
              config): 8 prompts of 64-256 tokens from the data stream
              at a step no training run reads, 32 new tokens each,
              greedy; fused_bnn, paged_attention and binarize_pack
              must launch (the summary's "train" path), and phase 4's
              re-checks pass; the share of generated tokens that are a
              Markov successor of their predecessor is printed beside
              the untrained init's (information, not a gate).
  analytic    the analytic model and the dry-run (after [train]), at
              full-width bnn-lm-100m: (a) FlopCounterMode over one
              [train] step (bnn_train, 8 x 256, remat, one microbatch)
              within 15 % of the model's flops_total - 10 params_total
              (the optimizer's elementwise term); (b) over a bf16
              prefill of 8 x 256 (the last row's head) within 15 % of
              flops_fwd; (c) roofline_terms at the H100's data-sheet
              peaks beside [train]'s median step and phase 3's decode
              step at B = 8 (timed here): bound, its dominant term,
              measured / bound, MFU (printed, no gate); (d) the
              dry-run's per-device parameter bytes on a 1x1 mesh over
              the card (a one-rank nccl group) within 1 % of the bytes
              the card's allocations of the same bf16 tree request;
              (e) the quickstart example's VDP three ways on the card
              agree, with xnor_popcount launched; (f) the dry-run's
              step record (launch/collectives.py, a step on a rank's
              meta shards under a fake group): for [ranks] (i)'s cell
              (6 layers, 8 x 256, 2 microbatches, float32 over (2, 2))
              every kind's calls and sent bytes equal (i)'s measured
              step (train_step_collectives' prediction when (i) did
              not run); for [train]'s step (8 x 256, one microbatch,
              float32, on a 1x1 mesh over the card) its argument +
              temp bytes printed beside the allocator's peak of the
              bytes requested in the same step on the same mesh,
              their ratio (the peak less what the card held besides
              the step's arguments) within ANALYTIC_STEP_RATIO and the
              temp bytes within ANALYTIC_TEMP_REL.
  spec        speculative decoding (spec_k 4, spec_ngram 3) on
              bnn-lm-100m at published width through launch.serve's
              run functions: 16 requests (8 periodic prompts, a seeded
              unit of 4-16 tokens repeated to 128-512 tokens, and 8 of
              [serve]'s), 64 new, 8 after 8 steps, under A's config,
              greedy and sampled, each beside the same traffic with
              spec_k 0: verify steps and drafts in each run, accepted
              drafts and a partly accepted verify step over the phase,
              tokens equal spec_k 0's (a request that parts is
              re-checked by phase 4's machinery, the verify's route in
              chunks of spec_k + 1 against the decode replay, and
              passes only if they part first by an accepted
              difference, printed, before its tokens do).
  5. conv     the paper's binarized-conv path (core/conv.bnn_conv2d) at
              every groups == 1 layer of VGG-small, ResNet18,
              MobileNet_V2 and ShuffleNet_V2 (photonic/workloads.py),
              batch 1, published shapes, seeded inputs and weights:
              the XNOR-popcount GEMM kernel bit-exact against its plain
              version in four modes (edge shapes around its routes and
              tiles, an ip view at an odd word offset, every route of
              its plan; then every distinct layer shape, timed in
              "dot" mode), weight/patch
              packing bit-exact at the patch shapes, the patch-packing
              kernel (patches read from the NHWC input) bit-exact
              against im2col + pack at every distinct layer input,
              timed, and at thresholds that tell its two padding rules
              apart, every layer through
              the kernels equal to its plain path and to the sign-conv
              oracle exactly (launch counts over that run must be > 0;
              device times summed per network), and a chained binary
              VGG-small stack conv2..conv6 equal on all three routes.
  6. photonic the engine's modelled OXBNN section from the serving run
              and the simulator's Fig. 7 comparison — modelled numbers
              of the photonic accelerators, not measurements.
  7. families mixtral-8x7b (GQA, sliding-window ring, MoE) and
              deepseek-v2-lite-16b (MLA latents, MoE with shared
              experts, a leading dense layer) at their published widths,
              2 layers each (PHASE7_LAYERS; 4 until PR 29), seeded
              random weights, one after the other:
              8 requests each (mixtral: two prompts of 4400 and 4700
              tokens, longer than its ring, the rest 64-512 tokens), 32
              new tokens, 4 submitted after 4 steps; the ring must wrap
              (ring_reuses > 0), each path's kernels must launch, and
              finished requests go through the phase-4 check (mixtral:
              the first, whose ring wrapped, and the shortest;
              deepseek: all eight).  Prints tokens/s, ring reuses and
              peak memory.  Then mamba2-1.3b (the Mamba-2 SSD mixer
              over recurrent slots, no FFN) at its published widths,
              2 of its 48 layers: 16 requests of 16-1500 tokens, 32
              new tokens, 4 submitted after 4 steps, 5 slots under a
              batch of 8, so admissions wait for a slot and released
              slots are handed out again (zeroed); the longest request
              and the first on a reused slot are re-checked (the
              replay in the engine's slot; the chunked re-check runs
              the SSD dual form where the engine ran the recurrence,
              and prints how far apart they are).  Phase 2 checks and
              times the
              fused BNN GEMM at mamba2's in_proj (N = 8512, K = 2048)
              and out_proj (N = 2048, K = 4096) at M = 1, 8, 128, and
              each weight's pack.  Last, with everything before it
              freed, the jamba hybrid (jamba-1.5-large-398b) at
              published width, the window of published layers 2-4
              ((ssm, dense), (gqa, moe), (ssm, dense); ≈ 52 GB of
              float32 weights): 12 requests of 16-1500 tokens, 32 new
              tokens, 4 submitted after 4 steps, 5 recurrent slots and
              256 blocks under a batch of 8.  All 5 slots must be in
              use at once; from the cache's recorded admissions and the
              trace's no_blocks defers, one admission must wait for a
              slot while the blocks were free, and one must find a
              slot but too few blocks and give the slot back.  The
              longest request and the first that gave a slot back are
              re-checked, the replay in the engine's own slot and
              block table.  Phase 2 checks and times the three kernels
              of its path at its shapes: the fused BNN GEMM at every
              projection (in_proj N = 32928, out_proj, q/o, k/v, the
              FFN's and each expert's w1/w3 and w2) at M = 1, 8, 128
              and an expert's routed rows at prefill (M = 16), the pack
              of in_proj's weight and of an expert matrix, and paged
              GQA at H = 64, Hkv = 8, Dh = 128 (B = 8 and 1, C = 1 and
              128; kv_len around the decode walk's parts, C around its
              tile).  Each family's traffic carries 2 periodic prompts
              (mixtral, deepseek, mamba2): after its phase run, the
              same traffic with spec_k 4 must give the phase run's
              tokens (or part only as [spec] allows), with verify
              steps, mixtral's ring wrapping, mamba2's slots repaired.
              Then the JAX defaults (prefix cache with slot snapshots,
              swap) against a control without them (no prefix cache,
              recompute), equal tokens: mamba2 (2 layers) on 12
              requests over 3 shared heads of 256 tokens (two 128-token
              chunks) with suffixes of 16-512, 2 whole repeats, 32 new,
              4 after 4 steps, 5 slots, and two forced preemptions of
              the youngest request (one parked at a snapshot in the
              index: re-adopted; one mid-decode: a host trip, its slot
              restored bit-equal); the jamba window on 12 such requests
              (suffixes 16-608 for the first 6, 608-1200 after) with 5
              slots and 256 blocks: both members skip the same tokens
              and both admission shortages occur.  Snapshot hits and
              skipped prefill tokens > 0 in both.

The line before the last is a JSON object with every kernel's launches
on its paths (serving, its two mixed-impl runs, ranks (summed over the
ranks), serve, tenants, shards,
train, analytic, conv, spec, mixtral, deepseek, mamba2, jamba, each
family's speculative run and the defaults pairs), error, times and
bound; the last line is the run's verdict with the
device.
Imports nothing of JAX or the JAX package.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
L2_BYTES = 50 * 2 ** 20          # H100 L2 cache (NVIDIA data sheet)
INT8_OPS_PER_S = 1979e12         # densest documented integer rate: int8
                                 # tensor cores (the binary mma's is
                                 # measured: b1_ops_per_s)
FP32_FLOPS_PER_S = 67e12         # float32 outside the tensor cores
TF32X3_FLOPS_PER_S = 495e12 / 3  # float32 work as 3xTF32 tensor-core
                                 # products: the TF32 data-sheet rate / 3
MAX_ATTN_ERR = 1e-4              # |kernel - plain| for attention outputs
MAX_MLA_REL_ERR = 1e-4           # MLA: |kernel - plain| <= this x
                                 # max(1, max|plain|); the kernel's absorbed
                                 # order sums the R = 512 latent terms
                                 # differently
MAX_ROUTE_GAP = 1e-6             # an MoE routing difference is rounding only
                                 # where the plain path's k-th and (k+1)-th
                                 # router probabilities are closer than this
MAX_HIDDEN_ERR = 1e-4            # |kernels - plain| per layer hidden state
FLIP_RMS_FRACTION = 1e-5         # a sign flip closer to 0 than this x RMS
FLIP_POSITIONS: list[int] = []   # every accepted flip's position, in order
                                 # is rounding, not a fault
MODES = ("bitcount", "dot", "dot_scaled", "binary_act")   # BNN GEMM epilogues


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of one call: ``iters`` calls captured in a CUDA
    graph, replayed between two CUDA events.  A replay issues the
    kernels with no per-call host work, so this is the device's time
    (host launch cost is what ``eager_ms`` adds)."""
    fn()                                    # build, allocate, warm up
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def eager_ms(fn, iters: int = 20) -> float:
    """Mean time of one call issued from Python, back to back: the host's
    launch cost where it exceeds the device time."""
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


def launch_ms(fn, iters: int = 10) -> dict[str, float]:
    """Device time per call of each kernel ``fn`` launches, by kernel
    name, from a ``torch.profiler`` trace of ``iters`` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and \
                not getattr(ev, "is_user_annotation", False):
            out[ev.name] = out.get(ev.name, 0.0) + \
                ev.time_range.elapsed_us() / 1e3 / iters
    if not out:
        raise AssertionError("the profiler traced no kernel on the card")
    return out


def cold_inputs(x: torch.Tensor):
    """A callable that returns ``x`` or one of its copies in turn: where
    ``x`` is over an eighth of the L2 cache, enough copies that the
    replays of ``time_ms`` read it from device memory, as a first use
    does, not from L2."""
    n = x.numel() * x.element_size()
    copies = [x]
    if n > L2_BYTES // 8:
        copies += [x.clone() for _ in range(-(-2 * L2_BYTES // n))]
    it = itertools.cycle(copies)
    return lambda: next(it)


def check_bound(row: dict, what: str) -> None:
    """A kernel faster than its bound means a wrong bound: refuse it."""
    if not row["bound_ms"] <= row["ms"]:
        raise AssertionError(f"{what} {row['shape']}: {row['ms']:.5g} ms "
                             f"beats its bound {row['bound_ms']:.5g} ms")


def warm_clocks(dev, seconds: float = 1.0):
    """Keep the card busy for a moment so that timings start at its
    working clocks, not its idle ones."""
    a = torch.randn(4096, 4096, device=dev)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        a = torch.tanh(a @ a)
    torch.cuda.synchronize()


@functools.lru_cache(maxsize=None)
def b1_ops_per_s(dev) -> float:
    """The binary tensor-core product's rate on this card, measured once:
    a tight loop of independent mma.m16n8k256.b1 (AND + popcount) in 4
    blocks of 8 warps per SM (csrc/fused_bnn.cu ``fb_b1_mma_rate``),
    2 x 16 x 8 x 256 operations an mma, as int8's 2 M N K."""
    from repro_torch.kernels import _lib
    blocks = 4 * torch.cuda.get_device_properties(dev).multi_processor_count
    iters, reps = 4096, 5
    out = torch.empty(blocks * 256, dtype=torch.int32, device=dev)
    probe = lambda: _lib.launch("fb_b1_mma_rate", out.device, _lib.ptr(out),
                                blocks, iters)
    probe()                                      # build, warm up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        probe()
    end.record()
    torch.cuda.synchronize()
    n_ops = reps * blocks * 8 * iters * 8 * 2 * 16 * 8 * 256
    return n_ops / (start.elapsed_time(end) / 1e3)


def xnor_gemm_ops_per_s(dev) -> float:
    """The rate of an XNOR-popcount GEMM's bound: the faster of the int8
    data-sheet rate and the binary mma's measured one."""
    return max(INT8_OPS_PER_S, b1_ops_per_s(dev))


def bound_ms(n_bytes: float, n_ops: float, ops_rate: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------- phase 1


def phase_device() -> str:
    from repro_torch.kernels import _lib
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    _lib.LIBRARY.load()
    log(f"[device] kernel library {_lib.LIBRARY.path.name} built in "
        f"{_lib.LIBRARY.build_s:.1f} s")
    dev = torch.device("cuda")
    warm_clocks(dev)
    log(f"[device] binary mma.m16n8k256 rate {b1_ops_per_s(dev) / 1e12:.1f} "
        f"TOP/s measured (int8 data sheet {INT8_OPS_PER_S / 1e12:.0f}); "
        f"XNOR GEMM bounds use {xnor_gemm_ops_per_s(dev) / 1e12:.1f}")
    return smi


# --------------------------------------------------------------- phase 2
#
# Each check builds the main path's inputs, holds the kernel against its
# plain version, and returns a row for the kernel table.


def check_fused_bnn(dev, m: int, n: int, s: int, gen: torch.Generator,
                    timed: bool) -> dict:
    """The kernel bit-exact against the plain version in all four modes;
    timed in "dot_scaled"."""
    from repro_torch.kernels import binarize_pack as bp, fused_bnn as fb
    x = torch.randn(m, s, device=dev, generator=gen)
    w = torch.randn(s, n, device=dev, generator=gen)
    wp = bp.binarize_pack_torch(w.t().contiguous())
    alpha = torch.rand(n, device=dev, generator=gen) + 0.5
    for mode in MODES:
        got = fb.fused_bnn_matmul(x, wp, s, mode=mode, alpha=alpha)
        want = fb.fused_bnn_matmul_torch(x, wp, s, mode=mode, alpha=alpha)
        torch.cuda.synchronize()
        if got.dtype != want.dtype or not torch.equal(got, want):
            bad = (got.float() != want.float()).sum().item()
            raise AssertionError(f"fused_bnn M={m} N={n} S={s} {mode}: {bad} "
                                 "elements differ from the plain version")
    row = {"shape": f"M={m} N={n} S={s}", "max_abs_err": 0.0}
    if timed:
        kw = -(-s // 32)
        n_bytes = m * s * 4 + n * kw * 4 + n * 4 + m * n * 4
        row["bound_ms"], row["bound_by"] = bound_ms(
            n_bytes, 2 * m * n * s, xnor_gemm_ops_per_s(dev))
        run = lambda: fb.fused_bnn_matmul(x, wp, s, mode="dot_scaled",
                                          alpha=alpha)
        row["ms"] = time_ms(run)
        row["eager_ms"] = eager_ms(run)
        row["plain_ms"] = time_ms(lambda: fb.fused_bnn_matmul_torch(
            x, wp, s, mode="dot_scaled", alpha=alpha), iters=3)
        xs = torch.where(x >= 0, 1.0, -1.0).to(torch.bfloat16)
        ws = torch.where(w >= 0, 1.0, -1.0).to(torch.bfloat16)
        row["library_ms"] = time_ms(lambda: torch.matmul(xs, ws))
        row["beats_library"] = row["ms"] < row["library_ms"]
        check_bound(row, "fused_bnn")
    return row


def check_binarize_pack(dev, m: int, s: int, gen: torch.Generator,
                        timed: bool) -> dict:
    from repro_torch.kernels import binarize_pack as bp
    x = torch.randn(m, s, device=dev, generator=gen)
    got = bp.binarize_pack(x)
    want = bp.binarize_pack_torch(x)
    if not torch.equal(got, want):
        raise AssertionError(f"binarize_pack {m}x{s}: "
                             f"{(got != want).sum().item()} words differ")
    row = {"shape": f"M={m} S={s}", "max_abs_err": 0.0}
    if timed:
        kw = -(-s // 32)
        row["bound_ms"], row["bound_by"] = bound_ms(m * s * 4 + m * kw * 4,
                                                    m * s, INT8_OPS_PER_S)
        xs = cold_inputs(x)
        row["ms"] = time_ms(lambda: bp.binarize_pack(xs()))
        row["eager_ms"] = eager_ms(lambda: bp.binarize_pack(xs()))
        row["plain_ms"] = time_ms(lambda: bp.binarize_pack_torch(x), iters=5)
        row["library_ms"] = None
        check_bound(row, "binarize_pack")
    return row


def check_pack_patches(dev, x: torch.Tensor, k: int, stride: int,
                       padding: str, timed: bool,
                       threshold: float = 0.0) -> dict:
    """The patch-packing kernel bit-exact against its plain version (the
    patch matrix written out, then packed) on the NHWC input ``x`` of a
    k x k conv; timed against its byte bound: the input read once, the
    words written once."""
    from repro_torch.kernels import binarize_pack as bp
    args = (x, k, k, stride, padding)
    got = bp.pack_patches(*args, threshold=threshold)
    want = bp.pack_patches_torch(*args, threshold=threshold)
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"pack_patches {tuple(x.shape)} k={k} "
                             f"stride={stride} {padding} thr={threshold}: "
                             f"words differ from the plain version")
    row = {"shape": f"x={tuple(x.shape)} k={k} stride={stride} {padding}",
           "M": got.shape[0], "S": k * k * x.shape[-1], "max_abs_err": 0.0}
    if timed:
        n_bytes = x.numel() * 4 + got.numel() * 4
        row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, got.numel() * 32,
                                                    INT8_OPS_PER_S)
        run = lambda: bp.pack_patches(*args)
        row["ms"] = time_ms(run)
        row["eager_ms"] = eager_ms(run)
        row["plain_ms"] = time_ms(lambda: bp.pack_patches_torch(*args),
                                  iters=5)
        row["library_ms"] = None
        check_bound(row, "pack_patches")
    return row


def _check_rows_alone(got: torch.Tensor, alone, what: str) -> None:
    """The batch-invariance gate: row i of a batched call ``got`` equals,
    bit for bit, ``alone(i)``, the same row run as a batch of one."""
    for i in range(got.shape[0]):
        if not torch.equal(alone(i), got[i:i + 1]):
            raise AssertionError(f"{what}: row {i} differs from the same "
                                 "row run alone (B = 1)")


def check_paged_attention(dev, b: int, c: int, h: int, hkv: int, dh: int,
                          bs: int, max_len: int, gen: torch.Generator,
                          timed: bool, window: int | None = None,
                          lens=None, n_valid=None) -> dict:
    """Ragged kv_len up to ``max_len`` over shuffled physical blocks (the
    first row at it; with B > 1 the last row has kv_len 0: fully
    masked), or the given ``lens``.  C > 1 runs causal, with each row's
    queries ending at its last key (a prefill chunk), or, given per-row
    ``n_valid``, a speculative verify: row i's chunk starts at kv_len -
    n_valid[i] and its queries past n_valid[i] are padding.  At C = 1
    each row of the batch must equal, bit for bit, the same row run
    alone."""
    from repro_torch.kernels import paged_attention as pa
    mb = -(-max_len // bs)
    rng = np.random.default_rng(7)
    if lens is None:
        lens = rng.integers(c, max_len + 1, size=b)
        lens[0] = max_len
        if b > 1:
            lens[-1] = 0
    lens = np.asarray(lens)
    b = len(lens)
    nb = b * mb + 1
    table = (1 + rng.permutation(b * mb)).reshape(b, mb).astype(np.int32)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    if n_valid is not None:
        q_off = kv_len - torch.tensor(n_valid, dtype=torch.int32, device=dev)
    else:
        q_off = (kv_len - c).clamp_min(0) if c > 1 else kv_len - 1
    q_off = q_off.to(torch.int32).contiguous()
    tab = torch.tensor(table, device=dev)
    q = torch.randn(b, c, h, dh, device=dev, generator=gen)
    kp = torch.randn(nb, bs, hkv, dh, device=dev, generator=gen)
    vp = torch.randn(nb, bs, hkv, dh, device=dev, generator=gen)
    causal = c > 1
    kw = dict(kv_len=kv_len, q_offset=q_off, causal=causal, window=window)
    got = pa.paged_attention(q, kp, vp, tab, **kw)
    want = pa.paged_attention_torch(q, kp, vp, tab, **kw)
    err = (got - want).abs().max().item()
    if not err <= MAX_ATTN_ERR:
        raise AssertionError(f"paged_attention B={b} C={c}: max abs err "
                             f"{err:.3g} > {MAX_ATTN_ERR}")
    for i in np.flatnonzero(lens == 0):
        if got[i].abs().max().item() != 0.0:
            raise AssertionError("paged_attention: fully-masked row is not "
                                 "zero")
    if c == 1:
        _check_rows_alone(
            got, lambda i: pa.paged_attention(
                q[i:i + 1], kp, vp, tab[i:i + 1], kv_len=kv_len[i:i + 1],
                q_offset=q_off[i:i + 1], causal=causal, window=window),
            f"paged_attention B={b} C=1")
    row = {"shape": f"B={b} C={c} H={h} Hkv={hkv} Dh={dh} BS={bs} "
                    f"kv_len<={max_len}"
                    + ("" if n_valid is None else
                       f" n_valid={list(n_valid)}"), "max_abs_err": err}
    if timed:
        # what this run's data needs: each row's visible keys once
        qpos = q_off.long()[:, None] + torch.arange(c, device=dev)
        vis = torch.minimum(qpos + 1, kv_len.long()[:, None]) if causal \
            else kv_len.long()[:, None].expand(b, c)
        vis = vis.clamp_min(0)
        n_keys = int(kv_len.clamp_min(0).sum())
        n_bytes = (2 * n_keys * hkv * dh + 2 * q.numel()) * 4 + tab.numel() * 4
        n_ops = 4 * int(vis.sum()) * h * dh
        row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, n_ops,
                                                    FP32_FLOPS_PER_S)
        run = lambda: pa.paged_attention(q, kp, vp, tab, **kw)
        row["ms"] = time_ms(run)
        row["eager_ms"] = eager_ms(run)
        row["plain_ms"] = time_ms(
            lambda: pa.paged_attention_torch(q, kp, vp, tab, **kw), iters=5)
        # yardstick: SDPA over the already-gathered K/V (heads repeated
        # for GQA) with a bool mask
        keys = kp[tab.long()].reshape(b, mb * bs, hkv, dh)
        vals = vp[tab.long()].reshape(b, mb * bs, hkv, dh)
        keys = keys.repeat_interleave(h // hkv, dim=2).transpose(1, 2)
        vals = vals.repeat_interleave(h // hkv, dim=2).transpose(1, 2)
        kpos = torch.arange(mb * bs, device=dev)
        mask = kpos[None, None] < kv_len.long()[:, None, None]
        if causal:
            mask = mask & (qpos[:, :, None] >= kpos)
        mask = mask[:, None].expand(b, h, c, mb * bs)
        qt = q.transpose(1, 2)
        fsdpa = torch.nn.functional.scaled_dot_product_attention
        row["library_ms"] = time_ms(lambda: fsdpa(qt, keys, vals,
                                                  attn_mask=mask))
        row["beats_library"] = row["ms"] < row["library_ms"]
        check_bound(row, "paged_attention")
    return row


# (M, N, S) of the families' BNN GEMMs, timed in phase 2; an expert's
# M is the rows routed to it, spread over 1-128 at prefill and 1-2 at
# decode (chip_profile.py's fused_bnn_shapes)
FAMILY_GEMMS = (
    (128, 4096, 4096), (128, 1024, 4096),     # mixtral q/o, k/v
    (128, 14336, 4096), (32, 14336, 4096),    # an expert's w1/w3: prefill
    (32, 4096, 14336),                        # ... w2: prefill
    (1, 14336, 4096), (2, 4096, 14336),       # w1/w3, w2: decode
    (12, 1408, 2048), (1, 2048, 1408),        # deepseek expert w1, w2
)


# mamba2-1.3b's BNN weights (K, N): in_proj (2 d_inner + 2 state + heads
# = 8512 outputs) and out_proj; and the reduced config's (d_model 64)
MAMBA2_WEIGHTS = {"in_proj": (2048, 8512), "out_proj": (4096, 2048)}
MAMBA2_REDUCED_WEIGHTS = ((64, 304), (128, 64))


# jamba-1.5-large's BNN weights (K, N) in the served window (layers 2-4):
# SSD in_proj (2 d_inner + 2 state + heads = 32928 outputs, a tail at
# every N tile) and out_proj, attention q/o and k/v, the dense FFN's and
# each expert's w1/w3 and w2
JAMBA_WEIGHTS = {"in_proj": (8192, 32928), "out_proj": (16384, 8192),
                 "q/o": (8192, 8192), "k/v": (8192, 1024),
                 "w1/w3": (8192, 24576), "w2": (24576, 8192)}
# an expert's routed rows in a 128-token prefill chunk (top-2 of 16: 16
# on average); at decode (8 rows: 1) they are the M = 1 rows above
JAMBA_EXPERT_PREFILL_M = 16


def phase_kernels(dev, cfg) -> dict[str, list[dict]]:
    warm_clocks(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    d, f = cfg.d_model, cfg.d_ff
    hd = cfg.n_heads * cfg.head_dim
    rows: dict[str, list[dict]] = {"fused_bnn": [], "binarize_pack": [],
                                   "paged_attention": []}
    for m in (1, 8, 128):
        for n, s in ((hd, d), (f, d), (d, f), (d, 100)):
            rows["fused_bnn"].append(check_fused_bnn(dev, m, n, s, gen, True))
    weights = {"q": (d, hd), "k": (d, cfg.n_kv_heads * cfg.head_dim),
               "v": (d, cfg.n_kv_heads * cfg.head_dim), "o": (hd, d),
               "gate": (d, f), "up": (d, f), "down": (f, d)}
    for name, (k_in, n_out) in weights.items():
        # a weight (K, N) packs as its transpose (N, K)
        rows["binarize_pack"].append(
            {"weight": name, **check_binarize_pack(dev, n_out, k_in, gen, True)})
    for c in (1, 128):
        rows["paged_attention"].append(check_paged_attention(
            dev, 8, c, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 16, 1024,
            gen, True))
    # the engine's smallest decode bucket: one row over the whole table
    rows["paged_attention"].append(check_paged_attention(
        dev, 1, 1, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 16, 1024, gen,
        True))
    # the speculative verify ([spec]): C = spec_k + 1 = 5 over 8 rows,
    # ragged kv_len, each row's real queries 1-5
    rows["paged_attention"].append(check_paged_attention(
        dev, 8, VERIFY_C, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 16,
        1024, gen, True, lens=VERIFY_LENS, n_valid=VERIFY_N_VALID))
    # the served families' widths (section "families"): mixtral's
    # attention projections at a prefill chunk, its experts' w1/w3 and w2
    # at the rows an expert gets in a prefill step and at decode, and a
    # deepseek-v2-lite expert's
    for m, n, s in FAMILY_GEMMS:
        rows["fused_bnn"].append(check_fused_bnn(dev, m, n, s, gen, True))
    # mamba2-1.3b's in_proj (N = 8512, not a multiple of any N tile) and
    # out_proj at a decode row, a full decode bucket and a prefill chunk,
    # and each weight's pack; the reduced config's untimed
    for name, (k_in, n_out) in MAMBA2_WEIGHTS.items():
        for m in (1, 8, 128):
            rows["fused_bnn"].append({"weight": f"mamba2 {name}",
                                      **check_fused_bnn(dev, m, n_out, k_in,
                                                        gen, True)})
        rows["binarize_pack"].append(
            {"weight": f"mamba2 {name}",
             **check_binarize_pack(dev, n_out, k_in, gen, True)})
    for k_in, n_out in MAMBA2_REDUCED_WEIGHTS:
        for m in (1, 8, 128):
            check_fused_bnn(dev, m, n_out, k_in, gen, False)
    # edges, untimed and bit-exact: row counts around both paths' tiles,
    # N not a multiple of any tile, S around word and tile boundaries
    for m in (1, 2, 3, 17, 33, 127, 129, 257):
        for s in (100, 4095, 4097, 14336):
            check_fused_bnn(dev, m, 77, s, gen, False)
    check_paged_attention(dev, 3, 4, 12, 4, 64, 16, 100, gen, False)
    # the decode walk's parts: kv_len one short of, at and one past a part
    # boundary (k * DECODE_PART_KEYS), 0, 1 and BS - 1; at bnn-lm-100m's
    # heads and at G = 4, Dh = 128, with and without a window that cuts
    # a part
    from repro_torch.kernels.paged_attention import DECODE_PART_KEYS as kp
    edges = (kp - 1, kp, kp + 1, 3 * kp - 1, 3 * kp, 3 * kp + 1, 0, 1, 15)
    for h, hkv, dh, window in ((12, 12, 64, None), (16, 4, 128, None),
                               (16, 4, 128, 300)):
        check_paged_attention(dev, 0, 1, h, hkv, dh, 16, 1024, gen, False,
                              window=window, lens=edges)
    check_paged_attention(dev, 3, 4, 4, 2, 16, 4, 40, gen, False, window=5)
    # attention around the decode tile (R = C * G = 16) and the prefill
    # tile (64 rows): G = 4 at C = 4, 5, 17, 128, Dh = 128 and 64, with a
    # window that cuts a block and a key tile mid-way
    for c in (4, 5, 17, 128):
        for dh, window in ((128, None), (128, 100), (64, 37)):
            check_paged_attention(dev, 3, c, 16, 4, dh, 16, 700, gen, False,
                                  window=window)
    check_paged_attention(dev, 3, 17, 12, 12, 64, 16, 300, gen, False)
    # a head width the tiled path is not built for: R = 68 query rows
    # take the decode walk, 16 rows a block
    for window in (None, 37):
        check_paged_attention(dev, 3, 17, 16, 4, 32, 16, 300, gen, False,
                              window=window)
    for name, rs in rows.items():
        for r in rs:
            log(f"[kernels] {name} {json.dumps(r)}")
    return rows


def phase_jamba_kernels(dev, rows: dict[str, list[dict]]) -> None:
    """The three kernels of the jamba window's path at its shapes, each
    against its plain version, timed; rows appended to ``rows``: the
    fused BNN GEMM at every projection (M = 1, 8, 128) and an expert's
    routed rows at prefill, the pack of in_proj's weight and of one
    expert matrix, and paged GQA (ring off) at H = 64, Hkv = 8 (group
    8), Dh = 128 over a 2048-token table, B = 8 and 1, C = 1 and 128;
    untimed, kv_len around the decode walk's parts and C around its
    16-row tile (C * G = 16, 24, 136)."""
    gen = torch.Generator(device=dev).manual_seed(3)
    new = {k: [] for k in ("fused_bnn", "binarize_pack", "paged_attention")}
    for name, (k_in, n_out) in JAMBA_WEIGHTS.items():
        ms = (1, 8, 128) + ((JAMBA_EXPERT_PREFILL_M,) if name in
                            ("w1/w3", "w2") else ())
        for m in ms:
            new["fused_bnn"].append({"weight": f"jamba {name}",
                                     **check_fused_bnn(dev, m, n_out, k_in,
                                                       gen, True)})
    for name in ("in_proj", "w1/w3"):
        k_in, n_out = JAMBA_WEIGHTS[name]
        new["binarize_pack"].append(
            {"weight": f"jamba {name}",
             **check_binarize_pack(dev, n_out, k_in, gen, True)})
    for b, c in ((8, 1), (1, 1), (8, 128), (1, 128)):
        new["paged_attention"].append(
            {"model": "jamba", **check_paged_attention(
                dev, b, c, 64, 8, 128, 16, 2048, gen, True)})
    new["paged_attention"].append(
        {"model": "jamba", **check_paged_attention(
            dev, 8, VERIFY_C, 64, 8, 128, 16, 2048, gen, True,
            lens=[2 * n for n in VERIFY_LENS], n_valid=VERIFY_N_VALID)})
    from repro_torch.kernels.paged_attention import DECODE_PART_KEYS as kp
    check_paged_attention(dev, 0, 1, 64, 8, 128, 16, 2048, gen, False,
                          lens=(kp - 1, kp, kp + 1, 4 * kp - 1, 4 * kp,
                                4 * kp + 1, 7 * kp + 1, 2047, 2048, 0, 1,
                                15))
    for c in (2, 3, 17):
        check_paged_attention(dev, 3, c, 64, 8, 128, 16, 700, gen, False)
    for name, rs in new.items():
        for r in rs:
            log(f"[kernels] {name} {json.dumps(r)}")
        rows[name] += rs


# the fixed-order row-wise kernels' main-path shapes: the LM heads (K, N)
# of bnn-lm-100m (tied: the embedding read transposed), mixtral-8x7b and
# jamba-1.5-large (2.1 GB of float32), the routers of deepseek-v2-lite,
# mixtral-8x7b and jamba-1.5-large, and the norms' widths (bnn-lm-100m,
# deepseek-v2-lite, mixtral, jamba)
ROW_HEADS = {"bnn-lm-100m": (768, 32000, True),
             "mixtral-8x7b": (4096, 32000, False),
             "jamba-1.5-large": (8192, 65536, False)}
ROW_ROUTERS = {"deepseek-v2-lite": (2048, 64), "mixtral-8x7b": (4096, 8),
               "jamba-1.5-large": (8192, 16)}
ROW_NORM_D = (768, 2048, 4096, 8192)
ROW_M = (1, 8, 128)


def _vs(row: dict) -> dict:
    """A timed row's ratios: ms over the library call's, bound over ms."""
    row["vs_library"] = row["ms"] / row["library_ms"]
    row["of_bound"] = row["bound_ms"] / row["ms"]
    return row


def _row_weight(dev, k: int, n: int, gen, tied: bool) -> torch.Tensor:
    """A (K, N) weight, or the tied head's layout: an (N, K) embedding
    read transposed (strides (1, K))."""
    if tied:
        return (torch.randn(n, k, device=dev, generator=gen)
                / k ** 0.5).t()
    return torch.randn(k, n, device=dev, generator=gen) / k ** 0.5


def check_row_gemm(dev, m: int, k: int, n: int, gen: torch.Generator,
                   timed: bool, tied: bool = False, what: str = "") -> list:
    """The kernel bit-equal to its plain version on the whole (K, N)
    weight and on its second half of the columns as a rank holds it (a
    contiguous shard; of the tied head the embedding's second half of
    rows, transposed), the half's outputs bit-equal to the whole's same
    columns; with ``timed`` a row for each, timed beside the plain
    version, ``torch.matmul`` in float32 (TF32 off) and the bound."""
    from repro_torch.kernels import rowwise as rw
    x = torch.randn(m, k, device=dev, generator=gen)
    w = _row_weight(dev, k, n, gen, tied)
    half = (w.t()[n // 2:].contiguous().t() if tied
            else w[:, n // 2:].contiguous())
    out = []
    got = {}
    for part, wt in (("whole", w), ("half", half)):
        got[part] = rw.row_gemm_cuda(x, wt)
        want = rw.row_gemm_torch(x, wt)
        torch.cuda.synchronize()
        if not torch.equal(got[part], want):
            bad = (got[part] != want).sum().item()
            err = (got[part] - want).abs().max().item()
            raise AssertionError(
                f"row_gemm {what} M={m} K={k} N={wt.shape[1]} {part}: {bad} "
                f"elements differ from the plain version (max {err:.3e})")
        if not timed:
            continue
        nn = wt.shape[1]
        row = {"shape": f"M={m} K={k} N={nn}", "weight": what,
               "layout": "tied (embedding transposed)" if tied else "dense",
               "max_abs_err": 0.0}
        row["bound_ms"], row["bound_by"] = bound_ms(
            (m * k + k * nn + m * nn) * 4, 2 * m * nn * k, FP32_FLOPS_PER_S)
        row["ms"] = time_ms(lambda: rw.row_gemm_cuda(x, wt))
        row["eager_ms"] = eager_ms(lambda: rw.row_gemm_cuda(x, wt))
        row["plain_ms"] = time_ms(lambda: rw.row_gemm_torch(x, wt),
                                  iters=1 if k * m > 65536 else 3)
        row["library_ms"] = time_ms(lambda: torch.matmul(x, wt))
        row["library"] = "torch.matmul float32 (TF32 off)"
        check_bound(row, "row_gemm")
        out.append(_vs(row))
    if not torch.equal(got["half"], got["whole"][:, n // 2:]):
        raise AssertionError(f"row_gemm {what} M={m} K={k} N={n}: the half "
                             "vocab's logits differ from the whole's")
    return out


def check_row_norm(dev, m: int, d: int, gen: torch.Generator, timed: bool,
                   misaligned: bool = False) -> dict:
    """RMSNorm and LayerNorm (with bias) bit-equal to the plain version
    (``misaligned``: x 4 bytes off 16, the scalar loads); RMSNorm timed
    beside the plain version, ATen's ``rms_norm`` and the bound."""
    from repro_torch.kernels import rowwise as rw
    flat = torch.randn(m * d + 1, device=dev, generator=gen) * 3 + 0.5
    x = flat[1:].view(m, d) if misaligned else flat[:-1].view(m, d)
    scale = 1 + 0.1 * torch.randn(d, device=dev, generator=gen)
    bias = 0.1 * torch.randn(d, device=dev, generator=gen)
    for layer in (False, True):
        b = bias if layer else None
        eps = 1e-5 if layer else 1e-6
        got = rw.row_norm_cuda(x, scale, b, eps, layer)
        want = rw.row_norm_torch(x, scale, b, eps, layer)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = (got != want).sum().item()
            err = (got - want).abs().max().item()
            raise AssertionError(
                f"row_norm M={m} D={d} {'layernorm' if layer else 'rmsnorm'}"
                f": {bad} elements differ from the plain version "
                f"(max {err:.3e})")
    row = {"shape": f"M={m} D={d}", "norm": "rmsnorm", "max_abs_err": 0.0}
    if timed:
        row["bound_ms"], row["bound_by"] = bound_ms(
            (2 * m * d + d) * 4, 4 * m * d, FP32_FLOPS_PER_S)
        row["ms"] = time_ms(lambda: rw.row_norm_cuda(x, scale, None, 1e-6,
                                                     False))
        row["eager_ms"] = eager_ms(lambda: rw.row_norm_cuda(
            x, scale, None, 1e-6, False))
        row["plain_ms"] = time_ms(lambda: rw.row_norm_torch(
            x, scale, None, 1e-6, False), iters=3)
        row["library_ms"] = time_ms(lambda: torch.nn.functional.rms_norm(
            x, (d,), scale, 1e-6))
        row["library"] = "torch.nn.functional.rms_norm"
        check_bound(row, "row_norm")
        _vs(row)
    return row


def phase_row_kernels(dev) -> dict[str, list[dict]]:
    """The fixed-order head GEMM and row norm at the main paths' shapes,
    each bit-equal to its plain version, timed: the heads of
    bnn-lm-100m (tied), mixtral-8x7b and jamba-1.5-large, whole and over
    half the vocab, and the routers of deepseek-v2-lite, mixtral and
    jamba at M = 1, 8, 128; the norms at D = 768-8192, M = 1, 8, 128;
    untimed, the edges: M around the regimes (router, decode to 32 rows,
    prefill tiles of 128), N around the router and head tiles, K off
    every tile and around the order's chunks (KC - 1, KC, KC + 1,
    3 KC + 5, a router K past its cluster's shared memory), both
    layouts; D around the norm's warps (1024, 1025, 2050, 4100, 8191)
    and past a lane's registers (16384, 20000), aligned and not."""
    from repro_torch.kernels.rowwise import KC
    gen = torch.Generator(device=dev).manual_seed(4)
    rows: dict[str, list[dict]] = {"row_gemm": [], "row_norm": []}
    for name, (k, n, tied) in ROW_HEADS.items():
        for m in ROW_M:
            rows["row_gemm"] += check_row_gemm(dev, m, k, n, gen, True, tied,
                                               f"{name} head")
    for name, (k, n) in ROW_ROUTERS.items():
        for m in ROW_M:
            rows["row_gemm"] += check_row_gemm(dev, m, k, n, gen, True,
                                               what=f"{name} router")[:1]
    edges = [(2, 100, 77), (3, 33, 130), (5, 1, 9), (9, 64, 200),
             (17, 31, 65), (129, 257, 63), (65, 2048, 64), (3, 2048, 8),
             (17, 4097, 16), (129, 300, 33), (1, 257, 129), (8, 31, 300),
             (1, KC - 1, 64), (8, KC, 8), (33, KC + 1, 16),
             (129, 3 * KC + 5, 63), (5, 3 * KC + 5, 33), (2, 24 * KC + 3, 64),
             (1, 3 * KC + 5, 65), (8, KC + 1, 129), (16, KC - 1, 300),
             (32, 3 * KC + 5, 128), (33, KC, 130), (40, 3 * KC + 5, 128),
             (129, 3 * KC + 5, 200), (257, KC, 129)]
    for m, k, n in edges:
        for tied in (False, True):
            check_row_gemm(dev, m, k, n, gen, False, tied, "edge")
    for d in ROW_NORM_D:
        for m in ROW_M:
            rows["row_norm"].append(check_row_norm(dev, m, d, gen, True))
    for m, d in ((3, 100), (5, 64), (129, 2050), (1, 7), (3, 1024),
                 (2, 1025), (5, 2050), (129, 4100), (1, 8191), (3, 16384),
                 (2, 20000)):
        for misaligned in (False, True):
            check_row_norm(dev, m, d, gen, False, misaligned)
    for name, rs in rows.items():
        for r in rs:
            log(f"[kernels] {name} {json.dumps(r)}")
    return rows


def _ragged_rows(b, c, max_len, rng, dev):
    """kv_len up to ``max_len`` (the first row at it, the last 0: fully
    masked) and the q_offset of a decode (c = 1) or a prefill chunk."""
    lens = rng.integers(c, max_len + 1, size=b)
    lens[0], lens[-1] = max_len, 0
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    q_off = (kv_len - c).clamp_min(0) if c > 1 else kv_len - 1
    return kv_len, q_off.to(torch.int32).contiguous()


def _visible(kpos, kv_len, q_off, c, causal, window):
    """(B, C, S) bool: the keys each chunk query sees (the masks of the
    kernels' plain versions)."""
    qpos = q_off.long()[:, None] + torch.arange(c, device=kpos.device)
    m = ((kpos >= 0) & (kpos < kv_len.long()[:, None]))[:, None, :]
    m = m.expand(kpos.shape[0], c, kpos.shape[1])
    if causal:
        m = m & (qpos[:, :, None] >= kpos[:, None, :])
    if window:
        m = m & (qpos[:, :, None] - kpos[:, None, :] < window)
    return m


RING_NEWEST = (100, 2000, 4223, 4300, 6000, 8191, 5, 3000)
# the speculative verify's attention: C = spec_k + 1 with spec_k 4, each
# row's real queries 1-5 (n_valid), ragged kv_len; the ring's newest
# positions just past its 4224 slots (the arc has just wrapped) and one
# short of them
VERIFY_C = 5
VERIFY_N_VALID = (1, 2, 3, 4, 5, 5, 3, 1)
VERIFY_LENS = (1024, 7, 300, 513, 640, 256, 900, 1)
VERIFY_RING_NEWEST = (4223, 4224, 4225, 4226, 4228, 4230, 4300, 4500)


def check_ring_attention(dev, c: int, gen: torch.Generator,
                         timed: bool, newest=RING_NEWEST,
                         window: int = 4096, n_valid=None) -> dict:
    """mixtral's ring at its published shapes: B=8, H=32, Hkv=8, Dh=128,
    BS=16, MB=264 (4224 slots), window 4096.  ``newest`` covers rows
    below the capacity (slots never written), above it (wrapped) and a
    kv_len below one block.  C > 1 is a causal prefill chunk ending at
    ``newest``, or, given per-row ``n_valid``, a speculative verify whose
    row i starts at newest + 1 - n_valid[i] (queries past n_valid[i] are
    padding)."""
    from repro_torch.kernels import paged_attention as pa
    b, h, hkv, dh, bs, mb = len(newest), 32, 8, 128, 16, 264
    newest = torch.tensor(newest, dtype=torch.int32, device=dev)
    kv_len = (newest + 1).to(torch.int32)
    q_off = newest if c == 1 else (kv_len - c).clamp_min(0).to(torch.int32)
    if n_valid is not None:
        q_off = (kv_len - torch.tensor(n_valid, dtype=torch.int32,
                                       device=dev)).to(torch.int32)
    causal = c > 1
    nb = b * mb + 1
    tab = (1 + torch.randperm(b * mb, generator=gen, device=dev)).reshape(
        b, mb).to(torch.int32)
    q = torch.randn(b, c, h, dh, device=dev, generator=gen)
    kp = torch.randn(nb, bs, hkv, dh, device=dev, generator=gen)
    vp = torch.randn(nb, bs, hkv, dh, device=dev, generator=gen)
    kw = dict(kv_len=kv_len, q_offset=q_off, causal=causal, window=window,
              ring=True, newest=newest)
    got = pa.paged_attention(q, kp, vp, tab, **kw)
    want = pa.paged_attention_torch(q, kp, vp, tab, **kw)
    err = (got - want).abs().max().item()
    if not err <= MAX_ATTN_ERR:
        raise AssertionError(f"paged_attention ring C={c} window={window} "
                             f"newest={newest.tolist()}: max abs err "
                             f"{err:.3g} > {MAX_ATTN_ERR}")
    kpos = pa.ring_key_positions(newest, mb, bs)
    vis = _visible(kpos, kv_len, q_off, c, causal, window)
    blind = ~vis.any(dim=-1)                    # (B, C): rows that see no key
    if blind.any() and got[blind].abs().max().item() != 0.0:
        raise AssertionError(f"paged_attention ring C={c}: a fully-masked "
                             "row is not zero")
    if c == 1:
        _check_rows_alone(
            got, lambda i: pa.paged_attention(
                q[i:i + 1], kp, vp, tab[i:i + 1], kv_len=kv_len[i:i + 1],
                q_offset=q_off[i:i + 1], causal=causal, window=window,
                ring=True, newest=newest[i:i + 1]),
            f"paged_attention ring B={b} C=1")
    row = {"shape": f"B={b} C={c} H={h} Hkv={hkv} Dh={dh} BS={bs} MB={mb} "
                    f"window={window} newest={newest.tolist()}"
                    + ("" if n_valid is None else
                       f" n_valid={list(n_valid)}"), "max_abs_err": err}
    if timed:
        # what this run's data needs: each row's visible keys once
        n_keys = int(vis.any(dim=1).sum())
        n_bytes = (2 * n_keys * hkv * dh + 2 * q.numel()) * 4 + \
            tab.numel() * 4
        n_ops = 4 * int(vis.sum()) * h * dh
        row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, n_ops,
                                                    FP32_FLOPS_PER_S)
        run = lambda: pa.paged_attention(q, kp, vp, tab, **kw)
        row["ms"] = time_ms(run)
        row["eager_ms"] = eager_ms(run)
        row["plain_ms"] = time_ms(
            lambda: pa.paged_attention_torch(q, kp, vp, tab, **kw), iters=3)
        # yardstick: SDPA over the gathered K/V (heads repeated for GQA)
        # with the ring's mask
        keys = kp[tab.long()].reshape(b, mb * bs, hkv, dh)
        vals = vp[tab.long()].reshape(b, mb * bs, hkv, dh)
        keys = keys.repeat_interleave(h // hkv, dim=2).transpose(1, 2)
        vals = vals.repeat_interleave(h // hkv, dim=2).transpose(1, 2)
        mask = vis[:, None].expand(b, h, c, mb * bs)
        qt = q.transpose(1, 2)
        fsdpa = torch.nn.functional.scaled_dot_product_attention
        row["library_ms"] = time_ms(lambda: fsdpa(qt, keys, vals,
                                                  attn_mask=mask))
        row["beats_library"] = row["ms"] < row["library_ms"]
        check_bound(row, "paged_attention")
    return row


MLA_RING_NEWEST = (100, 1023, 1500, 3000, 5, 700, 2047, 4000)


def check_mla_attention(dev, c: int, gen: torch.Generator, timed: bool,
                        ring: bool = False, newest=MLA_RING_NEWEST,
                        window: int | None = None, lens=None) -> dict:
    """deepseek-v2-lite's latent attention at its published shapes: B=8,
    H=16, nope 128, rope 64, R=512, Dv=128, BS=16, MB=64 (kv_len up to
    1024, the last row fully masked, or the given ``lens``); ``ring``
    reads the same table as a ring (``newest`` below and above its 1024
    slots; B = len(newest)).  C > 1 is a causal chunk ending at each
    row's last key.  At C = 1 each row of the batch must equal, bit for
    bit, the same row run alone."""
    from repro_torch.kernels import paged_attention as pa
    b, h, nope, dr, r, dv, bs, mb = 8, 16, 128, 64, 512, 128, 16, 64
    rng = np.random.default_rng(11 + c)
    if ring:
        b = len(newest)
        newest = torch.tensor(newest, dtype=torch.int32, device=dev)
        kv_len = (newest + 1).to(torch.int32)
        q_off = newest if c == 1 else \
            (kv_len - c).clamp_min(0).to(torch.int32)
    elif lens is not None:
        newest = None
        b = len(lens)
        kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        q_off = (kv_len - c).clamp_min(0) if c > 1 else kv_len - 1
        q_off = q_off.to(torch.int32).contiguous()
    else:
        newest = None
        kv_len, q_off = _ragged_rows(b, c, mb * bs, rng, dev)
    causal = c > 1
    nb = b * mb + 1
    tab = (1 + torch.randperm(b * mb, generator=gen, device=dev)).reshape(
        b, mb).to(torch.int32)
    q = torch.randn(b, c, h, nope + dr, device=dev, generator=gen)
    ckv = torch.randn(nb, bs, r, device=dev, generator=gen)
    krope = torch.randn(nb, bs, dr, device=dev, generator=gen)
    k_up = torch.randn(r, h * nope, device=dev, generator=gen) * r ** -0.5
    v_up = torch.randn(r, h * dv, device=dev, generator=gen) * r ** -0.5
    kw = dict(k_up=k_up, v_up=v_up, nope_dim=nope, kv_len=kv_len,
              q_offset=q_off, causal=causal, window=window, ring=ring,
              newest=newest)
    got = pa.paged_attention_mla(q, ckv, krope, tab, **kw)
    want = pa.paged_attention_mla_torch(q, ckv, krope, tab, **kw)
    err = (got - want).abs().max().item()
    limit = MAX_MLA_REL_ERR * max(1.0, want.abs().max().item())
    if not err <= limit:
        raise AssertionError(f"paged_attention_mla C={c} ring={ring} "
                             f"window={window}: max abs err {err:.3g} > "
                             f"{limit:.3g}")
    kpos = (pa.ring_key_positions(newest, mb, bs) if ring else
            torch.arange(mb * bs, device=dev)[None].expand(b, mb * bs))
    vis = _visible(kpos, kv_len, q_off, c, causal, window)
    blind = ~vis.any(dim=-1)                    # (B, C): rows that see no key
    if blind.any() and got[blind].abs().max().item() != 0.0:
        raise AssertionError(f"paged_attention_mla C={c} ring={ring}: a "
                             "fully-masked row is not zero")
    if c == 1:
        _check_rows_alone(
            got, lambda i: pa.paged_attention_mla(
                q[i:i + 1], ckv, krope, tab[i:i + 1], **{
                    **kw, "kv_len": kv_len[i:i + 1],
                    "q_offset": q_off[i:i + 1],
                    "newest": None if newest is None else newest[i:i + 1]}),
            f"paged_attention_mla B={b} C=1 ring={ring} window={window}")
    tiled = pa.mla_tiled(c, h, r, dr)
    row = {"shape": f"B={b} C={c} H={h} nope={nope} rope={dr} R={r} Dv={dv} "
                    f"BS={bs} MB={mb} ring={ring} window={window}",
           "max_abs_err": err, "limit": limit,
           "path": "tiled" if tiled else "decode"}
    if timed:
        n_keys = int(vis.any(dim=1).sum())
        rows = b * c * h
        n_bytes = n_keys * (r + dr) * 4 + (k_up.numel() + v_up.numel()) * 4 \
            + (q.numel() + got.numel() + tab.numel()) * 4
        # the absorbed form: q . k_up per query row; a (R + Dr)-wide score
        # and an R-wide weighted sum per visible (query, key) and head;
        # v_up per query row
        pairs = int(vis.sum()) * h
        gemm_ops = 2 * rows * nope * r + 2 * rows * r * dv
        walk_ops = pairs * (2 * (r + dr) + 2 * r)
        # both walks multiply on tensor cores in 3xTF32; the GEMMs too on
        # the tiled route, in float32 on CUDA cores on the decode route
        row["bound_rate"] = ("3xTF32, 495/3 TFLOP/s" if tiled else
                             "GEMMs float32 67 TFLOP/s, walk 3xTF32 "
                             "495/3 TFLOP/s")
        gemm_rate = TF32X3_FLOPS_PER_S if tiled else FP32_FLOPS_PER_S
        row["bound_ms"], row["bound_by"] = bound_ms(
            n_bytes, gemm_ops + walk_ops, (gemm_ops + walk_ops) / (
                gemm_ops / gemm_rate + walk_ops / TF32X3_FLOPS_PER_S))
        run = lambda: pa.paged_attention_mla(q, ckv, krope, tab, **kw)
        row["ms"] = time_ms(run)
        row["eager_ms"] = eager_ms(run)
        row["launch_ms"] = launch_ms(run)
        check_bound(row, "paged_attention_mla")
        row["plain_ms"] = time_ms(
            lambda: pa.paged_attention_mla_torch(q, ckv, krope, tab, **kw),
            iters=3)
        lat = ckv[tab.long()].reshape(b, mb * bs, r)
        rope = krope[tab.long()].reshape(b, mb * bs, dr)
        mask = vis[:, None].expand(b, h, c, mb * bs)
        fsdpa = torch.nn.functional.scaled_dot_product_attention
        scale = (nope + dr) ** -0.5
        # the library yardstick: the absorbed form in PyTorch calls —
        # torch.matmul of q_nope by each head's k_up, SDPA over the
        # gathered latents as keys (R + Dr wide) and values (R wide),
        # every head's query rows against the row's one latent sequence,
        # torch.matmul by each head's v_up (weights laid out per head
        # once, outside the timing)
        k_up_h = k_up.reshape(r, h, nope).permute(1, 2, 0).contiguous()
        v_up_h = v_up.reshape(r, h, dv).permute(1, 0, 2).contiguous()
        keys = torch.cat([lat, rope], dim=-1)[:, None]  # (B, 1, S, R + Dr)
        vals = lat[:, None]                              # (B, 1, S, R)
        mask_hc = mask.reshape(b, 1, h * c, mb * bs)

        def library():
            qn = q[..., :nope].permute(2, 0, 1, 3).reshape(h, b * c, nope)
            q_lat = torch.matmul(qn, k_up_h)            # (H, B*C, R)
            qa = torch.cat([q_lat.reshape(h, b, c, r).permute(1, 0, 2, 3),
                            q[..., nope:].transpose(1, 2)], dim=-1)
            o = fsdpa(qa.reshape(b, 1, h * c, r + dr), keys, vals,
                      attn_mask=mask_hc, scale=scale)
            o = o.reshape(b, h, c, r).permute(1, 0, 2, 3).reshape(h, b * c, r)
            return torch.matmul(o, v_up_h)              # (H, B*C, Dv)
        lib_out = library().reshape(h, b, c, dv).permute(1, 2, 0, 3)
        if not (lib_out - want).abs().max().item() <= 10 * limit:
            raise AssertionError("the absorbed library yardstick computes "
                                 "another function than the plain version")
        row["library_ms"] = time_ms(library)
        row["library"] = ("absorbed: matmul by k_up + SDPA over the latents "
                          "+ matmul by v_up")

        # the decompressing yardstick: both expansion matmuls of every
        # gathered key, then SDPA over per-head K and V
        rope_h = rope[:, :, None].expand(b, mb * bs, h, dr)
        qt = q.transpose(1, 2)

        def decompress():
            k_nope = torch.matmul(lat, k_up).reshape(b, mb * bs, h, nope)
            v_h = torch.matmul(lat, v_up).reshape(b, mb * bs, h, dv)
            k_h = torch.cat([k_nope, rope_h], dim=-1)
            return fsdpa(qt, k_h.transpose(1, 2), v_h.transpose(1, 2),
                         attn_mask=mask)
        row["library_decompress_ms"] = time_ms(decompress)
    return row


def phase_attention_variants(dev) -> dict[str, list[dict]]:
    """The ring and MLA variants at the published shapes of their
    configurations, each against its plain version, timed."""
    gen = torch.Generator(device=dev).manual_seed(2)
    rows = {"paged_attention_ring": [check_ring_attention(dev, c, gen, True)
                                     for c in (1, 128)]
            # the engine's smallest decode bucket: one wrapped row
            + [check_ring_attention(dev, 1, gen, True, newest=(6000,))],
            "paged_attention_mla": [check_mla_attention(dev, c, gen, True)
                                    for c in (1, 128)]}
    rows["paged_attention_mla"].append(check_mla_attention(dev, 1, gen, True,
                                                           ring=True))
    # the engine's smallest decode bucket: one row at kv_len 1024
    rows["paged_attention_mla"].append(check_mla_attention(dev, 1, gen, True,
                                                           lens=(1024,)))
    # the speculative verify ([spec]): MLA at C = 5 over 8 rows; the ring
    # at C = 5 with each row's real queries 1-5, over a ring whose
    # visible arc has just wrapped (newest around its 4224 slots)
    rows["paged_attention_mla"].append(check_mla_attention(dev, VERIFY_C,
                                                           gen, True))
    rows["paged_attention_ring"].append(check_ring_attention(
        dev, VERIFY_C, gen, True, newest=VERIFY_RING_NEWEST,
        n_valid=VERIFY_N_VALID))
    # off the paths, checked untimed: a ring prefill chunk of MLA; ring
    # chunks around the decode and prefill tiles (G = 4: R = 16, 20, 68),
    # rings that have just wrapped (newest = capacity - 1, capacity,
    # capacity + 1, + one block), a window that cuts a block and a key
    # tile mid-way
    check_mla_attention(dev, 5, gen, False, ring=True)
    # the MLA decode walk's parts: kv_len one short of, at and one past a
    # part boundary (k * MLA_PART_KEYS), 0, 1 and BS - 1, with and
    # without a window that cuts a part; rings whose arc starts one
    # short of, at and one past a part boundary, and wraps (at a
    # multiple of the 1024-slot capacity: a part boundary)
    from repro_torch.kernels.paged_attention import MLA_PART_KEYS as mk
    edges = (mk - 1, mk, mk + 1, 3 * mk - 1, 3 * mk, 3 * mk + 1, 0, 1, 15)
    for window in (None, 100):
        check_mla_attention(dev, 1, gen, False, window=window, lens=edges)
        check_mla_attention(dev, 1, gen, False, ring=True, window=window,
                            newest=(1023 + mk - 1, 1023 + mk, 1023 + mk + 1,
                                    2047, 2048, 2049, 1023 + 3 * mk,
                                    3 * 1024 + 5))
    # MLA around the decode block (C * H = 16) and the tiled path's
    # 64-row tile (C = 2, 4, 5, 17 at H = 16), a window that cuts a
    # latent block, ring chunks over a ring that has just wrapped
    for c in (2, 4, 17):
        check_mla_attention(dev, c, gen, False)
    check_mla_attention(dev, 17, gen, False, window=37)
    check_mla_attention(dev, 128, gen, False, window=300)
    for c in (17, 128):
        check_mla_attention(dev, c, gen, False, ring=True,
                            newest=(1023, 1024, 1025, 1040, 1024 + 70))
    for c in (4, 5, 17):
        check_ring_attention(dev, c, gen, False)
    for c in (1, 17, 128):
        check_ring_attention(dev, c, gen, False,
                             newest=(4223, 4224, 4225, 4240, 4224 + 70),
                             window=1000)
    # the decode walk's parts over a ring: the arc wraps at position 8448
    # (twice the capacity, a part boundary) and starts one short of, at
    # and one past a part boundary; a window that cuts a part, and one
    # key wide
    for window in (4096, 300):
        check_ring_attention(dev, 1, gen, False, window=window,
                             newest=(8447, 8448, 8449, 8703, 4350, 4351,
                                     4352, 3 * 4224 + 5))
    check_ring_attention(dev, 1, gen, False, window=1,
                         newest=(0, 255, 256, 8448))
    for name, rs in rows.items():
        for r in rs:
            log(f"[kernels] {name} {json.dumps(r)}")
    return rows


# --------------------------------------------------------------- phase 3


def traffic(vocab: int, n_requests: int = 16, prompt_lens=(64, 512),
            seed: int = 0) -> list[np.ndarray]:
    """Seeded prompts with lengths drawn uniformly from ``prompt_lens``."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(prompt_lens[0], prompt_lens[1] + 1, size=n_requests)
    return [rng.integers(0, vocab, size=n) for n in lens]


SERVING_KERNELS = ("fused_bnn", "paged_attention", "binarize_pack",
                   "row_gemm", "row_norm")


def phase_serving(dev, cfg, ecfg, n_requests: int = 16, max_new: int = 64,
                  prompt_lens=(64, 512), late_after: int = 10, seed: int = 0,
                  *, prompts=None, n_late: int | None = None,
                  required=SERVING_KERNELS, watch=None, params=None):
    """Serve seeded traffic through the port's Engine; returns the engine,
    its params, the finished outputs, the launch counts and the stats.
    ``prompts`` replaces the drawn traffic; the last ``n_late`` (default
    half) are submitted after ``late_after`` steps.  Kernel launch
    counts are reset just before the engine is built (its weights pack
    on first use); every kernel in ``required`` must have launched.
    ``watch(engine)``, when given, is called on the new engine before
    the first request; ``params`` replace the seeded weights."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as M
    from repro_torch.serving import Engine
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = M.init(gen, cfg, device=dev)
    if prompts is None:
        prompts = traffic(cfg.vocab, n_requests, prompt_lens, seed)
    n_requests = len(prompts)
    early = n_requests - (n_requests // 2 if n_late is None else n_late)
    ops.reset_launches()
    eng = Engine(params, cfg, ecfg, device=dev)
    if watch is not None:
        watch(eng)
    t0 = time.perf_counter()
    for p in prompts[:early]:
        eng.submit(p, max_new)
    for _ in range(late_after):
        eng.step()
    for p in prompts[early:]:
        eng.submit(p, max_new)
    out = eng.run()
    torch.cuda.synchronize() if dev.type == "cuda" else None
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in ops.KERNELS}
    st = eng.stats()
    if len(out) != n_requests:
        raise AssertionError(f"{len(out)} of {n_requests} requests finished")
    for rid, seq in out.items():
        r = eng.requests[rid]
        if seq.shape != (r.prompt_len + max_new,) or \
                not ((seq >= 0) & (seq < cfg.vocab)).all():
            raise AssertionError(f"request {rid}: bad output {seq.shape}")
    if st["max_concurrent_decode"] < 2:
        raise AssertionError("fewer than 2 decode rows ever ran together")
    log(f"[serving] {cfg.name} d_model={cfg.d_model} layers={cfg.n_layers} "
        f"vocab={cfg.vocab} requests={n_requests} "
        f"prompt_tokens={sum(len(p) for p in prompts)} "
        f"generated={st['decoded_tokens']} steps={st['steps']} wall_s={wall:.3f}")
    log(f"[serving] total_tokens_per_s={st['total_tokens_per_s']:.1f} "
        f"decode_tokens_per_s={st['decode_tokens_per_s']:.1f} "
        f"max_concurrent_decode={st['max_concurrent_decode']} "
        f"preemptions={st['preemptions']} prefill_calls={st['prefill_calls']} "
        f"decode_calls={st['decode_calls']}")
    log(f"[serving] launches {json.dumps(launches)}")
    for name in required:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"{cfg.name} serving path")
    return eng, params, out, launches, st


MIXED_PAIRS = (("torch", "auto"), ("auto", "torch"))   # (attn_impl, bnn_impl)
MIXED_REQUESTS = 4             # phase 3's first prompts, served again


def serving_mixed_pairs(dev, cfg, ecfg, params, out,
                        max_new: int = 64) -> dict[str, dict]:
    """Phase 3's first MIXED_REQUESTS prompts served again under each
    mixed pair of impls: the paged attention's plain version with the
    BNN GEMM kernels, then the reverse.  The launch counts show the
    split; the tokens equal phase 3's, or part at a sign flip that
    phase 4's rule accepts (found by its teacher-forced re-check of the
    sequence up to the first differing token, and printed).  Returns
    {path: launches}."""
    import dataclasses
    from repro_torch.kernels import ops
    from repro_torch.serving import Engine
    prompts = traffic(cfg.vocab)[:MIXED_REQUESTS]
    paths = {}
    for attn_impl, bnn_impl in MIXED_PAIRS:
        tag = f"attn_impl={attn_impl} bnn_impl={bnn_impl}"
        ops.reset_launches()
        eng = Engine(params, cfg, dataclasses.replace(
            ecfg, attn_impl=attn_impl, bnn_impl=bnn_impl), device=dev)
        rids = [eng.submit(pr, max_new) for pr in prompts]
        got = eng.run()
        _sync(dev)
        launches = {k.name: k.launches for k in ops.KERNELS}
        log(f"[serving] {tag}: {MIXED_REQUESTS} requests, launches "
            f"{json.dumps(launches)}")
        kernel, plain = (("fused_bnn", "paged_attention")
                         if attn_impl == "torch"
                         else ("paged_attention", "fused_bnn"))
        if dev.type == "cuda" and not (launches[kernel] > 0
                                       and launches[plain] == 0):
            raise AssertionError(f"[serving] {tag}: {kernel} "
                                 f"{launches[kernel]}, {plain} "
                                 f"{launches[plain]} launches")
        for i, rid in enumerate(rids):
            a, b = got[rid], out[i]
            if np.array_equal(a, b):
                continue
            pos = int(np.nonzero(a != b)[0][0])
            _l, _p, flips, _w, _kept = _teacher_forced(
                params, cfg, b[:pos + 1], ecfg.prefill_chunk,
                ecfg.block_size, 0, dev, f"[serving] {tag} rid {i}",
                keep_from=pos + 1)
            if not flips:
                raise AssertionError(f"[serving] {tag} request {i}: "
                                     f"tokens part at {pos} with no "
                                     "accepted sign flip before it")
            log(f"[serving] {tag} request {i}: tokens part at position "
                f"{pos} after {flips} accepted sign flips")
        log(f"[serving] {tag}: tokens checked against phase 3's")
        paths[f"serving_{'attn' if attn_impl == 'torch' else 'bnn'}"
              f"_plain"] = launches
        del eng
    return paths


# --------------------------------------------------------------- [ranks]
#
# The serving forward over several ranks (ROADMAP.md queue 1, item 11's
# serving half): bnn-lm-100m at published width and "bnn" over (data,
# model) meshes of ranks spawned by launch/mesh.spawn_ranks.  Every rank
# draws phase 3's seeded weights itself (one generator seed) and keeps
# its slices.  On a machine with fewer cards than ranks they share the
# cards under gloo, over the cards' tensors (launch/mesh.rank_world);
# with a card a rank, NCCL.

RANKS_PROJ = (("attn", "q"), ("attn", "k"), ("attn", "v"), ("attn", "o"),
              ("ffn", "gate"), ("ffn", "up"), ("ffn", "down"))
RANKS_GEMM_ROWS = (1, 8, 128)
RANKS_PREFILL = dict(rows=2, tokens=512)   # (b): 2 prompts, 4 chunks
RANKS_LATE_AFTER = 10                      # phase 3's schedule
GLOO_PROBES = ("all_reduce", "all_gather", "broadcast",
               "all_gather_into_tensor", "reduce_scatter_tensor",
               "all_to_all_single")


def ranks_schedule(eng, prompts, max_new: int, sampling=None,
                   late_after: int = RANKS_LATE_AFTER) -> list[list[int]]:
    """Phase 3's schedule: the first half submitted, ``late_after``
    steps, then the rest; each request's tokens, in prompt order."""
    early = len(prompts) - len(prompts) // 2
    rids = [eng.submit(p, max_new, **({"sampling": sampling(b)}
                                      if sampling else {}))
            for b, p in enumerate(prompts[:early])]
    for _ in range(late_after):
        eng.step()
    rids += [eng.submit(p, max_new, **({"sampling": sampling(b)}
                                       if sampling else {}))
             for b, p in enumerate(prompts[early:], start=early)]
    out = eng.run()
    return [out[r].tolist() for r in rids]


def _ranks_mesh(world, shape):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(world.device.type, tuple(shape),
                            mesh_dim_names=("data", "model"))


def ranks_gemms(world, mesh, params, cfg) -> int:
    """(a) Each projection of layer 0, placed by the decode rules, at
    RANKS_GEMM_ROWS input rows: the tensor-parallel GEMM (the rank's
    kernel on its shard) gathered whole equals one rank's kernel on the
    whole weight, bit for bit.  Returns the cases checked."""
    from repro_torch.dist import sharding as S, spmd
    from repro_torch.kernels import ops
    placed = S.place_params(params, cfg, mesh)
    gen = torch.Generator(device=world.device).manual_seed(11)
    n = 0
    for blk, name in RANKS_PROJ:
        w = params["layers"][0][blk][name]["w"]
        wt = placed["layers"][0][blk][name]["w"]
        for m in RANKS_GEMM_ROWS:
            x = torch.randn(m, w.shape[0], generator=gen, device=world.device)
            want = ops.bnn_dense(x, w, precision="bnn")
            got = spmd.full(ops.bnn_dense(x, wt, precision="bnn"))
            if not torch.equal(got, want):
                raise AssertionError(
                    f"[ranks] mesh {tuple(mesh.shape)} {name} M={m} "
                    f"K={w.shape[0]} N={w.shape[1]}: "
                    f"{int((got != want).sum())} elements differ from one "
                    "rank's kernel")
            n += 1
    return n


def _prefill_taps(params, cfg, prompts, dev, mesh=None):
    """``prefill_chunk`` over the prompts (one row each, equal lengths)
    in chunks of 128 on fresh pools: (logits per chunk, taps per chunk),
    gathered whole."""
    from repro_torch.dist import sharding as S, spmd
    from repro_torch.layers import common as C
    from repro_torch.models import transformer as M
    rows, n = prompts.shape
    bs, chunk = 16, 128
    per = n // bs
    pools = M.init_paged_state(cfg, 1 + rows * per, bs, device=dev,
                               mesh=mesh)
    table = (1 + torch.arange(rows * per, device=dev, dtype=torch.int32)
             ).reshape(rows, per)
    tok = torch.from_numpy(prompts.astype(np.int64)).to(dev)
    ctx = (C.sharding_context(mesh, S.decode_rules_of(mesh))
           if mesh is not None else contextlib.nullcontext())
    logits, taps = [], []
    with ctx, torch.no_grad():
        for i in range(0, n, chunk):
            t: list = []
            lg, _ = M.prefill_chunk(
                params, cfg, tok[:, i:i + chunk], pools, table,
                torch.full((rows,), i, dtype=torch.int32, device=dev),
                torch.full((rows,), chunk, dtype=torch.int32, device=dev),
                taps=t)
            logits.append(spmd.full(lg))
            taps.append([(name, spmd.full(v)) for name, v in t])
    return logits, taps


def ranks_prefill(world, mesh, params, cfg) -> dict:
    """(b) Two prompts of 512 tokens (seeded), one row each, through
    ``prefill_chunk`` in chunks of 128, one rank on the whole weights
    and over ``mesh`` (the rows split over data where it has two):
    every projection input and layer output bit-equal; the logits
    bit-equal (the head is each rank's vocab slice on its own rows,
    through ``row_gemm``).  Returns the record."""
    rows, n = RANKS_PREFILL["rows"], RANKS_PREFILL["tokens"]
    prompts = np.random.default_rng(21).integers(0, cfg.vocab, (rows, n))
    from repro_torch.dist import sharding as S
    want_l, want_t = _prefill_taps(params, cfg, prompts, world.device)
    placed = S.place_params(params, cfg, mesh)
    got_l, got_t = _prefill_taps(placed, cfg, prompts, world.device, mesh)
    where = f"[ranks] mesh {tuple(mesh.shape)} prefill"
    for c, (tk, tw) in enumerate(zip(got_t, want_t)):
        layer = 0
        for (name, a), (_n, b) in zip(tk, tw):
            if not torch.equal(a, b):
                raise AssertionError(
                    f"{where} chunk {c} layer {layer} {name}: first "
                    f"difference, max |diff| "
                    f"{(a.float() - b.float()).abs().max().item():.3e}")
            layer += name == "hidden"
    diff = max((a - b).abs().max().item() for a, b in zip(got_l, want_l))
    scale = max(b.abs().max().item() for b in want_l)
    if not all(torch.equal(a, b) for a, b in zip(got_l, want_l)):
        raise AssertionError(f"{where}: logits differ from one rank's by "
                             f"{diff:.3e} (largest {scale:.3e})")
    return {"bit_equal": True, "max_abs_diff": diff,
            "max_abs_logit": scale}


def probe_gloo(world) -> dict[str, str]:
    """Which collectives the gloo group runs on a card's tensors, each
    tried once on every rank (information: the forward needs
    all_reduce and all_gather, dist/spmd)."""
    import torch.distributed as dist
    t = torch.ones(4, device=world.device)
    calls = {
        "all_reduce": lambda: dist.all_reduce(t.clone()),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(t) for _ in range(world.size)], t),
        "broadcast": lambda: dist.broadcast(t.clone(), 0),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(4 * world.size, device=world.device), t),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(4, device=world.device),
            torch.ones(4 * world.size, device=world.device)),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty(4 * world.size, device=world.device),
            torch.ones(4 * world.size, device=world.device)),
    }
    out = {}
    for name in GLOO_PROBES:
        try:
            calls[name]()
            torch.cuda.synchronize(world.device)
            out[name] = "ok"
        except (RuntimeError, ValueError, NotImplementedError) as e:
            out[name] = type(e).__name__ + ": " + str(e).splitlines()[0][:80]
    return out


def ranks_engine(world, mesh, params, cfg, ecfg, prompts, max_new) -> dict:
    """(c) The engine over ``mesh`` serves phase 3's traffic on its
    schedule, greedy and then sampled (C's sampling), the ranks' tokens
    compared at every step; (d) its peak memory, the collectives of each
    decode step and tokens/s."""
    from repro_torch.dist import spmd
    from repro_torch.kernels import ops
    from repro_torch.serving import Engine
    rec: dict = {"runs": [], "wrap_us": dtensor_wrap_us(mesh, world.device)}
    wraps = [0]
    wrap = spmd.wrap

    def counting_wrap(*a, **kw):      # spmd's own calls resolve here too
        wraps[0] += 1
        return wrap(*a, **kw)
    spmd.wrap = counting_wrap
    for sampled in (False, True):
        ops.reset_launches()
        if world.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(world.device)
        eng = Engine(params, cfg, ecfg, device=world.device, mesh=mesh,
                     check_ranks=True)
        steps: list = []
        decode = eng._decode_fn

        def counted(*a, decode=decode, steps=steps):
            before, w0 = spmd.COLLECTIVES.copy(), wraps[0]
            r = decode(*a)
            steps.append({**(spmd.COLLECTIVES - before),
                          "dtensor_wraps": wraps[0] - w0})
            return r
        eng._decode_fn = counted
        t0 = time.perf_counter()
        toks = ranks_schedule(eng, prompts, max_new,
                              serve_sampling if sampled else None)
        _sync(world.device)
        wall = time.perf_counter() - t0
        st = eng.stats()
        rec["runs"].append({
            "tokens": toks, "wall_s": wall,
            "total_tokens_per_s": st["total_tokens_per_s"],
            "decode_tokens_per_s": st["decode_tokens_per_s"],
            "steps": st["steps"], "decode_calls": st["decode_calls"],
            "launches": {k.name: k.launches for k in ops.KERNELS},
            "peak_bytes": (torch.cuda.max_memory_allocated(world.device)
                           if world.device.type == "cuda" else 0),
            "decode_collectives": steps})
        del eng
    spmd.wrap = wrap
    return rec


def dtensor_wrap_us(mesh, dev) -> float:
    """The host's us to wrap an (8, 768) shard as a DTensor and take its
    local tensor back (``spmd.wrap`` + ``to_local``, what the forward
    does around each sublayer): the median of 5 runs of 2000."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.dist import spmd
    t = torch.zeros(8, 768, device=dev)
    pl = [Shard(0), Replicate()][:mesh.ndim]
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(2000):
            spmd.wrap(t, mesh, pl).to_local()
        runs.append((time.perf_counter() - t0) / 2000 * 1e6)
    return float(np.median(runs))


def ranks_worker(world, cfg, ecfg, prompts, max_new, gemm_shapes,
                 prefill_shapes, engine_shape, probe):
    """One rank of the [ranks] phase (module docstring, [ranks])."""
    from repro_torch.models import transformer as M
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=world.device).manual_seed(0)
    params = M.init(gen, cfg, device=world.device)   # the one-rank runs'
    out: dict = {"backend": world.backend, "device": str(world.device),
                 "gemms": {}, "prefill": {}}
    for shape in gemm_shapes:
        out["gemms"][shape] = ranks_gemms(world, _ranks_mesh(world, shape),
                                          params, cfg)
    for shape in prefill_shapes:
        out["prefill"][shape] = ranks_prefill(
            world, _ranks_mesh(world, shape), params, cfg)
    if engine_shape is not None:
        out["engine"] = ranks_engine(world, _ranks_mesh(world, engine_shape),
                                     params, cfg, ecfg, prompts, max_new)
    if probe and world.backend == "gloo" and world.device.type == "cuda":
        out["gloo_cuda"] = probe_gloo(world)
    return out


def _median_counts(steps: list[dict]) -> dict:
    keys = sorted({k for s in steps for k in s})
    return {k: float(np.median([s.get(k, 0) for s in steps])) for k in keys}


def ranks_parts_worker(world, parts):
    """One rank of a [ranks] world: each part ``(fn, args)`` in turn,
    ``fn(world, *args)``, the rank's memory given back after each;
    returns the backend, the rank's device and each part's result with
    its seconds on the rank."""
    out = {"backend": world.backend, "device": str(world.device),
           "parts": []}
    for fn, args in parts:
        t0 = time.perf_counter()
        res = fn(world, *args)
        out["parts"].append((res, time.perf_counter() - t0))
        gc.collect()
        if world.device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def run_ranks(dev, preps: list[dict]) -> list:
    """[ranks]: the parts of ``preps`` (each from a ``*_prep``, which made
    its one-rank references and freed their weights: ``parts``, a part
    ``(fn, args)`` for each world size it runs on, and ``report``) in
    one world of spawned ranks for each size, every prep's part in turn
    on every rank (a world's start and its ranks' first use of the card
    cost 10-25 s each); then each prep's ``report`` of its part's
    results by size, rank order.  Returns the reports' returns."""
    from repro_torch.launch.mesh import spawn_ranks
    got = [{} for _ in preps]
    try:
        for size in sorted({n for p in preps for n in p["parts"]}):
            which = [i for i, p in enumerate(preps) if size in p["parts"]]
            t0 = time.perf_counter()
            recs = spawn_ranks(ranks_parts_worker, size,
                               [preps[i]["parts"][size] for i in which],
                               device=dev.type, timeout_s=900)
            took = ", ".join(
                f"{preps[i]['parts'][size][0].__name__} {sec:.1f} s"
                for i, (_res, sec) in zip(which, recs[0]["parts"]))
            log(f"[ranks] world of {size}: backend {recs[0]['backend']}, "
                f"ranks on {sorted({r['device'] for r in recs})}, "
                f"{torch.cuda.device_count() if dev.type == 'cuda' else 0} "
                f"card(s); {time.perf_counter() - t0:.1f} s (on rank 0: "
                f"{took})")
            for j, i in enumerate(which):
                got[i][size] = [r["parts"][j][0] for r in recs]
        return [p["report"](g) for p, g in zip(preps, got)]
    finally:
        for p in preps:
            if "cleanup" in p:
                p["cleanup"]()


def ranks_prep(dev, smi: str, cfg=None, ecfg=None, smoke: bool = False,
               max_new: int = 64) -> dict:
    """[ranks] (a)-(d) for ``run_ranks``: (a) the tensor-parallel
    fused_bnn at every projection of bnn-lm-100m (q, k, v, o, gate, up,
    down) at tp = 2 ((1, 2) mesh) and 4 ((1, 4)) bit-equal to one rank's
    kernel; (b) prefill logits over (1, 2) and (2, 2) against one rank
    (``ranks_prefill``); (c) the engine over (2, 2) serves phase 3's 16
    prompts, 64 new, greedy and sampled: tokens equal the one-rank
    engine's (served here first, on the same seeded weights), every rank
    the same at every step; (d) printed: backend and cards, per-rank
    peak memory, the collectives a decode step, tokens/s beside the
    one-rank run and the host's launch us.  ``cfg``: bnn-lm-100m at
    SERVE_LAYERS layers (``smoke``: reduced width on the CPU, a
    rehearsal).  The report returns the engine runs' launches, summed
    over the ranks."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as M
    from repro_torch.serving import Engine, EngineConfig
    t0 = time.perf_counter()
    if cfg is None:
        cfg = get_config("bnn-lm-100m").replace(precision="bnn")
        cfg = reduced(cfg) if smoke else cfg.replace(n_layers=SERVE_LAYERS)
    if ecfg is None:
        ecfg = EngineConfig(block_size=16, num_blocks=1025, max_batch=8,
                            prefill_chunk=128, max_model_len=1024,
                            **NO_PREFIX)
    params = M.init(torch.Generator(device=dev).manual_seed(0), cfg,
                    device=dev)
    prompts = traffic(cfg.vocab)
    ref, one_rank_st = {}, None
    for sampled in (False, True):
        eng = Engine(params, cfg, ecfg, device=dev)
        t1 = time.perf_counter()
        ref[sampled] = ranks_schedule(
            eng, prompts, max_new, serve_sampling if sampled else None)
        _sync(dev)
        st = eng.stats()
        if not sampled:
            one_rank_st = st
        log(f"[ranks] {cfg.name} {cfg.n_layers} layers, one rank "
            f"{'sampled' if sampled else 'greedy'}: "
            f"total_tokens_per_s={st['total_tokens_per_s']:.1f} "
            f"wall_s={time.perf_counter() - t1:.3f}")
        del eng
    del params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    launch_us = host_launch_us(dev)
    worlds = {2: ([(1, 2)], [(1, 2)], None, True),
              4: ([(1, 4)], [(2, 2)], (2, 2), False)}

    def report(recs_by_size: dict) -> dict:
        engine_launches = {k.name: 0 for k in ops.KERNELS}
        for size, (_gemm, _pre, eng_shape, _probe) in worlds.items():
            recs = recs_by_size[size]
            r0 = recs[0]
            for shape, n in r0["gemms"].items():
                log(f"[ranks] (a) mesh {shape}: fused_bnn bit-equal to one "
                    f"rank at {n} projection x rows cases (tp {shape[1]})")
            for shape, pr in r0["prefill"].items():
                log(f"[ranks] (b) mesh {shape}: prefill logits bit-equal "
                    f"to one rank (max |diff| {pr['max_abs_diff']:.3e}, "
                    f"largest logit {pr['max_abs_logit']:.3f}); every "
                    "projection input and layer output bit-equal")
            if "gloo_cuda" in r0:
                log(f"[ranks] gloo on CUDA tensors: "
                    f"{json.dumps(r0['gloo_cuda'])}")
            if eng_shape is None:
                continue
            for i, tag in enumerate(("greedy", "sampled")):
                for r, rec in enumerate(recs):
                    if rec["engine"]["runs"][i]["tokens"] != ref[i == 1]:
                        got = rec["engine"]["runs"][i]["tokens"]
                        bad = [b for b in range(len(got))
                               if got[b] != ref[i == 1][b]]
                        raise AssertionError(
                            f"[ranks] (c) mesh {eng_shape} {tag} rank {r}: "
                            f"requests {bad} differ from the one-rank engine")
                run0 = r0["engine"]["runs"][i]
                for rec in recs:
                    for k, v in rec["engine"]["runs"][i]["launches"].items():
                        engine_launches[k] += v
                for name in SERVING_KERNELS:
                    if dev.type == "cuda" and any(
                            rec["engine"]["runs"][i]["launches"][name] <= 0
                            for rec in recs):
                        raise AssertionError(f"[ranks] (c) {tag}: {name} "
                                             "never launched on a rank")
                peaks = [rec["engine"]["runs"][i]["peak_bytes"] / 2 ** 30
                         for rec in recs]
                per_step = _median_counts(run0["decode_collectives"])
                log(f"[ranks] (c) mesh {eng_shape} {tag}: tokens equal the "
                    f"one-rank engine's on all {size} ranks "
                    f"({len(prompts)} requests x {max_new} new, "
                    f"{cfg.n_layers} layers)")
                log(f"[ranks] (d) {tag}: total_tokens_per_s="
                    f"{run0['total_tokens_per_s']:.1f} (one rank "
                    f"{one_rank_st['total_tokens_per_s']:.1f}) "
                    f"decode_tokens_per_s={run0['decode_tokens_per_s']:.1f} "
                    f"steps={run0['steps']} wall_s={run0['wall_s']:.3f} "
                    f"host_launch_us={launch_us:.2f}; peak GiB per rank "
                    f"{[round(p, 3) for p in peaks]}; a decode step (median "
                    f"of {len(run0['decode_collectives'])}): "
                    f"{json.dumps(per_step)}, a DTensor wrap "
                    f"{r0['engine']['wrap_us']:.1f} us; {smi}")
        log(f"[ranks] (a)-(d) launches {json.dumps(engine_launches)}; "
            f"{time.perf_counter() - t0:.1f} s since its one-rank runs")
        return engine_launches
    return {"parts": {size: (ranks_worker, (cfg, ecfg, prompts, max_new,
                                            *w))
                      for size, w in worlds.items()},
            "report": report}


def phase_ranks(dev, smi: str, cfg=None, ecfg=None, smoke: bool = False,
                max_new: int = 64) -> dict:
    """[ranks] (a)-(d) alone (``ranks_prep``)."""
    return run_ranks(dev, [ranks_prep(dev, smi, cfg, ecfg, smoke,
                                      max_new)])[0]


# ------------------------------------------------- [ranks] (e)-(f): families
#
# mixtral-8x7b and deepseek-v2-lite at published width and
# RANKS_FAMILY_LAYERS layers over (data, model) meshes of spawned ranks:
# expert-parallel MoE, GQA over the sliding-window ring and MLA on a
# rank's heads.  Each rank draws the family's seeded weights in
# transformer.init's order and keeps its slices one layer at a time
# (launch/mesh.init_on_ranks), so no rank holds more than one layer
# whole; the one-rank references are made first in this process, which
# then frees its weights.

RANKS_FAMILIES = {
    # (e) over (1, 2); (f) over (1, 4): over (2, 2) four ranks hold two
    # copies of the experts (they are replicated over data), 4 x 11.3
    # GiB, and each also draws one 5.4 GiB layer whole at a time: about
    # 67 GiB before the pools and the four CUDA contexts on one card
    "mixtral-8x7b": dict(prefill=[(1, 2)], engine=(1, 4), rows=1,
                         tokens=4352, decode=0, seed=41),
    # (e) over (1, 2) and (2, 2), then 4 decode steps at B = 8 (the MLA
    # decode route: C·H <= 16); (f) over (2, 2)
    "deepseek-v2-lite-16b": dict(prefill=[(1, 2), (2, 2)], engine=(2, 2),
                                 rows=8, tokens=256, decode=4, seed=42),
}
# the families' depth over ranks: 4 layers until [ranks] (i)-(j) took its
# ~100 s, 2 since (a dense and a MoE layer for deepseek, two MoE layers
# for mixtral); the smoke's time limit leaves no more
RANKS_FAMILY_LAYERS = 2
RANKS_FAMILY_NEW = 32
# deepseek's dense first layer's down projection over 4 ranks: K slices
# of 10944 / 4 = 2736 = 85.5 words (the row-parallel pad correction)
RANKS_PART_WORDS = (10944, 2048)

# [ranks] (g)-(h), the SSM mixer and the jamba hybrid, built as (e)-(f):
# (g) prefill_chunk over the meshes, every tap, the logits and each
# rank's slices of the pools (the slots' h and conv tail, jamba's K/V)
# bit-equal to one rank's; (h) the engine (every rank's tokens one
# rank's), then the JAX engine's defaults (slot snapshots, swap) on
# shared heads with two forced preemptions: snapshot hits, a slot back
# from the host bit-equal, one rank's tokens
RANKS_SSM = {
    # (g) over (1, 2) and (2, 2): 8 rows of 512 tokens in one chunk, then
    # 4 decode steps at B = 8; (h) over (2, 2)
    "mamba2-1.3b": dict(prefill=[(1, 2), (2, 2)], engine=(2, 2), rows=8,
                        tokens=512, chunk=512, decode=4, seed=43,
                        layers=2),      # 8, then 4, until the smoke's time
    # the jamba window (published layers 2-4: ssm, gqa + moe, ssm) over
    # (1, 2): 24 GiB of weights a rank, its 12 GiB expert stacks drawn by
    # one rank at a time (``init_on_ranks``: ranks sharing a card)
    "jamba-1.5-large-398b": dict(prefill=[(1, 2)], engine=(1, 2), rows=8,
                                 tokens=128, chunk=128, decode=4, seed=44,
                                 window=True),
}
# (h)'s shared-head traffic (``prefix_traffic``, shortened): 6 prompts on
# 2 heads of 256 tokens, request 5 repeating request 1, 16 new each
RANKS_PREFIX = dict(n=6, heads=2, repeats=((5, 1),), suffix=(16, 256))
RANKS_PREFIX_NEW = 16


def family_cfg(arch: str, smoke: bool = False):
    """The family at published width and RANKS_FAMILY_LAYERS layers (an
    SSM family: its RANKS_SSM cut; the jamba window: published layers
    2-4) (``smoke``: reduced, a CPU rehearsal)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    spec = {**RANKS_FAMILIES, **RANKS_SSM}[arch]
    base = get_config(arch).replace(precision="bnn")
    if spec.get("window"):
        return jamba_window(reduced(base) if smoke else base)
    cfg = base.replace(n_layers=spec.get("layers", RANKS_FAMILY_LAYERS))
    return reduced(cfg) if smoke else cfg


def family_ecfg(arch: str):
    from repro_torch.serving import EngineConfig
    return EngineConfig(**{"mixtral": MIXTRAL_ENGINE,
                           "deepseek": DEEPSEEK_ENGINE,
                           "mamba2": MAMBA2_ENGINE,
                           "jamba": JAMBA_ENGINE}[arch.split("-")[0]])


def ranks_prefix_run(eng, prompts) -> dict:
    """(h) ``prompts`` (RANKS_PREFIX traffic, RANKS_PREFIX_NEW new each,
    the last 2 after 4 steps) on an engine under the JAX defaults, with
    the policy's victim preempted once parked at a snapshot and once
    mid-decode (``forced_preempts``), every slot back from the host
    checked bit-equal (``watch_slot_swaps``): the tokens and what the
    snapshot and swap machinery did."""
    rec, done = {}, {}
    watch_slot_swaps(eng, rec)
    toks = serve_forced(eng, prompts, RANKS_PREFIX_NEW, 4, 2,
                        lambda e: forced_preempts(e, done))
    st = eng.stats()
    return {"tokens": [t.tolist() for t in toks], "forced": done,
            "host_trips_checked": rec["checked"],
            "snapshot_hits": st["prefix_cache"]["snapshot_hits"],
            "skipped_prefill_tokens":
                st["prefix_cache"]["skipped_prefill_tokens"],
            "swapped_slots": st["swap"]["swapped_slots"],
            "readopted_snapshots": st["swap"]["readopted_snapshots"],
            "total_tokens_per_s": st["total_tokens_per_s"]}


def defaults_ecfg(arch: str):
    """The family's engine under the JAX engine's defaults (prefix cache:
    slot snapshots; swap preemption)."""
    from dataclasses import replace
    from repro_torch.serving import EngineConfig
    return replace(family_ecfg(arch), prefix_cache=True,
                   preempt_policy=EngineConfig().preempt_policy)


def fingerprint(t: torch.Tensor) -> tuple[int, int, int]:
    """An exact-content checksum of ``t`` (its 32-bit words: their sum
    and a position-weighted sum in int64, and the count), computed on
    the card: equal tensors give equal prints, and a differing word
    changes the weighted sum unless another cancels it exactly."""
    v = t.detach().contiguous().reshape(-1).view(torch.int32).to(torch.int64)
    w = torch.arange(v.numel(), device=v.device) % 65521 + 1
    return (int(v.sum()), int((v * w).sum()), v.numel())


def _family_taps(params, cfg, prompts, dev, mesh=None, decode: int = 0,
                 chunk: int = 128):
    """``prefill_chunk`` over ``prompts`` (rows of equal length) in
    chunks of ``chunk`` on fresh pools (a window-sized ring for a
    windowed config, so a longer prompt wraps it; a recurrent slot a
    row), then ``decode`` greedy ``paged_decode_step``s: (logits of each
    chunk and step, whole, on the host; per chunk and step the
    fingerprint of every tap, whole; the pools)."""
    from repro_torch.dist import sharding as S, spmd
    from repro_torch.layers import common as C
    from repro_torch.models import transformer as M
    from repro_torch.serving.mixer_state import ring_block_count
    rows, n = prompts.shape
    bs = 16
    ring = bool(cfg.sliding_window)
    per = (ring_block_count(cfg.sliding_window, bs, chunk) if ring
           else -(-(n + decode) // bs))
    pools = M.init_paged_state(cfg, 1 + rows * per, bs, 1 + rows,
                               device=dev, mesh=mesh)
    table = (1 + torch.arange(rows * per, device=dev, dtype=torch.int32)
             ).reshape(rows, per)
    slots = 1 + torch.arange(rows, device=dev, dtype=torch.int32)
    tok = torch.from_numpy(prompts.astype(np.int64)).to(dev)
    ctx = (C.sharding_context(mesh, S.decode_rules_of(mesh))
           if mesh is not None else contextlib.nullcontext())

    def at(v):
        return torch.full((rows,), v, dtype=torch.int32, device=dev)
    logits, prints = [], []
    with ctx, torch.no_grad():
        for i in range(0, n, chunk):
            t: list = []
            lg, _ = M.prefill_chunk(params, cfg, tok[:, i:i + chunk], pools,
                                    table, at(i), at(chunk), slots,
                                    ring=ring, taps=t)
            logits.append(spmd.full(lg).cpu())
            prints.append([(name, fingerprint(spmd.full(v)))
                           for name, v in t])
        cur = logits[-1][:, -1].argmax(-1)
        for j in range(decode):
            t = []
            lg, _ = M.paged_decode_step(params, cfg, cur[:, None].to(dev),
                                        pools, table, at(n + j), None, slots,
                                        ring=ring, taps=t)
            logits.append(spmd.full(lg).cpu())
            prints.append([(name, fingerprint(spmd.full(v)))
                           for name, v in t])
            cur = logits[-1][:, -1].argmax(-1)
    return logits, prints, pools


def family_reference(dev, arch: str, smoke: bool = False) -> dict:
    """One rank's (e) and (f) on the whole weights ((g) and (h) for a
    RANKS_SSM family): the prefill's logits (saved to a file the ranks
    map) and tap prints (an SSM family's pools too, saved), the engine's
    greedy and sampled tokens and tokens/s (an SSM family's prefix run
    too); then the weights are freed."""
    import tempfile
    from repro_torch.models import transformer as M
    from repro_torch.serving import Engine
    spec = {**RANKS_FAMILIES, **RANKS_SSM}[arch]
    cfg = family_cfg(arch, smoke)
    t0 = time.perf_counter()
    params = M.init(torch.Generator(device=dev).manual_seed(0), cfg,
                    device=dev)
    prompts = np.random.default_rng(spec["seed"]).integers(
        0, cfg.vocab, (spec["rows"], spec["tokens"]))
    chunk = spec.get("chunk", 128)
    logits, prints, pools = _family_taps(params, cfg, prompts, dev,
                                         decode=spec["decode"], chunk=chunk)
    tmp = tempfile.mkdtemp(prefix="ranks_ref_")
    path = str(Path(tmp) / f"{arch}.pt")
    torch.save(logits, path)
    ssm = arch in RANKS_SSM
    traffic_ = family_traffic(cfg.vocab, seed=spec["seed"])
    ref = {"arch": arch, "cfg": cfg, "prompts": prompts, "decode":
           spec["decode"], "chunk": chunk, "logits_path": path, "tmp": tmp,
           "prints": prints, "traffic": traffic_, "tokens": [],
           "tokens_per_s": [], "max_new": RANKS_FAMILY_NEW,
           "letters": ("g", "h") if ssm else ("e", "f")}
    if ssm:
        ref["pools_path"] = str(Path(tmp) / f"{arch}.pools.pt")
        torch.save([{k: v.cpu() for k, v in p.items()} for p in pools],
                   ref["pools_path"])
    del pools
    ecfg = family_ecfg(arch)
    for sampled in (False, True):
        eng = Engine(params, cfg, ecfg, device=dev)
        ref["tokens"].append(ranks_schedule(
            eng, traffic_, ref["max_new"],
            serve_sampling if sampled else None))
        _sync(dev)
        ref["tokens_per_s"].append(eng.stats()["total_tokens_per_s"])
        del eng
    if ssm:
        ref["prefix_traffic"] = prefix_traffic(cfg.vocab, seed=spec["seed"],
                                               **RANKS_PREFIX)
        ref["prefix"] = ranks_prefix_run(
            Engine(params, cfg, defaults_ecfg(arch), device=dev),
            ref["prefix_traffic"])
        _sync(dev)
    del params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(f"[ranks] {arch} one rank: {len(logits)} prefill chunks and "
        f"decode steps, engine total_tokens_per_s greedy "
        f"{ref['tokens_per_s'][0]:.1f} sampled {ref['tokens_per_s'][1]:.1f}; "
        f"{time.perf_counter() - t0:.1f} s")
    return ref


def ranks_family_prefill(world, mesh, params, ref) -> dict:
    """(e) ``_family_taps`` over ``mesh`` against one rank's: every tap
    of every chunk (each projection input, the MoE's routing and down
    inputs, each layer output) with one rank's print, and the logits of
    every chunk and decode step bit-equal (max |diff| 0); (g) also each
    rank's slices of the pools."""
    from repro_torch.dist import spmd
    got_l, got_p, pools = _family_taps(
        params, ref["cfg"], ref["prompts"], world.device, mesh,
        ref["decode"], ref["chunk"])
    where = f"[ranks] {ref['arch']} mesh {tuple(mesh.shape)} prefill"
    chunks = len(got_p) - ref["decode"]
    for c, (got, want) in enumerate(zip(got_p, ref["prints"],
                                        strict=True)):
        layer = 0
        at = (f"chunk {c}" if c < chunks else f"decode step {c - chunks}")
        for (name, a), (_n, b) in zip(got, want, strict=True):
            if a != b:
                raise AssertionError(f"{where} {at} layer {layer} "
                                     f"{name}: first difference")
            layer += name == "hidden"
    want_l = torch.load(ref["logits_path"], mmap=True)
    diff = max((a - b).abs().max().item()
               for a, b in zip(got_l, want_l, strict=True))
    if diff:
        raise AssertionError(f"{where}: logits differ by {diff:.3e}")
    n_pool = 0
    if "pools_path" in ref:
        want_p = torch.load(ref["pools_path"], mmap=True)
        for li, (got, want) in enumerate(zip(pools, want_p, strict=True)):
            for k, v in got.items():
                w = want[k]
                for d in range(v.ndim):
                    start, n = spmd.rank_slice(v, d)
                    w = w.narrow(d, start, n)
                if not torch.equal(v.to_local(), w.to(v.device)):
                    raise AssertionError(f"{where}: layer {li} pool {k}: "
                                         "the rank's slice differs")
                n_pool += 1
    return {"chunks": chunks, "steps": ref["decode"],
            "taps": sum(len(p) for p in got_p), "max_abs_diff": diff,
            "pool_slices": n_pool}



def ranks_part_words(world, mesh, k: int, n: int) -> int:
    """A row-parallel fused_bnn whose K slice is not a whole number of
    32-bit words (a (k, n) weight over ``mesh``'s model ranks) at 1, 8
    and 128 rows, bit-equal to one rank's kernel on the whole weight."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.dist import spmd
    from repro_torch.kernels import ops
    gen = torch.Generator(device=world.device).manual_seed(13)
    w = torch.randn(k, n, generator=gen, device=world.device) / k ** 0.5
    wt = spmd.place(w, mesh, [Replicate(), Shard(0)])
    for m in RANKS_GEMM_ROWS:
        x = torch.randn(m, k, generator=gen, device=world.device)
        want = ops.bnn_dense(x, w, precision="bnn")
        got = spmd.full(ops.bnn_dense(x, wt, precision="bnn"))
        if not torch.equal(got, want):
            raise AssertionError(
                f"[ranks] mesh {tuple(mesh.shape)} K={k} ({k // mesh.size(1)}"
                f" a rank) M={m}: {int((got != want).sum())} elements "
                "differ from one rank's kernel")
    return len(RANKS_GEMM_ROWS)


def ranks_family_worker(world, jobs):
    """One rank of [ranks] (e)-(f) and (g)-(h): for each job, the
    family's weights drawn on the rank (``init_on_ranks``: in turns on
    a shared card), then (e) and (f) over the job's meshes
    ((h): then the prefix run, ``ranks_prefix_run``); the launches by
    kernel from the weights' first use to the job's end, the weight
    bytes the rank keeps and its peak."""
    from repro_torch import tree as T
    from repro_torch.dist import spmd
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import CACHED_KINDS, init_on_ranks
    from repro_torch.models import transformer as M
    from repro_torch.serving import Engine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = []
    for job in jobs:
        ref = job["ref"]
        rec = {"backend": world.backend, "device": str(world.device)}
        if job.get("part_words"):
            shape, (k, n) = job["part_words"]
            rec["part_words"] = ranks_part_words(
                world, _ranks_mesh(world, shape), k, n)
        if world.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(world.device)
        t0 = time.perf_counter()
        gen = torch.Generator(device=world.device).manual_seed(0)
        shapes = job["prefill"] + ([job["engine"]] if job["engine"] else [])
        meshes = {s: _ranks_mesh(world, s) for s in shapes}
        ops.reset_launches()
        launches = {k.name: 0 for k in ops.KERNELS}
        for shape, mesh in meshes.items():
            params = init_on_ranks(gen.manual_seed(0), ref["cfg"], mesh,
                                   device=world.device)
            leaves = [spmd.local(v) for v in
                      T.leaves(M.trainable(params, ref["cfg"]))]
            sub = rec.setdefault(shape, {
                "weight_bytes": sum(v.numel() * v.element_size()
                                    for v in leaves),
                "init_s": time.perf_counter() - t0,
                # the peak since the job began: the draw's, on a card
                "init_peak_bytes": (
                    torch.cuda.max_memory_allocated(world.device)
                    if world.device.type == "cuda" else 0)})
            if shape in job["prefill"]:
                sub["prefill"] = ranks_family_prefill(world, mesh, params,
                                                      ref)
            for k in ops.KERNELS:
                launches[k.name] += k.launches
            if shape == job["engine"]:
                sub["engine"] = ranks_engine(
                    world, mesh, params, ref["cfg"], family_ecfg(ref["arch"]),
                    ref["traffic"], ref["max_new"])
                for run in sub["engine"]["runs"]:
                    for name, v in run["launches"].items():
                        launches[name] += v
                if "prefix" in ref:
                    ops.reset_launches()
                    sub["prefix"] = ranks_prefix_run(
                        Engine(params, ref["cfg"], defaults_ecfg(ref["arch"]),
                               device=world.device, mesh=mesh,
                               check_ranks=True), ref["prefix_traffic"])
                    for k in ops.KERNELS:
                        launches[k.name] += k.launches
            sub["cached_bytes"] = ops.cached_bytes(CACHED_KINDS,
                                                   T.leaves(params))
            ops.reset_launches()
            del params, leaves
            gc.collect()
            if world.device.type == "cuda":
                torch.cuda.empty_cache()
            t0 = time.perf_counter()
        rec["launches"] = launches
        rec["peak_bytes"] = (torch.cuda.max_memory_allocated(world.device)
                             if world.device.type == "cuda" else 0)
        out.append(rec)
    return out


ROW_KERNELS = ("row_gemm", "row_norm")     # the head, router and norms
FAMILY_KERNELS = {"mixtral-8x7b": ("fused_bnn", "paged_attention_ring",
                                   "binarize_pack", *ROW_KERNELS),
                  "deepseek-v2-lite-16b": ("fused_bnn", "paged_attention_mla",
                                           "binarize_pack", *ROW_KERNELS),
                  "mamba2-1.3b": ("fused_bnn", "binarize_pack",
                                  *ROW_KERNELS),
                  "jamba-1.5-large-398b": ("fused_bnn", "paged_attention",
                                           "binarize_pack", *ROW_KERNELS)}


def families_prep(dev, smi: str, smoke: bool = False, families=None,
                  part_words=RANKS_PART_WORDS) -> dict:
    """[ranks] (e)-(f) of ``families`` (RANKS_FAMILIES; RANKS_SSM gives
    (g)-(h); module docstring) for ``run_ranks``: the one-rank
    references (their weights freed), then the families' jobs in a
    world of 2 ranks and one of 4 ((e)-(f): (e) over (1, 2) for both
    families; (f) for mixtral over (1, 4); (e) and (f) for deepseek over
    (2, 2); ``part_words``: a row-parallel GEMM on part words over
    (1, 4)).  ``smoke``: reduced width on the CPU (a rehearsal).  The
    report returns the launches of each family's runs over ranks,
    summed over the ranks."""
    import shutil
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import rank_weight_bytes
    families = RANKS_FAMILIES if families is None else families
    t0 = time.perf_counter()
    refs = {}
    for a in families:
        refs[a] = family_reference(dev, a, smoke)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    worlds = {2: [], 4: []}
    for arch, spec in families.items():
        by_size = {}
        for s in spec["prefill"] + [spec["engine"]]:
            by_size.setdefault(s[0] * s[1], []).append(s)
        for size, shapes in by_size.items():
            worlds[size].append({
                "ref": refs[arch],
                "prefill": [s for s in spec["prefill"] if s in shapes],
                "engine": spec["engine"] if spec["engine"] in shapes
                else None})
    if part_words:
        worlds[4][0]["part_words"] = ((1, 4), part_words)
    worlds = {size: jobs for size, jobs in worlds.items() if jobs}
    for jobs in worlds.values():
        for job in jobs:
            cfg = job["ref"]["cfg"]
            for s in dict.fromkeys(job["prefill"] + [job["engine"]]):
                if s is not None:
                    log_weight_bytes(cfg, s, rank_weight_bytes(cfg, s))

    def report(recs_by_size: dict) -> dict:
        paths = {f"ranks_{a.split('-')[0]}": {k.name: 0 for k in ops.KERNELS}
                 for a in families}
        for size, jobs in worlds.items():
            recs = recs_by_size[size]
            for j, job in enumerate(jobs):
                report_family_job(job, [r[j] for r in recs], paths, smi,
                                  dev)
        for arch in families:
            need = FAMILY_KERNELS[arch]
            got = paths[f"ranks_{arch.split('-')[0]}"]
            missing = [k for k in need if got.get(k, 0) <= 0]
            if dev.type == "cuda" and missing:
                raise AssertionError(f"[ranks] {arch}: {missing} never "
                                     "launched over ranks")
        log(f"[ranks] {', '.join(families)} launches {json.dumps(paths)}; "
            f"{time.perf_counter() - t0:.1f} s since the one-rank runs")
        return paths

    def cleanup():
        for ref in refs.values():
            shutil.rmtree(ref["tmp"], ignore_errors=True)
    return {"parts": {size: (ranks_family_worker, (jobs,))
                      for size, jobs in worlds.items()},
            "report": report, "cleanup": cleanup}


def phase_ranks_families(dev, smi: str, smoke: bool = False,
                         families=None, part_words=RANKS_PART_WORDS
                         ) -> dict[str, dict[str, int]]:
    """[ranks] (e)-(h) alone (``families_prep``)."""
    return run_ranks(dev, [families_prep(dev, smi, smoke, families,
                                         part_words)])[0]


# ------------------------------------------------- [ranks] (i)-(j): training
#
# bnn-lm-100m at published width (RANKS_TRAIN_LAYERS of its 12 layers)
# trained at "bnn_train" over a
# (2, 2) mesh of spawned ranks (FSDP: the params placed by the train
# rules, each layer gathered over "data" at its use and again on the
# remat recompute; the collectives differentiable, dist/spmd.py), held
# to one rank's run of the same weights on the card; then the trained
# shards re-placed by the decode rules and served over the mesh through
# the kernels, held bit-equal to one rank's engine on the gathered
# weights.

RANKS_TRAIN = dict(seq_len=256, global_batch=8, microbatches=2, steps=3,
                   lr=1e-3)
RANKS_TRAIN_SMOKE = dict(RANKS_TRAIN, seq_len=32)   # the CPU rehearsal
# (i)'s depth: 6 of bnn-lm-100m's 12 layers at its published width (the
# whole smoke took 1186.6-1368.3 s on slow hosts with 12: PERF.md, PR 29)
RANKS_TRAIN_LAYERS = 6
# what a phase measured that a later one holds something against: (i)'s
# step's collectives ([analytic] (f))
MEASURED: dict = {}
RANKS_TRAIN_SHAPE = (2, 2)
# the CPU tests' bounds (tests/_torch_ranks_train.py)
RANKS_TRAIN_LOSS_REL = 1e-5      # step 0's loss and gradient norm
RANKS_TRAIN_GRAD_REL = 1e-5      # each leaf, of its largest |element|
RANKS_TRAIN_PARAM = dict(rtol=5e-3, atol=1e-4)   # after the steps, lr 1e-3
RANKS_TRAIN_SERVE = dict(n=8, new=16, prompt_lens=(64, 256))
# (i)'s peak a rank while training (GiB, ranks in order) when the loss
# gathered the head whole and took each chunk over the whole vocab, as
# this script measured it on an NVIDIA H100 80GB HBM3 at 700.00 W:
# printed beside the vocab-parallel loss's
RANKS_TRAIN_PEAK_WHOLE_VOCAB_GIB = (1.945, 1.949, 1.949, 1.948)


def train_step_collectives(cfg, sizes, shape) -> dict:
    """One (i) step's collectives on a rank of the ``shape`` (data,
    model) mesh by kind, calls and the bytes sent into them, predicted
    from the dense tied ``cfg``'s param shapes under the FSDP train rules
    and the step's structure (``launch/steps``, remat on, ``dist/spmd``'s
    backward convention), a microbatch at a time: a leaf cut over
    ``data`` is gathered at each use (a layer's again on the recompute)
    and its gradient reduce-scattered back; a row-parallel weight is
    gathered over ``model`` too for its alpha's value
    (``ops._train_alpha``), without a gradient; a row-parallel STE GEMM
    (o, down) all-reduces its product and its alpha forward, on the
    recompute and backward; the vocab-parallel lookup all-reduces the
    rank's rows of the microbatch's embeddings forward and backward.
    The loss (``transformer.loss_fn``, chunks of ``launch.train``'s
    ``min(512, seq_len)``; ``model`` cuts the vocab): the rank's slice
    of the tied head gathered over ``data`` alone and its gradient
    reduce-scattered back; a chunk all-reduces its rows' max and its
    stacked pair of sums (the exp-sum and the gold logit) over
    ``model`` forward and again on the recompute, and the pair's
    gradient backward.  Then the loss's sum and count over
    ``data`` forward and the sum's gradient; a leaf held whole over a
    mesh dim all-reduces its gradient there.  Then the update's norm:
    a stack of sums a group of leaves cut alike, a collective a cut
    dim."""
    import collections
    import types
    from repro_torch.dist import sharding as S
    from repro_torch.layers.common import logical_to_pspec
    from repro_torch.models import transformer as M
    if set(M.layer_plan(cfg)) != {("gqa", "dense")} or \
            not cfg.tie_embeddings or shape[1] == 1 or cfg.vocab % shape[1]:
        raise ValueError("train_step_collectives: dense tied configs over "
                         "a mesh whose model dim cuts the vocab only")
    size = {"data": shape[0], "model": shape[1]}
    rules = S.rules_train(False, fsdp=True)
    g = sizes["microbatches"]
    mb_tokens = sizes["global_batch"] // g * sizes["seq_len"]
    rows = mb_tokens // size["data"]           # a rank's tokens
    d, f4 = cfg.d_model, 4
    out: collections.Counter = collections.Counter()
    groups: collections.Counter = collections.Counter()

    def add(kind, n, nbytes):
        out[kind] += n
        out[kind + "_bytes"] += n * nbytes

    def leaf(axes, t, in_layer):
        spec = logical_to_pspec(tuple(axes), rules, tuple(t.shape),
                                types.SimpleNamespace(shape=size))
        local, cut = list(t.shape), set()
        for i, e in enumerate(spec):
            for a in (e if isinstance(e, tuple) else (e,) if e else ()):
                local[i] //= size[a]
                cut.add(a)
        nbytes = math.prod(local) * f4
        groups[tuple(a for a in size if a in cut)] += 1
        if "data" in cut:
            add("all_gather", g * (2 if in_layer else 1), nbytes)
            add("reduce_scatter", g, nbytes * size["data"])
        if in_layer and len(spec) == 2 and spec[0] == "model":
            # a row-parallel weight's alpha: one rank's mean over the
            # whole K, gathered over "model" (forward and recompute)
            add("all_gather", 2 * g, nbytes * size["data"])
        for a in size:
            if a not in cut and size[a] > 1:
                add("all_reduce", g, nbytes)
        return t
    params = M.trainable(M.abstract_init(cfg), cfg)
    for key, specs in M.param_specs(cfg).items():
        S.map_specs(lambda a, t: leaf(a, t, key == "layers"), specs,
                    params[key])
    b_e = params["embed"]["w"].numel() * f4 // (size["data"] * size["model"])
    add("all_gather", g, b_e)
    add("reduce_scatter", g, b_e * size["data"])
    chunk = min(512, sizes["seq_len"])
    n = g * -(-sizes["seq_len"] // chunk)
    per = rows // sizes["seq_len"] * chunk * f4
    add("all_reduce", 2 * n, per)
    add("all_reduce", 3 * n, 2 * per)
    n_row = 3 * g * 2 * cfg.n_layers
    add("all_reduce", n_row, rows * d * f4)
    add("all_reduce", n_row, d * f4)
    add("all_reduce", 2 * g, rows * d * f4)
    add("all_reduce", 3 * g, f4)
    for cut, n in groups.items():
        add("all_reduce", len(cut), n * f4)
    return dict(out)


def ranks_train_reference(dev, cfg, sizes, path: str, smoke: bool) -> dict:
    """(i)'s one rank on ``dev``: step 0's ``value_and_grad`` on batch 0
    (loss, gradient norm, every gradient, every BNN projection's input),
    then ``launch.train`` for the steps from the same weights, with the
    phase's microbatches and with one (the spread of a run that only
    rounds otherwise): each step's metrics and ms.  The tensors go to
    ``path`` (on the host) for the ranks; the rest is returned."""
    from repro_torch import tree as T
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_tensors
    from repro_torch.launch import steps
    from repro_torch.launch.train import train, train_init
    from repro_torch.optim.optimizer import global_norm
    params = train_init(cfg, dev, 0)
    data = SyntheticLM(DataConfig(cfg.vocab, sizes["seq_len"],
                                  sizes["global_batch"], seed=0))
    with projection_inputs() as inputs:
        loss, _, grads = steps.value_and_grad(
            params, cfg, to_tensors(data.batch(0), dev),
            loss_chunk=min(512, sizes["seq_len"]), remat=False)
    ref = {"loss": float(loss), "grad_norm": float(global_norm(grads))}
    torch.save({"grads": T.map_(lambda g: g.cpu(), grads),
                "inputs": [x.cpu() for x in inputs]}, path)
    del grads
    kw = dict(smoke=smoke, steps=sizes["steps"],
              global_batch=sizes["global_batch"], seq_len=sizes["seq_len"],
              lr=sizes["lr"], precision="bnn_train", device=dev,
              log_every=10 ** 6)
    metrics, step_ms, mb1 = [], [], []
    train(TRAIN_ARCH, microbatches=1, params=train_init(cfg, dev, 0),
          metrics=mb1, **kw)
    train(TRAIN_ARCH, microbatches=sizes["microbatches"], params=params,
          metrics=metrics, step_ms=step_ms, **kw)
    return {**ref, "metrics": metrics, "step_ms": step_ms, "mb1": mb1}


def ranks_train_last_step(dev, cfg, sizes, ckpt_dir: str) -> dict:
    """(i)'s last step taken again by one rank on ``dev`` from the
    state the mesh's ``launch.train`` checkpointed before it (whole:
    params, m, v, the step): its metrics and the elements of the params
    after it beyond ``RANKS_TRAIN_PARAM`` of the mesh's checkpoint
    after it."""
    from repro_torch import tree as T
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_tensors
    from repro_torch.launch import steps
    from repro_torch.launch.train import adamw_config, train_init
    from repro_torch.models import transformer as M
    from repro_torch.optim import optimizer as opt
    last = sizes["steps"] - 1
    ocfg = adamw_config(sizes["lr"], sizes["steps"])
    like = train_init(cfg, dev, 0)
    tree = M.trainable(like, cfg)
    mgr = CheckpointManager(ckpt_dir, keep=2)
    (before, state), at = mgr.restore((tree, opt.init(ocfg, tree)), last)
    (after, _), _ = mgr.restore((tree, state), last + 1)
    del like, tree
    params = dict(before)
    if cfg.tie_embeddings:
        params["head"] = {"w": params["embed"]["w"].t()}
    data = SyntheticLM(DataConfig(cfg.vocab, sizes["seq_len"],
                                  sizes["global_batch"], seed=0))
    _, state, m = steps.build_train_step(
        cfg, ocfg, microbatches=sizes["microbatches"],
        loss_chunk=min(512, sizes["seq_len"]))(
        params, state, to_tensors(data.batch(last), dev))
    tol = RANKS_TRAIN_PARAM
    misses = sum(int(((p - w).abs() > tol["atol"] + tol["rtol"] * w.abs())
                     .sum()) for p, w in zip(T.leaves(M.trainable(params, cfg)),
                                             T.leaves(after), strict=True))
    return {"step": at, "misses": misses,
            **{k: float(v) for k, v in m.items()}}


def _leaf_errors(tree, want, dev) -> tuple[dict[str, float], list[str]]:
    """Each DTensor leaf of ``tree`` gathered whole against the same
    leaf of ``want`` (host tensors): {path: the largest |diff| over the
    leaf's largest |element|}, and the leaves all zeros where
    ``want``'s is not."""
    from repro_torch import tree as T
    from repro_torch.dist import spmd
    errs, zero = {}, []
    for path, g, w in zip(T.paths(tree), T.leaves(tree), T.leaves(want),
                          strict=True):
        gw, w = spmd.full(g).float(), w.to(dev).float()
        errs[path] = float((gw - w).abs().max() /
                           w.abs().max().clamp_min(1e-30))
        if not gw.any() and w.any():
            zero.append(path)
    return errs, zero


def _input_flips(seen, want, dev) -> list[dict]:
    """Every BNN projection's input over the mesh (``seen``, gathered
    whole) against one rank's (``want``, in call order): bit-equal or
    not, the largest |diff|, the STE sign flips and the farthest flip
    from zero in units of its row's RMS."""
    out = []
    for xa, xb in zip(seen, want, strict=True):
        xa, xb = xa.float(), xb.to(dev).float()
        flip = (xa >= 0) != (xb >= 0)
        rms = xb.square().mean(dim=-1, keepdim=True).sqrt().clamp_min(1e-30)
        far = float(((torch.maximum(xa.abs(), xb.abs()) / rms) * flip).max())
        out.append({"equal": bool(torch.equal(xa, xb)),
                    "max_diff": float((xa - xb).abs().max()),
                    "flips": int(flip.sum()), "far": far})
    return out


class _StepCollectives(list):
    """``launch.train``'s ``metrics`` list that also takes
    ``spmd.COLLECTIVES`` as each step's metrics arrive (before any
    checkpoint of that step)."""

    def __init__(self):
        super().__init__()
        self.seen: list[dict] = []

    def append(self, m):
        from repro_torch.dist import spmd
        self.seen.append(dict(spmd.COLLECTIVES))
        super().append(m)

    def of_step(self, i: int) -> dict:
        """Step ``i``'s collectives (the counts since step ``i - 1``)."""
        before = self.seen[i - 1] if i else {}
        return {k: v - before.get(k, 0) for k, v in self.seen[i].items()}


def ranks_train_worker(world, cfg, sizes, shape, ref_path, ckpt_dir,
                       prompts, ecfg, smoke):
    """One rank of (i)-(j) (module docstring, [ranks]): the seeded
    weights drawn and kept by the train rules (``init_on_ranks``); step
    0's gradients and projection inputs against one rank's
    (``ref_path``); ``launch.train``'s steps over the mesh, a checkpoint
    into ``ckpt_dir`` before the last and after it; the trained shards
    re-placed by the decode rules and served by the engine over the
    mesh (every rank's tokens compared at every step), then, on rank 0,
    by one rank's engine on the gathered weights."""
    from repro_torch import tree as T
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_tensors
    from repro_torch.dist import sharding as S, spmd
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import init_on_ranks
    from repro_torch.launch.train import train
    from repro_torch.layers import common as C
    from repro_torch.models import transformer as M
    from repro_torch.optim.optimizer import global_norm
    from repro_torch.serving import Engine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, on_card = world.device, world.device.type == "cuda"
    mesh = _ranks_mesh(world, shape)
    rules = S.train_rules_of(mesh)
    ref = torch.load(ref_path, mmap=True, weights_only=False)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_on_ranks(torch.Generator(device=dev).manual_seed(0), cfg,
                           mesh, device=dev, rules=rules)
    rec = {"init_s": time.perf_counter() - t0, "weight_bytes": sum(
        spmd.local(v).numel() * spmd.local(v).element_size()
        for v in T.leaves(M.trainable(params, cfg)))}
    data = SyntheticLM(DataConfig(cfg.vocab, sizes["seq_len"],
                                  sizes["global_batch"], seed=0))
    chunk = min(512, sizes["seq_len"])
    with C.sharding_context(mesh, rules), \
            projection_inputs(spmd.full) as inputs:
        loss, _, grads = steps.value_and_grad(
            params, cfg, to_tensors(data.batch(0), dev), loss_chunk=chunk,
            remat=False)
    with C.sharding_context(mesh, rules):
        rec["grad_norm"] = float(global_norm(grads))
    rec["loss"] = float(loss)
    rec["grad_errs"], rec["zero_grads"] = _leaf_errors(grads, ref["grads"],
                                                       dev)
    rec["inputs"] = _input_flips(inputs, ref["inputs"], dev)
    del grads, inputs
    metrics, step_ms = _StepCollectives(), []
    spmd.COLLECTIVES.clear()
    train(TRAIN_ARCH, smoke=smoke, steps=sizes["steps"],
          global_batch=sizes["global_batch"], seq_len=sizes["seq_len"],
          microbatches=sizes["microbatches"], lr=sizes["lr"],
          precision="bnn_train", device=dev, params=params, mesh=mesh,
          metrics=metrics, step_ms=step_ms, log_every=10 ** 6,
          ckpt_dir=ckpt_dir, ckpt_every=sizes["steps"] - 1)
    rec["step_collectives"] = metrics.of_step(1)   # no checkpoint in it
    rec.update(metrics=list(metrics), step_ms=step_ms,
               train_peak_bytes=(torch.cuda.max_memory_allocated(dev)
                                 if on_card else 0))
    # (j): the trained shards under the decode rules, served over the mesh
    bnn = cfg.replace(precision="bnn")
    served = S.replace_params(params, bnn, mesh, S.decode_rules_of(mesh))
    del params
    gc.collect()
    ops.reset_launches()
    eng = Engine(served, bnn, ecfg, device=dev, mesh=mesh, check_ranks=True)
    rids = [eng.submit(p, RANKS_TRAIN_SERVE["new"]) for p in prompts]
    t1 = time.perf_counter()
    got = eng.run()
    _sync(dev)
    rec["serve_s"] = time.perf_counter() - t1
    rec["tokens"] = [got[r].tolist() for r in rids]
    rec["launches"] = {k.name: k.launches for k in ops.KERNELS}
    del eng
    whole = S.gather_tree(served)
    del served
    if world.rank == 0:
        eng = Engine(whole, bnn, ecfg, device=dev)
        rids = [eng.submit(p, RANKS_TRAIN_SERVE["new"]) for p in prompts]
        got = eng.run()
        rec["one_rank_tokens"] = [got[r].tolist() for r in rids]
        del eng
    del whole
    return rec


def train_ranks_prep(dev, smi: str, smoke: bool = False) -> dict:
    """[ranks] (i)-(j) (module docstring) for ``run_ranks``: one rank's
    reference run on ``dev`` (freed before the ranks start), then a
    world of 4 ranks trains over (2, 2) and serves the trained weights.
    ``smoke``: reduced width on the CPU (a rehearsal).  The report
    returns (j)'s launches, summed over the ranks."""
    import shutil
    import tempfile
    from repro_torch import configs
    from repro_torch.configs.base import reduced
    from repro_torch.launch.mesh import rank_weight_bytes
    from repro_torch.serving import EngineConfig
    t0 = time.perf_counter()
    cfg = configs.get_config(TRAIN_ARCH).replace(precision="bnn_train")
    cfg = reduced(cfg) if smoke else cfg.replace(n_layers=RANKS_TRAIN_LAYERS)
    sizes = RANKS_TRAIN_SMOKE if smoke else RANKS_TRAIN
    shape = RANKS_TRAIN_SHAPE
    size = shape[0] * shape[1]
    b = rank_weight_bytes(cfg, shape, train=True)
    log(f"[ranks] (i) {cfg.name} precision={cfg.precision} d_model="
        f"{cfg.d_model} layers={cfg.n_layers} vocab={cfg.vocab} over "
        f"{shape}: batch {sizes['global_batch']} x {sizes['seq_len']}, "
        f"microbatches {sizes['microbatches']}, remat on, {sizes['steps']} "
        f"steps at lr {sizes['lr']}; reckoned a rank keeps "
        f"{b['rank'] / 2 ** 30:.3f} GiB of params, "
        f"{b['train'] / 2 ** 30:.3f} GiB with m, v and the gradients "
        f"(whole model {b['whole'] / 2 ** 30:.3f} GiB, x 4 "
        f"{4 * b['whole'] / 2 ** 30:.3f}); {smi}")
    sv = RANKS_TRAIN_SERVE
    prompts = traffic(cfg.vocab, sv["n"], sv["prompt_lens"], seed=6)
    ecfg = EngineConfig(block_size=16, num_blocks=1025, max_batch=8,
                        prefill_chunk=128,
                        max_model_len=sv["prompt_lens"][1] + sv["new"],
                        **NO_PREFIX)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ranks_train_")
    try:
        path = f"{tmp}/ref.pt"
        one = ranks_train_reference(dev, cfg, sizes, path, smoke)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(f"[ranks] (i) one rank's reference run: "
        f"{time.perf_counter() - t0:.1f} s")
    return {"parts": {size: (ranks_train_worker,
                             (cfg, sizes, shape, path, f"{tmp}/ckpt",
                              prompts, ecfg, smoke))},
            "report": functools.partial(
                ranks_train_report, dev, smi, cfg, sizes, shape, one, b,
                f"{tmp}/ckpt"),
            "cleanup": lambda: shutil.rmtree(tmp, ignore_errors=True)}


def phase_ranks_train(dev, smi: str, smoke: bool = False) -> dict:
    """[ranks] (i)-(j) alone (``train_ranks_prep``)."""
    return run_ranks(dev, [train_ranks_prep(dev, smi, smoke)])[0]


def ranks_train_report(dev, smi, cfg, sizes, shape, one, b, ckpt_dir,
                       recs_by_size) -> dict:
    """(i)-(j)'s gates and lines from the ranks' records (rank order)
    and one rank's reference run ``one``: the last step again on one
    rank from the mesh's checkpoint in ``ckpt_dir``, then every gate."""
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    size = shape[0] * shape[1]
    tokens = sizes["global_batch"] * sizes["seq_len"]
    sv = RANKS_TRAIN_SERVE
    recs = recs_by_size[size]
    last = ranks_train_last_step(dev, cfg, sizes, ckpt_dir)
    log(f"[ranks] (i)-(j) draws {[round(r['init_s'], 1) for r in recs]} s; "
        f"the last step again on one rank {time.perf_counter() - t0:.1f} s")
    r0 = recs[0]
    worst = sorted(r0["grad_errs"].items(), key=lambda kv: -kv[1])
    ins = r0["inputs"]
    log(f"[ranks] (i) step 0's BNN projection inputs over the mesh against "
        f"one rank's: {sum(x['equal'] for x in ins)} of {len(ins)} "
        f"bit-equal (first differing: "
        f"{next((i for i, x in enumerate(ins) if not x['equal']), None)}), "
        f"largest |diff| {max(x['max_diff'] for x in ins):.3g}, STE sign "
        f"flips {sum(x['flips'] for x in ins)} (farthest "
        f"{max(x['far'] for x in ins):.3g} x its row's RMS); gradients: "
        f"worst leaves {[(k, float(f'{v:.3g}')) for k, v in worst[:6]]}, "
        f"{sum(v > RANKS_TRAIN_GRAD_REL for v in r0['grad_errs'].values())} "
        f"of {len(worst)} beyond {RANKS_TRAIN_GRAD_REL}")
    log(f"[ranks] (i) per projection (equal, max |diff|, flips): " +
        " ".join(f"{i}:{int(x['equal'])},{x['max_diff']:.2g},{x['flips']}"
                 for i, x in enumerate(ins)))
    fails = []
    for r, rec in enumerate(recs):
        loss_rel = abs(rec["loss"] - one["loss"]) / abs(one["loss"])
        norm_rel = abs(rec["grad_norm"] - one["grad_norm"]) / one["grad_norm"]
        err = max(rec["grad_errs"].values())
        if loss_rel > RANKS_TRAIN_LOSS_REL or norm_rel > RANKS_TRAIN_LOSS_REL \
                or err > RANKS_TRAIN_GRAD_REL or rec["zero_grads"]:
            fails.append(
                f"[ranks] (i) rank {r} step 0 against one rank: loss rel "
                f"{loss_rel:.3g}, grad norm rel {norm_rel:.3g}, worst leaf "
                f"{err:.3g}, all-zero gradients {rec['zero_grads']}")
        m0 = rec["metrics"][0]
        if abs(m0["loss"] - one["metrics"][0]["loss"]) > \
                RANKS_TRAIN_LOSS_REL * abs(one["metrics"][0]["loss"]) or \
                abs(m0["grad_norm"] - one["metrics"][0]["grad_norm"]) > \
                RANKS_TRAIN_LOSS_REL * one["metrics"][0]["grad_norm"]:
            fails.append(f"[ranks] (i) rank {r}: launch.train's first step "
                         f"{m0} against one rank's {one['metrics'][0]}")
        if rec["tokens"] != r0["one_rank_tokens"]:
            got = rec["tokens"]
            bad = [i for i in range(len(got))
                   if got[i] != r0["one_rank_tokens"][i]]
            fails.append(f"[ranks] (j) rank {r}: requests {bad} "
                         "differ from one rank's engine")
    log(f"[ranks] (i) step 0 against one rank (all {size} ranks): loss "
        f"{r0['loss']:.7f} / {one['loss']:.7f}, grad norm "
        f"{r0['grad_norm']:.7f} / {one['grad_norm']:.7f}, worst leaf "
        f"{worst[0][0]} within {worst[0][1]:.3g} of its largest "
        f"element (gate {RANKS_TRAIN_GRAD_REL}); all-zero gradients "
        f"{r0['zero_grads']}")
    def losses(ms):
        return " ".join(f"{m['loss']:.6f}" for m in ms)

    def norms(ms):
        return " ".join(f"{m['grad_norm']:.6f}" for m in ms)
    log(f"[ranks] (i) {sizes['steps']} free steps of launch.train: losses "
        f"{losses(r0['metrics'])} over the mesh, {losses(one['metrics'])} "
        f"one rank, {losses(one['mb1'])} one rank at microbatches 1; grad "
        f"norms {norms(r0['metrics'])} / {norms(one['metrics'])} / "
        f"{norms(one['mb1'])}")
    lm = r0["metrics"][-1]
    rel = {k: abs(last[k] - lm[k]) / abs(lm[k])
           for k in ("loss", "grad_norm", "lr")}
    log(f"[ranks] (i) the last step (step {last['step']}) again on one rank "
        f"from the mesh's checkpoint before it: loss {last['loss']:.7f} / "
        f"{lm['loss']:.7f}, grad norm {last['grad_norm']:.7f} / "
        f"{lm['grad_norm']:.7f}, lr rel {rel['lr']:.3g}; {last['misses']} "
        f"parameter elements beyond rtol {RANKS_TRAIN_PARAM['rtol']} atol "
        f"{RANKS_TRAIN_PARAM['atol']} of the mesh's checkpoint after it")
    if rel["loss"] > RANKS_TRAIN_LOSS_REL or \
            rel["grad_norm"] > RANKS_TRAIN_LOSS_REL or rel["lr"] > 1e-6 or \
            last["misses"]:
        fails.append(f"[ranks] (i) the last step on one rank from the mesh's "
                     f"checkpoint: {rel}, {last['misses']} parameter misses")
    peaks = [round(r["train_peak_bytes"] / 2 ** 30, 3) for r in recs]
    kept = [round(r["weight_bytes"] / 2 ** 30, 3) for r in recs]
    log(f"[ranks] (i) a rank keeps {kept} GiB of params (reckoned "
        f"{b['rank'] / 2 ** 30:.3f}; with m, v, grads {b['train'] / 2 ** 30:.3f}"
        f"), peak while training {peaks} GiB (the whole-vocab loss's: "
        f"{list(RANKS_TRAIN_PEAK_WHOLE_VOCAB_GIB)} GiB)")
    coll = {k: round(v, 1) for k, v in sorted(r0["step_collectives"].items())}
    MEASURED["ranks_train_step_collectives"] = (
        cfg, sizes, shape, dict(r0["step_collectives"]))
    want = train_step_collectives(cfg, sizes, shape)
    log(f"[ranks] (i) one step's collectives on rank 0 (launch.train's "
        f"step 1, the update's included): {json.dumps(coll)}; "
        f"predicted {json.dumps(dict(sorted(want.items())))}: equal "
        f"{coll == {k: float(v) for k, v in want.items()}}")
    # step 1: no warm-up and no checkpoint (the mesh's run saves after
    # it, and that save's time falls in step 2's)
    ms = r0["step_ms"][min(1, len(r0["step_ms"]) - 1)]
    ms1 = float(np.median(one["step_ms"][1:] or one["step_ms"]))
    log(f"[ranks] (i) step 1 {ms:.1f} ms over (2, 2) "
        f"({[round(x, 1) for x in r0['step_ms']]}), one rank's median "
        f"{ms1:.1f} ms "
        f"({[round(x, 1) for x in one['step_ms']]}): training tokens/s "
        f"{tokens / ms * 1e3:.1f} over the mesh, {tokens / ms1 * 1e3:.1f} "
        f"on one rank ({'4 ranks on one card under gloo' if dev.type == 'cuda' and torch.cuda.device_count() < size else 'a device a rank'}); {smi}")
    launches = {k.name: sum(r["launches"][k.name] for r in recs)
                for k in ops.KERNELS}
    if dev.type == "cuda":
        for name in SERVING_KERNELS:
            if any(r["launches"][name] <= 0 for r in recs):
                raise AssertionError(f"[ranks] (j): {name} never launched "
                                     "on a rank")
    log(f"[ranks] (j) the trained weights re-placed by the decode rules and "
        f"served over {shape}: {sv['n']} prompts x {sv['new']} new, greedy: "
        f"every rank's tokens equal one rank's engine on the gathered "
        f"weights: {not any('(j)' in f for f in fails)} "
        f"({r0['serve_s']:.2f} s); launches summed over the ranks "
        f"{json.dumps(launches)}; {time.perf_counter() - t0:.1f} s")
    if fails:
        raise AssertionError("; ".join(fails))
    return launches


def log_weight_bytes(cfg, shape, b: dict, tag: str = "[ranks]") -> None:
    log(f"{tag} {cfg.name} {cfg.n_layers} layers over {shape}: reckoned "
        f"{b['rank'] / 2 ** 30:.2f} GiB of weights a rank + "
        f"{b['cached'] / 2 ** 30:.2f} cached at first use (MLA's "
        f"k_up/v_up columns of its heads; the SSM layers' whole conv and "
        f"norm scale) (whole "
        f"{b['whole'] / 2 ** 30:.2f}, largest layer drawn whole "
        f"{b['largest_layer'] / 2 ** 30:.2f})")


def log_weights_kept(arch, shape, recs, tag: str = "[ranks]") -> None:
    def gib(key):
        return [round(r[shape][key] / 2 ** 30, 3) for r in recs]
    log(f"{tag} {arch} mesh {shape}: weights kept a rank "
        f"{gib('weight_bytes')} GiB + cached {gib('cached_bytes')} GiB, "
        f"drawn in {[round(r[shape]['init_s'], 1) for r in recs]} s (peak "
        f"GiB while drawing {gib('init_peak_bytes')})")


def report_family_job(job, recs, paths, smi, dev):
    """Check and print one family job's records from every rank."""
    ref = job["ref"]
    arch = ref["arch"]
    pre, eng = ref["letters"]
    path = paths[f"ranks_{arch.split('-')[0]}"]
    for rec in recs:
        for k, v in rec["launches"].items():
            path[k] = path.get(k, 0) + v
    if "part_words" in recs[0]:
        k, n = RANKS_PART_WORDS
        log(f"[ranks] (e) mesh (1, 4): row-parallel fused_bnn at K={k} "
            f"({k // 4} = {k / 4 / 32} words a rank), N={n}, M "
            f"{list(RANKS_GEMM_ROWS)}: bit-equal to one rank's kernel")
    for shape in job["prefill"]:
        pr = recs[0][shape]["prefill"]
        log(f"[ranks] ({pre}) {arch} mesh {shape}: "
            f"{ref['prompts'].shape[0]} x {ref['prompts'].shape[1]} tokens "
            f"in {pr['chunks']} chunks of {ref['chunk']} + {pr['steps']} "
            f"decode steps: logits bit-equal to one rank (max |diff| "
            f"{pr['max_abs_diff']}), {pr['taps']} taps equal one rank's "
            f"prints, {pr['pool_slices']} pool slices equal one rank's, on "
            "every rank")
    shapes = [s for s in dict.fromkeys(job["prefill"] + [job["engine"]])
              if s is not None]
    for shape in shapes:
        log_weights_kept(arch, shape, recs)
    log(f"[ranks] {arch}: peak GiB per rank "
        f"{[round(r['peak_bytes'] / 2 ** 30, 3) for r in recs]}")
    shape = job["engine"]
    if shape is None:
        return
    for i, tag in enumerate(("greedy", "sampled")):
        for r, rec in enumerate(recs):
            got = rec[shape]["engine"]["runs"][i]["tokens"]
            if got != ref["tokens"][i]:
                bad = [b for b in range(len(got)) if got[b] != ref["tokens"][i][b]]
                raise AssertionError(
                    f"[ranks] ({eng}) {arch} mesh {shape} {tag} rank {r}: "
                    f"requests {bad} differ from the one-rank engine")
        run0 = recs[0][shape]["engine"]["runs"][i]
        peaks = [rec[shape]["engine"]["runs"][i]["peak_bytes"] / 2 ** 30
                 for rec in recs]
        log(f"[ranks] ({eng}) {arch} mesh {shape} {tag}: tokens equal the "
            f"one-rank engine's on all {len(recs)} ranks "
            f"({len(ref['traffic'])} requests x {ref['max_new']} new); "
            f"total_tokens_per_s={run0['total_tokens_per_s']:.1f} (one "
            f"rank {ref['tokens_per_s'][i]:.1f}) decode_tokens_per_s="
            f"{run0['decode_tokens_per_s']:.1f} steps={run0['steps']} "
            f"wall_s={run0['wall_s']:.3f}; peak GiB per rank "
            f"{[round(p, 3) for p in peaks]}; a decode step (median of "
            f"{len(run0['decode_collectives'])}): "
            f"{json.dumps(_median_counts(run0['decode_collectives']))}; "
            f"launches summed over ranks "
            f"{json.dumps(_sum_launches(recs, shape, i))}; {smi}")
    if "prefix" in ref:
        report_prefix_run(arch, shape, ref["prefix"],
                          [rec[shape]["prefix"] for rec in recs], smi)


def report_prefix_run(arch, shape, want: dict, runs: list[dict], smi):
    """(h)'s prefix run over ``shape``: every rank's tokens and counts
    one rank's; snapshot hits, the mid-decode preemption's slot back from
    the host bit-equal (``watch_slot_swaps`` raises otherwise)."""
    where = f"[ranks] (h) {arch} mesh {shape} defaults"
    for r, run in enumerate(runs):
        if run["tokens"] != want["tokens"]:
            raise AssertionError(f"{where} rank {r}: tokens differ from the "
                                 "one-rank engine's")
        for k in ("forced", "host_trips_checked", "snapshot_hits",
                  "skipped_prefill_tokens", "swapped_slots",
                  "readopted_snapshots"):
            if run[k] != want[k]:
                raise AssertionError(f"{where} rank {r}: {k} {run[k]}, one "
                                     f"rank {want[k]}")
    run = runs[0]
    if run["snapshot_hits"] <= 0 or "mid_decode" not in run["forced"] \
            or run["host_trips_checked"] < 1:
        raise AssertionError(f"{where}: snapshot_hits="
                             f"{run['snapshot_hits']}, forced {run['forced']}"
                             f", host trips checked "
                             f"{run['host_trips_checked']}")
    log(f"{where}: {len(want['tokens'])} requests on shared heads x "
        f"{RANKS_PREFIX_NEW} new: tokens equal one rank's on all "
        f"{len(runs)} ranks; snapshot_hits={run['snapshot_hits']} "
        f"skipped_prefill_tokens={run['skipped_prefill_tokens']} forced "
        f"preemptions (kind: rid) {run['forced']} swapped_slots="
        f"{run['swapped_slots']} readopted_snapshots="
        f"{run['readopted_snapshots']}; slots back from the host "
        f"bit-equal on every rank: {run['host_trips_checked']}; "
        f"total_tokens_per_s={run['total_tokens_per_s']:.1f} (one rank "
        f"{want['total_tokens_per_s']:.1f}); {smi}")


def _sum_launches(recs, shape, i) -> dict:
    out: dict = {}
    for rec in recs:
        for k, v in rec[shape]["engine"]["runs"][i]["launches"].items():
            if v:
                out[k] = out.get(k, 0) + v
    return out


# --------------------------------------------------------------- phase 4

# taps of the inputs of binarized projections (their sign bits are what
# the XNOR GEMM sees)
BNN_TAPS = ("q", "k", "v", "o", "q_down", "q_up", "kv_down", "gate", "up",
            "down", "moe_in", "moe_down_in", "in_proj", "out_proj")


def _check_signs(where, name, a, b, skip_rows=None) -> set[int]:
    """Sign bits of one BNN input, kernel route ``a`` vs plain ``b``
    (rows = chunk positions); a flip is accepted only within
    FLIP_RMS_FRACTION x its row's RMS of zero, and printed.  Returns the
    positions with accepted flips."""
    n = a.shape[0]
    a2, b2 = a.reshape(n, -1, a.shape[-1]), b.reshape(n, -1, b.shape[-1])
    if skip_rows is not None:
        a2, b2 = a2[~skip_rows], b2[~skip_rows]
        pos_of = (~skip_rows).nonzero()[:, 0]
    else:
        pos_of = torch.arange(n, device=a.device)
    diff = (a2 >= 0) != (b2 >= 0)
    if not diff.any():
        return set()
    rms = b2.float().pow(2).mean(dim=-1, keepdim=True).sqrt()
    near = b2.abs() <= FLIP_RMS_FRACTION * rms
    if (diff & ~near).any():
        raise AssertionError(f"{where} {name}: {int((diff & ~near).sum())} "
                             "sign bits differ away from 0")
    flipped = set()
    for i, j, col in diff.nonzero().tolist():
        pos = int(pos_of[i])
        flipped.add(pos)
        FLIP_POSITIONS.append(pos)
        v, r = b2[i, j, col].item(), rms[i, j, 0].item()
        log(f"[e2e] {where} {name} pos {pos} col {col}: sign flip at "
            f"{v:.3g} (row rms {r:.3g}: {abs(v) / r:.3g} x rms from 0)")
    return flipped


def _check_sublayer(where, taps_k, taps_p, y_k, y_p) -> tuple[int, float]:
    """One sublayer (attention, or FFN / MoE) run on the same input by
    both routes: the sign bits of every BNN input, the MoE routing
    (a difference accepted only at a near-tie of the plain path's
    router), and the outputs within MAX_HIDDEN_ERR — at the positions
    no accepted flip or routing difference explains.  Returns (accepted
    flips, max output error)."""
    flipped: set[int] = set()
    probs = differs = None
    for (name, a), (name_p, b) in zip(taps_k, taps_p, strict=True):
        if name != name_p:
            raise AssertionError(f"{where}: taps {name} vs {name_p}")
        if name == "router_probs":
            probs = b
        elif name == "topk":
            differs = (a != b).any(dim=-1)
            for pos in differs.nonzero()[:, 0].tolist():
                top = probs[pos].sort(descending=True).values
                k = a.shape[-1]
                gap = (top[k - 1] - top[k]).item()
                if not gap < MAX_ROUTE_GAP:
                    raise AssertionError(
                        f"{where} pos {pos}: experts {a[pos].tolist()} vs "
                        f"{b[pos].tolist()} with router gap {gap:.3g}")
                log(f"[e2e] {where} pos {pos}: routing {a[pos].tolist()} vs "
                    f"{b[pos].tolist()} at a router near-tie (gap {gap:.3g})")
                flipped.add(pos)
        elif name in BNN_TAPS:
            skip = differs if name == "moe_down_in" else None
            flipped |= _check_signs(where, name, a, b, skip)
    ok = torch.ones(y_k.shape[0], dtype=torch.bool, device=y_k.device)
    ok[list(flipped)] = False
    err = (y_k[ok] - y_p[ok]).abs().max().item() if ok.any() else 0.0
    if not err <= MAX_HIDDEN_ERR:
        raise AssertionError(f"{where}: output differs by {err:.3g}")
    return len(flipped), err


ROUTES = ("auto", "torch")      # the kernels, the plain versions


def _two_routes(where, mix_step, ffn_step, keep=None):
    """One layer on both routes, re-synchronised at each sublayer:
    ``mix_step(route, taps)`` and ``ffn_step(route, xm, taps)`` run the
    mixer and the FFN / MoE sublayer (with its residual); both routes
    take the kernel route's input.  ``keep(label, taps, y)`` receives
    the kernel route's taps and output of each sublayer.  Returns
    (kernel route's layer output, plain route's, accepted flips, worst
    output error); each tap and output is (rows, ...) over the checked
    rows."""
    flips, worst = 0, 0.0
    ys, taps = {}, {}
    for r in ROUTES:
        taps[r] = []
        ys[r] = mix_step(r, taps[r])
    nf, err = _check_sublayer(f"{where} attn", taps["auto"], taps["torch"],
                              ys["auto"][1], ys["torch"][1])
    flips, worst = flips + nf, max(worst, err)
    if keep:
        keep("attn", taps["auto"], ys["auto"][1])
    outs, ftaps = {}, {}
    for r in ROUTES:
        ftaps[r] = []
        outs[r] = ffn_step(r, ys["auto"][0], ftaps[r])
    nf, err = _check_sublayer(f"{where} ffn", ftaps["auto"], ftaps["torch"],
                              outs["auto"][1], outs["torch"][1])
    flips, worst = flips + nf, max(worst, err)
    if keep:
        keep("ffn", ftaps["auto"], outs["auto"][1])
    return outs["auto"][0], outs["torch"][0], flips, worst


def _teacher_forced(params, cfg, seq: np.ndarray, chunk: int, bs: int,
                    ring_blocks: int, dev, where: str, keep_from: int,
                    tail_chunk: int | None = None):
    """Prefill ``seq`` in chunks through the kernels ("auto") and the
    plain versions ("torch") on fresh pools (``tail_chunk``, when given:
    the first ``keep_from`` positions in chunks of ``chunk``, the rest in
    chunks of ``tail_chunk``), layer by layer and
    re-synchronised at every sublayer: both routes run each attention
    and each FFN / MoE on the kernel route's input, so a difference is
    held to the sublayer that made it.  Returns (kernel route's logits
    (T, V), plain route's logits, accepted flips, worst output error,
    the kernel route's sublayers at positions >= ``keep_from``:
    {position: [(label, taps, output)]})."""
    from repro_torch.layers import common as C
    from repro_torch.models import transformer as M
    t = len(seq)
    # a ring table is exactly the ring wide: positions wrap modulo it;
    # SSM layers run in recurrent slot 1
    mb = ring_blocks or -(-t // bs)
    pools = {r: M.init_paged_state(cfg, mb + 1, bs, 2, device=dev)
             for r in ROUTES}
    table = torch.arange(1, mb + 1, dtype=torch.int32, device=dev)[None]
    slots = torch.ones(1, dtype=torch.int32, device=dev)
    logits = {r: [] for r in ROUTES}
    kept: dict[int, list] = {}
    flips, worst = 0, 0.0
    starts = list(range(0, t, chunk))
    if tail_chunk:
        starts = list(range(0, keep_from, chunk)) + list(
            range(keep_from, t, tail_chunk))
    with torch.no_grad():
        for i_s, pos in enumerate(starts):
            end = starts[i_s + 1] if i_s + 1 < len(starts) else t
            n = end - pos
            width = max(n, tail_chunk or 0) if pos >= keep_from and \
                tail_chunk else chunk
            toks = torch.zeros((1, width), dtype=torch.int64, device=dev)
            toks[0, :n] = torch.from_numpy(seq[pos:pos + n].astype(np.int64))
            lengths = torch.tensor([pos], dtype=torch.int32, device=dev)
            n_valid = torch.tensor([n], dtype=torch.int32, device=dev)
            x = M._embed(params, cfg, toks)
            for li, (mix, f, p) in enumerate(M._iter_layers(cfg, params)):
                h = C.norm(x, p["norm1"], cfg.norm, cfg.norm_eps)

                def mix_step(r, taps, li=li, mix=mix, p=p, h=h):
                    y = M.mixer_prefill(
                        mix, p["attn"], cfg, h, pools[r][li], table, lengths,
                        n_valid, slots, ring=bool(ring_blocks), impl=r,
                        taps=taps)
                    taps[:] = [(nm, v[0, :n]) for nm, v in taps]
                    return x + y, y[0, :n]

                def ffn_step(r, xm, taps, f=f, p=p):
                    y = M._ffn(p, cfg, f, xm, r, paged=True, taps=taps)
                    taps[:] = [(nm, v[0, :n]) for nm, v in taps]
                    return y, y[0, :n]

                def keep(label, taps, y, li=li):
                    for i in range(max(0, keep_from - pos), n):
                        kept.setdefault(pos + i, []).append(
                            (f"layer {li} {label}",
                             [(nm, v[i:i + 1]) for nm, v in taps],
                             y[i:i + 1]))
                x, xp, nf, err = _two_routes(
                    f"{where} pos {pos} layer {li}", mix_step, ffn_step,
                    keep if pos + n > keep_from else None)
                flips, worst = flips + nf, max(worst, err)
            for r, v in (("auto", x), ("torch", xp)):
                v = C.norm(v, params["final_norm"], cfg.norm, cfg.norm_eps)
                logits[r].append(torch.matmul(v, params["head"]["w"])[0, :n])
    return (torch.cat(logits["auto"]), torch.cat(logits["torch"]), flips,
            worst, kept)


def engine_calls(eng, rid: int) -> list[tuple]:
    """The step calls that made request ``rid``'s output, from the
    scheduler's trace after its last admission (recompute preemption
    starts a request over): ("prefill", position, tokens) chunks, then
    ("decode", row, batch) steps, each at the row and padded batch the
    engine gave it."""
    trace = eng.scheduler.trace
    start = max(i for i, e in enumerate(trace)
                if e["event"] == "admit" and e["rid"] == rid)
    calls = []
    for e in trace[start:]:
        if e["event"] == "prefill" and e["rid"] == rid:
            calls.append(("prefill", e["pos"] - e["tokens"], e["tokens"]))
        elif e["event"] == "decode" and rid in e["rids"]:
            calls.append(("decode", e["rids"].index(rid), e["batch"]))
    return calls


def engine_slot(eng, rid: int) -> int:
    """The recurrent slot the engine gave request ``rid`` at its last
    admission (0 for a stack without SSM layers)."""
    return [e["slot"] for e in eng.scheduler.trace
            if e["event"] == "admit" and e["rid"] == rid][-1] or 0


def decode_replay(params, cfg, eng, rid: int, dev, where: str,
                  blocks=None):
    """Re-run request ``rid`` as the engine ran it: the prompt in the
    engine's prefill chunks through the kernels (the chunked re-check
    holds the same chunks against the plain versions), then every
    generated position as a C = 1 ``paged_decode_step`` at the engine's
    row, padded batch, table width and recurrent slot (the other rows
    copy the request, inactive), and, given the physical ``blocks`` it
    held, over a pool of the engine's size in those blocks (else blocks
    1.. of a pool of the table's width), through the kernels and the
    plain versions layer by layer,
    re-synchronised at every sublayer as in ``_teacher_forced``; the
    plain route starts from the kernel route's cache.  Every kernel sees
    the shapes the engine gave it, so the kernel route reproduces the
    engine's tokens exactly.
    Returns (greedy tokens of the kernel route, accepted flips, worst
    output error, the kernel route's decode sublayers {position:
    [(label, taps, output)]})."""
    from repro_torch.layers import common as C
    from repro_torch.models import transformer as M
    req = eng.requests[rid]
    seq = req.full_sequence()
    ecfg, ring = eng.ecfg, bool(eng.cache.ring_blocks)
    chunk, bs = ecfg.prefill_chunk, ecfg.block_size
    mb = eng.cache.table_width
    slot = engine_slot(eng, rid)
    calls = engine_calls(eng, rid)
    if sum(c[0] == "decode" for c in calls) != len(req.out) - 1:
        raise AssertionError(f"{where}: {len(req.out)} tokens from "
                             f"{len(calls)} engine calls")
    if blocks is None:
        n_blocks = mb + 1
        row_table = torch.arange(1, mb + 1, dtype=torch.int32, device=dev)
    else:                          # the engine's table row: 0 past blocks
        n_blocks = ecfg.num_blocks
        row_table = torch.zeros(mb, dtype=torch.int32, device=dev)
        row_table[:len(blocks)] = torch.tensor(blocks, dtype=torch.int32)
    pools = {"auto": M.init_paged_state(cfg, n_blocks, bs, slot + 1,
                                        device=dev)}
    tokens, kept = [], {}
    flips, worst = 0, 0.0
    pos = 0
    with torch.no_grad():
        for kind, a, n in calls:
            if kind == "prefill":          # a = position, n = tokens
                if a != pos:
                    raise AssertionError(f"{where}: prefill at {a}, "
                                         f"expected {pos}")
                toks = torch.zeros((1, chunk), dtype=torch.int64, device=dev)
                toks[0, :n] = torch.from_numpy(seq[a:a + n].astype(np.int64))
                logits, _ = M.prefill_chunk(
                    params, cfg, toks, pools["auto"], row_table[None],
                    torch.tensor([a], dtype=torch.int32, device=dev),
                    torch.tensor([n], dtype=torch.int32, device=dev),
                    torch.tensor([slot], dtype=torch.int32, device=dev),
                    ring=ring, impl="auto")
                tokens.append(int(logits[0, n - 1].argmax()))
                pos += n
                continue
            if "torch" not in pools:       # the plain route's cache
                pools["torch"] = [{k: v.clone() for k, v in layer.items()}
                                  for layer in pools["auto"]]
            bsz, row = n, a                # a = row, n = padded batch
            toks = torch.full((bsz, 1), int(seq[pos]), dtype=torch.int64,
                              device=dev)
            active = torch.zeros(bsz, dtype=torch.bool, device=dev)
            active[row] = True
            table = row_table[None].expand(bsz, mb).contiguous()
            lengths = torch.full((bsz,), pos, dtype=torch.int32, device=dev)
            slots = torch.full((bsz,), slot, dtype=torch.int32, device=dev)
            x = M._embed(params, cfg, toks)
            for li, (mix, f, p) in enumerate(M._iter_layers(cfg, params)):
                h = C.norm(x, p["norm1"], cfg.norm, cfg.norm_eps)

                def mix_step(r, taps, li=li, mix=mix, p=p, h=h):
                    y = M.mixer_decode(
                        mix, p["attn"], cfg, h, pools[r][li], table, lengths,
                        slots, active, ring=ring, impl=r, taps=taps)
                    taps[:] = [(nm, v[row]) for nm, v in taps]
                    return x + y, y[row]

                def ffn_step(r, xm, taps, f=f, p=p):
                    y = M._ffn(p, cfg, f, xm, r, paged=True, taps=taps)
                    taps[:] = [(nm, v[row]) for nm, v in taps]
                    return y, y[row]

                def keep(label, taps, y, li=li):
                    kept.setdefault(pos, []).append(
                        (f"layer {li} {label}", taps, y))
                x, _xp, nf, err = _two_routes(
                    f"{where} decode pos {pos} layer {li}", mix_step,
                    ffn_step, keep)
                flips, worst = flips + nf, max(worst, err)
            v = C.norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
            logits = torch.matmul(v, params["head"]["w"])
            tokens.append(int(logits[row, 0].argmax()))
            pos += 1
    # the prefill's token completes the prompt; each decode makes one more
    return (np.asarray(tokens[len(tokens) - len(req.out):]), flips, worst,
            kept)


def _cross_check(where, kept_replay, kept_chunked, chunk_path) -> int | None:
    """The decode replay against the chunked re-check, kernel route
    against kernel route, sublayer by sublayer in position order: the
    first sublayer where the two part must be a difference that
    ``_check_sublayer`` accepts (a sign flip within FLIP_RMS_FRACTION x
    RMS of zero, an MoE routing difference at a router near-tie); it is
    printed with the two routes, and everything after it is downstream
    of it.  Returns the position where they part, or None."""
    for pos in sorted(kept_replay):
        for (label, taps_r, y_r), (label_c, taps_c, y_c) in zip(
                kept_replay[pos], kept_chunked[pos], strict=True):
            if label != label_c:
                raise AssertionError(f"{where}: {label} vs {label_c}")
            nf, _err = _check_sublayer(
                f"{where} pos {pos} {label} decode replay vs chunked",
                taps_r, taps_c, y_r, y_c)
            if nf:
                log(f"[e2e] {where}: the decode replay (C = 1 decode walk) "
                    f"and the chunked re-check ({chunk_path}) part first at "
                    f"pos {pos} {label}, by an accepted difference printed "
                    "above; later positions are downstream of it")
                return pos
    return None


def _route_gap(kept_replay, kept_chunked) -> tuple[float, int, int]:
    """How far the chunked re-check's BNN inputs are from the replay's at
    the generated positions: (max |difference| / the row's RMS, sign
    flips, flips farther than FLIP_RMS_FRACTION x RMS from 0)."""
    worst, flips, far = 0.0, 0, 0
    for pos in kept_replay:
        for (_l, taps_r, _y), (_l2, taps_c, _y2) in zip(
                kept_replay[pos], kept_chunked[pos], strict=True):
            for (name, a), (_n, b) in zip(taps_r, taps_c, strict=True):
                if name not in BNN_TAPS:
                    continue
                rms = b.float().pow(2).mean().sqrt()
                worst = max(worst, ((a - b).abs().max() / rms).item())
                diff = (a >= 0) != (b >= 0)
                flips += int(diff.sum())
                far += int((diff & (b.abs() > FLIP_RMS_FRACTION * rms)).sum())
    return worst, flips, far


def phase_e2e(dev, cfg, params, eng, out, rids=None, held=None):
    """Two re-checks of finished requests (the first two by default),
    each running the kernels and the plain versions layer by layer: a
    decode replay of what the engine ran, whose kernel route must
    reproduce the engine's greedy tokens exactly, and a teacher-forced
    chunked prefill, which must reproduce them up to the first place
    where it parts from the replay by an accepted difference.
    ``held`` (rid -> the physical blocks the engine gave it) runs the
    replay in the engine's own table.

    The chunked re-check of a stack with SSM layers runs the generated
    positions in the SSD dual form where the engine (and the replay)
    ran the recurrence; how far the two routes' BNN inputs are apart is
    printed (the dual form's decay exp(cum_t - cum_s) is a difference
    of two running sums, so it strays further than attention's rounding
    does)."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import transformer as M
    flips_total = 0
    chunk = eng.ecfg.prefill_chunk
    mixers = {mix for mix, _f in M.layer_plan(cfg)}
    ssm = "ssm" in mixers
    paths = []
    if "mla" in mixers:
        paths.append("MLA tiled 3xTF32 path" if pa.mla_tiled(
            chunk, cfg.n_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim)
            else "MLA decode walk")
    if "gqa" in mixers:
        paths.append("GQA tiled path" if pa.gqa_tiled(
            chunk, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim)
            else "GQA decode walk")
    if ssm:
        paths.append("SSD dual form")
    path = " + ".join(paths) + f", chunks of {chunk}"
    for rid in (sorted(out)[:2] if rids is None else rids):
        req = eng.requests[rid]
        seq = out[rid]
        p = req.prompt_len
        where = f"{cfg.name} rid {rid}"
        t0 = time.perf_counter()
        tok_r, flips, worst_r, kept_r = decode_replay(
            params, cfg, eng, rid, dev, where,
            None if held is None else held[rid])
        replay_s = time.perf_counter() - t0
        flips_total += flips
        if not np.array_equal(tok_r, seq[p:]):
            bad = int((tok_r != seq[p:]).sum())
            raise AssertionError(f"{where}: the decode replay's greedy tokens "
                                 f"differ from the engine's at {bad} "
                                 "positions")
        lg_k, lg_p, flips, worst, kept_c = _teacher_forced(
            params, cfg, seq, chunk, eng.ecfg.block_size,
            eng.cache.ring_blocks, dev, where, keep_from=p)
        flips_total += flips
        if ssm:
            gap, nflip, nfar = _route_gap(kept_r, kept_c)
            log(f"[e2e] {where}: the chunked re-check ({path}) against the "
                f"replay (SSD recurrence) at the generated positions: BNN inputs "
                f"differ by up to {gap:.3g} x RMS, {nflip} sign flips, "
                f"{nfar} of them farther than {FLIP_RMS_FRACTION} x RMS "
                "from 0")
        part = _cross_check(where, kept_r, kept_c, path)
        greedy = lg_k[p - 1:-1].argmax(dim=-1).cpu().numpy()
        # the token at seq[i] comes from the logits at position i - 1
        differ = np.flatnonzero(greedy != seq[p:]) + p - 1
        if differ.size and (part is None or differ.min() < part):
            raise AssertionError(f"{where}: teacher-forced greedy tokens "
                                 f"differ from the engine's at positions "
                                 f"{differ.tolist()}, before any accepted "
                                 "difference from the decode replay")
        lerr = (lg_k - lg_p).abs().max().item()
        if not torch.isfinite(lg_k).all() or not lerr <= MAX_HIDDEN_ERR * 10:
            raise AssertionError(f"{where}: logits differ by {lerr:.3g}")
        log(f"[e2e] {where} tokens={len(seq)} layers={cfg.n_layers} "
            f"slot={engine_slot(eng, rid)} "
            + ("" if held is None else f"blocks={len(held[rid])} ")
            + f"max_sublayer_err={max(worst, worst_r):.3g} "
            f"max_logit_err={lerr:.3g} decode replay reproduces the "
            f"engine's {len(seq) - p} greedy tokens ({replay_s:.2f} s); "
            f"chunked re-check: {len(seq) - p - differ.size} equal"
            + ("" if part is None else
               f", {differ.size} differ after the routes part at pos {part}"))
    log(f"[e2e] {cfg.name} sign flips and routing differences accepted: "
        f"{flips_total}")


# ------------------------------------------------------------- [serve]
#
# The server as users start it: bnn-lm-100m at published width through
# repro_torch.launch.serve's run functions, with the JAX engine's
# defaults (prefix cache, swap preemption), greedy and sampled decoding,
# stop tokens, and the legacy loop.

# phases 3, 4 and 7 run without the prefix cache and with recompute
# preemption, as they did before the engine took the JAX defaults: their
# decode replays assume no adopted blocks
NO_PREFIX = dict(prefix_cache=False, preempt_policy="recompute")
# ~193 blocks: 8 running requests of 400-700 tokens need more than the
# pool holds even with their system prompts shared, so requests swap
SERVE_ENGINE = dict(block_size=16, num_blocks=194, max_batch=8,
                    prefill_chunk=128, max_model_len=1024)
# no pressure: no prefix cache, recompute, a pool for every request
SERVE_CALM = dict(SERVE_ENGINE, num_blocks=1025, **NO_PREFIX)
SERVE_SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.95)
SERVE_NEW, SERVE_LATE, SERVE_LATE_AFTER = 64, 16, 8
SERVE_STOP_ROWS, SERVE_STOP_AT = (3, 17), 10
SERVE_LEGACY = dict(batch=4, prompt_len=128, gen=64)
# the depth of bnn-lm-100m in [ranks] (a)-(d), [serve], [tenants],
# [shards] and [spec]: 4 of its 12 layers at its published width (12
# until the whole smoke outran its 1200 s on slow hosts: the host's
# launches and gloo's waits grow with the layers); phase 3, [train] and
# [analytic] keep all 12
SERVE_LAYERS = 4


def serve_setup(dev, smoke: bool = False):
    """[serve]'s model as ``launch.serve.setup`` draws it (bnn-lm-100m,
    precision "bnn", seed 0), cut to its first SERVE_LAYERS layers
    (``smoke``: the reduced config, whole)."""
    from repro_torch.launch import serve as SV
    cfg, params = SV.setup("bnn-lm-100m", smoke=smoke, precision="bnn",
                           seed=0, device=dev)
    if smoke:
        return cfg, params
    params["layers"] = params["layers"][:SERVE_LAYERS]
    return cfg.replace(n_layers=SERVE_LAYERS), params


def serve_traffic(vocab: int, seed: int = 4) -> list[np.ndarray]:
    """24 prompts: one of 4 system prompts of 384 tokens (24 blocks of
    16), then a unique suffix of 32-256 tokens in whole blocks; requests
    12, 17 and 22 repeat requests 8, 13 and 18 whole, while those still
    hold their blocks (every block matched: the last token is prefilled
    again, into a copy)."""
    rng = np.random.default_rng(seed)
    systems = [rng.integers(0, vocab, 384) for _ in range(4)]
    prompts = [np.concatenate([systems[i % 4], rng.integers(
        0, vocab, 16 * int(rng.integers(2, 17)))]) for i in range(21)]
    for at, src in ((12, 8), (17, 13), (22, 18)):
        prompts.insert(at, prompts[src].copy())
    return prompts


def serve_sampling(b: int, stop=()):
    from repro_torch.serving import SamplingParams
    return SamplingParams(**SERVE_SAMPLING, seed=1000 + b, stop=stop)


def watch_swaps(eng, rec: dict):
    """Wrap the engine's block pool so that every swap-out records the
    request's blocks (every layer's K and V) and every successful
    swap-in checks the restored blocks bit-equal to them."""
    attn = eng.cache.attn
    swap_out, swap_in = attn.swap_out, attn.swap_in
    rec.update(saved={}, checked=0, blocks=0, out_ms=[], in_ms=[])

    def _span_ms(name, call):
        t = attn.tracer.span_total(name)
        ok = call()
        return ok, 1e3 * (attn.tracer.span_total(name) - t)

    def _blocks(req):
        ids = torch.tensor(req.blocks, dtype=torch.long,
                           device=attn._device())
        return [{k: v.index_select(0, ids).clone() for k, v in p.items()}
                for p in attn.pools]

    def out(req, peer=None):
        rec["saved"][req.rid] = _blocks(req)
        n = attn.swapped_blocks
        _ok, ms = _span_ms("swap_out", lambda: swap_out(req, peer=peer))
        rec["out_ms"].append((attn.swapped_blocks - n, ms))

    def back(req):
        ok, ms = _span_ms("swap_in", lambda: swap_in(req))
        want = rec["saved"].pop(req.rid)
        if ok:
            rec["in_ms"].append((len(req.blocks), ms))
            for li, (got, w) in enumerate(zip(_blocks(req), want)):
                for k in w:
                    if not torch.equal(got[k], w[k]):
                        raise AssertionError(
                            f"[serve] rid {req.rid}: layer {li} {k} not "
                            "bit-equal after the swap round trip")
            rec["checked"] += 1
            rec["blocks"] += len(req.blocks)
        elif ok is False:           # deferred: swapped out still
            rec["saved"][req.rid] = want
        return ok

    attn.swap_out, attn.swap_in = out, back


def _serve_line(tag, eng, wall):
    st = eng.stats()
    log(f"[serve] {tag}: total_tokens_per_s={st['total_tokens_per_s']:.1f} "
        f"decode_tokens_per_s={st['decode_tokens_per_s']:.1f} "
        f"steps={st['steps']} decode_calls={st['decode_calls']} "
        f"prefill_calls={st['prefill_calls']} "
        f"prefill_tokens={st['prefill_tokens']} wall_s={wall:.3f}")
    return st


def phase_serve(dev, smi: str, smoke: bool = False, keep=None):
    """The [serve] phase (A-E of the module docstring) on ``dev``:
    bnn-lm-100m at published width, seeded weights (``smoke``: the
    reduced config, as the CPU test runs it; the traffic's lengths and
    content are the same).  Returns (the kernel launches over A-E, A's
    tokens); ``keep["C"]``, when a dict is given, gets C's tokens."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as SV
    from repro_torch.serving import EngineConfig, sample_tokens
    arch = "bnn-lm-100m"
    cfg, params = serve_setup(dev, smoke)
    cuda = dev.type == "cuda"
    prompts = serve_traffic(cfg.vocab)
    ops.reset_launches()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    log(f"[serve] {cfg.name} d_model={cfg.d_model} layers={cfg.n_layers} "
        f"vocab={cfg.vocab} requests={len(prompts)} prompt_tokens="
        f"{sum(map(len, prompts))} new={SERVE_NEW} late={SERVE_LATE} "
        f"after {SERVE_LATE_AFTER} steps; {smi}")

    def serve(tag, ecfg, sampling=None, late=SERVE_LATE, watch=None,
              stops=None):
        def sp(b):
            if sampling is None:
                return SV.SamplingParams()
            return sampling(b, stops.get(b, ())) if stops else sampling(b)
        t0 = time.perf_counter()
        eng, seqs = SV.run(params, cfg, prompts, SERVE_NEW,
                           EngineConfig(**ecfg), sampling=sp,
                           late_after=SERVE_LATE_AFTER if late else 0,
                           n_late=late, watch=watch, device=dev)
        if cuda:
            torch.cuda.synchronize(dev)
        st = _serve_line(tag, eng, time.perf_counter() - t0)
        for b, s in enumerate(seqs):
            if not ((s >= 0) & (s < cfg.vocab)).all():
                raise AssertionError(f"[serve] {tag}: request {b} emitted "
                                     "a token out of the vocab")
        return eng, seqs, st

    def same(tag, got, want, upto=None):
        for b, (g, w) in enumerate(zip(got, want)):
            n = len(w) if upto is None else upto[b]
            if len(g) != n or not np.array_equal(g, w[:n]):
                j = next((i for i in range(min(len(g), n)) if g[i] != w[i]),
                         min(len(g), n))
                raise AssertionError(
                    f"[serve] {tag}: request {b} parts at position {j} "
                    f"(lengths {len(g)} vs {n})")

    # A: greedy, prefix cache and swap (the defaults)
    rec = {}
    eng_a, out_a, st_a = serve("A greedy prefix+swap", SERVE_ENGINE,
                               watch=lambda e: watch_swaps(e, rec))
    pc, sw = st_a["prefix_cache"], st_a["swap"]
    log(f"[serve] A prefix_cache hits={pc['hits']} queries={pc['queries']} "
        f"hit_rate={pc['hit_rate']:.3f} skipped_prefill_tokens="
        f"{pc['skipped_prefill_tokens']} cow_copies={pc['cow_copies']} "
        f"evictions={pc['evictions']} preemptions={st_a['preemptions']}")
    log(f"[serve] A swap swap_outs={sw['swap_outs']} swap_ins={sw['swap_ins']}"
        f" swapped_blocks={sw['swapped_blocks']} readopted_blocks="
        f"{sw['readopted_blocks']} swap_lost={eng_a.scheduler.swap_losts} "
        f"d2h_bytes={sw['swap_out_bytes']} d2h_ms={1e3 * sw['swap_out_s']:.3f}"
        f" h2d_ms={1e3 * sw['swap_in_s']:.3f} checked_swap_ins="
        f"{rec['checked']} checked_blocks={rec['blocks']} "
        f"peak_used_blocks={st_a['mixer']['blocks']['peak_used_blocks']}")
    log(f"[serve] A each swap: out (blocks copied, ms) "
        f"{[(n, round(ms, 3)) for n, ms in rec['out_ms']]}; in (blocks "
        f"held after it, re-adopted ones included, ms) "
        f"{[(n, round(ms, 3)) for n, ms in rec['in_ms']]}")
    if pc["hits"] <= 0 or pc["cow_copies"] <= 0:
        raise AssertionError("[serve] A: no prefix hit or no copy-on-write")
    if sw["swap_outs"] <= 0 or sw["swap_ins"] <= 0:
        raise AssertionError("[serve] A: no swap-out or no swap-in")
    if rec["checked"] != sw["swap_ins"]:
        raise AssertionError("[serve] A: a swap-in went unchecked")
    # B: greedy, no prefix cache, recompute, no pressure
    eng_b, out_b, st_b = serve("B greedy calm", SERVE_CALM)
    same("B == A", out_b, out_a)
    # C: sampled under A's config; D: the same requests all at once
    # under B's; C': two requests stop at their token 10 of C
    eng_c, out_c, st_c = serve("C sampled prefix+swap", SERVE_ENGINE,
                               serve_sampling)
    eng_d, out_d, _ = serve("D sampled calm, all at once", SERVE_CALM,
                            serve_sampling, late=0)
    same("D == C", out_d, out_c)
    if keep is not None:
        keep["C"] = out_c
    stops, upto = {}, [len(s) for s in out_c]
    for b in SERVE_STOP_ROWS:
        gen = list(out_c[b][len(prompts[b]):])
        stops[b] = (int(gen[SERVE_STOP_AT]),)
        upto[b] = len(prompts[b]) + gen.index(stops[b][0]) + 1
    _e, out_s, _ = serve("C' sampled with stop tokens", SERVE_ENGINE,
                         serve_sampling, stops=stops)
    same("C' == C up to the first stop token", out_s, out_c, upto)
    log(f"[serve] C' stop tokens {stops}: requests end at lengths "
        f"{[len(out_s[b]) for b in SERVE_STOP_ROWS]} (prompt + first "
        f"occurrence + 1)")
    # E: the legacy loop against the paged serve on the same prompts
    lp = SV.make_prompts(cfg, SERVE_LEGACY["batch"],
                         SERVE_LEGACY["prompt_len"], 0)
    legacy, legacy_tps = SV.run_legacy(params, cfg, lp, SERVE_LEGACY["gen"],
                                       device=dev)
    paged = SV.serve(arch, smoke=smoke, params=params, prompts=lp,
                     device=dev, gen=SERVE_LEGACY["gen"], precision="bnn",
                     verbose=False)
    same("E legacy == paged", list(legacy), list(paged))
    log(f"[serve] E legacy tokens/s={legacy_tps:.1f} (batch "
        f"{SERVE_LEGACY['batch']}, prompts {SERVE_LEGACY['prompt_len']}, "
        f"{SERVE_LEGACY['gen']} new); tokens equal the paged serve's")
    launches = {k.name: k.launches for k in ops.KERNELS}
    log(f"[serve] launches {json.dumps(launches)}")
    for name in SERVING_KERNELS if cuda else ():
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "serve path")
    # what sampling adds to one decode step (B = 8 rows, V = 32000)
    c_step = st_c["wall_s"] / max(st_c["steps"], 1)
    a_step = st_a["wall_s"] / max(st_a["steps"], 1)
    if cuda:
        x = torch.randn(8, cfg.vocab, device=dev)
        args = [torch.full((8,), v, device=dev) for v in (
            1000, 0.8, 50, 0.95)]
        args[0], args[2] = args[0].long(), args[2].long()
        idx = torch.arange(8, device=dev) + 500
        greedy_ms = eager_ms(lambda: sample_tokens(x))
        sampled_ms = eager_ms(lambda: sample_tokens(x, idx, *args))
        log(f"[serve] sampling per decode step (B=8, V={cfg.vocab}): "
            f"sample_tokens {sampled_ms:.4f} ms vs greedy argmax "
            f"{greedy_ms:.4f} ms (eager, synchronised); engine wall per "
            f"step C {1e3 * c_step:.3f} ms vs A {1e3 * a_step:.3f} ms")
        log(f"[serve] peak memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")
        check_sampled_bits(dev)
    return launches, out_a


# ------------------------------------------- [tenants]: the policies, the
# engine's trace file, the streaming front-end and scoring, on [serve]'s
# weights (the same seed) and traffic under A's config (SERVE_ENGINE)

TENANTS = "chat=latency:2048,batch=throughput"
TENANT_NAMES = ("chat", "batch")     # request b's tenant: b % 2
CHAT_BUDGET = 2048                   # chat's in-flight tokens, at most
SCORE_SUFFIX = 128                   # a scoring prompt: a system prompt + this
CANCEL_AFTER = 8                     # streamed tokens, then the last request
                                     # is cancelled
MAX_SCORE_GAP = 1e-3                 # |engine logprob - teacher-forced|, nats


def tenant_kw(b: int) -> dict:
    return {"tenant": TENANT_NAMES[b % 2]}


def score_prompts(prompts, vocab: int, seed: int = 5) -> list[np.ndarray]:
    """The 4 system prompts of ``serve_traffic`` (requests 0-3 start
    with them), each with a seeded suffix of SCORE_SUFFIX tokens: 512
    tokens, 4 prefill chunks of 128 each."""
    rng = np.random.default_rng(seed)
    return [np.concatenate([prompts[i][:384], rng.integers(
        0, vocab, SCORE_SUFFIX)]).astype(np.int32) for i in range(4)]


def watch_tenant_budget(eng, rec: dict):
    """After every admission pass: chat's in-flight tokens (prompt +
    max_new of its running requests) within CHAT_BUDGET."""
    sched = eng.scheduler
    schedule = sched.schedule
    rec["max_chat"] = 0

    def checked(step):
        plan = schedule(step)
        n = sched.tenant_tokens_in_flight("chat")
        rec["max_chat"] = max(rec["max_chat"], n)
        if n > CHAT_BUDGET:
            raise AssertionError(f"[tenants] step {step}: chat holds {n} "
                                 f"tokens in flight > {CHAT_BUDGET}")
        return plan

    sched.schedule = checked


def slo_victims(records) -> tuple[list[tuple], dict[str, int]]:
    """From a trace's request records: each preemption victim as (rid,
    its tenant, whether a batch request was running then), and the
    defers by reason.  Raises if a chat request was preempted while a
    batch request ran."""
    tenant, running, victims, defers = {}, set(), [], {}
    for r in records:
        if r["type"] != "request":
            continue
        ev, rid = r["event"], r["rid"]
        if ev == "submit":
            tenant[rid] = r["tenant"]
        elif ev in ("admit", "swap_in"):
            running.add(rid)
        elif ev in ("swap_out", "evict"):
            batch = any(tenant[x] == "batch" for x in running)
            victims.append((rid, tenant[rid], batch))
            if batch and tenant[rid] != "batch":
                raise AssertionError(
                    f"[tenants] step {r['step']}: chat request {rid} "
                    "preempted while a batch request was running")
            running.discard(rid)
        elif ev in ("finish", "cancelled"):
            running.discard(rid)
        elif ev == "defer":
            defers[r["reason"]] = defers.get(r["reason"], 0) + 1
    return victims, defers


def tenants_setup(dev, smoke: bool = False, want=None) -> dict:
    """[serve]'s weights (seed 0) and traffic, and A's greedy tokens
    (``want``, or served here under A's config)."""
    from repro_torch.launch import serve as SV
    from repro_torch.serving import EngineConfig
    cfg, params = serve_setup(dev, smoke)
    prompts = serve_traffic(cfg.vocab)
    late = dict(late_after=SERVE_LATE_AFTER, n_late=SERVE_LATE)
    if want is None:
        _e, want = SV.run(params, cfg, prompts, SERVE_NEW,
                          EngineConfig(**SERVE_ENGINE), device=dev, **late)
    return dict(dev=dev, cfg=cfg, params=params, prompts=prompts,
                want=want, late=late)


def _tenants_run(ctx, tag, ecfg_kw, **kw):
    """One run of the phase's traffic through ``launch.serve.run``;
    logs its line and checks every request's tokens equal A's."""
    from repro_torch.launch import serve as SV
    from repro_torch.serving import EngineConfig
    dev = ctx["dev"]
    t0 = time.perf_counter()
    eng, seqs = SV.run(ctx["params"], ctx["cfg"], ctx["prompts"], SERVE_NEW,
                       EngineConfig(**SERVE_ENGINE, **ecfg_kw), device=dev,
                       **ctx["late"], **kw)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    st = eng.stats()
    log(f"[tenants] {tag}: total_tokens_per_s={st['total_tokens_per_s']:.1f} "
        f"steps={st['steps']} preemptions={st['preemptions']} "
        f"swap_outs={st['swap']['swap_outs']} wall_s={wall:.3f}")
    _same_tokens(f"[tenants] {tag}", seqs, ctx["want"])
    return eng, st


def _same_tokens(tag, got, want):
    for b, (g, w) in enumerate(zip(got, want, strict=True)):
        if len(g) != len(w) or not np.array_equal(g, w):
            raise AssertionError(f"{tag}: request {b}'s tokens differ from "
                                 "A's (fcfs)")


def tenants_priority(ctx) -> dict:
    """The priority policy (request b at priority b % 3): each
    request's greedy tokens equal A's.  Returns the run's stats."""
    return _tenants_run(ctx, "priority", dict(policy="priority"),
                        request_kw=lambda b: {"priority": b % 3})[1]


def tenants_slo(ctx) -> dict:
    """The slo policy (TENANTS, round-robin): each request's greedy
    tokens equal A's, chat within its budget after every admission
    pass.  Returns the run's stats."""
    rec = {}
    _e, st = _tenants_run(ctx, "slo", dict(policy="slo", tenants=TENANTS),
                          request_kw=tenant_kw,
                          watch=lambda e: watch_tenant_budget(e, rec))
    log(f"[tenants] slo: chat's most tokens in flight {rec['max_chat']} "
        f"(budget {CHAT_BUDGET})")
    return st


def tenants_trace(ctx, untraced: dict) -> dict:
    """The slo run again with ``start_trace`` into a temporary directory:
    the trace validates, its step records' dur_s sum to wall_s and its
    swap spans to the swap section's times (float equality), the tokens
    equal A's; the victims and defers read from its request records
    (at least one preemption and one tenant_budget defer; a chat
    request preempted only while no batch request ran); the photonic
    replay of the file, and its Perfetto export with a track per
    request; tokens/s traced against untraced, two runs each in turns.
    Returns the counts the CPU run predicts."""
    import tempfile
    from repro_torch.launch import trace_view as TV
    from repro_torch.serving import (format_report, read_trace,
                                     replay_trace, validate_trace)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "slo.jsonl")
        rec = {}

        def watch(e):
            e.start_trace(path)
            watch_tenant_budget(e, rec)
        eng, st = _tenants_run(ctx, "slo traced",
                               dict(policy="slo", tenants=TENANTS),
                               request_kw=tenant_kw, watch=watch)
        eng.stop_trace()
        records = read_trace(path)
        validate_trace(records)
        steps = [r for r in records if r["type"] == "step"]
        if sum(r["dur_s"] for r in steps) != st["wall_s"]:
            raise AssertionError("[tenants] the step records' dur_s do not "
                                 "sum to stats()['wall_s']")
        spans = {}
        for r in records:
            if r["type"] == "span":
                spans[r["name"]] = spans.get(r["name"], 0.0) + r["dur_s"]
        sw = st["swap"]
        if (spans.get("swap_out", 0.0) + spans.get("snapshot_out", 0.0)
                != sw["swap_out_s"]
                or spans.get("swap_in", 0.0) + spans.get("snapshot_in", 0.0)
                != sw["swap_in_s"]):
            raise AssertionError("[tenants] the swap spans do not sum to "
                                 "the swap section's times")
        victims, defers = slo_victims(records)
        n_pre = len(victims)
        if n_pre < 1 or defers.get("tenant_budget", 0) < 1:
            raise AssertionError("[tenants] slo: no preemption or no "
                                 "tenant_budget defer")
        log(f"[tenants] slo trace: {len(records)} records, {len(steps)} "
            f"steps, span seconds {json.dumps(spans)}; victims (rid, "
            f"tenant, batch running) {victims}; defers {json.dumps(defers)}")
        # the tracing's cost, in turns: untraced (tenants_slo), traced
        # (the run above), traced, untraced; a time only the card gives
        tps = {"untraced": [untraced["total_tokens_per_s"]],
               "traced": [st["total_tokens_per_s"]]}
        for tag in ("traced", "untraced") if ctx["dev"].type == "cuda" \
                else ():
            again = str(Path(tmp) / "again.jsonl")
            _e, st2 = _tenants_run(
                ctx, f"slo {tag} again", dict(policy="slo", tenants=TENANTS),
                request_kw=tenant_kw,
                watch=(lambda e: e.start_trace(again)) if tag == "traced"
                else None)
            tps[tag].append(st2["total_tokens_per_s"])
        ratio = sum(tps["traced"]) / sum(tps["untraced"])
        log(f"[tenants] tracing overhead: total_tokens_per_s traced "
            f"{tps['traced']} vs untraced {tps['untraced']} (runs in turns "
            f"untraced, traced, traced, untraced): {ratio:.3f}x")
        for line in format_report(replay_trace(path)).splitlines():
            log(f"[tenants] {line}")
        out = str(Path(tmp) / "slo.perfetto.json")
        n_events = TV.export_perfetto(path, out)
        with open(out) as fh:
            doc = json.load(fh)
        tracks = {e["args"]["name"] for e in doc["traceEvents"]
                  if e["ph"] == "M" and e["pid"] == TV.REQUEST_PID
                  and e["name"] == "thread_name"}
        want_tracks = {f"rid {rid}" for rid in eng.requests}
        if tracks != want_tracks:
            raise AssertionError("[tenants] the Perfetto export lacks a "
                                 "request's track")
        log(f"[tenants] perfetto: {n_events} events, {len(tracks)} request "
            "tracks")
    return {"preemptions": st["preemptions"], "victims": victims,
            "defers": defers, "swap_outs": sw["swap_outs"],
            "swap_ins": sw["swap_ins"], "steps": st["steps"]}


def tenants_stream(ctx) -> tuple[dict, dict]:
    """The 24 requests through the front-end (``launch.serve.run_stream``,
    slo, TENANTS) with 4 scoring requests (``score_prompts``, tenant
    batch) beside them; the last request cancelled after CANCEL_AFTER
    streamed tokens.  Gates: each uncancelled stream equals A's tokens,
    the cancelled one A's up to where it stopped; every block free after
    ``reset_stats(flush_prefix=True)``; scored tokens Σ(len − 1); no
    scoring request adopted a prefix.  Returns (the kernel launches of
    the run, {"scores": the scoring prompts, "scored": their results,
    "steps": the run's steps, "cancelled": (request, tokens streamed)})."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as SV
    from repro_torch.serving import EngineConfig
    dev, prompts, want = ctx["dev"], ctx["prompts"], ctx["want"]
    scores = score_prompts(prompts, ctx["cfg"].vocab)
    rec = {}
    t0 = time.perf_counter()
    eng, rids, got, scored = SV.run_stream(
        ctx["params"], ctx["cfg"], prompts, SERVE_NEW,
        EngineConfig(**SERVE_ENGINE, policy="slo", tenants=TENANTS),
        request_kw=tenant_kw, scores=scores,
        score_kw=lambda i: {"tenant": "batch"}, cancel_after=CANCEL_AFTER,
        watch=lambda e: watch_tenant_budget(e, rec), device=dev,
        **ctx["late"])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in ops.KERNELS}
    st = eng.stats()
    cancelled = None
    for b, rid in enumerate(rids):
        stream = got[rid]
        seq = np.concatenate([prompts[b], np.asarray(stream, np.int64)])
        if eng.requests[rid].state.value == "cancelled":
            if b != len(rids) - 1 or len(stream) < CANCEL_AFTER \
                    or not np.array_equal(seq, want[b][:len(seq)]):
                raise AssertionError(f"[tenants] stream: request {b} "
                                     "cancelled wrongly")
            cancelled = (b, len(stream))
        elif not np.array_equal(seq, want[b]):
            raise AssertionError(f"[tenants] stream: request {b}'s stream "
                                 "differs from A's tokens")
    if cancelled is None:
        raise AssertionError("[tenants] stream: no request was cancelled")
    sc = st["scoring"]
    if sc["requests"] != len(scores) or sc["scored_tokens"] != sum(
            len(p) - 1 for p in scores):
        raise AssertionError(f"[tenants] scoring counts {sc}")
    admits = {e["rid"]: e for e in eng.scheduler.trace
              if e["event"] == "admit"}
    for s in scored:
        if eng.requests[s["rid"]].skipped_prefill or \
                admits[s["rid"]]["cached_tokens"]:
            raise AssertionError(f"[tenants] scoring request {s['rid']} "
                                 "adopted a prefix")
    eng.reset_stats(flush_prefix=True)
    alloc = eng.cache.attn.allocator
    alloc.check()
    if alloc.num_used:
        raise AssertionError(f"[tenants] {alloc.num_used} blocks held after "
                             "the stream run and a prefix flush")
    log(f"[tenants] stream: total_tokens_per_s={st['total_tokens_per_s']:.1f}"
        f" steps={st['steps']} wall_s={wall:.3f}; request {cancelled[0]} "
        f"cancelled after {cancelled[1]} streamed tokens; scoring {sc}, "
        f"modeled scoring tokens/s "
        f"{st['photonic']['modeled_scoring_tokens_per_s']:.0f}; chat's most "
        f"tokens in flight {rec['max_chat']}; every block free after the "
        "prefix flush")
    return launches, {"scores": scores, "scored": scored,
                      "steps": st["steps"], "cancelled": cancelled}


def score_logprobs(logits: np.ndarray, prompt: np.ndarray) -> np.ndarray:
    """log p(prompt[i + 1] | prompt[:i + 1]) from logits rows 0..T-2, in
    float64 (the engine's ``_accumulate_score``)."""
    rows = logits[:len(prompt) - 1].astype(np.float64)
    mx = rows.max(axis=-1)
    lse = mx + np.log(np.exp(rows - mx[:, None]).sum(axis=-1))
    return rows[np.arange(len(rows)), prompt[1:].astype(np.int64)] - lse


def plain_teacher_forced(params, cfg, prompt: np.ndarray, dev) -> np.ndarray:
    """The prompt's logits (T, V) from ``prefill_chunk`` in the engine's
    chunks on fresh pools, through the plain versions end to end
    (``impl="torch"``)."""
    from repro_torch.models import transformer as M
    chunk, bs = SERVE_ENGINE["prefill_chunk"], SERVE_ENGINE["block_size"]
    t = len(prompt)
    mb = -(-t // bs)
    pools = M.init_paged_state(cfg, mb + 1, bs, 2, device=dev)
    table = torch.arange(1, mb + 1, dtype=torch.int32, device=dev)[None]
    slots = torch.ones(1, dtype=torch.int32, device=dev)
    rows = []
    with torch.no_grad():
        for pos in range(0, t, chunk):
            n = min(chunk, t - pos)
            toks = torch.zeros((1, chunk), dtype=torch.int64, device=dev)
            toks[0, :n] = torch.from_numpy(
                prompt[pos:pos + n].astype(np.int64))
            lg, pools = M.prefill_chunk(
                params, cfg, toks, pools, table,
                torch.tensor([pos], dtype=torch.int32, device=dev),
                torch.tensor([n], dtype=torch.int32, device=dev), slots,
                impl="torch")
            rows.append(lg[0, :n].float().cpu().numpy())
    return np.concatenate(rows)


def tenants_scoring_check(ctx, scoring: dict) -> float:
    """Each scoring request's logprobs against a teacher-forced pass of
    its prompt through the plain versions on the device
    (``plain_teacher_forced``): |engine - plain| <= MAX_SCORE_GAP at
    every scored position.  Past the first position where an accepted
    sign flip of the kernel route (phase 4's two routes, re-synchronised
    at each sublayer, each flip printed) parts the routes, the plain
    pass runs on other inputs and is not held.  Returns the largest gap
    held."""
    worst = 0.0
    for p, s in zip(scoring["scores"], scoring["scored"], strict=True):
        got = np.asarray(s["logprobs"], np.float64)
        gap = np.abs(got - score_logprobs(
            plain_teacher_forced(ctx["params"], ctx["cfg"], p, ctx["dev"]),
            p))
        held = len(gap)
        if gap.max() > MAX_SCORE_GAP:
            FLIP_POSITIONS.clear()
            _teacher_forced(ctx["params"], ctx["cfg"], p,
                            SERVE_ENGINE["prefill_chunk"],
                            SERVE_ENGINE["block_size"], 0, ctx["dev"],
                            f"[tenants] score rid {s['rid']}",
                            keep_from=len(p))
            held = min(FLIP_POSITIONS, default=len(gap))
            if gap[:held].max(initial=0.0) > MAX_SCORE_GAP:
                raise AssertionError(
                    f"[tenants] score rid {s['rid']}: logprobs differ from "
                    f"the plain route by {gap[:held].max():.3g} before any "
                    "accepted flip")
        worst = max(worst, float(gap[:held].max(initial=0.0)))
        log(f"[tenants] score rid {s['rid']}: {len(got)} logprobs, ppl "
            f"{s['ppl']:.3f}; largest gap to the plain route "
            f"{gap[:held].max(initial=0.0):.3g} over positions 0-{held - 1} "
            f"(tolerance {MAX_SCORE_GAP})"
            + (f"; {gap[held:].max():.3g} past an accepted flip"
               if held < len(gap) else ""))
    return worst


def phase_tenants(dev, smi: str, want=None, smoke: bool = False) -> dict:
    """The [tenants] phase (module docstring) on ``dev``; ``want``: A's
    tokens from [serve] (served again here when None; ``smoke``: the
    reduced config, as the CPU tests run it).  Returns the kernel
    launches of the phase's main-path runs."""
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    ctx = tenants_setup(dev, smoke, want)
    log(f"[tenants] {ctx['cfg'].name} d_model={ctx['cfg'].d_model} "
        f"requests={len(ctx['prompts'])} tenants {TENANTS}; {smi}")
    ops.reset_launches()
    tenants_priority(ctx)
    st = tenants_slo(ctx)
    tenants_trace(ctx, st)
    launches, scoring = tenants_stream(ctx)
    tenants_scoring_check(ctx, scoring)
    log(f"[tenants] launches {json.dumps(launches)}; phase "
        f"{time.perf_counter() - t0:.1f} s")
    for name in ("fused_bnn", "paged_attention") if dev.type == "cuda" else ():
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "tenants path")
    return launches


# ------------------------------------------------------------- [train]
#
# Training: full-width bnn-lm-100m at precision "bnn_train" (the STE
# forward and backward, no kernel: float matmuls of the signs, as in
# the JAX package), the port's torch init from seed 0, SyntheticLM
# batches; then the trained weights served at precision "bnn" through
# the kernels.

TRAIN_ARCH = "bnn-lm-100m"
TRAIN = dict(seq_len=256, global_batch=8, lr=1e-3, steps=60)
# the CPU rehearsal (tests/test_torch_train_phase.py): the reduced
# config, shorter sequences, and the JAX package's test_e2e lr for 30
# steps
TRAIN_SMOKE = dict(seq_len=64, global_batch=8, lr=2e-3, steps=30)
TRAIN_CPU_ROWS = 2             # (a): the batch's sequences run on the CPU
TRAIN_LOSS_REL = 1e-4          # (a) loss, card against the CPU
TRAIN_GNORM_REL = 1e-3         # (a) global gradient norm
TRAIN_COSINE = 0.999           # (a) each leaf's gradient, cosine
TRAIN_MB_REL = 1e-5            # (b) loss and grad norm, 2 microbatches vs 1
# (b) parameters: the JAX package's microbatch bound (tests/test_e2e.py,
# rtol 5e-3 / atol 1e-3 at lr 1e-2) scaled to lr 1e-3
TRAIN_MB_PARAM = dict(rtol=5e-3, atol=1e-4)
TRAIN_REMAT_REL = 1e-6         # (c) each leaf, of its largest |element|
TRAIN_RESUME = (10, 16, 5)     # (d) stop at, resume to, checkpoint every
TRAIN_RESUME_RTOL = 1e-4       # (d) the JAX package's resume bound
TRAIN_LOSS_DROP = 0.05         # (e) nats: JAX's test_train_loss_decreases
TRAIN_SERVE_NEW = 32           # (f) new tokens a request, greedy
TRAIN_SERVE_PROMPTS = (8, 64, 256)   # (f) count, shortest, longest
TRAIN_SERVE_STEP = 10 ** 6     # (f) a data step no training run reads


def _train_setup(dev, smoke: bool):
    from repro_torch import configs
    from repro_torch.configs.base import reduced
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    cfg = configs.get_config(TRAIN_ARCH)
    if smoke:
        cfg = reduced(cfg)
    cfg = cfg.replace(precision="bnn_train")
    sizes = TRAIN_SMOKE if smoke else TRAIN
    data = SyntheticLM(DataConfig(cfg.vocab, sizes["seq_len"],
                                  sizes["global_batch"], seed=0))
    return cfg, sizes, data


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


HOST_PROBE_LAUNCHES = 2000     # tiny launches a run of host_launch_us


def host_launch_us(dev) -> float:
    """The host's wall per eager launch on ``dev``, in us: the median
    of 5 runs of HOST_PROBE_LAUNCHES in-place multiplies of 8 elements,
    each run ending in a synchronize.  A host-bound step (thousands of
    launches) scales with it, so two runs' step times are compared
    beside it."""
    x = torch.ones(8, device=dev)
    runs = []
    for _ in range(5):
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(HOST_PROBE_LAUNCHES):
            x.mul_(1.0)
        _sync(dev)
        runs.append((time.perf_counter() - t0) / HOST_PROBE_LAUNCHES * 1e6)
    return float(np.median(runs))


def _cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    """Cosine of two tensors (1 when both are zero)."""
    a, b = a.double().flatten(), b.double().flatten()
    den = float(a.norm() * b.norm())
    return float(a @ b) / den if den else float(torch.equal(a, b))


@contextlib.contextmanager
def projection_inputs(whole=None):
    """A list that receives the input of every BNN projection
    (``ops.bnn_dense``) called in the block, in call order, detached
    (``whole``: a function of it first, the gather of a DTensor's)."""
    from repro_torch.kernels import ops
    seen: list = []
    inner = ops.bnn_dense

    def rec(x, w, **kw):
        seen.append((whole(x) if whole else x).detach())
        return inner(x, w, **kw)
    ops.bnn_dense = rec
    try:
        yield seen
    finally:
        ops.bnn_dense = inner


def record_projection_inputs(params, cfg, batch, loss_chunk):
    """The input of every BNN projection of one ``loss_fn`` forward, in
    call order."""
    from repro_torch.models import transformer as M
    with projection_inputs() as seen, torch.no_grad():
        M.loss_fn(params, cfg, batch, loss_chunk=loss_chunk)
    return seen


def train_sign_flips(params_card, params_cpu, cfg, batch_card, batch_cpu,
                     loss_chunk) -> int:
    """(a)'s explanation of a miss: the STE sign bits of every BNN
    projection's input, card against CPU, projection by projection.  A
    flip is accepted only within FLIP_RMS_FRACTION x its row's RMS of
    zero on both sides; any other raises.  Returns the flips."""
    a = record_projection_inputs(params_card, cfg, batch_card, loss_chunk)
    b = record_projection_inputs(params_cpu, cfg, batch_cpu, loss_chunk)
    if len(a) != len(b):
        raise AssertionError(f"[train] (a): {len(a)} projections on the card, "
                             f"{len(b)} on the CPU")
    flips = 0
    for i, (xa, xb) in enumerate(zip(a, b)):
        xa = xa.cpu().float()
        flip = (xa >= 0) != (xb.float() >= 0)
        n = int(flip.sum())
        if not n:
            continue
        rms = xb.float().square().mean(dim=-1, keepdim=True).sqrt()
        near = (xa.abs() <= FLIP_RMS_FRACTION * rms) & \
            (xb.float().abs() <= FLIP_RMS_FRACTION * rms)
        far = int((flip & ~near).sum())
        log(f"[train] (a) projection {i}: {n} STE sign flips, {far} farther "
            f"than {FLIP_RMS_FRACTION} x RMS from 0")
        if far:
            raise AssertionError(f"[train] (a): projection {i} flips {far} "
                                 "signs far from zero, card against CPU")
        flips += n
    return flips


def train_vs_cpu(dev, cfg, params, batch, loss_chunk) -> None:
    """(a): the card against the CPU at step 0, the same port code and
    weights on TRAIN_CPU_ROWS sequences of the batch."""
    from repro_torch import tree as T
    from repro_torch.data.pipeline import to_tensors
    from repro_torch.launch import steps
    from repro_torch.optim.optimizer import global_norm
    from repro_torch.serving.sharded import params_on
    rows = {k: v[:TRAIN_CPU_ROWS] for k, v in batch.items()}
    b_card, b_cpu = to_tensors(rows, dev), to_tensors(rows, "cpu")
    cpu_params = params_on(params, cfg, torch.device("cpu"), copy=True)
    t0 = time.perf_counter()
    l_card, _, g_card = steps.value_and_grad(params, cfg, b_card,
                                             loss_chunk=loss_chunk,
                                             remat=False)
    _sync(dev)
    t1 = time.perf_counter()
    l_cpu, _, g_cpu = steps.value_and_grad(cpu_params, cfg, b_cpu,
                                           loss_chunk=loss_chunk, remat=False)
    t2 = time.perf_counter()
    n_card, n_cpu = float(global_norm(g_card)), float(global_norm(g_cpu))
    lc, lp = float(l_card), float(l_cpu)
    cos = [_cosine(a.cpu(), b) for a, b in zip(T.leaves(g_card),
                                               T.leaves(g_cpu))]
    loss_rel, norm_rel = abs(lc - lp) / abs(lp), abs(n_card - n_cpu) / n_cpu
    log(f"[train] (a) card vs CPU at step 0 on {TRAIN_CPU_ROWS} sequences: "
        f"loss {lc:.7f} / {lp:.7f} (rel {loss_rel:.3g}), grad norm "
        f"{n_card:.6g} / {n_cpu:.6g} (rel {norm_rel:.3g}), min leaf cosine "
        f"{min(cos):.7f} over {len(cos)} leaves; card {t1 - t0:.2f} s, "
        f"CPU {t2 - t1:.2f} s")
    if loss_rel <= TRAIN_LOSS_REL and norm_rel <= TRAIN_GNORM_REL and \
            min(cos) >= TRAIN_COSINE:
        return
    flips = train_sign_flips(params, cpu_params, cfg, b_card, b_cpu,
                             loss_chunk)
    if not flips:
        raise AssertionError("[train] (a): card and CPU differ with no STE "
                             "sign flip to explain it")
    log(f"[train] (a) the miss is explained by {flips} STE sign flips, each "
        f"within {FLIP_RMS_FRACTION} x RMS of zero")


def train_microbatches(dev, cfg, params, batch, sizes, loss_chunk) -> None:
    """(b): one build_train_step step with 2 microbatches against 1."""
    from repro_torch import tree as T
    from repro_torch.data.pipeline import to_tensors
    from repro_torch.launch import steps
    from repro_torch.launch.train import adamw_config
    from repro_torch.models import transformer as M
    from repro_torch.optim import optimizer as opt
    from repro_torch.serving.sharded import params_on
    ocfg = adamw_config(sizes["lr"], sizes["steps"])
    tb = to_tensors(batch, dev)
    out = {}
    for mb in (1, 2):
        p = params_on(params, cfg, dev, copy=True)
        state = opt.init(ocfg, M.trainable(p, cfg))
        _, _, m = steps.build_train_step(cfg, ocfg, microbatches=mb,
                                         loss_chunk=loss_chunk)(p, state, tb)
        out[mb] = (M.trainable(p, cfg), float(m["loss"]),
                   float(m["grad_norm"]))
    loss_rel = abs(out[2][1] - out[1][1]) / out[1][1]
    norm_rel = abs(out[2][2] - out[1][2]) / out[1][2]
    worst = 0.0
    for a, b in zip(T.leaves(out[2][0]), T.leaves(out[1][0]), strict=True):
        excess = (a - b).abs() - (TRAIN_MB_PARAM["atol"] +
                                  TRAIN_MB_PARAM["rtol"] * b.abs())
        worst = max(worst, float(excess.max()))
    log(f"[train] (b) microbatches 2 vs 1: loss {out[2][1]:.7f} / "
        f"{out[1][1]:.7f} (rel {loss_rel:.3g}), grad norm rel {norm_rel:.3g}, "
        f"params within rtol {TRAIN_MB_PARAM['rtol']} atol "
        f"{TRAIN_MB_PARAM['atol']}: {worst <= 0}")
    if loss_rel > TRAIN_MB_REL or norm_rel > TRAIN_MB_REL or worst > 0:
        raise AssertionError("[train] (b): 2 microbatches differ from 1")


def train_remat(dev, cfg, params, batch, loss_chunk) -> None:
    """(c): gradients with remat on equal those with it off."""
    from repro_torch import tree as T
    from repro_torch.data.pipeline import to_tensors
    from repro_torch.launch import steps
    tb = to_tensors(batch, dev)
    grads = [steps.value_and_grad(params, cfg, tb, loss_chunk=loss_chunk,
                                  remat=r)[2] for r in (False, True)]
    worst = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                for a, b in zip(T.leaves(grads[1]), T.leaves(grads[0])))
    log(f"[train] (c) remat on vs off: each leaf within {worst:.3g} of its "
        "largest element")
    if worst > TRAIN_REMAT_REL:
        raise AssertionError(f"[train] (c): remat changes a gradient by "
                             f"{worst:.3g} of its largest element")


def train_resume(dev, smoke: bool, sizes, tmp: str) -> None:
    """(d): stop at 10 with a checkpoint every 5 (keep 2), resume to
    16; the last loss equals an uninterrupted 16-step run's."""
    from repro_torch.launch.train import train
    stop, end, every = TRAIN_RESUME
    kw = dict(smoke=smoke, global_batch=sizes["global_batch"],
              seq_len=sizes["seq_len"], lr=sizes["lr"], schedule_total=end,
              device=dev, precision="bnn_train", log_every=100)
    l_a = train(TRAIN_ARCH, steps=end, **kw)
    d = f"{tmp}/resume"
    l_s = train(TRAIN_ARCH, steps=stop, ckpt_dir=d, ckpt_every=every, **kw)
    l_b = train(TRAIN_ARCH, steps=end, ckpt_dir=d, ckpt_every=100, **kw)
    rel = abs(l_b[-1] - l_a[-1]) / abs(l_a[-1])
    log(f"[train] (d) resumed at {stop} to {end}: last loss {l_b[-1]:.7f}, "
        f"uninterrupted {l_a[-1]:.7f} (rel {rel:.3g}); {len(l_b)} steps "
        f"after the restore (its digest verified); the two runs' first "
        f"{stop} losses bit-equal: {l_s == l_a[:stop]}, the last "
        f"{end - stop}: {l_b == l_a[stop:]}")
    if len(l_b) != end - stop or rel > TRAIN_RESUME_RTOL:
        raise AssertionError("[train] (d): the resumed run's last loss "
                             "differs from the uninterrupted run's")


def train_learn(dev, cfg, params, sizes, smoke: bool):
    """(e): ``sizes["steps"]`` steps of ``launch.train`` from ``params``
    (trained in place); returns (losses, each step's ms but the
    first's, peak bytes)."""
    from repro_torch.launch.train import train
    step_ms = []
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses = train(TRAIN_ARCH, smoke=smoke, steps=sizes["steps"],
                   global_batch=sizes["global_batch"],
                   seq_len=sizes["seq_len"], lr=sizes["lr"],
                   precision="bnn_train", device=dev, params=params,
                   step_ms=step_ms)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    log(f"[train] (e) {len(losses)} steps: loss " + " ".join(
        f"{l:.4f}" for l in losses))
    log(f"[train] (e) mean of the first 5 {first:.5f}, of the last 5 "
        f"{last:.5f}: drop {first - last:.5f} nats (gate "
        f"{TRAIN_LOSS_DROP}); log V = {math.log(cfg.vocab):.5f}")
    if not np.isfinite(losses).all() or not last < first - TRAIN_LOSS_DROP:
        raise AssertionError(f"[train] (e): the loss fell {first - last:.4f} "
                             f"nats, less than {TRAIN_LOSS_DROP}")
    return losses, step_ms[1:], peak        # the first step warms up


def train_checkpoint_io(cfg, params, tmp: str) -> dict:
    """Save and restore ms and bytes of a training checkpoint: the
    trained params and AdamW moments of the same shapes."""
    import os
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models import transformer as M
    from repro_torch.optim import optimizer as opt
    tree = M.trainable(params, cfg)
    state = opt.init(opt.AdamWConfig(), tree)
    mgr = CheckpointManager(f"{tmp}/io", keep=1)
    _sync(tree["embed"]["w"].device)
    t0 = time.perf_counter()
    path = mgr.save(1, (tree, state))
    t1 = time.perf_counter()
    (back, _), _ = mgr.restore((tree, state))
    _sync(tree["embed"]["w"].device)
    t2 = time.perf_counter()
    nbytes = os.path.getsize(f"{path}/arrays.npz")
    if not torch.equal(back["embed"]["w"], tree["embed"]["w"]):
        raise AssertionError("[train] a restored checkpoint differs")
    return {"save_ms": (t1 - t0) * 1e3, "restore_ms": (t2 - t1) * 1e3,
            "bytes": nbytes}


def markov_share(data, out: dict, prompt_lens: dict) -> float:
    """The share of generated tokens that are one of their
    predecessor's Markov successors in the data stream."""
    hit = n = 0
    for rid, seq in out.items():
        p = prompt_lens[rid]
        prev, nxt = seq[p - 1:-1], seq[p:]
        hit += int((data.successors[prev] == nxt[:, None]).any(axis=1).sum())
        n += len(nxt)
    return hit / n


def train_serve(dev, cfg, params, data, smi: str):
    """(f): the trained weights served at precision "bnn" through the
    kernels (phase 3's engine config), re-checked as phase 4 does;
    returns the kernel launches of that run and the Markov shares."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.serving import EngineConfig
    n, lo, hi = TRAIN_SERVE_PROMPTS
    src = SyntheticLM(DataConfig(cfg.vocab, hi, n, seed=0))
    rows = src.batch(TRAIN_SERVE_STEP)["tokens"]
    lens = np.random.default_rng(TRAIN_SERVE_STEP).integers(lo, hi + 1, n)
    prompts = [rows[i, :lens[i]].astype(np.int64) for i in range(n)]
    bnn = cfg.replace(precision="bnn")
    ecfg = EngineConfig(block_size=16, num_blocks=1025, max_batch=8,
                        prefill_chunk=128,
                        max_model_len=hi + TRAIN_SERVE_NEW, **NO_PREFIX)
    shares = {}
    launches = None
    for tag, p in (("trained", params), ("init", None)):
        eng, p_used, out, counts, _ = phase_serving(
            dev, bnn, ecfg, max_new=TRAIN_SERVE_NEW, prompts=prompts,
            late_after=0, n_late=0, params=p,
            required=SERVING_KERNELS if dev.type == "cuda" else ())
        shares[tag] = markov_share(
            data, out, {r: eng.requests[r].prompt_len for r in out})
        if tag == "trained":
            launches = counts
            phase_e2e(dev, bnn, p_used, eng, out)
        del eng, p_used, out
    log(f"[train] (f) served the trained weights at precision bnn: "
        f"{n} prompts of {lo}-{hi} tokens, {TRAIN_SERVE_NEW} new each; "
        f"Markov successors among the generated tokens: trained "
        f"{shares['trained']:.4f}, init {shares['init']:.4f} "
        f"(chance {data.cfg.branching / cfg.vocab:.5f}); {smi}")
    return launches, shares


def phase_train(dev, smi: str, smoke: bool = False,
                out: dict | None = None) -> dict:
    """The [train] phase (module docstring) on ``dev`` (``smoke``: the
    reduced config and TRAIN_SMOKE, the CPU rehearsal).  Returns the
    kernel launches of (f)'s serving run of the trained weights;
    ``out``, when a dict, receives the median step ms ("step_ms")."""
    import tempfile
    t0 = time.perf_counter()
    cfg, sizes, data = _train_setup(dev, smoke)
    loss_chunk = min(512, sizes["seq_len"])
    log(f"[train] {cfg.name} precision={cfg.precision} d_model={cfg.d_model} "
        f"layers={cfg.n_layers} vocab={cfg.vocab} batch "
        f"{sizes['global_batch']} x {sizes['seq_len']} lr {sizes['lr']} "
        f"steps {sizes['steps']}; {smi}")
    from repro_torch.launch.train import train_init
    params = train_init(cfg, dev)
    batch = data.batch(0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        train_vs_cpu(dev, cfg, params, batch, loss_chunk)
        train_microbatches(dev, cfg, params, batch, sizes, loss_chunk)
        train_remat(dev, cfg, params, batch, loss_chunk)
        train_resume(dev, smoke, sizes, tmp)
        launch_us = host_launch_us(dev)
        losses, step_ms, peak = train_learn(dev, cfg, params, sizes, smoke)
        io = train_checkpoint_io(cfg, params, tmp)
    med = float(np.median(step_ms))
    if out is not None:
        out["step_ms"] = med
    tokens = sizes["global_batch"] * sizes["seq_len"]
    log(f"[train] step median {med:.2f} ms (min {min(step_ms):.2f}, max "
        f"{max(step_ms):.2f}; launch.train's step times, a batch built and "
        f"copied in each, the first step left out) at B "
        f"{sizes['global_batch']} x T {sizes['seq_len']}, microbatches 1, "
        f"remat on; the host {launch_us:.2f} us a tiny launch: "
        f"{tokens / med * 1e3:.1f} training tokens/s; peak device memory "
        f"{peak / 2 ** 30:.3f} GiB; checkpoint {io['bytes']} bytes, save "
        f"{io['save_ms']:.1f} ms, restore {io['restore_ms']:.1f} ms; {smi}")
    launches, _shares = train_serve(dev, cfg, params, data, smi)
    log(f"[train] launches {json.dumps(launches)}; phase "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------- [analytic]
# the analytic model (launch/analytic.py) and the dry-run (launch/
# dryrun.py) at full-width bnn-lm-100m, after [train]

ANALYTIC_FLOPS_REL = 0.15      # (a), (b): FlopCounterMode vs the model
ANALYTIC_BYTES_REL = 0.01      # (d): the dry-run's bytes vs the allocator's
# (f): the dry-run's argument + temp bytes of [train]'s step over the
# allocator's peak of the bytes requested in it less what the card held
# besides the step's arguments (the library's workspaces, 64 MiB alone;
# earlier phases' caches in the whole smoke): 0.999997 on an NVIDIA H100
# 80GB HBM3 at 700 W, the step's batch int64 on the card (16 KiB), its
# temp bytes within 8 KiB of 1.5 GB
ANALYTIC_STEP_RATIO = (0.999, 1.001)
ANALYTIC_TEMP_REL = 1e-3       # (f): the temp bytes, dry-run vs the card
ANALYTIC_DECODE_B = 8          # (c): phase 3's decode batch
ANALYTIC_DECODE_PAST = 32      # (c): tokens decoded past each prompt
ANALYTIC_DECODE_STEPS = 20     # (c): timed decode steps


def counted_flops(fn) -> int:
    """The FLOPs ``torch.utils.flop_counter`` counts over ``fn()`` (its
    matmuls, convolutions and attention calls; elementwise work is not
    counted, nor is it in the analytic model)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def _flops_gate(tag: str, measured: float, model: float, what: str):
    rel = measured / model - 1.0
    log(f"[analytic] {tag} FlopCounterMode {measured:.6e} FLOP, the "
        f"analytic model's {what} {model:.6e}: {rel:+.4f} relative (gate "
        f"{ANALYTIC_FLOPS_REL})")
    if not abs(rel) <= ANALYTIC_FLOPS_REL:
        raise AssertionError(f"[analytic] {tag}: counted FLOPs differ from "
                             f"the model by {rel:+.4f}")


def analytic_train_flops(dev, smoke: bool):
    """(a): one [train] step (bnn_train, its batch, one microbatch, remat
    on) counted against ``flops_total - 10 params_total`` (the model's
    optimizer term is elementwise work the counter does not see).
    Returns (cfg, cell, the model)."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data.pipeline import to_tensors
    from repro_torch.launch import analytic, steps
    from repro_torch.launch.train import adamw_config, train_init
    from repro_torch.models import transformer as M
    from repro_torch.optim import optimizer as opt_mod
    cfg, sizes, data = _train_setup(dev, smoke)
    seq, b = sizes["seq_len"], sizes["global_batch"]
    params = train_init(cfg, dev)
    opt_cfg = adamw_config(sizes["lr"], sizes["steps"])
    state = opt_mod.init(opt_cfg, M.trainable(params, cfg))
    step = steps.build_train_step(cfg, opt_cfg, microbatches=1,
                                  loss_chunk=min(512, seq))
    batch = to_tensors(data.batch(0), dev)
    measured = counted_flops(lambda: step(params, state, batch))
    _sync(dev)
    cell = ShapeCell("train_step", seq, b, "train")
    cm = analytic.cell_model(cfg, cell, microbatches=1, remat=True)
    head = 2.0 * b * seq * cfg.d_model * cfg.vocab
    log(f"[analytic] (a) {cfg.name} {cfg.precision} train step B {b} x T "
        f"{seq}: the model's flops_fwd {cm.flops_fwd:.6e} (the tied head "
        f"{head:.6e}), flops_total {cm.flops_total:.6e}, params_total "
        f"{cm.params_total:.0f}, model_flops {cm.model_flops:.6e}")
    _flops_gate("(a) train step", measured,
                cm.flops_total - 10.0 * cm.params_total,
                "flops_total - 10 params_total")
    del params, state, batch
    return cfg, cell, cm


def analytic_prefill_flops(dev, smoke: bool) -> None:
    """(b): a bf16 prefill of the [train] batch's shape (hidden_states,
    then the last row's head) counted against ``flops_fwd``."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import analytic
    from repro_torch.launch.train import train_init
    from repro_torch.models import transformer as M
    cfg, sizes, data = _train_setup(dev, smoke)
    cfg = cfg.replace(precision="bf16")
    seq, b = sizes["seq_len"], sizes["global_batch"]
    params = train_init(cfg, dev)
    tokens = torch.from_numpy(data.batch(0)["tokens"]).long().to(dev)

    def prefill():
        with torch.no_grad():
            h = M.hidden_states(params, cfg, tokens)
            return torch.matmul(h[:, -1], params["head"]["w"])
    measured = counted_flops(prefill)
    _sync(dev)
    cm = analytic.cell_model(cfg, ShapeCell("prefill_step", seq, b,
                                            "prefill"))
    _flops_gate(f"(b) bf16 prefill B {b} x T {seq}", measured,
                cm.flops_fwd, "flops_fwd")


def analytic_decode_step(dev, smoke: bool) -> tuple[float, float, object]:
    """(c), the decode half: phase 3's decode step (its engine config,
    the serving closure of ``roles.build_step_fns``, greedy) at B = 8,
    each row at one of phase 3's first prompts' lengths plus
    ANALYTIC_DECODE_PAST; the median of ANALYTIC_DECODE_STEPS timed
    steps, each ending in a synchronize.  Returns (ms, the rows' mean
    length, the config)."""
    from repro_torch import configs
    from repro_torch.configs.base import reduced
    from repro_torch.models import transformer as M
    from repro_torch.serving.roles import build_step_fns
    cfg = configs.get_config(TRAIN_ARCH)
    if smoke:
        cfg = reduced(cfg)
    cfg = cfg.replace(precision="bnn")
    b, bs = ANALYTIC_DECODE_B, SERVE_ENGINE["block_size"]
    lens = [len(p) + ANALYTIC_DECODE_PAST
            for p in traffic(cfg.vocab)[:b]]
    per_row = -(-(max(lens) + 1) // bs)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = M.init(gen, cfg, device=dev)
    pools = M.init_paged_state(cfg, b * per_row + 1, bs, device=dev)
    table = (1 + torch.arange(b * per_row, dtype=torch.int32,
                              device=dev)).reshape(b, per_row)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    active = torch.ones(b, dtype=torch.bool, device=dev)
    tokens = torch.randint(0, cfg.vocab, (b, 1), generator=gen, device=dev)
    decode = build_step_fns(cfg).decode
    runs = []
    for i in range(ANALYTIC_DECODE_STEPS + 2):
        _sync(dev)
        t0 = time.perf_counter()
        decode(params, pools, tokens, table, lengths, active, None)
        _sync(dev)
        if i >= 2:                     # two warm-up steps
            runs.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(runs)), float(np.mean(lens)), cfg


def _roofline_line(tag: str, cm, measured_ms: float) -> dict:
    from repro_torch.launch import analytic
    terms = analytic.roofline_terms(cm, 0.0, 1)
    bound_ms = terms["step_s_bound"] * 1e3
    mfu = cm.model_flops / (measured_ms * 1e-3 * analytic.PEAK_FLOPS)
    log(f"[analytic] (c) {tag}: measured {measured_ms:.3f} ms, the "
        f"roofline bound {bound_ms:.4f} ms ({terms['dominant']}: compute "
        f"{terms['compute_s'] * 1e3:.4f} ms, memory "
        f"{terms['memory_s'] * 1e3:.4f} ms at the data-sheet "
        f"{analytic.PEAK_FLOPS:.4g} FLOP/s, {analytic.HBM_BW:.4g} B/s), "
        f"measured / bound {measured_ms / bound_ms:.2f}; model FLOPs "
        f"{cm.model_flops:.6e}: MFU {mfu:.5f}")
    return terms


def analytic_dryrun_bytes(dev) -> None:
    """(d): the dry-run's per-device parameter bytes of full-width
    bnn-lm-100m on ``smoke_mesh`` over ``dev`` against the bytes the
    card's allocations of the same tree at bf16 request (the caching
    allocator's rounded block bytes printed beside them)."""
    from repro_torch import tree as T
    from repro_torch.dist import sharding as S
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import smoke_mesh
    params, specs = dryrun.param_tree(dryrun.configs.get_config(TRAIN_ARCH))
    with smoke_mesh(dev) as mesh:
        # run_cell's placement of train_4k's params (its step is (f)'s)
        want, _ = dryrun.place(mesh, specs, params,
                               S.rules_train(False, fsdp=True))
    leaves = T.leaves(params)
    if dev.type != "cuda":
        log(f"[analytic] (d) dry-run params {want} bytes on the 1x1 mesh "
            f"({len(leaves)} leaves; no allocator on {dev.type})")
        return
    def stat(name):
        return torch.cuda.memory_stats(dev)[f"{name}_bytes.all.current"]
    _sync(dev)
    before = {k: stat(k) for k in ("requested", "allocated")}
    held = [torch.empty(x.shape, dtype=x.dtype, device=dev) for x in leaves]
    got = {k: stat(k) - v for k, v in before.items()}
    del held
    rel = got["requested"] / want - 1.0
    log(f"[analytic] (d) dry-run params {want} bytes per device on the "
        f"1x1 mesh over {dev}; the card's allocations of the same "
        f"{len(leaves)} bf16 leaves: {got['requested']} bytes requested, "
        f"{rel:+.5f} relative (gate {ANALYTIC_BYTES_REL}); "
        f"{got['allocated']} in the allocator's blocks "
        f"({got['allocated'] / want - 1.0:+.5f}: its rounding and the "
        "segment tails it does not split off)")
    if not abs(rel) <= ANALYTIC_BYTES_REL:
        raise AssertionError(f"[analytic] (d): {got['requested']} bytes "
                             f"allocated vs the dry-run's {want}")


def analytic_dryrun_step(dev) -> None:
    """(f): the dry-run's record of a training step against the card:
    for [ranks] (i)'s cell the collectives (its step's, ``MEASURED``,
    or the prediction), and for [train]'s step on a 1x1 mesh over
    ``dev`` the argument + temp bytes against the allocator's peak of
    the bytes requested while the same step runs there."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import tree as T
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data.pipeline import to_tensors
    from repro_torch.dist import sharding as S, spmd
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import fake_world, smoke_mesh
    from repro_torch.launch.train import train_init
    from repro_torch.layers import common as C
    from repro_torch.models import transformer as M
    from repro_torch.optim import optimizer as opt
    t0 = time.perf_counter()
    rs = RANKS_TRAIN
    with fake_world(RANKS_TRAIN_SHAPE[0] * RANKS_TRAIN_SHAPE[1]):
        rec = dryrun.run_cell(
            TRAIN_ARCH, ShapeCell("ranks_train", rs["seq_len"],
                                  rs["global_batch"], "train"), False,
            mesh=init_device_mesh("cpu", RANKS_TRAIN_SHAPE,
                                  mesh_dim_names=("data", "model")),
            microbatches=rs["microbatches"],
            overrides={"n_layers": RANKS_TRAIN_LAYERS}, dtype=torch.float32)
    cfg = dryrun.configs.get_config(TRAIN_ARCH).replace(
        precision="bnn_train", n_layers=RANKS_TRAIN_LAYERS)
    measured = MEASURED.get("ranks_train_step_collectives")
    if measured is not None and measured[:3] != (cfg, rs, RANKS_TRAIN_SHAPE):
        measured = None                 # (i) ran another cell (its smoke)
    want = measured[3] if measured is not None else \
        train_step_collectives(cfg, rs, RANKS_TRAIN_SHAPE)
    want = {k: v for k, v in want.items() if v}
    equal = rec["sent"] == want
    jax = rec["collectives"]
    log(f"[analytic] (f) the dry-run's step record of [ranks] (i)'s cell "
        f"over {RANKS_TRAIN_SHAPE} (meta shards, a fake group of 4): "
        f"{json.dumps(rec['sent'])}; "
        f"{'(i) measured' if measured is not None else 'predicted'} "
        f"{json.dumps(dict(sorted(want.items())))}: equal {equal}; JAX's "
        f"record: bytes executed {jax['total_bytes_executed']}, static "
        f"{jax['total_bytes_static']}, collective_s "
        f"{rec['roofline']['collective_s']:.3e}")
    if not equal:
        raise AssertionError("[analytic] (f): the dry-run's collectives "
                             "differ from (i)'s step")
    cfg, sizes, data = _train_setup(dev, False)
    cell = ShapeCell("train", sizes["seq_len"], sizes["global_batch"],
                     "train")
    with smoke_mesh(dev) as mesh:
        rec = dryrun.run_cell(TRAIN_ARCH, cell, False, mesh=mesh,
                              microbatches=1,
                              overrides={"precision": cfg.precision},
                              dtype=torch.float32)
        mem = rec["memory"]
        want = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        if dev.type != "cuda":
            log(f"[analytic] (f) dry-run [train] step: arguments "
                f"{mem['argument_size_in_bytes']} + temp "
                f"{mem['temp_size_in_bytes']} bytes (no allocator on "
                f"{dev.type}); {time.perf_counter() - t0:.1f} s")
            return
        rules = S.train_rules_of(mesh)
        params = S.place_params(train_init(cfg, dev), cfg, mesh, rules)
        opt_cfg = dryrun.moment_config(cfg)
        state = opt.init(opt_cfg, M.trainable(params, cfg))
        batch = to_tensors(data.batch(0), dev)
        step = steps.build_train_step(cfg, opt_cfg, microbatches=1)

        def stat(name):
            return torch.cuda.memory_stats(dev)[f"requested_bytes.all.{name}"]
        with C.sharding_context(mesh, rules):
            step(params, state, batch)      # builds, workspaces, caches
            _sync(dev)
            gc.collect()                    # what the first step left
            torch.cuda.reset_peak_memory_stats(dev)
            base = stat("current")
            step(params, state, batch)
            _sync(dev)
        peak = stat("peak")
        allocated = torch.cuda.max_memory_allocated(dev)
        args = sum(spmd.local(x).nbytes for x in T.leaves(
            (M.trainable(params, cfg), state, batch)))
        del params, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    other = base - args                 # workspaces, earlier phases
    ratio = want / (peak - other)
    temp_rel = mem["temp_size_in_bytes"] / (peak - base) - 1.0
    lo, hi = ANALYTIC_STEP_RATIO
    log(f"[analytic] (f) [train]'s step (8 x 256, microbatches 1, float32) "
        f"on a 1x1 mesh over {dev}: the dry-run's arguments "
        f"{mem['argument_size_in_bytes']} + temp {mem['temp_size_in_bytes']}"
        f" = {want} bytes; the card's requested bytes before the step "
        f"{base} (its arguments {args}, {other} besides them: the "
        f"library's workspaces, earlier phases' caches), at its peak "
        f"{peak} (max_memory_allocated {allocated}: the allocator's "
        f"rounding; temp {peak - base}, the dry-run's {temp_rel:+.6f} "
        f"relative, gate {ANALYTIC_TEMP_REL}): ratio {ratio:.6f} to the "
        f"peak less the bytes besides (gate {lo}-{hi}); "
        f"{time.perf_counter() - t0:.1f} s")
    if not lo <= ratio <= hi or not abs(temp_rel) <= ANALYTIC_TEMP_REL:
        raise AssertionError(f"[analytic] (f): dry-run {want} bytes vs the "
                             f"card's peak {peak}")


def analytic_quickstart(dev) -> None:
    """(e): the quickstart's VDP three ways on ``dev``; the packed
    XNOR-popcount kernel must launch there."""
    import runpy
    from repro_torch.kernels import ops
    qs = runpy.run_path(str(Path(__file__).resolve().parent / "examples" /
                            "quickstart_torch.py"), run_name="example")
    before = {k.name: k.launches for k in ops.KERNELS}
    z_optical, z_kernel, z_direct, act = qs["vdp_three_ways"](dev)
    n = {k.name: k.launches - before[k.name] for k in ops.KERNELS}
    log(f"[analytic] (e) quickstart VDP on {dev.type}: optical(PCA) "
        f"{z_optical}, kernel {z_kernel}, direct {z_direct}, comparator "
        f"{act}; xnor_popcount launches {n['xnor_popcount']}")
    if not z_optical == z_kernel == z_direct:
        raise AssertionError("[analytic] (e): the three VDP results differ")
    if dev.type == "cuda" and n["xnor_popcount"] <= 0:
        raise AssertionError("[analytic] (e): xnor_popcount did not launch")


def phase_analytic(dev, smi: str, train_step_ms: float | None = None,
                   smoke: bool = False) -> dict:
    """The [analytic] phase (module docstring); ``train_step_ms`` is
    [train]'s median step (measured here when not given).  Returns the
    kernel launches of the phase's runs."""
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    log(f"[analytic] the analytic model and the dry-run at "
        f"{'reduced' if smoke else 'full-width'} {TRAIN_ARCH}; {smi}")
    ops.reset_launches()
    _cfg, _cell, cm_train = analytic_train_flops(dev, smoke)
    gc.collect()
    analytic_prefill_flops(dev, smoke)
    gc.collect()
    if train_step_ms is None:
        train_step_ms = train_step_time(dev, smoke)
    _roofline_line("the [train] step (its median)", cm_train, train_step_ms)
    dec_ms, mean_len, dcfg = analytic_decode_step(dev, smoke)
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import analytic
    cm_dec = analytic.cell_model(dcfg, ShapeCell(
        "decode_step", round(mean_len), ANALYTIC_DECODE_B, "decode"))
    _roofline_line(f"phase 3's decode step at B {ANALYTIC_DECODE_B}, mean "
                   f"length {mean_len:.1f} (the model's bytes take bf16 "
                   "weights; the served weights are float32 and packed)",
                   cm_dec, dec_ms)
    gc.collect()
    analytic_dryrun_bytes(dev)
    analytic_quickstart(dev)
    analytic_dryrun_step(dev)
    launches = {k.name: k.launches for k in ops.KERNELS}
    log(f"[analytic] launches {json.dumps(launches)}; phase "
        f"{time.perf_counter() - t0:.1f} s")
    for name in ("fused_bnn", "paged_attention", "xnor_popcount"):
        if dev.type == "cuda" and launches[name] <= 0:
            raise AssertionError(f"[analytic]: {name} did not launch")
    return launches


def train_step_time(dev, smoke: bool) -> float:
    """The median of a few ``launch.train`` steps' ms (the first left
    out), when [train] did not hand over its own."""
    from repro_torch.launch.train import train
    cfg, sizes, _data = _train_setup(dev, smoke)
    step_ms: list = []
    train(TRAIN_ARCH, smoke=smoke, steps=6, global_batch=sizes["global_batch"],
          seq_len=sizes["seq_len"], lr=sizes["lr"], precision="bnn_train",
          device=dev, step_ms=step_ms)
    return float(np.median(step_ms[1:]))


# ------------------------------------------- [shards]: worker roles and
# sharded serving on [serve]'s weights (seed 0) and traffic, every shard
# under A's config (SERVE_ENGINE); all shards share the one card
# (shard_devices tiles it) and step one after another

SHARDS_MIGRATE_AT = 24     # S2: steps before a request migrates mid-decode
SHARDS_KILL_AT = 24        # S2 kill: steps before shard 1 stops beating
PD_ROLES = "1:2"           # one prefill shard, two decode shards
# mamba2's slot path under 1:1: its engine sizes with the JAX defaults
# (prefix cache with slot snapshots, swap), 8 of its traffic's requests
MAMBA2_SHARDS = dict(max_batch=8, num_slots=6, prefill_chunk=128,
                     max_model_len=2048)
MAMBA2_SHARDS_LAYERS = 8   # of 48: the cut of the slot path's depth
MAMBA2_SHARDS_NEW = 32


def full_width_bytes(full_cfg, block_size: int):
    """host_bytes as it would count a request's host copies at
    ``full_cfg``'s widths: the prompt and the tokens, every copied block
    at the full width's bytes a block, a recurrent slot at its bytes a
    slot (the pools' shapes on the meta device, nothing allocated)."""
    from repro_torch.models import transformer as M
    from repro_torch.serving.mixer_state import LAYOUT_SLOT, layer_layouts
    pools = M.init_paged_state(full_cfg, 2, block_size, 2, device="meta")
    per = {True: 0, False: 0}
    for layout, pool in zip(layer_layouts(full_cfg), pools, strict=True):
        per[layout == LAYOUT_SLOT] += sum(v[0].nbytes for v in pool.values())

    def count(req) -> int:
        n = req.prompt.nbytes + 4 * len(req.out)
        if req.host_kv:
            n += next(iter(req.host_kv[0].values())).shape[0] * per[False]
        if req.host_state:
            n += per[True]
        return n
    return count


@contextlib.contextmanager
def as_full_width(ctx, ecfg):
    """The reduced-width CPU run as the card's prediction: a handoff's
    bytes (``roles.host_bytes``) and every shard's cost model (the
    modelled transfer's steps) at the full width's sizes, with the
    card's fused GEMM.  Yields the ``watch`` that swaps the cost models;
    a no-op on the card."""
    from repro_torch.serving import roles
    from repro_torch.serving.cost_model import PhotonicCostModel
    full = ctx.get("full_cfg")
    if full is None:
        yield lambda se: None
        return
    model = PhotonicCostModel(full, ecfg.accelerator, fused_bnn=True,
                              link_gbps=ecfg.link_gbps)
    real = roles.host_bytes
    roles.host_bytes = full_width_bytes(full, ecfg.block_size)

    def watch(se):
        for e in se.engines:
            e.cost_model = model
    try:
        yield watch
    finally:
        roles.host_bytes = real


def after_step(k: int, fn):
    """A ``watch`` that calls ``fn(se)`` once, right after the sharded
    engine's ``k``-th step."""
    def watch(se):
        step, n = se.step, [0]

        def counted():
            out = step()
            n[0] += 1
            if n[0] == k:
                fn(se)
            return out
        se.step = counted
    return watch


def shards_setup(dev, smoke: bool = False, want=None,
                 want_sampled=None) -> dict:
    """[serve]'s weights and traffic (``tenants_setup``), A's greedy
    tokens and C's sampled ones (``want``/``want_sampled``, or served
    by one engine here and in ``shards_pd_sampled``); ``smoke``: the
    reduced config, the CPU run that predicts the card's counts
    (``as_full_width``)."""
    from repro_torch.configs import get_config
    ctx = tenants_setup(dev, smoke, want)
    ctx["want_sampled"] = want_sampled
    if smoke:
        ctx["full_cfg"] = get_config("bnn-lm-100m").replace(
            precision="bnn", n_layers=SERVE_LAYERS)
    return ctx


def _shards_run(ctx, tag, shards, roles=None, *, want=None, watch=(),
                sampling=None, ecfg=None, stream=False):
    """The phase's traffic through ``launch.serve.run`` (``run_stream``
    with ``stream``) on a ShardedEngine of ``shards`` shards; logs its
    line, checks each request's tokens against ``want`` (A's) and that
    every request finished.  Returns (the sharded engine, its stats)."""
    from repro_torch.launch import serve as SV
    from repro_torch.serving import EngineConfig
    dev, prompts = ctx["dev"], ctx["prompts"]
    ecfg = ecfg or EngineConfig(**SERVE_ENGINE)
    want = ctx["want"] if want is None else want
    kw = dict(device=dev, shards=shards, roles=roles, **ctx["late"])
    if sampling is not None:
        kw["sampling"] = sampling
    with as_full_width(ctx, ecfg) as full:
        def watch_all(se):
            full(se)
            for w in watch:
                w(se)
        t0 = time.perf_counter()
        if stream:
            se, rids, got, _s = SV.run_stream(
                ctx["params"], ctx["cfg"], prompts, SERVE_NEW, ecfg,
                watch=watch_all, **kw)
            seqs = [np.concatenate([prompts[b], np.asarray(got[r], np.int64)])
                    for b, r in enumerate(rids)]
        else:
            se, seqs = SV.run(ctx["params"], ctx["cfg"], prompts, SERVE_NEW,
                              ecfg, watch=watch_all, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    st = se.stats()
    if st["finished"] != len(prompts):
        raise AssertionError(f"[shards] {tag}: {st['finished']} of "
                             f"{len(prompts)} requests finished")
    _same_tokens(f"[shards] {tag}", seqs, want)
    rows = [(p["role"], p["finished"], p["decoded_tokens"],
             p["prefill_tokens"], p["preemptions"], p["swap_losts"])
            for p in st["per_shard"]]
    log(f"[shards] {tag}: total_tokens_per_s="
        f"{(st['decoded_tokens'] + st['prefill_tokens']) / wall:.1f} "
        f"aggregate_decode_tokens_per_s="
        f"{st['aggregate_decode_tokens_per_s']:.1f} wall_s={wall:.3f}; per "
        f"shard (role, finished, decoded, prefilled, preemptions, "
        f"swap_losts) {rows}")
    return se, st


def _defers(se) -> list[dict[str, int]]:
    """Each shard's defers by reason."""
    out = []
    for e in se.engines:
        d = {}
        for ev in e.scheduler.trace:
            if ev["event"] == "defer":
                d[ev["reason"]] = d.get(ev["reason"], 0) + 1
        out.append(d)
    return out


def _shard_counts(se, st) -> dict:
    """The counts of a sharded run that depend only on the traffic's
    lengths and content (the CPU run at reduced width predicts them)."""
    return {"finished": [p["finished"] for p in st["per_shard"]],
            "decoded": [p["decoded_tokens"] for p in st["per_shard"]],
            "prefilled": [p["prefill_tokens"] for p in st["per_shard"]],
            "preemptions": [p["preemptions"] for p in st["per_shard"]],
            "swap_losts": [p["swap_losts"] for p in st["per_shard"]],
            "swap_outs": [e.cache.swap_outs for e in se.engines],
            "steps": [e.step_count for e in se.engines],
            "defers": _defers(se), "migrations": st["migrations"],
            "requeued_lost": st["requeued_lost"],
            "handoffs": st["handoff"]["handoffs"],
            "handoff_bytes": st["handoff"]["handoff_bytes"]}


def shards_mixed(ctx) -> dict:
    """S2: two mixed shards; after SHARDS_MIGRATE_AT steps the first
    request in mid-decode (by rid) migrates to the other shard.  Tokens
    equal A's, every request finishes, both shards decode, one
    migration.  Returns the run's counts."""
    moved = {}

    def migrate(se):
        rid = min(r for r, q in se.requests.items()
                  if q.state.value == "decode" and len(q.out) >= 2)
        moved.update(rid=rid, src=se.shard_of[rid], pos=se.requests[rid].pos)
        moved["dst"] = se.migrate(rid)
    se, st = _shards_run(ctx, "S2 mixed, one migration", 2,
                         watch=[after_step(SHARDS_MIGRATE_AT, migrate)])
    if not moved or st["migrations"] != 1:
        raise AssertionError(f"[shards] S2: migrations {st['migrations']}")
    if any(p["decoded_tokens"] == 0 for p in st["per_shard"]):
        raise AssertionError("[shards] S2: a shard got no work")
    log(f"[shards] S2 migrated rid {moved['rid']} at pos {moved['pos']} "
        f"from shard {moved['src']} to {moved['dst']} after "
        f"{SHARDS_MIGRATE_AT} steps; its tokens equal A's")
    return {**_shard_counts(se, st), "migrated": moved}


def shards_kill(ctx) -> dict:
    """S2 kill: after SHARDS_KILL_AT steps shard 1 stops beating (its
    last beat set past the monitor's ``dead_after``) and ``reap``, given
    an explicit clock, kills it; every request finishes on shard 0 with A's tokens.
    Returns the counts, the rescue's (requeued_lost, the swap_lost
    events by reason) and the states rescued."""
    rescued = {}

    def silence(se):
        now = max(se.monitor._last_beat.values())
        se.monitor.beat(1, now - se.monitor.dead_after - 1.0)
        states = {}
        for r in se.engines[1].requests.values():
            states[r.state.value] = states.get(r.state.value, 0) + 1
        dead = se.reap(now=now)
        if dead != [1]:
            raise AssertionError(f"[shards] S2 kill: reap killed {dead}")
        rescued["states"] = states
    se, st = _shards_run(ctx, "S2 kill", 2,
                         watch=[after_step(SHARDS_KILL_AT, silence)])
    if se.alive != [0] or not rescued:
        raise AssertionError(f"[shards] S2 kill: alive {se.alive}")
    lost = {}                  # by reason: a parked chain evicted, or
    for ev in se.engines[0].scheduler.trace:      # the shard lost
        if ev["event"] == "swap_lost":
            why = ev.get("reason", "chain_evicted")
            lost[why] = lost.get(why, 0) + 1
    if st["requeued_lost"] != lost.get("shard_lost", 0):
        raise AssertionError("[shards] S2 kill: requeued_lost != shard_lost "
                             "events")
    log(f"[shards] S2 kill: shard 1 reaped after {SHARDS_KILL_AT} steps "
        f"holding {json.dumps(rescued['states'])}; requeued_lost="
        f"{st['requeued_lost']} swap_lost events by reason {json.dumps(lost)}")
    return {**_shard_counts(se, st), "rescued": rescued["states"],
            "swap_lost_events": lost}


def _record_adoptions(rec: list):
    """A ``watch``: each decode shard's ``adopt_request`` records the
    request's ``host_bytes`` as it arrives (before its swap-in)."""
    from repro_torch.serving import roles

    def watch(se):
        for e in se.engines:
            adopt = e.adopt_request

            def recorded(req, *, lost=False, _adopt=adopt):
                rec.append((req.rid, roles.host_bytes(req)))
                return _adopt(req, lost=lost)
            e.adopt_request = recorded
    return watch


def shards_pd(ctx) -> dict:
    """PD: one prefill and two decode shards, greedy, traced into
    per-shard files.  Tokens equal A's; every request is handed off
    once; the decode shards prefill nothing; the bytes the decode
    shards adopt sum to handoff_bytes; the three traces validate, the
    merged Perfetto export has one handoff flow per handoff, and the
    replays' handoffs_in sum to the handoffs.  Returns the counts."""
    import tempfile
    from repro_torch.launch import trace_view as TV
    from repro_torch.serving import read_trace, replay_trace, validate_trace
    adopted = []
    with tempfile.TemporaryDirectory() as tmp:
        prefix = str(Path(tmp) / "pd")
        se, st = _shards_run(ctx, f"PD {PD_ROLES} greedy traced", 3, PD_ROLES,
                             watch=[lambda s: s.start_trace(prefix),
                                    _record_adoptions(adopted)])
        se.stop_trace()
        n = len(ctx["prompts"])
        ho = st["handoff"]
        outs = {}
        replays = []
        for i in range(3):
            records = read_trace(f"{prefix}.shard{i}.jsonl")
            validate_trace(records)
            for r in records:
                if r["type"] == "span" and r["name"] == "handoff_out":
                    outs[r["rid"]] = outs.get(r["rid"], 0) + 1
            replays.append(replay_trace(records)["handoff"])
        if ho["handoffs"] != n or sorted(outs) != sorted(se.requests) \
                or set(outs.values()) != {1}:
            raise AssertionError(f"[shards] PD: {ho['handoffs']} handoffs, "
                                 f"per request {outs}")
        if any(p["prefill_tokens"] for p in st["per_shard"][1:]):
            raise AssertionError("[shards] PD: a decode shard prefilled")
        if len(adopted) != n or sum(b for _r, b in adopted) \
                != ho["handoff_bytes"]:
            raise AssertionError("[shards] PD: the adopted bytes do not sum "
                                 "to handoff_bytes")
        if sum(r["handoffs_in"] for r in replays) != n:
            raise AssertionError("[shards] PD: the replays' handoffs_in do "
                                 "not sum to the handoffs")
        out = str(Path(tmp) / "pd.perfetto.json")
        n_events = TV.export_perfetto_merged(prefix, out)
        with open(out) as fh:
            doc = json.load(fh)
        flows = {ph: sorted(e["id"] for e in doc["traceEvents"]
                            if e.get("cat") == "handoff" and e["ph"] == ph)
                 for ph in ("s", "f")}
        if flows["s"] != flows["f"] or len(flows["s"]) != n:
            raise AssertionError("[shards] PD: the merged export lacks a "
                                 "handoff flow")
    log(f"[shards] PD handoffs={ho['handoffs']} handoff_bytes="
        f"{ho['handoff_bytes']} modeled_transfer_ms_per_handoff="
        f"{ho['modeled_transfer_ms_per_handoff']:.4f} host_copy_wall_ms="
        f"{1e3 * ho['host_copy_wall_s']:.3f}; transfer_pending defers "
        f"{[d.get('transfer_pending', 0) for d in _defers(se)]}; merged "
        f"perfetto {n_events} events, {len(flows['s'])} handoff flows")
    return _shard_counts(se, st)


def shards_pd_sampled(ctx) -> dict:
    """PD sampled ([serve]'s C sampling): tokens equal one engine's
    (C's, served here when ``ctx`` lacks them)."""
    from repro_torch.launch import serve as SV
    from repro_torch.serving import EngineConfig
    if ctx["want_sampled"] is None:
        _e, ctx["want_sampled"] = SV.run(
            ctx["params"], ctx["cfg"], ctx["prompts"], SERVE_NEW,
            EngineConfig(**SERVE_ENGINE), sampling=serve_sampling,
            device=ctx["dev"], **ctx["late"])
    se, st = _shards_run(ctx, f"PD {PD_ROLES} sampled", 3, PD_ROLES,
                         want=ctx["want_sampled"], sampling=serve_sampling)
    return _shard_counts(se, st)


def shards_pd_stream(ctx) -> dict:
    """PD through the asyncio front-end: each stream equals A's."""
    se, st = _shards_run(ctx, f"PD {PD_ROLES} front-end", 3, PD_ROLES,
                         stream=True)
    return _shard_counts(se, st)


def shards_mamba2(ctx) -> dict:
    """The slot path: mamba2-1.3b at published width, MAMBA2_SHARDS_LAYERS
    of its 48 layers (the reduced config on the CPU), the first 8 of its
    traffic's requests under 1:1 with the defaults; tokens equal one
    engine's, a handoff carries recurrent state, and the bytes the
    decode shard adopts sum to handoff_bytes."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.launch import serve as SV
    from repro_torch.models import transformer as M
    from repro_torch.serving import EngineConfig
    dev = ctx["dev"]
    full = get_config("mamba2-1.3b").replace(precision="bnn")
    cfg = (reduced(full) if "full_cfg" in ctx
           else full.replace(n_layers=MAMBA2_SHARDS_LAYERS))
    params = M.init(torch.Generator(device=dev).manual_seed(0), cfg,
                    device=dev)
    prompts = family_traffic(cfg.vocab, seed=2, n=16, lens=(16, 1500))[:8]
    ecfg = EngineConfig(**MAMBA2_SHARDS)
    _e, want = SV.run(params, cfg, prompts, MAMBA2_SHARDS_NEW, ecfg,
                      device=dev)
    mctx = dict(ctx, cfg=cfg, params=params, prompts=prompts, late={})
    if "full_cfg" in ctx:
        mctx["full_cfg"] = full.replace(n_layers=MAMBA2_SHARDS_LAYERS)
    moved = []
    t0 = time.perf_counter()
    with as_full_width(mctx, ecfg) as fw:
        se, seqs = SV.run(params, cfg, prompts, MAMBA2_SHARDS_NEW, ecfg,
                          device=dev, shards=2, roles="1:1",
                          watch=lambda s: (fw(s),
                                           _record_adoptions(moved)(s)))
    wall = time.perf_counter() - t0
    _same_tokens("[shards] mamba2 1:1", seqs, want)
    st = se.stats()
    slots = se.engines[0].cache.ssm.swapped_slots
    if not slots:
        raise AssertionError("[shards] mamba2 1:1: no handoff moved "
                             "recurrent state")
    if len(moved) != st["handoff"]["handoffs"] or sum(
            b for _r, b in moved) != st["handoff"]["handoff_bytes"]:
        raise AssertionError("[shards] mamba2 1:1: the adopted bytes do "
                             "not sum to handoff_bytes")
    log(f"[shards] mamba2 layers={cfg.n_layers} (published 48) d_model="
        f"{cfg.d_model} 1:1: {len(prompts)} requests, total_tokens_per_s="
        f"{(st['decoded_tokens'] + st['prefill_tokens']) / wall:.1f} "
        f"wall_s={wall:.3f}; handoffs={st['handoff']['handoffs']} "
        f"bytes={st['handoff']['handoff_bytes']}, {slots} carried a "
        "recurrent slot; tokens equal one engine's")
    return {**_shard_counts(se, st), "slot_handoffs": slots}


def phase_shards(dev, smi: str, want=None, want_sampled=None,
                 smoke: bool = False) -> tuple[dict, dict]:
    """The [shards] phase (module docstring) on ``dev``; ``want`` and
    ``want_sampled``: A's and C's tokens from [serve] (served again
    here when None; ``smoke``: the reduced config, the CPU run that
    predicts the card's counts).  Returns (the kernel launches of the
    phase's runs, the counts by run)."""
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    ctx = shards_setup(dev, smoke, want, want_sampled)
    log(f"[shards] {ctx['cfg'].name} d_model={ctx['cfg'].d_model} "
        f"requests={len(ctx['prompts'])}, every shard A's engine config, "
        f"all shards on {dev}; {smi}")
    ops.reset_launches()
    counts = {"s2": shards_mixed(ctx), "kill": shards_kill(ctx),
              "pd": shards_pd(ctx), "pd_sampled": shards_pd_sampled(ctx),
              "pd_stream": shards_pd_stream(ctx)}
    counts["mamba2"] = shards_mamba2(ctx)
    launches = {k.name: k.launches for k in ops.KERNELS}
    log(f"[shards] counts {json.dumps(counts)}")
    log(f"[shards] launches {json.dumps(launches)}; phase "
        f"{time.perf_counter() - t0:.1f} s")
    for name in SERVING_KERNELS if dev.type == "cuda" else ():
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "shards path")
    return launches, counts


# the sampled bits on the card against the CPU's (the CPU's are held to
# jax.random in tests/test_torch_sampling.py, with the same bounds)
SAMPLED_KEYS = ((0, 0), (1, 3), (7, 17), (1000, 500), (2 ** 31 + 5, 1023),
                (2 ** 32 - 1, 99999), (123456789, 2 ** 31 - 1))
GUMBEL_ULPS = 4          # |gumbel_card - gumbel_cpu| in ulps of max(1, |g|)
NEAR_TIE = 1e-5          # perturbed scores closer than this may swap
TOP_P_ULPS = 8           # a top-p boundary this close is a near-tie


def check_sampled_bits(dev):
    """``random_bits`` and ``uniform`` under seeded (seed, index) keys
    bit-equal on the card and on the CPU, ``gumbel`` within GUMBEL_ULPS
    ulps, and ``sample_tokens`` on fixed logits (B = 16, V = 32000,
    greedy and sampled rows, top-k and top-p) equal, except where the
    CPU's two best perturbed scores lie within NEAR_TIE or a top-p
    boundary within TOP_P_ULPS ulps moves a token in or out (printed)."""
    from repro_torch.serving import sampling as ts
    cpu = torch.device("cpu")
    v = 32000
    worst = 0.0
    for seed, index in SAMPLED_KEYS:
        got = {}
        for d in (cpu, dev):
            k1, k2 = ts.token_key(torch.tensor([seed], device=d),
                                  torch.tensor([index], device=d))
            got[d.type] = [f(k1, k2, (v,)).cpu() for f in
                           (ts.random_bits, ts.uniform, ts.gumbel)]
        (bc, uc, gc_), (bd, ud, gd) = got["cpu"], got[dev.type]
        if not torch.equal(bc, bd) or not torch.equal(
                uc.view(torch.int32), ud.view(torch.int32)):
            raise AssertionError(f"[serve] sampled bits: key ({seed}, "
                                 f"{index}): bits or uniforms differ from "
                                 "the CPU's")
        spacing = torch.from_numpy(np.spacing(np.maximum(
            1.0, gc_.abs().numpy()).astype(np.float32)))
        ulps = ((gd - gc_).abs() / spacing).max().item()
        worst = max(worst, ulps)
        if not ulps <= GUMBEL_ULPS:
            raise AssertionError(f"[serve] sampled bits: key ({seed}, "
                                 f"{index}): gumbel {ulps} ulps from the "
                                 "CPU's")
    rng = np.random.default_rng(5)
    n = 16
    logits = rng.standard_normal((n, v)).astype(np.float32) * 3
    seeds = rng.integers(0, 2 ** 32, n)
    index = rng.integers(0, 2 ** 20, n)
    temps = np.where(np.arange(n) % 4 == 0, 0.0,
                     rng.uniform(0.3, 1.5, n)).astype(np.float32)
    top_k = np.where(np.arange(n) % 3 == 0, 0,
                     rng.integers(1, 100, n)).astype(np.int32)
    top_p = np.where(np.arange(n) % 2 == 0, 1.0,
                     rng.uniform(0.5, 0.99, n)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (logits, index.astype(np.int64),
                                          seeds.astype(np.int64), temps,
                                          top_k, top_p)]
    tok_c = ts.sample_tokens(*args).numpy()
    tok_d = ts.sample_tokens(*[a.to(dev) for a in args]).cpu().numpy()
    # the CPU's perturbed scores and nucleus masks, to explain a difference
    lf = args[0] / torch.clamp(args[3], min=1e-6)[:, None]
    filt = {d: ts.filter_rows(lf.to(d), args[4].to(d), args[5].to(d)).cpu()
            for d in ("cpu", dev.type)}
    k1, k2 = ts.token_key(args[2], args[1])
    score = filt["cpu"] + ts.gumbel(k1[:, None], k2[:, None], (v,))
    accepted = []
    for r in np.flatnonzero(tok_c != tok_d):
        top = score[r].sort(descending=True).values
        gap = (top[0] - top[1]).item()
        moved = (filt["cpu"][r] > ts.NEG) != (filt[dev.type][r] > ts.NEG)
        probs = torch.softmax(lf[r].sort(descending=True).values, dim=-1)
        mass = (torch.cumsum(probs, 0) - probs)
        p = float(top_p[r])
        near_p = bool(moved.any()) and bool(
            ((mass - p).abs() <= TOP_P_ULPS * np.spacing(np.float32(p)))
            .any())
        if not (temps[r] > 0 and (gap < NEAR_TIE or near_p)):
            raise AssertionError(f"[serve] sample_tokens row {r}: card "
                                 f"{tok_d[r]} vs CPU {tok_c[r]} (top-two "
                                 f"gap {gap:.3g}, no near-tie)")
        accepted.append((int(r), gap, near_p))
    log(f"[serve] sampled bits on the card: random_bits and uniform "
        f"bit-equal to the CPU's at {len(SAMPLED_KEYS)} keys x {v}, gumbel "
        f"within {worst:.3g} ulps (bound {GUMBEL_ULPS}); sample_tokens "
        f"equal at {n - len(accepted)} of {n} rows"
        + (f"; near-ties accepted (row, gap, top-p boundary) {accepted}"
           if accepted else ""))


# ------------------------------------------------ slot snapshots, defaults
#
# mamba2 and jamba under the JAX engine's defaults (prefix cache with
# snapshot_slots = 2 x max_batch, swap preemption) on traffic with shared
# heads, beside the same traffic without the prefix cache and under
# recompute (the control): the tokens must be equal.

PREFIX_HEAD, PREFIX_SUFFIX = 256, (16, 512)
JAMBA_PREFIX_SUFFIX, JAMBA_PREFIX_SEED = (16, 1200), 6


def prefix_traffic(vocab: int, seed: int, n: int = 12, heads: int = 3,
                   repeats=((9, 1), (11, 6)), suffix=PREFIX_SUFFIX,
                   long_from: int | None = None) -> list[np.ndarray]:
    """``n`` prompts: one of ``heads`` heads of PREFIX_HEAD tokens (two
    128-token chunks, so snapshots land on the chunk grid), then a unique
    suffix of ``suffix`` tokens; request ``at`` repeats request ``src``
    whole for each (at, src) of ``repeats``; with ``long_from``, the
    suffixes of the requests before it are drawn from the lower half of
    ``suffix`` and the rest from the upper half.  The lengths are drawn
    first, so they do not depend on ``vocab``."""
    rng = np.random.default_rng(seed)
    lo, hi = suffix
    if long_from is None:
        lens = rng.integers(lo, hi + 1, size=n)
    else:
        mid = (lo + hi) // 2
        lens = np.concatenate([rng.integers(lo, mid + 1, size=long_from),
                               rng.integers(mid, hi + 1, size=n - long_from)])
    hs = [rng.integers(0, vocab, PREFIX_HEAD) for _ in range(heads)]
    prompts = [np.concatenate([hs[i % heads], rng.integers(0, vocab, m)])
               for i, m in enumerate(lens)]
    for at, src in repeats:
        prompts[at] = prompts[src].copy()
    return prompts


def watch_slot_swaps(eng, rec: dict):
    """Wrap the engine's slot member so that every swap-out keeps a copy
    of the request's slot (every layer's state; over a mesh the rank's
    slices) and every swap-in that came back from the host checks the
    slot bit-equal to it."""
    from repro_torch.dist import spmd
    ssm = eng.cache.ssm
    swap_out, swap_in = ssm.swap_out, ssm.swap_in
    rec.update(saved={}, checked=0)

    def out(req, peer=None):
        rec["saved"][req.rid] = [{k: spmd.local(v)[req.slot].clone()
                                  for k, v in p.items()} for p in ssm.pools]
        swap_out(req, peer=peer)

    def back(req):
        host = req.host_state is not None
        ok = swap_in(req)
        want = rec["saved"].pop(req.rid)
        if ok and host:
            for li, (p, w) in enumerate(zip(ssm.pools, want)):
                for k, v in w.items():
                    if not torch.equal(spmd.local(p[k])[req.slot], v):
                        raise AssertionError(
                            f"rid {req.rid}: layer {li} {k} of its slot not "
                            "bit-equal after the host round trip")
            rec["checked"] += 1
        elif ok is False:
            rec["saved"][req.rid] = want
        return ok

    ssm.swap_out, ssm.swap_in = out, back


def forced_preempts(eng, done: dict):
    """After a step: preempt the policy's victim (the youngest running
    request) once while it is parked exactly at a snapshot in the index
    (swap-in re-adopts it: no host trip), and once while it is past its
    prompt (a host trip).  ``done`` records which ran."""
    sched = eng.scheduler
    if not sched.running or len(done) == 2:
        return
    v = sched.policy.victim(sched.running)
    bs = eng.ecfg.block_size
    snaps = eng.cache.ssm.snapshots
    parked = (v.state.value == "prefill" and 0 < v.pos < v.prompt_len
              and v.pos % eng.ecfg.prefill_chunk == 0
              and v.snap_registered == v.pos // bs
              and snaps is not None and v.snap_key in snaps)
    decoding = v.state.value == "decode" and v.pos > v.prompt_len
    for kind, hit in (("at_snapshot", parked), ("mid_decode", decoding)):
        if hit and kind not in done:
            sched._preempt_one(eng.step_count, None)
            done[kind] = v.rid
            return


def serve_forced(eng, prompts, max_new, late_after, n_late, forced=None):
    """Submit all but the last ``n_late`` prompts, step ``late_after``
    times, submit the rest, run to the end; ``forced(eng)`` runs after
    every step.  Returns each request's tokens, in order."""
    early = len(prompts) - n_late
    rids = [eng.submit(p, max_new) for p in prompts[:early]]
    for _ in range(late_after):
        eng.step()
        if forced:
            forced(eng)
    rids += [eng.submit(p, max_new) for p in prompts[early:]]
    while not eng.scheduler.idle:
        if not eng.step():
            raise RuntimeError(f"stalled: {eng.scheduler.stall_reasons()}")
        if forced:
            forced(eng)
    return [eng.requests[r].full_sequence() for r in rids]


def phase_defaults(dev, smi, cfg, params, ecfg_kw, prompts, depth,
                   hybrid: bool):
    """Serve ``prompts`` (32 new tokens each, 4 after 4 steps) under the
    JAX engine's defaults over ``ecfg_kw`` and, as the control, without
    the prefix cache and under recompute; returns the defaults run's
    kernel launches.  Gates: equal tokens, snapshot hits and skipped
    prefill tokens; mamba2 (``hybrid`` False): two forced preemptions,
    one re-adopting a snapshot, one taking the host trip, which must
    restore the slot bit-equal; jamba: both members skip the same
    tokens, and the admission shortages of its phase still occur."""
    from repro_torch.kernels import ops
    from repro_torch.serving import Engine, EngineConfig
    arch = cfg.name
    on = {k: v for k, v in ecfg_kw.items()
          if k not in ("prefix_cache", "preempt_policy")}
    ops.reset_launches()
    eng = Engine(params, cfg, EngineConfig(**on), device=dev)
    rec, adm, done = {}, {}, {}
    watch_slot_swaps(eng, rec)
    if hybrid:
        adm.update(watch_admissions(eng))
    t0 = time.perf_counter()
    out = serve_forced(eng, prompts, 32, 4, 4,
                       None if hybrid else lambda e: forced_preempts(e, done))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in ops.KERNELS}
    ctl = Engine(params, cfg, EngineConfig(**{**on, **NO_PREFIX}),
                 device=dev)
    want = serve_forced(ctl, prompts, 32, 4, 4)
    for b, (g, w) in enumerate(zip(out, want)):
        if not np.array_equal(g, w):
            j = int(np.flatnonzero(g != w)[0]) if len(g) == len(w) else -1
            raise AssertionError(f"[{arch}] defaults: request {b} parts "
                                 f"from the control at position {j}")
    st = eng.stats()
    pc, sw = st["prefix_cache"], st["swap"]
    if pc["snapshot_hits"] <= 0 or pc["skipped_prefill_tokens"] <= 0:
        raise AssertionError(f"[{arch}] defaults: no snapshot hit or no "
                             "prefill token skipped")
    extra = ""
    if hybrid:
        a, m = eng.cache.attn, eng.cache.ssm
        if a.skipped_prefill_tokens != m.skipped_prefill_tokens:
            raise AssertionError(f"[{arch}] defaults: the attention member "
                                 f"skipped {a.skipped_prefill_tokens} "
                                 f"tokens, the slots {m.skipped_prefill_tokens}")
        slot_waits, released = shortages(eng, adm)
        if not slot_waits or not released:
            raise AssertionError(f"[{arch}] defaults: the admissions no "
                                 "longer wait for a slot and give a slot "
                                 "back")
        extra = (f"both members skipped {a.skipped_prefill_tokens} tokens; "
                 f"admissions_waiting_for_a_slot={len(slot_waits)} "
                 f"admissions_giving_back_a_slot={len(released)} ")
    else:
        if len(done) != 2 or sw["readopted_snapshots"] < 1 \
                or sw["swapped_slots"] < 1:
            raise AssertionError(f"[{arch}] defaults: forced preemptions "
                                 f"{done}, readopted_snapshots="
                                 f"{sw['readopted_snapshots']}, swapped_slots="
                                 f"{sw['swapped_slots']}")
        extra = f"forced preemptions (kind: rid) {done} "
    if not hybrid and rec["checked"] < 1:
        raise AssertionError(f"[{arch}] defaults: no host trip came back "
                             "to be checked")
    log(f"[{arch}] defaults {depth}: requests={len(prompts)} prompt_tokens="
        f"{sum(map(len, prompts))} snapshot_hits={pc['snapshot_hits']} "
        f"snapshot_queries={pc['snapshot_queries']} snapshot_stores="
        f"{pc['snapshot_stores']} snapshot_evictions="
        f"{pc['snapshot_evictions']} block_hits={pc['hits'] - pc['snapshot_hits']} "
        f"skipped_prefill_tokens={pc['skipped_prefill_tokens']} "
        f"preemptions={st['preemptions']} swap_outs={sw['swap_outs']} "
        f"swap_ins={sw['swap_ins']} swapped_slots={sw['swapped_slots']} "
        f"readopted_snapshots={sw['readopted_snapshots']} "
        f"swap_lost={eng.scheduler.swap_losts} host_trips_checked="
        f"{rec['checked']} {extra}total_tokens_per_s="
        f"{st['total_tokens_per_s']:.1f} wall_s={wall:.3f}; tokens equal "
        f"the control's (no prefix cache, recompute: total_tokens_per_s="
        f"{ctl.stats()['total_tokens_per_s']:.1f}); {smi}")
    log(f"[{arch}] defaults launches {json.dumps(launches)}")
    return launches


# ---------------------------------------------------------------- [spec]
#
# Speculative decoding (prompt-lookup drafts, one verify forward a step):
# bnn-lm-100m at published width through repro_torch.launch.serve's run
# functions, greedy and sampled, beside the same traffic with spec_k 0;
# then mixtral, deepseek and mamba2 on their phase's traffic.

SPEC_K, SPEC_NGRAM, SPEC_NEW = 4, 3, 64


def periodic_prompts(vocab: int, n: int, seed: int,
                     lens=(128, 512)) -> list[np.ndarray]:
    """``n`` prompts, each a seeded unit of 4-16 tokens repeated to
    ``lens`` tokens: prompt lookup always finds a draft."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        unit = rng.integers(0, vocab, int(rng.integers(4, 17)))
        m = int(rng.integers(lens[0], lens[1] + 1))
        out.append(np.tile(unit, -(-m // len(unit)))[:m])
    return out


def spec_traffic(vocab: int) -> list[np.ndarray]:
    """8 periodic prompts, then 8 of [serve]'s chat prompts."""
    return periodic_prompts(vocab, 8, seed=21) + serve_traffic(vocab)[:8]


def partial_steps(eng) -> int:
    """Verify steps that accepted part of their draft: more committed
    tokens than rows (one is the verifier's own), fewer than fed."""
    return sum(1 for e in eng.scheduler.trace if e["event"] == "spec_decode"
               and len(e["rids"]) < e["committed"]
               < len(e["rids"]) + e["drafted"])


def spec_gates(where, eng):
    """Verify steps ran and drafts were proposed; returns the stats and
    the partly accepted verify steps (gated over the phase: a sampled
    run of random weights rarely draws a draft's token)."""
    sp = eng.stats()["speculative"]
    if not (sp["spec_steps"] > 0 and sp["draft_tokens"] > 0):
        raise AssertionError(f"{where}: speculative stats {sp}")
    return sp, partial_steps(eng)


def spec_recheck(dev, cfg, params, prompt, max_new, ecfg_kw, sampling,
                 got: np.ndarray, want: np.ndarray, where: str):
    """A speculative request whose tokens part from its control's: serve
    it alone with ``ecfg_kw`` (no prefix cache, recompute) and spec_k 0
    (its tokens must equal the control's), then hold phase 4's decode
    replay (the C = 1 decode route the control ran) against the chunked
    re-check with the prompt in prefill chunks and every generated
    position in chunks of spec_k + 1 (the verify's route: the tiled
    attention walk, the SSD dual form) sublayer by sublayer.  Passes only
    if they part first by an accepted difference (printed) at a position
    before the token where ``got`` leaves ``want``."""
    from repro_torch.launch import serve as SV
    from repro_torch.serving import EngineConfig
    p = len(prompt)
    g = int(np.flatnonzero(got[p:len(want)] != want[p:len(got)])[0]) + p
    solo, (seq,) = SV.run(params, cfg, [prompt], max_new,
                          EngineConfig(**ecfg_kw), device=dev,
                          sampling=lambda _b: sampling)
    if not np.array_equal(seq, want):
        raise AssertionError(f"{where}: the request served alone leaves "
                             "the control's tokens")
    _tok, _f, _w, kept_r = decode_replay(params, cfg, solo, 0, dev, where)
    _lk, _lp, _f2, _w2, kept_c = _teacher_forced(
        params, cfg, seq, solo.ecfg.prefill_chunk, solo.ecfg.block_size,
        solo.cache.ring_blocks, dev, where, keep_from=p,
        tail_chunk=SPEC_K + 1)
    part = _cross_check(where, kept_r, kept_c,
                        f"generated positions in chunks of {SPEC_K + 1}")
    if part is None or part >= g:
        raise AssertionError(f"{where}: the speculative tokens part from "
                             f"the control's at position {g} with no "
                             "accepted difference of the two routes before "
                             "it")
    log(f"{where}: the speculative tokens part from the control's at "
        f"position {g}, after the verify route (chunks of {SPEC_K + 1}) "
        f"parts from the decode route at pos {part} by the accepted "
        "difference printed above; equal up to it")
    return g


def same_or_rechecked(dev, cfg, params, prompts, max_new, ecfg_kw, sampling,
                      got, want, where) -> list[int]:
    """Each request's speculative tokens equal its control's, or part
    only after an accepted difference (``spec_recheck``); returns the
    requests that parted."""
    parted = []
    for b, (g, w) in enumerate(zip(got, want)):
        if len(g) == len(w) and np.array_equal(g, w):
            continue
        spec_recheck(dev, cfg, params, prompts[b], max_new,
                     {**ecfg_kw, **NO_PREFIX},
                     None if sampling is None else sampling(b), g, w,
                     f"{where} request {b}")
        parted.append(b)
    return parted


def phase_spec(dev, smi: str, smoke: bool = False):
    """The [spec] phase: bnn-lm-100m at published width (``smoke``: the
    reduced config) through launch.serve's run functions, 16 requests
    (``spec_traffic``), 64 new tokens each, 8 after 8 steps, under
    [serve]'s A config (prefix cache, swap, 193 blocks) with spec_k 4 and
    spec_ngram 3, greedy and sampled (SERVE_SAMPLING, seed 1000 +
    request), each beside the same traffic with spec_k 0.  Returns the
    kernel launches over the speculative runs."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as SV
    from repro_torch.serving import EngineConfig
    cfg, params = serve_setup(dev, smoke)
    prompts = spec_traffic(cfg.vocab)
    cuda = dev.type == "cuda"
    log(f"[spec] {cfg.name} d_model={cfg.d_model} layers={cfg.n_layers} "
        f"requests={len(prompts)} prompt_tokens={sum(map(len, prompts))} "
        f"new={SPEC_NEW} spec_k={SPEC_K} spec_ngram={SPEC_NGRAM}; {smi}")
    launches = {k.name: 0 for k in ops.KERNELS}
    accepted = partly = 0
    spec_kw = dict(SERVE_ENGINE, spec_k=SPEC_K, spec_ngram=SPEC_NGRAM)
    for tag, sampling in (("greedy", None), ("sampled", serve_sampling)):
        sp_fn = (lambda b: SV.SamplingParams()) if sampling is None \
            else sampling
        runs = {}
        for name, kw in (("spec", spec_kw), ("plain", SERVE_ENGINE)):
            if name == "spec":
                ops.reset_launches()
            t0 = time.perf_counter()
            eng, seqs = SV.run(params, cfg, prompts, SPEC_NEW,
                               EngineConfig(**kw), sampling=sp_fn,
                               late_after=8, n_late=8, device=dev)
            if cuda:
                torch.cuda.synchronize(dev)
            runs[name] = (eng, seqs, time.perf_counter() - t0)
            if name == "spec":
                for k in ops.KERNELS:
                    launches[k.name] += k.launches
        (eng, got, wall), (ctl, want, wall_c) = runs["spec"], runs["plain"]
        sp, part = spec_gates(f"[spec] {tag}", eng)
        accepted += sp["accepted_tokens"]
        partly += part
        parted = same_or_rechecked(dev, cfg, params, prompts, SPEC_NEW,
                                   SERVE_ENGINE, sampling, got, want,
                                   f"[spec] {tag}")
        st, stc = eng.stats(), ctl.stats()
        log(f"[spec] {tag}: spec_steps={sp['spec_steps']} draft_tokens="
            f"{sp['draft_tokens']} accepted_tokens={sp['accepted_tokens']} "
            f"acceptance_rate={sp['acceptance_rate']:.3f} "
            f"tokens_per_decode_step={sp['tokens_per_decode_step']:.3f} "
            f"partly_accepted_steps={part} modeled_spec_speedup="
            f"{st['photonic']['modeled_spec_speedup']:.3f} "
            f"preemptions={st['preemptions']} swap_outs="
            f"{st['swap']['swap_outs']}; total_tokens_per_s="
            f"{st['total_tokens_per_s']:.1f} decode_calls="
            f"{st['decode_calls']} wall_s={wall:.3f} vs spec_k 0: "
            f"total_tokens_per_s={stc['total_tokens_per_s']:.1f} "
            f"decode_calls={stc['decode_calls']} wall_s={wall_c:.3f}; "
            f"tokens equal spec_k 0's"
            + (f" except requests {parted} (rechecked above)"
               if parted else ""))
    if accepted <= 0 or partly <= 0:
        raise AssertionError(f"[spec]: {accepted} draft tokens accepted, "
                             f"{partly} verify steps accepted part of "
                             "their draft")
    log(f"[spec] launches {json.dumps(launches)}")
    for name in SERVING_KERNELS if cuda else ():
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "[spec] path")
    return launches


def spec_family(dev, cfg, params, ecfg_kw, prompts, control, where,
                required):
    """One family's phase traffic (its ``prompts``, with 2 periodic
    prompts among them) served again with spec_k 4, 32 new tokens, 4
    after 4 steps, against ``control``, the phase's own run on the same
    traffic; returns the speculative run's kernel launches."""
    from repro_torch.kernels import ops
    from repro_torch.serving import Engine, EngineConfig
    ops.reset_launches()
    eng = Engine(params, cfg, EngineConfig(**ecfg_kw, spec_k=SPEC_K,
                                           spec_ngram=SPEC_NGRAM),
                 device=dev)
    t0 = time.perf_counter()
    got = serve_forced(eng, prompts, 32, 4, 4)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in ops.KERNELS}
    want = [control[r] for r in sorted(control)]
    sp = eng.stats()["speculative"]
    if not (sp["spec_steps"] > 0 and sp["draft_tokens"] > 0):
        raise AssertionError(f"{where}: no verify step ({sp})")
    if eng.cache.ssm is not None and sp["repairs"] < 1:
        raise AssertionError(f"{where}: no slot repair ({sp})")
    if eng.cache.ring_blocks and \
            not eng.stats()["mixer"]["blocks"]["ring_reuses"] > 0:
        raise AssertionError(f"{where}: the ring never wrapped")
    parted = same_or_rechecked(dev, cfg, params, prompts, 32, ecfg_kw, None,
                               got, want, where)
    st = eng.stats()
    log(f"{where} spec_k={SPEC_K}: spec_steps={sp['spec_steps']} "
        f"draft_tokens={sp['draft_tokens']} accepted_tokens="
        f"{sp['accepted_tokens']} repairs={sp['repairs']} "
        f"partly_accepted_steps={partial_steps(eng)} "
        f"tokens_per_decode_step={sp['tokens_per_decode_step']:.3f} "
        f"total_tokens_per_s={st['total_tokens_per_s']:.1f} "
        f"wall_s={wall:.3f}; tokens equal the phase's run"
        + (f" except requests {parted} (rechecked above)" if parted else ""))
    log(f"{where} spec launches {json.dumps(launches)}")
    for name in required:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on {where}'s "
                                 "speculative path")
    return launches


# --------------------------------------------------------------- phase 5

def check_xnor_popcount(dev, m: int, n: int, s: int, gen: torch.Generator,
                        timed: bool, modes=MODES, kw: int | None = None,
                        offset: int = 0) -> dict:
    """The packed x packed GEMM kernel against its plain version on
    operands packed from seeded floats (pad bits 0, as the conv path
    packs them), over ``kw`` words (default ceil(s/32); more words are
    zero), ip a view ``offset`` words into its buffer."""
    from repro_torch.kernels import _lib, binarize_pack as bp
    from repro_torch.kernels import xnor_popcount as xp
    x = torch.randn(m, s, device=dev, generator=gen)
    w = torch.randn(n, s, device=dev, generator=gen)
    ip, wp = bp.binarize_pack_torch(x), bp.binarize_pack_torch(w)
    kw = kw or ip.shape[1]
    ip = torch.nn.functional.pad(ip, (0, kw - ip.shape[1]))
    wp = torch.nn.functional.pad(wp, (0, kw - wp.shape[1])).contiguous()
    if offset:
        buf = torch.zeros(m * kw + offset, dtype=torch.int32, device=dev)
        buf[offset:] = ip.reshape(-1)
        ip = buf[offset:].view(m, kw)
    alpha = torch.rand(n, device=dev, generator=gen) + 0.5
    for mode in modes:
        got = xp.xnor_popcount_matmul(ip, wp, s, mode=mode, alpha=alpha)
        want = xp.xnor_popcount_matmul_torch(ip, wp, s, mode=mode, alpha=alpha)
        torch.cuda.synchronize()
        if got.dtype != want.dtype or not torch.equal(got, want):
            bad = (got.float() != want.float()).sum().item()
            raise AssertionError(f"xnor_popcount M={m} N={n} S={s} Kw={kw} "
                                 f"offset={offset} {mode}: {bad} elements "
                                 "differ from the plain version")
    plan = xp.xnor_plan(m, n, kw, _lib.sm_count(dev))
    row = {"shape": f"M={m} N={n} S={s}", "max_abs_err": 0.0,
           "plan": list(plan)}
    if timed:
        n_bytes = (m + n) * kw * 4 + m * n * 4          # dot: int32 out
        row["bound_ms"], row["bound_by"] = bound_ms(
            n_bytes, 2 * m * n * s, xnor_gemm_ops_per_s(dev))
        run = lambda: xp.xnor_popcount_matmul(ip, wp, s, mode="dot")
        row["ms"] = time_ms(run)
        row["eager_ms"] = eager_ms(run)
        row["plain_ms"] = time_ms(
            lambda: xp.xnor_popcount_matmul_torch(ip, wp, s, mode="dot"),
            iters=3)
        xs = torch.where(x >= 0, 1.0, -1.0).to(torch.bfloat16)
        ws = torch.where(w >= 0, 1.0, -1.0).to(torch.bfloat16)
        row["library_ms"] = time_ms(lambda: torch.matmul(xs, ws.t()))
        check_bound(row, "xnor_popcount")
    return row


# (Kw, S) of the XNOR GEMM edge checks: a word, 3 and 5 words (not a
# multiple of 4), VGG's 144 and 256; and 8 words over S = 100 (Kw past
# ceil(S/32): zero words)
XNOR_EDGE_K = ((1, 27), (3, 70), (5, 147), (144, 4608), (256, 8192),
               (8, 100))


def check_xnor_edges(dev, gen: torch.Generator) -> None:
    """Bit-exact in four modes around both routes (M = 8 / 9) and the
    tensor-core tile (64 / 65 rows), at N around the column tiles, K
    around word and vector widths; ip at an odd word offset (1-word
    copies); every route of ``xnor_plan`` at least once."""
    plans = set()
    for m in (1, 8, 9, 49, 64, 65):
        for kw, s in XNOR_EDGE_K:
            for n in (10, 77, 1000):
                r = check_xnor_popcount(dev, m, n, s, gen, False, kw=kw)
                plans.add((*r["plan"][:2], r["plan"][2] > 1))
    for m, n, kw, s in ((1, 1000, 144, 4608), (9, 77, 5, 147),
                        (64, 512, 144, 4608), (65, 77, 256, 8192),
                        (8449, 96, 10, 300)):
        r = check_xnor_popcount(dev, m, n, s, gen, False, kw=kw, offset=1)
        plans.add((*r["plan"][:2], r["plan"][2] > 1))
    # (route, tile width, split): weight read, CUDA-core tiles, binary
    # mma tiles 32 and 64 wide, split K
    want = {(0, 0, False), (1, 0, False), (2, 32, False), (2, 32, True),
            (2, 64, False)}
    if not want <= plans:
        raise AssertionError(f"xnor_popcount edges took routes {plans}, "
                             f"not all of {want}")
    log(f"[conv] xnor_popcount edges bit-exact in four modes; routes "
        f"(route, bn, split) {sorted(plans)}")


def conv_layers() -> list[tuple[str, object]]:
    """(network, LayerSpec) of every groups == 1 layer of the four BNNs:
    convs, 1x1 convs and the fully connected layers (1x1 over 1x1)."""
    from repro_torch.photonic import workloads as wl
    return [(net, layer) for net, make in wl.WORKLOADS.items()
            for layer in make() if layer.groups == 1]


def conv_args(layer) -> dict:
    """A LayerSpec's stride and padding: 'pad=0' layers are VALID, the
    rest SAME (JAX's SAME gives the published output sizes)."""
    return {"stride": layer.stride,
            "padding": "VALID" if layer.pad == 0 else "SAME"}


def _pool2(a: torch.Tensor) -> torch.Tensor:
    """2x2 max-pool of NHWC {0,1} activations (an OR; the same in the
    {-1,+1} encoding), as VGG-small pools between its conv stages."""
    b, h, w, c = a.shape
    return a.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def phase_conv(dev) -> tuple[dict, dict[str, int]]:
    """Checks and times the conv path; returns the rows for the kernel
    table and the launch counts of the run over every layer."""
    from repro_torch.core import conv, patches
    from repro_torch.core.binarize import b01_to_pm1
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(1)
    layers = conv_layers()
    cases = []
    for net, layer in layers:
        x = torch.randn(1, layer.h_in, layer.w_in, layer.c_in, device=dev,
                        generator=gen)
        w = torch.randn(layer.k, layer.k, layer.c_in, layer.c_out,
                        device=dev, generator=gen)
        cases.append((net, layer, x, w))
    shapes = sorted({(l.h_out * l.w_out, l.c_out, l.s) for _, l in layers})
    log(f"[conv] {len(layers)} ungrouped layers, {len(shapes)} distinct "
        f"GEMM shapes (M, N, S)")

    # 1. the GEMM kernel against its plain version: edges, then every
    # distinct layer shape (four modes, timed in "dot")
    check_xnor_edges(dev, gen)
    gemm = {}
    for m, n, s in shapes:
        gemm[(m, n, s)] = check_xnor_popcount(dev, m, n, s, gen, True)
        log(f"[conv] xnor_popcount {json.dumps(gemm[(m, n, s)])}")

    # 2. packing at the patch shapes (M, S) and the weight shapes (N, S);
    # the patch rows packed from each distinct layer input, and at
    # thresholds that tell the two padding rules apart (a padded tap is
    # 0.0, a position past S -1.0) on a C_in that is no multiple of 4
    packs = {}
    for m, n, s in shapes:
        for rows in (m, n):
            if (rows, s) not in packs:
                packs[(rows, s)] = check_binarize_pack(dev, rows, s, gen, True)
                log(f"[conv] binarize_pack {json.dumps(packs[(rows, s)])}")
    patch_rows = {}
    for net, layer, x, _w in cases:
        key = (tuple(x.shape), layer.k, *conv_args(layer).values())
        if key not in patch_rows:
            patch_rows[key] = {"layer": f"{net}.{layer.name}",
                               **check_pack_patches(dev, x, layer.k,
                                                    **conv_args(layer),
                                                    timed=True)}
            log(f"[conv] pack_patches {json.dumps(patch_rows[key])}")
    xe = torch.randn(2, 9, 7, 5, device=dev, generator=gen)
    for thr in (-2.0, -0.5, 0.5):
        for k, stride, padding in ((3, 2, "SAME"), (3, 1, "VALID"),
                                   (1, 1, "SAME")):
            check_pack_patches(dev, xe, k, stride, padding, False, thr)
            check_pack_patches(dev, xe[..., :4].contiguous(), k, stride,
                               padding, False, thr)

    # 3. the main path: every layer through bnn_conv2d on the card
    ops.reset_launches()
    outs = [conv.bnn_conv2d(x, w, **conv_args(layer))
            for _, layer, x, w in cases]
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in ops.KERNELS}
    log(f"[conv] launches {json.dumps(launches)}")
    for name in ("binarize_pack", "pack_patches", "xnor_popcount"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the conv path")
    nets: dict[str, dict] = {}      # per network: summed device times
    for (net, layer, x, w), got in zip(cases, outs, strict=True):
        args = conv_args(layer)
        want_shape = (1, layer.h_out, layer.w_out, layer.c_out)
        if tuple(got.shape) != want_shape or not torch.isfinite(got).all():
            raise AssertionError(f"{net}.{layer.name}: output {tuple(got.shape)}"
                                 f", want finite {want_shape}")
        plain = conv.bnn_conv2d(x, w, impl="torch", **args)
        oracle = conv.reference_sign_conv2d(x, w, **args)
        for what, ref in (("plain path", plain), ("sign-conv oracle", oracle)):
            if not torch.equal(got, ref):
                bad = int((got != ref).sum())
                raise AssertionError(f"{net}.{layer.name}: {bad} outputs "
                                     f"differ from the {what}")
        m, n, s = layer.h_out * layer.w_out, layer.c_out, layer.s
        g = gemm[(m, n, s)]
        # the library yardstick: cuDNN's bf16 conv of the sign tensors,
        # NCHW/OIHW, padded as JAX pads
        xs = patches.pad(torch.where(x >= 0, 1.0, -1.0), layer.k, layer.k,
                         **args)
        xs = xs.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous()
        ws = torch.where(w >= 0, 1.0, -1.0).permute(3, 2, 0, 1)
        ws = ws.to(torch.bfloat16).contiguous()
        row = {"layer": f"{net}.{layer.name}", "M": m, "N": n, "S": s,
               "gemm_ms": g["ms"], "bound_ms": g["bound_ms"],
               "bound_by": g["bound_by"], "gemm_plain_ms": g["plain_ms"],
               "layer_ms": time_ms(lambda: conv.bnn_conv2d(x, w, **args)),
               "library_ms": time_ms(lambda: torch.nn.functional.conv2d(
                   xs, ws, stride=layer.stride))}
        log(f"[conv] layer {json.dumps(row)}")
        tot = nets.setdefault(net, dict.fromkeys(
            ("layers", "layer_ms", "gemm_ms", "library_ms", "bound_ms"), 0))
        tot["layers"] += 1
        for k in ("layer_ms", "gemm_ms", "library_ms", "bound_ms"):
            tot[k] += row[k]
    for net, tot in nets.items():
        log(f"[conv] network {net} {json.dumps(tot)}")

    # 4. a chained binary stack: VGG-small conv2..conv6, each layer's
    # comparator output fed on as {-1,+1} (pooled where the stage halves)
    chain = [(layer, w) for net, layer, _x, w in cases
             if net == "vgg_small" and layer.name in
             ("conv2", "conv3", "conv4", "conv5", "conv6")]
    x0 = torch.randn(1, 32, 32, 128, device=dev, generator=gen)
    acts = {"kernels": x0, "plain": x0, "oracle": x0}
    for layer, w in chain:
        args = conv_args(layer)
        for route, a in acts.items():
            if a.shape[1] > layer.h_in:
                a = _pool2(a)
            a = a if a.is_floating_point() else b01_to_pm1(a)
            if route == "oracle":
                acts[route] = (conv.reference_sign_conv2d(a, w, **args) > 0
                               ).to(torch.uint8)
            else:
                acts[route] = conv.bnn_conv2d(
                    a, w, impl="auto" if route == "kernels" else "torch",
                    binary_out=True, **args)
        if not (torch.equal(acts["kernels"], acts["plain"])
                and torch.equal(acts["kernels"], acts["oracle"])):
            raise AssertionError(f"binary chain differs at vgg_small."
                                 f"{layer.name}")
    final = acts["kernels"]
    log(f"[conv] binary chain vgg_small conv2..conv6: output "
        f"{tuple(final.shape)}, {int(final.sum())} of {final.numel()} "
        f"activations set, equal on kernels, plain and oracle routes")
    return {"xnor_popcount": list(gemm.values()),
            "xnor_popcount_most_work": gemm[max(gemm, key=math.prod)],
            "binarize_pack_conv": list(packs.values()),
            "pack_patches": list(patch_rows.values())}, launches


# --------------------------------------------------------------- phase 6


def phase_photonic(st: dict):
    """Modelled numbers of the photonic accelerators (the paper's
    simulator), printed beside the card's measurements, never as
    them."""
    from repro_torch.photonic import accelerators as acc, simulator as sim
    log(f"[photonic] modelled (not measured on this card) OXBNN cost of the "
        f"served stream: {json.dumps(st['photonic'])}")
    table = sim.compare(acc.ALL)
    nets = list(next(iter(table.values())))
    for net in nets:
        log(f"[photonic] modelled Fig. 7 {net}: " + "; ".join(
            f"{a} fps={table[a][net].fps:.1f} fps/W={table[a][net].fps_per_w:.1f}"
            for a in table))
    g = {a: (sim.gmean([table[a][n].fps for n in nets]),
             sim.gmean([table[a][n].fps_per_w for n in nets])) for a in table}
    ox = g["OXBNN_50"]
    log("[photonic] modelled gmean OXBNN_50 over: " + "; ".join(
        f"{a} fps x{ox[0] / g[a][0]:.2f} fps/W x{ox[1] / g[a][1]:.2f}"
        for a in g if a != "OXBNN_50"))


# --------------------------------------------------------------- phase 7


MIXTRAL_ENGINE = dict(block_size=16, num_blocks=1025, max_batch=8,
                      prefill_chunk=128, max_model_len=8192, **NO_PREFIX)
DEEPSEEK_ENGINE = dict(block_size=16, num_blocks=1025, max_batch=8,
                       prefill_chunk=128, max_model_len=1024, **NO_PREFIX)
# 5 allocatable recurrent slots under a batch of 8: admissions wait for a
# slot, and released slots are handed out again
MAMBA2_ENGINE = dict(max_batch=8, num_slots=6, prefill_chunk=128,
                     max_model_len=2048, **NO_PREFIX)
# phase 7's cut of mamba2's depth (48 layers until the [ranks] (g)-(h)
# part took its ~220 s, 16 until [ranks] (i)-(j) took its ~100 s, 4
# until the whole smoke outran its 1200 s on slow hosts)
MAMBA2_PHASE_LAYERS = 2
PHASE7_LAYERS = 2      # mixtral's and deepseek-v2-lite's
# jamba: 5 slots under a batch of 8 and a block pool of 256 blocks (4096
# tokens) under 12 prompts of 16-1500 tokens: admissions wait for a slot
# with blocks free, and find a slot but too few blocks
JAMBA_ENGINE = dict(block_size=16, num_blocks=257, max_batch=8, num_slots=6,
                    prefill_chunk=128, max_model_len=2048, **NO_PREFIX)
JAMBA_PUBLISHED_LAYERS = (2, 5)      # the served window of the 72 layers


def jamba_window(cfg):
    """jamba-1.5-large cut to published layers 2-4, (ssm, dense), (gqa,
    moe), (ssm, dense): every width as published, one full-width
    16-expert MoE layer (two would not fit on one 80 GB card in
    float32), SSD layers on both sides of the attention layer."""
    lo, hi = JAMBA_PUBLISHED_LAYERS
    return cfg.replace(n_layers=hi - lo, attn_offset=cfg.attn_offset - lo,
                       scan_period=hi - lo)


def jamba_traffic(vocab: int):
    return family_traffic(vocab, seed=3, n=12, lens=(16, 1500))


def jamba_prefix_traffic(vocab: int):
    """The defaults pair's traffic: 12 prompts on 3 shared heads of 256
    tokens, suffixes long enough that the 256 blocks run short while a
    slot is free (and a slot while blocks are free), as in the phase."""
    return prefix_traffic(vocab, seed=JAMBA_PREFIX_SEED,
                          suffix=JAMBA_PREFIX_SUFFIX, long_from=6)


def family_traffic(vocab: int, long_lens=(), seed: int = 0, n: int = 8,
                   lens=(64, 512)):
    """``n`` seeded prompts: ``long_lens`` first and fifth (one early,
    one late), the rest ``lens[0]``-``lens[1]`` tokens."""
    rng = np.random.default_rng(seed)
    sizes = list(rng.integers(lens[0], lens[1] + 1, size=n - len(long_lens)))
    for i, m in zip((0, 4), long_lens):
        sizes.insert(i, m)
    return [rng.integers(0, vocab, size=int(m)) for m in sizes]


def with_periodic(prompts, vocab: int, seed: int, n_late: int = 4):
    """``prompts`` with 2 periodic prompts (``periodic_prompts``) at the
    end of the early group, the last ``n_late`` left last: the phase's
    traffic for the speculative run, and the phase's run its control."""
    early = len(prompts) - n_late
    return (prompts[:early] + periodic_prompts(vocab, 2, seed)
            + prompts[early:])


def slot_owners(eng) -> dict[int, list[int]]:
    """Recurrent slot -> the requests admitted to it, in order."""
    owners: dict[int, list[int]] = {}
    for e in eng.scheduler.trace:
        if e["event"] == "admit" and e["slot"] is not None:
            owners.setdefault(e["slot"], []).append(e["rid"])
    return owners


def mamba2_rids(eng, out, _rec=None) -> list[int]:
    """The longest request and the first one admitted to a slot another
    request had released."""
    reused = [rids[1] for rids in slot_owners(eng).values() if len(rids) > 1]
    if not reused:
        raise AssertionError("no recurrent slot was handed out twice")
    longest = max(out, key=lambda r: len(out[r]))
    return [longest] + [min(r for r in reused if r != longest)]


def watch_admissions(eng) -> dict:
    """Record a hybrid engine's admissions (a recurrent slot and the
    prompt's blocks) at its cache: for every attempt the request, its
    outcome, the blocks its prompt needs, both members' free counts
    before and after, and the request's position and slot after it
    (``attempts``); at every release the blocks the request held
    (``held``: its last release is at its finish)."""
    cache = eng.cache
    rec = {"attempts": [], "held": {}, "failed": []}
    alloc, release, swap_in = cache.alloc_prompt, cache.release, \
        cache.swap_in

    def free():
        return {"slots": cache.ssm.allocator.num_free,
                "blocks": cache.attn.allocator.num_free}

    def alloc_prompt(req):
        before = free()
        ok = alloc(req)
        rec["attempts"].append({
            "rid": req.rid, "ok": ok,
            "blocks_needed": cache.attn.blocks_needed(req.prompt_len),
            "free_before": before, "free_after": free(), "pos": req.pos,
            "slot": req.slot})
        if not ok:
            rec["failed"].append(req.rid)
        return ok

    def swap_in_(req):
        ok = swap_in(req)
        if ok is False:                 # deferred as no_blocks too
            rec["failed"].append(req.rid)
        return ok

    def release_(req):
        rec["held"][req.rid] = list(req.blocks)
        release(req)

    cache.alloc_prompt, cache.release, cache.swap_in = \
        alloc_prompt, release_, swap_in_
    return rec


def shortages(eng, rec) -> tuple[list[dict], list[dict]]:
    """From the recorded admissions of a hybrid engine: (the attempts
    that waited for a slot while the prompt's blocks were free, the
    attempts that found a free slot but too few blocks, and gave the
    slot back: both members' free counts as before, the request at
    position 0 without a slot).  The failed attempts and the swap-ins
    that found too few blocks must be the scheduler's ``no_blocks``
    defers."""
    failed = [a for a in rec["attempts"] if not a["ok"]]
    defers = [e["rid"] for e in eng.scheduler.trace
              if e["event"] == "defer" and e["reason"] == "no_blocks"]
    if rec["failed"] != defers:
        raise AssertionError("the failed admissions are not the trace's "
                             "no_blocks defers")
    slot_waits = [a for a in failed if a["free_before"]["slots"] == 0
                  and a["free_before"]["blocks"] >= a["blocks_needed"]]
    released = [a for a in failed if a["free_before"]["slots"] > 0
                and a["free_before"]["blocks"] < a["blocks_needed"]
                and a["free_after"] == a["free_before"]
                and a["pos"] == 0 and a["slot"] is None]
    return slot_waits, released


def phase_family(dev, smi: str, cfg, depth: str, ecfg, prompts, required,
                 e2e_rids, extra=None):
    """Serve one model family at its published widths (``cfg``, its
    depth cut as ``depth`` says) and re-check the finished requests
    ``e2e_rids(eng, out, rec)`` picks layer by layer; returns the
    serving run's launch counts.  A ring must wrap; recurrent slots must
    all be in use at once, and an admission must wait for one.  A
    hybrid stack's admissions (slots and blocks) are recorded (``rec``,
    from ``watch_admissions``): one must wait for a slot while the
    blocks are free, one must find a slot but too few blocks and give
    the slot back, and the replay runs in the engine's own table.
    ``extra(params, out)``, when given, runs last on the same weights
    (with this run's engine freed) and what it returns is returned
    beside the launch counts."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rec = {}

    def watch(eng):
        if eng.cache.attn is not None and eng.cache.ssm is not None:
            rec.update(watch_admissions(eng))
    eng, params, out, launches, st = phase_serving(
        dev, cfg, ecfg, max_new=32, late_after=4, prompts=prompts, n_late=4,
        required=required, watch=watch)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    arch, mixer, layout = cfg.name, st["mixer"], []
    if "blocks" in mixer:
        blk = mixer["blocks"]
        if eng.cache.ring_blocks and not blk["ring_reuses"] > 0:
            raise AssertionError(f"{arch}: the ring never wrapped")
        layout.append(f"blocks={json.dumps(blk)}")
    if "slots" in mixer:
        sl = mixer["slots"]
        if sl["peak_used_slots"] != sl["num_slots"]:
            raise AssertionError(f"{arch}: {sl['peak_used_slots']} of "
                                 f"{sl['num_slots']} slots ever in use")
        if rec:
            slot_waits, released = shortages(eng, rec)
            if not released:
                raise AssertionError(f"{arch}: no admission found a slot "
                                     "but too few blocks")
            waits = len(slot_waits)
            layout.append(
                f"admissions_giving_back_a_slot={len(released)} "
                f"(rids {sorted({a['rid'] for a in released})}; first "
                f"{json.dumps(released[0])})")
        else:                          # no block pool: every defer waits
            waits = sum(e["event"] == "defer" and e["reason"] == "no_blocks"
                        for e in eng.scheduler.trace)
        if not waits:
            raise AssertionError(f"{arch}: no admission waited for a slot")
        layout.append(f"slots={json.dumps(sl)} "
                      f"admissions_waiting_for_a_slot={waits} "
                      f"slot_owners={json.dumps(slot_owners(eng))}")
    log(f"[{arch}] {depth} total_tokens_per_s={st['total_tokens_per_s']:.1f} "
        f"decode_tokens_per_s={st['decode_tokens_per_s']:.1f} "
        f"preemptions={st['preemptions']} {' '.join(layout)} "
        f"peak_memory_gib={peak_gib:.2f} card={smi}")
    phase_e2e(dev, cfg, params, eng, out, rids=e2e_rids(eng, out, rec),
              held=rec.get("held"))
    if extra is None:
        return launches
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return launches, extra(params, out)


def jamba_rids(eng, out, rec) -> list[int]:
    """The longest request and the first that found a slot but too few
    blocks."""
    longest = max(out, key=lambda r: len(out[r]))
    _waits, released = shortages(eng, rec)
    return [longest] + [next(a["rid"] for a in released
                             if a["rid"] != longest)]


def phase_families(dev, smi: str) -> dict[str, dict[str, int]]:
    """Phase 7 with each family's speculative run and the defaults pairs
    (mamba2, jamba); returns the kernel launches by path."""
    from repro_torch.configs import get_config
    from repro_torch.serving import EngineConfig
    # mixtral: 2 prompts longer than its 4224-token ring (one early, one
    # late); the e2e re-check takes the first of them (its ring wrapped)
    # and the shortest request.  Each family's traffic carries 2 periodic
    # prompts for its speculative run (``extra``: spec_k 4 on the same
    # traffic, this run its control)
    cut = "layers={} (published {})"
    spec_paths = {}

    def family(name, cfg_f, depth, ecfg_kw, prompts, required, rids,
               more=None):
        def extra(params, out):
            # the weights were packed by the phase's run
            got = {"spec": spec_family(
                dev, cfg_f, params, ecfg_kw, prompts, out,
                f"[{cfg_f.name}]",
                [k for k in required if k != "binarize_pack"])}
            if more is not None:
                got["defaults"] = more(params)
            return got
        launches, got = phase_family(dev, smi, cfg_f, depth,
                                     EngineConfig(**ecfg_kw), prompts,
                                     required, rids, extra)
        for k, v in got.items():
            spec_paths[f"{name}_{k}"] = v
        return launches

    # mixtral and deepseek at PHASE7_LAYERS (4 until [ranks] (i)-(j): the
    # smoke's time limit)
    mixtral = family(
        "mixtral", get_config("mixtral-8x7b").replace(
            precision="bnn", n_layers=PHASE7_LAYERS),
        cut.format(PHASE7_LAYERS, 32), MIXTRAL_ENGINE,
        with_periodic(family_traffic(32000, (4400, 4700)), 32000, seed=31),
        FAMILY_KERNELS["mixtral-8x7b"],
        lambda eng, out, _rec: [0, min(out, key=lambda r: len(out[r]))])
    ds_prompts = with_periodic(family_traffic(102400, seed=1), 102400,
                               seed=32)
    deepseek = family(
        "deepseek", get_config("deepseek-v2-lite-16b").replace(
            precision="bnn", n_layers=PHASE7_LAYERS),
        cut.format(PHASE7_LAYERS, 27), DEEPSEEK_ENGINE, ds_prompts,
        FAMILY_KERNELS["deepseek-v2-lite-16b"],
        # the eight requests of its phase traffic (not the periodic two)
        lambda eng, out, _rec: [r for r in sorted(out) if r not in (4, 5)])
    # mamba2 at published width, MAMBA2_PHASE_LAYERS of its 48 layers:
    # 16 prompts of 16-1500 tokens (most longer than one prefill chunk);
    # the e2e re-check takes the longest and the first request that got
    # a released slot.  Then the JAX defaults (prefix cache, snapshots,
    # swap) on shared-head traffic beside its control
    m_cfg = get_config("mamba2-1.3b").replace(precision="bnn",
                                              n_layers=MAMBA2_PHASE_LAYERS)
    m_depth = cut.format(MAMBA2_PHASE_LAYERS, 48)
    mamba2 = family(
        "mamba2", m_cfg, m_depth, MAMBA2_ENGINE,
        with_periodic(family_traffic(50280, seed=2, n=16, lens=(16, 1500)),
                      50280, seed=33),
        FAMILY_KERNELS["mamba2-1.3b"], mamba2_rids,
        lambda params: phase_defaults(
            dev, smi, m_cfg, params, MAMBA2_ENGINE,
            prefix_traffic(50280, seed=5), m_depth, False))
    # jamba: published layers 2-4 (ssm, dense), (gqa, moe), (ssm, dense)
    # at published width (≈ 52 GB of float32 weights, so everything
    # before is freed first); the e2e re-check takes the longest request
    # and one that found a slot but too few blocks; then the defaults
    # pair on shared heads
    full = get_config("jamba-1.5-large-398b")
    lo, hi = JAMBA_PUBLISHED_LAYERS
    j_cfg = jamba_window(full.replace(precision="bnn"))
    j_depth = f"window=layers {lo}-{hi - 1} of {full.n_layers}"
    jamba, j_defaults = phase_family(
        dev, smi, j_cfg, j_depth, EngineConfig(**JAMBA_ENGINE),
        jamba_traffic(full.vocab), SERVING_KERNELS, jamba_rids,
        lambda params, _out: phase_defaults(
            dev, smi, j_cfg, params, JAMBA_ENGINE,
            jamba_prefix_traffic(full.vocab), j_depth, True))
    spec_paths["jamba_defaults"] = j_defaults
    return {"mixtral": mixtral, "deepseek": deepseek, "mamba2": mamba2,
            "jamba": jamba, **spec_paths}


# -------------------------------------------------------------------- main


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.serving import EngineConfig
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    last = [t0]

    def clock(what: str):
        """The seconds a phase took and the run so far."""
        now = time.perf_counter()
        log(f"[time] {what} {now - last[0]:.1f} s (run {now - t0:.1f} s)")
        last[0] = now
    smi = phase_device()
    cfg = get_config("bnn-lm-100m").replace(precision="bnn")
    rows = phase_kernels(dev, cfg)
    rows.update(phase_attention_variants(dev))
    phase_jamba_kernels(dev, rows)
    rows.update(phase_row_kernels(dev))
    clock("device, kernels")
    ecfg = EngineConfig(block_size=16, num_blocks=1025, max_batch=8,
                        prefill_chunk=128, max_model_len=1024, **NO_PREFIX)
    eng, params, out, launches, st = phase_serving(dev, cfg, ecfg)
    phase_e2e(dev, cfg, params, eng, out)
    mixed_launches = serving_mixed_pairs(dev, cfg, ecfg, params, out)
    clock("serving, e2e, mixed pairs")
    del eng, params, out
    gc.collect()
    torch.cuda.empty_cache()
    # (a)-(j) in one world of 2 and one of 4, after every part's one-rank
    # references (a world's spawn and its ranks' first use of the card
    # cost 10-25 s each)
    ranks_launches, families_ranks, train_ranks = run_ranks(dev, [
        ranks_prep(dev, smi, cfg.replace(n_layers=SERVE_LAYERS), ecfg),
        families_prep(dev, smi, families={**RANKS_FAMILIES, **RANKS_SSM}),
        train_ranks_prep(dev, smi)])
    gc.collect()
    torch.cuda.empty_cache()
    clock("[ranks] (a)-(j)")
    kept = {}
    serve_launches, out_a = phase_serve(dev, smi, keep=kept)
    clock("[serve]")
    tenants_launches = phase_tenants(dev, smi, want=out_a)
    clock("[tenants]")
    shards_launches, _counts = phase_shards(dev, smi, want=out_a,
                                            want_sampled=kept.pop("C"))
    del out_a
    gc.collect()
    clock("[shards]")
    train_out: dict = {}
    train_launches = phase_train(dev, smi, out=train_out)
    gc.collect()
    clock("[train]")
    analytic_launches = phase_analytic(dev, smi, train_out["step_ms"])
    gc.collect()
    clock("[analytic]")
    conv_rows, conv_launches = phase_conv(dev)
    phase_photonic(st)
    clock("conv, photonic")
    spec_launches = phase_spec(dev, smi)
    gc.collect()
    clock("[spec]")
    families = phase_families(dev, smi)
    gc.collect()
    clock("phase 7")
    rows["xnor_popcount"] = conv_rows["xnor_popcount"]
    rows["binarize_pack"] += conv_rows["binarize_pack_conv"]
    rows["pack_patches"] = conv_rows["pack_patches"]
    # one representative main-path shape per kernel for the summary line
    # (decode projection / decode attention / one weight / the conv
    # layer with the most XNOR work / decode over the ring / MLA
    # decode / the conv input with the most patch bits / bnn-lm-100m's
    # head at a decode bucket of 8 / a norm of 8 decode rows); every
    # shape is in the [kernels] and [conv] lines above
    pick = {"fused_bnn": rows["fused_bnn"][4],
            "paged_attention": rows["paged_attention"][0],
            "binarize_pack": rows["binarize_pack"][0],
            "xnor_popcount": conv_rows["xnor_popcount_most_work"],
            "paged_attention_ring": rows["paged_attention_ring"][0],
            "paged_attention_mla": rows["paged_attention_mla"][0],
            "pack_patches": max(rows["pack_patches"],
                                key=lambda r: r["M"] * r["S"]),
            "row_gemm": rows["row_gemm"][2],
            "row_norm": rows["row_norm"][1]}
    paths = {"serving": launches, "ranks": ranks_launches, **families_ranks,
             "ranks_train": train_ranks, "serve": serve_launches,
             "tenants": tenants_launches, "shards": shards_launches,
             "train": train_launches, "analytic": analytic_launches,
             **mixed_launches,
             "conv": conv_launches,
             "spec": spec_launches, **families}
    kernels = []
    for k in ops.KERNELS:
        r = pick[k.name]
        by_path = {p: n[k.name] for p, n in paths.items() if n[k.name]}
        kernels.append({
            "name": k.name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(x["max_abs_err"] for x in rows[k.name]),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"],
            **({"library": r["library"]} if "library" in r else {})})
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
