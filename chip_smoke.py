#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA H100 (sm_90a) and
the CUDA toolkit.  In order it

1. prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions, and builds the hand-written kernels from
   ``src/repro_torch/kernels/csrc`` with nvcc (one process per source, in
   parallel), timing the build;
2. holds each kernel (B1 distance_topk, B2 distance_argmin,
   B3 gnb_scores_batch, B4 pairwise_sq_dist, B5 topk_smallest and its
   int32 key mode, B6 distance_topk_q8, B7 distance_argmin_q8, B8
   adc_topk, B9 gnb_scores, B10 matmul, B11 flash_attention, B12
   flash_attention_bwd) against its plain PyTorch version on the card
   at the main-path shapes, at ragged edge shapes, on data with exact
   ties, on rows holding NaN and +Inf (int8: saturated ±127, INT_MIN and
   INT_MAX; B2's NaN rows take centroid 0, ROADMAP C4), B10 and B11 on
   every route of their shape rules (B11 at head dims up to 256) and at
   k = 1, k = n and k > 32, and times kernel, plain
   version and one library call; B2 on each of its routes (``rows`` for
   d <= 4, ``narrow`` for few rows, ``bulk``/``plain`` by B1's alignment
   rule, ``stream`` past its resident centroids) at d in {1, 21, 33, 784}
   and K in {1, 255, 257}, each bitwise equal to the blocked K-Means arm
   (B4, then the row min), at the fit shape too, and timed at d = 1
   beside its bound and ``cdist`` + ``argmin``; B8 on both its routes
   (``fused`` up to ``FUSED_K_MAX``, the matrix and B5 past it), at the
   ANN bucket on either side of that capacity, on all-padding rows, L not
   a multiple of 32, a split query and LUT entries past 255; B3 (and B9,
   B3 at B = 1) on both its routes (``resident``, ``stream`` past its
   resident (mu, var) pairs), at C = 16, 17, 33 (its class groups),
   B = 1, 31, 1025 and d = 1 to 1300, each timed at the path shape by
   graph replay beside CUDA events; B7 on both its routes (``resident``,
   ``stream`` past its resident centroids), on its packed keys and past
   them, at N = 1, 1024, 1025 and on duplicated centroids, bit for bit,
   and timed at the K-Means fit shape and at a serving bucket; B1 and B6
   also on an unaligned view
   (``A[1:]``, their ``plain`` route), a last tile ending off a 16-byte
   multiple, rows in adversarial order (every row beats the threshold),
   all-equal rows and the ANN probe shape, each on the route their
   alignment rule gives, with ``[time]`` lines for the ANN probe and the
   adversarial order; B5 on both its routes (``filter`` up to
   ``FILTER_K_MAX``, ``radix`` past it) in both key modes, bit for bit, at
   k = 1, k = n and either side of the cap, on split rows (R = 1, 16),
   descending rows (timed against the same rows shuffled), offset and
   row-strided views and n not a multiple of 4; B4 on both its routes and
   both its store mechanisms (``tma`` where E's pitch is 16-byte aligned,
   ``scalar`` otherwise) in both layouts, with one feature, 784
   features, ragged N and K and K = 1; at k = 32 the blocked arm's values
   and indices are checked bitwise equal to fused B1's, and the two arms
   are timed there; the blocked kNN arm is also checked at N = 2^22,
   where it splits a
   bucket's queries into chunks to bound its distance matrix;
3. drives each path through the entry points a user calls:
   ``make_fitted`` -> ``NonNeuralServeEngine.warmup_buckets`` ->
   ``classify``, with every launch count set to 0 just before and read
   just after, and checks what it serves against the same estimator run
   with ``path="ref"`` on the card.  The paths: kNN at k = 4 (B1) and
   k = 64 (the blocked arm, B4 then B5, every launch on B4's ``bulk`` and
   B5's ``filter`` route, checked), K-Means fused (B2) and blocked (B4,
   by ``REPRO_BACKEND=blocked``),
   GNB (B3), GMM at d = 784 (B3) and at d = 21 (no kernel), RF (no
   kernel).  B9's entry is ``ops.gnb_scores`` itself, driven one query at
   a time against the fitted GNB moments under its own count.  The int8
   tier serves the fitted kNN (B6), K-Means (B7), GNB, GMM-wide and RF
   estimators through ``NonNeuralServeEngine(..., policy="int8")``, held
   against the plain versions on the same quantized params (every B1 and
   B6 launch of the kNN paths on the ``bulk`` route); IVF-PQ ANN
   (``make_fitted("ann")``: B2 in the fit, on its bulk and rows routes,
   B1 probe, B8's fused route serving, one launch a bucket) is held
   against ``path="ref"`` and its recall@10 against exact fused kNN, and
   B5's int32 mode is timed on a bucket's ADC distance matrix (B8's
   matrix route); the K-Means path's B2 launches are checked to take the
   bulk route in the fit and the narrow route in serving, every B3 launch
   of the GNB, GMM-wide and B9 paths and every B7 launch of the K-Means
   int8 path the resident route;
4. serves stablelm-3b at full width (bf16, seeded weights) through
   ``ServeEngine.generate``: batch 4, prompts of 512 seeded tokens, 32
   greedy new tokens, with B10 computing every projection and the
   unembedding and B11 the prefill's causal attention; checks the launch
   counts the shapes imply (B10 225 a forward pass, 33 passes; B11 32)
   and the route of each (B10 on wgmma in the prefill and on the small-M
   kernel at M = 4, B11 on wgmma), times the prefill and the decode
   steps, holds the logits at every step against the plain route
   (``path="ref"``) on the same tokens, and holds one prefill's residual
   stream after every layer to the plain route's, within twice the plain
   route's distance from an fp32 route (``lm_layers``).  B10 and B11 are
   also timed at each path shape by a CUDA graph of the calls
   (``device_ms``), beside the CUDA-event time of a loop of calls;
   then seven more archs the same way (``lm_arch_path``, ``LM_ARCHS``, a
   ``[lm/<tag>]`` phase each, bf16 weights and stub frontend inputs
   seeded on the card): deepseek-67b and nemotron-4-340b at their
   published widths with the depth cut to the most layers whose phase
   peak stays within 72 GB (``layer_cut``; 41 and 4, named
   "<arch>-L<n>"), whisper-large-v3 (1,500 encoder frames, a 64-token
   decoder prompt; its encoder's self-attention on B11, bidirectional,
   its cross-attention's projections on B10), phi-3-vision-4.2b (576
   patch embeddings before a 512-token prompt), gemma-7b (its tied
   unembedding on B10 over a copy of the table's transpose, timed beside
   its byte bound; B11 at head_dim 256) and mamba2-780m (the SSD mixer:
   six B10 launches a layer, its scan in torch ops) at full width and
   depth, and jamba-1.5-large-398b at ``reduced`` widths in bf16
   (``phase_config``, named "<arch>-reduced": one hybrid unit of SSD,
   attention and MoE sublayers, B5 for its routers), each with B10, B11
   and B5's launches and routes as ``lm_launch_plan`` derives them from
   its layer plan, the parameter count as ``tree_extra`` derives it, the
   logits gate (jamba's plain route taking the kernel route's expert
   choices, each differing one at a near-tie: ``tied_routes``; gemma's
   and mamba2's the fp32 gate, ``gate="fp32"``) and the
   per-layer check (whisper's encoder layers first; jamba's made for
   routing, ``moe_layers``), its prefill and decode ms by the host clock
   and by device busy time, and its peak memory; then serves qwen3-moe-30b-a3b at full width and depth (``MOE``: 48
   layers, 128 experts, top 8; 61.1 GB of bf16 weights seeded on the
   card one expert slab at a time) the same way (``moe_path``): B10 for
   q, k, v, o and the unembedding, B11 in the prefill, B5 for every MoE
   layer's router (48 x 33 launches, on its filter route); B5's
   selection, ``route`` and ``apply_moe`` bit-equal to the plain route on
   a layer's real prefill states at T = 2048 (the capacity branch) and
   T = 4 (dropless), B5 timed at both router shapes; a teacher-forced
   per-layer check made for routing (``moe_layers``: every flip of a
   token's expert set at a near-tie, ``moe_flip_check``; at least
   ``MOE_SAME`` of the tokens routed alike by all routes, and the layer's
   output within ``LAYER_FACTOR`` of the fp32 noise over them); B10 and
   B11 are held against their plain versions at every served model's
   path shapes among the edge cases (``lm_path_shapes``,
   ``lm_attn_shapes``: B11 also non-causal at S = 1,500; jamba's at its
   published widths too, and B5 at every MoE model's router shapes);
   free-running greedy generation on both routes,
   printed, not gated (a flip at one near-tie moves a token by a whole
   expert's share); then, on the same weights, the planned steps
   (``moe_two_phase_path``, ``[lm/moe/two_phase]``):
   ``make_prefill_step``/``make_decode_step`` with a ``ParallelPlan`` on
   a (data 1, model 8) mesh of the card, every MoE layer two-phase (each
   shard routes its tokens on B5 and runs its 16 experts, then one psum),
   8 greedy new tokens with B5 launched 8 x 48 a forward and B10, B11 as
   on one device; per layer (``moe_two_phase_layers``) the kept slots
   equal to one device's and the output within the bf16 grouping bound
   (``two_phase_check``), layer 0's router input bit-equal and every flip
   at a near-tie; the layer's kernel route bit-equal to its plain route at
   (1, 8) and (2, 4); prefill and decode ms beside ``[lm/moe]``'s;
5. replays a seeded Poisson request stream (``STREAM``: 256 arrivals a
   tick for 64 ticks, a coalescing window of 4 ticks, a deadline of 8)
   through ``RequestScheduler`` on the fitted kNN (B1) and GNB (B3)
   estimators, every bucket warmed first, and once more on kNN with an
   LRU cache over 1024 distinct rows (``stream_path``): each request's
   prediction equals one ``classify`` of the same queries but at fp32
   near-ties, no bucket runs that was not warmed before the stream, a
   cache hit's answer equals the served one; prints the ``[stream]``
   SLO lines, the bucket histogram, the straggler events and req/s;
6. trains LR and SVM (300 full-batch steps) on the GNB path's rows on
   the card and serves the queries through Fig. 4's two-phase decision
   (``linear_path``): accuracy above 0.95, no kernel launched, classes
   equal to the CPU computation on the same weights but at near-ties;
7. serves multi-tenant fleets (``TENANTS``: 1,024 kNN tenants of 4,096
   rows at d = 21, 256 K-Means tenants at K = 8, 256 GNB tenants at
   d = 784 and 64 GMM tenants on their moments) from a ``ModelStore`` on
   the card through ``classify_group`` (``tenants_path``): one grouped
   launch of B1, B2 or B3 a (group, bucket) cell, each lane bit-equal to
   the per-tenant loop, equal to the grouped plain version but at
   near-ties, timed against the loop and, at the group shape, against
   one tenant's launch and the bound; the kNN fleet at half its resident
   bytes (evictions, admissions serving their dequantized lanes, a
   hot-swap, a NaN update refused and its breaker open), a seeded
   cross-tenant Poisson stream through the store-mode scheduler, and a
   chaos plan replayed twice.  B1, B2 and B3 are also held, grouped on
   every route, bit-equal lane by lane to their one-tenant launches
   (``tenant_kernel_edges``);
8. tunes the fitted kNN (k = 4 and k = 32), K-Means and GNB engines at
   warmup, on zeros (``warmup_buckets(d, autotune=True)``) and on the
   paths' queries (``warmup(Xq[:b], autotune=True)`` a bucket): every
   registered arm but ``quant`` and ``ref`` a bucket (``autotune_path``),
   printing each bucket's winner against the static arm in µs, no winner
   ``ref``, a tuned classify equal to the untuned engine's but at fp32
   near-ties and no slower than it on the queries;
9. fits a calibration from the kNN k = 32 timings on the queries
   (``calibrate_path``),
   installs it with ``dispatch.set_cost_model`` and checks that the
   selector then takes the arm measured fastest at bucket 1024, and that
   a fresh engine launches its kernels; then clears it;
10. measures the brownout rungs' capacity factors (int8 on kNN, K-Means
   and GNB, IVF-PQ ANN on kNN at N = 2^20) and replays a seeded
   overloading kNN stream down a ``build_ladder`` ladder with every rung
   (``ladder_path``): downshifts, every tier inside its warmed buckets,
   answers equal to each tier's one-shot classify, no degraded answer
   cached, ANN labels agreeing with exact kNN on >= 0.95.
11. runs the sharded layer on the card (``sharded_path``): every path's
   estimator (kNN at k = 4 and 64, K-Means, GNB, GMM wide, RF, ANN, and
   the int8 kNN and K-Means tiers) over ``make_local_mesh(c, card)`` at
   c = 8 and c = 3 shards: ``fit_sharded`` held against the one-device fit
   (kNN and RF bit for bit, the others within 2e-4), then a full and a
   ragged bucket through ``NonNeuralServeEngine(mesh=...)`` under each
   registered strategy and ``auto``, each kernel of the path launched c
   times a bucket, classes and neighbours equal to the one-device
   engine's, int8 ``reference`` refused; the ms of a 1024 classify a
   strategy at c = 1 and 8; autotune with the strategy axis at c = 8; a
   request stream on the 3-shard mesh;
12. last, trains stablelm-3b at full width and depth
   (``TRAIN``: bf16, batch 8 x seq 128 from ``token_stream``, the train
   CLI's defaults): B12 (attention's backward pass) held against its
   plain version at its edge shapes and at the path's, on both its routes
   (``wgmma``, ``cuda_core``, each case on the one its rule gives, a
   second call bit-equal), and each route timed beside SDPA's backward
   (``train_kernel_edges``, ``train_kernel_times``); B10
   through its autograd form at every forward, dA and dB shape of the
   step, and B11 at the step's shape, each against its plain version
   (``train_path_edges``); one
   step's gradients on the kernel route held leaf by leaf to the plain
   route's, within ``LAYER_FACTOR`` of the plain route's distance from an
   fp32 route, remat ``full`` and ``dots`` bit-equal to ``none``, and each
   policy's launches and routes equal to ``train_launches``
   (``train_step_checks``); then the main path, ``launch/train.run`` at
   the CLI's defaults for ``TRAIN["steps"]`` steps through
   ``FaultTolerantRunner`` with the counts set to 0 just before and read
   just after: no ``step_failure``, finite losses, the probe loss falling,
   the checkpoint of the last step restored by a fresh runner bit-equal,
   and its next step bit-equal to the uninterrupted run's; the median
   step, tokens/s, model-FLOPs share, peak memory and one profiled step's
   top kernels printed (``train_path``).

The comparison rule: integer outputs (B5's int32 mode, B6, B7, B8 and
the int8 and ANN paths' neighbours, assignments and votes) match
exactly.  Float values match to rtol = atol = 1e-5, where for a
squared distance rtol applies to ‖a‖² + ‖c‖², the size of the terms of
the expansion that both versions evaluate (see ``near``), and for a GMM
log-responsibility to the size of the terms of the Gaussian log-density
(see ``gauss_scale``); GNB scores use rtol on the score itself.  Indices
match exactly except at a rank where the two rows' distances agree within
that tolerance (a near-tie between different rows), which is counted and
printed.  On integer-valued data every distance is exact, so there the
indices must match exactly; B5 ranks the very floats its plain version
sorts, so its indices must match exactly everywhere.  B10 matches to one
ulp of the output dtype plus 1e-5·(|A|·|B|) (see ``gemm_case``); B11 to
2^-7·(P·|V| + |out|) in bf16, from the rounding of p (see
``attn_case``); the LM logits to ``LM_ATOL + LM_RTOL·|logit|``, or
under the fp32 gate (mamba2-780m, gemma-7b, whose right bf16 routes
stand about that far from an fp32 route) to within ``LAYER_FACTOR``
times the plain route's distance from an fp32 route, step by step; a
greedy token may differ from the plain route's argmax only where that
route ranks the two within twice what the gate allows between the two
routes (a near-tie, counted).  B12 matches
to ``BWD_RTOL`` of the size of the terms it sums plus one ulp (see
``attn_bwd_case``); a training step's gradients, leaf by leaf, to
``LAYER_FACTOR`` times the plain route's distance from an fp32 route
(ROADMAP C3's rule).  Any failure exits
non-zero; so does a machine without a card, or a directory without the
package.  The last lines are a JSON object with each kernel's numbers,
the card's name and power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = dict(rtol=1e-5, atol=1e-5)
SEED = 0
DEVICE = "cuda:0"
MAX_BATCH = 1024
N_QUERIES = 4096
# main-path sizes: kNN over a million rows at the asd_like width, K-Means
# with the coarse-quantizer K, GNB at the mnist_like width
KNN = dict(n=1 << 20, d=21, classes=3, k=4)
KMEANS = dict(n=1 << 18, d=21, K=256)
GNB = dict(n=60_000, d=784, classes=10)
# slice 2: kNN past B1's lists on the same data (the blocked arm), GMM on
# the GNB data (d >= 64: B3) and on the kNN data (d = 21: the ref
# E-step), RF at the reference's defaults on 4,000 kNN rows (its CART
# trains in Python loops on the host)
KNN_BLOCKED_K = 64
GMM_NARROW_ROWS = 1 << 18
RF = dict(n=4_000, trees=16, depth=8)

# slice 3: the int8 tier serves the fitted estimators above; IVF-PQ ANN at
# the repo's own ANN configuration (DESIGN.md §10, benchmarks/ann_sweep.py
# at its largest N): 256 blob classes, 256 cells, dsub = 1 codebooks
ANN = dict(n=1 << 18, d=21, classes=256, cells=256, pq_m=21, n_codes=256,
           k=10, refine=128, nprobe=16, train_iters=10)
Q8_BLOCKED_K = 64

# slice 4: stablelm-3b at full width serves a batch of 4 prompts of 512
# seeded tokens and 32 greedy new tokens (the KV cache holds 544)
LM = dict(arch="stablelm-3b", batch=4, prompt=512, new=32)
# slice 21: four more archs served the same way, each a phase of its own
# ("[lm/<tag>]"): deepseek-67b and nemotron-4-340b at their published
# widths with the depth cut to the most layers whose phase peak stays
# within CUT_PEAK_BYTES (``layer_cut``; the arch id says "-L<n>"), then
# whisper-large-v3 (32 + 32 layers, 1,500 seeded encoder frames, a
# 64-token decoder prompt: its text context is 448) and phi-3-vision-4.2b
# (576 seeded patch embeddings before a 512-token prompt) at full depth
LM_ARCHS = (
    dict(tag="deepseek", arch="deepseek-67b", batch=4, prompt=512, new=32,
         cut=True),
    dict(tag="nemotron", arch="nemotron-4-340b", batch=4, prompt=512, new=32,
         cut=True),
    dict(tag="whisper", arch="whisper-large-v3", batch=4, prompt=64, new=32,
         cut=False),
    dict(tag="vlm", arch="phi-3-vision-4.2b", batch=4, prompt=512, new=32,
         cut=False),
    # slice 22: jamba (the hybrid unit: SSD, attention and MoE
    # sublayers) at ``reduced`` widths in bf16, since no unit of its
    # published width fits one card; mamba2-780m (the SSD mixer, tied) and
    # gemma-7b (its tied unembedding, B11 at head_dim 256) at full width
    # and depth, their logits held by the fp32 gate (``gate``: see
    # LM_ATOL below)
    dict(tag="jamba", arch="jamba-1.5-large-398b", batch=4, prompt=512,
         new=32, cut=False, reduced=True),
    dict(tag="mamba2", arch="mamba2-780m", batch=4, prompt=512, new=32,
         cut=False, gate="fp32"),
    dict(tag="gemma", arch="gemma-7b", batch=4, prompt=512, new=32,
         cut=False, gate="fp32"))
CUT_PEAK_BYTES = 72e9
# B10's edge sizes (every M, N, K among them) and B11's (S, d)
GEMM_EDGES = (1, 3, 65, 257, 6913)
ATTN_EDGES_S = (1, 12, 129, 512)
ATTN_EDGES_D = (16, 64, 80, 128, 144, 192, 256)
# the LM path's logits, kernel route against plain route, agree to
# LM_ATOL + LM_RTOL·|logit|: both round the residual stream to bf16 at
# every layer, but not the same sums, so 32 layers leave logit
# differences of a few bf16 ulps (on an H100 the largest of the 6.6
# million compared comes to about 0.8 of this bound), where a wrong
# kernel moves logits by their own size (about 1)
LM_ATOL, LM_RTOL = 2.0 ** -3, 2.0 ** -6
# That bound is absolute, set on stablelm.  Two right bf16 routes of
# mamba2-780m stand up to 1.8 of it from an fp32 route (and of gemma-7b
# up to 1.0), so their phases (``gate="fp32"``) hold the logits as the
# per-layer check below holds each layer: at every step an fp32 route
# (the plain route over fp32 copies of the weights) runs beside the two,
# and the kernel route's largest |logit − fp32 logit| over the tolerance
# at the fp32 logits may be at most LAYER_FACTOR times the plain route's.
# A wrong tile moves some logits by their own size, many times the noise.
# the per-layer check (ROADMAP C3): after every layer of one teacher-forced
# prefill, the kernel route's residual stream may stand from the plain
# route's at most LAYER_FACTOR times as far (Frobenius norm over the whole
# (B, S, d_model) state) as the plain route stands from an fp32 plain
# route on the same bf16 weights.  Two right bf16 routes round the same
# fp32 sums, mostly to the same values, so their distance sits below the
# bf16 rounding noise that the fp32 route measures; a wrong tile of one
# head in one layer moves it past that noise at that layer.
LAYER_FACTOR = 2.0
# slice 15: qwen3-moe-30b-a3b at full width and depth (48 layers, 128
# experts, top-8 on B5; 61.1 GB of bf16 weights) serves a batch of 4
# prompts of 512 seeded tokens and 32 greedy new tokens: its prefill's
# 2048 tokens take the capacity branch (C = 160 an expert), as stablelm's
# batch does; a prompt of 1024 would run dropless at C = 8 x 1024 with a
# 4.3 GB dispatch buffer a layer.  Decode is dropless (C = 32 at batch 4)
MOE = dict(arch="qwen3-moe-30b-a3b", batch=4, prompt=512, new=32)
# the MoE per-layer check holds a layer's output only over the tokens that
# every route sends to the same experts; at least this share of a layer's
# tokens must be among them (in runs on the card at least 1,866 of 2,048
# were), or a fault that moves most routers would leave nothing to hold
MOE_SAME = 0.5
# the same served model through the planned steps
# (``make_prefill_step``/``make_decode_step`` with a ParallelPlan) on a
# (data, model) mesh of the one card, 16 experts a model shard: every MoE
# layer runs two-phase (OP1 a shard, OP2 one psum), B5 once a shard; 8
# greedy new tokens, since eight shards multiply the decode step's host
# work.  "split" is the (data, model) mesh of one more layer held kernel
# route against plain route (its data shards change the capacity)
TWO_PHASE = dict(mesh=(1, 8), split=(2, 4), new=8)

# training: stablelm-3b trains at full width and depth (bf16, seeded
# weights) on the train CLI's defaults: batch 8 x seq 128 from
# token_stream, AdamW at lr 1e-3, remat "dots"; STEPS steps through the
# CLI's FaultTolerantRunner loop, the probe loss logged every LOG_EVERY
TRAIN = dict(arch="stablelm-3b", batch=8, seq=128, steps=20, log_every=5)
# B12's edge sizes: S = 1, S off the 32- and 64-row tiles, S = 64 (the
# wgmma route's tile exactly) and past it; d off 32, and d on both sides
# of the wgmma route's 128 (bf16 d = 16, 80, 128 take wgmma, the rest the
# CUDA cores)
BWD_EDGES_S = (1, 45, 64, 129)
BWD_EDGES_D = (16, 33, 80, 128, 256)
# B12 against its plain version: both sum in fp32 (the wgmma route feeds
# P and dS in as two bf16 terms each, 16 significant bits), so BWD_RTOL of
# the size of the summed terms, plus one ulp of the output dtype
BWD_RTOL = 1e-4

# slice 10: a Poisson request stream (the JAX CLI's --stream model) through
# RequestScheduler on the fitted kNN (B1) and GNB (B3) engines, cycling
# N_QUERIES queries: 256 arrivals a tick fill a 1024 bucket in the
# coalescing window, about 16,400 requests in all; a third run on kNN
# repeats 1024 distinct rows through an LRU of 4096, so cached answers
# are served.  Then LR and SVM (paper §4.2) trained on the GNB data with
# the JAX package's defaults (300 full-batch steps) and served on
# N_QUERIES queries
STREAM = dict(rate=256, ticks=64, max_wait=4, deadline=8, cache_size=4096,
              cache_rows=1024)
# slice 11: multi-tenant fleets at the paper's widths (kNN and K-Means at
# asd_like's d = 21, GNB at mnist_like's d = 784), served in groups of 64
# tenants through buckets of up to 16 rows (ROWS); the kNN fleet's A has
# 86,016 >= 2^16 elements a tenant (352 MB fp32 in all); a cross-tenant
# Poisson stream (TENANT_STREAM) over it, tenants drawn by seed
TENANTS = dict(knn=dict(G=1024, n=4096, d=21, classes=3, k=4),
               kmeans=dict(G=256, n=4096, d=21, K=8),
               gnb=dict(G=256, n=512, d=784, classes=10),
               group=64, rows=16, resident_frac=0.5)
TENANT_STREAM = dict(rate=256, ticks=64, max_wait=4, deadline=8)
LINEAR_STEPS = 300
# slice 12: autotune over the fitted kNN (k = 4 and k = 32, where blocked
# B4 + B5 and fused B1 cross), K-Means and GNB estimators of the paths; the
# brownout ladder's capacity factors up to FMAX x MAX_BATCH rows, then a
# kNN stream of fresh seeded rows, each sent once, down a ladder built with
# every rung, admission bounded at eight fp32 drains: 4 calm ticks, 32 at
# twice a fp32 drain's 1024 requests, 32 light ones; then every 16th row
# sent again, 256 a tick, through an LRU that holds every row (a row hits
# if and only if tier 0 served it: degraded answers are never cached)
AUTOTUNE = (("knn", 4), ("knn", 32), ("kmeans", None), ("gnb", None))
# a tuned engine's classify against the untuned one's: median of TUNE_REPS
# alternating turns, no slower than x TUNE_TOL + TUNE_SLACK_MS (the host
# clock's spread at the host-bound K-Means and GNB buckets)
TUNE_REPS, TUNE_TOL, TUNE_SLACK_MS = 7, 1.10, 0.05
LADDER = dict(fmax=8, reps=5, factors={"int8": 2, "ann": 4}, deadline=8,
              max_wait=4, max_queue=8192,
              trace=((256, 4), (2048, 32), (64, 32)), probe_every=16,
              probe_rate=256)
# slice 13: the sharded layer over make_local_mesh(c, card): every path's
# estimator fitted with fit_sharded at c = 8 (a power of two: the butterfly
# merge) and c = 3 (ragged: the gather merge, buckets rounded to 3) and
# served under each registered strategy and auto, a full bucket and a
# ragged one of RAGGED rows; autotune with the strategy axis at c = 8 on
# TUNE_BUCKETS; a stream at c = 3 (256 arrivals a tick for 16 ticks)
SHARDED = dict(meshes=(8, 3), ragged=37, tune_buckets=(8, 64, 1024),
               time_reps=5, stream=dict(rate=256, ticks=16, max_wait=4))
# (case, algorithm, launches a bucket a shard of each kernel); the int8
# cases serve the one-device fits' quantized copies
SHARDED_CASES = (("knn", "knn", {"B1": 1}),
                 ("knn k=64", "knn", {"B4": 1, "B5": 1}),
                 ("kmeans", "kmeans", {"B2": 1}),
                 ("gnb", "gnb", {"B3": 1}),
                 ("gmm wide", "gmm", {"B3": 1}),
                 ("rf", "rf", {}),
                 ("ann", "ann", {"B1": 1, "B8": 1}),
                 ("knn int8", "knn", {"B6": 1}),
                 ("kmeans int8", "kmeans", {"B7": 1}))
# tests/test_mesh_parity.py's tolerances: the psum'd fits, and the float
# aux of a model partition (or of another B3 plan)
SHARD_FIT_TOL = dict(rtol=2e-4, atol=2e-4)
SHARD_AUX_TOL = dict(rtol=1e-4, atol=1e-4)

# NVIDIA data-sheet peaks by H100 variant, at the full power limit: fp32
# outside the tensor cores (FLOP/s), device-memory rate (bytes/s), the
# dense int8 tensor-core rate (OP/s) and the dense bf16 one (FLOP/s)
PEAKS = {"PCIe": (51.2e12, 2.0e12, 1513e12, 756e12),
         "NVL": (60.0e12, 3.9e12, 1671e12, 835e12),
         "SXM": (67.0e12, 3.35e12, 1979e12, 989e12)}


def check(cond, msg: str) -> None:
    if not cond:
        print(f"FAIL: {msg}", flush=True)
        sys.exit(1)


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def card_peaks(name: str):
    for key in ("PCIe", "NVL"):
        if key in name:
            return key, PEAKS[key]
    return "SXM", PEAKS["SXM"]


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of one call over ``reps`` calls, after one
    warm call, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_ops: float, n_bytes: float, peaks, int8: bool = False,
             bf16: bool = False):
    """The larger of ops over the peak (fp32, or the int8 or bf16 tensor
    cores' with ``int8`` or ``bf16``) and bytes over the memory rate."""
    t_ops = n_ops / peaks[3 if bf16 else 2 if int8 else 0] * 1e3
    t_bytes = n_bytes / peaks[1] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def ulp(torch, x, dtype):
    """One unit in the last place, in ``dtype`` (bf16 keeps 8 significant
    bits, fp32 24), of each value of x: two right roundings of one exact
    product can differ by that much."""
    _, e = torch.frexp(x.float())
    bits = 7 if dtype == torch.bfloat16 else 23
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 1 - bits)


def gemm_check(torch, ref, got, a, b, what):
    """B10's output ``got`` against its plain version on the same operands
    a (M, K) and b (K, N).  Tolerance: one ulp of the plain value in the
    output dtype (each side rounds the fp32 sum once; two roundings of
    sums that differ in their last bits can land one ulp apart, up to
    2^-7·|ref| in bf16) plus 1e-5·(|A|·|B|) for the fp32 sums' order.
    Returns (max |err|, max err/tol)."""
    want = ref.matmul(a, b)
    torch.cuda.synchronize()
    M, N = a.shape[0], b.shape[1]
    check(got.dtype == a.dtype and got.shape == (M, N),
          f"{what}: {got.dtype} {tuple(got.shape)}")
    err = (got.float() - want.float()).abs()
    tol = ulp(torch, want, a.dtype) + \
        1e-5 * (a.float().abs() @ b.float().abs())
    check(bool((err <= tol).all()), f"{what}: {int((err > tol).sum())} "
          f"values past the tolerance, max error {float(err.max())}")
    return float(err.max()), float((err / tol).max())


def gemm_case(torch, ops, ref, dev, gen, M, N, K, dtype):
    """B10 against its plain version on N(0, 1) operands (``gemm_check``).
    Returns (max |err|, max err/tol)."""
    a = torch.randn((M, K), generator=gen, device=dev).to(dtype)
    b = torch.randn((K, N), generator=gen, device=dev).to(dtype)
    return gemm_check(torch, ref, ops.matmul(a, b), a, b,
                      f"B10 M={M} N={N} K={K} {dtype}")


def gemm_way(torch, M, N, K, dtype) -> str:
    """The route kernels/gemm.py's shape rule gives B10 at (M, N, K)."""
    from repro_torch.kernels.gemm import SMALL_M
    return "small_m" if M <= SMALL_M else "fp32" if dtype == torch.float32 \
        else "wgmma" if N % 8 == 0 and K % 8 == 0 else "mma_sync"


def attn_pv(torch, q, k, v, causal):
    """P·|V| with the plain version's probabilities: the size of the terms
    an output row sums."""
    S, d = q.shape[-2], q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * \
        (1.0 / math.sqrt(d))
    if causal:
        keep = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(keep, s, torch.full_like(s, -1e30))
    return torch.matmul(torch.softmax(s, -1), v.float().abs())


def attn_inputs(torch, dev, gen, B, H, S, d, dtype, layout="model"):
    """q, k, v (B, H, S, d) of N(0, 1): in the models' (B, S, H, d) memory
    seen through a permute, or contiguous."""
    if layout == "model":
        x = torch.randn((B, S, 3, H, d), generator=gen, device=dev).to(dtype)
        return [x[:, :, i].permute(0, 2, 1, 3) for i in range(3)]
    return [torch.randn((B, H, S, d), generator=gen, device=dev).to(dtype)
            for _ in range(3)]


def attn_case(torch, ops, ref, q, k, v, causal, what):
    """B11 against its plain version.  Tolerance: in bf16 both sides cast
    p to bf16 before P·V, but the kernel casts exp(s - running max) and
    the plain version the normalised p, each within 2^-8 relative, so
    their sums differ by up to 2^-7·(P·|V|); the outputs' own roundings
    add up to 2^-7·|ref|.  In fp32, 1e-5·(P·|V|) for the sums' order and
    one ulp.  Returns (max |err|, max err/tol)."""
    got = ops.flash_attention(q, k, v, causal=causal)
    want = ref.attention(q, k, v, causal)
    pv = attn_pv(torch, q, k, v, causal)
    torch.cuda.synchronize()
    check(got.dtype == q.dtype and got.shape == q.shape,
          f"{what}: {got.dtype} {tuple(got.shape)}")
    err = (got.float() - want.float()).abs()
    if q.dtype == torch.bfloat16:
        tol = 2.0 ** -7 * (pv + want.float().abs()) + 1e-5 * pv
    else:
        tol = 1e-5 * pv + ulp(torch, want, q.dtype)
    check(bool((err <= tol).all()), f"{what}: {int((err > tol).sum())} "
          f"values past the tolerance, max error {float(err.max())}")
    return float(err.max()), float((err / tol).max())


def lm_proj_shapes(cfg):
    """The (N, K) of one model's projections, distinct and in order (from
    ``transformer.layer_plan``): q, k, v, o where it has attention; an
    SSD mixer's z and x, B and C, dt and out where it has one; the dense
    MLP's where it has one."""
    from repro_torch.models import transformer
    mixers, ffns, _, _ = transformer.layer_plan(cfg)
    d = cfg.d_model
    proj = []
    if "attn" in mixers:
        proj += [(cfg.q_dim, d), (cfg.kv_dim, d), (d, cfg.q_dim)]
    if "ssm" in mixers:
        proj += [(cfg.d_inner, d), (cfg.ssm.n_groups * cfg.ssm.d_state, d),
                 (cfg.ssm_heads, d), (d, cfg.d_inner)]
    if "mlp" in ffns:
        proj += [(cfg.d_ff, d), (d, cfg.d_ff)]
    return list(dict.fromkeys(proj))


def lm_seq(cfg, prompt: int) -> int:
    """The decoder's prefill length: a VLM's patches, then the prompt."""
    return prompt + (cfg.vision.num_patches if cfg.vision is not None
                     else 0)


def lm_path_shapes(cfg, batch: int, prompt: int):
    """The B10 (M, N, K) of one model's serving path, distinct and in
    order: its projections (``lm_proj_shapes``) at the prefill's M =
    batch · (patches + prompt) and at decode's M = batch, then the
    unembedding at M = batch, then for an enc-dec arch the same
    projections at the encoder's M = batch · n_ctx (the encoder's layers,
    and the decoder's cross-attention keys and values of the memory; its
    queries and outputs are the decoder's q and o shapes); and B11's (B,
    H, S, d) of its decoder's prefill (after the GQA repeat), None for a
    model without attention."""
    from repro_torch.models import transformer
    proj = lm_proj_shapes(cfg)
    S = lm_seq(cfg, prompt)
    gemm = [(M, N, K) for M in (batch * S, batch) for N, K in proj]
    gemm.append((batch, cfg.vocab_size, cfg.d_model))
    if cfg.encoder is not None:
        gemm += [(batch * cfg.encoder.n_ctx, N, K) for N, K in proj]
    attn = (batch, cfg.n_heads, S, cfg.head_dim) \
        if "attn" in transformer.layer_plan(cfg)[0] else None
    return list(dict.fromkeys(gemm)), attn


def lm_attn_shapes(cfg, batch: int, prompt: int):
    """B11's ((B, H, S, d), causal) on one model's serving path: the
    decoder's causal prefill (none without attention), and an enc-dec
    arch's bidirectional encoder layers at S = n_ctx."""
    attn = lm_path_shapes(cfg, batch, prompt)[1]
    shapes = [] if attn is None else [(attn, True)]
    if cfg.encoder is not None:
        shapes.append(((batch, cfg.n_heads, cfg.encoder.n_ctx,
                        cfg.head_dim), False))
    return shapes


def attn_path_inputs(torch, dev, gen, cfg, B, S, dtype):
    """q, k, v (B, H, S, d) of N(0, 1) laid out as ``apply_attention``
    gives them to B11: q a (B, S, H, d) projection seen through a permute,
    k and v (B, S, KV, d) projections repeated to H heads (the GQA
    repeat), then permuted."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.randn((B, S, H, hd), generator=gen, device=dev).to(dtype)
    kv = [torch.randn((B, S, KV, hd), generator=gen, device=dev).to(dtype)
          .repeat_interleave(H // KV, dim=2) for _ in range(2)]
    return [t.permute(0, 2, 1, 3) for t in [q] + kv]


def lm_kernel_edges(torch, ops, ref, dev, gen, models) -> int:
    """B10 at every (M, N, K) of ``GEMM_EDGES``, at every LM path's shapes
    (``models``: (config, batch, prompt) of each served model, through
    ``lm_path_shapes``) and at the small-M boundary; B11 at every (S, d)
    of the edge sizes, causal and not, in the models' layout, plus a head
    dim that is not a multiple of 16 (the CUDA-core kernel in bf16), and
    at each model's path shapes in its own layout (``lm_attn_shapes``:
    the decoder's causal prefill, an encoder's bidirectional layers);
    both dtypes, each path case on the route the shape rule gives; B5 at
    each MoE model's router shapes.  Returns the number of cases."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gemm
    from repro_torch.kernels.gemm import SMALL_M
    path, attn_path = [], []
    for cfg, batch, prompt in models:
        shapes, _ = lm_path_shapes(cfg, batch, prompt)
        path += [s for s in shapes if s not in path]
        attn_path += [(cfg, attn, causal) for attn, causal in
                      lm_attn_shapes(cfg, batch, prompt)]
    d, ff = models[0][0].d_model, models[0][0].d_ff
    path += [(SMALL_M, ff, d), (SMALL_M + 1, d, ff)]
    n = 0
    ops.reset_launches()
    for dtype in (torch.bfloat16, torch.float32):
        worst = (0.0, 0.0)
        for M in GEMM_EDGES:
            for N in GEMM_EDGES:
                for K in GEMM_EDGES:
                    r = gemm_case(torch, ops, ref, dev, gen, M, N, K, dtype)
                    worst = max(worst, r, key=lambda t: t[1])
                    n += 1
        for M, N, K in path:
            way = gemm_way(torch, M, N, K, dtype)
            before = gemm.ROUTE_LAUNCHES[way]
            err, ratio = gemm_case(torch, ops, ref, dev, gen, M, N, K, dtype)
            check(gemm.ROUTE_LAUNCHES[way] == before + 1,
                  f"B10 {dtype} M={M} N={N} K={K} did not take the {way} "
                  f"route: {gemm.ROUTE_LAUNCHES}")
            print(f"[edge] B10 {dtype} M={M} N={N} K={K} ({way}): "
                  f"max_abs_err={err:.4g}, {ratio:.3f} of the tolerance")
            n += 1
        print(f"[edge] B10 {dtype}: all {len(GEMM_EDGES) ** 3} shapes with "
              f"M, N, K in {GEMM_EDGES} within the tolerance; worst "
              f"max_abs_err={worst[0]:.4g}, {worst[1]:.3f} of it")
    # the shape rule of kernels/gemm.py, applied to every case above
    want = dict.fromkeys(gemm.ROUTE_LAUNCHES, 0)
    shapes = [(M, N, K) for M in GEMM_EDGES for N in GEMM_EDGES
              for K in GEMM_EDGES] + path
    for dtype in (torch.bfloat16, torch.float32):
        for M, N, K in shapes:
            want[gemm_way(torch, M, N, K, dtype)] += 1
    edge_routes = dict(gemm.ROUTE_LAUNCHES)
    check(edge_routes == want, f"B10 edge routes {edge_routes}, the shape "
          f"rule gives {want}")
    for dtype in (torch.bfloat16, torch.float32):
        cases = [(1, 2, S, hd, c, "model") for S in ATTN_EDGES_S
                 for hd in ATTN_EDGES_D for c in (True, False)]
        cases += [(1, 2, 129, 24, True, "model"),
                  (2, 3, 130, 80, True, "contiguous")]
        worst = (0.0, 0.0)
        for B, H, S, hd, causal, layout in cases:
            q, k, v = attn_inputs(torch, dev, gen, B, H, S, hd, dtype, layout)
            r = attn_case(torch, ops, ref, q, k, v, causal,
                          f"B11 {dtype} B={B} H={H} S={S} d={hd} "
                          f"causal={causal} {layout}")
            worst = max(worst, r, key=lambda t: t[1])
            n += 1
        print(f"[edge] B11 {dtype}: {len(cases)} cases (S in {ATTN_EDGES_S}, "
              f"d in {ATTN_EDGES_D}, causal and full, d = 24, a contiguous "
              f"layout) within the tolerance; d = 80 takes the "
              f"{fa.route(*attn_inputs(torch, dev, gen, 1, 1, 4, 80, dtype))} "
              f"route; worst max_abs_err={worst[0]:.4g}, {worst[1]:.3f} of "
              "it")
    # bf16 at d % 16 == 0 takes wgmma; d = 24 and every fp32 case the
    # CUDA cores
    n_wg = sum(hd % 16 == 0 for _, _, _, hd, _, _ in cases)
    want = {"wgmma": n_wg, "cuda_core": 2 * len(cases) - n_wg}
    check(fa.ROUTE_LAUNCHES == want, f"B11 edge routes "
          f"{fa.ROUTE_LAUNCHES}, the layout rule gives {want}")
    print(f"[edge] routes: B10 {edge_routes}, B11 {dict(fa.ROUTE_LAUNCHES)}")
    for cfg, (B, H, S, hd), causal in attn_path:
        mask = "causal" if causal else "full"
        for dtype in (torch.bfloat16, torch.float32):
            way = "wgmma" if dtype == torch.bfloat16 and hd % 16 == 0 \
                else "cuda_core"
            before = fa.ROUTE_LAUNCHES[way]
            q, k, v = attn_path_inputs(torch, dev, gen, cfg, B, S, dtype)
            err, ratio = attn_case(
                torch, ops, ref, q, k, v, causal, f"B11 {cfg.arch_id} "
                f"{dtype} B={B} H={H} S={S} d={hd} {mask}")
            check(fa.ROUTE_LAUNCHES[way] == before + 1,
                  f"B11 {cfg.arch_id} {dtype} did not take the {way} route: "
                  f"{fa.ROUTE_LAUNCHES}")
            print(f"[edge] B11 {cfg.arch_id} {dtype} B={B} H={H} S={S} "
                  f"d={hd} {mask}, KV heads {cfg.n_kv_heads} repeated "
                  f"({way}): max_abs_err={err:.4g}, {ratio:.3f} of the "
                  "tolerance")
            n += 1
    # B5 at each MoE model's router shapes (the prefill's batch x S tokens
    # and decode's batch, top-k of the negated softmax probabilities of E
    # experts, as ``moe.route`` hands them to it), on the filter route
    from repro_torch.kernels import topk_select
    for cfg, batch, prompt in models:
        if cfg.moe is None:
            continue
        E, k = cfg.moe.num_experts, cfg.moe.top_k
        way = topk_select.route(k)
        for T in (batch * lm_seq(cfg, prompt), batch):
            x = -torch.softmax(torch.randn((T, E), generator=gen,
                                           device=dev), dim=-1)
            before = topk_select.ROUTE_LAUNCHES[way]
            got, want = ops.topk_smallest(x, k), ref.topk_smallest(x, k)
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"B5 {cfg.arch_id} router T={T} E={E} k={k}: differs "
                  "from its plain version")
            check(topk_select.ROUTE_LAUNCHES[way] == before + 1,
                  f"B5 {cfg.arch_id} router T={T} did not take the {way} "
                  f"route: {topk_select.ROUTE_LAUNCHES}")
            print(f"[edge] B5 {cfg.arch_id} router T={T} E={E} k={k} "
                  f"({way}): values and indices equal")
            n += 1
    return n


def attn_bwd_terms(torch, q, k, v, o, do, causal):
    """The sizes of the terms that dq, dk and dv sum (the plain formula on
    absolute values): dV's P^T|dO|, and dQ's and dK's |dS| bound
    P·(|dO||V|^T + rowsum|dO·o|) against |K| and |Q|, scaled."""
    S, d = q.shape[-2], q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, of, gf = (t.float() for t in (q, k, v, o, do))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        keep = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(keep, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, -1)
    ds = p * (torch.matmul(gf.abs(), vf.abs().transpose(-1, -2)) +
              (gf * of).abs().sum(-1, keepdim=True))
    return (torch.matmul(ds, kf.abs()) * scale,
            torch.matmul(ds.transpose(-1, -2), qf.abs()) * scale,
            torch.matmul(p.transpose(-1, -2), gf.abs()))


def attn_bwd_inputs(torch, ops, gen, q, k, v, causal):
    """B11's output o at q, k, v and an N(0, 1) output gradient dO laid out
    as q (the models' layout stays permuted)."""
    o = ops.flash_attention(q, k, v, causal=causal)
    do = torch.empty_like(q).copy_(torch.randn(
        q.shape, generator=gen, device=q.device).to(q.dtype))
    return o, do


def bwd_way(torch, dtype, hd) -> str:
    """The route kernels/flash_attention_bwd.py's rule gives B12 on
    aligned tensors (every layout of these checks is): ``wgmma`` for bf16
    with d a multiple of 16 up to 128, else ``cuda_core``."""
    return "wgmma" if dtype == torch.bfloat16 and hd % 16 == 0 and \
        hd <= 128 else "cuda_core"


def attn_bwd_case(torch, ops, ref, gen, q, k, v, causal, what, way=None):
    """B12 against its plain version on the same q, k, v, o, dO, through
    ``ops.flash_attention_bwd`` (the rule's route) or, with ``way``, the
    launcher on that route.  Tolerance: both sum in fp32 from the same
    inputs and round once (the wgmma route's P and dS in two bf16 terms
    keep 16 bits, 2^-17 relative), so BWD_RTOL of the size of the terms
    (``attn_bwd_terms``: the fp32 sums' order over up to S·d terms, and
    exp of scores that agree to a few fp32 ulps) plus one ulp of the
    output dtype.  A second call on the same inputs must give the same
    bits (no atomics, a fixed schedule).  Returns (max |err|, max
    err/tol)."""
    from repro_torch.kernels import flash_attention_bwd as fab
    o, do = attn_bwd_inputs(torch, ops, gen, q, k, v, causal)

    def call():
        if way is None:
            return ops.flash_attention_bwd(q, k, v, o, do, causal=causal)
        return fab.launch(q, k, v, o, do, causal, way=way)
    got = call()
    again = call()
    want = ref.attention_bwd(q, k, v, o, do, causal=causal)
    terms = attn_bwd_terms(torch, q, k, v, o, do, causal)
    torch.cuda.synchronize()
    worst = (0.0, 0.0)
    for name, g, a, w, m, x in zip(("dq", "dk", "dv"), got, again, want,
                                   terms, (q, k, v)):
        check(g.dtype == x.dtype and g.shape == x.shape,
              f"{what} {name}: {g.dtype} {tuple(g.shape)}")
        err = (g.float() - w.float()).abs()
        tol = BWD_RTOL * m + ulp(torch, w, x.dtype)
        check(bool((err <= tol).all()), f"{what} {name}: "
              f"{int((err > tol).sum())} values past the tolerance, max "
              f"error {float(err.max())}")
        worst = max(worst, (float(err.max()), float((err / tol).max())),
                    key=lambda t: t[1])
        check(torch.equal(g, a), f"{what} {name}: a second call on the "
              "same inputs gave other bits")
    return worst


def train_kernel_edges(torch, ops, ref, dev, gen, cfg) -> int:
    """B12 against its plain version at every (S, d) of ``BWD_EDGES_S`` x
    ``BWD_EDGES_D`` (S = 1, S off and on the tiles, d not a multiple of
    32, d past the wgmma route's 128), causal and full, fp32 and bf16, in
    the models' permuted layout and contiguous, and at the training path's
    shape (``TRAIN``: batch x heads x seq x head dim of ``cfg``, laid out
    as ``apply_attention`` gives it) on each route, two calls a case
    (``attn_bwd_case``: bit-equal), each counted once in ``ops.LAUNCHES``
    and on the route ``bwd_way`` gives; both routes must run.  Returns
    the number of cases."""
    from repro_torch.kernels import flash_attention_bwd as fab
    ops.reset_launches()
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        worst = {}
        for S in BWD_EDGES_S:
            for hd in BWD_EDGES_D:
                for causal in (True, False):
                    layout = "model" if (S + hd) % 2 else "contiguous"
                    q, k, v = attn_inputs(torch, dev, gen, 2, 3, S, hd, dtype,
                                          layout)
                    way = bwd_way(torch, dtype, hd)
                    before = fab.ROUTE_LAUNCHES[way]
                    what = f"B12 {dtype} S={S} d={hd} causal={causal} " \
                        f"{layout}"
                    r = attn_bwd_case(torch, ops, ref, gen, q, k, v, causal,
                                      what)
                    check(fab.ROUTE_LAUNCHES[way] == before + 2,
                          f"{what} did not take the {way} route: "
                          f"{fab.ROUTE_LAUNCHES}")
                    worst[way] = max(worst.get(way, (0.0, 0.0)), r,
                                     key=lambda t: t[1])
                    n += 1
        print(f"[edge] B12 {dtype}: {len(BWD_EDGES_S) * len(BWD_EDGES_D) * 2}"
              f" cases (S in {BWD_EDGES_S}, d in {BWD_EDGES_D}, causal and "
              f"full, permuted and contiguous), each called twice, bit-equal,"
              f" within the tolerance; worst " + ", ".join(
                  f"{w} max_abs_err={e:.4g}, {x:.3f} of it"
                  for w, (e, x) in sorted(worst.items())))
    check(ops.LAUNCHES["flash_attention_bwd"] == 2 * n and
          all(fab.ROUTE_LAUNCHES.values()),
          f"B12: {ops.LAUNCHES['flash_attention_bwd']} launches for {n} "
          f"cases, routes {fab.ROUTE_LAUNCHES}; both routes expected")
    B, S = TRAIN["batch"], TRAIN["seq"]
    for dtype, way in ((torch.bfloat16, None), (torch.bfloat16, "cuda_core"),
                       (torch.float32, None)):
        q, k, v = attn_path_inputs(torch, dev, gen, cfg, B, S, dtype)
        want = way or bwd_way(torch, dtype, cfg.head_dim)
        before = fab.ROUTE_LAUNCHES[want]
        err, ratio = attn_bwd_case(torch, ops, ref, gen, q, k, v, True,
                                   f"B12 path {dtype} {want}", way)
        check(fab.ROUTE_LAUNCHES[want] == before + 2,
              f"B12 path {dtype} did not take the {want} route: "
              f"{fab.ROUTE_LAUNCHES}")
        print(f"[edge] B12 {cfg.arch_id} {dtype} B={B} H={cfg.n_heads} "
              f"S={S} d={cfg.head_dim} causal, the models' layout, {want} "
              f"route{'' if way is None else ' (named)'}: "
              f"max_abs_err={err:.4g}, {ratio:.3f} of the tolerance")
        n += 1
    return n


def train_path_shapes(cfg, batch: int, seq: int):
    """The B10 products of one training step of ``cfg`` at batch x seq
    tokens, as (M, K, N) of each distinct weight's x (M, K) @ w (K, N) at
    M = batch · seq: the projections (``lm_proj_shapes``) and the
    unembedding (d_model, vocab).  Each gives three launches: the forward
    (M, N, K), dA = dC @ wᵀ (M, K, N) and dB = xᵀ @ dC (K, N, M).  And
    B11's (B, H, S, d) of the forward (after the GQA repeat)."""
    weights = [(K, N) for N, K in lm_proj_shapes(cfg)]
    weights.append((cfg.d_model, cfg.vocab_size))
    M = batch * seq
    return [(M, K, N) for K, N in dict.fromkeys(weights)], \
        (batch, cfg.n_heads, seq, cfg.head_dim)


def train_path_edges(torch, ops, ref, dev, gen, cfg) -> int:
    """B10 and B11 at the training path's shapes (``TRAIN`` on ``cfg``,
    ``train_path_shapes``): B10 through its autograd form
    (``kernels/autograd.matmul``) for each weight, in bf16 as the step
    runs it, forward and backward from an N(0, 1) dC, each of the three
    outputs held against its plain version on the operands
    ``_matmul_backward`` gives B10 (contiguous transposed copies) with
    ``gemm_check``'s tolerance, and each launch on the route the shape
    rule gives; B11 at the forward's shape in the models' layout, bf16 and
    fp32 (``attn_case``), on its route.  Returns the number of cases."""
    from repro_torch.kernels import autograd as grad_ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gemm
    bf = torch.bfloat16
    shapes, (B, H, S, hd) = train_path_shapes(cfg, TRAIN["batch"],
                                              TRAIN["seq"])
    n = 0
    for M, K, N in shapes:
        x = torch.randn((M, K), generator=gen, device=dev).to(bf)
        w = torch.randn((K, N), generator=gen, device=dev).to(bf)
        dc = torch.randn((M, N), generator=gen, device=dev).to(bf)
        cases = (("forward", x, w), ("dA", dc, w.t().contiguous()),
                 ("dB", x.t().contiguous(), dc))
        want = dict(gemm.ROUTE_LAUNCHES)
        for _, a, b in cases:
            want[gemm_way(torch, a.shape[0], b.shape[1], a.shape[1],
                          bf)] += 1
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        out = grad_ops.matmul(xg, wg)
        got = (out.detach(),) + torch.autograd.grad(out, (xg, wg), dc)
        del xg, wg, out
        check(gemm.ROUTE_LAUNCHES == want, f"B10 train x ({M}, {K}) @ w "
              f"({K}, {N}): routes {gemm.ROUTE_LAUNCHES}, the shape rule "
              f"gives {want}")
        for (name, a, b), g in zip(cases, got):
            Mc, Kc, Nc = a.shape[0], a.shape[1], b.shape[1]
            what = f"B10 train {name} M={Mc} N={Nc} K={Kc} {bf}"
            err, ratio = gemm_check(torch, ref, g, a, b, what)
            print(f"[edge] {what} ({gemm_way(torch, Mc, Nc, Kc, bf)}, "
                  f"autograd form): max_abs_err={err:.4g}, {ratio:.3f} of "
                  "the tolerance")
            n += 1
        del x, w, dc, cases, got
    for dtype in (bf, torch.float32):
        way = "wgmma" if dtype == bf and hd % 16 == 0 else "cuda_core"
        before = fa.ROUTE_LAUNCHES[way]
        q, k, v = attn_path_inputs(torch, dev, gen, cfg, B, S, dtype)
        what = f"B11 train {cfg.arch_id} {dtype} B={B} H={H} S={S} d={hd} " \
            "causal"
        err, ratio = attn_case(torch, ops, ref, q, k, v, True, what)
        check(fa.ROUTE_LAUNCHES[way] == before + 1,
              f"{what} did not take the {way} route: {fa.ROUTE_LAUNCHES}")
        print(f"[edge] {what}, the models' layout ({way}): "
              f"max_abs_err={err:.4g}, {ratio:.3f} of the tolerance")
        n += 1
    return n


def train_kernel_times(torch, ops, ref, dev, gen, cfg, peaks):
    """B12 at the training path's shape (``TRAIN`` on ``cfg``, bf16,
    causal, the models' layout, the wgmma route by the rule): the kernels
    by CUDA events and by graph replay; the CUDA-core route (named) on the
    same inputs by graph replay; its plain version; and SDPA's backward on
    contiguous copies (the library row) by events and by graph replay (a
    captured forward and backward less the captured forward), beside its
    bound.  Returns B12's kernel row."""
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.launch.lm_kernel_times import device_ms
    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, S, H, hd = TRAIN["batch"], TRAIN["seq"], cfg.n_heads, cfg.head_dim
    bf = torch.bfloat16
    q, k, v = attn_path_inputs(torch, dev, gen, cfg, B, S, bf)
    o, do = attn_bwd_inputs(torch, ops, gen, q, k, v, True)
    check(fab.route(q, k, v, o, do) == "wgmma",
          f"B12 main: the rule gives {fab.route(q, k, v, o, do)}")
    err, _ = attn_bwd_case(torch, ops, ref, gen, q, k, v, True, "B12 main")
    qc, kc, vc = (t.detach().contiguous() for t in (q, k, v))
    doc = do.contiguous()

    def library(backward):
        # fresh leaves each call, so that a captured backward stays on
        # the capturing stream
        a, b, c = (t.detach().requires_grad_() for t in (qc, kc, vc))
        out = sdpa(a, b, c, is_causal=True)
        return torch.autograd.grad(out, (a, b, c), doc) if backward else out
    leaves = [t.detach().requires_grad_() for t in (qc, kc, vc)]
    out = sdpa(*leaves, is_causal=True)
    pairs = B * H * S * (S + 1) // 2
    b, by = bound_ms(10 * pairs * hd, 8 * B * H * S * hd * 2, peaks,
                     bf16=True)
    row = dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="src/repro/models/attention.py:82", max_abs_err=err,
        ms=cuda_ms(torch, lambda: ops.flash_attention_bwd(q, k, v, o, do),
                   20),
        dev_ms=device_ms(lambda: ops.flash_attention_bwd(q, k, v, o, do), 20),
        core_dev_ms=device_ms(lambda: fab.launch(q, k, v, o, do, True,
                                                 way="cuda_core"), 20),
        plain_ms=cuda_ms(torch, lambda: ref.attention_bwd(q, k, v, o, do),
                         5),
        library_ms=cuda_ms(torch, lambda: torch.autograd.grad(
            out, leaves, doc, retain_graph=True), 20),
        lib_dev_ms=device_ms(lambda: library(True), 20) -
        device_ms(lambda: library(False), 20),
        bound_ms=b, bound_by=by, launches=0)
    print(f"[time] B12 {row['name']} B={B} H={H} S={S} d={hd} bf16 causal: "
          f"wgmma route {row['ms']:.4f} ms, device {row['dev_ms']:.4f} ms "
          f"(the CUDA-core route {row['core_dev_ms']:.4f} ms device), plain "
          f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, "
          f"device {row['lib_dev_ms']:.4f} ms (SDPA backward), bound "
          f"{b:.4f} ms ({by})")
    return row


def train_launches(cfg, remat: str) -> dict:
    """The launches of one training step (forward and backward) of the
    dense ``cfg`` under ``remat``, derived from the code: B10 (``matmul``)
    once a projection (q, k, v, o and the gated MLP's three: 7 a layer)
    and for the unembedding in the forward pass, twice each (dA, dB) in
    the backward pass, and the layers' 7 again where ``full`` recomputes
    them (``dots`` keeps B10's outputs); B11 once a layer, twice where
    the layer is recomputed (``full`` and ``dots``); B12 once a layer.
    Every launch takes the wgmma route of its kernel (the step's shapes
    are bf16 with 16-byte aligned rows; ``train_step_checks`` and
    ``train_path`` check the routes)."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    check(transformer.layer_plan(cfg)[1] == ["mlp"] and cfg.mlp_type in
          ("swiglu", "geglu"), f"{cfg.arch_id}: the launch rule is the "
          "dense gated model's")
    L, fwd = cfg.n_layers, 7 * cfg.n_layers + 1
    want = dict.fromkeys(ops.LAUNCHES, 0)
    want["matmul"] = 3 * fwd + (7 * L if remat == "full" else 0)
    want["flash_attention"] = L * (1 if remat == "none" else 2)
    want["flash_attention_bwd"] = L
    return want


def grad_dist(torch, a, b) -> float:
    """‖a − b‖ over a leaf in fp32, a slice of at most 2^24 values at a
    time (a stacked leaf of stablelm-3b is 566M values)."""
    rows = max(1, (1 << 24) * a.shape[0] // a.numel()) if a.ndim > 1 \
        else a.numel()
    return math.sqrt(sum(float((x.float() - y.float()).square().sum())
                         for x, y in zip(a.split(rows), b.split(rows))))


def train_grads(torch, ops, cfg, params, batch, remat, path=None):
    """One step's loss and gradients (``trainer.loss_and_grads``) under
    ``remat`` with the launch counts set to 0 just before and read just
    after: (loss, gradient tree, launches, B10, B11 and B12 routes)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import gemm
    from repro_torch.training import trainer
    ops.reset_launches()
    loss, _, grads = trainer.loss_and_grads(params, batch, cfg,
                                            TrainConfig(remat=remat), path)
    torch.cuda.synchronize()
    return loss, grads, dict(ops.LAUNCHES), dict(
        b10=dict(gemm.ROUTE_LAUNCHES), b11=dict(fa.ROUTE_LAUNCHES),
        b12=dict(fab.ROUTE_LAUNCHES))


def aten_calls(torch, fn) -> int:
    """The number of operators ``fn()`` dispatches, forward and backward
    (a dispatch mode that counts each call and runs it)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))
    with Count():
        fn()
    return Count.n


def b10_dispatch_us(torch, ops, dev, reps: int = 200):
    """Host µs a call of B10 at a small shape (64 x 64 x 64, bf16, one
    synchronize after ``reps`` calls): the wrapper called directly, its
    custom operator (``kernels/autograd.matmul``), and the operator
    recording autograd, as a training forward calls it."""
    from repro_torch.kernels import autograd as grad_ops
    a, b = (torch.randn((64, 64), device=dev).to(torch.bfloat16)
            for _ in range(2))
    ag, bg = a.clone().requires_grad_(), b.clone().requires_grad_()

    def per_call(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e6
    with torch.enable_grad():
        return (per_call(lambda: ops.matmul(a, b)),
                per_call(lambda: grad_ops.matmul(a, b)),
                per_call(lambda: grad_ops.matmul(ag, bg)))


def train_step_checks(torch, ops, dev, cfg):
    """The training phase's step checks on one batch (``TRAIN``, the first
    of the CLI's ``token_stream`` batches) at full width: the kernel
    route's gradients (remat ``none``) against the plain route's and an
    fp32 plain route's, every leaf within ``LAYER_FACTOR`` of the plain
    route's fp32 noise (ROADMAP C3's rule); remat ``full`` and ``dots``
    bit-equal to ``none``; each policy's launches and routes equal to
    ``train_launches``.  Prints each policy's warm time and operator count
    and B10's dispatch cost (``aten_calls``, ``b10_dispatch_us``).
    Returns the rows printed."""
    from repro_torch import tree as T
    from repro_torch.data.datasets import token_stream
    from repro_torch.data.pipeline import TokenBatcher, to_device
    from repro_torch.models import transformer
    B, S = TRAIN["batch"], TRAIN["seq"]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = transformer.init_params(cfg, gen, device=dev)
    batcher = TokenBatcher(token_stream(2_000_000, cfg.vocab_size), B, S)
    batch = to_device(batcher.batch_at(0), dev)
    runs = {}
    for remat in ("none", "full", "dots"):
        loss, grads, launches, routes = train_grads(torch, ops, cfg, params,
                                                    batch, remat)
        want = train_launches(cfg, remat)
        check(launches == want, f"train {remat}: launches {launches}, the "
              f"code implies {want}")
        want_routes = dict(
            b10=dict(wgmma=want["matmul"], mma_sync=0, small_m=0, fp32=0),
            b11=dict(wgmma=want["flash_attention"], cuda_core=0),
            b12=dict(wgmma=want["flash_attention_bwd"], cuda_core=0))
        check(routes == want_routes, f"train {remat}: routes {routes}, the "
              f"design implies {want_routes}")
        check(bool(torch.isfinite(loss)), f"train {remat}: loss {loss}")
        print(f"[lm/train] {remat}: loss {float(loss):.6f}; launches B10 "
              f"{launches['matmul']}, B11 {launches['flash_attention']}, "
              f"B12 {launches['flash_attention_bwd']} (as derived); routes "
              f"B10 {routes['b10']}, B11 {routes['b11']}, B12 "
              f"{routes['b12']}")
        if remat == "none":
            runs[remat] = (loss, grads)
            continue
        base_loss, base = runs["none"]
        differ = [p for (p, g), b in zip(T.flatten(grads), T.leaves(base))
                  if not torch.equal(g, b)]
        check(torch.equal(loss, base_loss) and not differ,
              f"train {remat}: loss {float(loss)} against {float(base_loss)}"
              f"; gradients not bit-equal to remat none at {differ}")
        print(f"[lm/train] {remat}: loss and all {len(T.leaves(grads))} "
              "gradient leaves bit-equal to remat none")
        del grads
    # the host's share of a step: each policy's loss and gradients timed
    # warm (the faster of two, each to a synchronize), the operators it
    # dispatches, and B10's custom-operator dispatch beside the wrapper's
    step_ms, n_aten = {}, {}
    for remat in ("none", "full", "dots"):
        ms = []
        for _ in range(2):
            t0 = time.perf_counter()
            train_grads(torch, ops, cfg, params, batch, remat)
            ms.append((time.perf_counter() - t0) * 1e3)
        step_ms[remat] = min(ms)
        n_aten[remat] = aten_calls(torch, lambda: train_grads(
            torch, ops, cfg, params, batch, remat))
    direct, op, rec = b10_dispatch_us(torch, ops, dev)
    fwd = 7 * cfg.n_layers + 1
    print("[lm/train] loss and gradients, ms (warm, host clock to a "
          "synchronize) and operators dispatched a step: " + ", ".join(
              f"{r} {step_ms[r]:.2f} ms ({n_aten[r]} ops)" for r in step_ms)
          + f"; dots - none {step_ms['dots'] - step_ms['none']:.2f} ms; B10 "
          f"a call at 64 x 64 x 64: wrapper {direct:.1f} us, custom "
          f"operator {op:.1f} us, recording autograd {rec:.1f} us, so "
          f"{(rec - direct) * fwd / 1e3:.2f} ms a step over {fwd} forward "
          "calls")
    g_kernel = runs.pop("none")[1]
    _, g_plain, plain_launches, _ = train_grads(torch, ops, cfg, params,
                                                batch, "none", "ref")
    check(not any(plain_launches.values()), f"train plain route launched "
          f"kernels: {plain_launches}")
    p32 = T.map(lambda t: t.float(), params)
    del params
    _, g_exact, _, _ = train_grads(torch, ops, cfg, p32, batch, "none", "ref")
    del p32
    rows = []
    for (path, gk), gp, ge in zip(T.flatten(g_kernel), T.leaves(g_plain),
                                  T.leaves(g_exact)):
        dist, noise = grad_dist(torch, gk, gp), grad_dist(torch, gp, ge)
        rows.append((path, dist, noise, dist <= LAYER_FACTOR * noise))
    bad = [r for r in rows if not r[3]]
    check(not bad, "train gradients: " + "; ".join(
        f"{p}: ‖kernel − plain‖ {d:.4g} > {LAYER_FACTOR} x ‖plain − fp32‖ "
        f"{n:.4g}" for p, d, n, _ in bad))
    worst = max(rows, key=lambda r: r[1] / r[2])
    print(f"[lm/train] gradients, kernel route against plain route, every "
          f"leaf within {LAYER_FACTOR} x the plain route's distance from an "
          f"fp32 route (ROADMAP C3's rule): at most {worst[1] / worst[2]:.3f}"
          f" x ({worst[0]}); " + ", ".join(
              f"{p} {d / n:.3f}" for p, d, n, _ in rows))
    return rows


def train_path(torch, ops, dev, cfg, peaks):
    """The training phase's main path and what follows it: the train
    CLI's loop (``launch/train.run`` at its defaults for ``TRAIN["steps"]``
    steps, remat ``dots``, checkpoint at the last step) with the counts
    set to 0 just before and read just after; no ``step_failure``, finite
    losses, the probe loss lower at the last logged step than at the
    first; then a fresh runner restores the checkpoint, bit-equal to the
    run's state with dtypes kept, and its next step is bit-equal to the
    uninterrupted run's.  Prints the step's timings.  Returns the
    launches of the CLI run."""
    import shutil
    from repro_torch import tree as T
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data.pipeline import to_device
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.launch import train
    from repro_torch.launch.lm_kernel_times import device_kernels
    from repro_torch.runtime.events import kinds
    from repro_torch.runtime.fault_tolerance import (FaultTolerantRunner,
                                                     RunState)
    from repro_torch.training import trainer
    steps, every = TRAIN["steps"], TRAIN["log_every"]
    B, S = TRAIN["batch"], TRAIN["seq"]
    ckpt_dir = ROOT / ".train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = train.run(train.parse_args(
        ["--arch", cfg.arch_id, "--steps", str(steps), "--log-every",
         str(every), "--ckpt-dir", str(ckpt_dir), "--device", str(dev)]))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    b12_routes = dict(fab.ROUTE_LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_logs = len(res["logged"])
    step = train_launches(cfg, "dots")
    want = dict.fromkeys(ops.LAUNCHES, 0)
    # each step, then a no-grad forward of the probe batch at each log
    want["matmul"] = steps * step["matmul"] + n_logs * (7 * cfg.n_layers + 1)
    want["flash_attention"] = steps * step["flash_attention"] + \
        n_logs * cfg.n_layers
    want["flash_attention_bwd"] = steps * step["flash_attention_bwd"]
    check(launches == want, f"train CLI: launches {launches}, the code "
          f"implies {want}")
    check(b12_routes == dict(wgmma=want["flash_attention_bwd"], cuda_core=0),
          f"train CLI: B12 routes {b12_routes}, all wgmma expected")
    runner, state, losses = res["runner"], res["state"], res["losses"]
    fails = kinds(runner.events, "step_failure")
    check(not fails, f"train CLI: step failures {fails}")
    check(state.step == steps and res["logged"][-1] == steps and
          all(math.isfinite(x) for x in losses), f"train CLI: step "
          f"{state.step}, losses {losses}")
    check(losses[-1] < losses[0], f"train CLI: the probe loss did not fall "
          f"({losses})")
    warm = sorted(res["step_ms"][2:])
    step_ms = warm[len(warm) // 2]
    n_params = cfg.param_count()
    mfu = 6 * n_params * B * S / (step_ms / 1e3) / peaks[3]
    print(f"[lm/train] CLI {cfg.arch_id} batch={B} seq={S} remat=dots "
          f"steps={steps}: {run_s:.1f}s with the checkpoint; probe loss "
          f"{' -> '.join(f'{x:.4f}' for x in losses)} at steps "
          f"{res['logged']}; no step_failure; launches B10 "
          f"{launches['matmul']}, B11 {launches['flash_attention']}, B12 "
          f"{launches['flash_attention_bwd']} (as derived; B12 routes "
          f"{b12_routes}); median step "
          f"{step_ms:.2f} ms after 2 warm-up steps ({B * S / step_ms * 1e3:.0f}"
          f" tokens/s), model-FLOPs share {mfu:.4f} of {peaks[3] / 1e12:g} "
          f"TFLOP/s (6 x {n_params} x {B * S} a step); peak "
          f"{peak_gb:.2f} GB allocated")

    # the checkpoint of step `steps`, restored by a fresh runner, and one
    # more step from each
    batch = to_device(res["batcher"].batch_at(steps), dev)
    step_fn = trainer.make_train_step(res["cfg"], res["train_cfg"])
    host = T.map(lambda t: t.to("cpu", copy=True),
                 {"params": state.params, "opt_state": state.opt_state})
    state = runner.run_step(step_fn, state, batch)
    after = T.map(lambda t: t.to("cpu", copy=True),
                  {"params": state.params, "opt_state": state.opt_state})
    like = T.map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                       device="meta"), host)
    del state, res, runner
    torch.cuda.empty_cache()
    fresh = FaultTolerantRunner(Checkpointer(ckpt_dir / cfg.arch_id))
    t0 = time.perf_counter()
    got = fresh.maybe_restore(RunState(0, like["params"], like["opt_state"]),
                              device=dev)
    restore_s = time.perf_counter() - t0
    check(got.step == steps, f"resume: restored step {got.step}")

    def same(tree, want_tree, what):
        bad = [p for (p, g), w in zip(T.flatten(tree), T.leaves(want_tree))
               if g.dtype != w.dtype or not torch.equal(g, w.to(g.device))]
        check(not bad, f"resume: {what} differs at {bad}")
    same({"params": got.params, "opt_state": got.opt_state}, host,
         "the restored state")
    del host
    nxt = fresh.run_step(step_fn, got, batch)
    check(not kinds(fresh.events, "step_failure"), "resume: step failure")
    same({"params": nxt.params, "opt_state": nxt.opt_state}, after,
         f"step {steps + 1} from the restored state")
    del after
    print(f"[lm/train] resume: step {steps} restored by a fresh runner in "
          f"{restore_s:.1f}s, bit-equal to the run's state with dtypes kept; "
          f"its step {steps + 1} bit-equal to the uninterrupted run's")

    # one more step under the profiler
    kern = device_kernels(lambda: fresh.run_step(step_fn, nxt, batch))
    busy = sum(kern.values())
    top = list(kern.items())[:8]
    print(f"[lm/train] one step under the profiler: device busy {busy:.2f} "
          f"ms = {busy / step_ms:.3f} of the median step; top kernels: "
          + "; ".join(f"{k[:60]} {v:.2f} ms" for k, v in top))
    del nxt, got
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return launches


def lm_kernel_times(torch, ops, ref, dev, gen, cfg, peaks):
    """B10 at each projection shape of the LM path (prefill M = batch ·
    prompt, decode M = batch, the unembedding at M = batch) and B11 at
    the prefill shape, in the models' layout: kernel, plain version and
    one library call, with each call's bound.  Each kernel and library
    call is timed twice: by CUDA events around a loop of calls
    (``cuda_ms``, the host's issue time included where it is the slower
    side) and by the replay of the calls captured as a CUDA graph
    (``device_ms``, device time alone).  Returns the kernel rows and the
    per-shape B10 times."""
    from repro_torch.kernels import gemm
    from repro_torch.launch.lm_kernel_times import device_ms
    d, ff, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    Bt, P = LM["batch"], LM["prompt"]
    bf = torch.bfloat16
    shapes = {"prefill qkvo": (Bt * P, d, d),
              "prefill in/gate": (Bt * P, ff, d),
              "prefill out": (Bt * P, d, ff), "decode qkvo": (Bt, d, d),
              "decode in/gate": (Bt, ff, d), "decode out": (Bt, d, ff),
              "unembed": (Bt, V, d)}
    b10 = {}
    for key, (M, N, K) in shapes.items():
        a = torch.randn((M, K), generator=gen, device=dev).to(bf)
        w = torch.randn((K, N), generator=gen, device=dev).to(bf)
        b, by = bound_ms(2 * M * N * K, 2 * (M * K + K * N + M * N), peaks,
                         bf16=True)
        b10[key] = dict(M=M, N=N, K=K, route=gemm.route(a, w),
                        ms=cuda_ms(torch, lambda: ops.matmul(a, w), 20),
                        dev_ms=device_ms(lambda: ops.matmul(a, w), 20),
                        plain_ms=cuda_ms(torch, lambda: ref.matmul(a, w), 5),
                        library_ms=cuda_ms(torch, lambda: torch.matmul(a, w),
                                           20),
                        lib_dev_ms=device_ms(lambda: torch.matmul(a, w),
                                             20),
                        bound_ms=b, bound_by=by,
                        err=gemm_case(torch, ops, ref, dev, gen, M, N, K,
                                      bf)[0])
        r = b10[key]
        print(f"[time] B10 {key} M={M} N={N} K={K} ({r['route']}): kernel "
              f"{r['ms']:.4f} ms, device {r['dev_ms']:.4f} ms "
              f"({2 * M * N * K / r['dev_ms'] / 1e9:.1f} TFLOP/s, "
              f"{2 * (M * K + K * N + M * N) / r['dev_ms'] / 1e9:.3f} TB/s), "
              f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} "
              f"ms, device {r['lib_dev_ms']:.4f} ms, bound {b:.4f} ms ({by})")
    del a, w
    main = b10["prefill in/gate"]
    kernels = {"B10": dict(
        name="matmul", route="cuda",
        source="src/repro_torch/kernels/csrc/gemm.cu",
        replaces="src/repro/kernels/gemm.py:19", max_abs_err=main["err"],
        ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=main["library_ms"],
        launches=0)}

    H, hd = cfg.n_heads, cfg.head_dim
    q, k, v = attn_inputs(torch, dev, gen, Bt, H, P, hd, bf)
    err, _ = attn_case(torch, ops, ref, q, k, v, True, "B11 main")
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    pairs = Bt * H * P * (P + 1) // 2          # unmasked (query, key) pairs
    b, by = bound_ms(4 * pairs * hd, 4 * 2 * Bt * H * P * hd, peaks,
                     bf16=True)
    kernels["B11"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:24", max_abs_err=err,
        ms=cuda_ms(torch, lambda: ops.flash_attention(q, k, v), 50),
        plain_ms=cuda_ms(torch, lambda: ref.attention(q, k, v, True), 5),
        bound_ms=b, bound_by=by,
        library_ms=cuda_ms(torch, lambda: torch.nn.functional
                           .scaled_dot_product_attention(qc, kc, vc,
                                                         is_causal=True), 50),
        launches=0)
    contiguous_ms = cuda_ms(torch, lambda: ops.flash_attention(qc, kc, vc), 50)
    b11 = dict(dev_ms=device_ms(lambda: ops.flash_attention(q, k, v),
                                50),
               lib_dev_ms=device_ms(lambda: torch.nn.functional
                                    .scaled_dot_product_attention(
                                        qc, kc, vc, is_causal=True), 50))
    kernels["B11"]["dev_ms"] = b11["dev_ms"]
    for key in ("B10", "B11"):
        kr = kernels[key]
        print(f"[time] {key} {kr['name']}: kernel {kr['ms']:.4f} ms, plain "
              f"{kr['plain_ms']:.4f} ms, library {kr['library_ms']:.4f} ms, "
              f"bound {kr['bound_ms']:.4f} ms ({kr['bound_by']})")
    print(f"[kernel] B11 flash_attention B={Bt} H={H} S={P} d={hd} causal, "
          f"the models' layout: max_abs_err={err:.4g}; device "
          f"{b11['dev_ms']:.4f} ms (SDPA {b11['lib_dev_ms']:.4f} ms); on "
          f"contiguous (B, H, S, d) tensors {contiguous_ms:.4f} ms")
    # one line with every path shape's numbers, for the records
    print("[lm-times] " + json.dumps(dict(
        b10={k: {f: r[f] for f in ("M", "N", "K", "route", "ms", "dev_ms",
                                    "plain_ms", "library_ms", "lib_dev_ms",
                                    "bound_ms", "bound_by")}
             for k, r in b10.items()},
        b11=dict(ms=kernels["B11"]["ms"], dev_ms=b11["dev_ms"],
                 plain_ms=kernels["B11"]["plain_ms"],
                 library_ms=kernels["B11"]["library_ms"],
                 lib_dev_ms=b11["lib_dev_ms"],
                 bound_ms=kernels["B11"]["bound_ms"]))))
    return kernels, b10


def lm_layer_check(torch, got, plain, exact):
    """The per-layer check (ROADMAP C3) on three lists of residual
    streams, one per layer: two bf16 routes (``got``, ``plain``) and an
    fp32 route (``exact``) on the same weights.  Returns one row per
    layer, (layer, ‖got − plain‖, ‖plain − exact‖, ok), ok when the first
    is at most ``LAYER_FACTOR`` times the second."""
    rows = []
    for i, (g, p, e) in enumerate(zip(got, plain, exact)):
        dist = float((g.float() - p.float()).norm())
        noise = float((p.float() - e.float()).norm())
        rows.append((i, dist, noise, dist <= LAYER_FACTOR * noise))
    return rows


def lm_layers(torch, cfg, params, tokens, frontend=None):
    """One teacher-forced prefill of ``tokens`` (and the stub frontends'
    ``frontend`` inputs), layer by layer (an enc-dec arch's encoder layers
    first), through the kernel route, the plain route and the plain route
    in fp32 on the same weights, upcast one layer at a time (never the
    whole tree: 122 GB at qwen3-moe-30b-a3b's width);
    ``lm_layer_check`` on the three."""
    from repro_torch.models import transformer
    frontend = frontend or {}
    got = transformer.layer_states(params, tokens, cfg, **frontend)
    plain = transformer.layer_states(params, tokens, cfg, path="ref",
                                     **frontend)
    exact = transformer.layer_states(params, tokens, cfg, path="ref",
                                     dtype=torch.float32, **frontend)
    return lm_layer_check(torch, got, plain, exact), exact[-1].float().norm()


def tree_extra(cfg) -> int:
    """The parameters in the tree beyond the reference's ``param_count``,
    which counts d_model twice for the norms of a decoder layer (once
    more an encoder layer, once a cross-attention block) and nothing for
    a final norm: so the final norms (an encoder's too), every LayerNorm's
    bias, a qk-norm arch's q and k norms, an SSD mixer's gated norm
    (d_inner), less d_model for each layer without an FFN (one norm, not
    two)."""
    from repro_torch.models import transformer
    mixers, ffns, _, n_units = transformer.layer_plan(cfg)
    per_norm = 2 * cfg.d_model if cfg.norm == "layernorm" else cfg.d_model
    # each layer's norm_mixer and, with an FFN, norm_ffn; the final one
    norms = n_units * sum(1 + (ff != "none") for ff in ffns) + 1
    counted = 2 * cfg.d_model * cfg.n_layers
    if cfg.encoder is not None:
        norms += 2 * cfg.encoder.n_layers + 1 + cfg.n_layers
        counted += 2 * cfg.d_model * cfg.encoder.n_layers + \
            cfg.d_model * cfg.n_layers
    qk = 2 * cfg.head_dim * n_units * mixers.count("attn") \
        if cfg.attn.qk_norm else 0
    gated = cfg.d_inner * n_units * mixers.count("ssm") if "ssm" in mixers \
        else 0
    return per_norm * norms - counted + qk + gated


def lm_launch_plan(torch, cfg, batch: int, prompt: int, new: int) -> dict:
    """Every B10, B11 and B5 launch of ``generate`` (one prefill of batch
    x prompt, after a VLM's patches, then ``new`` decode steps), derived
    from the layer plan (``transformer.layer_plan``): each launch's shape,
    and the route the shape rules give it in the config's dtype.  A
    forward pass launches B10 four times an attention sublayer (q, k, v,
    o), six an SSD mixer (z, x, B, C, dt, out), two or three a dense MLP
    (in, gate where it is gated, out) and once for the unembedding; B11
    once an attention sublayer, in the prefill only; B5 once an MoE
    sublayer (its router; the expert GEMMs are torch's).  Returns the
    launch counts and the routes, as ``ops.LAUNCHES`` and the
    ``ROUTE_LAUNCHES`` count them (B5's only for a model with MoE
    layers)."""
    from repro_torch.models import transformer
    from repro_torch.models.layers import mlp_is_gated, torch_dtype
    mixers, ffns, _, n_units = transformer.layer_plan(cfg)
    d, q, kv, ff = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
    mlp = [(ff, d)] * (2 if mlp_is_gated(cfg.mlp_type) else 1) + [(d, ff)]
    attn = [(q, d), (kv, d), (kv, d), (d, q)]
    mixer_proj = {"attn": attn}
    if "ssm" in mixers:
        GN, d_in = cfg.ssm.n_groups * cfg.ssm.d_state, cfg.d_inner
        mixer_proj["ssm"] = [(d_in, d), (d_in, d), (GN, d), (GN, d),
                             (cfg.ssm_heads, d), (d, d_in)]
    S = lm_seq(cfg, prompt)
    gemm, flash, router = [], [], 0
    if cfg.encoder is not None:
        Me = batch * cfg.encoder.n_ctx
        for _ in range(cfg.encoder.n_layers):
            gemm += [(Me, N, K) for N, K in attn + mlp]
            flash.append(cfg.head_dim)
    for M, prefill in [(batch * S, True)] + [(batch, False)] * new:
        for _ in range(n_units):
            for mx, ffn in zip(mixers, ffns):
                proj = mixer_proj[mx] + (mlp if ffn == "mlp" else [])
                gemm += [(M, N, K) for N, K in proj]
                if prefill and mx == "attn":
                    flash.append(cfg.head_dim)
                router += ffn == "moe"
            if cfg.encoder is not None:
                # cross q and o; its k and v of the memory in the prefill
                gemm += [(M, q, d), (M, d, q)]
                if prefill:
                    gemm += [(batch * cfg.encoder.n_ctx, kv, d)] * 2
        gemm.append((batch, cfg.vocab_size, d))    # the last position's
    dtype = torch_dtype(cfg)
    b10 = {way: 0 for way in ("wgmma", "mma_sync", "small_m", "fp32")}
    for M, N, K in gemm:
        b10[gemm_way(torch, M, N, K, dtype)] += 1
    b11 = {"wgmma": sum(hd % 16 == 0 for hd in flash)
           if dtype == torch.bfloat16 else 0}
    b11["cuda_core"] = len(flash) - b11["wgmma"]
    launches = dict(matmul=len(gemm), flash_attention=len(flash))
    routes = dict(b10=b10, b11=b11)
    if router:
        # k <= FILTER_K_MAX: every router launch on the filter route
        launches["topk_smallest"] = router
        routes["b5"] = {"filter": router, "radix": 0}
    return dict(launches=launches, routes=routes)


def frontend_inputs(torch, dev, gen, cfg, batch: int) -> dict:
    """The stub frontends' inputs, N(0, 0.02²) in the config's dtype as
    the JAX CLI draws them: an enc-dec arch's encoder frames (batch, n_ctx,
    d_model), a VLM's patch embeddings (batch, num_patches, d_model)."""
    from repro_torch.models.layers import torch_dtype

    def draw(n):
        return torch.randn((batch, n, cfg.d_model), generator=gen,
                           device=dev).mul_(0.02).to(torch_dtype(cfg))
    out = {}
    if cfg.encoder is not None:
        out["encoder_frames"] = draw(cfg.encoder.n_ctx)
    if cfg.vision is not None:
        out["patch_embeds"] = draw(cfg.vision.num_patches)
    return out


def busy_ms(torch, window):
    """Device busy time of ``window()`` in ms: the profiler's kernel time
    over it (None where the window records no kernel)."""
    from repro_torch.launch.lm_kernel_times import device_kernels
    return sum(device_kernels(window).values()) or None


def busy_share(busy, wall) -> str:
    """A device busy time and its share of the host-clock time."""
    return "not measured" if busy is None else \
        f"{busy:.2f} ms = {busy / wall:.3f}"


def fp32_route(torch, cfg, params, serve_cfg):
    """The fp32 route of an LM: the plain route (``path="ref"``) over fp32
    copies of the weights, its caches in fp32."""
    from repro_torch.serving import ServeEngine
    from repro_torch.tree import map as tree_map
    return ServeEngine(dataclasses.replace(cfg, dtype="float32"),
                       tree_map(lambda t: t.float(), params), serve_cfg,
                       path="ref")


def fp32_distances(torch, cfg, params, serve_cfg, prompts, frontend,
                   tokens, step, got, plain):
    """Where the fixed logits gate fails at ``step``: the same step on the
    fp32 route (``fp32_route``, teacher-forced on ``tokens``), and how far
    the kernel route's logits ``got`` and the plain route's ``plain``
    stand from it, each the largest |logit − fp32 logit| over the gate's
    tolerance at the fp32 logits.  A diagnosis printed with the failure,
    not a gate: it tells two bf16 routes that each stand near the fp32
    route from one that does not.  None off the card, or where the copy
    would not fit its free memory."""
    from repro_torch.tree import leaves
    dev = got.device
    need = 2 * sum(t.numel() * t.element_size() for t in leaves(params))
    if dev.type != "cuda" or torch.cuda.mem_get_info(dev)[0] < need + 4e9:
        return None
    engine = fp32_route(torch, cfg, params, serve_cfg)
    logits, cache = engine.prefill(prompts, **frontend)
    for i in range(step):
        logits, cache = engine.decode(cache, tokens[:, i:i + 1])
    return fp32_gaps(torch, logits, got, plain)


def fp32_gaps(torch, exact, got, plain):
    """The largest |logit − fp32 logit| over the tolerance at the fp32
    logits ``exact``, of the kernel route's logits ``got`` and of the
    plain route's ``plain``, and that tolerance."""
    exact = exact.float()
    tol = LM_ATOL + LM_RTOL * exact.abs()
    return tuple(float(((t - exact).abs() / tol).max())
                 for t in (got, plain)) + (tol,)


def lm_path(torch, ops, dev, cfg, spec=None, tag: str = "lm"):
    """Serve ``spec`` (``LM`` by default, or an ``LM_ARCHS`` entry: batch,
    prompt, new tokens) of ``cfg`` through ``ServeEngine.generate``, with
    seeded weights and, for an enc-dec or VLM arch, seeded stub frontend
    inputs (``frontend_inputs``), the launch counts set to 0 just before
    and read just after: each count and route what ``lm_launch_plan``
    derives from the layer plan (B10 on the wgmma route in the prefill
    and the small-M route at M = batch, B11 on the wgmma route; B5 for an
    MoE arch's routers).  Time the prefill and the decode steps; hold the
    kernel route's logits, step by step, to the plain route's
    (``path="ref"``) on the same tokens (an MoE arch's plain route
    taking the kernel route's expert choices, each at a near-tie where
    the two differ: ``tied_routes``), or for a ``gate="fp32"`` spec to
    LAYER_FACTOR times the plain route's distance from the fp32 route
    (``fp32_route``, run beside them); and hold one prefill's residual
    stream to the plain route's after every layer, an encoder's too
    (``lm_layers``; an MoE arch's made for routing, ``moe_layers``).  For
    stablelm (the first LM phase) every host-clock time is taken before
    the first profiler window of the process: a process that has run
    ``torch.profiler`` issues later launches more slowly.  The device busy
    time of a prefill and of a decode step is the profiler's kernel time
    (None, printed "not measured", where a window records no kernel).
    Messages carry ``tag``.  Returns the numbers of the report line."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gemm, topk_select
    from repro_torch.models import transformer
    from repro_torch.serving import ServeEngine
    from repro_torch.tree import leaves as tree_leaves
    spec = spec or LM
    Bt, P, new = spec["batch"], spec["prompt"], spec["new"]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    def leaves(tree):
        for v in tree.values():
            yield from (leaves(v) if isinstance(v, dict) else [v])
    n_params = sum(t.numel() for t in leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    extra = tree_extra(cfg)
    check(n_params == cfg.param_count() + extra,
          f"{tag}: {n_params} parameters in the tree, {cfg.param_count()} "
          f"counted, {extra} norm parameters left out of the count")
    prompts = torch.randint(0, cfg.vocab_size, (Bt, P), generator=gen,
                            device=dev)
    frontend = frontend_inputs(torch, dev, gen, cfg, Bt)
    S = lm_seq(cfg, P)
    serve_cfg = ServeConfig(max_seq=S + new)
    engine = ServeEngine(cfg, params, serve_cfg)
    # the decode cache's bytes: k and v, an enc-dec arch's memory (k, v),
    # an SSD mixer's conv windows and fp32 state
    cache_bytes = sum(
        t.numel() * t.element_size() for t in tree_leaves(
            transformer.init_cache(cfg, Bt, S + new, device="meta"))
        if isinstance(t, torch.Tensor))
    print(f"[{tag}] {cfg.arch_id}: {cfg.param_count()} parameters as the "
          f"reference counts them ({n_params} in the tree, with the "
          f"{extra} of the norms it leaves out), {n_bytes} bytes of "
          f"{cfg.dtype}, seeded on the card in {init_s:.2f}s; decode cache "
          f"{cache_bytes} bytes for batch {Bt} x {S + new} positions"
          + (f" and the memory's {cfg.encoder.n_ctx}"
             if cfg.encoder is not None else "")
          + "".join(f"; {k} {tuple(v.shape)} seeded"
                    for k, v in frontend.items()))
    # first calls outside the count
    engine.generate(prompts[:, :16], 2, **frontend)
    torch.cuda.synchronize()

    ops.reset_launches()
    t0 = time.perf_counter()
    res = engine.generate(prompts, new, **frontend)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    routes = dict(b10=dict(gemm.ROUTE_LAUNCHES), b11=dict(fa.ROUTE_LAUNCHES))
    plan = lm_launch_plan(torch, cfg, Bt, P, new)
    if "b5" in plan["routes"]:
        routes["b5"] = dict(topk_select.ROUTE_LAUNCHES)
    want = {name: 0 for name in launches}
    want.update(plan["launches"])
    check(launches == want, f"{tag}: launches {launches}, the shapes imply "
          f"{want}")
    # the prefill's projections at M = batch x prompt (and an encoder's at
    # batch x n_ctx) on wgmma; its unembedding (the last position) and
    # every decode launch at M = batch on the small-M kernel; the
    # prefill's attention on wgmma
    check(routes == plan["routes"], f"{tag}: routes {routes}, the design "
          f"implies {plan['routes']}")
    check(res.tokens.shape == (Bt, new) and
          bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()) and
          bool(torch.isfinite(res.logprobs).all()) and
          bool((res.logprobs <= 0).all()),
          f"{tag}: tokens {tuple(res.tokens.shape)} or log-probabilities "
          "out of range")

    # timed: the prefill alone, then decode steps on its cache
    prefill_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = engine.prefill(prompts, **frontend)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    steps, traced = min(8, new // 2), min(2, new - min(8, new // 2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        logits, cache = engine.decode(cache, res.tokens[:, i:i + 1])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    # a tied arch's unembedding copies the (vocab, d_model) table to a
    # contiguous (d_model, vocab) B10 weight each forward pass: its time
    # by CUDA events, beside a plain copy of the same bytes in their own
    # order (``clone``) and its bytes (one read, one write) over the
    # card's memory rate
    tied_copy = None
    if cfg.tie_embeddings and dev.type == "cuda":
        tok = params["embed"]["tok"]
        rate = card_peaks(torch.cuda.get_device_name(dev))[1][1]
        tied_copy = (cuda_ms(torch, lambda: tok.t().contiguous(), 10),
                     2 * tok.numel() * tok.element_size() / rate * 1e3,
                     tok.numel() * tok.element_size(),
                     cuda_ms(torch, tok.clone, 10))
    # device busy time of a prefill and of the next decode steps, from
    # the profiler's kernels
    prefill_dev_ms = busy_ms(torch, lambda: engine.prefill(prompts,
                                                           **frontend))
    state = {"cache": cache}

    def decode_steps():
        for i in range(steps, steps + traced):
            _, state["cache"] = engine.decode(state["cache"],
                                              res.tokens[:, i:i + 1])
    step_busy = busy_ms(torch, decode_steps)
    del logits, cache, state
    pre, step_dev = min(prefill_ms), \
        None if step_busy is None else step_busy / traced
    print(f"[{tag}] {cfg.arch_id}: generate {gen_s:.3f}s "
          f"({Bt * new / gen_s:.1f} tok/s); prefill {pre:.2f} ms (device "
          f"busy {busy_share(prefill_dev_ms, pre)}); decode step "
          f"{step_ms:.2f} ms ({Bt / step_ms * 1e3:.1f} tok/s; device busy "
          f"{busy_share(step_dev, step_ms)})"
          + ("" if tied_copy is None else
             f"; tied unembedding: the (d_model, vocab) copy of the "
             f"{tied_copy[2]}-byte table {tied_copy[0]:.4f} ms a forward "
             f"pass by CUDA events (a clone of the table {tied_copy[3]:.4f}"
             f" ms), bound {tied_copy[1]:.4f} ms (one read and one write at "
             "the card's memory rate)"))

    # the plain route on the same tokens, teacher-forced; for an MoE arch
    # it takes the kernel route's expert choices (``tied_routes``); for a
    # phase of the fp32 gate the fp32 route runs beside the two
    ref_engine = ServeEngine(cfg, params, serve_cfg, path="ref")
    tie = tied_routes(torch) if cfg.moe is not None else None
    f32 = fp32_route(torch, cfg, params, serve_cfg) \
        if spec.get("gate") == "fp32" else None
    lk, ck = engine.prefill(prompts, **frontend)
    lr, cr = ref_engine.prefill(prompts, **frontend)
    if f32 is not None:
        lf, cf = f32.prefill(prompts, **frontend)
    worst, near, differ = 0.0, 0, 0
    # the fp32 gate's largest distances: kernel − fp32 and plain − fp32
    # (each over the tolerance at the fp32 logits), kernel − plain
    far = None if f32 is None else dict(kernel=0.0, plain=0.0, pair=0.0)
    for step in range(new + 1):
        lkf, lrf = lk.float(), lr.float()
        diff = (lkf - lrf).abs()
        tol = LM_ATOL + LM_RTOL * lrf.abs()
        pair = float((diff / tol).max())
        if f32 is None:
            # the kernel route within the tolerance of the plain route
            ok = bool((diff <= tol).all())
            exact = None if ok else fp32_distances(
                torch, cfg, params, serve_cfg, prompts, frontend,
                res.tokens, step, lkf, lrf)
            check(ok, f"{tag} step {step}: logits differ from the plain "
                  f"route's by up to {float(diff.max())} ({pair:.3f} of "
                  f"the tolerance, {int((diff > tol).sum())} of "
                  f"{diff.numel()} logits past it)"
                  + ("" if exact is None else
                     f"; from an fp32 route on the same weights the kernel "
                     f"route stands at most {exact[0]:.3f} of the "
                     f"tolerance, the plain route {exact[1]:.3f}"))
            worst = max(worst, pair)
            allow = tol
        else:
            # the kernel route within LAYER_FACTOR of the plain route's
            # distance from the fp32 route; two routes within the gate
            # stand at most (1 + LAYER_FACTOR) x the plain one's apart
            dk, dp, tol = fp32_gaps(torch, lf, lkf, lrf)
            check(dk <= LAYER_FACTOR * dp, f"{tag} step {step}: the kernel "
                  f"route's logits stand {dk:.3f} of the tolerance from an "
                  f"fp32 route's, past {LAYER_FACTOR} x the plain route's "
                  f"{dp:.3f} (kernel − plain {pair:.3f})")
            worst = max(worst, dk / dp)
            far = dict(kernel=max(far["kernel"], dk),
                       plain=max(far["plain"], dp),
                       pair=max(far["pair"], pair))
            allow = (1 + LAYER_FACTOR) * dp * tol
        tk, tr = lkf.argmax(-1), lrf.argmax(-1)
        if step < new:
            check(torch.equal(tk, res.tokens[:, step]),
                  f"{tag} step {step}: generate's tokens are not its "
                  "logits' argmax")
        # a token may differ from the plain route's argmax only where the
        # plain route ranks the two within twice what the gate allows
        gap = lrf.gather(1, tr[:, None]) - lrf.gather(1, tk[:, None])
        room = 2 * allow.gather(1, tr[:, None])
        check(bool((gap <= room).all()), f"{tag} step {step}: a greedy "
              "token differs from the plain route's argmax without a "
              "near-tie")
        top2 = lrf.topk(2, dim=-1).values
        near += int((top2[:, 0] - top2[:, 1] <= room[:, 0]).sum())
        differ += int((tk != tr).sum())
        if step == new:
            break
        nxt = res.tokens[:, step:step + 1]
        lk, ck = engine.decode(ck, nxt)
        lr, cr = ref_engine.decode(cr, nxt)
        if f32 is not None:
            lf, cf = f32.decode(cf, nxt)
    del lk, ck, lr, cr, engine, ref_engine
    if f32 is not None:
        del lf, cf, f32
    router_tie = None
    if tie is not None:
        router_tie = tie.close()
        check(router_tie["far"] == 0, f"{tag}: {router_tie['far']} of "
              f"{router_tie['flips']} expert choices the plain route took "
              "over from the kernel route are away from a near-tie")

    # ROADMAP C3: one teacher-forced prefill, layer by layer (an MoE
    # arch's made for routing, ``moe_layers``)
    moe_rows = None
    if cfg.moe is None:
        rows, scale = lm_layers(torch, cfg, params, prompts, frontend)
    else:
        moe_rows = moe_layers(torch, cfg, params, prompts)
        bad = [r for r in moe_rows if not r["ok"]]
        check(not bad, f"{tag} layers: " + "; ".join(
            f"layer {r['layer']}: {r['far']} of {r['flips']} flips away "
            f"from a near-tie, ‖kernel − plain‖ {r['dist']:.4g} against "
            f"{LAYER_FACTOR} x ‖plain − fp32‖ {r['noise']:.4g} over "
            f"{r['same']} tokens (at least {MOE_SAME} x {Bt * S})"
            for r in bad))
        rows = [(r["layer"], r["dist"], r["noise"], r["ok"])
                for r in moe_rows]
        scale = moe_rows[-1]["scale"]
    bad = [r for r in rows if not r[3]]
    check(not bad, f"{tag} layers: " + "; ".join(
        f"layer {i}: ‖kernel − plain‖ {dist:.4g} > {LAYER_FACTOR} x "
        f"‖plain − fp32‖ {noise:.4g}" for i, dist, noise, _ in bad))
    ratios = [dist / noise for _, dist, noise, _ in rows]
    worst_layer = max(range(len(rows)), key=lambda i: ratios[i])
    layers = dict(
        n=len(rows), worst=ratios[worst_layer], worst_layer=worst_layer,
        first=(rows[0][1], rows[0][2]), last=(rows[-1][1], rows[-1][2]),
        scale=float(scale),
        flips=None if moe_rows is None else [r["flips"] for r in moe_rows],
        same=None if moe_rows is None else min(r["same"] for r in moe_rows))
    del params, frontend
    return dict(gen_s=gen_s, prefill_ms=pre, step_ms=step_ms,
                prefill_dev_ms=prefill_dev_ms, step_dev_ms=step_dev,
                decisions=Bt * (new + 1), near=near, differ=differ,
                worst=worst, far=far, first=res.tokens[0, :8].tolist(),
                launches=launches, routes=routes, layers=layers,
                router_tie=router_tie)


def layer_weights(cfg, n: int) -> int:
    """Bytes of the tree of ``cfg`` at ``n`` layers (every leaf in the
    config's 2-byte dtype)."""
    c = dataclasses.replace(cfg, n_layers=n)
    return 2 * (c.param_count() + tree_extra(c))


def cut_peak(cfg, spec, n: int) -> int:
    """The phase's peak bytes at ``n`` layers of ``cfg``, estimated: the
    weights, plus the larger of the plain route's largest transient (the
    fp32 copy of the widest weight, the unembedding or an MLP matrix, and
    fp32 activations at the prefill's rows) and the per-layer check's
    (three routes' residual streams after every layer, bf16, bf16 and
    fp32, the fp32 copy of one layer and its activations), plus 2 GB for
    the caches, the logits and the allocator."""
    B, S, d = spec["batch"], lm_seq(cfg, spec["prompt"]), cfg.d_model
    act = 3 * 4 * B * S * max(cfg.d_ff, cfg.q_dim)
    widest = 4 * d * max(cfg.vocab_size, cfg.d_ff, cfg.q_dim)
    layer = layer_weights(cfg, 2) - layer_weights(cfg, 1)
    states = n * B * S * d * (2 + 2 + 4)
    return layer_weights(cfg, n) + max(widest, states + 2 * layer) + act + \
        2 * 10 ** 9


def layer_cut(cfg, spec) -> int:
    """The most layers of ``cfg`` whose phase peak (``cut_peak``) stays
    within ``CUT_PEAK_BYTES``."""
    n = 1
    while n < cfg.n_layers and cut_peak(cfg, spec, n + 1) <= CUT_PEAK_BYTES:
        n += 1
    return n


def phase_config(spec):
    """The config an ``LM_ARCHS`` phase serves: the registered arch, or
    for a ``reduced`` entry its ``reduced`` config in bf16 (the per-layer
    check holds a bf16 route against an fp32 one), named
    "<arch>-reduced"."""
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    cfg = get_config(spec["arch"])
    if spec.get("reduced"):
        cfg = dataclasses.replace(reduced(cfg), dtype="bfloat16",
                                  arch_id=f"{cfg.arch_id}-reduced")
    return cfg


def lm_arch_path(torch, ops, dev, spec) -> dict:
    """One ``LM_ARCHS`` phase, ``[lm/<tag>]``: the arch at its published
    widths (the layer-cut ones at ``layer_cut``'s depth, named
    "<arch>-L<n>"; a ``reduced`` one at ``phase_config``'s widths)
    through ``lm_path``, with the phase's peak memory.  Returns the
    launch counts."""
    cfg = phase_config(spec)
    tag = f"lm/{spec['tag']}"
    depth = ""
    if spec["cut"]:
        n = layer_cut(cfg, spec)
        depth = (f" ({n} of {cfg.n_layers} layers, the most whose phase "
                 f"peak stays within {CUT_PEAK_BYTES / 1e9:g} GB by "
                 f"cut_peak's estimate, {cut_peak(cfg, spec, n) / 1e9:.1f} "
                 "GB; every width as published)")
        cfg = dataclasses.replace(cfg, n_layers=n,
                                  arch_id=f"{cfg.arch_id}-L{n}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    run = lm_path(torch, ops, dev, cfg, spec, tag)
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()

    Bt, new, lay = spec["batch"], spec["new"], run["layers"]
    print(f"[{tag}] {cfg.arch_id}{depth} batch={Bt} prompt={spec['prompt']}"
          f" new={new}, bf16 weights seeded from a torch.Generator on the "
          f"card (times above): peak {peak / 1e9:.2f} GB allocated; phase "
          f"{time.perf_counter() - t_phase:.1f}s")
    tie = run["router_tie"]
    print(f"[{tag}] launches B10={run['launches']['matmul']} "
          f"B11={run['launches']['flash_attention']}"
          + (f" B5={run['launches']['topk_smallest']}, routes B5 "
             f"{run['routes']['b5']}" if "b5" in run["routes"] else "")
          + f", routes B10 {run['routes']['b10']}, B11 "
          f"{run['routes']['b11']} (the layer plan implies them); against "
          f"the plain route, teacher-forced"
          + (f" (its router taking the kernel route's experts: "
             f"{tie['flips']} of {tie['decisions']} decisions differed, "
             f"all at near-ties)" if tie is not None else "") + ": "
          + (f"logits within {run['worst']:.3f} of the tolerance, "
             if run["far"] is None else
             f"logits from an fp32 route at most {run['worst']:.3f} x the "
             f"plain route's distance at a step (the gate {LAYER_FACTOR} "
             f"x; kernel route up to {run['far']['kernel']:.3f} of the "
             f"tolerance, plain {run['far']['plain']:.3f}; kernel − plain "
             f"{run['far']['pair']:.3f}, not gated), ")
          + f"{run['differ']} of {run['decisions']} greedy tokens differ from "
          f"its argmax, all at near-ties ({run['near']} near-ties); per "
          f"layer ‖kernel − plain‖ within {LAYER_FACTOR} x ‖plain − fp32‖ "
          f"at all {lay['n']} layers"
          + (f" ({cfg.encoder.n_layers} encoder layers first)"
             if cfg.encoder is not None else "")
          + (f" (the MoE sublayers' over the tokens all three routes route "
             f"alike, fewest {lay['same']}; router flips a layer "
             f"{lay['flips']}, each at a near-tie)"
             if lay["flips"] is not None else "")
          + f", at most {lay['worst']:.3f} x (layer {lay['worst_layer']}); "
          f"first row {run['first']}")
    return run["launches"]


def expert_mask(torch, ids, n_experts: int, values=None):
    """(T, k) expert ids -> (T, n_experts) bool, True at each token's ids
    (only where ``values``, a (T, k) bool, is True, when given)."""
    src = torch.ones_like(ids, dtype=torch.bool) if values is None else values
    return torch.zeros((ids.shape[0], n_experts), dtype=torch.bool,
                       device=ids.device).scatter_(1, ids.long(), src)


def moe_flip_check(torch, ids_k, ids_p, logits_k, logits_p):
    """The near-tie rule of the MoE per-layer check, on one layer's router
    over T tokens: the kernel route's and the plain route's top-k expert
    ids (T, k) and router logits (T, E), fp32.  Returns (flip, ok), two
    (T,) bool tensors: ``flip`` where the two top-k sets differ, ``ok``
    where there is no flip or the flip is at a near-tie.  A flip is at a
    near-tie when, for every expert the plain route took and the kernel
    route dropped and every expert the kernel route took in its place,
    the plain route's logit gap between the two is at most twice the
    largest |logit_k − logit_p| of that token: routes whose logits stand
    within δ of each other can swap two experts only where the two stand
    within 2δ."""
    E = logits_p.shape[1]
    in_k = expert_mask(torch, ids_k, E)
    in_p = expert_mask(torch, ids_p, E)
    flip = (in_k != in_p).any(1)
    dropped = logits_p.masked_fill(~(in_p & ~in_k), -math.inf).amax(1)
    taken = logits_p.masked_fill(~(in_k & ~in_p), math.inf).amin(1)
    delta = (logits_k - logits_p).abs().amax(1)
    return flip, ~flip | (dropped - taken <= 2 * delta)


class tied_routes:
    """The teacher-forced comparison of an MoE model's kernel route with
    its plain route (``lm_path``), made for routing: while it is open,
    each router call of the kernel route (``moe.route``) records its
    expert ids and router logits, and each call of the plain route, made
    in the same order, takes those ids (its weights gathered from its own
    probabilities) after ``moe_flip_check`` has held them against its own
    choice: where the two differ, it must be at a near-tie.  So a near-tie
    that the two routes break apart moves neither route's later tokens
    (a flip in a prefill also moves the capacity ranks of every later
    token), and the logits gate holds the kernels' arithmetic.  ``close``
    restores ``moe.route`` and returns the counts: router decisions,
    flips taken over, flips away from a near-tie."""

    def __init__(self, torch):
        from repro_torch.models import moe
        from repro_torch.models.layers import plain_route
        self.moe, self.real = moe, moe.route
        self.queue, self.counts = [], dict(decisions=0, flips=0, far=0)

        def route(params, x, cfg, path=None):
            if not plain_route(path):
                w, ids, aux = self.real(params, x, cfg, path)
                self.queue.append((ids, moe.router_logits(params, x)))
                return w, ids, aux
            ids_k, logits_k = self.queue.pop(0)
            _, ids_p, aux = self.real(params, x, cfg, path)
            logits_p = moe.router_logits(params, x)
            flip, ok = moe_flip_check(torch, ids_k, ids_p, logits_k,
                                      logits_p)
            self.counts["decisions"] += ids_k.shape[0]
            self.counts["flips"] += int(flip.sum())
            self.counts["far"] += int((~ok).sum())
            w = torch.softmax(logits_p, dim=-1).gather(-1, ids_k.long())
            return w / w.sum(-1, keepdim=True), ids_k, aux
        moe.route = route

    def close(self) -> dict:
        self.moe.route = self.real
        check(not self.queue, f"{len(self.queue)} router calls of the "
              "kernel route had no plain-route counterpart")
        return dict(self.counts)


def moe_layers(torch, cfg, params, tokens):
    """The per-layer check of an MoE model (ROADMAP C3, made for routing):
    one teacher-forced prefill of ``tokens`` (B, S), layer by layer, each
    layer fed the kernel route's residual stream and run on the kernel
    route, the plain route and the plain route in fp32 (that layer's
    weights upcast, one layer's copy at a time).  In an MoE layer a token
    whose top-k set differs between the kernel and the plain route must
    be at a near-tie (``moe_flip_check``).  Over the tokens that all
    three routes send to the same experts and keep in the same ones (a
    flip also moves the capacity ranks of later tokens), ‖kernel −
    plain‖ ≤ LAYER_FACTOR · ‖plain − fp32‖ (Frobenius norm of the layer's
    output rows); those tokens are at least ``MOE_SAME`` of the layer's,
    since the near-tie bound widens with the error it is given (an error
    that moves every token's router would flip them all, each within its
    own bound, and leave no token for the norm).  A layer without an MoE
    (a hybrid's other sublayers, attention or SSD, with a dense MLP or
    none) is held over all its tokens.  Returns one dict a layer: flips,
    flips far from a tie, tokens compared, the two norms, the fp32
    output's norm and whether the layer passed."""
    from repro_torch.models import layers as L
    from repro_torch.models import moe, transformer
    E = cfg.moe.num_experts
    x = L.apply_embed(params["embed"], tokens, cfg)
    B, S, d = x.shape
    T = B * S
    C = moe.capacity(T, cfg)
    positions = torch.arange(S, device=x.device).expand(B, S)
    rows = []
    for i in range(cfg.n_layers):
        outs, ids, logits, chosen, kept = [], [], [], [], []
        for dtype, path in ((None, None), (None, "ref"),
                            (torch.float32, "ref")):
            p = transformer.layer_params(params, i, dtype)
            xa, _ = transformer.mixer(p, x if dtype is None else x.to(dtype),
                                      cfg, positions, path)
            if "moe" in p:
                h = L.apply_norm(p["norm_ffn"], xa, cfg).reshape(T, d)
                w, e, _ = moe.route(p["moe"], h, cfg, path)
                slot, _, _ = moe.slot_map(w, e, C, E)
                ids.append(e)
                logits.append(moe.router_logits(p["moe"], h))
                chosen.append(expert_mask(torch, e, E))
                kept.append(expert_mask(torch, e, E, slot < E * C))
                del h
            outs.append(transformer.ffn(p, xa, cfg, path)[0])
            del p, xa
        if ids:
            flip, near = moe_flip_check(torch, ids[0], ids[1], logits[0],
                                        logits[1])
            same = ((chosen[0] == chosen[1]) & (chosen[1] == chosen[2]) &
                    (kept[0] == kept[1]) & (kept[1] == kept[2])).all(1)
        else:
            flip = torch.zeros((T,), dtype=torch.bool, device=x.device)
            near = same = ~flip
        got, plain, exact = (o.reshape(T, d)[same].float() for o in outs)
        dist = float((got - plain).norm())
        noise = float((plain - exact).norm())
        rows.append(dict(layer=i, flips=int(flip.sum()),
                         far=int((~near).sum()), same=int(same.sum()),
                         dist=dist, noise=noise, scale=float(exact.norm()),
                         ok=bool(near.all()) and
                         int(same.sum()) >= MOE_SAME * T and
                         dist <= LAYER_FACTOR * noise))
        x = outs[0]
    return rows


def bits(torch, t):
    """The raw bits of a float tensor, for bitwise comparison."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def moe_path(torch, ops, ref, dev, cfg, peaks, hand_on=None):
    """Serve ``MOE`` through ``ServeEngine.generate`` (qwen3-moe-30b-a3b at
    full width and depth: bf16 weights seeded on the card, one expert
    slab at a time) with the launch counts set to 0 just before and read
    just after, each count and route what the shapes imply; time the
    prefill and the decode steps on the host clock, then their device busy
    time; hold B5's router selection and one MoE layer, kernel route
    against plain route, bit for bit on a layer's real prefill hidden
    states (T = batch · prompt, the capacity branch) and on the decode
    shape (T = batch, dropless); time B5 at those two router shapes; run
    the per-layer check (``moe_layers``); and generate greedily on both
    routes, free-running, printing where their tokens part (not gated: a
    flip at one near-tie moves a token's layer output by a whole
    expert's share).  The host-clock times come after the stablelm
    phase's profiler windows.  Returns the launch counts; with
    ``hand_on`` (a dict) the params, prompts, greedy tokens and times are
    left in it for ``moe_two_phase_path`` rather than freed."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gemm
    from repro_torch.kernels import topk_select as ts
    from repro_torch.launch.lm_kernel_times import device_kernels, device_ms
    from repro_torch.models import layers as L
    from repro_torch.models import moe, transformer
    from repro_torch.serving import ServeEngine
    t_phase = time.perf_counter()
    Bt, P, new = MOE["batch"], MOE["prompt"], MOE["new"]
    nL, E, k = cfg.n_layers, cfg.moe.num_experts, cfg.moe.top_k
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    def leaves(tree):
        for v in tree.values():
            yield from (leaves(v) if isinstance(v, dict) else [v])
    n_params = sum(t.numel() for t in leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    # the reference's count leaves out the final norm and the q/k norms
    check(n_params == cfg.param_count() + cfg.d_model +
          2 * cfg.head_dim * nL,
          f"lm/moe: {n_params} parameters in the tree, "
          f"{cfg.param_count()} counted")
    prompts = torch.randint(0, cfg.vocab_size, (Bt, P), generator=gen,
                            device=dev)
    serve_cfg = ServeConfig(max_seq=P + new)
    engine = ServeEngine(cfg, params, serve_cfg)
    print(f"[lm/moe] {cfg.arch_id}: {cfg.param_count()} parameters as the "
          f"reference counts them ({n_params} in the tree, with the final "
          f"norm and the q/k norms), {n_bytes} bytes (bf16, the router "
          f"fp32), seeded on the card in {init_s:.2f}s; "
          f"{torch.cuda.memory_allocated()} bytes allocated")
    engine.generate(prompts[:, :16], 2)     # first calls outside the count
    torch.cuda.synchronize()

    ops.reset_launches()
    t0 = time.perf_counter()
    res = engine.generate(prompts, new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    routes = dict(b10=dict(gemm.ROUTE_LAUNCHES), b11=dict(fa.ROUTE_LAUNCHES),
                  b5=dict(ts.ROUTE_LAUNCHES))
    want = {name: 0 for name in launches}
    want["matmul"] = (4 * nL + 1) * (1 + new)
    want["flash_attention"] = nL
    want["topk_smallest"] = nL * (1 + new)
    check(launches == want, f"lm/moe: launches {launches}, the shapes "
          f"imply {want}")
    # q, k, v, o of the prefill at M = batch x prompt on wgmma; its
    # unembedding and every decode launch at M = batch on small-M; the
    # router's k = 8 of 128 on B5's filter route
    want_routes = dict(
        b10=dict(wgmma=4 * nL, mma_sync=0, small_m=1 + new * (4 * nL + 1),
                 fp32=0),
        b11=dict(wgmma=nL, cuda_core=0),
        b5=dict(filter=nL * (1 + new), radix=0))
    check(routes == want_routes, f"lm/moe: routes {routes}, the design "
          f"implies {want_routes}")
    check(res.tokens.shape == (Bt, new) and
          bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()) and
          bool(torch.isfinite(res.logprobs).all()) and
          bool((res.logprobs <= 0).all()),
          f"lm/moe: tokens {tuple(res.tokens.shape)} or log-probabilities "
          "out of range")

    # timed: the prefill alone, then decode steps on its cache
    prefill_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = engine.prefill(prompts)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    steps, traced = min(8, new // 2), min(2, new - min(8, new // 2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        logits, cache = engine.decode(cache, res.tokens[:, i:i + 1])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    # device busy time, and the kernels that take the most of it
    prefill_kernels = device_kernels(lambda: engine.prefill(prompts))
    state = {"cache": cache}

    def decode_steps():
        for i in range(steps, steps + traced):
            _, state["cache"] = engine.decode(state["cache"],
                                              res.tokens[:, i:i + 1])
    step_kernels = {name: ms / traced for name, ms in
                    device_kernels(decode_steps).items()}
    prefill_dev = sum(prefill_kernels.values()) or None
    step_dev = sum(step_kernels.values()) or None
    del logits, cache, state

    def share(busy, wall):
        return "not measured" if busy is None else \
            f"{busy:.2f} ms = {busy / wall:.3f}"

    def top(kernels):
        return "; ".join(f"{name[:70]} {ms:.3f} ms"
                         for name, ms in list(kernels.items())[:6])
    pre = min(prefill_ms)
    print(f"[lm/moe] {cfg.arch_id} batch={Bt} prompt={P} new={new}: "
          f"generate {gen_s:.3f}s ({Bt * new / gen_s:.1f} tok/s); prefill "
          f"{pre:.2f} ms (device busy {share(prefill_dev, pre)}); decode "
          f"step {step_ms:.2f} ms ({Bt / step_ms * 1e3:.1f} tok/s; device "
          f"busy {share(step_dev, step_ms)}); launches B10 "
          f"{launches['matmul']}, B11 {launches['flash_attention']}, B5 "
          f"{launches['topk_smallest']} (the shapes imply them); routes "
          f"{routes}")
    print(f"[lm/moe] device time by kernel, prefill: {top(prefill_kernels)}")
    print(f"[lm/moe] device time by kernel, a decode step: "
          f"{top(step_kernels)}")

    # B5 and one MoE layer, kernel route against plain route, on the
    # hidden states of the middle layer's MoE in a real prefill, and on
    # the last position of each row (the decode shape)
    mid = nL // 2
    x = transformer.layer_states(params, prompts, cfg)[mid - 1]
    p = transformer.layer_params(params, mid)
    positions = torch.arange(P, device=dev).expand(Bt, P)
    xa, _ = transformer.mixer(p, x, cfg, positions)
    h = L.apply_norm(p["norm_ffn"], xa, cfg)
    del x, xa
    b5_times = {}
    for T, hh in ((Bt * P, h.reshape(Bt * P, -1)),
                  (Bt, h[:, -1].contiguous())):
        C = moe.capacity(T, cfg)
        neg = -torch.softmax(moe.router_logits(p["moe"], hh), dim=-1)
        kv, ki = ops.topk_smallest(neg, k)
        pv, pi = ref.topk_smallest(neg, k)
        check(torch.equal(ki, pi) and torch.equal(bits(torch, kv),
                                                  bits(torch, pv)),
              f"lm/moe router T={T}: B5 differs from its plain version")
        wk, ik, ak = moe.route(p["moe"], hh, cfg)
        wp, ip, ap = moe.route(p["moe"], hh, cfg, path="ref")
        check(torch.equal(ik, ip) and
              torch.equal(bits(torch, wk), bits(torch, wp)) and
              torch.equal(bits(torch, ak), bits(torch, ap)),
              f"lm/moe route T={T}: ids, weights or aux differ from the "
              "plain route's")
        yk, _ = moe.apply_moe(p["moe"], hh, cfg)
        yp, _ = moe.apply_moe(p["moe"], hh, cfg, path="ref")
        check(torch.equal(bits(torch, yk), bits(torch, yp)),
              f"lm/moe apply_moe T={T}: the kernel route differs from the "
              "plain route")
        slot, _, _ = moe.slot_map(wk, ik, C, E)
        dropped = int((slot == E * C).sum())
        b, by = bound_ms(T * E, 4 * T * E + 8 * T * k, peaks)
        r = dict(C=C, dropped=dropped, bound_ms=b, bound_by=by,
                 ms=cuda_ms(torch, lambda: ops.topk_smallest(neg, k), 50),
                 dev_ms=device_ms(lambda: ops.topk_smallest(neg, k), 50),
                 plain_ms=cuda_ms(torch, lambda: ref.topk_smallest(neg, k),
                                  50),
                 library_ms=cuda_ms(torch, lambda: torch.topk(
                     neg, k, dim=1, largest=False), 50),
                 lib_dev_ms=device_ms(lambda: torch.topk(
                     neg, k, dim=1, largest=False), 50))
        b5_times[T] = r
        print(f"[kernel] B5 router T={T} E={E} k={k} (layer {mid}'s "
              f"prefill states; C={C}, {dropped} of {T * k} assignments "
              f"dropped): ids and weights bit-equal to the plain version's, "
              f"route() and apply_moe() bit-equal to the plain route's")
        print(f"[time] B5 router ({T}, {E}) k={k}: kernel {r['ms']:.4f} ms, "
              f"device {r['dev_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"torch.topk {r['library_ms']:.4f} ms (device "
              f"{r['lib_dev_ms']:.4f} ms), bound {b:.6f} ms ({by})")
    del p, h, neg, kv, ki, pv, pi, wk, ik, ak, wp, ip, ap, yk, yp, slot

    # ROADMAP C3 for routing: one teacher-forced prefill, layer by layer
    rows = moe_layers(torch, cfg, params, prompts)
    bad = [r for r in rows if not r["ok"]]
    check(not bad, "lm/moe layers: " + "; ".join(
        f"layer {r['layer']}: {r['far']} of {r['flips']} flips away from a "
        f"near-tie, ‖kernel − plain‖ {r['dist']:.4g} against {LAYER_FACTOR} "
        f"x ‖plain − fp32‖ {r['noise']:.4g} over {r['same']} tokens (at "
        f"least {MOE_SAME} x {Bt * P})"
        for r in bad))
    ratios = [r["dist"] / r["noise"] if r["noise"] else 0.0 for r in rows]
    worst = max(range(nL), key=lambda i: ratios[i])
    print(f"[lm/moe] per layer, one teacher-forced prefill of {Bt * P} "
          f"tokens: every flip of a token's top-{k} set at a near-tie; "
          f"flips a layer {[r['flips'] for r in rows]}; over the tokens all "
          f"three routes route alike (fewest {min(r['same'] for r in rows)})"
          f" ‖kernel − plain‖ within {LAYER_FACTOR} x ‖plain − fp32‖ at "
          f"all {nL} layers, at most {ratios[worst]:.3f} x (layer {worst}: "
          f"{rows[worst]['dist']:.4g} against {rows[worst]['noise']:.4g})")

    # free-running greedy generation on both routes
    def free_run(eng):
        lg, c = eng.prefill(prompts)
        toks, lgs = [], []
        for _ in range(new):
            lf = lg.float()
            nxt = lf.argmax(-1)
            toks.append(nxt)
            lgs.append(lf)
            lg, c = eng.decode(c, nxt[:, None])
        return torch.stack(toks, dim=1), torch.stack(lgs, dim=1)
    tk, lk = free_run(engine)
    check(torch.equal(tk, res.tokens), "lm/moe: generate's tokens are not "
          "the argmax of its own logits")
    check(bool(torch.isfinite(lk).all()), "lm/moe: logits not finite")
    tp, lp = free_run(ServeEngine(cfg, params, serve_cfg, path="ref"))
    # a row's context is the same on both routes up to its first differing
    # token, that step included
    differ = tk != tp
    first = torch.where(differ.any(1), differ.float().argmax(1),
                        torch.full((Bt,), new, device=dev))
    same_ctx = torch.arange(new, device=dev)[None, :] <= first[:, None]
    worst_logit = float(((lk - lp).abs().amax(-1))[same_ctx].max())
    steps_differ = {b: torch.nonzero(differ[b]).flatten().tolist()
                    for b in range(Bt) if bool(differ[b].any())}
    print(f"[lm/moe] free-running greedy, {new} steps a row: largest logit "
          f"difference from the plain route while the contexts agree "
          f"{worst_logit:.4g}; steps whose greedy token differs, by row: "
          f"{steps_differ or 'none'} (not gated: ROADMAP C); first row "
          f"{res.tokens[0, :8].tolist()}")
    if hand_on is not None:
        hand_on.update(params=params, prompts=prompts, tokens=res.tokens,
                       prefill_ms=pre, step_ms=step_ms,
                       prefill_dev=prefill_dev, step_dev=step_dev)
    del tk, lk, tp, lp, res, engine, params
    torch.cuda.empty_cache()
    print(f"[lm/moe] phase in {time.perf_counter() - t_phase:.2f}s, peak "
          f"{torch.cuda.max_memory_allocated()} bytes allocated")
    return launches


def two_phase_check(torch, cfg, p, h, plan):
    """The layer check of the two-phase MoE: one MoE layer (params ``p``,
    inputs h (T, d)) on one device (``expert_terms``, then ``combine``)
    against ``apply_moe_two_phase`` over ``plan`` (one data shard, so
    both take the capacity of all T tokens).  The shards' kept slots,
    offset by e_base·C, must be the one-device kept slots, exactly, and
    so must the dropped count.  Each shard's expert rows are then the
    one-device rows of its slot block (counted where bit-equal), and the
    two outputs differ only in how a token's k weighted rows t_j are
    grouped in the bf16 additions (a shard's in ascending slot order,
    then the shards' partials in shard order).  Any grouping of the sum
    of k terms stands within (k − 1)·2^-8·Σ|t_j| of the exact sum (first
    order; 2^-8 is bf16's unit roundoff), so elementwise
    |y_tp − y_1| ≤ Σ_j |t^tp_j − t^1_j| + (k − 1)·2^-8·(Σ_j |t^tp_j| +
    Σ_j |t^1_j|), which is 2(k − 1)·2^-8·Σ_j |w_j·ye_j| where the rows
    are equal.  Returns a dict: y1 (the one-device output), kept,
    dropped (one device), rows_equal (shards), ratio (the largest
    |y_tp − y_1| over that bound) and ok."""
    from repro_torch.models import moe
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    model_n = plan.mesh.shape[plan.model_axis]
    e_local = E // model_n
    n_data, T_loc, _ = moe.shard_grid(plan, h.shape[0])
    check(n_data == 1, "two_phase_check takes a plan of one data shard")
    C = moe.capacity(T_loc, cfg)
    slot1, t1, _ = moe.expert_terms(p, h, cfg, C)
    y1 = moe.combine(slot1, t1).to(h.dtype)
    ytp, _ = moe.apply_moe_two_phase(p, h, cfg, plan)
    union = torch.full_like(slot1, E * C)
    diff = torch.zeros(h.shape, dtype=torch.float64, device=h.device)
    mag = torch.zeros_like(diff)
    rows_equal = 0
    n_loc = e_local * C
    for j in range(model_n):
        sj, tj, _ = moe.expert_terms(moe.expert_shard(p, j, e_local,
                                                      h.device),
                                     h, cfg, C, e_base=j * e_local,
                                     e_local=e_local)
        mine = sj < n_loc
        at = torch.where(mine, sj + j * n_loc, E * C)
        union = torch.where(mine, at, union)
        rows_equal += int(torch.equal(bits(torch, tj[:-1]),
                                      bits(torch, t1[j * n_loc:
                                                     (j + 1) * n_loc])))
        gj, g1 = tj[sj].double(), t1[at].double()     # (T, k, d), 0 if not
        diff += (gj - g1).abs().sum(1)
        mag += gj.abs().sum(1) + g1.abs().sum(1)
        del gj, g1
    bound = diff + (k - 1) * 2.0 ** -8 * mag
    err = (ytp.double() - y1.double()).abs()
    ratio = torch.where(bound > 0, err / bound.clamp_min(1e-300),
                        torch.where(err > 0, math.inf, 0.0))
    kept = torch.equal(union, slot1)
    worst = float(ratio.max())
    return dict(y1=y1, kept=kept, dropped=int((slot1 == E * C).sum()),
                rows_equal=rows_equal, ratio=worst,
                ok=kept and worst <= 1.0)


def moe_two_phase_layers(torch, cfg, params, tokens, plan):
    """The per-layer checks of the two-phase MoE over one prefill of
    ``tokens`` (B, S) on the kernel route, two residual streams side by
    side: the one-device layer's and the two-phase layer's.  At every
    layer, teacher-forced on the one-device stream's MoE inputs,
    ``two_phase_check`` (kept slots exact, the bf16 grouping bound); on
    each stream's own inputs, the two routers: layer 0's inputs are the
    same bits, so its top-k sets must be the same, and at every layer a
    token whose set differs must be at a near-tie (``moe_flip_check``) and
    at least ``MOE_SAME`` of the tokens routed alike.  Returns one dict a
    layer."""
    from repro_torch.models import layers as L
    from repro_torch.models import moe, transformer
    x1 = L.apply_embed(params["embed"], tokens, cfg)
    xtp = x1
    B, S, d = x1.shape
    T = B * S
    positions = torch.arange(S, device=x1.device).expand(B, S)
    rows = []
    for i in range(cfg.n_layers):
        p = transformer.layer_params(params, i)
        xa1, _ = transformer.mixer(p, x1, cfg, positions)
        xatp, _ = transformer.mixer(p, xtp, cfg, positions)
        h1 = L.apply_norm(p["norm_ffn"], xa1, cfg).reshape(T, d)
        htp = L.apply_norm(p["norm_ffn"], xatp, cfg).reshape(T, d)
        r = two_phase_check(torch, cfg, p["moe"], h1, plan)
        _, ids1, _ = moe.route(p["moe"], h1, cfg)
        _, idstp, _ = moe.route(p["moe"], htp, cfg)
        flip, near = moe_flip_check(torch, idstp, ids1,
                                    moe.router_logits(p["moe"], htp),
                                    moe.router_logits(p["moe"], h1))
        same_input = torch.equal(bits(torch, h1), bits(torch, htp))
        r.update(layer=i, same_input=same_input, flips=int(flip.sum()),
                 far=int((~near).sum()), alike=int((~flip).sum()))
        r["ok"] = (r["ok"] and bool(near.all()) and
                   r["alike"] >= MOE_SAME * T and
                   (i > 0 or (same_input and r["flips"] == 0)))
        x1 = xa1 + r.pop("y1").reshape(B, S, d)
        ytp, _ = moe.apply_moe_two_phase(p["moe"], htp, cfg, plan)
        xtp = xatp + ytp.reshape(B, S, d)
        rows.append(r)
        del p, xa1, xatp, h1, htp, ytp
    return rows


def moe_two_phase_path(torch, ops, dev, cfg, hand):
    """Serve the ``[lm/moe]`` phase's model again (its params, prompts and
    greedy tokens handed on in ``hand``; nothing seeded twice) through the
    planned steps: ``trainer.make_prefill_step(cfg, max_seq, plan=plan)``
    and ``make_decode_step(cfg, plan=plan)``, ``plan`` a ``ParallelPlan``
    on a ``TWO_PHASE["mesh"]`` (data, model) mesh of the one card, so
    every MoE layer runs ``apply_moe_two_phase``.  Greedy generation of
    ``TWO_PHASE["new"]`` tokens with the launch counts set to 0 just
    before and read just after: B5 once a shard a layer, B10 and B11 as
    the one-device route's, each on its route.  Then the per-layer checks
    (``moe_two_phase_layers``), the two-phase layer's kernel route
    against its plain route bit for bit on a layer's real prefill states
    (T = batch · prompt and T = batch) and on a ``TWO_PHASE["split"]``
    mesh, the prefill and decode step times (host clock, then device
    busy) beside ``[lm/moe]``'s, the peak memory, and where the greedy
    tokens part from ``[lm/moe]``'s (printed, not gated).  Returns the
    launch counts."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gemm
    from repro_torch.kernels import topk_select as ts
    from repro_torch.launch.lm_kernel_times import device_kernels
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import moe, transformer
    from repro_torch.sharding import ParallelPlan
    from repro_torch.training import trainer
    t_phase = time.perf_counter()
    params, prompts, one = hand["params"], hand["prompts"], hand["tokens"]
    Bt, P = prompts.shape
    new = TWO_PHASE["new"]
    nL, E, k = cfg.n_layers, cfg.moe.num_experts, cfg.moe.top_k

    def plan_on(shape):
        return ParallelPlan(mesh=make_local_mesh(shape, dev,
                                                 axes=("data", "model")))
    plan = plan_on(TWO_PHASE["mesh"])
    shards = plan.mesh.size
    model_n = plan.mesh.shape["model"]
    torch.cuda.reset_peak_memory_stats()
    prefill_step = trainer.make_prefill_step(cfg, P + new, plan=plan)
    decode_step = trainer.make_decode_step(cfg, plan=plan)

    def generate():
        logits, cache = prefill_step(params, {"tokens": prompts})
        toks = []
        for _ in range(new):
            nxt = logits.float().argmax(-1)
            toks.append(nxt)
            logits, cache = decode_step(params, cache, nxt[:, None])
        return torch.stack(toks, dim=1), logits

    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    toks, last = generate()
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    routes = dict(b10=dict(gemm.ROUTE_LAUNCHES), b11=dict(fa.ROUTE_LAUNCHES),
                  b5=dict(ts.ROUTE_LAUNCHES))
    want = {name: 0 for name in launches}
    want["matmul"] = (4 * nL + 1) * (1 + new)
    want["flash_attention"] = nL
    want["topk_smallest"] = nL * shards * (1 + new)
    check(launches == want, f"lm/moe/two_phase: launches {launches}, the "
          f"shapes imply {want}")
    # bf16 (the card's model) on wgmma; an fp32 model (a CPU rehearsal)
    # on B10's fp32 and B11's CUDA-core routes
    big, att = ("wgmma", "wgmma") if cfg.dtype == "bfloat16" else \
        ("fp32", "cuda_core")
    want_routes = dict(
        b10=dict(wgmma=0, mma_sync=0, small_m=1 + new * (4 * nL + 1),
                 fp32=0),
        b11=dict(wgmma=0, cuda_core=0),
        b5=dict(filter=nL * shards * (1 + new), radix=0))
    want_routes["b10"][big] += 4 * nL
    want_routes["b11"][att] += nL
    check(routes == want_routes, f"lm/moe/two_phase: routes {routes}, the "
          f"design implies {want_routes}")
    check(toks.shape == (Bt, new) and
          bool(((toks >= 0) & (toks < cfg.vocab_size)).all()) and
          bool(torch.isfinite(last).all()),
          "lm/moe/two_phase: tokens out of range or logits not finite")

    # timed: the prefill alone, then decode steps on its cache (host
    # clock), then device busy time under the profiler
    prefill_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill_step(params, {"tokens": prompts})
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    steps, traced = new // 2, new // 4
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        logits, cache = decode_step(params, cache, toks[:, i:i + 1])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    spent = {"serve": time.perf_counter() - t_phase}
    t0 = time.perf_counter()
    prefill_kernels = device_kernels(
        lambda: prefill_step(params, {"tokens": prompts}))
    state = {"cache": cache}

    def decode_steps():
        for i in range(steps, steps + traced):
            _, state["cache"] = decode_step(params, state["cache"],
                                            toks[:, i:i + 1])
    step_kernels = {name: ms / traced for name, ms in
                    device_kernels(decode_steps).items()}
    prefill_dev = sum(prefill_kernels.values()) or None
    step_dev = sum(step_kernels.values()) or None
    del logits, cache, state
    spent["profile"] = time.perf_counter() - t0

    def busy(ms, wall):
        return "not measured" if ms is None else f"{ms:.2f} ms = " \
            f"{ms / wall:.3f}"
    pre = min(prefill_ms)
    print(f"[lm/moe/two_phase] {cfg.arch_id} on a {TWO_PHASE['mesh']} "
          f"(data, model) mesh of the card ({E // model_n} experts a "
          f"shard) batch={Bt} prompt={P} new={new}: generate "
          f"{gen_s:.3f}s; prefill {pre:.2f} ms (device busy "
          f"{busy(prefill_dev, pre)}), one device {hand['prefill_ms']:.2f} "
          f"ms ({busy(hand['prefill_dev'], hand['prefill_ms'])}); decode "
          f"step {step_ms:.2f} ms (device busy {busy(step_dev, step_ms)}), "
          f"one device {hand['step_ms']:.2f} ms "
          f"({busy(hand['step_dev'], hand['step_ms'])}); launches B5 "
          f"{launches['topk_smallest']} ({nL} x {shards} a forward), B10 "
          f"{launches['matmul']}, B11 {launches['flash_attention']} (the "
          f"shapes imply them); routes {routes}")
    print("[lm/moe/two_phase] device time by kernel, prefill: " + "; ".join(
        f"{n[:70]} {ms:.3f} ms" for n, ms in list(prefill_kernels.items())[:6]))
    print("[lm/moe/two_phase] device time by kernel, a decode step: " +
          "; ".join(f"{n[:70]} {ms:.3f} ms"
                    for n, ms in list(step_kernels.items())[:6]))

    # the per-layer checks over one prefill
    t0 = time.perf_counter()
    rows = moe_two_phase_layers(torch, cfg, params, prompts, plan)
    spent["layers"] = time.perf_counter() - t0
    bad = [r for r in rows if not r["ok"]]
    check(not bad, "lm/moe/two_phase layers: " + "; ".join(
        f"layer {r['layer']}: kept slots equal {r['kept']}, bound ratio "
        f"{r['ratio']:.4g}, same input {r['same_input']}, {r['far']} of "
        f"{r['flips']} flips away from a near-tie, {r['alike']} of "
        f"{Bt * P} routed alike" for r in bad))
    worst = max(rows, key=lambda r: r["ratio"])
    print(f"[lm/moe/two_phase] per layer, one prefill of {Bt * P} tokens: "
          f"teacher-forced, the kept slots equal one device's at all {nL} "
          f"layers (dropped a layer {[r['dropped'] for r in rows]}), expert "
          f"rows bit-equal in {sum(r['rows_equal'] for r in rows)} of "
          f"{nL * model_n} shard blocks, |y_tp − y_1| within the bf16 "
          f"grouping bound at most {worst['ratio']:.4f} of it (layer "
          f"{worst['layer']}); free-running, layer 0's router input "
          f"bit-equal and its top-{k} sets equal, flips a layer "
          f"{[r['flips'] for r in rows]}, all at near-ties, fewest alike "
          f"{min(r['alike'] for r in rows)}")

    # the two-phase layer, kernel route against plain route, bit for bit
    t0 = time.perf_counter()
    mid = nL // 2
    x = transformer.layer_states(params, prompts, cfg, plan=plan)[mid - 1]
    p = transformer.layer_params(params, mid)
    positions = torch.arange(P, device=dev).expand(Bt, P)
    xa, _ = transformer.mixer(p, x, cfg, positions)
    h = L.apply_norm(p["norm_ffn"], xa, cfg)
    del x, xa
    split = plan_on(TWO_PHASE["split"])
    for pl, T, hh in ((plan, Bt * P, h.reshape(Bt * P, -1)),
                      (plan, Bt, h[:, -1].contiguous()),
                      (split, Bt * P, h.reshape(Bt * P, -1))):
        n_data, T_loc, _ = moe.shard_grid(pl, T)
        C = moe.capacity(T_loc, cfg)
        mn = pl.mesh.shape["model"]
        ops.reset_launches()
        yk, ak = moe.apply_moe_two_phase(p["moe"], hh, cfg, pl)
        torch.cuda.synchronize()
        n_b5 = ops.LAUNCHES["topk_smallest"]
        yp, ap = moe.apply_moe_two_phase(p["moe"], hh, cfg, pl, path="ref")
        check(n_b5 == pl.mesh.size and
              torch.equal(bits(torch, yk), bits(torch, yp)) and
              torch.equal(bits(torch, ak), bits(torch, ap)),
              f"lm/moe/two_phase {tuple(pl.mesh.shape.values())} T={T}: "
              f"the kernel route differs from the plain route ({n_b5} B5 "
              "launches)")
        kept = 0
        for i in range(n_data):
            w, ids, _ = moe.route(p["moe"], hh[i * T_loc:(i + 1) * T_loc],
                                  cfg)
            slot, _, _ = moe.slot_map(w, ids, C, E)
            kept += int((slot < E * C).sum())
        print(f"[lm/moe/two_phase] layer {mid}, mesh (data, model) = "
              f"{tuple(pl.mesh.shape.values())}, T={T} ({n_data} data "
              f"shards of {T_loc} tokens, C={C}, {E // mn} experts a "
              f"shard): {kept} of {T * k} assignments kept; kernel route "
              f"bit-equal to the plain route, B5 launched {n_b5} times")
    del p, h, hh, yk, yp, ak, ap
    spent["routes"] = time.perf_counter() - t0

    # where the greedy tokens part from the one-device route's
    differ = toks != one[:, :new]
    parts = {b: int(differ[b].float().argmax()) for b in range(Bt)
             if bool(differ[b].any())}
    torch.cuda.empty_cache()
    print(f"[lm/moe/two_phase] greedy tokens against [lm/moe]'s, first "
          f"differing step by row: {parts or 'none'} (not gated: ROADMAP "
          f"C); first row {toks[0].tolist()}; phase in "
          f"{time.perf_counter() - t_phase:.2f}s (" + ", ".join(
              f"{name} {sec:.2f}s" for name, sec in spent.items())
          + f"), peak "
          f"{torch.cuda.max_memory_allocated()} bytes allocated")
    return launches


def stream_path(torch, ops, dev, est, kr, queries, helpers,
                cache_size: int = 0) -> int:
    """Serve ``est`` through ``RequestScheduler``: warm every bucket of a
    ``NonNeuralServeEngine``, replay the seeded Poisson trace ``STREAM``
    over ``queries`` (cycled), with every launch count set to 0 just
    before the warmup and read just after the replay, and check it:
    launches only of ``kr``'s kernel and only into buckets warmed before
    the stream, every request served, each prediction equal to one
    ``classify`` of the same queries but at fp32 near-ties, a cache hit's
    answer equal bit for bit to the one served for its row.  Prints the
    ``[stream]`` lines; returns the kernel's launches."""
    import numpy as np

    from repro_torch.serving import (NonNeuralServeEngine, RequestScheduler,
                                     poisson_trace, replay_trace)
    algo = est.algorithm
    counts = poisson_trace(STREAM["rate"], STREAM["ticks"], seed=SEED)
    engine = NonNeuralServeEngine(est, max_batch=MAX_BATCH, device=dev)
    ops.reset_launches()
    engine.warmup_buckets(queries.shape[1])
    sched = RequestScheduler(engine, max_wait=STREAM["max_wait"],
                             cache_size=cache_size)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = replay_trace(sched, queries, counts, deadline=STREAM["deadline"])
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    st = sched.stats
    n_launch = launches[kr["name"]]
    what = f"stream {algo}" + (f" cache={cache_size}" if cache_size else "")
    check(set(engine.bucket_launches) <= sched.warmed,
          f"{what}: buckets {sorted(engine.bucket_launches)} not all "
          f"warmed before the stream {sorted(sched.warmed)}")
    check(n_launch == len(engine.warmed) + st.launches and
          sum(launches.values()) == n_launch,
          f"{what}: launches {launches} for {len(engine.warmed)} warmed "
          f"buckets and {st.launches} drains")
    check(len(ids) == int(counts.sum()) == st.completed and
          sched.pending == 0 and st.shed == 0,
          f"{what}: {len(ids)} requests, {st.completed} completed, "
          f"{st.shed} shed")
    # one classify of the same queries, after the counted run
    rows = queries[np.arange(len(ids)) % len(queries)]
    one = engine.classify(rows)
    one_cls, one_aux = one.classes.cpu().numpy(), one.aux.cpu().numpy()
    res = [sched.results[i] for i in ids]
    got_cls = np.array([r.prediction for r in res])
    got_aux = np.stack([r.aux for r in res])
    odd = got_cls != one_cls
    if algo == "knn":
        on_card, pair_dist = helpers["on_card"], helpers["pair_dist"]
        got_t, one_t, Q = on_card(got_aux), on_card(one_aux), on_card(rows)
        A = engine.estimator.params.A
        dk, scale = pair_dist(A[got_t.long()], Q)
        dp, _ = pair_dist(A[one_t.long()], Q)
        n_near = helpers["compare_ranked"](
            what, got_t, one_t, helpers["near"](dk, dp, scale), False)
        check(bool((got_aux != one_aux).any(1)[odd].all()),
              f"{what}: a class differs from one classify without a "
              "near-tie")
    else:
        check(np.allclose(got_aux, one_aux, **TOL),
              f"{what}: scores differ from one classify by "
              f"{float(np.abs(got_aux - one_aux).max())}")
        top2 = -np.sort(-one_aux, axis=1)[:, :2]
        tie = np.isclose(top2[:, 0], top2[:, 1], **TOL)
        check(bool(tie[odd].all()), f"{what}: a class differs from one "
              "classify without a near-tie")
        n_near = int(odd.sum())
    # a hit's answer is the served answer of its row, bit for bit
    served = {}
    for i, r in zip(ids, res):
        row = i % len(queries)
        if r.cache_hit:
            p, a = served[row]
            check(r.prediction == p and np.array_equal(r.aux, a),
                  f"{what}: request {i} hit an answer unlike the one served "
                  "for its row")
        else:
            served.setdefault(row, (r.prediction, r.aux))
    check((st.cache_hits > 0) == bool(cache_size),
          f"{what}: {st.cache_hits} cache hits")
    s = st.summary()
    events = {}
    for e in sched.events:
        events[e.kind] = events.get(e.kind, 0) + 1
    print(f"[stream] {algo}: rate={STREAM['rate']} ticks={STREAM['ticks']} "
          f"max_wait={STREAM['max_wait']} deadline={STREAM['deadline']} "
          f"cache={cache_size} over {len(queries)} distinct queries")
    host = wall - float(np.sum(st.batch_times))
    print(f"[stream] {algo}: served {len(ids)} requests in {wall:.3f}s wall "
          f"({len(ids) / wall:.1f} req/s; {host:.3f}s of it outside the "
          f"launches, {1e6 * host / len(ids):.2f} us a request; "
          f"{s['launches']} launches, "
          f"buckets={dict(sorted(st.bucket_launches.items()))}, straggler "
          f"events={sum(events.values())} {events}); {kr['name']} "
          f"launches={n_launch} ({len(engine.warmed)} warmup buckets + "
          f"{st.launches} drains)")
    print(f"[stream] {algo}: latency ticks p50={s['p50']:.0f} "
          f"p95={s['p95']:.0f} p99={s['p99']:.0f}  throughput="
          f"{s['throughput']:.2f} req/tick  occupancy={s['occupancy']:.4f}  "
          f"hit_rate={s['hit_rate']:.4f}  deadline_miss="
          f"{s['deadline_miss_rate']:.4f}; mean launch (copy in, "
          f"classify, synchronize) "
          f"{1e3 * float(np.mean(st.batch_times)):.4f} ms; equal to one "
          f"classify of the same {len(ids)} queries but near_ties={n_near}"
          + (f"; {st.cache_hits} hits equal to their rows' served answers"
             if cache_size else ""))
    return n_launch


def tenants_path(torch, ops, ref, dev, peaks, kernels,
                 helpers) -> None:
    """Multi-tenant serving at the paper's widths (``TENANTS``): seeded
    fleets of same-shape per-tenant fits in a ``ModelStore`` on the card,
    served by ``NonNeuralServeEngine.classify_group``, one grouped launch
    of B1 (kNN), B2 (K-Means) or B3 (GNB, GMM at d = 784) a (group,
    bucket) cell.  For each fleet one call of ``GROUP`` tenants x ``ROWS``
    rows: one launch of its kernel (launch and route counts read around
    the call), each lane bit-equal to the per-tenant loop on the same
    stacked lanes, and equal to the grouped plain version (``path="ref"``)
    but at fp32 near-ties.  Then the kNN fleet under a resident budget
    (evictions, admissions that serve their dequantized lanes, a hot-swap
    that misses the stacked-group cache, a NaN update refused and its
    tenant's breaker open), a seeded cross-tenant Poisson stream through
    the store-mode scheduler (each prediction equal to the one-shot
    grouped answer, only warmed cells), and a chaos replay run twice
    (identical results and events).  Adds the path's launches to
    ``kernels``."""
    import copy

    import numpy as np

    from repro_torch.core import estimator as est_mod
    from repro_torch.core.gmm import GMMState
    from repro_torch.data.datasets import class_blobs
    from repro_torch.kernels import distance_argmin as kda
    from repro_torch.kernels import distance_topk as kdt
    from repro_torch.kernels import gnb_score as kgs
    from repro_torch.launch.lm_kernel_times import device_ms
    from repro_torch.runtime.chaos import (ChaosInjector, ChaosPlan,
                                           _poison_first_leaf)
    from repro_torch.serving import (BreakerConfig, DegradePolicy,
                                     ModelStore, PoisonedParamsError,
                                     RequestScheduler, poisson_trace,
                                     replay_trace)
    from repro_torch.serving import quant as squant

    on_card, pair_dist, near = (helpers[k] for k in
                                ("on_card", "pair_dist", "near"))
    Gg, R = TENANTS["group"], TENANTS["rows"]
    card = smi()
    keys = {"knn": ("B1", "distance_topk", kdt.ROUTE_LAUNCHES),
            "kmeans": ("B2", "distance_argmin", kda.ROUTE_LAUNCHES),
            "gnb": ("B3", "gnb_scores_batch", kgs.ROUTE_LAUNCHES),
            "gmm": ("B3", "gnb_scores_batch", kgs.ROUTE_LAUNCHES)}

    def count(name):
        """Add the run's launches of ``name`` (and its grouped ones) to
        its kernel's counts."""
        kr = kernels[next(k for k, n, _ in keys.values() if n == name)]
        kr["launches"] += ops.LAUNCHES[name]
        kr["grouped"] = kr.get("grouped", 0) + ops.GROUP_LAUNCHES[name]

    def fleet(algo, cfg, seed, **kw):
        """G tenants cut from one seeded blob draw (tenant t: rows
        t (n + ROWS) .., the last ROWS its queries), fitted on the card
        and registered; returns (store, queries (G, ROWS, d), fits)."""
        groups = cfg.get("classes", cfg.get("K"))
        X, y = class_blobs(n=cfg["G"] * (cfg["n"] + R), d=cfg["d"],
                           n_class=groups, seed=seed)
        X = X.reshape(cfg["G"], cfg["n"] + R, cfg["d"])
        y = y.reshape(cfg["G"], cfg["n"] + R)
        store, fits = ModelStore(device=dev), []
        for t in range(cfg["G"]):
            fits.append(est_mod.make_fitted(
                algo, X[t, :cfg["n"]], y[t, :cfg["n"]], n_groups=groups,
                device=dev, **kw))
            store.register(t, fits[-1])
        return store, np.ascontiguousarray(X[:, cfg["n"]:]), fits

    def host_ms(fn, reps):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(1e3 * (time.perf_counter() - t0))
        return float(np.median(out))

    def against_plain(algo, stacked, Qt, res, store):
        """The grouped plain version (path="ref") on the same lanes: exact
        but at fp32 near-ties, whose count it returns."""
        pest = copy.copy(store.template)
        pest.path = "ref"
        pcls, paux = pest.predict_batch_group_fn()(stacked, Qt)
        odd = res.classes != pcls
        if algo == "knn":
            n_near = 0
            for t in range(Qt.shape[0]):
                A = stacked.A[t]
                dk, scale = pair_dist(A[res.aux[t].long()], Qt[t])
                dp, _ = pair_dist(A[paux[t].long()], Qt[t])
                agree = near(dk, dp, scale)
                differ = res.aux[t] != paux[t]
                check(bool((~differ | agree).all()), f"tenants knn lane {t}: "
                      "a neighbour differs from the plain version's "
                      "without a near-tie")
                n_near += int(differ.sum())
            check(bool((res.aux != paux).any(2)[odd].all()),
                  "tenants knn: a class differs without a neighbour "
                  "near-tie")
            return n_near
        if algo == "kmeans":
            c = stacked.centroids
            scale = (Qt * Qt).sum(2) + torch.gather((c * c).sum(2), 1,
                                                    res.classes.long())
            check(near(res.aux, paux, scale).all().item(),
                  "tenants kmeans: distances differ from the plain "
                  "version's")
            pd = torch.gather(
                (Qt[:, :, None] - c[:, None]).pow(2).sum(3), 2,
                res.classes.long()[..., None])[..., 0]
            check(bool(near(pd, paux, scale)[odd].all()),
                  "tenants kmeans: an assignment differs without a "
                  "near-tie")
            return int(odd.sum())
        if algo == "gnb":
            check(bool(torch.isclose(res.aux, paux, **TOL).all()),
                  "tenants gnb: scores differ from the plain version's by "
                  f"{float((res.aux - paux).abs().max())}")
            scale = paux.abs()
        else:
            inv = 1.0 / stacked.var
            scale = (Qt * Qt) @ (0.5 * inv).transpose(1, 2) + \
                Qt.abs() @ (stacked.mu * inv).abs().transpose(1, 2) + \
                0.5 * (stacked.mu ** 2 * inv + torch.log(stacked.var).abs()
                       + math.log(2 * math.pi)).sum(2)[:, None]
            check(bool(((res.aux - paux).abs() <= TOL["atol"] + TOL["rtol"]
                        * scale).all()), "tenants gmm: log-responsibilities "
                  "differ from the plain version's")
        top2 = paux.topk(2, dim=2)
        tie = (top2.values[..., 0] - top2.values[..., 1]).abs() <= \
            TOL["atol"] + TOL["rtol"] * scale.gather(
                2, top2.indices[..., :1])[..., 0]
        check(bool(tie[odd].all()), f"tenants {algo}: a class differs from "
              "the plain version's without a near-tie")
        return int(odd.sum())

    t_phase = time.perf_counter()
    fleets = {}
    t0 = time.perf_counter()
    fleets["knn"] = fleet("knn", TENANTS["knn"], SEED + 11,
                          k=TENANTS["knn"]["k"])
    fleets["kmeans"] = fleet("kmeans", TENANTS["kmeans"], SEED + 12)
    fleets["gnb"] = fleet("gnb", TENANTS["gnb"], SEED + 13)
    # GMM tenants at the GNB fleet's widths: the mixture of its first
    # GROUP tenants' class moments (components = classes), the GMM-wide
    # path's B3 arm with log_pi as the prior
    gstore = ModelStore(device=dev)
    for t, g in enumerate(fleets["gnb"][2][:Gg]):
        p = g.params
        gstore.register(t, est_mod.GMMEstimator.from_params(GMMState(
            mu=p.mu, var=p.var, log_pi=p.log_prior,
            log_lik=torch.zeros((), device=dev),
            n_iter=torch.zeros((), dtype=torch.int32, device=dev)),
            device=dev))
    fleets["gmm"] = (gstore, fleets["gnb"][1][:Gg], None)
    torch.cuda.synchronize()
    print(f"[tenants] fleets fitted and registered in "
          f"{time.perf_counter() - t0:.2f}s: " + ", ".join(
              f"{a} G={len(st)} resident {st.stats()['resident_bytes']}B "
              f"(int8 at rest {sum(sl.at_rest_bytes for sl in st._slots.values())}B)"
              for a, (st, _, _) in fleets.items()))

    engines = {}
    for algo, (store, Q, _) in fleets.items():
        key, kname, routes = keys[algo]
        d = Q.shape[2]
        engine = store.make_engine(max_batch=R, max_group=Gg)
        engines[algo] = engine
        ids = list(range(Gg))
        stacked, _ = store.group(ids)
        n_cells = engine.warmup_groups(stacked, d)
        Qt = on_card(Q[:Gg])
        torch.cuda.synchronize()
        ops.reset_launches()
        res = engine.classify_group(stacked, Qt)
        torch.cuda.synchronize()
        launches, grouped = dict(ops.LAUNCHES), dict(ops.GROUP_LAUNCHES)
        way = [r for r, n in routes.items() if n]
        count(kname)
        check(launches[kname] == 1 and grouped[kname] == 1 and
              sum(launches.values()) == 1 and res.launches == 1 and
              engine.group_launches == {(Gg, R): 1} and len(way) == 1,
              f"tenants {algo}: launches {launches}, grouped {grouped}, "
              f"cells {engine.group_launches}, routes {dict(routes)}")
        cells = dict(engine.group_launches)
        fn = store.template.predict_batch_fn()
        lanes = [est_mod.unstack_params(stacked, t) for t in ids]
        outs = [fn(lanes[t], Qt[t]) for t in ids]
        torch.cuda.synchronize()
        for t in ids:
            check(torch.equal(res.classes[t], outs[t][0]) and
                  torch.equal(res.aux[t], outs[t][1]),
                  f"tenants {algo}: lane {t} is not bit-equal to its "
                  "one-tenant call")
        n_near = against_plain(algo, stacked, Qt, res, store)
        group_ms = host_ms(lambda: engine.classify_group(stacked, Qt), 5)
        loop_ms = host_ms(lambda: [fn(lanes[t], Qt[t]) for t in ids], 3)
        nq = Gg * R
        print(f"[tenants] {algo}: {Gg} tenants x {R} rows (d={d}) in one "
              f"{key} {kname} launch ({way[0]} route; {n_cells} warmed "
              f"cells), lanes bit-equal to the per-tenant loop, equal to "
              f"the grouped plain version but {n_near} at near-ties; "
              f"grouped {group_ms:.4f} ms ({1e3 * group_ms / nq:.3f} us a "
              f"query) vs per-tenant loop {loop_ms:.4f} ms "
              f"({1e3 * loop_ms / nq:.3f} us a query), host clock; "
              f"launches a cell {cells}; resident "
              f"{store.stats()['resident_bytes']}B; {card}")

    # the grouped kernels at the group shape: device time and bound
    (kst, kQ, _), (mst, mQ, _), (gst, gQ, _) = (
        fleets["knn"], fleets["kmeans"], fleets["gnb"])
    ka, _ = kst.group(list(range(Gg)))
    ma, _ = mst.group(list(range(Gg)))
    ga, _ = gst.group(list(range(Gg)))
    kq, mq, gq = on_card(kQ[:Gg]), on_card(mQ[:Gg]), on_card(gQ[:Gg])
    kk = TENANTS["knn"]["k"]
    Nn, d1 = ka.A.shape[1:]
    Km, dg, Cg = ma.centroids.shape[1], gq.shape[2], ga.mu.shape[1]
    # (grouped kernel, one tenant's launch, grouped plain version, one
    # PyTorch call of the same function or None, operations, bytes)
    cases = {
        "B1": (lambda: ops.distance_topk_group(ka.A, kq, kk),
               lambda: ops.distance_topk(ka.A[0], kq[0], kk),
               lambda: ref.distance_topk_group(ka.A, kq, kk),
               lambda: torch.cdist(kq, ka.A).topk(kk, largest=False),
               Gg * Nn * R * (2 * d1 + 1),
               4 * Gg * (Nn + R) * d1 + 8 * Gg * R * kk),
        "B2": (lambda: ops.distance_argmin_group(mq, ma.centroids),
               lambda: ops.distance_argmin(mq[0], ma.centroids[0]),
               lambda: ref.distance_argmin_group(mq, ma.centroids),
               lambda: torch.cdist(mq, ma.centroids).argmin(2),
               Gg * R * Km * (2 * d1 + 1),
               4 * Gg * (R + Km) * d1 + 8 * Gg * R),
        "B3": (lambda: ops.gnb_scores_batch_group(gq, ga.mu, ga.var,
                                                  ga.log_prior),
               lambda: ops.gnb_scores_batch(gq[0], ga.mu[0], ga.var[0],
                                            ga.log_prior[0]),
               lambda: ref.gnb_scores_batch_group(gq, ga.mu, ga.var,
                                                  ga.log_prior),
               None, 5 * Gg * R * Cg * dg,
               4 * Gg * (R * dg + 2 * Cg * dg + Cg + R * Cg))}
    for key, (grp, one, plain, lib, n_ops, n_bytes) in cases.items():
        row = dict(ms=device_ms(grp, 50), one_ms=device_ms(one, 50),
                   events_ms=cuda_ms(torch, grp, 50),
                   plain_ms=cuda_ms(torch, plain, 10),
                   library_ms=None if lib is None else cuda_ms(torch, lib,
                                                               10))
        row["bound_ms"], row["bound_by"] = bound_ms(n_ops, n_bytes, peaks)
        kernels[key]["group"] = row
        lib_s = "none" if lib is None else f"{row['library_ms']:.4f} ms"
        print(f"[tenants/time] {key} {kernels[key]['name']} at G={Gg} x "
              f"{R} rows: grouped {row['ms']:.4f} ms device (graph replay; "
              f"events {row['events_ms']:.4f} ms), one tenant "
              f"{row['one_ms']:.4f} ms device ({row['ms'] / row['one_ms']:.2f}"
              f"x for {Gg}x the work), plain {row['plain_ms']:.4f} ms, "
              f"library {lib_s}, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}); {card}")
    del ka, ma, ga, kq, mq, gq

    # the cost of a stacked-group cache miss against a hit, 64 kNN tenants
    other = list(range(Gg, 2 * Gg))
    miss_ms = host_ms(lambda: (kst._group_cache.clear(), kst.group(other)),
                      3)
    hit_ms = host_ms(lambda: kst.group(other), 3)
    print(f"[tenants] knn group() of {Gg} tenants: miss (torch.stack of "
          f"{Gg * Nn * d1 * 4 + Gg * Nn * 4}B on the card) {miss_ms:.4f} "
          f"ms, hit {hit_ms:.4f} ms, host clock")

    # a cross-tenant Poisson stream through the store-mode scheduler
    st = TENANT_STREAM
    G = len(kst)
    engine = engines["knn"]
    counts = poisson_trace(st["rate"], st["ticks"], seed=SEED)
    total = int(counts.sum())
    mids = np.random.default_rng(SEED).integers(0, G, size=total).tolist()
    flat = kQ.reshape(-1, kQ.shape[2])
    sched = RequestScheduler(engine, store=kst, max_wait=st["max_wait"])
    misses0 = kst.group_misses
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = replay_trace(sched, flat, counts, deadline=st["deadline"],
                        model_ids=mids)
    wall = time.perf_counter() - t0
    n_miss = kst.group_misses - misses0
    count("distance_topk")
    n_launch = ops.LAUNCHES["distance_topk"]
    ss = sched.stats
    check(len(rids) == total == ss.completed and sched.pending == 0 and
          n_launch == ss.launches == ops.GROUP_LAUNCHES["distance_topk"] and
          sum(ops.LAUNCHES.values()) == n_launch,
          f"tenant stream: {len(rids)} requests, {ss.completed} completed, "
          f"{ss.launches} drains, launches {ops.LAUNCHES}")
    check(set(engine.group_launches) <= sched.warmed_groups,
          f"tenant stream ran cells {sorted(engine.group_launches)} not "
          f"warmed before it {sorted(sched.warmed_groups)}")
    # the one-shot grouped answer of every request, GROUP at a time
    one_cls = np.empty(total, np.int64)
    one_aux = np.empty((total, kk), np.int64)
    for lo in range(0, total, Gg):
        sel = list(range(lo, min(total, lo + Gg)))
        stacked, _ = kst.group([mids[i] for i in sel])
        r = engine.classify_group(stacked, on_card(
            flat[[i % len(flat) for i in sel]][:, None]))
        one_cls[sel] = r.classes[:, 0].cpu().numpy()
        one_aux[sel] = r.aux[:, 0].cpu().numpy()
    got_cls = np.array([int(sched.results[i].prediction) for i in rids])
    got_aux = np.stack([sched.results[i].aux for i in rids])
    check(np.array_equal(got_cls, one_cls) and
          np.array_equal(got_aux, one_aux),
          f"tenant stream: {int((got_cls != one_cls).sum())} predictions "
          "differ from the one-shot grouped answer")
    s = ss.summary()
    host = wall - float(np.sum(ss.batch_times))
    print(f"[tenants/stream] knn: {G} tenants drawn uniformly (seed "
          f"{SEED}), rate={st['rate']} ticks={st['ticks']} "
          f"max_wait={st['max_wait']} deadline={st['deadline']}, "
          f"{R}-row buckets, group <= {Gg}: served {total} requests in "
          f"{wall:.3f}s wall ({total / wall:.1f} req/s; {host:.3f}s of it "
          f"outside the launches, {1e6 * host / total:.2f} us a request); "
          f"{ss.launches} grouped launches, {n_miss} "
          f"stacked-group cache misses, cells "
          f"{dict(sorted(engine.group_launches.items()))}")
    print(f"[tenants/stream] knn: latency ticks p50={s['p50']:.0f} "
          f"p95={s['p95']:.0f} p99={s['p99']:.0f} throughput="
          f"{s['throughput']:.2f} req/tick occupancy={s['occupancy']:.4f} "
          f"deadline_miss={s['deadline_miss_rate']:.4f}; mean launch "
          f"(group, copy in, classify_group, synchronize) "
          f"{1e3 * float(np.mean(ss.batch_times)):.4f} ms; every "
          f"prediction equal to the one-shot grouped answer; {card}")
    del sched

    # the kNN fleet under a resident budget: evict, admit, hot-swap, NaN
    full = kst.stats()["resident_bytes"]
    ev0, adm0 = kst.evictions, kst.admissions
    kst.set_budget(int(full * TENANTS["resident_frac"]))
    stt = kst.stats()
    check(kst.evictions > ev0 and stt["n_resident"] < len(kst),
          f"budget: no eviction ({stt})")
    cold = [m for m in kst.model_ids if m not in set(kst.resident_ids)][:Gg]
    stacked, _ = kst.group(cold)
    check(kst.admissions - adm0 == len(cold) == Gg,
          f"budget: {kst.admissions - adm0} admissions for {len(cold)}")
    Qc = on_card(kQ[cold])
    res = engine.classify_group(stacked, Qc)
    fn = kst.template.predict_batch_fn()
    for gi, m in enumerate(cold):
        deq = squant.dequantize_params(kst._slots[m].qparams,
                                       dtype=torch.float32)
        lane = est_mod.unstack_params(stacked, gi)
        check(torch.equal(lane.A, deq.A) and
              torch.equal(lane.labels, deq.labels),
              f"budget: tenant {m}'s admitted lane is not its dequantized "
              "at-rest payload")
        cls, aux = fn(deq, Qc[gi])
        check(torch.equal(res.classes[gi], cls) and
              torch.equal(res.aux[gi], aux),
              f"budget: tenant {m} does not serve its dequantized lane's "
              "answers")
    misses = kst.group_misses
    kst.group(cold)
    check(kst.group_misses == misses, "budget: a repeated group missed")
    gen = kst.update(cold[0], fleets["knn"][2][cold[1]])
    kst.group(cold)
    check(gen == 1 and kst.group_misses == misses + 1,
          f"hot-swap: generation {gen}, misses {kst.group_misses - misses}")
    bad = copy.copy(kst.template)
    bad._params = _poison_first_leaf(kst.params_of(cold[2])[1])
    try:
        kst.update(cold[2], bad)
        check(False, "a NaN update was published")
    except PoisonedParamsError as e:
        leaf = e.leaf_path
    guard = RequestScheduler(engine, store=kst,
                             breaker=BreakerConfig(fail_threshold=1))
    guard.record_failure(cold[2], reason="nan_rejected")
    rid = guard.submit(kQ[cold[2], 0], model_id=cold[2])
    check(guard.results[rid].shed and
          guard.results[rid].reason == "breaker_open" and
          kst.generation(cold[2]) == 0 and kst.poisoned_rejections == 1,
          "NaN update: its tenant still takes requests")
    stt = kst.stats()
    print(f"[tenants] knn at resident-frac {TENANTS['resident_frac']}: "
          f"{stt['n_resident']}/{stt['n_models']} resident "
          f"({stt['resident_bytes']}B of {full}B fp32; at rest "
          f"{stt['at_rest_bytes']}B int8), {kst.evictions - ev0} evictions, "
          f"{kst.admissions - adm0} admissions; {Gg} admitted tenants serve "
          f"their dequantized lanes' answers; update -> generation {gen}, "
          f"the stacked-group cache missed; a NaN update refused "
          f"(PoisonedParamsError at {leaf}) and its tenant's submits shed "
          f"breaker_open")
    del fleets["knn"], kst, stacked, res, engines["knn"]

    # a chaos replay of the "storm" plan over the K-Means fleet, twice
    mfits = fleets["kmeans"][2]

    def chaos_run():
        store = ModelStore(device=dev)
        for t, est in enumerate(mfits):
            store.register(t, est)
        eng = store.make_engine(max_batch=R, max_group=Gg)
        eng.warmup_groups(store.group(list(range(Gg)))[0], mQ.shape[2])
        sched = RequestScheduler(eng, store=store, max_wait=st["max_wait"],
                                 shed_expired=True, breaker=BreakerConfig(),
                                 degrade=DegradePolicy(
                                     None, deadline=st["deadline"]))
        plan = ChaosPlan.preset("storm", seed=SEED, ticks=24,
                                n_tenants=len(store))
        cnt = poisson_trace(64, 24, seed=SEED)
        who = np.random.default_rng(SEED + 1).integers(
            0, len(store), size=int(cnt.sum()) + 200).tolist()
        ids = replay_trace(sched, mQ.reshape(-1, mQ.shape[2]), cnt,
                           deadline=st["deadline"], model_ids=who,
                           chaos=ChaosInjector(plan, store=store))
        keys_ = [(i, r.shed, r.reason, None if r.prediction is None
                  else int(r.prediction), r.tier, r.bucket, r.queue_time,
                  r.batch_time) for i, r in
                 ((i, sched.results[i]) for i in ids)]
        return keys_, list(sched.events), sched, store

    ops.reset_launches()
    k1, e1, s1, store1 = chaos_run()
    count("distance_argmin")
    ops.reset_launches()
    k2, e2, _, _ = chaos_run()
    check(k1 == k2 and e1 == e2, "chaos: two replays of one plan differ")
    kinds = {}
    for e in e1:
        kinds[e.kind] = kinds.get(e.kind, 0) + 1
    check(kinds.get("chaos_eviction_storm", 0) > 0 and
          kinds.get("nan_rejected", 0) == kinds.get("chaos_nan", 0),
          f"chaos: events {kinds}")
    print(f"[tenants/chaos] kmeans storm plan (seed {SEED}, 24 ticks) over "
          f"{len(store1)} tenants, run twice: identical RequestResult and "
          f"event streams ({len(k1)} requests, shed "
          f"{dict(s1.stats.shed_reasons)}, evictions {store1.evictions}, "
          f"events {kinds})")
    print(f"[tenants] phase in {time.perf_counter() - t_phase:.2f}s; {card}")


def tenant_kernel_edges(torch, ops, ref, dev, gen) -> int:
    """B1, B2 and B3 over model groups (a tenant axis, one launch): each
    lane bit-equal to the one-tenant launch on its operands, and the group
    against the grouped plain version (integer data: exact; normal data:
    values to ``TOL`` scaled as the one-tenant edges scale them), on every
    route, with tenant bases off 16 bytes (N d not a multiple of 4) and
    d past the bulk route.  Returns the number of cases."""
    from repro_torch.kernels import distance_argmin as kda
    from repro_torch.kernels import distance_topk as kdt
    from repro_torch.kernels import gnb_score as kgs

    def rand(shape, ints):
        if ints:
            return torch.randint(-2, 3, shape, generator=gen).float().to(dev)
        return torch.randn(shape, generator=gen).to(dev)

    def lanes_equal(got, one, what):
        for t, (a, b) in enumerate(zip(got, one)):
            check(torch.equal(a, b), f"{what}: lane {t} differs from its "
                  f"one-tenant launch in {int((a != b).sum())} places")

    def scaled(got, want, scale, what):
        check(bool(((got - want).abs() <= TOL["atol"] + TOL["rtol"] * scale)
                   .all()), f"{what}: values differ from the grouped plain "
              f"version by {float((got - want).abs().max())}")

    n = 0
    for G, N, d, Q, k, ints, way in [(5, 4096, 21, 16, 4, False, "bulk"),
                                     (3, 37, 5, 7, 4, True, "plain"),
                                     (3, 4099, 21, 130, 32, False, "plain"),
                                     (4, 300, 40, 33, 8, True, "plain"),
                                     (2, 1000, 21, 129, 32, True, "bulk")]:
        A, C = rand((G, N, d), ints), rand((G, Q, d), ints)
        what = f"B1 group G={G} N={N} d={d} Q={Q} k={k}"
        check(kdt.route(A) == way, f"{what}: route {kdt.route(A)}")
        before = dict(kdt.ROUTE_LAUNCHES)
        gv, gi = ops.distance_topk_group(A, C, k)
        check(kdt.ROUTE_LAUNCHES[way] == before[way] + 1,
              f"{what}: not one launch on {way}")
        one = [ops.distance_topk(A[t], C[t], k) for t in range(G)]
        pv, pi = ref.distance_topk_group(A, C, k)
        torch.cuda.synchronize()
        lanes_equal(gv, [o[0] for o in one], what + " values")
        lanes_equal(gi, [o[1] for o in one], what + " indices")
        an = (A * A).sum(-1)
        cn = (C * C).sum(-1)
        scale = torch.gather(an, 1, gi.reshape(G, -1).long()).reshape(
            gi.shape) + cn[..., None]
        scaled(gv, pv, scale, what)
        if ints:
            check(torch.equal(gi, pi), f"{what}: indices differ from the "
                  "grouped plain version on integer data")
        print(f"[edge] {what} {way}: lanes bit-equal to one-tenant "
              f"launches, max_abs_err={float((gv - pv).abs().max()):.3g}")
        n += 1
    for G, N, K, d, ints, way in [(8, 16, 8, 21, False, "narrow"),
                                  (3, 4096, 256, 21, False, "bulk"),
                                  (3, 4099, 8, 21, True, "plain"),
                                  (4, 100, 16, 1, False, "rows"),
                                  (2, 500, 1000, 21, True, "stream"),
                                  (2, 3001, 64, 40, False, "plain")]:
        A, Cc = rand((G, N, d), ints), rand((G, K, d), ints)
        what = f"B2 group G={G} N={N} K={K} d={d}"
        check(kda.route(A, Cc) == way, f"{what}: route {kda.route(A, Cc)}")
        before = dict(kda.ROUTE_LAUNCHES)
        gv, gi = ops.distance_argmin_group(A, Cc)
        check(kda.ROUTE_LAUNCHES[way] == before[way] + 1,
              f"{what}: not one launch on {way}")
        one = [ops.distance_argmin(A[t], Cc[t]) for t in range(G)]
        pv, pi = ref.distance_argmin_group(A, Cc)
        torch.cuda.synchronize()
        lanes_equal(gv, [o[0] for o in one], what + " values")
        lanes_equal(gi, [o[1] for o in one], what + " indices")
        scale = (A * A).sum(-1) + torch.gather(
            (Cc * Cc).sum(-1), 1, gi.long())
        scaled(gv, pv, scale, what)
        if ints:
            check(torch.equal(gi, pi), f"{what}: ids differ from the "
                  "grouped plain version on integer data")
        print(f"[edge] {what} {way}: lanes bit-equal to one-tenant "
              f"launches, max_abs_err={float((gv - pv).abs().max()):.3g}")
        n += 1
    for G, B, C, d, way in [(4, 16, 10, 784, "resident"),
                            (3, 33, 17, 100, "stream"),
                            (5, 1, 3, 64, "resident"),
                            (2, 5, 12, 2100, "stream")]:
        X = torch.randn((G, B, d), generator=gen).to(dev)
        mu = torch.randn((G, C, d), generator=gen).to(dev)
        var = (torch.rand((G, C, d), generator=gen) + 0.25).to(dev)
        lp = torch.log_softmax(torch.randn((G, C), generator=gen), 1).to(dev)
        what = f"B3 group G={G} B={B} C={C} d={d}"
        check(kgs.route(C, d) == way, f"{what}: route {kgs.route(C, d)}")
        before = dict(kgs.ROUTE_LAUNCHES)
        gs = ops.gnb_scores_batch_group(X, mu, var, lp)
        check(kgs.ROUTE_LAUNCHES[way] == before[way] + 1,
              f"{what}: not one launch on {way}")
        one = [ops.gnb_scores_batch(X[t], mu[t], var[t], lp[t])
               for t in range(G)]
        ps = ref.gnb_scores_batch_group(X, mu, var, lp)
        torch.cuda.synchronize()
        lanes_equal(gs, one, what)
        check(bool(torch.isclose(gs, ps, **TOL).all()), f"{what}: scores "
              f"differ from the grouped plain version by "
              f"{float((gs - ps).abs().max())}")
        print(f"[edge] {what} {way}: lanes bit-equal to one-tenant "
              f"launches, max_abs_err={float((gs - ps).abs().max()):.3g}")
        n += 1
    return n


def linear_path(torch, ops, dev, data, n_class: int) -> None:
    """The paper's GEMM-based pair on ``data`` (train rows, labels,
    queries, labels): ``train_lr``/``train_svm`` with the JAX package's
    defaults on the card, then Fig. 4's two-phase decision on the
    queries; accuracy above 0.95, no kernel launched, and classes equal
    to the port's CPU computation on the same weights except where its
    top two scores are a near-tie (within 1e-5 + 1e-5·(|W|·|x| + |b|))."""
    from repro_torch.core import gemm_based as gb
    from repro_torch.core.distribution import two_phase_matvec
    Xtr, ytr, Xq, yq = data
    Xq_card = torch.from_numpy(Xq).to(dev)
    Xc = torch.from_numpy(Xq)
    for algo, train, predict in (("lr", gb.train_lr, gb.lr_predict_batch),
                                 ("svm", gb.train_svm,
                                  gb.svm_predict_batch)):
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = train(Xtr, ytr, n_class, steps=LINEAR_STEPS, device=dev)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        cls = predict(model, Xq)
        torch.cuda.synchronize()
        check(not any(ops.LAUNCHES.values()),
              f"{algo}: kernels ran on a path that has none: {ops.LAUNCHES}")
        check(bool(torch.isfinite(model.W).all()) and
              bool(torch.isfinite(model.b).all()),
              f"{algo}: trained weights are not finite")
        acc = float((cls.cpu().numpy() == yq).mean())
        check(acc > 0.95, f"{algo}: accuracy {acc} on the held-out queries")

        def timed(queries, reps=10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                predict(model, queries)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / reps * 1e3

        host_ms, card_ms = timed(Xq), timed(Xq_card)
        W, b = model.W.cpu(), model.b.cpu()
        odd = (cls.cpu() != predict(gb.LinearModel(W=W, b=b), Xc)).numpy()
        top2 = two_phase_matvec(W, Xc, b).topk(2, dim=1).values
        scale = (Xc.abs() @ W.abs().T + b.abs()).amax(1)
        tie = ((top2[:, 0] - top2[:, 1]).abs() <=
               TOL["atol"] + TOL["rtol"] * scale).numpy()
        check(bool(tie[odd].all()), f"{algo}: a class differs from the CPU "
              "computation on the same weights without a near-tie")
        print(f"[path] {algo}: train {LINEAR_STEPS} full-batch steps on "
              f"{len(Xtr)} x {Xtr.shape[1]}, {n_class} classes, in "
              f"{train_s:.3f}s ({1e3 * train_s / LINEAR_STEPS:.3f} ms a "
              f"step, the rows' host-to-card copy included); predict "
              f"{len(Xq)} queries at {len(Xq) / host_ms * 1e3:.1f} q/s "
              f"({host_ms:.4f} ms from host memory, {card_ms:.4f} ms from "
              f"the card); acc={acc:.4f}; no kernel on this path "
              f"(launches all 0); classes equal to the CPU computation on "
              f"the same weights but {int(odd.sum())} at near-ties")


def _agree(torch, what, algo, est, res, want, Xq, helpers) -> int:
    """Hold ``res`` (one engine's classify of ``Xq``) against ``want``
    (another's, same estimator): kNN neighbours and K-Means assignments
    equal but at fp32 near-ties of their distances, GNB scores to TOL and
    classes equal but where ``want``'s top two are a near-tie; an int8
    or ANN tier (integer work) bit for bit where ``exact`` rows are
    given.  Returns the near-tie count."""
    on_card, pair_dist = helpers["on_card"], helpers["pair_dist"]
    near, compare_ranked = helpers["near"], helpers["compare_ranked"]
    Q = on_card(Xq)
    odd = res.classes != want.classes
    if algo in ("knn", "ann"):
        rows = est.params.refs if algo == "ann" else est.params.A
        rows = rows.float()
        dk, scale = pair_dist(rows[res.aux.long().clamp(min=0)], Q)
        dp, _ = pair_dist(rows[want.aux.long().clamp(min=0)], Q)
        tie = near(dk, dp, scale) & ((res.aux < 0) == (want.aux < 0))
        n_near = compare_ranked(what, res.aux, want.aux, tie, False)
        check(bool((res.aux != want.aux).any(1)[odd].all()),
              f"{what}: a class differs without a neighbour near-tie")
        return n_near
    if algo == "kmeans":
        cen = est.params.centroids
        dk, scale = (t[:, 0] for t in pair_dist(
            cen[res.classes.long()][:, None], Q))
        dp, _ = pair_dist(cen[want.classes.long()][:, None], Q)
        n_near = compare_ranked(what, res.classes, want.classes,
                                near(dk, dp[:, 0], scale), False)
        check(bool(near(res.aux, want.aux, scale).all()),
              f"{what}: assignment distances differ")
        return n_near
    check(torch.allclose(res.aux, want.aux, **TOL),
          f"{what}: scores differ by {float((res.aux - want.aux).abs().max())}")
    top2 = want.aux.topk(2, dim=1).values
    tie = torch.isclose(top2[:, 0], top2[:, 1], **TOL)
    check(bool(tie[odd].all()), f"{what}: a class differs without a "
          "near-tie of the scores")
    return int(odd.sum())


def _count(kernels, launches, wanted, what) -> str:
    """Add a phase's launches of each wanted kernel to its count in
    ``kernels``, failing where one was never launched."""
    out = []
    for key in wanted:
        name = kernels[key]["name"]
        check(launches[name] > 0, f"{what}: kernel {key} {name} was never "
              "launched in the phase")
        kernels[key]["launches"] += launches[name]
        out.append(f"{key}={launches[name]}")
    return " ".join(out)


def _tuned_line(eng, real) -> list:
    """One entry a bucket: the winner tuned on the path's queries (µs a
    launch; * where it differs from the static arm; every arm timed),
    then the winner tuned on zeros."""
    arms = []
    for b, arm in sorted(real.tuned.items()):
        zero = eng.tuned[b]
        each = ", ".join(f"{p or 'static'} {us:.1f}"
                         for _, p, _, us in arm.candidates)
        arms.append(f"{b}: {arm.path or arm.static_path}"
                    f"{'*' if arm.differs else ''} {arm.us:.1f} (static "
                    f"{arm.static_path} {arm.static_us:.1f}; {each}; zeros: "
                    f"{zero.path or zero.static_path}"
                    f"{'*' if zero.differs else ''} {zero.us:.1f})")
    return arms


def autotune_path(torch, ops, dev, fits, queries, kernels, helpers):
    """Measured arm choice at warmup on the card: for each of
    ``AUTOTUNE`` (kNN at k = 4 and 32, K-Means, GNB, the fitted estimators
    of the paths at full width) one engine runs ``warmup_buckets(d,
    autotune=True)`` (all-zero batches, as ``serve --stream --autotune``
    does) and another ``warmup(Xq[:b], autotune=True)`` at every bucket b,
    on the path's own queries: every registered arm that measurement may
    take on the card (not ``quant``, not the plain ``ref``) a bucket, the
    least of 3 timed launches after a warm one.  Checks: every bucket
    tuned, no winner ``ref``, ``bucket_launches ⊆ warmed`` after a tuned
    classify of the queries, its classes equal the untuned engine's but at
    fp32 near-ties, and, where the query-tuned arm differs from the static
    one (and for all 4096 queries), its classify no slower than the
    untuned engine's: median of ``TUNE_REPS`` turns each, alternating, on
    the card's queries, within x ``TUNE_TOL`` + ``TUNE_SLACK_MS`` (the
    host clock's spread between launches).  B1-B5 all launched in the
    phase (counts set to 0 just before, read just after).  Prints every
    bucket's winner against the static arm in µs; returns the kNN
    k = 32 engine tuned on the queries."""
    import numpy as np
    from repro_torch.core.estimator import KNNEstimator
    from repro_torch.serving import NonNeuralServeEngine
    t_phase = time.perf_counter()
    ops.reset_launches()
    out = None
    for algo, k in AUTOTUNE:
        est = fits[algo]
        if k is not None and k != est.k:
            est = KNNEstimator.from_params(est.params, k=k, device=dev)
        what = f"{algo} k={k}" if k is not None else algo
        Xq = helpers["on_card"](queries[algo])
        d = Xq.shape[1]
        plain = NonNeuralServeEngine(est, max_batch=MAX_BATCH, device=dev)
        plain.warmup_buckets(d)
        zeros = NonNeuralServeEngine(est, max_batch=MAX_BATCH, device=dev)
        real = NonNeuralServeEngine(est, max_batch=MAX_BATCH, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = zeros.warmup_buckets(d, autotune=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for b in sorted(zeros.tuned):
            real.warmup(Xq[:b], autotune=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for eng in (zeros, real):
            check(n == len(eng.tuned) == len(eng.warmed),
                  f"autotune {what}: {n} buckets warmed, {len(eng.tuned)} "
                  "tuned")
            for b, arm in sorted(eng.tuned.items()):
                check((arm.path or arm.static_path) != "ref" and
                      all(c[1] != "ref" for c in arm.candidates) and
                      arm.bn is None and arm.strategy == "single",
                      f"autotune {what}: bucket {b} {arm}")
        res, want = real.classify(Xq), plain.classify(Xq)
        torch.cuda.synchronize()
        check(set(real.bucket_launches) <= real.warmed,
              f"autotune {what}: buckets {sorted(real.bucket_launches)} "
              f"not all warmed {sorted(real.warmed)}")
        n_near = _agree(torch, f"autotune {what}", algo, est, res, want,
                        queries[algo], helpers)
        # the tuned engine against the untuned one on the same queries
        races = [(b, Xq[:b]) for b, arm in sorted(real.tuned.items())
                 if arm.differs] + [(len(Xq), Xq)]
        raced = []
        for b, rows in races:
            ms = {"tuned": [], "untuned": []}
            for _ in range(TUNE_REPS):
                for name, eng in (("tuned", real), ("untuned", plain)):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    eng.classify(rows)
                    torch.cuda.synchronize()
                    ms[name].append((time.perf_counter() - t) * 1e3)
            tuned, untuned = (float(np.median(ms[x]))
                              for x in ("tuned", "untuned"))
            check(tuned <= untuned * TUNE_TOL + TUNE_SLACK_MS,
                  f"autotune {what}: the tuned classify of {b} queries "
                  f"took {tuned:.4f} ms against {untuned:.4f} untuned")
            raced.append(f"{b}: {tuned:.4f} / {untuned:.4f}")
        arms = " | ".join(_tuned_line(zeros, real))
        print(f"[autotune] {what}: {n} buckets tuned on zeros in "
              f"{t1 - t0:.2f}s and on the queries in {t2 - t1:.2f}s; "
              f"winner tuned on the queries against the static arm in us "
              f"a launch (* = differs; then every arm timed; then the "
              f"winner tuned on zeros): {arms}; a tuned classify of "
              f"{len(Xq)} equals the untuned engine's but {n_near} "
              f"near-ties; tuned / untuned classify "
              f"ms (median of {TUNE_REPS}, queries on the card) at "
              f"{'; '.join(raced)}")
        if (algo, k) == ("knn", 32):
            out = real
    launches = dict(ops.LAUNCHES)
    counts = _count(kernels, launches, ("B1", "B2", "B3", "B4", "B5"),
                    "autotune")
    print(f"[autotune] phase in {time.perf_counter() - t_phase:.2f}s; "
          f"launches {counts}")
    return out


def calibrate_path(torch, ops, dev, eng, Xq, kernels) -> None:
    """The calibrated selector on the card's own numbers: the kNN k = 32
    engine's autotune timings on the path's queries become calibration
    rows (µs a query, the
    estimator's ``serve_cost_shape()``, the bucket, the arm), go through
    ``fit_calibration`` and ``CostModel.from_calibration``, and the model
    is installed with ``set_cost_model``.  Checks that ``resolve`` at
    every tuned bucket then takes the arm measured fastest there (1024
    among them), that a fresh untuned engine launches those arms' kernels
    (B1, or B4 and B5) for a classify of the queries (buckets of 1024)
    and of their first 100 (a bucket of 128), and that clearing the model
    restores the static selector."""
    from repro_torch.core import calibrate, precision
    from repro_torch.kernels import dispatch
    from repro_torch.serving import NonNeuralServeEngine
    t_phase = time.perf_counter()
    est = eng.estimator
    shape = est.serve_cost_shape()
    rows, fastest = [], {}
    for b, arm in sorted(eng.tuned.items()):
        for _, p, _, us in arm.candidates:
            path = p or arm.static_path
            rows.append({"tier": precision.tier_for("fp32", path=path),
                         "algorithm": "knn", "op": dispatch.HOT_OPS["knn"],
                         "bucket": b, "path": path, "measured_us": us / b,
                         "shape": shape})
        fastest[b] = min(arm.candidates, key=lambda c: c[3])[1] or \
            arm.static_path
    fit = calibrate.fit_calibration(rows)
    cm = precision.CostModel.from_calibration(fit)
    kw = dict(N=shape["N"], d=shape["d"])

    def arm_at(q, k=shape["k"]):
        return dispatch.resolve("knn", "distance_topk", Q=q, k=k,
                                device=dev, **kw).name

    static = {b: arm_at(b) for b in fastest}
    dispatch.set_cost_model(cm)
    try:
        got = {b: arm_at(b) for b in fastest}
        got4 = {b: arm_at(b, 4) for b in fastest}
        check(got == fastest,
              f"calibrate: resolve takes {got}, the measured fastest are "
              f"{fastest}")
        fresh = NonNeuralServeEngine(est, max_batch=MAX_BATCH, device=dev)
        fresh.warmup_buckets(shape["d"])
        torch.cuda.synchronize()
        launches = {}
        for rows_q in (Xq, Xq[:100]):
            ops.reset_launches()
            res = fresh.classify(rows_q)
            torch.cuda.synchronize()
            b = fresh._bucket(len(rows_q))
            launches[b] = (res.launches, dict(ops.LAUNCHES))
    finally:
        dispatch.set_cost_model(None)
    for b, (n_b, ln) in launches.items():
        want = {"fused": (n_b, 0), "blocked": (0, n_b)}[fastest[b]]
        check((ln["distance_topk"], ln["pairwise_sq_dist"]) == want and
              ln["pairwise_sq_dist"] == ln["topk_smallest"],
              f"calibrate: {n_b} buckets of {b} under the model launched "
              f"{ln}, expected B1/B4 {want}")
        for key, name in (("B1", "distance_topk"),
                          ("B4", "pairwise_sq_dist"),
                          ("B5", "topk_smallest")):
            kernels[key]["launches"] += ln[name]
    check({b: arm_at(b) for b in fastest} == static,
          "calibrate: clearing the model did not restore the selector")
    tiers = "; ".join(f"{t} median |rel err| {s['median_abs_rel_err']:.3f} "
                      f"over {s['n']} rows" for t, s in
                      fit["summary"]["tiers"].items())
    flips = {b: a for b, a in got.items() if a != static[b]}
    print(f"[calibrate] {len(rows)} rows from the knn k={shape['k']} "
          f"autotune timings on the queries (N={shape['N']}, d={shape['d']}); {tiers}; "
          f"us_per_cycle {fit['summary']['us_per_cycle']:.4e}; calibrated "
          f"resolve takes the measured fastest arm at every bucket, "
          f"{got[MAX_BATCH]} at {MAX_BATCH}, flipping the static selector "
          f"at {flips or 'none'}; at k=4 the same buckets resolve to "
          f"{got4} (the model keys on (algorithm, bucket)); a fresh "
          f"engine's classify launched "
          + "; ".join(f"{n} buckets of {b}: B1 {ln['distance_topk']}, B4 "
                      f"{ln['pairwise_sq_dist']}, B5 {ln['topk_smallest']}"
                      for b, (n, ln) in launches.items())
          + f"; model cleared, static selector again; phase in "
          f"{time.perf_counter() - t_phase:.2f}s")


def _median_ms(torch, fn, reps: int) -> float:
    """Median host time (ms) of ``reps`` calls of ``fn``, each ended by a
    synchronize."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(sorted(times)[reps // 2])


def ladder_path(torch, ops, dev, fits, queries, kernels, helpers) -> None:
    """The brownout ladder on the card, in two parts, with the launch
    counts set to 0 before (a) and read after (b)'s replay.

    (a) Each rung's capacity factor at the paths' shapes (int8 on kNN,
    K-Means and GNB, ANN on kNN at N = 2^20): the largest power of two f
    up to ``LADDER["fmax"]`` for which one ``classify`` of f x 1024 rows
    (from host memory) through the rung takes no longer than one of 1024
    through tier 0, the median of ``LADDER["reps"]`` host-clock timings of
    each; printed beside ``CAPACITY_FACTORS``.

    (b) A seeded Poisson trace of fresh rows above one fp32 drain's
    capacity through the kNN scheduler with ``DegradePolicy(build_ladder(
    engine, d, capacity_factors=LADDER["factors"]), deadline)``, so that
    every rung exists, then a probe sending every 16th row again through
    an LRU that holds every row.  Checks: a downshift; every tier's
    ``bucket_launches ⊆`` its ``warmed``; every answer equal to that tier
    engine's one-shot ``classify`` of the same rows (the int8 tier bit for
    bit, fp32 and ANN but at near-ties of their exact distances); a probe
    row hits the cache if and only if tier 0 served it, with that answer
    bit for bit (no degraded answer cached); the ANN tier's labels
    agreeing with exact kNN on >= 0.95 of the queries; B1, B2, B6, B7 and
    B8 all launched in the phase."""
    import numpy as np

    from repro_torch.data.datasets import class_blobs
    from repro_torch.serving import (ClassifyResult, DegradePolicy,
                                     NonNeuralServeEngine, RequestScheduler,
                                     build_ladder, poisson_trace,
                                     replay_trace)
    from repro_torch.serving import degrade as deg
    t_phase = time.perf_counter()
    card = smi()
    reps, fmax = LADDER["reps"], LADDER["fmax"]
    ops.reset_launches()

    # (a) capacity factors
    def factor(tier0, rung, rows):
        tier0.warmup(rows[:MAX_BATCH])
        base = _median_ms(torch, lambda: tier0.classify(rows[:MAX_BATCH]),
                          reps)
        best, readings, f = 1, [], 1
        while f <= fmax:
            chunk = rows[:f * MAX_BATCH]
            rung.warmup(chunk)
            ms = _median_ms(torch, lambda: rung.classify(chunk), reps)
            readings.append(f"{f * MAX_BATCH}: {ms:.4f} ms ({ms / base:.3f}"
                            f"x)")
            if ms <= base:
                best = f
            f *= 2
        return best, base, readings

    measured = {}
    for algo in ("knn", "kmeans", "gnb"):
        rows = np.concatenate([queries[algo]] * (
            -(-fmax * MAX_BATCH // len(queries[algo]))))
        tier0 = NonNeuralServeEngine(fits[algo], max_batch=MAX_BATCH,
                                     device=dev)
        rungs = [("int8", tier0.sibling(policy="int8",
                                        max_batch=fmax * MAX_BATCH))]
        if algo == "knn":
            t0 = time.perf_counter()
            ann = deg.ann_sibling(tier0, max_batch=fmax * MAX_BATCH)
            torch.cuda.synchronize()
            s = ann.estimator.serve_cost_shape()
            print(f"[ladder] ann rung of knn: IVF-PQ fit from params.A in "
                  f"{time.perf_counter() - t0:.2f}s: {s['C']} cells, nprobe "
                  f"{ann.estimator.nprobe}, pq_m {s['m']}, refine "
                  f"{ann.estimator.refine}, L = {s['L']} candidates a "
                  f"query, so {fmax * MAX_BATCH * s['L'] * s['m'] / 2**20:.0f}"
                  f" MiB of candidate codes (and "
                  f"{fmax * MAX_BATCH * s['L'] * 8 / 2**20:.0f} MiB of int64 "
                  f"ids) at {fmax * MAX_BATCH} rows")
            rungs.append(("ann", ann))
        for rung, eng in rungs:
            f, base, readings = factor(tier0, eng, rows)
            measured[(rung, algo)] = f
            table = deg.CAPACITY_FACTORS.get((rung, algo))
            print(f"[ladder] capacity {rung} {algo}: x{f} (tier 0, "
                  f"{MAX_BATCH} rows: {base:.4f} ms; the rung at "
                  f"{'; '.join(readings)}; median of {reps}, host clock, "
                  f"rows from host memory); CAPACITY_FACTORS holds "
                  f"x{table}")
        del tier0, rungs
    torch.cuda.empty_cache()

    # (b) a replay down the ladder: fresh rows once each, then a probe
    # sending every 16th of them again
    Xq = queries["knn"]
    d = Xq.shape[1]
    eng = NonNeuralServeEngine(fits["knn"], max_batch=MAX_BATCH, device=dev)
    eng.warmup_buckets(d)
    tiers = build_ladder(eng, d, capacity_factors=LADDER["factors"])
    check([(t.name, t.capacity_factor) for t in tiers] ==
          [("full", 1)] + list(LADDER["factors"].items()),
          f"ladder: built {[(t.name, t.capacity_factor) for t in tiers]}")
    counts = np.concatenate([poisson_trace(r, t, seed=SEED + i) for i, (r, t)
                             in enumerate(LADDER["trace"])])
    n1 = int(counts.sum())
    fresh = class_blobs(n=n1, d=d, n_class=int(fits["knn"].params.n_class),
                        seed=SEED + 5)[0]
    probe = np.arange(0, n1, LADDER["probe_every"])
    rate = LADDER["probe_rate"]
    counts = np.concatenate([counts, np.full(len(probe) // rate, rate),
                             [len(probe) % rate]]).astype(np.int64)
    rows_sent = np.concatenate([fresh, fresh[probe]])
    pol = DegradePolicy(tiers, deadline=LADDER["deadline"])
    sched = RequestScheduler(eng, max_wait=LADDER["max_wait"],
                             cache_size=len(rows_sent),
                             max_queue=LADDER["max_queue"],
                             shed_expired=True, degrade=pol)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = replay_trace(sched, rows_sent, counts, deadline=LADDER["deadline"])
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    st = sched.stats
    check(st.downshifts >= 1, f"ladder: no downshift ({st.summary()})")
    check(len(ids) == int(counts.sum()) == len(rows_sent) == st.finished,
          f"ladder: {len(ids)} requests, {st.finished} finished")
    for t in tiers:
        check(set(t.engine.bucket_launches) <= t.engine.warmed and
              set(st.tier_bucket_launches.get(t.name, {})) <=
              sched.tier_warmed[t.name],
              f"ladder: tier {t.name} ran buckets "
              f"{sorted(t.engine.bucket_launches)} outside "
              f"{sorted(t.engine.warmed)}")
    # every answer against its tier engine's one-shot classify
    res = [sched.results[i] for i in ids]
    by_tier = {}
    for j, r in enumerate(res):
        if not r.shed and not r.cache_hit:
            by_tier.setdefault(r.tier, []).append(j)
    near_ties = {}
    for t in tiers:
        got_ids = by_tier.get(t.name, [])
        if not got_ids:
            continue
        rows = rows_sent[got_ids]
        one = t.engine.classify(rows)
        got = ClassifyResult(
            classes=torch.tensor([res[i].prediction for i in got_ids],
                                 dtype=one.classes.dtype, device=dev),
            aux=torch.from_numpy(np.stack([res[i].aux for i in got_ids]))
            .to(dev), launches=0, algorithm=t.engine.algorithm)
        if t.name == "int8":
            check(torch.equal(got.classes, one.classes) and
                  torch.equal(got.aux, one.aux),
                  "ladder: an int8-tier answer differs from that engine's "
                  "one-shot classify")
            near_ties[t.name] = 0
        else:
            near_ties[t.name] = _agree(
                torch, f"ladder tier {t.name}", t.engine.algorithm,
                t.engine.estimator, got, one, rows, helpers)
    # no degraded answer is cached: a probe row hits if and only if tier 0
    # served it in the first pass, and then with that answer bit for bit
    check(not any(r.cache_hit for r in res[:n1]),
          "ladder: a first-pass row hit the cache")
    hits = miss_degraded = 0
    for j, r in zip(probe, res[n1:]):
        first = res[j]
        at_full = not first.shed and first.tier == "full"
        check(r.cache_hit == at_full,
              f"ladder: probe of row {j} (first served "
              f"{'shed' if first.shed else first.tier}) "
              f"{'hit' if r.cache_hit else 'missed'} the cache")
        if at_full:
            hits += 1
            check(r.prediction == first.prediction and
                  np.array_equal(r.aux, first.aux),
                  f"ladder: probe of row {j} hit an answer unlike tier 0's")
        elif not first.shed:
            miss_degraded += 1
    check(miss_degraded > 0, "ladder: no probe row was first served by a "
          "degraded tier")
    ann_tier = next(t for t in tiers if t.name == "ann")
    exact = eng.classify(Xq).classes
    agree = float((ann_tier.engine.classify(Xq).classes == exact)
                  .float().mean())
    check(agree >= 0.95, f"ladder: the ANN tier agrees with exact kNN on "
          f"{agree} of the labels")
    counted = _count(kernels, launches, ("B1", "B2", "B6", "B7", "B8"),
                     "ladder")
    s = st.summary()
    print(f"[ladder] stream knn: trace {LADDER['trace']} (rate, ticks) of "
          f"{n1} fresh rows, then every {LADDER['probe_every']}th again at "
          f"{rate} a tick; {len(ids)} requests in {wall:.3f}s "
          f"({len(ids) / wall:.1f} "
          f"req/s); ladder "
          + " -> ".join(f"{t.name} (x{t.capacity_factor})" for t in tiers)
          + f"; downshifts {st.downshifts}, upshifts {st.upshifts}; served "
          f"by tier {dict(st.tier_served)}; shed {st.shed} "
          f"{dict(st.shed_reasons)}; probe of {len(probe)} rows: {hits} "
          f"hits, each a tier-0 answer of the first pass, {miss_degraded} "
          f"misses of rows a degraded tier served; p50 {s['p50']:.0f} p95 "
          f"{s['p95']:.0f} ticks, "
          f"deadline misses {s['deadline_miss_rate']:.4f}; answers equal "
          f"to each tier's one-shot classify but near-ties {near_ties}; "
          f"ANN labels agree with exact kNN on {agree:.4f}")
    print(f"[ladder] measured factors {{"
          + ", ".join(f"{k}: {v}" for k, v in measured.items())
          + f"}}; launches {counted}; phase in "
          f"{time.perf_counter() - t_phase:.2f}s; {card}")


def _shard_fit_check(torch, what, algo, sh, one) -> str:
    """A sharded fit's params against the one-device fit's: kNN (its rows
    past the real ones the far padding) and RF bit for bit, K-Means, GNB,
    GMM and ANN floats to ``SHARD_FIT_TOL`` (ANN's integer leaves
    exactly); loop metadata aside."""
    from repro_torch.core.cluster import _FAR
    worst = 0.0
    for name, got, want in zip(one.params._fields, sh.params, one.params):
        if not isinstance(want, torch.Tensor):
            check(got == want, f"{what}: fit_sharded {name} {got} != {want}")
            continue
        if name in ("shift", "n_iter", "log_lik"):
            continue
        if algo == "knn" and name == "A":
            n = want.shape[0]
            check(bool((got[n:] == _FAR).all()),
                  f"{what}: the kNN residency rows are not the far rows")
            got = got[:n]
        check(got.shape == want.shape, f"{what}: fit_sharded {name} "
              f"{tuple(got.shape)} against {tuple(want.shape)}")
        if algo in ("knn", "rf") or not want.is_floating_point():
            check(torch.equal(got, want), f"{what}: fit_sharded {name} "
                  "differs from the one-device fit")
        else:
            check(torch.allclose(got, want, **SHARD_FIT_TOL),
                  f"{what}: fit_sharded {name} differs from the one-device "
                  f"fit by {float((got - want).abs().max())}")
            worst = max(worst, float((got - want).abs().max()))
    return "bit-equal" if algo in ("knn", "rf") else \
        f"within {SHARD_FIT_TOL['rtol']} (max |diff| {worst:.3g})"


def sharded_path(torch, ops, dev, fits, data, kernels, helpers, sms):
    """The sharded layer (``core/cluster.py``) on the card: for each of
    ``SHARDED_CASES`` and each shard count c of ``SHARDED["meshes"]``
    (c = 8, a power of two, the butterfly merge; c = 3, ragged, the gather
    merge and shard-multiple buckets), over ``make_local_mesh(c, card)``:

    1. ``make_fitted(..., mesh=...)`` (``fit_sharded``) on the path's
       training rows, its params held against the path's one-device fit
       (``fits``): kNN and RF bit for bit, K-Means, GNB, GMM and ANN
       within ``SHARD_FIT_TOL``; the K-Means fit's B2 launches are c a
       Lloyd step.  The int8 cases serve the one-device fits' quantized
       copies (``policy="int8"``: the tier fits on one device);
    2. one ``classify`` of ``MAX_BATCH`` + ``SHARDED["ragged"]`` queries
       (a full bucket and a ragged one) through
       ``NonNeuralServeEngine(mesh=...)`` under each registered strategy
       and ``auto`` (the int8 cases: ``query`` and ``auto``; their
       ``reference`` must refuse), launch counts set to 0 just before and
       read just after: each kernel of the case launched c times a bucket
       under a sharded strategy (once a bucket ``auto`` sent to
       ``single``), no other kernel; classes and neighbours equal to the
       one-device engine's on the same estimator and queries, integer aux
       bit for bit, float aux bit for bit under ``query`` where the
       shard's kernel plan is the one-device bucket's (B3's plan splits a
       query's features over warps by the batch) and within
       ``SHARD_AUX_TOL`` otherwise (a model partition, or another B3
       plan), as ``tests/test_mesh_parity.py`` allows;
    3. at c = 8, the ms of one ``MAX_BATCH`` classify a strategy beside
       the one-device engine's (c = 1): the median of
       ``SHARDED["time_reps"]``, host clock, queries on the card
       (information, not a claim);
    4. at c = 8, autotune with the strategy axis on the path's queries
       (``warmup(Xq[:b], autotune=True)`` at each of
       ``SHARDED["tune_buckets"]``): the JAX package's candidates (the
       static strategy and ``single`` with each path; a sharded strategy
       with the estimator's own path, which the JAX list adds only where
       the path axis is closed), never ``ref`` timed or chosen on the
       card, ``bn`` None, the tuned classify's classes the one-device
       engine's;
    5. at c = 3, a seeded Poisson stream (``SHARDED["stream"]``) through
       ``RequestScheduler`` on the sharded kNN engine (every bucket
       warmed, up to 1026), each request's prediction the one-device
       engine's, no bucket run that was not warmed before the stream.

    B1-B8 each launched in the counted runs (their counts added to
    ``kernels``); prints a ``[sharded]`` line a case and mesh, the
    ``[sharded/time]``, ``[sharded/autotune]`` and ``[sharded/stream]``
    lines and the card."""
    import numpy as np
    from repro_torch.core.estimator import KNNEstimator, make_fitted
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import gnb_score as kgs
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.serving import (NonNeuralServeEngine, RequestScheduler,
                                     poisson_trace, replay_trace)
    on_card = helpers["on_card"]
    t_phase = time.perf_counter()
    names = {key: kr["name"] for key, kr in kernels.items()
             if key in ("B1", "B2", "B3", "B4", "B5", "B6", "B7", "B8")}
    counted = dict.fromkeys(names.values(), 0)
    fit_kw = {
        "knn": dict(n_groups=KNN["classes"], k=KNN["k"]),
        "kmeans": dict(n_groups=KMEANS["K"]),
        "gnb": dict(n_groups=GNB["classes"]),
        "gmm": dict(n_groups=GNB["classes"]),
        "rf": dict(n_groups=KNN["classes"], n_trees=RF["trees"],
                   max_depth=RF["depth"]),
        "ann": dict(n_groups=ANN["classes"], k=ANN["k"],
                    n_cells=ANN["cells"], nprobe=ANN["nprobe"],
                    pq_m=ANN["pq_m"], n_codes=ANN["n_codes"],
                    refine=ANN["refine"], train_iters=ANN["train_iters"])}
    queries = {algo: on_card(d[2]) for algo, d in data.items()}
    n_rows = MAX_BATCH + SHARDED["ragged"]

    def counted_run(fn):
        ops.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        ln = {name: ops.LAUNCHES[name] for name in counted}
        for name, n in ln.items():
            counted[name] += n
        return out, ln

    chunks = [min(MAX_BATCH, n_rows - lo)
              for lo in range(0, n_rows, MAX_BATCH)]

    def b3_plans_differ(eng, one, est, c):
        """Whether a shard's B3 plan differs from the one-device bucket's
        for some chunk of the counted run (then a score's feature sums
        run in another order)."""
        C, d = est.params.mu.shape
        return any(kgs.plan(eng._bucket(n) // c, C, d, sms)
                   != kgs.plan(one._bucket(n), C, d, sms) for n in chunks)

    sharded_fits = {}
    timing = {}
    for c in SHARDED["meshes"]:
        mesh = make_local_mesh(c, dev)
        for what, algo, per in SHARDED_CASES:
            int8 = what.endswith("int8")
            Q = queries[algo][:n_rows]
            fit_note = ""
            if int8:
                est = fits[algo]
            elif what == "knn k=64":
                est = KNNEstimator.from_params(sharded_fits[(c, "knn")].params,
                                               k=KNN_BLOCKED_K, device=dev)
            else:
                Xtr, ytr = data[algo][:2]
                ops.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                est = make_fitted(algo, Xtr, ytr, device=dev, mesh=mesh,
                                  **fit_kw[algo])
                torch.cuda.synchronize()
                fit_s = time.perf_counter() - t0
                check(est.mesh is mesh, f"{what} c={c}: fit_sharded kept "
                      "no mesh")
                sharded_fits[(c, algo)] = est
                fit_note = (f"fit_sharded {fit_s:.2f}s, params "
                            f"{_shard_fit_check(torch, f'{what} c={c}', algo, est, fits[algo])}")
                if algo == "kmeans":
                    steps = int(est.params.n_iter) + 1
                    n_b2 = ops.LAUNCHES["distance_argmin"]
                    check(n_b2 == c * steps, f"kmeans c={c}: fit_sharded "
                          f"launched B2 {n_b2} times for {steps} steps")
                    fit_note += f", B2 {n_b2} = {c} x {steps} Lloyd steps"
            policy = "int8" if int8 else None
            one = NonNeuralServeEngine(est, max_batch=MAX_BATCH, device=dev,
                                       policy=policy)
            one.warmup(Q)
            want = one.classify(Q)
            torch.cuda.synchronize()
            regd = sorted(st for a, _, st in dispatch.sharded_registered()
                          if a == algo)
            if int8:
                regd = [s for s in regd if s != "reference"]
                try:
                    NonNeuralServeEngine(est, max_batch=MAX_BATCH,
                                         device=dev, mesh=mesh,
                                         policy="int8", strategy="reference")
                    refused = False
                except NotImplementedError:
                    refused = True
                check(refused, f"{what} c={c}: int8 + reference served")
            parts = []
            for strat in regd + ["auto"]:
                eng = NonNeuralServeEngine(
                    est, max_batch=MAX_BATCH, device=dev, mesh=mesh,
                    policy=policy, strategy=None if strat == "auto" else strat)
                eng.warmup(Q)
                warmed = set(eng.warmed)
                res, ln = counted_run(lambda: eng.classify(Q))
                tag = f"{what} c={c} {strat}"
                buckets = sorted(eng.bucket_launches)
                check(set(buckets) <= warmed and
                      sum(eng.bucket_launches.values()) == len(chunks) and
                      all(b % c == 0 for b in buckets),
                      f"{tag}: buckets {eng.bucket_launches}, warmed "
                      f"{sorted(warmed)}")
                used = [eng.bucket_strategies[b] for b in buckets]
                shards = sum(n * (1 if eng.bucket_strategies[b] == "single"
                                  else c)
                             for b, n in eng.bucket_launches.items())
                for key, name in names.items():
                    want_n = shards * per.get(key, 0)
                    check(ln[name] == want_n, f"{tag}: {key} {name} "
                          f"launched {ln[name]} times, {want_n} expected "
                          f"({shards} shard launches over the buckets "
                          f"{dict(zip(buckets, used))})")
                check(torch.equal(res.classes, want.classes),
                      f"{tag}: {int((res.classes != want.classes).sum())} "
                      "classes differ from the one-device engine's")
                exact = True
                if res.aux.is_floating_point() and algo in ("kmeans", "gnb",
                                                            "gmm"):
                    exact = "reference" not in used and not (
                        algo in ("gnb", "gmm") and "query" in used and
                        b3_plans_differ(eng, one, est, c))
                if exact:
                    check(torch.equal(res.aux, want.aux), f"{tag}: aux not "
                          "bit-equal to the one-device engine's")
                    agree = "bit-equal"
                else:
                    diff = float((res.aux - want.aux).abs().max())
                    check(torch.allclose(res.aux, want.aux, **SHARD_AUX_TOL),
                          f"{tag}: aux differs by {diff}")
                    agree = f"aux within 1e-4 ({diff:.3g})"
                launched = " ".join(f"{k}={ln[names[k]]}" for k in per) \
                    or "no kernel"
                parts.append(f"{strat} {'/'.join(used)}: {launched}, "
                             f"{agree}")
                if c == 8:
                    Q1 = queries[algo][:MAX_BATCH]
                    if what not in timing:
                        timing[what] = {"c=1": _median_ms(
                            torch, lambda: one.classify(Q1),
                            SHARDED["time_reps"])}
                    timing[what][strat] = _median_ms(
                        torch, lambda: eng.classify(Q1), SHARDED["time_reps"])
            print(f"[sharded] {what} c={c}: {fit_note + '; ' if fit_note else ''}"
                  f"{n_rows} queries in buckets {buckets}, classes equal to "
                  f"the one-device engine's; " + "; ".join(parts))
    card = smi()
    for what, ms in timing.items():
        print(f"[sharded/time] {what}: one {MAX_BATCH} classify, ms "
              "(median, host clock, queries on the card): "
              + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
              + f"; {card}")

    # autotune with the strategy axis at c = 8, on the paths' queries
    mesh = make_local_mesh(8, dev)
    tuned_lines = []
    ops.reset_launches()
    for algo in ("knn", "kmeans", "gnb", "gmm", "rf", "ann"):
        est = sharded_fits[(8, algo)]
        Xq = queries[algo]
        eng = NonNeuralServeEngine(est, max_batch=MAX_BATCH, device=dev,
                                   mesh=mesh)
        one = NonNeuralServeEngine(est, max_batch=MAX_BATCH, device=dev)
        for b in SHARDED["tune_buckets"]:
            eng.warmup(Xq[:b], autotune=True)
        arms = []
        for b, arm in sorted(eng.tuned.items()):
            check(arm.path != "ref" and arm.bn is None and
                  all(cand[1] != "ref" for cand in arm.candidates),
                  f"sharded autotune {algo}: bucket {b} {arm}")
            strategies = sorted({cand[0] for cand in arm.candidates})
            check({"single", arm.static_strategy} <= set(strategies),
                  f"sharded autotune {algo}: bucket {b} timed only "
                  f"{strategies}")
            arms.append(f"{b}: {arm.strategy}/{arm.path or arm.static_path}"
                        f"{'*' if arm.differs else ''} {arm.us:.1f} (static "
                        f"{arm.static_strategy}/{arm.static_path} "
                        f"{arm.static_us:.1f}; timed {strategies})")
        Q = Xq[:n_rows]
        res = eng.classify(Q)
        check(set(eng.bucket_launches) <= eng.warmed and torch.equal(
            res.classes, one.classify(Q).classes),
            f"sharded autotune {algo}: tuned classify differs or ran an "
            "unwarmed bucket")
        tuned_lines.append(f"{algo} " + ", ".join(arms))
    for name in counted:
        counted[name] += ops.LAUNCHES[name]
    print("[sharded/autotune] c=8, tuned on the queries, winner "
          "strategy/path us a launch (* = differs from static): "
          + " | ".join(tuned_lines))

    # a request stream on the ragged mesh
    est = sharded_fits[(3, "knn")]
    Xq = queries["knn"]
    eng = NonNeuralServeEngine(est, max_batch=MAX_BATCH, device=dev,
                               mesh=make_local_mesh(3, dev))
    one = NonNeuralServeEngine(est, max_batch=MAX_BATCH, device=dev)
    n_warm = eng.warmup_buckets(Xq.shape[1])
    check(eng.bucket_launches == {}, "sharded stream: warmup counted")
    sched = RequestScheduler(eng, max_wait=SHARDED["stream"]["max_wait"])
    counts = poisson_trace(SHARDED["stream"]["rate"],
                           SHARDED["stream"]["ticks"], seed=SEED)
    rows = Xq.cpu().numpy()
    t0 = time.perf_counter()
    (ids, _), ln = counted_run(lambda: (replay_trace(sched, rows, counts),
                                        None))
    wall = time.perf_counter() - t0
    Qs = Xq[torch.as_tensor(np.arange(len(ids)) % len(rows))]
    want = one.classify(Qs).classes.cpu().numpy()
    got = np.array([int(sched.results[i].prediction) for i in ids])
    check(np.array_equal(got, want), f"sharded stream: "
          f"{int((got != want).sum())} predictions differ from the "
          "one-device engine's")
    check(set(eng.bucket_launches) <= sched.warmed,
          f"sharded stream: buckets {sorted(eng.bucket_launches)} not all "
          f"warmed {sorted(sched.warmed)}")
    s = sched.stats.summary()
    print(f"[sharded/stream] knn c=3: {len(ids)} requests in {wall:.3f}s "
          f"({len(ids) / wall:.0f} req/s, host clock), {s['launches']} "
          f"launches over buckets {dict(sorted(eng.bucket_launches.items()))}"
          f" (routes {dict(sorted(eng.bucket_strategies.items()))}; "
          f"{n_warm} buckets warmed, the top one "
          f"{max(sched.warmed)}), B1 launches {ln['distance_topk']}; "
          f"p50 {s['p50']:.0f} p95 {s['p95']:.0f} ticks; predictions equal "
          "to the one-device engine's")
    counts_line = _count(kernels, counted, tuple(names), "sharded")
    print(f"[sharded] phase in {time.perf_counter() - t_phase:.2f}s; "
          f"launches {counts_line}; {card}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device is visible: this script measures the card",
              file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"{ROOT} does not hold src/repro_torch: run this script from "
              "a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))

    import numpy as np

    from repro_torch.core import estimator as est_mod
    from repro_torch.core.gnb import fit_gnb
    from repro_torch.data.datasets import class_blobs
    from repro_torch.kernels import _build, dispatch, ops, ref
    from repro_torch.kernels.distance_topk import TOPK_K_MAX
    from repro_torch.serving import NonNeuralServeEngine

    dev = torch.device(DEVICE)
    card = smi()
    name = torch.cuda.get_device_name(0)
    variant, peaks = card_peaks(name)
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name} sms "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} "
          f"(bounds from the H100 {variant} peaks: fp32 "
          f"{peaks[0] / 1e12:g} TFLOP/s, {peaks[1] / 1e12:g} TB/s, int8 "
          f"tensor cores {peaks[2] / 1e12:g} TOP/s)")
    check(not torch.backends.cuda.matmul.allow_tf32 and
          not torch.backends.cudnn.allow_tf32,
          "TF32 is on: the plain versions and the GMM/GNB scores must run "
          "in full fp32")

    # ------------------------------------------------ 1. build the kernels
    t0 = time.perf_counter()
    libs = _build.build_all()
    for stem in libs:
        _build.library(stem)
    print(f"[build] {len(libs)} libraries from "
          f"{[p.name for p in _build.sources()]} in "
          f"{time.perf_counter() - t0:.2f}s (nvcc {_build.build_seconds:.2f}s)")
    for stem, log in _build.logs().items():
        kernel = ""
        for line in log.splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:       # the mangled name past the file's namespace
                kernel = re.sub(r"^_ZN\w*?_cu_[0-9a-f]{8}", "",
                                entry.group(1))[:40]
            elif "Used" in line or "spill" in line:
                print(f"[ptxas] {stem} {kernel}: {line.strip()}")

    # ------------------------------------------------ data of the main path
    def blobs(n, d, classes, seed):
        X, y = class_blobs(n=n + N_QUERIES, d=d, n_class=classes, seed=seed)
        return X[:n], y[:n], X[n:], y[n:]

    t0 = time.perf_counter()
    knn_data = blobs(KNN["n"], KNN["d"], KNN["classes"], SEED)
    km_data = blobs(KMEANS["n"], KMEANS["d"], KMEANS["K"], SEED + 1)
    gnb_data = blobs(GNB["n"], GNB["d"], GNB["classes"], SEED + 2)
    print(f"[data] seeded blobs in {time.perf_counter() - t0:.2f}s")
    gen = torch.Generator().manual_seed(SEED)

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def rand(shape, ints: bool):
        """Normal data, or small integers drawn with repetition (exact
        distances, exact ties between equal rows)."""
        if ints:
            return torch.randint(-2, 3, shape, generator=gen).float().to(dev)
        return torch.randn(shape, generator=gen).to(dev)

    def pair_dist(rows, q):
        """Distances of gathered rows (Q, m, d) to queries (Q, d) by the
        kernels' expansion, elementwise, and the scale ‖a‖² + ‖c‖² of the
        expansion's terms."""
        an = (rows * rows).sum(-1)
        cn = (q * q).sum(-1)[:, None]
        return an - 2.0 * (rows * q[:, None]).sum(-1) + cn, an + cn

    def near(got, want, scale):
        """|got - want| <= atol + rtol * scale.  A distance computed as
        ‖a‖² − 2a·c + ‖c‖² carries the rounding of its terms, so its error
        grows with ‖a‖² + ‖c‖², not with the distance: on the blob data
        (centres spread 3, d = 21) the terms are about 500 while nearest
        distances are about 8, and two correct fp32 evaluations of the
        same expansion differ by ~1e-4."""
        return (got - want).abs() <= TOL["atol"] + TOL["rtol"] * scale

    def compare_ranked(what, got_idx, want_idx, agree, exact):
        """Indices equal, except at a rank where the two rows' distances
        agree (``agree``, a near-tie); returns that count."""
        differ = got_idx != want_idx
        check(bool((~differ | agree).all()),
              f"{what}: {int((differ & ~agree).sum())} ranks pick a row "
              f"whose distance differs from the plain version's")
        n_near = int(differ.sum())
        check(not (exact and n_near), f"{what}: {n_near} index mismatches "
              f"on integer data, where every distance is exact")
        return n_near

    # ------------------------------------- 2. kernels against plain versions
    def topk_case(A, C, k, exact, what, chunk=128, dtype=torch.float32):
        A, C = A.to(dtype), C.to(dtype)
        kv, ki = ops.distance_topk(A, C, k)
        torch.cuda.synchronize()
        parts = [ref.distance_topk(A, C[i:i + chunk], k)
                 for i in range(0, C.shape[0], chunk)]
        A, C = A.float(), C.float()   # bf16 inputs meet the kernel upcast
        pv = torch.cat([p[0] for p in parts])
        pi = torch.cat([p[1] for p in parts])
        check(kv.shape == pv.shape and ki.dtype == torch.int32,
              f"{what}: shapes {tuple(kv.shape)} {ki.dtype}")
        dk, scale = pair_dist(A[ki.long()], C)
        check(bool(near(kv, pv, scale).all()),
              f"{what}: values differ by {float((kv - pv).abs().max())}")
        srt = ki.sort(dim=1).values
        check(bool((srt[:, 1:] != srt[:, :-1]).all()),
              f"{what}: a row appears twice in one query's list")
        check(bool(near(dk, kv, scale).all()),
              f"{what}: a value does not belong to its row")
        tied = kv[:, 1:] == kv[:, :-1]
        check(bool((ki[:, 1:] > ki[:, :-1])[tied].all()),
              f"{what}: an exact tie is not broken to the smallest row")
        dp, _ = pair_dist(A[pi.long()], C)
        n_near = compare_ranked(what, ki, pi, near(dk, dp, scale), exact)
        return float((kv - pv).abs().max()), n_near

    def argmin_case(A, C, exact, what):
        kv, ki = ops.distance_argmin(A, C)
        pv, pi = ref.distance_argmin(A, C)
        torch.cuda.synchronize()
        dk, scale = (t[:, 0] for t in pair_dist(C[ki.long()][:, None], A))
        dp, _ = pair_dist(C[pi.long()][:, None], A)
        check(bool(near(kv, pv, scale).all()),
              f"{what}: values differ by {float((kv - pv).abs().max())}")
        check(bool(near(dk, kv, scale).all()),
              f"{what}: a value does not belong to its centroid")
        n_near = compare_ranked(what, ki, pi, near(dk, dp[:, 0], scale),
                                exact)
        return float((kv - pv).abs().max()), n_near

    def nonfinite_case(N, d, k, what):
        """Queries holding a NaN or an Inf: every distance of the first is
        NaN, the second's are +Inf or NaN.  Both versions rank NaN after
        every number and break equal values to the smaller row, so indices
        match exactly and every one is a real row."""
        A, C = rand((N, d), True), rand((3, d), True)
        C[0, d // 2] = float("nan")
        C[1, 0] = float("inf")
        kv, ki = ops.distance_topk(A, C, k)
        pv, pi = ref.distance_topk(A, C, k)
        torch.cuda.synchronize()
        check(bool(((ki >= 0) & (ki < N)).all()),
              f"{what}: an index is not a row of A")
        check(torch.equal(ki, pi), f"{what}: indices differ from the "
              f"plain version's at {int((ki != pi).sum())} ranks")
        check(bool(torch.isclose(kv, pv, equal_nan=True, **TOL).all()),
              f"{what}: values differ from the plain version's")
        return int(kv.isnan().sum()), int(kv.isinf().sum())

    def gnb_case(X, mu, var, lp, what):
        ks = ops.gnb_scores_batch(X, mu, var, lp)
        ps = ref.gnb_scores_batch(X, mu, var, lp)
        torch.cuda.synchronize()
        check(bool(torch.isclose(ks, ps, **TOL).all()),
              f"{what}: scores differ by {float((ks - ps).abs().max())}")
        return float((ks - ps).abs().max())

    def gnb_inputs(B, d, C):
        X = torch.randn((B, d), generator=gen)
        mu = torch.randn((C, d), generator=gen)
        var = torch.rand((C, d), generator=gen) + 0.25
        lp = torch.log_softmax(torch.randn(C, generator=gen), 0)
        return [t.to(dev).contiguous() for t in (X, mu, var, lp)]

    edges = 0
    for N, d, Q, k, ints in [(4099, 1, 1, 1, True), (4099, 5, 3, TOPK_K_MAX,
                             True), (70001, 21, 3, TOPK_K_MAX, False),
                             (3001, 784, 1, TOPK_K_MAX, False),
                             (33, 21, 40, TOPK_K_MAX, True),
                             (TOPK_K_MAX, 5, 3, TOPK_K_MAX, False),
                             (100_003, 21, 37, 4, False),
                             (20_011, 784, 3, 1, True)]:
        err, n_near = topk_case(rand((N, d), ints), rand((Q, d), ints), k,
                              ints, f"B1 N={N} d={d} Q={Q} k={k}")
        print(f"[edge] B1 N={N} d={d} Q={Q} k={k} ints={ints}: "
              f"max_abs_err={err:.3g} near_ties={n_near}")
        edges += 1
    for N, d, Q, k, ints in [(500, 21, 5, 4, False), (4099, 5, 3, 8, True)]:
        err, n_near = topk_case(rand((N, d), ints), rand((Q, d), ints), k,
                                ints, f"B1 bf16 N={N} d={d} Q={Q} k={k}",
                                dtype=torch.bfloat16)
        print(f"[edge] B1 bf16 N={N} d={d} Q={Q} k={k} ints={ints}: "
              f"max_abs_err={err:.3g} near_ties={n_near}")
        edges += 1
    for N, d, k in [(4099, 21, TOPK_K_MAX), (70, 5, 4)]:
        n_nan, n_inf = nonfinite_case(N, d, k, f"B1 NaN/Inf N={N} d={d}")
        print(f"[edge] B1 NaN and Inf queries N={N} d={d} k={k}: "
              f"{n_nan} NaN and {n_inf} Inf values, indices equal")
        edges += 1
    # B1's Hopper design (bulk copies, shared lists with queues): an
    # unaligned view (the plain route), a last tile whose span is not a
    # multiple of 16 bytes, rows in adversarial order (each ranks before
    # every earlier one, so every row beats every threshold and the queues
    # fill between syncs), all-equal rows (exact ties fill a queue in one
    # tile), and the ANN probe shape
    from repro_torch.kernels import distance_topk as kdt
    from repro_torch.kernels import quantized as qk
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def tail_bytes(N, Q, d, itemsize):
        """Bytes of the last tile of the last split of B1/B6's plan."""
        n_splits, per = kdt.split_rows(N, Q, sms)
        last = N - (n_splits - 1) * per
        return (last - (last - 1) // kdt.TILE_ROWS * kdt.TILE_ROWS) * d * \
            itemsize

    def adversarial(rows, centre, n_q, jitter):
        """rows sorted by descending distance to ``centre`` (stable), and
        n_q queries at the centre (plus ``jitter`` times normal noise)."""
        dist = ((rows.double() - centre.double()) ** 2).sum(1)
        rows = rows[dist.argsort(descending=True, stable=True)].contiguous()
        q = centre.repeat(n_q, 1)
        if jitter:
            q = q + jitter * torch.randn(q.shape, generator=gen).to(dev)
        return rows, q.contiguous()

    check(tail_bytes(4099, 5, 21, 4) % 16 and tail_bytes(4099, 5, 21, 1) % 16,
          "the ragged-tile case no longer ends off a 16-byte multiple")
    A_view = rand((100_004, 21), False)
    A_adv, C_adv = adversarial(rand((65_536, 21), False),
                               rand((1, 21), False), 129, 1e-3)
    for what, A_e, C_e, k, exact, way in [
            ("unaligned view A[1:]", A_view[1:], rand((37, 21), False), 4,
             False, "plain"),
            ("ragged last tile N=4099", rand((4099, 21), False),
             rand((5, 21), False), 8, False, "bulk"),
            ("adversarial order N=65536", A_adv, C_adv, 4, False, "bulk"),
            ("all-equal rows N=3000", torch.ones((3000, 21), device=dev),
             rand((64, 21), True), 8, True, "bulk"),
            ("ANN probe shape N=256", rand((256, 21), False),
             rand((1024, 21), False), 16, False, "bulk")]:
        before = dict(kdt.ROUTE_LAUNCHES)
        err, n_near = topk_case(A_e, C_e, k, exact, f"B1 {what}")
        check(kdt.ROUTE_LAUNCHES[way] == before[way] + 1,
              f"B1 {what}: routes {kdt.ROUTE_LAUNCHES}, the alignment rule "
              f"gives {way}")
        print(f"[edge] B1 {what} d=21 Q={C_e.shape[0]} k={k} ({way} route):"
              f" max_abs_err={err:.3g} near_ties={n_near}")
        edges += 1
    A_ann, C_ann = rand((256, 21), False), rand((1024, 21), False)
    A_shuf = A_adv[torch.randperm(A_adv.shape[0], generator=gen).to(dev)]
    ann_ms = [cuda_ms(torch, lambda: fn(A_ann, C_ann, 16), 20)
              for fn in (ops.distance_topk, ref.distance_topk)]
    adv_ms = [cuda_ms(torch, lambda: ops.distance_topk(rows, C_adv, 4), 20)
              for rows in (A_adv, A_shuf)]
    print(f"[time] B1 ANN probe shape N=256 Q=1024 d=21 k=16: kernel "
          f"{ann_ms[0]:.4f} ms, plain {ann_ms[1]:.4f} ms")
    print(f"[time] B1 adversarial order N=65536 Q=129 d=21 k=4: kernel "
          f"{adv_ms[0]:.4f} ms; the same rows shuffled {adv_ms[1]:.4f} ms")
    del A_view, A_adv, C_adv, A_ann, C_ann, A_shuf
    # B2 on the route its rule gives (rows for d <= 4, narrow for few
    # rows, bulk/plain by B1's alignment rule, stream past the resident
    # centroids), d in {1, 21, 33, 784} and K in {1, 255, 257}; on every
    # route B2 sums in B4's order, so the fused arm equals the blocked one
    # (B4, then the row min) bit for bit
    from repro_torch.kernels import distance_argmin as kda

    def blocked_argmin(A, C):
        v, i = torch.min(ops.pairwise_sq_dist(A, C), dim=1)
        return v, i.to(torch.int32)

    def bitwise(got, want):
        return torch.equal(got[0].view(torch.int32),
                           want[0].view(torch.int32)) and \
            torch.equal(got[1], want[1])

    A_view = rand((5001, 21), False)
    for N, d, K, ints, A_e in [
            (4099, 1, 1, True, None), (4099, 1, 255, False, None),
            (70_001, 1, 257, False, None), (70_001, 21, 255, False, None),
            (4099, 5, 257, True, None), (1024, 21, 256, False, None),
            (129, 21, 33, True, None), (1, 21, 257, False, None),
            (5000, 33, 255, False, None), (5000, 33, 1, True, None),
            (5000, 21, 256, False, A_view[1:]),
            (1001, 784, 257, False, None), (129, 784, 1, False, None),
            (20_000, 21, 1000, False, None)]:
        A_e = rand((N, d), ints) if A_e is None else A_e
        C_e = rand((K, d), ints)
        before = dict(kda.ROUTE_LAUNCHES)
        way = kda.route(A_e, C_e)
        err, n_near = argmin_case(A_e, C_e, ints, f"B2 N={N} d={d} K={K}")
        check(kda.ROUTE_LAUNCHES[way] == before[way] + 1,
              f"B2 N={N} d={d} K={K}: routes {kda.ROUTE_LAUNCHES}, the rule "
              f"gives {way}")
        same = bitwise(ops.distance_argmin(A_e, C_e), blocked_argmin(A_e, C_e))
        check(same, f"B2 N={N} d={d} K={K} ({way}): the fused arm differs "
              "from the blocked arm's bits")
        print(f"[edge] B2 N={N} d={d} K={K} ints={ints} ({way} route): "
              f"max_abs_err={err:.3g} near_ties={n_near}, bitwise equal to "
              "B4 + row min")
        edges += 1
    del A_view
    # ROADMAP C4: a row holding NaN takes centroid 0 at +inf in both
    # versions (a NaN distance is never the nearest); the other rows as
    # above
    nan_rows = rand((1001, 21), False)
    nan_rows[[5, 600, 1000], [3, 0, 20]] = float("nan")
    for A_n, C_n, what in [
            (torch.tensor([[0.0, 0.0], [float("nan"), 1.0], [1.0, 1.0]],
                          device=dev),
             torch.tensor([[0.0, 0.0], [1.0, 1.0], [2.0, 2.0]], device=dev),
             "B2 [[0,0],[nan,1],[1,1]]"),
            (nan_rows, rand((257, 21), False), "B2 random NaN rows")]:
        kv, ki = ops.distance_argmin(A_n, C_n)
        pv, pi = ref.distance_argmin(A_n, C_n)
        torch.cuda.synchronize()
        bad = torch.isnan(A_n).any(1)
        check(bool((ki[bad] == 0).all()) and bool((pi[bad] == 0).all()) and
              bool(torch.isinf(kv[bad]).all()) and
              bool(torch.isinf(pv[bad]).all()),
              f"{what}: a NaN row did not take centroid 0 at +inf "
              f"(kernel {ki[bad].tolist()}, plain {pi[bad].tolist()})")
        err, n_near = argmin_case(A_n[~bad].contiguous(), C_n, False, what)
        print(f"[edge] {what}: {int(bad.sum())} NaN rows take centroid 0 at "
              f"+inf in both versions; the other rows max_abs_err="
              f"{err:.3g} near_ties={n_near}")
        edges += 1
    # B3's Hopper design: class groups of at most 16 (C = 16, 17, 33),
    # one query (B9's case) and ragged query counts, d from one feature to
    # past the resident (mu, var) pairs (C d past gnb_score.RESIDENT_MAX:
    # the stream route), each on the route its rule gives
    from repro_torch.kernels import gnb_score as kgs
    for B, d, C in [(1, 784, 10), (3, 1, 1), (33, 5, 9), (1023, 65, 257),
                    (1, 784, 16), (31, 785, 16), (1025, 5, 17), (31, 1, 33),
                    (1, 785, 17), (5, 1300, 10), (1025, 784, 33),
                    (1025, 784, 10)]:
        before = dict(kgs.ROUTE_LAUNCHES)
        way = kgs.route(C, d)
        err = gnb_case(*gnb_inputs(B, d, C), f"B3 B={B} d={d} C={C}")
        check(kgs.ROUTE_LAUNCHES[way] == before[way] + 1,
              f"B3 B={B} d={d} C={C}: routes {kgs.ROUTE_LAUNCHES}, the rule "
              f"gives {way}")
        print(f"[edge] B3 B={B} d={d} C={C} ({way} route, plan "
              f"{kgs.plan(B, C, d, sms)}): max_abs_err={err:.3g}")
        edges += 1

    def dist_case(N, K, d, col_major, ints, what):
        """B4 in either layout against the plain version."""
        A, C = rand((N, d), ints), rand((K, d), ints)
        e = ops.pairwise_sq_dist(A, C, col_major=col_major)
        p = ref.pairwise_sq_dist(A, C)
        torch.cuda.synchronize()
        check(e.shape == (N, K) and (e.T if col_major else e).is_contiguous(),
              f"{what}: layout {tuple(e.shape)} strides {e.stride()}")
        scale = (A * A).sum(1)[:, None] + (C * C).sum(1)[None, :]
        check(bool(near(e, p, scale).all()),
              f"{what}: values differ by {float((e - p).abs().max())}")
        check(not ints or torch.equal(e, p), f"{what}: a distance differs "
              "on integer data, where every distance is exact")
        return float((e - p).abs().max())

    def select_case(x, k, what):
        """B5 against the plain version on the same tensor: both rank the
        same floats, so indices and values must be equal; indices are
        distinct in every row."""
        kv, ki = ops.topk_smallest(x, k)
        pv, pi = ref.topk_smallest(x, k)
        torch.cuda.synchronize()
        check(ki.shape == (x.shape[0], k) and ki.dtype == torch.int32,
              f"{what}: {tuple(ki.shape)} {ki.dtype}")
        check(torch.equal(ki, pi), f"{what}: indices differ from the plain "
              f"version's at {int((ki != pi).sum())} places")
        check(bool(torch.isclose(kv, pv, rtol=0, atol=0,
                                 equal_nan=True).all()),
              f"{what}: values differ from the plain version's")
        srt = ki.sort(dim=1).values
        check(bool((srt[:, 1:] != srt[:, :-1]).all()),
              f"{what}: an index appears twice in one row")
        return int(kv.isnan().sum()), int(kv.isinf().sum())

    def rows(R, n, kind):
        if kind == "ints":        # few values: long runs of exact ties
            return torch.randint(0, 4, (R, n), generator=gen).float().to(dev)
        x = torch.randn((R, n), generator=gen)
        if kind == "inf":         # four fifths +Inf: k reaches them
            x[:, torch.rand(n, generator=gen) < 0.8] = float("inf")
        if kind == "nan":         # NaN, ±Inf and signed zeros mixed in
            u = torch.rand((R, n), generator=gen)
            x[u < 0.3] = float("nan")
            x[(u >= 0.3) & (u < 0.4)] = float("inf")
            x[(u >= 0.4) & (u < 0.45)] = -float("inf")
            x[(u >= 0.45) & (u < 0.5)] = -0.0
            x[(u >= 0.5) & (u < 0.55)] = 0.0
        return x.to(dev)

    for N, K, d, col_major, ints in [(4099, 1, 1, True, True),
                                     (4099, 257, 5, False, True),
                                     (70_001, 1023, 21, True, False),
                                     (1001, 65, 784, False, False),
                                     (33, 40, 21, True, True),
                                     (1, 1, 21, False, False)]:
        err = dist_case(N, K, d, col_major, ints,
                        f"B4 N={N} K={K} d={d} col_major={col_major}")
        print(f"[edge] B4 N={N} K={K} d={d} col_major={col_major} "
              f"ints={ints}: max_abs_err={err:.3g}")
        edges += 1
    for R, n, k, kind in [(3, 4099, 1, "normal"), (5, 4099, 4099, "ints"),
                          (7, 5000, 33, "ints"), (37, 70_001, 64, "normal"),
                          (2, 3, 3, "normal"), (4, 9000, 2049, "inf"),
                          (6, 300, 300, "nan"), (9, 20_000, 64, "nan"),
                          (1, 1, 1, "normal"), (1030, 2048, 2048, "ints")]:
        n_nan, n_inf = select_case(rows(R, n, kind), k,
                                   f"B5 R={R} n={n} k={k} {kind}")
        print(f"[edge] B5 R={R} n={n} k={k} {kind}: indices equal, "
              f"{n_nan} NaN and {n_inf} Inf values")
        edges += 1
    # the reference's finding: its Pallas B5 repeats index 0 on this row
    kv, ki = ops.topk_smallest(torch.tensor(
        [[1.0, float("inf"), float("inf"), 0.5]], device=dev), 4)
    check(ki.tolist() == [[3, 0, 1, 2]], f"B5 +Inf row: {ki.tolist()}")
    # the blocked arm's hand-over: B5 reads the transpose of B4's
    # column-major matrix in place, and a row-strided slice of it
    e = ops.pairwise_sq_dist(rand((5000, 21), False), rand((40, 21), False),
                             col_major=True)
    select_case(e.T, 64, "B5 on the transposed view of B4")
    select_case(e.T[::3], 100, "B5 on a row-strided view")
    edges += 3
    del e
    for d, C in [(784, 10), (1, 1), (65, 257), (5, 9), (1, 16), (5, 17),
                 (784, 33), (785, 10), (1300, 17)]:
        X, mu_e, var_e, lp_e = gnb_inputs(1, d, C)
        before = dict(kgs.ROUTE_LAUNCHES)
        way = kgs.route(C, d)
        ks = ops.gnb_scores(X[0], mu_e, var_e, lp_e)
        ps = ref.gnb_scores(X[0], mu_e, var_e, lp_e)
        torch.cuda.synchronize()
        check(ks.shape == (C,) and bool(torch.isclose(ks, ps, **TOL).all()),
              f"B9 d={d} C={C}: scores differ by "
              f"{float((ks - ps).abs().max())}")
        check(kgs.ROUTE_LAUNCHES[way] == before[way] + 1,
              f"B9 d={d} C={C}: B3 routes {kgs.ROUTE_LAUNCHES}, the rule "
              f"gives {way}")
        print(f"[edge] B9 d={d} C={C} (B3 at B=1, {way} route): "
              f"max_abs_err={float((ks - ps).abs().max()):.3g}")
        edges += 1
    # ---- slice 3: integer kernels, bit-equal to their plain versions
    def i8(shape, kind="normal"):
        """int8 lattice rows: uniform on [-127, 127], rows drawn with
        repetition from a few small ones (exact ties), or saturated."""
        if kind == "dup":
            base = torch.randint(-3, 4, (max(1, shape[0] // 3), shape[1]),
                                 generator=gen)
            x = base[torch.randint(0, base.shape[0], (shape[0],),
                                   generator=gen)]
        elif kind == "sat":
            x = torch.where(torch.rand(shape, generator=gen) < 0.5, -127, 127)
        else:
            x = torch.randint(-127, 128, shape, generator=gen)
        return x.to(torch.int8).to(dev).contiguous()

    def equal_case(what, got, want):
        torch.cuda.synchronize()
        check(all(g.dtype == w.dtype and torch.equal(g, w)
                  for g, w in zip(got, want)),
              f"{what}: differs from the plain version at "
              f"{sum(int((g != w).sum()) for g, w in zip(got, want))} "
              "places")

    for R, n, k in [(3, 4099, 1), (5, 4099, 4099), (7, 5000, 33),
                    (4, 9000, 2049), (1, 1, 1)]:
        x = torch.randint(-5, 5, (R, n), generator=gen, dtype=torch.int32)
        x[:, ::7] = 2 ** 31 - 1
        x[:, ::11] = -2 ** 31
        x = x.to(dev)
        equal_case(f"B5 int32 R={R} n={n} k={k}", ops.topk_smallest(x, k),
                   ref.topk_smallest(x, k))
        print(f"[edge] B5 int32 R={R} n={n} k={k} with INT_MIN, INT_MAX "
              "and ties: values and indices equal")
        edges += 1
    # ---- slice 7: B5's two routes (filter up to FILTER_K_MAX, radix past
    # it) and B4's tile design, each edge on the route its rule gives;
    # B5 bit for bit in both key modes (its values are x's own bits)
    from repro_torch.kernels import pairwise_sq_dist as kpd
    from repro_torch.kernels import topk_select as kts
    k_cap = kts.FILTER_K_MAX

    def bits(v):
        return v.view(torch.int32) if v.dtype == torch.float32 else v

    def select_exact(x, k, what):
        before = dict(kts.ROUTE_LAUNCHES)
        kv, ki = ops.topk_smallest(x, k)
        pv, pi = ref.topk_smallest(x, k)
        torch.cuda.synchronize()
        way = kts.route(k)
        check(kts.ROUTE_LAUNCHES[way] == before[way] + 1,
              f"{what}: routes {kts.ROUTE_LAUNCHES}, the rule gives {way}")
        check(torch.equal(ki, pi), f"{what}: indices differ from the plain "
              f"version's at {int((ki != pi).sum())} places")
        check(torch.equal(bits(kv), bits(pv)),
              f"{what}: values differ from the plain version's bits")
        return way

    def i32_rows(R, n):
        x = torch.randint(-5, 5, (R, n), generator=gen, dtype=torch.int32)
        x[:, ::7] = 2 ** 31 - 1
        x[:, ::11] = -2 ** 31
        return x.to(dev)

    def descending(x):
        return torch.sort(x, dim=1, descending=True, stable=True).values

    M = KNN["n"]
    x_off = rows(37, 70_002, "nan")
    x_str = rows(30, 20_000, "normal")
    for what, x, k in [
            ("R=1 n=2^20 k=64 (split rows)", rows(1, M, "normal"), 64),
            ("R=16 n=2^20 k=64 NaN/Inf/zeros", rows(16, M, "nan"), 64),
            (f"R=5 n=70003 k=FILTER_K_MAX={k_cap} ties",
             rows(5, 70_003, "ints"), k_cap),
            (f"R=5 n=70003 k={k_cap - 1}", rows(5, 70_003, "normal"),
             k_cap - 1),
            (f"R=5 n=70003 k={k_cap + 1}", rows(5, 70_003, "normal"),
             k_cap + 1),
            ("R=3 n=k=2053 NaN", rows(3, 2053, "nan"), 2053),
            ("R=4 n=k=1000 ties", rows(4, 1000, "ints"), 1000),
            ("R=6 n=4097 k=1 NaN", rows(6, 4097, "nan"), 1),
            ("R=9 n=100000 k=128 long runs of ties",
             rows(9, 100_000, "ints"), 128),
            ("R=6 n=7 k=5 NaN", rows(6, 7, "nan"), 5),
            ("descending rows R=16 n=2^18 k=64",
             descending(rows(16, 1 << 18, "normal")), 64),
            ("R=37 n=70001 k=64 offset view x[:, 1:] (ragged head)",
             x_off[:, 1:], 64),
            ("R=10 n=20000 k=300 row-strided view x[::3]", x_str[::3], 300),
            ("int32 R=1 n=2^20 k=64", i32_rows(1, M), 64),
            ("int32 R=16 n=70003 k=128", i32_rows(16, 70_003), 128),
            (f"int32 R=3 n=4099 k={k_cap}", i32_rows(3, 4099), k_cap),
            (f"int32 R=3 n=4099 k={k_cap + 1}", i32_rows(3, 4099),
             k_cap + 1),
            ("int32 R=5 n=k=3001", i32_rows(5, 3001), 3001),
            ("int32 descending R=8 n=2^16 k=64",
             descending(i32_rows(8, 1 << 16)), 64),
            ("int32 R=7 n=5001 k=33 offset view x[:, 1:]",
             i32_rows(7, 5002)[:, 1:], 33)]:
        way = select_exact(x, k, f"B5 {what}")
        print(f"[edge] B5 {what} ({way} route): values and indices "
              "bit-equal to the plain version")
        edges += 1
    del x_off, x_str
    # a row in descending order pushes every element past the threshold
    x_desc = descending(rows(16, 1 << 18, "normal"))
    x_shuf = x_desc[:, torch.randperm(1 << 18, generator=gen).to(dev)]
    desc_ms = [cuda_ms(torch, lambda: ops.topk_smallest(x, 64), 20)
               for x in (x_desc, x_shuf)]
    print(f"[time] B5 descending rows R=16 n=262144 k=64: kernel "
          f"{desc_ms[0]:.4f} ms; the same rows shuffled {desc_ms[1]:.4f} ms")
    del x_desc, x_shuf

    def dist_exact(A, C, col_major, what):
        """B4 on the route its rule gives against the plain version."""
        before = dict(kpd.ROUTE_LAUNCHES)
        way = kpd.route(A)
        e = ops.pairwise_sq_dist(A, C, col_major=col_major)
        check(kpd.ROUTE_LAUNCHES[way] == before[way] + 1,
              f"{what}: routes {kpd.ROUTE_LAUNCHES}, the rule gives {way}")
        p_ = ref.pairwise_sq_dist(A, C)
        torch.cuda.synchronize()
        check(e.shape == p_.shape and
              (e.T if col_major else e).is_contiguous(),
              f"{what}: layout {tuple(e.shape)} strides {e.stride()}")
        scale = (A * A).sum(1)[:, None] + (C * C).sum(1)[None, :]
        check(bool(near(e, p_, scale).all()),
              f"{what}: values differ by {float((e - p_).abs().max())}")
        return way, float((e - p_).abs().max())

    A_view = rand((5001, 21), False)
    for what, A_e, K_e, col in [
            ("view A[1:]", A_view[1:], 300, True),
            ("one feature", rand((4099, 1), False), 130, True),
            ("wide rows", rand((1001, 784), False), 130, False),
            ("scalar stores", rand((70_001, 21), False), 1023, True),
            ("tma stores", rand((4100, 21), False), 257, True),
            ("scalar stores", rand((4099, 21), False), 257, False),
            ("tma stores", rand((4099, 21), False), 260, False),
            ("K=1", rand((4099, 21), False), 1, True),
            ("K=1", rand((4099, 21), False), 1, False)]:
        C_e = rand((K_e, A_e.shape[1]), False)
        way, err = dist_exact(A_e, C_e, col, f"B4 {what}")
        print(f"[edge] B4 {what} N={A_e.shape[0]} K={K_e} "
              f"d={A_e.shape[1]} col_major={col} ({way} route): "
              f"max_abs_err={err:.3g}")
        edges += 1
    del A_view
    for N, d, Q, k, kind in [(4099, 1, 3, 1, "dup"), (4099, 3, 37, 4, "dup"),
                             (4099, 21, 37, TOPK_K_MAX, "normal"),
                             (70_001, 21, 5, 4, "normal"),
                             (3001, 64, 33, 17, "dup"),
                             (500, 832, 3, TOPK_K_MAX, "normal"),
                             (33, 5, 40, 33, "dup"),
                             (4099, 21, 7, 4099, "dup"),
                             (5000, 21, 9, Q8_BLOCKED_K, "normal"),
                             (100, 21, 5, 7, "sat"), (1, 21, 3, 1, "sat")]:
        A8, C8 = i8((N, d), kind), i8((Q, d), kind)
        equal_case(f"B6 N={N} d={d} Q={Q} k={k}",
                   ops.distance_topk_q8(A8, C8, k),
                   ref.distance_topk_q8(A8, C8, k))
        print(f"[edge] B6 N={N} d={d} Q={Q} k={k} {kind}: distances and "
              "rows equal")
        edges += 1
    # B6's Hopper design: the edges of B1's above, bit-equal
    A8_view = i8((100_017, 21))
    A8_adv, C8_adv = adversarial(i8((65_536, 21)), i8((1, 21)), 129, 0)
    for what, A8, C8, k, way in [
            ("unaligned view A[1:]", A8_view[1:], i8((37, 21)), 4, "plain"),
            ("ragged last tile N=4099", i8((4099, 21)), i8((5, 21)), 8,
             "bulk"),
            ("adversarial order N=65536", A8_adv, C8_adv, 4, "bulk"),
            ("all-equal rows N=3000",
             torch.full((3000, 21), 5, dtype=torch.int8, device=dev),
             i8((64, 21)), 8, "bulk"),
            ("ANN probe shape N=256", i8((256, 21)), i8((1024, 21)),
             16, "bulk")]:
        before = dict(qk.ROUTE_LAUNCHES)
        equal_case(f"B6 {what}", ops.distance_topk_q8(A8, C8, k),
                   ref.distance_topk_q8(A8, C8, k))
        check(qk.ROUTE_LAUNCHES[way] == before[way] + 1,
              f"B6 {what}: routes {qk.ROUTE_LAUNCHES}, the alignment rule "
              f"gives {way}")
        print(f"[edge] B6 {what} d=21 Q={C8.shape[0]} k={k} ({way} route): "
              "distances and rows equal")
        edges += 1
    A8_shuf = A8_adv[torch.randperm(A8_adv.shape[0], generator=gen).to(dev)]
    adv_ms = [cuda_ms(torch, lambda: ops.distance_topk_q8(rows, C8_adv, 4), 20)
              for rows in (A8_adv, A8_shuf)]
    print(f"[time] B6 adversarial order N=65536 Q=129 d=21 k=4: kernel "
          f"{adv_ms[0]:.4f} ms; the same rows shuffled {adv_ms[1]:.4f} ms")
    del A8_view, A8_adv, C8_adv, A8_shuf
    # B7 on both its routes (``resident``; ``stream`` past
    # quantized.ARGMIN_RESIDENT_MAX), on its packed keys (d = 21 up to
    # K = 2048) and past them (d = 832), at N = 1, 1024 and 1025 and on
    # duplicated centroids (the first index wins)
    for N, d, K, kind in [(4099, 1, 1, "dup"), (4099, 5, 257, "dup"),
                          (1001, 832, 257, "normal"), (129, 21, 33, "dup"),
                          (1, 21, 257, "normal"), (70_001, 21, 256, "sat"),
                          (1, 1, 1, "normal"), (1024, 21, 255, "dup"),
                          (1025, 21, 257, "normal"), (1024, 21, 1200, "dup"),
                          (1025, 21, 2049, "normal"), (1025, 832, 1, "sat"),
                          (70, 832, 257, "dup"), (1024, 1, 256, "dup")]:
        A8, C8 = i8((N, d), kind), i8((K, d), kind)
        before = dict(qk.ARGMIN_ROUTE_LAUNCHES)
        way = qk.argmin_route(K, d)
        equal_case(f"B7 N={N} d={d} K={K}", ops.distance_argmin_q8(A8, C8),
                   ref.distance_argmin_q8(A8, C8))
        check(qk.ARGMIN_ROUTE_LAUNCHES[way] == before[way] + 1,
              f"B7 N={N} d={d} K={K}: routes {qk.ARGMIN_ROUTE_LAUNCHES}, the "
              f"rule gives {way}")
        print(f"[edge] B7 N={N} d={d} K={K} {kind} ({way} route, plan "
              f"{qk.argmin_plan(N, K, d, sms)}): distances and centroids "
              "equal")
        edges += 1
    for fn in (lambda: ops.distance_topk_q8(i8((10, 833)), i8((2, 833)), 1),
               lambda: ops.distance_argmin_q8(i8((10, 833)), i8((2, 833)))):
        try:
            fn()
            check(False, "d = 833 did not raise")
        except ValueError:
            edges += 1
    print("[edge] B6 and B7 at d = 833 raise ValueError")

    def adc_inputs(Q, L, m, n_codes, invalid=0.2, lut_hi=256, code_hi=None):
        lut = torch.randint(0, lut_hi, (Q, m * n_codes), generator=gen,
                            dtype=torch.int32)
        codes = (torch.randint(0, code_hi or n_codes, (Q, L, m),
                               generator=gen) - 128).to(torch.int8)
        ids = torch.randint(0, 1 << 20, (Q, L), generator=gen,
                            dtype=torch.int32)
        ids[torch.rand((Q, L), generator=gen) < invalid] = -1
        return lut.to(dev), codes.to(dev).contiguous(), ids.to(dev)

    from repro_torch.kernels import ann as kann
    # each on the route k gives (fused up to FUSED_K_MAX, the matrix and
    # B5 past it); L not a multiple of 32, all-padding rows, codes past
    # n_codes - 1 (both sides clamp them), LUT entries past 255 (the fused
    # route then reads the LUT from device memory), codes wider than its
    # register path, a query split across blocks (Q = 1), and padding in
    # contiguous runs, as in a ragged cell list
    k_cap = kann.FUSED_K_MAX
    for Q, L, m, n_codes, k, invalid, lut_hi, code_hi in [
            (5, 1000, 21, 256, 1, 0.2, 256, None),
            (5, 1000, 21, 256, 10, 0.2, 256, None),
            (5, 1000, 21, 256, 1000, 0.2, 256, None),
            (2, 5001, 21, 256, k_cap, 0.2, 256, None),
            (2, 5001, 21, 256, k_cap + 1, 0.2, 256, None),
            (3, 777, 4, 16, 33, 0.2, 3, None),
            (3, 100, 7, 256, 50, 1.0, 256, None),
            (2, 300, 256, 256, 20, 0.2, 256, None),
            (4, 1001, 3, 256, 128, 0.9, 256, None),
            (1, 1, 1, 1, 1, 0.0, 256, None),
            (3, 777, 5, 16, 40, 0.2, 256, 256),
            (3, 777, 5, 16, 40, 0.2, 1000, None),
            (4, 4096, 25, 256, 100, 0.3, 256, None),
            (4, 4096, 21, 256, 128, "runs", 256, None),
            (1, 40_000, 21, 256, 128, "runs", 256, None),
            (2, 20001, 7, 256, 300, "runs", 256, None)]:
        lut, codes, ids = adc_inputs(Q, L, m, n_codes,
                                     0.0 if invalid == "runs" else invalid,
                                     lut_hi, code_hi)
        if invalid == "runs":
            # cells of capacity 1024, each with a padded tail
            for c in range(L // 1024):
                ids[:, c * 1024 + 100 * (c % 9 + 1):(c + 1) * 1024] = -1
        before = dict(kann.ROUTE_LAUNCHES)
        way = kann.route(k)
        equal_case(f"B8 Q={Q} L={L} m={m} k={k}",
                   ops.adc_topk(lut, codes, ids, k),
                   ref.adc_topk(lut, codes, ids, k))
        check(kann.ROUTE_LAUNCHES[way] > before[way] and
              sum(kann.ROUTE_LAUNCHES.values()) - sum(before.values()) ==
              kann.ROUTE_LAUNCHES[way] - before[way],
              f"B8 Q={Q} L={L} m={m} k={k}: routes {kann.ROUTE_LAUNCHES}, "
              f"the rule gives {way}")
        where = "shared" if kann.lut_in_smem(m, n_codes) and lut_hi <= 256 \
            else "device"
        print(f"[edge] B8 Q={Q} L={L} m={m} n_codes={n_codes} k={k} "
              f"invalid={invalid} codes<{code_hi or n_codes} LUT<{lut_hi} "
              f"in {where} memory ({way} route): distances and positions "
              "equal")
        edges += 1
    # ---- slice 4: B10 (GEMM) and B11 (attention), bf16 and fp32
    from repro_torch.configs.registry import get_config
    lm_cfg = get_config(LM["arch"])
    lm_gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    moe_cfg = get_config(MOE["arch"])
    edges += lm_kernel_edges(
        torch, ops, ref, dev, lm_gen,
        [(lm_cfg, LM["batch"], LM["prompt"]),
         (moe_cfg, MOE["batch"], MOE["prompt"])] +
        [(phase_config(a), a["batch"], a["prompt"]) for a in LM_ARCHS] +
        # a ``reduced`` phase's arch at its published widths too: its
        # kernels are held at the shapes its path would give them there
        [(get_config(a["arch"]), a["batch"], a["prompt"])
         for a in LM_ARCHS if a.get("reduced")])
    edges += tenant_kernel_edges(torch, ops, ref, dev, gen)
    print(f"[edge] {edges} ragged and tied cases agree with the plain "
          "versions")

    kernels = {}

    # B1 at the kNN serving shape: the whole reference set, one full bucket
    A = on_card(knn_data[0])
    Cq = on_card(knn_data[2][:MAX_BATCH])
    k = KNN["k"]
    err, n_near = topk_case(A, Cq, k, False, "B1 main")
    N, d, Q = A.shape[0], A.shape[1], Cq.shape[0]
    # per pair: d multiply-adds for a·c and one add of the two norms
    # (the -2 folds into C); the norms themselves, once per row and query
    b, by = bound_ms(N * Q * (2 * d + 1) + 2 * d * (N + Q),
                     4 * d * (N + Q) + 8 * Q * k, peaks)
    kernels["B1"] = dict(
        name="distance_topk", route="cuda",
        source="src/repro_torch/kernels/csrc/distance_topk.cu",
        replaces="src/repro/kernels/distance_topk.py:48",
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: ops.distance_topk(A, Cq, k), 10),
        plain_ms=cuda_ms(torch, lambda: [ref.distance_topk(
            A, Cq[i:i + 128], k) for i in range(0, Q, 128)], 3),
        bound_ms=b, bound_by=by,
        library_ms=cuda_ms(torch, lambda: torch.topk(
            torch.cdist(Cq, A) ** 2, k, dim=1, largest=False), 3))
    kernels["B1"]["serve_ms"] = kernels["B1"]["ms"]
    print(f"[kernel] B1 distance_topk N={N} Q={Q} d={d} k={k}: "
          f"max_abs_err={err:.3g} near_ties={n_near}")

    # B2 at the K-Means fit shape: every training row against K centroids;
    # K-Means' fused (B2) and blocked (B4, then the row min) arms give the
    # same bits in every value and index
    A2 = on_card(km_data[0])
    C2 = A2[: KMEANS["K"]].clone()
    err, n_near = argmin_case(A2, C2, False, "B2 main")
    fused = ops.distance_argmin(A2, C2)
    blocked = blocked_argmin(A2, C2)
    same_v = int((fused[0].view(torch.int32) ==
                  blocked[0].view(torch.int32)).sum())
    same_i = int((fused[1] == blocked[1]).sum())
    check(same_v == same_i == A2.shape[0],
          f"B2 main: fused vs blocked K-Means arms: {same_v} values and "
          f"{same_i} indices of {A2.shape[0]} bitwise equal")
    del fused, blocked
    N, d, K = A2.shape[0], A2.shape[1], C2.shape[0]
    b, by = bound_ms(N * K * (2 * d + 1) + 2 * d * (N + K),
                     4 * d * (N + K) + 8 * N, peaks)
    kernels["B2"] = dict(
        name="distance_argmin", route="cuda",
        source="src/repro_torch/kernels/csrc/distance_argmin.cu",
        replaces="src/repro/kernels/distance_topk.py:116",
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: ops.distance_argmin(A2, C2), 20),
        plain_ms=cuda_ms(torch, lambda: ref.distance_argmin(A2, C2), 10),
        bound_ms=b, bound_by=by,
        library_ms=cuda_ms(torch, lambda: torch.cdist(A2, C2).argmin(1),
                           10))
    # and at the serving shape: one full bucket of queries
    Aq2 = on_card(km_data[2][:MAX_BATCH])
    kernels["B2"]["serve_ms"] = cuda_ms(
        torch, lambda: ops.distance_argmin(Aq2, C2), 200)
    print(f"[kernel] B2 distance_argmin N={N} K={K} d={d} "
          f"({kda.route(A2, C2)} route): max_abs_err={err:.3g} "
          f"near_ties={n_near}; fused vs blocked arms: all {same_v} values "
          f"and {same_i} indices bitwise equal (checked); at the serving "
          f"shape N={MAX_BATCH} ({kda.route(Aq2, C2)} route): "
          f"{kernels['B2']['serve_ms']:.4f} ms")

    # B3 at the GNB serving shape: one full bucket against fitted moments
    Xg = on_card(gnb_data[2][:MAX_BATCH])
    mu, var, lp = fit_gnb(on_card(gnb_data[0]), on_card(gnb_data[1]),
                          GNB["classes"])
    err = gnb_case(Xg, mu, var, lp, "B3 main")
    B, d, C = Xg.shape[0], Xg.shape[1], mu.shape[0]
    d_g = d
    b, by = bound_ms(7 * B * C * d + C * d + B * C,
                     4 * (B * d + 2 * C * d + C + B * C), peaks)
    # ms: device time (the replay of a CUDA graph of 20 calls), which the
    # redesigned B3 takes in less than the wrapper's host time, so a loop
    # of calls timed by events (events_ms) measures the host
    from repro_torch.launch.lm_kernel_times import device_ms
    kernels["B3"] = dict(
        name="gnb_scores_batch", route="cuda",
        source="src/repro_torch/kernels/csrc/gnb_score.cu",
        replaces="src/repro/kernels/gnb_score.py:38",
        max_abs_err=err,
        ms=device_ms(lambda: ops.gnb_scores_batch(Xg, mu, var, lp)),
        events_ms=cuda_ms(torch, lambda: ops.gnb_scores_batch(Xg, mu, var,
                                                              lp), 200),
        plain_ms=cuda_ms(torch, lambda: ref.gnb_scores_batch(Xg, mu, var,
                                                             lp), 50),
        bound_ms=b, bound_by=by, library_ms=None)
    kernels["B3"]["serve_ms"] = kernels["B3"]["ms"]
    print(f"[kernel] B3 gnb_scores_batch B={B} C={C} d={d} "
          f"({kgs.route(C, d)} route, plan {kgs.plan(B, C, d, sms)}): "
          f"device {kernels['B3']['ms']:.4f} ms (graph replay), events "
          f"{kernels['B3']['events_ms']:.4f} ms, max_abs_err={err:.3g}")

    # B4 at the kNN serving shape: the (N, Q) matrix of one full bucket,
    # column-major as the blocked kNN arm writes it
    E = ops.pairwise_sq_dist(A, Cq, col_major=True)
    P = ref.pairwise_sq_dist(A, Cq)
    torch.cuda.synchronize()
    scale = (A * A).sum(1)[:, None] + (Cq * Cq).sum(1)[None, :]
    check(bool(near(E, P, scale).all()),
          f"B4 main: values differ by {float((E - P).abs().max())}")
    err = float((E - P).abs().max())
    del P, scale
    N, d, Q = A.shape[0], A.shape[1], Cq.shape[0]
    b, by = bound_ms(N * Q * (2 * d + 1) + 2 * d * (N + Q),
                     4 * d * (N + Q) + 4 * N * Q, peaks)
    kernels["B4"] = dict(
        name="pairwise_sq_dist", route="cuda",
        source="src/repro_torch/kernels/csrc/pairwise_sq_dist.cu",
        replaces="src/repro/kernels/distance.py:18",
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: ops.pairwise_sq_dist(A, Cq,
                                                       col_major=True), 10),
        plain_ms=cuda_ms(torch, lambda: ref.pairwise_sq_dist(A, Cq), 3),
        bound_ms=b, bound_by=by,
        library_ms=cuda_ms(torch, lambda: torch.cdist(A, Cq) ** 2, 3))
    kernels["B4"]["serve_ms"] = kernels["B4"]["ms"]
    # and at the K-Means shapes: the fit (every row against K centroids)
    # and one serving bucket, row-major as the blocked K-Means arm writes
    Nk, Kk = A2.shape[0], C2.shape[0]
    b_km, by_km = bound_ms(Nk * Kk * (2 * d + 1) + 2 * d * (Nk + Kk),
                           4 * d * (Nk + Kk) + 4 * Nk * Kk, peaks)
    km_fit = dict(ms=cuda_ms(torch, lambda: ops.pairwise_sq_dist(A2, C2), 20),
                  plain=cuda_ms(torch, lambda: ref.pairwise_sq_dist(A2, C2),
                                10),
                  lib=cuda_ms(torch, lambda: torch.cdist(A2, C2) ** 2, 10))
    kernels["B4"]["serve_ms_kmeans"] = cuda_ms(
        torch, lambda: ops.pairwise_sq_dist(Aq2, C2), 200)
    print(f"[kernel] B4 pairwise_sq_dist N={N} K={Q} d={d} col_major: "
          f"max_abs_err={err:.3g}; at the K-Means fit shape N={Nk} K={Kk}: "
          f"kernel {km_fit['ms']:.4f} ms, plain {km_fit['plain']:.4f} ms, "
          f"library {km_fit['lib']:.4f} ms, bound {b_km:.4f} ms ({by_km}); "
          f"at the K-Means serving shape N={MAX_BATCH}: "
          f"{kernels['B4']['serve_ms_kmeans']:.4f} ms")

    # B5 on the transpose of that matrix: the k = 64 nearest of 2^20 rows
    # for each query of the bucket, read in place
    kb = KNN_BLOCKED_K
    X5 = E.T
    kv, ki = ops.topk_smallest(X5, kb)
    torch.cuda.synchronize()
    err = 0.0
    for i in range(0, Q, 128):
        pv, pi = ref.topk_smallest(X5[i:i + 128], kb)
        check(torch.equal(ki[i:i + 128], pi) and torch.equal(kv[i:i + 128],
                                                              pv),
              f"B5 main: rows {i}..{i + 127} differ from the plain version")
        err = max(err, float((kv[i:i + 128] - pv).abs().max()))
    del pv, pi
    R, n = X5.shape
    b, by = bound_ms(R * n, 4 * R * n + 8 * R * kb, peaks)
    kernels["B5"] = dict(
        name="topk_smallest", route="cuda",
        source="src/repro_torch/kernels/csrc/topk_select.cu",
        replaces="src/repro/kernels/topk_select.py:22",
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: ops.topk_smallest(X5, kb), 10),
        plain_ms=cuda_ms(torch, lambda: [ref.topk_smallest(
            X5[i:i + 128], kb) for i in range(0, R, 128)], 2),
        bound_ms=b, bound_by=by,
        library_ms=cuda_ms(torch, lambda: torch.topk(X5, kb, dim=1,
                                                     largest=False), 3))
    kernels["B5"]["serve_ms"] = kernels["B5"]["ms"]
    # the two arms meet at k = 32: B4 + B5 and the fused B1 rank the same
    # distances, summed in the same order (csrc/distance_tile.cuh), so
    # their values and indices are bitwise equal
    bv, bi = ops.topk_smallest(X5, TOPK_K_MAX)
    fv, fi = ops.distance_topk(A, Cq, TOPK_K_MAX)
    torch.cuda.synchronize()
    same_idx = int((bi == fi).sum())
    same_val = int((bv.view(torch.int32) == fv.view(torch.int32)).sum())
    check(same_idx == same_val == bi.numel(),
          f"k={TOPK_K_MAX} blocked vs fused B1: {same_idx} of {bi.numel()} "
          f"indices and {same_val} values bitwise equal")
    print(f"[kernel] B5 topk_smallest R={R} n={n} k={kb} on B4's "
          f"transpose: indices and values equal the plain version's; at "
          f"k={TOPK_K_MAX} blocked vs fused B1: {same_idx} of {bi.numel()} "
          f"indices and {same_val} values bitwise equal (checked)")
    # where the arms cross (ROADMAP A14): both at k = 32, the largest k
    # the fused arm takes
    cross = dict(b1=cuda_ms(torch, lambda: ops.distance_topk(
                     A, Cq, TOPK_K_MAX), 10),
                 b5=cuda_ms(torch, lambda: ops.topk_smallest(
                     X5, TOPK_K_MAX), 10))
    print(f"[time] k={TOPK_K_MAX} at N={N} Q={Q}: fused B1 "
          f"{cross['b1']:.4f} ms; blocked B4 + B5 "
          f"{kernels['B4']['ms'] + cross['b5']:.4f} ms (B4 "
          f"{kernels['B4']['ms']:.4f}, B5 {cross['b5']:.4f})")
    del E, X5, kv, ki, bv, bi, fv, fi

    # the blocked kNN arm past its byte budget: at N = 2^22 one bucket's
    # matrix would take 16 GiB, so the queries go through B4 and B5 in
    # chunks; sampled queries, chunk edges among them, against the plain
    # version
    N_big = 4 * KNN["n"]
    A_big = torch.randn((N_big, KNN["d"]), generator=gen).to(dev)
    step = max(1, dispatch.BLOCKED_BYTES // (4 * N_big))
    before = dict(ops.LAUNCHES)
    kv, ki = dispatch.distance_topk(A_big, Cq, kb, path="blocked")
    torch.cuda.synchronize()
    n_chunks = -(-Q // step)
    grew = {n: ops.LAUNCHES[n] - before[n] for n in before}
    check(grew["pairwise_sq_dist"] == grew["topk_smallest"] == n_chunks > 1,
          f"blocked kNN N={N_big}: launches {grew} for {n_chunks} chunks")
    sel = torch.tensor(sorted({*range(0, Q, 16), *(
        j for c0 in range(step, Q, step) for j in (c0 - 1, c0))}),
        device=dev)
    pv, pi = ref.distance_topk(A_big, Cq[sel], kb)
    dk, scale = pair_dist(A_big[ki[sel].long()], Cq[sel])
    dp, _ = pair_dist(A_big[pi.long()], Cq[sel])
    n_near = compare_ranked("blocked kNN chunked", ki[sel], pi,
                            near(dk, dp, scale), False)
    check(bool(near(kv[sel], pv, scale).all()),
          f"blocked kNN N={N_big}: values differ from the plain version")
    big_ms = cuda_ms(torch, lambda: dispatch.distance_topk(
        A_big, Cq, kb, path="blocked"), 3)
    print(f"[kernel] blocked kNN N={N_big} Q={Q} k={kb}: {n_chunks} chunks "
          f"of {step} queries (matrix budget {dispatch.BLOCKED_BYTES} "
          f"bytes), {big_ms:.4f} ms per bucket; {len(sel)} sampled queries "
          f"against the plain version, near_ties={n_near}")
    del A_big, kv, ki, pv, pi, dk, dp, scale

    # B9: one query at the GNB width, B3 at B = 1
    xg = Xg[0].contiguous()
    ks, ps = ops.gnb_scores(xg, mu, var, lp), ref.gnb_scores(xg, mu, var, lp)
    torch.cuda.synchronize()
    check(bool(torch.isclose(ks, ps, **TOL).all()),
          f"B9 main: scores differ by {float((ks - ps).abs().max())}")
    C = mu.shape[0]
    b, by = bound_ms(7 * C * d_g + C * d_g + C,
                     4 * (d_g + 2 * C * d_g + 2 * C), peaks)
    kernels["B9"] = dict(
        name="gnb_scores", route="cuda",
        source="src/repro_torch/kernels/csrc/gnb_score.cu",
        replaces="src/repro/kernels/gnb_score.py:20",
        max_abs_err=float((ks - ps).abs().max()),
        ms=device_ms(lambda: ops.gnb_scores(xg, mu, var, lp)),
        events_ms=cuda_ms(torch, lambda: ops.gnb_scores(xg, mu, var, lp),
                          200),
        plain_ms=cuda_ms(torch, lambda: ref.gnb_scores(xg, mu, var, lp),
                         200),
        bound_ms=b, bound_by=by, library_ms=None)
    print(f"[kernel] B9 gnb_scores C={C} d={d_g} (B3 at B=1, plan "
          f"{kgs.plan(1, C, d_g, sms)}): device {kernels['B9']['ms']:.4f} "
          f"ms (graph replay), events {kernels['B9']['events_ms']:.4f} ms, "
          f"max_abs_err={kernels['B9']['max_abs_err']:.3g}")

    # ---- slice 3: B6 and B7 on the int8 lattice of the main-path data

    def chunked(fn, Q, step=128):
        parts = [fn(i, min(Q, i + step)) for i in range(0, Q, step)]
        return tuple(torch.cat([p[j] for p in parts]) for j in range(2))

    def int_mm_dist(X8, Y8):
        """(n, d), (m, d) int8 -> (n, m) int32 lattice distances through
        one library call, ``torch._int_mm``, on operands zero-padded to a
        multiple of 32 features (at least 32)."""
        pad = max(32, -(-X8.shape[1] // 32) * 32) - X8.shape[1]
        Xp = torch.nn.functional.pad(X8, (0, pad))
        Yp = torch.nn.functional.pad(Y8, (0, pad))
        cross = torch._int_mm(Xp, Yp.T)
        xn = (X8.int() * X8.int()).sum(1, dtype=torch.int32)
        yn = (Y8.int() * Y8.int()).sum(1, dtype=torch.int32)
        return xn[:, None] - 2 * cross + yn[None, :]

    def library(what, fn, reps):
        """The library call's device time, or None (with the reason
        printed) where this build's ``torch._int_mm`` refuses the
        operands."""
        try:
            return cuda_ms(torch, fn, reps)
        except RuntimeError as err:
            print(f"[library] {what}: torch._int_mm refused: "
                  f"{str(err).splitlines()[0]}")
            return None

    scale_knn = qk.feature_scales(A.abs().amax(0))
    A8, C8 = qk.quantize_rows(A, scale_knn), qk.quantize_rows(Cq, scale_knn)
    N, d, Q = A8.shape[0], A8.shape[1], C8.shape[0]
    kq = KNN["k"]
    got = ops.distance_topk_q8(A8, C8, kq)
    equal_case("B6 main", got, chunked(
        lambda i, j: ref.distance_topk_q8(A8, C8[i:j], kq), Q))
    lib_ms = library("B6", lambda: torch.topk(int_mm_dist(C8, A8), kq,
                                              dim=1, largest=False), 3)
    if lib_ms is not None:
        lv = torch.topk(int_mm_dist(C8, A8), kq, dim=1, largest=False,
                        sorted=True).values
        check(torch.equal(lv, got[0]), "B6: the library call's distances "
              "differ from the kernel's")
    b, by = bound_ms(2 * N * Q * d, N * d + Q * d + 8 * Q * kq, peaks,
                     int8=True)
    kernels["B6"] = dict(
        name="distance_topk_q8", route="cuda",
        source="src/repro_torch/kernels/csrc/quantized.cu",
        replaces="src/repro/kernels/quantized.py:157", max_abs_err=0.0,
        ms=cuda_ms(torch, lambda: ops.distance_topk_q8(A8, C8, kq), 10),
        plain_ms=cuda_ms(torch, lambda: chunked(
            lambda i, j: ref.distance_topk_q8(A8, C8[i:j], kq), Q), 2),
        bound_ms=b, bound_by=by, library_ms=lib_ms)
    kernels["B6"]["serve_ms"] = kernels["B6"]["ms"]
    # past the lists: the (Q, N) lattice matrix, then B5's int32 mode
    kb = Q8_BLOCKED_K
    equal_case("B6 main k=64", ops.distance_topk_q8(A8, C8, kb), chunked(
        lambda i, j: ref.distance_topk_q8(A8, C8[i:j], kb), Q))
    big = dict(ms=cuda_ms(torch, lambda: ops.distance_topk_q8(A8, C8, kb), 5),
               matrix=cuda_ms(torch, lambda: qk.launch_dist(A8, C8), 5),
               plain=cuda_ms(torch, lambda: chunked(
                   lambda i, j: ref.distance_topk_q8(A8, C8[i:j], kb), Q), 1),
               lib=library("B6 k=64", lambda: torch.topk(
                   int_mm_dist(C8, A8), kb, dim=1, largest=False), 3))
    kernels["B6"]["k64"] = big
    print(f"[kernel] B6 distance_topk_q8 N={N} Q={Q} d={d} k={kq}: equal "
          f"to the plain version; at k={kb} (lattice matrix "
          f"{big['matrix']:.4f} ms, then B5 int32): {big['ms']:.4f} ms, "
          f"equal to the plain version (plain {big['plain']:.4f} ms, "
          f"library "
          f"{'none' if big['lib'] is None else format(big['lib'], '.4f')}"
          " ms)")
    del A8, C8, got

    # B7 at the K-Means fit shape, scales from the centroids as the quant
    # arm takes them; and at one serving bucket
    scale_km = qk.feature_scales(C2.abs().amax(0))
    A28, C28 = qk.quantize_rows(A2, scale_km), qk.quantize_rows(C2, scale_km)
    Aq28 = qk.quantize_rows(Aq2, scale_km)
    equal_case("B7 main", ops.distance_argmin_q8(A28, C28),
               ref.distance_argmin_q8(A28, C28))
    N, d, K = A28.shape[0], A28.shape[1], C28.shape[0]
    b, by = bound_ms(2 * N * K * d, N * d + K * d + 8 * N, peaks, int8=True)
    kernels["B7"] = dict(
        name="distance_argmin_q8", route="cuda",
        source="src/repro_torch/kernels/csrc/quantized.cu",
        replaces="src/repro/kernels/quantized.py:288", max_abs_err=0.0,
        ms=device_ms(lambda: ops.distance_argmin_q8(A28, C28)),
        events_ms=cuda_ms(torch, lambda: ops.distance_argmin_q8(A28, C28),
                          20),
        plain_ms=cuda_ms(torch, lambda: ref.distance_argmin_q8(A28, C28),
                         10),
        bound_ms=b, bound_by=by,
        library_ms=library("B7", lambda: torch.min(int_mm_dist(A28, C28),
                                                   dim=1), 10))
    equal_case("B7 serving bucket", ops.distance_argmin_q8(Aq28, C28),
               ref.distance_argmin_q8(Aq28, C28))
    kernels["B7"]["serve_ms"] = device_ms(
        lambda: ops.distance_argmin_q8(Aq28, C28))
    kernels["B7"]["serve_events_ms"] = cuda_ms(
        torch, lambda: ops.distance_argmin_q8(Aq28, C28), 200)
    print(f"[kernel] B7 distance_argmin_q8 N={N} K={K} d={d} "
          f"({qk.argmin_route(K, d)} route, plan "
          f"{qk.argmin_plan(N, K, d, sms)}): device {kernels['B7']['ms']:.4f}"
          f" ms (graph replay), events {kernels['B7']['events_ms']:.4f} ms, "
          f"equal to the plain version; at the serving bucket "
          f"N={MAX_BATCH} (plan {qk.argmin_plan(MAX_BATCH, K, d, sms)}): "
          f"device {kernels['B7']['serve_ms']:.4f} ms (graph replay), "
          f"events {kernels['B7']['serve_events_ms']:.4f} ms, equal to the "
          "plain version")
    # B2 at d = 1, K = 256: each PQ codebook fit of the ANN path (65,536
    # training rows) and encoding (every row)
    A1 = A2[:, :1].contiguous()
    C1 = A1[:KMEANS["K"]].clone()
    kernels["B2"]["d1"] = {}
    for n1 in (1 << 16, A1.shape[0]):
        A1n = A1[:n1].contiguous()
        err, n_near = argmin_case(A1n, C1, False, f"B2 d=1 N={n1}")
        b1, by1 = bound_ms(n1 * KMEANS["K"] * 3 + 2 * (n1 + KMEANS["K"]),
                           4 * (n1 + KMEANS["K"]) + 8 * n1, peaks)
        row = dict(
            ms=cuda_ms(torch, lambda: ops.distance_argmin(A1n, C1), 50),
            plain=cuda_ms(torch, lambda: ref.distance_argmin(A1n, C1), 10),
            lib=cuda_ms(torch, lambda: torch.cdist(A1n, C1).argmin(1), 10),
            bound=b1, by=by1)
        kernels["B2"]["d1"][n1] = row
        print(f"[kernel] B2 distance_argmin at d=1 N={n1} K={C1.shape[0]} "
              f"({kda.route(A1n, C1)} route; the ANN path's codebook "
              f"fits): kernel {row['ms']:.4f} ms, plain {row['plain']:.4f} "
              f"ms, library {row['lib']:.4f} ms (cdist + argmin), bound "
              f"{b1:.4f} ms ({by1}), max_abs_err={err:.3g} "
              f"near_ties={n_near}")
    del A28, C28, Aq28, A1, C1, A1n
    for kr in kernels.values():
        kr["launches"] = 0
    for key, kr in kernels.items():
        lib = "none" if kr["library_ms"] is None else \
            f"{kr['library_ms']:.4f}"
        print(f"[time] {key} {kr['name']}: kernel {kr['ms']:.4f} ms, plain "
              f"{kr['plain_ms']:.4f} ms, library {lib} ms, bound "
              f"{kr['bound_ms']:.4f} ms ({kr['bound_by']})")
    del A2, C2, Aq2

    # ------------------------------------------------ 3. the paths
    def drive(algo, data, groups, *, est=None, policy=None,
              ref_batch=MAX_BATCH, **kw):
        """Fit (or take ``est``, fitted by an earlier path), warm every
        bucket and serve the queries through an engine of ``policy``, with
        the launch counts set to 0 just before and read just after."""
        Xtr, ytr, Xq, yq = data
        ops.reset_launches()
        t0 = time.perf_counter()
        setup = "fit+warmup+serve" if est is None else \
            "quantize+warmup+serve"
        if est is None:
            est = est_mod.make_fitted(algo, Xtr, ytr, n_groups=groups,
                                      device=dev, **kw)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        engine = NonNeuralServeEngine(est, max_batch=MAX_BATCH, device=dev,
                                      policy=policy)
        engine.warmup_buckets(Xtr.shape[1])
        warmed = set(engine.warmed)
        res = engine.classify(Xq)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        routes = dict(b1=dict(kdt.ROUTE_LAUNCHES), b6=dict(qk.ROUTE_LAUNCHES),
                      b4=dict(kpd.ROUTE_LAUNCHES), b5=dict(kts.ROUTE_LAUNCHES),
                      b2=dict(kda.ROUTE_LAUNCHES),
                      b8=dict(kann.ROUTE_LAUNCHES),
                      b3=dict(kgs.ROUTE_LAUNCHES),
                      b7=dict(qk.ARGMIN_ROUTE_LAUNCHES))
        wall = time.perf_counter() - t0
        check(set(engine.bucket_launches) <= warmed,
              f"{algo}: served buckets {sorted(engine.bucket_launches)} "
              f"not all warmed {sorted(warmed)}")
        check(res.classes.shape == (len(Xq),) and res.launches == 4,
              f"{algo}: {tuple(res.classes.shape)} in {res.launches}")
        check(bool(((res.classes >= 0) & (res.classes < groups)).all()),
              f"{algo}: a class outside [0, {groups})")
        # timed serving after warmup, outside the counted run: queries
        # from host memory as a caller sends them, and already on the card
        def timed(queries, reps=5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                engine.classify(queries)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / reps * 1e3

        call_ms = (timed(Xq), timed(on_card(Xq)))
        # the plain versions on the params the engine served (for the
        # int8 tier, its quantized copy)
        served = engine.estimator
        kw_ref = {"k": served.k} if algo in ("knn", "ann") else {}
        if algo == "ann":
            kw_ref.update(nprobe=served.nprobe, refine=served.refine)
        est_ref = type(served).from_params(served.params, path="ref",
                                           device=dev, **kw_ref)
        res_ref = NonNeuralServeEngine(est_ref, max_batch=ref_batch,
                                       device=dev).classify(Xq)
        torch.cuda.synchronize()
        acc = float((res.classes.cpu().numpy() == yq).mean())
        return dict(est=served, res=res, res_ref=res_ref, launches=launches,
                    routes=routes, call_ms=call_ms, acc=acc, wall=wall, setup=setup,
                    fit_s=fit_s, engine=engine,
                    n_buckets=len(warmed) + res.launches)

    def report(algo, keys, run, extra, bucket_ms=0.0):
        """One line per path: served q/s from the host clock, the share of
        a classify call that its kernels' device time (at the bucket
        shape, from CUDA events) accounts for, and each kernel's launches
        in the counted run.  A path without a kernel must launch none."""
        launches = run["launches"]
        counts = []
        for key in keys:
            kr = kernels[key]
            count = launches[kr["name"]]
            check(count > 0, f"{algo}: kernel {key} {kr['name']} was never "
                  "launched on the path")
            kr["launches"] += count
            counts.append(f"{key} launches={count} (kernel {kr['ms']:.4f} "
                          f"ms, plain {kr['plain_ms']:.4f} ms)")
        if not keys:
            check(not any(launches.values()),
                  f"{algo}: kernels ran on a path that has none: {launches}")
            counts.append("no kernel on this path (launches all 0)")
        host_ms, card_ms = run["call_ms"]
        share = (f", kernel time {4 * bucket_ms / host_ms:.3f} and "
                 f"{4 * bucket_ms / card_ms:.3f} of those") if keys else ""
        print(f"[path] {algo}: {N_QUERIES / host_ms * 1e3:.1f} q/s served "
              f"(classify of {N_QUERIES} in 4 buckets of {MAX_BATCH}: "
              f"{host_ms:.4f} ms from host memory, {card_ms:.4f} ms from "
              f"the card{share}), {', '.join(counts)}, "
              f"acc={run['acc']:.4f}, {run['setup']} {run['wall']:.2f}s; "
              f"{extra}")

    def knn_checks(what, run):
        """Neighbours against the ref arm, near-ties allowed; a class may
        differ only where the neighbours do."""
        res, res_ref = run["res"], run["res_ref"]
        check(run["acc"] >= 0.95, f"{what} accuracy {run['acc']}")
        Aq, Qq = run["est"].params.A, on_card(knn_data[2])
        dk, scale = pair_dist(Aq[res.aux.long()], Qq)
        dp, _ = pair_dist(Aq[res_ref.aux.long()], Qq)
        n_near = compare_ranked(f"{what} serve", res.aux, res_ref.aux,
                                near(dk, dp, scale), False)
        odd = res.classes != res_ref.classes
        check(bool((res.aux != res_ref.aux).any(1)[odd].all()),
              f"{what}: a class differs from the ref arm without a near-tie")
        return n_near, int(odd.sum())

    def kmeans_checks(what, run):
        """The fit against the ref arm's fit, assignments against ref."""
        est, res, res_ref = run["est"], run["res"], run["res_ref"]
        fit_ref = est_mod.make_fitted("kmeans", km_data[0], None,
                                      n_groups=KMEANS["K"], device=dev,
                                      path="ref")
        check(int(est.params.n_iter) == int(fit_ref.params.n_iter),
              f"{what}: {int(est.params.n_iter)} iterations, ref arm "
              f"{int(fit_ref.params.n_iter)}")
        check(torch.allclose(est.params.centroids, fit_ref.params.centroids,
                             **TOL), f"{what}: fitted centroids differ from "
              "the ref arm's")
        Qk, cen = on_card(km_data[2]), est.params.centroids
        dk, scale = (t[:, 0] for t in pair_dist(
            cen[res.classes.long()][:, None], Qk))
        dp, _ = pair_dist(cen[res_ref.classes.long()][:, None], Qk)
        n_near = compare_ranked(f"{what} serve", res.classes,
                                res_ref.classes, near(dk, dp[:, 0], scale),
                                False)
        check(bool(near(res.aux, res_ref.aux, scale).all()),
              f"{what}: assignment distances differ from the ref arm's")
        # the first K rows seed one centroid in each of the K blobs, so a
        # right fit assigns every query to its own blob
        check(run["acc"] >= 0.95, f"{what}: {run['acc']} of the queries in "
              "their blob")
        return int(est.params.n_iter), n_near

    def gauss_scale(X, mu, var):
        """Size of the terms of the GEMM-identity log-density (x² and x·mu
        over var, and the per-component constant): the rounding of a
        log-responsibility follows it, not the log-responsibility."""
        inv = 1.0 / var
        return (X * X) @ (0.5 * inv).T + X.abs() @ (mu * inv).abs().T + \
            0.5 * (mu * mu * inv + torch.log(var).abs() + math.log(
                2 * math.pi)).sum(1)

    def gmm_checks(what, run, Xq):
        """Log-responsibilities against the ref arm (the chunked E-step);
        a class may differ only where the ref arm's top two are a
        near-tie."""
        est, res, res_ref = run["est"], run["res"], run["res_ref"]
        p = est.params
        scale = gauss_scale(on_card(Xq), p.mu.float(), p.var.float())
        check(bool(torch.isfinite(res.aux).all()),
              f"{what}: a log-responsibility is not finite")
        diff = (res.aux - res_ref.aux).abs()
        check(bool((diff <= TOL["atol"] + TOL["rtol"] * scale).all()),
              f"{what}: log-responsibilities differ from the ref arm's by "
              f"{float(diff.max())}")
        odd = res.classes != res_ref.classes
        top2 = res_ref.aux.topk(2, dim=1).values
        tie = (top2[:, 0] - top2[:, 1]).abs() <= TOL["atol"] + \
            TOL["rtol"] * scale.max(1).values
        check(bool(tie[odd].all()),
              f"{what}: a class differs from the ref arm without a "
              "near-tie")
        return float(diff.max()), int(odd.sum()), int(p.n_iter)

    # kNN, k = 4: the fused B1
    run = drive("knn", knn_data, KNN["classes"])
    n_near, n_odd = knn_checks("knn", run)
    check(run["routes"]["b1"] == {"bulk": run["launches"]["distance_topk"],
                                  "plain": 0},
          f"knn: B1 routes {run['routes']['b1']} for "
          f"{run['launches']['distance_topk']} launches: not all on the bulk "
          "route")
    report("knn", ["B1"], run, f"near_ties={n_near}, classes differing at "
           f"near-ties={n_odd}", kernels["B1"]["serve_ms"])
    fitted = {"knn": run["est"]}     # served again by the int8 tier
    del run

    # kNN, k = 64: past B1's lists, the selector takes the blocked arm;
    # every bucket of the counted run goes through B4 then B5
    sizes = sorted({min(MAX_BATCH, 1 << i) for i in range(11)})
    arms = {dispatch.resolve("knn", "distance_topk", N=KNN["n"], d=KNN["d"],
                             Q=q, k=KNN_BLOCKED_K).name for q in sizes}
    check(arms == {"blocked"}, f"knn k={KNN_BLOCKED_K} resolves to {arms}")
    run = drive("knn", knn_data, KNN["classes"], k=KNN_BLOCKED_K)
    n_near, n_odd = knn_checks(f"knn k={KNN_BLOCKED_K}", run)
    ln = run["launches"]
    check(ln["pairwise_sq_dist"] == ln["topk_smallest"] == run["n_buckets"]
          and ln["distance_topk"] == 0,
          f"knn k={KNN_BLOCKED_K}: {run['n_buckets']} buckets, launches "
          f"{ln}: a bucket did not go through B4 and B5")
    check(run["routes"]["b4"] == {"bulk": run["n_buckets"], "plain": 0} and
          run["routes"]["b5"] == {"filter": run["n_buckets"], "radix": 0},
          f"knn k={KNN_BLOCKED_K}: B4 routes {run['routes']['b4']}, B5 "
          f"routes {run['routes']['b5']}: not every launch on bulk/filter")
    report(f"knn k={KNN_BLOCKED_K}", ["B4", "B5"], run,
           f"all {run['n_buckets']} buckets through B4 (bulk route) then B5 "
           f"(filter route), no B1 and "
           f"no plain version, near_ties={n_near}, classes differing at "
           f"near-ties={n_odd}",
           kernels["B4"]["serve_ms"] + kernels["B5"]["serve_ms"])
    del run

    # K-Means: the fused B2, in the fit (the bulk route, n_iter + 1
    # launches) and in serving (the narrow route, one launch a bucket)
    run = drive("kmeans", km_data, KMEANS["K"])
    n_iter, n_near = kmeans_checks("kmeans", run)
    want_b2 = dict.fromkeys(kda.ROUTES, 0)
    want_b2.update(bulk=n_iter + 1, narrow=run["n_buckets"])
    check(run["routes"]["b2"] == want_b2 and
          run["launches"]["distance_argmin"] == n_iter + 1 + run["n_buckets"],
          f"kmeans: B2 routes {run['routes']['b2']}, expected {want_b2}")
    report("kmeans", ["B2"], run, f"n_iter={n_iter} (ref arm the same), "
           f"near_ties={n_near}, B2 routes {run['routes']['b2']}",
           kernels["B2"]["serve_ms"])
    fitted["kmeans"] = run["est"]
    del run

    # K-Means, blocked: REPRO_BACKEND selects B4 + min/argmin everywhere
    os.environ["REPRO_BACKEND"] = "blocked"
    try:
        run = drive("kmeans", km_data, KMEANS["K"])
    finally:
        del os.environ["REPRO_BACKEND"]
    check(run["launches"]["distance_argmin"] == 0,
          f"kmeans blocked: B2 ran {run['launches']['distance_argmin']} "
          "times")
    n_iter, n_near = kmeans_checks("kmeans blocked", run)
    report("kmeans blocked", ["B4"], run, f"REPRO_BACKEND=blocked, "
           f"n_iter={n_iter} (ref arm the same), near_ties={n_near}",
           kernels["B4"]["serve_ms_kmeans"])
    del run

    # GNB: scores against the ref arm, classes equal but at near-ties
    run = drive("gnb", gnb_data, GNB["classes"])
    res, res_ref = run["res"], run["res_ref"]
    check(run["acc"] >= 0.95, f"gnb accuracy {run['acc']}")
    check(torch.allclose(res.aux, res_ref.aux, **TOL),
          "gnb: scores differ from the ref arm's")
    odd = res.classes != res_ref.classes
    top2 = res_ref.aux.topk(2, dim=1).values
    check(bool(torch.isclose(top2[:, 0], top2[:, 1], **TOL)[odd].all()),
          "gnb: a class differs from the ref arm without a near-tie")
    n_b3 = run["launches"]["gnb_scores_batch"]
    check(run["routes"]["b3"] == {"resident": n_b3, "stream": 0},
          f"gnb: B3 routes {run['routes']['b3']}: not all of its {n_b3} "
          "launches on the resident route")
    report("gnb", ["B3"], run, f"classes differing at near-ties="
           f"{int(odd.sum())}, every B3 launch on the resident route",
           kernels["B3"]["serve_ms"])
    fitted["gnb"] = run["est"]

    # B9's own entry, ops.gnb_scores: one query at a time against the
    # fitted moments, each equal to its row of the served batch
    singles = 16
    p = run["est"].params
    Xs = on_card(gnb_data[2][:singles])
    ops.reset_launches()
    one = [ops.gnb_scores(Xs[i], p.mu, p.var, p.log_prior)
           for i in range(singles)]
    torch.cuda.synchronize()
    b9 = dict(launches=dict(ops.LAUNCHES))
    check(b9["launches"]["gnb_scores"] == singles and
          sum(b9["launches"].values()) == singles,
          f"gnb one query: launches {b9['launches']} for {singles} calls")
    check(kgs.ROUTE_LAUNCHES == {"resident": singles, "stream": 0},
          f"gnb one query: B3 routes {kgs.ROUTE_LAUNCHES} for {singles} "
          "calls, not all resident")
    for i, s1 in enumerate(one):
        check(torch.allclose(s1, res.aux[i], **TOL),
              f"gnb one query: scores of query {i} differ from its batch "
              "row")
    n_launch = kernels["B9"]["launches"] = b9["launches"]["gnb_scores"]
    print(f"[path] gnb one query: ops.gnb_scores (B9) launches={n_launch} "
          f"(kernel {kernels['B9']['ms']:.4f} ms, plain "
          f"{kernels['B9']['plain_ms']:.4f} ms) for {singles} queries, "
          "all on B3's resident route, scores equal to their rows of the "
          "served batch")
    del run, res, res_ref, one, Xs

    # GMM at the GNB width: EM on the chunked E-step, served through B3
    run = drive("gmm", gnb_data, GNB["classes"])
    check(run["acc"] >= 0.95, f"gmm wide: {run['acc']} of the queries in "
          "their blob")
    err, n_odd, n_iter = gmm_checks("gmm wide", run, gnb_data[2])
    n_b3 = run["launches"]["gnb_scores_batch"]
    check(run["routes"]["b3"] == {"resident": n_b3, "stream": 0},
          f"gmm wide: B3 routes {run['routes']['b3']}: not all of its "
          f"{n_b3} launches on the resident route")
    report("gmm wide", ["B3"], run, f"n_iter={n_iter}, log-resp max diff "
           f"from the ref arm {err:.3g}, classes differing at near-ties="
           f"{n_odd}, every B3 launch on the resident route",
           kernels["B3"]["serve_ms"])
    fitted["gmm"] = run["est"]
    del run

    # GMM at the kNN width: d < 64, the ref arm (no kernel)
    narrow = tuple(a[:GMM_NARROW_ROWS] for a in knn_data[:2]) + \
        knn_data[2:]
    run = drive("gmm", narrow, KNN["classes"])
    check(run["acc"] >= 0.95, f"gmm narrow: {run['acc']} of the queries "
          "in their blob")
    check(torch.equal(run["res"].classes, run["res_ref"].classes) and
          torch.equal(run["res"].aux, run["res_ref"].aux),
          "gmm narrow: the default arm differs from the ref arm")
    report("gmm narrow", [], run, f"n_iter={int(run['est'].params.n_iter)}"
           f", {GMM_NARROW_ROWS} training rows, equal to the ref arm")
    del run

    # RF at the reference's defaults: host CART, traversal in torch ops
    rf_data = (knn_data[0][:RF["n"]], knn_data[1][:RF["n"]]) + knn_data[2:]
    run = drive("rf", rf_data, KNN["classes"], n_trees=RF["trees"],
                max_depth=RF["depth"])
    check(run["acc"] >= 0.95, f"rf accuracy {run['acc']}")
    check(torch.equal(run["res"].classes, run["res_ref"].classes) and
          torch.equal(run["res"].aux, run["res_ref"].aux) and
          bool((run["res"].aux.sum(1) == RF["trees"]).all()),
          "rf: votes differ from the ref arm's or do not sum to the trees")
    report("rf", [], run, f"{RF['trees']} trees of depth <= {RF['depth']} "
           f"on {RF['n']} rows, traversal depth "
           f"{run['est']._depth}, votes equal to the ref arm")
    fitted["rf"] = run["est"]
    del run

    # ------------------------------------------------ 4. the int8 tier
    # the estimators fitted above, served through the engine's int8 tier
    # (an engine-local quantized copy); the plain versions serve the same
    # quantized params with path="ref", integer for integer
    def int8_checks(what, run, exact_aux=True):
        res, res_ref = run["res"], run["res_ref"]
        check(run["est"].quantized and not fitted[what].quantized,
              f"{what} int8: the engine did not serve a local quantized "
              "copy")
        check(run["acc"] >= 0.95, f"{what} int8: accuracy {run['acc']}")
        check(torch.equal(res.classes, res_ref.classes) and
              (not exact_aux or torch.equal(res.aux, res_ref.aux)),
              f"{what} int8: differs from the plain versions on the same "
              "quantized params")
        r = run["engine"].quant_report
        return f"params {r['bytes_fp32']} B fp32 -> {r['bytes_int8']} B int8"

    run = drive("knn", knn_data, KNN["classes"], est=fitted["knn"],
                policy="int8", ref_batch=256)
    msg = int8_checks("knn", run)
    check(run["launches"]["distance_topk_q8"] == run["n_buckets"],
          f"knn int8: launches {run['launches']}")
    check(run["routes"]["b6"] == {"bulk": run["n_buckets"], "plain": 0},
          f"knn int8: B6 routes {run['routes']['b6']}: not all on the bulk "
          "route")
    report("knn int8", ["B6"], run, f"{msg}; neighbours and classes equal "
           "to the plain version's", kernels["B6"]["serve_ms"])
    del run
    run = drive("kmeans", km_data, KMEANS["K"], est=fitted["kmeans"],
                policy="int8")
    msg = int8_checks("kmeans", run)
    n_b7 = run["launches"]["distance_argmin_q8"]
    check(run["routes"]["b7"] == {"resident": n_b7, "stream": 0},
          f"kmeans int8: B7 routes {run['routes']['b7']}: not all of its "
          f"{n_b7} launches on the resident route")
    report("kmeans int8", ["B7"], run, f"{msg}; assignments and distances "
           "equal to the plain version's, every B7 launch on the resident "
           "route", kernels["B7"]["serve_ms"])
    del run
    for algo, data, groups in (("gnb", gnb_data, GNB["classes"]),
                               ("gmm", gnb_data, GNB["classes"]),
                               ("rf", rf_data, KNN["classes"])):
        run = drive(algo, data, groups, est=fitted[algo], policy="int8")
        msg = int8_checks(algo, run)
        label = "gmm wide" if algo == "gmm" else algo
        report(f"{label} int8", [], run, f"{msg}; affine scores over int8 "
               "features" if algo != "rf" else f"{msg}; int8 thresholds")
        del run
    streamed = {algo: fitted[algo] for algo in ("knn", "gnb")}
    # the one-device fits the sharded phase holds its fits against
    shard_fits = dict(fitted)
    # served again by the autotune and ladder phases
    fitted = {algo: fitted[algo] for algo in ("knn", "kmeans", "gnb")}

    # ------------------------------------------------ 5. IVF-PQ ANN
    from repro_torch.core.ann import build_query_luts
    from repro_torch.kernels.ann import adc_dmax
    ann_data = blobs(ANN["n"], ANN["d"], ANN["classes"], SEED + 3)
    run = drive("ann", ann_data, ANN["classes"], k=ANN["k"],
                n_cells=ANN["cells"], nprobe=ANN["nprobe"], pq_m=ANN["pq_m"],
                n_codes=ANN["n_codes"], refine=ANN["refine"],
                train_iters=ANN["train_iters"])
    est, res, res_ref = run["est"], run["res"], run["res_ref"]
    p = est.params
    L = est.serve_cost_shape()["L"]
    check(run["acc"] >= 0.95, f"ann: accuracy {run['acc']}")
    # recall@10 against exact fused kNN (B1) over the same rows
    Qa = on_card(ann_data[2])
    exact = torch.cat([ops.distance_topk(p.refs, Qa[i:i + MAX_BATCH],
                                         ANN["k"])[1]
                       for i in range(0, len(Qa), MAX_BATCH)])
    hits = (res.aux[:, :, None] == exact[:, None, :]).any(2).sum(1)
    recall = float(hits.float().mean()) / ANN["k"]
    check(recall >= 0.95, f"ann: recall@{ANN['k']} {recall} < 0.95")
    # neighbours against the plain versions: the LUT and the integer
    # distances are one computation, so a query may differ only where
    # B1's fp32 probe and the plain probe rank two cells at a near-tie
    differ = (res.aux != res_ref.aux).any(1)
    n_odd = int(differ.sum())
    if n_odd:
        pk = ops.distance_topk(p.centroids, Qa[differ], ANN["nprobe"])[1]
        pr = ref.distance_topk(p.centroids, Qa[differ], ANN["nprobe"])[1]
        dk, scale = pair_dist(p.centroids[pk.long()], Qa[differ])
        dp, _ = pair_dist(p.centroids[pr.long()], Qa[differ])
        check(bool((pk != pr).any(1).all()) and
              bool(((pk == pr) | near(dk, dp, scale)).all()),
              f"ann: {n_odd} queries differ from the plain versions without "
              "a near-tie in the probe")
    check(torch.equal(res.classes[~differ], res_ref.classes[~differ]),
          "ann: a class differs from the plain versions' with the same "
          "neighbours")

    # B8 at the path's bucket shape: the first bucket's LUTs and candidates
    Xb = Qa[:MAX_BATCH]
    _, cells = ops.distance_topk(p.centroids, Xb, ANN["nprobe"])
    cand = p.cell_ids[cells.long()].reshape(MAX_BATCH, -1).contiguous()
    qlut = build_query_luts(Xb, p.codebooks)
    codes = p.codes[cand.clamp(min=0).long()].contiguous()
    want = max(ANN["k"], ANN["refine"])
    Q, L, m = codes.shape
    n_codes = qlut.shape[1] // m
    # k = max(k, refine) on the fused route, and on either side of its
    # capacity (the fused route, then the matrix and B5)
    for k8 in (want, kann.FUSED_K_MAX, kann.FUSED_K_MAX + 1):
        before = dict(kann.ROUTE_LAUNCHES)
        equal_case(f"B8 main k={k8}", ops.adc_topk(qlut, codes, cand, k8),
                   chunked(lambda i, j: ref.adc_topk(
                       qlut[i:j], codes[i:j], cand[i:j], k8), Q))
        way = kann.route(k8)
        check(kann.ROUTE_LAUNCHES[way] > before[way],
              f"B8 main k={k8}: routes {kann.ROUTE_LAUNCHES}, the rule "
              f"gives {way}")
        print(f"[kernel] B8 adc_topk at the bucket k={k8} ({way} route): "
              "distances and positions equal to the plain version")
    flat = (codes.long() + 128 + torch.arange(m, device=dev) * n_codes
            ).reshape(Q, L * m)

    def adc_library():
        e = torch.gather(qlut, 1, flat).view(Q, L, m).sum(2)
        return torch.topk(torch.where(cand < 0, adc_dmax(m), e), want,
                          dim=1, largest=False)

    # bytes: the ids of every candidate, the codes of the valid ones (a
    # padding slot's distance is the sentinel, known from its id), the
    # LUTs, the output; ops: one add per looked-up entry of a valid
    # candidate, at the fp32 rate of the CUDA cores
    n_valid = int((cand >= 0).sum())
    b, by = bound_ms(n_valid * m, n_valid * m + 4 * Q * L
                     + 4 * qlut.numel() + 8 * Q * want, peaks)
    kernels["B8"] = dict(
        name="adc_topk", route="cuda",
        source="src/repro_torch/kernels/csrc/adc_topk.cu",
        replaces="src/repro/kernels/ann.py:105", max_abs_err=0.0,
        ms=cuda_ms(torch, lambda: ops.adc_topk(qlut, codes, cand, want), 10),
        plain_ms=cuda_ms(torch, lambda: chunked(lambda i, j: ref.adc_topk(
            qlut[i:j], codes[i:j], cand[i:j], want), Q), 2),
        bound_ms=b, bound_by=by,
        library_ms=cuda_ms(torch, adc_library, 3), launches=0)
    dist_ms = cuda_ms(torch, lambda: kann.launch_dist(qlut, codes, cand), 10)
    invalid = float((cand < 0).float().mean())
    print(f"[kernel] B8 adc_topk Q={Q} L={L} m={m} n_codes={n_codes} "
          f"k={want} ({kann.route(want)} route, one launch): equal to the "
          f"plain version; the matrix route's distances alone "
          f"{dist_ms:.4f} ms; {invalid:.3f} of the candidates are list "
          "padding")
    # B5's int32 key mode at the ANN shape: the ADC distance matrix of
    # this bucket, k = max(k, refine)
    e_ann = kann.launch_dist(qlut, codes, cand)
    before = dict(kts.ROUTE_LAUNCHES)
    got = ops.topk_smallest(e_ann, want)
    check(kts.ROUTE_LAUNCHES["filter"] == before["filter"] + 1,
          f"B5 int32 ANN: routes {kts.ROUTE_LAUNCHES}")
    equal_case("B5 int32 ANN", got, chunked(
        lambda i, j: ref.topk_smallest(e_ann[i:j], want), Q))
    b, by = bound_ms(e_ann.numel(), 4 * e_ann.numel() + 8 * Q * want, peaks)
    b5_ann = dict(
        ms=cuda_ms(torch, lambda: ops.topk_smallest(e_ann, want), 20),
        plain=cuda_ms(torch, lambda: chunked(
            lambda i, j: ref.topk_smallest(e_ann[i:j], want), Q), 3),
        lib=cuda_ms(torch, lambda: torch.topk(e_ann, want, dim=1,
                                              largest=False), 20),
        bound=b, by=by)
    kernels["B5"]["ann_int32"] = b5_ann
    print(f"[time] B5 int32 at the ANN shape R={Q} n={L} k={want} (filter "
          f"route): kernel {b5_ann['ms']:.4f} ms, plain "
          f"{b5_ann['plain']:.4f} ms, library {b5_ann['lib']:.4f} ms "
          f"(torch.topk), bound {b:.4f} ms ({by}); bit-equal to the plain "
          "version")
    del e_ann, got
    del flat, codes, cand, qlut
    # every launch's route: B2 in the fit on its bulk route (the cells,
    # d = 21) and rows route (the codebooks, d = 1); B8 fused, one launch a
    # bucket, no B5
    ln, rt = run["launches"], run["routes"]
    check(set(k_ for k_, v in rt["b2"].items() if v) <= {"bulk", "rows"} and
          rt["b2"]["bulk"] > 0 and rt["b2"]["rows"] > 0 and
          sum(rt["b2"].values()) == ln["distance_argmin"],
          f"ann: B2 routes {rt['b2']} for {ln['distance_argmin']} launches")
    check(rt["b8"] == {"fused": run["n_buckets"], "matrix": 0} and
          ln["adc_topk"] == run["n_buckets"] and ln["topk_smallest"] == 0,
          f"ann: B8 routes {rt['b8']}, launches {ln} for "
          f"{run['n_buckets']} buckets")
    report("ann", ["B2", "B1", "B8"], run,
           f"fit {run['fit_s']:.2f}s, L={L} candidates per query "
           f"(nprobe={ANN['nprobe']}, {p.cell_ids.shape[0]} cells of "
           f"capacity {p.cell_ids.shape[1]}), recall@{ANN['k']}="
           f"{recall:.4f} against exact fused kNN, refine={ANN['refine']}; "
           f"neighbours equal to path='ref' but {n_odd} queries at probe "
           f"near-ties; B2 routes {rt['b2']}, B8 routes {rt['b8']}",
           kernels["B8"]["ms"])
    shard_fits["ann"] = est
    del run, est, res, res_ref, p, Qa, exact

    # ------------------------------------------------ 6. the LM path
    del A, Cq, Xg, mu, var, lp, xg, ks, ps
    torch.cuda.empty_cache()
    # the path first: its host-clock times come before any profiler window
    run = lm_path(torch, ops, dev, lm_cfg)
    lm_kernels, b10 = lm_kernel_times(torch, ops, ref, dev, lm_gen, lm_cfg,
                                      peaks)
    kernels.update(lm_kernels)
    kernels["B10"]["launches"] = run["launches"]["matmul"]
    kernels["B11"]["launches"] = run["launches"]["flash_attention"]
    # B10 and B11's share, from their device times at the path's shapes
    L_ = lm_cfg.n_layers
    run["b10_prefill"] = L_ * (4 * b10["prefill qkvo"]["dev_ms"] +
                               2 * b10["prefill in/gate"]["dev_ms"] +
                               b10["prefill out"]["dev_ms"]) + \
        b10["unembed"]["dev_ms"]
    run["b11_prefill"] = L_ * kernels["B11"]["dev_ms"]
    run["b10_step"] = L_ * (4 * b10["decode qkvo"]["dev_ms"] +
                            2 * b10["decode in/gate"]["dev_ms"] +
                            b10["decode out"]["dev_ms"]) + \
        b10["unembed"]["dev_ms"]
    Bt, new = LM["batch"], LM["new"]
    pre, step = run["prefill_ms"], run["step_ms"]

    def share(busy, wall):
        return "not measured" if busy is None else \
            f"{busy:.2f} ms = {busy / wall:.3f}"
    print(f"[path] lm {lm_cfg.arch_id} batch={Bt} prompt={LM['prompt']} "
          f"new={new}: generate {run['gen_s']:.3f}s "
          f"({Bt * new / run['gen_s']:.1f} tok/s); prefill {pre:.2f} ms "
          f"(device busy {share(run['prefill_dev_ms'], pre)}, "
          f"B10 device {run['b10_prefill']:.2f} ms = "
          f"{run['b10_prefill'] / pre:.3f}, B11 {run['b11_prefill']:.3f} ms "
          f"= {run['b11_prefill'] / pre:.4f}); decode step {step:.2f} ms "
          f"({Bt / step * 1e3:.1f} tok/s; device busy "
          f"{share(run['step_dev_ms'], step)}, "
          f"B10 device {run['b10_step']:.2f} ms = "
          f"{run['b10_step'] / step:.3f}); "
          f"B10 launches={run['launches']['matmul']} B11 "
          f"launches={run['launches']['flash_attention']} (the shapes "
          f"imply them); against the plain route, teacher-forced: logits "
          f"within {run['worst']:.3f} of the tolerance, {run['differ']} of "
          f"{run['decisions']} greedy tokens differ from its argmax, all at "
          f"near-ties ({run['near']} near-ties); first row "
          f"{run['first']}")
    lay = run["layers"]
    print(f"[path] lm routes: B10 {run['routes']['b10']}, B11 "
          f"{run['routes']['b11']} (the design implies them); per layer, "
          f"one teacher-forced prefill: ‖kernel − plain‖ within "
          f"{LAYER_FACTOR} x ‖plain − fp32‖ at all {lm_cfg.n_layers} layers,"
          f" at most {lay['worst']:.3f} x (layer {lay['worst_layer']}); "
          f"layer 0 {lay['first'][0]:.4g} against {lay['first'][1]:.4g}, "
          f"layer {lm_cfg.n_layers - 1} {lay['last'][0]:.4g} against "
          f"{lay['last'][1]:.4g} (‖fp32 state‖ {lay['scale']:.4g})")
    del run

    # ------------------------------------------------ 6a. seven more archs
    # deepseek-67b and nemotron-4-340b layer-cut, whisper-large-v3,
    # phi-3-vision-4.2b, gemma-7b and mamba2-780m at full depth, jamba
    # reduced, each freed before the next
    for spec in LM_ARCHS:
        launches = lm_arch_path(torch, ops, dev, spec)
        kernels["B10"]["launches"] += launches["matmul"]
        kernels["B11"]["launches"] += launches["flash_attention"]
        kernels["B5"]["launches"] += launches["topk_smallest"]

    # ------------------------------------------------ 6b. the MoE LM path
    # stablelm's weights are gone (lm_path, lm_kernel_times); qwen3's 61.1
    # GB take the card's memory next, so the caches go back first
    torch.cuda.empty_cache()
    hand: dict = {}
    launches = moe_path(torch, ops, ref, dev, moe_cfg, peaks, hand_on=hand)
    kernels["B5"]["launches"] += launches["topk_smallest"]
    kernels["B10"]["launches"] += launches["matmul"]
    kernels["B11"]["launches"] += launches["flash_attention"]

    # ------------------------------------------------ 6c. the MoE two-phase
    # the same weights through the planned steps on a (1, 8) mesh, then
    # freed before the request streams
    launches = moe_two_phase_path(torch, ops, dev, moe_cfg, hand)
    hand.clear()
    torch.cuda.empty_cache()
    kernels["B5"]["launches"] += launches["topk_smallest"]
    kernels["B10"]["launches"] += launches["matmul"]
    kernels["B11"]["launches"] += launches["flash_attention"]


    # ------------------------------------------------ 7. request streams
    # the fitted kNN and GNB estimators behind RequestScheduler (one
    # warmed engine each, launch counts read around warmup and replay)
    helpers = dict(on_card=on_card, pair_dist=pair_dist, near=near,
                   compare_ranked=compare_ranked)
    knn_q = knn_data[2]
    for algo, key, queries, cache in (
            ("knn", "B1", knn_q, 0), ("gnb", "B3", gnb_data[2], 0),
            ("knn", "B1", knn_q[:STREAM["cache_rows"]],
             STREAM["cache_size"])):
        kernels[key]["launches"] += stream_path(
            torch, ops, dev, streamed[algo], kernels[key], queries, helpers,
            cache_size=cache)
    del streamed

    # ------------------------------------------------ 8. LR and SVM
    linear_path(torch, ops, dev, gnb_data, GNB["classes"])

    # ------------------------------------------------ 9. tenants
    torch.cuda.empty_cache()
    tenants_path(torch, ops, ref, dev, peaks, kernels, helpers)

    # ------------------------------------------------ 10. autotune
    torch.cuda.empty_cache()
    queries = {"knn": knn_data[2], "kmeans": km_data[2],
               "gnb": gnb_data[2]}
    knn32 = autotune_path(torch, ops, dev, fitted, queries, kernels, helpers)

    # ------------------------------------------------ 11. calibrate
    calibrate_path(torch, ops, dev, knn32, queries["knn"], kernels)
    del knn32

    # ------------------------------------------------ 12. the ladder
    torch.cuda.empty_cache()
    ladder_path(torch, ops, dev, fitted, queries, kernels, helpers)
    del fitted

    # ------------------------------------------------ 13. the sharded layer
    torch.cuda.empty_cache()
    from repro_torch.kernels.gemm import sm_count
    sharded_path(torch, ops, dev, shard_fits,
                 {"knn": knn_data, "kmeans": km_data, "gnb": gnb_data,
                  "gmm": gnb_data, "rf": rf_data, "ann": ann_data},
                 kernels, helpers, sm_count(torch.device(dev)))
    del shard_fits

    # ------------------------------------------------ 14. training
    # after the LM serving phases (the MoE's weights are gone) and last,
    # so that its 40 GB of training state and its checkpoint's host
    # copies come after every host-clock gate of the earlier phases
    torch.cuda.empty_cache()
    n = train_kernel_edges(torch, ops, ref, dev, lm_gen, lm_cfg)
    print(f"[edge] B12: {n} cases within the tolerance")
    n = train_path_edges(torch, ops, ref, dev, lm_gen, lm_cfg)
    print(f"[edge] B10 and B11 at the training path's shapes: {n} cases "
          "within the tolerance")
    kernels["B12"] = train_kernel_times(torch, ops, ref, dev, lm_gen, lm_cfg,
                                        peaks)
    torch.cuda.empty_cache()
    train_step_checks(torch, ops, dev, lm_cfg)
    torch.cuda.empty_cache()
    launches = train_path(torch, ops, dev, lm_cfg, peaks)
    kernels["B10"]["launches"] += launches["matmul"]
    kernels["B11"]["launches"] += launches["flash_attention"]
    kernels["B12"]["launches"] = launches["flash_attention_bwd"]
    torch.cuda.empty_cache()

    # ------------------------------------------------ summary lines
    kernels = dict(sorted(kernels.items(), key=lambda kv: int(kv[0][1:])))
    kr = kernels["B8"]
    print(f"[time] B8 {kr['name']}: kernel {kr['ms']:.4f} ms, plain "
          f"{kr['plain_ms']:.4f} ms, library {kr['library_ms']:.4f} ms, "
          f"bound {kr['bound_ms']:.4f} ms ({kr['bound_by']})")
    print("kernels: " + " ".join(
        f"{key}={kr['name']}:{kr['launches']}"
        + (f"({kr['grouped']} grouped)" if kr.get("grouped") else "")
        for key, kr in kernels.items()))
    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    print(json.dumps({"kernels": [{f: kr[f] for f in order}
                                  for kr in kernels.values()]}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
