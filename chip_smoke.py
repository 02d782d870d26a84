#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one NVIDIA
card and hold its hand-written kernels against their plain PyTorch versions.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  device          card name and count, ``nvidia-smi`` name and power limit
  build           nvcc build of every kernel source, from this checkout;
                  ptxas registers/spills/shared memory and the SASS counts
                  of HGMMA, UTMALDG and HMMA of every gwas_dot instantiation
                  (each main kernel: HGMMA and UTMALDG, no HMMA)
  kernel          gwas_dot kernel vs its plain version on the card, at one
                  fused scan cell (M=4096, N=23000, P=1024), a ragged shape
                  and the dense engine's calls at the benchmark's batch
                  (M=8192, N=23000, P=4096: one KERNEL_TRAIT_CHUNK of the
                  20,480-trait OLS cell; P=2048: the multivariate cell),
                  fp32 and bf16; kernel/plain/library times (CUDA events), bound;
                  at the cell, column and row splits of the call bitwise
                  equal to the whole call; the loop's edge shapes (unaligned
                  y rows, per-code decode, partial steps and chunks, tiles
                  larger than the problem, all-missing rows)
  kernel_tstat    the tstat kernel and both entries of the screen kernel (r
                  mode: screen_compact; t mode: compact_survivors) vs their
                  plain versions at the mixed-model cell (4096, 1024) and a
                  ragged (1000, 300): t bitwise between tstat and the screen,
                  idx and count exactly, then no-survivor, all-survivor, NaN,
                  capacity-above-size and empty tiles; times of the whole
                  calls and the bound; both entries and the sparse epilogue
                  under torch.cuda.set_sync_debug_mode("error"), and the
                  synchronizing ops left in one fused step and one lmm step
  kernel_refine   the refine kernel (the canonical -log10 p of every emitted
                  t on a card) vs its plain version (stats.neglog10_p_from_t
                  on the card) and the host refine, on a t grid across its
                  lane switches at dof 50, 4096, 22986 and 1e6 and on one
                  OLS cell's lanes (20,480 winners and a 4,096-slot hit
                  buffer at dof 22,986): the largest gaps in ulps, a lane's
                  bits independent of its position; times of the kernel,
                  the plain version and the host refine, and the bound
  scan            the fused path: ``gwas scan --engine fused`` through
                  Study.from_arrays(PlinkBed) -> plan -> ScanSession ->
                  TsvWriter on a synthetic cohort at the paper workload's
                  width (N=23,000 samples, P=2,048 traits, 12 covariates),
                  depth cut to 8,192 markers (2 batches x 2 trait blocks);
                  one gwas_dot and one t-mode compaction launch per cell
  cross           the same cohort on the dense engine twice: under dense
                  staging (the library's fp32 GEMM at full N, no gwas_dot)
                  and under packed staging (on-card statistics, gwas_dot over
                  the packed codes): the fused scan and the packed dense scan
                  each against the library scan, same hits outside a +/-0.05
                  band, values within the fused oracle tolerances, lambda_gc
                  within 1e-3
  multivariate    ``gwas scan --multivariate``: the same cohort unblocked on
                  the dense engine; hits.tsv and per_trait_best.tsv byte-equal
                  to cross's; S against a float64 oracle on the card's own r,
                  omnibus_nlp against scipy's float64 gammaincc, n_traits_eff
                  against float64 Li & Ji; the whitening's time; gwas_dot
                  launched once a cell (the dense engine's product on packed
                  codes) and the refine; the reference's omnibus medians on
                  its test cohort
  identities      1,024 markers at full N and P: sparse == dense epilogue,
                  blocked == unblocked trait grid, packed == dense staging
  lmm_scan        the mixed-model path: ``gwas scan --engine lmm
                  --lmm-epilogue fused`` on a structured cohort at the same
                  width (N=23,000, P=2,048, 12 covariates, M=8,192), delta
                  pinned at (1-h2)/h2; streamed GRM, eigendecomposition and
                  rotation times; one screen launch per cell; every planted
                  effect must be a hit
  executor        the multi-device executor (``MultiDeviceExecutor``) on one
                  slot (``cuda:0``, its own CUDA stream) under the shared-fs
                  scheduler backend, on the scan cohort: the fused engine
                  marker-major, trait-major (lease 1) and unpipelined, and the
                  dense engine, and the dense multivariate screen, each
                  canonical-bitwise equal to its serial run from ``scan``,
                  ``cross`` or ``multivariate``, gwas_dot (fused) and the t-mode
                  compaction launched once per cell; a stream audit checks
                  that every staging copy, kernel call and device-to-host
                  pull of the slot's worker, tail and look-ahead threads ran
                  on the slot's stream, not the default one; per run the
                  time split, the executor's info and the card's peak memory;
                  a control run without the tail flush before the last
                  blocking claim (the reference's order) shows its cost
  multihost       two host processes on the card share one checkpoint
                  directory under shared-fs (the scan cohort in 16 cells of
                  1,024 markers x 1,024 traits, each host's study from
                  ``Study.from_arrays`` over the .bed and saved .npy tables):
                  both hosts' hits.tsv, per_trait_best.tsv and qc.tsv equal
                  each other's and a serial run's byte for byte, each host
                  computing at least one cell; then host A is SIGKILLed after
                  its first committed cell and host B, with a 2 s lease TTL,
                  reclaims A's leases and writes the same bytes
  serve           the serve layer (``ServeHost(devices=1)`` in process) on
                  the scan cohort, resident on the fused engine with scan's
                  plan and warmed at admission; three concurrent requests:
                  window queries [0, 4096) (2 cells) and [3000, 5000) (4
                  cells) and an upload of the study's own panel (4 cells).
                  The upload's three tables are byte-equal to scan's, each
                  window's to an offline ``ScanPlan.run(marker_window=)``,
                  ``covered`` equal to its ``window_covered``; gwas_dot and
                  the t-mode compaction launched once per served cell; a
                  device-state cache hit; then one more window through
                  ``ServeServer``/``ServeClient`` over HTTP (the same
                  hits.tsv bytes), ``POST /shutdown``, nothing pinned and no
                  serve thread left
  lmm_identities  N=4,096, M=2,048 in 2 PLINK shards, P=512, REML and LOCO:
                  fused sparse == fused dense-audit (the tstat kernel),
                  blocked == unblocked, packed == dense staging, and the
                  executor on one slot under shared-fs, bitwise (the last
                  launching the screen once per cell); the fused epilogue vs
                  the dense one at the oracle tolerances
  serve_lmm       that cohort resident in a ``ServeHost`` (fused epilogue,
                  REML at warm-up): one window query across the shards,
                  byte-equal to its offline windowed scan, the screen kernel
                  launched once per served cell
  mesh            the sharding mesh (``ScanPlan(mesh=)``): a world of one
                  process spawned over NCCL with a (1, 1) ("data", "model")
                  mesh; the fused engine ``mp`` at scan's width and grid,
                  its hits.tsv, per_trait_best.tsv and qc.tsv byte-equal to
                  scan's (the mesh keeps the dense p-value epilogue: the
                  sparse == dense identity), and the lmm fused epilogue
                  ``mp`` on lmm_identities' cohort, byte-equal to its serial
                  scan (the tstat kernel on each cell); wall, step and
                  prepare times, launches, bytes moved by collectives
  cli             ``python -m repro_torch.launch.gwas scan`` with
                  ``--engine fused``, ``--engine lmm --lmm-epilogue fused
                  --loco`` on a split fileset, and ``--multivariate`` with a
                  checkpoint, on a small cohort; ``merge`` of that checkpoint
                  (the scan's bytes), ``report``, and ``grm --loco --spectrum``
                  against the in-process streamed GRM and spectrum; KING
                  kinship on the card vs the CPU; ``gwas serve --ready-file``
                  as a subprocess (fused, the scan's flags): a study admitted
                  over HTTP, a panel upload equal to the CLI scan's tables
                  and a window query equal to its rows, then ``POST
                  /shutdown`` and exit 0
  lm_parity       the LM wing: every arch of ``LM_ARCHS`` at ``reduced()`` in
                  float32, the same weights (``init_model`` on the CPU from a
                  seeded generator, copied to the card) through
                  ``build_prefill_step`` and 4 decode steps on the CPU and on
                  the card: logits within 1e-4 * max |logit|, cache positions
                  and the MoE routing integers (with and without dropped
                  tokens) bitwise
  lm_serve        gemma2-9b whole (42 layers, d_model 3,584, 9.24 B
                  parameters in bfloat16), drawn on the card from a seeded
                  generator and served through ``build_prefill_step`` /
                  ``build_decode_step``: 4 requests of 1,024 prompt tokens
                  and 32 greedy decode steps (prefill_s, decode ms per step
                  (median, p95), tokens/s, peak memory, the decode and
                  prefill bounds); prefill and decode against the forward at
                  B=2, S=256; a 4,160-token request whose 21 local rings wrap,
                  8 decode steps, each against the forward
  lm_families     each LM arch at full width, depth cut to one repeat of its
                  block pattern (whisper whole, MoE capacity permissive): B=2,
                  S=64 prefill and 4 decode steps against the forward;
                  parameter bytes, prefill and decode times (each arch's
                  first calls); each model freed before the next
  lm_train_parity every arch at ``reduced()`` in float32, the same weights
                  and ``make_batch`` batch on the CPU and the card: one train
                  step's loss within 1e-5 and each gradient within 1e-4 *
                  max |g| (rwkv6-3b: 1e-3, its gradient is ill-conditioned);
                  a second identical pass on the card compared bitwise (which
                  gradients differ, if any); ``adamw_update`` on the CPU's
                  gradients on both devices within 1e-6; remat "full" and
                  "dots" on the card within 1e-6 of "none"
  lm_train_families  each arch at full width, one repeat of its pattern
                  (whisper whole), B=2, S=64: train steps at remat "none"
                  (first, warm) and "full" from the same weights, losses
                  within 1e-3, finite, grad_norm > 0, parameters moved; times
                  and peak memory; arctic-480b forward and backward only (its
                  float32 AdamW state does not fit on one card)
  lm_train        granite-moe-1b-a400m whole (24 layers, 32 experts top-8,
                  1.38e9 parameters): 8 AdamW steps of B=4, S=4,096 (remat
                  "dots", loss_chunk 1,024, float32 m/v), a checkpoint after
                  step 4; first, median and p95 step times, tokens/s, peak
                  memory, the FLOP bound (``launch.roofline.model_flops`` at
                  989 TFLOP/s) and the step's share of it; two identical
                  passes compared bitwise; one step under ``torch.profiler``
                  (kernels, busy share, top kernels); one step with bfloat16
                  m/v (its peak); the checkpoint restored into a fresh model
                  and steps 5-7 rerun, equal to the uninterrupted run (bitwise
                  when the two passes were)
  lm_mesh_one     LM training on a mesh: a world of one process spawned over
                  NCCL with a (1, 1) ("data", "model") mesh; gemma2-9b at full
                  width, depth cut to one repeat of its pattern (2 layers),
                  B=2, S=256: one train step with ``mesh=`` (remat "full",
                  loss_chunk 128) bitwise equal to the ``mesh=None`` step from
                  the same weights (metrics, parameters, m and v: on one rank
                  the gather and the gradient reduce are identities), then
                  one step of ``launch/train.py --reduced --mesh pod`` on that
                  world
  lm_serve_mesh_one  LM serving on a mesh: a world of one over NCCL, mesh
                  (1, 1); gemma2-9b at full width, one repeat of its pattern,
                  B=4: a 512-token prefill into 544-slot caches and 8 decode
                  steps through ``build_prefill_step(mesh=)`` /
                  ``build_decode_step(mesh=)``, logits and every cache
                  tensor bitwise equal to ``mesh=None``
  dryrun          the dry run (``launch/dryrun.py``) against the card: each
                  cell traced as rank 0 of a fake world of one (under
                  ``FakeTensorMode``, in a child process, beside the card's
                  run) and run for real: (a) the paper's fused cell, one
                  batch of 8,192 markers x 23,000 samples x 20,480 traits in
                  fp32 (``build_fused_step``, inputs on the card); (b)
                  gemma2-9b whole, a prefill of 4 x 1,024 tokens into 4,160
                  slots, and granite-moe-1b-a400m whole, one train step of
                  B=4 x S=4,096 (remat "dots", loss_chunk 1,024, float32
                  m/v); the trace's argument (rest) bytes within 1% and peak
                  bytes within 10% of the card's (``memory_allocated`` /
                  ``max_memory_allocated`` above the bytes before), the fused
                  cell's gwas_dot launches and FLOPs (``FlopCounterMode`` on
                  the card's run) equal, its step time beside its
                  ``compute_s``; (c) ``python -m repro_torch.launch.dryrun
                  --arch gemma2-9b --shape decode_32k --mesh pod`` and
                  ``python -m repro_torch.launch.report`` on its record, exit
                  0, the record ``ok``

The LM phases launch none of the repo's kernels: each reads the counts and
fails unless all are 0.  Every GWAS scan on the card launches the refine
kernel at least once a cell.  Each path's launch counts are set to 0 just before it runs and read just
after.  Then come a ``kernels`` JSON line, the ``nvidia-smi`` line, and as
the last line ``{"ok": true, "device": {...}}``.  Any failure raises and
exits non-zero; without a CUDA device it exits 1 and prints no result.

    python3 chip_smoke.py --only build,kernel

runs the device phase and the named phases among ``build``, ``kernel``,
``kernel_tstat`` and ``kernel_refine`` only (a quick check of the kernels); it prints neither the
``kernels`` line nor the ``ok`` line.  ``--only lm_serve`` (and
``lm_parity``, ``lm_families``, ``lm_train_parity``, ``lm_train_families``,
``lm_train``, ``lm_mesh_one``, ``lm_serve_mesh_one``, ``dryrun``) runs one
such phase alone the same way.  On a machine with two or more cards,

    python3 chip_smoke.py --only build,devices

runs the multi-device executor over every card (``devices``: the scan
cohort in 16 cells, fused and dense, bitwise against the serial run on
``cuda:0``, each slot on its own card and stream), and

    python3 chip_smoke.py --only build,mesh

runs the sharding mesh over the cards, one process per card over NCCL: a
(2, 2) mesh on 4 cards, (2, 1) and (1, 2) on 2 (and (1, 1) on one card, a
quick check of the phase itself).  Against serial scans on ``cuda:0``:
dense ``mp`` and ``sample`` and the fused engine ``mp`` at the scan cohort's
width, the lmm fused epilogue ``mp`` on lmm_identities' cohort, the dense
multivariate screen ``mp``; fused tables byte-equal, the rest at the oracle
tolerances; every rank's gathered tiles bitwise equal (a digest of every
cell), a repeated ``sample`` run bitwise equal, and a checkpoint cut under
the mesh resumed with no mesh byte-equal to the serial tables.  On 4 cards,

    python3 chip_smoke.py --only build,lm_mesh

runs LM training on a mesh, one process per card over NCCL (fewer cards:
an error).  (a) Parity: gemma2-9b at full width, one repeat, float32, B=8,
S=512, on (2, 2) and (4, 1) against the ``mesh=None`` step on ``cuda:0``
from the same weights and batch (loss and grad_norm within 1e-5, each
gradient within 1e-4 * max |g|, every rank's metrics the same bits);
granite-moe-1b-a400m whole in float32 on (2, 2): the GSPMD MoE with the
config's capacity against ``mesh=None`` at the same bounds (dropped slots
counted), the manual MoE's logits against the GSPMD layer's within 1e-3 at
capacity factor E, and a checkpoint cut at step 2 under the mesh, streamed
to disk and read back one key at a time, resumed on one card with no mesh
(steps 3-4 within 1e-5); and granite-moe-1b-a400m whole in bf16, B=4 x
S=4,096, timed on (4, 1) with the GSPMD MoE (each rank runs the experts
over the whole batch's (E, C) buffer) and the manual MoE (each rank's rows
alone), and on one card with no mesh.  (b) gemma2-9b whole (42
layers, bf16) with FSDP on (4, 1): 6 AdamW steps of B=16 x S=4,096 with 4
microbatches, remat "full", loss_chunk 512 and float32 m/v; first, median
and p95 step times, tokens/s, each rank's memory at rest and peak, the
bytes each rank received through collectives a step, the FLOP bound
(``launch.roofline.model_flops`` at 4 x 989 TFLOP/s) and the step's share
of it, one more step under ``torch.profiler`` on every rank (busy share,
top kernels), and two identical passes compared (the differing gradients
named); beside it, rank 0's dry run of the same step on a fake world of 4
(a child process traces it while the cards run): rest bytes within 1%,
peak within 10%, collective bytes a step exact.
(c) Every rank's launch counts of the repo's kernels read 0.  On 4 cards,

    python3 chip_smoke.py --only build,lm_serve_mesh

runs the LM serve steps on a mesh, one process per card over NCCL (fewer
cards: an error), with every layer split over "model" (attention, the MLP,
the embedding and the head, the rg-lru and rwkv6 mixes, the MoE's router
and experts).  (a) Parity: gemma2-9b, qwen1.5-32b, recurrentgemma-2b,
rwkv6-3b (its one head, and 4 heads of 16), granite-moe-1b-a400m and
arctic-480b at ``reduced()`` in float32, B=4, a 24-token prompt into
32-slot caches and 8 decode steps, on (2, 2) and (1, 4) against
``mesh=None`` on ``cuda:0`` from the same weights: logits of every step and
the gathered caches within 1e-4 * max |ref|, every rank's gathered results
the same bits; then the same six archs at full width, one repeat of the
pattern, in bfloat16, B=4, a 512-token prompt into 544-slot caches and 8
decode steps, on (1, 4) against ``mesh=None`` on ``cuda:0`` from the same
weights: the mesh's logits and caches no further from the same weights
served in float32 than 4x ``mesh=None``'s bfloat16 error (a wrong split is
off by the size of the values), positions equal; for the MoE archs on the
rows whose experts the three runs chose alike (rounding flips near ties),
at least half of them.  (b) Served whole in
bfloat16 on (1, 4), weights drawn a parameter at a time
(``models.convert.init_blocks``): qwen1.5-32b, 8 requests of 4,096 prompt
tokens into 4,160-slot caches, then 64 greedy decode steps;
recurrentgemma-2b, rwkv6-3b and granite-moe-1b-a400m, 8 requests of 256
prompt tokens into 288-slot caches, then 32 greedy decode steps.  For each:
``prefill_s``, decode ms per step (median, p95) and tokens/s, each rank's
bytes at rest (weights, caches) and at peak (under 80 GB), the bytes each
rank moved through collectives per prefill and per decode step, the
kernels per decode step and one more prefill under ``torch.profiler``, and
each time beside its bound (prefill: ``launch.roofline.model_flops`` at 4 x
989 TFLOP/s; decode: a rank's weights and caches read once at 3.35 TB/s);
beside them, rank 0's dry run of the prefill and of a decode step on a fake
world of 4: rest bytes within 1%, peak within 10%, collective bytes exact.
(c) Every rank's launch counts of the repo's kernels read 0.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# Published H100 SXM peaks (NVIDIA data sheet, dense): fp32 outside the
# tensor cores, TF32 and bf16 on them, and HBM3 bandwidth.
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
HBM_BYTES_S = 3.35e12
HIT_BAND = 0.05
DEVICE = "cuda:0"
# "cell": a fused scan's cell (1,024-trait blocks); "dense_ols" and
# "dense_mv": the dense engine's calls on the card at the benchmark's 8,192-
# marker batch, one KERNEL_TRAIT_CHUNK of the 20,480-trait OLS panel and the
# whole 2,048-trait multivariate panel
KERNEL_SHAPES = (("cell", (4096, 23000, 1024)), ("ragged", (1000, 1003, 300)),
                 ("dense_ols", (8192, 23000, 4096)), ("dense_mv", (8192, 23000, 2048)))
DENSE_KERNEL_SHAPES = ("dense_ols", "dense_mv")
# The gwas_dot loop's edges: (label, M, N, P, block_n).  P=301: rows of y not
# 16-byte aligned (4-byte copies, scalar stores); block_n 64 and 36: the
# per-code decode (block_n/4 is not a multiple of the 32-sample step), and
# with 36, N_pad=468 is 14.6 steps: the last step is partial and the 15
# steps end inside a 64-sample chunk; the last: M and P under one 128 x 128
# tile.  Each also has an all-missing row.
KERNEL_EDGES = (("p301", 300, 1003, 301, 512), ("bn64", 200, 700, 64, 64),
                ("bn36", 130, 460, 40, 36), ("small", 5, 77, 3, 512))
# the bitwise split checks at the cell: column and row prefixes
SPLIT_P, SPLIT_M = 512, 2048
# the scan cohort: the paper workload's width (configs/gwas_ukb.py: 23,000
# samples, 12 covariates; 20,480 traits cut to 2,048), depth cut to 8,192
# markers in two batches, traits in two blocks
SCAN = dict(n_samples=23000, n_markers=8192, n_traits=2048, n_covariates=12,
            n_causal=32, effect_size=0.06, batch_markers=4096, trait_block=1024)
IDENTITY_MARKERS = 1024
# the multivariate screen's tolerances: S relative to a float64 oracle on
# the card's own r; omnibus_nlp (rel, abs) against scipy's float64 gammaincc
# (the p-value contract of tests/test_oracle.py); n_traits_eff against
# float64 Li & Ji, in float32 units of 1 (2^-24) per trait and level of a
# pairwise sum: P eigenvalues near 1, each rounded by the float32 eigensolver
# and summed in float32 (4 P log2 P ulps: 5.4e-3 at P = 2,048)
MV_TOL = dict(s_rel=1e-3, nlp=(2e-3, 5e-3), meff_ulps_per_trait_level=4)
# the reference's own omnibus check (tests/test_screening.py) runs on its
# test cohort (tests/conftest.py)
MV_SMALL = dict(n_samples=400, n_markers=600, n_traits=12, n_causal=8, effect_size=0.6,
                missing_rate=0.02, seed=7)
# fused-engine oracle tolerances (tests/test_oracle.py): r, t (rel, abs),
# nlp (rel, abs)
FUSED_TOL = (5e-5, (5e-4, 5e-4), (5e-3, 1e-2))
# the mixed-model scan: a structured cohort at the same width; delta pinned
# at (1 - h2) / h2 (REML is host numpy and would dominate the phase).  With
# N > M every marker lies in the GRM's range, where the background's
# variance is h2 * N / M + 1 - h2 = 1.72, so a planted effect b has a GLS t
# near b * sqrt(N / 1.72) = 116 b: 0.06 gives t ~ 6.9, and ~8% of the 32
# effects fall under the 7.301 threshold (t ~ 5.5); 0.09 gives t ~ 10.4.
LMM_SCAN = dict(n_samples=23000, n_markers=8192, n_traits=2048, n_covariates=12,
                h2=0.4, n_causal=32, effect_size=0.09, batch_markers=4096,
                trait_block=1024, delta=1.5)
LMM_IDENT = dict(n_samples=4096, n_markers=2048, n_shards=2, n_traits=512,
                 n_covariates=12, batch_markers=1024, trait_block=256)
# fused vs dense lmm epilogue (tests/test_oracle.py): the same r, t within
# 1e-4 and nlp within 1e-3, absolute
LMM_EPILOGUE_TOL = (0.0, (0.0, 1e-4), (0.0, 1e-3))
# the two-host shared-fs run: the scan cohort in batches of 1,024 markers and
# blocks of 1,024 traits (16 cells); host A's lease TTL when it is killed
MULTIHOST = dict(batch_markers=1024, trait_block=1024, kill_lease_ttl=2.0)
# the serve phase's marker windows on the scan cohort's 2 batches of 4,096:
# (a) inside batch 0, (b) across the boundary (widens to both batches); and
# the lmm study's window, across the boundary of its two shards at marker 683
# (two LOCO scopes, batches [0, 683) and [683, 1707))
SERVE_WINDOWS = ((0, 4096), (3000, 5000))
SERVE_LMM_WINDOW = (600, 800)
TSTAT_SHAPES = (("cell", (4096, 1024)), ("ragged", (1000, 300)))
TSTAT_CAPACITY = 4096
# elements per tile of the compaction kernel (csrc/tstat.cu); one 8-byte
# status word per tile
COMPACT_TILE = 4096
# the synchronizing-op census: the lmm step's sample count (its rotation is
# N x N; the epilogue's ops do not depend on N)
SYNC_LMM_SAMPLES = 4096
T_RTOL = 2e-6
# The refine at one OLS cell: 20,480 traits' winners over 8,192 markers and a
# 4,096-slot hit buffer (64 survivors, the rest padding), at dof 22,986.
REFINE_CELL = dict(traits=20480, markers=8192, hit_slots=4096, survivors=64, dof=22986.0)
REFINE_DOFS = (50.0, 4096.0, 22986.0, 1e6)
REFINE_RTOL, REFINE_ATOL = 1e-5, 1e-6   # the kernel against the host and plain version
# Flops of one refine lane (each division, reciprocal and transcendental one):
# a lane that runs the fraction (the tail, the beta bulk) does 28 a trip for
# 128 trips plus ~26 around them; an Edgeworth bulk lane ~16.
REFINE_FLOPS = dict(fraction=128 * 28 + 26, normal=16)
# the mesh phase: its mesh shapes by card count, and the cells a
# checkpointed run under the mesh computes before it is cut
MESH_SHAPES = {4: ((2, 2),), 2: ((2, 1), (1, 2)), 1: ((1, 1),)}
MESH_CUT_CELLS = 2
# dense-engine oracle tolerances (tests/test_oracle.py): r, t (rel, abs),
# nlp (rel, abs)
DENSE_TOL = (2e-5, (2e-4, 2e-4), (2e-3, 5e-3))
# The LM wing.  lm_parity: every arch at reduced() in float32, CPU vs card,
# logits within 1e-4 * max |logit|.  lm_serve: gemma2-9b whole
# (src/repro/configs/gemma2_9b.py): 4 requests of 1,024 prompt tokens into
# caches of 1,056 positions, 32 greedy decode steps; the forward identity at
# B=2, S=256; a prompt of 4,160 > local_window 4,096 with 8 decode steps.
# lm_families: every arch at full width, one repeat of its pattern.  The
# forward identities hold max |d| <= 5e-2 * max |logit| in bfloat16 (the
# reference's test_prefill_decode_consistency bound, made relative).
LM_PARITY = dict(batch=2, seq=12, steps=4, seed=2026, rel=1e-4)
LM_SERVE = dict(arch="gemma2-9b", batch=4, prompt=1024, capacity=1056, steps=32, seed=2026,
                consist_batch=2, consist_len=256, wrap_prompt=4160, wrap_steps=8,
                rel_bound=5e-2, profile_steps=4)
LM_FAMILIES = dict(batch=2, seq=64, steps=4, seed=2026, rel_bound=5e-2)
# LM training.  Parity: one step at reduced() in float32 on the CPU and the
# card; rwkv6-3b's gradient is ill-conditioned (float32 rounding amplified
# ~100x in any two implementations; tests/test_torch_train_parity.py), so its
# gradients and grad_norm are held at 1e-3.
LM_TRAIN_PARITY = dict(batch=4, seq=32, seed=2026, loss_rel=1e-5, grad_rel=1e-4,
                       ill_conditioned={"rwkv6-3b": 1e-3}, opt_rel=1e-6, remat_rel=1e-6)
LM_TRAIN_FAMILIES = dict(batch=2, seq=64, seed=2026, rel_bound=1e-3,
                         no_optimizer=("arctic-480b",))
# granite-moe-1b-a400m whole: train_4k's S=4,096 with the global batch cut
# from 256 to 4; a checkpoint after 5 steps, resumed for steps 5-7.
LM_TRAIN = dict(arch="granite-moe-1b-a400m", batch=4, seq=4096, steps=8, resume_at=5,
                remat="dots", loss_chunk=1024, seed=2026)
# LM training on a mesh.  lm_mesh_one: gemma2-9b at full width, one repeat
# of its pattern, on a world of one: the mesh step bitwise equal to
# mesh=None.  lm_mesh (4 cards): (a) parity at reduced depth in float32 on
# (2, 2), (1, 4) and (4, 1) against mesh=None on cuda:0 (on (2, 2) and (1,
# 4) every layer computes on its "model" blocks), granite-moe-1b-a400m
# whole on (1, 4) and (2, 2) (GSPMD with the config's capacity; on (2, 2)
# manual vs GSPMD at capacity factor E, a checkpoint cut at step 2 resumed
# on one card; the MoE's cost on (4, 1) in bf16, GSPMD vs manual vs one
# card); (b) gemma2-9b whole on (4, 1) (FSDP only), (2, 2) and (1, 4)
# (FSDP and the "model" split), the reference's
# TRAIN_OVERRIDES["gemma2-9b"] (4 microbatches, remat full, loss_chunk 512,
# float32 m/v), B=16, S=4,096, each held to its trace on a fake world.
LM_MESH_ONE = dict(arch="gemma2-9b", batch=2, seq=256, remat="full", loss_chunk=128, seed=2026)
LM_MESH = dict(arch="gemma2-9b", batch=8, seq=512, seed=2026, loss_rel=1e-5, grad_rel=1e-4,
               shapes=((2, 2), (1, 4), (4, 1)), moe_arch="granite-moe-1b-a400m", moe_batch=8,
               moe_seq=512, moe_shapes=((1, 4), (2, 2)), manual_bound=1e-3, cut_at=2,
               resume_to=4,
               moe_cost=dict(batch=4, seq=4096, steps=4, remat="dots", loss_chunk=1024),
               whole=dict(shapes=((4, 1), (2, 2), (1, 4)), batch=16, seq=4096, steps=5,
                          n_microbatches=4, remat="full", loss_chunk=512, first_loss_rel=1e-2))
# LM serving on a mesh.  lm_serve_mesh_one: gemma2-9b at full width, one
# repeat of its pattern, on a world of one: prefill and 8 decode steps
# through the mesh arms bitwise equal to mesh=None.  lm_serve_mesh (4
# cards): (a) parity at reduced() in float32 on (2, 2) and (1, 4) against
# mesh=None on cuda:0, and at full width (one repeat of the pattern) in
# bfloat16 on (1, 4), held to mesh=None's own bfloat16 error; (b) served
# whole in bfloat16 on (1, 4), weights drawn a parameter at a time:
# qwen1.5-32b (src/repro/configs/qwen15_32b.py, 70.4 GB of weights: more
# than one card), 8 requests of 4,096 prompt tokens into caches of 4,160
# positions, then 64 greedy decode steps; recurrentgemma-2b, rwkv6-3b and
# granite-moe-1b-a400m, 8 requests of 256 prompt tokens, 32 decode steps.
LM_SERVE_MESH_ONE = dict(arch="gemma2-9b", batch=4, prompt=512, capacity=544, steps=8,
                         seed=2026)
# The split recurrent and expert layers (rg-lru, rwkv6, the MoE) join (a)
# in float32 (rwkv6 also with heads of 16, so its 4 reduced() heads split)
# and at full width, and are served whole in (b) with short prompts (their
# recurrences loop over time steps).
LM_SERVE_MESH = dict(archs=("gemma2-9b", "qwen1.5-32b", "recurrentgemma-2b", "rwkv6-3b",
                            "rwkv6-3b-4h", "granite-moe-1b-a400m", "arctic-480b"),
                     shapes=((2, 2), (1, 4)), batch=4, prompt=24, capacity=32, steps=8,
                     seed=2026, rel=1e-4,
                     full=dict(archs=("gemma2-9b", "qwen1.5-32b", "recurrentgemma-2b",
                                      "rwkv6-3b", "granite-moe-1b-a400m", "arctic-480b"),
                               shape=(1, 4), batch=4, prompt=512, capacity=544, steps=8,
                               factor=4.0),
                     whole=dict(shape=(1, 4), peak_limit=80e9, cells=(
                         dict(arch="qwen1.5-32b", batch=8, prompt=4096, capacity=4160, steps=64),
                         dict(arch="recurrentgemma-2b", batch=8, prompt=256, capacity=288,
                              steps=32),
                         dict(arch="rwkv6-3b", batch=8, prompt=256, capacity=288, steps=32),
                         dict(arch="granite-moe-1b-a400m", batch=8, prompt=256, capacity=288,
                              steps=32))))
# reduced() variants of (a): (arch, config changes)
LM_VARIANTS = {"rwkv6-3b-4h": ("rwkv6-3b", dict(rwkv_head_dim=16))}
# The dry run (launch/dryrun.py) against the card, each cell traced as rank 0
# of a fake world beside its measurement.  dryrun (one card): (a) the
# paper's fused cell, one batch of 8,192 markers x 23,000 samples x 20,480
# traits in fp32 (configs/gwas_ukb.py); (b) gemma2-9b prefill of 4 x 1,024
# tokens into 4,160 slots, and one granite-moe-1b-a400m train step of B=4 x
# S=4,096 (remat dots, loss_chunk 1,024, float32 m/v); (c) the CLIs on
# gemma2-9b decode_32k on the pod mesh.  lm_mesh and lm_serve_mesh hold
# their (b) cells to the trace too.  Rest (argument) bytes within 1%, peak
# bytes within 10%, collective bytes and gwas_dot launches exact.
DRYRUN = dict(seed=2026, lm_serve=dict(arch="gemma2-9b", batch=4, prompt=1024, capacity=4160),
              lm_train=dict(arch="granite-moe-1b-a400m", batch=4, seq=4096, remat="dots",
                            loss_chunk=1024),
              cli=("gemma2-9b", "decode_32k"), tol=dict(argument_bytes=0.01, peak_bytes=0.10))


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps: int = 3, inner: int = 1) -> float:
    """Median of ``reps`` CUDA-event timings of ``inner`` back-to-back calls
    of ``fn``, per call, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def graph_ms(fn, inner: int = 20, reps: int = 3):
    """The card's time per call of ``fn``: ``inner`` calls captured in one
    CUDA graph on a side stream (after a warm-up there: the compaction keeps
    its workspace per stream), the graph replayed (``cuda_ms``).  A replay
    skips the host's work per call, which sets the rate of back-to-back
    calls for these small kernels.  Returns (ms, the last captured call's
    output after the timed replays)."""
    import torch

    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        fn()
    stream.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(inner):
            out = fn()
    ms = cuda_ms(graph.replay, reps=reps) / inner
    torch.cuda.synchronize()
    return ms, out


def bytes_bound(nbytes: float, flops: float, peak: float = FP32_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def reset_launches() -> None:
    from repro_torch.kernels import tstat as ts
    from repro_torch.kernels.gwas_dot import gwas_dot as gd

    gd.launches = 0
    ts.tstat_launches = 0
    ts.screen_launches = 0
    ts.compact_launches = 0
    ts.refine_launches = 0


def read_launches() -> dict:
    from repro_torch.kernels import tstat as ts
    from repro_torch.kernels.gwas_dot import gwas_dot as gd

    return {"gwas_dot": gd.launches, "tstat": ts.tstat_launches,
            "screen_compact": ts.screen_launches, "compact_survivors": ts.compact_launches,
            "refine": ts.refine_launches}


def check_refined_on_card(label: str, launches: dict, cells: int) -> None:
    """Every cell of a scan on the card refines its winners (and its hit
    slots or survivors, when its screen passes) with the refine kernel."""
    check(launches["refine"] >= cells > 0,
          f"{label}: the refine kernel launched {launches['refine']} times for {cells} cells")


def launched_besides_refine(launches: dict) -> dict:
    return {k: v for k, v in launches.items() if k != "refine" and v}


def dense_gwas_dot_calls(cells: int, width: int) -> int:
    """gwas_dot launches of a dense scan on the card (packed staging, the
    paper's dof): one a cell for each chunk of ``KERNEL_TRAIT_CHUNK`` traits
    of its ``width``-trait block."""
    from repro_torch.core.engines import KERNEL_TRAIT_CHUNK

    return cells * -(-width // KERNEL_TRAIT_CHUNK)


def gwas_dot_bound(m: int, n: int, p: int, packed_bytes: int, dtype: str) -> tuple[float, str]:
    """Least time for one gwas_dot call: each input read once (packed codes,
    mean, inv_std, y), each output written once (r, t), against the product's
    2*M*N*P FLOP on the tensor cores: three TF32 passes in fp32 mode (one
    TF32 product cannot hold r to 2e-6), one bf16 pass in bf16 mode."""
    nbytes = packed_bytes + 8 * m + 4 * n * p + 8 * m * p
    flops = 2.0 * m * n * p
    if dtype == "fp32":
        return bytes_bound(nbytes, 3 * flops, TF32_FLOPS)
    return bytes_bound(nbytes, flops, BF16_FLOPS)


# --------------------------------------------------------------------- phases


def phase_device() -> tuple[dict, str]:
    import torch

    name = torch.cuda.get_device_name(0)
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    smi = cards[0]
    info = {"kind": name, "count": torch.cuda.device_count()}
    emit({"phase": "device", **info, "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, **({"nvidia_smi_all": cards} if len(cards) > 1 else {})})
    return info, smi


# gwas_dot's kernels by instantiation, from the library's ptxas log and SASS
# (filled by phase_build): {label: {"registers", "spill_stores",
# "spill_loads", "smem_static", "sass": {"HGMMA", "UTMALDG", "HMMA"}}}
GWAS_DOT_BUILD: dict = {}
SASS_OPS = ("HGMMA", "UTMALDG", "HMMA")


def _instantiation(mangled: str) -> str:
    """``gwas_dot_kernel<bf16, fast>`` / ``trait_operand_kernel<bf16>`` from a
    mangled name (template bools as ``Lb0E``/``Lb1E``)."""
    import re

    name = re.search(r"(gwas_dot_kernel|trait_operand_kernel)I((?:Lb[01]E)+)E", mangled)
    if name is None:
        return mangled
    flags = ["true" if f == "1" else "false" for f in re.findall(r"Lb([01])E", name.group(2))]
    return f"{name.group(1)}<{', '.join(flags)}>"


def _gwas_dot_instantiations(log: str, sass: str) -> dict:
    import re

    out: dict = {}
    current = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = out.setdefault(_instantiation(m.group(1)), {})
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            current["spill_stores"], current["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            current["smem_static"] = int(sm.group(1)) if sm else 0
    function = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            function = out.setdefault(_instantiation(m.group(1)), {})
            function["sass"] = dict.fromkeys(SASS_OPS, 0)
            continue
        if function is not None:
            for op in SASS_OPS:
                if re.search(rf"\b{op}\b", line):
                    function["sass"][op] += 1
    return out


def phase_build() -> None:
    from repro_torch.kernels import build

    sources = sorted(f[:-3] for f in os.listdir(build.CSRC_DIR) if f.endswith(".cu"))
    t0 = time.perf_counter()
    # One nvcc per source, all started together.
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        libs = dict(zip(sources, pool.map(build.build, sources)))
    wall = time.perf_counter() - t0
    ptxas = {
        s: [ln.strip() for ln in build.build_info[s]["log"].splitlines()
            if "registers" in ln or "spill" in ln or "entry function" in ln]
        for s in sources
    }
    # ptxas's advisories on the wgmma pipeline and setmaxnreg, if any
    advisories = [ln.strip() for ln in build.build_info["gwas_dot"]["log"].splitlines()
                  if "wgmma" in ln or "setmaxnreg" in ln or "Performance" in ln]
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = (subprocess.run([cuobjdump, "-sass", libs["gwas_dot"]], capture_output=True,
                           text=True, check=True).stdout if os.path.exists(cuobjdump) else "")
    GWAS_DOT_BUILD.clear()
    GWAS_DOT_BUILD.update(_gwas_dot_instantiations(build.build_info["gwas_dot"]["log"], sass))
    emit({"phase": "build", "sources": sources, "wall_s": wall,
          "nvcc_s": {s: build.build_info[s]["seconds"] for s in sources},
          "libs": {s: os.path.relpath(p, HERE) for s, p in libs.items()}, "ptxas": ptxas,
          "gwas_dot_advisories": advisories, "gwas_dot": GWAS_DOT_BUILD})
    # gwas_dot's main kernels run on wgmma fed by TMA: their SASS must hold
    # HGMMA and UTMALDG and no warp-level HMMA
    if sass:
        mains = {k: v for k, v in GWAS_DOT_BUILD.items() if k.startswith("gwas_dot_kernel")}
        check(len(mains) == 4, f"gwas_dot: expected 4 main instantiations, found {sorted(mains)}")
        for label, info in mains.items():
            ops = info.get("sass", {})
            check(ops.get("HGMMA", 0) > 0 and ops.get("UTMALDG", 0) > 0 and ops.get("HMMA", 0) == 0,
                  f"gwas_dot {label}: SASS {ops}, expected HGMMA and UTMALDG and no HMMA")


def _mode_build(dtype: str) -> dict:
    """The build's numbers for the instantiations of one mode, with the main
    kernel's dynamic shared memory."""
    from repro_torch.kernels.gwas_dot import gwas_dot as gd

    flag = "true" if dtype == "bf16" else "false"
    rows = {k: v for k, v in GWAS_DOT_BUILD.items() if k.split("<")[-1].startswith(flag)}
    return {"instantiations": rows, "smem_dynamic": gd.smem_bytes(dtype == "bf16")}


def _kernel_inputs(m, n, p, block_n, seed, missing_row=False):
    import numpy as np
    import torch

    from repro_torch.kernels.gwas_dot import ops

    rng = np.random.default_rng(seed)
    codes = rng.choice([0, 1, 2, 3], p=[0.3, 0.02, 0.38, 0.3], size=(m, n)).astype(np.uint8)
    mean, inv_std, _ = ops.marker_stats_from_codes(codes)
    y = rng.normal(size=(n, p)).astype(np.float32)
    # plant signal so r spans the epilogue's range, not just ~1/sqrt(N)
    k = min(16, m, p)
    c32 = codes[:k].astype(np.int32)
    dose = np.where(c32 == 1, mean[:k, None], 2 - c32 + (c32 >> 1)).astype(np.float32)
    y[:, :k] += 0.8 * ((dose - mean[:k, None]) * inv_std[:k, None]).T
    if missing_row:
        codes[-1] = 1
        mean, inv_std, _ = ops.marker_stats_from_codes(codes)
    dev = torch.device(DEVICE)
    return (
        torch.from_numpy(ops.pack_tiled(codes, block_n)).to(dev),
        torch.from_numpy(mean).to(dev),
        torch.from_numpy(inv_std).to(dev),
        torch.from_numpy(y).to(dev),
    )


def _hold_gwas_dot(label, packed, mean, inv_std, y, n, block_n, dtype):
    """One kernel call against the plain version on the same inputs: r within
    2e-6 (fp32) or 5e-3 (bf16), and in fp32 t within the r tolerance carried
    through t = r sqrt(dof / (1 - r^2)).  Returns the outputs and errors."""
    import torch

    from repro_torch.kernels.gwas_dot import gwas_dot as gd
    from repro_torch.kernels.gwas_dot import ref

    p = y.shape[1]
    dof = n - 2
    y_pad = torch.cat([y, y.new_zeros((packed.shape[1] * 4 - n, p))])
    r, t = gd.gwas_dot_fused(packed, mean, inv_std, y, n_samples=n, dof=dof,
                             block_n=block_n, input_dtype=dtype)
    r0, t0 = ref.gwas_dot_ref(ref.unpack_tiled(packed, block_n), mean, inv_std, y_pad,
                              n_samples=n, dof=dof, input_dtype=dtype)
    check(bool(torch.isfinite(r).all() and torch.isfinite(t).all()),
          f"gwas_dot {label} {dtype}: non-finite output")
    r_err = float((r - r0).abs().max())
    t_err = float((t - t0).abs().max())
    r_tol = 2e-6 if dtype == "fp32" else 5e-3
    check(r_err <= r_tol, f"gwas_dot {label} {dtype}: |dr|={r_err} > {r_tol}")
    t_tol = None
    if dtype == "fp32":
        # The r tolerance carried through t = r sqrt(dof / (1 - r^2)):
        # dt/dr = sqrt(dof) / (1 - r^2)^1.5, i.e. 2e-6 sqrt(dof) at r ~ 0
        # (~3e-4 at N = 23,000), plus 2e-6 |t| for the epilogue's own rounding.
        slope = math.sqrt(dof) / torch.clamp(1 - r0 * r0, min=1e-6) ** 1.5
        excess = (t - t0).abs() - (r_tol * slope + r_tol * t0.abs())
        t_tol = 2e-6 * math.sqrt(dof)
        check(float(excess.max()) <= 0.0,
              f"gwas_dot {label} {dtype}: |dt|={t_err} past the propagated r tolerance")
    return (r, t), {"r_max_abs_err": r_err, "t_max_abs_err": t_err, "r_tol": r_tol,
                    "t_tol": t_tol}


def _hold_trait_operand(label, packed, mean, inv_std, y, block_n, dtype) -> None:
    """The kernel's prologue against its plain version, bit for bit: one
    launch with a scratch of our own, then the scratch against
    ``ref.trait_operand_ref`` (transpose, the kernel's sample order, bf16
    rounding or tf32 hi/lo split, zeros past y's rows and P)."""
    import torch

    from repro_torch.kernels.gwas_dot import gwas_dot as gd
    from repro_torch.kernels.gwas_dot import ref

    n_pad = packed.shape[1] * 4
    shape, stype = ref.trait_operand_shape(y.shape[1], n_pad, dtype)
    scratch = torch.full(shape, float("nan"), dtype=stype, device=y.device)
    n = y.shape[0]
    gd._launch(packed, mean, inv_std, y, scratch, block_n, float(n), float(n - 2), 1e-12,
               dtype == "bf16")
    want = ref.trait_operand_ref(y, n_pad, dtype, block_n)
    word = torch.int16 if dtype == "bf16" else torch.int32
    check(torch.equal(scratch.view(word), want.view(word)),
          f"gwas_dot {label} {dtype}: the prologue's trait operand differs from its plain version")


def _split_bitwise(packed, mean, inv_std, y, n, block_n, dtype, whole) -> None:
    """Columns 0..SPLIT_P-1 of the whole call equal a call on those columns,
    rows 0..SPLIT_M-1 a call on those rows, byte for byte: each output's sum
    runs in one order whatever the shape."""
    import torch

    from repro_torch.kernels.gwas_dot import gwas_dot as gd

    kw = dict(n_samples=n, dof=n - 2, block_n=block_n, input_dtype=dtype)
    r, t = whole
    rc, tc = gd.gwas_dot_fused(packed, mean, inv_std, y[:, :SPLIT_P].contiguous(), **kw)
    rm, tm = gd.gwas_dot_fused(packed[:SPLIT_M], mean[:SPLIT_M], inv_std[:SPLIT_M], y, **kw)
    check(torch.equal(rc, r[:, :SPLIT_P]) and torch.equal(tc, t[:, :SPLIT_P]),
          f"gwas_dot {dtype}: the first {SPLIT_P} columns differ from the whole call")
    check(torch.equal(rm, r[:SPLIT_M]) and torch.equal(tm, t[:SPLIT_M]),
          f"gwas_dot {dtype}: the first {SPLIT_M} rows differ from the whole call")


def phase_kernel() -> tuple[dict, dict]:
    import torch

    from repro_torch.core.engines import KERNEL_TRAIT_CHUNK
    from repro_torch.kernels.gwas_dot import gwas_dot as gd
    from repro_torch.kernels.gwas_dot import ref

    check(dict(KERNEL_SHAPES)["dense_ols"][2] == KERNEL_TRAIT_CHUNK,
          f"the dense_ols shape is not one {KERNEL_TRAIT_CHUNK}-trait call")
    block_n = 512
    main, dense_rows = None, {}
    for label, (m, n, p) in KERNEL_SHAPES:
        packed, mean, inv_std, y = _kernel_inputs(m, n, p, block_n, seed=m + n + p)
        dof = n - 2
        n_pad = packed.shape[1] * 4
        y_pad = torch.cat([y, y.new_zeros((n_pad - n, p))])
        g = ref.decode_standardize_ref(ref.unpack_tiled(packed, block_n), mean, inv_std)
        for dtype in ("fp32", "bf16"):
            def kernel():
                return gd.gwas_dot_fused(packed, mean, inv_std, y, n_samples=n, dof=dof,
                                         block_n=block_n, input_dtype=dtype)

            def plain():
                return ref.gwas_dot_ref(ref.unpack_tiled(packed, block_n), mean, inv_std,
                                        y_pad, n_samples=n, dof=dof, input_dtype=dtype)

            whole, errs = _hold_gwas_dot(label, packed, mean, inv_std, y, n, block_n, dtype)
            _hold_trait_operand(label, packed, mean, inv_std, y, block_n, dtype)
            if label == "cell":
                _split_bitwise(packed, mean, inv_std, y, n, block_n, dtype, whole)
            del whole
            # the yardstick: one PyTorch GEMM of the same (decoded) operands
            lib_a, lib_b = ((g, y_pad) if dtype == "fp32"
                            else (g.to(torch.bfloat16), y_pad.to(torch.bfloat16)))
            bound_ms, bound_by = gwas_dot_bound(m, n, p, packed.numel(), dtype)
            row = {
                "shape": label, "m": m, "n": n, "p": p, "dtype": dtype, **errs,
                # 5 back-to-back calls a timing: the host's work per call
                # (checks, allocation, the tensor map) overlaps the card's
                "kernel_ms": cuda_ms(kernel, inner=5),
                "plain_ms": cuda_ms(plain, inner=5),
                "library_ms": cuda_ms(lambda: torch.matmul(lib_a, lib_b), inner=5),
                "bound_ms": bound_ms, "bound_by": bound_by,
            }
            if label == "cell":
                row["split_bitwise"] = {f"p{SPLIT_P}": True, f"m{SPLIT_M}": True}
            if label in ("cell", *DENSE_KERNEL_SHAPES):
                # the call's two kernels on the card's timeline: the
                # prologue (trait operand) and the main kernel
                prof = _device_profile(kernel, 3, top=4)
                row["device_ms_by_kernel"] = {
                    ("prologue" if "trait_operand" in k else "main" if "gwas_dot" in k else k): v
                    for k, v in prof["top_kernels_ms"].items()}
            row["build"] = _mode_build(dtype)
            if dtype == "fp32":
                # why the plain version sums in float64: the fp32 GEMM's own
                # r error against that sum, beside the kernel's r_max_abs_err
                r_lib = torch.clamp(torch.matmul(lib_a, lib_b) / float(n), -1.0, 1.0)
                row["library_r_max_abs_err"] = float((r_lib - plain()[0]).abs().max())
                del r_lib
            del lib_a, lib_b
            row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
            emit({"phase": "kernel", **row})
            if label == "cell" and dtype == "fp32":
                main = row
            if label in DENSE_KERNEL_SHAPES:
                dense_rows[f"{label}/{dtype}"] = row
        del packed, mean, inv_std, y, y_pad, g
        torch.cuda.empty_cache()
    for label, m, n, p, block_n in KERNEL_EDGES:
        inputs = _kernel_inputs(m, n, p, block_n, seed=m + n + p, missing_row=True)
        for dtype in ("fp32", "bf16"):
            (r, t), errs = _hold_gwas_dot(label, *inputs, n, block_n, dtype)
            check(bool((r[-1] == 0).all() and (t[-1] == 0).all()),
                  f"gwas_dot {label} {dtype}: the all-missing row is not 0")
            _hold_trait_operand(label, *inputs, block_n, dtype)
            emit({"phase": "kernel", "shape": label, "m": m, "n": n, "p": p,
                  "block_n": block_n, "dtype": dtype, **errs, "build": _mode_build(dtype)})
    return main, dense_rows


class Collect:
    """A result writer that keeps each cell's payload in memory, for the
    comparisons below (the TSVs hold rounded text)."""

    name = "collect"

    def open(self, session) -> None:
        from repro_torch.core.sinks import BestTraitSink, LambdaGCSink

        self.best = BestTraitSink(session.n_traits)
        self.lam = LambdaGCSink()
        self.cells: dict = {}

    def write(self, cell) -> None:
        self.best.on_cell(cell)
        self.lam.on_cell(cell)
        self.cells[(cell.batch_index, cell.block_index)] = cell.arrays

    def close(self) -> dict:
        return {}

    def abort(self) -> None:
        pass

    def hits(self):
        import numpy as np

        hits = np.concatenate([np.zeros((0, 2), np.int32)] + [a["hits"] for a in self.cells.values()])
        stats = np.concatenate([np.zeros((0, 3), np.float32)] + [a["hit_stats"] for a in self.cells.values()])
        order = np.lexsort((hits[:, 1], hits[:, 0]))
        return hits[order], stats[order]

    def canonical(self) -> dict:
        """Everything a run emits, independent of its trait blocking."""
        import numpy as np

        hits, stats = self.hits()
        tracks = {}
        for (b, k), a in sorted(self.cells.items()):
            if "maf" in a:
                for key in ("maf", "valid", "t_probe", "omnibus_nlp"):
                    if key in a:
                        tracks.setdefault(key, []).append(a[key])
        return {
            "hits": hits, "hit_stats": stats,
            "best_nlp": self.best.best_nlp, "best_marker": self.best.best_marker,
            **{k: np.concatenate(v) for k, v in tracks.items()},
            "lambda_gc": np.float64(self.lam.result()["lambda_gc"]),
        }


def _run(study, out_dir: str | None, collect: "Collect | None" = None, **plan_kwargs):
    """Plan, prepare and stream one scan; returns (collector, summary, timing).
    The launch counts are the scan's own: set to 0 after the prepare (the
    lmm setup runs no kernel of this repo) and read when the stream ends.
    ``max_memory_allocated`` is the card's peak over the stream."""
    import torch

    from repro_torch.api import TsvWriter

    plan = study.plan(device=DEVICE, **plan_kwargs)
    t0 = time.perf_counter()
    plan.prepare()
    prepare_s = time.perf_counter() - t0
    session = plan.run()
    cells = []
    prev = {"step": 0.0, "busy": 0.0}

    def progress(m):
        s = m.summary()
        # the serial walk's label is "serial", an executor slot's "dev0" (or
        # "<host>/dev0" under shared-fs); replayed cells count as "checkpoint"
        busy = sum(d["busy_s"] for label, d in s["per_device"].items()
                   if label != "checkpoint")
        cells.append({"cell": m.cells_done, "step_s": s["step_s"] - prev["step"],
                      "wall_s": busy - prev["busy"]})
        prev.update(step=s["step_s"], busy=busy)

    session.progress = progress
    col = Collect() if collect is None else collect
    writers = [col] + ([TsvWriter(out_dir)] if out_dir else [])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    summary = session.stream_to(*writers)
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    metrics = session.metrics.summary()
    info = session.lmm_info
    lmm = None if info is None else {
        **{f"{k}_s": v for k, v in info["setup_s"].items()},
        "scopes": info["scopes"], "loco": info["loco"],
        "delta": ({str(k): float(v) for k, v in info["delta"].items()}
                  if isinstance(info["delta"], dict) else float(info["delta"])),
        "dof": session.dof,
    }
    return col, summary, {
        "prepare_s": prepare_s, "wall_s": wall, "launches": launches,
        "step_s": metrics["step_s"], "extract_s": metrics["extract_s"],
        "decode_s": metrics["decode_s"], "cells": cells,
        "grid": [session.n_batches, session.n_trait_blocks],
        "genotype_staging": session.prepared.ctx.genotype_staging,
        "executor": session.executor_info,
        "live_cells": metrics["live_cells"], "replayed_cells": metrics["replayed_cells"],
        "max_memory_allocated": peak,
        **({"lmm": lmm} if lmm else {}),
    }


def _compare(a: Collect, b: Collect, threshold: float, tol=FUSED_TOL) -> dict:
    """Same hit set outside the +/-band around the threshold, values within
    ``tol`` = (r, t (rel, abs), nlp (rel, abs)), lambda_gc within 1e-3."""
    import numpy as np

    tol_r, tol_t, tol_nlp = tol

    ha, sa = a.hits()
    hb, sb = b.hits()
    ta = {tuple(h): s for h, s in zip(ha.tolist(), sa)}
    tb = {tuple(h): s for h, s in zip(hb.tolist(), sb)}
    for x, y, nx, ny in ((ta, tb, "a", "b"), (tb, ta, "b", "a")):
        missing = [k for k, s in x.items() if s[2] >= threshold + HIT_BAND and k not in y]
        check(not missing, f"hits in {nx} but not in {ny}: {missing[:5]}")
    common = sorted(set(ta) & set(tb))
    dr = dt = dn = 0.0
    for k in common:
        ra, tva, na = (float(v) for v in ta[k])
        rb, tvb, nb = (float(v) for v in tb[k])
        dr, dt, dn = max(dr, abs(ra - rb)), max(dt, abs(tva - tvb)), max(dn, abs(na - nb))
        check(abs(ra - rb) <= tol_r, f"hit {k}: r {ra} vs {rb}")
        check(abs(tva - tvb) <= tol_t[1] + tol_t[0] * abs(tvb), f"hit {k}: t {tva} vs {tvb}")
        check(abs(na - nb) <= tol_nlp[1] + tol_nlp[0] * abs(nb), f"hit {k}: nlp {na} vs {nb}")
    bn_a, bn_b = a.best.best_nlp, b.best.best_nlp
    best_dn = float(np.max(np.abs(bn_a - bn_b)))
    check(bool(np.all(np.abs(bn_a - bn_b) <= tol_nlp[1] + tol_nlp[0] * np.abs(bn_b))),
          f"per-trait best nlp differs by up to {best_dn}")
    la, lb = a.lam.result()["lambda_gc"], b.lam.result()["lambda_gc"]
    check(abs(la - lb) <= 1e-3, f"lambda_gc {la} vs {lb}")
    return {"hits_a": len(ta), "hits_b": len(tb), "common": len(common),
            "max_dr": dr, "max_dt": dt, "max_dnlp": dn, "best_max_dnlp": best_dn,
            "lambda_gc": [la, lb]}


def _scan_cohort(tmp: str):
    """The scan cohort (``SCAN``, seed 2026) as ``tmp/cohort.bed`` and its
    Study."""
    from repro_torch.api import Study
    from repro_torch.io import PlinkBed, synth
    from repro_torch.io.plink import write_plink

    cohort = synth.make_cohort(
        n_samples=SCAN["n_samples"], n_markers=SCAN["n_markers"],
        n_traits=SCAN["n_traits"], n_covariates=SCAN["n_covariates"],
        n_causal=SCAN["n_causal"], effect_size=SCAN["effect_size"], seed=2026,
    )
    bed = write_plink(os.path.join(tmp, "cohort"), cohort.dosages, sample_ids=cohort.sample_ids)
    return Study.from_arrays(PlinkBed(bed), cohort.phenotypes, cohort.covariates), cohort


def phase_scan(tmp: str):
    import numpy as np

    from repro_torch.api import GridSpec

    t0 = time.perf_counter()
    study, cohort = _scan_cohort(tmp)
    setup_s = time.perf_counter() - t0
    grid = GridSpec(batch_markers=SCAN["batch_markers"], trait_block=SCAN["trait_block"])
    col, summary, timing = _run(study, os.path.join(tmp, "fused"), engine="fused", grid=grid)
    cells = timing["grid"][0] * timing["grid"][1]
    for name in ("gwas_dot", "compact_survivors"):
        check(timing["launches"][name] == cells,
              f"the fused scan launched {name} {timing['launches'][name]} times, "
              f"not once per cell ({cells})")
    check_refined_on_card("scan", timing["launches"], cells)
    hits, stats = col.hits()
    check(bool(np.isfinite(stats).all()), "non-finite hit statistics")
    found = {tuple(h) for h in hits.tolist()}
    planted = {(m, t) for m, t, _ in cohort.effects}
    missed = sorted(planted - found)
    check(not missed, f"planted effects missing from hits.tsv: {missed}")
    with open(os.path.join(tmp, "fused", "hits.tsv")) as f:
        tsv_rows = sum(1 for _ in f) - 1
    check(tsv_rows == len(hits), f"hits.tsv has {tsv_rows} rows, the stream {len(hits)}")
    emit({"phase": "scan", **SCAN, "cohort_setup_s": setup_s, **timing, "hits": len(hits),
          "planted": len(planted), "lambda_gc": summary["lambda_gc"]})
    return study, cohort, col, timing


def phase_cross(tmp: str, study, fused: Collect) -> tuple[Collect, dict]:
    """The library GEMM at full N (the dense engine under dense staging) as
    the cross-check of both gwas_dot routes: the fused scan and the dense
    engine under packed staging (its product in gwas_dot).  Returns the
    packed dense scan, which the later phases hold their runs against, and
    its timing."""
    from repro_torch.api import GridSpec, IOSpec

    grid = GridSpec(batch_markers=SCAN["batch_markers"], trait_block=SCAN["trait_block"])
    library, _, lib_timing = _run(study, None, engine="dense", grid=grid,
                                  io=IOSpec(genotype_staging="dense"))
    check(lib_timing["launches"]["gwas_dot"] == 0,
          f"cross: dense staging launched gwas_dot {lib_timing['launches']['gwas_dot']} times; "
          "its product is the library's")
    dense, _, timing = _run(study, os.path.join(tmp, "dense"), engine="dense", grid=grid)
    cells = timing["grid"][0] * timing["grid"][1]
    calls = dense_gwas_dot_calls(cells, SCAN["trait_block"])
    check(timing["launches"]["gwas_dot"] == calls, f"cross: packed staging launched gwas_dot "
          f"{timing['launches']['gwas_dot']} times, not {calls}")
    for label, run in (("fused", fused), ("dense_packed", dense)):
        cmp = _compare(run, library, threshold=7.301)
        emit({"phase": "cross", "engines": [label, "dense_library"], **cmp})
    emit({"phase": "cross", "dense_library_wall_s": lib_timing["wall_s"],
          "dense_library_step_s": lib_timing["step_s"], "dense_packed_wall_s": timing["wall_s"],
          "dense_packed_step_s": timing["step_s"], "dense_packed_gwas_dot": calls})
    return dense, timing


class MvCollect(Collect):
    """A ``Collect`` that also keeps the prepared scan and, per live cell, the
    card's own r tile and omnibus S (device tensors, no copy), for the
    float64 oracle after the run."""

    def open(self, session) -> None:
        super().open(session)
        self.prepared = session.prepared
        self.tiles: dict = {}

    def write(self, cell) -> None:
        super().write(cell)
        if cell.view is not None:
            out, m = cell.view._out, cell.view.m_batch
            self.tiles[cell.lo] = (out["r"][:m], out["omnibus"][:m])


def _omnibus_medians(omni, effects, n_markers: int) -> dict:
    import numpy as np

    planted = sorted({m for m, _, _ in effects})
    null = np.setdiff1d(np.arange(n_markers), planted)
    return {"planted_median_nlp": float(np.median(omni[planted])),
            "null_median_nlp": float(np.median(omni[null]))}


def phase_multivariate(tmp: str, study, cohort) -> Collect:
    """``gwas scan --multivariate``: the scan cohort unblocked (the reference
    refuses a blocked multivariate grid) on the dense engine, with the dense
    p-value epilogue the omnibus needs.  Hits and per-trait winners are
    byte-equal to phase ``cross``'s dense run; S holds against a float64
    oracle on the card's own r (W from a float64 eigh of the same panel),
    ``omnibus_nlp`` against scipy's float64 ``gammaincc``, and
    ``n_traits_eff`` against float64 Li & Ji.  The product runs in
    ``gwas_dot`` once a cell (packed staging on a card), the p-values in the
    refine kernel; no other kernel of this repo runs.
    The reference's own omnibus check (planted median > 5, null < 1) runs on
    its test cohort; at the scan cohort, where each planted marker moves one
    trait of 2,048, the null median is checked and the planted one is
    printed beside its noncentral chi-square prediction."""
    import numpy as np
    import scipy.special as sp
    import scipy.stats as st
    import torch

    from repro_torch.api import GridSpec, Study
    from repro_torch.core import multivariate as mv
    from repro_torch.io import PlinkBed, synth
    from repro_torch.io.plink import write_plink

    grid = GridSpec(batch_markers=SCAN["batch_markers"], trait_block=0)
    out = os.path.join(tmp, "multivariate")
    col, _, timing = _run(study, out, collect=MvCollect(), engine="dense", grid=grid,
                          multivariate=True)
    mv_calls = dense_gwas_dot_calls(timing["grid"][0] * timing["grid"][1], SCAN["n_traits"])
    check(launched_besides_refine(timing["launches"]) == {"gwas_dot": mv_calls},
          f"multivariate: kernels launched {timing['launches']}; the path runs gwas_dot "
          f"{mv_calls} times and the refine")
    check_refined_on_card("multivariate", timing["launches"],
                          timing["grid"][0] * timing["grid"][1])
    for name in ("hits.tsv", "per_trait_best.tsv"):
        with open(os.path.join(tmp, "dense", name), "rb") as a, \
                open(os.path.join(out, name), "rb") as b:
            check(a.read() == b.read(), f"multivariate: {name} differs from the dense run's")
    with open(os.path.join(out, "qc.tsv")) as f:
        header = f.readline().split()
    check(header[-1] == "omnibus_neglog10p", f"multivariate: qc.tsv header {header}")
    prep = col.prepared
    ctx = prep.ctx
    n = study.n_samples
    check(ctx.multivariate and ctx.whitening is not None
          and ctx.whitening.device == prep.device, "multivariate: no whitening on the card")

    # Gram + eigh of the full panel on the card, warm (prepare_s holds the first)
    y = prep.panels.device_block(prep.trait_blocks[0])
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mv.whiten_panel(y)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)

    # the float64 oracle, on the card, on the card's own r
    y64 = y.double()
    lam, vec = torch.linalg.eigh(y64.T @ y64 / n)
    lam, vec = torch.flip(lam, (0,)), torch.flip(vec, (1,))
    keep = lam > 1e-6 * lam[0]
    w64 = vec[:, keep] * torch.rsqrt(lam[keep])[None, :]
    lam_np = np.maximum(lam.cpu().numpy(), 0.0)
    meff64 = float(np.sum((lam_np >= 1.0) + (lam_np - np.floor(lam_np))))
    p = SCAN["n_traits"]
    meff_tol = MV_TOL["meff_ulps_per_trait_level"] * p * math.log2(p) * 2.0 ** -24
    check(abs(ctx.n_traits_eff - meff64) <= meff_tol,
          f"multivariate: n_traits_eff {ctx.n_traits_eff} vs float64 {meff64}")
    s_card, s_rel = [], 0.0
    nc_planted = []
    planted = {m: t for m, t, _ in cohort.effects}
    for lo, (r, s) in sorted(col.tiles.items()):
        s64 = n * torch.sum((r.double() @ w64) ** 2, dim=-1)
        s_rel = max(s_rel, float(torch.max(torch.abs(s.double() - s64) / s64)))
        s_card.append(s.cpu().numpy())
        r_host = r.cpu().numpy()
        nc_planted += [n * float(r_host[m - lo, t]) ** 2 for m, t in planted.items()
                       if lo <= m < lo + r_host.shape[0]]
    col.tiles = {}
    check(s_rel <= MV_TOL["s_rel"], f"multivariate: S off the float64 oracle by {s_rel} (rel)")
    s_all = np.concatenate(s_card).astype(np.float64)
    omni = col.canonical()["omnibus_nlp"]
    check(omni.shape == s_all.shape and bool(np.isfinite(omni).all()),
          "multivariate: omnibus_nlp not finite or of the wrong shape")
    k = ctx.n_traits_eff
    with np.errstate(divide="ignore"):
        exact = -np.log10(sp.gammaincc(k / 2.0, s_all / 2.0))
    rtol, atol = MV_TOL["nlp"]
    fin = np.isfinite(exact)
    nlp_err = float(np.max(np.abs(omni[fin] - exact[fin])))
    check(bool(np.all(np.abs(omni[fin] - exact[fin]) <= atol + rtol * exact[fin])),
          f"multivariate: omnibus_nlp off scipy's float64 gammaincc by {nlp_err}")
    check(bool(np.all(omni[~fin] > 300.0)), "multivariate: an underflowing lane below 300")
    med = _omnibus_medians(omni, cohort.effects, s_all.shape[0])
    check(med["null_median_nlp"] < 1.0, f"multivariate: null median {med['null_median_nlp']}")
    check(med["planted_median_nlp"] > med["null_median_nlp"],
          f"multivariate: planted median {med} not above the null's")
    # noncentral chi-square at the planted markers' own N r^2 (each moves one
    # trait; the panel is near-white, so the whitening keeps N r^2)
    predicted = float(np.median(-np.log10(st.chi2.sf(st.ncx2.median(k, nc_planted), k))))

    # the reference's own check, on its test cohort
    small = synth.make_cohort(**MV_SMALL)
    bed = write_plink(os.path.join(tmp, "mv_small"), small.dosages, sample_ids=small.sample_ids)
    small_study = Study.from_arrays(PlinkBed(bed), small.phenotypes, small.covariates,
                                    device=DEVICE)
    small_col, _, small_timing = _run(small_study, None, engine="dense",
                                      grid=GridSpec(batch_markers=256), multivariate=True)
    small_calls = dense_gwas_dot_calls(small_timing["grid"][0] * small_timing["grid"][1],
                                       MV_SMALL["n_traits"])
    check(launched_besides_refine(small_timing["launches"]) == {"gwas_dot": small_calls},
          f"multivariate/small: kernels launched {small_timing['launches']}")
    small_med = _omnibus_medians(small_col.canonical()["omnibus_nlp"], small.effects,
                                 MV_SMALL["n_markers"])
    check(small_med["planted_median_nlp"] > 5.0 and small_med["null_median_nlp"] < 1.0,
          f"multivariate/small: omnibus medians {small_med}")

    emit({"phase": "multivariate", **{k_: SCAN[k_] for k_ in
                                      ("n_samples", "n_markers", "n_traits", "n_covariates",
                                       "batch_markers")},
          "trait_block": 0, "engine": "dense",
          "whiten_s": statistics.median(runs), "whiten_s_runs": runs,
          "n_traits_eff": ctx.n_traits_eff, "n_traits_eff_f64": meff64,
          "n_traits_eff_tol": meff_tol,
          **{k_: timing[k_] for k_ in ("prepare_s", "wall_s", "step_s", "extract_s",
                                      "max_memory_allocated", "launches", "cells")},
          "hits_and_best_bytes_equal_to_cross_dense": True,
          "s_max_rel_err_vs_f64": s_rel, "s_tol_rel": MV_TOL["s_rel"],
          "omnibus_nlp_max_abs_err_vs_scipy_f64": nlp_err, "omnibus_nlp_tol": MV_TOL["nlp"],
          "underflowing_lanes": int((~fin).sum()), **med,
          "predicted_planted_median_nlp": predicted,
          "small": {**MV_SMALL, **small_med, "wall_s": small_timing["wall_s"]}})
    return col


def phase_identities(tmp: str, cohort) -> None:
    import numpy as np

    from repro_torch.api import GridSpec, IOSpec, Study
    from repro_torch.io import PlinkBed
    from repro_torch.io.plink import write_plink

    m = IDENTITY_MARKERS
    bed = write_plink(os.path.join(tmp, "head"), cohort.dosages[:m], sample_ids=cohort.sample_ids)
    study = Study.from_arrays(PlinkBed(bed), cohort.phenotypes, cohort.covariates)
    runs = {
        "sparse": dict(grid=GridSpec(batch_markers=m)),
        "dense_epilogue": dict(grid=GridSpec(batch_markers=m), sparse_epilogue=False),
        "blocked": dict(grid=GridSpec(batch_markers=m, trait_block=SCAN["trait_block"])),
        "dense_staging": dict(grid=GridSpec(batch_markers=m), io=IOSpec(genotype_staging="dense")),
    }
    canon = {}
    for name, kw in runs.items():
        col, _, timing = _run(study, None, engine="fused", **kw)
        check(timing["launches"]["gwas_dot"] > 0, f"identities/{name}: kernel not launched")
        check((timing["launches"]["compact_survivors"] > 0) == (name != "dense_epilogue"),
              f"identities/{name}: compact_survivors launched "
              f"{timing['launches']['compact_survivors']} times")
        check_refined_on_card(f"identities/{name}", timing["launches"],
                              timing["grid"][0] * timing["grid"][1])
        canon[name] = col.canonical()
    result = _bitwise(canon, "sparse", ("dense_epilogue", "blocked", "dense_staging"))
    emit({"phase": "identities", "markers": m, "hits": int(len(canon["sparse"]["hits"])),
          **result})


class StreamAudit:
    """Records, while active, every staging copy, kernel-wrapper call and
    device-to-host pull made on the card: the wrapper, the calling thread
    and the raw handle of the current stream of the tensor's device.  The
    wrappers are replaced by pass-through spies (the kernels' own launch
    counts are untouched) and restored on exit."""

    def __init__(self):
        self.calls: list[tuple[str, str, int]] = []
        self._undo: list = []

    def __enter__(self) -> "StreamAudit":
        import threading

        import torch

        from repro_torch.core import engines, panels, sinks
        from repro_torch.kernels import tstat as ts
        from repro_torch.kernels.gwas_dot import gwas_dot as gd

        def spy(mod, name, device_of):
            real = getattr(mod, name)

            def wrapped(*a, **k):
                dev = device_of(*a, **k)
                if dev is not None and dev.type == "cuda":
                    dev = torch.device("cuda", dev.index if dev.index is not None
                                       else torch.cuda.current_device())
                    self.calls.append((name, threading.current_thread().name, dev.index,
                                       torch.cuda.current_stream(dev).cuda_stream))
                return real(*a, **k)

            setattr(mod, name, wrapped)
            self._undo.append((mod, name, real))

        tensor_dev = lambda x, *a, **k: x.device if isinstance(x, torch.Tensor) else None  # noqa: E731
        spy(engines, "to_device", lambda arr, device: device)
        spy(panels, "to_device", lambda arr, device: device)
        spy(sinks, "_host", tensor_dev)
        spy(gd, "gwas_dot_fused", tensor_dev)
        for name in ("compact_survivors", "screen_compact", "tstat", "refine_neglog10p_device"):
            spy(ts, name, tensor_dev)
        return self

    def __exit__(self, *exc) -> None:
        for mod, name, real in reversed(self._undo):
            setattr(mod, name, real)

    def check_slot_streams(self, label: str) -> dict:
        """Every call from an executor slot's threads (its worker, tail and
        panel look-ahead, named by the slot's number) ran on one stream of
        one device, not that device's default stream, and no two slots
        shared a stream; the slots' kernels were among the calls (the
        refine kernel on every path)."""
        import re

        import torch

        slots: dict[str, set] = {}
        for name, thread, index, stream in self.calls:
            m = re.match(r"(scan-device-|slot-tail-|panel-prefetch-dev)(\d+)$", thread)
            if m:
                slots.setdefault(m.group(2), set()).add((index, stream))
        check(bool(slots), f"{label}: no call from a slot thread")
        for slot, pairs in slots.items():
            check(len(pairs) == 1, f"{label}: slot {slot} ran on {pairs}")
            (index, stream), = pairs
            default = torch.cuda.default_stream(torch.device("cuda", index)).cuda_stream
            check(stream != default, f"{label}: slot {slot} ran on the default stream")
        check(len({p for pairs in slots.values() for p in pairs}) == len(slots),
              f"{label}: two slots shared a stream")
        kernels = sorted({c[0] for c in self.calls} - {"to_device", "_host"})
        check("refine_neglog10p_device" in kernels, f"{label}: kernel wrappers called: {kernels}")
        return {"calls": len(self.calls), "slots": {s: sorted(p)[0][0] for s, p in slots.items()},
                "threads": sorted({c[1].rstrip("0123456789") for c in self.calls}),
                "kernel_wrappers": kernels, "one_stream_per_slot": True,
                "default_stream": False}


def phase_executor(tmp: str, study, fused: Collect, dense: Collect,
                   multivariate: Collect) -> dict:
    """The multi-device executor at the scan cell: ``shared-fs`` on one slot
    (``cuda:0`` and its own stream), the fused engine three ways, the dense
    engine once and the dense multivariate screen once (unblocked), each
    canonical-bitwise equal to its serial run on the default stream (the
    omnibus track included), with its kernels launched once per cell from the
    slot's stream (the multivariate path launches gwas_dot and no compaction;
    every path launches the refine kernel at least once a cell)."""
    from repro_torch.api import ExecSpec, GridSpec

    grid = GridSpec(batch_markers=SCAN["batch_markers"], trait_block=SCAN["trait_block"])
    unblocked = GridSpec(batch_markers=SCAN["batch_markers"], trait_block=0)
    runs = {
        "fused": ("fused", dict(), dict(grid=grid)),
        "fused_trait_major": ("fused", dict(placement="trait-major", lease_batches=1),
                              dict(grid=grid)),
        "fused_unpipelined": ("fused", dict(slot_prefetch=0, autotune_lease=False),
                              dict(grid=grid)),
        "dense": ("dense", dict(), dict(grid=grid)),
        "dense_multivariate": ("dense", dict(), dict(grid=unblocked, multivariate=True)),
    }
    serial = {"fused": fused.canonical(), "dense": dense.canonical(),
              "dense_multivariate": multivariate.canonical()}
    rows = {}
    for name, (engine, ex, plan_kw) in runs.items():
        with StreamAudit() as audit:
            col, _, timing = _run(
                study, None, engine=engine,
                checkpoint_dir=os.path.join(tmp, f"ck_{name}"),
                executor=ExecSpec(devices=1, backend="shared-fs", host_id="h0", **ex),
                **plan_kw,
            )
        cells = timing["grid"][0] * timing["grid"][1]
        check(timing["live_cells"] == cells, f"executor/{name}: {timing['live_cells']} live "
              f"cells of {cells}")
        mv = plan_kw.get("multivariate", False)
        # both engines multiply packed codes in gwas_dot on the card; the
        # dense one in calls of KERNEL_TRAIT_CHUNK traits
        calls = (dense_gwas_dot_calls(cells, SCAN["n_traits"]) if mv
                 else dense_gwas_dot_calls(cells, SCAN["trait_block"]) if engine == "dense"
                 else cells)
        check(timing["launches"]["gwas_dot"] == calls, f"executor/{name}: gwas_dot launched "
              f"{timing['launches']['gwas_dot']} times, not {calls}")
        if not mv:
            check(timing["launches"]["compact_survivors"] == cells,
                  f"executor/{name}: compact_survivors launched "
                  f"{timing['launches']['compact_survivors']} times, not once per cell ({cells})")
        check_refined_on_card(f"executor/{name}", timing["launches"], cells)
        if mv:
            check(launched_besides_refine(timing["launches"]) == {"gwas_dot": calls},
                  f"executor/{name}: kernels launched {timing['launches']}")
        base = "dense_multivariate" if mv else engine
        canon = col.canonical()
        check(("omnibus_nlp" in canon) == mv, f"executor/{name}: omnibus track")
        _bitwise({"serial": serial[base], name: canon}, "serial", (name,))
        info = timing["executor"]
        rows[name] = {
            "engine": engine, "bitwise_vs_serial": True, "launches": timing["launches"],
            **{k: timing[k] for k in ("wall_s", "prepare_s", "step_s", "extract_s",
                                     "decode_s", "max_memory_allocated", "cells")},
            "autotune": info["autotune"], "wait_share": info["autotune"]["wait_share"],
            "workers": info["workers"], "placement": info["placement"],
            "slot_prefetch": info["slot_prefetch"],
            "streams": audit.check_slot_streams(name),
        }
    # Control: the reference's order, in which a worker's last blocking
    # claim does not wait for its own tail first and so sleeps one lease
    # poll (1 s at the default 60 s TTL) on its own undone lease.
    from repro_torch.api import session as session_mod

    flush = session_mod._SlotTail.flush
    session_mod._SlotTail.flush = lambda self: None
    try:
        col, _, timing = _run(
            study, None, engine="fused", grid=grid,
            checkpoint_dir=os.path.join(tmp, "ck_control"),
            executor=ExecSpec(devices=1, backend="shared-fs", host_id="h0"),
        )
    finally:
        session_mod._SlotTail.flush = flush
    _bitwise({"serial": serial["fused"], "control": col.canonical()}, "serial", ("control",))
    rows["fused_no_tail_flush"] = {
        "engine": "fused", "bitwise_vs_serial": True,
        **{k: timing[k] for k in ("wall_s", "step_s", "extract_s", "decode_s")},
        "workers": timing["executor"]["workers"],
    }
    emit({"phase": "executor", "devices": 1, "backend": "shared-fs", **SCAN, "runs": rows})
    return rows


def phase_devices(tmp: str) -> dict:
    """The multi-device executor over every visible card:
    the scan cohort in 16 cells (1,024 markers x 1,024 traits), fused and
    dense, each bitwise equal to its serial run on ``cuda:0``, one kernel
    launch per cell, each slot on its own card and stream.  Needs two or
    more cards; not part of the default run."""
    import torch

    from repro_torch.api import ExecSpec, GridSpec

    n = torch.cuda.device_count()
    check(n >= 2, f"phase devices needs 2 or more cards, found {n}")
    study, _ = _scan_cohort(tmp)
    grid = GridSpec(batch_markers=MULTIHOST["batch_markers"],
                    trait_block=MULTIHOST["trait_block"])
    rows = {}
    for engine in ("fused", "dense"):
        serial, _, base = _run(study, None, engine=engine, grid=grid)
        # twice: the first run also pays each further card's first use
        # (context, kernel modules, cuBLAS handle, allocator pools)
        for run in ("first", "second"):
            with StreamAudit() as audit:
                col, _, timing = _run(study, None, engine=engine, grid=grid,
                                      executor=ExecSpec(devices=n))
            label = f"devices/{engine}/{run}"
            cells = timing["grid"][0] * timing["grid"][1]
            # both engines launch gwas_dot once a cell (1,024-trait blocks)
            for k in ("gwas_dot", "compact_survivors"):
                check(timing["launches"][k] == cells, f"{label}: {k} launched "
                      f"{timing['launches'][k]} times, not once per cell ({cells})")
            check_refined_on_card(label, timing["launches"], cells)
            _bitwise({"serial": serial.canonical(), "multi": col.canonical()}, "serial",
                     ("multi",))
            info = timing["executor"]
            check(info["devices"] == n, f"{label}: {info['devices']} slots for {n} cards")
            streams = audit.check_slot_streams(label)
            busy = [w for w, st in info["workers"].items() if st["completed"] > 0]
            check(len(busy) >= 2, f"{label}: only {busy} computed cells")
            rows[f"{engine}_{run}"] = {
                "bitwise_vs_serial": True, "cells": cells, "launches": timing["launches"],
                "serial_wall_s": base["wall_s"], "serial_extract_s": base["extract_s"],
                "wall_s": timing["wall_s"],
                **{k: timing[k] for k in ("step_s", "extract_s", "decode_s",
                                         "max_memory_allocated")},
                "workers": info["workers"], "autotune": info["autotune"], "streams": streams,
            }
    emit({"phase": "devices", "cards": n, **MULTIHOST, "runs": rows})
    return rows


_HOST = """
import json, os, sys, time
sys.path.insert(0, os.path.join(sys.argv[1], "src"))
import numpy as np
from repro_torch.api import ExecSpec, GridSpec, Study, TsvWriter
from repro_torch.io import PlinkBed

here, bed, ck, out, host, ttl, barrier = sys.argv[1:8]
study = Study.from_arrays(PlinkBed(bed), np.load(bed[:-4] + ".pheno.npy"),
                          np.load(bed[:-4] + ".cov.npy"), device=sys.argv[8])
plan = study.plan(engine="fused", device=sys.argv[8], checkpoint_dir=ck,
                  grid=GridSpec(batch_markers=int(sys.argv[9]), trait_block=int(sys.argv[10])),
                  executor=ExecSpec(devices=1, backend="shared-fs", host_id=host,
                                    lease_ttl=float(ttl)))
plan.prepare()
if barrier != "-":
    # start the scan together with the peer host
    open(os.path.join(barrier, host), "w").close()
    while len(os.listdir(barrier)) < 2:
        time.sleep(0.01)
session = plan.run()
t0 = time.perf_counter()
session.stream_to(TsvWriter(out))
m = session.metrics.summary()
print(json.dumps({"host": host, "wall_s": time.perf_counter() - t0,
                  "live_cells": m["live_cells"], "replayed_cells": m["replayed_cells"],
                  "workers": session.executor_info["workers"]}), flush=True)
"""


def _spawn_host(tmp: str, bed: str, ck: str, host: str, ttl: float, barrier: str):
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    return subprocess.Popen(
        [sys.executable, "-c", _HOST, HERE, bed, ck, os.path.join(tmp, host), host, str(ttl),
         barrier, DEVICE, str(MULTIHOST["batch_markers"]), str(MULTIHOST["trait_block"])],
        cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )


def _host_result(proc, host: str, timeout: float = 600) -> dict:
    out, err = proc.communicate(timeout=timeout)
    check(proc.returncode == 0, f"host {host} failed ({proc.returncode}):\n{err[-3000:]}")
    return json.loads(out.strip().splitlines()[-1])


def _tsv_bytes(out: str) -> dict:
    return {f: open(os.path.join(out, f), "rb").read()
            for f in ("hits.tsv", "per_trait_best.tsv", "qc.tsv")}


def phase_multihost(tmp: str, study, cohort) -> dict:
    """Two host processes on one card share one checkpoint directory under
    ``shared-fs`` at full width (16 cells).  Live: both write byte-identical
    outputs, equal to a serial in-process run, each computing at least one
    cell.  Killed: host A is SIGKILLed after its first committed cell, and
    host B (short lease TTL) reclaims A's leases and writes the same bytes."""
    import numpy as np

    from repro_torch.api import GridSpec

    work = os.path.join(tmp, "multihost")
    os.makedirs(work)
    bed = os.path.join(tmp, "cohort.bed")
    np.save(bed[:-4] + ".pheno.npy", cohort.phenotypes)
    np.save(bed[:-4] + ".cov.npy", cohort.covariates)
    grid = GridSpec(batch_markers=MULTIHOST["batch_markers"],
                    trait_block=MULTIHOST["trait_block"])
    _, _, serial = _run(study, os.path.join(work, "serial"), engine="fused", grid=grid)
    cells = serial["grid"][0] * serial["grid"][1]
    ref = _tsv_bytes(os.path.join(work, "serial"))
    row = {"phase": "multihost", **MULTIHOST, "cells": cells, "serial_wall_s": serial["wall_s"]}

    # two live hosts, started together after both have prepared
    live = os.path.join(work, "live")
    barrier = os.path.join(live, "barrier")
    os.makedirs(barrier)
    t0 = time.perf_counter()
    procs = {h: _spawn_host(live, bed, os.path.join(live, "ck"), h, 60.0, barrier)
             for h in ("hostA", "hostB")}
    results = {h: _host_result(p, h) for h, p in procs.items()}
    row["live"] = {"command_s": time.perf_counter() - t0, **{
        h: {k: r[k] for k in ("wall_s", "live_cells", "replayed_cells")}
        for h, r in results.items()}}
    for h, r in results.items():
        check(r["live_cells"] >= 1, f"multihost: {h} computed no cell")
        check(r["live_cells"] + r["replayed_cells"] == cells,
              f"multihost: {h} emitted {r['live_cells'] + r['replayed_cells']} of {cells} cells")
        check(_tsv_bytes(os.path.join(live, h)) == ref,
              f"multihost: {h}'s outputs differ from the serial run")

    # host A killed after its first committed cell; host B reclaims its leases
    killed = os.path.join(work, "killed")
    os.makedirs(killed)
    ck = os.path.join(killed, "ck")
    ttl = MULTIHOST["kill_lease_ttl"]
    victim = _spawn_host(killed, bed, ck, "hostA", ttl, "-")
    manifest = os.path.join(ck, "manifest.json")
    deadline = time.monotonic() + 300
    committed = 0
    while time.monotonic() < deadline and victim.poll() is None:
        try:
            with open(manifest) as f:
                committed = len(json.load(f)["completed"])
        except (OSError, ValueError):
            committed = 0
        if committed >= 1:
            break
        time.sleep(0.01)
    check(victim.poll() is None and committed >= 1,
          f"multihost: host A ended ({victim.poll()}) or committed nothing before the kill")
    victim.kill()
    victim.communicate(timeout=60)
    with open(manifest) as f:
        at_kill = len(json.load(f)["completed"])
    check(at_kill < cells, "multihost: host A finished the grid before the kill")
    t0 = time.perf_counter()
    survivor = _host_result(_spawn_host(killed, bed, ck, "hostB", ttl, "-"), "hostB")
    reclaimed = sum(w["reclaimed"] for w in survivor["workers"].values())
    check(reclaimed >= 1, "multihost: host B reclaimed none of host A's leases")
    check(survivor["live_cells"] + survivor["replayed_cells"] == cells,
          "multihost: host B did not emit the whole grid")
    check(_tsv_bytes(os.path.join(killed, "hostB")) == ref,
          "multihost: host B's outputs differ from the serial run")
    row["killed"] = {"hostA_committed_at_kill": at_kill, "command_s": time.perf_counter() - t0,
                     "hostB": {k: survivor[k] for k in ("wall_s", "live_cells", "replayed_cells")},
                     "reclaimed": reclaimed}
    row["bytes_equal_to_serial"] = True
    emit(row)
    return row


def _serve_done(host, rid: str) -> dict:
    info = host.wait(rid, timeout=600)
    check(info["status"] == "done", f"serve request {rid}: {info['status']}: {info['error']}")
    return info


def _offline_window(study, out: str, window, **plan_kwargs) -> tuple:
    """An offline windowed scan of ``study`` into ``out``: (covered, bytes)."""
    from repro_torch.api import TsvWriter

    session = study.plan(device=DEVICE, **plan_kwargs).run(resume=False, marker_window=window)
    session.stream_to(TsvWriter(out))
    return session.window_covered, _tsv_bytes(out)


def _serve_threads() -> list:
    import threading

    return [t.name for t in threading.enumerate() if t.name.startswith("serve-")]


def phase_serve(tmp: str, study) -> dict:
    """The serve layer on the scan cohort at full width, through the entry
    points a user calls: a resident study, three concurrent requests and an
    HTTP round trip, every served table byte-equal to its offline scan."""
    import torch

    from repro_torch.api import GridSpec
    from repro_torch.serve import ServeClient, ServeHost, ServeServer

    work = os.path.join(tmp, "serve")
    os.makedirs(work)
    plan_kwargs = dict(engine="fused", grid=GridSpec(batch_markers=SCAN["batch_markers"],
                                                     trait_block=SCAN["trait_block"]))
    offline = {w: _offline_window(study, os.path.join(work, f"offline_{w[0]}_{w[1]}"), w,
                                  **plan_kwargs)
               for w in SERVE_WINDOWS}
    scan_bytes = _tsv_bytes(os.path.join(tmp, "fused"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    host = ServeHost(devices=1, out_root=os.path.join(work, "served"), device=DEVICE)
    server = None
    try:
        host.admit_study("scan", study, **plan_kwargs)
        boot = host.warm_study("scan")
        reset_launches()
        t0 = time.perf_counter()
        rids = {"c": host.submit_panel("scan", study.phenotypes, list(study.trait_names))}
        rids["a"] = host.submit_window("scan", *SERVE_WINDOWS[0])
        rids["b"] = host.submit_window("scan", *SERVE_WINDOWS[1])
        # each request's finish, seconds after (c) was submitted
        finished: dict = {}
        deadline = time.monotonic() + 600
        while len(finished) < len(rids) and time.monotonic() < deadline:
            for name, rid in rids.items():
                if name not in finished and host.request_info(rid)["status"] in ("done",
                                                                                  "failed"):
                    finished[name] = time.perf_counter() - t0
            time.sleep(0.005)
        infos = {name: _serve_done(host, rid) for name, rid in rids.items()}
        launches = read_launches()
        requests, cells = {}, 0
        for name, window in (("a", SERVE_WINDOWS[0]), ("b", SERVE_WINDOWS[1]), ("c", None)):
            info = infos[name]
            got = _tsv_bytes(os.path.dirname(host.result_path(rids[name], "hits.tsv")))
            if window is None:
                check(got == scan_bytes, "serve: the uploaded panel's tables differ from scan's")
            else:
                covered, want = offline[window]
                check(tuple(info["covered"]) == covered,
                      f"serve: window {window} covered {info['covered']}, offline {covered}")
                check(got == want, f"serve: window {window}'s tables differ from the offline run")
            n = info["metrics"]["live_cells"]
            cells += n
            requests[name] = {"kind": "window" if window else "panel", "window": window,
                              "covered": info["covered"], "wall_s": info["wall_s"],
                              "finished_s": finished[name], "cells": n, "bytes_equal": True,
                              **{k: info["metrics"][k]
                                 for k in ("decode_s", "stage_s", "step_s", "extract_s")}}
        check(cells == 10, f"serve: the three requests computed {cells} cells, not 10")
        for kernel in ("gwas_dot", "compact_survivors"):
            check(launches[kernel] == cells,
                  f"serve launched {kernel} {launches[kernel]} times, not once per cell ({cells})")
        check_refined_on_card("serve", launches, cells)
        summary = host.metrics_summary()
        caches = summary["serve"]["caches"]
        check(caches["device_state"]["hits"] >= 1, f"serve: no device-state cache hit {caches}")
        peak = torch.cuda.max_memory_allocated()
        # the HTTP round trip: the same window as (a), the same bytes
        server = ServeServer(host).start()
        client = ServeClient(*server.address, timeout=600.0)
        t1 = time.perf_counter()
        wid = client.scan_window("scan", *SERVE_WINDOWS[0])
        client.wait(wid, timeout=600)
        http = {"wall_s": time.perf_counter() - t1}
        check(client.fetch(wid, "hits.tsv") == _tsv_bytes(
            os.path.dirname(host.result_path(rids["a"], "hits.tsv")))["hits.tsv"],
              "serve: hits.tsv over HTTP differs from request (a)'s")
        http["hits_bytes_equal"] = True
        check(client.shutdown() == {"ok": True}, "serve: POST /shutdown refused")
        server.wait()
    finally:
        if server is not None:
            server.shutdown()
        host.shutdown()
    leftover = _serve_threads()
    check(host.registry.n_pinned == 0, f"serve: {host.registry.n_pinned} slots pinned")
    check(not leftover, f"serve: threads alive after shutdown: {leftover}")
    latency = {kind: {k: v[k] for k in ("n", "p50_s", "p95_s")}
               for kind, v in summary["serve"]["latency_by_kind"].items()}
    row = {"phase": "serve", "prepare_s": boot["prepare_s"], "requests": requests,
           "finish_order": sorted(finished, key=finished.get),
           "a_before_c": finished["a"] < finished["c"], "latency_by_kind": latency,
           "device_state_cache": {k: caches["device_state"][k]
                                  for k in ("hits", "misses", "evictions")},
           "panel_cache": caches["panel"], "launches": launches,
           "max_memory_allocated": peak, "http": http, "n_pinned_after": 0,
           "serve_threads_after": leftover}
    emit(row)
    return row


def phase_serve_lmm(tmp: str, study, plan_kwargs: dict) -> dict:
    """A resident lmm study (REML at warm-up) answers one window query,
    byte-equal to its offline windowed scan, one screen launch per cell.
    The offline scan runs on the resident plan's prepared state through the
    serial executor's own slot: a second REML prepare would double the
    phase's cost, and the ``lmm_identities`` runs already hold separate
    prepares bitwise equal."""
    from repro_torch.api import TsvWriter
    from repro_torch.serve import ServeHost

    work = os.path.join(tmp, "serve_lmm")
    os.makedirs(work)
    window = SERVE_LMM_WINDOW
    host = ServeHost(devices=1, out_root=os.path.join(work, "served"), device=DEVICE)
    try:
        host.admit_study("lmm", study, **plan_kwargs)
        boot = host.warm_study("lmm")
        offline = host.registry.resident("lmm").plan().run(resume=False, marker_window=window)
        offline.stream_to(TsvWriter(os.path.join(work, "offline")))
        covered, want = offline.window_covered, _tsv_bytes(os.path.join(work, "offline"))
        reset_launches()
        info = _serve_done(host, host.submit_window("lmm", *window))
        launches = read_launches()
        got = _tsv_bytes(os.path.dirname(host.result_path(info["request"], "hits.tsv")))
    finally:
        host.shutdown()
    cells = info["metrics"]["live_cells"]
    check(tuple(info["covered"]) == covered,
          f"serve_lmm: covered {info['covered']}, offline {covered}")
    check(got == want, "serve_lmm: the served tables differ from the offline windowed scan")
    check(launches["screen_compact"] == cells and cells > 0,
          f"serve_lmm launched the screen {launches['screen_compact']} times, not once per "
          f"cell ({cells})")
    check(host.registry.n_pinned == 0 and not _serve_threads(), "serve_lmm: not shut down")
    row = {"phase": "serve_lmm", "window": window, "covered": info["covered"], "cells": cells,
           "prepare_s": boot["prepare_s"], "wall_s": info["wall_s"], "launches": launches,
           "bytes_equal": True}
    emit(row)
    return row


def _bitwise(canon: dict, base_name: str, others) -> dict:
    """Every emitted array of each run in ``others`` equals ``base_name``'s,
    bit for bit."""
    import numpy as np

    base = canon[base_name]
    result = {}
    for name in others:
        other = canon[name]
        check(base.keys() == other.keys(), f"{name}: emitted fields differ")
        bad = [k for k in base if not (base[k].dtype == other[k].dtype
                                       and np.array_equal(base[k], other[k]))]
        check(not bad, f"{base_name} vs {name}: not bitwise equal in {bad}")
        result[name] = "bitwise equal"
    return result


def _tstat_inputs(m: int, p: int, dof: float, seed: int):
    """Correlations as a mixed-model cell gives them (r ~ N(0, 1/dof) under
    the null), a band of strong rows so the screen has survivors past the
    buffer's capacity, and the clip edges."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    r = rng.normal(scale=1.0 / math.sqrt(dof), size=(m, p)).astype(np.float32)
    k = min(32, m)
    r[:k] = rng.normal(scale=8.0 / math.sqrt(dof), size=(k, p)).astype(np.float32)
    r[0, :4] = [1.0, -1.0, 0.0, 0.99999]
    return torch.from_numpy(r).to(DEVICE)


def _hold_compaction(label: str, r, dof: float, t2: float, capacity: int) -> dict:
    """Both entries of the screen kernel against their plain versions on the
    same inputs: t bitwise equal to the tstat kernel's, idx and count
    exactly equal, in r mode against the whole plain version and in t mode
    against the plain compaction of the same t."""
    import torch

    from repro_torch.kernels import tstat as ts

    t, idx, cnt = ts.screen_compact(r, dof, t2, capacity)
    _, idx0, cnt0 = ts.screen_compact_plain(r, dof, t2, capacity)
    idx_t, cnt_t = ts.compact_survivors(t, t2, capacity)
    idx_t0, cnt_t0 = ts.compact_survivors_plain(t, t2, capacity)
    torch.cuda.synchronize()
    check(torch.equal(t.view(torch.int32), ts.tstat(r, dof).view(torch.int32)),
          f"screen {label}: t differs from the tstat kernel's bit for bit")
    check(torch.equal(idx, idx0) and int(cnt) == int(cnt0),
          f"screen {label}: idx/count differ from the plain version ({int(cnt)} vs {int(cnt0)})")
    check(torch.equal(idx_t, idx_t0) and int(cnt_t) == int(cnt_t0),
          f"compact_survivors {label}: idx/count differ from the plain version "
          f"({int(cnt_t)} vs {int(cnt_t0)})")
    check(torch.equal(idx_t, idx) and int(cnt_t) == int(cnt),
          f"{label}: the two entries disagree on the same t")
    idx_err = max([0] + [int((a - b).abs().max()) for a, b in ((idx, idx0), (idx_t, idx_t0))
                         if a.numel()])
    return {"survivors": int(cnt), "capacity": capacity, "idx_max_abs_err": idx_err}


def _syncs_in(fn) -> dict:
    """Run ``fn`` once under torch.cuda.set_sync_debug_mode("warn"): each
    synchronizing op's innermost line in this repo's ``src/``, with its
    count."""
    import traceback
    import warnings
    from collections import Counter

    import torch

    src = os.path.join(HERE, "src") + os.sep
    found: Counter = Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack() if f.filename.startswith(src)]
        where = ours[-1] if ours else None
        found[f"{os.path.relpath(where.filename, HERE)}:{where.lineno}" if where
              else f"{filename}:{lineno}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return dict(sorted(found.items()))


def _sync_census(dof: float, t2: float) -> dict:
    """The compaction's entries and the sparse epilogue under sync-debug
    "error" (none may wait for the host), then the synchronizing ops left
    in one fused step at the scan cell and one lmm step (prolog + cell,
    then the cell alone), both with the sparse epilogue."""
    import torch

    from repro_torch.core.association import AssocOptions, SparseEpilogue, sparse_epilogue_outputs
    from repro_torch.core.engines import build_fused_step, build_lmm_step
    from repro_torch.kernels import tstat as ts

    r = _tstat_inputs(4096, 1024, dof, seed=99)
    t = ts.tstat(r, dof)
    plan = SparseEpilogue(7.301, t2, TSTAT_CAPACITY)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ts.screen_compact(r, dof, t2, TSTAT_CAPACITY)
        ts.compact_survivors(t, t2, TSTAT_CAPACITY)
        sparse_epilogue_outputs(r, t, dof, plan)
        # the control: the plain compaction's torch.nonzero must raise here
        try:
            ts.compact_survivors_plain(t, t2, TSTAT_CAPACITY)
            control_raised = False
        except RuntimeError:
            control_raised = True
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(control_raised, "sync-debug 'error' mode let torch.nonzero through")
    control = _syncs_in(lambda: ts.compact_survivors_plain(t, t2, TSTAT_CAPACITY))
    check(bool(control), "the census found no synchronizing op in torch.nonzero")
    del r, t

    m, n, p = KERNEL_SHAPES[0][1]
    packed, mean, inv_std, y = _kernel_inputs(m, n, p, 512, seed=7)
    valid = torch.ones(m, dtype=torch.bool, device=DEVICE)
    fused = build_fused_step(n_samples=n, n_covariates=SCAN["n_covariates"],
                             options=AssocOptions(), sparse_epilogue=True)
    args = (packed, mean.reshape(-1, 1), inv_std.reshape(-1, 1), valid, y)
    fused(*args)                       # builds and warms up outside the census
    steps = {"fused_step": _syncs_in(lambda: fused(*args))}
    del packed, mean, inv_std, y, args

    gen = torch.Generator(device=DEVICE).manual_seed(7)
    nl = SYNC_LMM_SAMPLES
    g_raw = torch.randint(0, 3, (m, nl), generator=gen, device=DEVICE).to(torch.float32)
    rotation = torch.eye(nl, device=DEVICE)
    qhat = torch.linalg.qr(torch.randn(nl, SCAN["n_covariates"] + 1, generator=gen,
                                       device=DEVICE))[0]
    y_std = torch.randn(nl, p, generator=gen, device=DEVICE)
    lmm = build_lmm_step(n_samples=nl, n_covariates=SCAN["n_covariates"],
                         options=AssocOptions(), epilogue="fused", sparse_epilogue=True)
    lmm(g_raw.clone(), rotation, qhat, y_std)   # warm-up on another staged tensor
    steps["lmm_step"] = _syncs_in(lambda: lmm(g_raw, rotation, qhat, y_std))
    steps["lmm_cell"] = _syncs_in(lambda: lmm(g_raw, rotation, qhat, y_std))
    return {"error_mode": ["screen_compact", "compact_survivors", "sparse_epilogue_outputs"],
            "synchronizing_ops": {"control_compact_survivors_plain": control, **steps}}


def phase_kernel_tstat() -> dict:
    """Kernel 2 and both entries of kernel 3 against their plain versions:
    t at rtol 2e-6 (and bitwise between tstat and the screen), the
    compacted indices and the count exactly.  ``ms`` is per call of the
    whole wrapper, 20 calls back to back (r stays in L2, as it does after
    the correlation GEMM that produces it); ``device_ms`` the same 20 calls
    replayed from a CUDA graph, without the host's work per call."""
    import torch

    from repro_torch.core.stats import t2_screen_threshold
    from repro_torch.kernels import tstat as ts

    dof = float(LMM_SCAN["n_samples"] - 2 - LMM_SCAN["n_covariates"])
    t2 = t2_screen_threshold(7.301, dof)
    rows = {}
    for label, (m, p) in TSTAT_SHAPES:
        r = _tstat_inputs(m, p, dof, seed=m + p)
        n = m * p
        t = ts.tstat(r, dof)
        t0 = ts.tstat_plain(r, dof)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(t).all()), f"tstat {label}: non-finite t")
        excess = (t - t0).abs() - T_RTOL * t0.abs()
        check(float(excess.max()) <= 0.0, f"tstat {label}: t past rtol {T_RTOL}")
        held = _hold_compaction(label, r, dof, t2, TSTAT_CAPACITY)
        check(held["survivors"] > TSTAT_CAPACITY or label != "cell",
              f"screen {label}: {held['survivors']} survivors do not overflow the buffer")
        tiles = -(-n // COMPACT_TILE)
        slots = 4 * TSTAT_CAPACITY + 8 * tiles
        # flops per element: t ~6 (mul, sub, max, div, rsqrt, mul), the
        # screen 2 more (square, compare)
        for name, kernel, plain, nbytes, flops in (
            ("tstat", lambda: ts.tstat(r, dof), lambda: ts.tstat_plain(r, dof), 8 * n, 6 * n),
            ("screen_compact", lambda: ts.screen_compact(r, dof, t2, TSTAT_CAPACITY),
             lambda: ts.screen_compact_plain(r, dof, t2, TSTAT_CAPACITY), 8 * n + slots, 8 * n),
            ("compact_survivors", lambda: ts.compact_survivors(t, t2, TSTAT_CAPACITY),
             lambda: ts.compact_survivors_plain(t, t2, TSTAT_CAPACITY), 4 * n + slots, 2 * n),
        ):
            bound_ms, bound_by = bytes_bound(nbytes, float(flops))
            device_ms, replayed = graph_ms(kernel)
            # the graph's replays wrote the same results as the calls above
            if name == "tstat":
                check(torch.equal(replayed, t), f"tstat {label}: the replayed t differs")
            else:
                want = plain()[-2:]
                check(torch.equal(replayed[-2], want[0]) and int(replayed[-1]) == int(want[1]),
                      f"{name} {label}: the replayed idx/count differ from the plain version")
            row = {
                "kernel": name, "shape": label, "m": m, "p": p,
                "max_abs_err": (float((t - t0).abs().max()) if name != "compact_survivors"
                                else float(held["idx_max_abs_err"])),
                "ms": cuda_ms(kernel, inner=20), "plain_ms": cuda_ms(plain, inner=20),
                "device_ms": device_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
                "library_ms": None,
            }
            if name != "tstat":
                row.update(held)
            row["bound_share"] = row["bound_ms"] / row["ms"]
            row["device_bound_share"] = row["bound_ms"] / row["device_ms"]
            emit({"phase": "kernel_tstat", **row})
            if label == "cell":
                rows[name] = row
        del r, t, t0
    # the compaction's edges: no survivors, all survivors (overflow), NaN r
    # with a capacity above the tile's size, and an empty tile
    m, p = TSTAT_SHAPES[1][1]
    nan_r = _tstat_inputs(37, 53, dof, seed=5)
    nan_r.view(-1)[::7] = float("nan")
    edges = {
        "none": torch.zeros((m, p), device=DEVICE),
        "all": torch.full((m, p), 0.5, device=DEVICE),
        "nan_above_capacity": nan_r,
        "empty": torch.zeros((0, p), device=DEVICE),
    }
    held = {k: _hold_compaction(k, r, dof, t2, TSTAT_CAPACITY) for k, r in edges.items()}
    check(held["none"]["survivors"] == 0 and held["all"]["survivors"] == m * p
          and held["empty"]["survivors"] == 0, f"edge survivor counts {held}")
    emit({"phase": "kernel_tstat", "edges": held, **_sync_census(dof, t2)})
    return rows


def _refine_cell(seed: int):
    """One OLS cell's refined lanes: each trait's winner (the t of largest
    t^2 over the batch's null markers), then the hit buffer: survivors
    past the screen, then padding t = 0."""
    import torch

    c = REFINE_CELL
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    t = torch.randn(c["markers"], c["traits"], generator=gen, device=DEVICE)
    best = torch.gather(t, 0, torch.argmax(t * t, dim=0, keepdim=True))[0]
    del t
    hits = torch.zeros(c["hit_slots"], device=DEVICE)
    hits[: c["survivors"]] = 5.5 + 3.0 * torch.rand(c["survivors"], generator=gen, device=DEVICE)
    return torch.cat([best, hits])


def _ulp_gap(got, want) -> dict:
    """How far two float32 -log10 p buffers (>= 0) lie apart: the share of
    equal bits, the largest gap in ulps, absolute and relative (where the
    value is at least 1e-3)."""
    import numpy as np

    a = np.asarray(got, np.float32) + np.float32(0.0)   # -0 -> +0
    b = np.asarray(want, np.float32) + np.float32(0.0)
    ulps = np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))
    big = np.abs(b) >= 1e-3
    return {"equal_share": float(np.mean(ulps == 0)), "max_ulps": int(ulps.max()),
            "max_abs": float(np.abs(a - b).max()),
            "max_rel": float((np.abs(a - b)[big] / b[big]).max()) if big.any() else 0.0}


def phase_kernel_refine() -> dict:
    """The refine kernel against its plain version on the card and the
    host refine, within REFINE_RTOL/REFINE_ATOL, on the lane grid at each
    of REFINE_DOFS and at one OLS cell; bits independent of position.
    ``ms`` is per call of the whole route (``stats.refine_neglog10p``), 20
    calls back to back; ``device_ms`` the kernel's 20 calls replayed from a
    CUDA graph; ``plain_ms`` the plain version's eager ops on the card;
    ``host_ms`` the host refine of the same lanes (wall clock, median of 3)."""
    import numpy as np
    import torch

    from repro_torch.core import stats
    from repro_torch.kernels import tstat as ts

    def held(label, t, dof):
        got = stats.refine_neglog10p(t, dof)
        plain = stats.neglog10_p_from_t(t, dof)
        host = stats.refine_neglog10p(t.cpu().numpy(), dof)
        torch.cuda.synchronize()
        k = got.cpu().numpy()
        for name, want in (("plain", plain.cpu().numpy()), ("host", host)):
            check(np.allclose(k, want, rtol=REFINE_RTOL, atol=REFINE_ATOL),
                  f"refine {label}: kernel vs {name} past rtol {REFINE_RTOL} atol {REFINE_ATOL}"
                  f": {_ulp_gap(k, want)}")
        return got, {"vs_plain": _ulp_gap(k, plain.cpu().numpy()), "vs_host": _ulp_gap(k, host)}

    grid = {}
    for dof in REFINE_DOFS:
        t = torch.from_numpy(stats._refine_grid(dof)).to(DEVICE)
        got, grid[str(dof)] = held(f"grid/{dof}", t, dof)
        check(float(got[0]) == 0.0, f"refine grid/{dof}: t = 0 gives {float(got[0])}")
    c = REFINE_CELL
    dof = c["dof"]
    t = _refine_cell(seed=31)
    n = t.numel()
    launches = ts.refine_launches
    got, gap = held("cell", t, dof)
    check(ts.refine_launches == launches + 1, "refine cell: not one launch")
    for lo, hi in ((0, 1), (5, 69), (20000, 20600), (n - 7, n)):
        part = stats.refine_neglog10p(t[lo:hi].clone(), dof)
        check(torch.equal(part.view(torch.int32), got[lo:hi].view(torch.int32)),
              f"refine cell: lanes [{lo}, {hi}) differ alone")
    scalars = stats._refine_scalars(dof)
    device_ms, replayed = graph_ms(lambda: ts.refine_neglog10p_device(t, scalars))
    check(torch.equal(replayed, got), "refine cell: the replayed values differ")
    t_host = t.cpu().numpy()
    host_runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        stats.refine_neglog10p(t_host, dof)
        host_runs.append(1e3 * (time.perf_counter() - t0))
    fraction = int((t * t > scalars.t2_switch).sum())
    flops = fraction * REFINE_FLOPS["fraction"] + (n - fraction) * REFINE_FLOPS["normal"]
    bound_ms, bound_by = bytes_bound(8.0 * n, float(flops))
    row = {
        "kernel": "refine", "lanes": n, "dof": dof, "fraction_lanes": fraction,
        "ms": cuda_ms(lambda: stats.refine_neglog10p(t, dof), inner=20),
        "device_ms": device_ms,
        "plain_ms": cuda_ms(lambda: stats.neglog10_p_from_t(t, dof), inner=3),
        "host_ms": statistics.median(host_runs), "host_ms_runs": host_runs,
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": 8 * n, "flops": flops,
        "library_ms": None, **gap,
        "max_abs_err": gap["vs_plain"]["max_abs"],
    }
    row["device_bound_share"] = row["bound_ms"] / row["device_ms"]
    emit({"phase": "kernel_refine", "grid": grid, **row})
    return row


def phase_lmm_scan(tmp: str) -> dict:
    """The mixed-model path at the paper workload's width, through the
    entry points a user calls; every planted effect must be a hit."""
    import numpy as np

    from repro_torch.api import GridSpec, LmmSpec, Study
    from repro_torch.io import PlinkBed, synth
    from repro_torch.io.plink import write_plink

    cfg = LMM_SCAN
    t0 = time.perf_counter()
    cohort = synth.make_structured_cohort(
        n_samples=cfg["n_samples"], n_markers=cfg["n_markers"], n_traits=cfg["n_traits"],
        n_covariates=cfg["n_covariates"], h2=cfg["h2"], n_causal=cfg["n_causal"],
        effect_size=cfg["effect_size"], seed=2026,
    )
    bed = write_plink(os.path.join(tmp, "lmm"), cohort.dosages, sample_ids=cohort.sample_ids)
    setup_s = time.perf_counter() - t0
    study = Study.from_arrays(PlinkBed(bed), cohort.phenotypes, cohort.covariates)
    out = os.path.join(tmp, "lmm_out")
    col, summary, timing = _run(
        study, out, engine="lmm", lmm=LmmSpec(epilogue="fused", delta=cfg["delta"]),
        grid=GridSpec(batch_markers=cfg["batch_markers"], trait_block=cfg["trait_block"]),
    )
    cells = timing["grid"][0] * timing["grid"][1]
    check(timing["launches"]["screen_compact"] == cells,
          f"the lmm scan launched the screen kernel {timing['launches']['screen_compact']} "
          f"times, not once per cell ({cells})")
    check(timing["launches"]["compact_survivors"] == 0,
          "the lmm scan compacted outside the screen kernel")
    check_refined_on_card("lmm_scan", timing["launches"], cells)
    hits, stats = col.hits()
    check(bool(np.isfinite(stats).all()), "non-finite hit statistics")
    planted = {(m, t) for m, t, _ in cohort.effects}
    missed = sorted(planted - {tuple(h) for h in hits.tolist()})
    check(not missed, f"planted effects missing from the lmm hits: {missed}")
    planted_t = [abs(float(st[1])) for h, st in zip(hits.tolist(), stats)
                 if tuple(h) in planted]
    with open(os.path.join(out, "hits.tsv")) as f:
        tsv_rows = sum(1 for _ in f) - 1
    check(tsv_rows == len(hits), f"hits.tsv has {tsv_rows} rows, the stream {len(hits)}")
    emit({"phase": "lmm_scan", **cfg, "cohort_setup_s": setup_s, **timing,
          "hits": len(hits), "planted": len(planted), "planted_abs_t": {
              "min": min(planted_t), "median": statistics.median(planted_t)},
          "lambda_gc": summary["lambda_gc"]})
    return timing


def phase_lmm_identities(tmp: str) -> dict:
    """The port's bitwise identities on the mixed-model path (REML, LOCO over
    two shards), and the fused epilogue against the dense one."""
    from repro_torch.api import ExecSpec, GridSpec, IOSpec, LmmSpec

    cfg = LMM_IDENT
    study, files = _lmm_ident_cohort(tmp)
    serial_out = os.path.join(tmp, "lmm_ident_out")
    fused = LmmSpec(epilogue="fused", loco=True)
    grid = GridSpec(batch_markers=cfg["batch_markers"], trait_block=cfg["trait_block"])
    runs = {
        "sparse": dict(lmm=fused, grid=grid),
        "dense_audit": dict(lmm=fused, grid=grid, sparse_epilogue=False),
        "unblocked": dict(lmm=fused, grid=GridSpec(batch_markers=cfg["batch_markers"])),
        "dense_staging": dict(lmm=fused, grid=grid, io=IOSpec(genotype_staging="dense")),
        "dense_epilogue": dict(lmm=LmmSpec(epilogue="dense", loco=True), grid=grid),
        # the multi-device executor on one slot (its own stream) under shared-fs
        "shared_fs": dict(lmm=fused, grid=grid, checkpoint_dir=os.path.join(tmp, "ck_lmm"),
                          executor=ExecSpec(devices=1, backend="shared-fs", host_id="h0")),
    }
    cols, canon, launches, info, grids = {}, {}, {}, {}, {}
    for name, kw in runs.items():
        col, _, timing = _run(study, serial_out if name == "sparse" else None,
                              engine="lmm", **kw)
        cols[name], canon[name], launches[name] = col, col.canonical(), timing["launches"]
        info[name] = {"wall_s": timing["wall_s"], "prepare_s": timing["prepare_s"],
                      **timing["lmm"]}
        grids[name] = timing["grid"]
    cells = grids["shared_fs"][0] * grids["shared_fs"][1]
    check(launches["sparse"]["screen_compact"] > 0, "the sparse run never launched the screen")
    check(launches["shared_fs"]["screen_compact"] == cells,
          f"the shared-fs run launched the screen {launches['shared_fs']['screen_compact']} "
          f"times, not once per cell ({cells})")
    check(launches["dense_audit"]["tstat"] > 0, "the dense-audit run never launched tstat")
    check(launches["dense_epilogue"]["tstat"] + launches["dense_epilogue"]["screen_compact"]
          == 0, "the dense epilogue launched a t-statistic kernel")
    result = _bitwise(canon, "sparse", ("dense_audit", "unblocked", "dense_staging",
                                         "shared_fs"))
    cmp = _compare(cols["sparse"], cols["dense_epilogue"], threshold=7.301,
                   tol=LMM_EPILOGUE_TOL)
    emit({"phase": "lmm_identities", **cfg, "hits": int(len(canon["sparse"]["hits"])),
          **result, "fused_vs_dense_epilogue": cmp, "launches": launches, "runs": info})
    phase_serve_lmm(tmp, study, dict(engine="lmm", **runs["sparse"]))
    return launches["dense_audit"], {"files": files, "out": serial_out}


def _gwas(work: str, *args) -> tuple[str, float]:
    """One ``python -m repro_torch.launch.gwas`` subprocess; (stdout, s)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.gwas", *args],
                          cwd=work, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"CLI {args[0]} {args[1:]} failed ({proc.returncode}):\n"
          f"{proc.stderr[-3000:]}")
    return proc.stdout, wall


def _cli(work: str, out: str, genotypes: str, files: dict, *flags) -> tuple[dict, set, float]:
    """One ``repro_torch.launch.gwas scan`` subprocess; (summary, hit keys, s)."""
    _, wall = _gwas(work, "scan", "--genotypes", genotypes, "--pheno", files["pheno"],
                    "--covar", files["cov"], "--out", os.path.join(work, out),
                    "--batch-markers", "256", "--device", DEVICE, *flags)
    with open(os.path.join(work, out, "summary.json")) as f:
        summary = json.load(f)
    with open(os.path.join(work, out, "hits.tsv")) as f:
        next(f)
        found = {tuple(line.split("\t")[:2]) for line in f}
    return summary, found, wall


def _marker_rows(path: str, lo: int, hi: int) -> list:
    """A TSV's data rows whose marker (the synthetic ``rs%08d`` id, first
    column) lies in ``[lo, hi)``, in file order."""
    with open(path) as f:
        next(f)
        return [line for line in f if lo <= int(line.split("\t", 1)[0][2:]) < hi]


def _cli_serve(work: str, files: dict) -> dict:
    """``gwas serve --ready-file`` as a subprocess with the fused CLI scan's
    flags: a second study admitted over HTTP at the ready address, an upload
    of the booted study's own panel (the CLI scan's tables, byte for byte)
    and a window query on the admitted one (the scan's hit and QC rows of
    the covered markers); ``POST /shutdown`` must end it with 0."""
    from repro_torch.api import Study
    from repro_torch.serve import ServeClient

    ready = os.path.join(work, "serve.ready")
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.gwas", "serve", "--genotypes", files["bed"],
         "--pheno", files["pheno"], "--covar", files["cov"], "--engine", "fused",
         "--batch-markers", "256", "--device", DEVICE, "--ready-file", ready,
         "--out-root", os.path.join(work, "served")],
        cwd=work, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        deadline = time.monotonic() + 300
        while not os.path.exists(ready) and proc.poll() is None and time.monotonic() < deadline:
            time.sleep(0.05)
        check(os.path.exists(ready), f"CLI serve did not boot (exit {proc.poll()})")
        row = {"boot_s": time.perf_counter() - t0}
        with open(ready) as f:
            address, port = f.read().split()
        client = ServeClient(address, int(port), timeout=600.0)
        client.admit_study("posted", genotypes=files["bed"], phenotypes=files["pheno"],
                           covariates=files["cov"],
                           plan={"engine": "fused", "grid": {"batch_markers": 256}})
        study = Study.from_files(files["bed"], files["pheno"], files["cov"], device=DEVICE)
        t1 = time.perf_counter()
        pid = client.scan_panel("default", study.phenotypes, study.trait_names)
        wid = client.scan_window("posted", 300, 700)
        client.wait(pid, timeout=600)
        lo, hi = client.wait(wid, timeout=600)["covered"]
        row["requests_s"] = time.perf_counter() - t1
        scan = os.path.join(work, "fused")
        for name, want in _tsv_bytes(scan).items():
            check(client.fetch(pid, name) == want, f"CLI serve: the panel's {name} differs "
                  "from the CLI scan's")
            client.fetch_to(wid, name, os.path.join(work, f"window_{name}"))
        for name in ("hits.tsv", "qc.tsv"):
            got = _marker_rows(os.path.join(work, f"window_{name}"), lo, hi)
            check(got and got == _marker_rows(os.path.join(scan, name), lo, hi),
                  f"CLI serve: the window's {name} rows differ from the CLI scan's")
        client.shutdown()
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            out, err = proc.communicate()
    check(proc.returncode == 0, f"CLI serve exited {proc.returncode}:\n{err[-3000:]}")
    lines = [json.loads(line) for line in out.splitlines()]
    check(lines[-1] == {"stopped": {"requests": {"done": 2}}}, f"CLI serve: {lines[-1]}")
    row.update(covered=[lo, hi], prepare_s=lines[0]["serving"]["prepare_s"],
               device=lines[0]["serving"]["device"], command_s=time.perf_counter() - t0,
               bytes_equal_to_scan=True, exit_code=proc.returncode)
    return row


def phase_cli(tmp: str) -> None:
    import numpy as np

    from repro_torch.core import grm, kinship
    from repro_torch.io import open_genotypes, synth
    from repro_torch.runtime.device import resolve_device

    work = os.path.join(tmp, "cli")
    os.makedirs(work)
    cohort = synth.make_cohort(n_samples=500, n_markers=1200, n_traits=10,
                               n_causal=6, effect_size=0.6, seed=11)
    files = synth.write_cohort_files(cohort, os.path.join(work, "cohort"))
    split = synth.write_split_plink(cohort, os.path.join(work, "cohort"), n_shards=3)
    planted = {(cohort.marker_ids[m], f"trait{t}") for m, t, _ in cohort.effects}
    row = {"phase": "cli"}
    ck = os.path.join(work, "ck")
    for name, genotypes, flags in (
        ("fused", files["bed"], ("--engine", "fused")),
        ("lmm", ",".join(split), ("--engine", "lmm", "--lmm-epilogue", "fused", "--loco")),
        ("multivariate", files["bed"], ("--multivariate", "--checkpoint-dir", ck)),
    ):
        summary, found, wall = _cli(work, name, genotypes, files, *flags)
        check(planted <= found, f"CLI {name} missed planted effects {sorted(planted - found)}")
        check(summary["device"] == str(resolve_device(DEVICE)),
              f"CLI {name} ran on {summary['device']}")
        row[name] = {"wall_s": wall, "hits": summary["hits"], "lambda_gc": summary["lambda_gc"],
                     "device": summary["device"],
                     "genotype_staging": summary["genotype_staging"]}
        if name == "lmm":
            check(summary["lmm"]["scopes"] == 3 and summary["lmm"]["loco"],
                  f"CLI lmm summary {summary['lmm']}")
            row[name]["lmm"] = summary["lmm"]
        if name == "multivariate":
            with open(os.path.join(work, name, "qc.tsv")) as f:
                check(f.readline().split()[-1] == "omnibus_neglog10p",
                      "CLI multivariate: qc.tsv has no omnibus column")
                omni = np.array([float(line.split("\t")[3]) for line in f])
            med = _omnibus_medians(omni, cohort.effects, omni.shape[0])
            check(med["planted_median_nlp"] > 5.0 and med["null_median_nlp"] < 1.0,
                  f"CLI multivariate: omnibus medians {med}")
            row[name].update(med)
    # merge the multivariate scan's checkpoint: the scan's own bytes
    _, wall = _gwas(work, "merge", "--checkpoint-dir", ck, "--out", os.path.join(work, "merged"),
                    "--genotypes", files["bed"], "--pheno", files["pheno"])
    check(_tsv_bytes(os.path.join(work, "merged")) == _tsv_bytes(os.path.join(work, "multivariate")),
          "CLI merge: TSVs differ from the scan's")
    row["merge"] = {"wall_s": wall, "bytes_equal_to_scan": True}
    report, wall = _gwas(work, "report", "--out", os.path.join(work, "multivariate"), "--top", "5")
    top = [ln for ln in report.splitlines() if ln.startswith("  rs")]
    check("== scan summary ==" in report and len(top) == 5, f"CLI report:\n{report}")
    row["report"] = {"wall_s": wall, "top_rows": len(top)}
    # the streamed GRM and its spectrum, against the same functions in process
    grm_out = os.path.join(work, "grm.npz")
    _, wall = _gwas(work, "grm", "--genotypes", ",".join(split), "--out", grm_out, "--loco",
                    "--spectrum", "--batch-markers", "256", "--device", DEVICE)
    want = grm.stream_grm(open_genotypes(",".join(split)), batch_markers=256, device=DEVICE)
    k = want.full()
    with np.load(grm_out) as z:
        got = {key: z[key] for key in z.files}
    # the spectrum on the CLI's own GRM: the same input to the same eigh
    s_want, u_want = grm.grm_spectrum(got["k"], device=DEVICE)
    check(sorted(got) == ["k", "loco_0", "loco_1", "loco_2", "s", "shard_boundaries", "u"],
          f"CLI grm: keys {sorted(got)}")
    grm_err = max(float(np.max(np.abs(got["k"] - k))),
                  *(float(np.max(np.abs(got[f"loco_{i}"] - want.loco(i)))) for i in range(3)))
    check(grm_err <= 1e-5, f"CLI grm: GRM off the in-process one by {grm_err}")
    s_err = float(np.max(np.abs(got["s"] - s_want)))
    check(s_err <= 1e-10 * float(s_want.max()), f"CLI grm: spectrum off by {s_err}")
    rng_got = got["u"][:, got["s"] > 1e-8 * got["s"].max()]
    rng_want = u_want[:, s_want > 1e-8 * s_want.max()]
    check(rng_got.shape == rng_want.shape, "CLI grm: ranks differ")
    proj_err = float(np.max(np.abs(rng_got @ rng_got.T - rng_want @ rng_want.T)))
    check(proj_err <= 1e-8, f"CLI grm: range projector off by {proj_err}")
    row["grm"] = {"wall_s": wall, "samples": int(k.shape[0]), "max_abs_err": grm_err,
                  "spectrum_max_abs_err": s_err, "range_projector_max_abs_err": proj_err}
    # KING kinship products on the card against the CPU (integer counts in
    # float32: exact on both)
    rel = synth.make_cohort(n_samples=400, n_markers=2000, n_traits=2, n_related_pairs=5,
                            seed=5)
    phi = kinship.king_kinship(rel.dosages.T, device=DEVICE)
    phi_cpu = kinship.king_kinship(rel.dosages.T, device="cpu")
    check(np.array_equal(phi, phi_cpu), "KING kinship differs between the card and the CPU")
    keep = kinship.greedy_unrelated(phi)
    row["kinship"] = {"samples": 400, "excluded": int((~keep).sum()), "bitwise_vs_cpu": True}
    row["serve"] = _cli_serve(work, files)
    emit(row)


def _mesh_kind() -> str:
    """The mesh's device type: the card's, or the CPU's when a rehearsal
    sets ``DEVICE = "cpu"``."""
    return "cpu" if DEVICE == "cpu" else "cuda"


def _mesh_study(job: dict):
    import numpy as np

    from repro_torch.api import Study
    from repro_torch.io import open_genotypes

    return Study.from_arrays(open_genotypes(job["genotypes"]), np.load(job["pheno"]),
                             np.load(job["cov"]), device=_mesh_kind())


def _mesh_job(mesh, rank: int, job: dict) -> dict:
    """One scan of the mesh phase on one rank: Study -> plan(mesh=) ->
    session, rank 0 feeding a TsvWriter; a digest of every cell's arrays
    (equal on every rank: each holds the gathered tiles)."""
    import hashlib

    import numpy as np
    import torch

    from repro_torch.api import GridSpec, LmmSpec, TsvWriter
    from repro_torch.runtime import sharding

    kw = {k: job[k] for k in ("engine", "mode", "multivariate", "checkpoint_dir") if k in job}
    if "lmm" in job:
        kw["lmm"] = LmmSpec(**job["lmm"])
    plan = _mesh_study(job).plan(device=_mesh_kind(), mesh=mesh, grid=GridSpec(**job["grid"]),
                                 **kw)
    t0 = time.perf_counter()
    plan.prepare()
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    session = plan.run()
    writer = TsvWriter(job["out"]) if rank == 0 and job.get("out") else None
    if writer is not None:
        writer.open(session)
    digest = hashlib.sha256()
    stop = job.get("stop_after")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    n = 0
    t0 = time.perf_counter()
    with sharding.record_collectives() as colls:
        events = session.events()
        for cell in events:
            digest.update(f"{cell.batch_index},{cell.block_index}".encode())
            for key in sorted(cell.arrays):
                digest.update(key.encode() + np.ascontiguousarray(cell.arrays[key]).tobytes())
            if writer is not None:
                writer.write(cell)
            n += 1
            if n == stop:
                break
        events.close()
    if writer is not None and stop is None:
        writer.close()
    wall = time.perf_counter() - t0
    metrics = session.metrics.summary()
    return {"prepare_s": prepare_s, "wall_s": wall, "step_s": metrics["step_s"],
            "extract_s": metrics["extract_s"], "decode_s": metrics["decode_s"],
            "cells": n, "launches": read_launches(),
            "collective_bytes_per_cell": sum(c.wire_bytes for c in colls) / max(n, 1),
            "digest": digest.hexdigest(), "executor": session.executor_info,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


def _mesh_jobs(mesh, rank: int, jobs: list, tmp: str) -> dict:
    """The mesh phase's body on one rank: each scan job in turn."""
    return {job["name"]: _mesh_job(mesh, rank, job) for job in jobs}


def _mesh_rank(rank: int, world: int, store: str, shape, jobs, tmp: str,
               body: str = "_mesh_jobs") -> None:
    """One spawned rank of a mesh phase: its own card, NCCL (initialized
    eagerly, so a failure surfaces here), the ("data", "model") mesh, then
    ``body(mesh, rank, jobs, tmp)`` (a function of this module, by name).
    Writes its result to ``tmp/mesh_rank<rank>.json``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import datetime

    torch.cuda.set_device(rank)
    # a collective that waits longer than this fails the rank (and the run)
    dist.init_process_group("nccl", init_method="file://" + store, rank=rank,
                            world_size=world, device_id=torch.device("cuda", rank),
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = init_device_mesh("cuda", tuple(shape), mesh_dim_names=("data", "model"))
        out = globals()[body](mesh, rank, jobs, tmp)
        with open(os.path.join(tmp, f"mesh_rank{rank}.json"), "w") as f:
            json.dump(out, f)
    except BaseException:
        # the other ranks may wait in a collective this rank never joins,
        # and destroy_process_group would wait with them: leave at once
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    dist.destroy_process_group()


def _spawn_world(tmp: str, shape, jobs, body: str = "_mesh_jobs") -> list:
    """Run ``body`` on a mesh of ``shape``, one spawned process per card;
    returns each rank's result (the first with the spawn's wall time)."""
    import torch.multiprocessing as mp

    world = math.prod(shape)
    store = os.path.join(tmp, f"mesh_store_{body}_{'x'.join(map(str, shape))}")
    for r in range(world):
        path = os.path.join(tmp, f"mesh_rank{r}.json")
        if os.path.exists(path):
            os.remove(path)
    t0 = time.perf_counter()
    mp.spawn(_mesh_rank, args=(world, store, list(shape), jobs, tmp, body), nprocs=world,
             join=True)
    spawn_s = time.perf_counter() - t0
    ranks = [json.load(open(os.path.join(tmp, f"mesh_rank{r}.json"))) for r in range(world)]
    ranks[0]["spawn_s"] = spawn_s
    return ranks


def _spawn_mesh(tmp: str, shape, jobs: list) -> list:
    """Run ``jobs`` on a mesh of ``shape``, one spawned process per card;
    returns each rank's results after checking that every rank's cells
    carry the same bits."""
    ranks = _spawn_world(tmp, shape, jobs)
    for job in jobs:
        digests = {ranks[r][job["name"]]["digest"] for r in range(len(ranks))}
        check(len(digests) == 1, f"mesh {shape}/{job['name']}: the ranks' cells differ")
    return ranks


def _mesh_files(tmp: str, stem: str, cohort) -> dict:
    import numpy as np

    paths = {"pheno": os.path.join(tmp, f"{stem}.pheno.npy"),
             "cov": os.path.join(tmp, f"{stem}.cov.npy")}
    np.save(paths["pheno"], cohort.phenotypes)
    np.save(paths["cov"], cohort.covariates)
    return paths


def _row(res: dict) -> dict:
    return {k: res[k] for k in ("prepare_s", "wall_s", "step_s", "extract_s", "cells",
                                "launches", "collective_bytes_per_cell",
                                "max_memory_allocated")}


def _read_hits(out: str) -> dict:
    with open(os.path.join(out, "hits.tsv")) as f:
        f.readline()
        return {(m, t): tuple(float(v) for v in rest)
                for m, t, *rest in (ln.rstrip("\n").split("\t") for ln in f)}


def _compare_tables(got: str, want: str, tol=DENSE_TOL) -> dict:
    """Two output directories of one scan at a stated tolerance: the same
    hits outside the +/-band around the threshold, hit values and per-trait
    bests within ``tol`` plus the TSV's rounding (r 5 decimals, t 4, nlp
    3), per-trait winners equal where the best is past the band, qc.tsv's
    marker, maf and valid columns equal."""
    tol_r, tol_t, tol_nlp = tol
    a, b = _read_hits(got), _read_hits(want)
    for x, y, nx in ((a, b, "mesh"), (b, a, "serial")):
        missing = [k for k, v in x.items() if v[2] >= 7.301 + HIT_BAND and k not in y]
        check(not missing, f"hits only in the {nx} tables: {missing[:5]}")
    dr = dt = dn = 0.0
    for k in set(a) & set(b):
        (r1, t1, n1), (r2, t2, n2) = a[k], b[k]
        dr, dt, dn = max(dr, abs(r1 - r2)), max(dt, abs(t1 - t2)), max(dn, abs(n1 - n2))
        check(abs(r1 - r2) <= tol_r + 1e-5, f"hit {k}: r {r1} vs {r2}")
        check(abs(t1 - t2) <= tol_t[1] + tol_t[0] * abs(t2) + 1e-4, f"hit {k}: t {t1} vs {t2}")
        check(abs(n1 - n2) <= tol_nlp[1] + tol_nlp[0] * abs(n2) + 1e-3,
              f"hit {k}: nlp {n1} vs {n2}")
    rows = {}
    for name in ("per_trait_best.tsv", "qc.tsv"):
        with open(os.path.join(got, name)) as f1, open(os.path.join(want, name)) as f2:
            rows[name] = ([ln.rstrip("\n").split("\t") for ln in f1],
                          [ln.rstrip("\n").split("\t") for ln in f2])
    best_dn = 0.0
    for (tr1, m1, n1), (tr2, m2, n2) in zip(*(r[1:] for r in rows["per_trait_best.tsv"])):
        n1, n2 = float(n1), float(n2)
        best_dn = max(best_dn, abs(n1 - n2))
        check(tr1 == tr2 and abs(n1 - n2) <= tol_nlp[1] + tol_nlp[0] * abs(n2) + 1e-3,
              f"per-trait best {tr1}: {n1} vs {n2}")
        check(n2 < 7.301 + HIT_BAND or m1 == m2, f"per-trait winner {tr1}: {m1} vs {m2}")
    qc1, qc2 = rows["qc.tsv"]
    check(len(qc1) == len(qc2) and qc1[0] == qc2[0], "qc.tsv shapes differ")
    for x, y in zip(qc1[1:], qc2[1:]):
        check(x[:3] == y[:3], f"qc.tsv row {x} vs {y}")
        for u, v in zip(x[3:], y[3:]):
            check(abs(float(u) - float(v)) <= tol_nlp[1] + tol_nlp[0] * abs(float(v)) + 1e-3,
                  f"qc.tsv omnibus {x} vs {y}")
    return {"hits": [len(a), len(b)], "common": len(set(a) & set(b)), "max_dr": dr,
            "max_dt": dt, "max_dnlp": dn, "best_max_dnlp": best_dn}


def phase_mesh_one(tmp: str, lmm_ident: dict) -> dict:
    """The full run's mesh phase: a world of one over NCCL, mesh (1, 1).
    The fused engine ``mp`` on scan's cohort writes scan's tables byte for
    byte; the lmm fused epilogue ``mp`` writes lmm_identities' serial
    tables byte for byte.  Returns the mesh path's launch counts."""
    scan_files = dict(genotypes=os.path.join(tmp, "cohort.bed"),
                      pheno=os.path.join(tmp, "cohort.pheno.npy"),
                      cov=os.path.join(tmp, "cohort.cov.npy"))
    jobs = [
        dict(name="fused_mp", engine="fused", out=os.path.join(tmp, "mesh_fused"),
             grid=dict(batch_markers=SCAN["batch_markers"], trait_block=SCAN["trait_block"]),
             **scan_files),
        # the same scan again, warm (the first pays the process's first use
        # of the dense epilogue's kernels)
        dict(name="fused_mp_again", engine="fused",
             grid=dict(batch_markers=SCAN["batch_markers"], trait_block=SCAN["trait_block"]),
             **scan_files),
        dict(name="lmm_fused_mp", engine="lmm", out=os.path.join(tmp, "mesh_lmm"),
             lmm=dict(epilogue="fused", loco=True),
             grid=dict(batch_markers=LMM_IDENT["batch_markers"],
                       trait_block=LMM_IDENT["trait_block"]),
             **lmm_ident["files"]),
    ]
    ranks = _spawn_mesh(tmp, (1, 1), jobs)
    res = ranks[0]
    check(_tsv_bytes(os.path.join(tmp, "mesh_fused")) == _tsv_bytes(os.path.join(tmp, "fused")),
          "mesh (1, 1) fused tables differ from scan's")
    check(_tsv_bytes(os.path.join(tmp, "mesh_lmm")) == _tsv_bytes(lmm_ident["out"]),
          "mesh (1, 1) lmm tables differ from lmm_identities' serial scan")
    fused, lmm = res["fused_mp"], res["lmm_fused_mp"]
    check(res["fused_mp_again"]["digest"] == fused["digest"],
          "mesh (1, 1): a repeated fused scan gave other bits")
    check(fused["launches"]["gwas_dot"] == fused["cells"],
          f"mesh fused: gwas_dot launched {fused['launches']['gwas_dot']} times "
          f"for {fused['cells']} cells")
    check(fused["launches"]["compact_survivors"] == 0, "mesh fused: the sparse epilogue ran")
    check(lmm["launches"]["tstat"] == lmm["cells"],
          f"mesh lmm: tstat launched {lmm['launches']['tstat']} times for {lmm['cells']} cells")
    check(lmm["launches"]["screen_compact"] == 0, "mesh lmm: the sparse epilogue ran")
    emit({"phase": "mesh", "world": 1, "shape": [1, 1], "backend": "nccl",
          "spawn_s": res["spawn_s"], "fused_tables_equal_scan": True,
          "lmm_tables_equal_serial": True,
          "runs": {k: _row(res[k]) for k in ("fused_mp", "fused_mp_again", "lmm_fused_mp")},
          "executor": fused["executor"]})
    return {"gwas_dot": fused["launches"]["gwas_dot"], "tstat": lmm["launches"]["tstat"]}


def _lmm_ident_cohort(tmp: str):
    from repro_torch.api import Study
    from repro_torch.io import open_genotypes, synth

    cfg = LMM_IDENT
    cohort = synth.make_structured_cohort(
        n_samples=cfg["n_samples"], n_markers=cfg["n_markers"], n_traits=cfg["n_traits"],
        n_covariates=cfg["n_covariates"], h2=0.4, n_causal=16, effect_size=0.1, seed=7,
    )
    beds = synth.write_split_plink(cohort, os.path.join(tmp, "ident"), n_shards=cfg["n_shards"])
    study = Study.from_arrays(open_genotypes(",".join(beds)), cohort.phenotypes,
                              cohort.covariates)
    return study, dict(genotypes=",".join(beds), **_mesh_files(tmp, "ident", cohort))


def phase_mesh(tmp: str) -> dict:
    """``--only mesh``: the mesh over every card against serial scans on
    ``cuda:0`` (module docstring)."""
    import torch

    from repro_torch.api import GridSpec, LmmSpec

    n = torch.cuda.device_count()
    shapes = MESH_SHAPES[4 if n >= 4 else 2 if n >= 2 else 1]
    t0 = time.perf_counter()
    study, cohort = _scan_cohort(tmp)
    scan_files = dict(genotypes=os.path.join(tmp, "cohort.bed"),
                      **_mesh_files(tmp, "cohort", cohort))
    del cohort
    lmm_study, lmm_files = _lmm_ident_cohort(tmp)
    setup_s = time.perf_counter() - t0
    grid = dict(batch_markers=SCAN["batch_markers"], trait_block=SCAN["trait_block"])
    lgrid = dict(batch_markers=LMM_IDENT["batch_markers"], trait_block=LMM_IDENT["trait_block"])
    lmm = dict(epilogue="fused", loco=True)
    runs = {  # name -> (plan kwargs, files, grid, serial reference)
        "fused_mp": (dict(engine="fused"), scan_files, grid, "fused"),
        # the same scan again: the first one pays each rank's first use of
        # its NCCL communicators and of the dense epilogue's kernels
        "fused_mp_again": (dict(engine="fused"), scan_files, grid, None),
        "dense_mp": (dict(engine="dense"), scan_files, grid, "dense"),
        "dense_sample": (dict(engine="dense", mode="sample"), scan_files, grid, "dense"),
        "dense_sample_again": (dict(engine="dense", mode="sample"), scan_files, grid, None),
        "dense_mv_mp": (dict(engine="dense", multivariate=True), scan_files,
                        dict(batch_markers=SCAN["batch_markers"]), "dense_mv"),
        "lmm_fused_mp": (dict(engine="lmm", lmm=lmm), lmm_files, lgrid, "lmm"),
    }
    serial = {}
    for name, st, kw, g in (
        ("fused", study, dict(engine="fused"), grid),
        ("dense", study, dict(engine="dense"), grid),
        ("dense_mv", study, dict(engine="dense", multivariate=True),
         dict(batch_markers=SCAN["batch_markers"])),
        ("lmm", lmm_study, dict(engine="lmm", lmm=LmmSpec(**lmm)), lgrid),
    ):
        out = os.path.join(tmp, f"serial_{name}")
        _, _, timing = _run(st, out, grid=GridSpec(**g), **kw)
        serial[name] = {"out": out, "wall_s": timing["wall_s"], "step_s": timing["step_s"],
                        "prepare_s": timing["prepare_s"]}
    del study, lmm_study
    torch.cuda.empty_cache()
    rows = {}
    for shape in shapes:
        label = "x".join(map(str, shape))
        jobs = []
        for name, (kw, files, g, _) in runs.items():
            jobs.append(dict(name=name, out=os.path.join(tmp, f"mesh_{label}_{name}"),
                             grid=g, **kw, **files))
        ck = os.path.join(tmp, f"ck_{label}")
        jobs.append(dict(name="cut", engine="fused", grid=grid, checkpoint_dir=ck,
                         stop_after=MESH_CUT_CELLS, **scan_files))
        ranks = _spawn_mesh(tmp, shape, jobs)
        res = ranks[0]
        fused = os.path.join(tmp, f"mesh_{label}_fused_mp")
        check(_tsv_bytes(fused) == _tsv_bytes(serial["fused"]["out"]),
              f"mesh {shape}: fused tables differ from the serial scan's")
        for name in ("dense_sample", "fused_mp"):
            check(res[f"{name}_again"]["digest"] == res[name]["digest"],
                  f"mesh {shape}: a repeated {name} scan gave other bits")
        compared = {}
        for name, (_, _, _, ref) in runs.items():
            if ref is not None and name != "fused_mp":
                compared[name] = _compare_tables(os.path.join(tmp, f"mesh_{label}_{name}"),
                                                 serial[ref]["out"])
        for name in ("fused_mp", "fused_mp_again", "cut"):
            check(res[name]["launches"]["gwas_dot"] == res[name]["cells"],
                  f"mesh {shape}/{name}: gwas_dot launched "
                  f"{res[name]['launches']['gwas_dot']} times for {res[name]['cells']} cells")
        check(res["lmm_fused_mp"]["launches"]["tstat"] == res["lmm_fused_mp"]["cells"],
              f"mesh {shape}: tstat not launched once per lmm cell")
        # the cut checkpoint resumes with no mesh, on cuda:0, to the same bytes
        resumed_out = os.path.join(tmp, f"resumed_{label}")
        _, _, resumed = _run(_scan_study(scan_files), resumed_out, engine="fused",
                             grid=GridSpec(**grid), checkpoint_dir=ck)
        check(resumed["replayed_cells"] == MESH_CUT_CELLS,
              f"mesh {shape}: resumed {resumed['replayed_cells']} cells from the cut")
        check(_tsv_bytes(resumed_out) == _tsv_bytes(serial["fused"]["out"]),
              f"mesh {shape}: the resumed scan's tables differ from the serial scan's")
        rows[label] = {
            "world": math.prod(shape), "spawn_s": res["spawn_s"],
            "fused_tables_equal_serial": True, "ranks_bitwise_equal": True,
            "repeats_bitwise": True, "resumed_without_mesh_equal": True,
            "vs_serial": compared,
            "runs": {name: _row(res[name]) for name in list(runs) + ["cut"]},
            "executor": res["fused_mp"]["executor"],
        }
    emit({"phase": "mesh", "cards": n, "setup_s": setup_s, "backend": "nccl",
          "serial": serial, "meshes": rows})
    return rows


# ------------------------------------------------------------ the LM wing

def _lm_config(arch: str):
    """An LM arch's full configuration (the CPU rehearsal of these phases
    swaps in ``reduced()``)."""
    from repro_torch.configs import get_config

    return get_config(arch)


def _permissive(cfg):
    """MoE capacity at n_experts, as the reference's tests: no token is
    dropped, so prefill/decode equal the forward at the same positions."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.n_experts)))


def _lm_launches(phase: str) -> dict:
    """The LM path runs none of the repo's kernels: every count is 0."""
    launches = read_launches()
    check(not any(launches.values()), f"{phase}: kernels launched on the LM path: {launches}")
    return launches


def _max_rel(got, want) -> float:
    """max |got - want| / max |want| over float32 copies."""
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def _param_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def _oracle_logits(cfg, model, batch: dict, positions: list):
    """The full-sequence forward's logits at ``positions`` only: the final
    hidden states (``train_hidden``) through the head at those positions,
    so the (B, S, V) float32 logits never exist at once."""
    import torch

    from repro_torch.models import api as M

    with torch.inference_mode():
        hidden, _ = M.train_hidden(cfg, model, batch)
        picked = hidden[:, positions]
        del hidden
        return M.apply_head(cfg, model, picked).float()


def _serve_seq(cfg, model, prompt: dict, cont, capacity: int, oracle_batch: dict) -> dict:
    """Prefill ``prompt``, then decode the tokens ``cont`` (B, n) one by one
    (teacher forced) through the serve steps; each step's logits against the
    forward over the whole sequence at the same position.  Returns the
    largest ``max |d| / max |ref|`` and the caches."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.layers import NEG_INF
    from repro_torch.train import build_decode_step, build_prefill_step

    b, n = cont.shape
    s = _prompt_len(cfg, prompt)
    shape = ShapeConfig("serve", seq_len=capacity, global_batch=b, kind="prefill")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = build_prefill_step(cfg, shape)(model, prompt)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    got = [logits]
    decode = build_decode_step(cfg, shape)
    for i in range(n):
        pos = torch.full((b,), s + i, dtype=torch.int32, device=DEVICE)
        logits, caches = decode(model, cont[:, i], pos, caches)
        got.append(logits)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    want = _oracle_logits(cfg, model, oracle_batch, list(range(s - 1, s + n)))
    v = cfg.vocab                      # the padded columns hold NEG_INF
    errs = [_max_rel(g[:, :v], want[:, i, :v]) for i, g in enumerate(got)]
    check(all(bool((g[:, v:] == NEG_INF).all()) for g in got), "the vocab pad columns are not masked")
    return {"max_rel_err": max(errs), "per_step": errs, "caches": caches,
            "prefill_s": t1 - t0, "decode_ms": 1e3 * (t2 - t1) / max(n, 1)}


def _device_profile(fn, calls: int, top: int = 0) -> dict:
    """``calls`` calls of ``fn`` under ``torch.profiler`` (CPU and CUDA
    activity): wall time, the card's kernel time (kernels of one stream do
    not overlap; NCCL's run on their own stream) and kernels per call.
    ``device_busy_share`` is kernel time over wall time; None when the
    trace holds no kernel.  With ``top``, the ``top`` kernel names by card
    time (ms per call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # NCCL also records an "nccl:<op>" range on the device timeline beside
    # its kernel: count the kernel only
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith("nccl:")]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    out = {"wall_ms": 1e3 * wall / calls, "device_ms": busy_us / 1e3 / calls,
           "kernels_per_call": len(kernels) / calls,
           "device_busy_share": busy_us / 1e6 / wall if kernels else None}
    if top:
        by_name: dict = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
        out["top_kernels_ms"] = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:top])
    return out


def _prompt_len(cfg, batch: dict) -> int:
    if cfg.family == "encdec":
        return batch["tokens"].shape[1]
    return batch["positions"].shape[-1]


def _lm_batches(cfg, b: int, s: int, n: int, seed: int):
    """A prompt of ``s`` positions (``make_batch``; vlm: half of them stub
    patches), ``n`` continuation tokens, and the whole sequence for the
    forward, all on the card."""
    import numpy as np
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.train import make_batch

    prompt = make_batch(cfg, ShapeConfig("prompt", s, b, "prefill"), 0, seed=seed)
    prompt.pop("labels")
    cont = np.random.default_rng(seed + 1).integers(0, cfg.vocab, (b, n)).astype(np.int32)
    full = dict(prompt, tokens=np.concatenate([prompt["tokens"], cont], axis=1))
    if "positions" in prompt:
        lead = prompt["positions"].shape[:-1]
        full["positions"] = np.broadcast_to(np.arange(s + n, dtype=np.int32), (*lead, s + n)).copy()
    on = lambda d: {k: torch.as_tensor(v, device=DEVICE) for k, v in d.items()}  # noqa: E731
    return on(prompt), torch.as_tensor(cont, device=DEVICE), on(full)


def phase_lm_parity() -> dict:
    """Every LM arch at ``reduced()`` in float32: the same weights on the CPU
    and the card, prefill and decode through the serve steps on both; the
    card's logits within LM_PARITY["rel"] of the CPU's, cache positions and
    MoE routing integers bitwise."""
    import copy

    import torch

    from repro_torch.configs import LM_ARCHS, get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import api as M
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.layers import LayerCache
    from repro_torch.train import build_decode_step, build_prefill_step, make_batch

    p = LM_PARITY
    reset_launches()
    rows = {}
    t_start = time.perf_counter()
    for arch in LM_ARCHS:
        cfg = _permissive(dataclasses.replace(get_config(arch).reduced(), dtype="float32"))
        gen = torch.Generator(device="cpu").manual_seed(p["seed"])
        cpu_model = M.init_model(cfg, generator=gen, device="cpu", max_positions=64)
        card_model = copy.deepcopy(cpu_model).to(DEVICE)
        shape = ShapeConfig("serve", seq_len=p["seq"] + p["steps"], global_batch=p["batch"],
                            kind="prefill")
        batch = make_batch(cfg, ShapeConfig("prompt", p["seq"], p["batch"], "prefill"), 0,
                           seed=p["seed"])
        batch.pop("labels")
        prefill, decode = build_prefill_step(cfg, shape), build_decode_step(cfg, shape)
        lc, cc = prefill(cpu_model, batch)
        lg, cg = prefill(card_model, batch)
        v = cfg.vocab
        errs = [_max_rel(lg[:, :v], lc[:, :v])]
        s = _prompt_len(cfg, batch)
        for i in range(p["steps"]):
            token = torch.argmax(lc, dim=-1).to(torch.int32)
            pos = torch.full((p["batch"],), s + i, dtype=torch.int32)
            lc, cc = decode(cpu_model, token, pos, cc)
            lg, cg = decode(card_model, token.to(DEVICE), pos.to(DEVICE), cg)
            errs.append(_max_rel(lg[:, :v], lc[:, :v]))
        caches = [c["self"] if isinstance(c, dict) and "self" in c else c for c in cc]
        caches_g = [c["self"] if isinstance(c, dict) and "self" in c else c for c in cg]
        positions_equal = all(torch.equal(a.positions, b.positions.cpu())
                              for a, b in zip(caches, caches_g) if isinstance(a, LayerCache))
        row = {"max_rel_err": max(errs), "positions_equal": positions_equal}
        if cfg.moe is not None:
            layer = next(blk for blk in cpu_model.layers if blk.moe is not None)
            h = torch.randn((p["batch"] * p["seq"], cfg.d_model), generator=gen)
            probs = torch.softmax(h @ layer.moe.router, dim=-1)
            dropping = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
            routes_equal, dropped = True, 0
            for c in (cfg, dropping):
                want, _ = moe_mod.moe_route(c, probs)
                got, _ = moe_mod.moe_route(c, probs.to(DEVICE))
                for a, b in zip(want, got):
                    routes_equal &= all(torch.equal(x, y.cpu()) for x, y in
                                        ((a.dest_e, b.dest_e), (a.dest_c, b.dest_c), (a.keep, b.keep)))
                    dropped += int((~a.keep).sum()) if c is dropping else 0
            x = h.reshape(p["batch"], p["seq"], cfg.d_model)
            with torch.inference_mode():
                out_c, _ = moe_mod.moe_layer(dropping, layer.moe, x)
                card_layer = next(blk for blk in card_model.layers if blk.moe is not None)
                out_g, _ = moe_mod.moe_layer(dropping, card_layer.moe, x.to(DEVICE))
            row.update(routes_equal=routes_equal, dropped=dropped,
                       moe_drop_max_rel_err=_max_rel(out_g, out_c))
            check(routes_equal, f"lm_parity {arch}: MoE routes differ between the CPU and the card")
            check(dropped > 0, f"lm_parity {arch}: the dropping capacity dropped no token")
            check(row["moe_drop_max_rel_err"] <= p["rel"], f"lm_parity {arch}: MoE with drops {row}")
        check(row["max_rel_err"] <= p["rel"], f"lm_parity {arch}: logits differ {row}")
        check(positions_equal, f"lm_parity {arch}: cache positions differ")
        rows[arch] = row
        del cpu_model, card_model, cc, cg
    emit({"phase": "lm_parity", "rel_bound": p["rel"], "archs": rows,
          "launches": _lm_launches("lm_parity"), "wall_s": time.perf_counter() - t_start})
    return rows


def phase_lm_serve() -> dict:
    """gemma2-9b at full width and depth on the card, served through
    ``build_prefill_step`` / ``build_decode_step``: four requests of a
    1,024-token prompt and 32 greedy decode steps (times, peak memory, the
    bounds), prefill/decode against the forward at B=2, S=256, and one
    request whose prompt overflows the 4,096-slot local rings."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import api as M
    from repro_torch.models.layers import LayerCache
    from repro_torch.models.transformer import _layer_kinds
    from repro_torch.train import build_decode_step, build_prefill_step, make_batch

    p = LM_SERVE
    cfg = _lm_config(p["arch"])
    torch.cuda.empty_cache()
    reset_launches()
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(p["seed"])
    model = M.init_model(cfg, generator=gen, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in model.parameters())
    param_bytes = _param_bytes(model)

    # (1) the requests
    b, s, cap, steps = p["batch"], p["prompt"], p["capacity"], p["steps"]
    shape = ShapeConfig("serve", seq_len=cap, global_batch=b, kind="prefill")
    batch = make_batch(cfg, ShapeConfig("prompt", s, b, "prefill"), 0, seed=p["seed"])
    batch.pop("labels")
    prefill, decode = build_prefill_step(cfg, shape), build_decode_step(cfg, shape)
    prefill_times = []
    for _ in range(2):           # the first call pays cuBLAS's start-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logits, caches = prefill(model, batch)
        torch.cuda.synchronize()
        prefill_times.append(time.perf_counter() - t0)
    step_s = []
    token = torch.argmax(logits, dim=-1).to(torch.int32)
    for i in range(steps):
        pos = torch.full((b,), s + i, dtype=torch.int32, device=DEVICE)
        t0 = time.perf_counter()
        logits, caches = decode(model, token, pos, caches)
        token = torch.argmax(logits, dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    check(bool(torch.isfinite(logits[:, : cfg.vocab]).all()), "lm_serve: non-finite decode logits")
    # where a step's time goes: the card's kernel time against the wall
    state = {"caches": caches, "token": token, "pos": s + steps}

    def one_step():
        pos = torch.full((b,), state["pos"], dtype=torch.int32, device=DEVICE)
        logits, state["caches"] = decode(model, state["token"], pos, state["caches"])
        state["token"] = torch.argmax(logits, dim=-1).to(torch.int32)
        state["pos"] += 1

    decode_profile = _device_profile(one_step, p["profile_steps"])
    caches = state["caches"]
    del state
    prefill_profile = _device_profile(lambda: prefill(model, batch), 1)
    cache_bytes = sum(c.k.numel() * c.k.element_size() + c.v.numel() * c.v.element_size()
                      for c in caches)
    del caches, logits
    # Least times: decode reads every weight once (the tied head reads the
    # whole table; the embedding gather is 4 rows) and every k/v slot of every
    # layer; prefill does 2 FLOP per weight per token outside the embedding
    # (the head runs on the last token only) plus the dense QK^T and PV over
    # all S x S pairs, in bf16 on the tensor cores.
    hd, heads = cfg.resolved_head_dim, cfg.n_heads
    embed = cfg.padded_vocab * cfg.d_model
    prefill_flops = (2.0 * b * s * (n_params - embed) + 4.0 * b * heads * s * s * hd * cfg.n_layers
                     + 2.0 * b * embed)
    decode_bound_ms, decode_bound_by = bytes_bound(param_bytes + cache_bytes, 2.0 * b * n_params,
                                                   BF16_FLOPS)
    prefill_bound_ms, prefill_bound_by = bytes_bound(param_bytes, prefill_flops, BF16_FLOPS)
    step_ms = sorted(1e3 * t for t in step_s)
    row = {
        "phase": "lm_serve", "arch": cfg.arch, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "params": n_params, "param_bytes": param_bytes, "init_s": init_s,
        "batch": b, "prompt": s, "cache_capacity": cap, "decode_steps": steps,
        "prefill_s": prefill_times[1], "prefill_first_s": prefill_times[0],
        "prefill_bound_ms": prefill_bound_ms, "prefill_bound_by": prefill_bound_by,
        "prefill_flops": prefill_flops,
        "decode_ms_median": statistics.median(step_ms),
        "decode_ms_p95": step_ms[min(len(step_ms) - 1, math.ceil(0.95 * len(step_ms)) - 1)],
        "decode_ms_first": 1e3 * step_s[0],
        "tokens_per_s": b * steps / sum(step_s),
        "decode_bound_ms": decode_bound_ms, "decode_bound_by": decode_bound_by,
        "decode_bound_bytes": param_bytes + cache_bytes, "peak_bytes": peak,
        "decode_profile": decode_profile, "prefill_profile": prefill_profile,
    }

    # (2) prefill and the first decode against the forward, B=2, S=256
    bound = p["rel_bound"]
    prompt, cont, full = _lm_batches(cfg, p["consist_batch"], p["consist_len"], 1, p["seed"])
    res = _serve_seq(cfg, model, prompt, cont, p["consist_len"] + 8, full)
    row["consistency"] = {"batch": p["consist_batch"], "prompt": p["consist_len"],
                          "max_rel_err": res["max_rel_err"], "bound": bound}
    check(res["max_rel_err"] <= bound, f"lm_serve: prefill/decode vs forward {row['consistency']}")
    del res, prompt, cont, full
    torch.cuda.empty_cache()

    # (3) one request longer than the local window: the local rings wrap
    n = p["wrap_steps"]
    prompt, cont, full = _lm_batches(cfg, 1, p["wrap_prompt"], n, p["seed"] + 7)
    res = _serve_seq(cfg, model, prompt, cont, p["wrap_prompt"] + n, full)
    rings = [c for c, kind in zip(res["caches"], _layer_kinds(cfg)) if kind == "local"]
    check(all(isinstance(c, LayerCache) and c.k.shape[1] == cfg.local_window for c in rings),
          "lm_serve: the local layers' rings do not hold local_window slots")
    oldest = min(int(c.positions.min()) for c in rings)
    last = p["wrap_prompt"] + n - 1
    check(oldest == last - cfg.local_window + 1,
          f"lm_serve: the rings hold positions from {oldest}, not the last {cfg.local_window}")
    row["wrap"] = {"prompt": p["wrap_prompt"], "local_window": cfg.local_window, "steps": n,
                   "local_layers": len(rings), "oldest_position_in_rings": oldest,
                   "max_rel_err": res["max_rel_err"], "per_step": res["per_step"], "bound": bound}
    check(res["max_rel_err"] <= bound, f"lm_serve: the wrapped request vs forward {row['wrap']}")
    row["launches"] = _lm_launches("lm_serve")
    del res, model
    torch.cuda.empty_cache()
    emit(row)
    return row


def phase_lm_families() -> dict:
    """Each LM arch at its full width, depth cut to one repeat of its
    ``block_pattern`` (whisper whole), MoE capacity permissive: prefill and
    decode against the forward, parameter bytes and times.  Each model is
    freed before the next."""
    import torch

    from repro_torch.configs import LM_ARCHS
    from repro_torch.models import api as M

    p = LM_FAMILIES
    reset_launches()
    rows = {}
    for arch in LM_ARCHS:
        cfg = _lm_config(arch)
        if cfg.family != "encdec":
            cfg = dataclasses.replace(cfg, n_layers=len(cfg.block_pattern))
        cfg = _permissive(cfg)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=DEVICE).manual_seed(p["seed"])
        t0 = time.perf_counter()
        model = M.init_model(cfg, generator=gen, device=DEVICE)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        prompt, cont, full = _lm_batches(cfg, p["batch"], p["seq"], p["steps"], p["seed"])
        res = _serve_seq(cfg, model, prompt, cont, p["seq"] + p["steps"], full)
        row = {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
               "params": sum(t.numel() for t in model.parameters()),
               "param_bytes": _param_bytes(model), "init_s": init_s,
               "prefill_s": res["prefill_s"], "decode_ms": res["decode_ms"],
               "max_rel_err": res["max_rel_err"], "peak_bytes": torch.cuda.max_memory_allocated()}
        check(row["max_rel_err"] <= p["rel_bound"], f"lm_families {arch}: {row}")
        rows[arch] = row
        del model, res, prompt, cont, full
    torch.cuda.empty_cache()
    emit({"phase": "lm_families", "batch": p["batch"], "seq": p["seq"], "steps": p["steps"],
          "rel_bound": p["rel_bound"], "archs": rows, "launches": _lm_launches("lm_families")})
    return rows


def _rel(got, want) -> float:
    """|got - want| / |want| for scalars (0 when both are 0)."""
    got, want = float(got), float(want)
    return abs(got - want) / abs(want) if want else abs(got)


def _leaf_errs(got: dict, want: dict) -> dict:
    """Per tensor: max |got - want| / max |want| (float32 copies on the CPU)."""
    return {k: _max_rel(got[k], want[k]) for k in want}


def _on(batch: dict, device) -> dict:
    import torch

    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _grads_differ(a: dict, b: dict) -> list:
    """Names of the gradients that are not bitwise equal."""
    import torch

    return sorted(k for k in a if not torch.equal(a[k], b[k]))


def phase_lm_train_parity() -> dict:
    """Every LM arch at ``reduced()`` in float32: the same weights and batch
    on the CPU and the card, one train step's loss and gradients (remat
    "none") against each other, a second identical step on the card against
    the first (bitwise or not, and which gradients differ), ``adamw_update``
    on the CPU's gradients on both devices, and remat "full"/"dots" on the
    card against "none"."""
    import copy

    import torch

    from repro_torch.configs import LM_ARCHS, get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import api as M
    from repro_torch.train import make_batch
    from repro_torch.train.optimizer import (AdamWConfig, adamw_init, adamw_update, decay_mask,
                                             global_norm)
    from repro_torch.train.train_step import TrainStepConfig, loss_and_grads

    p = LM_TRAIN_PARITY
    reset_launches()
    rows = {}
    t_start = time.perf_counter()
    for arch in LM_ARCHS:
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        gen = torch.Generator(device="cpu").manual_seed(p["seed"])
        cpu_model = M.init_model(cfg, generator=gen, device="cpu", max_positions=64)
        card_model = copy.deepcopy(cpu_model).to(DEVICE)
        batch = make_batch(cfg, ShapeConfig("t", p["seq"], p["batch"], "train"), 0, seed=p["seed"])
        cpu_b, card_b = _on(batch, "cpu"), _on(batch, DEVICE)
        tcfg = TrainStepConfig()
        lc, mc, gc = loss_and_grads(cfg, tcfg, cpu_model, cpu_b)
        lg, mg, gg = loss_and_grads(cfg, tcfg, card_model, card_b)
        lg2, _, gg2 = loss_and_grads(cfg, tcfg, card_model, card_b)
        differ = _grads_differ(gg, gg2)
        errs = _leaf_errs(gg, gc)
        worst = max(errs, key=errs.get)
        row = {"loss": float(lc), "loss_rel_err": _rel(lg, lc),
               "xent_rel_err": _rel(mg["xent"], mc["xent"]),
               "moe_aux_rel_err": _rel(mg["moe_aux"], mc["moe_aux"]),
               "grad_max_rel_err": errs[worst], "grad_worst_leaf": worst,
               "grad_norm_rel_err": _rel(global_norm(gg.values()), global_norm(gc.values())),
               "repeat_bitwise": not differ and bool(torch.equal(lg, lg2)),
               "repeat_differing_grads": differ}
        # AdamW on the CPU's gradients, on both devices (two steps)
        ocfg = AdamWConfig(lr=1e-2, warmup_steps=1)
        decay = decay_mask(cfg, cpu_model)
        states = {}
        for dev, model in (("cpu", cpu_model), (DEVICE, card_model)):
            params = {k: t.detach().clone() for k, t in model.named_parameters()}
            opt = adamw_init(ocfg, params)
            for _ in range(2):
                _, opt, _ = adamw_update(ocfg, {k: g.to(dev) for k, g in gc.items()}, opt, params,
                                         decay=decay)
            states[dev] = (params, opt)
        (pc, oc), (pg, og) = states["cpu"], states[DEVICE]
        row["adamw_max_rel_err"] = max(max(_leaf_errs(pg, pc).values()),
                                       max(_leaf_errs(og.m, oc.m).values()),
                                       max(_leaf_errs(og.v, oc.v).values()))
        for remat in ("full", "dots"):
            lr_, _, _ = loss_and_grads(cfg, TrainStepConfig(remat=remat), card_model, card_b)
            row[f"remat_{remat}_loss_rel_err"] = _rel(lr_, lg)
        grad_rel = p["ill_conditioned"].get(arch, p["grad_rel"])
        row["grad_bound"] = grad_rel
        check(max(row["loss_rel_err"], row["xent_rel_err"], row["moe_aux_rel_err"]) <= p["loss_rel"],
              f"lm_train_parity {arch}: loss {row}")
        check(row["grad_max_rel_err"] <= grad_rel, f"lm_train_parity {arch}: gradients {row}")
        check(row["grad_norm_rel_err"] <= p["ill_conditioned"].get(arch, p["loss_rel"]),
              f"lm_train_parity {arch}: grad_norm {row}")
        check(row["adamw_max_rel_err"] <= p["opt_rel"], f"lm_train_parity {arch}: adamw {row}")
        check(max(row["remat_full_loss_rel_err"], row["remat_dots_loss_rel_err"]) <= p["remat_rel"],
              f"lm_train_parity {arch}: remat {row}")
        rows[arch] = row
        del cpu_model, card_model, gc, gg, gg2, states
    emit({"phase": "lm_train_parity", "bounds": {k: v for k, v in p.items() if k != "seed"},
          "archs": rows, "launches": _lm_launches("lm_train_parity"),
          "wall_s": time.perf_counter() - t_start})
    return rows


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_lm_train_families() -> dict:
    """Each LM arch at full width, depth cut to one repeat of its
    ``block_pattern`` (whisper whole), B=2, S=64: one train step at remat
    "none" (first call, then warm) and one at "full" from the same weights;
    the losses agree, are finite, ``grad_norm`` > 0 and the parameters
    moved.  arctic-480b runs the forward and backward only (its AdamW state
    would not fit on one card).  Each model is freed before the next."""
    import torch

    from repro_torch.configs import LM_ARCHS
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import api as M
    from repro_torch.train import make_batch
    from repro_torch.train.optimizer import AdamWConfig, adamw_init, global_norm
    from repro_torch.train.train_step import TrainStepConfig, build_train_step, loss_and_grads

    p = LM_TRAIN_FAMILIES
    reset_launches()
    rows = {}
    t_start = time.perf_counter()
    for arch in LM_ARCHS:
        cfg = _lm_config(arch)
        if cfg.family != "encdec":
            cfg = dataclasses.replace(cfg, n_layers=len(cfg.block_pattern))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=DEVICE).manual_seed(p["seed"])
        model = M.init_model(cfg, generator=gen, device=DEVICE)
        batch = _on(make_batch(cfg, ShapeConfig("t", p["seq"], p["batch"], "train"), 0,
                               seed=p["seed"]), DEVICE)
        row = {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
               "params": sum(t.numel() for t in model.parameters()),
               "param_bytes": _param_bytes(model)}
        if arch in p["no_optimizer"]:
            losses, times = [], []
            for remat in ("none", "none", "full"):
                (loss, _, grads), dt = _timed(lambda: loss_and_grads(
                    cfg, TrainStepConfig(remat=remat), model, batch))
                losses.append(loss)
                times.append(dt)
                gnorm = global_norm(grads.values())
                del grads
            row.update(optimizer=False, moved=None)
        else:
            snapshot = {k: t.detach().clone() for k, t in model.named_parameters()}
            losses, times = [], []
            for remat in ("none", "none", "full"):
                with torch.no_grad():
                    for k, t in model.named_parameters():
                        t.copy_(snapshot[k])
                opt = adamw_init(AdamWConfig(), model)
                step = build_train_step(cfg, tcfg=TrainStepConfig(remat=remat))
                (_, _, metrics), dt = _timed(lambda: step(model, opt, batch))
                losses.append(metrics["loss"])
                times.append(dt)
                gnorm = metrics["grad_norm"]
                del opt
            moved = max(float((t.detach().float() - snapshot[k].float()).abs().max())
                        for k, t in model.named_parameters())
            row.update(optimizer=True, moved=moved)
            del snapshot
        row.update(loss=float(losses[0]), warm_loss_rel_err=_rel(losses[1], losses[0]),
                   full_loss_rel_err=_rel(losses[2], losses[0]), grad_norm=float(gnorm),
                   first_step_s=times[0], warm_step_s=times[1], full_step_s=times[2],
                   peak_bytes=torch.cuda.max_memory_allocated())
        check(math.isfinite(row["loss"]) and row["grad_norm"] > 0, f"lm_train_families {arch}: {row}")
        check(max(row["warm_loss_rel_err"], row["full_loss_rel_err"]) <= p["rel_bound"],
              f"lm_train_families {arch}: remat losses {row}")
        check(row["moved"] is None or row["moved"] > 0, f"lm_train_families {arch}: nothing moved")
        rows[arch] = row
        del model, batch, losses
    torch.cuda.empty_cache()
    emit({"phase": "lm_train_families", "batch": p["batch"], "seq": p["seq"],
          "rel_bound": p["rel_bound"], "archs": rows, "launches": _lm_launches("lm_train_families"),
          "wall_s": time.perf_counter() - t_start})
    return rows


def phase_lm_train() -> dict:
    """granite-moe-1b-a400m whole on the card: 8 AdamW steps of B=4, S=4,096
    (remat "dots", ``loss_chunk`` 1,024, float32 m/v) on ``make_batch``'s
    steps 0-7, a checkpoint written after step 4; step times, tokens/s, peak
    memory and the FLOP bound (``launch.roofline.model_flops``); two
    identical forward/backward passes compared bitwise; one step under
    ``torch.profiler``; one step with bfloat16 m/v (its peak); then the
    checkpoint restored into a fresh model and steps 5-7 run again, equal to
    the uninterrupted run's."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.roofline import HW, model_flops, param_count
    from repro_torch.launch.train import flatten_state, restore_state
    from repro_torch.models import api as M
    from repro_torch.runtime.checkpoint import TrainCheckpoint
    from repro_torch.train import make_batch
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.train_step import (TrainStepConfig, build_train_step, init_train_state,
                                              loss_and_grads)

    p = LM_TRAIN
    cfg = _lm_config(p["arch"])
    shape = ShapeConfig("train_4k", p["seq"], p["batch"], "train")
    tcfg = TrainStepConfig(remat=p["remat"], loss_chunk=p["loss_chunk"])
    batches = [_on(make_batch(cfg, shape, i), DEVICE) for i in range(p["steps"] + 2)]
    torch.cuda.empty_cache()
    reset_launches()
    t_start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    (model, opt), init_s = _timed(lambda: init_train_state(
        cfg, tcfg, torch.Generator(device=DEVICE).manual_seed(p["seed"]), device=DEVICE,
        max_positions=p["seq"]))
    n_params = sum(t.numel() for t in model.parameters())
    step = build_train_step(cfg, tcfg=tcfg)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        ckpt = TrainCheckpoint(tmp)
        losses, step_s, save_s = [], [], None
        for i in range(p["steps"]):
            (_, opt, metrics), dt = _timed(lambda: step(model, opt, batches[i]))
            losses.append(float(metrics["loss"]))
            step_s.append(dt)
            check(math.isfinite(losses[-1]), f"lm_train: non-finite loss at step {i}")
            if i + 1 == p["resume_at"]:
                _, save_s = _timed(lambda: ckpt.save(i + 1, flatten_state(cfg, model, opt)))
        peak = torch.cuda.max_memory_allocated()
        final = {k: t.detach().to("cpu", copy=True) for k, t in model.named_parameters()}
        # two identical forward/backward passes
        l1, _, g1 = loss_and_grads(cfg, tcfg, model, batches[p["steps"]])
        l2, _, g2 = loss_and_grads(cfg, tcfg, model, batches[p["steps"]])
        differ = _grads_differ(g1, g2)
        bitwise = not differ and bool(torch.equal(l1, l2))
        del g1, g2
        profile = _device_profile(lambda: step(model, opt, batches[p["steps"]]), 1, top=8)
        # bfloat16 m/v
        del opt
        torch.cuda.empty_cache()
        tcfg16 = dataclasses.replace(tcfg, optimizer=AdamWConfig(state_dtype="bfloat16"))
        opt16 = adamw_init(tcfg16.optimizer, model)
        step16 = build_train_step(cfg, tcfg=tcfg16)
        torch.cuda.reset_peak_memory_stats()
        (_, _, m16), bf16_step_s = _timed(lambda: step16(model, opt16, batches[p["steps"] + 1]))
        bf16_peak = torch.cuda.max_memory_allocated()
        del model, opt16
        torch.cuda.empty_cache()
        # resume: a fresh model and state from the checkpoint, steps 5-7 again
        fresh = M.init_model(cfg, generator=None, device=DEVICE, max_positions=p["seq"])
        fresh_opt = adamw_init(tcfg.optimizer, fresh)
        (start, flat), load_s = _timed(ckpt.restore)
        fresh_opt = restore_state(cfg, fresh, fresh_opt, flat)
        del flat
        check(start == p["resume_at"] and int(fresh_opt.count) == start,
              f"lm_train: resumed at {start}, count {int(fresh_opt.count)}")
        resumed = []
        for i in range(start, p["steps"]):
            _, fresh_opt, metrics = step(fresh, fresh_opt, batches[i])
            resumed.append(float(metrics["loss"]))
        param_diff = max(_max_rel(t.detach(), final[k]) for k, t in fresh.named_parameters())
        del fresh, fresh_opt, final
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    loss_diff = max(_rel(a, b) for a, b in zip(resumed, losses[start:]))
    flops = model_flops(cfg, shape)
    hw = HW()
    bound_ms = 1e3 * flops / hw.peak_flops
    warm = sorted(1e3 * t for t in step_s[1:])
    median_ms = statistics.median(warm)
    row = {
        "phase": "lm_train", "arch": cfg.arch, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "params": n_params, "param_count": param_count(cfg), "batch": p["batch"], "seq": p["seq"],
        "tokens_per_step": p["batch"] * p["seq"], "remat": p["remat"], "loss_chunk": p["loss_chunk"],
        "init_s": init_s, "losses": losses, "first_step_s": step_s[0],
        "step_ms_median": median_ms,
        "step_ms_p95": warm[min(len(warm) - 1, math.ceil(0.95 * len(warm)) - 1)],
        "tokens_per_s": p["batch"] * p["seq"] / (median_ms / 1e3),
        "peak_bytes": peak, "model_flops": flops, "bound_ms": bound_ms,
        "bound_by": "operations (bf16 at 989 TFLOP/s)", "share_of_bound": bound_ms / median_ms,
        "checkpoint_save_s": save_s, "checkpoint_load_s": load_s,
        "repeat_bitwise": bitwise, "repeat_differing_grads": differ,
        "profile": profile, "bf16_state_step_s": bf16_step_s, "bf16_state_peak_bytes": bf16_peak,
        "bf16_state_loss": float(m16["loss"]),
        "resumed_from": start, "resumed_losses": resumed, "resumed_loss_max_rel_err": loss_diff,
        "resumed_param_max_rel_err": param_diff,
    }
    if bitwise:
        check(loss_diff == 0.0 and param_diff == 0.0, f"lm_train: resumed run differs {row}")
    else:   # the parity tolerance on the loss; parameters within two bf16 steps of a leaf's max
        check(loss_diff <= LM_TRAIN_PARITY["loss_rel"] and param_diff <= 2.0 ** -7,
              f"lm_train: resumed run differs {row}")
    check(math.isfinite(row["bf16_state_loss"]), f"lm_train: bf16 state step {row}")
    row["launches"] = _lm_launches("lm_train")
    row["wall_s"] = time.perf_counter() - t_start
    emit(row)
    return row


def _one_repeat(cfg):
    """Full width, depth cut to one repeat of the block pattern."""
    return dataclasses.replace(cfg, n_layers=len(cfg.block_pattern))


def _lm_mesh_one_rank(mesh, rank: int, p: dict, tmp: str) -> dict:
    """lm_mesh_one on its one rank: the same weights (each drawn from the
    seeded generator on the card) through one train step with and without
    the (1, 1) mesh, compared bit for bit (metrics, parameters, m and v);
    then one step of ``launch/train.py --reduced --mesh pod``."""
    import contextlib
    import io

    import torch

    import repro_torch.launch.train as port_train
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.runtime import sharding as sh
    from repro_torch.train import make_batch
    from repro_torch.train.train_step import TrainStepConfig, build_train_step, init_train_state

    dev = sh.local_device(mesh)
    cfg = _one_repeat(_lm_config(p["arch"]))
    tcfg = TrainStepConfig(remat=p["remat"], loss_chunk=p["loss_chunk"])
    batch = make_batch(cfg, ShapeConfig("t", p["seq"], p["batch"], "train"), 0, seed=p["seed"])
    reset_launches()
    runs, out = {}, {"n_layers": cfg.n_layers, "d_model": cfg.d_model, "dtype": cfg.dtype}
    for label, m in (("none", None), ("mesh", mesh)):
        torch.cuda.reset_peak_memory_stats()
        model, opt = init_train_state(cfg, tcfg, torch.Generator(device=dev).manual_seed(p["seed"]),
                                      device=dev, max_positions=p["seq"], mesh=m)
        step = build_train_step(cfg, tcfg=tcfg, mesh=m)
        (_, opt, metrics), dt = _timed(lambda: step(model, opt, batch))
        runs[label] = (model, opt, metrics)
        out[label] = {"step_s": dt, "peak_bytes": torch.cuda.max_memory_allocated(),
                      **{k: float(v) for k, v in metrics.items()}}
    (m0, o0, x0), (m1, o1, x1) = runs["none"], runs["mesh"]
    p0, p1 = dict(m0.named_parameters()), dict(m1.named_parameters())
    out["differing"] = sorted(
        [f"metric {k}" for k in x0 if not torch.equal(x0[k], x1[k])]
        + [f"{part} {k}" for part, a, b in (("param", p0, p1), ("m", o0.m, o1.m), ("v", o0.v, o1.v))
           for k in a if not torch.equal(a[k], b[k])])
    del runs, m0, m1, o0, o1, p0, p1
    torch.cuda.empty_cache()
    out["granite_ulp"] = _ulp_moved(dev)
    torch.cuda.empty_cache()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        port_train.main(["--arch", p["arch"], "--reduced", "--steps", "1", "--log-every", "1",
                         "--mesh", "pod", "--device", dev.type])
    out["train_cli"] = buf.getvalue().splitlines()
    out["launches"] = read_launches()
    return out


def _ulp_moved(dev) -> dict:
    """The conditioning of lm_mesh's granite parity cell on one card, with
    no mesh: granite-moe-1b-a400m whole in float32 (LM_MESH's seed, batch
    and sequence), its gradients before and after every weight moves by one
    float32 ulp (up or down at random), as
    ``tests/test_torch_train_parity.py`` probes rwkv6-3b.  The worst
    leaf's max |g1 - g0| / max |g0|, and the routers' worst."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import api as M
    from repro_torch.train import make_batch
    from repro_torch.train.train_step import TrainStepConfig, loss_and_grads

    p = LM_MESH
    cfg = dataclasses.replace(_lm_config(p["moe_arch"]), dtype="float32")
    shape = ShapeConfig("t", p["moe_seq"], p["moe_batch"], "train")
    batch = _on(make_batch(cfg, shape, 0, seed=p["seed"]), dev)
    model = M.init_model(cfg, generator=torch.Generator(device=dev).manual_seed(p["seed"]),
                         device=dev)
    _, _, g0 = loss_and_grads(cfg, TrainStepConfig(), model, batch)
    gen = torch.Generator(device=dev).manual_seed(7)
    with torch.no_grad():
        for w in model.parameters():
            up = torch.rand(w.shape, generator=gen, device=dev) < 0.5
            w.copy_(torch.nextafter(w, torch.where(up, torch.inf, -torch.inf).to(w.dtype)))
    _, _, g1 = loss_and_grads(cfg, TrainStepConfig(), model, batch)
    moved = {k: float((g1[k] - g0[k]).abs().max()) / max(float(g0[k].abs().max()), 1e-30)
             for k in g0}
    worst = max(moved, key=moved.get)
    return {"arch": p["moe_arch"], "batch": p["moe_batch"], "seq": p["moe_seq"],
            "moved_max_rel": moved[worst], "worst_leaf": worst,
            "router_moved_max_rel": max(v for k, v in moved.items() if k.endswith("moe.router"))}


def phase_lm_mesh_one() -> dict:
    """The default run's LM mesh phase: a world of one over NCCL, mesh
    (1, 1).  gemma2-9b at full width, one repeat of its pattern, B=2,
    S=256: the mesh train step bitwise equal to the mesh=None one (the
    gather and the gradient reduce are identities), and one step of
    ``launch/train.py --mesh pod``; no kernel of the repo launched.  Also
    ``_ulp_moved``: how far lm_mesh's granite gradients move under a
    one-ulp change of the weights."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_lm_mesh_")
    try:
        res = _spawn_world(tmp, (1, 1), LM_MESH_ONE, body="_lm_mesh_one_rank")[0]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(not res["differing"], f"lm_mesh_one: mesh (1, 1) differs from mesh=None: "
          f"{res['differing'][:8]}")
    cli = res["train_cli"]
    check(cli[0] == "mesh data=1xmodel=1" and cli[-1] == "done." and len(cli) == 3,
          f"lm_mesh_one: launch/train.py --mesh pod printed {cli}")
    check(not any(res["launches"].values()), f"lm_mesh_one: kernels launched: {res['launches']}")
    emit({"phase": "lm_mesh_one", "world": 1, "shape": [1, 1], "backend": "nccl",
          "arch": LM_MESH_ONE["arch"], "batch": LM_MESH_ONE["batch"], "seq": LM_MESH_ONE["seq"],
          "bitwise_equal_mesh_none": True, **res})
    return res


def _counting_drops():
    """Wraps the MoE router so each call's dropped slots are counted;
    returns the running list of counts."""
    import repro_torch.models.moe as moe_mod

    counts: list = []
    route = moe_mod.moe_route

    def counted(*args, **kwargs):
        routes, frac = route(*args, **kwargs)
        counts.append(sum(int((~r.keep).sum()) for r in routes))
        return routes, frac

    moe_mod.moe_route = counted
    return counts


def _held_grads(cfg, tcfg, model, batch, mesh, want: dict | None) -> dict:
    """The mesh step's loss and gradients on this rank's blocks; each
    gradient gathered (one leaf at a time) and held on rank 0 against
    ``want`` = (loss, grad_norm, gradients) of the mesh=None step."""
    import torch.distributed as dist

    from repro_torch.runtime import sharding as sh
    from repro_torch.train.optimizer import global_norm_on_mesh
    from repro_torch.train.train_step import loss_and_grads, param_specs

    specs = param_specs(cfg, mesh)
    (loss, metrics, grads), dt = _timed(lambda: loss_and_grads(cfg, tcfg, model, batch, mesh=mesh))
    gnorm = global_norm_on_mesh(grads, mesh, specs)
    errs = {}
    for name, g in grads.items():
        full = sh.gather_full(g, mesh, specs[name])
        if want is not None:
            ref = want[2][name]
            errs[name] = (float((full.float() - ref.float()).abs().max())
                          / max(float(ref.float().abs().max()), 1e-30))
        del full
    out = {"step_s": dt, "loss": float(loss), "grad_norm": float(gnorm),
           "moe_aux": float(metrics["moe_aux"])}
    if want is not None:
        worst = max(errs, key=errs.get)
        out.update(loss_rel_err=_rel(loss, want[0]), grad_norm_rel_err=_rel(gnorm, want[1]),
                   grad_max_rel_err=errs[worst], grad_worst_leaf=worst)
    dist.barrier()
    return out


def _lm_mesh_rank(mesh, rank: int, p: dict, tmp: str) -> dict:
    """lm_mesh on one of 4 ranks (module docstring: parts (a) and (b)).
    (b)'s ``rest_bytes`` is the training state alone (allocated after its
    init less before it); ``peak_bytes`` is the card's peak over (b)."""
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import describe, make_mesh
    from repro_torch.launch.roofline import HW, model_flops
    from repro_torch.launch.train import restore_state, state_items
    from repro_torch.models import api as M
    from repro_torch.models import moe as moe_mod
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime.checkpoint import TrainCheckpoint
    from repro_torch.train import make_batch
    from repro_torch.train.optimizer import adamw_init, global_norm
    from repro_torch.train.train_step import (TrainStepConfig, build_train_step, init_train_state,
                                              loss_and_grads, mesh_scope)

    dev = sh.local_device(mesh)
    meshes = {"x".join(map(str, s)): make_mesh(s, ("data", "model")) for s in p["shapes"]}
    gen = lambda: torch.Generator(device=dev).manual_seed(p["seed"])  # noqa: E731
    reset_launches()
    out = {"rank": rank, "meshes": {k: describe(m) for k, m in meshes.items()}}

    def unsharded(cfg, tcfg, batch):
        """Rank 0: the mesh=None step on cuda:0 from the same weights."""
        if rank != 0:
            return None
        model = M.init_model(cfg, generator=gen(), device=dev)
        loss, _, grads = loss_and_grads(cfg, tcfg, model, _on(batch, dev))
        want = (loss, global_norm(grads.values()), grads)
        del model
        return want

    # (a) gemma2-9b, one repeat, float32, on (2, 2) and (4, 1)
    cfg = dataclasses.replace(_one_repeat(_lm_config(p["arch"])), dtype="float32")
    tcfg = TrainStepConfig()
    batch = make_batch(cfg, ShapeConfig("t", p["seq"], p["batch"], "train"), 0, seed=p["seed"])
    want = unsharded(cfg, tcfg, batch)
    out["gemma2"] = {}
    for label, m in meshes.items():
        model = init_train_state(cfg, tcfg, gen(), device=dev, mesh=m)[0]
        out["gemma2"][label] = _held_grads(cfg, tcfg, model, batch, m, want)
        del model
    del want
    torch.cuda.empty_cache()

    # (a) granite-moe-1b-a400m whole, float32, on (1, 4) and (2, 2); the
    # model on (2, 2) goes on to the checks and steps below
    m22 = meshes["2x2"]
    cfg = dataclasses.replace(_lm_config(p["moe_arch"]), dtype="float32")
    shape = ShapeConfig("t", p["moe_seq"], p["moe_batch"], "train")
    batches = [make_batch(cfg, shape, i, seed=p["seed"]) for i in range(p["resume_to"])]
    drops = _counting_drops()
    want = unsharded(cfg, tcfg, batches[0])
    out["moe_dropped_unsharded"] = sum(drops)
    out["granite"] = {}
    for s in p["moe_shapes"]:
        label = "x".join(map(str, s))
        model = opt = None
        gc.collect()
        torch.cuda.empty_cache()
        drops.clear()
        model, opt = init_train_state(cfg, tcfg, gen(), device=dev, mesh=meshes[label])
        out["granite"][label] = {**_held_grads(cfg, tcfg, model, batches[0], meshes[label], want),
                                 "dropped_rank": sum(drops)}
    del want
    cfg_e = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    logits = {}
    for impl in ("manual", "gspmd"):
        c = dataclasses.replace(cfg_e, moe_impl=impl)
        with torch.no_grad(), mesh_scope(c, model, batches[0], m22) as rows:
            logits[impl] = M.train_logits(c, model, rows)[0]
    out["manual_vs_gspmd_max_abs"] = float((logits["manual"] - logits["gspmd"]).abs().max())
    del logits
    # four AdamW steps on (2, 2), a checkpoint after step 2 (rank 0 writes it)
    step = build_train_step(cfg, tcfg=tcfg, mesh=m22)
    ck = TrainCheckpoint(os.path.join(tmp, "lm_mesh_ckpt"))
    losses = []
    for i in range(p["resume_to"]):
        model, opt, metrics = step(model, opt, batches[i])
        losses.append(float(metrics["loss"]))
        if i + 1 == p["cut_at"]:   # streamed to disk one key at a time
            items = state_items(cfg, model, opt, mesh=m22)
            if rank == 0:
                ck.save(i + 1, items)
            else:
                for _ in items:
                    pass
    out["mesh_losses"] = losses
    del model, opt
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:   # resumed on one card, no mesh
        fresh = M.init_model(cfg, generator=None, device=dev)
        fresh_opt = adamw_init(tcfg.optimizer, fresh)
        with ck.open() as (start, flat):   # read one key at a time
            fresh_opt = restore_state(cfg, fresh, fresh_opt, flat)
        one = build_train_step(cfg, tcfg=tcfg)
        resumed = []
        for i in range(start, p["resume_to"]):
            fresh, fresh_opt, metrics = one(fresh, fresh_opt, batches[i])
            resumed.append(float(metrics["loss"]))
        out["resumed_from"], out["resumed_losses"] = start, resumed
        del fresh, fresh_opt
    torch.cuda.empty_cache()
    dist.barrier()

    # (a) the GSPMD MoE's cost on a data axis: granite-moe-1b-a400m whole,
    # bfloat16, on (4, 1), where each rank runs the experts over the whole
    # batch's (E, C) buffer; the manual MoE routes each rank's rows alone;
    # "none" is the same global batch on rank 0's card with no mesh.
    m41 = meshes["4x1"]
    c = p["moe_cost"]
    cfg = _lm_config(p["moe_arch"])
    shape = ShapeConfig("t", c["seq"], c["batch"], "train")
    tcfg = TrainStepConfig(remat=c["remat"], loss_chunk=c["loss_chunk"])
    batches = [make_batch(cfg, shape, i, seed=p["seed"]) for i in range(c["steps"])]
    tokens = c["batch"] * c["seq"]
    rank_tokens = tokens // sh.axis_size(m41, "data")
    moe = cfg.moe
    rows = {"gspmd": moe.n_experts * moe_mod._capacity(cfg, tokens),   # the (E, C) buffer
            "manual": moe.n_experts * max(4, int(moe.capacity_factor * rank_tokens * moe.top_k
                                                 / moe.n_experts) + 4),
            "none": moe.n_experts * moe_mod._capacity(cfg, tokens)}
    out["moe_cost"] = {}
    for impl in ("gspmd", "manual", "none"):
        m = None if impl == "none" else m41
        if m is None and rank != 0:
            dist.barrier()
            continue
        ci = dataclasses.replace(cfg, moe_impl="gspmd" if m is None else impl)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model, opt = init_train_state(ci, tcfg, gen(), device=dev, max_positions=c["seq"], mesh=m)
        step = build_train_step(ci, tcfg=tcfg, mesh=m)
        times, losses = [], []
        for b in batches:
            (model, opt, metrics), dt = _timed(lambda: step(model, opt, b))
            times.append(1e3 * dt)
            losses.append(float(metrics["loss"]))
        out["moe_cost"][impl] = {"step_ms": times, "step_ms_median": statistics.median(times[1:]),
                                 "peak_bytes": torch.cuda.max_memory_allocated(),
                                 "losses": losses, "expert_rows_per_rank": rows[impl]}
        del model, opt, step
        if m is None:
            dist.barrier()
    torch.cuda.empty_cache()

    # (b) gemma2-9b whole, bfloat16, on each of (4, 1), (2, 2), (1, 4)
    w = p["whole"]
    cfg = _lm_config(p["arch"])
    shape = ShapeConfig("train_4k", w["seq"], w["batch"], "train")
    tcfg = TrainStepConfig(n_microbatches=w["n_microbatches"], remat=w["remat"],
                           loss_chunk=w["loss_chunk"])
    batches = [make_batch(cfg, shape, i) for i in range(w["steps"] + 1)]
    flops = model_flops(cfg, shape)
    out["whole"] = {}
    for s in w["shapes"]:
        label = "x".join(map(str, s))
        m = meshes[label]
        axis_of = {tuple(dist.get_process_group_ranks(m.get_group(a))): a
                   for a in ("data", "model")}
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (model, opt), init_s = _timed(lambda: init_train_state(cfg, tcfg, gen(), device=dev,
                                                              max_positions=w["seq"], mesh=m))
        rest = torch.cuda.memory_allocated() - base
        step = build_train_step(cfg, tcfg=tcfg, mesh=m)
        losses, step_s, received, by_kind = [], [], [], {}
        for i in range(w["steps"]):
            with sh.record_collectives() as colls:
                (model, opt, metrics), dt = _timed(lambda: step(model, opt, batches[i]))
            losses.append(float(metrics["loss"]))
            step_s.append(dt)
            received.append(sum(c.wire_bytes for c in colls))
            kinds: dict = {}
            for c in colls:
                key = f"{c.kind} {axis_of.get(c.ranks, 'other')}"
                kinds[key] = kinds.get(key, 0.0) + c.wire_bytes
            by_kind = kinds
        peak = torch.cuda.max_memory_allocated()
        profile = _device_profile(lambda: step(model, opt, batches[-1]), 1, top=10)
        l1, _, g1 = loss_and_grads(cfg, tcfg, model, batches[-1], mesh=m)
        l2, _, g2 = loss_and_grads(cfg, tcfg, model, batches[-1], mesh=m)
        differ = _grads_differ(g1, g2) + ([] if torch.equal(l1, l2) else ["loss"])
        del g1, g2, model, opt, step
        torch.cuda.empty_cache()
        warm = sorted(1e3 * t for t in step_s[1:])
        row = {
            "n_layers": cfg.n_layers, "d_model": cfg.d_model, "mesh": describe(m),
            "batch": w["batch"], "seq": w["seq"], "n_microbatches": w["n_microbatches"],
            "remat": w["remat"], "loss_chunk": w["loss_chunk"], "init_s": init_s,
            "losses": losses, "step_s": step_s, "base_bytes": base, "rest_bytes": rest,
            "peak_bytes": peak, "received_bytes_per_step": received,
            "received_bytes_by_kind": by_kind, "model_flops": flops,
            "bound_ms": 1e3 * flops / (sh.axis_size(m, ("data", "model")) * HW().peak_flops),
            "repeat_differing": differ, "profile": profile,
        }
        if warm:
            row["step_ms_median"] = statistics.median(warm)
            row["step_ms_p95"] = warm[min(len(warm) - 1, math.ceil(0.95 * len(warm)) - 1)]
        out["whole"][label] = row
        dist.barrier()
    out["launches"] = read_launches()
    return out


def phase_lm_mesh() -> dict:
    """``--only build,lm_mesh`` on 4 cards: LM training on a mesh, one
    process per card over NCCL (module docstring).  Fewer cards: an error.
    The phase's row is printed before the checks of its traces, so a cell
    that misses its trace shows by how much."""
    import torch

    n = torch.cuda.device_count()
    check(n >= 4, f"lm_mesh needs 4 cards, found {n}")
    p = LM_MESH
    w = p["whole"]
    labels = {"x".join(map(str, s)): s for s in w["shapes"]}
    predictions = _Predictions({label: dict(
        arch=p["arch"], cfg=_lm_config(p["arch"]), mesh=s,
        shape=("train_4k", w["seq"], w["batch"], "train"),
        tcfg=dict(n_microbatches=w["n_microbatches"], remat=w["remat"],
                  loss_chunk=w["loss_chunk"])) for label, s in labels.items()})
    tmp = tempfile.mkdtemp(prefix="chip_smoke_lm_mesh_")
    try:
        ranks = _spawn_world(tmp, (2, 2), p, body="_lm_mesh_rank")
        predicted = predictions.result()
    finally:
        predictions.close()
        shutil.rmtree(tmp, ignore_errors=True)
    r0 = ranks[0]
    parity = lambda r: {**{f"gemma2 {k}": v for k, v in r["gemma2"].items()},  # noqa: E731
                        **{f"granite {k}": v for k, v in r["granite"].items()}}
    for label, row in parity(r0).items():
        check(row["loss_rel_err"] <= p["loss_rel"] and row["grad_norm_rel_err"] <= p["loss_rel"]
              and row["grad_max_rel_err"] <= p["grad_rel"], f"lm_mesh parity {label}: {row}")
        for r in ranks[1:]:
            other = parity(r)[label]
            check(other["loss"] == row["loss"] and other["grad_norm"] == row["grad_norm"],
                  f"lm_mesh parity {label}: rank {r['rank']}'s metrics differ")
    check(r0["manual_vs_gspmd_max_abs"] < p["manual_bound"],
          f"lm_mesh: manual vs GSPMD logits {r0['manual_vs_gspmd_max_abs']}")
    resumed_err = max(_rel(a, b) for a, b in
                      zip(r0["resumed_losses"], r0["mesh_losses"][r0["resumed_from"]:]))
    check(r0["resumed_from"] == p["cut_at"] and resumed_err <= p["loss_rel"],
          f"lm_mesh: the resumed run's losses {r0['resumed_losses']} vs {r0['mesh_losses']}")
    cost = r0["moe_cost"]
    check(all(math.isfinite(x) for run in cost.values() for x in run["losses"]),
          f"lm_mesh: granite losses {cost}")
    for r in ranks:
        check(not any(r["launches"].values()), f"lm_mesh: kernels launched {r['launches']}")
    tokens = w["batch"] * w["seq"]
    first = r0["whole"]["4x1"]["losses"][0]
    wholes, misses = {}, []
    for label in labels:
        whole = r0["whole"][label]
        peaks = [r["whole"][label]["peak_bytes"] for r in ranks]
        check(all(math.isfinite(x) for x in whole["losses"]),
              f"lm_mesh {label}: losses {whole['losses']}")
        check(max(peaks) < 80e9, f"lm_mesh {label}: per-rank peaks {peaks}")
        check(not whole["repeat_differing"],
              f"lm_mesh {label}: a repeated pass differs: {whole['repeat_differing'][:4]}")
        check(_rel(whole["losses"][0], first) <= w["first_loss_rel"],
              f"lm_mesh {label}: first loss {whole['losses'][0]} vs (4, 1)'s {first}")
        step_bytes = set(whole["received_bytes_per_step"])
        check(len(step_bytes) == 1, f"lm_mesh {label}: steps moved different bytes {step_bytes}")
        try:
            dry_run = _held(f"lm_mesh whole {label}",
                            {"argument_bytes": whole["rest_bytes"],
                             "peak_bytes": whole["peak_bytes"] - whole["base_bytes"],
                             "collective_bytes": step_bytes.pop()}, predicted[label])
        except RuntimeError as e:
            misses.append(str(e))
            dry_run = {"miss": str(e), "predicted": predicted[label]}
        row = {**whole, "peak_bytes_per_rank": peaks,
               "rest_bytes_per_rank": [r["whole"][label]["rest_bytes"] for r in ranks],
               "received_bytes_per_step_per_rank": [r["whole"][label]["received_bytes_per_step"]
                                                    for r in ranks],
               "tokens_per_step": tokens, "first_loss_rel_err_vs_4x1": _rel(whole["losses"][0],
                                                                           first),
               "dry_run": dry_run}
        if "step_ms_median" in whole:
            row["tokens_per_s"] = tokens / (whole["step_ms_median"] / 1e3)
            row["share_of_bound"] = whole["bound_ms"] / whole["step_ms_median"]
        wholes[label] = row
    row = {"phase": "lm_mesh", "cards": n, "backend": "nccl", "meshes": r0["meshes"],
           "gemma2_parity": r0["gemma2"], "granite_parity": r0["granite"],
           "moe_dropped": {"unsharded": r0["moe_dropped_unsharded"],
                           "mesh_per_rank": {k: [r["granite"][k]["dropped_rank"] for r in ranks]
                                             for k in r0["granite"]}},
           "manual_vs_gspmd_max_abs": r0["manual_vs_gspmd_max_abs"],
           "checkpoint": {"cut_at": p["cut_at"], "mesh_losses": r0["mesh_losses"],
                          "resumed_losses": r0["resumed_losses"], "max_rel_err": resumed_err},
           "moe_cost": {**cost, **{f"{impl}_peak_bytes_per_rank":
                                   [r["moe_cost"][impl]["peak_bytes"] for r in ranks]
                                   for impl in ("gspmd", "manual")},
                        "batch": p["moe_cost"]["batch"], "seq": p["moe_cost"]["seq"],
                        "gspmd_loss_rel_err_vs_none": max(
                            _rel(a, b) for a, b in zip(cost["gspmd"]["losses"],
                                                       cost["none"]["losses"]))},
           "whole": wholes, "launches": [r["launches"] for r in ranks],
           "spawn_s": r0["spawn_s"]}
    emit(row)
    check(not misses, f"lm_mesh: cells missed their traces: {misses}")
    return row


# ------------------------------------------------- LM serving on a mesh


def _serve_on(cfg, model, mesh, prompt: dict, cont, capacity: int):
    """Prefill ``prompt``, then decode the tokens ``cont`` (B, n) one by one
    (teacher forced) through the serve steps on ``mesh`` (None: without a
    mesh) -> (every step's logits, the caches)."""
    import numpy as np

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.train import build_decode_step, build_prefill_step

    b, n = cont.shape
    s = _prompt_len(cfg, prompt)
    shape = ShapeConfig("serve", seq_len=capacity, global_batch=b, kind="prefill")
    logits, caches = build_prefill_step(cfg, shape, mesh=mesh)(model, prompt)
    out = [logits]
    decode = build_decode_step(cfg, shape, mesh=mesh)
    for i in range(n):
        logits, caches = decode(model, cont[:, i], np.full((b,), s + i, np.int32), caches)
        out.append(logits)
    return out, caches


def _cache_tensors(caches) -> list:
    """Every tensor of a cache structure, in order (None fields skipped)."""
    import torch

    if caches is None:
        return []
    if isinstance(caches, torch.Tensor):
        return [caches]
    if isinstance(caches, dict):
        return [t for k in sorted(caches) for t in _cache_tensors(caches[k])]
    return [t for c in caches for t in _cache_tensors(c)]


def _serve_inputs(cfg, b: int, s: int, n: int, seed: int):
    """A ``make_batch`` prompt of ``s`` positions and ``n`` continuation
    tokens (host arrays)."""
    import numpy as np

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.train import make_batch

    prompt = make_batch(cfg, ShapeConfig("prompt", s, b, "prefill"), 0, seed=seed)
    prompt.pop("labels")
    cont = np.random.default_rng(seed + 1).integers(0, cfg.vocab, (b, n)).astype(np.int32)
    return prompt, cont


def _lm_serve_mesh_one_rank(mesh, rank: int, p: dict, tmp: str) -> dict:
    """lm_serve_mesh_one on its one rank: the same weights (drawn from the
    seeded generator on the card) served with and without the (1, 1) mesh,
    compared bit for bit (every step's logits, every cache tensor)."""
    import torch

    from repro_torch.models import api as M
    from repro_torch.runtime import sharding as sh
    from repro_torch.train.train_step import param_specs, to_blocks

    dev = sh.local_device(mesh)
    cfg = _one_repeat(_lm_config(p["arch"]))
    prompt, cont = _serve_inputs(cfg, p["batch"], p["prompt"], p["steps"], p["seed"])
    model = M.init_model(cfg, generator=torch.Generator(device=dev).manual_seed(p["seed"]),
                         device=dev)
    (want, want_caches), none_s = _timed(lambda: _serve_on(cfg, model, None, prompt, cont,
                                                           p["capacity"]))
    to_blocks(model, mesh, param_specs(cfg, mesh))
    reset_launches()
    (got, got_caches), mesh_s = _timed(lambda: _serve_on(cfg, model, mesh, prompt, cont,
                                                         p["capacity"]))
    launches = read_launches()
    a, b = _cache_tensors(want_caches), _cache_tensors(got_caches)
    differ = ([f"logits {i}" for i, (x, y) in enumerate(zip(got, want)) if not torch.equal(x, y)]
              + [f"cache tensor {i}" for i, (x, y) in enumerate(zip(b, a))
                 if not torch.equal(x, y)])
    if len(a) != len(b):
        differ.append(f"{len(b)} cache tensors, not {len(a)}")
    return {"n_layers": cfg.n_layers, "d_model": cfg.d_model, "dtype": cfg.dtype,
            "cache_tensors": len(a), "serve_s": {"none": none_s, "mesh": mesh_s},
            "finite": bool(all(torch.isfinite(x).all() for x in got)),
            "differing": differ, "launches": launches}


def phase_lm_serve_mesh_one() -> dict:
    """The default run's LM serve mesh phase: a world of one over NCCL, mesh
    (1, 1).  gemma2-9b at full width, one repeat of its pattern: prefill and
    8 decode steps through the serve steps' mesh arms bitwise equal to
    mesh=None; no kernel of the repo launched."""
    p = LM_SERVE_MESH_ONE
    tmp = tempfile.mkdtemp(prefix="chip_smoke_lm_serve_mesh_")
    try:
        res = _spawn_world(tmp, (1, 1), p, body="_lm_serve_mesh_one_rank")[0]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(res["finite"], "lm_serve_mesh_one: non-finite logits")
    check(not res["differing"], f"lm_serve_mesh_one: mesh (1, 1) differs from mesh=None: "
          f"{res['differing'][:8]}")
    check(not any(res["launches"].values()),
          f"lm_serve_mesh_one: kernels launched: {res['launches']}")
    emit({"phase": "lm_serve_mesh_one", "world": 1, "shape": [1, 1], "backend": "nccl",
          "arch": p["arch"], "batch": p["batch"], "prompt": p["prompt"],
          "capacity": p["capacity"], "steps": p["steps"], "bitwise_equal_mesh_none": True,
          **res})
    return res


def _greedy(logits, mesh):
    """Each row's argmax over the vocab, whose columns are split over
    "model" when the logits are a block: the ranks' (max, index) pairs
    gathered, the first of the largest taken (as ``argmax``)."""
    import torch

    from repro_torch.runtime import sharding as sh

    n = logits.shape[1]
    first = sh.axis_index(mesh, "model") * n
    vals, idx = logits.max(dim=-1)
    pairs = sh.axis_rows(torch.stack([vals, (idx + first).float()], dim=-1), mesh, "model")
    best = torch.argmax(pairs[..., 0], dim=0)                         # (B,)
    return pairs[best, torch.arange(pairs.shape[1], device=best.device), 1].to(torch.int32)


def _reduced_config(label: str):
    """The float32 ``reduced()`` config of an arch or of an ``LM_VARIANTS``
    label."""
    arch, changes = LM_VARIANTS.get(label, (label, {}))
    return dataclasses.replace(_lm_config(arch).reduced(), dtype="float32", **changes)


@contextlib.contextmanager
def _in_float32(model):
    """``model``'s parameters in float32 for the duration, and back to their
    own dtypes after (bfloat16 -> float32 -> bfloat16 is exact), each cast
    on the host with its card copy freed first: arctic's layer is 28 GB in
    bfloat16 and 56 GB in float32, and a card holding one 8.9 GB expert
    weight in both dtypes at once peaked at 65 GB, which a rank beside its
    NCCL buffers does not have."""
    import torch

    def cast(p, dtype):
        host, dev = p.data.cpu(), p.device
        p.data = torch.empty(0, dtype=dtype, device=dev)
        p.data = host.to(dtype).to(dev)

    dtypes = {n: p.dtype for n, p in model.named_parameters()}
    for p in model.parameters():
        cast(p, torch.float32)
    try:
        yield model
    finally:
        for n, p in model.named_parameters():
            cast(p, dtypes[n])


@contextlib.contextmanager
def _recorded_routes():
    """Inside, each call of the MoE router appends to the yielded list each
    token's experts, one column a round (T, top_k), -1 where dropped."""
    import torch

    import repro_torch.models.moe as moe_mod

    log: list = []
    route = moe_mod.moe_route

    def recorded(*args, **kwargs):
        routes, frac = route(*args, **kwargs)
        log.append(torch.stack([torch.where(r.keep, r.dest_e, -1) for r in routes], -1).cpu())
        return routes, frac

    moe_mod.moe_route = recorded
    try:
        yield log
    finally:
        moe_mod.moe_route = route


def _same_routes(logs: list, b: int, s: int, steps: int) -> tuple[list, "torch.Tensor"]:
    """Which rows of the prefill (B rows of ``s`` tokens) and of each of
    ``steps`` decode steps every run of ``logs`` (each a
    ``_recorded_routes`` list) computed with the same experts: (for each
    call, the rows (B,) bool whose output saw the same experts; the rows
    whose caches did, after the last call).  A MoE layer below the last
    feeds the caches of the layers above it, so a token's flip there marks
    its row for every later call; the last MoE layer feeds only the row's
    output at that call, through its last token.  A row whose experts
    differ computes another function: a flip of a near tie, which rounding
    decides, not an error of the split."""
    import torch

    per = len(logs[0]) // (1 + steps)
    cached = torch.ones(b, dtype=torch.bool)
    rows = []
    for call in range(1 + steps):
        n = s if call == 0 else 1
        out = cached.clone()
        for layer in range(per):
            first = logs[0][call * per + layer].view(b, n, -1)
            for other in logs[1:]:
                same = other[call * per + layer].view(b, n, -1) == first
                if layer == per - 1:
                    out &= same[:, -1].all(-1)
                else:
                    cached &= same.flatten(1).all(1)
                    out &= cached
        rows.append(out)
    return rows, cached


def _rows_rel(got, want, rows) -> float:
    """max |got - want| over the rows ``rows`` of the batch dim (dim 0) /
    max |want| over every row."""
    got, want = got.float().cpu(), want.float().cpu()
    scale = max(float(want.abs().max()), 1e-30)
    return float((got[rows] - want[rows]).abs().max()) / scale if rows.any() else 0.0


def _whole_logits(logits: list, cfg, m, batch: int) -> list:
    """Each step's logits whole, from this rank's block of the serve steps'
    logits layout (the vocab on "model" only where it divides)."""
    from repro_torch.runtime import sharding as sh
    from repro_torch.train import partition

    spec = partition.divisible_sharding(m, sh.P(sh.batch_axes(m), "model"),
                                        (batch, cfg.vocab)).spec
    return [sh.gather_full(x, m, spec) for x in logits]


def _serve_whole(m, w: dict, seed: int) -> dict:
    """One (b) cell on this rank: ``w['arch']`` whole in bfloat16 on mesh
    ``m``, weights drawn a parameter at a time; a prefill of ``w['batch']``
    prompts of ``w['prompt']`` tokens, then ``w['steps'] - 1`` greedy decode
    steps: times, memory and collective bytes of this rank."""
    import gc
    import hashlib

    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import describe
    from repro_torch.launch.roofline import HW, model_flops
    from repro_torch.models import convert
    from repro_torch.runtime import sharding as sh
    from repro_torch.train import build_decode_step, build_prefill_step
    from repro_torch.train.train_step import param_specs

    dev = sh.local_device(m)
    cfg = _lm_config(w["arch"])
    prompt, _ = _serve_inputs(cfg, w["batch"], w["prompt"], 1, seed)
    shape = ShapeConfig("serve", seq_len=w["capacity"], global_batch=w["batch"], kind="prefill")
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model, init_s = _timed(lambda: convert.init_blocks(cfg, seed, mesh=m,
                                                          specs=param_specs(cfg, m)))
    weights = torch.cuda.memory_allocated() - base
    init_peak = torch.cuda.max_memory_allocated() - base
    prefill, decode = build_prefill_step(cfg, shape, mesh=m), build_decode_step(cfg, shape, mesh=m)
    with sh.record_collectives() as colls:
        (logits, caches), prefill_s = _timed(lambda: prefill(model, prompt))
    prefill_bytes = sum(c.wire_bytes for c in colls)
    cache_bytes = sum(t.numel() * t.element_size() for t in _cache_tensors(caches))
    finite = bool(torch.isfinite(logits).all())
    token = _greedy(logits, m)
    tokens = [token]
    step_s, step_bytes = [], []
    for i in range(w["steps"] - 1):
        pos = torch.full((w["batch"],), w["prompt"] + i, dtype=torch.int32, device=dev)
        with sh.record_collectives() as colls:
            (logits, caches), dt = _timed(lambda: decode(model, token, pos, caches))
        step_bytes.append(sum(c.wire_bytes for c in colls))
        step_s.append(dt)
        finite = finite and bool(torch.isfinite(logits).all())
        token = _greedy(logits, m)
        tokens.append(token)
    pos = torch.full((w["batch"],), w["prompt"] + w["steps"] - 1, dtype=torch.int32, device=dev)
    profile = _device_profile(lambda: decode(model, token, pos, caches), 1, top=8)
    peak = torch.cuda.max_memory_allocated() - base
    finite = finite and all(bool(torch.isfinite(t.float()).all())
                            for t in _cache_tensors(caches) if t.is_floating_point())
    del caches, logits
    torch.cuda.empty_cache()
    prefill_profile = _device_profile(lambda: prefill(model, prompt), 1, top=8)
    del model
    torch.cuda.empty_cache()
    warm = sorted(1e3 * t for t in step_s[1:])
    flops = model_flops(cfg, ShapeConfig("prefill", w["prompt"], w["batch"], "prefill"))
    world = sh.axis_size(m, ("data", "model"))
    row = {
        "arch": w["arch"], "n_layers": cfg.n_layers, "d_model": cfg.d_model, "dtype": cfg.dtype,
        "mesh": describe(m), "batch": w["batch"], "prompt": w["prompt"],
        "capacity": w["capacity"], "decode_steps": w["steps"], "init_s": init_s,
        "weights_bytes": weights, "cache_bytes": cache_bytes, "init_peak_bytes": init_peak,
        "peak_bytes": peak, "prefill_s": prefill_s,
        "prefill_bound_s": flops / (world * HW().peak_flops), "prefill_flops": flops,
        "prefill_collective_bytes": prefill_bytes, "decode_step_ms": [1e3 * t for t in step_s],
        "decode_step_ms_median": statistics.median(warm),
        "decode_step_ms_p95": warm[min(len(warm) - 1, math.ceil(0.95 * len(warm)) - 1)],
        "decode_bound_ms": 1e3 * (weights + cache_bytes) / HBM_BYTES_S,
        "decode_collective_bytes_per_step": statistics.median(step_bytes),
        "decode_collective_bytes_set": sorted(set(step_bytes)),
        "decode_profile": profile, "prefill_profile": prefill_profile, "finite": finite,
        "tokens_digest": hashlib.sha256(torch.stack(tokens).cpu().numpy().tobytes()).hexdigest(),
    }
    row["decode_tokens_per_s"] = w["batch"] / (row["decode_step_ms_median"] / 1e3)
    return row


def _lm_serve_mesh_rank(mesh, rank: int, p: dict, tmp: str) -> dict:
    """lm_serve_mesh on one of 4 ranks (module docstring: parts (a) and
    (b))."""
    import hashlib

    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import describe, make_mesh
    from repro_torch.models import api as M
    from repro_torch.models import convert
    from repro_torch.runtime import sharding as sh
    from repro_torch.train.serve_step import cache_specs
    from repro_torch.train.train_step import param_specs, to_blocks

    dev = sh.local_device(mesh)
    meshes = {"x".join(map(str, s)): make_mesh(s, ("data", "model")) for s in p["shapes"]}
    reset_launches()
    out = {"rank": rank, "meshes": {k: describe(m) for k, m in meshes.items()}, "parity": {}}

    # (a) reduced(), float32, against mesh=None on cuda:0
    for arch in p["archs"]:
        cfg = _reduced_config(arch)
        prompt, cont = _serve_inputs(cfg, p["batch"], p["prompt"], p["steps"], p["seed"])
        make = lambda: M.init_model(cfg, generator=torch.Generator(device=dev).manual_seed(  # noqa: E731
            p["seed"]), device=dev, max_positions=64)
        want = _serve_on(cfg, make(), None, prompt, cont, p["capacity"]) if rank == 0 else None
        shape = ShapeConfig("serve", seq_len=p["capacity"], global_batch=p["batch"],
                            kind="prefill")
        for label, m in meshes.items():
            model = to_blocks(make(), m, param_specs(cfg, m))
            logits, caches = _serve_on(cfg, model, m, prompt, cont, p["capacity"])
            logits = _whole_logits(logits, cfg, m, p["batch"])
            whole = _cache_tensors(convert.caches_from_blocks(caches, cache_specs(cfg, shape, m), m))
            digest = hashlib.sha256()
            for t in logits + whole:
                digest.update(t.cpu().contiguous().view(torch.uint8).numpy().tobytes())
            row = {"digest": digest.hexdigest()}
            if want is not None:
                ref = _cache_tensors(want[1])
                row["logits_max_rel_err"] = max(_max_rel(g, w) for g, w in zip(logits, want[0]))
                row["caches_max_rel_err"] = max(
                    (_max_rel(g, w) for g, w in zip(whole, ref) if w.dtype != torch.int32),
                    default=0.0)
                row["positions_equal"] = len(whole) == len(ref) and all(
                    torch.equal(g, w) for g, w in zip(whole, ref) if w.dtype == torch.int32)
            out["parity"][f"{arch} {label}"] = row
            del model, caches, whole
        del want
    torch.cuda.empty_cache()

    # (a) at full width, one repeat of the pattern, bfloat16, on (1, 4): the
    # split paths at the published head counts, widths and vocab, against
    # mesh=None on cuda:0 from the same weights.  Bound: the mesh's error
    # against the same weights in float32 at most ``factor`` times mesh=None's
    # own bfloat16 error (a wrong split is off by the size of the values).
    f = p["full"]
    m = meshes["x".join(map(str, f["shape"]))]
    for arch in f["archs"]:
        cfg = _one_repeat(_lm_config(arch))
        prompt, cont = _serve_inputs(cfg, f["batch"], f["prompt"], f["steps"], p["seed"])
        shape = ShapeConfig("serve", seq_len=f["capacity"], global_batch=f["batch"],
                            kind="prefill")
        model = M.init_model(cfg, generator=torch.Generator(device=dev).manual_seed(p["seed"]),
                             device=dev)
        if rank == 0:
            with _recorded_routes() as plain_routes:
                plain = _serve_on(cfg, model, None, prompt, cont, f["capacity"])
            with _in_float32(model), _recorded_routes() as exact_routes:
                exact = _serve_on(dataclasses.replace(cfg, dtype="float32"), model, None, prompt,
                                  cont, f["capacity"])
        to_blocks(model, m, param_specs(cfg, m))
        with _recorded_routes() as mesh_routes:
            logits, caches = _serve_on(cfg, model, m, prompt, cont, f["capacity"])
        logits = _whole_logits(logits, cfg, m, f["batch"])
        whole = _cache_tensors(convert.caches_from_blocks(caches, cache_specs(cfg, shape, m), m))
        del model, caches
        if rank == 0:
            ref = _cache_tensors(exact[1])
            # rows compared: those whose experts all three runs chose alike;
            # the logits' vocab columns only (the pad columns are -inf)
            rows, cached = _same_routes([exact_routes, plain_routes, mesh_routes], f["batch"],
                                        f["prompt"], f["steps"])
            v = cfg.vocab

            def errs(got_logits, got_caches):
                return (max(_rows_rel(g[:, :v], w[:, :v], r)
                            for g, w, r in zip(got_logits, exact[0], rows)),
                        max(_rows_rel(g, w, cached) for g, w in zip(got_caches, ref)
                            if w.dtype != torch.int32))

            mesh_err, plain_err = errs(logits, whole), errs(plain[0], _cache_tensors(plain[1]))
            out["parity"][f"{arch} full bf16 {'x'.join(map(str, f['shape']))}"] = {
                "n_layers": cfg.n_layers, "d_model": cfg.d_model, "n_heads": cfg.n_heads,
                "n_kv_heads": cfg.n_kv_heads, "padded_vocab": cfg.padded_vocab,
                "logits_max_rel_err": mesh_err[0], "caches_max_rel_err": mesh_err[1],
                "plain_logits_max_rel_err": plain_err[0],
                "plain_caches_max_rel_err": plain_err[1], "factor": f["factor"],
                "rows_compared": [int(r.sum()) for r in rows],
                "within": (mesh_err[0] <= f["factor"] * plain_err[0]
                           and mesh_err[1] <= f["factor"] * plain_err[1]
                           and 2 * sum(int(r.sum()) for r in rows) >= f["batch"] * len(rows)
                           and 2 * int(cached.sum()) >= f["batch"]),
                "positions_equal": len(whole) == len(ref) and all(
                    torch.equal(g, w) for g, w in zip(whole, ref) if w.dtype == torch.int32)}
            del exact, plain
        del logits, whole
        torch.cuda.empty_cache()
    dist.barrier()

    # (b) served whole, bfloat16, on (1, 4)
    w = p["whole"]
    m = meshes["x".join(map(str, w["shape"]))]
    out["whole"] = {c["arch"]: _serve_whole(m, c, p["seed"]) for c in w["cells"]}
    out["launches"] = read_launches()
    return out


def _check_lm_serve_mesh(p: dict, ranks: list, predicted: dict) -> dict:
    """lm_serve_mesh's checks (module docstring) on every rank's results;
    returns each (b) cell's row with its dry run beside it."""
    r0 = ranks[0]
    w = p["whole"]
    for label, row in r0["parity"].items():
        if "factor" in row:       # full width, bfloat16
            check(row["within"] and row["positions_equal"], f"lm_serve_mesh parity {label}: {row}")
            continue
        check(row["logits_max_rel_err"] <= p["rel"] and row["caches_max_rel_err"] <= p["rel"]
              and row["positions_equal"], f"lm_serve_mesh parity {label}: {row}")
        check(all(r["parity"][label]["digest"] == row["digest"] for r in ranks),
              f"lm_serve_mesh parity {label}: the ranks' gathered results differ")
    for r in ranks:
        check(not any(r["launches"].values()), f"lm_serve_mesh: kernels launched {r['launches']}")
    served = {}
    for c in w["cells"]:
        arch = c["arch"]
        whole = [r["whole"][arch] for r in ranks]
        check(all(x["finite"] for x in whole), f"lm_serve_mesh {arch}: non-finite logits or caches")
        check(len({x["tokens_digest"] for x in whole}) == 1,
              f"lm_serve_mesh {arch}: the ranks' greedy tokens differ")
        peaks = [x["peak_bytes"] for x in whole]
        check(max(peaks) < w["peak_limit"], f"lm_serve_mesh {arch}: per-rank peaks {peaks}")
        w0 = whole[0]
        pf, dc = predicted[(arch, "prefill")], predicted[(arch, "decode")]
        check(len(w0["decode_collective_bytes_set"]) == 1,
              f"lm_serve_mesh {arch}: decode steps moved different bytes "
              f"{w0['decode_collective_bytes_set']}")
        row = {**w0, **{f"{k}_per_rank": [x[k] for x in whole] for k in
                        ("weights_bytes", "cache_bytes", "init_peak_bytes", "peak_bytes",
                         "prefill_s", "decode_step_ms_median", "prefill_collective_bytes",
                         "decode_collective_bytes_per_step")}}
        row["dry_run"] = {
            "rest_and_peak": _held(f"lm_serve_mesh {arch} whole",
                                   {"argument_bytes": w0["weights_bytes"] + w0["cache_bytes"],
                                    "peak_bytes": w0["peak_bytes"]},
                                   {"argument_bytes": dc["argument_bytes"],
                                    "peak_bytes": max(pf["peak_bytes"], dc["peak_bytes"])}),
            "prefill": _held(f"lm_serve_mesh {arch} prefill",
                             {"collective_bytes": w0["prefill_collective_bytes"]}, pf),
            "decode": _held(f"lm_serve_mesh {arch} decode",
                            {"collective_bytes": w0["decode_collective_bytes_set"][0]}, dc)}
        row["prefill_share_of_bound"] = w0["prefill_bound_s"] / w0["prefill_s"]
        row["decode_share_of_bound"] = w0["decode_bound_ms"] / w0["decode_step_ms_median"]
        served[arch] = row
    return served


def phase_lm_serve_mesh() -> dict:
    """``--only build,lm_serve_mesh`` on 4 cards: the LM serve steps on a
    mesh, one process per card over NCCL (module docstring).  Fewer cards:
    an error."""
    import torch

    n = torch.cuda.device_count()
    check(n >= 4, f"lm_serve_mesh needs 4 cards, found {n}")
    p = LM_SERVE_MESH
    w = p["whole"]
    cells = {}
    for c in w["cells"]:
        cell = dict(arch=c["arch"], cfg=_lm_config(c["arch"]), mesh=w["shape"])
        cells[(c["arch"], "prefill")] = dict(cell, prompt=c["prompt"], shape=(
            "serve", c["capacity"], c["batch"], "prefill"))
        cells[(c["arch"], "decode")] = dict(cell, shape=("serve", c["capacity"], c["batch"],
                                                         "decode"))
    predictions = _Predictions(cells)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_lm_serve_mesh_")
    try:
        ranks = _spawn_world(tmp, (2, 2), p, body="_lm_serve_mesh_rank")
        predicted = predictions.result()
    finally:
        predictions.close()
        shutil.rmtree(tmp, ignore_errors=True)
    r0 = ranks[0]
    try:
        served = _check_lm_serve_mesh(p, ranks, predicted)
    except Exception:
        # the numbers of a failed check, for its diagnosis
        emit({"phase": "lm_serve_mesh", "failed": True, "parity": r0["parity"],
              "whole": {a: {k: v for k, v in x.items() if "profile" not in k}
                        for a, x in r0["whole"].items()},
              "predicted": {" ".join(k): v for k, v in predicted.items()}})
        raise
    row = {"phase": "lm_serve_mesh", "cards": n, "backend": "nccl", "meshes": r0["meshes"],
           "parity": {k: {kk: vv for kk, vv in v.items() if kk != "digest"}
                      for k, v in r0["parity"].items()},
           "whole": served, "launches": [r["launches"] for r in ranks], "spawn_s": r0["spawn_s"]}
    emit(row)
    return row


# ------------------------------------------------------------ dry run


def _predict(cell: dict) -> dict:
    """Rank 0's trace of one cell on a fake world of the cell's mesh shape
    (``launch.dryrun``): the card's path, under ``FakeTensorMode``.  Runs in
    a child process: the fake world, like any world, is one per process."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import fake_world, make_mesh
    from repro_torch.launch.roofline import HW
    from repro_torch.train.train_step import TrainStepConfig

    torch.set_num_threads(1)
    shape = tuple(cell["mesh"])
    world = math.prod(shape)
    with fake_world(world, device=D.trace_device(cell["arch"])):
        mesh = make_mesh(shape, ("data", "model"))
        if cell["arch"] == "gwas_ukb":
            trace = D.trace_gwas_cell(cell["engine"], mesh, g=cell["g"])
        else:
            tcfg = TrainStepConfig(**cell["tcfg"]) if "tcfg" in cell else None
            trace, _ = D.trace_lm_cell(cell["arch"], ShapeConfig(*cell["shape"]), mesh,
                                       cfg=cell["cfg"], tcfg=tcfg, prompt=cell.get("prompt"))
    peak = cell.get("peak_flops", HW().peak_flops)
    return {"argument_bytes": trace.memory["argument_bytes"],
            "peak_bytes": trace.memory["peak_bytes"], "flops": trace.flops,
            "compute_s": trace.flops / peak, "peak_flops": peak,
            "collective_bytes": sum(c.wire_bytes for c in trace.collectives),
            "n_collectives": len(trace.collectives), "kernel_calls": trace.kernel_calls,
            "trace_s": trace.seconds}


class _Predictions:
    """``_predict`` of each named cell, in spawned child processes started
    at once (a core each; the card's measurements go on meanwhile)."""

    def __init__(self, cells: dict):
        import multiprocessing

        self._pool = multiprocessing.get_context("spawn").Pool(len(cells))
        self._jobs = {k: self._pool.apply_async(_predict, (c,)) for k, c in cells.items()}

    def result(self, timeout: float = 900) -> dict:
        try:
            return {k: job.get(timeout) for k, job in self._jobs.items()}
        finally:
            self.close()

    def close(self) -> None:
        self._pool.terminate()
        self._pool.join()


def _held(label: str, measured: dict, predicted: dict) -> dict:
    """The trace's numbers beside the card's, and the checks of the dry
    run: argument (rest) bytes within 1%, peak bytes within 10%, collective
    bytes and gwas_dot launches exact (for the keys ``measured`` has)."""
    tol = DRYRUN["tol"]
    row = {"measured": measured, "predicted": predicted}
    for key in ("argument_bytes", "peak_bytes"):
        if key not in measured:
            continue
        row[f"{key}_rel_err"] = (predicted[key] - measured[key]) / measured[key]
        check(abs(row[f"{key}_rel_err"]) <= tol[key],
              f"dryrun {label}: {key} predicted {predicted[key]} vs {measured[key]} on the card")
    if "collective_bytes" in measured:
        check(predicted["collective_bytes"] == measured["collective_bytes"],
              f"dryrun {label}: collective bytes predicted {predicted['collective_bytes']} vs "
              f"{measured['collective_bytes']} on the card")
    if "gwas_dot_launches" in measured:
        check(predicted["kernel_calls"].get("gwas_dot", 0) == measured["gwas_dot_launches"],
              f"dryrun {label}: gwas_dot calls {predicted['kernel_calls']} vs "
              f"{measured['gwas_dot_launches']} launches on the card")
    return row


def _measure_fused(g) -> dict:
    """One real ``build_fused_step`` batch step of the workload ``g`` on the
    card, inputs resident there (the serial scan's staging): the inputs'
    bytes, the step's peak above them, its time, launches and FLOPs (a
    second call under ``FlopCounterMode``)."""
    import gc

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.core.association import AssocOptions
    from repro_torch.core.engines import build_fused_step

    m, n, p = g.batch_markers, g.n_samples, g.n_traits
    n_pad = -(-n // g.block_n) * g.block_n
    gen = torch.Generator(device=DEVICE).manual_seed(DRYRUN["seed"])
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    args = (torch.randint(0, 256, (m, n_pad // 4), dtype=torch.uint8, device=DEVICE,
                          generator=gen),
            torch.rand((m, 1), device=DEVICE, generator=gen),
            torch.rand((m, 1), device=DEVICE, generator=gen) + 0.5,
            torch.ones((m,), dtype=torch.bool, device=DEVICE),
            torch.randn((n, p), device=DEVICE, generator=gen))
    rest = torch.cuda.memory_allocated() - base
    step = build_fused_step(n_samples=n, n_covariates=g.n_covariates,
                            options=AssocOptions(precision="fp32"), block_m=g.block_m,
                            block_n=g.block_n, block_p=min(g.block_p, p // 16))
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out, step_s = _timed(lambda: step(*args))
    peak = torch.cuda.max_memory_allocated() - base
    launches = read_launches()["gwas_dot"]
    finite = bool(torch.isfinite(out["r"]).all())
    del out
    with FlopCounterMode(display=False) as flop:
        flop_out = step(*args)
    del flop_out, args
    torch.cuda.empty_cache()
    return {"argument_bytes": rest, "peak_bytes": peak, "gwas_dot_launches": launches,
            "flops": flop.get_total_flops(), "step_s": step_s, "r_finite": finite}


def _measure_lm(cfg, shape, tcfg, prompt: int | None) -> dict:
    """One real step of an LM cell on the card with no mesh, weights drawn
    a parameter at a time (``init_blocks``), AdamW state for training: the
    rest bytes (weights and state) and the step's peak above the bytes
    allocated before them."""
    import gc

    import torch

    from repro_torch.models import api as M
    from repro_torch.models import convert
    from repro_torch.train import build_prefill_step, make_batch
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.train_step import build_train_step

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    model = convert.init_blocks(cfg, DRYRUN["seed"], device=DEVICE)
    fed = dataclasses.replace(shape, seq_len=prompt or shape.seq_len)
    batch = make_batch(cfg, fed, 0, seed=DRYRUN["seed"])
    batch = {k: v for k, v in batch.items() if k in M.input_specs(cfg, fed)}
    if shape.kind == "train":
        model.requires_grad_(True)
        opt = adamw_init(tcfg.optimizer, model)
        step = build_train_step(cfg, tcfg=tcfg)
        run = lambda: step(model, opt, batch)  # noqa: E731
    else:
        step = build_prefill_step(cfg, shape)
        run = lambda: step(model, batch)  # noqa: E731
    torch.cuda.synchronize()
    rest = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    out, step_s = _timed(run)
    peak = torch.cuda.max_memory_allocated() - base
    del out, run, step, model, batch
    if shape.kind == "train":
        del opt
    gc.collect()
    torch.cuda.empty_cache()
    return {"argument_bytes": rest, "peak_bytes": peak, "step_s": step_s}


def _dryrun_cli(tmp: str) -> dict:
    """``python -m repro_torch.launch.dryrun`` on one cell of the pod mesh
    and ``python -m repro_torch.launch.report`` on its record, as a user
    runs them: exit codes, the record's numbers, the report's text."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    out_dir = os.path.join(tmp, "dryrun")
    arch, shape = DRYRUN["cli"]
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                          "--shape", shape, "--mesh", "pod", "--out-dir", out_dir],
                         env=env, capture_output=True, text=True, timeout=900)
    cli_s = time.perf_counter() - t0
    check(run.returncode == 0, f"dryrun CLI failed:\n{run.stderr[-3000:]}")
    with open(os.path.join(out_dir, f"{arch}__{shape}__pod.json")) as f:
        record = json.load(f)
    check(record["status"] == "ok", f"dryrun CLI record: {record}")
    report = subprocess.run([sys.executable, "-m", "repro_torch.launch.report", "--dir", out_dir],
                            env=env, capture_output=True, text=True, timeout=300)
    check(report.returncode == 0 and f"| {arch} | {shape} | 16x16 | ok |" in report.stdout,
          f"report CLI failed:\n{report.stdout[-2000:]}{report.stderr[-2000:]}")
    keep = ("mesh", "traced_on", "lower_s", "memory", "flops_per_device_exact",
            "collective_wire_bytes", "collectives_by_kind", "compute_s", "memory_floor_s",
            "collective_s", "dominant", "useful_flops_ratio", "fits_hbm", "hbm_util")
    return {"arch": arch, "shape": shape, "mesh_kind": "pod", "dryrun_s": cli_s,
            "record": {k: record[k] for k in keep}, "report": report.stdout}


def phase_dryrun(tmp: str) -> dict:
    """The dry run against the card (module docstring): (a) the paper's
    fused cell, (b) the lm_serve and lm_train cells, each traced on a fake
    world of one beside its measurement; (c) the dry-run and report CLIs."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.roofline import HW
    from repro_torch.train.train_step import TrainStepConfig

    p = DRYRUN
    g = _gwas_config()
    serve, train = p["lm_serve"], p["lm_train"]
    cells = {
        "fused": dict(arch="gwas_ukb", engine="fused", g=g, mesh=(1, 1),
                      peak_flops=HW().peak_flops_tf32 / 3),
        "lm_serve": dict(arch=serve["arch"], cfg=_lm_config(serve["arch"]), mesh=(1, 1),
                         shape=("lm_serve", serve["capacity"], serve["batch"], "prefill"),
                         prompt=serve["prompt"]),
        "lm_train": dict(arch=train["arch"], cfg=_lm_config(train["arch"]), mesh=(1, 1),
                         shape=("lm_train", train["seq"], train["batch"], "train"),
                         tcfg=dict(remat=train["remat"], loss_chunk=train["loss_chunk"])),
    }
    from concurrent.futures import ThreadPoolExecutor

    predictions = _Predictions(cells)
    try:
        with ThreadPoolExecutor(max_workers=1) as pool:
            cli_job = pool.submit(_dryrun_cli, tmp)
            measured = {"fused": _measure_fused(g)}
            for name in ("lm_serve", "lm_train"):
                c = cells[name]
                tcfg = TrainStepConfig(**c["tcfg"]) if "tcfg" in c else None
                measured[name] = _measure_lm(c["cfg"], ShapeConfig(*c["shape"]), tcfg,
                                             c.get("prompt"))
            predicted = predictions.result()
            cli = cli_job.result()
    finally:
        predictions.close()
    check(measured["fused"]["r_finite"], "dryrun: the fused step's r is not finite")
    rows = {name: _held(name, measured[name], predicted[name]) for name in cells}
    rows["fused"]["flops_rel_err"] = (predicted["fused"]["flops"] - measured["fused"]["flops"]) / \
        measured["fused"]["flops"]
    check(predicted["fused"]["flops"] == measured["fused"]["flops"],
          f"dryrun fused: FLOPs {predicted['fused']['flops']} vs {measured['fused']['flops']}")
    rows["fused"]["step_s_over_compute_s"] = measured["fused"]["step_s"] / \
        predicted["fused"]["compute_s"]
    row = {"phase": "dryrun", "workload": {"n_samples": g.n_samples, "n_traits": g.n_traits,
                                           "batch_markers": g.batch_markers},
           "cells": rows, "cli": cli, "tolerances": p["tol"]}
    emit(row)
    return row


def _gwas_config():
    """The paper's workload (``configs/gwas_ukb.py``; the CPU rehearsal
    swaps in ``reduced()``)."""
    from repro_torch.configs import get_config

    return get_config("gwas_ukb")


def _scan_study(files: dict):
    import numpy as np

    from repro_torch.api import Study
    from repro_torch.io import PlinkBed

    return Study.from_arrays(PlinkBed(files["genotypes"]), np.load(files["pheno"]),
                             np.load(files["cov"]))


def _in_tmp(phase):
    def run():
        tmp = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            return phase(tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return run


QUICK_PHASES = {"build": phase_build, "kernel": phase_kernel, "kernel_tstat": phase_kernel_tstat,
                "kernel_refine": phase_kernel_refine,
                "devices": _in_tmp(phase_devices), "mesh": _in_tmp(phase_mesh),
                "lm_parity": phase_lm_parity, "lm_serve": phase_lm_serve,
                "lm_families": phase_lm_families, "lm_train_parity": phase_lm_train_parity,
                "lm_train_families": phase_lm_train_families, "lm_train": phase_lm_train,
                "lm_mesh_one": phase_lm_mesh_one, "lm_mesh": phase_lm_mesh,
                "lm_serve_mesh_one": phase_lm_serve_mesh_one, "lm_serve_mesh": phase_lm_serve_mesh,
                "dryrun": _in_tmp(phase_dryrun)}


def main(argv: list[str]) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", help="comma-separated phases among "
                        f"{', '.join(QUICK_PHASES)}; skips the rest")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.runtime.device import resolve_device

    t_start = time.perf_counter()
    resolve_device(DEVICE)
    info, smi = phase_device()
    if args.only:
        names = args.only.split(",")
        unknown = sorted(set(names) - set(QUICK_PHASES))
        check(not unknown, f"--only takes {sorted(QUICK_PHASES)}, not {unknown}")
        for name in names:
            QUICK_PHASES[name]()
        emit({"phase": "done", "only": names, "total_s": time.perf_counter() - t_start})
        return 0
    phase_build()
    main_row, dense_kernel_rows = phase_kernel()
    tstat_rows = phase_kernel_tstat()
    refine_row = phase_kernel_refine()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        study, cohort, fused, timing = phase_scan(tmp)
        dense, dense_timing = phase_cross(tmp, study, fused)
        multivariate = phase_multivariate(tmp, study, cohort)
        phase_identities(tmp, cohort)
        phase_executor(tmp, study, fused, dense, multivariate)
        phase_multihost(tmp, study, cohort)
        phase_serve(tmp, study)
        del study, cohort, fused, dense, multivariate
        lmm_timing = phase_lmm_scan(tmp)
        torch.cuda.empty_cache()
        audit_launches, lmm_ident = phase_lmm_identities(tmp)
        torch.cuda.empty_cache()
        phase_mesh_one(tmp, lmm_ident)
        phase_cli(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_lm_parity()
    phase_lm_serve()
    phase_lm_families()
    phase_lm_train_parity()
    phase_lm_train_families()
    phase_lm_train()
    phase_lm_mesh_one()
    phase_lm_serve_mesh_one()
    _in_tmp(phase_dryrun)()
    kernels = [{
        "name": "gwas_dot",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gwas_dot.cu",
        "replaces": "src/repro/kernels/gwas_dot/gwas_dot.py:35",
        "launches": timing["launches"]["gwas_dot"],
        # the dense engine's calls on the card: one a cell a chunk of
        # KERNEL_TRAIT_CHUNK traits, over the same cohort
        "launches_dense": dense_timing["launches"]["gwas_dot"],
        "max_abs_err": main_row["r_max_abs_err"],
        "ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "dense_calls": {k: {"m": row["m"], "n": row["n"], "p": row["p"],
                            "max_abs_err": row["r_max_abs_err"], "ms": row["kernel_ms"],
                            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                            "library_ms": row["library_ms"]}
                        for k, row in dense_kernel_rows.items()},
    }]
    # tstat runs on the fused epilogue's dense-audit path, the screen on the
    # mixed-model scan's default (sparse) path, its t mode on the fused OLS
    # scan's sparse epilogue
    for name, replaces, launches in (
        ("screen_compact", "src/repro/kernels/tstat.py:65",
         lmm_timing["launches"]["screen_compact"]),
        ("compact_survivors", "src/repro/kernels/tstat.py:65",
         timing["launches"]["compact_survivors"]),
        ("tstat", "src/repro/kernels/tstat.py:19", audit_launches["tstat"]),
    ):
        row = tstat_rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": "src/repro_torch/kernels/csrc/tstat.cu",
            "replaces": replaces, "launches": launches, "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    # the refine replaces no Pallas kernel: it moves the reference's host
    # refine onto the card, and runs on every GWAS scan's cells
    kernels.append({
        "name": "refine", "route": "cuda", "source": "src/repro_torch/kernels/csrc/tstat.cu",
        "replaces": None, "moves": "src/repro/core/stats.py::refine_neglog10p (host)",
        "launches": timing["launches"]["refine"], "max_abs_err": refine_row["max_abs_err"],
        "ms": refine_row["ms"], "plain_ms": refine_row["plain_ms"],
        "host_ms": refine_row["host_ms"], "bound_ms": refine_row["bound_ms"],
        "bound_by": refine_row["bound_by"], "library_ms": None,
    })
    emit({"phase": "done", "total_s": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                             "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
