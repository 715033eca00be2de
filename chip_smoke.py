"""HAIL's main path, LM serving and LM training on one NVIDIA H100,
through the PyTorch port.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version on the card, then drives the
port's two paths.  HAIL runs at the paper's widths — UserVisits (91 B a
row), 2^19-row blocks (47.7 MB, the power of two closest to a 64 MB HDFS
block), 1,024-row index partitions, three replicas indexed on visitDate /
sourceIP / adRevenue, 10 nodes with 4 map slots — cut to 64 blocks (33.5 M
rows, 3.05 GB of ASCII).  Serving runs llama3.2-1b and falcon-mamba-7b at
full width and depth in bfloat16, with random weights from a seeded
generator: 4 prompts of 512 tokens, then 31 greedy decode steps; and
whisper-medium, the encoder-decoder, at full width and depth: 4 clips of
1,500 frame embeddings and 4 decoder prompts of 224 tokens, then 31
greedy decode steps; h2o-danube-1.8b at full width and depth (head dim
80, a sliding window of 4,096): 4 prompts of 8,192 tokens, twice the
window, into ring caches of 4,096 slots that the 31 decode steps wrap;
qwen2-vl-72b at full width on 16 of its 80 layers (head dim 128,
M-RoPE): 4 prompts of 512 patch embeddings, then 31 decode steps at
(3, B, 1) positions; and gemma3-4b and gemma3-12b at full width and depth
(head dim 256, qk-norm, five local layers of window 1,024 to one global
layer): 4 prompts of 4,096 tokens into rings of 1,024 slots at the local
layers and full caches at the global ones, then 31 decode steps;
mixtral-8x22b at full width on 8 of its 56 layers (MoE, 8 experts, top 2,
GQA 48/8, a window of 4,096): 4 prompts of 8,192 tokens through ring
caches of 4,096 slots; arctic-480b at full width on 2 of its 35 layers
(128 experts and a dense residual MLP, GQA 56/8): 4 prompts of 4,096
tokens; and zamba2-2.7b at full width and depth (45 Mamba2 layers and 9
occurrences of one shared attention block, MHA at head dim 80): 4 prompts
of 4,096 tokens.  Training runs llama3.2-1b at full width and depth and
falcon-mamba-7b at full width on 8 of its 64 layers, with float32
parameters and AdamW state, on batches of 4 x 512 tokens, whisper-medium
at full width and depth on 4 x 1,500 frames and 4 x 448 tokens,
h2o-danube-1.8b at full width and depth on 1 x 8,192 tokens, gemma3-4b
at full width on 16 of its 34 layers (2 of 5 groups and its tail) on
1 x 4,096 tokens, zamba2-2.7b at full width and depth on 1 x 4,096
tokens and mixtral-8x22b at full width on 1 of its 56 layers on
1 x 8,192 tokens.

1. device   the card, its count, its power limit and the float32 matmul
            settings (TF32 off for matmuls and cuDNN);
2. build    the kernels' build time, and each flash kernel's registers,
            spills and static shared memory a head dim from ptxas -v;
3. kernels  each kernel against its plain version at main-path shapes
            (the reader, the sort, the root-directory lookup and the range
            scan at HAIL's, flash attention at the llama prefill's, the
            scan at the falcon-mamba prefill's, plus small and ragged
            cases; the reader also at Q = 3, at Q = 1,500, at C = 1, at
            R = 1,000, over an out-of-order root directory and over inputs
            that are views off 16-byte boundaries; flash in bf16 at every
            head dim, ragged, non-causal and windowed; the backward kernels
            too: flash attention's with its forward's log-sum-exp and
            float32 output at the llama train shape in bf16 and float32
            and at the same edges, and once from the bf16 output; the
            scan's at the falcon-mamba train shape, small, ragged and
            N = 1; flash forward and backward at whisper's encoder,
            decoder-self and cross shapes; flash forward and backward at
            head dims 80 and 128 in bf16 and float32, causal, non-causal
            and windowed, T != S, ragged, GQA 32/8 and 64/8, at qwen2-vl's
            prefill shape and at h2o-danube's T of 8,192 and window of
            4,096; the bf16 backward from the bf16 and from the float32
            output against the exact gradient, at h2o-danube's and
            qwen2-vl's shapes too; flash forward and backward at head dim
            256 in bf16 and float32, causal, non-causal and windowed,
            T != S, ragged, with a softcap at head dims 64 and 256, and at
            gemma3's prefill and training shapes; flash forward and
            backward at GQA 48/8, 56/8 and 32/32 (head dims 128 and 80),
            at the prefill shapes of mixtral, arctic and zamba2 and the
            training shapes of mixtral and zamba2, the bf16 backward
            there against the exact gradient), and the HAIL slice at the
            test shape on the card against the CPU;
4. eager    HAIL upload + indexed query through the fused reader, against
            the same query over a plain HDFS upload; then the same query
            read by the two standalone primitives (``ops.index_search`` on
            every block's root directory, ``ops.pax_scan`` on each block's
            selected partitions), against the fused reader's rows;
5. shared   one split read for 8 queries at once against 8 single reads;
5b. server  HAIL serving on the eager store: 8 queries of 4 tenants through
            ``HailServer`` flushes (one reader launch per split and batch,
            each ticket's rows == its own job's), re-flushed from the
            result cache (exact and subsumed hits, no launch) and from the
            block cache (no verification); then 4 corrupted (replica,
            block) pairs found by a flush and by the scrubber and repaired
            bit-equal to copies taken before (2 sort launches per repaired
            indexed block); then a ReplicationController adding a replica
            for the unindexed duration column (one batched sort of
            (64, 2^19)), bit-equal to its reference permutation, claimed
            and built on by an adaptive flush, and decommissioned;
5c. wave    the multi-device wave dispatch on the eager store, with slots
            of the card: a (1,) mesh takes the per-split path (rows, bytes,
            counters, launches equal); a (4,) mesh of four streams on
            cuda:0 reads the 40 splits in 10 waves, one reader launch a
            split, with the per-split job's row ids, fractions, bytes and
            scan-mode counters (three runs, and once under a node
            failure); two adaptive jobs on a lazy store (full scans 64,
            48); a HailServer cold flush of phase 5b's queries; and
            ``spmd_aggregate`` of adRevenue by countryCode (exact counts,
            sums within 1e-5 of float64); walls and idle shares of both
            jobs;
6. adaptive a lazy upload that 6 adaptive jobs converge to fully indexed,
            then one eager, HDFS, building and converged job each again
            under the CUDA profiler: device-busy time and host spans;
6b. data    the LM data pipeline at the served model's widths: 2^15
            documents of 513 tokens (vocabulary 128,256) uploaded in
            blocks of 4,096 rows, selected by the indexed query domain = 3
            (doc ids and tokens bit-equal to the generated corpus), and
            the first (4, 512) batch, which phase 9 trains on;
7. serve    each model: prefill + decode through the serve steps, with
            one flash-attention (llama, 16; h2o-danube, 24; qwen2-vl, 16;
            gemma3-4b, 34; gemma3-12b, 48; mixtral, 8; arctic, 2) or scan
            (falcon-mamba, 64) launch per layer in prefill (whisper: 72,
            one a layer of its encoder, two a decoder layer; zamba2: 9,
            one a shared block, none a Mamba2 layer) and none in decode;
            every layer's output on the kernel route against the plain
            route from the same input (an MoE layer on the plain route's
            routing, the tokens routed otherwise counted with their
            logit gaps), and the logits of both routes (for h2o-danube,
            gemma3, arctic and zamba2 on the first prompt, for mixtral on
            its first 6,144 tokens); the ring caches of h2o-danube, of
            gemma3's local layers and of mixtral slot by slot after
            prefill and after the last decode step, gemma3's full caches
            at its global layers and zamba2's nine shared-block caches
            too, and against the plain route's (zamba2's Mamba2 caches
            finite, and bit for bit up to its first attention layer);
            walls, tokens/s,
            parameter bytes, peak memory, and one profiled prefill and
            decode step (with the kernel's share of the device time);
8. times    each kernel's own device time (from the CUDA profiler) against
            its bound, its plain version's and, where one exists, a library
            call's, each beside CUDA events around back-to-back calls (the
            reader at 16 and 64 blocks and at the paths' shapes: the
            server's 2 blocks at Q = 8, C = 3, the eager job's 2 indexed
            blocks and the adaptive jobs' one lazy block at Q = 1, each
            with its launches on its path; the sort at one block, at 16
            and at 64; the two backward kernels at the train shapes, flash
            beside SDPA's backward; flash forward and backward at whisper's
            encoder and cross shapes, at h2o-danube's prefill and training
            shapes, at qwen2-vl's prefill shape, at gemma3's prefill (4b
            and 12b) and training (4b) shapes, global and local, at the
            prefill shapes of mixtral, arctic and zamba2 and the training
            shapes of mixtral and zamba2, beside SDPA and its backward);
9. train    gradients through the kernels: one llama attention layer,
            one falcon-mamba Mamba1 layer, one whisper decoder layer, one
            h2o-danube layer on 6,144 tokens (past its window), one
            qwen2-vl layer, a local and a global gemma3-4b layer on
            2,048 tokens and one mixtral MoE layer on 6,144 tokens (the
            router's and experts' gradients too, on the plain route's
            routing) at full width, dx and every parameter gradient
            on the kernel route against the plain route (one forward and
            one backward launch a mixer call); the attention layers again
            in bf16 compute (each attention call's gradients against the
            plain attention's, every gradient against float32 compute,
            see LAYER_BF16_EXCESS); a whole
            llama step at full width on 2 groups in float32 compute on
            both routes; llama3.2-1b trained at full width and depth in
            bf16 compute on phase 6b's HAIL-selected batch (a warm-up
            and 5 counted steps, 16 flash forward and 16 backward launches
            a step, the loss falling on the repeated batch, one profiled
            step, one step each under remat="full" and "dots" with 32
            forward launches and the loss of a remat="none" step from the
            same state),
            falcon-mamba-7b the same on 8 layers (8 + 8 scan launches a
            step), whisper-medium the same at full width and depth on a
            repeated batch of 4 x 1,500 frames and 4 x 448 tokens (a
            warm-up and 3 counted steps, 72 + 72 flash launches a step),
            h2o-danube-1.8b the same at full width and depth on a repeated
            1 x 8,192 tokens (24 + 24 a step, windowed), gemma3-4b on 16
            of its 34 layers on 1 x 4,096 tokens (16 + 16 a step, 14
            windowed), zamba2-2.7b at full width and depth on 1 x 4,096
            tokens (9 + 9 a step, every gradient leaf finite: the Mamba2
            repair), mixtral-8x22b on 1 of its 56 layers on 1 x 8,192
            tokens (1 + 1 a step, windowed);
            and a checkpoint round trip of a full-width two-group
            llama train state (bit for bit onto the card, the same loss
            from the restored state, a corrupted leaf falling back to the
            step before).

Each phase prints one JSON line; every check that fails raises, so the exit
code is not 0.  The last line is ``{"ok": true, "device": {...}}``.  Data
comes from a fixed seed.  Needs one CUDA card; exits non-zero without one.

    python3 chip_smoke.py --profiler-probe [ROUNDS]

counts instead how often ``torch.profiler`` loses the device work of a
profiled window (``profiler_probe``), the reason every profiled window
here starts ``PROFILER_SETTLE_S`` late.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
ROWS = 1 << 19                 # rows a block
BLOCKS = 64                    # the cut: a sixth of one datanode's 20 GB
PARTITION = 1024               # rows a leaf partition (the paper's)
N_NODES = 10
BAD_FRACTION = 0.001
KEYS = ("visitDate", "sourceIP", "adRevenue")
QUICK = ("visitDate", 10000, 10155)    # examples/quickstart.py's query
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
INT_OPS_PER_S = 67e12          # H100 SXM peak outside the tensor cores
F32_OPS_PER_S = 67e12          # float32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # dense bf16 on the tensor cores
INT32_MAX = 2**31 - 1

# LM serving: the traffic of phase 7
SERVE = (("llama3.2-1b", "flash_attention"),
         ("falcon-mamba-7b", "selective_scan"))
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 512, 32
# h2o-danube-1.8b (arXiv:2401.16818: 24 layers, width 2,560, 32 heads over
# 8 KV heads of 80, sliding window 4,096): prompts of twice the window, so
# prefill keeps a ring of the last 4,096 positions a layer and every decode
# step wraps it; trained on one sequence of the same length.  qwen2-vl-72b
# (arXiv:2409.12191: 80 layers, width 8,192, 64 heads over 8 KV heads of
# 128, M-RoPE) served at 16 of its 80 layers: its bf16 weights are ~145
# GB, 16 layers and both 1.25 B-parameter tables ~33 GB.
H2O, QWEN = "h2o-danube-1.8b", "qwen2-vl-72b"
H2O_WINDOW = 4096
H2O_PROMPT = 2 * H2O_WINDOW
H2O_TRAIN_BATCH, H2O_TRAIN_SEQ = 1, 2 * H2O_WINDOW
H2O_TRAIN_STEPS = 4             # one of them the warm-up
QWEN_GROUPS = 16
# The per-layer checks at h2o-danube's widths run past the window at batch
# 1: the plain route's float32 scores are 32 heads x T^2 x 4 B a copy
# (34 GB for the 4 prompts of 8,192, 8.6 GB for one; 4.8 GB at 6,144,
# where the gradient check's autograd keeps several).
H2O_CHECK_BATCH = 1
H2O_LAYER_SEQ = 3 * H2O_WINDOW // 2
# their attention shapes in bf16: h2o's prefill (4 x 8,192 against a
# window of 4,096) and training (1 x 8,192), qwen2-vl's prefill (4 x 512)
H2O_PREFILL_ATTN = (SERVE_BATCH, H2O_PROMPT, H2O_PROMPT, 32, 8, 80, True,
                    H2O_WINDOW, torch.bfloat16)
H2O_TRAIN_ATTN = (H2O_TRAIN_BATCH, H2O_TRAIN_SEQ, H2O_TRAIN_SEQ, 32, 8, 80,
                  True, H2O_WINDOW, torch.bfloat16)
QWEN_ATTN = (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 64, 8, 128, True, None,
             torch.bfloat16)
# gemma3-4b and gemma3-12b (hf:google/gemma-3-*-pt: 34 and 48 layers,
# widths 2,560 and 3,840, 8 and 16 heads over 4 and 8 KV heads of 256,
# qk-norm, five local layers of window 1,024 and one global layer a
# group): 4 prompts of 4,096 tokens, four windows, so the local layers
# prefill into rings of 1,024 slots that the 31 decode steps wrap while
# the global layers fill full caches; gemma3-4b trained at full width on
# 2 of its 5 groups and its 4-layer tail (16 of 34 layers: float32 AdamW
# state for all 3.88 B parameters is 62 GB) on one sequence of 4,096.
GEMMA4, GEMMA12 = "gemma3-4b", "gemma3-12b"
GEMMA_WINDOW = 1024
GEMMA_PROMPT = 4 * GEMMA_WINDOW
GEMMA_CHECK_BATCH = 1
GEMMA_TRAIN_GROUPS, GEMMA_TRAIN_SEQ = 2, 4 * GEMMA_WINDOW
GEMMA_TRAIN_STEPS = 4           # one of them the warm-up
GEMMA_LAYER_SEQ = 2 * GEMMA_WINDOW
GEMMA_LOCAL, GEMMA_GLOBAL = 0, 5    # pattern positions
# their attention shapes in bf16: each model's prefill at a global
# (causal) and a local (window 1,024) layer, and the training shape
GEMMA4_PREFILL_ATTN = (SERVE_BATCH, GEMMA_PROMPT, GEMMA_PROMPT, 8, 4, 256,
                       True, None, torch.bfloat16)
GEMMA4_PREFILL_LOCAL_ATTN = GEMMA4_PREFILL_ATTN[:7] + (GEMMA_WINDOW,
                                                       torch.bfloat16)
GEMMA12_PREFILL_ATTN = (SERVE_BATCH, GEMMA_PROMPT, GEMMA_PROMPT, 16, 8, 256,
                        True, None, torch.bfloat16)
GEMMA12_PREFILL_LOCAL_ATTN = GEMMA12_PREFILL_ATTN[:7] + (GEMMA_WINDOW,
                                                         torch.bfloat16)
GEMMA4_TRAIN_ATTN = (1, GEMMA_TRAIN_SEQ, GEMMA_TRAIN_SEQ, 8, 4, 256, True,
                     None, torch.bfloat16)
GEMMA4_TRAIN_LOCAL_ATTN = GEMMA4_TRAIN_ATTN[:7] + (GEMMA_WINDOW,
                                                   torch.bfloat16)
# mixtral-8x22b (arXiv:2401.04088: 56 layers, width 6,144, 48 heads over
# 8 KV heads of 128, sliding window 4,096, 8 experts of 16,384, top 2)
# served on 8 of its 56 layers (20.4 B parameters, 40.9 GB in bf16): 4
# prompts of 8,192 tokens, twice the window, into rings of 4,096 slots that
# the 31 decode steps wrap; its route checks on one prompt of 6,144 (past
# the window), where the plain route's float32 scores are 7.2 GB a copy at
# 48 heads (12.9 GB at 8,192).  Trained at full width on 1 of its 56
# layers on 1 x 8,192 tokens (2.9 B parameters: 46.5 GB of float32
# parameters, gradients and AdamW moments).  arctic-480b
# (hf:Snowflake/snowflake-arctic-base: 35 layers, width 7,168, 56 heads over
# 8 KV heads of 128, 128 experts of 4,864, top 2, a dense residual MLP)
# served on 2 of its 35 layers (27.7 B parameters, 55.4 GB; a third layer
# of 13.6 B would not fit): 4 prompts of 4,096 tokens; not trained (one
# layer's float32 state is 218 GB).  zamba2-2.7b (arXiv:2411.15242: 54
# layers = 9 x (5 Mamba2 + 1 shared attention block of 32 heads of 80, MHA),
# width 2,560) served at full width and depth on 4 prompts of 4,096 tokens
# and trained so on 1 x 4,096 tokens.
MIXTRAL, ARCTIC, ZAMBA = "mixtral-8x22b", "arctic-480b", "zamba2-2.7b"
MIXTRAL_WINDOW = 4096
MIXTRAL_GROUPS, MIXTRAL_PROMPT = 8, 2 * MIXTRAL_WINDOW
MIXTRAL_CHECK_BATCH, MIXTRAL_CHECK_PROMPT = 1, 3 * MIXTRAL_WINDOW // 2
MIXTRAL_TRAIN_GROUPS, MIXTRAL_TRAIN_SEQ = 1, 2 * MIXTRAL_WINDOW
MIXTRAL_LAYER_SEQ = 3 * MIXTRAL_WINDOW // 2
ARCTIC_GROUPS, ARCTIC_PROMPT, ARCTIC_CHECK_BATCH = 2, 4096, 1
ZAMBA_PROMPT, ZAMBA_CHECK_BATCH = 4096, 1
ZAMBA_TRAIN_SEQ = 4096
MOE_TRAIN_STEPS = 4             # one of them the warm-up
# their attention shapes in bf16: each model's prefill, and the training
# shapes of mixtral (windowed, 1 x 8,192) and zamba2's shared block (1 x
# 4,096)
MIXTRAL_PREFILL_ATTN = (SERVE_BATCH, MIXTRAL_PROMPT, MIXTRAL_PROMPT, 48, 8,
                        128, True, MIXTRAL_WINDOW, torch.bfloat16)
MIXTRAL_TRAIN_ATTN = (1, MIXTRAL_TRAIN_SEQ, MIXTRAL_TRAIN_SEQ, 48, 8, 128,
                      True, MIXTRAL_WINDOW, torch.bfloat16)
ARCTIC_PREFILL_ATTN = (SERVE_BATCH, ARCTIC_PROMPT, ARCTIC_PROMPT, 56, 8, 128,
                       True, None, torch.bfloat16)
ZAMBA_PREFILL_ATTN = (SERVE_BATCH, ZAMBA_PROMPT, ZAMBA_PROMPT, 32, 32, 80,
                      True, None, torch.bfloat16)
ZAMBA_TRAIN_ATTN = (1, ZAMBA_TRAIN_SEQ, ZAMBA_TRAIN_SEQ, 32, 32, 80, True,
                    None, torch.bfloat16)
# GQA ratios no path had launched before: 6 (48/8), 7 (56/8) and 1 (32/32),
# at D = 128 and 80, causal, windowed and non-causal, T off the tiles
MOE_HYBRID_CASES = [
    (1, 300, 300, 48, 8, 128, True, 128, torch.bfloat16),
    (2, 97, 161, 48, 8, 128, True, None, torch.bfloat16),
    (1, 300, 300, 48, 8, 128, True, 128, torch.float32),
    (2, 100, 100, 56, 8, 128, True, None, torch.bfloat16),
    (1, 77, 77, 56, 8, 128, True, None, torch.float32),
    (2, 100, 100, 32, 32, 80, True, None, torch.bfloat16),
    (1, 70, 130, 32, 32, 80, False, None, torch.bfloat16),
    (2, 100, 100, 32, 32, 80, True, None, torch.float32),
    (1, 70, 130, 32, 32, 80, False, None, torch.float32)]
# The MoE router takes its top 2 from float32 logits; the kernel and the
# plain route differ in attention by ~1e-7 of scale, so a token whose 2nd
# and 3rd logits lie that close may take another expert on one route (and
# shift the capacity positions after it in its group): an order-one
# difference and no fault.  So each MoE layer check records the plain
# route's routing, runs the kernel route on it (``Routing``), and holds
# every output and gradient at SERVE_LAYER_TOL; the tokens the kernel route
# would have routed otherwise are counted, with their logit gaps: at most
# ROUTE_FLIPS_MAX of them a check, each gap within ROUTE_GAP_SHARE of the
# logits' largest magnitude.
ROUTE_FLIPS_MAX = 8
ROUTE_GAP_SHARE = 1e-5
# Softcap (gemma3's option, which no config sets): phase 3 holds the
# kernels to the plain versions at this cap on scores of N(0, 1) data at
# D = 64 and 256, where c tanh(s / c) bends them (a 10th element of a
# case)
FLASH_SOFTCAP = 2.0
GEMMA_D256_CASES = [
    (2, 100, 100, 8, 4, 256, True, None, torch.bfloat16),
    (2, 100, 77, 4, 2, 256, False, 24, torch.bfloat16),
    (1, 300, 300, 8, 4, 256, True, 128, torch.bfloat16),
    (1, 70, 130, 8, 4, 256, False, None, torch.bfloat16),
    (2, 97, 161, 8, 4, 256, True, None, torch.bfloat16),
    (1, 200, 50, 2, 1, 256, True, 16, torch.bfloat16),
    (2, 100, 77, 4, 2, 256, False, 24, torch.float32),
    (1, 300, 300, 8, 4, 256, True, 128, torch.float32),
    (2, 97, 161, 8, 4, 256, True, None, torch.float32),
    (1, 200, 50, 2, 1, 256, True, 16, torch.float32),
    (2, 100, 100, 4, 2, 64, True, None, torch.bfloat16, FLASH_SOFTCAP),
    (2, 100, 77, 4, 2, 64, False, 24, torch.float32, FLASH_SOFTCAP),
    (1, 300, 300, 8, 4, 256, True, 128, torch.bfloat16, FLASH_SOFTCAP),
    (2, 97, 161, 8, 4, 256, True, None, torch.float32, FLASH_SOFTCAP)]
# The plain versions at h2o's T of 8,192 hold the (T, T) float32 scores of
# every head several times over (34 GB a copy for the prefill's 4 prompts;
# the backward about 6 copies, reckoned ~52 GB at 32 heads).  So phase 3
# launches the kernels at these two shapes whole and holds each output to
# the plain version on parts (plain_parts): the prefill's first and last
# prompt, and the training shape's first and last 8 of 32 heads (2 of 8 KV
# heads, the model's GQA 4:1).  Phase 8 times the plain versions on one
# such part, and says so.
H2O_PLAIN_HEADS = 8
# the CUDA function each serving kernel launches (profiler names; the range
# scan's is "scan_kernel", which no other name contains)
KERNEL_NAMES = {"flash_attention": "flash_bf16_kernel",
                "selective_scan": "selective_scan_lanes"}
# Kernel against plain version, max abs error: the JAX package's own
# tolerances (tests/test_kernels.py): float32 attention 2e-5, bfloat16
# attention 2e-2 (one bf16 step of outputs of magnitude < 4), scan 1e-4
# relative to the output's magnitude (float32 over 512 steps).
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SCAN_RTOL = 1e-4
# Serving, kernel route against plain route.  The two routes differ only
# in float32 summation order inside attention or the scan (~1e-7 of the
# output's scale, phase 3), but the random-weight models amplify any
# difference layer by layer: on the CPU, a 1e-3 relative change of every
# scan output moves the logits of a 64-layer falcon-mamba by 11-33% of
# their scale in bf16.  So the check is per layer, from the same input:
# every layer's output (float32 compute, bf16 weights cast at use) on the
# kernel route against the plain route, as a share of its largest
# magnitude.  1e-4 is a thousand times the kernels' own difference and
# far below the order-1 error of a faulty kernel.  The logits of the
# whole prefill and first decode step are compared too, in bf16 and in
# float32, and reported with the free-running divergence per layer.
SERVE_LAYER_TOL = 1e-4
# The backward kernels against their plain versions (ref.attention_bwd,
# ref.selective_scan_bwd) on the same inputs, as a share of each
# gradient's largest magnitude: float32 sums in another order (~1e-6
# measured) within 1e-5; bf16 gradients are rounded once to bf16 at the
# store (2^-9 of each value), within 2^-8.  The scan's gradients sum over
# up to 512 steps and 8,192 channels in float32: 1e-4, as the forward.
# The forward's lse (natural log, float32): 1e-5 of its magnitude.
FLASH_BWD_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -8}
# (The bf16 backward is held to the plain version's float32 gradient, its
# value before its own rounding to bf16: the kernel's one rounding is then
# the 2^-9, where against the plain version's bf16 gradient two roundings
# of one value may land a whole bf16 step apart, 2^-7 of the scale near
# the largest gradient.)
SCAN_BWD_RTOL = 1e-4
LSE_TOL = 1e-5
# Training (phase 9): batch 4 x 512 tokens; llama3.2-1b at full width and
# depth, falcon-mamba-7b at full width on 8 of its 64 layers (float32
# AdamW state for all 7.01 B parameters would be 112 GB).  The whole-step
# check runs llama at full width on 2 groups in float32 compute on both
# routes: each route's gradients are the same float32 arithmetic but for
# the summation order inside attention (~1e-6 of a gradient's scale,
# phase 3), which the random-weight model carries through two layers and
# the 128,256-way softmax.  Its weights are the first two layers of the
# full model's (scores of order 1e2, where one float32 ulp of a score is
# ~1e-5 of a softmax weight); 1e-3 of each leaf's scale leaves room for
# that and is far below the order-1 error of a missing or wrong gradient.
TRAIN_BATCH, TRAIN_SEQ = 4, 512
TRAIN_STEPS = 6                 # one of them the warm-up
FALCON_TRAIN_GROUPS, FALCON_TRAIN_STEPS = 8, 3
TRAIN_LR = 1e-3
TRAIN_STEP_TOL = 1e-3
# whisper-medium (arXiv:2212.04356, Table 1: 24 + 24 layers, width 1024,
# 16 heads of 64): 1,500 encoder frames (a 30 s window of 80-channel
# log-Mel at a 10 ms stride, halved by the stride-2 convolution, whose
# output the stub frontend's frame embeddings stand for); the released
# decoder context of 448 tokens, of which a previous-text prompt takes at
# most half: 224 to prefill, the full 448 to train on.
WHISPER = "whisper-medium"
WHISPER_FRAMES, WHISPER_PROMPT, WHISPER_TRAIN_SEQ = 1500, 224, 448
WHISPER_TRAIN_STEPS = 4         # one of them the warm-up
# its three attention shapes in bf16 (phase 3): encoder, decoder self
# (the prefill's 224 tokens) and cross
WHISPER_ATTN = [
    (SERVE_BATCH, WHISPER_FRAMES, WHISPER_FRAMES, 16, 16, 64, False, None,
     torch.bfloat16),
    (SERVE_BATCH, WHISPER_PROMPT, WHISPER_PROMPT, 16, 16, 64, True, None,
     torch.bfloat16),
    (SERVE_BATCH, WHISPER_PROMPT, WHISPER_FRAMES, 16, 16, 64, False, None,
     torch.bfloat16)]
# bf16-compute layer gradients (phase 9).  Two checks.  (a) Each attention
# call of the layer: the kernels' dq, dk, dv against the exact gradient of
# the same bf16 q, k, v and upstream gradient (autograd through the plain
# attention on their float32 values, no rounding at the end), within
# FLASH_BWD_RTOL's 2^-8 of its scale: the one rounding of each gradient to
# bf16 costs up to 2^-8 of a value just above a power of two.  (Against
# the plain route's own bf16 gradients two roundings meet, and one value
# rounded the other way is a whole bf16 step, up to 2^-7 of the scale.)  (b)
# Every gradient of the layer, against the same layer in float32 compute
# (the same bf16 weights and inputs): the kernel route's share may exceed
# the plain route's by at most 2^-8.  bf16 compute alone puts either route
# at ~0.005-0.010 of a gradient's scale from float32 compute (each of the
# layer's bf16 roundings flips some values differently once the two
# routes' attention outputs differ by P's rounding to bf16; measured on
# the CPU with a model of the kernel's arithmetic), so the two bf16 routes
# cannot be held to 2^-8 of each other, and (a) is where a fault of the
# backward kernel shows.  The kernel route's share is also held to
# LAYER_BF16_CEIL outright: 2^-6, 1.5 times the largest reading before it
# was set (0.0105, whisper's decoder layer; 0.0095 llama's).
# An MoE layer reads more, on both routes alike: its backward runs through
# the experts' bf16 products.  Mixtral's layer at two seeds (0 + 4 and
# 0 + 44; ``scripts/moe_layer_witness.py``) put its other leaves up to
# 0.0169 from float32 compute (dx 0.0168 on both routes, attn/wk 0.0169 on
# the plain route: past 2^-6), so they are held by (b) and under
# LAYER_BF16_MOE_CEIL, 2^-5, 1.85 times that.  Its expert leaves (w_gate,
# w_up, w_down) read w_gate at 0.030-0.052.  An expert's gradient reads the
# attention only through the forward, so its noise is set by how far each
# route's attention output sits from float32, and the plain route is not
# the only sound reference: two witnesses, the plain route with its
# attention output moved by the flash forward's own difference, mirrored
# or rolled by half the sequence (``layer_grad_check_bf16``, each move
# checked within FLASH_TOL), read w_gate 0.0048 and 0.0054 apart at the
# two seeds, past 2^-8.  So an expert leaf of the kernel route is held
# within LAYER_BF16_EXPERT_EXCESS, 2^-7 (1.45 times that spread), of the
# furthest of the plain route and the witnesses (the kernel route read
# 0.0047 and 0.0 past it), and under LAYER_BF16_EXPERT_CEIL, 5 * 2^-6,
# 1.5 times the largest reading (0.0517).
LAYER_BF16_EXCESS = 2 ** -8
LAYER_BF16_CEIL = 2 ** -6
LAYER_BF16_MOE_CEIL = 2 ** -5
LAYER_BF16_EXPERT_EXCESS = 2 ** -7
LAYER_BF16_EXPERT_CEIL = 5 * 2 ** -6
# The repair check (phase 3, ``bf16_grad_repair``) also runs whisper's
# encoder and cross shapes with q scaled by REPAIR_PEAK: scores with a
# standard deviation of 6, each row's softmax near one-hot, so O is large
# and its rounding to bf16 moves D = rowsum(dO * O) most.  There the
# backward from the bf16 O must fail 2^-8 (the control: the check sees
# the fault; 0.0042-0.0067 on the CPU at (1,1500,8,64) and
# (2,224,1500,8,64)) and the backward from the float32 O must pass it.
REPAIR_PEAK = 6.0


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def clear_launches():
    """Every launch count to 0, by kernel and by launch shape."""
    from repro_torch.kernels import _build

    _build.KERNEL_LAUNCHES.clear()
    _build.SHAPE_LAUNCHES.clear()


def shape_launches() -> dict:
    """The launches counted by shape since ``clear_launches``:
    "kernel: launch key" -> launches."""
    from repro_torch.kernels import _build

    return {f"{kernel}: {key}": n
            for (kernel, key), n in sorted(_build.SHAPE_LAUNCHES.items())}


def ptxas_flash(log: str) -> list:
    """Registers, spills and static shared memory of every flash kernel
    instantiation (one a head dim; the bf16 kernels' with and without the
    softcap, the dK/dV kernel's passes) as ``ptxas -v`` reported them in
    the build: [{"kernel", "head_dim", ("pass", "softcap",) "registers",
    "spill_stores", "spill_loads", "static_smem_bytes"}]."""
    import re

    rows, cur = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = re.search(r"(flash_(?:bf16|f32|bwd_dq|bwd_dkdv|bwd_dq_bf16|"
                             r"bwd_dkdv_bf16)_kernel)ILi(\d+)E(?:Li(\d)E)?"
                             r"(?:Lb(\d)E)?", entry[1])
            cur = None
            if name:
                cur = {"kernel": name[1], "head_dim": int(name[2])}
                if name[3] is not None:     # the dK/dV kernel's DkdvPass
                    cur["pass"] = ("dK and dV", "dV", "dK")[int(name[3])]
                if name[4] is not None:     # the bf16 kernels' kCap
                    cur["softcap"] = name[4] == "1"
                rows.append(cur)
            continue
        if cur is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill:
            cur["spill_stores"], cur["spill_loads"] = map(int, spill.groups())
        used = re.search(r"Used (\d+) registers", line)
        if used:
            cur["registers"] = int(used[1])
            smem = re.search(r"(\d+) bytes smem", line)
            cur["static_smem_bytes"] = int(smem[1]) if smem else 0
    return sorted(rows, key=lambda r: (r["kernel"], r["head_dim"],
                                       r.get("pass", ""),
                                       r.get("softcap", False)))


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms, between CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_us(event) -> float:
    """An averaged profiler event's own device time in us."""
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0))


PROFILER_MISSES: list = []   # device_ms calls the profiler traced nothing of
# The profiler has been seen to drop the device work of the first
# milliseconds after it starts, for the CUDA kernels and plain PyTorch
# calls alike (``python3 chip_smoke.py --profiler-probe`` on an H100: some
# windows of 20 calls traced nothing, some of 200 calls lost their first
# 40-60 calls; no window that began 50 ms after the profiler did lost
# anything), so every profiled window waits this long before its first
# call.
PROFILER_SETTLE_S = 0.05


def device_ms(fn, iters: int, match: str | None = None) -> tuple[float, str]:
    """Device time per call of ``fn`` in ms, from the CUDA profiler: the
    summed duration of the device work (kernels and copies) it issued, or
    of the kernels whose name holds ``match``, over ``iters`` calls after a
    warm-up.  Unlike ``cuda_ms`` it leaves out the time the card waits for
    the host between calls.  Each window waits ``PROFILER_SETTLE_S``
    first.  Should the profiler still trace none of the work (it did, in
    runs where every launch succeeded, before the wait), after two such
    profiled runs the time is taken between CUDA events around the same
    calls instead (``cuda_ms``, host gaps included), and the miss is
    recorded in ``PROFILER_MISSES``.  The second value names the clock:
    "profiler" or "cuda_events"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILER_SETTLE_S)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        events = [e for e in device if match is None or match in e.key]
        if events:
            return sum(device_us(e) for e in events) / iters / 1e3, "profiler"
        seen.append(sorted(e.key[:80] for e in device)[:4])
    PROFILER_MISSES.append({"match": match, "device_events_seen": seen})
    return cuda_ms(fn, iters), "cuda_events"


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = INT_OPS_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# kernel inputs at main-path shapes
# ---------------------------------------------------------------------------


def reader_inputs(rng, b, rows, parts, n_cols, n_q, use_index,
                  ranges="edges", kind="sorted"):
    """Blocks as the store holds them: indexed blocks sorted by key with a
    root directory of partition minima, unindexed ones in upload order
    with a zeroed directory; bad rows at ~0.1%.  Keys are even, so an odd
    point range matches nothing.  ``ranges``: "edges" are ranges below the
    minimum, above the maximum, lo > hi and the whole int32 range, then
    random ones past the eighth; "server" are phase 5b's eight visitDate
    ranges (lo 7000 ... 11900, widths 155 + 10 i).  ``kind``: "shifted"
    takes keys near INT32_MAX and adds to each indexed block's minima the
    int32 shift that wraps (``FaultInjector.corrupt_root``), so the
    directory is out of order; "offset" passes keys, bad flags and the
    projection as views one element past a 16-byte boundary."""
    ps = rows // parts
    keys = (rng.integers(3500, 6000, (b, rows)) * 2).astype(np.int64)
    if kind == "shifted":          # keys in [INT32_MAX - 5100, - 100]
        keys += INT32_MAX - 12100
    keys[use_index > 0] = np.sort(keys[use_index > 0], axis=1)
    mins = np.where(use_index[:, None] > 0, keys[:, ::ps], 0)
    if kind == "shifted":
        shift = int(rng.integers(1000, 4000))     # the later minima wrap
        mins = np.where(use_index[:, None] > 0,
                        (mins + shift + 2**31) % 2**32 - 2**31, 0)
        check(bool((np.diff(mins[use_index > 0], axis=1) < 0).any()),
              "the shifted directory is out of order")
    proj = rng.integers(-2**31, INT32_MAX, (b, rows, n_cols)).astype(np.int32)
    bad = rng.random((b, rows)) < 0.001
    if kind == "shifted":
        top = INT32_MAX
        lohi = np.array([[top - 4000, top - 3000], [top - 5100, top],
                         [-2**31, -2**31 + 5000], [-2**31, top],
                         [top - 2000, top - 2500]], np.int64)
    elif ranges == "server":
        lohi = np.array([[lo, lo + 155 + 10 * i] for i, lo in enumerate(
            [7000, 7400, 8000, 9000, 10000, 10500, 11000, 11900])])
    else:
        lohi = np.array([[10000, 10155], [-50, 6999], [12001, 20000],
                         [9000, 8000], [8001, 8001], [7000, 7500],
                         [-2**31, INT32_MAX], [11000, 11999]], np.int64)
    while len(lohi) < n_q:
        extra = np.sort(rng.integers(6900, 12100, (n_q - len(lohi), 2)), 1)
        lohi = np.concatenate([lohi, extra])
    lohi = lohi[:n_q]
    arrays = [a.astype(np.int32) if a.dtype == np.int64 else a for a in (
        mins, keys, proj, bad, use_index.astype(np.int32), lohi)]
    out = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrays]
    if kind == "offset":        # keys, proj, bad: views one element on
        for i in (1, 2, 3):
            flat = torch.empty(out[i].numel() + 1, dtype=out[i].dtype,
                               device="cuda")
            view = flat[1:].view(out[i].shape)
            view.copy_(out[i])
            check(view.is_contiguous() and view.data_ptr() % 16 != 0,
                  "an unaligned contiguous view")
            out[i] = view
    return out


def reader_bound(inputs, outputs, partition_size):
    """Least bytes the reader must move for these inputs: keys and bad flags
    of the rows some query's partition range covers (by the port's
    lower-bound rule), the projection of the rows some query keeps, the
    root directories of indexed blocks, every output byte; and two compares
    per live row and query."""
    mins, keys, proj, _, uidx, lohi = inputs
    mins, uidx, lohi = (t.cpu().numpy() for t in (mins, uidx, lohi))
    mask = outputs[0]
    b, rows = keys.shape
    n_cols, n_q = proj.shape[2], lohi.shape[0]
    live = 0
    for i in range(b):
        if not uidx[i]:
            live += rows
            continue
        spans = []
        for lo, hi in lohi:
            p0 = max(int((mins[i] < lo).sum()) - 1, 0)
            p1 = max(int((mins[i] <= hi).sum()) - 1, 0)
            spans.append((p0 * partition_size,
                          min((p1 + 1) * partition_size, rows)))
        end = -1
        for s, e in sorted(spans):
            s = max(s, end)
            if e > s:
                live += e - s
                end = e
    kept = int(mask.any(dim=-1).sum())
    n_bytes = (live * 5 + kept * 4 * n_cols
               + int(uidx.sum()) * mins.shape[1] * 4 + b * 4 + n_q * 8  # reads
               + b * rows * (n_q + 4 * n_cols) + b * n_q * 4)  # writes
    return bound_ms(n_bytes, 2 * live * n_q)


def sort_inputs(rng, b, n, kind="dupes"):
    """Heavy duplicates and INT32_MAX bad-row sentinels; or one key value
    throughout ("equal"), or keys over all of int32 ("full")."""
    if kind == "equal":
        keys = np.full((b, n), -7, np.int32)
    elif kind == "full":
        keys = rng.integers(-2**31, INT32_MAX, (b, n), endpoint=True)
    else:
        keys = rng.integers(7000, 7050, (b, n))
        keys[rng.random((b, n)) < 0.01] = INT32_MAX
    return torch.from_numpy(keys.astype(np.int32)).cuda()


def sort_bound(keys):
    """Keys read once, sorted keys and the permutation written once, against
    the radix sort's integer work: per key and 8-bit digit, its extraction
    (xor, shift, mask) and its count in the histogram, then its rank and
    place in the digit's pass (a compare, an add, an address): 7 operations
    for each of 4 digits."""
    b, n = keys.shape
    return bound_ms(b * n * 12, 7 * 4 * b * n)


def attn_inputs(b, t, s, h, kv, d, dtype):
    g = torch.Generator(device="cuda").manual_seed(SEED)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype)
            for shape in ((b, t, h, d), (b, s, kv, d), (b, s, kv, d))]


def attn_bound_terms(q, k, v, causal, window) -> tuple[int, int]:
    """(bytes, flops) of ``attn_bound``."""
    b, t, h, d = q.shape
    s = k.shape[1]
    qp = torch.arange(t)[:, None]
    kp = torch.arange(s)[None, :]
    m = torch.ones((t, s), dtype=torch.bool)
    if causal:
        m &= kp <= qp
    if window is not None:
        m &= kp > qp - window
    n_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    return n_bytes, 4 * b * h * d * int(m.sum())


def attn_bound(q, k, v, causal, window):
    """Each input read once and the output written once, against 4 flops
    (QK^T and PV, a multiply and an add each) per head dim and per
    unmasked (query, key) pair, at the tensor-core rate for bf16 inputs
    and the CUDA-core rate for float32."""
    n_bytes, n_ops = attn_bound_terms(q, k, v, causal, window)
    rate = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else F32_OPS_PER_S
    return bound_ms(n_bytes, n_ops, rate)


def attn_lse_bound(q, k, v, causal, window):
    """``attn_bound`` of the training forward, which also writes each
    row's lse and, for bf16 inputs, the float32 output (4 bytes each)."""
    n_bytes, n_ops = attn_bound_terms(q, k, v, causal, window)
    b, t, h, _ = q.shape
    n_bytes += 4 * b * h * t
    if q.dtype == torch.bfloat16:
        n_bytes += 4 * q.numel()
    rate = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else F32_OPS_PER_S
    return bound_ms(n_bytes, n_ops, rate)


def bf16_grad_repair(flash_attention, ref) -> list:
    """The bf16 backward fed the forward's bf16 output (before the repair)
    and its float32 output (after), and autograd through the plain
    attention, each against the exact gradient of the same bf16 inputs
    (the plain formula in float32 from the float32 output), as a share of
    each gradient's largest magnitude: at the llama train shape and
    whisper's encoder and cross shapes, and at the last two again with q
    scaled by REPAIR_PEAK; at h2o-danube's training shape (the plain side
    on plain_parts), qwen2-vl's prefill shape, and the training shapes of
    mixtral (on plain_parts) and zamba2.  After the repair each must be
    within 2^-8;
    before it, the peaked cases must not (the control)."""
    rows = []
    for name, shape, peak in (
            ("llama train", (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 32, 8, 64,
                             True, None, torch.bfloat16), None),
            ("whisper encoder", WHISPER_ATTN[0], None),
            ("whisper cross", WHISPER_ATTN[2], None),
            ("whisper encoder, peaked", WHISPER_ATTN[0], REPAIR_PEAK),
            ("whisper cross, peaked", WHISPER_ATTN[2], REPAIR_PEAK),
            ("h2o-danube train shape, plain on 2 x 8 of its 32 heads",
             H2O_TRAIN_ATTN, None),
            ("qwen2-vl prefill shape", QWEN_ATTN, None),
            ("mixtral train shape, plain on 2 x 12 of its 48 heads",
             MIXTRAL_TRAIN_ATTN, None),
            ("zamba2 train shape", ZAMBA_TRAIN_ATTN, None)):
        b, t, s, h, kv, d, causal, window, dtype = shape
        q, k, v = attn_inputs(b, t, s, h, kv, d, dtype)
        if peak is not None:
            q = (q.float() * peak).to(dtype)
        do = upstream_grad(q)
        o, lse, o32 = flash_attention.flash_attention_fwd(
            q, k, v, causal=causal, window=window)
        from_bf16 = flash_attention.flash_attention_bwd(
            q, k, v, o, lse, do, causal=causal, window=window)
        from_f32 = flash_attention.flash_attention_bwd(
            q, k, v, o32, lse, do, causal=causal, window=window)
        before, after, plain = [0.0] * 3, [0.0] * 3, [0.0] * 3
        for part in plain_parts(shape):
            qp, dop = part_of(part, q), part_of(part, do)
            kp, vp = part_of(part, k, True), part_of(part, v, True)
            f = [x.float() for x in (qp, kp, vp, dop)]
            _, lse_x, o_x = ref.attention_lse(*f[:3], causal=causal,
                                              window=window)
            exact = ref.attention_bwd(*f[:3], o_x, lse_x, f[3],
                                      causal=causal, window=window)

            def shares(got):
                return [max_abs_err([g], [e]) / float(e.abs().max())
                        for g, e in zip(got, exact)]

            qa, ka, va = (x.detach().requires_grad_(True)
                          for x in (qp, kp, vp))
            got_plain = torch.autograd.grad(
                ref.attention(qa, ka, va, causal=causal, window=window),
                (qa, ka, va), dop)
            before = list(map(max, before,
                              shares(grads_part(part, from_bf16))))
            after = list(map(max, after, shares(grads_part(part, from_f32))))
            plain = list(map(max, plain, shares(got_plain)))
            del qp, kp, vp, dop, f, o_x, lse_x, exact, qa, ka, va, got_plain
            torch.cuda.empty_cache()
        torch.cuda.synchronize()
        tol = FLASH_BWD_RTOL[dtype]
        check(max(after) <= tol, f"flash_attention_bwd from the float32 O "
              f"at {name}: dq, dk, dv {after} of the exact gradient's "
              f"scale > 2^-8")
        if peak is not None:
            check(max(before) > tol, f"flash_attention_bwd from the bf16 O "
                  f"at {name}: dq, dk, dv {before} of the exact gradient's "
                  f"scale, all within 2^-8: the control shows no fault")
        rows.append({"shape": name, "q": [b, t, h, d], "kv": [b, s, kv, d],
                     "causal": causal, "window": window, "q_scale": peak,
                     "bf16_o_share": before, "f32_o_share": after,
                     "plain_autograd_share": plain, "tol_share": tol})
        del q, k, v, do, o, o32, lse, from_bf16, from_f32
        torch.cuda.empty_cache()
    return rows


def float32_o_cost(flash_attention) -> dict:
    """What the float32 O costs on the card, at the llama train shape and
    whisper's encoder shape: the backward from the bf16 O against the
    float32 O, and the training forward with its float32 O against the
    same launch given no o32 pointer (it then writes the bf16 output and
    lse only; called through the C entry point, so not counted as a
    launch).  Device ms from the profiler, in turns (A B C D D C B A,
    three rounds): each one's times and median."""
    import math
    import statistics

    from repro_torch.kernels import _build

    stream = torch.cuda.current_stream().cuda_stream
    entry = _build.entry("flash_attention_lse_launch",
                         flash_attention._LSE_ARGTYPES)
    out = {}
    for name, (b, t, s, h, kv, d, causal) in (
            ("llama train", (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 32, 8, 64,
                             True)),
            ("whisper encoder", (SERVE_BATCH, WHISPER_FRAMES,
                                 WHISPER_FRAMES, 16, 16, 64, False))):
        q, k, v = attn_inputs(b, t, s, h, kv, d, torch.bfloat16)
        do = upstream_grad(q)
        o, lse, o32 = flash_attention.flash_attention_fwd(q, k, v,
                                                          causal=causal)
        bare_o, bare_lse = torch.empty_like(o), torch.empty_like(lse)

        def fwd_without_o32():
            code = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         bare_o.data_ptr(), None, bare_lse.data_ptr(), b, t,
                         s, h, kv, d, int(causal), -1, 1, 1.0 / math.sqrt(d),
                         0.0, stream)
            check(code == 0, f"flash_attention_lse_launch without o32: "
                  f"error {code}")

        fwd_without_o32()
        torch.cuda.synchronize()
        check(torch.equal(bare_o, o) and torch.equal(bare_lse, lse),
              f"{name}: the forward without o32 gives another output or lse")
        runs = {
            "fwd_with_f32_o": (lambda: flash_attention.flash_attention_fwd(
                q, k, v, causal=causal), "flash_bf16_kernel"),
            "fwd_without_f32_o": (fwd_without_o32, "flash_bf16_kernel"),
            "bwd_from_f32_o": (lambda: flash_attention.flash_attention_bwd(
                q, k, v, o32, lse, do, causal=causal), "flash_bwd"),
            "bwd_from_bf16_o": (lambda: flash_attention.flash_attention_bwd(
                q, k, v, o, lse, do, causal=causal), "flash_bwd")}
        times = {n: [] for n in runs}
        for _ in range(3):
            for n in list(runs) + list(runs)[::-1]:
                times[n].append(device_ms(runs[n][0], 20, runs[n][1])[0])
        med = {n: statistics.median(x) for n, x in times.items()}
        out[name] = {"q": [b, t, h, d], "kv": [b, s, kv, d],
                     "causal": causal, "ms": times, "median_ms": med,
                     "fwd_f32_o_ms": med["fwd_with_f32_o"]
                     - med["fwd_without_f32_o"],
                     "bwd_f32_o_ms": med["bwd_from_f32_o"]
                     - med["bwd_from_bf16_o"]}
        del q, k, v, do, o, lse, o32, bare_o, bare_lse
    return out


def upstream_grad(like, seed: int = SEED + 3):
    """A random upstream gradient of ``like``'s shape, dtype and device."""
    g = torch.Generator(device=like.device).manual_seed(seed)
    return torch.randn(like.shape, generator=g, device=like.device).to(
        like.dtype)


def scan_inputs(b, t, d, n):
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    delta = torch.nn.functional.softplus(rn(b, t, d))
    return delta, rn(b, t, d), rn(b, t, n), rn(b, t, n), -torch.exp(
        rn(d, n) * 0.3)


def scan_bound(delta, b):
    """delta and x read and y written (4 B each per (b, t, d)), b and c
    read, a read and h_final written; 7 float32 operations per (b, t, d,
    n): delta*a, exp, *h, (delta x)*B, +, and the multiply-add into y."""
    bs, t, d = delta.shape
    n = b.shape[-1]
    n_bytes = 4 * (3 * bs * t * d + 2 * bs * t * n + d * n + bs * d * n)
    return bound_ms(n_bytes, 7 * bs * t * d * n, F32_OPS_PER_S)


def flash_bwd_bound(q, k, v, causal, window):
    """q, k, v and dO read once, o (float32, as the training path hands it
    over) read once, lse and D (float32 a row and head) read once, dq, dk
    and dv written once, against 10 flops (QK^T, dO V^T, P^T dO, dS^T Q,
    dS K: a multiply and an add each) per head dim and per unmasked
    (query, key) pair, at the tensor-core rate for bf16 inputs and the
    CUDA-core rate for float32."""
    b, t, h, d = q.shape
    _, fwd_ops = attn_bound_terms(q, k, v, causal, window)
    n_bytes = (3 * q.numel() + 4 * k.numel()) * q.element_size() \
        + 4 * q.numel() + 2 * 4 * b * h * t
    n_ops = fwd_ops // 4 * 10
    rate = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else F32_OPS_PER_S
    return bound_ms(n_bytes, n_ops, rate)


def scan_bwd_bound(delta, b, with_dh):
    """delta, x, dy read and ddelta, dx written (4 B each per (b, t, d)),
    b, c read and db, dc written, a read and da written, dh_final read if
    given; about 12 float32 operations per (b, t, d, n) (the two recurrences
    and the five gradient terms)."""
    bs, t, d = delta.shape
    n = b.shape[-1]
    n_bytes = 4 * (5 * bs * t * d + 4 * bs * t * n + 2 * d * n
                   + (bs * d * n if with_dh else 0))
    return bound_ms(n_bytes, 12 * bs * t * d * n, F32_OPS_PER_S)


def search_inputs(rng, b, parts):
    """Root directories as an indexed store holds them: sorted partition
    minima of visitDate-like keys, with duplicates (so some minima equal
    the range's bound)."""
    mins = np.sort(rng.integers(3500, 6000, (b, parts)) * 2, axis=1)
    return torch.from_numpy(mins.astype(np.int32)).cuda()


def search_bound(mins):
    """Each minimum read once, the pair and the (blocks, 2) output; two
    compares a minimum."""
    b, parts = mins.shape
    return bound_ms(4 * b * parts + 8 + 8 * b, 2 * b * parts)


def scan_block_inputs(rng, rows, n_cols, dtype):
    keys = rng.integers(0, 10000, rows).astype(np.int32)
    proj = rng.integers(-2**31, INT32_MAX, (rows, n_cols)).astype(np.int32)
    proj = torch.from_numpy(proj).cuda()
    if dtype == torch.float32:   # any 32-bit pattern, NaNs included
        proj = proj.view(torch.float32)
    return torch.from_numpy(keys).cuda(), proj


def pax_bound(keys, proj, mask, tile):
    """The keys, the projection of the kept rows and the pair read; the
    mask, the output and the per-tile counts written; two compares a row."""
    rows, n_cols = proj.shape
    kept = int(mask.sum())
    n_bytes = (4 * rows + 4 * n_cols * kept + 8
               + rows + 4 * n_cols * rows + 4 * (rows // tile))
    return bound_ms(n_bytes, 2 * rows)


def bits(t):
    """A tensor's 32-bit words, so float outputs compare bit for bit."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def max_abs_err(got, want) -> float:
    return max(float((g.to(torch.float64) - w.to(torch.float64)).abs().max())
               if g.numel() else 0.0 for g, w in zip(got, want))


def grad_shares(got, want) -> list:
    """Each gradient's max abs error as a share of its reference's largest
    magnitude."""
    return [max_abs_err([g], [w]) / max(float(w.float().abs().max()), 1e-30)
            for g, w in zip(got, want)]


def plain_parts(shape) -> list:
    """The (prompts, heads, KV heads) slices on which an attention kernel
    launched at ``shape`` is held to its plain version: the whole, except
    at h2o-danube's two long shapes (H2O_PLAIN_HEADS), the prefill shapes
    of arctic and zamba2 (the first and last prompt) and mixtral's two
    (12 of 48 heads, on the first and last prompt)."""
    b, _, _, h, kv = shape[:5]
    every = slice(None)
    if shape in (H2O_PREFILL_ATTN, ARCTIC_PREFILL_ATTN, ZAMBA_PREFILL_ATTN):
        return [(slice(i, i + 1), every, every) for i in (0, b - 1)]
    if shape == H2O_TRAIN_ATTN:
        g, gk = H2O_PLAIN_HEADS, H2O_PLAIN_HEADS * kv // h
        return [(every, slice(0, g), slice(0, gk)),
                (every, slice(h - g, h), slice(kv - gk, kv))]
    if shape in (MIXTRAL_PREFILL_ATTN, MIXTRAL_TRAIN_ATTN):
        # the first and last 2 of 8 KV heads (12 of 48 query heads), on
        # the first and last prompt
        g, gk = 2 * h // kv, 2
        return [(slice(0, 1), slice(0, g), slice(0, gk)),
                (slice(b - 1, b), slice(h - g, h), slice(kv - gk, kv))]
    return [(every, every, every)]


def plain_note(shape) -> str:
    """Where the plain version holds the kernel at ``shape``, when not on
    the whole: " (plain on prompts i-j heads k-l; ...)"."""
    parts = plain_parts(shape)
    if len(parts) == 1:
        return ""

    def span(s):
        return "all" if s == slice(None) else f"{s.start}-{s.stop - 1}"
    return " (plain on " + "; ".join(f"prompts {span(bs)} heads {span(hs)}"
                                     for bs, hs, _ in parts) + ")"


def part_of(part, x, kv=False):
    """``x`` (B, T, H, D), or lse (B, H, T) when 3-d, on ``part``'s prompts
    and heads (its KV heads if ``kv``), contiguous."""
    bs, hs, ks = part
    if x.dim() == 3:
        return x[bs, hs].contiguous()
    return x[bs, :, ks if kv else hs].contiguous()


def grads_part(part, grads):
    """dq, dk, dv on ``part``."""
    return [part_of(part, g, kv) for g, kv in zip(grads, (False, True, True))]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_kernels(rng):
    from repro_torch.kernels import (block_sort, flash_attention, hail_reader,
                                     index_search, pax_scan, ref,
                                     selective_scan)

    reader_cases = []
    # the server's batches read (visitDate, sourceIP, __rowid__): C = 3; then
    # the kernel's edges: an odd Q (mask rows off 16-byte boundaries), Q =
    # 1,500 at a small R (more queries than shared memory stages), C = 1, R
    # not a multiple of 16 or of the tile, an out-of-order root directory
    # (corrupt_root's wrap) at the server's shape, and inputs that are
    # views off 16-byte boundaries
    for b, rows, parts, q, mix, c, kind in [
            (16, ROWS, 512, 1, True, 2, "sorted"),
            (16, ROWS, 512, 8, True, 2, "sorted"),
            (2, ROWS, 512, 8, False, 3, "sorted"),
            (16, ROWS, 512, 1, False, 2, "sorted"),
            (1, ROWS, 512, 1, True, 2, "sorted"),
            (2, ROWS, 512, 1, False, 2, "sorted"),
            (4, 1024, 8, 1, True, 2, "sorted"),
            (4, 1024, 8, 8, True, 2, "sorted"),
            (3, 4096, 8, 3, True, 2, "sorted"),
            (2, 4096, 8, 1500, True, 3, "sorted"),
            (4, ROWS, 512, 8, True, 1, "sorted"),
            (3, 1000, 8, 5, True, 3, "sorted"),
            (2, ROWS, 512, 8, True, 3, "shifted"),
            (3, 1000, 8, 9, True, 3, "offset")]:
        uidx = (np.arange(b) % 3 != 2) if mix else np.zeros(b, bool)
        inputs = reader_inputs(rng, b, rows, parts, c, q, uidx, kind=kind)
        ps = rows // parts
        got = hail_reader.hail_read_batch(*inputs, partition_size=ps)
        want = ref.hail_read_batch(*inputs, partition_size=ps)
        torch.cuda.synchronize()
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        check(equal, f"hail_read kernel == plain at B={b} R={rows} Q={q} "
              f"C={c} {kind}")
        reader_cases.append({"blocks": b, "rows": rows, "parts": parts,
                             "cols": c, "queries": q, "mixed_index": mix,
                             "inputs": kind,
                             "rows_kept": int(got[0].any(-1).sum()),
                             "max_abs_err": max_abs_err(got, want)})
        del inputs, got, want
    sort_cases = []
    # the main path's shapes (a repaired block, an adaptive build, a donor
    # replica of add_replica), then one tile padded (n < 4096), one tile,
    # several, a block of one key and keys over all of int32
    for b, n, kind in [(1, ROWS, "dupes"), (16, ROWS, "dupes"),
                       (BLOCKS, ROWS, "dupes"),
                       (4, 1024, "dupes"), (3, 2, "dupes"), (2, 64, "full"),
                       (1, 4096, "dupes"), (2, 8192, "equal"),
                       (2, 1 << 16, "full")]:
        keys = sort_inputs(rng, b, n, kind)
        got = block_sort.bitonic_sort(keys)
        want = block_sort.bitonic_sort_plain(keys)
        lib = ref.sort_by_key(keys)
        torch.cuda.synchronize()
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"bitonic_sort kernel == plain at ({b}, {n}) {kind}")
        check(all(torch.equal(g, w) for g, w in zip(got, lib)),
              f"bitonic_sort kernel == stable argsort at ({b}, {n}) {kind}")
        sort_cases.append({"blocks": b, "n": n, "keys": kind,
                           "max_abs_err": max_abs_err(got, want)})
    search_cases = []
    for b, parts in [(BLOCKS, 512), (3, 8), (5, 64), (13, 7), (1, 1),
                     (9, 33)]:
        mins = search_inputs(rng, b, parts)
        flat = mins.flatten().cpu().numpy()
        # a bound equal to a minimum, below all, above all, lo > hi, and
        # the range as device scalars (no host sync)
        ranges = [(int(flat[len(flat) // 2]), int(flat[len(flat) // 2]) + 300),
                  (10000, 10155), (-50, 6999), (12001, 20000), (9000, 8000),
                  (-2**31, INT32_MAX),
                  (torch.tensor(8000, device="cuda"),
                   torch.tensor(9000, device="cuda"))]
        for lo, hi in ranges:
            got = index_search.index_search(mins, lo, hi)
            want = index_search.index_search_plain(mins, lo, hi)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"index_search kernel == plain at {(b, parts)} "
                  f"lo={int(lo)} hi={int(hi)}")
        search_cases.append({"blocks": b, "parts": parts,
                             "ranges": len(ranges),
                             "max_abs_err": max_abs_err([got], [want])})
    pax_cases = []
    for rows, n_cols, tile, dtype in [(ROWS, 2, 1024, torch.int32),
                                      (ROWS, 3, 1024, torch.float32),
                                      (1000, 3, 1024, torch.int32),
                                      (1031, 1, 1024, torch.float32),
                                      (2048, 4, 256, torch.int32),
                                      (300, 5, 64, torch.float32)]:
        keys, proj = scan_block_inputs(rng, rows, n_cols, dtype)
        for lo, hi in [(2000, 4999), (5000, 5000), (9000, 100),
                       (-2**31, INT32_MAX)]:
            got = pax_scan.pax_scan(keys, proj, lo, hi, row_tile=tile)
            want = pax_scan.pax_scan_plain(keys, proj, lo, hi, row_tile=tile)
            torch.cuda.synchronize()
            check(all(torch.equal(bits(g), bits(w))
                      for g, w in zip(got, want)),
                  f"pax_scan kernel == plain at rows={rows} C={n_cols} "
                  f"tile={tile} {dtype} lo={lo} hi={hi}")
        pax_cases.append({"rows": rows, "cols": n_cols, "tile": tile,
                          "dtype": str(dtype), "tiles": int(got[2].numel()),
                          "max_abs_err": max_abs_err(
                              [bits(g) for g in got],
                              [bits(w) for w in want])})
    flash_cases = []
    for shape in [
            (4, 512, 512, 32, 8, 64, True, None, torch.bfloat16),  # llama
            (2, 128, 128, 4, 4, 32, False, None, torch.float32),
            (1, 256, 256, 2, 2, 32, True, 32, torch.float32),
            (2, 100, 100, 4, 2, 16, True, None, torch.float32),   # ragged
            (2, 100, 77, 4, 2, 64, False, 24, torch.float32),
            (1, 300, 300, 4, 1, 64, True, 128, torch.bfloat16),
            # the tensor-core path at every head dim, ragged T and S,
            # non-causal and windowed, and rows with no key in their band
            (2, 128, 128, 4, 4, 32, False, None, torch.bfloat16),
            (1, 256, 256, 2, 2, 32, True, 32, torch.bfloat16),
            (2, 100, 100, 4, 2, 16, True, None, torch.bfloat16),
            (2, 100, 77, 4, 2, 16, False, 24, torch.bfloat16),
            (2, 100, 77, 4, 2, 64, False, 24, torch.bfloat16),
            (1, 70, 130, 4, 1, 32, False, None, torch.bfloat16),
            (1, 200, 50, 2, 1, 64, True, 16, torch.bfloat16),
            (1, 200, 50, 2, 1, 64, True, 16, torch.float32),
            *WHISPER_ATTN,
            # head dims 80 (h2o-danube) and 128 (qwen2-vl): GQA 32/8 and
            # 64/8, T and S off the 64-row tiles, T != S, causal,
            # non-causal and windowed with a window shorter than T, and
            # rows with no key in their band; then the main paths' shapes
            (2, 100, 100, 32, 8, 80, True, None, torch.bfloat16),
            (2, 100, 77, 4, 2, 80, False, 24, torch.bfloat16),
            (1, 300, 300, 32, 8, 80, True, 128, torch.bfloat16),
            (1, 200, 50, 4, 1, 80, True, 16, torch.bfloat16),
            (1, 70, 130, 64, 8, 128, False, None, torch.bfloat16),
            (2, 97, 161, 64, 8, 128, True, None, torch.bfloat16),
            (1, 300, 300, 8, 1, 128, True, 100, torch.bfloat16),
            (2, 100, 77, 4, 2, 80, False, 24, torch.float32),
            (1, 300, 300, 32, 8, 80, True, 128, torch.float32),
            (2, 97, 161, 64, 8, 128, True, None, torch.float32),
            (1, 200, 50, 2, 1, 128, True, 16, torch.float32),
            QWEN_ATTN, H2O_PREFILL_ATTN,
            # head dim 256 (gemma3) in bf16 and float32: causal, windowed
            # with a window shorter than T, non-causal, T != S, ragged,
            # GQA 2:1, rows with no key in their band; softcap at D = 64
            # and 256; then gemma3's prefill shapes, global and local
            *GEMMA_D256_CASES,
            GEMMA4_PREFILL_ATTN, GEMMA4_PREFILL_LOCAL_ATTN,
            GEMMA12_PREFILL_ATTN, GEMMA12_PREFILL_LOCAL_ATTN,
            # GQA 48/8, 56/8 and 32/32 (mixtral, arctic, zamba2's shared
            # block), then the three models' prefill shapes
            *MOE_HYBRID_CASES, MIXTRAL_PREFILL_ATTN, ARCTIC_PREFILL_ATTN,
            ZAMBA_PREFILL_ATTN]:
        b, t, s, h, kv, d, causal, window, dtype, *cap = shape
        cap = cap[0] if cap else None
        q, k, v = attn_inputs(b, t, s, h, kv, d, dtype)
        got = flash_attention.flash_attention(q, k, v, causal=causal,
                                              window=window, softcap=cap)
        err = 0.0
        for part in plain_parts(shape):
            want = ref.attention(part_of(part, q), part_of(part, k, True),
                                 part_of(part, v, True), causal=causal,
                                 window=window, softcap=cap)
            err = max(err, max_abs_err([part_of(part, got)], [want]))
            del want
        torch.cuda.synchronize()
        case = f"q {(b, t, h, d)} k/v {(b, s, kv, d)} {dtype} " \
               f"causal={causal} window={window}" \
               + (f" softcap={cap}" if cap else "")
        case += plain_note(shape)
        check(err <= FLASH_TOL[dtype], f"flash_attention kernel == plain "
              f"at {case}: {err} > {FLASH_TOL[dtype]}")
        flash_cases.append({"case": case, "max_abs_err": err,
                            "tol": FLASH_TOL[dtype]})
        del q, k, v, got
    scan_cases = []
    for b, t, d, n in [(SERVE_BATCH, SERVE_PROMPT, 8192, 16),  # falcon-mamba
                       (2, 100, 300, 8), (1, 70, 130, 5)]:
        inputs = scan_inputs(b, t, d, n)
        got = selective_scan.selective_scan(*inputs)
        want = ref.selective_scan(*inputs)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        tol = SCAN_RTOL * max(1.0, max(float(w.abs().max()) for w in want))
        check(err <= tol, f"selective_scan kernel == plain at "
              f"{(b, t, d, n)}: {err} > {tol}")
        scan_cases.append({"shape": [b, t, d, n], "max_abs_err": err,
                           "tol": tol})
        del inputs, got, want
    # the backward kernels, each held to its plain version on the same
    # inputs (the forward's own lse and its float32 output, as the
    # training path hands them over, for flash): at the llama train shape
    # in bf16 and f32, every head dim, ragged T and S, non-causal,
    # windowed and rows with no key in their band; then the edges of the
    # bf16 tensor-core kernels' 64-key and 64-row tiles: GQA 4:1 at T =
    # 100, T = 65 against S = 200, windows with empty rows at D = 16
    # (causal and not), T and S off the tiles, T < S causal; then
    # whisper's encoder, decoder self and cross shapes
    flash_bwd_cases = []
    for shape in [
            (4, 512, 512, 32, 8, 64, True, None, torch.bfloat16),  # llama
            (4, 512, 512, 32, 8, 64, True, None, torch.float32),
            (2, 128, 128, 4, 4, 32, False, None, torch.float32),
            (1, 256, 256, 2, 2, 32, True, 32, torch.float32),
            (2, 100, 100, 4, 2, 16, True, None, torch.float32),
            (2, 100, 77, 4, 2, 64, False, 24, torch.float32),
            (1, 200, 50, 2, 1, 64, True, 16, torch.float32),
            (1, 200, 50, 2, 1, 64, True, 16, torch.bfloat16),
            (2, 100, 77, 4, 2, 16, False, 24, torch.bfloat16),
            (1, 70, 130, 4, 1, 32, False, None, torch.bfloat16),
            (1, 300, 300, 4, 1, 64, True, 128, torch.bfloat16),
            (2, 100, 100, 8, 2, 32, True, None, torch.bfloat16),
            (2, 65, 200, 4, 2, 64, False, None, torch.bfloat16),
            (1, 200, 50, 4, 2, 16, True, 16, torch.bfloat16),
            (1, 150, 40, 2, 1, 16, False, 8, torch.bfloat16),
            (1, 130, 190, 4, 4, 64, False, 100, torch.bfloat16),
            (2, 97, 161, 4, 1, 32, True, None, torch.bfloat16),
            *WHISPER_ATTN,
            # head dims 80 and 128 as the forward's, and h2o-danube's
            # training shape (the plain side on plain_parts)
            (2, 100, 100, 32, 8, 80, True, None, torch.bfloat16),
            (2, 100, 77, 4, 2, 80, False, 24, torch.bfloat16),
            (1, 300, 300, 32, 8, 80, True, 128, torch.bfloat16),
            (1, 200, 50, 4, 1, 80, True, 16, torch.bfloat16),
            (1, 70, 130, 64, 8, 128, False, None, torch.bfloat16),
            (2, 97, 161, 64, 8, 128, True, None, torch.bfloat16),
            (1, 300, 300, 8, 1, 128, True, 100, torch.bfloat16),
            (2, 100, 77, 4, 2, 80, False, 24, torch.float32),
            (1, 300, 300, 32, 8, 80, True, 128, torch.float32),
            (2, 97, 161, 64, 8, 128, True, None, torch.float32),
            (1, 200, 50, 2, 1, 128, True, 16, torch.float32),
            QWEN_ATTN, H2O_TRAIN_ATTN,
            # head dim 256 as the forward's, and gemma3's training shapes
            *GEMMA_D256_CASES, GEMMA4_TRAIN_ATTN, GEMMA4_TRAIN_LOCAL_ATTN,
            # GQA 48/8, 56/8 and 32/32, and the training shapes of mixtral
            # (windowed, the plain side on plain_parts) and zamba2
            *MOE_HYBRID_CASES, MIXTRAL_TRAIN_ATTN, ZAMBA_TRAIN_ATTN]:
        b, t, s, h, kv, d, causal, window, dtype, *cap = shape
        cap = cap[0] if cap else None
        mask = dict(causal=causal, window=window, softcap=cap)
        q, k, v = attn_inputs(b, t, s, h, kv, d, dtype)
        do = upstream_grad(q)
        o, lse, o32 = flash_attention.flash_attention_fwd(q, k, v, **mask)
        got = flash_attention.flash_attention_bwd(q, k, v, o32, lse, do,
                                                  **mask)
        case = f"q {(b, t, h, d)} k/v {(b, s, kv, d)} {dtype} " \
               f"causal={causal} window={window}" \
               + (f" softcap={cap}" if cap else "")
        case += plain_note(shape)
        check(o32.dtype == torch.float32 and torch.equal(o32.to(dtype), o),
              f"flash forward's float32 output rounds to its output at "
              f"{case}")
        out_err = lse_err = abs_err = 0.0
        rel, rel_bf16 = [0.0] * 3, [0.0] * 3
        for part in plain_parts(shape):
            qp, kp, vp = (part_of(part, q), part_of(part, k, True),
                          part_of(part, v, True))
            o32p, lsep, dop = (part_of(part, o32), part_of(part, lse),
                               part_of(part, do))
            out_plain, lse_plain, _ = ref.attention_lse(qp, kp, vp, **mask)
            out_err = max(out_err, max_abs_err([part_of(part, o)],
                                               [out_plain]))
            lse_err = max(lse_err, float(
                ((lsep - lse_plain).abs()
                 / lse_plain.abs().clamp(min=1.0)).max()))
            del out_plain, lse_plain
            gotp = grads_part(part, got)
            # the plain version's float32 gradient (see FLASH_BWD_RTOL);
            # its gradient in q's dtype is reported beside it, unchecked:
            # two roundings may land a whole bf16 step apart
            want = ref.attention_bwd(qp.float(), kp.float(), vp.float(),
                                     o32p, lsep, dop.float(), **mask)
            rel = list(map(max, rel, grad_shares(gotp, want)))
            abs_err = max(abs_err, max_abs_err(gotp, want))
            del want
            want = ref.attention_bwd(qp, kp, vp, o32p, lsep, dop, **mask)
            rel_bf16 = list(map(max, rel_bf16, grad_shares(gotp, want)))
            del want
            del qp, kp, vp, o32p, lsep, dop, gotp
            torch.cuda.empty_cache()
        torch.cuda.synchronize()
        check(out_err <= FLASH_TOL[dtype], f"flash training forward == "
              f"plain at {case}: {out_err} > {FLASH_TOL[dtype]}")
        check(lse_err <= LSE_TOL, f"flash lse kernel == plain at {case}: "
              f"{lse_err} > {LSE_TOL} of its magnitude")
        check(max(rel) <= FLASH_BWD_RTOL[dtype], f"flash_attention_bwd "
              f"kernel == plain at {case}: dq, dk, dv {rel} of their scale "
              f"> {FLASH_BWD_RTOL[dtype]}")
        flash_bwd_cases.append({"case": case, "out_max_abs_err": out_err,
                                "lse_share": lse_err,
                                "max_abs_err": abs_err,
                                "share_of_scale": rel,
                                "share_of_plain_in_dtype": rel_bf16,
                                "tol_share": FLASH_BWD_RTOL[dtype]})
        del q, k, v, do, o, o32, got, lse
    # the backward also takes O in q's dtype (the D kernel's other path)
    q, k, v = attn_inputs(TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 32, 8, 64,
                          torch.bfloat16)
    do = upstream_grad(q)
    o, lse, _ = flash_attention.flash_attention_fwd(q, k, v)
    got = flash_attention.flash_attention_bwd(q, k, v, o, lse, do)
    want = ref.attention_bwd(q.float(), k.float(), v.float(), o, lse,
                             do.float())
    rel_bf16 = grad_shares(got, ref.attention_bwd(q, k, v, o, lse, do))
    torch.cuda.synchronize()
    rel = grad_shares(got, want)
    check(max(rel) <= FLASH_BWD_RTOL[torch.bfloat16], f"flash_attention_bwd "
          f"kernel == plain from a bf16 O: {rel} > 2^-8")
    flash_bwd_cases.append({"case": "llama train shape, O in bf16",
                            "max_abs_err": max_abs_err(got, want),
                            "share_of_scale": rel,
                            "share_of_plain_in_dtype": rel_bf16,
                            "tol_share": FLASH_BWD_RTOL[torch.bfloat16]})
    del q, k, v, do, o, lse, got, want
    repair = bf16_grad_repair(flash_attention, ref)
    # the scan's: every lane split (N = 1, 3, 5, 8, 16), D off the 128
    # channels a CTA (8192 + 32, 40) and T off the 16-step interval
    scan_bwd_cases = []
    for b, t, d, n, with_dh in [(SERVE_BATCH, SERVE_PROMPT, 8192, 16, False),
                                (SERVE_BATCH, SERVE_PROMPT, 8192, 16, True),
                                (2, 100, 300, 8, True), (1, 70, 130, 5, True),
                                (2, 37, 64, 1, True), (1, 33, 40, 3, False),
                                (2, 64, 8192 + 32, 16, True),
                                (2, 45, 40, 16, False)]:
        inputs = scan_inputs(b, t, d, n)
        dy = upstream_grad(inputs[0])
        dh = upstream_grad(inputs[0].new_empty((b, d, n))) if with_dh \
            else None
        got = selective_scan.selective_scan_bwd(*inputs, dy, dh)
        want = ref.selective_scan_bwd(*inputs, dy, dh)
        torch.cuda.synchronize()
        rel = [max_abs_err([g], [w]) / max(float(w.abs().max()), 1e-30)
               for g, w in zip(got, want)]
        check(max(rel) <= SCAN_BWD_RTOL, f"selective_scan_bwd kernel == "
              f"plain at {(b, t, d, n)} dh_final={with_dh}: ddelta, dx, "
              f"db, dc, da {rel} of their scale > {SCAN_BWD_RTOL}")
        scan_bwd_cases.append({"shape": [b, t, d, n], "dh_final": with_dh,
                               "max_abs_err": max_abs_err(got, want),
                               "share_of_scale": rel,
                               "tol_share": SCAN_BWD_RTOL})
        del inputs, got, want
    emit("kernels", reader=reader_cases, sort=sort_cases,
         index_search=search_cases, pax_scan=pax_cases, flash=flash_cases,
         scan=scan_cases, flash_bwd=flash_bwd_cases, scan_bwd=scan_bwd_cases,
         bf16_grad_repair=repair)
    return {name: max(c["max_abs_err"] for c in cases)
            for name, cases in (("hail_read", reader_cases),
                                ("bitonic_sort", sort_cases),
                                ("index_search", search_cases),
                                ("pax_scan", pax_cases),
                                ("flash_attention", flash_cases),
                                ("selective_scan", scan_cases),
                                ("flash_attention_bwd", flash_bwd_cases),
                                ("selective_scan_bwd", scan_bwd_cases))}


def phase_small_slice():
    """The whole slice at the test shape (4 blocks x 1024 rows, partition
    128, 6 nodes) on the card, against the same run on the CPU, where the
    plain versions serve: equal stores, rows and convergence."""
    from repro_torch.core import mapreduce as mr
    from repro_torch.core import query as q
    from repro_torch.core import schema as sc
    from repro_torch.core import store as st
    from repro_torch.core import upload as up
    from repro_torch.core.parse import format_rows

    cols = sc.gen_uservisits(4 * 1024, seed=7)
    raw = format_rows(sc.USERVISITS, cols, bad_fraction=0.002).reshape(
        4, 1024, -1)
    query = q.HailQuery(filter=QUICK, projection=("sourceIP",))
    runs = {}
    for dev in ("cuda", "cpu"):
        hail, _ = up.hail_upload(sc.USERVISITS, raw, list(KEYS),
                                 partition_size=128, n_nodes=6, device=dev)
        lazy, _ = up.hail_lazy_upload(sc.USERVISITS, raw, partition_size=128,
                                      n_nodes=6, device=dev)
        jobs = [mr.run_job(hail, query, reader="kernels"),
                mr.run_job(hail, query, reader="kernels", fail_node_at=0.5)]
        jobs += [mr.run_job(lazy, query, reader="kernels",
                            adaptive=mr.AdaptiveConfig(offer_rate=0.25))
                 for _ in range(6)]
        runs[dev] = ([(j.n_tasks, j.results["n_rows"], j.full_scan_blocks,
                       j.blocks_indexed,
                       [v.tolist() for v in j.results["sample"].values()])
                      for j in jobs],
                     st.store_to_numpy(lazy), st.store_to_numpy(hail))
    (jobs_g, lazy_g, hail_g), (jobs_c, lazy_c, hail_c) = \
        runs["cuda"], runs["cpu"]
    check(jobs_g == jobs_c, "small slice: card jobs == CPU jobs")
    for got, want in ((lazy_g, lazy_c), (hail_g, hail_c)):
        for rg, rc in zip(got["replicas"], want["replicas"]):
            for part in ("cols", "checksums"):
                for c in rc[part]:
                    check(np.array_equal(rg[part][c], rc[part][c]),
                          f"small slice: replica {part}[{c}] card == CPU")
            check(np.array_equal(rg["mins"], rc["mins"]),
                  "small slice: root directories card == CPU")
    emit("small_slice", jobs=len(jobs_g),
         curve=[j[2] for j in jobs_g[2:]], rows=jobs_g[0][1])


def profile_job(run, match: str | None = None) -> dict:
    """One more run of a job under the CUDA profiler and the port's span
    tracer: host wall, device-busy time (the sum of the device-side events:
    kernels and copies; they do not overlap on one stream, and where a mesh
    runs them on several streams the sum can exceed their union),
    the busiest of them, the device time and launches of the kernels whose
    name holds ``match``, and host time per traced span (the per-split and
    whole-job slices left out: they overlap the others).  Walls here include
    the profiler's own cost; the phases above report walls without it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import trace

    tracer = trace.install()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILER_SETTLE_S)
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        trace.uninstall()

    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_ms = sum(device_us(e) for e in events) / 1e3
    top = sorted(events, key=device_us, reverse=True)[:6]
    matched = [e for e in events if match is not None and match in e.key]
    spans: dict[str, float] = {}
    opened: dict[tuple, list] = {}
    for ev in tracer.events:
        key = (ev.get("tid"), ev.get("name"))
        if ev["ph"] == "B":
            opened.setdefault(key, []).append(ev["ts"])
        elif ev["ph"] == "E":
            spans[ev["name"]] = (spans.get(ev["name"], 0.0)
                                 + (ev["ts"] - opened[key].pop()) / 1e3)
        elif ev["ph"] == "X" and ev["name"] not in ("split", "job"):
            spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur"] / 1e3
    kernel_ms = sum(device_us(e) for e in matched) / 1e3
    # a run the profiler traced nothing of measures no busy time or idle
    # share (see device_ms)
    traced = bool(events)
    return {"wall_ms": wall * 1e3,
            "device_busy_ms": busy_ms if traced else None,
            "device_idle_share": (1.0 - busy_ms / (wall * 1e3)
                                  if traced else None),
            "top_device_ms": [[e.key[:160], device_us(e) / 1e3] for e in top],
            "kernel_device_ms": kernel_ms,
            "kernel_share_of_busy": kernel_ms / busy_ms if busy_ms else 0.0,
            # launches: each runs every kernel of its entry point once
            "kernel_calls": max((e.count for e in matched), default=0),
            "host_span_ms": spans}


def rowid_collector():
    from repro_torch.core import query as q
    parts = []

    def on_split(_k, res, _wall):
        parts.append(q.collect(res)["__rowid__"])

    return parts, on_split


def phase_two_kernel_read(store, query) -> dict:
    """The query read by the two standalone primitives on the eager store's
    real data: ``ops.index_search`` over every block's root directory on the
    filter column's replica, then ``ops.pax_scan`` over each block's
    selected partition range (rowid and the projected column).  Its kept
    rows, bad rows removed, must equal the fused reader's rows for the same
    blocks, and each block's tile counts must sum to its kept rows.
    Returns the launch counts of the read."""
    from repro_torch.core import query as q
    from repro_torch.core import schema as sc
    from repro_torch.kernels import ops

    col, lo, hi = query.filter
    (proj_col,) = query.projection
    qplan = q.plan(store, query)
    rid = int(qplan.replica_for_block[0])
    rep = store.replicas[rid]
    check(bool((qplan.replica_for_block == rid).all())
          and bool(np.asarray(qplan.index_scan, bool).all())
          and rep.sort_key == col,
          f"every block index-scans the {col} replica")
    bad = q._bad_mask(store, rid)
    ps, rows = store.partition_size, store.rows_per_block
    clear_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pr = ops.index_search(rep.mins, lo, hi).cpu()   # one sync, to slice
    kept, partitions = [], 0
    for b in range(store.n_blocks):
        p0, p1 = int(pr[b, 0]), int(pr[b, 1])
        partitions += p1 - p0 + 1
        r0, r1 = p0 * ps, min((p1 + 1) * ps, rows)
        proj = torch.stack([rep.cols[sc.ROWID][b, r0:r1],
                            rep.cols[proj_col][b, r0:r1]], dim=-1)
        mask, out, counts = ops.pax_scan(rep.cols[col][b, r0:r1], proj, lo,
                                         hi)
        check(int(counts.sum()) == int(mask.sum()),
              f"block {b}: tile counts sum to the kept rows")
        check(torch.equal(out[mask], proj[mask])
              and not bool(out[~mask].any()),
              f"block {b}: kept rows keep their projection, others are 0")
        kept.append(out[mask & ~bad[b, r0:r1], 0])
    two_ids = torch.sort(torch.cat(kept)).values
    torch.cuda.synchronize()
    two_s = time.perf_counter() - t0
    launches = dict(ops.KERNEL_LAUNCHES)
    t0 = time.perf_counter()
    res = q.read_hail_kernels(store, query, qplan)
    fused_ids = torch.sort(res.cols[sc.ROWID][res.mask]).values
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    check(torch.equal(two_ids, fused_ids),
          "two-kernel read rowid set == fused reader rowid set")
    check(launches.get("index_search", 0) == 1
          and launches.get("pax_scan", 0) == store.n_blocks,
          f"one index_search and one pax_scan a block: {launches}")
    emit("two_kernel", blocks=store.n_blocks, partitions_read=partitions,
         rows=int(two_ids.numel()), two_kernel_s=two_s,
         fused_reader_s=fused_s, launches=launches)
    return launches


SERVER_PROJ = ("visitDate", "sourceIP")


def server_queries() -> list:
    """Phase 5b's traffic: 8 narrow visitDate ranges of 4 tenants."""
    from repro_torch.core import query as q
    los = [7000, 7400, 8000, 9000, 10000, 10500, 11000, 11900]
    return [q.HailQuery(filter=("visitDate", lo, lo + 155 + 10 * i),
                        projection=SERVER_PROJ) for i, lo in enumerate(los)]


def phase_hail_server(store, query_rows) -> dict:
    """HAIL serving on the eager store: eight tenants' queries through
    ``HailServer`` flushes over both cache tiers, corruption found on the
    read path and by the scrubber and repaired bit for bit, then heat-driven
    replication adding a replica that an adaptive flush claims and builds
    on, and its decommission.  ``query_rows(query)`` gives a query's sorted
    row ids from its own ``run_job``.  Returns the kernel launches of the
    phase's flushes, repairs and replica transitions."""
    from repro_torch.core import checksum as ck
    from repro_torch.core import governor as gv
    from repro_torch.core import mapreduce as mr
    from repro_torch.core import query as q
    from repro_torch.core import schema as sc
    from repro_torch.core.fault import FaultInjector
    from repro_torch.kernels import ops
    from repro_torch.obs import trace
    from repro_torch.runtime.jobserver import (FlushPolicy, HailServer,
                                               ServerConfig, ServerFrontend)
    from repro_torch.runtime.scrubber import ScrubConfig, Scrubber

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    proj = SERVER_PROJ
    queries = server_queries()
    want = [query_rows(qq) for qq in queries]
    launches: dict[str, int] = {}
    walls: dict[str, float] = {}

    def server(**cfg) -> HailServer:
        """A server with fresh caches of both tiers."""
        store.block_cache = store.result_cache = None
        return HailServer(store, ServerConfig(max_batch=8, **cfg))

    def counted(name: str, fn):
        """Run ``fn`` with the launch counts set to 0; its wall (ending in
        a synchronize) lands in ``walls[name]``, its launches are added to
        the phase's and returned."""
        clear_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        got = dict(ops.KERNEL_LAUNCHES)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        return out, got

    def flush(name: str, srv, qs, **kw):
        tickets = [srv.submit(qq, tenant=f"tenant{i % 4}")
                   for i, qq in enumerate(qs)]
        with ops.stats_scope() as s:
            stats, got = counted(name, lambda: srv.flush(**kw))
        check(all(t.status == "done" for t in tickets), f"{name}: answered")
        return tickets, stats, got, s.dispatches

    def ids(t):
        return np.sort(t.result.rows[sc.ROWID])

    def same_answers(name, tickets):
        check(all(np.array_equal(ids(t), w) for t, w in zip(tickets, want)),
              f"{name}: every ticket's row ids == its own run_job's")

    # --- 1. cold flush: one shared scan, one reader launch per split ------
    srv = server()
    tickets, cold, got, _ = flush("cold", srv, queries)
    same_answers("cold flush", tickets)
    outer = [t.result.rows for t in tickets]
    check(cold.batch_sizes == [8], f"one batch of 8: {cold.batch_sizes}")
    check(got.get("hail_read", 0) == cold.n_splits > 0,
          f"one hail_read launch per (split, batch): {got} vs "
          f"{cold.n_splits} splits")
    # --- 2. tier 2: the same ranges and ranges inside them, no scan -------
    tickets, hits, got, _ = flush("result_hit", srv, queries)
    same_answers("result-cache flush", tickets)
    check(hits.result_cache_hits == 8 and got.get("hail_read", 0) == 0,
          f"the re-flush is answered by the result cache: {got}")
    inner = [q.HailQuery(filter=("visitDate", f[1] + 20, f[2] - 20),
                         projection=proj)
             for f in (qq.filter for qq in queries)]
    tickets, sub, got, _ = flush("subsumed", srv, inner)
    subsumed = srv.result_cache.stats.subsumed_hits
    for t, qq, rows in zip(tickets, inner, outer):
        keep = (rows["visitDate"] >= qq.filter[1]) & (
            rows["visitDate"] <= qq.filter[2])
        check(np.array_equal(ids(t), np.sort(rows[sc.ROWID][keep])),
              f"subsumed answer == the cold answer cut to {qq.filter}")
    check(sub.result_cache_hits == 8 and subsumed == 8
          and got.get("hail_read", 0) == 0,
          f"contained ranges are subsumed hits: {subsumed}, {got}")
    result_hit_rate = srv.result_cache.stats.hit_rate
    # --- 3. tier 1: a warm re-flush gathers from the block cache ----------
    srv = server(result_cache=False)
    flush("block_fill", srv, queries)
    tickets, warm, got, disp = flush("block_warm", srv, queries)
    same_answers("warm block-cache flush", tickets)
    check(warm.cache_misses == 0 and warm.cache_hits > 0
          and disp.get("verify_blocks", 0) == 0,
          f"every gather hits the block cache, no verify: "
          f"{warm.cache_hits} hits, {warm.cache_misses} misses, "
          f"{disp.get('verify_blocks', 0)} verifies")
    check(got.get("hail_read", 0) == warm.n_splits,
          "the warm flush still reads once per (split, batch)")
    block_hit_rate = srv.cache.stats.hit_rate
    # latency as ServerFrontend reports it for the eight queries
    fe = ServerFrontend(server(), FlushPolicy(window_s=0.05))

    def offer_all():
        for i, qq in enumerate(queries):
            fe.offer(qq, tenant=f"tenant{i % 4}", at=0.001 * i)
        fe.drain()

    counted("frontend", offer_all)
    check(len(fe.latencies) == 8 and not fe.failed,
          "the frontend answers the eight queries")
    profile = profile_job(lambda: flush("profiled", server(), queries),
                          match="reader_kernel")

    # --- 4. faults: read-path quarantine, scrubber, bit-exact repair ------
    rid = {k: store.replica_for(k) for k in ("visitDate", "sourceIP",
                                             "adRevenue")}
    n = store.n_blocks                   # blocks 5, 40, 17, 33 of 64
    targets = [(rid["visitDate"], n * 5 // 64), (rid["visitDate"], n * 5 // 8),
               (rid["sourceIP"], n * 17 // 64), (rid["adRevenue"], n * 33 // 64)]
    clones = {(r, b): ({c: v[b].clone() for c, v in
                        store.replicas[r].cols.items()},
                       store.replicas[r].mins[b].clone(),
                       {c: v[b].clone() for c, v in
                        store.replicas[r].checksums.items()})
              for r, b in targets}
    inj = FaultInjector(store, seed=SEED)
    events = [inj.corrupt_chunk(*targets[0], col="visitDate"),
              inj.corrupt_chunk(*targets[1], col="sourceIP"),
              inj.corrupt_root(*targets[2]),
              inj.truncate_checksums(*targets[3], col="adRevenue")]
    corrupted = {(e.replica_id, e.block_id) for e in events}
    tracer = trace.install()
    try:
        tickets, faulty, got_faulty, _ = flush("faulty", server(), queries)
        same_answers("flush over corrupt blocks", tickets)
        on_read = {(r, b) for r, b in corrupted
                   if store.is_quarantined(r, b)}
        check(on_read == set(targets[:2]) and faulty.blocks_quarantined == 2,
              f"the flush quarantines the visitDate replica's corrupt "
              f"blocks it reads: {sorted(on_read)}")
        scrubber = Scrubber(store, ScrubConfig(blocks_per_tick=64))
        pairs = len(store.live_replica_ids()) * store.n_blocks
        ticks = -(-pairs // 64)          # one revolution over every pair
        _, got_scrub = counted("scrub", lambda: [scrubber.tick()
                                                  for _ in range(ticks)])
        t_repaired = tracer.now_us()
    finally:
        trace.uninstall()
    quarantined = {(ev["args"]["replica"], ev["args"]["block"])
                   for ev in tracer.events if ev.get("name") == "quarantine"}
    first_quarantine = min(ev["ts"] for ev in tracer.events
                           if ev.get("name") == "quarantine")
    repair_s = sum(ev["dur"] for ev in tracer.events
                   if ev.get("name") == "repair_blocks") / 1e6
    sstats = scrubber.stats
    check(quarantined == corrupted,
          f"quarantined pairs == corrupted pairs: {sorted(quarantined)}")
    check(sstats.blocks_repaired == 4 and not store.namenode.quarantined,
          f"all four repaired: {sstats}")
    for (r, b), (cols, mins, sums) in clones.items():
        rep = store.replicas[r]
        check(all(torch.equal(rep.cols[c][b], v) for c, v in cols.items())
              and torch.equal(rep.mins[b], mins)
              and all(torch.equal(rep.checksums[c][b], v)
                      for c, v in sums.items()),
              f"replica {r} block {b} repaired bit-equal to its clone")
    indexed = sum(store.replicas[r].block_indexed(b) for r, b in targets)
    check(got_scrub.get("bitonic_sort", 0) == 2 * indexed,
          f"two sort launches per repaired indexed block: {got_scrub}")
    del clones
    tickets, after, _, _ = flush("repaired", server(), queries)
    same_answers("flush after the repair", tickets)
    check(after.blocks_quarantined == 0 and not store.namenode.quarantined,
          "nothing quarantined after the repair")

    # --- 5. replication: a hot unindexed column earns a replica -----------
    ctl = gv.ReplicationController(store, gv.ReplicationConfig(
        max_replication=4, hot_misses=1, n_nodes=N_NODES))
    dq = [q.HailQuery(filter=("duration", 1000 * i, 1000 * i + 400),
                      projection=("duration",)) for i in range(4)]
    dur, dstats, _, _ = flush("duration", server(), dq)
    dwant = [ids(t) for t in dur]
    check(dstats.split_scan_modes and all(
        n_idx == 0 for n_idx, _ in dstats.split_scan_modes),
          "no replica indexes duration: every block full-scans")
    added, got_add = counted("add_replica", ctl.tick)
    check([(e.kind, e.column) for e in added] == [("add", "duration")],
          f"one tick adds one replica for duration: {added}")
    check(got_add.get("bitonic_sort", 0) == 1,
          f"one batched sort for the one donor replica: {got_add}")
    new_id = added[0].replica_id
    new, donor = store.replicas[new_id], store.replicas[0]
    perm = torch.sort(donor.cols[sc.ROWID], dim=-1, stable=True).indices
    for c, v in donor.cols.items():
        ref_col = torch.gather(v, 1, perm)
        check(torch.equal(new.cols[c], ref_col)
              and torch.equal(new.checksums[c],
                              ck.batched_chunk_checksums(ref_col)),
              f"added replica column {c} == donor permuted by the stable "
              f"sort of __rowid__, checksums recomputed")
        del ref_col
    del perm
    check(new.sort_key is None and not bool(new.mins.any()),
          "the added replica is unclaimed")
    adapt = server(adaptive=mr.AdaptiveConfig(offer_rate=0.25))
    dur2, astats, got_adapt, _ = flush("adaptive", adapt, dq)
    check(all(np.array_equal(ids(t), w) for t, w in zip(dur2, dwant)),
          "the adaptive flush's rows == the full scan's")
    check(new.sort_key == "duration" and astats.blocks_indexed > 0
          and int(new.indexed.sum()) == astats.blocks_indexed
          and got_adapt.get("bitonic_sort", 0) > 0,
          f"the adaptive flush claims the new replica and builds on it "
          f"with the sort kernel: {astats.blocks_indexed} blocks, "
          f"{got_adapt}")
    ctl.detach()
    mem_before = torch.cuda.memory_allocated()
    store.block_cache = store.result_cache = None
    store.decommission_replica(new_id)
    del new
    freed = mem_before - torch.cuda.memory_allocated()
    check(store.replicas[new_id].retired
          and store.live_replica_ids() == [0, 1, 2] and freed > 0,
          f"decommission frees the replica ({freed} bytes)")
    emit("hail_server", blocks=store.n_blocks, queries=len(queries),
         flush_s=walls, n_splits=cold.n_splits,
         latency_p50_s=fe.percentile_latency(50),
         latency_p99_s=fe.percentile_latency(99),
         result_cache_hit_rate=result_hit_rate,
         block_cache_hit_rate=block_hit_rate,
         faults=[dataclasses.astuple(e) for e in events],
         quarantined_on_read=sorted(on_read),
         scrub_ticks=ticks, scrub=dataclasses.asdict(sstats),
         repair_s=repair_s, repair_bytes=sstats.bytes_rewritten,
         recover_s=(t_repaired - first_quarantine) / 1e6,
         add_replica_s=walls["add_replica"],
         adaptive_blocks_indexed=astats.blocks_indexed,
         decommission_freed_bytes=freed, launches=launches,
         peak_mem_bytes=torch.cuda.max_memory_allocated(),
         profile=profile, seconds=time.perf_counter() - t_phase)
    return launches


def phase_wave(store, raw, query, eager_ids) -> dict:
    """The multi-device wave dispatch on the eager store, with meshes of
    slots on the one card: a (1,) mesh takes the per-split path (rows,
    bytes, counters and launches equal); a (4,) mesh of four streams on
    cuda:0 reads the 40 splits in 10 waves, one launch a split, with the
    per-split row ids, fractions and bytes and the scan-mode counters of
    the per-split job (three runs, to catch a stream race), also under a
    node failure; two adaptive jobs on a lazy store; a HailServer cold
    flush of phase 5b's queries; ``spmd_aggregate`` of adRevenue by
    countryCode.  Returns the kernel launches of the compared runs."""
    from repro_torch.core import mapreduce as mr
    from repro_torch.core import query as q
    from repro_torch.core import schema as sc
    from repro_torch.core import upload as up
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.jobserver import HailServer, ServerConfig

    t_phase = time.perf_counter()
    # the scrubber phase 5b attached ticks at every job boundary, and its
    # cursor moves: its verification counts would differ job to job
    store.scrubber = None
    launches: dict[str, int] = {}
    mesh1 = make_mesh((1,), ("data",), devices=["cuda:0"])
    mesh4 = make_mesh((4,), ("data",), devices=["cuda:0"] * 4)

    def job(st, mesh=None, **kw):
        """-> (JobStats, per split (sorted row ids, fractions, bytes),
        reader counters, kernel launches), from cold caches."""
        st.block_cache = st.result_cache = None
        splits = []

        def on_split(_k, res, _wall):
            splits.append((np.sort(q.collect(res)[sc.ROWID]),
                           res.rows_read_frac.cpu().numpy(),
                           float(res.bytes_read)))

        clear_launches()
        with ops.stats_scope() as s:
            stats = mr.run_job(st, query, reader="kernels", mesh=mesh,
                               on_split_complete=on_split, **kw)
        torch.cuda.synchronize()
        got = dict(ops.KERNEL_LAUNCHES)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        return stats, splits, dict(s.dispatches), got

    def rowids(run):
        return np.sort(np.concatenate([r for r, _, _ in run[1]]))

    def same_splits(name, a, b):
        check(len(a[1]) == len(b[1]) and all(
            np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
            and x[2] == y[2] for x, y in zip(a[1], b[1])),
              f"{name}: per-split row ids, fractions and bytes == the "
              f"per-split job's")
        check(a[0].bytes_read == b[0].bytes_read
              and a[0].n_tasks == b[0].n_tasks
              and a[0].full_scan_blocks == b[0].full_scan_blocks
              and a[0].blocks_indexed == b[0].blocks_indexed,
              f"{name}: bytes, tasks, full-scan and indexed blocks")

    def sharded_counts(counts, n_splits):
        want = {k: v for k, v in counts.items()
                if k not in ("hail_read", "hail_read_batch")}
        want["hail_read_sharded_waves"] = -(-n_splits // 4)
        want["hail_read_sharded_splits"] = n_splits
        return want

    # --- 1. a (1,) mesh: the per-split path --------------------------------
    base = job(store)
    one = job(store, mesh1)
    same_splits("(1,) mesh", one, base)
    check(one[2] == base[2] and one[3] == base[3]
          and base[3].get("hail_read", 0) == base[0].n_tasks == 40,
          f"(1,) mesh: counters and launches == the per-split job's: "
          f"{one[3]} vs {base[3]}")
    # --- 2. a (4,) mesh: four streams on the card, three runs -------------
    runs = [job(store, mesh4) for _ in range(3)]
    for k, run in enumerate(runs):
        same_splits(f"(4,) mesh, run {k}", run, base)
        check(np.array_equal(rowids(run), eager_ids),
              f"(4,) mesh, run {k}: rowid set == the eager job's")
        check(run[2] == sharded_counts(base[2], 40)
              and run[2]["hail_read_sharded_waves"] == 10,
              f"(4,) mesh, run {k}: 10 waves, 40 splits, the per-split "
              f"job's scan-mode counters: {run[2]}")
        check(run[3].get("hail_read", 0) == 40,
              f"(4,) mesh, run {k}: one reader launch a split: {run[3]}")
    fail_base = job(store, fail_node_at=0.5)
    fail4 = job(store, mesh4, fail_node_at=0.5)
    same_splits("(4,) mesh, node failure", fail4, fail_base)
    check(np.array_equal(rowids(fail4), eager_ids)
          and fail4[0].rescheduled_tasks == fail_base[0].rescheduled_tasks
          > 0
          and fail4[2] == sharded_counts(fail_base[2], fail_base[0].n_tasks),
          f"(4,) mesh, node failure: rows, retries and counters: "
          f"{fail4[2]}")
    # --- 3. adaptive: two jobs on a lazy store each way -------------------
    cfg = mr.AdaptiveConfig(offer_rate=0.25)
    lazy_runs = {}
    for name, mesh in (("per_split", None), ("mesh4", mesh4)):
        lazy, _ = up.hail_lazy_upload(sc.USERVISITS, raw,
                                      partition_size=PARTITION,
                                      n_nodes=N_NODES)
        lazy_runs[name] = [job(lazy, mesh, adaptive=cfg) for _ in range(2)]
        del lazy
    for a, b in zip(lazy_runs["mesh4"], lazy_runs["per_split"]):
        same_splits("adaptive (4,) mesh", a, b)
        check(np.array_equal(rowids(a), eager_ids),
              "adaptive (4,) mesh: rowid set == the eager job's")
    adaptive_curve = [r[0].full_scan_blocks for r in lazy_runs["mesh4"]]
    check(adaptive_curve == [64, 48]
          and all(r[3].get("bitonic_sort", 0) > 0
                  for r in lazy_runs["mesh4"]),
          f"adaptive (4,) mesh: full scans (64, 48), builds sort with the "
          f"kernel: {adaptive_curve}")
    torch.cuda.empty_cache()
    # --- 4. HailServer: a cold flush of phase 5b's queries ----------------
    answers = {}
    for name, mesh in (("per_split", None), ("mesh4", mesh4)):
        store.block_cache = store.result_cache = None
        srv = HailServer(store, ServerConfig(max_batch=8, mesh=mesh,
                                             result_cache=False))
        tickets = [srv.submit(qq, tenant=f"tenant{i % 4}")
                   for i, qq in enumerate(server_queries())]
        clear_launches()
        stats = srv.flush()
        torch.cuda.synchronize()
        got = dict(ops.KERNEL_LAUNCHES)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        check(all(t.status == "done" for t in tickets)
              and got.get("hail_read", 0) == stats.n_splits,
              f"{name} flush: answered, one launch a split: {got}")
        answers[name] = (stats, [t.result.rows for t in tickets])
    (s0, rows0), (s4, rows4) = answers["per_split"], answers["mesh4"]
    check(all(set(a) == set(b) and all(np.array_equal(a[c], b[c])
                                       for c in a)
              for a, b in zip(rows0, rows4)),
          "(4,) mesh flush: every ticket's answer == the per-split flush's")
    check(s0.batch_of_split == s4.batch_of_split
          and s0.queries_of_split == s4.queries_of_split
          and s0.split_scan_modes == s4.split_scan_modes,
          "(4,) mesh flush: the same splits, members and scan modes")
    store.block_cache = store.result_cache = None
    # --- 5. spmd_aggregate: adRevenue by countryCode over replica 0 -------
    rep = store.replicas[0]
    good = ~q._bad_mask(store, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sums, cnts = mr.spmd_aggregate(mesh4, rep.cols["countryCode"],
                                   rep.cols["adRevenue"], good, 256)
    torch.cuda.synchronize()
    agg_s = time.perf_counter() - t0
    keys = rep.cols["countryCode"].cpu().numpy().reshape(-1)
    vals = rep.cols["adRevenue"].cpu().numpy().reshape(-1)
    m = good.cpu().numpy().reshape(-1)
    want_sums = np.bincount(keys[m] % 256, weights=vals[m].astype(np.float64),
                            minlength=256)
    want_cnts = np.bincount(keys[m] % 256, minlength=256)
    rel = float(np.max(np.abs(sums.cpu().numpy() - want_sums)
                       / np.maximum(np.abs(want_sums), 1.0)))
    check(np.array_equal(cnts.cpu().numpy(), want_cnts),
          "spmd_aggregate: counts exact")
    check(rel <= 1e-5, f"spmd_aggregate: sums within 1e-5 relative of "
                       f"float64 numpy: {rel}")
    # --- 6. walls and idle shares, one sample each ------------------------
    walls, profiles = {}, {}
    for name, mesh in (("per_split", None), ("mesh4", mesh4)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mr.run_job(store, query, reader="kernels", mesh=mesh)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        profiles[name] = profile_job(lambda: mr.run_job(
            store, query, reader="kernels", mesh=mesh), match="reader_kernel")
    emit("wave", mesh=str(mesh4), splits=base[0].n_tasks,
         waves=runs[0][2]["hail_read_sharded_waves"],
         rows=base[0].results["n_rows"],
         failover_tasks=fail4[0].n_tasks, adaptive_curve=adaptive_curve,
         flush_splits=s4.n_splits, flush_s={"per_split": s0.wall_s,
                                            "mesh4": s4.wall_s},
         aggregate_s=agg_s, aggregate_max_rel_err=rel,
         job_wall_s=walls, profile=profiles, launches=launches,
         nvidia_smi=nvidia_smi(), seconds=time.perf_counter() - t_phase)
    return launches


def phase_data_pipeline() -> dict:
    """The LM data pipeline at the served model's widths: a tokenized
    corpus of 2^15 documents, 513 tokens each (512-token batches plus the
    shifted label) from llama3.2-1b's vocabulary of 128,256, uploaded in
    blocks of 4,096 rows indexed on domain, quality and timestamp; training
    data selected by the indexed query domain = 3.  Returns the first
    (4, 512) batch, which phase 9 trains on."""
    from repro_torch.core import query as q
    from repro_torch.core import schema as sc
    from repro_torch.data import pipeline as pl

    t_phase = time.perf_counter()
    cfg = pl.CorpusConfig(n_docs=1 << 15, seq_width=513, rows_per_block=4096,
                          vocab=128_256, partition_size=256)
    select = ("domain", 3, 3)
    mem0 = torch.cuda.memory_allocated()
    store, upload = pl.build_corpus(cfg, seed=SEED)
    torch.cuda.synchronize()
    store_bytes = torch.cuda.memory_allocated() - mem0
    t0 = time.perf_counter()
    src = pl.HailDataSource(store, cfg, select=select, batch_size=4)
    torch.cuda.synchronize()
    select_s = time.perf_counter() - t0
    check(src.used_index, "the selection is an index scan")
    cols = sc.gen_tokens_corpus(cfg.n_docs, cfg.seq_width, cfg.vocab,
                                cfg.n_domains, SEED)
    res = q.read_hail(store, q.HailQuery(filter=select,
                                         projection=("doc_id",)),
                      q.plan(store, q.HailQuery(filter=select,
                                                projection=("doc_id",))))
    doc_ids = q.collect(res)["doc_id"]
    check(np.array_equal(np.sort(doc_ids), np.nonzero(cols["domain"] == 3)[0]),
          "selected doc ids == the generated columns' domain = 3")
    tokens = np.stack([cols[f"tok{i}"] for i in range(cfg.seq_width)], axis=1)
    check(src.tokens.dtype == torch.int32
          and torch.equal(src.tokens.cpu(), torch.from_numpy(tokens[doc_ids])),
          "each selected row's tokens == its document's generated tokens")
    batch = next(iter(src))
    draw = np.random.default_rng(0).integers(0, src.n_selected, 4)
    check(batch["tokens"].shape == (4, 512) and batch["tokens"].is_cuda
          and batch["tokens"].dtype == batch["labels"].dtype == torch.int32
          and torch.equal(batch["tokens"][:, 1:], batch["labels"][:, :-1])
          and torch.equal(batch["tokens"].cpu(),
                          torch.from_numpy(tokens[doc_ids[draw], :-1])),
          "first batch: (4, 512) int32 on the card, the drawn rows, labels "
          "shifted by one")
    emit("data_pipeline", docs=cfg.n_docs, seq_width=cfg.seq_width,
         vocab=cfg.vocab, blocks=store.n_blocks, selected=src.n_selected,
         used_index=src.used_index, upload_s=upload.wall_s,
         select_s=select_s, store_device_bytes=store_bytes,
         reduced=["n_docs 2^15 (depth only)"],
         seconds=time.perf_counter() - t_phase)
    return {k: v.contiguous() for k, v in batch.items()}


def share(got, want) -> dict:
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    return {"max_abs_err": err, "scale": scale, "share": err / scale}


def kernel_calls(cfg, tail: bool = True) -> int:
    """Mixer kernel launches in one forward of ``cfg``: one an attention
    or Mamba1 layer (the groups' and, with ``tail``, the tail's; a shared
    position as the shared block it runs), two a cross layer (its self-
    and cross-attention), none a Mamba2 layer (plain torch, as the JAX
    package runs it), and one an encoder layer."""
    def calls(lc):
        if lc.kind == "shared":
            lc = cfg.stack.shared
        if lc.kind == "mamba2":
            return 0
        return 2 if lc.attn is not None and lc.attn.cross else 1

    n = sum(calls(lc) * cfg.stack.n_groups for lc in cfg.stack.pattern)
    if tail:
        n += sum(calls(lc) for lc in cfg.stack.tail)
    return n + (cfg.encoder.n_layers if cfg.encoder is not None else 0)


def stack_layers(sc) -> list:
    """(layer config, group or None, key) of every layer of a stack, in the
    order ``apply_stack`` runs them: each group's pattern, then the
    tail."""
    return ([(lc, g, f"p{i}") for g in range(sc.n_groups)
             for i, lc in enumerate(sc.pattern)]
            + [(lc, None, f"t{i}") for i, lc in enumerate(sc.tail)])


class Routing:
    """Records every MoE routing decision (``models.moe.route``) made
    inside the block: the float32 logits, top_idx and pos of each call.
    Given the records of another run (``forced``), each call instead takes
    that run's top_idx and pos (its gates then the softmax of its own
    logits at those experts) and keeps its own decisions beside them
    ("own"), so two routes can be held to each other on one routing (see
    ROUTE_FLIPS_MAX).  A block without MoE layers records nothing."""

    def __init__(self, forced: list | None = None):
        self.forced = None if forced is None else list(forced)
        self.records: list = []

    def __enter__(self):
        from repro_torch.models import moe as moe_mod

        self.real = moe_mod.route

        def route(params, xg, cfg):
            logits, top_idx, gates, pos = self.real(params, xg, cfg)
            rec = {"logits": logits.detach(), "top_idx": top_idx,
                   "pos": pos, "cap": None}
            if self.forced is not None:
                want = self.forced.pop(0)
                rec["own"] = (top_idx, pos)
                top_idx, pos = want["top_idx"], want["pos"]
                gates = torch.softmax(logits.gather(-1, top_idx), dim=-1)
                rec["top_idx"], rec["pos"] = top_idx, pos
            rec["cap"] = moe_mod.capacity(cfg, xg.shape[1])
            self.records.append(rec)
            return logits, top_idx, gates, pos

        moe_mod.route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe as moe_mod

        moe_mod.route = self.real
        return False

    def flips(self, plain: list) -> dict:
        """Of a forced run against the run it was forced by (``plain``'s
        records): the tokens whose own top_idx differed ("flips"), their
        logit gaps (the k-th minus the (k+1)-th logit on the plain route)
        as shares of the logits' largest magnitude, and the assignments
        whose own keep differed ("keep_shifts")."""
        flips, gaps, shifts = 0, [], 0
        for rec, ref_rec in zip(self.records, plain):
            own_idx, own_pos = rec["own"]
            k = own_idx.shape[-1]
            moved = (own_idx != ref_rec["top_idx"]).any(-1)
            flips += int(moved.sum())
            shifts += int(((own_pos < rec["cap"])
                           != (ref_rec["pos"] < ref_rec["cap"])).sum())
            if bool(moved.any()):
                lg = ref_rec["logits"]
                top = torch.topk(lg, k + 1, dim=-1).values
                gap = (top[..., k - 1] - top[..., k])[moved]
                gaps += (gap / lg.abs().max()).tolist()
        return {"layers": len(self.records), "flips": flips,
                "gap_shares": gaps, "keep_shifts": shifts}


def check_routing(what: str, forced: "Routing", plain: list) -> dict | None:
    """The routing rule (ROUTE_FLIPS_MAX, ROUTE_GAP_SHARE) of a forced run;
    None where the block has no MoE layer."""
    if not plain:
        return None
    rec = forced.flips(plain)
    check(rec["flips"] <= ROUTE_FLIPS_MAX,
          f"{what}: {rec['flips']} tokens routed otherwise on the kernel "
          f"route > {ROUTE_FLIPS_MAX}")
    widest = max(rec["gap_shares"], default=0.0)
    check(widest <= ROUTE_GAP_SHARE,
          f"{what}: a token routed otherwise on the kernel route has a "
          f"logit gap of {widest} of the logits' scale > {ROUTE_GAP_SHARE}")
    return rec


def layer_routes(cfg, params, batch) -> dict:
    """Prefill layer by layer in float32 compute (the embedding scaled as
    the model scales it), the encoder's layers (if any) first, then every
    layer of the stack in order, its tail's too.  Per layer: its output on
    the kernel route and on the plain route from the same (plain-route)
    input ("teacher_forced", the check), and the kernel route run freely
    from the embedding against the plain route ("free_running", how far
    the model carries a difference),
    each as a share of the plain output's largest magnitude.  A decoder
    layer's cross-attention reads the plain route's encoder output when
    teacher-forced and the kernel route's when running freely.  A shared
    position runs the stack's shared block on its shared parameters.  An
    MoE layer's teacher-forced kernel route runs on the plain route's
    routing (``Routing``, checked by ``check_routing``)."""
    from repro_torch.kernels import ops
    from repro_torch.models.common import (default_positions, embed_tokens,
                                           rmsnorm)
    from repro_torch.models.stack import apply_layer

    def view(tree, g):
        return {k: view(v, g) if isinstance(v, dict) else v[g]
                for k, v in tree.items()}

    routing = {"layers": 0, "flips": 0, "gap_shares": [], "keep_shifts": 0}

    def run(sc, stack_params, x_ref, aux_ref, aux_free, forced, free):
        def layer(x, lc, g, key, kernels, aux):
            p = (stack_params["shared"] if lc.kind == "shared"
                 else view(stack_params["groups"][key], g) if g is not None
                 else stack_params["tail"][key])
            ops.use_kernels(kernels)
            try:
                return apply_layer(lc, p, x, mode="train", cache=None,
                                   aux=aux, eps=cfg.norm_eps,
                                   shared=sc.shared)[0]
            finally:
                ops.use_kernels(True)

        x_free = x_ref
        for lc, g, key in stack_layers(sc):
            with Routing() as plain:
                out_ref = layer(x_ref, lc, g, key, False, aux_ref)
            with Routing(plain.records) as on_plain:
                out_k = layer(x_ref, lc, g, key, True, aux_ref)
            rec = check_routing(f"{cfg.name} layer {g} {key}", on_plain,
                                plain.records)
            if rec is not None:
                for name in ("layers", "flips", "gap_shares", "keep_shifts"):
                    routing[name] += rec[name]
            forced.append(share(out_k, out_ref)["share"])
            del out_k
            x_free = layer(x_free, lc, g, key, True, aux_free)
            free.append(share(x_free, out_ref)["share"])
            x_ref = out_ref
        return x_ref, x_free

    forced, free = [], []
    enc_ref = enc_free = None
    with torch.no_grad():
        if cfg.encoder is not None:
            frames = batch["enc_inputs"].float()
            aux = {"positions": default_positions(*frames.shape[:2],
                                                  frames.device)}
            enc_ref, enc_free = (
                rmsnorm(x, params["enc_norm"], cfg.norm_eps)
                for x in run(cfg.encoder, params["encoder"], frames, aux,
                             aux, forced, free))
        scale = math.sqrt(cfg.d_model) if cfg.embed_scale else None
        if "tokens" in batch:
            x = embed_tokens(params["embed"], batch["tokens"], scale,
                             torch.float32)
        else:                   # a model fed embeddings (qwen2-vl)
            x = batch["inputs"].float()
            if scale is not None:
                x = x * scale
        pos = default_positions(*x.shape[:2], x.device, cfg.mrope)
        run(cfg.stack, params["stack"], x,
            {"positions": pos, "enc": enc_ref},
            {"positions": pos, "enc": enc_free}, forced, free)
    return {"teacher_forced": forced, "free_running": free,
            "encoder_layers": 0 if cfg.encoder is None
            else cfg.encoder.n_layers,
            "moe_routing": routing if routing["layers"] else None}


def cut_specs(cfg, groups: int) -> dict:
    """The parameter specs of ``cfg`` cut to its first ``groups`` layer
    groups, each stacked leaf drawn at the scale the full depth gives it.
    The init's fan-in of a stacked leaf is its leading (group) axis, so a
    cut would otherwise draw it at groups^-1/2: at mixtral's 8 of 56
    groups 2.6x the full model's weights (at arctic's 2 of 35, 4.2x), and
    scores of order 1e3, where float32 scores differ by ~1e-4 between any
    two summation orders and the softmax is near one-hot."""
    from repro_torch.dist.sharding import map_specs
    from repro_torch.models.model import model_specs

    full = cfg.stack.n_groups

    def cut(s):
        scale = s.scale
        if s.init == "normal" and scale is None:
            scale = full ** -0.5
        return dataclasses.replace(s, shape=(groups,) + s.shape[1:],
                                   scale=scale)

    specs = model_specs(cfg)
    specs["stack"]["groups"] = map_specs(cut, specs["stack"]["groups"])
    return specs


def serve_batch(cfg, rng, prompt: int, frames: int | None) -> dict:
    """SERVE_BATCH prompts of ``prompt`` numpy tokens (or, for a model fed
    embeddings, qwen2-vl, ``prompt`` patch embeddings) and, for an
    encoder-decoder, ``frames`` frame embeddings each (numpy normal draws,
    bf16), on the card."""
    if not cfg.embed_inputs and cfg.encoder is None:
        return {"inputs": torch.from_numpy(rng.standard_normal(
            (SERVE_BATCH, prompt, cfg.d_model), dtype=np.float32)).cuda().to(
                torch.bfloat16)}
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (SERVE_BATCH, prompt))).cuda()}
    if cfg.encoder is not None:
        batch["enc_inputs"] = torch.from_numpy(rng.standard_normal(
            (SERVE_BATCH, frames, cfg.d_model), dtype=np.float32)).cuda().to(
                torch.bfloat16)
    return batch


def phase_serve(arch: str, kernel: str, rng, prompt: int = SERVE_PROMPT,
                frames: int | None = None, groups: int | None = None,
                check_batch: int = SERVE_BATCH,
                check_prompt: int | None = None) -> dict:
    """One model through the port's serve steps at full width and depth
    (or on ``groups`` of its layer groups, a cut the record lists) in
    bfloat16: warm-up (not counted), then the main path with the launch
    counts set to 0 — prefill of SERVE_BATCH x ``prompt`` numpy tokens or
    patch embeddings (and, for an encoder-decoder, ``frames`` frame
    embeddings each), then SERVE_GEN - 1 greedy decode steps — then the
    kernel route against the plain route (see SERVE_LAYER_TOL) on the
    first ``check_batch`` prompts (their first ``check_prompt`` tokens,
    where given; an MoE layer under the routing rule, ROUTE_FLIPS_MAX),
    and one profiled prefill and decode step.  A windowed model whose
    prompt outruns its window decodes through ring caches: their
    positions are checked slot by slot after prefill and after the last
    step, and so are those of the full caches
    of any global layer beside them (gemma3), and the kernel route's
    caches after prefill and one decode step against the plain route's
    (positions equal, the first layer's keys and values bit for bit: they
    come from the embedding alone).  A model with a shared attention block
    (zamba2) has its per-occurrence caches checked the same way, and its
    Mamba2 conv and state caches finite and, on the two routes, bit for
    bit up to the first attention layer (``ssm_routes``).  Returns the
    phase's record."""
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import init_params
    from repro_torch.kernels import ops
    from repro_torch.models.model import model_specs
    from repro_torch.train.step import make_decode_step, make_prefill_step

    cfg = get_config(arch)
    reduced = []
    specs = model_specs(cfg)
    if groups is not None:
        reduced.append(f"n_groups {cfg.stack.n_groups} -> {groups} (the "
                       f"weights drawn at the full depth's scale)")
        specs = cut_specs(cfg, groups)
        cfg = dataclasses.replace(cfg, stack=dataclasses.replace(
            cfg.stack, n_groups=groups))
    capacity = prompt + SERVE_GEN
    windows = sorted({lc.attn.window for lc in cfg.stack.pattern
                      + cfg.stack.tail if lc.attn is not None
                      and lc.attn.window is not None})
    ring = any(w < capacity for w in windows)
    # caches whose positions are checked: rings, and a shared block's
    attn_caches = ring or cfg.stack.shared is not None
    cp = prompt if check_prompt is None else check_prompt
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_params(specs, gen, "cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    def leaves(tree):
        for v in tree.values():
            yield from leaves(v) if isinstance(v, dict) else (v,)

    n_params = sum(v.numel() for v in leaves(params))
    n_bytes = sum(v.numel() * v.element_size() for v in leaves(params))
    batch = serve_batch(cfg, rng, prompt, frames)
    prefill = make_prefill_step(cfg, max_len=prompt + SERVE_GEN)
    decode = make_decode_step(cfg)

    logits, cache = prefill(params, batch)                        # warm-up
    decode(params, cache, {"tokens": logits.argmax(-1), "pos": prompt})
    del logits, cache
    torch.cuda.synchronize()

    # --- the main path, counted -------------------------------------------
    clear_launches()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    tok = logits.argmax(-1)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = dict(ops.KERNEL_LAUNCHES)
    prefill_shapes = shape_launches()
    prefill_logits, first_tok = logits, tok
    finite = bool(torch.isfinite(logits).all())
    generated = [tok]
    ring_record = None
    if attn_caches:
        ring_record = {"windows": windows,
                       "after_prefill": ring_positions(cfg, cache, prompt - 1,
                                                       capacity)}
    t0 = time.perf_counter()
    for i in range(SERVE_GEN - 1):
        logits, cache = decode(params, cache,
                               {"tokens": tok, "pos": prompt + i})
        tok = logits.argmax(-1)
        generated.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = dict(ops.KERNEL_LAUNCHES)
    finite = finite and bool(torch.isfinite(logits).all())
    if cfg.stack.shared is not None:
        finite = finite and all(bool(torch.isfinite(v).all())
                                for v in tree_leaves(cache).values()
                                if v.is_floating_point())
    if attn_caches:
        ring_record["after_decode"] = ring_positions(
            cfg, cache, prompt + SERVE_GEN - 2, capacity)
    want_launches = kernel_calls(cfg)
    check(prefill_launches == {kernel: want_launches},
          f"{arch}: launched {prefill_launches} in prefill, want "
          f"{want_launches} {kernel} (one a layer, two a cross layer)")
    check(launches == prefill_launches,
          f"{arch}: decode launched kernels {launches} vs {prefill_launches}")
    check(finite, f"{arch}: logits are finite")
    check(prefill_logits.shape == (SERVE_BATCH, cfg.vocab),
          f"{arch}: logits shape {tuple(prefill_logits.shape)}")
    peak = torch.cuda.max_memory_allocated()

    # --- the kernel route against the plain route ------------------------
    few = {k: v[:check_batch] for k, v in batch.items()}
    if check_prompt is not None:
        few["tokens"] = few["tokens"][:, :check_prompt]
    routes = {"layers_f32": layer_routes(cfg, params, few),
              "batch": check_batch}
    worst = max(routes["layers_f32"]["teacher_forced"])
    check(worst <= SERVE_LAYER_TOL,
          f"{arch}: a layer's output, kernel route vs plain route from the "
          f"same input, differs by {worst} of its scale > {SERVE_LAYER_TOL}")

    def both_routes(pf, dc):
        """(prefill logits, first decode logits, the cache after it) on the
        kernel and the plain route."""
        out = []
        for kernels in (True, False):
            ops.use_kernels(kernels)
            try:
                lg, c = pf(params, few)
                dl, c = dc(params, c, {"tokens": first_tok[:check_batch],
                                       "pos": cp})
            finally:
                ops.use_kernels(True)
            out.append((lg, dl, c))
        return out

    if check_prompt is None:
        ops.use_kernels(False)
        try:
            plain_bf16, _ = prefill(params, few)
        finally:
            ops.use_kernels(True)
        routes["logits_bf16_prefill"] = share(prefill_logits[:check_batch],
                                              plain_bf16)
        del plain_bf16
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    (k_pre, k_dec, k_cache), (p_pre, p_dec, p_cache) = both_routes(
        make_prefill_step(cfg32, max_len=cp + SERVE_GEN),
        make_decode_step(cfg32))
    for name, got, want in (("logits_f32_prefill", k_pre, p_pre),
                            ("logits_f32_decode_1", k_dec, p_dec)):
        routes[name] = share(got, want)
        check(bool(torch.isfinite(got).all()), f"{arch}: {name} finite")
    if attn_caches:
        ring_record["routes"] = ring_routes(cfg, k_cache, p_cache, cp,
                                            cp + SERVE_GEN)
    if cfg.stack.shared is not None:
        ring_record["ssm_routes"] = ssm_routes(cfg, k_cache, p_cache)
    del k_pre, k_dec, p_pre, p_dec, k_cache, p_cache

    profiles = {
        "prefill": profile_job(lambda: prefill(params, batch),
                               KERNEL_NAMES[kernel]),
        "decode_step": profile_job(lambda: decode(
            params, cache, {"tokens": tok, "pos": prompt + SERVE_GEN - 1}))}
    for prof in profiles.values():
        prof.pop("host_span_ms")
    record = {
        "arch": arch, "kernel": kernel, "layers": cfg.n_layers,
        "reduced": reduced, "windows": windows, "ring": ring_record,
        "check_prompt": cp,
        "encoder_layers": 0 if cfg.encoder is None
        else cfg.encoder.n_layers, "frames": frames,
        "batch": SERVE_BATCH, "prompt": prompt, "generated":
        SERVE_GEN, "params": n_params, "param_bytes": n_bytes,
        "init_s": init_s, "prefill_s": prefill_s,
        "prefill_tok_s": SERVE_BATCH * prompt / prefill_s,
        "decode_ms_per_step": decode_s / (SERVE_GEN - 1) * 1e3,
        "decode_tok_s": SERVE_BATCH * (SERVE_GEN - 1) / decode_s,
        "launches_prefill": prefill_launches,
        "launches_prefill_by_shape": prefill_shapes, "launches": launches,
        "plain_route": routes, "peak_mem_bytes": peak,
        "tokens_head": torch.stack(generated, 1)[0, :8].tolist(),
        "profile": profiles}
    emit("serve", **record)
    del params, cache, logits, prefill_logits, batch, few
    torch.cuda.empty_cache()
    return record


def self_caches(cfg, cache) -> list:
    """(key, window, cache) of every self-attention cache of a model's
    stack: each pattern position's (its leaves (G, B, S, ...), one a
    group; a shared position's, per occurrence, for the shared block's
    attention) and each tail layer's (given a leading axis of 1)."""
    sc = cfg.stack

    def attn(lc):
        return sc.shared.attn if lc.kind == "shared" else lc.attn

    out = [(f"p{i}", attn(lc).window, cache["groups"][f"p{i}"]["self"])
           for i, lc in enumerate(sc.pattern) if attn(lc) is not None]
    return out + [(f"t{i}", attn(lc).window,
                   {k: v[None] for k, v in
                    cache["tail"][f"t{i}"]["self"].items()})
                  for i, lc in enumerate(sc.tail) if attn(lc) is not None]


def ssm_routes(cfg, k_cache, p_cache) -> dict:
    """The Mamba2 (or Mamba1) caches of the kernel route after prefill and
    one decode step against the plain route's (float32 compute): every
    leaf finite; the layers before the first attention layer (group 0's,
    fed by the embedding alone) bit for bit; each position's conv and
    state as shares of their scale, one a group."""
    out, first_attn = {}, min(
        (i for i, lc in enumerate(cfg.stack.pattern)
         if lc.kind not in ("mamba1", "mamba2")),
        default=len(cfg.stack.pattern))
    for i, lc in enumerate(cfg.stack.pattern):
        if lc.kind not in ("mamba1", "mamba2"):
            continue
        kc = k_cache["groups"][f"p{i}"]["ssm"]
        pc = p_cache["groups"][f"p{i}"]["ssm"]
        for name in ("conv", "state"):
            check(bool(torch.isfinite(kc[name]).all()),
                  f"p{i} {name} cache finite")
            if i < first_attn:
                check(torch.equal(kc[name][0], pc[name][0]),
                      f"group 0 p{i} {name} cache, kernel route == plain "
                      f"route bit for bit (before any attention)")
        out[f"p{i}"] = {name: [share(kc[name][g].float(),
                                     pc[name][g].float())["share"]
                               for g in range(kc[name].shape[0])]
                        for name in ("conv", "state")}
    return out


def ring_positions(cfg, cache, last: int, capacity: int) -> dict:
    """Every self-attention cache of ``cache`` (per layer and prompt): a
    ring (a window shorter than the ``capacity`` of the prefill's cache)
    holds exactly the last ``window`` positions up to ``last``, position p
    in slot p % window; a full cache holds positions 0 to ``last`` in its
    first slots and -1 (empty) in the rest."""
    rings, full = {}, {}
    for key, window, c in self_caches(cfg, cache):
        pos = c["pos"]                                    # (G, B, S)
        is_ring = window is not None and window < capacity
        slots = window if is_ring else capacity
        check(pos.shape[-1] == slots, f"{key}: caches of {pos.shape[-1]} "
              f"slots, want {slots}")
        want = torch.full((slots,), -1, dtype=pos.dtype, device=pos.device)
        if is_ring:
            live = torch.arange(last - window + 1, last + 1,
                                device=pos.device)
            want[live % window] = live.to(pos.dtype)
        else:
            want[:last + 1] = torch.arange(last + 1, device=pos.device)
        check(bool((pos == want).all()),
              f"{key}: positions up to {last}: " + (
                  f"slot p % {window} holds p for the last {window} "
                  f"positions" if is_ring else
                  f"slots 0-{last} hold their positions, the rest -1"))
        (rings if is_ring else full)[key] = {"slots": slots,
                                             "layers_prompts":
                                             list(pos.shape[:2])}
    first = {w: last - w + 1 for _, w, _ in self_caches(cfg, cache)
             if w is not None and w < capacity}
    return {"last": last, "first_in_ring": first, "rings": rings,
            "full": full}


def ring_routes(cfg, k_cache, p_cache, prompt: int, capacity: int) -> dict:
    """The kernel route's caches after prefill and one decode step against
    the plain route's (float32 compute): positions equal at every layer;
    the first layer's keys and values bit for bit (computed from the
    embedding, before any attention); each layer's as shares of their
    scale (what the layers before carry of the kernels' summation
    order)."""
    ring_positions(cfg, k_cache, prompt, capacity)
    out = {}
    for (key, _, kc), (_, _, pc) in zip(self_caches(cfg, k_cache),
                                        self_caches(cfg, p_cache)):
        check(torch.equal(kc["pos"], pc["pos"]),
              f"{key}: cache positions, kernel route == plain route")
        out[key] = {name: [share(kc[name][g], pc[name][g])["share"]
                           for g in range(kc[name].shape[0])]
                    for name in ("k", "v")}
    kc = self_caches(cfg, k_cache)[0][2]
    pc = self_caches(cfg, p_cache)[0][2]
    for name in ("k", "v"):
        check(torch.equal(kc[name][0], pc[name][0]),
              f"the first layer's cache {name}, kernel route == plain "
              f"route bit for bit")
    return out





def tree_leaves(tree, prefix: str = "") -> dict:
    """{"a/b": leaf} of a tree of dicts, keys sorted."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(tree_leaves(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def layer_setup(arch: str, seq: int, batch: int = TRAIN_BATCH,
                position: int = 0, seed: int = SEED + 4):
    """One layer of ``arch`` at full width (its decoder layer, for an
    encoder-decoder; the one at ``position`` of its stack's pattern):
    config, parameters (bf16 values held as float32 leaves), input x
    (batch, seq, D), upstream gradient and, for a cross layer, the
    encoder's states (batch, WHISPER_FRAMES, D), all drawn from
    ``seed``."""
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import init_params
    from repro_torch.models.stack import layer_specs

    cfg = get_config(arch)
    lc = cfg.stack.pattern[position]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = tree_map(lambda t: t.float(), init_params(
        layer_specs(lc, cfg.d_model), gen, "cuda", dtype=torch.bfloat16))
    x = torch.randn((batch, seq, cfg.d_model), generator=gen,
                    device="cuda")
    enc = torch.randn((batch, WHISPER_FRAMES, cfg.d_model),
                      generator=gen, device="cuda") if lc.attn is not None \
        and lc.attn.cross else None
    return cfg, lc, params, x, upstream_grad(x, seed - 1), enc


def layer_grads(cfg, lc, params, x, dout, enc, kernels: bool,
                dtype=torch.float32, routing: Routing | None = None) -> dict:
    """{"x", "enc" (a cross layer), "<param path>": gradient} of one layer
    in ``dtype`` compute (x, enc and dout cast to it; the float32 leaves
    are cast to it at use), on the kernel or the plain route, inside
    ``routing`` where given."""
    from repro_torch.kernels import ops
    from repro_torch.models.common import default_positions
    from repro_torch.models.stack import apply_layer

    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    ins = {"x": x.to(dtype).detach().requires_grad_(True)}
    if enc is not None:
        ins["enc"] = enc.to(dtype).detach().requires_grad_(True)
    aux = {"positions": default_positions(x.shape[0], x.shape[1], "cuda",
                                          cfg.mrope),
           "enc": ins.get("enc")}
    ops.use_kernels(kernels)
    try:
        with routing or contextlib.nullcontext():
            out = apply_layer(lc, live, ins["x"], mode="train", cache=None,
                              aux=aux, eps=cfg.norm_eps)[0]
            leaves = {**ins, **tree_leaves(live)}
            got = torch.autograd.grad(out, list(leaves.values()),
                                      dout.to(dtype))
    finally:
        ops.use_kernels(True)
    return dict(zip(leaves, got))


def layer_grad_check(arch: str, kernel: str, seq: int = TRAIN_SEQ,
                     batch: int = TRAIN_BATCH, position: int = 0) -> dict:
    """One layer of ``arch`` at full width, float32 compute with bf16
    weights (bf16 values held as float32 leaves, so the gradients are
    float32), from one input and one upstream gradient: dx (and, for a
    cross layer, the encoder states' gradient) and every parameter
    gradient on the kernel route against the plain route
    (``use_kernels(False)``, PyTorch's autograd through the plain
    versions), as a share of each gradient's largest magnitude.  The
    kernel route must launch the forward and the backward kernel once per
    mixer call (twice in a cross layer).  An MoE layer's kernel route runs
    on the plain route's routing (``Routing``, ``check_routing``)."""
    from repro_torch.kernels import ops

    cfg, lc, params, x, dout, enc = layer_setup(arch, seq, batch, position)
    plain_routing = Routing()
    plain = layer_grads(cfg, lc, params, x, dout, enc, False,
                        routing=plain_routing)
    clear_launches()
    on_plain = Routing(plain_routing.records)
    on_kernels = layer_grads(cfg, lc, params, x, dout, enc, True,
                             routing=on_plain)
    torch.cuda.synchronize()
    launches = dict(ops.KERNEL_LAUNCHES)
    routing = check_routing(f"{arch} layer gradients", on_plain,
                            plain_routing.records)
    shares = {n: share(on_kernels[n], plain[n])["share"] for n in plain}
    worst = max(shares, key=shares.get)
    calls = 2 if enc is not None else 1
    check(launches == {kernel: calls, f"{kernel}_bwd": calls},
          f"{arch} layer: launches {launches}, want {calls} {kernel} and "
          f"{calls} {kernel}_bwd")
    check(shares[worst] <= SERVE_LAYER_TOL,
          f"{arch} layer: gradient {worst}, kernel route vs plain route, "
          f"differs by {shares[worst]} of its scale > {SERVE_LAYER_TOL}")
    del on_kernels, plain, params, x, dout
    torch.cuda.empty_cache()
    return {"arch": arch, "position": position,
            "shape": [batch, seq, cfg.d_model],
            "window": lc.attn.window if lc.attn is not None else None,
            "enc_shape": None if enc is None else list(enc.shape),
            "launches": launches, "grad_share": shares, "worst": worst,
            "tol": SERVE_LAYER_TOL, "moe_routing": routing}


def layer_grad_check_bf16(arch: str, seq: int, batch: int = TRAIN_BATCH,
                          position: int = 0, seed: int = SEED + 4) -> dict:
    """One attention layer of ``arch`` at full width in bf16 compute (see
    LAYER_BF16_EXCESS): (a) each attention call's dq, dk, dv from the
    kernels against the exact gradient of the q, k, v and upstream
    gradient the layer gave that call, within 2^-8 of its scale (the plain
    route's bf16 gradients reported beside); (b) every gradient of the
    layer on the kernel and the plain route against the layer in float32
    compute, the kernel route's share at most LAYER_BF16_CEIL and within
    LAYER_BF16_EXCESS of the plain route's; and every backward launch fed
    the forward's float32 O.  A control run hands the backward the bf16 O
    (the forward before the repair) and reports what (a) and (b) read
    there, unchecked: the guard against the bf16 O is the O-dtype check
    here and ``bf16_grad_repair``'s.  An MoE layer runs every route on the
    routing of the float32 plain route (``Routing``): bf16 rounding of the
    router's input moves near-tied tokens to other experts, an order-one
    difference of its own.  Its expert leaves are held by (b) against the
    sound route furthest from float32 compute, the plain route or one of
    two witnesses, and every other leaf against the plain route, each
    under the MoE layer's own ceilings (see LAYER_BF16_MOE_CEIL)."""
    from repro_torch.kernels import flash_attention, ops, ref

    cfg, lc, params, x, dout, enc = layer_setup(arch, seq, batch, position,
                                                seed)
    f32_routing = Routing()
    f32 = layer_grads(cfg, lc, params, x, dout, enc, False,
                      routing=f32_routing)
    routed = f32_routing.records
    kernel_attention = ops.attention
    kernel_fwd, kernel_bwd = (flash_attention.flash_attention_fwd,
                              flash_attention.flash_attention_bwd)

    def on_kernels(o_dtypes, bf16_o=False):
        """The layer's gradients on the kernel route and its attention
        calls (q, k, v and their gradients, the output's upstream
        gradient); the O dtype of each backward launch into ``o_dtypes``;
        with ``bf16_o`` the backward reads the bf16 output."""
        calls = []

        def recorded(q, k, v, *, causal=True, window=None, softcap=None):
            out = kernel_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
            call = {"qkv": (q, k, v), "causal": causal, "window": window,
                    "softcap": softcap, "grads": {}}
            for name, t in (("q", q), ("k", k), ("v", v), ("o", out)):
                t.register_hook(lambda g, n=name, c=call:
                                c["grads"].__setitem__(n, g))
            calls.append(call)
            return out

        def fwd(q, k, v, **kw):
            out, lse, o32 = kernel_fwd(q, k, v, **kw)
            return out, lse, out if bf16_o else o32

        def bwd(q, k, v, o, *rest, **kw):
            o_dtypes.append(o.dtype)
            return kernel_bwd(q, k, v, o, *rest, **kw)

        ops.attention = recorded
        flash_attention.flash_attention_fwd = fwd
        flash_attention.flash_attention_bwd = bwd
        try:
            grads = layer_grads(cfg, lc, params, x, dout, enc, True,
                                torch.bfloat16, Routing(routed))
        finally:
            ops.attention = kernel_attention
            flash_attention.flash_attention_fwd = kernel_fwd
            flash_attention.flash_attention_bwd = kernel_bwd
        return grads, calls

    def attention_shares(call):
        """(the kernels' dq, dk, dv, the plain route's bf16 ones) as
        shares of the exact gradient's scale."""
        def plain_grads(dtype):
            q, k, v = (t.detach().to(dtype).requires_grad_(True)
                       for t in call["qkv"])
            return torch.autograd.grad(
                ref.attention(q, k, v, causal=call["causal"],
                              window=call["window"],
                              softcap=call["softcap"]), (q, k, v),
                call["grads"]["o"].to(dtype))

        exact = plain_grads(torch.float32)

        def shares(got):
            return [max_abs_err([g], [e]) / float(e.abs().max())
                    for g, e in zip(got, exact)]

        return (shares([call["grads"][n] for n in ("q", "k", "v")]),
                shares(plain_grads(torch.bfloat16)))

    o_dtypes = []
    clear_launches()
    grads, calls = on_kernels(o_dtypes)
    by_shape = shape_launches()
    n_calls = 2 if enc is not None else 1
    check(len(calls) == n_calls,
          f"{arch} bf16 layer: {len(calls)} attention calls")
    check(o_dtypes == [torch.float32] * n_calls,
          f"{arch} bf16 layer: the backward launches read O as {o_dtypes}, "
          f"want the forward's float32 O")
    # each gradient set is reduced to its shares at once: at mixtral's
    # widths one set is 10 GB, and the plain attention's autograd below
    # takes several 7.2 GB copies of the scores
    k_shares = {n: share(grads[n].float(), f32[n])["share"] for n in f32}
    del grads
    torch.cuda.empty_cache()
    attn = []
    for i, call in enumerate(calls):
        rel, plain_rel = attention_shares(call)
        check(max(rel) <= FLASH_BWD_RTOL[torch.bfloat16],
              f"{arch} bf16 layer, attention call {i}: the kernels' dq, dk, "
              f"dv {rel} of the exact gradient's scale > 2^-8")
        q, k = call["qkv"][:2]
        attn.append({"q": list(q.shape), "kv": list(k.shape),
                     "causal": call["causal"], "window": call["window"],
                     "share_of_scale": rel, "plain_bf16_share": plain_rel})
    del calls
    torch.cuda.empty_cache()
    plain = layer_grads(cfg, lc, params, x, dout, enc, False, torch.bfloat16,
                        Routing(routed))
    excess = {}
    for n in f32:
        p_share = share(plain[n].float(), f32[n])["share"]
        excess[n] = {"kernel": k_shares[n], "plain": p_share,
                     "excess": k_shares[n] - p_share}
    del plain
    torch.cuda.empty_cache()

    def witness(move):
        """The plain bf16 route with each attention output moved, in its
        forward only, by the flash forward's own difference from it on
        the same q, k and v: "mirror" subtracts that difference, "roll"
        adds it rolled by half the sequence.  Either is a sound route as
        far from the plain one as the kernel's forward, which an expert's
        gradient reads through the layer's activations alone (it does
        not depend on the attention backward).  -> (each expert leaf's
        share from float32 compute, each call's moved share of its
        output's scale)."""
        moved_by = []

        def moved(q, k, v, *, causal=True, window=None, softcap=None):
            out = ref.attention(q, k, v, causal=causal, window=window,
                                softcap=softcap)
            with torch.no_grad():
                fl = flash_attention.flash_attention(
                    q.detach(), k.detach(), v.detach(), causal=causal,
                    window=window, softcap=softcap).float()
                base = out.detach().float()
                diff = fl - base
                moved_by.append(share(fl, base)["share"])
                if move == "roll":
                    target = base + diff.roll(diff.shape[1] // 2, dims=1)
                else:
                    target = base - diff
                del fl, base, diff
            return target.to(out.dtype) + (out - out.detach())

        ops.attention = moved
        try:
            grads = layer_grads(cfg, lc, params, x, dout, enc, False,
                                torch.bfloat16, Routing(routed))
        finally:
            ops.attention = kernel_attention
        got = {n: share(grads[n].float(), f32[n])["share"] for n in experts}
        del grads
        torch.cuda.empty_cache()
        check(max(moved_by) <= FLASH_TOL[torch.bfloat16],
              f"{arch} bf16 layer, {move} witness: the flash forward is "
              f"{moved_by} of the plain output's scale from it")
        return got, moved_by

    experts = [n for n in f32 if lc.moe is not None
               and n.split("/")[-1] in ("w_gate", "w_up", "w_down")]
    witnesses = {}
    for move in ("mirror", "roll") if experts else ():
        got, moved_by = witness(move)
        witnesses[move] = {"moved_share": moved_by, "expert_vs_f32": got}
    for n in experts:
        sound = max([excess[n]["plain"]]
                    + [w["expert_vs_f32"][n] for w in witnesses.values()])
        excess[n]["sound"] = sound
        excess[n]["excess"] = excess[n]["kernel"] - sound
    dense = [n for n in f32 if n not in experts]
    ceiling = LAYER_BF16_CEIL if lc.moe is None else LAYER_BF16_MOE_CEIL
    limits = {}
    for names, tol, ceil in ((dense, LAYER_BF16_EXCESS, ceiling),
                             (experts, LAYER_BF16_EXPERT_EXCESS,
                              LAYER_BF16_EXPERT_CEIL)):
        for n in names:
            limits[n] = {"excess": tol, "ceiling": ceil}
            e = excess[n]
            check(e["excess"] <= tol,
                  f"{arch} bf16 layer: gradient {n} on the kernel route is "
                  f"{e['kernel']} of its scale from float32 compute, the "
                  f"sound route it is held to {e.get('sound', e['plain'])}"
                  f": more than {tol} apart")
            check(e["kernel"] <= ceil,
                  f"{arch} bf16 layer: gradient {n} on the kernel route is "
                  f"{e['kernel']} of its scale from float32 compute > "
                  f"{ceil}")
    worst = max(excess, key=lambda n: excess[n]["excess"])

    # the control: the same layer with the backward fed the bf16 O
    control_dtypes = []
    grads, calls = on_kernels(control_dtypes, bf16_o=True)
    control_layer = {n: share(grads[n].float(), f32[n])["share"]
                     for n in f32}
    del grads
    torch.cuda.empty_cache()
    control_attn = [attention_shares(call)[0] for call in calls]
    control_excess = {
        n: control_layer[n] - excess[n].get("sound", excess[n]["plain"])
        for n in f32}
    control = {
        "o_dtypes": [str(d) for d in control_dtypes],
        "attention_share_of_scale": control_attn,
        "layer_vs_f32_max": max(control_layer.values()),
        "layer_excess_max": max(control_excess.values()),
        "fails_a": max(map(max, control_attn))
        > FLASH_BWD_RTOL[torch.bfloat16],
        "fails_b": any(control_excess[n] > limits[n]["excess"]
                       or control_layer[n] > limits[n]["ceiling"]
                       for n in f32),
        "fails_o_dtype": control_dtypes != [torch.float32] * n_calls}
    del calls
    del f32, params, x, dout
    torch.cuda.empty_cache()
    return {"arch": arch, "position": position,
            "shape": [batch, seq, cfg.d_model],
            "enc_shape": None if enc is None else list(enc.shape),
            "launches_by_shape": by_shape,
            "attention_calls": attn, "tol_share": 2 ** -8,
            "layer_vs_f32": excess, "worst": worst,
            "tol_excess": LAYER_BF16_EXCESS, "ceiling": ceiling,
            "limits": limits, "witnesses": witnesses, "seed": seed,
            "control_bf16_o": control}


def train_run(cfg, batch, steps: int, kernel: str, opt,
              loss: str = "plain", finite_grads: bool = False,
              specs: dict | None = None) -> dict:
    """``steps`` train steps of ``cfg`` (float32 params and AdamW state)
    on one repeated batch, after a warm-up step: walls, tokens/s, losses,
    launches, peak memory, one profiled step, and one step each under
    remat="full" and "dots" with the loss of a remat="none" step from the
    same state; every step with the train step's ``loss`` ("plain" or
    "chunked": the logits a sequence chunk at a time).  The main path's
    counts are those of the timed steps.  With ``finite_grads``, every
    gradient leaf of the trained state is checked finite.  ``specs``
    (e.g. ``cut_specs``) replaces the parameter specs of ``cfg`` at
    init."""
    from repro_torch.dist.sharding import init_params
    from repro_torch.kernels import ops
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.step import (StepCfg, init_train_state,
                                        loss_and_grads, make_train_step)

    gc.collect()                # see the remat step below
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    if specs is None:
        state = init_train_state(cfg, opt, gen, "cuda")
    else:
        params = init_params(specs, gen, "cuda")
        state = {"params": params, **init_opt_state(params, opt)}
        del params
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tree_leaves(state["params"]).values()
    n_params = sum(v.numel() for v in leaves)
    state_bytes = sum(v.numel() * v.element_size()
                      for part in ("params", "m", "v")
                      for v in tree_leaves(state[part]).values())
    step = make_train_step(cfg, opt, StepCfg(remat="none", loss=loss))
    t0 = time.perf_counter()
    state, metrics = step(state, batch)                    # warm-up
    losses = [float(metrics["loss"])]
    warm_s = time.perf_counter() - t0

    clear_launches()
    walls, norms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        walls.append(time.perf_counter() - t0)
        norms.append(float(metrics["grad_norm"]))
    launches = dict(ops.KERNEL_LAUNCHES)
    by_shape = shape_launches()
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: v / steps for k, v in launches.items()}
    n_calls = kernel_calls(cfg)
    check(per_step == {kernel: n_calls, f"{kernel}_bwd": n_calls},
          f"{cfg.name}: launches a step {per_step}, want {n_calls} "
          f"{kernel} and {n_calls} {kernel}_bwd")
    check(all(np.isfinite(losses)), f"{cfg.name}: losses {losses} finite")
    check(losses[-1] < losses[0], f"{cfg.name}: the loss on a repeated "
          f"batch falls: {losses}")

    grad_leaves = None
    if finite_grads:
        _, grads = loss_and_grads(cfg, StepCfg(remat="none", loss=loss),
                                  state["params"], batch)
        bad = [n for n, g in tree_leaves(grads).items()
               if not bool(torch.isfinite(g).all())]
        check(not bad, f"{cfg.name}: gradient leaves not finite: {bad}")
        grad_leaves = len(tree_leaves(grads))
        del grads
    match = "flash_bwd" if kernel == "flash_attention" else "scan_bwd"
    prof = profile_job(lambda: step(state, batch), match)
    prof.pop("host_span_ms")
    none_loss = float(step(state, batch)[1]["loss"])
    remat = {}
    for name in ("full", "dots"):
        clear_launches()
        t0 = time.perf_counter()
        got_loss = float(make_train_step(cfg, opt, StepCfg(
            remat=name, loss=loss))(state, batch)[1]["loss"])
        wall = time.perf_counter() - t0
        got = dict(ops.KERNEL_LAUNCHES)
        # the first checkpoint call of a process imports torch._dynamo, and
        # that import keeps the calling frames (with this step's old and
        # new state) alive until a collection: collect, or they hold ~20 GB
        gc.collect()
        # remat re-runs the groups' forward in the backward, not the tail's
        n_fwd = n_calls + kernel_calls(cfg, tail=False)
        check(got == {kernel: n_fwd, f"{kernel}_bwd": n_calls},
              f"{cfg.name}: remat={name!r} launches {got}, want "
              f"{n_fwd} {kernel} and {n_calls} {kernel}_bwd")
        check(got_loss == none_loss, f"{cfg.name}: remat={name!r} loss "
              f"{got_loss} != remat='none' loss {none_loss} from the same "
              f"state")
        remat[name] = {"step_s": wall, "loss": got_loss, "launches": got}
    tokens = batch["tokens"].numel()
    del state, metrics
    torch.cuda.empty_cache()
    return {"model": cfg.name, "layers": cfg.n_layers,
            "encoder_layers": 0 if cfg.encoder is None
            else cfg.encoder.n_layers,
            "enc_inputs": list(batch["enc_inputs"].shape)
            if "enc_inputs" in batch else None, "params": n_params,
            "state_bytes": state_bytes, "batch": list(batch["tokens"].shape),
            "compute_dtype": str(cfg.compute_dtype), "loss": loss,
            "lr": opt.lr,
            "init_s": init_s, "warmup_step_s": warm_s, "step_s": walls,
            "tokens_per_s": tokens * steps / sum(walls), "losses": losses,
            "grad_norms": norms, "launches": launches,
            "launches_by_shape": by_shape,
            "launches_per_step": per_step, "peak_mem_bytes": peak,
            "profile": prof, "remat_none_loss": none_loss,
            "remat": remat, "finite_grad_leaves": grad_leaves}


def phase_train(batch: dict) -> dict:
    """9. train: the per-layer gradient check (the kernel route against
    the plain route, one llama attention layer, one falcon-mamba Mamba1
    layer, one whisper decoder layer, one h2o-danube layer past its window
    and one qwen2-vl layer at full width, in float32 compute; the
    attention layers again in bf16 compute, see LAYER_BF16_EXCESS); a
    whole llama3.2-1b step at full width and two groups in float32
    compute on both routes; llama3.2-1b trained at full width and depth
    on HAIL-selected data (phase 6b's batch), falcon-mamba-7b at full
    width cut to 8 of its 64 layers, whisper-medium at full width and
    depth on frame embeddings and tokens, and h2o-danube-1.8b at full
    width and depth on 1 x 8,192 tokens, and gemma3-4b at full width on 2
    of its 5 groups and its tail (16 layers) on 1 x 4,096 tokens (a local
    and a global layer of it also in the per-layer checks), zamba2-2.7b
    at full width and depth on 1 x 4,096 tokens and mixtral-8x22b on 1 of
    its 56 layers on 1 x 8,192 (its MoE layer also in the per-layer
    checks, on one routing); and a checkpoint round trip of a full-width
    two-group llama train state."""
    import tempfile

    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import init_params
    from repro_torch.kernels import ops
    from repro_torch.models.model import model_specs
    from repro_torch.train.optimizer import OptCfg
    from repro_torch.train.step import (StepCfg, init_train_state,
                                        loss_and_grads, make_train_step)

    t_phase = time.perf_counter()
    record: dict = {"layers": [layer_grad_check(arch, kernel)
                               for arch, kernel in SERVE]}
    record["layers"].append(layer_grad_check(WHISPER, "flash_attention",
                                             WHISPER_TRAIN_SEQ))
    # h2o-danube's layer past its window (head dim 80), qwen2-vl's with
    # M-RoPE positions (head dim 128)
    record["layers"].append(layer_grad_check(
        H2O, "flash_attention", H2O_LAYER_SEQ, H2O_CHECK_BATCH))
    record["layers"].append(layer_grad_check(QWEN, "flash_attention"))
    # gemma3-4b's local layer past its window and its global layer (head
    # dim 256, qk-norm, theta 10^4 and 10^6)
    for position in (GEMMA_LOCAL, GEMMA_GLOBAL):
        record["layers"].append(layer_grad_check(
            GEMMA4, "flash_attention", GEMMA_LAYER_SEQ, 1, position))
    # mixtral's MoE layer past its window (GQA 48/8, the router's and the
    # experts' gradients too)
    record["layers"].append(layer_grad_check(
        MIXTRAL, "flash_attention", MIXTRAL_LAYER_SEQ, 1))
    torch.cuda.empty_cache()
    record["layers_bf16"] = [
        layer_grad_check_bf16("llama3.2-1b", TRAIN_SEQ),
        layer_grad_check_bf16(WHISPER, WHISPER_TRAIN_SEQ),
        layer_grad_check_bf16(H2O, H2O_LAYER_SEQ, H2O_CHECK_BATCH),
        layer_grad_check_bf16(QWEN, TRAIN_SEQ),
        *(layer_grad_check_bf16(GEMMA4, GEMMA_LAYER_SEQ, 1, position)
          for position in (GEMMA_LOCAL, GEMMA_GLOBAL)),
        layer_grad_check_bf16(MIXTRAL, MIXTRAL_LAYER_SEQ, 1)]
    torch.cuda.empty_cache()

    # --- a whole step in float32 compute, kernel route vs plain route ----
    llama = get_config("llama3.2-1b")
    two = dataclasses.replace(llama, compute_dtype=torch.float32,
                              stack=dataclasses.replace(llama.stack,
                                                        n_groups=2))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    # the first two layers of the full-depth model's random weights: the
    # init draws a stacked leaf at (groups)^-1/2, so a 2-group draw would
    # give weights at 0.71 and scores of order 1e3, where the float32
    # scores themselves differ by ~1e-4 relative between any two routes
    params = init_params(model_specs(llama), gen, "cuda")
    params["stack"]["groups"] = tree_map(lambda t: t[:2].clone(),
                                         params["stack"]["groups"])
    routes = []
    for kernels in (True, False):
        ops.use_kernels(kernels)
        try:
            routes.append(loss_and_grads(two, StepCfg(remat="none"), params,
                                         batch))
        finally:
            ops.use_kernels(True)
    (loss_k, g_k), (loss_p, g_p) = routes
    g_k, g_p = tree_leaves(g_k), tree_leaves(g_p)
    shares = {n: share(g_k[n], g_p[n])["share"] for n in g_p}
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    worst = max(shares, key=shares.get)
    check(loss_rel <= TRAIN_STEP_TOL and shares[worst] <= TRAIN_STEP_TOL,
          f"llama 2-group float32 step, kernel route vs plain route: loss "
          f"{loss_rel}, gradient {worst} {shares[worst]} of its scale > "
          f"{TRAIN_STEP_TOL}")
    record["step_f32_2_groups"] = {"loss": float(loss_k),
                                   "loss_rel_err": loss_rel,
                                   "grad_share": shares, "worst": worst,
                                   "tol": TRAIN_STEP_TOL}
    del params, routes, g_k, g_p
    torch.cuda.empty_cache()

    # --- llama3.2-1b-train and falcon-mamba-7b-train-8L --------------------
    opt = OptCfg(lr=TRAIN_LR, warmup_steps=1, total_steps=100)
    record["llama3.2-1b-train"] = train_run(
        llama, batch, TRAIN_STEPS - 1, "flash_attention", opt)
    falcon = get_config("falcon-mamba-7b")
    falcon8 = dataclasses.replace(falcon, stack=dataclasses.replace(
        falcon.stack, n_groups=FALCON_TRAIN_GROUPS))
    rng = np.random.default_rng(SEED + 6)
    tok = torch.from_numpy(rng.integers(0, falcon.vocab, (
        TRAIN_BATCH, TRAIN_SEQ + 1)).astype(np.int32)).cuda()
    record["falcon-mamba-7b-train-8L"] = {
        **train_run(falcon8, {"tokens": tok[:, :-1].contiguous(),
                              "labels": tok[:, 1:].contiguous()},
                    FALCON_TRAIN_STEPS, "selective_scan", opt),
        "reduced": [f"n_groups 64 -> {FALCON_TRAIN_GROUPS}: AdamW in "
                    f"float32 for all 7.01 B parameters is 112 GB of "
                    f"params, grads and moments, past the card's 80 GB"],
        "data": "numpy tokens below falcon-mamba's vocabulary of 65,024 "
                "(the HAIL corpus draws from llama's 128,256)"}
    whisper = get_config(WHISPER)
    tok = torch.from_numpy(rng.integers(0, whisper.vocab, (
        TRAIN_BATCH, WHISPER_TRAIN_SEQ + 1)).astype(np.int32)).cuda()
    frames = torch.from_numpy(rng.standard_normal(
        (TRAIN_BATCH, WHISPER_FRAMES, whisper.d_model),
        dtype=np.float32)).cuda().to(torch.bfloat16)
    record["whisper-medium-train"] = {
        **train_run(whisper, {"tokens": tok[:, :-1].contiguous(),
                              "labels": tok[:, 1:].contiguous(),
                              "enc_inputs": frames},
                    WHISPER_TRAIN_STEPS - 1, "flash_attention", opt),
        "data": "numpy tokens below whisper's vocabulary of 51,865 and "
                "numpy normal frame embeddings (the stub frontend's "
                "output), bf16"}
    del tok, frames
    torch.cuda.empty_cache()
    # h2o-danube-1.8b at full width and depth on one sequence of twice its
    # window; qwen2-vl-72b is not trained here: at 16 B a parameter of
    # float32 weights, gradients and AdamW moments, its two embedding
    # tables alone would hold 40 GB
    h2o = get_config(H2O)
    tok = torch.from_numpy(rng.integers(0, h2o.vocab, (
        H2O_TRAIN_BATCH, H2O_TRAIN_SEQ + 1)).astype(np.int32)).cuda()
    record["h2o-danube-1.8b-train"] = {
        **train_run(h2o, {"tokens": tok[:, :-1].contiguous(),
                          "labels": tok[:, 1:].contiguous()},
                    H2O_TRAIN_STEPS - 1, "flash_attention", opt),
        "data": "numpy tokens below h2o-danube's vocabulary of 32,000"}
    del tok
    torch.cuda.empty_cache()
    # gemma3-4b at full width on 2 of its 5 groups and its tail, on one
    # sequence of four windows: the local layers' windowed backward at T >
    # window, the global layers' causal one at T = 4,096
    gemma = get_config(GEMMA4)
    gemma16 = dataclasses.replace(gemma, stack=dataclasses.replace(
        gemma.stack, n_groups=GEMMA_TRAIN_GROUPS))
    tok = torch.from_numpy(rng.integers(0, gemma.vocab, (
        1, GEMMA_TRAIN_SEQ + 1)).astype(np.int32)).cuda()
    record["gemma3-4b-train-16L"] = {
        **train_run(gemma16, {"tokens": tok[:, :-1].contiguous(),
                              "labels": tok[:, 1:].contiguous()},
                    GEMMA_TRAIN_STEPS - 1, "flash_attention", opt,
                    loss="chunked"),
        "reduced": [f"n_groups {gemma.stack.n_groups} -> "
                    f"{GEMMA_TRAIN_GROUPS} ({gemma16.n_layers} of "
                    f"{gemma.n_layers} layers, the 4-layer tail kept): "
                    f"float32 parameters, gradients and AdamW moments for "
                    f"all 3.88 B parameters are 62 GB, past the card's 80 "
                    f"GB with the activations and the 262,144-wide "
                    f"logits"],
        "loss_note": "the chunked loss (the train step's own option, 8 "
                     "chunks of 512 tokens): the plain loss's float32 "
                     "logits and their gradient (2 x 4.3 GB at 4,096 x "
                     "262,144) ran the card out of memory at 16 layers",
        "data": "numpy tokens below gemma3's vocabulary of 262,144"}
    del tok
    torch.cuda.empty_cache()
    # zamba2-2.7b at full width and depth: 45 Mamba2 layers (their chunk
    # of 128, whose gradients the JAX package's decay matrix turns to NaN)
    # and the shared block's 9 occurrences, every gradient leaf finite
    zamba = get_config(ZAMBA)
    tok = torch.from_numpy(rng.integers(0, zamba.vocab, (
        1, ZAMBA_TRAIN_SEQ + 1)).astype(np.int32)).cuda()
    record["zamba2-2.7b-train"] = {
        **train_run(zamba, {"tokens": tok[:, :-1].contiguous(),
                            "labels": tok[:, 1:].contiguous()},
                    MOE_TRAIN_STEPS - 1, "flash_attention", opt,
                    finite_grads=True),
        "data": "numpy tokens below zamba2's vocabulary of 32,000"}
    del tok
    torch.cuda.empty_cache()
    # mixtral-8x22b at full width on 1 of its 56 layers, on one sequence of
    # twice its window
    mixtral = get_config(MIXTRAL)
    mixtral1 = dataclasses.replace(mixtral, stack=dataclasses.replace(
        mixtral.stack, n_groups=MIXTRAL_TRAIN_GROUPS))
    tok = torch.from_numpy(rng.integers(0, mixtral.vocab, (
        1, MIXTRAL_TRAIN_SEQ + 1)).astype(np.int32)).cuda()
    opt_bf16 = dataclasses.replace(opt, state_dtype=torch.bfloat16)
    record["mixtral-8x22b-train-1L"] = {
        **train_run(mixtral1, {"tokens": tok[:, :-1].contiguous(),
                               "labels": tok[:, 1:].contiguous()},
                    MOE_TRAIN_STEPS - 1, "flash_attention", opt_bf16,
                    finite_grads=True,
                    specs=cut_specs(mixtral, MIXTRAL_TRAIN_GROUPS)),
        "reduced": [f"n_groups {mixtral.stack.n_groups} -> "
                    f"{MIXTRAL_TRAIN_GROUPS} (the weights drawn at the "
                    f"full depth's scale): float32 parameters, gradients "
                    f"and AdamW moments are 16 B a parameter, 46.5 GB for "
                    f"one layer and both tables (2.9 B)",
                    "AdamW moments in bf16 (OptCfg.state_dtype): the "
                    "functional update holds the old and the new state "
                    "at once, 2 x 35 GB with float32 moments and 11.6 GB "
                    "of gradients, past the card's 80 GB (the first such "
                    "run ran out of memory in the update; with bf16 "
                    "moments it still does unless a big leaf is updated "
                    "a slice at a time, train/optimizer.py)"],
        "data": "numpy tokens below mixtral's vocabulary of 32,768"}
    del tok
    torch.cuda.empty_cache()

    # --- checkpoint round trip -------------------------------------------
    two_bf16 = dataclasses.replace(two, compute_dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    step = make_train_step(two_bf16, opt, StepCfg(remat="none"))
    state, _ = step(init_train_state(two_bf16, opt, gen, "cuda"), batch)
    nbytes = sum(v.numel() * v.element_size()
                 for v in tree_leaves(state).values())

    def bits_equal(a, b):
        return all(x.dtype == y.dtype and torch.equal(
            x.view(torch.int32) if x.element_size() == 4 else x,
            y.view(torch.int32) if y.element_size() == 4 else y)
            for x, y in zip(tree_leaves(a).values(), tree_leaves(b).values()))

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        saver = ck.AsyncSaver()
        t0 = time.perf_counter()
        saver.save(state, d, 1)
        handoff_s = time.perf_counter() - t0
        saver.wait()
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored, at = ck.restore_latest(d, state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(at == 1 and bits_equal(restored, state),
              "checkpoint: restore gives the saved state bit for bit")
        check(all(v.is_cuda for v in tree_leaves(restored).values()),
              "checkpoint: restored onto the card")
        after, m_orig = step(state, batch)
        _, m_rest = step(restored, batch)
        check(float(m_orig["loss"]) == float(m_rest["loss"]),
              f"checkpoint: a step from the restored state gives the same "
              f"loss ({float(m_rest['loss'])} vs {float(m_orig['loss'])})")
        del restored
        ck.save(after, d, 2)
        victim = sorted(f for f in os.listdir(os.path.join(
            d, "step_00000002")) if f.endswith(".npy"))[0]
        with open(os.path.join(d, "step_00000002", victim), "r+b") as f:
            f.seek(200)
            f.write(b"\xff\xff\xff\xff")
        fallback, at = ck.restore_latest(d, state)
        check(at == 1 and bits_equal(fallback, state),
              f"checkpoint: a corrupted leaf ({victim}) of step 2 falls "
              f"back to step 1 bit for bit")
        del fallback, after
    record["checkpoint"] = {"state_bytes": nbytes, "handoff_s": handoff_s,
                            "save_s": save_s, "restore_s": restore_s,
                            "loss": float(m_orig["loss"]),
                            "corrupted_leaf": victim}
    del state
    torch.cuda.empty_cache()
    record["seconds"] = time.perf_counter() - t_phase
    emit("train", **record)
    return record


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import mapreduce as mr
    from repro_torch.core import query as q
    from repro_torch.core import schema as sc
    from repro_torch.core import splitting as sp
    from repro_torch.core import upload as up
    from repro_torch.core.parse import format_rows
    from repro_torch.kernels import (_build, block_sort, flash_attention,
                                     hail_reader, index_search, ops,
                                     pax_scan, ref, selective_scan)

    t_run = time.perf_counter()
    # float32 products in full float32: the plain versions are references
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    t0 = time.perf_counter()
    _build.library()
    emit("build", seconds=time.perf_counter() - t0,
         library_seconds=_build.build_seconds,
         ptxas_flash=ptxas_flash(_build.ptxas_log()))

    rng = np.random.default_rng(SEED)
    errs = phase_kernels(rng)
    phase_small_slice()

    # --- 4. eager main path -------------------------------------------------
    t0 = time.perf_counter()
    cols = sc.gen_uservisits(BLOCKS * ROWS, seed=SEED)
    raw = format_rows(sc.USERVISITS, cols, bad_fraction=BAD_FRACTION,
                      seed=SEED + 1).reshape(BLOCKS, ROWS, -1)
    del cols
    gen_s = time.perf_counter() - t0
    query = q.HailQuery(filter=QUICK, projection=("sourceIP",))
    torch.cuda.reset_peak_memory_stats()
    hail, hail_up = up.hail_upload(sc.USERVISITS, raw, list(KEYS),
                                   partition_size=PARTITION, n_nodes=N_NODES)
    hdfs, hdfs_up = up.hdfs_upload(sc.USERVISITS, raw, replication=3,
                                   n_nodes=N_NODES)
    hail_rows, on_hail = rowid_collector()
    clear_launches()
    hail_job = mr.run_job(hail, query, reader="kernels", splitting="hail",
                          on_split_complete=on_hail)
    eager_launches = dict(ops.KERNEL_LAUNCHES)
    hdfs_rows, on_hdfs = rowid_collector()
    hdfs_job = mr.run_job(hdfs, query, on_split_complete=on_hdfs)
    eager_ids = np.sort(np.concatenate(hail_rows))
    check(hail_job.results["n_rows"] == hdfs_job.results["n_rows"],
          "HAIL rows == Hadoop rows")
    check(np.array_equal(eager_ids, np.sort(np.concatenate(hdfs_rows))),
          "HAIL rowid set == Hadoop rowid set")
    check(eager_launches.get("hail_read", 0) == hail_job.n_tasks,
          "one fused reader launch per HAIL split")
    check(eager_launches.get("bitonic_sort", 0) == 0,
          "the eager path sorts with the library sort")
    emit("eager", ascii_bytes=int(raw.size), data_gen_s=gen_s,
         hail_upload_s=hail_up.wall_s, hdfs_upload_s=hdfs_up.wall_s,
         hail_written_bytes=hail_up.written_bytes,
         hail_job_s=hail_job.map_compute_s,
         hdfs_job_s=hdfs_job.map_compute_s,
         hail_tasks=hail_job.n_tasks, hdfs_tasks=hdfs_job.n_tasks,
         hail_bytes_read=hail_job.bytes_read,
         hdfs_bytes_read=hdfs_job.bytes_read,
         rows=hail_job.results["n_rows"], launches=eager_launches,
         peak_mem_bytes=torch.cuda.max_memory_allocated())

    two_kernel_launches = phase_two_kernel_read(hail, query)

    def query_rows(qq):
        rows, on_split = rowid_collector()
        mr.run_job(hail, qq, reader="kernels", on_split_complete=on_split)
        return np.sort(np.concatenate(rows))

    eager_profiles = {
        "hail_job": profile_job(lambda: mr.run_job(hail, query,
                                                   reader="kernels")),
        "hdfs_job": profile_job(lambda: mr.run_job(hdfs, query))}

    # --- 5. shared scan: one split, 8 queries at once vs 8 single reads ----
    qplan = q.plan(hail, query)
    split = max(sp.hail_splits(hail, qplan), key=lambda s: len(s.block_ids))
    los = [7000, 7400, 8000, 9000, 10000, 10500, 11000, 11900]
    queries = [q.HailQuery(filter=("visitDate", lo, lo + 155 + 10 * i),
                           projection=("sourceIP",))
               for i, lo in enumerate(los)]
    with ops.stats_scope() as s:
        batch, _ = q.read_hail_batch(hail, queries, qplan, split.block_ids)
    check(s.dispatches["hail_read"] == 1, "one launch for the batch")
    for qq, res in zip(queries, batch):
        single = q.read_hail_kernels(hail, qq, qplan, split.block_ids)
        check(torch.equal(single.mask, res.mask),
              f"shared-scan mask == single read for {qq.filter}")
    emit("shared", blocks=len(split.block_ids), queries=len(queries),
         rows=[int(r.mask.sum()) for r in batch])

    # --- 5b. server: flushes over both cache tiers, faults, replication ---
    server_launches = phase_hail_server(hail, query_rows)
    # --- 5c. wave: the multi-device wave dispatch on slots of the card ----
    wave_launches = phase_wave(hail, raw, query, eager_ids)
    del hail, hdfs, batch, single
    torch.cuda.empty_cache()

    # --- 6. adaptive: a lazy upload converges over 6 jobs -------------------
    torch.cuda.reset_peak_memory_stats()
    lazy, lazy_up = up.hail_lazy_upload(sc.USERVISITS, raw,
                                        partition_size=PARTITION,
                                        n_nodes=N_NODES)
    cfg = mr.AdaptiveConfig(offer_rate=0.25)
    jobs = []
    clear_launches()
    for _ in range(6):
        rows, on_split = rowid_collector()
        job = mr.run_job(lazy, query, reader="kernels", adaptive=cfg,
                         on_split_complete=on_split)
        check(np.array_equal(np.sort(np.concatenate(rows)), eager_ids),
              "adaptive job rowid set == eager rowid set")
        jobs.append(job)
    adaptive_launches = dict(ops.KERNEL_LAUNCHES)
    curve = [j.full_scan_blocks for j in jobs]
    quantum = mr.adaptive_quantum(lazy, cfg)
    check(curve == [max(BLOCKS - i * quantum, 0) for i in range(6)],
          f"convergence curve {curve}")
    check(all(j.results["n_rows"] == hail_job.results["n_rows"]
              for j in jobs), "adaptive rows == eager rows")
    check(adaptive_launches.get("bitonic_sort", 0) > 0,
          "adaptive builds sort with the sort kernel")
    check(adaptive_launches.get("hail_read", 0) == sum(j.n_tasks
                                                        for j in jobs),
          "one fused reader launch per adaptive split")
    profiles = {
        "adaptive_converged_job": profile_job(lambda: mr.run_job(
            lazy, query, reader="kernels", adaptive=cfg))}
    del lazy
    torch.cuda.empty_cache()
    fresh, _ = up.hail_lazy_upload(sc.USERVISITS, raw,
                                   partition_size=PARTITION, n_nodes=N_NODES)
    profiles["adaptive_first_job"] = profile_job(lambda: mr.run_job(
        fresh, query, reader="kernels", adaptive=cfg))
    emit("adaptive", lazy_upload_s=lazy_up.wall_s, curve=curve,
         blocks_indexed=[j.blocks_indexed for j in jobs],
         tasks=[j.n_tasks for j in jobs],
         job_s=[j.map_compute_s for j in jobs],
         build_s=[j.index_build_s for j in jobs],
         bytes_read=[j.bytes_read for j in jobs],
         launches=adaptive_launches,
         peak_mem_bytes=torch.cuda.max_memory_allocated())
    emit("profile", jobs={**eager_profiles, **profiles})
    del fresh, raw
    torch.cuda.empty_cache()

    # --- 6b. the LM data pipeline: HAIL-selected training batches ---------
    train_batch = phase_data_pipeline()
    torch.cuda.empty_cache()

    # --- 7. serve: llama3.2-1b, falcon-mamba-7b and whisper-medium ---------
    served = {kernel: phase_serve(arch, kernel, rng) for arch, kernel in SERVE}
    whisper = phase_serve(WHISPER, "flash_attention", rng,
                          prompt=WHISPER_PROMPT, frames=WHISPER_FRAMES)
    # h2o-danube-1.8b through ring caches; qwen2-vl-72b on 16 layers
    h2o_served = phase_serve(H2O, "flash_attention", rng, prompt=H2O_PROMPT,
                             check_batch=H2O_CHECK_BATCH)
    qwen_served = phase_serve(QWEN, "flash_attention", rng,
                              groups=QWEN_GROUPS)
    # gemma3-4b and gemma3-12b: rings at the local layers, full caches at
    # the global ones
    gemma4_served = phase_serve(GEMMA4, "flash_attention", rng,
                                prompt=GEMMA_PROMPT,
                                check_batch=GEMMA_CHECK_BATCH)
    gemma12_served = phase_serve(GEMMA12, "flash_attention", rng,
                                 prompt=GEMMA_PROMPT,
                                 check_batch=GEMMA_CHECK_BATCH)
    # mixtral-8x22b on 8 layers through ring caches, arctic-480b on 2
    # layers, zamba2-2.7b at full depth (Mamba2 and the shared block)
    mixtral_served = phase_serve(MIXTRAL, "flash_attention", rng,
                                 prompt=MIXTRAL_PROMPT, groups=MIXTRAL_GROUPS,
                                 check_batch=MIXTRAL_CHECK_BATCH,
                                 check_prompt=MIXTRAL_CHECK_PROMPT)
    arctic_served = phase_serve(ARCTIC, "flash_attention", rng,
                                prompt=ARCTIC_PROMPT, groups=ARCTIC_GROUPS,
                                check_batch=ARCTIC_CHECK_BATCH)
    zamba_served = phase_serve(ZAMBA, "flash_attention", rng,
                               prompt=ZAMBA_PROMPT,
                               check_batch=ZAMBA_CHECK_BATCH)

    # --- 8. times at main-path shapes ---------------------------------------
    # Each case: the kernel's own device time per call from the profiler
    # ("ms", the table's number) and CUDA events around back-to-back calls
    # ("events_ms", which also counts the gaps where the card waits for the
    # host: for calls that launch a few microseconds of work, those gaps
    # are most of it); the same two for the plain version and the library
    # call.
    def case(shape, kernel, plain, bound, match, library=None,
             plain_iters=3):
        ms, ms_by = device_ms(kernel, 20, match)
        plain_ms, plain_by = device_ms(plain, plain_iters)
        library_ms, library_by = (None, None) if library is None else (
            device_ms(library, 20))
        return {"shape": shape,
                "ms": ms,
                "events_ms": cuda_ms(kernel, 20),
                "plain_ms": plain_ms,
                "plain_events_ms": cuda_ms(plain, plain_iters, warmup=1),
                "library_ms": library_ms,
                "library_events_ms": None if library is None else cuda_ms(
                    library, 20),
                "bound_ms": bound[0], "bound_by": bound[1],
                "ms_by": {"ms": ms_by, "plain_ms": plain_by,
                          "library_ms": library_by}}

    ps = ROWS // 512
    timed = {}
    # four rows at 16 and 64 blocks, comparable with earlier runs, then the
    # shapes the paths launch: splits of 1-2 blocks, the server's batches of 8
    # narrow visitDate ranges over (visitDate, sourceIP, __rowid__), the
    # eager job's index scan and the adaptive jobs' lazy full scans
    path_launches = {"server_q8": server_launches.get("hail_read", 0),
                     "eager_q1": eager_launches.get("hail_read", 0),
                     "adaptive_q1": adaptive_launches.get("hail_read", 0)}
    for name, b, q_n, c, mix, ranges in [
            ("full_scan_q1", 16, 1, 2, False, "edges"),
            ("mixed_q1", 16, 1, 2, True, "edges"),
            ("mixed_q8", 16, 8, 2, True, "edges"),
            ("full_scan_q1_64blocks", 64, 1, 2, False, "edges"),
            ("server_q8", 2, 8, 3, True, "server"),
            ("eager_q1", 2, 1, 2, True, "edges"),
            ("adaptive_q1", 1, 1, 2, False, "edges")]:
        uidx = (np.arange(b) % 3 != 2) if mix else np.zeros(b, bool)
        inputs = reader_inputs(rng, b, ROWS, 512, c, q_n, uidx, ranges)
        out = hail_reader.hail_read_batch(*inputs, partition_size=ps)
        scan = ("index scan" if uidx.all() else "mixed index" if mix
                else "full scan")
        timed[name] = case(
            f"B={b} R={ROWS} P=512 C={c} Q={q_n} {scan}"
            + (", phase 5b's ranges" if ranges == "server" else ""),
            lambda: hail_reader.hail_read_batch(*inputs, partition_size=ps),
            lambda: ref.hail_read_batch(*inputs, partition_size=ps),
            reader_bound(inputs, out, ps), "reader_kernel")
        if name in path_launches:
            timed[name]["launches_on_path"] = path_launches[name]
        del inputs, out
    for b in (1, 16, BLOCKS):           # a repair, a build, add_replica
        keys = sort_inputs(rng, b, ROWS)
        timed[f"sort_{b}x2^19"] = case(
            f"({b}, {ROWS}) int32", lambda: block_sort.bitonic_sort(keys),
            lambda: block_sort.bitonic_sort_plain(keys), sort_bound(keys),
            None, library=lambda: torch.sort(keys, dim=-1, stable=True))
    # the flash rows: the key each is counted under on the main paths
    # (filled in after phase 9 from the launches counted by shape)
    flash_keys = {}

    def flash_key(name, kernel, what, q, k, causal, window=None):
        flash_keys[name] = (f"{kernel}: "
                            + flash_attention.launch_key(what, q, k, causal,
                                                         window))

    q, k, v = attn_inputs(SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 32, 8, 64,
                          torch.bfloat16)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    timed["flash_llama_prefill"] = case(
        "q (4,512,32,64) k/v (4,512,8,64) bf16 causal",
        lambda: flash_attention.flash_attention(q, k, v),
        lambda: ref.attention(q, k, v), attn_bound(q, k, v, True, None),
        "flash_bf16_kernel",
        library=lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
    flash_key("flash_llama_prefill", "flash_attention", "fwd", q, k, True)
    # the training forward at the same shape: lse and the float32 output
    # written too
    timed["flash_fwd_llama_train"] = case(
        "q (4,512,32,64) k/v (4,512,8,64) bf16 causal, lse and float32 O",
        lambda: flash_attention.flash_attention_fwd(q, k, v),
        lambda: ref.attention_lse(q, k, v),
        attn_lse_bound(q, k, v, True, None), "flash_bf16_kernel")
    flash_key("flash_fwd_llama_train", "flash_attention", "fwd+lse", q, k,
              True)
    del q, k, v, qt, kt, vt
    inputs = scan_inputs(SERVE_BATCH, SERVE_PROMPT, 8192, 16)
    timed["scan_falcon_prefill"] = case(
        "delta/x (4,512,8192) b/c (4,512,16) a (8192,16) f32",
        lambda: selective_scan.selective_scan(*inputs),
        lambda: ref.selective_scan(*inputs),
        scan_bound(inputs[0], inputs[2]), KERNEL_NAMES["selective_scan"])
    del inputs
    # the backward kernels at the train shapes; the library call for flash
    # is PyTorch's SDPA backward (its graph kept, so only the backward runs)
    q, k, v = attn_inputs(TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 32, 8, 64,
                          torch.bfloat16)
    do = upstream_grad(q)
    _, lse, o32 = flash_attention.flash_attention_fwd(q, k, v)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True)
    do_t = do.transpose(1, 2)
    timed["flash_bwd_llama_train"] = case(
        "q/o/dO (4,512,32,64) k/v (4,512,8,64) bf16 causal",
        lambda: flash_attention.flash_attention_bwd(q, k, v, o32, lse, do),
        lambda: ref.attention_bwd(q, k, v, o32, lse, do),
        flash_bwd_bound(q, k, v, True, None), "flash_bwd",
        library=lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), do_t,
                                            retain_graph=True))
    flash_key("flash_bwd_llama_train", "flash_attention_bwd",
              "bwd from float32 O", q, k, True)
    del q, k, v, do, o32, lse, qt, kt, vt, sdpa_out, do_t
    # whisper's compute-bound shapes, non-causal: the encoder's (4, 1500)
    # in prefill and training, and cross-attention from the prefill's 224
    # and the training's 448 decoder tokens: the serving forward with SDPA
    # (is_causal=False) beside it, the training forward (lse and the
    # float32 O), and the backward with SDPA's backward beside it
    for name, t, s, serve, train in [
            ("encoder", WHISPER_FRAMES, WHISPER_FRAMES, True, True),
            ("cross", WHISPER_PROMPT, WHISPER_FRAMES, True, False),
            ("cross_train", WHISPER_TRAIN_SEQ, WHISPER_FRAMES, False, True)]:
        q, k, v = attn_inputs(SERVE_BATCH, t, s, 16, 16, 64, torch.bfloat16)
        shape = f"q (4,{t},16,64) k/v (4,{s},16,64) bf16 non-causal"
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        if serve:
            timed[f"flash_whisper_{name}"] = case(
                shape,
                lambda: flash_attention.flash_attention(q, k, v,
                                                        causal=False),
                lambda: ref.attention(q, k, v, causal=False),
                attn_bound(q, k, v, False, None), "flash_bf16_kernel",
                library=lambda: torch.nn.functional.
                scaled_dot_product_attention(qt, kt, vt, is_causal=False))
            flash_key(f"flash_whisper_{name}", "flash_attention", "fwd", q,
                      k, False)
        if train:
            timed[f"flash_fwd_whisper_{name}"] = case(
                shape + ", lse and float32 O",
                lambda: flash_attention.flash_attention_fwd(q, k, v,
                                                            causal=False),
                lambda: ref.attention_lse(q, k, v, causal=False),
                attn_lse_bound(q, k, v, False, None), "flash_bf16_kernel",
                plain_iters=1)
            flash_key(f"flash_fwd_whisper_{name}", "flash_attention",
                      "fwd+lse", q, k, False)
            do = upstream_grad(q)
            _, lse, o32 = flash_attention.flash_attention_fwd(
                q, k, v, causal=False)
            sdpa_out = torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=False)
            do_t = do.transpose(1, 2)
            timed[f"flash_bwd_whisper_{name}"] = case(
                shape.replace("q (", "q/o/dO ("),
                lambda: flash_attention.flash_attention_bwd(
                    q, k, v, o32, lse, do, causal=False),
                lambda: ref.attention_bwd(q, k, v, o32, lse, do,
                                          causal=False),
                flash_bwd_bound(q, k, v, False, None), "flash_bwd",
                library=lambda: torch.autograd.grad(
                    sdpa_out, (qt, kt, vt), do_t, retain_graph=True),
                plain_iters=1)
            flash_key(f"flash_bwd_whisper_{name}", "flash_attention_bwd",
                      "bwd from float32 O", q, k, False)
            del do, lse, o32, sdpa_out, do_t
        del q, k, v, qt, kt, vt
    # head dims 80 and 128.  h2o-danube's windowed prefill (4 x 8,192 of
    # window 4,096) and its training forward and backward (1 x 8,192); the
    # plain versions there at one prompt (the forward) or at 8 of the 32
    # heads (the training rows, H2O_PLAIN_HEADS): their float32 scores take
    # 8.6 GB a copy a prompt at all 32.  SDPA takes the window as a boolean
    # band attn_mask over K/V expanded to the query heads outside the timed
    # call, and so also computes the masked pairs that the kernels skip.
    # qwen2-vl's causal prefill (4 x 512, 64 heads over 8) and the backward
    # at that shape, beside SDPA (is_causal, enable_gqa) and its backward.
    b_, t_, s_, h_, kv_, d_, _, win, dt_ = H2O_PREFILL_ATTN
    q, k, v = attn_inputs(b_, t_, s_, h_, kv_, d_, dt_)
    band = ref._band(t_, s_, True, win, "cuda")
    qt = q.transpose(1, 2)
    kt, vt = (x.repeat_interleave(h_ // kv_, dim=2).transpose(1, 2)
              for x in (k, v))
    timed["flash_h2o_prefill"] = case(
        "q (4,8192,32,80) k/v (4,8192,8,80) bf16 causal window 4096 "
        "(plain: q (1,8192,32,80), one of the 4 prompts)",
        lambda: flash_attention.flash_attention(q, k, v, window=win),
        lambda: ref.attention(q[:1], k[:1], v[:1], window=win),
        attn_bound(q, k, v, True, win), "flash_bf16_kernel",
        library=lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=band), plain_iters=1)
    flash_key("flash_h2o_prefill", "flash_attention", "fwd", q, k, True,
              win)
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    b_, t_, s_, h_, kv_, d_, _, win, dt_ = H2O_TRAIN_ATTN
    q, k, v = attn_inputs(b_, t_, s_, h_, kv_, d_, dt_)
    do = upstream_grad(q)
    _, lse, o32 = flash_attention.flash_attention_fwd(q, k, v, window=win)
    part = plain_parts(H2O_TRAIN_ATTN)[0]
    few = [part_of(part, x) for x in (q, o32, do)]
    kv2 = [part_of(part, x, True) for x in (k, v)]
    timed["flash_fwd_h2o_train"] = case(
        "q (1,8192,32,80) k/v (1,8192,8,80) bf16 causal window 4096, lse "
        "and float32 O (plain: q (1,8192,8,80) k/v (1,8192,2,80))",
        lambda: flash_attention.flash_attention_fwd(q, k, v, window=win),
        lambda: ref.attention_lse(few[0], *kv2, window=win),
        attn_lse_bound(q, k, v, True, win), "flash_bf16_kernel",
        plain_iters=1)
    flash_key("flash_fwd_h2o_train", "flash_attention", "fwd+lse", q, k,
              True, win)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (
        q, k.repeat_interleave(h_ // kv_, dim=2),
        v.repeat_interleave(h_ // kv_, dim=2)))
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=band)
    do_t = do.transpose(1, 2)
    timed["flash_bwd_h2o_train"] = case(
        "q/o/dO (1,8192,32,80) k/v (1,8192,8,80) bf16 causal window 4096 "
        "(plain: q (1,8192,8,80) k/v (1,8192,2,80))",
        lambda: flash_attention.flash_attention_bwd(q, k, v, o32, lse, do,
                                                    window=win),
        lambda: ref.attention_bwd(few[0], *kv2, few[1],
                                  part_of(part, lse), few[2],
                                  window=win),
        flash_bwd_bound(q, k, v, True, win), "flash_bwd",
        library=lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), do_t,
                                            retain_graph=True),
        plain_iters=1)
    flash_key("flash_bwd_h2o_train", "flash_attention_bwd",
              "bwd from float32 O", q, k, True, win)
    del q, k, v, do, lse, o32, few, kv2, qt, kt, vt, sdpa_out, do_t
    del band
    torch.cuda.empty_cache()
    b_, t_, s_, h_, kv_, d_, _, _, dt_ = QWEN_ATTN
    q, k, v = attn_inputs(b_, t_, s_, h_, kv_, d_, dt_)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    timed["flash_qwen_prefill"] = case(
        "q (4,512,64,128) k/v (4,512,8,128) bf16 causal",
        lambda: flash_attention.flash_attention(q, k, v),
        lambda: ref.attention(q, k, v), attn_bound(q, k, v, True, None),
        "flash_bf16_kernel",
        library=lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
    flash_key("flash_qwen_prefill", "flash_attention", "fwd", q, k, True)
    do = upstream_grad(q)
    _, lse, o32 = flash_attention.flash_attention_fwd(q, k, v)
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True)
    do_t = do.transpose(1, 2)
    timed["flash_bwd_qwen"] = case(
        "q/o/dO (4,512,64,128) k/v (4,512,8,128) bf16 causal",
        lambda: flash_attention.flash_attention_bwd(q, k, v, o32, lse, do),
        lambda: ref.attention_bwd(q, k, v, o32, lse, do),
        flash_bwd_bound(q, k, v, True, None), "flash_bwd",
        library=lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), do_t,
                                            retain_graph=True))
    flash_key("flash_bwd_qwen", "flash_attention_bwd", "bwd from float32 O",
              q, k, True)
    del q, k, v, do, lse, o32, qt, kt, vt, sdpa_out, do_t
    torch.cuda.empty_cache()
    # head dim 256: gemma3's prefill at a global (causal) and a local
    # (window 1,024) layer of the 4b and the 12b, and the 4b's training
    # forward (lse and float32 O) and backward at both, the plain versions
    # whole.  SDPA: causal with GQA at the global layers; at the local ones
    # a boolean band attn_mask over K/V expanded to the query heads (it
    # then computes the masked pairs too), as h2o-danube's rows.
    for name, shape in (
            ("flash_gemma4_prefill_global", GEMMA4_PREFILL_ATTN),
            ("flash_gemma4_prefill_local", GEMMA4_PREFILL_LOCAL_ATTN),
            ("flash_gemma12_prefill_global", GEMMA12_PREFILL_ATTN),
            ("flash_gemma12_prefill_local", GEMMA12_PREFILL_LOCAL_ATTN),
            ("gemma4_train_global", GEMMA4_TRAIN_ATTN),
            ("gemma4_train_local", GEMMA4_TRAIN_LOCAL_ATTN)):
        b_, t_, s_, h_, kv_, d_, _, win, dt_ = shape
        q, k, v = attn_inputs(b_, t_, s_, h_, kv_, d_, dt_)
        desc = (f"q ({b_},{t_},{h_},{d_}) k/v ({b_},{s_},{kv_},{d_}) bf16 "
                f"causal" + ("" if win is None else f" window {win}"))
        if win is None:
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                          for x in (q, k, v))
            sdpa_kw = dict(is_causal=True, enable_gqa=True)
        else:
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                          for x in (q, k.repeat_interleave(h_ // kv_, dim=2),
                                    v.repeat_interleave(h_ // kv_, dim=2)))
            sdpa_kw = dict(attn_mask=ref._band(t_, s_, True, win, "cuda"))

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, **sdpa_kw)

        if name.startswith("flash_"):
            timed[name] = case(
                desc, lambda: flash_attention.flash_attention(q, k, v,
                                                              window=win),
                lambda: ref.attention(q, k, v, window=win),
                attn_bound(q, k, v, True, win), "flash_bf16_kernel",
                library=sdpa, plain_iters=1)
            flash_key(name, "flash_attention", "fwd", q, k, True, win)
        else:
            timed[f"flash_fwd_{name}"] = case(
                desc + ", lse and float32 O",
                lambda: flash_attention.flash_attention_fwd(q, k, v,
                                                            window=win),
                lambda: ref.attention_lse(q, k, v, window=win),
                attn_lse_bound(q, k, v, True, win), "flash_bf16_kernel",
                library=sdpa, plain_iters=1)
            flash_key(f"flash_fwd_{name}", "flash_attention", "fwd+lse", q,
                      k, True, win)
            do = upstream_grad(q)
            _, lse, o32 = flash_attention.flash_attention_fwd(q, k, v,
                                                              window=win)
            sdpa_out = sdpa()
            do_t = do.transpose(1, 2)
            timed[f"flash_bwd_{name}"] = case(
                desc.replace("q (", "q/o/dO ("),
                lambda: flash_attention.flash_attention_bwd(
                    q, k, v, o32, lse, do, window=win),
                lambda: ref.attention_bwd(q, k, v, o32, lse, do,
                                          window=win),
                flash_bwd_bound(q, k, v, True, win), "flash_bwd",
                library=lambda: torch.autograd.grad(
                    sdpa_out, (qt, kt, vt), do_t, retain_graph=True),
                plain_iters=1)
            flash_key(f"flash_bwd_{name}", "flash_attention_bwd",
                      "bwd from float32 O", q, k, True, win)
            del do, lse, o32, sdpa_out, do_t
        del q, k, v, qt, kt, vt, sdpa_kw
        torch.cuda.empty_cache()
    # GQA 48/8 (mixtral, windowed), 56/8 (arctic) and 32/32 at head dim 80
    # (zamba2's shared block): each model's prefill and the training
    # forward and backward of mixtral and zamba2, the plain versions on
    # plain_parts; SDPA causal with GQA, or a band attn_mask over K/V
    # expanded to the query heads at mixtral's window
    for name, shape in (
            ("flash_mixtral_prefill", MIXTRAL_PREFILL_ATTN),
            ("flash_arctic_prefill", ARCTIC_PREFILL_ATTN),
            ("flash_zamba_prefill", ZAMBA_PREFILL_ATTN),
            ("mixtral_train", MIXTRAL_TRAIN_ATTN),
            ("zamba_train", ZAMBA_TRAIN_ATTN)):
        b_, t_, s_, h_, kv_, d_, _, win, dt_ = shape
        q, k, v = attn_inputs(b_, t_, s_, h_, kv_, d_, dt_)
        part = plain_parts(shape)[0]
        qp, kp, vp = (part_of(part, q), part_of(part, k, True),
                      part_of(part, v, True))
        desc = (f"q ({b_},{t_},{h_},{d_}) k/v ({b_},{s_},{kv_},{d_}) bf16 "
                f"causal" + ("" if win is None else f" window {win}"))
        plain_desc = ("" if qp.shape == q.shape else
                      f" (plain: q {tuple(qp.shape)} k/v {tuple(kp.shape)})")
        if win is None:
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                          for x in (q, k, v))
            sdpa_kw = dict(is_causal=True, enable_gqa=True)
        else:
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                          for x in (q, k.repeat_interleave(h_ // kv_, dim=2),
                                    v.repeat_interleave(h_ // kv_, dim=2)))
            sdpa_kw = dict(attn_mask=ref._band(t_, s_, True, win, "cuda"))

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, **sdpa_kw)

        if name.startswith("flash_"):
            timed[name] = case(
                desc + plain_desc,
                lambda: flash_attention.flash_attention(q, k, v, window=win),
                lambda: ref.attention(qp, kp, vp, window=win),
                attn_bound(q, k, v, True, win), "flash_bf16_kernel",
                library=sdpa, plain_iters=1)
            flash_key(name, "flash_attention", "fwd", q, k, True, win)
        else:
            timed[f"flash_fwd_{name}"] = case(
                desc + ", lse and float32 O" + plain_desc,
                lambda: flash_attention.flash_attention_fwd(q, k, v,
                                                            window=win),
                lambda: ref.attention_lse(qp, kp, vp, window=win),
                attn_lse_bound(q, k, v, True, win), "flash_bf16_kernel",
                library=sdpa, plain_iters=1)
            flash_key(f"flash_fwd_{name}", "flash_attention", "fwd+lse", q,
                      k, True, win)
            do = upstream_grad(q)
            _, lse, o32 = flash_attention.flash_attention_fwd(q, k, v,
                                                              window=win)
            o32p, lsep, dop = (part_of(part, o32), part_of(part, lse),
                               part_of(part, do))
            sdpa_out = sdpa()
            do_t = do.transpose(1, 2)
            timed[f"flash_bwd_{name}"] = case(
                desc.replace("q (", "q/o/dO (") + plain_desc,
                lambda: flash_attention.flash_attention_bwd(
                    q, k, v, o32, lse, do, window=win),
                lambda: ref.attention_bwd(qp, kp, vp, o32p, lsep, dop,
                                          window=win),
                flash_bwd_bound(q, k, v, True, win), "flash_bwd",
                library=lambda: torch.autograd.grad(
                    sdpa_out, (qt, kt, vt), do_t, retain_graph=True),
                plain_iters=1)
            flash_key(f"flash_bwd_{name}", "flash_attention_bwd",
                      "bwd from float32 O", q, k, True, win)
            del do, lse, o32, o32p, lsep, dop, sdpa_out, do_t
        del q, k, v, qp, kp, vp, qt, kt, vt, sdpa_kw
        torch.cuda.empty_cache()
    repair_cost = float32_o_cost(flash_attention)
    torch.cuda.empty_cache()
    inputs = scan_inputs(TRAIN_BATCH, TRAIN_SEQ, 8192, 16)
    dy = upstream_grad(inputs[0])
    timed["scan_bwd_falcon_train"] = case(
        "delta/x/dy (4,512,8192) b/c (4,512,16) a (8192,16) f32, "
        "no dh_final",
        lambda: selective_scan.selective_scan_bwd(*inputs, dy),
        lambda: ref.selective_scan_bwd(*inputs, dy),
        scan_bwd_bound(inputs[0], inputs[2], False), "scan_bwd",
        plain_iters=1)
    del inputs, dy
    torch.cuda.empty_cache()

    # the two primitives with their bounds on the card, as a caller that
    # keeps them there passes them: each call also stacks the pair (one
    # small launch), which "ms" leaves out
    def on_card(*xs):
        return [torch.tensor(x, dtype=torch.int32, device="cuda") for x in xs]

    mins = search_inputs(rng, BLOCKS, 512)
    lohi = on_card(*QUICK[1:])
    timed["index_search_64x512"] = case(
        f"mins ({BLOCKS}, 512) int32, (lo, hi) on the card",
        lambda: index_search.index_search(mins, *lohi),
        lambda: index_search.index_search_plain(mins, *lohi),
        search_bound(mins), "search_kernel", plain_iters=20)
    keys, proj = scan_block_inputs(rng, ROWS, 2, torch.int32)
    lohi = on_card(2000, 4999)
    mask = pax_scan.pax_scan(keys, proj, *lohi)[0]
    timed["pax_scan_2^19x2"] = case(
        f"key ({ROWS},) proj ({ROWS}, 2) int32, {int(mask.sum())} rows "
        f"kept, (lo, hi) on the card",
        lambda: pax_scan.pax_scan(keys, proj, *lohi),
        lambda: pax_scan.pax_scan_plain(keys, proj, *lohi),
        pax_bound(keys, proj, mask, 1024), "scan_kernel", plain_iters=20)
    del keys, proj, mask
    emit("times", cases=timed, float32_o_cost=repair_cost,
         profiler_misses=PROFILER_MISSES)

    # --- 9. train: gradients through the kernels, two models trained -------
    trained = phase_train(train_batch)
    train_launches = collections.Counter()
    for name in ("llama3.2-1b-train", "falcon-mamba-7b-train-8L",
                 "whisper-medium-train", "h2o-danube-1.8b-train",
                 "gemma3-4b-train-16L", "zamba2-2.7b-train",
                 "mixtral-8x22b-train-1L"):
        train_launches.update(trained[name]["launches"])
    # the flash rows' launches on the main paths, as counted by shape:
    # each serving prefill, and each training run's counted steps
    # (qwen2-vl is not trained: its backward shape runs in phase 9's bf16
    # gradient check of one of its layers)
    qwen_layer = next(r for r in trained["layers_bf16"] if r["arch"] == QWEN)
    by_path = {"llama3.2-1b prefill":
               served["flash_attention"]["launches_prefill_by_shape"],
               "whisper-medium prefill": whisper["launches_prefill_by_shape"],
               "h2o-danube-1.8b prefill":
               h2o_served["launches_prefill_by_shape"],
               f"qwen2-vl-72b prefill ({QWEN_GROUPS} layers)":
               qwen_served["launches_prefill_by_shape"],
               "gemma3-4b prefill": gemma4_served["launches_prefill_by_shape"],
               "gemma3-12b prefill":
               gemma12_served["launches_prefill_by_shape"],
               f"mixtral-8x22b prefill ({MIXTRAL_GROUPS} layers)":
               mixtral_served["launches_prefill_by_shape"],
               f"arctic-480b prefill ({ARCTIC_GROUPS} layers)":
               arctic_served["launches_prefill_by_shape"],
               "zamba2-2.7b prefill":
               zamba_served["launches_prefill_by_shape"],
               **{f"{name} ({len(trained[name]['step_s'])} counted steps)":
                  trained[name]["launches_by_shape"]
                  for name in ("llama3.2-1b-train", "whisper-medium-train",
                               "h2o-danube-1.8b-train",
                               "gemma3-4b-train-16L", "zamba2-2.7b-train",
                               "mixtral-8x22b-train-1L")},
               "qwen2-vl-72b one layer's bf16 gradients (phase 9)":
               qwen_layer["launches_by_shape"]}
    for name, key in flash_keys.items():
        timed[name]["launch_key"] = key
        timed[name]["launches_on_path"] = {
            path: counts[key] for path, counts in by_path.items()
            if key in counts}
        check(bool(timed[name]["launches_on_path"]),
              f"phase 8's {name} ({key}) was launched on no main path")
    flash_fields = ("shape", "ms", "events_ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "library_events_ms", "ms_by",
                    "launch_key", "launches_on_path")

    reader, sort = timed["full_scan_q1"], timed["sort_1x2^19"]
    reader_shapes = {k: {f: timed[k].get(f) for f in (
        "shape", "ms", "events_ms", "plain_ms", "bound_ms", "bound_by",
        "ms_by", "launches_on_path")}
        for k in ("full_scan_q1", "mixed_q8", "server_q8", "eager_q1",
                  "adaptive_q1")}
    sort_shapes = {k: {f: timed[k][f] for f in ("shape", "ms", "events_ms",
                                                 "library_ms",
                                                 "library_events_ms",
                                                 "bound_ms", "ms_by")}
                   for k in ("sort_1x2^19", "sort_16x2^19",
                             f"sort_{BLOCKS}x2^19")}
    flash, scan = timed["flash_llama_prefill"], timed["scan_falcon_prefill"]
    flash_bwd = timed["flash_bwd_llama_train"]
    scan_bwd = timed["scan_bwd_falcon_train"]
    search, pax = timed["index_search_64x512"], timed["pax_scan_2^19x2"]
    kernels = [
        {"name": "hail_read", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/hail_reader.cu",
         "replaces": "src/repro/kernels/hail_reader.py:48",
         "launches": eager_launches.get("hail_read", 0)
         + server_launches.get("hail_read", 0)
         + wave_launches.get("hail_read", 0)
         + adaptive_launches.get("hail_read", 0),
         "max_abs_err": errs["hail_read"], "ms": reader["ms"],
         "plain_ms": reader["plain_ms"], "bound_ms": reader["bound_ms"],
         "bound_by": reader["bound_by"], "library_ms": None,
         "shape": reader["shape"], "ms_by": reader["ms_by"],
         "shapes": reader_shapes},
        {"name": "bitonic_sort", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/block_sort.cu",
         "replaces": "src/repro/kernels/block_sort.py:51",
         "launches": server_launches.get("bitonic_sort", 0)
         + wave_launches.get("bitonic_sort", 0)
         + adaptive_launches.get("bitonic_sort", 0),
         "max_abs_err": errs["bitonic_sort"], "ms": sort["ms"],
         "plain_ms": sort["plain_ms"], "bound_ms": sort["bound_ms"],
         "bound_by": sort["bound_by"], "library_ms": sort["library_ms"],
         "shape": sort["shape"], "ms_by": sort["ms_by"],
         "shapes": sort_shapes},
        {"name": "index_search", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/index_search.cu",
         "replaces": "src/repro/kernels/index_search.py:22",
         "launches": two_kernel_launches.get("index_search", 0),
         "max_abs_err": errs["index_search"], "ms": search["ms"],
         "plain_ms": search["plain_ms"], "bound_ms": search["bound_ms"],
         "bound_by": search["bound_by"], "library_ms": None,
         "shape": search["shape"], "ms_by": search["ms_by"]},
        {"name": "pax_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/pax_scan.cu",
         "replaces": "src/repro/kernels/pax_scan.py:23",
         "launches": two_kernel_launches.get("pax_scan", 0),
         "max_abs_err": errs["pax_scan"], "ms": pax["ms"],
         "plain_ms": pax["plain_ms"], "bound_ms": pax["bound_ms"],
         "bound_by": pax["bound_by"], "library_ms": None,
         "shape": pax["shape"], "ms_by": pax["ms_by"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:25",
         "launches": sum(r["launches"].get("flash_attention", 0) for r in (
             served["flash_attention"], whisper, h2o_served, qwen_served,
             gemma4_served, gemma12_served, mixtral_served, arctic_served,
             zamba_served))
         + train_launches["flash_attention"],
         "max_abs_err": errs["flash_attention"], "ms": flash["ms"],
         "plain_ms": flash["plain_ms"], "bound_ms": flash["bound_ms"],
         "bound_by": flash["bound_by"], "library_ms": flash["library_ms"],
         "shape": flash["shape"], "ms_by": flash["ms_by"],
         "launch_key": flash["launch_key"],
         "launches_on_path": flash["launches_on_path"],
         "shapes": {k: {f: timed[k].get(f) for f in flash_fields}
                    for k in ("flash_fwd_llama_train",
                              "flash_whisper_encoder",
                              "flash_fwd_whisper_encoder",
                              "flash_whisper_cross",
                              "flash_fwd_whisper_cross_train",
                              "flash_h2o_prefill", "flash_fwd_h2o_train",
                              "flash_qwen_prefill",
                              "flash_gemma4_prefill_global",
                              "flash_gemma4_prefill_local",
                              "flash_gemma12_prefill_global",
                              "flash_gemma12_prefill_local",
                              "flash_fwd_gemma4_train_global",
                              "flash_fwd_gemma4_train_local",
                              "flash_mixtral_prefill",
                              "flash_arctic_prefill", "flash_zamba_prefill",
                              "flash_fwd_mixtral_train",
                              "flash_fwd_zamba_train")},
         "float32_o_cost": repair_cost},
        {"name": "selective_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/selective_scan.cu",
         "replaces": "src/repro/kernels/selective_scan.py:28",
         "launches": served["selective_scan"]["launches"].get(
             "selective_scan", 0) + train_launches["selective_scan"],
         "max_abs_err": errs["selective_scan"], "ms": scan["ms"],
         "plain_ms": scan["plain_ms"], "bound_ms": scan["bound_ms"],
         "bound_by": scan["bound_by"], "library_ms": None,
         "shape": scan["shape"], "ms_by": scan["ms_by"]},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
         "replaces": "src/repro/kernels/flash_attention.py:25",
         "backward_of": "flash_attention (the JAX package differentiates "
                        "plain jnp; no Pallas backward)",
         "launches": train_launches["flash_attention_bwd"],
         "max_abs_err": errs["flash_attention_bwd"], "ms": flash_bwd["ms"],
         "plain_ms": flash_bwd["plain_ms"],
         "bound_ms": flash_bwd["bound_ms"],
         "bound_by": flash_bwd["bound_by"],
         "library_ms": flash_bwd["library_ms"],
         "shape": flash_bwd["shape"], "ms_by": flash_bwd["ms_by"],
         "launch_key": flash_bwd["launch_key"],
         "launches_on_path": flash_bwd["launches_on_path"],
         "shapes": {k: {f: timed[k].get(f) for f in flash_fields}
                    for k in ("flash_bwd_whisper_encoder",
                              "flash_bwd_whisper_cross_train",
                              "flash_bwd_h2o_train", "flash_bwd_qwen",
                              "flash_bwd_gemma4_train_global",
                              "flash_bwd_gemma4_train_local",
                              "flash_bwd_mixtral_train",
                              "flash_bwd_zamba_train")}},
        {"name": "selective_scan_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/selective_scan_bwd.cu",
         "replaces": "src/repro/kernels/selective_scan.py:28",
         "backward_of": "selective_scan (the JAX package differentiates "
                        "plain jnp; no Pallas backward)",
         "launches": train_launches["selective_scan_bwd"],
         "max_abs_err": errs["selective_scan_bwd"], "ms": scan_bwd["ms"],
         "plain_ms": scan_bwd["plain_ms"], "bound_ms": scan_bwd["bound_ms"],
         "bound_by": scan_bwd["bound_by"], "library_ms": None,
         "shape": scan_bwd["shape"], "ms_by": scan_bwd["ms_by"]},
    ]
    emit("done", seconds=time.perf_counter() - t_run)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def profiler_window(fn, iters: int, match: str,
                    settle: bool) -> tuple[int, int]:
    """One profiled window of ``iters`` calls -> (device events traced,
    calls traced of the kernels whose name holds ``match``); ``settle``
    waits ``PROFILER_SETTLE_S`` after the profiler starts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if settle:
            time.sleep(PROFILER_SETTLE_S)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    return len(device), sum(e.count for e in device if match in e.key)


def profiler_probe(rounds: int) -> int:
    """``python3 chip_smoke.py --profiler-probe [ROUNDS]``: how often the
    profiler loses device work.  Opens ``rounds`` windows of each case
    (``index_search`` and ``pax_scan`` at phase 8's inputs, and the plain
    ``pax_scan``) in three modes — 20 calls, 200 calls, and 20 calls that
    start ``PROFILER_SETTLE_S`` after the profiler does — and prints one
    JSON line: per case and mode, the windows that traced no device event
    and how many of the kernel's calls each window traced; then the
    card's name and power limit.  Needs one CUDA card."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import collections
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, index_search, pax_scan

    _build.library()
    rng = np.random.default_rng(SEED)
    mins = search_inputs(rng, BLOCKS, 512)
    keys, proj = scan_block_inputs(rng, ROWS, 2, torch.int32)
    lohi = [torch.tensor(x, dtype=torch.int32, device="cuda")
            for x in (2000, 4999)]
    # (call, name of the kernel whose traced calls are counted)
    cases = {
        "index_search": (lambda: index_search.index_search(mins, *lohi),
                         "search_kernel"),
        "pax_scan": (lambda: pax_scan.pax_scan(keys, proj, *lohi),
                     "scan_kernel"),
        "pax_scan_plain": (lambda: pax_scan.pax_scan_plain(keys, proj,
                                                           *lohi),
                           "reduce_kernel"),
    }
    modes = {"20": (20, False), "200": (200, False), "20_settled": (20, True)}
    for fn, _ in cases.values():
        fn()
    torch.cuda.synchronize()
    empty = {f"{c}/{m}": [] for c in cases for m in modes}
    calls = {f"{c}/{m}": collections.Counter() for c in cases for m in modes}
    t0 = time.perf_counter()
    for r in range(rounds):
        for c, (fn, match) in cases.items():
            for m, (iters, settle) in modes.items():
                n_events, n_calls = profiler_window(fn, iters, match, settle)
                if n_events == 0:
                    empty[f"{c}/{m}"].append(r)
                calls[f"{c}/{m}"][n_calls] += 1
    print(json.dumps({"rounds": rounds, "windows": rounds * len(empty),
                      "empty": {k: len(v) for k, v in empty.items()},
                      "empty_rounds": {k: v for k, v in empty.items() if v},
                      # traced calls of the kernel a window -> windows
                      "calls": {k: dict(v) for k, v in calls.items()},
                      "seconds": time.perf_counter() - t0,
                      "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    print(nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--profiler-probe"]:
        sys.exit(profiler_probe(int(sys.argv[2]) if len(sys.argv) > 2
                                else 60))
    sys.exit(main())
