#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the port's CUDA kernels from ``src/repro_torch/csrc`` for
   ``sm_90a`` from three spawned processes at once, as the agents of a
   process-mode job meet them (on a cold ``build/`` exactly one must
   compile, the build's file lock holding the others until they load
   its library), and turns TF32 off for matmuls and convolutions;
3. holds each kernel against its plain PyTorch version on the card, at
   the split-NN path's shapes (R = 512 rows a round) and at the JAX
   package's kernel-test shapes: attention within 2e-5 (f32) / 2e-2
   (bf16), int8 quantization exactly; and at the edges of the two
   tensor-core kernels: attention at sq / sk of 1, 17, 64, 511 and 513,
   causal and not, windows ending inside a key tile, sq != sk down to
   rows that see no key, f32 and bf16; the grouped matmul at capacities
   1, 4, 16 and 17 with d and f that are not multiples of 8, and with d
   split across blocks, within 2e-4 (f32) / 5e-2 (bf16); attention at
   head dims of no compiled width (5, 8, 12, 24, 48, 192, 300),
   bidirectional and causal, f32 and bf16, at sq = sk of 8 and 100.
   Each check names the kernel variant it ran (``simt`` /
   ``mma_3xtf32`` / ``mma_bf16``; ``stream`` / ``mma_*``); attention at
   sq = sk = 4096 (head dim 128 causal, head dim 80 with a window of
   4096, q at its spread and at 3x it) within 2e-5; a NaN in q or in x
   (0 / 0 on the card, 0x7FFFFFFF, 0xFFFFFFFF) must come out NaN
   exactly where the plain version's does, in every variant; an
   inf in x or in w of the grouped matmul must give the plain version's
   +-inf and NaN at the same places, in every variant, and so must an
   inf in v of attention's tensor-core variant at granite's prefill
   shape, bidirectional and causal (where a query tile skips the key
   tiles past its diagonal and the kernel's fix-up gives the NaN the
   plain version's 0 * inf makes there); int8 quantization bit for bit
   at the path's (4096, 64), at (1,048,576, 64), at widths of the vector and
   the scalar variant and on a misaligned view;
4. serves the paper's vfl-recsys workload at its published scale
   (190,439 users, a 1,345-feature master silo with 19 items, a
   381-feature member silo on 60% of the users) with the benchmarked
   transformer tower ``embed + attn_block + quantize + mlp`` in both
   parties, random weights from a seed, through ``VFLJob`` and
   ``FederatedServer``: 16 caller threads send 8 queries each of 64
   matched rows (some repeated); every answer must be finite (64, 19)
   scores, each kernel must have launched twice per federated round (the
   master's bottom tower and the member's), a lone query must be
   bit-identical to offline ``predict`` of its rows, and the served
   scores must agree with the same model run on the plain versions;
   then a tower of the DSL's defaults (``embed``, ``attn_block``:
   head dim 8) in both parties: ``predict`` of 64 rows, two launches of
   each kernel, scores within 5e-3 of the plain versions (and, after
   step 9, trains the demo tower through ``VFLJob.fit``: one epoch at
   pipeline depth 1 and one at depth 2, lr 0.3, exactly 3 launches of
   each kernel a round and 2 of attention's backward kernel (the
   tower's attention gradient), finite and falling losses,
   rounds/s and epoch wall time, the device's busy share over a
   profiled epoch, the first 16 losses within rtol 1e-3 of the same job
   on the plain versions, and the tower's attention backward at (512,
   4, 8, 16): the backward kernel within 1e-4 of the plain VJP, its
   device time beside the plain VJP's (what the tower ran before) and
   SDPA's backward alone; then the other execution modes:
   ``socket_proc``, every party its own OS process and CUDA context
   over localhost TCP, one epoch at depth 1 and 2 with each worker's
   launches counted by a driver callback (1 of each kernel a round in
   the master, 2 in the member, 1 of attention's backward in each)
   and the depth-1 losses within rtol 1e-6 of thread mode's, 16 rounds
   each of ``process`` at depth 2 and ``socket`` and ``grpc`` at depth 1
   against thread mode's losses at the same tolerance, and secure
   aggregation over the member's silo split in two: 16 rounds and two
   masked predicts within 1e-3 of the same weights predicted unmasked;
   then phase 4e, the cluster launcher: test certificates minted with
   ``launch/certs.py`` (TLS whenever the ``openssl`` CLI is there), the
   committed ``examples/cluster`` specs loaded and validated, the
   quickstart spec at the demo's published scale (phase 4c's protocol,
   ``demo_silos`` as its data provider) run by two ``ClusterLauncher``s,
   every agent its own process and CUDA context over TLS'd gRPC framing:
   fit (224 rounds, first and last loss within rtol 1e-6 of thread
   mode's), evaluate and a serve window queried through ``ServeClient``,
   each agent's launches counted in its own process; an elastic restart
   (member0 crashed by ``[chaos]`` at step 5, respawned by ``[restart]``,
   every round completing); the privacy matrix of
   ``repro_torch.attacks.runner`` on the card and on the CPU, gated by
   ``benchmarks/check_regression.py --privacy``);
5. times each kernel, its plain version and, for attention,
   ``scaled_dot_product_attention`` (a yardstick only: the port never
   calls it) with CUDA events at the path's shapes; quantize also at
   (1,048,576, 64), with its launch floor at both shapes (an empty
   kernel on its grid, a copy of the same bytes);
6. serves ``rwkv6-7b`` from the model zoo at full width and depth (32
   layers, d_model 4096, 8.9 B params, 35.5 GB in f32, random weights
   drawn on the card from a seed) through ``ServeEngine``: the WKV
   kernel first against its plain version at the prefill shape
   (4, 64, 511, 64), at the JAX package's kernel-test shapes and at
   head dims 16, 48, 5, 128 and 130 (and 65 over 65,537 heads), within
   5e-5 (f32) / 5e-2 (bf16);
   then ``score`` of a (4, 512) token batch, which must launch the WKV
   kernel once per layer (32 times) and give a finite loss;
   teacher-forced ``decode_step`` logits of one 64-token sequence (a path
   with no WKV kernel) against ``forward`` logits within 2e-3; greedy
   ``generate`` of 16 tokens from 4 prompts of 16; it prints the prefill
   and decode tokens/s, runs the timed ``score`` and ``generate`` once
   more under ``torch.profiler`` to print where their device time goes
   (the WKV kernel, matmuls, the rest; the top kernels) and the device's
   busy share, and times the WKV kernel as in step 5;
7. serves ``granite-moe-3b-a800m`` from the model zoo at full width and
   depth (32 layers, d_model 1536, 24 query and 8 KV heads of 64, 40
   experts top-8 of width 512, vocab 49155; 3.37 B params, 13.5 GB in
   f32, drawn on the card from a seed) after the rwkv6-7b weights are
   freed: the grouped-expert-matmul kernel first against its plain
   version at the path's four shapes (gate/up and down at the
   prefill's capacity 512 and at decode's capacity 4) and at the JAX package's
   kernel-test shapes, within 2e-4 (f32) / 5e-2 (bf16), and the
   flash-attention kernel at the prefill shape (causal, GQA 3:1) within
   2e-5; then ``score`` of a (4, 512) batch, which must give a finite
   loss with exactly 96 grouped-matmul launches (3 a layer) and 32
   flash-attention launches; the same ``score`` with group-local
   dispatch (``moe_group_dispatch``), again 96 launches; decode-vs-
   prefill logits over 64 tokens within 2e-3 at the capacity where no
   assignment drops (``capacity_factor`` = 40 / 8); greedy ``generate``
   of 16 tokens from 4 prompts of 16; prefill and decode tokens/s and
   the same profiles as step 6 (device time of the grouped matmul, the
   attention kernel, matmuls and the rest); and it times both kernels
   at the path's shapes as in step 5, beside ``torch.bmm`` and SDPA;
8. holds the flash-attention kernel at head dim 80 against its plain
   version at ``h2o-danube-1.8b``'s prefill shape (q (4, 32, 511, 80),
   k/v (4, 8, 511, 80), causal, window 4096) within 2e-5, draws the
   full 24-layer model in f32 (1.83 B params, 7.3 GB) and runs one
   ``score`` of a (4, 512) batch, which must give a finite loss with
   exactly 24 attention launches (decode and the profile are left out
   to save time), then times the kernel at that shape beside SDPA;
9. serves one period of ``jamba-1.5-large-398b`` at full width (d_model
   8192, d_inner 16384, d_state 16, dt_rank 512; 64 query and 8 KV
   heads of 128, no RoPE; experts of width 24576 top-2; vocab 65536),
   cut in depth from 72 to 8 layers (7 Mamba, 1 attention; 4 MoE, 4
   dense FFNs) and in experts from 16 to 4, which it prints: 16.25 B
   params, 65.0 GB in f32, drawn on the card once the other weights
   are freed. First the selective-scan kernel against its plain
   version at the path's shape (4, 512, 16384, n 16), within 2e-5 of
   the output's largest magnitude (512 sequential steps of f32
   rounding), and at the JAX package's kernel-test shapes and state
   dims 1, 5, 32 and 100 (no config's) within 2e-5 (f32) / 3e-2
   (bf16); the grouped matmul at the path's four shapes
   and attention at (4, 64, 512, 128) causal GQA 8:1 as in step 7.
   Then ``score`` of a (4, 513) batch (512 tokens a row, a length the
   JAX package's chunked scan takes), which must give a finite loss
   with exactly 7 scan, 12 grouped-matmul and 1 attention launches;
   decode vs prefill within 2e-3 at ``capacity_factor`` 4 / 2; greedy
   ``generate`` (12 grouped-matmul launches a step, no scan, no
   attention kernel); tokens/s and the profiles as in step 6, with a
   ``scan`` kind; the scan's times (no PyTorch call computes it) beside
   its byte bound and its special-function floor (b s di n ``ex2`` at 16
   a clock on each of 132 SMs, at the SM clock ``nvidia-smi`` reads),
   and the grouped matmul and attention at jamba's shapes; and the
   phase's wall time;
9b. serves ``deepseek-v2-lite-16b`` at full width and depth (27 layers:
   a dense prefix layer of d_ff 10944, then 26 of multi-head latent
   attention (MLA: kv_lora 512, no q-LoRA, 16 heads of q/k 128 + 64 and
   v 128) and 64 experts top-6 of width 1408 with 2 shared; vocab
   102400; 15.7 B params, 62.8 GB in f32, drawn on the card after
   jamba's weights are freed), as step 7 serves granite: the grouped
   matmul at the path's four shapes (capacity 240 in prefill, 4 in
   decode) within 2e-4 and attention at (4, 16, 511, 192) causal with
   v's columns past 128 zero, as the MLA call pads them (the SIMT
   kernel), within 2e-5; ``score`` of a (4, 512) batch with exactly 27
   attention and 78 grouped-matmul launches; decode (the absorbed form
   over the latent cache) vs prefill within 2e-3 at ``capacity_factor``
   64 / 6; greedy ``generate`` (78 grouped-matmul launches a step, no
   attention kernel); tokens/s, profiles, peak memory, and both
   kernels' times beside ``torch.bmm`` and SDPA (which takes v of 128
   itself); then ``minicpm3-4b`` as step 8 runs h2o-danube: attention at
   (4, 40, 511, 96), v past 64 zero (the tensor-core kernel at width
   128), and one ``score`` of the full 62 layers (4.26 B params, 17.0
   GB) with exactly 62 attention launches;
9c. serves the encoder-decoder ``whisper-large-v3`` at full width and
   depth (32 encoder layers over 1,500 frames, 32 decoder layers with
   cross-attention; d_model 1280, 20 heads of 64, d_ff 5120, vocab
   51866; 1.60 B params, 6.41 GB in f32, drawn on the card after the
   MLA weights are freed): attention at its four shapes within 2e-5 of
   the plain version, naming each variant (the encoder's bidirectional
   (4, 20, 1500, 64), whose 1,500 keys end in a partial tile;
   cross-attention in prefill, q of 448 against 1,500 keys; the
   decoder's causal (4, 20, 448, 64); cross-attention in a decode step,
   one query against 1,500 keys, the SIMT kernel), and the encoder's
   shape with infs in v (the plain version's +-inf and NaN exactly);
   ``encode`` of (4, 1500, 1280) frames with exactly 32 attention
   launches; ``make_prefill_step`` of (4, 448) tokens with the frames
   with exactly 96; decode vs prefill over 16 positions within 2e-3;
   greedy ``generate`` of 64 tokens after 4 with 32 attention launches
   a decode step and finite logits; encode ms, prefill and decode
   tokens/s, the profiled busy shares of the prefill and of one decode
   step, device time by kind, peak memory, and the kernel's times at
   the four shapes beside its plain version and SDPA;
9d. serves the vision-language ``internvl2-76b`` at full width (d_model
   8192, 64 query and 8 KV heads of 128, d_ff 28672, vocab 128256, RoPE
   theta 500,000), cut in depth from 80 to 16 layers (15.8 B params,
   63.2 GB in f32, drawn on the card after whisper's weights are freed):
   attention at the prefill's q (4, 64, 768, 128) against k/v (4, 8,
   768, 128), causal, within 2e-5; ``make_prefill_step`` of (4, 512)
   tokens behind (4, 256, 8192) patch embeddings (the vision encoder is
   a stub in both packages), 768 positions a row, with exactly 16
   attention launches; one ``loss_fn``, finite, whose 256 prefix
   positions carry no loss (other labels under them leave it bit for
   bit); greedy ``generate`` of 16 tokens from 4 prompts of 16 (the text
   path, as the JAX package's engine decodes); ``score`` raising;
   tokens/s, the busy share, peak memory and the kernel's times at that
   shape beside SDPA;
10. trains ``granite-moe-3b-a800m`` at full width and depth (32 layers,
   3.37 B params; AdamW and remat "minimal", its config's; f32) after
   every other phase has freed its weights: attention's backward kernel
   (``csrc/flash_attention_bwd.cu``; on the tensor cores where the
   forward takes them, from the forward's row log-sum-exp)
   first against autograd through the plain attention at granite's
   training shape (the route ``mma_3xtf32`` asserted), causal, with a
   window of 128 and at head dim 80, dq, dk and dv each within 1e-4 of
   the largest gradient, and at its edges (rows that see no key, sq <
   sk, head dims 5 to 300, the split-NN tower's call, bf16 within
   2e-2), each case's route printed, its log-sum-exp within 1e-5 of the
   plain one, the forward's output the same to the bit with and without
   it, and two runs of the backward the same to the bit; dx and dw of
   the grouped matmul's ``Function`` (the forward
   kernel twice) against autograd through ``gmm_ref`` within 2e-4 at the
   step's two shapes. Then one step's loss and gradients with the
   kernels and with the plain versions at the same params (the routing's
   top-k picks of the kernel step replayed in the plain one, and the
   tokens whose own picks differ counted): losses within rtol 1e-5,
   every gradient present and within 1e-3 of its leaf's largest, and the
   kernel step's launches exact (attention 64: the forward and its remat
   recomputation, its backward 32, the grouped matmul 384); ``train()``
   for 2 warm-up and 8 timed steps of (4, 512) batches of
   ``make_lm_batches``: step time, tokens/s, peak device memory, launches
   a step, a finite loss lower at the end, model-FLOPs utilisation
   against 67 TFLOP/s (f32, TF32 off), and one more step under
   ``torch.profiler`` (busy share, device time by kind); the checkpoint
   round trip of ``examples/train_lm.py`` at full width and 2 layers
   (train with a ``ckpt_dir``, restore, the same loss within 1e-5, the
   params bit for bit); ``python -m repro_torch.examples.train_lm`` on
   the card for 8 steps (its falling loss and resume check, exact
   launches); and the times of the backward kernel (beside the f32-FMA
   route it replaced there, in turns, the plain VJP and SDPA's backward
   alone) and of the grouped matmul at the step's dx and dw shapes;
   then (phases 10g-10j)
   the recurrences' backward kernels (``csrc/rwkv6_wkv_bwd.cu``,
   ``csrc/selective_scan_bwd.cu``), through the ``autograd.Function``s
   that ``rwkv6_wkv`` and ``selective_scan`` apply to CUDA inputs that
   require grad, against autograd through the plain versions in float64
   at rwkv6-7b's (4, 64, 511, 64) and jamba's (4, 512, 16384, 16), every
   gradient within 1e-4 of its largest magnitude, and at edges (ragged
   lengths, masked head and state dims, bf16 within 1e-2), two backward
   runs the same to the bit; their times beside the plain VJPs, the
   bound and the design's own byte floor (checkpoint reads included),
   and the forwards with and without the checkpoints they write under
   grad; then ``rwkv6-7b`` cut in depth 32 -> 8 (AdamW)
   and jamba's first two layers (mamba + mlp, mamba + MoE of 4 experts;
   its adafactor) trained at full width as granite is: a kernel step
   against a plain step (gradients within 1e-4 of each leaf's largest),
   ``train()`` for 10 steps with a falling loss and exact launches, a
   profiled step; then (phase 10k) attention's backward kernel at the
   training shapes of the encoder-decoder and the vision prefix
   (whisper's bidirectional encoder (4, 20, 1500, 64), its decoder's
   causal (4, 20, 448, 64) and its cross-attention, q of 448 against
   1,500 keys; internvl2's q (4, 64, 768, 128) against k/v (4, 8, 768,
   128), causal), each on the ``mma_3xtf32`` route (asserted), within
   1e-4 of the plain VJP's largest gradient, its lse within 1e-5, two
   runs the same to the bit, and timed beside the plain VJP and SDPA's
   backward alone; then ``whisper-large-v3`` (AdamW, (4, 448) tokens and
   (4, 1500, 1280) frames) and ``internvl2-76b`` cut 80 -> 4 layers
   (Adafactor, (4, 512) tokens behind (4, 256, 8192) patches) trained at
   full width as granite is: a kernel step against a plain step
   (whisper's at 8 + 8 layers; gradients within 1e-4 of each leaf's
   largest), exact launches (whisper: 160 attention and 96 of its
   backward a step, an encoder layer's once, a decoder layer's self- and
   cross-attention twice each), ``train()`` for 10 steps (whisper at 32
   + 32 layers) with a falling loss, frames/s or patches/s beside
   tokens/s, and a profiled step;
11. runs the sharded paths with every mesh position on this card
   (``cuda:0`` repeated: every split, partial product and combine runs,
   in one process, no ``torch.distributed``): the bench tower
   (``benchmarks/bench_tower.py``'s embed + attn_block of 4 heads + mlp,
   48 features) and the demo's member bottom at its published widths
   (381 -> 256 -> 128), 512 rows, over a model axis of 2 and of 4
   (``make_tower_rules(m, devices=...)``, ``shard_tower``,
   ``apply(..., rules)``, ``split_nn.member_step(..., rules)``): forward
   and member step within rtol 1e-5 / atol 1e-6 of the unsharded,
   exactly m attention launches an attn_block a pass, the kernel at the
   per-shard shapes (512, 2, 8, 16) and (512, 1, 8, 16) within 2e-5 of
   its plain version, exactly m launches of its backward kernel an
   attn_block a member step, and timed beside it and SDPA, and ms of a sharded
   and an unsharded member step; mesh-mode VFL (``make_mesh_vfl_step``)
   at the paper's widths (1,345 master features, the member's 381 padded
   to them, bottom 256 -> 128, top (128, 64, 19), batch 4,096), 2 pods,
   20 steps masked and unmasked, each loss within rtol 1e-5 of a plain
   unsharded step's; ``granite-moe-3b-a800m`` at full width and depth
   drawn once: its decode with ``decode_partial_softmax`` under rules of
   a (2, 4) data x model mesh (the KV cache's 32 slots in 4 slices)
   against the plain decode over 4 prompts of 16 and 16 greedy tokens,
   logits within 2e-3, exactly 96 grouped-matmul launches a step and no
   attention kernel; then ``repro_torch.examples.vfl_llm`` on it (2
   silos, B 8, 16 soft tokens): the first step with the kernels and
   masks against the plain versions unmasked (loss within rtol 1e-5,
   every gradient within 1e-4 of its leaf's largest, the routing
   replayed), exact launches (attention 64 and its backward 32, the
   grouped matmul 384 a step), 8 SGD steps (step ms, tokens/s, peak
   memory, whether the loss fell); and attention forward and backward
   and the grouped matmul (forward, dx, dw) at that path's shapes
   against their plain versions, timed beside SDPA (attention's backward
   beside SDPA's backward alone) and ``torch.bmm``;
12. runs the zoo's train and prefill steps on meshes of more than one
   device, every position on this card (``launch/steps.py`` with
   ``MeshRules``; the kernels held to their plain versions and timed at
   each shard's shapes first): granite-moe-3b-a800m on data 2 x model 2
   against the unsharded step at 8 layers and alone at 8, h2o-danube
   at 6 of 24 layers, glm4's prefill on 1 x 4 at 20 layers; rwkv6-7b at 8
   layers, the jamba cut with Adafactor and deepseek-v2-lite-16b at 4
   layers on 2 x 2 against their unsharded steps, rwkv6-7b's prefill on
   1 x 4 at 16 layers against the unsharded step in float64;
   whisper-large-v3 at 8 + 8 layers (its encoder and cross-attention
   over the rows) and internvl2-76b cut to 1 layer (its 256 patches
   with their rows, Adafactor) on 2 x 2 against their unsharded steps,
   and both models' prefill on 1 x 4 (whisper at full depth, internvl2
   at 4 layers): loss, gradients, updated params and logits within
   their tolerances, two sharded runs bit-equal, launches exact, step
   ms sharded and unsharded, peak memory, busy share; and the same
   checks with the sequence split (``act_rules["seq"]``: each row's
   residual stream as sequence cells over ``model`` between layers),
   held to the same unsharded references, launches equal to the unsplit
   steps': granite's step at 8 layers (12k), rwkv6-7b's (12l) and
   internvl2's prefill on 1 x 4 (12m, its 256 patches spanning two
   cells of 192), with the residual stream's bytes a position holds
   between layers with and without the split;
13. prints all kernels in one ``kernels`` JSON line with each kernel's
   least possible time (bytes over the memory rate, or operations over
   the peak of the kernel's arithmetic route: 495 / 3 TFLOP/s for f32
   on the tensor cores in 3xTF32, 989 for bf16 on them, 67 for f32
   FMAs; eight kernels: the five forward ports and the backward kernels
   of attention, WKV and the scan), the variant each
   path's shape ran, its launches on each path and a training round,
   then
   ``{"ok": true, "device": {...}}`` as its last line.

Any failure raises and the script exits non-zero; it needs the repo's
``src/repro_torch`` beside it and a CUDA device, and prints no result
without them. It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# the split-NN path's round: R rows through each party's bottom tower
ROUNDS_ROWS = 512
HEADS, TOKENS, DIM = 4, 8, 64
CALLERS, QUERIES, QUERY_ROWS = 16, 8, 64
# phase 4e's queries to the cluster's serve window
CLUSTER_SERVE_CALLERS, CLUSTER_SERVE_QUERIES = 4, 8

# H100 SXM peaks (NVIDIA's data sheet): device memory rate; the float32
# rate outside the tensor cores (the WKV, scan and quantize kernels, and
# the FMA variants of attention and the grouped matmul); the tensor
# cores' f32-accurate rate in 3xTF32, three TF32 passes of 495 TFLOP/s;
# their bf16 rate
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
TF32X3_FLOP_S = 495e12 / 3
BF16_FLOP_S = 989e12

# the model-zoo phase: rwkv6-7b at full width and depth, f32
ZOO_ARCH = "rwkv6-7b"
SCORE_BATCH, SCORE_TOKENS = 4, 512        # score() prefills 511 of them
CONSIST_TOKENS = 64
GEN_BATCH, GEN_PROMPT, GEN_NEW = 4, 16, 16
# the profiled decode window: prompt tokens and new tokens, 7 decode steps
# of the timed generate's 31
PROFILE_GEN = (4, 4)
# substrings of the cuBLAS / CUTLASS kernel names the profile counts as
# matmuls
MATMUL_MARKS = ("gemm", "gemv", "cutlass", "xmma")
WKV_CASES = [
    # b, h, s, dh, dtype name (tests/test_kernels.py)
    (1, 2, 64, 32, "float32"),
    (2, 4, 128, 64, "float32"),
    (1, 2, 128, 32, "bfloat16"),
    # head dims of no config: 16 in the width of 32, 48 and 5 in that
    # of 64 (f32 and bf16), 128 and 130 in the plain kernel
    (1, 2, 64, 16, "float32"),
    (1, 2, 100, 48, "float32"),
    (1, 2, 64, 48, "bfloat16"),
    (1, 2, 40, 128, "float32"),
    (1, 1, 37, 5, "float32"),
    (1, 1, 20, 130, "float32"),
    # more (batch, head) pairs than a grid's y dimension takes (65535)
    (1, 65537, 1, 65, "float32"),
]

# the MoE phase: granite-moe-3b-a800m at full width and depth, f32
MOE_ARCH = "granite-moe-3b-a800m"
GMM_CASES = [
    # e, c, d, f, dtype name (tests/test_kernels.py), then capacities,
    # depths and widths no tile divides
    (4, 128, 64, 96, "float32"),
    (8, 256, 128, 128, "float32"),
    (2, 128, 128, 64, "bfloat16"),
    (3, 37, 50, 33, "float32"),
    (3, 37, 50, 33, "bfloat16"),
    (2, 65, 24, 72, "bfloat16"),
]

# the head-dim-80 check: h2o-danube-1.8b at full width and depth, f32
H2O_ARCH = "h2o-danube-1.8b"

# the Mamba phase: one 8-layer period of jamba-1.5-large-398b at full
# width with 4 of its 16 experts, f32 (65.0 GB of weights on one card)
JAMBA_ARCH = "jamba-1.5-large-398b"
JAMBA_LAYERS, JAMBA_EXPERTS = 8, 4
# a (4, 513) score prefills 512 tokens a row, a length the JAX
# package's chunked ssm_scan takes (511 is not)
JAMBA_SCORE_TOKENS = 513
SSM_CASES = [
    # b, s, di, n, dtype of dt/B/C, dtype of u (tests/test_kernels.py),
    # then a ragged length and width with u of its own dtype
    (1, 64, 32, 8, "float32", "float32"),
    (2, 128, 64, 16, "float32", "float32"),
    (1, 256, 32, 4, "bfloat16", "bfloat16"),
    (3, 37, 200, 16, "float32", "bfloat16"),
    # state dims of no config: masked registers (1, 5, 32) and the
    # looped wide path (100)
    (2, 37, 200, 1, "float32", "float32"),
    (2, 37, 200, 5, "float32", "float32"),
    (2, 37, 200, 32, "float32", "float32"),
    (2, 37, 72, 100, "float32", "float32"),
]

# the MLA phase: deepseek-v2-lite-16b at full width and depth, f32 (62.8
# GB of weights on one card), served as the MoE phase serves granite;
# then one cold score of the full minicpm3-4b (62 layers, 17.0 GB)
MLA_ARCH = "deepseek-v2-lite-16b"
MINICPM_ARCH = "minicpm3-4b"

# the encoder-decoder phase: whisper-large-v3 at full width and depth,
# f32 (6.41 GB of weights): frames of (4, 1500, 1280), a prefill of 448
# tokens (its published decoder context), decode vs prefill over 16
# positions, greedy generate of 64 tokens after a prompt of 4
INTERNVL_ARCH = "internvl2-76b"
# depth 80 -> 16 (15.8 B params, 63.2 GB in f32); 512 text tokens a row
# behind the 256 patch embeddings
INTERNVL_LAYERS, INTERNVL_TEXT = 16, 512
WHISPER_ARCH = "whisper-large-v3"
WHISPER_BATCH, WHISPER_TOKENS = 4, 448
WHISPER_CONSIST = 16
WHISPER_PROMPT, WHISPER_NEW = 4, 64

# the language-model training phase: granite-moe-3b-a800m at full width,
# AdamW (its config's optimizer) and remat "minimal" (its config's), f32;
# (4, 512) batches of make_lm_batches; 2 warm-up and 8 timed steps
LM_ARCH = MOE_ARCH
LM_LAYERS = 32
LM_BATCH, LM_SEQ = 4, 512
LM_WARMUP, LM_TIMED = 2, 8
LM_LR = 3e-4
# the checkpoint round trip's depth (full width): params and AdamW state
# of 2 layers, 4.2 GB on disk, where 32 layers would write 54 GB
LM_CKPT_LAYERS = 2
# phase 10g: the recurrences' backward kernels at the training path's
# shapes (rwkv6-7b (b, h, s, dh) of a (4, 512) score's 511 tokens, a
# length no multiple of the chunk; jamba's (b, s, di, n) of a (4, 512)
# batch), then at edges: ragged lengths, masked head and state dims, bf16
WKV_GRAD_CASES = [(4, 64, 511, 64, "float32"), (2, 3, 37, 32, "float32"),
                  (1, 2, 17, 48, "float32"), (2, 2, 9, 5, "float32"),
                  (1, 2, 40, 64, "bfloat16")]
SCAN_GRAD_CASES = [(4, 512, 16384, 16, "float32", "float32"),
                   (2, 37, 200, 16, "float32", "float32"),
                   (1, 64, 130, 8, "float32", "float32"),
                   (2, 21, 64, 4, "float32", "float32"),
                   (1, 33, 100, 5, "float32", "float32"),
                   (2, 48, 256, 16, "bfloat16", "bfloat16")]
# phase 10e': steps of ``python -m repro_torch.examples.train_lm``
TRAIN_LM_STEPS = 8
# phase 10i: rwkv6-7b trained at depth 32 -> 8 (~42 GB with AdamW's state)
RWKV_TRAIN_LAYERS = 8
# phase 10k: whisper-large-v3 trained at full width and depth (32 + 32)
# at LM_LR, its kernel-vs-plain step at 8 + 8 layers (the plain attention
# keeps (4, 20, 1500, 1500) f32 probabilities for each encoder layer,
# which no remat wraps: 32 of them do not fit beside the params);
# internvl2-76b at full width cut 80 -> 4 layers (~22 GB of params,
# untied 4.2 GB embed and lm_head)
WHISPER_CHECK_LAYERS = 8
INTERNVL_TRAIN_LAYERS = 4
# internvl2's rate: LM_LR scaled by granite's widest fan-in over
# internvl2's (1,536 / 28,672). Adafactor's first updates move every
# weight by about lr whatever its gradient, so a matmul's output moves by
# about lr x its fan-in of its size (more for wq, whose init takes d x
# heads as its fan-in); at LM_LR, and at 5.625e-5 and 3e-5, internvl2's
# 10-step loss rose or spiked above its batches' initial losses, at this
# rate and at 1e-5 it stayed below them (PERF.md, PR 28)
INTERNVL_TRAIN_LR = 1.6e-5
# attention's gradient checks at granite's training shapes: causal, a
# window shorter than the sequence, and a head dim of no power of two
ATT_GRAD_CASES = [
    # b, h, kvh, s, dh, window; causal, f32
    (LM_BATCH, 24, 8, LM_SEQ, 64, 0),
    (LM_BATCH, 24, 8, LM_SEQ, 64, 128),
    (LM_BATCH, 24, 8, LM_SEQ, 80, 0),
]
# and at its edges: rows that see no key (sq > sk with a window; causal
# and not; bf16), sq < sk, head dims in the widths of 32, 256 and 512
# and of no compiled width (5, 20), one head a kv group (the tensor-core
# route's direct dk / dv), a bidirectional short tower call, bf16
# (against the plain VJP in f32)
ATT_GRAD_EDGE_CASES = [
    # b, h, kvh, sq, sk, dh, causal, window, dtype
    (1, 4, 2, 300, 100, 32, True, 37, "float32"),
    (1, 4, 2, 300, 100, 32, False, 37, "float32"),
    (2, 2, 2, 17, 513, 128, True, 0, "float32"),
    (1, 2, 1, 70, 70, 200, True, 0, "float32"),
    (1, 2, 2, 40, 40, 300, False, 0, "float32"),
    (512, 4, 4, 8, 8, 16, False, 0, "float32"),
    (1, 4, 2, 100, 100, 5, False, 0, "float32"),
    (1, 4, 2, 100, 90, 20, False, 0, "float32"),
    (2, 4, 4, 200, 200, 128, False, 0, "float32"),
    (1, 4, 2, 256, 256, 64, True, 0, "bfloat16"),
    (1, 4, 2, 130, 70, 80, True, 30, "bfloat16"),
]

# quantize_int8: the path's (8R, 64), a shape where bytes dominate (256
# MiB in, past the 50 MB L2), widths of whole 16-byte chunks (the vector
# variant) and not (the scalar one), bf16, and a view 4 bytes into its
# storage (the scalar variant at the path's width)
QUANT_LARGE_ROWS = 1 << 20
QUANT_CASES = [
    # rows, d, dtype name, offset of x into its storage in elements
    (TOKENS * ROUNDS_ROWS, DIM, "float32", 0),
    (QUANT_LARGE_ROWS, DIM, "float32", 0), (300, 64, "float32", 0),
    (7, 1000, "float32", 0), (513, 96, "bfloat16", 0),
    (5, 36, "bfloat16", 0), (4096, 66, "float32", 0),
    (33, 520, "float32", 0), (TOKENS * ROUNDS_ROWS, DIM, "float32", 1)]

# training: the demo's split-NN learning rate (examples/vfl_recsys_demo.py)
# and the rounds held against the plain versions
TRAIN_LR = 0.3
TRAIN_CHECK_ROUNDS = 16

TOWER = ("embed:tokens=8,dim=64", "attn_block:heads=4", "quantize",
         "mlp:hidden=64")
TOP_TOWER = ("mlp:hidden=64,final_act=0",)
# the tower DSL's defaults: embed dim 32 and 4 heads, head dim 8
DEFAULT_TOWER = ("embed", "attn_block", "quantize", "mlp")

ATT_CASES = [
    # b, h, kvh, s, dh, causal, window, dtype name (tests/test_kernels.py)
    (2, 4, 2, 256, 64, True, 0, "float32"),
    (1, 4, 4, 128, 32, True, 64, "float32"),
    (2, 2, 1, 128, 128, False, 0, "float32"),
    (1, 8, 2, 512, 64, True, 128, "float32"),
    (1, 2, 2, 256, 64, True, 0, "bfloat16"),
    # h2o-danube-1.8b's head dim of 80
    (2, 8, 2, 96, 80, True, 64, "float32"),
    (1, 4, 4, 33, 80, False, 0, "bfloat16"),
]
# the attention kernel's edges: lengths around its 16-row SIMT / 64-row
# tensor-core switch and its 64-key tiles, causal or not, in f32 and
# bf16; windows that end inside a key tile; sq != sk, down to rows that
# see no key at all (a window shorter than sq - sk)
ATT_EDGE_CASES = [
    (1, 4, 2, s, s, 64, causal, 0, dt)
    for s in (1, 17, 64, 511, 513) for causal in (True, False)
    for dt in ("float32", "bfloat16")] + [
    # b, h, kvh, sq, sk, dh, causal, window, dtype
    (1, 4, 2, 511, 511, 80, True, 100, "float32"),
    (1, 4, 2, 511, 511, 80, False, 100, "float32"),
    (1, 4, 1, 513, 513, 128, True, 100, "bfloat16"),
    (2, 2, 2, 513, 513, 128, True, 0, "float32"),
    (1, 4, 2, 17, 513, 128, True, 0, "float32"),
    (1, 4, 2, 513, 17, 64, False, 8, "float32"),
    (1, 2, 2, 300, 200, 32, True, 37, "bfloat16"),
    (1, 2, 1, 100, 100, 16, True, 0, "float32"),
] + [
    # head dims of no compiled width: in the next wider one (8 the DSL's
    # default tower's, 24, 48; 5 and 12 staged element by element), and
    # above 128 on the SIMT kernel (192 MLA's qk, 300 in the width of
    # 512); bidirectional and causal, f32 and bf16, SIMT and tensor-core
    # lengths
    (1, 4, 2, s, s, dh, causal, 0, dt)
    for dh in (5, 8, 12, 24, 48, 192, 300) for s in (8, 100)
    for causal in (False, True) for dt in ("float32", "bfloat16")]
# long rows, as h2o-danube's window of 4096 and jamba's and granite's
# contexts give them: 3 sk / 8 tensor-core sums a row in f32; q at 3x
# its spread peaks the softmax, so the output is of v's size, where the
# tensor cores' truncating sums would show most
ATT_LONG_CASES = [
    # b, h, kvh, s, dh, window, q scale; causal, f32
    (1, 2, 1, 4096, 128, 0, 1.0),
    (1, 2, 1, 4096, 128, 0, 3.0),
    (1, 2, 1, 4096, 80, 4096, 1.0),
    (1, 2, 1, 4096, 80, 4096, 3.0),
]
# the grouped matmul's edges: capacities around its stream (c <= 16) /
# tensor-core switch; d and f that are not multiples of 8 (f32 copies
# 16-byte chunks where they are multiples of 4, bf16 falls back to plain
# loads); d long enough to be split across blocks
GMM_EDGE_CASES = [
    (3, c, d, f, dt) for c in (1, 4, 16, 17) for d, f in ((50, 33),
                                                          (1000, 36))
    for dt in ("float32", "bfloat16")] + [
    (2, 4, 4096, 96, "float32"),
    (2, 300, 200, 300, "float32"),
]


def log(*a) -> None:
    print(*a, flush=True)


_T0 = time.perf_counter()


def mark(what: str) -> None:
    """Log the script's elapsed wall time at the end of a phase."""
    log(f"elapsed {time.perf_counter() - _T0:.1f} s: {what} done")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _event_ms(run, per: int, trials: int) -> float:
    import torch
    times = []
    for _ in range(trials):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        run()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / per)
    return statistics.median(times)


def eager_ms(fn, reps: int = 200, trials: int = 15) -> float:
    """Median over ``trials`` of the mean time of ``reps`` back-to-back
    eager calls, from CUDA events: what a caller pays per call, host
    dispatch included when the host is the slower side."""
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()
    return _event_ms(run, reps, trials)


def graph_ms(fn, reps: int = 100, trials: int = 15) -> float:
    """Median over ``trials`` of the mean device time of ``reps`` calls
    captured in one CUDA graph and replayed, from CUDA events: the
    kernels' own time, without the host's dispatch (the port's
    ``launch.attention_turns.graph_ms``)."""
    from repro_torch.launch.attention_turns import graph_ms as replayed
    return replayed(fn, reps, trials)


def _bound(nbytes: float, ops: float, rate: float = F32_FLOP_S) -> dict:
    """The least time of a call: ``nbytes`` over the memory rate or
    ``ops`` over ``rate``, the peak of the arithmetic route the function
    can take (f32 FMAs, 3xTF32 or bf16 tensor cores), whichever is
    longer."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / rate * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "op_rate_tflop_s": rate / 1e12}


def product_rate(dtype) -> float:
    """The card's best rate for products of ``dtype`` at the accuracy
    the function needs: the tensor cores in bf16, or in 3xTF32 for f32
    (f32-accurate), whichever route a kernel takes; a bound at the rate
    of the route a kernel chose would flatter a slow route."""
    return BF16_FLOP_S if "bfloat16" in str(dtype) else TF32X3_FLOP_S


def route_rate(variant: str) -> float:
    """The peak of the arithmetic route a kernel variant takes (the
    wrappers' ``variant``): the tensor cores in 3xTF32 or bf16, else f32
    FMAs."""
    return {"mma_3xtf32": TF32X3_FLOP_S,
            "mma_bf16": BF16_FLOP_S}.get(variant, F32_FLOP_S)


def _build_in_worker(marks: str) -> None:
    """In a spawned process: ``_build.build()``, leaving a file in
    ``marks`` for each compile this process runs itself."""
    from repro_torch.kernels import _build
    compile_ = _build._compile

    def noted(*args):
        Path(marks, str(os.getpid())).write_text("")
        compile_(*args)

    _build._compile = noted
    _build.build()


def build_kernels(workers: int = 3) -> dict:
    """Phase 2: the kernels built from ``src/repro_torch/csrc`` at first
    use, as the agents of a process-mode job meet them: ``workers``
    spawned processes call ``_build.build()`` at once. On a cold
    ``build/`` the build's file lock lets exactly one of them run nvcc,
    and the others load its library; on a warm one none compiles."""
    import multiprocessing as mp
    import tempfile
    from repro_torch.kernels import _build
    lib = (_build.BUILD_ROOT / _build._digest(_build.inputs())
           / _build.LIB_NAME)
    cold = not lib.exists()
    (ROOT / "build").mkdir(exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as marks:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_build_in_worker, args=(marks,))
                 for _ in range(workers)]
        for pr in procs:
            pr.start()
        for pr in procs:
            pr.join(900)
        codes = [pr.exitcode for pr in procs]
        compiles = len(os.listdir(marks))
    if codes != [0] * workers:
        raise RuntimeError(f"a build process failed: exit codes {codes}")
    if compiles != int(cold):
        raise AssertionError(f"{compiles} of {workers} processes compiled "
                             f"on a {'cold' if cold else 'warm'} build/")
    _build.library()
    out = {"cold": cold, "processes": workers, "compiles": compiles,
           "seconds": time.perf_counter() - t0}
    log(f"built {lib.relative_to(ROOT)} from "
        f"{[s.name for s in _build.sources()]}: {workers} processes at "
        f"once on a {'cold' if cold else 'warm'} build/, {compiles} "
        f"compiled, in {out['seconds']:.1f} s")
    return out


def check_kernels(torch, dev):
    """Phase 3: every kernel against its plain version on the card."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(0)
    errs = {}
    r = ROUNDS_ROWS
    path_case = (r, HEADS, HEADS, TOKENS, DIM // HEADS, False, 0,
                 "float32")
    for case in [path_case] + ATT_CASES:
        b, h, kvh, s, dh, causal, window, dt = case
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(shape, generator=g).to(dtype).to(dev)
                   for shape in ((b, h, s, dh), (b, kvh, s, dh),
                                 (b, kvh, s, dh)))
        out = fa.flash_attention(q, k, v, causal=causal, window=window)
        exp = ref.attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
        torch.testing.assert_close(out.float(), exp.float(), atol=tol,
                                   rtol=tol)
        err = (out.float() - exp.float()).abs().max().item()
        log(f"attention {case}: max_abs_err {err:.3e} (tol {tol}) "
            f"{fa.variant(q, k, v)}")
        if case is path_case:
            errs["flash_attention"] = err
    for case in ATT_EDGE_CASES:
        b, h, kvh, sq, sk, dh, causal, window, dt = case
        dtype = getattr(torch, dt)
        q = torch.randn((b, h, sq, dh), generator=g).to(dtype).to(dev)
        k, v = (torch.randn((b, kvh, sk, dh), generator=g).to(dtype).to(dev)
                for _ in range(2))
        out = fa.flash_attention(q, k, v, causal=causal, window=window)
        exp = ref.attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
        torch.testing.assert_close(out.float(), exp.float(), atol=tol,
                                   rtol=tol)
        err = (out.float() - exp.float()).abs().max().item()
        log(f"attention edge {case}: max_abs_err {err:.3e} (tol {tol}) "
            f"{fa.variant(q, k, v)}")
    for case in ATT_LONG_CASES:
        b, h, kvh, s, dh, window, q_scale = case
        q = (torch.randn((b, h, s, dh), generator=g) * q_scale).to(dev)
        k, v = (torch.randn((b, kvh, s, dh), generator=g).to(dev)
                for _ in range(2))
        out = fa.flash_attention(q, k, v, causal=True, window=window)
        exp = ref.attention_ref(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, exp, atol=2e-5, rtol=2e-5)
        err = (out - exp).abs().max().item()
        log(f"attention long {case}: max_abs_err {err:.3e} (tol 2e-5) "
            f"{fa.variant(q, k, v)}")
        del q, k, v, out, exp
    check_gmm_edges(torch, dev, g)
    check_nan(torch, dev, g)
    check_inf(torch, dev, g)
    errs["attention_inf_in_v"] = check_inf_attention(torch, dev, g)
    for rows, d, dt, offset in QUANT_CASES:
        flat = torch.randn((offset + rows * d,), generator=g)
        rows_of = flat[offset:].view(rows, d)
        rows_of[0] = 0.0                           # an all-zero row
        rows_of[1, :4] = torch.tensor([0.5, 1.5, 2.5, 127.0])  # exact ties
        x = flat.to(getattr(torch, dt)).to(dev)[offset:].view(rows, d)
        q1, s1 = qz.quantize_int8(x)
        q2, s2 = ref.quantize_int8_ref(x)
        torch.cuda.synchronize()
        if not (torch.equal(q1, q2) and torch.equal(s1, s2)):
            raise AssertionError(
                f"quantize_int8 ({rows}, {d}) {dt} {qz.variant(x)}: "
                f"{int((q1 != q2).sum())} codes and "
                f"{int((s1 != s2).sum())} scales differ from the plain "
                f"version")
        log(f"quantize_int8 ({rows}, {d}) {dt} offset {offset}: exact "
            f"({qz.variant(x)})")
        if (rows, d, offset) == (TOKENS * r, DIM, 0):
            errs["quantize_int8"] = float(
                (q1.float() - q2.float()).abs().max().item())
        del flat, x, q1, s1, q2, s2
    return errs


def check_gmm_edges(torch, dev, g) -> None:
    """The grouped matmul against its plain version at its edge shapes,
    within 2e-4 (f32) / 5e-2 (bf16)."""
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import ref
    for case in GMM_EDGE_CASES:
        e, c, d, f, dt = case
        dtype = getattr(torch, dt)
        x = torch.randn((e, c, d), generator=g).to(dtype).to(dev)
        w = torch.randn((e, d, f), generator=g).to(dtype).to(dev)
        out = gmm.moe_gmm(x, w)
        exp = ref.gmm_ref(x, w)
        torch.cuda.synchronize()
        tol = 5e-2 if dtype == torch.bfloat16 else 2e-4
        torch.testing.assert_close(out.float(), exp.float(), atol=tol,
                                   rtol=tol)
        err = (out.float() - exp.float()).abs().max().item()
        log(f"moe_gmm edge {case}: max_abs_err {err:.3e} (atol = rtol = "
            f"{tol}) {gmm.variant(x, w)}")


def check_nan(torch, dev, g) -> None:
    """A NaN in an operand comes out NaN wherever the plain version's
    does, in every variant of attention (NaN in q) and of the grouped
    matmul (NaN in x): the NaN of 0 / 0 computed on the card, GPU
    arithmetic's canonical 0x7FFFFFFF and its negative 0xFFFFFFFF. The
    rest of the output agrees within the usual tolerances."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import ref
    zero = torch.zeros(1, device=dev)
    bits = torch.tensor([0x7FFFFFFF, -1], dtype=torch.int32, device=dev)
    nans = torch.cat([zero / zero, bits.view(torch.float32)])
    for s in (8, 100):                   # SIMT, tensor cores
        for dt in ("float32", "bfloat16"):
            dtype = getattr(torch, dt)
            q = torch.randn((1, 4, s, 64), generator=g).to(dev)
            q[0, 0, 3, 5], q[0, 1, s - 1, 0], q[0, 3, 0, 63] = nans
            q = q.to(dtype)
            k, v = (torch.randn((1, 2, s, 64), generator=g).to(dtype)
                    .to(dev) for _ in range(2))
            out = fa.flash_attention(q, k, v, causal=True)
            exp = ref.attention_ref(q, k, v, causal=True)
            torch.cuda.synchronize()
            tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
            torch.testing.assert_close(out.float(), exp.float(), atol=tol,
                                       rtol=tol, equal_nan=True)
            log(f"attention NaN in q (1, 4, {s}, 64) {dt}: "
                f"{int(exp.isnan().any(-1).sum())} NaN rows, as the "
                f"plain version's {fa.variant(q, k, v)}")
    for c in (4, 64):                    # stream, tensor cores
        for dt in ("float32", "bfloat16"):
            dtype = getattr(torch, dt)
            x = torch.randn((3, c, 96), generator=g).to(dev)
            x[0, 1, 7], x[1, c - 1, 95], x[2, 0, 0] = nans
            x = x.to(dtype)
            w = torch.randn((3, 96, 72), generator=g).to(dtype).to(dev)
            out = gmm.moe_gmm(x, w)
            exp = ref.gmm_ref(x, w)
            torch.cuda.synchronize()
            tol = 5e-2 if dtype == torch.bfloat16 else 2e-4
            torch.testing.assert_close(out.float(), exp.float(), atol=tol,
                                       rtol=tol, equal_nan=True)
            log(f"moe_gmm NaN in x (3, {c}, 96) {dt}: "
                f"{int(exp.isnan().any(-1).sum())} NaN rows, as the "
                f"plain version's {gmm.variant(x, w)}")


def check_inf(torch, dev, g) -> None:
    """An inf in x or in w of the grouped matmul gives the plain
    version's output: the same +-inf (and NaN, where an inf meets a
    zero or an inf of the other sign) at the same places, in every
    variant (stream and tensor cores, f32 and bf16); the rest within
    2e-4 (f32) / 5e-2 (bf16)."""
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import ref
    inf = float("inf")
    for c in (4, 64):                    # stream, tensor cores
        for dt in ("float32", "bfloat16"):
            for side in ("x", "w"):
                dtype = getattr(torch, dt)
                x = torch.randn((3, c, 96), generator=g)
                w = torch.randn((3, 96, 72), generator=g)
                if side == "x":
                    x[0, 1, 7], x[1, c - 1, 95], x[2, 0, 0] = inf, -inf, inf
                    x[2, 0, 1] = -inf            # inf + -inf: NaN
                else:
                    w[0, 7, 5], w[1, 95, 71], w[2, 0, 0] = inf, -inf, -inf
                    w[2, 1, 0] = inf
                x, w = x.to(dtype).to(dev), w.to(dtype).to(dev)
                out = gmm.moe_gmm(x, w).float()
                exp = ref.gmm_ref(x, w).float()
                torch.cuda.synchronize()
                where = exp.isinf()
                if not (torch.equal(out.isnan(), exp.isnan())
                        and torch.equal(out.isinf(), where)
                        and torch.equal(out[where], exp[where])):
                    raise AssertionError(
                        f"moe_gmm inf in {side} (3, {c}, 96) {dt}: "
                        f"{int(out.isnan().sum())} NaN and "
                        f"{int(out.isinf().sum())} inf, the plain "
                        f"version {int(exp.isnan().sum())} and "
                        f"{int(where.sum())} ({gmm.variant(x, w)})")
                fin = exp.isfinite()
                tol = 5e-2 if dtype == torch.bfloat16 else 2e-4
                torch.testing.assert_close(out[fin], exp[fin], atol=tol,
                                           rtol=tol)
                log(f"moe_gmm inf in {side} (3, {c}, 96) {dt}: "
                    f"{int(where.sum())} inf and {int(exp.isnan().sum())} "
                    f"NaN, as the plain version's {gmm.variant(x, w)}")


def inf_attention_inputs(torch, dev, g):
    """q, k, v at granite's prefill shape with specials in v: +inf and
    -inf in two columns of one (batch, kv head), +inf and -inf in one
    column of another (their sum NaN), and a finite value within half a
    TF32 ulp of FLT_MAX at a key that holds a row's top weight (its p is
    exactly 1)."""
    qs, ks = (4, 24, 511, 64), (4, 8, 511, 64)
    q = torch.randn(qs, generator=g)
    k, v = (torch.randn(ks, generator=g) for _ in range(2))
    s = ks[2]
    v[0, 0, 3, 5], v[0, 0, s - 1, 7] = float("inf"), -float("inf")
    v[1, 7, s // 2, 63], v[1, 7, s // 3, 63] = float("inf"), -float("inf")
    k[0, 0, 10] = q[0, 0, 20] * 4.0      # row 20's top weight at key 10
    v[0, 0, 10, 0] = torch.tensor([0x7F7FFFFF], dtype=torch.int32).view(
        torch.float32)[0]
    return q.to(dev), k.to(dev), v.to(dev)


def check_inf_attention(torch, dev, g) -> dict:
    """An inf in v through attention's tensor-core variant at granite's
    prefill shape, against ``attention_ref`` on the card, bidirectional
    and causal: the same +-inf and NaN at the same places, the rest
    within 2e-5 (relative, for the values near FLT_MAX). Causal, a query
    tile skips the key tiles past its diagonal, where the plain version's
    p = 0 meets an inf as 0 * inf = NaN; the kernel's fix-up stores NaN
    in those tiles' non-finite columns of the query tiles that skipped
    them, so the causal output is held to ``attention_ref`` itself. Returns the
    counts."""
    q, k, v = inf_attention_inputs(torch, dev, g)
    counts = {}
    for causal in (False, True):
        counts[f"causal={causal}"] = same_specials(torch, q, k, v, causal)
    return counts


def same_specials(torch, q, k, v, causal: bool) -> dict:
    """The attention kernel against ``attention_ref`` on the card where
    v holds infs: the same +-inf and NaN at the same places, the rest
    within 2e-5; returns their counts and the finite part's largest
    difference."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    out = fa.flash_attention(q, k, v, causal=causal)
    exp = ref.attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    where = exp.isinf()
    what = (f"attention inf in v q {tuple(q.shape)} causal={causal} "
            f"({fa.variant(q, k, v)})")
    if not (torch.equal(out.isnan(), exp.isnan())
            and torch.equal(out.isinf(), where)
            and torch.equal(out[where], exp[where])):
        raise AssertionError(
            f"{what}: {int(out.isnan().sum())} NaN and "
            f"{int(out.isinf().sum())} inf, expected "
            f"{int(exp.isnan().sum())} and {int(where.sum())}")
    fin = exp.isfinite()
    torch.testing.assert_close(out[fin], exp[fin], atol=2e-5, rtol=2e-5)
    got = {"inf": int(where.sum()), "nan": int(exp.isnan().sum()),
           "finite_max_abs_err": (out[fin] - exp[fin]).abs().max().item()}
    log(f"{what}: {got['inf']} inf and {got['nan']} NaN as the plain "
        f"version's; the rest max_abs_err {got['finite_max_abs_err']:.3e}")
    return got


def make_slice():
    """The paper's demo data at its published scale, as
    examples/vfl_recsys_demo.py builds it."""
    import numpy as np
    from repro_torch.configs.vfl_recsys import VFLRecsysConfig
    from repro_torch.core.protocols.base import (MasterData, MemberData,
                                                 VFLConfig)
    from repro_torch.data.synthetic import make_recsys_silos
    data = make_recsys_silos(VFLRecsysConfig(), seed=0)
    master = MasterData(data.ids, data.labels.astype(np.float64),
                        data.features)
    members = [MemberData(ids, x) for ids, x in
               zip(data.member_ids, data.member_features)]
    cfg = VFLConfig(protocol="split_nn", seed=0, use_psi=False,
                    batch_size=512, embedding_dim=64, tower=TOWER,
                    top_tower=TOP_TOWER)
    return cfg, master, members


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def serve_slice(torch, dev, cfg, master, members):
    """Phase 4: the main path, driven through the entry points a user
    calls. Returns (launch counts of the concurrent run, rounds, serve
    stats, the lone query's rows and scores, the job's results)."""
    import numpy as np
    from repro_torch.core.party import VFLJob
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quantize as qz
    from repro_torch.serve.federated import FederatedServer, ServeCfg
    n = len(set(master.ids) & set(members[0].ids))
    items = master.y.shape[1]
    rng = np.random.default_rng(1)
    hot = rng.choice(n, 256, replace=False)

    def query_rows(r):
        rows = np.concatenate([r.choice(n, QUERY_ROWS - 16),
                               r.choice(hot, 16)])
        rows[-1] = rows[0]                 # a duplicate inside the query
        return rows

    t0 = time.perf_counter()
    job = VFLJob(cfg, master, members, mode="thread", device=dev)
    srv = FederatedServer(job, ServeCfg(max_batch=512, max_wait_ms=2.0))
    srv.start()
    log(f"job + serve session up in {time.perf_counter() - t0:.1f} s "
        f"({n} matched rows)")
    # warm-up round (cuBLAS handles, the kernel library), not counted
    srv.query(query_rows(rng))
    sync(torch, dev)
    batches0 = srv.stats.batches
    failures = []

    def caller(i):
        r = np.random.default_rng(100 + i)
        for _ in range(QUERIES):
            rows = query_rows(r)
            s = srv.query(rows, timeout=300.0)
            if s.shape != (QUERY_ROWS, items) or not np.isfinite(s).all():
                failures.append((i, s.shape))

    fa.launches.reset()
    qz.launches.reset()
    threads = [threading.Thread(target=caller, args=(i,))
               for i in range(CALLERS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    sync(torch, dev)
    wall = time.perf_counter() - t0
    counts = {"flash_attention": fa.launches.count,
              "quantize_int8": qz.launches.count}
    rounds = srv.stats.batches - batches0
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a caller thread did not finish in 600 s")
    if failures:
        raise AssertionError(f"bad answers: {failures[:5]}")
    log(f"served {CALLERS * QUERIES} queries of {QUERY_ROWS} rows in "
        f"{wall:.3f} s over {rounds} federated rounds; launches {counts}")
    for name, c in counts.items():
        if c != 2 * rounds:
            raise AssertionError(f"{name} launched {c} times in "
                                 f"{rounds} rounds, expected {2 * rounds}")
    lone_rows = query_rows(np.random.default_rng(7))
    lone = srv.query(lone_rows)
    stats = srv.stop()
    log("ServeStats " + json.dumps(stats))
    offline = job.predict(rows=lone_rows, batch_size=len(lone_rows))
    if not np.array_equal(lone, offline):
        raise AssertionError("served scores differ from offline predict "
                             "of the same rows")
    log("lone query bit-identical to offline predict")
    results = job.shutdown()
    return counts, rounds, stats, lone_rows, lone, results


def plain_scores(torch, dev, cfg, master, members, results, rows):
    """The lone query's rows through the same weights with every block
    on its plain version (``kernel=ref``), on the card."""
    import dataclasses
    import numpy as np
    from repro_torch.core.protocols import base
    from repro_torch.core.protocols.split_nn import bottom_spec, top_spec
    from repro_torch.models import tower as twr
    ref_cfg = dataclasses.replace(
        cfg, tower=tuple(b if b.startswith(("embed", "mlp"))
                         else b + ("," if ":" in b else ":") + "kernel=ref"
                         for b in cfg.tower))
    order = results["master"]["order"]
    xm = base._select(master.ids, order, master.x)[rows]
    xp = base._select(members[0].ids, order, members[0].x)[rows]
    with torch.no_grad():
        def bottom(x, params):
            spec = bottom_spec(ref_cfg, x.shape[1])
            return twr.apply(spec, twr.from_numpy(params, dev),
                             torch.as_tensor(x, dtype=torch.float32,
                                             device=dev))
        u = bottom(xm, results["master"]["bottom"]) \
            + bottom(xp, results["member0"]["params"])
        top = top_spec(cfg, master.y.shape[1])
        out = twr.apply(top, twr.from_numpy(results["master"]["top"], dev),
                        u)
    return out.cpu().numpy().astype(np.float64)


def train_slice(torch, dev, cfg, master, members):
    """Phase 4c: split-NN training on the demo at its published scale,
    through ``VFLJob.fit`` in thread mode, at pipeline depth 1 and 2:
    one epoch each (every matched row once, in batches of 512), which
    must launch each kernel exactly 3 times a round (the forward of the
    master's bottom tower, the member's send, the member's VJP recomputed
    at its current params) and the attention's backward kernel exactly 2
    times a round (the master's bottom tower and the member's VJP), with
    finite losses whose last 16 average below the first 16. At depth 1 the same epoch twice more, timed and
    under ``torch.profiler`` (the device's busy share). Then
    the first 16 rounds again with every block on its plain version
    (``kernel=ref``) on the card: the losses within rtol 1e-3 of the
    kernels'. The attention kernel differs from the plain version by
    ~1e-6 and the quantize kernel is exact on equal inputs, so losses
    agree to ~1e-6 until a quantize input within that of a .5 tie takes
    a code one step apart, which moves a round's loss by ~1e-5; 1e-3
    leaves room for several over 16 rounds of SGD. Returns (the launches
    of each counted fit, the measured numbers, the loss histories of the
    counted fits at depth 1 and 2)."""
    import numpy as np
    from repro_torch.core.party import VFLJob
    from repro_torch.core.protocols.driver import StopAtStep
    counters = _split_nn_counters()
    measured, launches, all_losses = {}, {}, {}
    check = None

    def counted_fit(job, tag):
        """The job's fit, timed until the master's last round; the
        launches read once the job is shut down, past the member's last
        VJP."""
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        fit = job.fit()
        sync(torch, dev)
        wall = time.perf_counter() - t0
        job.shutdown()
        sync(torch, dev)
        got = {name: c.count for name, c in counters.items()}
        launches[tag] = got
        return fit["history"], wall, got

    for depth in (1, 2):
        tcfg = dataclasses.replace(cfg, epochs=1, lr=TRAIN_LR,
                                   pipeline_depth=depth)
        job = VFLJob(tcfg, master, members, mode="thread", device=dev)
        hist, wall, got = counted_fit(job, f"split_nn_train_d{depth}")
        rounds = len(hist)
        if got != split_nn_launches(3 * rounds, 2 * rounds):
            raise AssertionError(f"training at depth {depth} launched {got} "
                                 f"in {rounds} rounds, expected 3 forward "
                                 f"and 2 backward launches a round")
        losses = np.array([h["loss"] for h in hist])
        all_losses[depth] = losses
        if not np.isfinite(losses).all():
            raise AssertionError(f"depth {depth}: non-finite losses")
        head, tail = losses[:16].mean(), losses[-16:].mean()
        if not tail < head:
            raise AssertionError(f"depth {depth}: loss did not fall "
                                 f"({head:.6f} -> {tail:.6f})")
        # from round 16 on: past the parties' threads' first cuBLAS calls
        # and allocations
        steady = (rounds - 17) / (hist[-1]["wall_s"] - hist[16]["wall_s"])
        m = {"rounds": rounds, "epoch_s": wall, "rounds_per_s": rounds / wall,
             # the master's clock from the fit's start to its last round,
             # as the process-mode phase reads it
             "epoch_s_by_history": hist[-1]["wall_s"],
             "steady_rounds_per_s": steady, "loss_first": float(losses[0]),
             "loss_last": float(losses[-1]), "loss_first16_mean": float(head),
             "loss_last16_mean": float(tail),
             "launches_per_round": {k: v / rounds for k, v in got.items()}}
        if depth == 1:
            check = losses[:TRAIN_CHECK_ROUNDS]
            # the same epoch again, now that the process has run one (the
            # parties' first cuBLAS calls, autograd's first backward),
            # then once more under the profiler, against that wall time
            job = VFLJob(tcfg, master, members, mode="thread", device=dev)
            t0 = time.perf_counter()
            job.fit()
            sync(torch, dev)
            m["warm_epoch_s"] = time.perf_counter() - t0
            job.shutdown()
            job = VFLJob(tcfg, master, members, mode="thread", device=dev)
            m["profile"] = profile_window(torch, job.fit, m["warm_epoch_s"])
            job.shutdown()
        measured[f"depth{depth}"] = m
        log(f"split-NN training depth {depth}: {rounds} rounds in {wall:.3f} "
            f"s ({rounds / wall:.1f} rounds/s, {steady:.1f} from round 16); "
            f"loss {losses[0]:.6f} -> {losses[-1]:.6f} (first 16 "
            f"{head:.6f}, last 16 {tail:.6f}); launches {got}")
        if depth == 1:
            log("split-NN training profile " + json.dumps(m["profile"]))

    ref_cfg = dataclasses.replace(
        cfg, epochs=1, lr=TRAIN_LR, pipeline_depth=1,
        tower=tuple(b if b.startswith(("embed", "mlp"))
                    else b + ("," if ":" in b else ":") + "kernel=ref"
                    for b in cfg.tower))
    job = VFLJob(ref_cfg, master, members, mode="thread", device=dev,
                 callbacks=[StopAtStep(TRAIN_CHECK_ROUNDS)])
    hist, _, got = counted_fit(job, "split_nn_train_plain")
    if got != {name: 0 for name in counters}:
        raise AssertionError(f"the plain-version fit launched {got}")
    plain = np.array([h["loss"] for h in hist])
    rel = float(np.max(np.abs(check - plain) / np.abs(plain)))
    measured["plain_versions_loss_rel_err"] = rel
    log(f"split-NN training: the first {TRAIN_CHECK_ROUNDS} losses against "
        f"the plain versions on the card: max rel err {rel:.3e} (tol 1e-3)")
    if not rel <= 1e-3:
        raise AssertionError("training losses disagree with the plain "
                             "versions")
    measured["attention_backward"] = tower_attention_backward(torch, dev)
    log("split-NN training " + json.dumps(measured))
    del launches["split_nn_train_plain"]
    return launches, measured, all_losses


class WorkerLaunches:
    """A driver callback (the hooks of ``core.protocols.driver.Callback``)
    that counts each agent's own kernel launches over its fit: it zeroes
    the counters as the fit starts and writes them, with the agent's
    rounds, to ``<out>/<role>.json`` as it ends. In the process modes
    every agent is its own process with its own counters, so the parent
    reads the files once the job is shut down. A member's fit ends after
    its last VJP."""

    def __init__(self, out: str):
        self.out = out

    def on_fit_start(self, driver) -> None:
        for c in _split_nn_counters().values():
            c.reset()

    def on_epoch_start(self, driver, epoch) -> None:
        pass

    def on_batch_end(self, driver, step, epoch, loss) -> None:
        pass

    def on_epoch_end(self, driver, epoch) -> None:
        pass

    def on_fit_end(self, driver) -> None:
        got = {name: c.count for name, c in _split_nn_counters().items()}
        Path(self.out, f"{driver.role}.json").write_text(json.dumps(got))


def _split_nn_counters() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quantize as qz
    return {"flash_attention": fa.launches, "quantize_int8": qz.launches,
            "flash_attention_bwd": fa.bwd_launches}


def split_nn_launches(forwards: int, backwards: int) -> dict:
    """The launches of each split-NN kernel a party makes for
    ``forwards`` tower forwards of which ``backwards`` are differentiated
    (one attention and one quantize a forward, the attention's backward
    kernel a backward)."""
    return {"flash_attention": forwards, "quantize_int8": forwards,
            "flash_attention_bwd": backwards}


def _two_members(members):
    """The demo member's silo split in two by columns (the first half
    and the rest, every row in both), as ``data/vertical.py`` cuts one
    dataset into silos."""
    import numpy as np
    from repro_torch.core.protocols.base import MemberData
    from repro_torch.data.vertical import vertical_partition
    m = members[0]
    d = m.x.shape[1]
    first, rest = vertical_partition(
        m.ids, m.x, np.zeros((len(m.ids), 1)), widths=[d - d // 2],
        shuffle_members=False)
    return [MemberData(first.ids, first.x), rest[0]]


def demo_modes(torch, dev, cfg, master, members, thread_losses):
    """Phase 4d: the paper's demo at its published scale in the other
    execution modes, on the card. ``socket_proc`` (every party its own
    OS process and CUDA context, over localhost TCP) trains one epoch at
    depth 1 and at depth 2: epoch wall time and rounds/s (all rounds,
    and from round 16) from the master's round clock, each worker's
    launches through ``WorkerLaunches`` (the master's bottom forward, 1 a
    round; the member's send and VJP, 2 a round; the attention's backward
    kernel 1 a round in each), and the depth-1 losses
    within rtol 1e-6 of the thread mode's (``thread_losses``, from phase
    4c). Then 16 rounds each of ``process`` at depth 2 and ``socket`` and
    ``grpc`` (threads) at depth 1, whose losses must match the thread
    mode's at the same depth and tolerance. Then secure aggregation: the
    member's silo split in two, 16 rounds of ``secure_agg`` (finite,
    falling losses) and two predicts of 512 rows, each within the JAX
    package's own 1e-3 (``tests/test_lifecycle_api.py``) of the same
    trained weights predicted without masks. Returns (launches by run,
    the measured numbers)."""
    import tempfile
    import numpy as np
    from repro_torch.core.party import VFLJob
    from repro_torch.core.protocols.driver import Checkpointer, StopAtStep
    t_phase = time.perf_counter()
    measured, launches = {}, {}
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)

    def check_losses(tag, got, want):
        n = len(got)
        rel = float(np.max(np.abs(got - want[:n]) / np.abs(want[:n])))
        same = bool(np.array_equal(got, want[:n]))
        log(f"{tag}: {n} losses against thread mode's: max rel err "
            f"{rel:.3e} (tol 1e-6), bit-identical {same}")
        if not rel <= 1e-6:
            raise AssertionError(f"{tag}: losses disagree with thread mode")
        return {"max_rel_err_vs_thread": rel, "bit_identical": same}

    for depth in (1, 2):
        tcfg = dataclasses.replace(cfg, epochs=1, lr=TRAIN_LR,
                                   pipeline_depth=depth)
        with tempfile.TemporaryDirectory(dir=scratch) as out:
            t0 = time.perf_counter()
            job = VFLJob(tcfg, master, members, mode="socket_proc",
                         device=dev, callbacks=[WorkerLaunches(out)])
            hist = job.fit()["history"]
            fit_s = time.perf_counter() - t0
            job.shutdown()
            per_worker = {role: json.loads(Path(out, f"{role}.json")
                                           .read_text())
                          for role in ("master", "member0")}
        rounds = len(hist)
        want = {"master": split_nn_launches(rounds, rounds),
                "member0": split_nn_launches(2 * rounds, rounds)}
        for role, got in per_worker.items():
            if got != want[role]:
                raise AssertionError(
                    f"socket_proc depth {depth}: {role} launched {got} in "
                    f"{rounds} rounds, expected {want[role]}")
        total = {name: sum(w[name] for w in per_worker.values())
                 for name in per_worker["master"]}
        launches[f"split_nn_train_socket_proc_d{depth}"] = total
        losses = np.array([h["loss"] for h in hist])
        if not np.isfinite(losses).all() \
                or not losses[-16:].mean() < losses[:16].mean():
            raise AssertionError(f"socket_proc depth {depth}: losses "
                                 f"not finite and falling")
        epoch = hist[-1]["wall_s"]
        steady = (rounds - 17) / (hist[-1]["wall_s"] - hist[16]["wall_s"])
        m = {"rounds": rounds, "epoch_s": epoch, "rounds_per_s":
             rounds / epoch, "steady_rounds_per_s": steady,
             "fit_call_s_with_worker_start": fit_s,
             "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
             "launches_per_round_by_worker": {
                 role: {k: v / rounds for k, v in got.items()}
                 for role, got in per_worker.items()}}
        if depth == 1:
            m.update(check_losses("socket_proc depth 1", losses,
                                  thread_losses[1]))
        measured[f"socket_proc_d{depth}"] = m
        log(f"split-NN training socket_proc depth {depth}: {rounds} rounds "
            f"in {epoch:.3f} s ({rounds / epoch:.1f} rounds/s, "
            f"{steady:.1f} from round 16; the fit call with the workers' "
            f"start {fit_s:.1f} s); loss {losses[0]:.6f} -> "
            f"{losses[-1]:.6f}; launches by worker {per_worker}")

    for mode, depth in (("process", 2), ("socket", 1), ("grpc", 1)):
        tcfg = dataclasses.replace(cfg, epochs=1, lr=TRAIN_LR,
                                   pipeline_depth=depth)
        job = VFLJob(tcfg, master, members, mode=mode, device=dev,
                     callbacks=[StopAtStep(TRAIN_CHECK_ROUNDS)])
        hist = job.fit()["history"]
        job.shutdown()
        losses = np.array([h["loss"] for h in hist])
        # at depth 2 the round in flight when the stop comes runs too
        if not TRAIN_CHECK_ROUNDS <= len(losses) <= TRAIN_CHECK_ROUNDS + 1:
            raise AssertionError(f"{mode}: {len(losses)} rounds")
        measured[f"{mode}_d{depth}"] = check_losses(
            f"{mode} depth {depth}", losses, thread_losses[depth])

    # secure aggregation over two members
    two = _two_members(members)
    scfg = dataclasses.replace(cfg, epochs=1, lr=TRAIN_LR, secure_agg=True)
    rows = np.arange(ROUNDS_ROWS)
    with tempfile.TemporaryDirectory(dir=scratch) as ckpt:
        job = VFLJob(scfg, master, two, mode="thread", device=dev,
                     callbacks=[StopAtStep(TRAIN_CHECK_ROUNDS),
                                Checkpointer(ckpt, TRAIN_CHECK_ROUNDS)])
        hist = job.fit()["history"]
        masked = [job.predict(rows=rows, batch_size=len(rows))
                  for _ in range(2)]
        job.shutdown()
        plain_job = VFLJob(dataclasses.replace(scfg, secure_agg=False),
                           master, two, mode="thread", device=dev,
                           resume_dir=ckpt)
        plain = plain_job.predict(rows=rows, batch_size=len(rows))
        plain_job.shutdown()
    losses = np.array([h["loss"] for h in hist])
    if len(losses) != TRAIN_CHECK_ROUNDS or not np.isfinite(losses).all() \
            or not losses[-4:].mean() < losses[:4].mean():
        raise AssertionError(f"secure_agg: losses {losses}")
    errs = []
    for s in masked:
        if s.shape != plain.shape or not np.isfinite(s).all():
            raise AssertionError(f"secure_agg predict {s.shape}")
        np.testing.assert_allclose(s, plain, rtol=1e-3, atol=1e-3)
        errs.append(float(np.abs(s - plain).max()))
    measured["secure_agg"] = {
        "members": [m.x.shape[1] for m in two], "rounds": len(losses),
        "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
        "predict_max_abs_err_vs_unmasked": errs}
    log(f"secure_agg over members of {[m.x.shape[1] for m in two]} "
        f"features: {len(losses)} rounds, loss {losses[0]:.6f} -> "
        f"{losses[-1]:.6f}; two masked predicts of {len(rows)} rows against "
        f"the unmasked: max abs err {errs} (tol 1e-3)")
    measured["phase_s"] = time.perf_counter() - t_phase
    log("split-NN modes " + json.dumps(measured))
    return launches, measured


def demo_silos(role: str, launches: str = "", **_):
    """The ``[data]`` provider of phase 4e's published-scale cluster:
    ``make_slice``'s silos for ``role``, built by each agent itself from
    the seed (nothing raw crosses the wire). Import-safe, as any user's
    provider is. With ``launches`` set, the agent's process zeroes its
    kernel counters here, before any launch, and writes them to
    ``<launches>/<role>-<pid>.json`` as it exits: each agent is its own
    process with its own counters."""
    _, master, members = make_slice()
    if launches:
        import atexit
        counters = _split_nn_counters()
        for c in counters.values():
            c.reset()

        def write() -> None:
            Path(launches, f"{role}-{os.getpid()}.json").write_text(
                json.dumps({k: c.count for k, c in counters.items()}))
        atexit.register(write)
    if role == "master":
        return master
    return members[int(role[len("member"):])]


def _run_launchers(spec, log_root: Path, device: str):
    """Both hosts' launchers of ``spec``, each in a thread of this process
    (the JAX package's ``tests/test_cluster.py`` runs them so), their
    agents in processes of their own. Returns (exit codes, wall time, each
    host's seconds from the launch to its ``pids.json``: every agent of
    the host spawned, its torch imported and its listener bound)."""
    from repro_torch.launch.cluster import ClusterLauncher
    codes, ready = {}, {}
    t0 = time.perf_counter()

    def run(host):
        codes[host] = ClusterLauncher(spec, host, log_dir=log_root / host,
                                      device=device).run()
    # daemon threads: a launcher past the deadline below must not keep
    # this process alive after it raises
    threads = [threading.Thread(target=run, args=(h,), daemon=True)
               for h in spec.hosts]
    for t in threads:
        t.start()
    while any(t.is_alive() for t in threads):
        for h in spec.hosts:
            if h not in ready and (log_root / h / "pids.json").exists():
                ready[h] = time.perf_counter() - t0
        time.sleep(0.05)
        if time.perf_counter() - t0 > 600:
            raise RuntimeError("a launcher did not finish in 600 s")
    return codes, time.perf_counter() - t0, ready


def _summary(log_root: Path, host: str) -> dict:
    return json.loads((log_root / host / "summary.json").read_text())


def _serve_queries(log: Path, port: int, n: int, items: int) -> None:
    """Once the master's log says its frontend is up, CALLERS clients
    send QUERIES queries each of 64 matched rows through the port's
    ``ServeClient``; every answer must be finite (64, items) scores."""
    import numpy as np
    from repro_torch.serve.federated import ServeClient
    deadline = time.perf_counter() + 300
    while "serving on" not in (log.read_text() if log.exists() else ""):
        if time.perf_counter() > deadline:
            raise RuntimeError("the cluster's serve window did not open")
        time.sleep(0.1)
    bad = []

    def caller(i):
        r = np.random.default_rng(200 + i)
        try:
            with ServeClient("127.0.0.1", port, timeout=120.0) as cl:
                for _ in range(CLUSTER_SERVE_QUERIES):
                    s = cl.query(r.choice(n, QUERY_ROWS))
                    if s.shape != (QUERY_ROWS, items) \
                            or not np.isfinite(s).all():
                        bad.append((i, s.shape))
        except Exception as e:               # reported below
            bad.append((i, repr(e)))
    threads = [threading.Thread(target=caller, args=(i,))
               for i in range(CLUSTER_SERVE_CALLERS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    if bad or any(t.is_alive() for t in threads):
        raise AssertionError(f"cluster serve answers: {bad[:5]}")


def cluster_phase(torch, thread_losses, n_matched: int, items: int):
    """Phase 4e: the cluster launcher on the card. Mints a test CA and
    certificates for master, member0, alpha and beta under ``build/`` with
    ``launch/certs.py`` (TLS is required whenever the ``openssl`` CLI is
    there); loads and validates the committed ``examples/cluster`` specs
    with the port's ``load_spec``. Then the quickstart spec, its
    ``[protocol]`` set to phase 4c's (the demo tower, batch 512, lr 0.3,
    seed 0, no PSI, one epoch, depth 1) and its ``[data]`` to
    :func:`demo_silos`, runs as two ``ClusterLauncher``s (alpha: master,
    beta: member0), every agent its own process and CUDA context, over
    TLS'd gRPC framing, phases fit, evaluate and serve: both launchers
    exit 0, 224 rounds, the first and last loss within rtol 1e-6 of thread
    mode's (``thread_losses``, phase 4c), finite scores served through
    ``ServeClient``, each agent's launches counted in its own process
    (fit: 1 a round in the master, 2 in the member; evaluate and serve: 1
    a round in each). Then an elastic restart on the card: the committed
    quickstart spec (its reduced data) with the demo tower, member0
    crashed at step 5 by ``[chaos]`` and respawned by ``[restart]``, a new
    process and CUDA context resuming from its checkpoint; every round
    completes and ``recoveries`` names member0 once. Then the privacy
    matrix (``repro_torch.attacks.runner``) on the card and on the CPU:
    logreg_he rows equal to the CPU's and to the committed
    ``benchmarks/results/privacy.json``'s, split-NN utility within 0.02
    of the CPU's and leakage too, but for ``secure_agg``, whose masks come
    from a fresh secret in every run (its leakage is printed);
    ``benchmarks/check_regression.py --privacy`` run on the card's rows,
    its logreg_he cells passing, every verdict printed. Returns (the
    cluster's launches by kernel, the measured numbers)."""
    import shutil
    import numpy as np
    from repro_torch.attacks.runner import run_privacy_matrix
    from repro_torch.comm.sock import local_addresses
    from repro_torch.core.protocols.base import batch_bounds
    from repro_torch.launch.certs import TestCA, have_openssl
    from repro_torch.launch.cluster import load_spec, parse_toml
    t_phase = time.perf_counter()
    measured = {}
    build = ROOT / "build"
    root = build / "cluster"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    examples = ROOT / "examples" / "cluster"

    # 1. certificates
    tls = None
    if have_openssl():
        ver = subprocess.run(["openssl", "version"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
        ca = TestCA(build / "cluster_certs")
        for name in ("master", "member0", "alpha", "beta"):
            ca.issue(name)
        tls = {"cert": str(ca.dir / "{agent}.crt"),
               "key": str(ca.dir / "{agent}.key"), "ca": ca.ca_cert}
        log(f"cluster: {ver}; test CA and certificates for master, member0, "
            f"alpha, beta in {ca.dir}; TLS on every link")
    else:
        log("cluster: no openssl CLI on this machine, so no test "
            "certificates: the cluster runs without [comm.tls]")
    measured["tls"] = tls is not None

    # 2. the committed specs
    for name in ("quickstart_cluster.toml", "logreg_he_sharded.toml"):
        spec = load_spec(examples / name)
        spec.validate()
        log(f"cluster: {name} loads and validates: world {spec.world()}, "
            f"framing {spec.framing}")

    def spec_for(raw, **tables):
        ports = [p for _, p in local_addresses(
            [f"p{i}" for i in range(4)]).values()]
        raw = dict(raw, **tables)
        raw["comm"] = dict(raw["comm"])
        raw["comm"].pop("tls", None)
        if tls is not None:
            raw["comm"]["tls"] = tls
        raw["agents"] = {"master": f"127.0.0.1:{ports[0]}",
                         "member0": f"127.0.0.1:{ports[1]}"}
        raw["hosts"] = {"alpha": {"control": f"127.0.0.1:{ports[2]}",
                                  "agents": ["master"]},
                        "beta": {"control": f"127.0.0.1:{ports[3]}",
                                 "agents": ["member0"]}}
        return load_spec(raw)

    quick = parse_toml((examples / "quickstart_cluster.toml").read_text())

    # 3. the published-scale cluster
    launches_dir = root / "launches"
    launches_dir.mkdir()
    stop = root / "serve.stop"
    proto = {"name": "split_nn", "epochs": 1, "batch_size": 512,
             "lr": TRAIN_LR, "seed": 0, "use_psi": False,
             "embedding_dim": 64, "pipeline_depth": 1,
             "tower": list(TOWER), "top_tower": list(TOP_TOWER)}
    serve_port = local_addresses(["serve"])["serve"][1]
    spec = spec_for(
        quick, protocol=proto,
        run={"phases": ["fit", "evaluate", "serve"]},
        data={"provider": "chip_smoke:demo_silos",
              "launches": str(launches_dir)},
        serve={"port": serve_port, "host": "127.0.0.1", "max_batch": 512,
               "stop_file": str(stop)})
    errors = []

    def serve_guarded():
        # the queries, then the stop file that ends the serve window
        try:
            _serve_queries(root / "demo" / "alpha" / "master.log",
                           serve_port, n_matched, items)
        except Exception as e:               # raised again below
            errors.append(e)
        finally:
            stop.write_text("stop")
    server = threading.Thread(target=serve_guarded, daemon=True)
    server.start()
    codes, wall, ready = _run_launchers(spec, root / "demo", "cuda")
    server.join(60)
    if errors:
        raise errors[0]
    if codes != {"alpha": 0, "beta": 0}:
        raise AssertionError(f"cluster launchers exited {codes}; logs in "
                             f"{root / 'demo'}")
    master = _summary(root / "demo", "alpha")["agents"]["master"]
    member = _summary(root / "demo", "beta")["agents"]["member0"]
    fit = master["fit"]
    want = thread_losses[1]
    rel = [abs(fit["first_loss"] - want[0]) / abs(want[0]),
           abs(fit["final_loss"] - want[-1]) / abs(want[-1])]
    if fit["steps"] != len(want) or not max(rel) <= 1e-6:
        raise AssertionError(f"cluster fit {fit} against thread mode's "
                             f"{want[0]} -> {want[-1]} ({len(want)} rounds)")
    serve = master["serve"]
    eval_rounds = len(batch_bounds(n_matched, spec.cfg))
    per_agent = {}
    for f in sorted(launches_dir.iterdir()):
        per_agent[f.name.split("-")[0]] = json.loads(f.read_text())
    others = eval_rounds + serve["batches"]
    expect = {"master": split_nn_launches(fit["steps"] + others,
                                          fit["steps"]),
              "member0": split_nn_launches(2 * fit["steps"] + others,
                                           fit["steps"])}
    for role, want in expect.items():
        if per_agent.get(role) != want:
            raise AssertionError(f"cluster {role} launched "
                                 f"{per_agent.get(role)}, expected {want}")
    launches = {k: sum(a[k] for a in per_agent.values())
                for k in _split_nn_counters()}
    m = {"wall_s": wall, "ready_s_by_host": ready, "fit": fit,
         "rounds_per_s": fit["steps"] / fit["wall_s"],
         "loss_rel_err_vs_thread": rel,
         "evaluate_auc": master["evaluate"].get("auc"), "serve": serve,
         "comm_master": master["comm"], "comm_member": member["comm"],
         "launches_by_agent": per_agent}
    measured["published_scale"] = m
    log(f"cluster (published scale, {'TLS' if tls else 'plaintext'} gRPC "
        f"framing, one process and CUDA context an agent): launchers "
        f"{codes} in {wall:.1f} s; spawn to ready {ready}; fit "
        f"{fit['steps']} rounds, master's wall_s {fit['wall_s']:.3f} s "
        f"({m['rounds_per_s']:.1f} rounds/s); loss {fit['first_loss']:.6f} "
        f"-> {fit['final_loss']:.6f}, rel err vs thread mode {rel}; "
        f"evaluate AUC {m['evaluate_auc']}; serve p50 {serve['p50_ms']} ms "
        f"p99 {serve['p99_ms']} ms over {serve['batches']} rounds; bytes "
        f"sent by master {master['comm'].get('sent_bytes')}, member "
        f"{member['comm'].get('sent_bytes')}; launches {per_agent}")

    # 4. elastic restart on the card
    proto = dict(quick["protocol"], tower=list(TOWER),
                 top_tower=list(TOP_TOWER))
    spec = spec_for(
        quick, protocol=proto,
        chaos={"role": "member0", "step": 5},
        restart={"member0": {"policy": "on_failure"}})
    codes, wall, ready = _run_launchers(spec, root / "elastic", "cuda")
    if codes != {"alpha": 0, "beta": 0}:
        raise AssertionError(f"elastic launchers exited {codes}; logs in "
                             f"{root / 'elastic'}")
    master = _summary(root / "elastic", "alpha")["agents"]["master"]
    rounds = spec.cfg.epochs * len(batch_bounds(master["fit"]["n_common"],
                                                 spec.cfg))
    rec = master.get("recoveries", [])
    if master["fit"]["steps"] != rounds \
            or [r["role"] for r in rec] != ["member0"]:
        raise AssertionError(f"elastic run: {master['fit']}, recoveries "
                             f"{rec}, expected {rounds} rounds")
    measured["elastic"] = {"wall_s": wall, "ready_s_by_host": ready,
                           "fit": master["fit"], "recoveries": rec}
    log(f"cluster elastic restart: launchers {codes} in {wall:.1f} s; "
        f"{master['fit']['steps']} of {rounds} rounds; recoveries {rec} "
        f"(wait_s: the respawn's torch import, CUDA context and data; "
        f"RestartPolicy.wait_s {spec.restart_of('member0').wait_s})")

    # 5. the privacy matrix on the card and on the CPU
    t0 = time.perf_counter()
    rows = {"cuda": run_privacy_matrix(mode="thread", verbose=False,
                                       device="cuda")}
    cuda_s = time.perf_counter() - t0
    rows["cpu"] = run_privacy_matrix(mode="thread", verbose=False,
                                     device="cpu")
    committed = json.loads((ROOT / "benchmarks" / "results"
                            / "privacy.json").read_text())

    def key(r):
        return r["protocol"], r["attack"], r["defense"]
    cpu = {key(r): r for r in rows["cpu"]}
    ref = {key(r): r for r in committed}
    gaps = {}
    for r in rows["cuda"]:
        k, c = key(r), cpu[key(r)]
        if r["protocol"] == "logreg_he":
            if r != c or r != ref[k]:
                raise AssertionError(f"logreg_he row {r} against the CPU's "
                                     f"{c} and the committed {ref[k]}")
            continue
        gaps["/".join(k[1:])] = (r["leakage_auc"] - c["leakage_auc"],
                                 r["utility_auc"] - c["utility_auc"])
        # secure_agg's masks come from a fresh Diffie-Hellman secret in
        # every run (core/secure_agg_protocol.py): its leakage is another
        # draw in each run, so only its utility is held; the masks cancel
        if abs(r["utility_auc"] - c["utility_auc"]) > 0.02 or (
                k[2] != "secure_agg"
                and abs(r["leakage_auc"] - c["leakage_auc"]) > 0.02):
            raise AssertionError(f"split-NN row {r} against the CPU's {c}")
    paths = {}
    for dev_name, got in rows.items():
        paths[dev_name] = build / f"privacy_torch_{dev_name}.json"
        paths[dev_name].write_text(json.dumps(got, indent=1) + "\n")
    gate = subprocess.run(
        [sys.executable, str(ROOT / "benchmarks" / "check_regression.py"),
         "--privacy", str(paths["cuda"])], capture_output=True, text=True,
        timeout=120)
    verdicts = [ln for ln in (gate.stdout + gate.stderr).splitlines() if ln]
    for ln in verdicts:
        log(f"privacy gate (card's rows): {ln}")
    failed = [ln for ln in verdicts if ln.startswith("PRIVACY-FAIL")]
    if any("logreg_he" in ln for ln in failed) or not any(
            ln.startswith("OK  logreg_he") for ln in verdicts):
        raise AssertionError("the logreg_he cells fail the privacy gate")
    for ln in failed:
        cell = ln.split()[1].rstrip(":")
        k = tuple(cell.split("/"))
        log(f"privacy gate: {cell} fails on the card ("
            f"{next(r for r in rows['cuda'] if key(r) == k)['leakage_auc']}"
            f"), CPU {cpu[k]['leakage_auc']}, committed JAX row "
            f"{ref[k]['leakage_auc']}")
    measured["privacy"] = {
        "cuda_matrix_s": cuda_s, "gate_rc": gate.returncode,
        "gate_failures": failed, "split_nn_gaps_cuda_minus_cpu": gaps,
        "max_gap_but_secure_agg_leakage": max(
            max(abs(lk), abs(ut)) if not name.endswith("secure_agg")
            else abs(ut) for name, (lk, ut) in gaps.items()),
        "rows_cuda": rows["cuda"], "rows_cpu": rows["cpu"]}
    log(f"privacy matrix on the card in {cuda_s:.1f} s: logreg_he rows equal "
        f"the CPU's and the committed; split-NN gaps card - CPU (leakage, "
        f"utility) {gaps}")
    measured["phase_s"] = time.perf_counter() - t_phase
    log("cluster phase " + json.dumps(measured))
    log(f"cluster phase: {measured['phase_s']:.1f} s")
    return launches, measured


def attention_bwd_bound(q, k, causal: bool, dv=None) -> dict:
    """The attention backward's bound: q, k, v, o, dO read once, dq, dk,
    dv written once; five products a visible (query, key) pair at the
    rate of f32-accurate products, S again, dK and dQ of 2 dh, dP and
    dV of 2 ``dv`` (v's own width, dh where None). v, o, dO and dv count
    at ``dv`` columns: a padded v's extra columns are the kernel's
    cost, not the function's."""
    b, h, sq, dh = q.shape
    sk = k.shape[2]
    dv = dh if dv is None else dv
    pairs = (sq * (sq + 1) / 2 if causal and sq == sk else sq * sk)
    nbytes = (2 * b * h * sq * (dh + dv)
              + 2 * b * k.shape[1] * sk * (dh + dv)) * q.element_size()
    return _bound(nbytes, 2.0 * (3 * dh + 2 * dv) * pairs * b * h,
                  product_rate(q.dtype))


def kernel_times(torch, fn, calls: int = 20) -> dict:
    """Device ms a call of each kernel ``fn`` launches (by name, as
    ``torch.profiler`` records it), a mean over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.key_averages():
        # a kernel may come back as more than one entry
        key = e.key.replace("(anonymous namespace)::", "")
        name = key.split("(")[0].removeprefix("void ").split("::")[-1][:60]
        if _device_us(e) > 0:
            out[name] = out.get(name, 0.0) + _device_us(e) / 1e3 / calls
    return out


def sdpa_backward_ms(torch, q, k, v, do, causal: bool, reps: int,
                     trials: int, gqa: bool = False) -> dict:
    """SDPA's backward alone: one forward of
    ``scaled_dot_product_attention`` with k and v expanded to q's heads
    (not every backend takes GQA), or with ``gqa`` as they are under
    ``enable_gqa``, then only its backward op,
    ``autograd.grad`` with the graph retained. ``library_ms``: its
    kernels' device time under ``torch.profiler`` (``kernel_times``
    summed), as the kernel's own ``ms`` is device time;
    ``library_eager_ms``: the eager call, the autograd engine's host
    time included."""
    import torch.nn.functional as F
    g = 1 if gqa else q.shape[1] // k.shape[1]
    leaves = [q.detach().clone().requires_grad_()] + [
        t.repeat_interleave(g, dim=1).requires_grad_() for t in (k, v)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                         enable_gqa=gqa)

    def backward():
        return torch.autograd.grad(out, leaves, do, retain_graph=True)
    kernels = kernel_times(torch, backward)
    return {"library_ms": sum(kernels.values()),
            "library_kernels_ms": kernels,
            "library_eager_ms": eager_ms(backward, reps=reps,
                                         trials=trials),
            "library_op": out.grad_fn.name()}


def tower_attention_backward(torch, dev) -> dict:
    """The tower's attention backward at the path's shape, (512, 4, 8,
    16) f32, bidirectional: the backward kernel (its route, held to the
    plain VJP within 1e-4 of each gradient's largest entry) in a
    replayed graph and eagerly; the plain attention's VJP that the tower
    differentiated before it took the kernel, its device time summed
    over its kernels under ``torch.profiler``, a mean over 20 calls
    (the forward recomputed inside it is part of its cost); SDPA's
    backward alone."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(13)
    shape = (ROUNDS_ROWS, HEADS, TOKENS, DIM // HEADS)
    q, k, v, grad = (torch.randn(shape, generator=g).to(dev)
                     for _ in range(4))
    o, lse = fa.flash_attention(q, k, v, causal=False, return_lse=True)

    def kernel():
        return fa.flash_attention_bwd(q, k, v, o, grad, causal=False,
                                      lse=lse)
    err = grad_rel_err(kernel(), ref.attention_vjp_ref(q, k, v, grad,
                                                       causal=False))
    if not err <= 1e-4:
        raise AssertionError("attention's backward kernel disagrees with "
                             "the plain VJP at the tower's shape")
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))

    def plain():
        out = ref.attention_ref(qs, ks, vs, causal=False)
        return torch.autograd.grad(out, (qs, ks, vs), grad)

    for _ in range(3):
        plain()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            plain()
        torch.cuda.synchronize()
    total = sum(_device_us(e) for e in prof.key_averages()
                if e.device_type is not None
                and "cuda" in str(e.device_type).lower())
    out = {"shape": list(shape), "variant": fa.bwd_variant(q, k, v),
           "max_abs_err": err, "ms": graph_ms(kernel, reps=50, trials=10),
           "eager_ms": eager_ms(kernel, reps=50, trials=10),
           "plain_ms": total / 1e3 / 20,
           "plain_eager_ms": eager_ms(plain, reps=20, trials=5),
           **sdpa_backward_ms(torch, q, k, v, grad, False, 20, 5),
           **attention_bwd_bound(q, k, False)}
    log(f"flash_attention_bwd split-NN tower {shape} bidirectional f32: "
        f"{out}")
    return out


def default_tower_check(torch, dev, cfg, master, members) -> float:
    """Phase 4b: a tower built from the DSL's defaults (embed dim 32,
    attn_block of 4 heads: head dim 8) in both parties, on the card:
    ``predict`` of 64 matched rows in one federated round, which must
    launch each kernel twice (the master's bottom tower and the
    member's) and give finite scores within 5e-3 of the same weights on
    the plain versions. Returns the largest difference."""
    import numpy as np
    from repro_torch.core.party import VFLJob
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quantize as qz
    dcfg = dataclasses.replace(cfg, tower=DEFAULT_TOWER)
    n = len(set(master.ids) & set(members[0].ids))
    rows = np.random.default_rng(9).choice(n, QUERY_ROWS, replace=False)
    job = VFLJob(dcfg, master, members, mode="thread", device=dev)
    job.predict(rows=rows[:2], batch_size=2)         # warm-up
    sync(torch, dev)
    fa.launches.reset()
    qz.launches.reset()
    scores = job.predict(rows=rows, batch_size=len(rows))
    sync(torch, dev)
    got = {"flash_attention": fa.launches.count,
           "quantize_int8": qz.launches.count}
    results = job.shutdown()
    if got != {"flash_attention": 2, "quantize_int8": 2}:
        raise AssertionError(f"default tower predict launched {got}, "
                             f"expected 2 of each")
    items = master.y.shape[1]
    if scores.shape != (QUERY_ROWS, items) or not np.isfinite(scores).all():
        raise AssertionError(f"default tower scores {scores.shape}")
    plain = plain_scores(torch, dev, dcfg, master, members, results, rows)
    err = float(np.abs(scores - plain).max())
    log(f"default DSL tower {DEFAULT_TOWER} (head dim 8): predict of "
        f"{QUERY_ROWS} rows launched {got}; vs plain versions max_abs_err "
        f"{err:.3e} (tol 5e-3)")
    if not err <= 5e-3:
        raise AssertionError("default tower scores disagree with the "
                             "plain versions")
    return err


def time_kernels(torch, dev):
    """Phase 5: the split-NN kernels timed at the path's shapes (inputs
    hot in L2, as the path's preceding matmuls leave them)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(3)
    r = ROUNDS_ROWS
    q, k, v = (torch.randn((r, HEADS, TOKENS, DIM // HEADS),
                           generator=g).to(dev) for _ in range(3))
    x = torch.randn((TOKENS * r, DIM), generator=g).to(dev)
    nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    b, h, s, dh = q.shape
    variant = fa.variant(q, k, v)
    att = time_call(lambda: fa.flash_attention(q, k, v, causal=False),
                    lambda: ref.attention_ref(q, k, v, causal=False),
                    lambda: F.scaled_dot_product_attention(q, k, v),
                    2 * nbytes(q) + nbytes(k, v),
                    4.0 * b * h * s * s * dh,          # q.k and p.v
                    rate=product_rate(q.dtype))
    att["variant"] = variant
    qo, so = qz.quantize_int8(x)
    quant = time_call(lambda: qz.quantize_int8(x),
                      lambda: ref.quantize_int8_ref(x), None,
                      nbytes(x, qo, so),
                      5.0 * x.numel())  # abs, max, divide, round, clamp
    quant["variant"] = qz.variant(x)
    quant["floor"] = quantize_floor(torch, x)
    # where bytes dominate: 256 MiB in, past the L2
    big = torch.randn((QUANT_LARGE_ROWS, DIM), device=dev,
                      generator=torch.Generator(dev).manual_seed(4))
    qb, sb = qz.quantize_int8(big)
    few = dict(reps=20, trials=10)
    large = {"shape": list(big.shape), "variant": qz.variant(big),
             "ms": graph_ms(lambda: qz.quantize_int8(big), **few),
             "plain_ms": graph_ms(lambda: ref.quantize_int8_ref(big),
                                  reps=2, trials=3),
             "floor": quantize_floor(torch, big, few)}
    large.update(_bound(nbytes(big, qb, sb), 5.0 * big.numel()))
    large["byte_rate_share"] = large["bound_ms"] / large["ms"]
    quant["large"] = large
    log(f"quantize_int8 at {tuple(x.shape)}: {quant}")
    del big, qb, sb
    return att, quant


def quantize_floor(torch, x, timing: dict | None = None) -> dict:
    """What bounds the quantize kernel's vector variant from below at
    x's shape (f32): an empty kernel on its grid, and a copy of the same
    bytes (x read, a byte an element written) with its loads, stores and
    grid (``repro_quantize_int8_floor``), each timed as ``graph_ms``."""
    from repro_torch.kernels import _build
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)

    def launch(kind):
        err = _build.library().repro_quantize_int8_floor(
            x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], kind,
            torch.cuda.current_stream().cuda_stream)
        _build.check(err, "quantize_int8 floor")

    timing = timing or {}
    return {"empty_ms": graph_ms(lambda: launch(0), **timing),
            "copy_ms": graph_ms(lambda: launch(1), **timing)}


def time_call(kernel, plain, library, nbytes: float, ops: float,
              timing: dict | None = None,
              plain_timing: dict | None = None,
              rate: float = F32_FLOP_S) -> dict:
    """CUDA-event times of a kernel's wrapper, its plain version and the
    one PyTorch call that computes the same function (``library``, None
    where there is none), all on the same inputs, and the least time of
    ``nbytes`` and ``ops`` (``_bound``: each input read once and each
    output written once, the operations at ``rate``). Device times
    come from graph replay; the eager times per call stand beside them,
    since the host's dispatch bounds those. ``timing`` and
    ``plain_timing`` are ``graph_ms`` / ``eager_ms`` keywords."""
    timing = timing or {}
    plain_timing = plain_timing or timing
    out = {"ms": graph_ms(kernel, **timing),
           "eager_ms": eager_ms(kernel, **timing),
           "plain_ms": graph_ms(plain, **plain_timing),
           "plain_eager_ms": eager_ms(plain, **plain_timing),
           "library_ms": graph_ms(library, **timing) if library else None}
    out.update(_bound(nbytes, ops, rate))
    return out


def wkv_inputs(torch, dev, b, h, s, dh, dtype, g):
    """r, k, v, w (b, h, s, dh) of ``dtype`` and u (h, dh) f32 on the
    card, drawn as the JAX kernel test draws them."""
    r, k, v = (torch.randn((b, h, s, dh), generator=g) for _ in range(3))
    w = torch.sigmoid(torch.randn((b, h, s, dh), generator=g)) * 0.5 + 0.45
    u = torch.randn((h, dh), generator=g) * 0.3
    return ([t.to(dtype).to(dev) for t in (r, k, v, w)]
            + [u.to(dev)])


def wkv_bound(b, h, s, dh) -> tuple:
    """The WKV recurrence's least f32 work at (b, h, s, dh): (bytes, ops)
    of the forward and of the backward. Forward: r, k, v, w and u read
    once, y and S_final written once; 5 dh^2 flops a step of a (batch,
    head) pair (read-out r.S: dh^2 FMAs; update w*S + k v^T: a multiply
    and an FMA per element; the bonus term is O(dh)). Backward: r, k, v,
    w, dy and dS read, dr, dk, dv, dw written, u read and du written;
    12 dh^2 a step, the recomputed update and five products with a
    vector."""
    n_el = b * h * s * dh
    return (((5 * n_el + h * dh + b * h * dh * dh) * 4, 5.0 * n_el * dh),
            ((9 * n_el + b * h * dh * dh + 2 * h * dh) * 4,
             12.0 * n_el * dh))


def check_wkv(torch, dev):
    """Phase 6a: the WKV kernel against its plain version on the card,
    at the prefill path's shape and the JAX kernel test's shapes."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_wkv as wkv
    cfg = zoo_config()
    h, dh = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    path_case = (SCORE_BATCH, h, SCORE_TOKENS - 1, dh, "float32")
    g = torch.Generator().manual_seed(5)
    err = None
    for case in [path_case, (SCORE_BATCH, h, SCORE_TOKENS, dh,
                             "float32")] + WKV_CASES:
        b, hh, s, d, dt = case
        ins = wkv_inputs(torch, dev, b, hh, s, d, getattr(torch, dt), g)
        y, sf = wkv.rwkv6_wkv(*ins)
        ey, es = ref.rwkv6_ref(*ins)
        torch.cuda.synchronize()
        tol = 5e-2 if dt == "bfloat16" else 5e-5
        torch.testing.assert_close(y, ey, atol=tol, rtol=tol)
        torch.testing.assert_close(sf, es, atol=tol, rtol=tol)
        e = max((y - ey).abs().max().item(), (sf - es).abs().max().item())
        log(f"rwkv6_wkv {case}: max_abs_err {e:.3e} (tol {tol})")
        if case is path_case:
            err = e
    return err


def zoo_config():
    from repro_torch.configs import get_config
    cfg = get_config(ZOO_ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab) == \
        (32, 4096, 14336, 65536), "the full rwkv6-7b config"
    return cfg


def draw_params(torch, dev, cfg):
    """The model's f32 params, drawn on the card from seed 0; logs their
    count and size."""
    from repro_torch.models import params as PRM, transformer as T
    t0 = time.perf_counter()
    with torch.inference_mode():
        params = PRM.init_tree(T.model_spec(cfg),
                               torch.Generator(dev).manual_seed(0),
                               torch.float32, dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    # the spec's count is above the config's analytic one, which leaves
    # out the norms (and for rwkv6-7b the mixes, and counts its gate as a
    # LoRA where the spec, the JAX package's, has a full projection)
    log(f"{cfg.arch_id}: {n_params:,} params ({cfg.param_count():,} by "
        f"the config's count) in f32, {n_params * 4 / 1e9:.2f} GB, drawn "
        f"on the card in {time.perf_counter() - t0:.1f} s")
    return params


def decode_vs_prefill(torch, dev, cfg, params, seq) -> float:
    """Teacher-forced ``decode_step`` logits of the tokens ``seq`` (1, s)
    against ``forward``'s, each within 2e-3; returns the largest
    difference."""
    from repro_torch.models import transformer as T
    err = 0.0
    with torch.inference_mode():
        ref_logits, _ = T.forward(cfg, params, {"tokens": seq},
                                  torch.float32)
        cache = T.init_cache(cfg, 1, seq.shape[1], torch.float32, dev)
        for i in range(seq.shape[1]):
            logits, cache = T.decode_step(cfg, params, seq[:, i:i + 1],
                                          cache, i, None, torch.float32)
            torch.testing.assert_close(logits[:, 0], ref_logits[:, i],
                                       rtol=2e-3, atol=2e-3)
            err = max(err, (logits[:, 0] - ref_logits[:, i]
                            ).abs().max().item())
    return err


def check_generated(out, prompts, vocab: int) -> None:
    """``generate``'s output: the prompts, then GEN_NEW in-vocab tokens."""
    import numpy as np
    if out.shape != (GEN_BATCH, GEN_PROMPT + GEN_NEW) \
            or not ((out >= 0) & (out < vocab)).all() \
            or not np.array_equal(out[:, :GEN_PROMPT], prompts):
        raise AssertionError(f"generate gave {out.shape} {out[:, -4:]}")


def serve_model(torch, dev, cfg, tag: str, kernels: dict,
                variants: dict | None = None,
                score_tokens: int = SCORE_TOKENS):
    """Phases 6b, 7b and 9b: ``cfg`` served through ``ServeEngine``, on
    f32 weights drawn on the card: ``score`` of a (4, ``score_tokens``)
    batch, which must give a finite loss (router losses
    included where the model has them); the same ``score`` through an
    engine of each config in ``variants`` (name -> config) on the same
    weights; decode-vs-prefill logits; greedy ``generate``; prefill and
    decode tokens/s and their profiles. ``kernels`` maps each kernel of
    the path to (its launch counter, its launches in a ``score``, its
    launches in a decode step): each counted run sets every count to 0
    just before it and must read exactly those just after. Returns (the
    launches of each counted run, by ``{tag}_{run}``, the measured
    numbers)."""
    import numpy as np
    from repro_torch.serve.engine import ServeEngine
    params = draw_params(torch, dev, cfg)
    mark(f"{tag} weights")
    steps = GEN_PROMPT + GEN_NEW - 1
    per_score = {name: n for name, (_, n, _) in kernels.items()}
    per_generate = {name: n * steps for name, (_, _, n) in kernels.items()}
    launches = {}

    def counted(run, fn, expected):
        for counter, _, _ in kernels.values():
            counter.reset()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {name: c.count for name, (c, _, _) in kernels.items()}
        launches[f"{tag}_{run}"] = got
        if got != expected:
            raise AssertionError(f"{cfg.arch_id} {run} launched {got}, "
                                 f"expected {expected}")
        return out, wall

    def engine(c):
        return ServeEngine(c, params, max_seq=GEN_PROMPT + GEN_NEW + 1,
                           dtype=torch.float32, device=dev)

    eng = engine(cfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (SCORE_BATCH, score_tokens))
    torch.cuda.reset_peak_memory_stats()
    eng.score(toks)                    # warm-up: cuBLAS, the library
    torch.cuda.synchronize()
    loss, score_s = counted("score", lambda: eng.score(toks), per_score)
    if not np.isfinite(loss):
        raise AssertionError(f"score gave a non-finite loss {loss}")
    prefill_tok = SCORE_BATCH * (score_tokens - 1)
    log(f"{cfg.arch_id} score of ({SCORE_BATCH}, {score_tokens}) tokens: "
        f"loss {loss:.6f} (ln vocab {np.log(cfg.vocab):.6f}) in "
        f"{score_s * 1e3:.1f} ms; launches {launches[f'{tag}_score']}")
    log(f"{cfg.arch_id} prefill tokens/s: {prefill_tok / score_s:.1f}")
    prof_prefill = profile_window(torch, lambda: eng.score(toks), score_s)
    log(f"{tag} profile prefill " + json.dumps(prof_prefill))
    mark(f"{tag} score and its profile")
    measured = {"loss": loss, "score_s": score_s,
                "prefill_tok_s": prefill_tok / score_s}

    for name, vcfg in (variants or {}).items():
        v = engine(vcfg)
        v_loss, v_s = counted(f"{name}_score", lambda: v.score(toks),
                              per_score)
        if not np.isfinite(v_loss):
            raise AssertionError(f"{name} score gave a non-finite loss "
                                 f"{v_loss}")
        log(f"{cfg.arch_id} {name} score: loss {v_loss:.6f} in "
            f"{v_s * 1e3:.1f} ms (one call, not warmed up); launches "
            f"{launches[f'{tag}_{name}_score']}")
        measured.update({f"{name}_loss": v_loss, f"{name}_score_s": v_s})
        del v

    # decode against prefill where no assignment drops: capacity_factor
    # E / top_k gives every expert room for every token, at any count
    nd = cfg
    if cfg.moe is not None:
        m = cfg.moe
        nd = dataclasses.replace(cfg, moe=dataclasses.replace(
            m, capacity_factor=m.num_experts / m.top_k))
    seq = torch.as_tensor(rng.integers(0, cfg.vocab, (1, CONSIST_TOKENS)),
                          device=dev)
    mark(f"{tag} variants")
    consist_err = decode_vs_prefill(torch, dev, nd, params, seq)
    mark(f"{tag} decode vs prefill")
    at = "" if nd.moe is None else \
        f" at capacity_factor {nd.moe.capacity_factor}"
    log(f"{cfg.arch_id} decode vs prefill logits over {CONSIST_TOKENS} "
        f"tokens{at}: max_abs_err {consist_err:.3e} (tol 2e-3)")

    prompts = rng.integers(0, cfg.vocab, (GEN_BATCH, GEN_PROMPT))
    eng.generate(prompts[:, :2], 2)             # warm-up
    torch.cuda.synchronize()
    out, gen_s = counted("generate",
                         lambda: eng.generate(prompts, GEN_NEW), per_generate)
    check_generated(out, prompts, cfg.vocab)
    # every decode step advances the whole batch by one token: the
    # prompt's teacher-forced steps and the new tokens' (the last new
    # token needs no step of its own)
    decode_tok = GEN_BATCH * steps
    log(f"{cfg.arch_id} generate {GEN_NEW} tokens from {GEN_BATCH} prompts "
        f"of {GEN_PROMPT}: {gen_s * 1e3:.1f} ms; launches "
        f"{launches[f'{tag}_generate']}; first new tokens "
        f"{out[:, GEN_PROMPT:GEN_PROMPT + 4].tolist()}")
    log(f"{cfg.arch_id} decode tokens/s: {decode_tok / gen_s:.1f}")
    mark(f"{tag} generate")
    # the decode profile's window: PROFILE_GEN of the prompts' tokens and
    # new ones, timed alone; tracing the whole generate (~140k launches
    # at granite) took ~40 s
    short = prompts[:, :PROFILE_GEN[0]]
    t0 = time.perf_counter()
    eng.generate(short, PROFILE_GEN[1])
    torch.cuda.synchronize()
    short_s = time.perf_counter() - t0
    prof_decode = profile_window(
        torch, lambda: eng.generate(short, PROFILE_GEN[1]), short_s)
    log(f"{tag} profile decode ({PROFILE_GEN[0]} prompt tokens and "
        f"{PROFILE_GEN[1]} new) " + json.dumps(prof_decode))
    mark(f"{tag} decode profile")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"{cfg.arch_id} peak device memory {peak:.2f} GiB")
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    measured.update({"consist_err": consist_err, "generate_s": gen_s,
                     "decode_tok_s": decode_tok / gen_s,
                     "prefill_busy_share": prof_prefill["device_busy_share"],
                     "decode_busy_share": prof_decode["device_busy_share"],
                     "peak_gib": peak})
    log(f"{tag} " + json.dumps(measured))
    return launches, measured


def _device_us(e) -> float:
    t = getattr(e, "self_device_time_total", None)
    return float(t if t is not None else e.self_cuda_time_total)


def profile_window(torch, fn, wall_s: float) -> dict:
    """Runs ``fn`` once under ``torch.profiler`` and sums its kernels'
    device time, by kind (the port's WKV, selective-scan, grouped-matmul
    and attention kernels and the backward kernels, library matmuls, the
    rest; the backward kernels' second pass, ``sum_parts``, is in the
    rest) and for the
    six longest kernels. The busy share is that device time over
    ``wall_s``, the wall time of the same call timed without the
    profiler: the profiler slows the host's dispatch, not the kernels,
    and the kernels run one at a time on one stream."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    # the kernels alone: the numbers are device times, and tracing the
    # host's ops too gives the same ones and more than doubles the time
    # to collect a decode window of ~140k launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type is not None
               and "cuda" in str(e.device_type).lower()
               and _device_us(e) > 0]
    device_ms = sum(_device_us(e) for e in kernels) / 1e3
    kinds = {"wkv": 0.0, "wkv_bwd": 0.0, "scan": 0.0, "scan_bwd": 0.0,
             "gmm": 0.0, "attention": 0.0, "attention_bwd": 0.0,
             "quantize": 0.0, "matmul": 0.0, "other": 0.0}
    for e in kernels:
        name = e.key.lower()
        kind = ("wkv_bwd" if "rwkv6_wkv_bwd" in name else
                "wkv" if "rwkv6_wkv" in name else
                "scan_bwd" if "selective_scan_bwd" in name else
                "scan" if "selective_scan" in name else
                "gmm" if "gmm_" in name else
                "attention_bwd" if "attention_bwd" in name else
                "attention" if "attention_" in name
                or "hidden_keys" in name else
                "quantize" if "quantize_" in name else
                "matmul" if any(m in name for m in MATMUL_MARKS) else
                "other")
        kinds[kind] += _device_us(e) / 1e3
    ranked = sorted(kernels, key=_device_us, reverse=True)[:6]
    return {"wall_ms": wall_s * 1e3, "device_ms": device_ms,
            "device_busy_share": device_ms / 1e3 / wall_s,
            "kernel_launches": sum(e.count for e in kernels),
            "device_ms_by_kind": kinds,
            "top_kernels": [{"name": e.key[:90], "count": e.count,
                             "device_ms": _device_us(e) / 1e3}
                            for e in ranked]}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def time_wkv(torch, dev):
    """Phase 6c: the WKV kernel at the prefill path's shape."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_wkv as wkv
    cfg = zoo_config()
    b, h, s, dh = (SCORE_BATCH, cfg.d_model // cfg.rwkv.head_dim,
                   SCORE_TOKENS - 1, cfg.rwkv.head_dim)
    g = torch.Generator().manual_seed(6)
    ins = wkv_inputs(torch, dev, b, h, s, dh, torch.float32, g)
    (nbytes, flops), _ = wkv_bound(b, h, s, dh)
    out = time_call(lambda: wkv.rwkv6_wkv(*ins), lambda: ref.rwkv6_ref(*ins),
                    None,        # no PyTorch call computes the recurrence
                    nbytes, flops,
                    # the plain version is a loop of ~3,000 small kernels
                    plain_timing=dict(reps=2, trials=5))
    log(f"rwkv6_wkv at {(b, h, s, dh)} f32: {nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.2f} GFLOP; bound {out['bound_ms'] * 1e3:.1f} us "
        f"({out['bound_by']})")
    return out


def moe_config():
    from repro_torch.configs import get_config
    cfg = get_config(MOE_ARCH)
    m = cfg.moe
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, m.num_experts, m.top_k, m.d_expert, cfg.vocab) == \
        (32, 1536, 24, 8, 64, 40, 8, 512, 49155), \
        "the full granite-moe-3b-a800m config"
    assert cfg.block_pattern == (("attn", "moe"),)
    return cfg


def gmm_path_shapes(cfg, score_tokens: int = SCORE_TOKENS):
    """(name, (e, c, d, f)) of the grouped-matmul calls on the MoE path:
    gate/up (two launches a layer) and down (one) at the capacity of a
    (4, ``score_tokens`` - 1)-token prefill and at that of a batch-4
    decode step."""
    from repro_torch.models import moe
    pre = moe._capacity(SCORE_BATCH * (score_tokens - 1), cfg)
    dec = moe._capacity(GEN_BATCH, cfg)
    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_expert
    return [("prefill_gate_up", (e, pre, d, f)),
            ("prefill_down", (e, pre, f, d)),
            ("decode_gate_up", (e, dec, d, f)),
            ("decode_down", (e, dec, f, d))]


def prefill_attention_shapes(cfg, score_tokens: int = SCORE_TOKENS):
    """q and k/v shapes of the model's prefill self-attention (MLA's: a
    k head a q head, of head dim nope + rope, v padded to it)."""
    s = score_tokens - 1
    if cfg.attention == "mla":
        dh = cfg.mla.nope_head_dim + cfg.mla.rope_head_dim
        return ((SCORE_BATCH, cfg.n_heads, s, dh),) * 2
    return ((SCORE_BATCH, cfg.n_heads, s, cfg.head_dim),
            (SCORE_BATCH, cfg.n_kv_heads, s, cfg.head_dim))


def v_head_dim(cfg):
    """v's own head dim where it is narrower than the kernel's (MLA's,
    whose v the call pads with zero columns), else None."""
    return cfg.mla.v_head_dim if cfg.attention == "mla" else None


def attention_inputs(torch, dev, qs, ks, g, dv=None):
    """q, k, v on the card; v's columns past ``dv`` zero, as MLA's call
    pads them."""
    q = torch.randn(qs, generator=g).to(dev)
    k, v = (torch.randn(ks, generator=g).to(dev) for _ in range(2))
    if dv is not None:
        v[..., dv:] = 0
    return q, k, v


def check_attention(torch, dev, qs, ks, window: int, g, dv=None,
                    causal: bool = True) -> float:
    """The attention kernel against its plain version at a model's
    prefill shape (causal unless ``causal`` is False, ``window`` as the
    model sets it; v's columns past ``dv`` zero), f32, within 2e-5;
    returns the largest difference."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    q, k, v = attention_inputs(torch, dev, qs, ks, g, dv)
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    exp = ref.attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, exp, atol=2e-5, rtol=2e-5)
    err = (out - exp).abs().max().item()
    if dv is not None and torch.count_nonzero(out[..., dv:]).item():
        raise AssertionError("attention: v's zero columns gave nonzero "
                             "output columns")
    padded = "" if dv is None else f", v's columns past {dv} zero"
    log(f"attention q {qs} k/v {ks} causal={causal} window {window} "
        f"f32{padded} ({fa.variant(q, k, v)}): max_abs_err {err:.3e} "
        f"(tol 2e-5)")
    return err


def check_moe_kernels(torch, dev, cfg, score_tokens: int = SCORE_TOKENS,
                      jax_cases: bool = True):
    """Phases 7a and 9a: the grouped-matmul kernel against its plain
    version at the MoE path's shapes (and the JAX kernel test's), and
    the attention kernel at the model's prefill shape. The gmm's inputs
    are drawn on the card: a jamba expert's 805 M weights take seconds
    to draw on the host."""
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(8)
    gd = torch.Generator(dev).manual_seed(8)
    errs = {}
    cases = [(name, shape + ("float32",))
             for name, shape in gmm_path_shapes(cfg, score_tokens)]
    if jax_cases:
        cases += [(None, c) for c in GMM_CASES]
    for name, case in cases:
        e, c, d, f, dt = case
        dtype = getattr(torch, dt)
        x = torch.randn((e, c, d), generator=gd, device=dev)
        w = torch.randn((e, d, f), generator=gd, device=dev)
        if name:
            # the path's magnitudes: rmsnorm-ed activations, weights of
            # std 1/sqrt(d) at most (the spec's std is smaller still)
            w = w * d ** -0.5
        x, w = x.to(dtype), w.to(dtype)
        out = gmm.moe_gmm(x, w)
        exp = ref.gmm_ref(x, w)
        torch.cuda.synchronize()
        tol = 5e-2 if dtype == torch.bfloat16 else 2e-4
        torch.testing.assert_close(out.float(), exp.float(), atol=tol,
                                   rtol=tol)
        err = (out.float() - exp.float()).abs().max().item()
        log(f"moe_gmm {case}: max_abs_err {err:.3e} (atol = rtol = {tol})")
        if name:
            errs[name] = err
        del x, w, out, exp
    qs, ks = prefill_attention_shapes(cfg, score_tokens)
    errs["attention"] = check_attention(torch, dev, qs, ks, 0, g,
                                        v_head_dim(cfg))
    return errs


def time_attention(torch, dev, cfg, qs, ks, window: int, g,
                   timing: dict, dv=None, causal: bool = True) -> dict:
    """The attention kernel at one of a model's shapes (causal unless
    ``causal`` is False, ``window``; v's columns past ``dv`` zero, as
    MLA's call pads them) beside its plain version and SDPA (a yardstick
    only; it takes v of ``dv`` columns itself)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.launch.attention_turns import kernel_us
    q, k, v = attention_inputs(torch, dev, qs, ks, g, dv)
    b, h, s, dh = qs
    sk = ks[2]
    dv = dh if dv is None else dv
    v_own = v[..., :dv].contiguous()
    if window and window < sk:
        raise ValueError("SDPA's is_causal has no window: time the "
                         "attention kernel where the window masks nothing")
    if causal and s != sk:
        raise ValueError("SDPA's is_causal aligns the diagonal top-left")
    # the model's own work: q, k and v of dv columns read once, o of dv
    # columns written once; q.k at dh and p.v at dv over the visible
    # pairs only, s (s + 1) / 2 a (batch, head) when causal. A padded
    # v's extra columns are the kernel's cost, not the function's
    nbytes = (q.numel() + k.numel() + v_own.numel() + b * h * s * dv) * 4
    pairs = s * (s + 1) / 2 if causal else s * sk
    ops = 2.0 * b * h * (dh + dv) * pairs
    variant = fa.variant(q, k, v)
    att = time_call(
        lambda: fa.flash_attention(q, k, v, causal=causal, window=window),
        lambda: ref.attention_ref(q, k, v, causal=causal, window=window),
        lambda: F.scaled_dot_product_attention(
            q, k, v_own, is_causal=causal, enable_gqa=True),
        nbytes, ops, timing, rate=product_rate(q.dtype))
    att["variant"] = variant
    if route_rate(variant) != att["op_rate_tflop_s"] * 1e12:
        # the same work at the peak of the route the kernel took (f32
        # FMAs for the SIMT kernel), beside the bound
        att["route_bound_ms"] = _bound(nbytes, ops,
                                       route_rate(variant))["bound_ms"]
    if dv != dh:
        # SDPA on the padded v: what the pad costs a library kernel
        att["library_padded_v_ms"] = graph_ms(
            lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True), **timing)
    # device time a call of each kernel it launches: the attention
    # kernel and its hidden-key fix-up apart
    att["kernel_us"] = kernel_us(
        lambda: fa.flash_attention(q, k, v, causal=causal, window=window))
    log(f"flash_attention {cfg.arch_id} q {qs} k/v {ks} causal={causal} "
        f"f32: {att}")
    return att


def time_moe_kernels(torch, dev, cfg, score_tokens: int = SCORE_TOKENS,
                     prefill_timing: dict | None = None):
    """Phases 7c and 9c: the grouped matmul at the MoE path's four
    shapes and the attention kernel at its prefill shape, beside
    ``torch.bmm`` and SDPA (yardsticks only: the port calls neither).
    ``prefill_timing`` sets the repetitions at the prefill shapes. The
    gmm's inputs are drawn on the card, as ``check_moe_kernels``
    draws them."""
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(9)
    gd = torch.Generator(dev).manual_seed(9)
    few = dict(reps=20, trials=10)
    gmm_t = {}
    for name, (e, c, d, f) in gmm_path_shapes(cfg, score_tokens):
        x = torch.randn((e, c, d), generator=gd, device=dev)
        w = torch.randn((e, d, f), generator=gd, device=dev) * d ** -0.5
        # x and w read once, the output written once; 2 e c d f flops
        variant = gmm.variant(x, w)
        t = time_call(lambda: gmm.moe_gmm(x, w), lambda: ref.gmm_ref(x, w),
                      lambda: torch.bmm(x, w),
                      (x.numel() + w.numel() + e * c * f) * 4,
                      2.0 * e * c * d * f,
                      (prefill_timing or few) if name.startswith("prefill")
                      else few, rate=product_rate(x.dtype))
        t["variant"] = variant
        log(f"moe_gmm {name} {(e, c, d, f)} f32: {t}")
        gmm_t[name] = t
        del x, w
    qs, ks = prefill_attention_shapes(cfg, score_tokens)
    att = time_attention(torch, dev, cfg, qs, ks, 0, g, few,
                         v_head_dim(cfg))
    return gmm_t, att


def h2o_config():
    from repro_torch.configs import get_config
    cfg = get_config(H2O_ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab, cfg.attention, cfg.window) \
        == (24, 2560, 32, 8, 80, 6912, 32000, "swa", 4096), \
        "the full h2o-danube-1.8b config"
    return cfg


def cold_score(torch, dev, cfg, tag: str, seed: int):
    """Phases 8 and 9b: a dense attention model's head dim on the card.
    The attention kernel against its plain version at the model's
    prefill shape (causal, its window; MLA's v padded), then the full
    model drawn in f32 and one ``score`` of a (4, 512) batch, which
    must give a finite loss with exactly one attention launch a layer
    and no other kernel's; then the kernel's times at that shape.
    Decode and the profile are left out to save time. Returns (the
    error, the score's launches, the times)."""
    import numpy as np
    from repro_torch.serve.engine import ServeEngine
    t_phase = time.perf_counter()
    g = torch.Generator().manual_seed(seed)
    qs, ks = prefill_attention_shapes(cfg)
    window = cfg.window if cfg.attention == "swa" else 0
    err = check_attention(torch, dev, qs, ks, window, g, v_head_dim(cfg))
    params = draw_params(torch, dev, cfg)
    eng = ServeEngine(cfg, params, max_seq=SCORE_TOKENS, dtype=torch.float32,
                      device=dev)
    toks = np.random.default_rng(0).integers(0, cfg.vocab,
                                             (SCORE_BATCH, SCORE_TOKENS))
    counters = all_counters()
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    loss = eng.score(toks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {name: c.count for name, c in counters.items()}
    expected = {name: 0 for name in counters}
    expected["flash_attention"] = cfg.n_layers
    if got != expected:
        raise AssertionError(f"{cfg.arch_id} score launched {got}, "
                             f"expected {expected}")
    if not np.isfinite(loss):
        raise AssertionError(f"{cfg.arch_id} score gave a non-finite loss "
                             f"{loss}")
    log(f"{cfg.arch_id} score of ({SCORE_BATCH}, {SCORE_TOKENS}) tokens: "
        f"loss {loss:.6f} (ln vocab {np.log(cfg.vocab):.6f}) in "
        f"{wall * 1e3:.1f} ms (one call, not warmed up); launches {got}")
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    att = time_attention(torch, dev, cfg, qs, ks, window, g,
                         dict(reps=20, trials=10), v_head_dim(cfg))
    log(f"{cfg.arch_id} phase: {time.perf_counter() - t_phase:.1f} s")
    return err, {f"{tag}_score": {"flash_attention":
                                  got["flash_attention"]}}, att


def all_counters() -> dict:
    """Every kernel wrapper's launch counter, by kernel name."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import rwkv6_wkv as wkv
    from repro_torch.kernels import selective_scan as ssm
    return {"flash_attention": fa.launches,
            "flash_attention_bwd": fa.bwd_launches,
            "quantize_int8": qz.launches, "rwkv6_wkv": wkv.launches,
            "moe_gmm": gmm.launches, "selective_scan": ssm.launches,
            "rwkv6_wkv_bwd": wkv.bwd_launches,
            "selective_scan_bwd": ssm.bwd_launches}


def mla_config():
    from repro_torch.configs import get_config
    cfg = get_config(MLA_ARCH)
    m, a = cfg.moe, cfg.mla
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.vocab,
            m.num_experts, m.top_k, m.num_shared, m.d_expert,
            a.kv_lora_rank, a.q_lora_rank, a.nope_head_dim, a.rope_head_dim,
            a.v_head_dim) == (27, 2048, 16, 10944, 102400, 64, 6, 2, 1408,
                              512, None, 128, 64, 128), \
        "the full deepseek-v2-lite-16b config"
    assert cfg.prefix_pattern == (("attn", "mlp"),) and \
        cfg.block_pattern == (("attn", "moe"),)
    return cfg


def minicpm_config():
    from repro_torch.configs import get_config
    cfg = get_config(MINICPM_ARCH)
    a = cfg.mla
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.vocab,
            a.kv_lora_rank, a.q_lora_rank, a.nope_head_dim, a.rope_head_dim,
            a.v_head_dim) == (62, 2560, 40, 6400, 73448, 256, 768, 64, 32,
                              64), "the full minicpm3-4b config"
    return cfg


def mla_phase(torch, dev):
    """Phase 9b: multi-head latent attention on the card. The grouped
    matmul against its plain version at deepseek-v2-lite-16b's four
    shapes and attention at its prefill shape, (4, 16, 511, 192) causal
    with v's columns past 128 zero, as the MLA call pads them (the SIMT
    kernel: head dims above 128); the full 27-layer model served
    (``serve_model``: 27 attention and 78 gmm launches a ``score``, 78
    gmm launches and no attention a decode step; decode vs prefill at
    ``capacity_factor`` 64 / 6); both kernels' times at the path's
    shapes; then minicpm3-4b's attention at (4, 40, 511, 96), v past 64
    zero, and one cold ``score`` of the full 62 layers with exactly 62
    attention launches. Returns (errors, launches by run, times)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm
    t_phase = time.perf_counter()
    cfg = mla_config()
    errs = check_moe_kernels(torch, dev, cfg, jax_cases=False)
    gc.collect()
    torch.cuda.empty_cache()
    n_moe = sum(f == "moe" for _, f in
                cfg.prefix_pattern + cfg.block_pattern * cfg.n_repeats)
    # an attention launch a layer in prefill, none in decode; gate, up,
    # down per MoE layer in both (the dense prefix layer and the shared
    # experts are plain matmuls)
    launches, served = serve_model(
        torch, dev, cfg, "deepseek",
        {"moe_gmm": (gmm.launches, 3 * n_moe, 3 * n_moe),
         "flash_attention": (fa.launches, cfg.n_layers, 0)})
    gmm_t, att = time_moe_kernels(torch, dev, cfg)
    log(f"{MLA_ARCH} phase: {time.perf_counter() - t_phase:.1f} s")
    mc_err, mc_launches, mc_att = cold_score(torch, dev, minicpm_config(),
                                             "minicpm3", 12)
    errs["minicpm3_attention"] = mc_err
    return errs, launches | mc_launches, {
        "served": served, "gmm": gmm_t, "attention": att,
        "minicpm3_attention": mc_att}


def whisper_config():
    from repro_torch.configs import get_config
    cfg = get_config(WHISPER_ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab, cfg.encoder.n_layers,
            cfg.encoder.n_frames, cfg.tie_embeddings) == \
        (32, 1280, 20, 20, 64, 5120, 51866, 32, 1500, False), \
        "the full whisper-large-v3 config"
    return cfg


def whisper_attention_shapes(cfg) -> dict:
    """name -> (q shape, k/v shape, causal) of whisper's four attention
    calls: the encoder's bidirectional self-attention over the frames,
    cross-attention in prefill (sq != sk), the decoder's causal
    self-attention in prefill, and cross-attention in a decode step (one
    query against every frame)."""
    b, h, dh = WHISPER_BATCH, cfg.n_heads, cfg.head_dim
    f, s = cfg.encoder.n_frames, WHISPER_TOKENS
    return {"encoder": ((b, h, f, dh), (b, h, f, dh), False),
            "cross_prefill": ((b, h, s, dh), (b, h, f, dh), False),
            "decoder_self": ((b, h, s, dh), (b, h, s, dh), True),
            "cross_decode": ((b, h, 1, dh), (b, h, f, dh), False)}


def check_whisper_attention(torch, dev, cfg, g) -> dict:
    """Phase 9c's kernel checks: attention against its plain version at
    whisper's four shapes, f32 within 2e-5 (naming the variant each
    runs), and at the encoder's shape with infs in v (two columns of one
    (batch, head), +inf and -inf in one column of another, whose sum is
    NaN): no key tile is skipped when ``causal=False``, so the hidden-key
    fix-up must change nothing and the output must hold the plain
    version's +-inf and NaN exactly. Returns the errors by shape."""
    shapes = whisper_attention_shapes(cfg)
    errs = {name: check_attention(torch, dev, qs, ks, 0, g, causal=causal)
            for name, (qs, ks, causal) in shapes.items()}
    qs, ks, _ = shapes["encoder"]
    q, k, v = attention_inputs(torch, dev, qs, ks, g)
    _, h, f, dh = ks
    v[0, 0, 3, 5], v[0, 0, f - 1, 7] = float("inf"), -float("inf")
    v[1, h - 1, f // 2, dh - 1] = float("inf")
    v[1, h - 1, f // 3, dh - 1] = -float("inf")
    errs["encoder_inf_in_v"] = same_specials(
        torch, q, k, v, False)["finite_max_abs_err"]
    return errs


def time_whisper_attention(torch, dev, cfg, g) -> dict:
    """Phase 9c's kernel times at whisper's four shapes
    (``time_attention``: device ms in a replayed graph and eager ms,
    beside the plain version and SDPA, and the bound over the visible
    pairs)."""
    return {name: time_attention(torch, dev, cfg, qs, ks, 0, g,
                                 dict(reps=20, trials=10), causal=causal)
            for name, (qs, ks, causal)
            in whisper_attention_shapes(cfg).items()}


def attention_counted(torch, cfg, tag: str, launches: dict):
    """``counted(run, fn, attention)`` for a phase whose runs launch only
    the attention kernel: sets every count to 0, runs ``fn`` and waits
    for the card, records the attention launches in ``launches`` under
    ``{tag}_{run}`` and raises unless the attention kernel launched
    exactly ``attention`` times and no other kernel at all. Returns
    (``fn``'s result, its wall time)."""
    counters = all_counters()

    def counted(run, fn, attention: int):
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {name: c.count for name, c in counters.items()}
        expected = {name: 0 for name in counters}
        expected["flash_attention"] = attention
        launches[f"{tag}_{run}"] = {"flash_attention":
                                    got["flash_attention"]}
        if got != expected:
            raise AssertionError(f"{cfg.arch_id} {run} launched {got}, "
                                 f"expected {expected}")
        return out, wall
    return counted


def whisper_phase(torch, dev):
    """Phase 9c: the encoder-decoder on the card. Attention at
    whisper-large-v3's four shapes against its plain version
    (``check_whisper_attention``); the full model (32 encoder layers
    over 1,500 frames, 32 decoder layers with cross-attention; 1.60 B
    params, 6.41 GB in f32) drawn on the card; ``encode`` of frames of
    (4, 1500, 1280) (normal times 0.02) with exactly 32 attention
    launches; ``make_prefill_step`` of (4, 448) tokens and those frames
    with exactly 96 (32 encoder, 32 decoder self, 32 cross); teacher-
    forced ``decode_step``s over the first 16 positions against the
    prefill's logits at the same positions within 2e-3; greedy
    ``generate`` of 64 tokens after a prompt of 4 with 32 attention
    launches a decode step (one cross-attention a layer; the decoder's
    self-attention reads its cache in plain torch), in-vocabulary tokens
    and finite logits at every step; encode ms, prefill and decode
    tokens/s, the busy share of the prefill and of one decode step under
    the profiler, device time by kind, peak memory; then the kernel's
    times at the four shapes. Returns (errors, launches by run, the
    measured numbers)."""
    import numpy as np
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ServeEngine
    t_phase = time.perf_counter()
    cfg = whisper_config()
    g = torch.Generator().manual_seed(13)
    errs = check_whisper_attention(torch, dev, cfg, g)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = draw_params(torch, dev, cfg)
    launches = {}
    counted = attention_counted(torch, cfg, "whisper", launches)

    b, f, d = WHISPER_BATCH, cfg.encoder.n_frames, cfg.d_model
    frames = torch.randn((b, f, d), generator=torch.Generator(dev)
                         .manual_seed(1), device=dev) * 0.02
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (b, WHISPER_TOKENS)),
                           device=dev)
    with torch.inference_mode():
        T.encode(cfg, params, frames)              # warm-up: cuBLAS
        torch.cuda.synchronize()
        memory, enc_s = counted("encode",
                                lambda: T.encode(cfg, params, frames),
                                cfg.encoder.n_layers)
    if memory.shape != (b, f, d) or not torch.isfinite(memory).all():
        raise AssertionError(f"encode gave {tuple(memory.shape)}, finite "
                             f"{bool(torch.isfinite(memory).all())}")
    log(f"{cfg.arch_id} encode of ({b}, {f}, {d}) frames: "
        f"{enc_s * 1e3:.1f} ms; launches {launches['whisper_encode']}")

    prefill = ST.make_prefill_step(cfg, compute_dtype=torch.float32)
    batch = {"tokens": toks, "frames": frames}
    prefill(params, batch)                          # warm-up
    torch.cuda.synchronize()
    last, pre_s = counted("prefill", lambda: prefill(params, batch),
                          cfg.encoder.n_layers + 2 * cfg.n_layers)
    if last.shape != (b, cfg.vocab) or not torch.isfinite(last).all():
        raise AssertionError(f"prefill gave {tuple(last.shape)} logits, "
                             f"finite {bool(torch.isfinite(last).all())}")
    prefill_tok = b * WHISPER_TOKENS
    log(f"{cfg.arch_id} prefill of ({b}, {WHISPER_TOKENS}) tokens and the "
        f"frames: {pre_s * 1e3:.1f} ms, {prefill_tok / pre_s:.1f} tokens/s "
        f"(the encoder's frames not counted); launches "
        f"{launches['whisper_prefill']}")
    prof_prefill = profile_window(torch, lambda: prefill(params, batch),
                                  pre_s)
    log("whisper profile prefill " + json.dumps(prof_prefill))

    # decode vs prefill: the prefill's logits at the first positions
    # (causal, so they are those of the whole 448-token prefill)
    n = WHISPER_CONSIST
    with torch.inference_mode():
        ref_logits, _ = T.forward(cfg, params, batch, torch.float32)
        ref_logits = ref_logits[:, :n].clone()
        cache = T.init_cache(cfg, b, n + 1, torch.float32, dev)
        consist_err = 0.0
        for i in range(n):
            logits, cache = T.decode_step(cfg, params, toks[:, i:i + 1],
                                          cache, i, memory, torch.float32)
            torch.testing.assert_close(logits[:, 0], ref_logits[:, i],
                                       rtol=2e-3, atol=2e-3)
            consist_err = max(consist_err, (logits[:, 0] - ref_logits[:, i]
                                            ).abs().max().item())
        # one more step, timed and profiled alone
        tok = toks[:, n:n + 1]

        @torch.inference_mode()
        def step():
            return T.decode_step(cfg, params, tok, cache, n, memory,
                                 torch.float32)
        step()
        torch.cuda.synchronize()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        step_s = statistics.median(walls)
    log(f"{cfg.arch_id} decode vs prefill logits over {n} positions of "
        f"{b} rows: max_abs_err {consist_err:.3e} (tol 2e-3)")
    prof_step = profile_window(torch, step, step_s)
    log("whisper profile decode_step " + json.dumps(prof_step))
    del ref_logits, cache

    eng = ServeEngine(cfg, params, max_seq=WHISPER_PROMPT + WHISPER_NEW + 1,
                      dtype=torch.float32, device=dev)
    prompts = rng.integers(0, cfg.vocab, (b, WHISPER_PROMPT))
    eng.generate(prompts[:, :2], 2, memory=memory)      # warm-up
    finite = []
    plain_decode = eng._decode

    def checked(tok, cache, index, memory):
        # every step's logits finite: a flag on the card, read after
        logits, cache = plain_decode(tok, cache, index, memory)
        finite.append(torch.isfinite(logits).all())
        return logits, cache

    eng._decode = checked
    steps = WHISPER_PROMPT + WHISPER_NEW - 1
    out, gen_s = counted(
        "generate", lambda: eng.generate(prompts, WHISPER_NEW,
                                         memory=memory),
        cfg.n_layers * steps)
    if len(finite) != steps or not bool(torch.stack(finite).all()):
        raise AssertionError(f"{cfg.arch_id} generate: non-finite logits "
                             f"in {steps} steps")
    if out.shape != (b, WHISPER_PROMPT + WHISPER_NEW) \
            or not ((out >= 0) & (out < cfg.vocab)).all() \
            or not np.array_equal(out[:, :WHISPER_PROMPT], prompts):
        raise AssertionError(f"generate gave {out.shape} {out[:, -4:]}")
    decode_tok = b * steps
    log(f"{cfg.arch_id} generate {WHISPER_NEW} tokens from {b} prompts of "
        f"{WHISPER_PROMPT}: {gen_s * 1e3:.1f} ms, {decode_tok / gen_s:.1f} "
        f"decode tokens/s; launches {launches['whisper_generate']}; first "
        f"new tokens {out[:, WHISPER_PROMPT:WHISPER_PROMPT + 4].tolist()}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"{cfg.arch_id} peak device memory {peak:.2f} GiB")
    del eng, params, memory, frames, batch, last
    gc.collect()
    torch.cuda.empty_cache()
    times = time_whisper_attention(torch, dev, cfg, g)
    measured = {"encode_ms": enc_s * 1e3, "prefill_ms": pre_s * 1e3,
                "prefill_tok_s": prefill_tok / pre_s,
                "decode_step_ms": step_s * 1e3, "generate_s": gen_s,
                "decode_tok_s": decode_tok / gen_s,
                "consist_err": consist_err,
                "prefill_busy_share": prof_prefill["device_busy_share"],
                "decode_step_busy_share": prof_step["device_busy_share"],
                "prefill_device_ms_by_kind": prof_prefill[
                    "device_ms_by_kind"],
                "decode_step_device_ms_by_kind": prof_step[
                    "device_ms_by_kind"],
                "peak_gib": peak}
    log("whisper " + json.dumps(measured))
    log(f"{WHISPER_ARCH} phase: {time.perf_counter() - t_phase:.1f} s")
    return errs, launches, {"served": measured, "attention": times}


def internvl_config():
    """internvl2-76b's language model at full width, cut in depth from 80
    to INTERNVL_LAYERS layers (its 76 B params do not fit one card in
    f32); the vision encoder is a stub in both packages: the batch
    carries its 256 patch embeddings."""
    from repro_torch.configs import get_config
    full = get_config(INTERNVL_ARCH)
    cfg = dataclasses.replace(full, n_layers=INTERNVL_LAYERS)
    fe = cfg.frontend
    assert (full.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab, cfg.rope, cfg.rope_theta,
            fe.kind, fe.num_tokens) == \
        (80, 8192, 64, 8, 128, 28672, 128256, True, 500_000.0, "vision",
         256), "the full internvl2-76b config"
    log(f"{INTERNVL_ARCH}: cut to depth {cfg.n_layers} of {full.n_layers} "
        f"layers; every width as published; {fe.num_tokens} patch "
        f"embeddings (normal x 0.02) in front of {INTERNVL_TEXT} text "
        f"tokens a row")
    return cfg


def internvl_attention_shapes(cfg):
    """q and k/v of the prefill's self-attention over the patches and the
    text: (4, 64, 768, 128) against (4, 8, 768, 128)."""
    s = cfg.frontend.num_tokens + INTERNVL_TEXT
    return ((SCORE_BATCH, cfg.n_heads, s, cfg.head_dim),
            (SCORE_BATCH, cfg.n_kv_heads, s, cfg.head_dim))


def internvl_phase(torch, dev):
    """Phase 9d: the vision prefix on the card. Attention at the
    prefill's shape (q (4, 64, 768, 128), k/v (4, 8, 768, 128), causal)
    against its plain version within 2e-5; the 16-layer internvl2-76b
    (15.8 B params, 63.2 GB in f32) drawn on the card; ``make_prefill_step``
    of (4, 512) tokens behind (4, 256, 8192) patch embeddings, 768
    positions a row, with exactly 16 attention launches, finite last
    logits, tokens/s over every position and the profiled busy share;
    one ``loss_fn`` (16 launches), finite, whose prefix carries no loss:
    its labels there (the zero pad) changed to random tokens leave the
    loss bit for bit, and without the prefix mask it differs; greedy
    ``generate`` of 16 tokens from 4 prompts of 16 (the text path, as the
    JAX package's engine decodes, no kernel launch); ``score`` raising,
    as its batch has no patches; peak memory; the kernel's times at the
    prefill's shape. Returns (error, launches by run, measured)."""
    import numpy as np
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ServeEngine
    t_phase = time.perf_counter()
    cfg = internvl_config()
    g = torch.Generator().manual_seed(19)
    qs, ks = internvl_attention_shapes(cfg)
    err = check_attention(torch, dev, qs, ks, 0, g)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = draw_params(torch, dev, cfg)
    launches = {}
    counted = attention_counted(torch, cfg, "internvl2", launches)

    b, npatch, d = SCORE_BATCH, cfg.frontend.num_tokens, cfg.d_model
    patches = torch.randn((b, npatch, d), generator=torch.Generator(dev)
                          .manual_seed(2), device=dev) * 0.02
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (b, INTERNVL_TEXT + 1)),
                           device=dev)
    batch = {"tokens": toks[:, :-1], "patches": patches}
    prefill = ST.make_prefill_step(cfg, compute_dtype=torch.float32)
    prefill(params, batch)                          # warm-up: cuBLAS
    torch.cuda.synchronize()
    last, pre_s = counted("prefill", lambda: prefill(params, batch),
                          cfg.n_layers)
    if last.shape != (b, cfg.vocab) or not torch.isfinite(last).all():
        raise AssertionError(f"prefill gave {tuple(last.shape)} logits, "
                             f"finite {bool(torch.isfinite(last).all())}")
    positions = b * (npatch + INTERNVL_TEXT)
    log(f"{cfg.arch_id} prefill of ({b}, {INTERNVL_TEXT}) tokens behind "
        f"({b}, {npatch}, {d}) patches: {pre_s * 1e3:.1f} ms, "
        f"{positions / pre_s:.1f} tokens/s over all {positions} positions; "
        f"launches {launches['internvl2_prefill']}")
    prof_prefill = profile_window(torch, lambda: prefill(params, batch),
                                  pre_s)
    log("internvl2 profile prefill " + json.dumps(prof_prefill))
    del last

    # the loss: the prefix masked out, its labels the zero pad
    lbatch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
              "patches": patches}
    seen = {}
    xent = T.layers.softmax_xent

    def capture(logits, labels, mask=None):
        seen.update(logits=logits, labels=labels, mask=mask)
        return xent(logits, labels, mask)
    T.layers.softmax_xent = capture
    try:
        with torch.no_grad():
            (loss, _), loss_s = counted(
                "loss", lambda: T.loss_fn(cfg, params, lbatch,
                                          torch.float32), cfg.n_layers)
    finally:
        T.layers.softmax_xent = xent
    labels, mask = seen["labels"], seen["mask"]
    s_all = npatch + INTERNVL_TEXT
    if labels.shape != (b, s_all) or mask.shape != (b, s_all) \
            or bool(labels[:, :npatch].any()) \
            or bool(mask[:, :npatch].any()) \
            or not bool((mask[:, npatch:] == 1).all()):
        raise AssertionError("loss_fn's labels or mask over the prefix")
    other = labels.clone()
    other[:, :npatch] = torch.randint(0, cfg.vocab, (b, npatch),
                                      generator=torch.Generator(dev)
                                      .manual_seed(3), device=dev)
    with torch.no_grad():
        moved, _ = xent(seen["logits"], other, mask)
        unmasked, _ = xent(seen["logits"], labels, None)
    if not torch.isfinite(loss) or not torch.equal(moved, loss) \
            or torch.equal(unmasked, loss):
        raise AssertionError(f"the prefix carries loss: loss {loss.item()},"
                             f" other labels under it {moved.item()}, "
                             f"unmasked {unmasked.item()}")
    log(f"{cfg.arch_id} loss_fn with the prefix masked: {loss.item():.6f} "
        f"(ln vocab {np.log(cfg.vocab):.6f}) in {loss_s * 1e3:.1f} ms; "
        f"other labels under the {npatch} prefix positions: "
        f"{moved.item():.6f}, bit-identical; without the mask "
        f"{unmasked.item():.6f}; launches {launches['internvl2_loss']}")
    del seen, labels, mask, other, lbatch

    eng = ServeEngine(cfg, params, max_seq=GEN_PROMPT + GEN_NEW + 1,
                      dtype=torch.float32, device=dev)
    prompts = rng.integers(0, cfg.vocab, (GEN_BATCH, GEN_PROMPT))
    eng.generate(prompts[:, :2], 2)                 # warm-up
    torch.cuda.synchronize()
    out, gen_s = counted("generate",
                         lambda: eng.generate(prompts, GEN_NEW), 0)
    check_generated(out, prompts, cfg.vocab)
    decode_tok = GEN_BATCH * (GEN_PROMPT + GEN_NEW - 1)
    log(f"{cfg.arch_id} generate {GEN_NEW} tokens from {GEN_BATCH} prompts "
        f"of {GEN_PROMPT} (the text path): {gen_s * 1e3:.1f} ms, "
        f"{decode_tok / gen_s:.1f} decode tokens/s; launches "
        f"{launches['internvl2_generate']}; first new tokens "
        f"{out[:, GEN_PROMPT:GEN_PROMPT + 4].tolist()}")
    try:
        eng.score(toks.cpu().numpy())
    except ValueError as e:
        log(f"{cfg.arch_id} score raises, as its batch has no patches: {e}")
    else:
        raise AssertionError("score ran without the vision prefix")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"{cfg.arch_id} peak device memory {peak:.2f} GiB")
    del eng, params, patches, batch, toks
    gc.collect()
    torch.cuda.empty_cache()
    att = time_attention(torch, dev, cfg, qs, ks, 0, g,
                         dict(reps=20, trials=10))
    measured = {"layers": cfg.n_layers, "prefill_ms": pre_s * 1e3,
                "prefill_tok_s": positions / pre_s,
                "prefill_busy_share": prof_prefill["device_busy_share"],
                "prefill_device_ms_by_kind": prof_prefill[
                    "device_ms_by_kind"],
                "loss": loss.item(), "loss_ms": loss_s * 1e3,
                "generate_s": gen_s, "decode_tok_s": decode_tok / gen_s,
                "peak_gib": peak}
    log("internvl2 " + json.dumps(measured))
    log(f"{INTERNVL_ARCH} phase: {time.perf_counter() - t_phase:.1f} s")
    return err, launches, {"served": measured, "attention": att}


def jamba_config():
    """One period of jamba-1.5-large-398b at full width: depth 72 -> 8
    layers, experts 16 -> 4 (top-2 kept); every width is jamba's."""
    from repro_torch.configs import get_config
    full = get_config(JAMBA_ARCH)
    cfg = dataclasses.replace(
        full, n_layers=JAMBA_LAYERS,
        moe=dataclasses.replace(full.moe, num_experts=JAMBA_EXPERTS))
    m, mb = cfg.moe, cfg.mamba
    assert (full.n_layers, full.moe.num_experts) == (72, 16), \
        "the full jamba-1.5-large-398b config"
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab, cfg.rope, m.num_experts,
            m.top_k, m.d_expert, mb.d_inner(cfg.d_model), mb.d_state,
            mb.d_conv, mb.dt_rank) == \
        (8, 8192, 64, 8, 128, 24576, 65536, False, 4, 2, 24576, 16384,
         16, 4, 512), "one full-width period of jamba, 4 experts"
    assert [mx for mx, _ in cfg.block_pattern].count("mamba") == 7
    assert [f for _, f in cfg.block_pattern].count("moe") == 4
    log(f"{JAMBA_ARCH}: cut to depth {cfg.n_layers} of {full.n_layers} "
        f"layers (one period) and {m.num_experts} of "
        f"{full.moe.num_experts} experts (top-{m.top_k} kept); every "
        f"width as published")
    return cfg


def scan_inputs(torch, dev, b, s, di, n, x_dtype, u_dtype, g, dt_shift):
    """dt, B, C, u (b, s, ...) and A (di, n) f32 on the card: dt =
    softplus(normal + dt_shift), A = -exp(0.5 normal)."""
    import torch.nn.functional as F
    dt = F.softplus(torch.randn((b, s, di), generator=g) + dt_shift)
    bm, cm = (torch.randn((b, s, n), generator=g) for _ in range(2))
    u = torch.randn((b, s, di), generator=g)
    a = -torch.exp(torch.randn((di, n), generator=g) * 0.5)
    return ([t.to(x_dtype).to(dev) for t in (dt, bm, cm)]
            + [u.to(u_dtype).to(dev), a.to(dev)])


def scan_bound(b, s, di, n) -> tuple:
    """The selective scan's least f32 work at (b, s, di, n): (bytes, ops)
    of the forward and of the backward. Forward: dt, B, C, u, A read
    once, y and h_final written once; 7 operations a state element a
    step (dt * A, its exp, the decay times h, du * B, the sum, h * C and
    its sum) plus dt * u. Backward: dt, u, dy read, d(dt), du written;
    B, C read, dB, dC written; A read, dA written; dh read; 20
    operations a state element and step."""
    return (((3 * b * s * di + 2 * b * s * n + di * n + b * di * n) * 4,
             7.0 * b * s * di * n + b * s * di),
            ((5 * b * s * di + 4 * b * s * n + 2 * di * n + b * di * n) * 4,
             20.0 * b * s * di * n))


def scan_path_shape(cfg):
    mb = cfg.mamba
    return (SCORE_BATCH, JAMBA_SCORE_TOKENS - 1, mb.d_inner(cfg.d_model),
            mb.d_state)


def check_scan(torch, dev, cfg) -> float:
    """Phase 9a: the selective-scan kernel against its plain version at
    jamba's prefill shape, and at the JAX kernel test's shapes within
    its tolerances (2e-5 f32, 3e-2 bf16). At the path's shape the
    tolerance is relative to the output's largest magnitude: 512
    sequential steps of f32 rounding, in another order than the plain
    loop's, grow with the state, not with each element of y. Returns
    the path's largest difference."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import selective_scan as ssm
    g = torch.Generator().manual_seed(11)
    f32 = torch.float32
    # the path's dt: softplus around the model's b_dt of -4.6
    path = scan_path_shape(cfg) + ("float32", "float32")
    err = None
    for case in [path] + SSM_CASES:
        b, s, di, n, xd, ud = case
        shift = -4.6 if case is path else 0.0
        ins = scan_inputs(torch, dev, b, s, di, n, getattr(torch, xd),
                          getattr(torch, ud), g, shift)
        if case is not path:        # the JAX test's dt: softplus * 0.1
            ins[0] = (ins[0].float() * 0.1).to(ins[0].dtype)
        y, h = ssm.selective_scan(*ins)
        ey, eh = ref.selective_scan_ref(*ins)
        torch.cuda.synchronize()
        if case is path:
            scale = max(ey.abs().max().item(), eh.abs().max().item())
            tol = dict(atol=2e-5 * scale, rtol=2e-5)
        else:
            t = 3e-2 if xd == "bfloat16" or ud == "bfloat16" else 2e-5
            tol = dict(atol=t, rtol=t)
        assert y.dtype == h.dtype == f32
        torch.testing.assert_close(y, ey, **tol)
        torch.testing.assert_close(h, eh, **tol)
        e = max((y - ey).abs().max().item(), (h - eh).abs().max().item())
        log(f"selective_scan {case}: max_abs_err {e:.3e} ({tol})")
        if case is path:
            err = e
        del ins, y, h, ey, eh
    return err


def sm_clock_mhz() -> tuple:
    """The SM clock now and its maximum, MHz (``nvidia-smi``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60)
    now, top = out.stdout.strip().splitlines()[0].split(",")
    return float(now), float(top)


# exponentials a clock an SM on the special-function units, and the SMs
SFU_EX2_PER_CLK, SMS = 16, 132


def time_scan(torch, dev, cfg) -> dict:
    """Phase 9c: the selective scan at jamba's prefill shape, with its
    special-function floor: b s di n exponentials at 16 a clock on each
    of 132 SMs, at the SM clock ``nvidia-smi`` reads after the timing
    (and at the card's maximum clock)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import selective_scan as ssm
    b, s, di, n = scan_path_shape(cfg)
    g = torch.Generator().manual_seed(12)
    ins = scan_inputs(torch, dev, b, s, di, n, torch.float32, torch.float32,
                      g, -4.6)
    (nbytes, ops), _ = scan_bound(b, s, di, n)
    out = time_call(lambda: ssm.selective_scan(*ins),
                    lambda: ref.selective_scan_ref(*ins),
                    None,        # no PyTorch call computes the scan
                    nbytes, ops,
                    # the plain version is a loop of ~4,000 small kernels
                    plain_timing=dict(reps=2, trials=5))
    clock, top = sm_clock_mhz()
    ex2 = b * s * di * n / (SFU_EX2_PER_CLK * SMS)   # clocks
    out.update(sm_clock_mhz=clock, sm_clock_max_mhz=top,
               ex2_floor_ms=ex2 / (clock * 1e6) * 1e3,
               ex2_floor_at_max_clock_ms=ex2 / (top * 1e6) * 1e3)
    log(f"selective_scan at {(b, s, di, n)} f32: {nbytes / 1e6:.1f} MB, "
        f"{ops / 1e9:.2f} GFLOP; bound {out['bound_ms'] * 1e3:.1f} us "
        f"({out['bound_by']}); ex2 floor {out['ex2_floor_ms'] * 1e3:.1f} us "
        f"at {clock:.0f} MHz ({out['ex2_floor_at_max_clock_ms'] * 1e3:.1f} "
        f"at {top:.0f}); {out}")
    return out


def lm_config(layers: int = LM_LAYERS):
    """granite-moe-3b-a800m at full width, cut in depth to ``layers``
    with ``dataclasses.replace`` (as examples/train_lm.py cuts its
    model); every width, the optimizer and the remat policy its own."""
    cfg = dataclasses.replace(moe_config(), n_layers=layers)
    assert (cfg.optimizer, cfg.remat_policy) == ("adamw", "minimal")
    return cfg


def grad_rel_err(got, exp) -> float:
    """max |got - exp| / max |exp| over a tuple of gradients."""
    return max(((a.float() - e.float()).abs().max()
                / e.float().abs().max()).item() for a, e in zip(got, exp))


def attention_grad_case(torch, q, k, v, do, causal: bool, window: int,
                        tol: float, case) -> dict:
    """One case of attention's gradient on the card: the forward with and
    without the log-sum-exp (``o`` the same to the bit), the backward
    kernel's dq, dk, dv twice (the same to the bit) against autograd
    through the plain attention (``ref.attention_vjp_ref``, in f32),
    within ``tol`` of the largest gradient, the log-sum-exp within 1e-5
    of the plain version's (relative, past 1); raises unless all hold.
    Returns the error, the lse's error, the route and the kernel's o,
    lse and gradients."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    o_alone = fa.flash_attention(q, k, v, causal=causal, window=window)
    o, lse = fa.flash_attention(q, k, v, causal=causal, window=window,
                                return_lse=True)
    got = fa.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                 window=window, lse=lse)
    again = fa.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                   window=window, lse=lse)
    _, lse_ref = ref.attention_ref(q, k, v, causal=causal, window=window,
                                   return_lse=True)
    exp = ref.attention_vjp_ref(*(t.float() for t in (q, k, v, do)),
                                causal=causal, window=window)
    torch.cuda.synchronize()
    err = grad_rel_err(got, exp)
    lse_err = ((lse - lse_ref).abs()
               / lse_ref.abs().clamp(min=1)).max().item()
    same_o = torch.equal(o, o_alone)
    same_bwd = all(torch.equal(a, c) for a, c in zip(got, again))
    route = fa.bwd_variant(q, k, v)
    log(f"flash_attention_bwd {case} ({route}): max err / max grad "
        f"{err:.3e} (tol {tol}); lse rel err {lse_err:.3e} (tol 1e-5); "
        f"o the same to the bit without lse {same_o}; two runs the same "
        f"to the bit {same_bwd}")
    if not err <= tol:
        raise AssertionError("attention's backward kernel disagrees "
                             f"with the plain version's VJP at {case}")
    if not (lse_err <= 1e-5 and same_o and same_bwd):
        raise AssertionError(f"attention at {case}: the log-sum-exp, "
                             f"the output or a rerun differs")
    return {"err": err, "lse_err": lse_err, "route": route, "o": o,
            "lse": lse, "got": got}


def check_attention_grads(torch, dev) -> tuple:
    """Phase 10a: the backward kernel's dq, dk, dv, from the forward's
    log-sum-exp, against autograd through the plain attention
    (``attention_grad_case``) at granite's training shapes, each
    within 1e-4 of the largest gradient: causal (the tensor-core route,
    ``mma_3xtf32``, asserted), causal with a window of 128, and head dim
    80; then at the kernel's edges (ATT_GRAD_EDGE_CASES), bf16 within
    2e-2. At each case: the forward's output the same to the bit with and
    without the log-sum-exp, the log-sum-exp within 1e-5 of the plain
    version's (relative, past 1), the route printed, and two runs of the
    backward the same to the bit (at granite's shape also with o and dO
    4 bytes off 16-byte alignment). Returns (the training shapes' errors,
    the route of every case)."""
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator().manual_seed(14)
    errs, routes = {}, {}
    cases = [(b, h, kvh, s, s, dh, True, window, "float32")
             for b, h, kvh, s, dh, window in ATT_GRAD_CASES]
    for i, (b, h, kvh, sq, sk, dh, causal, window, dt) in enumerate(
            cases + ATT_GRAD_EDGE_CASES):
        dtype = getattr(torch, dt)
        q, do = (torch.randn((b, h, sq, dh), generator=g).to(dtype).to(dev)
                 for _ in range(2))
        k, v = (torch.randn((b, kvh, sk, dh), generator=g).to(dtype).to(dev)
                for _ in range(2))
        case = (b, h, kvh, sq, sk, dh, causal, window, dt)
        # bf16: the forward's bf16 tolerance
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
        r = attention_grad_case(torch, q, k, v, do, causal, window, tol,
                                case)
        route = r["route"]
        if i == 0 and route != "mma_3xtf32":
            raise AssertionError(f"granite's training shape took the {route} "
                                 f"route")
        if i == 0:
            # o and dO 4 bytes into their storage: the wrapper copies them
            # to 16-byte aligned memory for the route's staging
            o_off, do_off = (torch.empty(t.numel() + 1, dtype=t.dtype,
                                         device=dev)[1:].view(t.shape)
                             .copy_(t) for t in (r["o"], do))
            shifted = fa.flash_attention_bwd(q, k, v, o_off, do_off,
                                             causal=causal, window=window,
                                             lse=r["lse"])
            if not all(torch.equal(a, c)
                       for a, c in zip(r["got"], shifted)):
                raise AssertionError("the backward differs on misaligned "
                                     "o and dO")
            del o_off, do_off, shifted
        routes[str(case)] = route
        if i < len(cases):
            errs[f"dh{dh}_window{window}"] = r["err"]
        del q, k, v, do, r
    return errs, routes


def gmm_train_shapes(cfg):
    """(name, (e, c, d, f)) of the expert matmuls of a (4, 512) training
    step: gate/up and down at the step's capacity."""
    from repro_torch.models import moe
    c = moe._capacity(LM_BATCH * LM_SEQ, cfg)
    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_expert
    return [("gate_up", (e, c, d, f)), ("down", (e, c, f, d))]


def check_gmm_grads(torch, dev, cfg) -> float:
    """Phase 10a: dx and dw through the grouped matmul's ``Function`` (the
    kernel twice) against autograd through ``gmm_ref``, within the
    forward's 2e-4, at a training step's two shapes."""
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(15)
    worst = 0.0
    for name, (e, c, d, f) in gmm_train_shapes(cfg):
        x = torch.randn((e, c, d), generator=g).to(dev).requires_grad_()
        w = (torch.randn((e, d, f), generator=g) * d ** -0.5).to(
            dev).requires_grad_()
        dy = torch.randn((e, c, f), generator=g).to(dev)
        got = torch.autograd.grad(gmm.MoeGmm.apply(x, w), (x, w), dy)
        xr, wr = (t.detach().requires_grad_() for t in (x, w))
        exp = torch.autograd.grad(ref.gmm_ref(xr, wr), (xr, wr), dy)
        torch.cuda.synchronize()
        for what, a, b in zip(("dx", "dw"), got, exp):
            torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-4)
            err = (a - b).abs().max().item()
            worst = max(worst, err)
            log(f"moe_gmm {name} {(e, c, d, f)} {what} {tuple(a.shape)}: "
                f"max_abs_err {err:.3e} (atol = rtol = 2e-4)")
        del x, w, dy, got, exp
    return worst


class Routing:
    """Holds the plain-version step to the kernel step's routing: the
    router's top-k picks (``moe._top_k``) are recorded in the kernel
    step and replayed, call for call (the forward's, then the remat
    recomputation's), in the plain one. A top-k is not continuous: two
    runs whose router inputs differ in the last bits can pick another
    expert for a token whose k-th and (k+1)-th probabilities tie that
    closely, and compare two models. ``flips`` counts the tokens whose
    own top-k in the plain step differs from the replayed one."""

    def __init__(self, torch):
        from repro_torch.models import moe
        self.torch, self.moe, self.orig = torch, moe, moe._top_k
        self.picks, self.flips = [], 0

    def _patched(self, fn):
        import contextlib

        @contextlib.contextmanager
        def ctx():
            self.moe._top_k = fn
            try:
                yield
            finally:
                self.moe._top_k = self.orig
        return ctx()

    def record(self):
        def rec(probs, k):
            vals, sel = self.orig(probs, k)
            self.picks.append(sel)
            return vals, sel
        return self._patched(rec)

    def replay(self):
        """The recorded picks, call for call; a sharded step's router
        runs once a row (a batch position) where the recorded step ran
        once a layer, so each call takes the recorded picks' next tokens
        in order, as many as its rows hold (all of a recorded call's in
        an unsharded step)."""
        flat = [p.reshape(-1, p.shape[-1]) for p in self.picks]
        at = {"call": 0, "token": 0}

        def rep(probs, k):
            n = probs[..., 0].numel()
            src = flat[at["call"]]
            sel = src[at["token"]:at["token"] + n].to(probs.device)
            sel = sel.reshape(probs.shape[:-1] + (k,))
            at["token"] += n
            if at["token"] == src.shape[0]:
                at["call"], at["token"] = at["call"] + 1, 0
            own = self.orig(probs, k)[1]
            self.flips += int((own.sort(-1).values != sel.sort(-1).values
                               ).any(-1).sum())
            return probs.gather(-1, sel), sel
        return self._patched(rep)


# the zoo's kernels a model calls through ``ops``, and each one's
# backward kernel
ZOO_OPS = ("flash_attention", "moe_gmm", "rwkv6_wkv", "selective_scan")
MIXER_KERNELS = {"attn": ("flash_attention", "flash_attention_bwd"),
                 "rwkv": ("rwkv6_wkv", "rwkv6_wkv_bwd"),
                 "mamba": ("selective_scan", "selective_scan_bwd")}


def plain_versions():
    """The model's attention, expert matmuls, WKV and scan through
    ``ops``' ``kernel="ref"``: the plain versions on the card."""
    import contextlib
    import functools
    from repro_torch.kernels import ops

    @contextlib.contextmanager
    def ctx():
        orig = {name: getattr(ops, name) for name in ZOO_OPS}
        for name, fn in orig.items():
            setattr(ops, name, functools.partial(fn, kernel="ref"))
        try:
            yield
        finally:
            for name, fn in orig.items():
                setattr(ops, name, fn)
    return ctx()


def vision_prefix(cfg) -> int:
    """The patch embeddings in front of each row: internvl2's 256, 0 for
    a model without a vision prefix."""
    from repro_torch.models import transformer as T
    return cfg.frontend.num_tokens if T.has_vision_prefix(cfg) else 0


def train_text_shape(cfg) -> tuple:
    """(batch, text tokens a row) of a training step: (4, 448) for
    whisper (its published decoder context), (4, 512) behind internvl2's
    patches, and (LM_BATCH, LM_SEQ) for a decoder-only model."""
    if cfg.encoder is not None:
        return WHISPER_BATCH, WHISPER_TOKENS
    if vision_prefix(cfg):
        return SCORE_BATCH, INTERNVL_TEXT
    return LM_BATCH, LM_SEQ


def train_batches(cfg, steps: int, seed: int):
    """``steps`` numpy batches of ``make_lm_batches`` at the model's
    ``train_text_shape``; whisper's carry frames (b, 1500, d) and
    internvl2's patches (b, 256, d), the stubs' inputs, drawn normal x
    0.02 from a numpy generator of the same seed (as
    tests/test_archs_smoke.py draws them)."""
    import numpy as np
    from repro_torch.data.synthetic import make_lm_batches
    b, s = train_text_shape(cfg)
    stub = ({"frames": cfg.encoder.n_frames} if cfg.encoder is not None
            else {"patches": vision_prefix(cfg)} if vision_prefix(cfg)
            else {})
    rng = np.random.default_rng(seed)
    for batch in make_lm_batches(cfg.vocab, b, s, steps, seed=seed):
        for key, n in stub.items():
            batch[key] = (rng.standard_normal((b, n, cfg.d_model),
                                              dtype=np.float32) * 0.02)
        yield batch


def lm_batch(torch, dev, cfg, seed: int):
    batch = next(train_batches(cfg, 1, seed))
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def lm_launches_per_step(cfg) -> dict:
    """Each kernel's launches in one training step under remat
    "minimal": every repeated layer's mixer kernel twice (the forward and
    its recomputation in the backward) and its backward kernel once; an
    MoE layer's three grouped matmuls twice and two for each in the
    backward (a prefix layer, which no remat wraps, runs its forward
    kernels once). An encoder-decoder model adds its encoder layers'
    attention once and its backward once (``encode`` wraps none), and
    each decoder layer's cross-attention as many times as the layer's
    mixer and its backward once."""
    assert cfg.remat_policy == "minimal"
    out = {name: 0 for name in all_counters()}
    layers = [(m, f, 1) for m, f in cfg.prefix_pattern] + \
        [(m, f, 2) for m, f in cfg.block_pattern * cfg.n_repeats]
    enc = 0 if cfg.encoder is None else cfg.encoder.n_layers
    for mixer, ffn, runs in layers + [("attn", "mlp", 1)] * enc:
        fwd, bwd = MIXER_KERNELS[mixer]
        out[fwd] += runs
        out[bwd] += 1
        if ffn == "moe":
            out["moe_gmm"] += 3 * runs + 2 * 3
    if cfg.encoder is not None:
        for _, _, runs in layers:
            out["flash_attention"] += runs
            out["flash_attention_bwd"] += 1
    return out


def lm_kernel_vs_plain(torch, dev, cfg, card: str,
                       grad_tol: float = 1e-3) -> dict:
    """Phase 10c: one step's loss and gradients (``steps.loss_and_grads``)
    with the kernels and with the plain versions, at the same params and
    batch, the routing held alike (``Routing``): losses within rtol
    1e-5, every gradient present and within ``grad_tol`` of its leaf's
    largest. The kernel step's launches are counted. Its gradients wait
    on the host while the plain step runs (three copies of a 20 GB
    model's params do not fit beside the plain recurrences' autograd
    history)."""
    from repro_torch.launch import steps as ST
    from repro_torch.models import params as PRM
    from repro_torch.models import transformer as T
    # drawn outside inference mode (draw_params'), whose tensors autograd
    # may not track; the trainer draws the same way
    with torch.no_grad():
        params = PRM.init_tree(T.model_spec(cfg),
                               torch.Generator(dev).manual_seed(0),
                               torch.float32, dev)
    batch = lm_batch(torch, dev, cfg, seed=0)
    counters = all_counters()
    routing = Routing(torch)
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    with routing.record():
        loss_k, _, g_k = ST.loss_and_grads(cfg, params, batch,
                                           torch.float32)
    torch.cuda.synchronize()
    t_kernel = time.perf_counter() - t0
    launches = {name: c.count for name, c in counters.items()}
    if launches != lm_launches_per_step(cfg):
        raise AssertionError(f"the kernel step launched {launches}, "
                             f"expected {lm_launches_per_step(cfg)}")
    g_k = PRM.tree_map(lambda t: None if t is None else t.cpu(), g_k)
    # the forward's share, under no_grad (no remat, no backward); the
    # step's mixer launches beyond it are the remat recomputation's
    for c in counters.values():
        c.reset()
    with torch.no_grad():
        T.loss_fn(cfg, params, batch, torch.float32)
    forward = {name: c.count for name, c in counters.items()}
    mixers = [fwd for fwd, _ in MIXER_KERNELS.values()]
    split = {"forward": forward,
             "recompute": {k: launches[k] - forward[k] for k in mixers}
             | {"moe_gmm": forward["moe_gmm"]},
             "backward": {bwd: launches[bwd]
                          for _, bwd in MIXER_KERNELS.values()}
             | {"moe_gmm": launches["moe_gmm"] - 2 * forward["moe_gmm"]}}
    t0 = time.perf_counter()
    with plain_versions(), routing.replay():
        loss_p, _, g_p = ST.loss_and_grads(cfg, params, batch,
                                           torch.float32)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    worst, worst_leaf, missing = 0.0, None, []
    for (path, a), (_, b) in zip(PRM.tree_items(g_k), PRM.tree_items(g_p)):
        if a is None or b is None:
            missing.append("/".join(path))
            continue
        err = grad_rel_err((a.to(dev),), (b,))
        if err > worst:
            worst, worst_leaf = err, "/".join(path)
    loss_err = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    out = {"loss_kernel": loss_k.item(), "loss_plain": loss_p.item(),
           "loss_rel_err": loss_err, "grad_rel_err": worst,
           "grad_rel_err_leaf": worst_leaf,
           "n_grads": len(PRM.tree_items(g_k)),
           "routing_flips_replayed": routing.flips,
           "kernel_step_s": t_kernel, "plain_step_s": t_plain,
           "launches": launches, "launches_split": split}
    enc = f" + {cfg.encoder.n_layers} encoder" if cfg.encoder else ""
    log(f"{cfg.arch_id} {cfg.n_layers}{enc} layers, kernel vs plain step "
        f"({card}): " + json.dumps(out))
    if missing:
        raise AssertionError(f"gradients missing: {missing}")
    if not loss_err <= 1e-5 or not worst <= grad_tol:
        raise AssertionError("the kernel step's loss or gradients "
                             "disagree with the plain versions'")
    del params, g_k, g_p
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lm_train(torch, dev, cfg, card: str, tag: str = "granite",
             lr: float = LM_LR) -> dict:
    """Phase 10d: ``train()`` at ``lr`` from drawn params, 2 warm-up and
    8 timed steps of ``train_batches``: step time (from the
    trainer's history, whose float() of the metrics waits for the card
    each step), text tokens/s (and frames/s or patches/s beside them),
    peak device memory, launches a step, the loss finite and lower after
    the steps; then one more step of ``make_train_step`` under
    ``torch.profiler`` for the busy share and where the device time goes,
    and the model-FLOPs utilisation (``flops.model_flops`` over every
    position the decoder runs: internvl2's patches too) against the f32
    FMA peak, with the analytic count's (``flops.train_flops``, which
    counts whisper's encoder over its frames) beside it."""
    import math
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import flops as F
    from repro_torch.launch import steps as ST
    from repro_torch.train import optimizer as O
    from repro_torch.train.trainer import TrainJob, train
    steps = LM_WARMUP + LM_TIMED
    counters = all_counters()
    for c in counters.values():
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    job = TrainJob(cfg=cfg, lr=lr, steps=steps, log_every=1, device=dev)
    t0 = time.perf_counter()
    res = train(job, train_batches(cfg, steps, seed=0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {name: c.count for name, c in counters.items()}
    per_step = lm_launches_per_step(cfg)
    if launches != {k: n * steps for k, n in per_step.items()}:
        raise AssertionError(f"train() launched {launches} in {steps} "
                             f"steps, expected {per_step} a step")
    hist = res["history"]
    t = [r["t"] for r in hist]
    timed = [t[i] - t[i - 1] for i in range(LM_WARMUP, steps)]
    step_s = statistics.median(timed)
    losses = [r["loss"] for r in hist]
    if not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"training losses {losses}")
    b, s = train_text_shape(cfg)
    prefix = vision_prefix(cfg)
    shape = InputShape("lm_train", s + prefix, b, "train")
    model_flops = F.model_flops(cfg, shape)
    train_flops = F.train_flops(cfg, shape)
    out = {"layers": cfg.n_layers, "steps": steps, "lr": lr,
           "wall_s": wall,
           "step_ms": step_s * 1e3, "step_ms_timed": [x * 1e3 for x in timed],
           "tokens_per_s": b * s / step_s, "peak_gb": peak / 1e9,
           "loss_first": losses[0], "loss_last": losses[-1],
           "losses": losses, "launches_per_step": per_step,
           "model_flops": model_flops,
           "train_flops_analytic": train_flops,
           "mfu_f32": model_flops / step_s / F32_FLOP_S,
           "mfu_f32_analytic": train_flops / step_s / F32_FLOP_S}
    if cfg.encoder is not None:
        out["encoder_layers"] = cfg.encoder.n_layers
        out["frames_per_s"] = b * cfg.encoder.n_frames / step_s
    if prefix:
        out["patches_per_s"] = b * prefix / step_s
    rates = ", ".join(f"{out[k]:.1f} {k[:-6]}/s" for k in (
        "tokens_per_s", "frames_per_s", "patches_per_s") if k in out)
    log(f"{cfg.arch_id} train(): {cfg.n_layers} layers"
        + (f" (+ {cfg.encoder.n_layers} encoder)" if cfg.encoder else "")
        + f", {steps} steps of ({b}, {s}): step {out['step_ms']:.1f} ms "
        f"(median of {len(timed)}), {rates}, peak "
        f"{out['peak_gb']:.2f} GB, loss {losses[0]:.4f} -> {losses[-1]:.4f}"
        f", model FLOPs {model_flops / 1e12:.2f} T a step, utilisation "
        f"{out['mfu_f32']:.4f} of 67 TFLOP/s (f32, TF32 off; "
        f"{out['mfu_f32_analytic']:.4f} by the analytic count); launches a "
        f"step {per_step}; {card}")
    # a profiled step: the trainer's params and a fresh optimizer state
    params = res["params"]
    del res
    gc.collect()
    opt = O.make_optimizer(cfg.optimizer)
    state = opt.init(params)
    step = ST.make_train_step(cfg, opt, lr=lr,
                              compute_dtype=torch.float32)
    batch = lm_batch(torch, dev, cfg, seed=1)
    step(params, state, batch)          # the fresh state's first step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(params, state, batch)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    # busy: the profiled step's device time over the wall time of the
    # same step unprofiled just before
    prof = profile_window(torch, lambda: step(params, state, batch), wall_s)
    out["busy_share"] = prof["device_busy_share"]
    out["profiled_step_unprofiled_ms"] = wall_s * 1e3
    log(f"{tag} train profile ({card}) " + json.dumps(prof))
    del params, state, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lm_checkpoint(torch, dev, card: str) -> dict:
    """Phase 10e: the checkpoint round trip of examples/train_lm.py on
    the card, at full width and LM_CKPT_LAYERS layers: ``train()`` with
    a ``ckpt_dir`` for 2 steps, ``restore`` of its latest step, the loss
    of a fresh batch on the trained and the restored params within
    1e-5."""
    import shutil
    from repro_torch.data.synthetic import make_lm_batches
    from repro_torch.models import transformer as T
    from repro_torch.models import params as PRM
    from repro_torch.train import checkpoint as CKPT
    from repro_torch.train.trainer import TrainJob, train
    cfg = lm_config(LM_CKPT_LAYERS)
    ckpt = ROOT / "build" / "lm_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()
    res = train(TrainJob(cfg=cfg, lr=LM_LR, steps=2, log_every=1,
                         ckpt_dir=str(ckpt), device=dev),
                make_lm_batches(cfg.vocab, LM_BATCH, LM_SEQ, 3, seed=2))
    step = CKPT.latest_step(str(ckpt))
    restored, _ = CKPT.restore(str(ckpt), step, res["params"])
    batch = lm_batch(torch, dev, cfg, seed=123)
    with torch.no_grad():
        l1, _ = T.loss_fn(cfg, res["params"], batch, torch.float32)
        l2, _ = T.loss_fn(cfg, restored, batch, torch.float32)
    same = all(torch.equal(a, b) for a, b in zip(
        PRM.tree_leaves(res["params"]), PRM.tree_leaves(restored)))
    size = sum(f.stat().st_size for f in ckpt.iterdir())
    out = {"layers": cfg.n_layers, "step": step, "loss": l1.item(),
           "loss_restored": l2.item(), "params_equal": same,
           "bytes": size, "seconds": time.perf_counter() - t0}
    log(f"checkpoint round trip ({cfg.arch_id}, {cfg.n_layers} layers at "
        f"full width; {card}): " + json.dumps(out))
    shutil.rmtree(ckpt, ignore_errors=True)
    if not abs(l1.item() - l2.item()) < 1e-5 or not same:
        raise AssertionError("the restored params give another loss")
    del res, restored
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_lm_example(torch, dev, card: str) -> dict:
    """Phase 10e': ``python -m repro_torch.examples.train_lm`` on the
    card for TRAIN_LM_STEPS steps (its small qwen3, output under
    ``build/train_lm_smoke``, deleted after): the example's own gates (a
    falling loss, the checkpoint's resume check) and exact launches: 8
    attention layers, remat "none", so 8 forward and 8 backward kernel
    launches a step, and 8 forward for each of the resume check's two
    losses."""
    import shutil
    from repro_torch.examples import train_lm
    out_dir = ROOT / "build" / "train_lm_smoke"
    counters = all_counters()
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    out = train_lm.main(["--steps", str(TRAIN_LM_STEPS), "--device",
                         str(dev), "--out", str(out_dir)])
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    got = {name: c.count for name, c in counters.items()}
    layers = train_lm.small_qwen().n_layers
    expected = {name: 0 for name in counters}
    expected["flash_attention"] = layers * (TRAIN_LM_STEPS + 2)
    expected["flash_attention_bwd"] = layers * TRAIN_LM_STEPS
    out["launches"] = got
    log(f"examples.train_lm, {TRAIN_LM_STEPS} steps ({card}): "
        + json.dumps(out))
    shutil.rmtree(out_dir, ignore_errors=True)
    if got != expected:
        raise AssertionError(f"train_lm launched {got}, expected "
                             f"{expected}")
    return out


def time_lm_kernels(torch, dev, cfg, card: str) -> tuple:
    """Phase 10f: the backward kernel at granite's training shape (causal;
    the tensor-core route) beside autograd through the plain attention,
    SDPA's backward alone and SDPA's forward and backward, and the f32-FMA
    route it replaced there (the C entry point
    ``repro_flash_attention_bwd``, which still takes every shape), in
    turns, with each of its kernels' device time; the forward with and
    without the log-sum-exp, in turns; the grouped matmul at the four shapes of a training step's
    dx and dw beside ``gmm_ref`` and ``torch.bmm``."""
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(17)
    b, h, kvh, s, dh, _ = ATT_GRAD_CASES[0]
    q, do = (torch.randn((b, h, s, dh), generator=g).to(dev)
             for _ in range(2))
    k, v = (torch.randn((b, kvh, s, dh), generator=g).to(dev)
            for _ in range(2))
    o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    stats = torch.empty(3 * b * h * s, dtype=torch.float32, device=dev)
    lib = _build.library()

    # (the plain VJP runs autograd's engine, which is timed eagerly, not
    # captured in a graph)
    def kernel():
        return fa.flash_attention_bwd(q, k, v, o, do, causal=True, lse=lse)

    def fma_route():
        err = lib.repro_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            stats.data_ptr(), b, h, kvh, s, s, dh, 0, 1, 0, dh ** -0.5,
            torch.cuda.current_stream().cuda_stream)
        _build.check(err, "flash_attention_bwd (f32 FMAs)")
    def forward(lse: bool):
        return lambda: fa.flash_attention(q, k, v, causal=True,
                                          return_lse=lse)
    turns = [graph_ms(fn, reps=20, trials=10)
             for fn in (fma_route, kernel, kernel, fma_route)]
    fwd = [graph_ms(forward(lse), reps=20, trials=10)
           for lse in (False, True, True, False)]
    att = {"variant": fa.bwd_variant(q, k, v), "ms": min(turns[1:3]),
           "fma_route_ms": min(turns[0], turns[3]), "turns_ms": turns,
           # the forward without and with the log-sum-exp, in turns
           "forward_ms": min(fwd[0], fwd[3]),
           "forward_lse_ms": min(fwd[1:3]), "forward_turns_ms": fwd,
           "kernels_ms": kernel_times(torch, kernel),
           "eager_ms": eager_ms(kernel, reps=20, trials=10),
           "plain_ms": eager_ms(
               lambda: ref.attention_vjp_ref(q, k, v, do, causal=True),
               reps=5, trials=5),
           **sdpa_backward_ms(torch, q, k, v, do, True, 20, 5),
           **attention_bwd_bound(q, k, True)}
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                             enable_gqa=True)
        return torch.autograd.grad(out, (qs, ks, vs), do)
    att["sdpa_fwd_bwd_ms"] = eager_ms(sdpa_fwd_bwd, reps=20, trials=5)
    log(f"flash_attention_bwd granite training q {tuple(q.shape)} k/v "
        f"{tuple(k.shape)} causal f32 ({card}): {att}")
    del q, k, v, o, lse, do, qs, ks, vs, dq, dk, dv, stats
    gmm_t = {}
    for name, (e, c, d, f) in gmm_train_shapes(cfg):
        x = torch.randn((e, c, d), generator=g).to(dev)
        w = (torch.randn((e, d, f), generator=g) * d ** -0.5).to(dev)
        dy = torch.randn((e, c, f), generator=g).to(dev)
        wt, xt = w.transpose(1, 2).contiguous(), x.transpose(1, 2).contiguous()
        for part, (a, bm) in (("dx", (dy, wt)), ("dw", (xt, dy))):
            ee, cc, dd = a.shape
            ff = bm.shape[2]
            t = time_call(lambda: gmm.moe_gmm(a, bm),
                          lambda: ref.gmm_ref(a, bm),
                          lambda: torch.bmm(a, bm),
                          (a.numel() + bm.numel() + ee * cc * ff) * 4,
                          2.0 * ee * cc * dd * ff, dict(reps=20, trials=10),
                          rate=product_rate(a.dtype))
            t["variant"] = gmm.variant(a, bm)
            t["shape"] = [list(a.shape), list(bm.shape)]
            gmm_t[f"{name}_{part}"] = t
            log(f"moe_gmm backward {name} {part} {tuple(a.shape)} @ "
                f"{tuple(bm.shape)} f32 ({card}): {t}")
        del x, w, dy, wt, xt
    gc.collect()
    torch.cuda.empty_cache()
    return att, gmm_t


def lm_train_phase(torch, dev) -> tuple:
    """Phase 10: language-model training on the card (granite at full
    width, LM_LAYERS layers). Returns (the launches of the counted
    runs, the measured numbers)."""
    t_phase = time.perf_counter()
    card = gpu_line()
    cfg = lm_config()
    full = moe_config()
    log(f"{LM_ARCH} training: depth {cfg.n_layers} of {full.n_layers} "
        f"layers; every width as published; AdamW, remat "
        f"{cfg.remat_policy!r}, f32, ({LM_BATCH}, {LM_SEQ}) batches")
    att_errs, att_routes = check_attention_grads(torch, dev)
    gmm_err = check_gmm_grads(torch, dev, cfg)
    versus = lm_kernel_vs_plain(torch, dev, cfg, card)
    trained = lm_train(torch, dev, cfg, card)
    ckpt = lm_checkpoint(torch, dev, card)
    example = train_lm_example(torch, dev, card)
    att_t, gmm_t = time_lm_kernels(torch, dev, cfg, card)
    out = {"attention_grad_errs": att_errs,
           "attention_grad_routes": att_routes, "gmm_grad_err": gmm_err,
           "kernel_vs_plain": versus, "train": trained, "checkpoint": ckpt,
           "train_lm_example": example,
           "attention_bwd": att_t, "gmm_bwd": gmm_t,
           "seconds": time.perf_counter() - t_phase}
    log(f"{LM_ARCH} training phase: {out['seconds']:.1f} s; {card}")
    steps = LM_WARMUP + LM_TIMED
    launches = {"lm_train": {k: n * steps for k, n in
                             trained["launches_per_step"].items()}}
    return launches, out


def check_recurrence_grads(torch, dev) -> dict:
    """Phase 10g: the WKV and scan backward kernels, through their
    ``autograd.Function``s (``rwkv6_wkv`` / ``selective_scan`` on CUDA
    inputs that require grad), against autograd through the plain
    versions in float64 on the same inputs, with nonzero cotangents of
    both y and the final state: at rwkv6-7b's (4, 64, 511, 64) and
    jamba's dt/u (4, 512, 16384), B/C (4, 512, 16), A (16384, 16), every
    gradient within 1e-4 of its largest magnitude; then at the edges
    (WKV_GRAD_CASES, SCAN_GRAD_CASES: ragged lengths and widths, masked
    head and state dims, bf16 within 1e-2, the gradients' own rounding).
    The forward under grad, which also writes the checkpoints, must
    give the no-grad forward's outputs bit for bit, each call must
    launch its forward and its backward kernel once, and a second
    backward through the same graph must give the first one's gradients
    to the bit (no float atomics). Returns the path shapes' errors."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_wkv as wkv
    from repro_torch.kernels import selective_scan as ssm
    g = torch.Generator().manual_seed(18)
    out = {}

    def run(name, fn, ins, cots, plain, names, case, path):
        mod = wkv if name == "rwkv6_wkv" else ssm
        leaves = [t.clone().requires_grad_() for t in ins]
        mod.launches.reset()
        mod.bwd_launches.reset()
        outs = fn(*leaves)
        got = torch.autograd.grad(outs, leaves, cots, retain_graph=True)
        if (mod.launches.count, mod.bwd_launches.count) != (1, 1):
            raise AssertionError(f"{name}: {mod.launches.count} forward "
                                 f"and {mod.bwd_launches.count} backward "
                                 f"launches, expected 1 and 1")
        again = torch.autograd.grad(outs, leaves, cots)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{name}: two backward runs differ")
        del again
        with torch.no_grad():
            plain_outs = fn(*ins)
        if not all(torch.equal(a.detach(), b)
                   for a, b in zip(outs, plain_outs)):
            raise AssertionError(f"{name}: the forward under grad differs "
                                 f"from the forward without it")
        exp = plain(*(t.double() for t in ins), *(c.double() for c in cots))
        torch.cuda.synchronize()
        errs = {n: grad_rel_err((a,), (e,))
                for n, a, e in zip(names, got, exp)}
        abs_err = max((a.double() - e).abs().max().item()
                      for a, e in zip(got, exp))
        tol = 1e-2 if ins[0].dtype == torch.bfloat16 else 1e-4
        log(f"{name} backward {case}: max err / max grad {errs}, "
            f"max_abs_err {abs_err:.3e} (tol {tol} of the largest); two "
            f"runs the same to the bit")
        if not max(errs.values()) <= tol:
            raise AssertionError(f"{name}'s backward kernel disagrees with "
                                 f"the plain version's VJP at {case}")
        if path:
            out[name] = {"grad_rel_errs": errs, "max_abs_err": abs_err}
        del leaves, outs, got, exp, plain_outs

    for i, case in enumerate(WKV_GRAD_CASES):
        b, h, s, dh, dt = case
        ins = wkv_inputs(torch, dev, b, h, s, dh, getattr(torch, dt), g)
        cots = [torch.randn((b, h, s, dh), generator=g).to(dev),
                torch.randn((b, h, dh, dh), generator=g).to(dev)]
        run("rwkv6_wkv", wkv.rwkv6_wkv, ins, cots, ref.rwkv6_vjp_ref,
            ("dr", "dk", "dv", "dw", "du"), case, i == 0)
        del ins, cots
    for i, case in enumerate(SCAN_GRAD_CASES):
        b, s, di, n, xd, ud = case
        # the path's dt: softplus around the model's b_dt of -4.6
        ins = scan_inputs(torch, dev, b, s, di, n, getattr(torch, xd),
                          getattr(torch, ud), g, -4.6 if i == 0 else 0.0)
        cots = [torch.randn((b, s, di), generator=g).to(dev),
                torch.randn((b, di, n), generator=g).to(dev)]
        run("selective_scan", ssm.selective_scan, ins, cots,
            ref.selective_scan_vjp_ref, ("ddt", "dB", "dC", "du", "dA"),
            case, i == 0)
        del ins, cots
    gc.collect()
    torch.cuda.empty_cache()
    return out


def time_recurrence_bwd(torch, dev) -> dict:
    """Phase 10h: each backward kernel at its path shape (rwkv6-7b's
    (4, 64, 511, 64); jamba's (4, 512, 16384, 16)) from the forward's
    checkpoints, beside its plain version (autograd through the plain
    recurrence in f32, timed eagerly: the engine runs on the host) and
    its bound: the function's inputs read once and its gradients written
    once, or its operations at the f32 FMA rate (WKV: 12 dh^2 a (pair,
    step), the recomputed update and five products with a vector; the
    scan: 20 a state element and step). Beside the bound, the design's
    own byte floor: the function's bytes plus the checkpoints it reads
    and its per-block partials written and read again by the second
    pass. The forward is timed with and without the checkpoints it
    writes under grad. No PyTorch call computes either gradient:
    library_ms is None."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_wkv as wkv
    from repro_torch.kernels import selective_scan as ssm
    g = torch.Generator().manual_seed(20)
    out = {}

    def forward_ms(fwd, ins, chk_bytes) -> dict:
        with_ck = graph_ms(lambda: fwd(*ins, checkpoints=True), reps=20,
                           trials=10)
        return {"forward_ms": graph_ms(lambda: fwd(*ins), reps=20,
                                       trials=10),
                "forward_with_checkpoints_ms": with_ck,
                "checkpoint_mb": chk_bytes / 1e6,
                "checkpoint_write_floor_ms": chk_bytes / HBM_BYTES_S * 1e3}

    def design_floor(nbytes, extra) -> dict:
        return {"design_bytes_mb": (nbytes + extra) / 1e6,
                "design_floor_ms": (nbytes + extra) / HBM_BYTES_S * 1e3}

    b, h, s, dh, _ = WKV_GRAD_CASES[0]
    ins = wkv_inputs(torch, dev, b, h, s, dh, torch.float32, g)
    dy = torch.randn((b, h, s, dh), generator=g).to(dev)
    ds = torch.randn((b, h, dh, dh), generator=g).to(dev)
    _, _, chk = wkv.wkv_forward(*ins, checkpoints=True)

    def wkv_kernel():
        return wkv.rwkv6_wkv_bwd(*ins, chk, dy, ds)
    _, (nbytes, ops) = wkv_bound(b, h, s, dh)
    chk_bytes = chk.numel() * 4
    t = {"ms": graph_ms(wkv_kernel, reps=20, trials=10),
         "eager_ms": eager_ms(wkv_kernel, reps=20, trials=10),
         "plain_ms": eager_ms(lambda: ref.rwkv6_vjp_ref(*ins, dy, ds),
                              reps=2, trials=3),
         "library_ms": None, "shape": [b, h, s, dh],
         **_bound(nbytes, ops),
         # the checkpoints read; du's per-pair partials written and read
         **design_floor(nbytes, chk_bytes + 2 * b * h * dh * 4),
         **forward_ms(wkv.wkv_forward, ins, chk_bytes)}
    log(f"rwkv6_wkv_bwd at {(b, h, s, dh)} f32: {nbytes / 1e6:.1f} MB "
        f"(bound {t['bound_ms']:.4f} ms), with the checkpoints and "
        f"partials {t['design_bytes_mb']:.1f} MB (the design's floor "
        f"{t['design_floor_ms']:.4f} ms); {t}")
    out["rwkv6_wkv_bwd"] = t
    del ins, dy, ds, chk
    b, s, di, n, _, _ = SCAN_GRAD_CASES[0]
    ins = scan_inputs(torch, dev, b, s, di, n, torch.float32, torch.float32,
                      g, -4.6)
    dy = torch.randn((b, s, di), generator=g).to(dev)
    dh_ = torch.randn((b, di, n), generator=g).to(dev)
    _, _, chk = ssm.scan_forward(*ins, checkpoints=True)

    def scan_kernel():
        return ssm.selective_scan_bwd(*ins, chk, dy, dh_)
    _, (nbytes, ops) = scan_bound(b, s, di, n)
    chk_bytes = chk.numel() * 4
    # dB / dC per 128-channel block, dA per batch row: written, read back
    parts = (-(-di // ssm.BLOCK) * 2 * b * s * n + b * di * n) * 4 * 2
    t = {"ms": graph_ms(scan_kernel, reps=20, trials=10),
         "eager_ms": eager_ms(scan_kernel, reps=20, trials=10),
         "plain_ms": eager_ms(
             lambda: ref.selective_scan_vjp_ref(*ins, dy, dh_),
             reps=2, trials=3),
         "library_ms": None, "shape": [b, s, di, n],
         **_bound(nbytes, ops),
         **design_floor(nbytes, chk_bytes + parts),
         **forward_ms(ssm.scan_forward, ins, chk_bytes)}
    clock, top = sm_clock_mhz()
    # the kernel's exponentials: the walked decay every step, the
    # recomputed one at 3 steps of 4 (4 in the sequence's last group)
    groups = -(-s // ssm.CHECKPOINT)
    per_state = s + 3 * (groups - 1) + (s - (groups - 1) * ssm.CHECKPOINT)
    ex2 = per_state * b * di * n / (SFU_EX2_PER_CLK * SMS)
    t.update(sm_clock_mhz=clock, ex2_floor_ms=ex2 / (clock * 1e6) * 1e3)
    log(f"selective_scan_bwd at {(b, s, di, n)} f32: {nbytes / 1e6:.1f} MB "
        f"(bound {t['bound_ms']:.4f} ms), with the checkpoints and "
        f"partials {t['design_bytes_mb']:.1f} MB (the design's floor "
        f"{t['design_floor_ms']:.4f} ms); {t}")
    out["selective_scan_bwd"] = t
    del ins, dy, dh_, chk
    gc.collect()
    torch.cuda.empty_cache()
    return out


def rwkv_train_config():
    """rwkv6-7b at full width, cut in depth 32 -> RWKV_TRAIN_LAYERS; its
    AdamW and remat policy."""
    cfg = dataclasses.replace(zoo_config(), n_layers=RWKV_TRAIN_LAYERS)
    assert (cfg.optimizer, cfg.remat_policy) == ("adamw", "minimal")
    return cfg


def jamba_train_config():
    """The first two layers of jamba's period at full width, mamba + mlp
    then mamba + MoE, experts 16 -> 4 (as ``jamba_config`` cuts them);
    its adafactor and remat policy."""
    period = jamba_config()
    cfg = dataclasses.replace(period, n_layers=2,
                              block_pattern=period.block_pattern[:2])
    assert cfg.block_pattern == (("mamba", "mlp"), ("mamba", "moe")) and \
        (cfg.optimizer, cfg.remat_policy) == ("adafactor", "minimal")
    return cfg


def recurrence_train_phase(torch, dev) -> tuple:
    """Phase 10g-10j: the recurrences' backward kernels against the
    plain versions and their times, then rwkv6-7b (RWKV_TRAIN_LAYERS
    layers, AdamW) and the jamba cut (two layers, adafactor) trained at
    full width in f32 on (4, 512) batches as phase 10 trains granite:
    one step's loss and gradients with the kernels against the plain
    versions' (loss within rtol 1e-5, every gradient within 1e-4 of its
    leaf's largest), ``train()`` for 2 warm-up and 8 timed steps with a
    falling loss, launches a step exact, a profiled step. Returns (the
    launches of the counted runs, the measured numbers)."""
    t_phase = time.perf_counter()
    card = gpu_line()
    out = {"grad": check_recurrence_grads(torch, dev),
           "times": time_recurrence_bwd(torch, dev)}
    launches = {}
    steps = LM_WARMUP + LM_TIMED
    for tag, cfg in (("rwkv6", rwkv_train_config()),
                     ("jamba", jamba_train_config())):
        t0 = time.perf_counter()
        log(f"{cfg.arch_id} training: {cfg.n_layers} layers "
            f"{[m + '+' + f for m, f in cfg.block_pattern]} x "
            f"{cfg.n_repeats}, every width as published; "
            f"{cfg.optimizer}, remat {cfg.remat_policy!r}, f32, "
            f"({LM_BATCH}, {LM_SEQ}) batches")
        versus = lm_kernel_vs_plain(torch, dev, cfg, card, grad_tol=1e-4)
        trained = lm_train(torch, dev, cfg, card, tag)
        out[tag] = {"kernel_vs_plain": versus, "train": trained,
                    "seconds": time.perf_counter() - t0}
        launches[f"{tag}_train"] = {k: n * steps for k, n in
                                    trained["launches_per_step"].items()}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"recurrence training phase: {out['seconds']:.1f} s; {card}")
    return launches, out


def enc_vlm_attention_shapes() -> dict:
    """name -> (q shape, k/v shape, causal) of attention in whisper's and
    internvl2's training steps: the encoder's bidirectional
    self-attention over 1,500 frames, the decoder's causal self-attention
    and its cross-attention (448 queries, 1,500 keys) at (4, 448) tokens,
    and internvl2's causal GQA (8 query heads a KV head, head dim 128)
    over 256 patches and 512 tokens."""
    w = whisper_attention_shapes(whisper_config())
    qs, ks = internvl_attention_shapes(internvl_train_config())
    return {"whisper_train_encoder": w["encoder"],
            "whisper_train_decoder_self": w["decoder_self"],
            "whisper_train_cross": w["cross_prefill"],
            "internvl2_train": (qs, ks, True)}


def sdpa_eager(t: dict) -> dict:
    """``sdpa_backward_ms``'s numbers with the eager call's time as
    ``library_ms`` and the profiler's sum as ``library_profiler_ms``."""
    return dict(t, library_ms=t["library_eager_ms"],
                library_profiler_ms=t["library_ms"])


def enc_vlm_attention_grads(torch, dev, card: str) -> dict:
    """Phase 10k(a): attention's gradient at the four training shapes
    (``enc_vlm_attention_shapes``), f32: ``attention_grad_case`` within
    1e-4 of the largest gradient, the lse within 1e-5, two runs the same
    to the bit, the ``mma_3xtf32`` route asserted; then each timed: the
    backward's device ms in a replayed graph, each of its kernels' device
    time, eager ms, the bound, autograd through the plain attention, and
    SDPA's backward alone (internvl2's with ``enable_gqa``, and with k
    and v expanded to q's heads beside it): its ``library_ms`` is the
    eager call's, from CUDA events (``library_eager_ms``), as late in
    the script the profiler's sums can miss records; their sum is kept
    as ``library_profiler_ms``. Returns the numbers by shape."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(29)
    out = {}
    for name, (qs, ks, causal) in enc_vlm_attention_shapes().items():
        q, do = (torch.randn(qs, generator=g).to(dev) for _ in range(2))
        k, v = (torch.randn(ks, generator=g).to(dev) for _ in range(2))
        r = attention_grad_case(torch, q, k, v, do, causal, 0, 1e-4,
                                (name, qs, ks, causal))
        if r["route"] != "mma_3xtf32":
            raise AssertionError(f"{name} took the {r['route']} route")
        o, lse = r["o"], r["lse"]

        def kernel():
            return fa.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                          lse=lse)
        # max_abs_err: the largest of dq, dk, dv's errors over the
        # largest gradient
        t = {"route": r["route"], "q": list(qs), "kv": list(ks),
             "causal": causal, "max_abs_err": r["err"],
             "lse_rel_err": r["lse_err"],
             "ms": graph_ms(kernel, reps=10, trials=5),
             "kernels_ms": kernel_times(torch, kernel, calls=10),
             "eager_ms": eager_ms(kernel, reps=10, trials=5),
             "plain_ms": eager_ms(
                 lambda: ref.attention_vjp_ref(q, k, v, do, causal=causal),
                 reps=3, trials=3),
             **sdpa_eager(sdpa_backward_ms(torch, q, k, v, do, causal, 10,
                                           3, gqa=qs[1] != ks[1])),
             **attention_bwd_bound(q, k, causal)}
        if qs[1] != ks[1]:
            t["library_expanded"] = sdpa_eager(sdpa_backward_ms(
                torch, q, k, v, do, causal, 10, 3))
        log(f"flash_attention_bwd {name} q {qs} k/v {ks} causal {causal} "
            f"f32 ({card}): {json.dumps(t)}")
        out[name] = t
        del q, k, v, do, o, lse, r, kernel
        gc.collect()
        torch.cuda.empty_cache()
    return out


def whisper_train_configs():
    """whisper-large-v3 at full width and depth (its AdamW and remat
    policy), and the same cut to WHISPER_CHECK_LAYERS encoder and decoder
    layers for the kernel-vs-plain step."""
    cfg = whisper_config()
    assert (cfg.optimizer, cfg.remat_policy) == ("adamw", "minimal")
    cut = dataclasses.replace(
        cfg, n_layers=WHISPER_CHECK_LAYERS,
        encoder=dataclasses.replace(cfg.encoder,
                                    n_layers=WHISPER_CHECK_LAYERS))
    return cfg, cut


def internvl_train_config():
    """internvl2-76b at full width cut to INTERNVL_TRAIN_LAYERS layers;
    its Adafactor and remat policy."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(INTERNVL_ARCH),
                              n_layers=INTERNVL_TRAIN_LAYERS)
    assert (cfg.optimizer, cfg.remat_policy) == ("adafactor", "minimal")
    return cfg


def enc_vlm_train_phase(torch, dev) -> tuple:
    """Phase 10k: the encoder-decoder and the vision prefix trained on
    the card, f32, remat "minimal". (a) Attention's gradient at their
    four training shapes (``enc_vlm_attention_grads``). (b)
    whisper-large-v3 with (4, 448) tokens and (4, 1500, 1280) frames, its
    AdamW: one step's loss and gradients with the kernels against the
    plain versions' at 8 + 8 layers (``lm_kernel_vs_plain``: loss within
    rtol 1e-5, every gradient within 1e-4 of its leaf's largest, launches
    as ``lm_launches_per_step`` gives them), then ``train()`` at 32 + 32
    layers for 2 warm-up and 8 timed steps with a falling
    loss and exact launches (160 forward and 96 backward attention
    launches a step), and a profiled step (``lm_train``). (c)
    internvl2-76b at INTERNVL_TRAIN_LAYERS layers, (4, 512) tokens behind
    (4, 256, 8192) patches, its Adafactor at INTERNVL_TRAIN_LR: the same
    three. Returns (the launches of the counted runs, the measured
    numbers)."""
    t_phase = time.perf_counter()
    card = gpu_line()
    log(f"phase 10k(a): attention's gradient at whisper's and internvl2's "
        f"training shapes ({card})")
    out = {"attention_bwd": enc_vlm_attention_grads(torch, dev, card)}
    mark("phase 10k(a) attention's gradient at the training shapes")
    launches = {}
    steps = LM_WARMUP + LM_TIMED
    whisper, whisper_cut = whisper_train_configs()
    internvl = internvl_train_config()
    for tag, cfg, check, lr in (
            ("whisper", whisper, whisper_cut, LM_LR),
            ("internvl2", internvl, internvl, INTERNVL_TRAIN_LR)):
        t0 = time.perf_counter()
        card = gpu_line()
        b, s = train_text_shape(cfg)
        log(f"{cfg.arch_id} training ({card}): {cfg.n_layers} layers"
            + (f" + {cfg.encoder.n_layers} encoder layers over "
               f"{cfg.encoder.n_frames} frames" if cfg.encoder else "")
            + (f" behind {vision_prefix(cfg)} patch embeddings"
               if vision_prefix(cfg) else "")
            + f", every width as published; the kernel-vs-plain step at "
            f"{check.n_layers}"
            + (f" + {check.encoder.n_layers}" if check.encoder else "")
            + f" layers; {cfg.optimizer}, remat {cfg.remat_policy!r}, f32, "
            f"({b}, {s}) token batches, lr {lr}")
        versus = lm_kernel_vs_plain(torch, dev, check, card, grad_tol=1e-4)
        trained = lm_train(torch, dev, cfg, card, tag, lr)
        out[tag] = {"kernel_vs_plain": versus, "train": trained,
                    "seconds": time.perf_counter() - t0}
        launches[f"{tag}_train"] = {k: n * steps for k, n in
                                    trained["launches_per_step"].items()}
        mark(f"phase 10k {tag} training")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"whisper and internvl2 training phase: {out['seconds']:.1f} s; "
        f"{card}")
    return launches, out


# ---------------------------------------------------------------------------
# phase 11: sharding on the device path, every mesh position on this card
# ---------------------------------------------------------------------------

# 11a: the bench tower (benchmarks/bench_tower.py: 48 features, embed of
# 8 tokens of 64, attn_block of 4 heads, mlp to 64) and the demo's member
# bottom at its published widths (configs/vfl_recsys.py: 381 -> 256 ->
# 128), a round of 512 rows, over a model axis of 2 and of 4
BENCH_TOWER = ("embed:tokens=8,dim=64", "attn_block:heads=4",
               "mlp:hidden=64")
BENCH_IN, BENCH_OUT = 48, 64
TOWER_SHARDS = (2, 4)
SHARD_STEP_REPS = 20
# 11b: mesh-mode VFL at the paper's widths (configs/vfl_recsys.py): the
# master silo's 1,345 features and the member's 381 padded to them,
# bottom hidden 256, embedding 128, top (128, 64, 19), batch 4,096
VFL_FEATURES, VFL_MEMBER_FEATURES = 1345, 381
VFL_HIDDEN, VFL_EMBED, VFL_TOP = (256,), 128, (128, 64, 19)
VFL_BATCH, VFL_STEPS, VFL_LR = 4096, 20, 0.05
# 11c: granite decode with the KV cache's sequence over model on a
# (2, 4) data x model mesh (tests/test_sharded_decode.py's), 4 prompts
# of 16 then 16 greedy steps
DECODE_MESH = (2, 4)
DECODE_BATCH, DECODE_PROMPT, DECODE_NEW = 4, 16, 16
# 11d: repro_torch.examples.vfl_llm at full width and depth
VFL_LLM_STEPS = 8


def repeated_mesh(dev, shape, axes):
    """A mesh of ``shape`` whose every position is ``dev``."""
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(shape, axes, [dev] * math.prod(shape))


def _allclose_trees(torch, got, exp, what: str, rtol=1e-5, atol=1e-6
                    ) -> float:
    """Every leaf of ``got`` within rtol / atol of ``exp``'s; returns
    the largest difference."""
    from repro_torch.models import tower as twr
    worst = 0.0
    for a, b in zip(twr.leaves(got), twr.leaves(exp)):
        torch.testing.assert_close(a, b, rtol=rtol, atol=atol,
                                   msg=lambda m: f"{what}: {m}")
        worst = max(worst, (a - b).abs().max().item())
    return worst


def sharded_tower_check(torch, dev, name, blocks, in_dim, out_dim,
                        card: str, launches: dict) -> dict:
    """Phase 11a for one tower: forward and the member's step
    (``split_nn.member_step``) over a model axis of each of
    TOWER_SHARDS on this card repeated, against the unsharded tower on
    the same params, within rtol 1e-5 / atol 1e-6 (the JAX package's
    test's); each counted run's attention launches (one an attn_block a
    position, forward and step alike, and in the step one of its backward
    kernel); the ms of a sharded and an unsharded member step."""
    from repro_torch.core.protocols import split_nn as sn
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import tower as twr
    spec = twr.resolve(blocks, in_dim, out_dim)
    g = torch.Generator().manual_seed(21)
    params = twr.init(spec, g, dev)
    x = torch.randn((ROUNDS_ROWS, in_dim), generator=g).to(dev)
    du = torch.randn((ROUNDS_ROWS, out_dim), generator=g).to(dev)
    lr = 0.05
    n_attn = sum(b["kind"] == "attn_block" for b in spec.blocks)
    with torch.no_grad():
        plain = twr.apply(spec, params, x)
    plain_new = sn.member_step(spec, params, x, du, lr)

    def step_ms(fn):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(SHARD_STEP_REPS):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    out = {"unsharded_step_ms": step_ms(
        lambda: sn.member_step(spec, params, x, du, lr))}
    for m in TOWER_SHARDS:
        rules = twr.make_tower_rules(m, devices=[dev] * m)
        sharded = twr.shard_tower(params, spec, rules)
        fa.launches.reset()
        with torch.no_grad():
            got = twr.apply(spec, sharded, x, rules)
        torch.cuda.synchronize()
        fwd_launches = fa.launches.count
        fa.launches.reset()
        fa.bwd_launches.reset()
        new = sn.member_step(spec, sharded, x, du, lr, rules)
        torch.cuda.synchronize()
        step_launches = fa.launches.count
        bwd_launches = fa.bwd_launches.count
        launches[f"sharded_tower_{name}_m{m}"] = {
            "flash_attention": fwd_launches + step_launches,
            "flash_attention_bwd": bwd_launches}
        if (fwd_launches, step_launches, bwd_launches) != (m * n_attn,) * 3:
            raise AssertionError(
                f"{name} over model {m}: attention launched "
                f"{fwd_launches} (forward) and {step_launches} (step) "
                f"times, its backward {bwd_launches}, expected "
                f"{m * n_attn} each")
        fwd_err = _allclose_trees(torch, [got], [plain], f"{name} m{m} "
                                  f"forward")
        new_err = _allclose_trees(torch, twr._whole(new, dev), plain_new,
                                  f"{name} m{m} member step")
        out[f"m{m}"] = {"forward_max_abs_err": fwd_err,
                        "step_max_abs_err": new_err,
                        "attention_launches": fwd_launches + step_launches,
                        "attention_bwd_launches": bwd_launches,
                        "step_ms": step_ms(lambda: sn.member_step(
                            spec, sharded, x, du, lr, rules))}
    log(f"sharded tower {name} {blocks} ({in_dim} -> {out_dim}, "
        f"{ROUNDS_ROWS} rows) on {dev} repeated ({card}): "
        + json.dumps(out))
    return out


def time_tower_shards(torch, dev, card: str) -> dict:
    """Phase 11a: the attention kernel at the bench tower's per-shard
    shapes, (512, 4 / m, 8, 16) bidirectional, against its plain version
    within 2e-5, then timed beside it and SDPA."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(22)
    out = {}
    for m in TOWER_SHARDS:
        shape = (ROUNDS_ROWS, 4 // m, 8, 64 // 4)
        err = check_attention(torch, dev, shape, shape, 0, g,
                              causal=False)
        q, k, v = attention_inputs(torch, dev, shape, shape, g)
        b, h, s, dh = shape
        t = time_call(lambda: fa.flash_attention(q, k, v, causal=False),
                      lambda: ref.attention_ref(q, k, v, causal=False),
                      lambda: F.scaled_dot_product_attention(q, k, v),
                      4 * q.numel() * 4, 4.0 * b * h * s * s * dh,
                      rate=product_rate(q.dtype))
        t.update(shape=list(shape), variant=fa.variant(q, k, v),
                 max_abs_err=err)
        out[f"m{m}"] = t
        log(f"flash_attention sharded bench tower shard q/k/v {shape} "
            f"bidirectional f32 ({card}): {t}")
    return out


def plain_vfl_step(torch, bottoms, top, xs, y, lr: float):
    """The unsharded reference of mesh-mode VFL: every party's bottom and
    the top on one device, the plain sum of the bottom outputs, the BCE
    loss, autograd, ``p - lr * g``."""
    from repro_torch.core.protocols.split_nn import _bce
    from repro_torch.core.vfl_step import mlp_apply
    from repro_torch.models import tower as twr
    trees = list(bottoms) + [top]
    live = [[t.detach().requires_grad_() for t in twr.leaves(tr)]
            for tr in trees]
    with torch.enable_grad():
        agg = sum(mlp_apply(twr.with_leaves(b, ls), x, final_act=True)
                  for b, ls, x in zip(bottoms, live, xs))
        loss = _bce(mlp_apply(twr.with_leaves(top, live[-1]), agg), y)
        flat = [t for ls in live for t in ls]
        grads = torch.autograd.grad(loss, flat)
    with torch.no_grad():
        new = [p - lr * g for p, g in zip(flat, grads)]
    out, i = [], 0
    for tr, ls in zip(trees, live):
        out.append(twr.with_leaves(tr, new[i:i + len(ls)]))
        i += len(ls)
    return out[:-1], out[-1], loss.detach()


def mesh_vfl_phase(torch, dev, card: str) -> dict:
    """Phase 11b: ``make_mesh_vfl_step`` at the paper's widths, 2 pods
    on this card, VFL_STEPS steps masked and unmasked from the same
    params, against the plain unsharded step: losses within rtol 1e-5
    of it, masked within 1e-5 of unmasked; ms a step of each."""
    import numpy as np
    from repro_torch.core import secure_agg as SA
    from repro_torch.core import vfl_step as V
    mesh = repeated_mesh(dev, (2,), ("pod",))
    g = torch.Generator(dev).manual_seed(31)
    stacked = V.init_party_params(0, 2, VFL_FEATURES, VFL_HIDDEN, VFL_EMBED)
    top = [{k: t.to(dev) for k, t in lyr.items()} for lyr in V.mlp_init(
        torch.Generator().manual_seed(1), VFL_TOP)]
    x = torch.randn((2, VFL_BATCH, VFL_FEATURES), generator=g, device=dev)
    # the member silo's 381 features padded to the master's width
    x[1, :, VFL_MEMBER_FEATURES:] = 0
    y = (torch.rand((VFL_BATCH, VFL_TOP[-1]), generator=g, device=dev)
         < 0.3).float()
    lr = float(np.float32(VFL_LR))
    runs = {}
    for name in ("masked", "unmasked", "plain"):
        b, t = V.place_party_params(stacked, mesh), top
        mesh_step = V.make_mesh_vfl_step(mesh, 2, VFL_LR,
                                         use_masks=name == "masked")
        losses, times = [], []
        for i in range(VFL_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "plain":
                b, t, loss = plain_vfl_step(torch, b, t, [x[0], x[1]], y, lr)
            else:
                b, t, loss = mesh_step(b, t, x, y, SA.fold_in(0, i))
            losses.append(loss.item())
            times.append((time.perf_counter() - t0) * 1e3)
        runs[name] = {"losses": losses,
                      "step_ms": statistics.median(times[1:])}
    plain = np.asarray(runs["plain"]["losses"])
    out = {"batch": VFL_BATCH, "steps": VFL_STEPS,
           "loss_first": runs["masked"]["losses"][0],
           "loss_last": runs["masked"]["losses"][-1]}
    for name in ("masked", "unmasked"):
        got = np.asarray(runs[name]["losses"])
        out[f"{name}_vs_plain_rel_err"] = float(
            np.abs(got - plain).max() / np.abs(plain).min())
        out[f"{name}_step_ms"] = runs[name]["step_ms"]
    out["masked_vs_unmasked_rel_err"] = float(np.abs(
        np.asarray(runs["masked"]["losses"])
        - np.asarray(runs["unmasked"]["losses"])).max() / np.abs(plain).min())
    out["plain_step_ms"] = runs["plain"]["step_ms"]
    log(f"mesh-mode VFL at the paper's widths, 2 pods on {dev} ({card}): "
        + json.dumps(out))
    if not (np.isfinite(plain).all() and out["masked_vs_plain_rel_err"] <= 1e-5
            and out["unmasked_vs_plain_rel_err"] <= 1e-5
            and out["masked_vs_unmasked_rel_err"] <= 1e-5):
        raise AssertionError("mesh-mode VFL's losses disagree with the "
                             "plain step's")
    return out


def sharded_decode_check(torch, dev, cfg, params, card: str,
                         launches: dict) -> dict:
    """Phase 11c: granite's decode with ``decode_partial_softmax`` under
    rules of a (2, 4) data x model mesh of this card (the KV cache's 32
    slots in 4 slices of 8), against the plain decode: 4 prompts of 16
    and 16 greedy tokens decoded by the plain step, then the same tokens
    teacher-forced through the sharded step, every step's logits within
    2e-3 (the JAX package's test's bound); exact grouped-matmul launches
    (3 a layer a step) and no attention kernel; ms a step of each."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.sharding.rules import MeshRules
    cfg = dataclasses.replace(cfg, decode_partial_softmax=True)
    mesh = repeated_mesh(dev, DECODE_MESH, ("data", "model"))
    rules = MeshRules(mesh)
    n = DECODE_PROMPT + DECODE_NEW
    g = torch.Generator(dev).manual_seed(41)
    toks = torch.randint(0, cfg.vocab, (DECODE_BATCH, n), generator=g,
                         device=dev)

    def run(step, feed):
        cache = T.init_cache(cfg, DECODE_BATCH, n, torch.float32, dev)
        out, times = [], []
        for i in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = step(params, feed[:, i:i + 1], cache, i)
            if feed is toks and i + 1 >= DECODE_PROMPT and i + 1 < n:
                feed[:, i + 1] = logits[:, 0].argmax(-1)      # greedy
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            out.append(logits[:, 0])
        return torch.stack(out, 1), statistics.median(times[1:])

    plain, plain_ms = run(ST.make_decode_step(cfg, None, torch.float32),
                          toks)
    fa.launches.reset()
    gmm.launches.reset()
    sharded, sharded_ms = run(ST.make_decode_step(cfg, rules, torch.float32),
                              toks.clone())
    got = {"moe_gmm": gmm.launches.count,
           "flash_attention": fa.launches.count}
    launches["sharded_decode"] = dict(got)
    expected = {"moe_gmm": 3 * cfg.n_layers * n, "flash_attention": 0}
    if got != expected:
        raise AssertionError(f"sharded decode launched {got}, expected "
                             f"{expected}")
    err = (sharded - plain).abs().max().item()
    out = {"mesh": mesh.shape, "cache_slots": n, "steps": n,
           "max_abs_err": err, "sharded_step_ms": sharded_ms,
           "plain_step_ms": plain_ms, "launches": got}
    log(f"{cfg.arch_id} sequence-sharded decode ({cfg.n_layers} layers, "
        f"every position of the {mesh.shape} mesh on {dev}; {card}): "
        + json.dumps(out))
    if not (torch.isfinite(sharded).all() and err <= 2e-3):
        raise AssertionError("the sharded decode's logits disagree with "
                             "the plain decode's")
    return out


def vfl_llm_shapes(cfg):
    """The kernels' shapes on the VFL x LLM path: attention q (b, h, s,
    dh) and k/v (b, kvh, s, dh), causal; the grouped matmul's gate/up and
    down at its capacity."""
    from repro_torch.examples import vfl_llm
    from repro_torch.models import moe
    b, s = vfl_llm.BATCH, vfl_llm.SEQ
    c = moe._capacity(b * s, cfg)
    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_expert
    return ((b, cfg.n_heads, s, cfg.head_dim),
            (b, cfg.n_kv_heads, s, cfg.head_dim),
            [("gate_up", (e, c, d, f)), ("down", (e, c, f, d))])


def vfl_llm_kernels(torch, dev, cfg, card: str) -> dict:
    """Phase 11d: the kernels at the VFL x LLM path's shapes
    (``path_kernels``)."""
    qs, ks, gmm_shapes = vfl_llm_shapes(cfg)
    return path_kernels(torch, dev, cfg, card, qs, ks, gmm_shapes,
                        "VFL x LLM", 51)


def attention_bwd_at(torch, dev, qs, ks, window: int, g, tag: str,
                     card: str, dv=None, timing: dict | None = None,
                     plain_timing: dict | None = None,
                     causal: bool = True) -> dict:
    """The attention backward kernel (causal unless ``causal`` is False,
    ``window``; v's columns
    past ``dv`` zero, as MLA's call pads them) at q ``qs`` and k/v
    ``ks`` against the plain version's VJP, within 1e-4 of the largest
    gradient, then timed beside it and SDPA's backward (``timing``:
    ``graph_ms`` keywords, 50 calls, 10 trials by default;
    ``plain_timing`` the eager plain VJP's and SDPA's forward and
    backward, 20 calls and 5 trials by default)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    timing = timing or dict(reps=50, trials=10)
    slow = plain_timing or dict(reps=20, trials=5)
    q, do = (torch.randn(qs, generator=g).to(dev) for _ in range(2))
    k, v = (torch.randn(ks, generator=g).to(dev) for _ in range(2))
    if dv is not None:
        v[..., dv:] = 0
    o, lse = fa.flash_attention(q, k, v, causal=causal, window=window,
                                return_lse=True)
    got = fa.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                 window=window, lse=lse)
    exp = ref.attention_vjp_ref(q, k, v, do, causal=causal, window=window)
    torch.cuda.synchronize()
    bwd_err = grad_rel_err(got, exp)
    if not bwd_err <= 1e-4:
        raise AssertionError("attention's backward kernel disagrees with "
                             f"the plain VJP at the {tag} shape")

    def kernel():
        return fa.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                      window=window, lse=lse)
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))

    def sdpa_fwd_bwd():
        y = F.scaled_dot_product_attention(qr, kr, vr, is_causal=causal,
                                           enable_gqa=True)
        return torch.autograd.grad(y, (qr, kr, vr), do)
    out = {
        "shape": [list(qs), list(ks)], "window": window, "causal": causal,
        "max_abs_err": bwd_err, "variant": fa.bwd_variant(q, k, v),
        "ms": graph_ms(kernel, **timing),
        "eager_ms": eager_ms(kernel, **timing),
        "plain_ms": eager_ms(
            lambda: ref.attention_vjp_ref(q, k, v, do, causal=causal,
                                          window=window), **slow),
        **sdpa_backward_ms(torch, q, k, v, do, causal, timing["reps"],
                           timing["trials"]),
        "sdpa_fwd_bwd_ms": eager_ms(sdpa_fwd_bwd, **slow),
        **attention_bwd_bound(q, k, causal, dv)}
    log(f"flash_attention_bwd {tag} q {qs} k/v {ks} causal={causal} "
        f"window {window} f32 ({card}): {out}")
    return out


def path_kernels(torch, dev, cfg, card: str, qs, ks, gmm_shapes,
                 tag: str, seed: int, window: int = 0,
                 bwd: bool = True, dv=None,
                 att_timing: dict | None = None,
                 gmm_timing: dict | None = None,
                 causal: bool = True) -> dict:
    """The attention kernel (forward and, where ``bwd``, backward; causal
    unless ``causal`` is False, ``window`` as the path passes it, which
    must mask nothing for SDPA's
    sake; v's columns past ``dv`` zero, as MLA's call pads them) at q
    ``qs`` and k/v ``ks`` (none where ``qs`` is None), and the grouped
    matmul (forward, dx and dw) at each of ``gmm_shapes`` ((name, (e, c,
    d, f))), against their plain versions (2e-5; 1e-4 of the largest
    gradient; 2e-4), then timed beside them, SDPA and ``torch.bmm``
    (``att_timing`` / ``gmm_timing``: ``graph_ms`` keywords, 50 calls and
    10 trials by default)."""
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(seed)
    out = {}
    if qs is not None:
        out["attention"] = time_attention(
            torch, dev, cfg, qs, ks, window, g,
            att_timing or dict(reps=50, trials=10), dv, causal)
        out["attention"]["max_abs_err"] = check_attention(
            torch, dev, qs, ks, window, g, dv, causal)
        out["attention"]["shape"] = [list(qs), list(ks)]
        out["attention"]["causal"] = causal
    if qs is not None and bwd:
        out["attention_bwd"] = attention_bwd_at(
            torch, dev, qs, ks, window, g, tag, card, dv, att_timing,
            att_timing, causal)
    # the gmm's inputs drawn on the card, as ``check_moe_kernels``
    # draws them
    gd = torch.Generator(dev).manual_seed(seed)
    for name, (e, c, d, f) in gmm_shapes:
        x = torch.randn((e, c, d), generator=gd, device=dev)
        w = torch.randn((e, d, f), generator=gd, device=dev) * d ** -0.5
        dy = torch.randn((e, c, f), generator=gd, device=dev)
        xg, wg = (t.clone().requires_grad_() for t in (x, w))
        grads = torch.autograd.grad(gmm.MoeGmm.apply(xg, wg), (xg, wg), dy)
        xr, wr = (t.clone().requires_grad_() for t in (x, w))
        want = torch.autograd.grad(ref.gmm_ref(xr, wr), (xr, wr), dy)
        fwd = gmm.moe_gmm(x, w)
        fwd_ref = ref.gmm_ref(x, w)
        torch.cuda.synchronize()
        torch.testing.assert_close(fwd, fwd_ref, atol=2e-4, rtol=2e-4)
        for a, bb in zip(grads, want):
            torch.testing.assert_close(a, bb, atol=2e-4, rtol=2e-4)
        err = max((fwd - fwd_ref).abs().max().item(),
                  *((a - bb).abs().max().item()
                    for a, bb in zip(grads, want)))
        t = time_call(lambda: gmm.moe_gmm(x, w), lambda: ref.gmm_ref(x, w),
                      lambda: torch.bmm(x, w),
                      (x.numel() + w.numel() + e * c * f) * 4,
                      2.0 * e * c * d * f,
                      gmm_timing or dict(reps=50, trials=10),
                      rate=product_rate(x.dtype))
        t.update(shape=[list(x.shape), list(w.shape)],
                 variant=gmm.variant(x, w), max_abs_err=err)
        out[f"gmm_{name}"] = t
        log(f"moe_gmm {tag} {name} {(e, c, d, f)} f32, forward, dx "
            f"and dw ({card}): {t}")
        del x, w, dy, xg, wg, xr, wr, grads, want
    return out


def recurrence_at(torch, dev, name: str, shape, tag: str, card: str,
                  seed: int, bwd: bool = True) -> dict:
    """The WKV kernel (``name`` "rwkv6_wkv", ``shape`` (b, h, s, dh)) or
    the scan's ("selective_scan", (b, s, di, n); dt around the model's
    b_dt of -4.6) at a shard's shape, f32: the forward against its plain
    version (WKV at atol = rtol = 5e-5 as phase 6a; the scan within
    2e-5 of the output's largest magnitude as phase 9a), and where
    ``bwd`` the backward kernel through the ``autograd.Function`` (one
    forward and one backward launch; two backward runs the same to the
    bit) against autograd through the plain version in float64, every
    gradient within 1e-4 of its largest magnitude; then both timed
    beside their plain versions and their bounds, as phases 6c / 9c and
    10h count them (no PyTorch call computes either: library_ms
    None)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_wkv as wkv
    from repro_torch.kernels import selective_scan as ssm
    g = torch.Generator().manual_seed(seed)
    if name == "rwkv6_wkv":
        b, h, s, dh = shape
        mod, fwd, plain, vjp = wkv, wkv.rwkv6_wkv, ref.rwkv6_ref, \
            ref.rwkv6_vjp_ref
        ck_fwd, bwd_kernel = wkv.wkv_forward, wkv.rwkv6_wkv_bwd
        ins = wkv_inputs(torch, dev, b, h, s, dh, torch.float32, g)
        cot_shapes = [(b, h, s, dh), (b, h, dh, dh)]
        names = ("dr", "dk", "dv", "dw", "du")
        (fwd_bytes, fwd_ops), (bwd_bytes, bwd_ops) = wkv_bound(b, h, s, dh)
        fwd_tol = lambda ey, es: dict(atol=5e-5, rtol=5e-5)  # noqa: E731
    else:
        b, s, di, n = shape
        mod, fwd, plain, vjp = ssm, ssm.selective_scan, \
            ref.selective_scan_ref, ref.selective_scan_vjp_ref
        ck_fwd, bwd_kernel = ssm.scan_forward, ssm.selective_scan_bwd
        ins = scan_inputs(torch, dev, b, s, di, n, torch.float32,
                          torch.float32, g, -4.6)
        cot_shapes = [(b, s, di), (b, di, n)]
        names = ("ddt", "dB", "dC", "du", "dA")
        (fwd_bytes, fwd_ops), (bwd_bytes, bwd_ops) = scan_bound(b, s, di,
                                                               n)

        def fwd_tol(ey, es):
            scale = max(ey.abs().max().item(), es.abs().max().item())
            return dict(atol=2e-5 * scale, rtol=2e-5)
    y, sf = fwd(*ins)
    ey, es = plain(*ins)
    torch.cuda.synchronize()
    tol = fwd_tol(ey, es)
    torch.testing.assert_close(y, ey, **tol)
    torch.testing.assert_close(sf, es, **tol)
    out = {"shape": list(shape),
           "max_abs_err": max((y - ey).abs().max().item(),
                              (sf - es).abs().max().item()),
           **time_call(lambda: fwd(*ins), lambda: plain(*ins), None,
                       fwd_bytes, fwd_ops, dict(reps=20, trials=10),
                       plain_timing=dict(reps=1, trials=3))}
    del y, sf, ey, es
    log(f"{name} {tag} {tuple(shape)} f32 forward ({card}): {out}")
    if bwd:
        cots = [torch.randn(c, generator=g).to(dev) for c in cot_shapes]
        leaves = [t.clone().requires_grad_() for t in ins]
        mod.launches.reset()
        mod.bwd_launches.reset()
        outs = fwd(*leaves)
        got = torch.autograd.grad(outs, leaves, cots, retain_graph=True)
        if (mod.launches.count, mod.bwd_launches.count) != (1, 1):
            raise AssertionError(f"{name} at {tag}: {mod.launches.count} "
                                 f"forward and {mod.bwd_launches.count} "
                                 f"backward launches, expected 1 and 1")
        again = torch.autograd.grad(outs, leaves, cots)
        same = all(torch.equal(a, c) for a, c in zip(got, again))
        exp = vjp(*(t.double() for t in ins), *(c.double() for c in cots))
        torch.cuda.synchronize()
        errs = {k: grad_rel_err((a,), (e,))
                for k, a, e in zip(names, got, exp)}
        abs_err = max((a.double() - e).abs().max().item()
                      for a, e in zip(got, exp))
        del leaves, outs, got, again, exp
        _, _, chk = ck_fwd(*ins, checkpoints=True)

        def kernel():
            return bwd_kernel(*ins, chk, *cots)
        out["bwd"] = {
            "shape": list(shape), "grad_rel_errs": errs,
            "max_abs_err": abs_err, "two_runs_same_bits": same,
            "ms": graph_ms(kernel, reps=20, trials=10),
            "eager_ms": eager_ms(kernel, reps=20, trials=10),
            "plain_ms": eager_ms(lambda: vjp(*ins, *cots), reps=1,
                                 trials=3),
            "library_ms": None, **_bound(bwd_bytes, bwd_ops)}
        log(f"{name}_bwd {tag} {tuple(shape)} f32 ({card}): {out['bwd']}")
        del chk, cots
        if not (max(errs.values()) <= 1e-4 and same):
            raise AssertionError(f"{name}'s backward kernel disagrees with "
                                 f"the plain VJP at the {tag} shape, or "
                                 f"with itself")
    del ins
    return out


def vfl_llm_phase(torch, dev, card: str, launches: dict) -> tuple:
    """Phase 11c-d on one drawn granite-moe-3b-a800m (full width and
    depth): the sequence-sharded decode (11c) on its weights, then
    ``repro_torch.examples.vfl_llm`` (two silos on this card, B 8, 16
    soft tokens): the first step's loss and gradients with the kernels
    and masks against the plain versions unmasked (loss within rtol
    1e-5, every gradient within 1e-4 of its leaf's largest; the routing
    held alike, ``Routing``), its exact launches; VFL_LLM_STEPS SGD
    steps: finite losses, step ms, tokens/s, peak memory, whether the
    loss fell (logged, not gated). Returns (decode, vfl_llm numbers)."""
    from repro_torch.core import secure_agg as SA
    from repro_torch.examples import vfl_llm
    from repro_torch.models import params as PRM
    cfg = moe_config()
    mesh = vfl_llm.silo_mesh(dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ex = vfl_llm.init_example(cfg, mesh, seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(ex["backbone"]))
    log(f"{cfg.arch_id} backbone: {n_params:,} params in f32, "
        f"{n_params * 4 / 1e9:.2f} GB, drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    with torch.no_grad():
        decode = sharded_decode_check(torch, dev, cfg, ex["backbone"], card,
                                      launches)
    counters = all_counters()
    key0 = SA.fold_in(0, 100)
    routing = Routing(torch)
    for c in counters.values():
        c.reset()
    with routing.record():
        loss_k, gf_k, gb_k = vfl_llm.vfl_llm_grads(
            cfg, mesh, ex["fronts"], ex["backbone"], ex["x"], ex["labels"],
            key0)
    torch.cuda.synchronize()
    got = {name: c.count for name, c in counters.items()}
    per_step = lm_launches_per_step(cfg)
    if got != per_step:
        raise AssertionError(f"the VFL x LLM step launched {got}, "
                             f"expected {per_step}")
    with plain_versions(), routing.replay():
        loss_p, gf_p, gb_p = vfl_llm.vfl_llm_grads(
            cfg, mesh, ex["fronts"], ex["backbone"], ex["x"], ex["labels"],
            key0, use_masks=False)
    worst, worst_leaf = 0.0, None
    pairs = [(f"front{i}", a, b) for i, (a, b) in enumerate(zip(gf_k, gf_p))]
    pairs += [("/".join(p), a, b) for (p, a), (_, b) in
              zip(PRM.tree_items(gb_k), PRM.tree_items(gb_p))]
    for name, a, b in pairs:
        if (a is None) != (b is None):
            raise AssertionError(f"gradient {name} present in one step only")
        if a is None:
            continue
        err = grad_rel_err((a,), (b,))
        if err > worst:
            worst, worst_leaf = err, name
    loss_err = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    del gf_k, gb_k, gf_p, gb_p
    gc.collect()
    versus = {"loss_kernel_masked": loss_k.item(),
              "loss_plain_unmasked": loss_p.item(),
              "loss_rel_err": loss_err, "grad_rel_err": worst,
              "grad_rel_err_leaf": worst_leaf,
              "routing_flips_replayed": routing.flips, "launches": got}
    log(f"VFL x LLM first step, kernels and masks vs plain versions "
        f"unmasked ({card}): " + json.dumps(versus))
    if not (loss_err <= 1e-5 and worst <= 1e-4):
        raise AssertionError("the VFL x LLM step's loss or gradients "
                             "disagree with the plain unmasked step's")
    step = vfl_llm.make_vfl_llm_step(cfg, mesh)
    losses, times = [], []
    peak_all = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    for i in range(VFL_LLM_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(ex["fronts"], ex["backbone"], ex["x"], ex["labels"],
                    SA.fold_in(0, 100 + i))
        losses.append(loss.item())
        times.append((time.perf_counter() - t0) * 1e3)
    got = {name: c.count for name, c in counters.items()}
    launches["vfl_llm"] = {k: v for k, v in got.items() if v}
    expected = {k: v * VFL_LLM_STEPS for k, v in per_step.items()}
    if got != expected:
        raise AssertionError(f"{VFL_LLM_STEPS} VFL x LLM steps launched "
                             f"{got}, expected {expected}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"VFL x LLM losses {losses}")
    step_ms = statistics.median(times[1:])
    tokens = vfl_llm.BATCH * vfl_llm.SEQ
    out = {"kernel_vs_plain": versus, "losses": losses,
           "loss_fell": losses[-1] < losses[0], "step_ms": step_ms,
           "tokens_per_s": tokens / step_ms * 1e3,
           # the steps alone, and with the first step's two gradient
           # trees held for the comparison
           "peak_gb_steps": torch.cuda.max_memory_allocated() / 1e9,
           "peak_gb": max(peak_all, torch.cuda.max_memory_allocated()) / 1e9,
           "launches_per_step": {k: v for k, v in per_step.items() if v}}
    log(f"VFL x LLM {cfg.arch_id} ({cfg.n_layers} layers, 2 silos on {dev}, "
        f"B {vfl_llm.BATCH}, {vfl_llm.SEQ} soft tokens, SGD lr "
        f"{vfl_llm.LR}; {card}): " + json.dumps(out))
    del ex, step
    gc.collect()
    torch.cuda.empty_cache()
    return decode, out


def sharding_phase(torch, dev) -> tuple:
    """Phase 11: the sharded paths, every mesh position on this card
    (``cuda:0`` repeated: the splits, partial products and combines all
    run, one process, no ``torch.distributed``). Returns (the launches
    of the counted runs, the measured numbers)."""
    t_phase = time.perf_counter()
    card = gpu_line()
    log(f"sharding phase: every mesh position on {dev} repeated ({card})")
    launches: dict = {}
    from repro_torch.configs.vfl_recsys import CONFIG as RECSYS
    towers = {
        "bench": sharded_tower_check(torch, dev, "bench", BENCH_TOWER,
                                     BENCH_IN, BENCH_OUT, card, launches),
        "demo_member": sharded_tower_check(
            torch, dev, "demo_member",
            (f"mlp:hidden={RECSYS.bottom_dims[0]}",),
            VFL_MEMBER_FEATURES, RECSYS.embedding_dim, card, launches)}
    shards_t = time_tower_shards(torch, dev, card)
    vfl = mesh_vfl_phase(torch, dev, card)
    decode, llm = vfl_llm_phase(torch, dev, card, launches)
    kernels = vfl_llm_kernels(torch, dev, moe_config(), card)
    out = {"towers": towers, "tower_shard_attention": shards_t,
           "mesh_vfl": vfl, "sharded_decode": decode, "vfl_llm": llm,
           "vfl_llm_kernels": kernels,
           "seconds": time.perf_counter() - t_phase}
    log(f"sharding phase: {out['seconds']:.1f} s; {card}")
    return launches, out


# ---------------------------------------------------------------------------
# phase 12: the zoo's train and prefill steps on a mesh of more than one
# device, every mesh position on this card
# ---------------------------------------------------------------------------

# 12a: granite-moe-3b-a800m trained on a data 2 x model 2 mesh at full
# width: the sharded step held to the unsharded one at SHARD_CMP_LAYERS
# layers, where both sit on the card, then alone at SHARD_ALONE_LAYERS
# (its full 32 until phases 12d-12g came, 16 until phases 12h-12j came:
# cut to keep the script's time)
# 12b: h2o-danube-1.8b trained on data 2 x model 2 at full width, depth
# 24 -> SHARD_H2O_LAYERS (its full depth until phases 12h-12j came, 12
# until phases 12k-12m came, cut to keep the script's time; the dense
# gated MLP's split and the loss over 32,000 / 2 vocab)
# 12c: glm4-9b prefill on a 1 x 4 mesh (its 2 KV heads fall back to
# replication on model 4) at full width, depth 40 -> SHARD_GLM4_LAYERS
# so that the unsharded reference sits beside the sharded params
# 12d: rwkv6-7b trained on data 2 x model 2 at full width and
# RWKV_TRAIN_LAYERS layers, AdamW (the WKV kernel and its backward on a
# position's 32 heads)
# 12e: the jamba cut (``jamba_train_config``: mamba + mlp, mamba + moe,
# 4 experts) on data 2 x model 2, Adafactor (the scan on a position's
# 8,192 channels, w_in's column map, 2 experts a position)
# 12f: deepseek-v2-lite-16b on data 2 x model 2, depth 27 ->
# SHARD_MLA_LAYERS (the dense prefix layer and three MoE layers), AdamW:
# MLA's first training step on the card (8 heads a position at head dim
# 192, v padded; 32 experts a position; a vocab of 51,200 a position)
# 12g: rwkv6-7b prefill on a 1 x 4 mesh, depth 32 ->
# SHARD_RWKV_PREFILL_LAYERS so that the unsharded reference sits beside
# the sharded params
# 12h: whisper-large-v3 trained on data 2 x model 2 at full width and
# WHISPER_CHECK_LAYERS encoder and decoder layers, AdamW (the encoder's
# bidirectional attention and each decoder layer's cross-attention over
# a position's 10 heads, the biased MLP over mlp, layernorm)
# 12i: internvl2-76b on data 2 x model 2 at full width, depth 80 ->
# SHARD_INTERNVL_LAYERS (2.96 B params: the untied embed and head take
# 2.1 B), so that the unsharded reference waits on the card beside the
# placed params and both sharded runs' gradients; its 256 patches go
# with their rows and out of the loss, Adafactor at INTERNVL_TRAIN_LR
# 12j: both models' prefill on a 1 x 4 mesh: whisper at full width and
# depth (its vocab of 51,866 falls back to replication on model 4),
# internvl2 at INTERNVL_TRAIN_LAYERS (16 q heads and 2 KV heads a
# position)
# 12k-12m: the sequence split (``act_rules["seq"] = ("model",)``): 12a's
# compared step (512 tokens a row, 256 a cell), 12d's rwkv6-7b step (the
# token shift and WKV across a cell boundary) and 12j's internvl2
# prefill (256 patches and 512 tokens, 192 positions a cell), each from
# params placed afresh and held to its phase's unsharded reference
SHARD_MESH = (2, 2)
SHARD_CMP_LAYERS = 8
SHARD_ALONE_LAYERS = 8
SHARD_H2O_LAYERS = 6
SHARD_GLM4_MESH = (1, 4)
SHARD_GLM4_LAYERS = 20
SHARD_MLA_LAYERS = 4
SHARD_RWKV_PREFILL_MESH = (1, 4)
SHARD_RWKV_PREFILL_LAYERS = 16
SHARD_INTERNVL_LAYERS = 1
SHARD_ENC_VLM_PREFILL_MESH = (1, 4)
SHARD_TIMED = 2
# the share of the card's memory that four trees of a compared step's
# params' size (the unsharded gradients, the placed params, the first
# sharded run's gradients and the second's) may take: the unsharded
# gradients wait on the card where they fit so, else on the host
SHARD_REF_ON_CARD_SHARE = 0.85


def mixer_split(cfg, mixer: str) -> int:
    """The dim of a mixer that ``model`` splits: an RWKV-6 time-mix's
    heads, a Mamba mixer's d_inner channels, attention's (and MLA's) q
    heads."""
    if mixer == "rwkv":
        return cfg.d_model // cfg.rwkv.head_dim
    if mixer == "mamba":
        return cfg.mamba.d_inner(cfg.d_model)
    return cfg.eff_heads


def sharded_launches_per_step(cfg, shape, train: bool = True) -> dict:
    """Each hand kernel's launches in one step on a (data, model) mesh
    of ``shape``, each row (data position) its share of the batch. A
    mixer layer (attention, MLA, RWKV-6, Mamba) runs its kernel once a
    row and model position where its split dim (``mixer_split``)
    divides over model, else once a row; an MoE layer's three grouped
    matmuls once a model position over the experts' split (one where
    they do not split), on every row's tokens at once. A training step
    under remat "minimal" runs each repeated layer's forward kernels
    twice (the forward and its recomputation) and a prefix layer's once
    (no remat wraps it), each backward kernel once, the grouped matmul
    two a call in the backward; a prefill runs the forwards once. An
    encoder-decoder adds its encoder layers' attention, once a row and
    model position (no remat wraps the encoder) and its backward once,
    and each decoder layer's cross-attention as many times as the
    layer's self-attention."""
    assert not train or cfg.remat_policy == "minimal"
    rows, model = shape
    ep = model if cfg.moe and cfg.moe.num_experts % model == 0 else 1
    layers = [(m, f, 1) for m, f in cfg.prefix_pattern] + [
        (m, f, 2 if train else 1)
        for m, f in cfg.block_pattern * cfg.n_repeats]
    out = {name: 0 for name in all_counters()}

    def calls(mixer):
        return rows * (model if mixer_split(cfg, mixer) % model == 0
                       else 1)

    def attention(runs):
        out["flash_attention"] += calls("attn") * runs
        if train:
            out["flash_attention_bwd"] += calls("attn")
    for mixer, ffn, runs in layers:
        fwd, bwd = MIXER_KERNELS[mixer]
        out[fwd] += calls(mixer) * runs
        if train:
            out[bwd] += calls(mixer)
        if cfg.encoder is not None:
            attention(runs)
        if ffn == "moe":
            out["moe_gmm"] += 3 * ep * (runs + 2 if train else 1)
    for _ in range(0 if cfg.encoder is None else cfg.encoder.n_layers):
        attention(1)
    return out


def whole_items(tree, path=()):
    """(path, tensor) of each leaf of a param-like tree in
    ``tree_items``' order (dict keys sorted), a placed leaf (``Parts``)
    gathered whole only when its turn comes, so that no whole tree sits
    on the card at once."""
    from repro_torch.sharding.rules import Parts
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from whole_items(tree[k], path + (str(k),))
    else:
        yield path, tree.whole() if isinstance(tree, Parts) else tree


def capture_optimizer(against=None):
    """An optimizer whose update keeps the gradients the step hands it
    (each placed leaf gathered whole) and leaves params and state be:
    a train step's gradients through ``make_train_step`` itself. With
    ``against`` (a whole tree like them) it keeps instead whether every
    leaf equals ``against``'s to the bit, each gathered whole in turn,
    so that a second tree never sits whole on the card."""
    import torch
    from repro_torch.models import params as PRM
    from repro_torch.train import optimizer as O
    got = []

    def update(grads, state, params, lr):
        if against is None:
            got.append(PRM.whole_tree(grads))
        else:
            got.append(all(torch.equal(a, b) for (_, a), (_, b) in zip(
                whole_items(grads), whole_items(against))))
        return params, state
    return O.Optimizer("capture", lambda p: {}, update, lambda a: {}), got


def to_host(torch, tree):
    from repro_torch.models import params as PRM
    return PRM.tree_map(lambda t: t.detach().to("cpu"), tree)


def reference_updates(opt, params, grads, lr: float):
    """The params after one step of ``opt`` from ``params`` (updated in
    place) by ``grads`` (on the card or the host), a leaf at a time in
    ``tree_items``' order: each leaf updated as a one-leaf tree, as
    every optimizer here updates each leaf on its own."""
    for (path, p), (_, g) in zip(whole_items(params), whole_items(grads)):
        one = {"w": p}
        opt.update({"w": g.to(p.device)}, opt.init(one), one, lr)
        yield path, p


def update_err(torch, opt_name: str, got, exp, g_got, g_exp,
               lr: float, eps: float = 1e-8) -> float:
    """The largest difference of a param updated by one step of
    ``opt_name`` over its leaf's largest param; each argument yields
    (path, tensor) a leaf at a time (``whole_items``,
    ``reference_updates``; the gradients are read for AdamW only).
    AdamW's is taken beyond its own share of the gradients' difference,
    the share that ``assert_adamw_updates`` of
    tests/test_torch_sharded_steps.py states and allows; Adafactor's
    plainly, its first step being linear in the gradient (no sign of it
    taken)."""
    import itertools
    worst = 0.0
    grads = zip(g_got, g_exp) if opt_name == "adamw" \
        else itertools.repeat(None)
    for (_, a), (_, e), gs in zip(got, exp, grads):
        e = e.to(a.device)
        scale = e.abs().max().clamp(min=1e-30)
        if gs is None:
            worst = max(worst, float(((a - e).abs() / scale).max()))
            continue
        g1, g2 = (g.to(a.device) for _, g in gs)
        same = torch.sign(g1) == torch.sign(g2)
        moved = torch.where(same, (g1 - g2).abs() * eps / (
            (g1.abs() + eps) * (g2.abs() + eps)), 2.0)
        rest = ((a - e).abs() - lr * moved * (1 + 1e-3)).clamp(min=0)
        worst = max(worst, float((rest / scale).max()))
    return worst


def _time_steps(torch, fn, n: int) -> list:
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _counted(counters) -> dict:
    return {name: c.count for name, c in counters.items()}


def tensor_bytes(*trees) -> int:
    """The bytes of the distinct storages that the tensors of ``trees``
    (dicts, lists, ``Parts``) hold on the card."""
    from repro_torch.launch.hlo_analysis import tensors
    seen = {}
    for tree in trees:
        for t in tensors(tree):
            st = t.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def seq_rules(mesh):
    """Mesh rules that split the sequence over ``model``
    (``act_rules["seq"]``, the dry-run's ``seqshard``)."""
    from repro_torch.sharding.rules import MeshRules
    rules = MeshRules(mesh)
    rules.act_rules["seq"] = ("model",)
    return rules


def stream_bytes(torch, cfg, rules, batch) -> int:
    """The bytes of residual stream (f32) one mesh position holds
    between layers in a step of ``cfg`` on ``batch`` under ``rules``: a
    row's (b_row, s_total, d) at its home, or one of its sequence cells,
    as the step's layout (``launch/steps.py`` ``_Rows``, asked with
    fresh rules so that their fallbacks are not recorded twice) decides
    it; computed from those shapes."""
    from repro_torch.launch import steps as ST
    from repro_torch.sharding.rules import MeshRules
    fresh = MeshRules(rules.mesh, act_rules=dict(rules.act_rules))
    lay, rows = ST._Rows(cfg, fresh)(batch)
    b, s = rows["tokens"][0].shape
    s += vision_prefix(cfg)
    return b * s * cfg.d_model * 4 // lay.n_cells


def log_seq_split(phase: str, out: dict, card: str) -> None:
    """One line for a sequence-split phase (12k-12m): its step (or
    prefill) ms with the split, without it and unsharded, peak memory,
    busy share, and the residual stream's bytes a position holds
    between layers with and without the split."""
    seq = out["seq_split"]
    kind = "step" if "sharded_step_ms" in out else "prefill"
    log(f"phase {phase}: {kind} ms with the split "
        f"{seq[f'sharded_{kind}_ms']:.1f}, without "
        f"{out[f'sharded_{kind}_ms']:.1f}, unsharded "
        f"{out[f'unsharded_{kind}_ms']:.1f}; peak GB "
        f"{seq['sharded_peak_gb']:.2f} / {out['sharded_peak_gb']:.2f}; busy "
        f"{seq['sharded_busy_share']:.3f} / {out['sharded_busy_share']:.3f}; "
        f"residual stream bytes a position holds between layers "
        f"{seq['stream_bytes_per_position']} / "
        f"{out['stream_bytes_per_position']}; launches {seq['launches']} "
        f"(unsplit {out['launches']}); {card}")


def sharded_train_check(torch, dev, cfg, card: str, lr: float = LM_LR,
                        seq_split: bool = False) -> dict:
    """Phases 12a (at SHARD_CMP_LAYERS), 12b, 12d-12f, 12h and 12i, and
    with ``seq_split`` 12k (12a's) and 12l (12d's): one training step of
    ``cfg`` with its own optimizer at ``lr`` on a SHARD_MESH mesh of
    this card against the unsharded step, from the same params (seed 0)
    and batch (``lm_batch``: whisper's frames and internvl2's patches
    too), the routing held alike (``Routing.replay``): the loss within
    1e-5 relative, every gradient (``capture_optimizer``) within 1e-4 of
    its leaf's largest, every updated param within 1e-4 of its leaf's
    largest (``update_err``: beyond AdamW's own share of the gradients'
    difference); two sharded runs the same to the bit; launches exact
    at ``sharded_launches_per_step``; then step ms of both (SHARD_TIMED
    steps after one warm-up, each on its own params), peak memory and a
    profiled sharded step's busy share. With ``seq_split`` the sharded
    side runs again, from params placed afresh, under rules that split
    the sequence over ``model`` (``seq_rules``), held to the same
    unsharded reference with the same gates, its launches equal to the
    unsplit step's, and both sides are timed once the reference is let
    go, each from params placed afresh, so that their peaks hold the
    same things; its numbers under ``seq_split`` and the residual
    stream's bytes a position holds between layers with and without the
    split (``stream_bytes``). The unsharded side's gradients wait on the
    card where four trees of their size take at most
    SHARD_REF_ON_CARD_SHARE of it, else on the host, and come back a
    leaf at a time to be compared; its updated params are made a leaf
    at a time from the params drawn again (``reference_updates``), and
    the second sharded run is held to the first a leaf at a time
    (``capture_optimizer(against=...)``), so no whole reference tree but
    the gradients is kept; ``stage_seconds`` say where the check's time
    goes."""
    from repro_torch.launch import steps as ST
    from repro_torch.models import params as PRM
    from repro_torch.models import transformer as T
    from repro_torch.sharding.rules import MeshRules
    from repro_torch.train import optimizer as O

    def draw():
        with torch.no_grad():
            return PRM.init_tree(T.model_spec(cfg),
                                 torch.Generator(dev).manual_seed(0),
                                 torch.float32, dev)
    counters = all_counters()
    stages, t0 = {}, time.perf_counter()

    def stage(name):
        nonlocal t0
        stages[name] = time.perf_counter() - t0
        t0 = time.perf_counter()
    batch = lm_batch(torch, dev, cfg, seed=0)
    out = {"layers": cfg.n_layers, "mesh": list(SHARD_MESH),
           "optimizer": cfg.optimizer}
    # the unsharded step's time, on its own params
    params = draw()
    opt = O.make_optimizer(cfg.optimizer)
    state = opt.init(params)
    step_u = ST.make_train_step(cfg, opt, lr=lr,
                                compute_dtype=torch.float32)
    for c in counters.values():
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    times = _time_steps(torch, lambda: step_u(params, state, batch),
                        1 + SHARD_TIMED)
    out["unsharded_step_ms"] = statistics.median(times[1:])
    out["unsharded_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    # one step's, for phase 13: the rise of the allocated bytes above
    # the window's start, what the step starts from, its launches
    out["unsharded_rise_bytes"] = torch.cuda.max_memory_allocated() - base
    out["unsharded_resident_bytes"] = tensor_bytes(params, state, batch)
    out["unsharded_launches"] = {
        k: n // (1 + SHARD_TIMED) for k, n in _counted(counters).items()}
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    stage("unsharded_timed")
    # the compared step
    params = draw()
    routing = Routing(torch)
    with routing.record():
        loss_u, _, g_u = ST.loss_and_grads(cfg, params, batch,
                                           torch.float32)
    ref_bytes = sum(t.numel() * t.element_size()
                    for t in PRM.tree_leaves(g_u))
    # a copy to the host ran at ~2 GB/s beside the H100 (PERF.md): the
    # reference waits there only where it does not fit on the card
    on_card = 4 * ref_bytes <= SHARD_REF_ON_CARD_SHARE \
        * torch.cuda.get_device_properties(dev).total_memory
    if not on_card:
        g_u = to_host(torch, g_u)
    out["unsharded_reference_on_card"] = on_card
    out["unsharded_reference_gb"] = ref_bytes / 1e9
    stage("unsharded_compared")
    mesh = repeated_mesh(dev, SHARD_MESH, ("data", "model"))
    want = sharded_launches_per_step(cfg, SHARD_MESH)

    def compared(rules, placed, tag: str) -> tuple:
        """The sharded step under ``rules`` from ``placed``: compared,
        run again, updated and compared. Returns (its numbers, the
        updated params)."""
        cap, grads = capture_optimizer()
        step_c = ST.make_train_step(cfg, cap, lr=0.0, rules=rules,
                                    compute_dtype=torch.float32)
        for c in counters.values():
            c.reset()
        with routing.replay():
            _, _, m_s = step_c(placed, {}, batch)
        launches = _counted(counters)
        g_s = grads.pop()
        cap, same = capture_optimizer(against=g_s)
        with routing.replay():
            ST.make_train_step(cfg, cap, lr=0.0, rules=rules,
                               compute_dtype=torch.float32)(placed, {},
                                                            batch)
        same = same[0]
        del cap
        loss_err = abs(m_s["total_loss"].item() - loss_u.item()) \
            / abs(loss_u.item())
        grad_err, grad_leaf = 0.0, None
        for (path, a), (_, b) in zip(PRM.tree_items(g_s),
                                     PRM.tree_items(g_u)):
            err = grad_rel_err((a,), (b.to(a.device),))
            if err > grad_err:
                grad_err, grad_leaf = err, "/".join(path)
        if opt.name != "adamw":
            # only AdamW's update check reads the gradients again
            g_s = None
        gc.collect()
        stage(f"{tag}_captured_twice")
        state = opt.init(placed)
        with routing.replay():
            placed, state, _ = ST.make_train_step(
                cfg, opt, lr=lr, rules=rules,
                compute_dtype=torch.float32)(placed, state, batch)
        # the slots make room for the comparison and are drawn again for
        # the timed steps, whose work does not depend on their values
        del state
        gc.collect()
        torch.cuda.empty_cache()
        with torch.no_grad():
            upd_err = update_err(
                torch, opt.name, whole_items(placed),
                reference_updates(opt, draw(), g_u, lr),
                None if g_s is None else whole_items(g_s),
                whole_items(g_u), lr)
        del g_s
        gc.collect()
        torch.cuda.empty_cache()
        stage(f"{tag}_updated_and_compared")
        return {"loss_sharded": m_s["total_loss"].item(),
                "loss_rel_err": loss_err, "grad_rel_err": grad_err,
                "grad_rel_err_leaf": grad_leaf,
                "updated_rel_err": upd_err,
                "two_runs_same_bits": same, "launches": launches,
                "stream_bytes_per_position": stream_bytes(torch, cfg, rules,
                                                          batch)}, placed

    def timed(rules, placed, tag: str) -> dict:
        """Step ms (SHARD_TIMED steps), peak memory and a profiled step's
        busy share of the sharded step under ``rules`` from ``placed``,
        with nothing of the check's reference on the card."""
        step_s = ST.make_train_step(cfg, opt, lr=lr, rules=rules,
                                    compute_dtype=torch.float32)
        state = opt.init(placed)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        times = _time_steps(torch, lambda: step_s(placed, state, batch),
                            SHARD_TIMED)
        got = {"sharded_step_ms": statistics.median(times),
               "sharded_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "sharded_rise_bytes": torch.cuda.max_memory_allocated()
               - base,
               "sharded_resident_bytes": tensor_bytes(placed, state, batch)}
        prof = profile_window(torch, lambda: step_s(placed, state, batch),
                              min(times) / 1e3)
        got["sharded_busy_share"] = prof["device_busy_share"]
        got["sharded_profile"] = prof
        del placed, state
        gc.collect()
        torch.cuda.empty_cache()
        stage(f"{tag}_timed_and_profiled")
        return got

    def placed_afresh(rules):
        with torch.no_grad():
            out = ST.place_params(cfg, draw(), rules)
        gc.collect()
        torch.cuda.empty_cache()
        return out

    rules = MeshRules(mesh)
    placed = ST.place_params(cfg, params, rules)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    got, placed = compared(rules, placed, "sharded")
    sides = [got]
    if seq_split:
        # each side's timing waits until the reference is let go, and
        # runs from params placed afresh, so that both peaks hold the
        # same: the params, the slots and the step
        del placed
        rules_seq = seq_rules(mesh)
        got_seq, placed = compared(rules_seq, placed_afresh(rules_seq),
                                   "seq_split")
        del placed
        sides.append(got_seq)
    g_u = None
    gc.collect()
    torch.cuda.empty_cache()
    if seq_split:
        got.update(timed(rules, placed_afresh(rules), "sharded"))
        got_seq.update(timed(rules_seq, placed_afresh(rules_seq),
                             "seq_split"))
        got_seq["fallbacks"] = rules_seq.fallbacks
        got_seq["routing_flips_replayed"] = routing.flips
    else:
        # the sharded step's time, on from the compared step
        got.update(timed(rules, placed, "sharded"))
        del placed
    out.update({"loss_unsharded": loss_u.item(),
                "routing_flips_replayed": routing.flips, **got,
                "launches_expected": want, "fallbacks": rules.fallbacks})
    if seq_split:
        out["seq_split"] = got_seq
    out["stage_seconds"] = stages
    split = " and with the sequence split (act_rules['seq'])" \
        if seq_split else ""
    log(f"{cfg.arch_id} {cfg.n_layers} layers, sharded training step on "
        f"a {SHARD_MESH} data x model mesh of {dev}{split} vs unsharded "
        f"({card}): " + json.dumps(out))
    for got in sides:
        if got["launches"] != want:
            raise AssertionError(f"the sharded step launched "
                                 f"{got['launches']}, expected {want}")
        if not (got["loss_rel_err"] <= 1e-5 and got["grad_rel_err"] <= 1e-4
                and got["updated_rel_err"] <= 1e-4
                and got["two_runs_same_bits"]):
            raise AssertionError("the sharded training step disagrees "
                                 "with the unsharded one, or with itself")
    return out


def sharded_train_alone(torch, dev, cfg, card: str) -> dict:
    """Phase 12a at SHARD_ALONE_LAYERS: the sharded training step alone
    (at full depth its unsharded twin does not fit beside it): launches
    exact, loss
    finite, step ms (SHARD_TIMED after one warm-up), peak memory, a
    profiled step's busy share."""
    import math
    from repro_torch.launch import steps as ST
    from repro_torch.models import params as PRM
    from repro_torch.models import transformer as T
    from repro_torch.sharding.rules import MeshRules
    from repro_torch.train import optimizer as O
    rules = MeshRules(repeated_mesh(dev, SHARD_MESH, ("data", "model")))
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        params = PRM.init_tree(T.model_spec(cfg),
                               torch.Generator(dev).manual_seed(0),
                               torch.float32, dev)
        placed = ST.place_params(cfg, params, rules)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    opt = O.adamw()
    state = opt.init(placed)
    step = ST.make_train_step(cfg, opt, lr=LM_LR, rules=rules,
                              compute_dtype=torch.float32)
    batch = lm_batch(torch, dev, cfg, seed=0)
    counters = all_counters()
    for c in counters.values():
        c.reset()
    losses = []

    def run():
        nonlocal placed, state
        placed, state, m = step(placed, state, batch)
        losses.append(m["total_loss"].item())
    run()
    launches = _counted(counters)
    times = _time_steps(torch, run, SHARD_TIMED)
    out = {"layers": cfg.n_layers, "mesh": list(SHARD_MESH),
           "sharded_step_ms": statistics.median(times),
           "step_ms_timed": times,
           "tokens_per_s": LM_BATCH * LM_SEQ / statistics.median(times)
           * 1e3,
           "sharded_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "losses": losses, "launches": launches,
           "launches_expected": sharded_launches_per_step(cfg, SHARD_MESH)}
    prof = profile_window(torch, run, min(times) / 1e3)
    out["sharded_busy_share"] = prof["device_busy_share"]
    out["sharded_profile"] = prof
    log(f"{cfg.arch_id} {cfg.n_layers} layers, sharded training step "
        f"alone on a {SHARD_MESH} data x model mesh of {dev} ({card}): "
        + json.dumps(out))
    del placed, state, step
    gc.collect()
    torch.cuda.empty_cache()
    if launches != out["launches_expected"]:
        raise AssertionError(f"the full-depth sharded step launched "
                             f"{launches}, expected "
                             f"{out['launches_expected']}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"sharded training losses {losses}")
    return out


def sharded_prefill_check(torch, dev, cfg, card: str, mesh,
                          fallback: str | None = None,
                          float64_reference: bool = False,
                          seq_split: bool = False) -> dict:
    """Phases 12c, 12g and 12j, and with ``seq_split`` 12m (12j's
    internvl2): ``make_prefill_step`` of ``cfg`` on a ``mesh`` (data,
    model) of this card against the unsharded step on the same params
    (seed 0) and batch (``lm_batch`` without its labels: (4, 512)
    tokens, whisper's (4, 448) with their frames, internvl2's behind
    their patches): the last position's logits within 1e-5 of their
    largest, two sharded runs the same to the bit, launches exact, the
    rules' fallbacks (one naming ``fallback`` where it is given);
    prefill ms of both (median of SHARD_TIMED), peak memory, a profiled
    sharded prefill's busy share. With ``seq_split`` the sharded
    prefill runs again under rules that split the sequence over
    ``model`` (``seq_rules``), on the same placed params and held to the
    same reference with the same gates, its launches equal to the
    unsplit prefill's; its numbers under ``seq_split`` and the residual
    stream's bytes a position holds between layers with and without the
    split (``stream_bytes``). With ``float64_reference`` the logits are
    held to the unsharded step run in float64 (params cast, the plain
    versions of the kernels): where the f32 unsharded step's own
    rounding is near 1e-5 of the largest logit (rwkv6-7b's at 16
    layers), a sharded step as accurate as it cannot be held to it
    within 1e-5; both f32 steps' distances to it, and to each other, are
    logged."""
    from repro_torch.launch import steps as ST
    from repro_torch.sharding.rules import MeshRules
    params = draw_params(torch, dev, cfg)
    batch = {k: v for k, v in lm_batch(torch, dev, cfg, seed=0).items()
             if k != "labels"}
    step_u = ST.make_prefill_step(cfg, None, torch.float32)
    exp = step_u(params, batch)
    t_u = _time_steps(torch, lambda: step_u(params, batch), SHARD_TIMED)
    exp32 = exp
    if float64_reference:
        from repro_torch.models import params as PRM
        with torch.no_grad():
            p64 = PRM.tree_map(lambda t: t.double(), params)
        with plain_versions():
            exp = ST.make_prefill_step(cfg, None, torch.float64)(p64, batch)
        del p64
        gc.collect()
        torch.cuda.empty_cache()
    grid = repeated_mesh(dev, mesh, ("data", "model"))
    rules = MeshRules(grid)
    with torch.no_grad():
        placed = ST.place_params(cfg, params, rules)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    want = sharded_launches_per_step(cfg, mesh, train=False)
    counters = all_counters()

    def rel(a, e):
        return ((a.double() - e.double()).abs().max()
                / e.double().abs().max()).item()

    def side(rules) -> tuple:
        step_s = ST.make_prefill_step(cfg, rules, torch.float32)
        for c in counters.values():
            c.reset()
        torch.cuda.reset_peak_memory_stats()
        got = step_s(placed, batch)
        launches = _counted(counters)
        again = step_s(placed, batch)
        torch.cuda.synchronize()
        t_s = _time_steps(torch, lambda: step_s(placed, batch), SHARD_TIMED)
        out = {"logits_rel_err": rel(got, exp),
               "two_runs_same_bits": torch.equal(got, again),
               "finite": bool(torch.isfinite(got).all()),
               "fallbacks": rules.fallbacks,
               "sharded_prefill_ms": statistics.median(t_s),
               "sharded_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "launches": launches,
               "stream_bytes_per_position": stream_bytes(
                   torch, cfg, rules, batch)}
        prof = profile_window(torch, lambda: step_s(placed, batch),
                              min(t_s) / 1e3)
        out["sharded_busy_share"] = prof["device_busy_share"]
        out["sharded_profile"] = prof
        return out, got

    got_side, got = side(rules)
    out = {"layers": cfg.n_layers, "mesh": list(mesh),
           "shape": list(train_text_shape(cfg)),
           "reference": "unsharded, float64, plain versions"
           if float64_reference else "unsharded, float32, kernels",
           "unsharded_prefill_ms": statistics.median(t_u),
           **got_side, "launches_expected": want}
    if float64_reference:
        out["sharded_vs_unsharded_f32_rel_err"] = rel(got, exp32)
        out["unsharded_f32_vs_float64_rel_err"] = rel(exp32, exp)
    del got
    sides = [got_side]
    if seq_split:
        rules_seq = seq_rules(grid)
        out["seq_split"], _ = side(rules_seq)
        sides.append(out["seq_split"])
    split = " and with the sequence split (act_rules['seq'])" \
        if seq_split else ""
    log(f"{cfg.arch_id} {cfg.n_layers} layers, sharded prefill on a "
        f"{mesh} data x model mesh of {dev}{split} vs unsharded "
        f"({card}): " + json.dumps(out))
    del placed, exp, exp32
    gc.collect()
    torch.cuda.empty_cache()
    for got in sides:
        if got["launches"] != want:
            raise AssertionError(f"the sharded prefill launched "
                                 f"{got['launches']}, expected {want}")
        if not (got["logits_rel_err"] <= 1e-5 and got["two_runs_same_bits"]
                and got["finite"]):
            raise AssertionError("the sharded prefill disagrees with the "
                                 "unsharded one, or with itself")
    if not (fallback is None or any(fallback in f for f in rules.fallbacks)):
        raise AssertionError(f"no fallback naming {fallback}: "
                             f"{rules.fallbacks}")
    return out


def shard_attention_shapes(cfg, mesh):
    """q and k/v of the attention kernel's call in a row's and model
    position's share of a (LM_BATCH, LM_SEQ) step on a (data, model)
    ``mesh``: the batch over data, the q heads over model, and the KV
    heads that position's q heads read (``kv_heads_of``: a split's share,
    or, where the KV heads fall back to replication, the few that serve,
    as ``self_attention_sharded`` passes them)."""
    from repro_torch.models.attention import kv_heads_of
    rows, model = mesh
    b, h = LM_BATCH // rows, cfg.eff_heads // model
    lo, hi, idx = kv_heads_of(cfg.eff_heads, cfg.n_kv_heads, h, 0)
    kvh = hi - lo if idx is None else h
    return ((b, h, LM_SEQ, cfg.head_dim), (b, kvh, LM_SEQ, cfg.head_dim))


def sharded_shapes(cfg):
    """q, k/v and the grouped matmul's shapes of a row's and model
    position's share of a (LM_BATCH, LM_SEQ) training step on
    SHARD_MESH: the batch over data, the heads and the experts over
    model, the capacity the global batch's."""
    from repro_torch.models import moe
    model = SHARD_MESH[1]
    c = moe._capacity(LM_BATCH * LM_SEQ, cfg)
    e, d, f = cfg.moe.num_experts // model, cfg.d_model, cfg.moe.d_expert
    return (*shard_attention_shapes(cfg, SHARD_MESH),
            [("gate_up", (e, c, d, f)), ("down", (e, c, f, d))])


# the models of phases 12d-12f, trained on SHARD_MESH
MIXER_SHARD_TAGS = ("rwkv6", "jamba", "deepseek")


def mla_shard_config():
    """deepseek-v2-lite-16b at full width, cut in depth 27 ->
    SHARD_MLA_LAYERS: its dense prefix layer and three MoE layers."""
    cfg = dataclasses.replace(mla_config(), n_layers=SHARD_MLA_LAYERS)
    assert (cfg.optimizer, cfg.remat_policy, cfg.n_repeats) == \
        ("adamw", "minimal", SHARD_MLA_LAYERS - 1)
    return cfg


def mixer_shard_shapes(cfg, mesh) -> dict:
    """A row's and model position's share of a (LM_BATCH, LM_SEQ) step
    of ``cfg`` on a (data, model) ``mesh``, by kernel: the WKV's (b, h,
    s, dh), the scan's (b, s, di, n), MLA's attention q and k/v (b, h,
    s, nope + rope; v of v_head_dim padded to it), the grouped matmul's
    (name, (e, c, d, f)) at the global batch's capacity."""
    from repro_torch.models import moe
    rows, model = mesh
    b = LM_BATCH // rows
    out = {}
    mixers = {m for m, _ in cfg.prefix_pattern + cfg.block_pattern}
    if "rwkv" in mixers:
        out["wkv"] = (b, mixer_split(cfg, "rwkv") // model, LM_SEQ,
                      cfg.rwkv.head_dim)
    if "mamba" in mixers:
        out["scan"] = (b, LM_SEQ, mixer_split(cfg, "mamba") // model,
                       cfg.mamba.d_state)
    if cfg.attention == "mla":
        a = cfg.mla
        qs = (b, cfg.eff_heads // model, LM_SEQ,
              a.nope_head_dim + a.rope_head_dim)
        out["attention"] = (qs, qs)
    if cfg.moe is not None:
        c = moe._capacity(LM_BATCH * LM_SEQ, cfg)
        e, d, f = cfg.moe.num_experts // model, cfg.d_model, \
            cfg.moe.d_expert
        out["gmm"] = [("gate_up", (e, c, d, f)), ("down", (e, c, f, d))]
    return out


def mixer_shards(torch, dev, card: str) -> dict:
    """Phases 12d-12g and 12l: each kernel at its shard's shape
    (``recurrence_at``, ``path_kernels``), then rwkv6-7b (also with the
    sequence split, 12l), the jamba cut and deepseek trained on
    SHARD_MESH against their unsharded steps (``sharded_train_check``)
    and rwkv6-7b's prefill on SHARD_RWKV_PREFILL_MESH
    (``sharded_prefill_check``)."""
    rwkv, jamba, mla = (rwkv_train_config(), jamba_train_config(),
                        mla_shard_config())
    rwkv_pre = dataclasses.replace(zoo_config(),
                                   n_layers=SHARD_RWKV_PREFILL_LAYERS)
    out = {}
    sh = mixer_shard_shapes(rwkv, SHARD_MESH)
    out["kernels_rwkv6"] = {"wkv": recurrence_at(
        torch, dev, "rwkv6_wkv", sh["wkv"], "rwkv6 shard", card, 64)}
    out["kernels_rwkv6"]["wkv_prefill"] = recurrence_at(
        torch, dev, "rwkv6_wkv",
        mixer_shard_shapes(rwkv_pre, SHARD_RWKV_PREFILL_MESH)["wkv"],
        "rwkv6 prefill shard", card, 65, bwd=False)
    mark("phase 12d, 12g WKV at the shard shapes")
    sh = mixer_shard_shapes(jamba, SHARD_MESH)
    out["kernels_jamba"] = {
        "scan": recurrence_at(torch, dev, "selective_scan", sh["scan"],
                              "jamba shard", card, 66),
        # ~1 TFLOP a call: few repetitions
        **path_kernels(torch, dev, jamba, card, None, None, sh["gmm"],
                       "jamba shard", 67, gmm_timing=dict(reps=2,
                                                          trials=3))}
    mark("phase 12e scan and gmm at the shard shapes")
    sh = mixer_shard_shapes(mla, SHARD_MESH)
    # the SIMT kernels at head dim 192, the gmm at ~1 ms: fewer
    # repetitions
    out["kernels_deepseek"] = path_kernels(
        torch, dev, mla, card, *sh["attention"], sh["gmm"], "deepseek shard",
        68, dv=v_head_dim(mla), att_timing=dict(reps=10, trials=5),
        gmm_timing=dict(reps=20, trials=5))
    mark("phase 12f attention and gmm at the shard shapes")
    for phase, tag, cfg in zip(("12d", "12e", "12f"), MIXER_SHARD_TAGS,
                               (rwkv, jamba, mla)):
        # 12l: rwkv6-7b's step with the sequence split too, held to 12d's
        # reference (the token shift and WKV across a cell boundary)
        out[tag] = sharded_train_check(torch, dev, cfg, card,
                                       seq_split=tag == "rwkv6")
        if tag == "rwkv6":
            log_seq_split("12l", out[tag], card)
        mark(f"phase {phase} {tag}" + (", 12l" if tag == "rwkv6" else ""))
    # the f32 unsharded step's own rounding is ~1.2e-5 of the largest
    # logit at 16 layers (PERF.md): the reference is float64
    out["rwkv6_prefill"] = sharded_prefill_check(
        torch, dev, rwkv_pre, card, SHARD_RWKV_PREFILL_MESH,
        float64_reference=True)
    mark("phase 12g rwkv6 prefill")
    return out


def enc_vlm_shard_config():
    """internvl2-76b at full width, cut in depth 80 ->
    SHARD_INTERNVL_LAYERS: its one layer, the untied embed and head;
    its Adafactor and remat policy."""
    cfg = dataclasses.replace(internvl_train_config(),
                              n_layers=SHARD_INTERNVL_LAYERS)
    assert (cfg.optimizer, cfg.remat_policy, cfg.n_repeats) == \
        ("adafactor", "minimal", SHARD_INTERNVL_LAYERS)
    return cfg


def enc_vlm_shard_shapes(whisper, internvl) -> dict:
    """name -> (q, k/v, causal) of the attention kernel's calls in a
    row's and model position's share of a SHARD_MESH training step:
    whisper's (4, 448) tokens and 1,500 frames, internvl2's 256 patches
    before (4, 512) tokens; the batch over data, the heads (whisper's 20,
    internvl2's 64 q and 8 KV heads) over model."""
    rows, model = SHARD_MESH
    b_w, s_w = train_text_shape(whisper)
    b_w, h_w, n_f = b_w // rows, whisper.eff_heads // model, \
        whisper.encoder.n_frames
    dh = whisper.head_dim
    b_i, s_i = train_text_shape(internvl)
    b_i, s_i = b_i // rows, s_i + vision_prefix(internvl)
    return {
        "whisper_encoder": ((b_w, h_w, n_f, dh), (b_w, h_w, n_f, dh), False),
        "whisper_decoder_self": ((b_w, h_w, s_w, dh), (b_w, h_w, s_w, dh),
                                 True),
        "whisper_cross": ((b_w, h_w, s_w, dh), (b_w, h_w, n_f, dh), False),
        "internvl2": ((b_i, internvl.eff_heads // model, s_i,
                       internvl.head_dim),
                      (b_i, internvl.n_kv_heads // model, s_i,
                       internvl.head_dim), True)}


def internvl_prefill_shard_shapes(cfg) -> tuple:
    """q and k/v of the attention kernel's call in a row's and model
    position's share of internvl2's prefill on
    SHARD_ENC_VLM_PREFILL_MESH (phases 12j and 12m: with the sequence
    split or without, each position attends over its row whole): 256
    patches before 512 tokens, its 64 q and 8 KV heads over model."""
    rows, model = SHARD_ENC_VLM_PREFILL_MESH
    b, s = train_text_shape(cfg)
    b, s = b // rows, s + vision_prefix(cfg)
    return ((b, cfg.eff_heads // model, s, cfg.head_dim),
            (b, cfg.n_kv_heads // model, s, cfg.head_dim))


# the models of phases 12h-12j
ENC_VLM_SHARD_TAGS = ("whisper", "internvl2")


def enc_vlm_shards(torch, dev, card: str) -> dict:
    """Phases 12h-12j and 12m: the attention kernel, forward and
    backward, at whisper's and internvl2's shard shapes
    (``enc_vlm_shard_shapes``, through ``path_kernels``), forward at
    internvl2's prefill shard (``internvl_prefill_shard_shapes``), then
    whisper at WHISPER_CHECK_LAYERS +
    WHISPER_CHECK_LAYERS layers (AdamW) and internvl2 at
    SHARD_INTERNVL_LAYERS (Adafactor at INTERNVL_TRAIN_LR) trained on
    SHARD_MESH against their unsharded steps (``sharded_train_check``),
    and both models' prefill on SHARD_ENC_VLM_PREFILL_MESH
    (``sharded_prefill_check``): whisper at full depth, its vocab
    falling back on model 4, internvl2 at INTERNVL_TRAIN_LAYERS, also
    with the sequence split (12m)."""
    _, whisper = whisper_train_configs()
    internvl = enc_vlm_shard_config()
    out = {"kernels": {}}
    # the tensor-core kernels at 448-1,500 keys: fewer repetitions
    timing = dict(reps=20, trials=5)
    for i, (name, (qs, ks, causal)) in enumerate(
            enc_vlm_shard_shapes(whisper, internvl).items()):
        cfg = whisper if name.startswith("whisper") else internvl
        out["kernels"][name] = path_kernels(
            torch, dev, cfg, card, qs, ks, [], f"{name} shard", 69 + i,
            att_timing=timing, causal=causal)
    # the forward at internvl2's prefill shard (12j, 12m)
    out["kernels_prefill"] = path_kernels(
        torch, dev, internvl, card,
        *internvl_prefill_shard_shapes(internvl_train_config()), [],
        "internvl2 prefill shard", 73, bwd=False, att_timing=timing)
    mark("phase 12h, 12i, 12j attention at the shard shapes")
    out["whisper"] = sharded_train_check(torch, dev, whisper, card)
    mark("phase 12h whisper")
    out["internvl2"] = sharded_train_check(torch, dev, internvl, card,
                                           INTERNVL_TRAIN_LR)
    mark("phase 12i internvl2")
    out["whisper_prefill"] = sharded_prefill_check(
        torch, dev, whisper_config(), card, SHARD_ENC_VLM_PREFILL_MESH,
        "vocab")
    # 12m: internvl2's prefill with the sequence split too (256 patches
    # and 512 tokens, 192 positions a cell: the prefix spans cells 0 and
    # 1), held to 12j's reference
    out["internvl2_prefill"] = sharded_prefill_check(
        torch, dev, internvl_train_config(), card,
        SHARD_ENC_VLM_PREFILL_MESH, seq_split=True)
    log_seq_split("12m", out["internvl2_prefill"], card)
    mark("phase 12j whisper and internvl2 prefill, 12m")
    return out


def sharded_steps_phase(torch, dev) -> tuple:
    """Phase 12: the zoo's train and prefill steps on meshes of more
    than one device, every position on this card (``cuda:0`` repeated:
    every split, gather, partial product and reduce-scatter runs, one
    process, no ``torch.distributed``), 12k-12m with the sequence split
    too. Returns (the launches of the counted runs, the measured
    numbers)."""
    t_phase = time.perf_counter()
    card = gpu_line()
    log(f"sharded steps phase: every mesh position on {dev} repeated "
        f"({card})")
    granite = moe_config()
    qs, ks, gmm_shapes = sharded_shapes(granite)
    out = {"kernels": path_kernels(torch, dev, granite, card, qs, ks,
                                   gmm_shapes, "granite shard", 61)}
    # h2o-danube's share (dh 80, its window passed as the path passes
    # it) forward and backward; glm4's prefill share, one replicated KV
    # head serving a position's 8 q heads at dh 128, forward
    h2o = h2o_config()
    from repro_torch.configs import get_config
    glm4 = dataclasses.replace(get_config("glm4-9b"),
                               n_layers=SHARD_GLM4_LAYERS)
    out["kernels_h2o"] = path_kernels(
        torch, dev, h2o, card, *shard_attention_shapes(h2o, SHARD_MESH), [],
        "h2o-danube shard", 62, window=h2o.window)
    out["kernels_glm4"] = path_kernels(
        torch, dev, glm4, card, *shard_attention_shapes(glm4,
                                                        SHARD_GLM4_MESH),
        [], "glm4 prefill shard", 63, bwd=False)
    mark("phase 12 kernels at the shard shapes")
    # 12k: the same step with the sequence split too, held to 12a's
    # reference (attention, the global dispatch over gathered rows, the
    # vocab-split loss)
    out["granite"] = sharded_train_check(
        torch, dev, dataclasses.replace(granite,
                                        n_layers=SHARD_CMP_LAYERS), card,
        seq_split=True)
    log_seq_split("12k", out["granite"], card)
    mark("phase 12a granite compared, 12k")
    log(f"phase 12a: granite alone at {SHARD_ALONE_LAYERS} of "
        f"{granite.n_layers} layers (16 before phases 12h-12j: cut to keep "
        f"the script's time)")
    out["granite_full"] = sharded_train_alone(
        torch, dev, dataclasses.replace(granite,
                                        n_layers=SHARD_ALONE_LAYERS), card)
    mark(f"phase 12a granite at {SHARD_ALONE_LAYERS} layers")
    log(f"phase 12b: h2o-danube at {SHARD_H2O_LAYERS} of {h2o.n_layers} "
        f"layers (all {h2o.n_layers} before phases 12h-12j, 12 before "
        f"phases 12k-12m: cut to keep the script's time)")
    out["h2o"] = sharded_train_check(
        torch, dev, dataclasses.replace(h2o, n_layers=SHARD_H2O_LAYERS),
        card)
    mark("phase 12b h2o-danube")
    out["glm4"] = sharded_prefill_check(torch, dev, glm4, card,
                                        SHARD_GLM4_MESH, "kv_heads")
    mark("phase 12c glm4 prefill")
    out.update(mixer_shards(torch, dev, card))
    ev = enc_vlm_shards(torch, dev, card)
    out["kernels_enc_vlm"] = ev.pop("kernels")
    out["kernels_internvl2_prefill"] = ev.pop("kernels_prefill")
    out.update(ev)
    launches = {
        "sharded_granite_train": {k: v for k, v in out["granite_full"][
            "launches"].items() if v},
        "sharded_granite_train_compared": {k: v for k, v in out["granite"][
            "launches"].items() if v},
        "sharded_h2o_train": {k: v for k, v in out["h2o"][
            "launches"].items() if v},
        "sharded_glm4_prefill": {k: v for k, v in out["glm4"][
            "launches"].items() if v},
        **{f"sharded_{tag}_train": {k: v for k, v in out[tag][
            "launches"].items() if v} for tag in MIXER_SHARD_TAGS},
        "sharded_rwkv6_prefill": {k: v for k, v in out["rwkv6_prefill"][
            "launches"].items() if v},
        **{f"sharded_{tag}_train": {k: v for k, v in out[tag][
            "launches"].items() if v} for tag in ENC_VLM_SHARD_TAGS},
        **{f"sharded_{tag}_prefill": {k: v for k, v in out[
            f"{tag}_prefill"]["launches"].items() if v}
           for tag in ENC_VLM_SHARD_TAGS},
        # phases 12k-12m: the same steps with the sequence split
        **{f"sharded_{key}_seq_split": {k: v for k, v in out[key][
            "seq_split"]["launches"].items() if v}
           for key in ("granite", "rwkv6", "internvl2_prefill")}}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"sharded steps phase: {out['seconds']:.1f} s; {card}")
    return launches, out


# ---------------------------------------------------------------------------
# phase 13: the dry-run's trace (``launch/dryrun.py``: the step run under
# FakeTensorMode on a mesh of fake devices, nothing allocated, nothing
# launched) of the steps phase 12 measured, on the host, held to those
# measurements: 12a's granite unsharded and on data 2 x model 2, 12k's
# with the sequence split, 12d's and 12l's rwkv6-7b, each mesh on
# ``meta:0`` repeated as phase 12's is on this card repeated, in f32
# ---------------------------------------------------------------------------

# how far a trace's peak above its start may miss the measured rise of
# the allocated bytes over one step
DRYRUN_PEAK_SHARE = 0.05
# the phase's host time; a trace that starts after half of it traces one
# and two layers and extrapolates (logged)
DRYRUN_BUDGET_S = 90.0
# (e, c, d, f) of grouped matmuls whose plan the gmm's trace route makes
# in Python: decode sizes (a d split) and a training size
GMM_PLAN_SHAPES = [(40, 4, 1536, 512), (40, 4, 512, 1536), (4, 4, 8192, 128),
                   (2, 16, 24576, 8192), (16, 1, 8192, 4096),
                   (40, 512, 1536, 512)]


def dryrun_phase(torch, dev, steps: dict) -> dict:
    """Phase 13: each traced step's kernel calls equal its phase's
    counted launches and ``sharded_launches_per_step``, exactly; the
    bytes it starts from (params, AdamW slots, the batch) equal those
    the card held, exactly; its peak above its start is within
    DRYRUN_PEAK_SHARE of the card's measured rise over one step; its
    largest roofline term (``launch/dryrun.py``'s datasheet rates, one
    card, f32) is at most the measured step time. Also the gmm trace
    route's plan against the kernel's, and the card's memory and SMs
    (the dry-run's ``HBM_BYTES``). Raises with every miss."""
    from repro_torch.configs.base import InputShape
    from repro_torch.kernels import _build
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.sharding.rules import MeshRules
    t_phase = time.perf_counter()
    card = gpu_line()
    props = torch.cuda.get_device_properties(dev)
    log(f"phase 13: {props.name} total_memory {props.total_memory} bytes "
        f"(launch/dryrun.py HBM_BYTES {D.HBM_BYTES}), "
        f"{props.multi_processor_count} SMs; {card}")
    misses = []
    lib = _build.library()
    with torch.cuda.device(dev):
        plans = {str(s): (gmm.plan(*s, props.multi_processor_count),
                          gmm._plan(lib, *s)) for s in GMM_PLAN_SHAPES}
    misses += [f"gmm plan {s}: traced {a}, the kernel's {b}"
               for s, (a, b) in plans.items() if a != b]
    granite = dataclasses.replace(moe_config(), n_layers=SHARD_CMP_LAYERS)
    rwkv = rwkv_train_config()
    mesh = make_local_mesh(*SHARD_MESH, devices=["meta:0"] * 4)
    cases = [("12a unsharded", granite, None, steps["granite"], "unsharded"),
             ("12a", granite, MeshRules(mesh), steps["granite"], "sharded"),
             ("12k", granite, seq_rules(mesh),
              steps["granite"]["seq_split"], "sharded"),
             ("12d", rwkv, MeshRules(mesh), steps["rwkv6"], "sharded"),
             ("12l", rwkv, seq_rules(mesh), steps["rwkv6"]["seq_split"],
              "sharded")]
    out = {"gmm_plans": plans, "card": card,
           "total_memory": props.total_memory}
    for phase, cfg, rules, got, side in cases:
        b, s = train_text_shape(cfg)
        shape = InputShape(f"phase {phase}", s, b, "train")
        full = time.perf_counter() - t_phase < DRYRUN_BUDGET_S / 2
        t = D.depth_trace(cfg, shape, rules, torch.float32, full_depth=full)
        calls = {k: v for k, v in t["kernel_calls"].items() if v}
        counted = {k: v for k, v in got[
            "unsharded_launches" if side == "unsharded" else "launches"
        ].items() if v}
        want = {k: v for k, v in sharded_launches_per_step(
            cfg, (1, 1) if rules is None else SHARD_MESH).items() if v}
        rise = t["peak"][0] - t["start"][0]
        measured = got[f"{side}_rise_bytes"]
        rf = D.roofline(cfg, shape, t["collectives"], 1, torch.float32)
        top = max(rf[k] for k in ("compute_s", "memory_s", "collective_s"))
        step_s = got[f"{side}_step_ms"] / 1e3
        row = {"traced_layers": t["traced_layers"],
               "trace_s": t["seconds"], "ops": t.get("ops"),
               "kernel_calls": calls, "launches_counted": counted,
               "launches_expected": want,
               "resident_bytes": t["start"][0],
               "resident_bytes_on_card": got[f"{side}_resident_bytes"],
               "rise_bytes": rise, "rise_bytes_on_card": measured,
               "rise_miss": (rise - measured) / measured,
               "roofline": rf, "step_s_on_card": step_s,
               "roofline_over_step": top / step_s}
        out[phase] = row
        log(f"phase 13 {phase}: {cfg.arch_id} {cfg.n_layers} layers traced "
            f"at {t['traced_layers']} in {t['seconds']:.1f} s; calls {calls}"
            f" (counted {counted}); resident {t['start'][0]} B (card "
            f"{row['resident_bytes_on_card']}); rise {rise} B (card "
            f"{measured}, miss {row['rise_miss']:+.4f}); largest roofline "
            f"term {rf['dominant']} {top * 1e3:.1f} ms over the measured "
            f"{step_s * 1e3:.1f} ms: {row['roofline_over_step']:.3f}; {card}")
        if not calls == counted == want:
            misses.append(f"{phase}: traced calls {calls}, counted "
                          f"{counted}, expected {want}")
        if t["start"][0] != row["resident_bytes_on_card"]:
            misses.append(f"{phase}: resident {t['start'][0]} B against "
                          f"{row['resident_bytes_on_card']} on the card")
        if abs(row["rise_miss"]) > DRYRUN_PEAK_SHARE:
            misses.append(f"{phase}: traced rise {rise} B against "
                          f"{measured} on the card")
        if top > step_s:
            misses.append(f"{phase}: roofline {top} s above the measured "
                          f"step {step_s} s")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 13: {out['seconds']:.1f} s of host time (budget "
        f"{DRYRUN_BUDGET_S:.0f} s); {card}")
    if out["seconds"] > DRYRUN_BUDGET_S:
        misses.append(f"the phase took {out['seconds']:.1f} s")
    if misses:
        raise AssertionError("phase 13: " + "; ".join(misses))
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run this "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()
    log(gpu_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda")

    build = build_kernels()
    mark('build')

    errs = check_kernels(torch, dev)
    mark('kernel checks')

    import numpy as np
    t0 = time.perf_counter()
    cfg, master, members = make_slice()
    log(f"vfl-recsys data built in {time.perf_counter() - t0:.1f} s: "
        f"master x {master.x.shape}, y {master.y.shape}, member x "
        f"{members[0].x.shape}")
    counts, rounds, stats, rows, lone, results = serve_slice(
        torch, dev, cfg, master, members)
    plain = plain_scores(torch, dev, cfg, master, members, results, rows)
    # a quantize code may flip by one step where the attention kernel's
    # output differs from the plain version's by an ulp; one step moves
    # a score by about 1e-3, hence the tolerance
    e2e_err = float(np.abs(lone - plain).max())
    log(f"served vs plain-version scores: max_abs_err {e2e_err:.3e} "
        f"(tol 5e-3)")
    if not e2e_err <= 5e-3:
        raise AssertionError("served scores disagree with the plain "
                             "versions")
    default_tower_check(torch, dev, cfg, master, members)
    mark('split-NN serving')

    att, quant = time_kernels(torch, dev)
    mark('split-NN kernel times')

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import rwkv6_wkv as wkv
    from repro_torch.kernels import selective_scan as ssm
    errs["rwkv6_wkv"] = check_wkv(torch, dev)
    zoo_cfg = zoo_config()
    # one WKV launch a layer in prefill; decode's one-step update has none
    zoo_launches, _ = serve_model(
        torch, dev, zoo_cfg, "rwkv6",
        {"rwkv6_wkv": (wkv.launches, zoo_cfg.n_layers, 0)})
    wkv_t = time_wkv(torch, dev)
    mark('rwkv6-7b')

    # the rwkv6-7b weights are freed by now
    moe_cfg = moe_config()
    moe_errs = check_moe_kernels(torch, dev, moe_cfg)
    n = moe_cfg.n_layers      # every layer is (attn, moe): gate, up, down
    moe_launches, _ = serve_model(
        torch, dev, moe_cfg, "granite",
        {"moe_gmm": (gmm.launches, 3 * n, 3 * n),
         "flash_attention": (fa.launches, n, 0)},
        {"grouped": dataclasses.replace(moe_cfg, moe_group_dispatch=True)})
    gmm_t, moe_att = time_moe_kernels(torch, dev, moe_cfg)
    mark('granite-moe serving')

    # the granite-moe weights are freed by now
    h2o_err, h2o_launches, h2o_att = cold_score(torch, dev, h2o_config(),
                                                "h2o", 10)

    t_jamba = time.perf_counter()
    jamba_cfg = jamba_config()
    errs["selective_scan"] = check_scan(torch, dev, jamba_cfg)
    jamba_errs = check_moe_kernels(torch, dev, jamba_cfg,
                                   JAMBA_SCORE_TOKENS, jax_cases=False)
    gc.collect()
    torch.cuda.empty_cache()
    layers = jamba_cfg.block_pattern * jamba_cfg.n_repeats
    n_mamba = sum(mx == "mamba" for mx, _ in layers)
    n_attn = sum(mx == "attn" for mx, _ in layers)
    n_moe = sum(f == "moe" for _, f in layers)
    # a scan launch per Mamba layer and an attention launch per attention
    # layer in prefill, none in decode; gate, up, down per MoE layer in
    # both
    jamba_launches, _ = serve_model(
        torch, dev, jamba_cfg, "jamba",
        {"selective_scan": (ssm.launches, n_mamba, 0),
         "moe_gmm": (gmm.launches, 3 * n_moe, 3 * n_moe),
         "flash_attention": (fa.launches, n_attn, 0)},
        score_tokens=JAMBA_SCORE_TOKENS)
    scan_t = time_scan(torch, dev, jamba_cfg)
    jamba_gmm_t, jamba_att = time_moe_kernels(
        torch, dev, jamba_cfg, JAMBA_SCORE_TOKENS, dict(reps=2, trials=3))
    log(f"{JAMBA_ARCH} phase: {time.perf_counter() - t_jamba:.1f} s")
    mark('h2o-danube and jamba')

    # the jamba weights are freed by now
    mla_errs, mla_launches, mla = mla_phase(torch, dev)
    mark('MLA')

    # the encoder-decoder: whisper-large-v3 at full width and depth
    whisper_errs, whisper_launches, whisper = whisper_phase(torch, dev)
    mark('whisper')

    # the vision prefix: internvl2-76b at full width, 16 layers
    internvl_err, internvl_launches, internvl = internvl_phase(torch, dev)
    mark('internvl2')

    # last, so that its profiler session comes after every zoo timing
    train_launches, train, thread_losses = train_slice(torch, dev, cfg,
                                                       master, members)
    mark('split-NN training')
    # every party its own process, the other transports, secure
    # aggregation
    mode_launches, modes = demo_modes(torch, dev, cfg, master, members,
                                      thread_losses)
    mark('execution modes')
    # the cluster launcher: TLS, every agent its own process, the elastic
    # restart; the privacy matrix
    n_matched = len(set(master.ids) & set(members[0].ids))
    cluster_launches, cluster = cluster_phase(
        torch, thread_losses, n_matched, master.y.shape[1])
    mark('cluster')

    # language-model training: granite at full width, the backward
    # kernels, AdamW, checkpoints
    lm_launches, lm = lm_train_phase(torch, dev)
    mark('granite training')
    # the recurrences' backward kernels; rwkv6 and jamba trained
    rec_launches, rec = recurrence_train_phase(torch, dev)
    mark('recurrence training')
    # the encoder-decoder and the vision prefix trained: attention's
    # gradient at their shapes, whisper at full depth, internvl2 cut
    ev_launches, ev = enc_vlm_train_phase(torch, dev)
    mark('whisper and internvl2 training')
    # sharding on the device path: the sharded tower, mesh-mode VFL, the
    # sequence-sharded decode and the VFL x LLM example, every mesh
    # position on this card
    shard_launches, shard = sharding_phase(torch, dev)
    mark('sharding')
    # the zoo's train and prefill steps on meshes of more than one
    # device: granite, h2o-danube, rwkv6-7b, the jamba cut, deepseek,
    # whisper and internvl2 trained on data 2 x model 2, glm4's,
    # rwkv6-7b's, whisper's and internvl2's prefill on 1 x 4, every mesh
    # position on this card
    steps_launches, steps = sharded_steps_phase(torch, dev)
    mark('sharded train and prefill steps')
    # the dry-run's trace of phase 12's steps, held to what the card
    # measured of them
    dryrun_phase(torch, dev, steps)
    mark('dry-run traces')

    # launches of each kernel on each path's counted run
    by_path = {
        "flash_attention": {"split_nn_serve": counts["flash_attention"]},
        "quantize_int8": {"split_nn_serve": counts["quantize_int8"]},
        "rwkv6_wkv": {}, "moe_gmm": {}, "selective_scan": {},
        "flash_attention_bwd": {}, "rwkv6_wkv_bwd": {},
        "selective_scan_bwd": {}}
    mode_launches["split_nn_cluster"] = cluster_launches
    for run, got in (train_launches | mode_launches).items():
        for name, c in got.items():
            by_path[name][run] = c
    zoo_runs = (zoo_launches | moe_launches | h2o_launches | jamba_launches
                | mla_launches | whisper_launches | internvl_launches
                | lm_launches | rec_launches | ev_launches
                | shard_launches | steps_launches)
    for run, got in zoo_runs.items():
        for name, c in got.items():
            by_path[name][run] = c
    errs["moe_gmm"] = max(moe_errs[name] for name, _ in
                          gmm_path_shapes(moe_cfg))
    errs["flash_attention_bwd"] = max(
        *lm["attention_grad_errs"].values(),
        train["attention_backward"]["max_abs_err"],
        *(t["max_abs_err"] for t in ev["attention_bwd"].values()),
        *(t["attention_bwd"]["max_abs_err"]
          for t in steps["kernels_enc_vlm"].values()))
    for name in ("rwkv6_wkv", "selective_scan"):
        errs[f"{name}_bwd"] = rec["grad"][name]["max_abs_err"]
    extra = {
        # the attention kernel's times at the zoo's prefill shapes
        "flash_attention": {
            "inf_in_v_granite": errs["attention_inf_in_v"],
            "granite_prefill": dict(moe_att,
                                    max_abs_err=moe_errs["attention"]),
            "h2o_prefill": dict(h2o_att, max_abs_err=h2o_err),
            "jamba_prefill": dict(jamba_att,
                                  max_abs_err=jamba_errs["attention"]),
            # MLA: v padded to q/k's head dim; the bound counts the
            # model's own work (p.v at v's head dim)
            "deepseek_prefill": dict(mla["attention"],
                                     max_abs_err=mla_errs["attention"]),
            "minicpm3_prefill": dict(
                mla["minicpm3_attention"],
                max_abs_err=mla_errs["minicpm3_attention"]),
            # whisper: the encoder, cross-attention in prefill and in a
            # decode step, the decoder's causal self-attention
            "whisper": {name: dict(t, max_abs_err=whisper_errs[name])
                        for name, t in whisper["attention"].items()},
            "whisper_encoder_inf_in_v_max_abs_err":
                whisper_errs["encoder_inf_in_v"],
            # internvl2: 256 patches and 512 tokens, 768 positions a row
            "internvl2_prefill": dict(internvl["attention"],
                                      max_abs_err=internvl_err),
            # the sharded bench tower's per-shard shapes, model 2 and 4
            "sharded_tower": shard["tower_shard_attention"],
            # VFL x LLM: granite at full width, B 8, 16 soft tokens
            "vfl_llm": shard["vfl_llm_kernels"]["attention"],
            # a row's and model position's share of granite's training
            # step on a data 2 x model 2 mesh
            "sharded_granite_train": steps["kernels"]["attention"],
            # h2o-danube's share on data 2 x model 2 (dh 80, window
            # 4096), glm4's prefill share on 1 x 4 (8 q heads on the one
            # replicated KV head they read, dh 128)
            "sharded_h2o_train": steps["kernels_h2o"]["attention"],
            "sharded_glm4_prefill": steps["kernels_glm4"]["attention"],
            # MLA's share on data 2 x model 2: 8 heads at head dim 192,
            # v of 128 padded (SIMT)
            "sharded_deepseek_train": steps["kernels_deepseek"][
                "attention"],
            # a row's and model position's share on data 2 x model 2 of
            # whisper's encoder, decoder self- and cross-attention (10
            # heads) and of internvl2's GQA (32 q heads on 4 KV heads)
            **{f"sharded_{name}_train": t["attention"]
               for name, t in steps["kernels_enc_vlm"].items()},
            # internvl2's prefill share on 1 x 4 (16 q heads on 2 KV
            # heads over 768 positions), with the sequence split or not
            "sharded_internvl2_prefill": steps["kernels_internvl2_prefill"][
                "attention"]},
        # the grouped matmul's at each of its four shapes of each MoE
        # model; the top-level times are those of granite's prefill
        # gate/up
        "moe_gmm": {"shapes": gmm_t, "jamba_shapes": {
            name: dict(t, max_abs_err=jamba_errs[name])
            for name, t in jamba_gmm_t.items()},
            "deepseek_shapes": {
                name: dict(t, max_abs_err=mla_errs[name])
                for name, t in mla["gmm"].items()},
            # dx and dw of a training step, through the same kernel
            "train_backward_shapes": lm["gmm_bwd"],
            "train_backward_max_abs_err": lm["gmm_grad_err"],
            # VFL x LLM: forward, dx and dw held at each shape
            "vfl_llm_shapes": {
                name: shard["vfl_llm_kernels"][f"gmm_{name}"]
                for name in ("gate_up", "down")},
            # granite's training step on data 2 x model 2: a model
            # position's 20 experts at the global batch's capacity
            "sharded_granite_train_shapes": {
                name: steps["kernels"][f"gmm_{name}"]
                for name in ("gate_up", "down")},
            # deepseek's 32 experts and the jamba cut's 2 a position
            **{f"sharded_{tag}_train_shapes": {
                name: steps[f"kernels_{tag}"][f"gmm_{name}"]
                for name in ("gate_up", "down")}
               for tag in ("deepseek", "jamba")}},
        # a row's and model position's share: rwkv6's 32 heads in
        # training on data 2 x model 2, 16 in prefill on 1 x 4; jamba's
        # 8,192 channels
        "rwkv6_wkv": {
            "sharded_rwkv6_train": {k: v for k, v in steps[
                "kernels_rwkv6"]["wkv"].items() if k != "bwd"},
            "sharded_rwkv6_prefill": steps["kernels_rwkv6"]["wkv_prefill"]},
        "selective_scan": {
            "sharded_jamba_train": {k: v for k, v in steps[
                "kernels_jamba"]["scan"].items() if k != "bwd"}},
        # max_abs_err: the largest of dq, dk, dv's errors over the
        # largest gradient, at the three checked cases
        "flash_attention_bwd": {
            "grad_errs": lm["attention_grad_errs"],
            "launches_per_train_step": lm["train"]["launches_per_step"][
                "flash_attention_bwd"],
            "routes": lm["attention_grad_routes"],
            "split_nn_tower": train["attention_backward"],
            "vfl_llm": shard["vfl_llm_kernels"]["attention_bwd"],
            "sharded_granite_train": steps["kernels"]["attention_bwd"],
            "sharded_h2o_train": steps["kernels_h2o"]["attention_bwd"],
            # MLA's share at head dim 192: the f32-FMA route
            "sharded_deepseek_train": steps["kernels_deepseek"][
                "attention_bwd"],
            **{f"sharded_{name}_train": t["attention_bwd"]
               for name, t in steps["kernels_enc_vlm"].items()},
            # whisper's encoder, decoder self- and cross-attention and
            # internvl2's GQA at their training shapes
            **ev["attention_bwd"],
            "launches_per_whisper_train_step": ev["whisper"]["train"][
                "launches_per_step"]["flash_attention_bwd"],
            "launches_per_internvl2_train_step": ev["internvl2"]["train"][
                "launches_per_step"]["flash_attention_bwd"]},
        # each gradient's largest difference over its largest magnitude
        # at the path's shape, against the plain VJP in float64
        **{f"{name}_bwd": {
            "grad_rel_errs": rec["grad"][name]["grad_rel_errs"],
            "launches_per_train_step": rec[tag]["train"][
                "launches_per_step"][f"{name}_bwd"],
            # at the shard's shape of the step on data 2 x model 2
            f"sharded_{tag}_train": steps[f"kernels_{tag}"][key]["bwd"]}
           for name, tag, key in (("rwkv6_wkv", "rwkv6", "wkv"),
                                  ("selective_scan", "jamba", "scan"))}}
    kernels = []
    for name, src, replaces, t in (
            ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:69", att),
            ("quantize_int8", "src/repro_torch/csrc/quantize.cu",
             "src/repro/kernels/quantize.py:29", quant),
            ("rwkv6_wkv", "src/repro_torch/csrc/rwkv6_wkv.cu",
             "src/repro/kernels/rwkv6_wkv.py:48", wkv_t),
            ("moe_gmm", "src/repro_torch/csrc/moe_gmm.cu",
             "src/repro/kernels/moe_gmm.py:39", gmm_t["prefill_gate_up"]),
            ("selective_scan", "src/repro_torch/csrc/selective_scan.cu",
             "src/repro/kernels/selective_scan.py:51", scan_t),
            ("flash_attention_bwd",
             "src/repro_torch/csrc/flash_attention_bwd.cu",
             "src/repro/kernels/flash_attention.py:69", lm["attention_bwd"]),
            ("rwkv6_wkv_bwd", "src/repro_torch/csrc/rwkv6_wkv_bwd.cu",
             "src/repro/kernels/rwkv6_wkv.py:48",
             rec["times"]["rwkv6_wkv_bwd"]),
            ("selective_scan_bwd",
             "src/repro_torch/csrc/selective_scan_bwd.cu",
             "src/repro/kernels/selective_scan.py:51",
             rec["times"]["selective_scan_bwd"])):
        per_train_round = {
            f"depth{d}": train[f"depth{d}"]["launches_per_round"].get(name, 0)
            for d in (1, 2)}
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": sum(by_path[name].values()),
                        "launches_by_path": by_path[name],
                        "launches_per_train_round": per_train_round,
                        "max_abs_err": errs[name], **t,
                        **extra.get(name, {})})
    per_round = {k: counts[k] / rounds
                 for k in ("flash_attention", "quantize_int8")}
    log(f"rounds {rounds}; launches per round {per_round}; training "
        f"rounds/s {train['depth1']['rounds_per_s']:.1f} (depth 1), "
        f"{train['depth2']['rounds_per_s']:.1f} (depth 2); socket_proc "
        f"{modes['socket_proc_d1']['rounds_per_s']:.1f} (depth 1), "
        f"{modes['socket_proc_d2']['rounds_per_s']:.1f} (depth 2); cluster "
        f"{cluster['published_scale']['rounds_per_s']:.1f}; granite "
        f"training {lm['train']['step_ms']:.1f} ms a step, "
        f"{lm['train']['tokens_per_s']:.1f} tokens/s, peak "
        f"{lm['train']['peak_gb']:.2f} GB; whisper encode "
        f"{whisper['served']['encode_ms']:.1f} ms, prefill "
        f"{whisper['served']['prefill_tok_s']:.1f} tokens/s, decode "
        f"{whisper['served']['decode_tok_s']:.1f} tokens/s; internvl2 "
        f"prefill {internvl['served']['prefill_tok_s']:.1f} tokens/s, decode "
        f"{internvl['served']['decode_tok_s']:.1f} tokens/s; rwkv6 training "
        f"{rec['rwkv6']['train']['step_ms']:.1f} ms a step, jamba "
        f"{rec['jamba']['train']['step_ms']:.1f} ms; whisper training "
        f"{ev['whisper']['train']['step_ms']:.1f} ms a step, internvl2 "
        f"({INTERNVL_TRAIN_LAYERS} layers) "
        f"{ev['internvl2']['train']['step_ms']:.1f} ms; VFL x LLM "
        f"{shard['vfl_llm']['step_ms']:.1f} ms a step; mesh-mode VFL "
        f"{shard['mesh_vfl']['masked_step_ms']:.1f} ms a step; sharded "
        f"decode {shard['sharded_decode']['sharded_step_ms']:.1f} ms a "
        f"step; on data 2 x model 2 granite training "
        f"{steps['granite_full']['sharded_step_ms']:.1f} ms a step "
        f"({SHARD_ALONE_LAYERS} "
        f"layers; {steps['granite']['sharded_step_ms']:.1f} against "
        f"{steps['granite']['unsharded_step_ms']:.1f} unsharded at "
        f"{SHARD_CMP_LAYERS}), h2o-danube ({SHARD_H2O_LAYERS} layers) "
        f"{steps['h2o']['sharded_step_ms']:.1f} against "
        f"{steps['h2o']['unsharded_step_ms']:.1f}; glm4 prefill on 1 x 4 "
        f"{steps['glm4']['sharded_prefill_ms']:.1f} against "
        f"{steps['glm4']['unsharded_prefill_ms']:.1f} ms "
        f"({SHARD_GLM4_LAYERS} layers); rwkv6-7b "
        f"({RWKV_TRAIN_LAYERS} layers) {steps['rwkv6']['sharded_step_ms']:.1f}"
        f" against {steps['rwkv6']['unsharded_step_ms']:.1f}, the jamba cut "
        f"{steps['jamba']['sharded_step_ms']:.1f} against "
        f"{steps['jamba']['unsharded_step_ms']:.1f}, deepseek "
        f"({SHARD_MLA_LAYERS} layers) "
        f"{steps['deepseek']['sharded_step_ms']:.1f} against "
        f"{steps['deepseek']['unsharded_step_ms']:.1f}; rwkv6-7b prefill on "
        f"1 x 4 {steps['rwkv6_prefill']['sharded_prefill_ms']:.1f} against "
        f"{steps['rwkv6_prefill']['unsharded_prefill_ms']:.1f} ms "
        f"({SHARD_RWKV_PREFILL_LAYERS} layers); whisper "
        f"({WHISPER_CHECK_LAYERS} + {WHISPER_CHECK_LAYERS} layers) "
        f"{steps['whisper']['sharded_step_ms']:.1f} against "
        f"{steps['whisper']['unsharded_step_ms']:.1f}, internvl2 "
        f"({SHARD_INTERNVL_LAYERS} layer) "
        f"{steps['internvl2']['sharded_step_ms']:.1f} against "
        f"{steps['internvl2']['unsharded_step_ms']:.1f}; prefill on 1 x 4 "
        f"whisper {steps['whisper_prefill']['sharded_prefill_ms']:.1f} "
        f"against {steps['whisper_prefill']['unsharded_prefill_ms']:.1f}, "
        f"internvl2 ({INTERNVL_TRAIN_LAYERS} layers) "
        f"{steps['internvl2_prefill']['sharded_prefill_ms']:.1f} against "
        f"{steps['internvl2_prefill']['unsharded_prefill_ms']:.1f} ms; with "
        f"the sequence split granite "
        f"{steps['granite']['seq_split']['sharded_step_ms']:.1f}, rwkv6-7b "
        f"{steps['rwkv6']['seq_split']['sharded_step_ms']:.1f}, internvl2 "
        f"prefill "
        f"{steps['internvl2_prefill']['seq_split']['sharded_prefill_ms']:.1f}"
        f" ms; build "
        f"{build}; zoo launches {zoo_runs}; total "
        f"{time.perf_counter() - t_start:.1f} s")
    log(gpu_line())               # again, beside the numbers
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
