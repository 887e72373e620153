#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (trtllm_llama_tpu_torch) on one GPU.

    python3 chip_smoke.py [--layers N]

1. prints the card's name and power limit (nvidia-smi);
2. builds every kernel of the paths from csrc/ (one nvcc per source,
   in parallel) and prints the build time and nvcc's register, shared
   memory and spill report;
3. holds each kernel against its plain PyTorch version on the card at the
   paths' shapes and prints the max error against the stated tolerance,
   the kernel's time, its bound, the plain version's time and one PyTorch
   library call's time where one computes the same function (a yardstick
   only: the port never calls it). Kernels 1 and 6 are checked in every
   format: int8, int4 with g128 and with per-channel scales, and fp8
   (e4m3), stacked at the four projection shapes: the tensor-core GEMV
   (csrc/woq_gemv_tc.cuh) from TC_MIN_ROWS to 16 rows and the one-row
   GEMV below (csrc/woq_gemv.cuh, one launch), with the norm and residual
   options, each call's route held
   by the counters, the two GEMVs timed side by side at 1, 2, 4, 8, 9 and
   16 rows with the path's option (the crossover, TC_MIN_ROWS), the
   tensor-core GEMM at every row count above 16 the paths and serving
   give (64; int8 also serving's admissions and 8192), and the 2-D
   entries (woq_matmul, fp8_matmul) also at the lm_head's shape; at the
   qkv shape the GEMM and the GEMV are timed side by side at 16-8192 rows
   (the crossover), the GEMM once with fp16 activations. Row 6 (W8A8) at its four projection shapes:
   the int8 wgmma GEMM and the dp4a kernel, each forced onto its route,
   bit for bit against the plain version and timed side by side at 1-1024
   rows (the crossover, held against W8A8_GEMM_MIN_ROWS; the GEMM at least
   10x the dp4a kernel's speed at 1024 rows) and the GEMM at 8192 qkv
   rows, beside the bf16 matmul of the dequantized operands and
   torch._int_mm (row-major weight and a column-major copy). The
   attention kernels of the long-context path and of the decode modes
   are checked at its shapes: the streaming prefill
   (row 12) at 8192 rows, a GQA case and an f32 case with a length of 0;
   rows 10 and 12 side by side on the same bf16 inputs at S = 512-8192
   (B=1, 32 heads of 128, full length: which should take prompts past
   prefill_streaming_min_s); row 10 (the wgmma flash tile) at
   the paths' and serving's shapes, S = 150 with a length of 0 among
   them, and row 13 at segment edges, head dims 96 and 256 and fp16;
   the read-only (row 8) and one-launch (row 9) decodes with bf16 and
   int8 caches at S_max 128 and 8320 and at the edges (lengths 0 and S,
   positions 0, S - 1 and past S), beside kernel 3 on the same inputs;
   kernel 3 and row 9 (one split-cache body, csrc/flash_decode.cuh) at the
   edges of the host's split (decode_split) of path 5's 8320-row cache
   (first and last row of a split, 0, S - 1, past S, bs4 ragged 0-8200)
   and of one KV head's 2048 rows (groups 32 and 71), one launch a call,
   and timed side by side at S_max 128 / 1152 / 2048 / 8320 and GQA
   groups 1 / 32 / 71, bf16 and int8 caches, beside SDPA and the bound;
   rows 10 and 12 with Bloom's ALiBi slopes (row 10 at B=1 S=16, at
   the first serving wave and at B=3 S=150 with lengths 150 / 77 / 0, row
   12 at one 3072-row prompt), timed with and
   without slopes beside SDPA with a float mask holding the bias; rows 9
   and 3 at GQA groups of 71 (D=64, Falcon-7B) and 32 (D=128) with one KV
   head; kernels 2 and 3 at each decoder family's head shape (GPT-J 16 x
   256, GPT-NeoX 64 x 96, OPT 32 x 128, Falcon 71:1 x 64) and row 12 at
   head dims 96 and 256; each kernel's float16 instantiation at one
   shape; the SwiGLU prologue of the weight-only and fp8 GEMVs at the
   down projection's shape (x [M, 2 x 11008] -> 4096) in every format at
   M = 1, 4, 9 and 16, with and without the residual (bf16, one fp16 and one
   f32 case); the 2-D W8A8 entry (row 5) at path 7's five shapes, M = 1,
   8, 64 and 923 (dp4a at 1 row, the GEMM from 5 on), per-tensor and
   per-channel weight scales, bit for bit, timed over distinct weights in
   turn (L2-cold); and the five decode probes (rows 15-19; row 18 also
   through the tensor-core GEMV's pair decoders into bf16 and fp16),
   exhaustive and bit for bit; row 14 (the split-cache body through the
   block table) at serving's shapes, block sizes 8-96, a position at
   MB * BS and path 5's length through a shuffled table, beside kernel 3
   on the same rows stored dense; row 7 at the paths' rows, Task A's 1024
   and D = 1000, one launch a call. Kernel 3, rows 8, 9 and 14 are held
   so on bf16, int8 and e4m3 (fp8) caches (the decode checks take a cache
   kind), the e4m3 ones at S_max 128 pos 45, Task A's 1152 rows, path 5's
   8320 / 8201, serving's B=9 BS=64 MB=4 and a GQA group of 4, the written
   codes bit for bit; kernel 3 and row 9 are timed side by side on the
   three kinds in one table (S_max 128 / 1152 / 2048 / 8320, groups 1 /
   32 / 71); and the e4m3 KV codec probe (KVCodec and load_raw of the
   decode kernels) bit for bit against ops/fp8.py at scales 1 and 0.05;
4. drives each path through GenerationSession.generate with random weights
   born quantized (seed 0), at LLaMA-7B's widths (paths 3 and 4
   SHORT_DEPTH layers deep, the time budget; paths 1, 2 and 8 at full
   depth):
   path 1, int8 weight-only per-channel; path 2, SmoothQuant W8A8
   (per-token activation, per-channel weight scales) with an int8 KV cache
   (scale 0.05 per layer); path 3, int4 weight-only with g128 scales and
   an int4 per-channel lm_head; path 4, fp8 projections and an fp8
   lm_head (both lm_heads made by quantize_params from the random bf16
   one); path 8, bench.py's fp8kv: path 4's weights with an e4m3 KV cache
   (scale 0.05 per layer), whose bs1 request also runs its first decode
   step against the plain path and 16 decode steps under the profiler
   (kernel 3 once per layer and step, no softmax kernel, the workspace
   unchanged). Each: bs1 with an 8-token prompt and 50 greedy
   tokens, bs1 with another prompt, bs4 with ragged prompts; prints
   prefill ms, decode ms/token and tokens/s, checks that every kernel of
   the path was launched in the path's run (counts zeroed just before it;
   kernel 1 / 6's GEMM exactly 5 times a layer, in bs4's 64-row prefill,
   the tensor-core GEMV 5 times a layer in the 16-row bs1 prefills and
   bs4's decode steps, and, but on path 1, the GEMM's bs4 tokens against
   a run with the GEMVs at every row count, differing only at near ties),
   checks the 7B prefill logits against the plain-version path on the
   card, and profiles one bs1 request (device time by kernel, the device's
   busy share; device ms per decode token with a profile of the prefill
   alone subtracted). Paths 2 and 7 (W8A8) count the GEMM in every
   forward of at least W8A8_GEMM_MIN_ROWS rows (the 16-row bs1 prefills
   too) and hold bs4's tokens identical to a run on the dp4a kernel; then
   Task A (CNN/DailyMail summarization at bs1): one 923-token prompt
   (1024-row bucket) with the GEMM and with the dp4a kernel at every row
   count: TTFT, 16 decode steps over its int8 cache, 160 GEMM launches per
   prefill and none per decode step, first-token logits bit-identical
   and tokens identical between the routes, and a profile of the prefill
   (the GEMM's, kernel 2's and row 7's share; the plain quantize ops
   timed alone). Paths 1 and 2 then run the bs1 request again with
   decode_attn_mode 'split' (row 8) and 'fused' (row 9), path 8 with
   'fused' (its row 8 is held in the kernel phase only): decode and device
   ms/token, launches (the mode's kernel only), first-decode-step logits
   against the default mode's, and whether the tokens match. Paths 1, 3
   and 4 then run their bs1 and bs4 requests under TLLM_FUSE_GU=1 (gate/up
   fused, the SwiGLU prologue in the down projection's kernel): launches
   (the prologue once per layer in every forward of at most 16 rows),
   tokens against the unfused runs (where they differ, the two tokens'
   logits at the first differing step; an error unless their shift is
   within FUSE_GU_TOL), the fused session's prefill logits against the
   plain path (LOGITS_TOL), its logits against the unfused session's
   (FUSE_GU_TOL), decode and device ms/token. Path 1 then samples
   (run_sampling): bs1 and bs4 with temperature 0.8, top-k 40, top-p 0.95
   and repetition penalty 1.1 and their logprobs, each twice with one
   seed (identical tokens and logprobs), every token in the kept set of
   the plain filter on the session's own replay (edge tokens printed with
   their margins), logprobs within 5e-2 of the replay's; top_k=1 with
   top_p=0.9 against the greedy tokens (near ties only); a greedy bad word
   never emitted; a greedy stop word pair ending the run where it first
   completes; the card's sampler against the CPU's on the bs4 prefill
   logits with one noise tensor; device ms per sampled decode token
   beside greedy's. Then beam search (run_beams): bs1, 4 beams, in8 out50
   on the dense cache and with beam_paged_block 64: launches held exactly
   (the tiled 64-row prefill on the GEMM, each 4-row decode step on the
   tensor-core GEMV, kernel 3 or row 14 a layer a step), the two runs'
   beams alike, the best beam's score against its replayed log-probs,
   device ms per decode step. Then speculation (run_speculative), bs1
   in8 out50, gamma 4, on path 1's session and weights: a random
   LLaMA-160M-shaped bf16 draft (bench.py:416-418) and a self draft,
   greedy tokens equal to path 1's up to the first difference, which must
   be a near tie; the random draft sampling (temperature 0.8, top-k 8):
   every committed token in the target's kept set on the logits of the
   verify slab (or prefill) that committed it, one seed twice the same
   tokens; the copy workload (make_copy_params on path 1's weights over
   bench.py's 16-token cycle, a prompt repeating it twice) through
   PromptLookupSession (n-gram 3) and a self draft: the cycle's
   successors exactly, every iteration but the budget-capped last
   committing gamma + 1 tokens. Each run: wall ms per committed token,
   verify iterations, acceptance, launches held exactly (a verify: row
   2's tensor-core GEMV 5 a layer; a draft step: kernel 3 a draft layer,
   and the one-row GEMV 5 a layer for a self draft; a prefill: row 10 a
   layer, its projections on the route of its rows), the device ms of one
   iteration and, each profiled alone, of its draft steps and its verify.
   Each path's session is freed before the next starts;
4b. path 7, the hackathon's offline build at LLaMA-7B's full width,
   PATH7_DEPTH layers deep (the time budget; from_hf_config is checked at
   full depth): ModelConfig.from_hf_config of huggyllama/llama-7b's config.json
   fields, an HF-layout bf16 state dict drawn on the card (seed 0),
   synthetic calibration ranges (seed 0: |N(0, 1)| per channel with 1%
   outlier channels x20; no calibration corpus is at hand),
   smooth_hf_state_dict -> params_from_hf_state_dict (f32) ->
   quantize_params (static per-tensor SmoothQuant + int8 KV) ->
   save_engine -> load_engine(device="cuda") with every leaf byte-equal,
   each stage's wall time, the engine dir's bytes and the peak device
   memory; then GenerationSession on the loaded params, driven as paths
   1-4 with every wrapper's launches held exactly (row 5 five times per
   layer and forward, its GEMM in the forwards of at least
   W8A8_GEMM_MIN_ROWS rows, rows 6 and 7 never), Task A as path 2, and
   again under TLLM_FUSE_GU=1 (row 5 four times);
5. path 5, long context (bench.py's int8_int8kv long rows): int8
   weight-only LLaMA-7B with an int8 KV cache, one 8192-token prompt and
   64 greedy tokens; prints prefill ms, decode ms/token, the launches (the
   streaming prefill once per layer, kernel 1's GEMM 5 times per layer in
   the prefill, kernel 3 at every decode step), kernel 1's time per call
   at 8192 rows from a profile of the prefill, the 7B prefill logits
   against the plain path (the first token too), and decode steps over
   the 8k cache (host wall, device time, idle share, kernel 3's device ms
   per decode token from the profile: one kernel a layer and step);
6. serves with ServingEngine (int8 weight-only LLaMA-7B, bench.py's
   serving settings: 8 slots, decode_chunk 16, block 64, max_seq_len 200,
   bucket 128) 16 requests of 64 new tokens with prompts of 8-128 tokens
   (seed 0), in ten configurations, each engine freed before the next:
   dense, "dense, per-request sampling" (return_logprobs, max_bad_words
   4: 6 greedy requests, 6 sampled, 2 penalized with a min_length, one
   with a two-token bad word and one with a stop word, both from the
   dense run's tokens; the greedy ones must equal the dense run's, near
   ties aside, the bad word never completed, the stop request end
   "stop_words" where its pair first completes, a logprob a token),
   paged, packed prefill, paged with an int8 and with an e4m3 KV
   cache (scale 0.05), "dense, chunked prefill 32" (prompts of 33-128
   tokens in 2-4 forward_extend chunks: the chunk calls' rows against
   the long prompts' chunks, each long prompt's final-chunk logits, from
   the engine's own call, against a monolithic prefill within
   LOGITS_TOL, first tokens equal to dense's but at near ties), "dense,
   mixed step", "dense, pipelined" and "paged, pipelined" (every token
   equal to the dense run's, a difference only at a near tie on a bs1
   replay; the paged one then serves one request of 72 + 128 =
   max_seq_len tokens to its end, every block back); prints tokens/s,
   latency_stats, phase_stats (and the readback ms per step of dense,
   paged and the two pipelined runs side by side), the device busy share
   of one decode step (torch.profiler; dense, paged, packed and dense
   pipelined) and the launch counts, which must equal the layers times the
   engine's own count of decode steps (the tensor-core GEMV at 9 rows,
   kernel 3 or row 14), monolithic prefill calls (the GEMM, row 10 or 13)
   and chunk calls (the GEMM); checks that every request returns its 64
   tokens and that dense and paged agree on every first token, and prints
   how many requests match the dense run token for token. With the dense
   engine's weights (path 1's), forward_extend of 4 tokens after an
   8-token prefill against 4 decode steps (logits and the written K/V
   rows within LOGITS_TOL). With the packed engine's weights
   it prefills each admission wave both batched and packed and holds the
   logits and the K/V rows written within LOGITS_TOL, printing the top-2
   logit gap where a first token differs. Before the paths run, every
   kernel the serving phase launches is held against its plain version at
   the shapes it gives it (serve_waves: the int8 GEMV at 9, 256, 512 and
   1024 rows and the GEMM at each chunk call's 32-256 rows, prefill at
   each 8 x 128 admission, decode over 9 rows of the 256-row dense cache,
   inactive rows parked at max_seq_len among them, packed prefill at each
   wave's stream, and kernel 14 with bf16 and int8 pools, block sizes
   8/16/64, a position past the table, rows outside the write rows
   untouched). Then the speculative engines (run_serving_spec), the same
   settings, gamma 4: "dense, speculative (random draft)" (the
   LLaMA-160M-shaped draft, the 16 requests; tokens equal to dense's but
   at near ties) and "dense, prompt lookup (copy workload)" (n-gram 3, on
   make_copy_params of the weights, 16 prompts each a rotation of the
   cycle twice: the cycle's successors exactly, more tokens committed
   than verify iterations); tokens/s, verify iterations and committed
   tokens, launches held exactly (row 2's GEMM at each admission prefill
   and each 45-row verify, row 10 a layer a prefill, kernel 3 a draft
   layer a draft step); the kernel phase holds the verify rows (5 on the
   tensor-core GEMV, 45 on the GEMM, timed beside the other body) and the
   draft's attention shapes (kernels 2 and 3 at 12 heads of 64);
7. path 6, Bloom-7b1: first an HF BloomForCausalLM of its published
   fields at BLOOM_HF_LAYERS layers built on the card (seed 0) and loaded
   through convert/hf_families.py (hf_family_params: the loader's config
   against the published fields, f32 first-step logits against HF's own
   forward within HF_TOL), 16 bf16 tokens with the launches held; then
   at full width and depth (ALiBi, random weights drawn
   on the card, seed 0; the budget) through GenerationSession(model=decoder.BLOOM):
   bf16 weights with an 8-token prompt and 50 tokens (row 10 with slopes,
   once per layer) and a 3072-token prompt's prefill (row 12 with
   slopes), then the same tree int8 weight-only (quantize_params; kernel
   1 at Bloom's six projection shapes, held against its plain version
   first) with the 8-token prompt. Decode attention takes the JAX
   package's plain ALiBi branch, counted on its own. Prints prefill ms,
   decode ms/token, device ms per decode token and busy share beside the
   per-token weight-byte floor, the launch counts, and holds the first-step logits
   against the plain path on the card;
8. GPT-J-6B, GPT-NeoX-20B, OPT-6.7b and Falcon-7B at their published
   widths, 2 layers, from HF models built on the card (seed 0) and loaded
   through convert/hf_families.py (hf_family_params, as path 6's), then
   bf16: 16 greedy tokens each (Falcon also in the
   'fused' decode mode), launches (kernel 2 once per layer, kernel 3 or
   row 9 at every decode step, at every family's head dim), first-step
   logits against the plain path;
8b. Bloom-7b1 and OPT-6.7b at their published widths, 2 layers, bf16,
   served through ServingEngine(model=...) monolithic and with
   prefill_chunk=16 (four requests of 16 tokens, prompts of 40, 10, 33
   and 20): launches, the chunked tokens equal to the monolithic ones
   but at near ties;
8c. path 9, tensor parallelism (run_tp): the single-device
   references in this process (path 1's bs1 request and dense serving's
   16 requests, path 2's W8A8, each at PATH9_LAYERS = 8), then two
   ranks on the one card through parallel/launch.py over gloo (NCCL
   refuses two ranks on one device; gloo stages CUDA tensors through the
   host, so the times are no picture of TP speed; the ranks only load the
   libraries built here), each holding half of LLaMA-7B: (a) int8 bs1 in8
   out50, tokens = path 1's up to near ties, device ms and all-reduce ms a
   decode token from a profile; (b) Task A's 923-token prompt under
   overlap_chunks 4 and 0, tokens and first-token logits bit-identical,
   the windowed launches counted (wo and w_down, 4 windows a layer); (c)
   dense serving's 16 requests, tokens = the single device's up to near
   ties; (d) W8A8 bs1 and Task A; (e) fp8 Task A. A failed rank fails the
   phase. The kernel phase holds every route's n_window (rows 2, 4, 6)
   against the full call bit for bit and the plain version, and times
   one windowed 1024-row GEMM at w_down's local shape (K 5504, N 4096)
   against the full call;
8d. path 10, the quantization accuracy harness (run_accuracy,
   quantization/evaluate.py): (a) build_golden_setup at its defaults
   (hidden 256, 4 layers, 8 heads of 32, f32; an HF LlamaForCausalLM
   built and calibrated on the card; the JAX gates' own config has head
   dim 16, below the attention kernels' 32) with prompts [2, 16] and 10
   teacher-forced steps: the ten gated modes (int4-wo-g at g64) on the
   card and through the plain versions on the CPU on the same params,
   ranges and continuation, each card row against its CPU row (KL within
   ACC_KL_REL of the larger + ACC_KL_ABS, ppl ratio within ACC_PPL_ABS,
   top-1 at most one position apart), the gates' orderings; (b)
   LLaMA-7B width, ACC_7B_LAYERS layers, an f32 golden HF model built on
   the card, prompts [4, 48], 24 steps: the ten modes (int4 at g128; the
   int4 and fp8 weight formats, with int8 weight-only beside them, on
   structure_weights params), every metric finite, the orderings, the
   table of rows; every mode's launches held exactly (accuracy_expect);
8e. path 11, GPT-2 XL at gpt2-xl's published widths and depth (48
   layers; run_gpt2): a GPT2LMHeadModel built on the card (seed 0) and
   converted by convert/hf_gpt.py; f32 (TF32 off) first-token logits
   against HF's forward within HF_TOL and 16 greedy tokens against HF's
   (near ties aside); bf16 tokens and first-token logits against the
   plain path, device ms a bs1 decode token beside the byte floor; prompt
   tuning (2 tasks x 8 virtual tokens over real embeddings: tokens
   bit-identical to the real-token run; another table moves the logits;
   a repetition penalty keeps every token in the vocabulary); int8
   weight-only, row 2 on its three routes at K 1600 / 6400 (the GEMM's
   ragged last K tile at bs4's 64-row prefill), tokens against the plain
   path at bs1 and bs4; launches held exactly (row 10 48 a prefill,
   kernel 3 48 a decode step, row 2 288 an int8 forward). The kernel
   phase holds every kernel at paths 10 and 11's shapes (f32 GEMVs, W8A8
   and row 7 at their rows, row 10 at head dims 32, 64 and 128, kernel 3
   on f32 / bf16, int8 and e4m3 caches; check_accuracy_shapes), and row
   2 at GPT-2 XL's projections on every route, the ragged-K GEMM bit for
   bit against the zero-padded whole-tile call (check_gpt2_shapes);
9. prints each phase's wall time;
10. prints a `kernels` JSON line, then as the last line
   {"ok": true, "device": {...}}.
Any failed phase exits non-zero without that line. The script imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16 flop/s,
# dense int8 op/s.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
F32_FLOPS = 67e12     # float32 outside the tensor cores
# Two bf16 ulps at the largest output magnitude: the kernels and their
# plain versions sum in f32 in different orders, so a bf16 rounding
# (norm prologue, residual epilogue, attention output) may land one ulp
# apart.
BF16_TOL = 2.0 ** -7
LOGITS_TOL = 5e-2     # 7B prefill logits, relative to max |logit|
# TLLM_FUSE_GU=1 vs unfused 7B logits, relative to max |logit|: one
# [K, 2F] gate/up projection splits K unlike two [K, F] ones, so its bf16
# outputs round apart (at most 1.4e-2 measured, path 1 on an H100). Also
# the most that the two logits of a token flip may move against each other.
FUSE_GU_TOL = 2.5e-2
N_WEIGHT_LAYERS = 4   # stacked layers cycled when timing a matmul (> L2)
NEW_TOKENS = 50       # each path: 8-token prompt, 50 new tokens
KV_SCALE = 0.05       # paths 2 and 8's int8 / e4m3 KV scale, every layer
INT8_DECODE = "dma_decode_attention (int8 KV)"
INT8_PAGED = "paged_decode_attention (int8 KV)"
E4M3_DECODE = "dma_decode_attention (e4m3 KV)"
E4M3_PAGED = "paged_decode_attention (e4m3 KV)"
INT4_STACKED = "woq_matmul_stacked (int4 g128)"
INT4_2D = "woq_matmul (int4 per-channel)"
STREAMING = "streaming_prefill_attention_kernel"
READ_ONLY = "decode_attention_kernel"
READ_ONLY_INT8 = "decode_attention_kernel (int8 KV)"
FUSED = "fused_decode_attention"
FUSED_INT8 = "fused_decode_attention (int8 KV)"
READ_ONLY_E4M3 = "decode_attention_kernel (e4m3 KV)"
FUSED_E4M3 = "fused_decode_attention (e4m3 KV)"
# The decode checks' cache kinds: None (bf16), "int8" and "e4m3" (fp8 codes
# in uint8) -> the JSON names of kernel 3, row 8, row 9 and row 14 on it.
DECODE_KEYS = {
    None: ("dma_decode_attention", READ_ONLY, FUSED, "paged_decode_attention"),
    "int8": (INT8_DECODE, READ_ONLY_INT8, FUSED_INT8, INT8_PAGED),
    "e4m3": (E4M3_DECODE, READ_ONLY_E4M3, FUSED_E4M3, E4M3_PAGED),
}
_WOQ_PY = "trtllm_llama_tpu/ops/pallas/woq_matmul.py"
_ATTN_PY = "trtllm_llama_tpu/ops/pallas/attention.py"
# Rows the paths give a matmul or norm: decode bs1 and bs4, prefill bs1 and
# bs4 (prompts padded to the 16-token bucket). Each kernel is checked
# against its plain version at all of them.
PATH_ROWS = (1, 4, 16, 64)
# The serving phase: bench.py's serving settings (bench.py:166-272), with
# prompt lengths drawn from 8-128 (seed 0) instead of a fixed 128.
SERVE_ENGINE = dict(max_batch_size=8, max_input_len=128, max_seq_len=200,
                    prefill_buckets=(128,))
SERVE_REQUESTS = 16   # 24 before the decoder families' path 6 (budget)
SERVE_NEW = 64
SERVE_CHUNK = 16
SERVE_BLOCK = 64
SERVE_WARMUP = 2      # prompts of the warm-up run before the counted one
SERVE_PREFILL_CHUNK = 32  # "dense, chunked prefill 32": prompts of 33-128
                          # tokens go in 2-4 chunks
EDGE_PROMPT = 72      # "paged, pipelined": 72 + 128 new = max_seq_len 200
EXTEND_T = 4          # forward_extend's slab at full width (vs decode steps)
# Path 5: bench.py's long-context int8_int8kv rows (bench.py:128-150): one
# 8192-token prompt, 64 new tokens, RoPE table past LLaMA-1's 2048.
LONG_PROMPT = 8192
LONG_NEW = 64
LONG_ENGINE = dict(max_batch_size=1, max_input_len=8271, max_seq_len=8272)
LONG_ROPE = 16384     # bench.py:134: max(2048, next_pow2(in + out + 16))
LONG_S_MAX = 8320     # the session's cache rows: 8192 + 64, rounded to 128
DECODE_MODES = ("split", "fused")   # run again on paths 1 and 2
SHORT_DEPTH = 8       # layers of paths 3 and 4 (make_paths)
PATH7_DEPTH = 4       # layers of path 7's engine dir (build_offline)
DECODE_STEPS = 16     # path 8's profiled decode steps over its e4m3 cache
PROFILE_NEW = 4       # tokens of each profiled request (profile_generate;
                      # 16 before the sampling and beam runs, 8 before the
                      # accuracy and GPT-2 paths: the budget)
# kernels whose launches decode_step_launches counts in the decode steps:
# the split-K reduce (of the tensor-core GEMV and the GEMMs; no bs1 decode
# step launches it) and the one-launch GEMVs that take every bs1 projection
DECODE_KERNELS = ("gemv::reduce_kernel", "w8a8::reduce_kernel",
                  "gemv::gemv_kernel", "dp4a_kernel")
F32_TOL = 1e-5        # f32 kernels against their plain versions
# Path 6: Bloom-7b1, from bigscience/bloom-7b1's config.json (vocab_size
# 250880, hidden_size 4096, n_layer 30, n_head 32, layer_norm_epsilon 1e-5,
# ALiBi, an embedding LayerNorm; MLP 4 x hidden). Bloom has no position
# table: max_position_embeddings only bounds the buckets.
BLOOM_7B1 = dict(vocab_size=250880, hidden_size=4096, intermediate_size=16384,
                 num_layers=30, num_heads=32, num_kv_heads=32, head_dim=128,
                 rms_norm_eps=1e-5, architecture="bloom", dtype="bfloat16",
                 max_position_embeddings=4096)
BLOOM_LONG = 3072     # a long document's prefill: row 12 runs past 2048 rows
BLOOM_ENGINE = dict(max_batch_size=1, max_input_len=BLOOM_LONG,
                    max_seq_len=BLOOM_LONG + 1)
# The other decoder families at their published widths, FAMILY_LAYERS deep:
# (tag, ModelConfig fields, decode modes run).
FAMILY_LAYERS = 2
FAMILY_NEW = 16
FAMILY_CONFIGS = [
    # EleutherAI/gpt-j-6b config.json: n_embd 4096, n_head 16, rotary_dim 64,
    # n_inner null (4 x n_embd), vocab_size 50400, layer_norm_epsilon 1e-5
    ("GPT-J-6B", dict(architecture="gptj", vocab_size=50400, hidden_size=4096,
                      intermediate_size=16384, num_heads=16, num_kv_heads=16,
                      head_dim=256, rotary_dim=64, rms_norm_eps=1e-5,
                      max_position_embeddings=2048), ("auto",)),
    # EleutherAI/gpt-neox-20b config.json: hidden_size 6144, 64 heads,
    # intermediate_size 24576, rotary_pct 0.25 (24 of 96 dims), vocab 50432,
    # layer_norm_eps 1e-5
    ("GPT-NeoX-20B", dict(architecture="gptneox", vocab_size=50432,
                          hidden_size=6144, intermediate_size=24576,
                          num_heads=64, num_kv_heads=64, head_dim=96,
                          rotary_dim=24, rms_norm_eps=1e-5,
                          max_position_embeddings=2048), ("auto",)),
    # facebook/opt-6.7b config.json: hidden_size 4096, 32 heads, ffn_dim
    # 16384, relu, vocab_size 50272, max_position_embeddings 2048 (+2 offset)
    ("OPT-6.7b", dict(architecture="opt", vocab_size=50272, hidden_size=4096,
                      intermediate_size=16384, num_heads=32, num_kv_heads=32,
                      head_dim=128, rms_norm_eps=1e-5,
                      max_position_embeddings=2048), ("auto",)),
    # tiiuae/falcon-7b config.json: hidden_size 4544, 71 heads of 64,
    # multi_query (one KV head), MLP 4 x 4544, parallel_attn, vocab 65024,
    # layer_norm_epsilon 1e-5
    ("Falcon-7B", dict(architecture="falcon", vocab_size=65024,
                       hidden_size=4544, intermediate_size=18176,
                       num_heads=71, num_kv_heads=1, head_dim=64,
                       rms_norm_eps=1e-5, max_position_embeddings=2048),
     ("auto", "fused")),
]
# The same published fields as transformers configs (the families and
# path 6 build these HF models on the card and load them through
# convert/hf_families.py): tag -> (config class, model class, loader
# suffix, fields; the layer count is the run's)
HF_FAMILIES = {
    "GPT-J-6B": ("GPTJConfig", "GPTJForCausalLM", "gptj", dict(
        vocab_size=50400, n_embd=4096, n_head=16, rotary_dim=64,
        n_inner=None, n_positions=2048, layer_norm_epsilon=1e-5)),
    "GPT-NeoX-20B": ("GPTNeoXConfig", "GPTNeoXForCausalLM", "gptneox", dict(
        vocab_size=50432, hidden_size=6144, num_attention_heads=64,
        intermediate_size=24576, rotary_pct=0.25, rotary_emb_base=10000,
        max_position_embeddings=2048, layer_norm_eps=1e-5,
        use_parallel_residual=True)),
    "OPT-6.7b": ("OPTConfig", "OPTForCausalLM", "opt", dict(
        vocab_size=50272, hidden_size=4096, num_attention_heads=32,
        ffn_dim=16384, max_position_embeddings=2048, word_embed_proj_dim=4096,
        do_layer_norm_before=True, activation_function="relu")),
    "Falcon-7B": ("FalconConfig", "FalconForCausalLM", "falcon", dict(
        vocab_size=65024, hidden_size=4544, num_attention_heads=71,
        multi_query=True, parallel_attn=True, bias=False, alibi=False,
        new_decoder_architecture=False, max_position_embeddings=2048,
        layer_norm_epsilon=1e-5)),
    "Bloom-7b1": ("BloomConfig", "BloomForCausalLM", "bloom", dict(
        vocab_size=250880, hidden_size=4096, n_head=32,
        layer_norm_epsilon=1e-5)),
}
# the layer-count field of each config class
HF_LAYER_FIELD = {"GPTJConfig": "n_layer", "GPTNeoXConfig":
                  "num_hidden_layers", "OPTConfig": "num_hidden_layers",
                  "FalconConfig": "num_hidden_layers", "BloomConfig": "n_layer"}
BLOOM_HF_LAYERS = 2    # path 6's HF-weight check (its full depth stays random)
ROTARY_FAMILIES = ("gptj", "gptneox", "falcon")


# Path 7: the hackathon's offline build. The published huggyllama/llama-7b
# config.json fields that ModelConfig.from_hf_config reads.
HF_LLAMA_7B = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                   num_hidden_layers=32, num_attention_heads=32,
                   rms_norm_eps=1e-6, max_position_embeddings=2048,
                   tie_word_embeddings=False)
SQ_ALPHA = 0.5            # SmoothQuant migration strength
OUTLIER_SHARE = 0.01      # synthetic ranges: outlier channels ...
OUTLIER_GAIN = 20.0       # ... and their factor over |N(0, 1)|
SWIGLU_INT8 = "woq_matmul_stacked (SwiGLU)"
SWIGLU_INT4 = "woq_matmul_stacked (int4 g128 SwiGLU)"
SWIGLU_FP8 = "fp8_matmul_stacked (SwiGLU)"
_PROBES_CU = "trtllm_llama_tpu_torch/csrc/decode_probes.cu"
# kernel 3 and rows 8 and 9 (entries in decode_attention.cu, one library)
_FLASH_DECODE = "trtllm_llama_tpu_torch/csrc/flash_decode.cuh"
# row 12 at the paths' head dims (64 / 96 / 128, bf16 / fp16)
_FLASH_WS = "trtllm_llama_tpu_torch/csrc/flash_attention_ws.cuh"
ALIBI_PREFILL = "prefill_attention_kernel (ALiBi)"
ALIBI_STREAMING = "streaming_prefill_attention_kernel (ALiBi)"
FUSED_G71 = "fused_decode_attention (group 71)"
# kernels 1 and 6 at prefill rows: the tensor-core GEMM (csrc/woq_gemm.cuh)
GEMM_INT8 = "woq_matmul_stacked (GEMM)"
GEMM_INT4 = "woq_matmul_stacked (int4 g128 GEMM)"
GEMM_INT4_PC = "woq_matmul_stacked (int4 per-channel GEMM)"
GEMM_FP8 = "fp8_matmul_stacked (GEMM)"
# rows 5 and 6 at prefill rows: the int8 tensor-core GEMM (csrc/w8a8_gemm.cu)
W8A8_GEMM = "w8a8_matmul_stacked (GEMM)"
W8A8_GEMM_2D = "w8a8_matmul (GEMM)"
# kernel 1's GEMM on a K that is not whole 128-row tiles (GPT-2 XL's 1600:
# a last tile zero-filled past K); `.ragged_launches` counts its share
GEMM_RAGGED = "woq_matmul_stacked (GEMM, ragged K)"
GEMM_KEYS = (GEMM_INT8, GEMM_INT4, GEMM_INT4_PC, GEMM_FP8, W8A8_GEMM,
             W8A8_GEMM_2D)
# kernels 1 and 6 at TC_MIN_ROWS-16 rows: the tensor-core GEMV
# (csrc/woq_gemv_tc.cuh); `.tc_launches` counts its share of `.launches`
TC_INT8 = "woq_matmul_stacked (tensor-core GEMV)"
TC_INT4 = "woq_matmul_stacked (int4 g128 tensor-core GEMV)"
TC_INT4_2D = "woq_matmul (int4 per-channel tensor-core GEMV)"
TC_FP8 = "fp8_matmul_stacked (tensor-core GEMV)"
TC_FP8_2D = "fp8_matmul (tensor-core GEMV)"
TC_KEYS = (TC_INT8, TC_INT4, TC_INT4_2D, TC_FP8, TC_FP8_2D)
_WOQ_TC = "trtllm_llama_tpu_torch/csrc/woq_gemv_tc.cuh"
# Rows at which the kernel phase holds both GEMVs against their plain
# version and times them side by side (the crossover, TC_MIN_ROWS): decode
# bs1 / bs4, the rows between, serving's 9-row decode steps, the 16-row
# bucket.
GEMV_ROWS = (1, 2, 4, 5, 8, 9, 16)     # 5: a bs1 speculative verify
# Rows at which the kernel phase times the GEMM beside the GEMV (the
# crossover; GEMM_MIN_ROWS is 17) at the qkv shape, every format.
CROSSOVER_ROWS = (16, 17, 32, 45, 64, 256, 1024, LONG_PROMPT)  # 45: the
# speculative serving verify (9 rows x 5)
# Task A of the reference (BASELINE.md:6, bench.py:80-92): CNN/DailyMail
# summarization at bs1, prompts of up to 923 tokens. Paths 2 and 7 prefill
# one 923-token prompt (the 1024-row bucket) and decode TASK_A_DECODE
# tokens over its int8 cache.
TASK_A_PROMPT = 923
TASK_A_DECODE = 16
# Rows at which the kernel phase holds the W8A8 GEMM and the dp4a kernel
# against their plain version and times them side by side (the crossover:
# decode and bs4 rows, the rows between, prefill buckets, Task A's prompt
# and bucket); the qkv shape also at 8192 rows (the GEMM alone).
W8A8_ROWS = (1, 2, 4, 5, 6, 8, 16, 17, 32, 64, 256, TASK_A_PROMPT, 1024)


def serve_prompt_lens():
    """The serving phase's prompt lengths: 8-128 tokens, seed 0."""
    import numpy as np
    return np.random.default_rng(0).integers(8, 129, SERVE_REQUESTS).tolist()


def serve_waves():
    """Prompt lengths of each prefill call of the serving phase: the
    warm-up's prompts, then the counted run's admission waves (all requests
    arrive at once with one budget, so the slots fill with prompts 0-7,
    then 8-15). run_serving checks the engine's own count of
    prefill calls against it."""
    lens = serve_prompt_lens()
    slots = SERVE_ENGINE["max_batch_size"]
    return [lens[:SERVE_WARMUP]] + [lens[i:i + slots]
                                    for i in range(0, len(lens), slots)]


def packed_len(total):
    """The engine's packed stream length for `total` prompt tokens: powers
    of two from 16 (ServingEngine._t_bucket, below its cap of 8 x 128)."""
    t = 16
    while t < total:
        t *= 2
    return t


def serve_rows():
    """Rows the serving phase gives a projection: a decode step (the slots
    and the trash row), a speculative verify (those rows x SPEC_GAMMA + 1),
    each batched prefill (its prompts at the 128-token bucket), each packed
    stream and each chunked-prefill call (32 rows a partial prompt, 1-8 of
    them)."""
    bucket = max(SERVE_ENGINE["prefill_buckets"])
    slots = SERVE_ENGINE["max_batch_size"]
    rows = {slots + 1, (slots + 1) * (SPEC_GAMMA + 1)}
    for lens in serve_waves():
        rows |= {len(lens) * bucket, packed_len(sum(lens))}
    rows |= {SERVE_PREFILL_CHUNK * n for n in range(1, slots + 1)}
    return tuple(sorted(rows))

# JSON name -> (wrapper attribute, TPU kernel it replaces, source)
KERNELS = {
    "woq_matmul_stacked": (
        "woq_matmul_stacked", f"{_WOQ_PY}:617",
        "trtllm_llama_tpu_torch/csrc/woq_matmul.cu"),
    INT4_STACKED: (
        "woq_matmul_stacked", f"{_WOQ_PY}:617",
        "trtllm_llama_tpu_torch/csrc/woq_matmul.cu"),
    INT4_2D: (
        "woq_matmul", f"{_WOQ_PY}:416",
        "trtllm_llama_tpu_torch/csrc/woq_matmul.cu"),
    "fp8_matmul_stacked": (
        "fp8_matmul_stacked", f"{_WOQ_PY}:654",
        "trtllm_llama_tpu_torch/csrc/fp8_matmul.cu"),
    "fp8_matmul": (
        "fp8_matmul", f"{_WOQ_PY}:646",
        "trtllm_llama_tpu_torch/csrc/fp8_matmul.cu"),
    "prefill_attention_kernel": (
        "prefill_attention_kernel",
        "trtllm_llama_tpu/ops/pallas/attention.py:504",
        "trtllm_llama_tpu_torch/csrc/prefill_attention.cu"),
    "dma_decode_attention": (
        "dma_decode_attention",
        "trtllm_llama_tpu/ops/pallas/dma_decode_attention.py:156",
        _FLASH_DECODE),
    "rmsnorm_quant": (
        "rmsnorm_quant", "trtllm_llama_tpu/ops/pallas/rmsnorm_quant.py:31",
        "trtllm_llama_tpu_torch/csrc/rmsnorm_quant.cu"),
    "w8a8_matmul_stacked": (
        "w8a8_matmul_stacked", "trtllm_llama_tpu/ops/pallas/w8a8_matmul.py:181",
        "trtllm_llama_tpu_torch/csrc/w8a8_matmul.cu"),
    INT8_DECODE: (
        "dma_decode_attention",
        "trtllm_llama_tpu/ops/pallas/dma_decode_attention.py:156",
        _FLASH_DECODE),
    "packed_prefill_attention_kernel": (
        "packed_prefill_attention_kernel",
        "trtllm_llama_tpu/ops/pallas/attention.py:315",
        "trtllm_llama_tpu_torch/csrc/packed_prefill_attention.cu"),
    "paged_decode_attention": (
        "paged_decode_attention",
        "trtllm_llama_tpu/ops/pallas/paged_decode_attention.py:157",
        "trtllm_llama_tpu_torch/csrc/paged_decode_attention.cu"),
    INT8_PAGED: (
        "paged_decode_attention",
        "trtllm_llama_tpu/ops/pallas/paged_decode_attention.py:157",
        "trtllm_llama_tpu_torch/csrc/paged_decode_attention.cu"),
    E4M3_DECODE: (
        "dma_decode_attention",
        "trtllm_llama_tpu/ops/pallas/dma_decode_attention.py:156",
        _FLASH_DECODE),
    E4M3_PAGED: (
        "paged_decode_attention",
        "trtllm_llama_tpu/ops/pallas/paged_decode_attention.py:157",
        "trtllm_llama_tpu_torch/csrc/paged_decode_attention.cu"),
    READ_ONLY_E4M3: (
        "decode_attention_kernel", f"{_ATTN_PY}:72", _FLASH_DECODE),
    FUSED_E4M3: (
        "fused_decode_attention", f"{_ATTN_PY}:185", _FLASH_DECODE),
    STREAMING: (
        "streaming_prefill_attention_kernel", f"{_ATTN_PY}:433", _FLASH_WS),
    READ_ONLY: (
        "decode_attention_kernel", f"{_ATTN_PY}:72", _FLASH_DECODE),
    READ_ONLY_INT8: (
        "decode_attention_kernel", f"{_ATTN_PY}:72", _FLASH_DECODE),
    FUSED: (
        "fused_decode_attention", f"{_ATTN_PY}:185", _FLASH_DECODE),
    FUSED_INT8: (
        "fused_decode_attention", f"{_ATTN_PY}:185", _FLASH_DECODE),
    ALIBI_PREFILL: (
        "prefill_attention_kernel", f"{_ATTN_PY}:504",
        "trtllm_llama_tpu_torch/csrc/prefill_attention.cu"),
    ALIBI_STREAMING: (
        "streaming_prefill_attention_kernel", f"{_ATTN_PY}:433", _FLASH_WS),
    FUSED_G71: (
        "fused_decode_attention", f"{_ATTN_PY}:185", _FLASH_DECODE),
    GEMM_INT8: (
        "woq_matmul_stacked", f"{_WOQ_PY}:461",
        "trtllm_llama_tpu_torch/csrc/woq_gemm.cu"),
    GEMM_INT4: (
        "woq_matmul_stacked", f"{_WOQ_PY}:461",
        "trtllm_llama_tpu_torch/csrc/woq_gemm.cu"),
    GEMM_INT4_PC: (
        "woq_matmul_stacked", f"{_WOQ_PY}:461",
        "trtllm_llama_tpu_torch/csrc/woq_gemm.cu"),
    GEMM_FP8: (
        "fp8_matmul_stacked", f"{_WOQ_PY}:654",
        "trtllm_llama_tpu_torch/csrc/fp8_gemm.cu"),
    "w8a8_matmul": (
        "w8a8_matmul", "trtllm_llama_tpu/ops/pallas/w8a8_matmul.py:103",
        "trtllm_llama_tpu_torch/csrc/w8a8_matmul.cu"),
    W8A8_GEMM: (
        "w8a8_matmul_stacked", "trtllm_llama_tpu/ops/pallas/w8a8_matmul.py:113",
        "trtllm_llama_tpu_torch/csrc/w8a8_gemm.cu"),
    W8A8_GEMM_2D: (
        "w8a8_matmul", "trtllm_llama_tpu/ops/pallas/w8a8_matmul.py:58",
        "trtllm_llama_tpu_torch/csrc/w8a8_gemm.cu"),
    SWIGLU_INT8: (
        "woq_matmul_stacked", f"{_WOQ_PY}:617",
        "trtllm_llama_tpu_torch/csrc/woq_matmul.cu"),
    SWIGLU_INT4: (
        "woq_matmul_stacked", f"{_WOQ_PY}:617",
        "trtllm_llama_tpu_torch/csrc/woq_matmul.cu"),
    SWIGLU_FP8: (
        "fp8_matmul_stacked", f"{_WOQ_PY}:654",
        "trtllm_llama_tpu_torch/csrc/fp8_matmul.cu"),
    "probe_bitcast_u32_bf16": (
        "probe_bitcast_u32_bf16", "scripts/probe_int4_kernel.py:33",
        _PROBES_CU),
    "probe_u16_ops": (
        "probe_u16_ops", "scripts/probe_int4_kernel.py:62", _PROBES_CU),
    "probe_u32_bf16_construct": (
        "probe_u32_bf16_construct", "scripts/probe_int4_kernel.py:82",
        _PROBES_CU),
    "probe_gemv_decodes": (
        "probe_gemv_decodes", "tests/test_tpu_kernels.py:144", _PROBES_CU),
    "probe_fp8_planes": (
        "probe_fp8_planes", "tests/test_tpu_kernels.py:203", _PROBES_CU),
    "probe_tc_pairs": (
        "probe_tc_pairs", "tests/test_tpu_kernels.py:144", _PROBES_CU),
    # the e4m3 KV codec of the decode kernels: no Pallas kernel had it (the
    # JAX package runs fp8 caches on XLA, ops/attention.py:256, through the
    # codec of ops/fp8.py)
    "probe_kv_codec": (
        "probe_kv_codec", "trtllm_llama_tpu/ops/fp8.py:45", _PROBES_CU),
    GEMM_RAGGED: (
        "woq_matmul_stacked", f"{_WOQ_PY}:461",
        "trtllm_llama_tpu_torch/csrc/woq_gemm.cu"),
    TC_INT8: ("woq_matmul_stacked", f"{_WOQ_PY}:617", _WOQ_TC),
    TC_INT4: ("woq_matmul_stacked", f"{_WOQ_PY}:617", _WOQ_TC),
    TC_INT4_2D: ("woq_matmul", f"{_WOQ_PY}:416", _WOQ_TC),
    TC_FP8: ("fp8_matmul_stacked", f"{_WOQ_PY}:654", _WOQ_TC),
    TC_FP8_2D: ("fp8_matmul", f"{_WOQ_PY}:646", _WOQ_TC),
}


def time_ms(fn, iters=20, warmup=3, reps=3):
    """Device time per fn(i) call: `iters` calls captured in one CUDA graph,
    replayed `reps` times between CUDA events. Replay keeps the host out of
    the measurement (an eager call adds its Python and launch overhead,
    which the end-to-end numbers carry). Warm-up and capture share one
    side stream, so the capture finds the per-stream state (kernel 3's
    workspace, cuBLAS's) that the warm-up made."""
    import torch
    if not hasattr(time_ms, "side"):
        time_ms.side = torch.cuda.Stream()
    side = time_ms.side
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(warmup):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def bound_ms(n_bytes, flops, peak=BF16_FLOPS):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def decode_work(live, hq, hkv, d, kv, write):
    """(bytes, operations) that one decode-attention call needs, bf16 q:
    kernel 3 / row 9 (write=True) or row 8 (write=False), each sequence
    attending live[b] cache rows of kind `kv` (None: bf16, 2 bytes an
    element; "int8" / "e4m3": 1). Bytes: the live K/V rows once (a writer
    writes row pos in place of reading it), q and out, the positions or
    lengths, a quantized cache's scale and a writer's new K/V; 4 * Hq * D
    operations per live row."""
    b, n = len(live), sum(live)
    elem = 2 if kv is None else 1
    n_bytes = (2 * hkv * n * d * elem + 2 * b * hq * d * 2 + b * 4
               + (4 if kv else 0) + (2 * b * hkv * d * 2 if write else 0))
    return n_bytes, 4 * hq * d * n


def kv_cache(shape, kv, g):
    """A random cache of kind kv on the card: bf16 N(0, 1) values (None),
    int8 codes, or encodable e4m3 codes (uint8)."""
    import torch
    from trtllm_llama_tpu_torch.quantization.quantize import random_fp8_codes
    if kv == "e4m3":
        return random_fp8_codes(shape, g, "cuda")
    if kv == "int8":
        return torch.randint(-127, 128, shape, generator=g, device="cuda",
                             dtype=torch.int8)
    return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)


def kv_bf16(x, kv):
    """Cache rows as the library yardstick reads them: bf16, a quantized
    cache dequantized beforehand at KV_SCALE."""
    import torch
    from trtllm_llama_tpu_torch.ops.kernels import decode_attention as da
    return x if kv is None else da.kv_decode(x, KV_SCALE).to(torch.bfloat16)


# The amplitude of the decode checks' new K/V rows: past an int8 code's
# range at KV_SCALE (~8 = 160 codes, clamped at 127), past e4m3's +-448 x
# KV_SCALE (8 x N(0, 1) > 22.4 now and then: saturated).
NEW_KV_AMP = {None: 1.0, "int8": 2.0, "e4m3": 8.0}


def split_edges():
    """Kernel 3 / row 9 cases (B, Hq, Hkv, S_max, positions) at LLaMA-7B's
    widths on path 5's 8320-row cache that reach the edges of the host's
    split (decode_split): positions 0, the last row of split 0, the first
    of split 1, S_max - 1 and past S_max at bs1; at bs4, ragged positions
    0 to 8200, a split's last and first row among them, so some splits
    hold one live row and others all of theirs."""
    from trtllm_llama_tpu_torch.ops.kernels import decode_attention as da
    sms = da.sm_count(0)
    edge1 = da.decode_split(1, 32, LONG_S_MAX, 1, sms)[1] * da.TILE
    edge4 = da.decode_split(4, 32, LONG_S_MAX, 1, sms)[1] * da.TILE
    return ([(1, 32, 32, LONG_S_MAX, [p]) for p in
             (0, edge1 - 1, edge1, LONG_S_MAX - 1, LONG_S_MAX + 5)]
            + [(4, 32, 32, LONG_S_MAX, [0, edge4 - 1, edge4, 8200])])


def prefill_attention_work(lens, s, hq, hkv, d, itemsize=2, alibi=False):
    """(bytes, operations) that row 10's contract needs on [B, S] inputs
    with valid lengths `lens`: a sequence of length n > 0 reads its S rows
    of q and min(n, S) rows of K and V and does 4 * D operations per
    unmasked (row, col) pair for each q head; one of length 0 averages V
    over all S rows (one add a value), reading no q and no K. Every row's
    output is written; lens (and slopes) are read once."""
    n_bytes, ops = len(lens) * 4 + (hq * 4 if alibi else 0), 0
    for n in lens:
        n_bytes += s * hq * d * itemsize                       # out
        if n > 0:
            m = min(n, s)
            n_bytes += (s * hq + 2 * m * hkv) * d * itemsize   # q, K, V
            ops += 4 * hq * d * (m * (m + 1) // 2 + (s - m) * m)
        else:
            n_bytes += s * hkv * d * itemsize                  # V
            ops += s * hkv * d
    return n_bytes, ops


def packed_attention_work(seg_lens, t, hq, hkv, d, itemsize=2):
    """(bytes, operations) that row 13's contract needs on a T-row stream
    whose segments have lengths `seg_lens` (pad rows after them): q, K, V
    and out of the segments' rows only (a pad row's output is undefined),
    the T segment ids, and 4 * D operations per (row, col) pair of a
    segment's causal triangle for each q head."""
    rows = sum(seg_lens)
    pairs = sum(n * (n + 1) // 2 for n in seg_lens)
    return (rows * (2 * hq + 2 * hkv) * d * itemsize + t * 4,
            4 * hq * d * pairs)


def compare(name, got, ref, errors, tol=BF16_TOL):
    """Max abs / rel error of got vs ref; records a failure past tol."""
    import torch
    got, ref = got.float(), ref.float()
    if not bool(torch.isfinite(got).all()):
        errors.append(f"{name}: non-finite output")
        return float("inf")
    scale = ref.abs().max().item()
    err = (got - ref).abs().max().item()
    rel = err / max(scale, 1e-30)
    ok = rel <= tol
    print(f"  {name}: max_abs_err {err:.3e} max_rel_err {rel:.3e} "
          f"(tol {tol:.2e} x max|ref|) {'ok' if ok else 'FAIL'}")
    if not ok:
        errors.append(f"{name}: rel err {rel:.3e} > {tol:.2e}")
    return err


def ptxas_summary(log):
    """One line from nvcc -Xptxas -v: kernels, registers, smem, spills, and
    the (mangled) names of the kernels that spill."""
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    smem = [int(r) for r in re.findall(r"(\d+) bytes smem", log)] or [0]
    spills = sum(int(r) for r in re.findall(r"(\d+) bytes spill stores", log))
    spilling = [chunk.split("'")[0]
                for chunk in log.split("Compiling entry function '")[1:]
                if any(int(s) for s in re.findall(r"(\d+) bytes spill stores",
                                                  chunk))]
    return (f"{len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
            f"up to {max(smem)} bytes static smem, {spills} bytes spilled"
            + (f" (in {', '.join(spilling)})" if spilling else ""))


@contextlib.contextmanager
def patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


@contextlib.contextmanager
def route(gemm):
    """Kernels 1 and 6 forced onto one route: the GEMM at every row count
    of a call without options (gemm=True), or the GEMV at every row count
    (gemm=False), through the floor their routing rule reads."""
    from trtllm_llama_tpu_torch.ops.kernels import woq_matmul as woq
    with patched(woq, "GEMM_MIN_ROWS", 1 if gemm else 1 << 62):
        yield


@contextlib.contextmanager
def w8a8_route(gemm):
    """Rows 5 and 6 forced onto one route: the int8 GEMM at every row count
    of a layout it tiles (gemm=True), or the dp4a kernel at every row count
    (gemm=False), through the floor w8a8_gemm_route reads."""
    from trtllm_llama_tpu_torch.ops.kernels import w8a8_matmul as w8a8
    with patched(w8a8, "W8A8_GEMM_MIN_ROWS", 1 if gemm else 1 << 62):
        yield


def exact(name, got, ref, errors):
    """got must equal ref bit for bit (the W8A8 kernels: exact int32 sums,
    the same f32 epilogue). Returns the max abs error."""
    import torch
    err = (got.float() - ref.float()).abs().max().item()
    ok = torch.equal(got, ref)
    print(f"  {name}: max_abs_err {err:.3e} (bit-equal required) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        errors.append(f"{name}: not bit-equal to the plain version "
                      f"(max abs err {err:.3e})")
    return err


def launches_of(name, fn):
    """The launches of JSON entry `name` by its wrapper `fn` since the
    counts were zeroed: the GEMM's share for a GEMM entry, the tensor-core
    GEMV's for a TC_KEYS entry, the rest (the one-row GEMV's, or all)
    for the wrapper's other entries."""
    gemm = getattr(fn, "gemm_launches", 0)
    tc = getattr(fn, "tc_launches", 0)
    if name == GEMM_RAGGED:
        return fn.ragged_launches
    if name in GEMM_KEYS:
        return gemm
    return tc if name in TC_KEYS else fn.launches - gemm - tc


def tc_rows(rows):
    """Whether a bf16 call of `rows` rows at LLaMA-7B's widths runs the
    tensor-core GEMV (tc_route)."""
    import torch
    from trtllm_llama_tpu_torch.ops.kernels import woq_matmul as woq
    return woq.tc_route(rows, torch.bfloat16, 4096)


@contextlib.contextmanager
def tc_route_forced(tc):
    """Kernels 1 and 6 at up to 16 rows forced onto one GEMV: the
    tensor-core body at every row count it tiles (tc=True), or the
    one-row body (tc=False), through the floor tc_route reads."""
    from trtllm_llama_tpu_torch.ops.kernels import woq_matmul as woq
    with patched(woq, "TC_MIN_ROWS", 1 if tc else 1 << 30):
        yield



# ---------------------------------------------------------------------------
# kernels 1 (int8, int4) and 6 (fp8): the weight-only GEMVs
# ---------------------------------------------------------------------------

# weight format -> (stacked JSON key or None, 2-D JSON key or None, GEMM
# JSON key, seed, the rows whose GEMM time the kernels line records: the
# path's own, path 5's prefill for int8 and bs4's prefill for int4 g128
# and fp8; no path runs stacked int4 per-channel; then the tensor-core
# GEMV's stacked and 2-D keys and the rows its line records: serving's 9
# for int8, bs4's decode for the rest)
GEMV_FORMATS = {
    "int8": ("woq_matmul_stacked", None, GEMM_INT8, 1, LONG_PROMPT, TC_INT8,
             None, 9),
    "int4 g128": (INT4_STACKED, None, GEMM_INT4, 7, 64, TC_INT4, None, 4),
    "int4 per-channel": (None, INT4_2D, GEMM_INT4_PC, 8, 1024, None,
                         TC_INT4_2D, 4),
    "fp8": ("fp8_matmul_stacked", "fp8_matmul", GEMM_FP8, 9, 64, TC_FP8,
            TC_FP8_2D, 4),
}


def make_gemv_weight(fmt, n_l, k, n, g):
    """Random stacked weight [n_l, K, N] of `fmt` with random positive
    scales (grouped scales vary along K)."""
    import torch
    from trtllm_llama_tpu_torch.quantization.quantize import random_fp8_codes
    from trtllm_llama_tpu_torch.quantization.tensors import FP8Weight, WOQWeight

    def scale(shape, qmax):
        return (0.5 + torch.rand(shape, generator=g, device="cuda")) * (
            k ** -0.5 / qmax)
    if fmt == "fp8":
        return FP8Weight(random_fp8_codes((n_l, k, n), g, "cuda"),
                         scale((n_l, n), 448.0), 128)
    w_bits = 8 if fmt == "int8" else 4
    gs = 128 if fmt == "int4 g128" else 0
    q = torch.randint(-127, 128, (n_l, k // 2 if w_bits == 4 else k, n),
                      generator=g, device="cuda", dtype=torch.int8)
    sshape = (n_l, k // gs, n) if gs else (n_l, n)
    return WOQWeight(q, scale(sshape, 127.0), w_bits, gs,
                     128 if w_bits == 4 else 0)


def _one_layer(w, layer):
    import dataclasses
    return dataclasses.replace(w, qweight=w.qweight[layer],
                               scale=w.scale[layer])


def check_gemv(fmt, errors, results):
    """The stacked kernel at the four projection shapes: at every PATH_ROWS
    and GEMV_ROWS row count up to 16 with each option (and, for int8,
    serving's rows), on the route tc_route / gemm_route give it (the
    tensor-core GEMV from TC_MIN_ROWS, the one-row one below), the GEMM
    at every row count above 16 that the paths and serving give (bs4's
    64-row prefill; int8 also serving's admissions and path 5's 8192 rows)
    with none (the paths compose the options there); for formats whose
    2-D entry a path launches, the 2-D entry at the same shapes and at the
    lm_head's. At GEMV_ROWS both GEMVs, each forced onto its body, are
    timed side by side with the path's option beside the library call and
    the bound. Then check_gemm's side-by-side timing at the qkv shape."""
    import torch
    from trtllm_llama_tpu_torch.config import ModelConfig
    from trtllm_llama_tpu_torch.ops.kernels import fp8_matmul as f8k
    from trtllm_llama_tpu_torch.ops.kernels import woq_matmul as woq

    (key_3d, key_2d, gemm_key, seed, _, tc_3d, tc_2d,
     tc_key_rows) = GEMV_FORMATS[fmt]
    if fmt == "fp8":
        stacked, stacked_plain = f8k.fp8_matmul_stacked, f8k.fp8_matmul_stacked_plain
        two_d, two_d_plain = f8k.fp8_matmul, f8k.fp8_matmul_plain
    else:
        stacked, stacked_plain = woq.woq_matmul_stacked, woq.woq_matmul_stacked_plain
        two_d, two_d_plain = woq.woq_matmul, woq.woq_matmul_plain
    print(f"kernel {stacked.__name__} / {two_d.__name__} ({fmt} weights, bf16 "
          f"x, f32 out; the tensor-core GEMV at {woq.TC_MIN_ROWS}-16 rows, "
          "the one-row GEMV below, the GEMM above):")
    cfg = ModelConfig.llama_7b()
    d, f, vocab = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    qkv = cfg.num_heads * cfg.head_dim + 2 * cfg.num_kv_heads * cfg.head_dim
    # (name, K, N, option the main path uses at up to 16 rows)
    shapes = [("qkv", d, qkv, "norm"), ("wo", d, d, "resid"),
              ("gate/up", d, f, "none"), ("down", f, d, "resid")]
    g = torch.Generator(device="cuda").manual_seed(seed)
    n_l = N_WEIGHT_LAYERS
    err = {"gemv": 0.0, "tc": 0.0, "gemm": 0.0, "2-D gemv": 0.0,
           "2-D tc": 0.0}
    # the serving phase and path 5 run int8 weights at their own row counts
    rows = sorted(set(PATH_ROWS + GEMV_ROWS + (
        (serve_rows() + (LONG_PROMPT,)) if fmt == "int8" else ())))
    table = {}

    def route_of(m):
        return ("gemm" if m >= woq.GEMM_MIN_ROWS
                else "tc" if woq.TC_MIN_ROWS <= m <= woq.TC_MAX_ROWS
                else "gemv")

    def record(key, t_k, t_p, t_l, n_bytes, m, k, n, what):
        b_ms, b_by = bound_ms(n_bytes, 2 * m * k * n)
        print(f"  time {what}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
              f"library(matmul bf16 dequantized) {t_l:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), {n_bytes / t_k / 1e6:.1f} GB/s")
        if key is not None:
            results[key] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                                bound_ms=b_ms, bound_by=b_by,
                                shape=f"M={m} K={k} N={n} {fmt}, {what}")

    for pname, k, n, path_opt in shapes:
        w = make_gemv_weight(fmt, n_l, k, n, g)
        deq = w.dequantize(torch.bfloat16)             # yardstick only
        w_bytes = w.qweight[0].numel() + w.scale[0].numel() * 4
        nw = (1 + 0.1 * torch.randn((n_l, k), generator=g, device="cuda")
              ).to(torch.bfloat16)
        for m in rows:
            x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
            resid = torch.randn((m, n), generator=g, device="cuda").to(torch.bfloat16)
            rt = route_of(m)
            for opt in ("none",) if rt == "gemm" else ("none", "norm", "resid"):
                kw = {"norm": {"norm_w": nw}, "resid": {"resid": resid},
                      "none": {}}[opt]
                before = (stacked.gemm_launches, stacked.tc_launches)
                got = stacked(x, w, 1, **kw)
                ref = stacked_plain(x, w, 1, **kw)
                torch.cuda.synchronize()
                e = compare(f"{pname} K={k} N={n} M={m} {opt} ({rt})", got,
                            ref, errors)
                err[rt] = max(err[rt], e)
                moved = (stacked.gemm_launches - before[0],
                         stacked.tc_launches - before[1])
                if moved != (int(rt == "gemm"), int(rt == "tc")):
                    errors.append(f"{fmt} {pname} M={m} {opt}: the {rt} did "
                                  f"not run (GEMM / tensor-core launches "
                                  f"{moved})")
                del got, ref
            if key_2d is not None and m <= max(PATH_ROWS):
                w1 = _one_layer(w, 1)
                got = two_d(x, w1)
                ref = two_d_plain(x, w1)
                torch.cuda.synchronize()
                e = compare(f"2-D {pname} K={k} N={n} M={m} ({rt})", got, ref,
                            errors)
                key = "gemm" if rt == "gemm" else f"2-D {rt}"
                err[key] = max(err[key], e)
            if m not in GEMV_ROWS:
                continue
            kw = {"norm": {"norm_w": nw}, "resid": {"resid": resid},
                  "none": {}}[path_opt]
            with tc_route_forced(True):
                t_tc = time_ms(lambda i: stacked(x, w, i % n_l, **kw))
            with tc_route_forced(False):
                t_cc = time_ms(lambda i: stacked(x, w, i % n_l, **kw))
            t_l = time_ms(lambda i: torch.matmul(x, deq[i % n_l]))
            n_bytes = (w_bytes + m * k * 2 + m * n * 4
                       + (k * 2 if path_opt == "norm" else 0)
                       + (m * n * 2 if path_opt == "resid" else 0))
            b_ms, b_by = bound_ms(n_bytes, 2 * m * k * n)
            table[f"{pname} M={m} {path_opt}"] = dict(
                tc_ms=t_tc, one_row_ms=t_cc, library_ms=t_l, bound_ms=b_ms,
                bound_by=b_by)
            print(f"  time {pname} M={m} {path_opt}: tensor-core {t_tc:.4f} "
                  f"ms, one-row {t_cc:.4f} ms, library(matmul bf16 "
                  f"dequantized) {t_l:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
                  f"tensor-core at {100 * b_ms / t_tc:.1f}%, one-row at "
                  f"{100 * b_ms / t_cc:.1f}% of the bound; "
                  f"{t_tc / t_l:.2f}x / {t_cc / t_l:.2f}x the library")
            for key, route_ms, at in ((key_3d, t_cc, 1), (tc_3d, t_tc,
                                                          tc_key_rows)):
                if key is not None and pname == "qkv" and m == at:
                    t_p = time_ms(lambda i: stacked_plain(x, w, i % n_l,
                                                          **kw), iters=8)
                    record(key, route_ms, t_p, t_l, n_bytes, m, k, n,
                           f"{pname} M={m} {path_opt}")
        if pname == "qkv":
            err["gemm"] = max(err["gemm"], check_gemm(fmt, w, deq, g, errors,
                                                      results))
        del w, deq
    for pname, _, _, path_opt in shapes:
        no_slower = [m for m in GEMV_ROWS
                     if table[f"{pname} M={m} {path_opt}"]["tc_ms"]
                     <= table[f"{pname} M={m} {path_opt}"]["one_row_ms"]]
        print(f"  {fmt} {pname}: the tensor-core GEMV is no slower than the "
              f"one-row one at M = {no_slower} (TC_MIN_ROWS "
              f"{woq.TC_MIN_ROWS})")
    results["_e2e"][f"kernel 1/6 {fmt} GEMV tensor-core vs one-row"] = table
    results[gemm_key]["max_abs_err"] = err["gemm"]
    for key, e in ((key_3d, err["gemv"]), (tc_3d, err["tc"])):
        if key is not None:
            results[key]["max_abs_err"] = e
    if key_2d is None:
        return
    # the lm_head: one [4096, 32000] weight, per-channel (bigger than L2);
    # bs1 and bs4 decode / last rows on the GEMVs, and the GEMM at the
    # 2-D entry's widest shape
    w = _one_layer(make_gemv_weight(fmt, 1, d, vocab, g), 0)
    deq = w.dequantize(torch.bfloat16)
    for m in (1, 4, 64):
        x = torch.randn((m, d), generator=g, device="cuda").to(torch.bfloat16)
        rt = route_of(m)
        before = (two_d.gemm_launches, two_d.tc_launches)
        got = two_d(x, w)
        ref = two_d_plain(x, w)
        torch.cuda.synchronize()
        e = compare(f"2-D lm_head K={d} N={vocab} M={m} ({rt})", got, ref,
                    errors)
        if (two_d.gemm_launches - before[0],
                two_d.tc_launches - before[1]) != (int(rt == "gemm"),
                                                   int(rt == "tc")):
            errors.append(f"{fmt} 2-D lm_head M={m}: the {rt} did not run")
        if rt == "gemm":
            results[gemm_key]["max_abs_err"] = max(
                results[gemm_key]["max_abs_err"], e)
        else:
            err[f"2-D {rt}"] = max(err[f"2-D {rt}"], e)
        if rt != "gemm":
            t_k = time_ms(lambda i: two_d(x, w))
            t_p = time_ms(lambda i: two_d_plain(x, w), iters=8)
            t_l = time_ms(lambda i: torch.matmul(x, deq))
            n_bytes = (w.qweight.numel() + w.scale.numel() * 4 + m * d * 2
                       + m * vocab * 4)
            record(key_2d if rt == "gemv" else tc_2d, t_k, t_p, t_l, n_bytes,
                   m, d, vocab, f"lm_head M={m} ({rt})")
    results[key_2d]["max_abs_err"] = err["2-D gemv"]
    results[tc_2d]["max_abs_err"] = err["2-D tc"]


def check_gemm(fmt, w, deq, g, errors, results):
    """The GEMM and the GEMV side by side at the qkv shape (w: the stacked
    weight, deq: its bf16 dequantization, the library yardstick), at each
    CROSSOVER_ROWS row count, each forced onto its route: their times, the
    plain version's, the library call's and the bound; the GEMM against
    the plain version at every count, and once with fp16 activations.
    Records the GEMM's kernels-line entry at the format's path rows and
    returns its largest error."""
    import torch
    from trtllm_llama_tpu_torch.ops.kernels import fp8_matmul as f8k
    from trtllm_llama_tpu_torch.ops.kernels import woq_matmul as woq

    _, _, gemm_key, _, key_rows, _, _, _ = GEMV_FORMATS[fmt]
    stacked, plain = ((f8k.fp8_matmul_stacked, f8k.fp8_matmul_stacked_plain)
                      if fmt == "fp8" else
                      (woq.woq_matmul_stacked, woq.woq_matmul_stacked_plain))
    n_l, k, n = w.qweight.shape[0], w.k_dim, w.qweight.shape[-1]
    w_bytes = w.qweight[0].numel() + w.scale[0].numel() * 4
    err_max, table = 0.0, {}
    for m in CROSSOVER_ROWS:
        x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
        with route(gemm=True):
            got = stacked(x, w, 1)
        ref = plain(x, w, 1)
        torch.cuda.synchronize()
        err_max = max(err_max, compare(f"qkv K={k} N={n} M={m} (GEMM forced)",
                                       got, ref, errors))
        if m == 1024:
            xh = x.to(torch.float16)
            err_max = max(err_max, compare(
                f"qkv K={k} N={n} M={m} fp16 (GEMM)", stacked(xh, w, 1),
                plain(xh, w, 1), errors))
        del got, ref
        big = m >= 1024                    # the GEMV takes 30-550 ms here
        with route(gemm=True):
            t_gemm = time_ms(lambda i: stacked(x, w, i % n_l))
        with route(gemm=False):
            t_gemv = time_ms(lambda i: stacked(x, w, i % n_l),
                             **(dict(iters=2, warmup=1, reps=1) if big else {}))
        # (int4 g128's plain version holds [M, K/128, N] f32 partials: 13 GB
        # at 8192 rows, so it is compared there once, not timed)
        t_p = (None if m == LONG_PROMPT and getattr(w, "group_size", 0) else
               time_ms(lambda i: plain(x, w, i % n_l), iters=2 if big else 8,
                       warmup=1, reps=1))
        t_l = time_ms(lambda i: torch.matmul(x, deq[i % n_l]))
        n_bytes = w_bytes + m * k * 2 + m * n * 4
        b_ms, b_by = bound_ms(n_bytes, 2 * m * k * n)
        table[m] = dict(gemm_ms=t_gemm, gemv_ms=t_gemv, plain_ms=t_p,
                        library_ms=t_l, bound_ms=b_ms, bound_by=b_by)
        print(f"  time qkv M={m}: GEMM {t_gemm:.4f} ms, GEMV {t_gemv:.4f} ms, "
              f"plain {'not timed' if t_p is None else f'{t_p:.4f} ms'}, "
              f"library(matmul bf16 dequantized) "
              f"{t_l:.4f} ms, bound {b_ms:.4f} ms ({b_by}); GEMM at "
              f"{100 * b_ms / t_gemm:.1f}% of the bound, "
              f"{t_gemm / t_l:.2f}x the library")
        if m == key_rows:
            results[gemm_key] = dict(
                ms=t_gemm, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                bound_by=b_by, shape=f"M={m} K={k} N={n} {fmt}, qkv (GEMM)",
                launches=0)                # the paths add theirs
        del x
    faster = [m for m in CROSSOVER_ROWS
              if table[m]["gemm_ms"] < table[m]["gemv_ms"]]
    print(f"  {fmt} crossover: the GEMM is faster than the GEMV at M = "
          f"{faster} of {list(CROSSOVER_ROWS)} (GEMM_MIN_ROWS "
          f"{woq.GEMM_MIN_ROWS})")
    results["_e2e"][f"kernel 1/6 {fmt} qkv GEMM vs GEMV"] = table
    return err_max


# format -> (JSON key or None, seed)
SWIGLU_CASES = {"int8": (SWIGLU_INT8, 21), "int4 g128": (SWIGLU_INT4, 22),
                "int4 per-channel": (None, 23), "fp8": (SWIGLU_FP8, 24)}


def check_swiglu(errors, results):
    """The SwiGLU prologue of rows 2 and 4 at the down projection's shape
    (x [M, 2 x 11008] = [gate | up] -> N = 4096) in every weight format, at
    M = 1, 4, 9 and 16 (the FUSE_MAX_ROWS limit; the tensor-core GEMV from
    TC_MIN_ROWS, the one-row one below), with and without the
    residual, bf16, plus one fp16 and one f32 case; timed at M = 1 with the
    residual (the decode step's call) over N_WEIGHT_LAYERS weights."""
    import torch
    from trtllm_llama_tpu_torch.config import ModelConfig
    from trtllm_llama_tpu_torch.ops.kernels import fp8_matmul as f8k
    from trtllm_llama_tpu_torch.ops.kernels import woq_matmul as woq

    cfg = ModelConfig.llama_7b()
    k, n = cfg.intermediate_size, cfg.hidden_size
    n_l = N_WEIGHT_LAYERS
    print(f"SwiGLU prologue of rows 2 and 4: x [M, 2 x {k}] -> N={n}, "
          "silu(g) in f32, times u in the compute dtype:")
    extra = {"int8": (torch.float16, 1), "fp8": (torch.float32, 9)}
    for fmt, (key, seed) in SWIGLU_CASES.items():
        g = torch.Generator(device="cuda").manual_seed(seed)
        w = make_gemv_weight(fmt, n_l, k, n, g)
        if fmt == "fp8":
            fn, plain = f8k.fp8_matmul_stacked, f8k.fp8_matmul_stacked_plain
        else:
            fn, plain = woq.woq_matmul_stacked, woq.woq_matmul_stacked_plain
        cases = [(torch.bfloat16, m) for m in (1, 4, 9, 16)]
        if fmt in extra:
            cases.append(extra[fmt])
        err = 0.0
        for dtype, m in cases:
            x = (2 * torch.randn((m, 2 * k), generator=g, device="cuda")).to(
                dtype)
            resid = torch.randn((m, n), generator=g, device="cuda").to(dtype)
            tol = F32_TOL if dtype == torch.float32 else BF16_TOL
            for kw in ({}, {"resid": resid}):
                got = fn(x, w, 1, swiglu=True, **kw)
                ref = plain(x, w, 1, swiglu=True, **kw)
                torch.cuda.synchronize()
                err = max(err, compare(
                    f"{fmt} SwiGLU M={m} {str(dtype)[6:]}"
                    f"{' resid' if kw else ''}", got, ref, errors, tol=tol))
        x = (2 * torch.randn((1, 2 * k), generator=g, device="cuda")).to(
            torch.bfloat16)
        resid = torch.randn((1, n), generator=g, device="cuda").to(
            torch.bfloat16)
        h = (torch.nn.functional.silu(x[:, :k].float()).to(x.dtype)
             * x[:, k:])
        deq = w.dequantize(torch.bfloat16)                 # yardstick only
        t_k = time_ms(lambda i: fn(x, w, i % n_l, swiglu=True, resid=resid))
        t_p = time_ms(lambda i: plain(x, w, i % n_l, swiglu=True,
                                      resid=resid), iters=8)
        t_l = time_ms(lambda i: torch.matmul(h, deq[i % n_l]))
        n_bytes = (w.qweight[0].numel() + w.scale[0].numel() * 4 + 2 * k * 2
                   + n * 4 + n * 2)
        b_ms, b_by = bound_ms(n_bytes, 2 * k * n)
        print(f"  time {fmt} SwiGLU M=1 resid: kernel {t_k:.4f} ms, plain "
              f"{t_p:.4f} ms, library(matmul bf16 dequantized, on the "
              f"composed silu(g) * u) {t_l:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}), {n_bytes / t_k / 1e6:.1f} GB/s")
        if key is not None:       # no path runs int4 per-channel stacked
            results[key] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                                bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                                launches=0,
                                shape=f"M=1 K={k} N={n} {fmt}, SwiGLU + resid")
        del w, deq


def check_probes(errors, results):
    """Rows 15-19, each on its exhaustive input, held bit for bit against
    its plain version (the two e4m3 NaN codes NaN on both sides; row 18
    also through the tensor-core GEMV's pair decoders, into bf16 and fp16),
    and the decode kernels' e4m3 KV codec against ops/fp8.py; no path
    launches them."""
    import torch
    from trtllm_llama_tpu_torch.ops.kernels import probes as pr

    print("decode probes (rows 15-19), exact:")
    cases = [(pr.probe_bitcast_u32_bf16, pr.bitcast_inputs),
             (pr.probe_u16_ops, pr.u16_inputs),
             (pr.probe_u32_bf16_construct, pr.construct_inputs),
             (pr.probe_gemv_decodes, pr.code_inputs),
             (pr.probe_tc_pairs, pr.code_inputs),
             (pr.probe_fp8_planes, pr.planes_inputs)]
    for fn, make in cases:
        name = fn.__name__
        plain = getattr(pr, name + "_plain")
        x = make("cuda")
        got, ref = fn(x), plain(x)
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        torch.cuda.synchronize()
        same, n_out = True, 0
        for a, b in zip(got, ref):
            nan = torch.isnan(a.float()) & torch.isnan(b.float())
            same &= (a.shape == b.shape and a.dtype == b.dtype
                     and bool((nan | (a == b)).all()))
            n_out += a.numel() * a.element_size()
        t_k = time_ms(lambda i: fn(x))
        t_p = time_ms(lambda i: plain(x), iters=8)
        n_bytes = x.numel() * x.element_size() + n_out
        b_ms, b_by = bound_ms(n_bytes, 0)
        print(f"  {name} {tuple(x.shape)} {x.dtype}: "
              f"{'exact' if same else 'MISMATCH'}; kernel {t_k:.4f} ms, plain "
              f"{t_p:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
        if name == "probe_u32_bf16_construct":
            pair = got[0].float()[0:2, 9 + 16 * 5].tolist()
            print(f"  nibbles (9, 5) -> {pair} (the TPU probe expects 200, 168)")
            same &= pair == [200.0, 168.0]
        if not same:
            errors.append(f"{name}: differs from its plain version")
        results[name] = dict(ms=t_k, plain_ms=t_p, library_ms=None,
                             bound_ms=b_ms, bound_by=b_by,
                             max_abs_err=0.0 if same else float("inf"),
                             launches=0, shape=f"{tuple(x.shape)} {x.dtype}")
    # the e4m3 KV codec of the decode kernels (KVCodec, load_raw): the
    # encode sweep at scales 1 (every tie exact) and KV_SCALE (path 8's)
    x = pr.kv_codec_inputs("cuda")
    exact = True
    for scale in (1.0, KV_SCALE):
        s = torch.tensor([scale], device="cuda")
        got, ref = pr.probe_kv_codec(x, s), pr.probe_kv_codec_plain(x, s)
        torch.cuda.synchronize()
        same = all(a.shape == b.shape and a.dtype == b.dtype and bool(
            ((torch.isnan(a.float()) & torch.isnan(b.float())) | (a == b))
            .all()) for a, b in zip(got, ref))
        print(f"  probe_kv_codec at scale {scale}: {x.numel()} values "
              f"encoded (ties, +-448 and past it, subnormals, -0), 256 codes "
              f"decoded three ways: {'exact' if same else 'MISMATCH'}")
        exact &= same
        if not same:
            errors.append(f"probe_kv_codec at scale {scale}: differs from "
                          "fp8_encode / fp8_decode")
    t_k = time_ms(lambda i: pr.probe_kv_codec(x, s))
    t_p = time_ms(lambda i: pr.probe_kv_codec_plain(x, s), iters=8)
    b_ms, b_by = bound_ms(x.numel() * 5 + 256 * 12, 0)
    print(f"  probe_kv_codec: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, bound "
          f"{b_ms:.6f} ms ({b_by})")
    results["probe_kv_codec"] = dict(
        ms=t_k, plain_ms=t_p, library_ms=None, bound_ms=b_ms, bound_by=b_by,
        max_abs_err=0.0 if exact else float("inf"), launches=0,
        shape=f"{x.numel()} f32 values, 256 codes")


# ---------------------------------------------------------------------------
# kernel 2
# ---------------------------------------------------------------------------

def check_prefill(errors, results):
    """Row 10 (kernel 2) at the paths' and serving's shapes, bf16, 32 heads
    of 128, against its plain version; each MHA case timed beside the bound
    and SDPA with the same mask. bf16 / fp16 run the wgmma flash tile
    (csrc/flash_attention.cuh), which carries P through P V as three bf16
    terms (f32's precision)."""
    import torch
    import torch.nn.functional as F
    from trtllm_llama_tpu_torch.ops.kernels import prefill_attention as pa

    print("kernel prefill_attention_kernel (causal GQA, bf16; the wgmma "
          "flash tile):")
    g = torch.Generator(device="cuda").manual_seed(2)
    d = 128
    cases = [  # (B, S, Hq, Hkv, lens)
        (1, 16, 32, 32, [8]),            # main path bs1: bucket 16, prompt 8
        (4, 16, 32, 32, [8, 5, 12, 3]),  # main path bs4 ragged
        (2, 512, 32, 32, [512, 300]),    # long ragged
        (2, 64, 32, 8, [64, 17]),        # GQA group of 4
        (3, 150, 32, 32, [150, 77, 0]),  # S off the tile, a length of 0
        (1, 1024, 32, 32, [TASK_A_PROMPT]),   # Task A (paths 2 and 7)
    ] + [  # serving: each batched admission at the 128-token bucket
        (len(lens), max(SERVE_ENGINE["prefill_buckets"]), 32, 32, lens)
        for lens in serve_waves()]
    max_err = 0.0
    for b, s, hq, hkv, lens in cases:
        q = torch.randn((b, s, hq, d), generator=g, device="cuda").to(torch.bfloat16)
        k = torch.randn((b, s, hkv, d), generator=g, device="cuda").to(torch.bfloat16)
        v = torch.randn((b, s, hkv, d), generator=g, device="cuda").to(torch.bfloat16)
        sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        got = pa.prefill_attention_kernel(q, k, v, sl)
        ref = pa.prefill_attention_kernel_plain(q, k, v, sl)
        torch.cuda.synchronize()
        name = f"B={b} S={s} Hq={hq} Hkv={hkv} lens={lens}"
        max_err = max(max_err, compare(name, got, ref, errors))
        if hq != hkv:
            continue
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        cols = torch.arange(s, device="cuda")
        mask = ((cols[None, :] <= cols[:, None])[None]
                & (cols[None, None, :] < sl[:, None, None]))[:, None]
        t_k = time_ms(lambda i: pa.prefill_attention_kernel(q, k, v, sl))
        t_p = time_ms(lambda i: pa.prefill_attention_kernel_plain(q, k, v, sl))
        t_l = time_ms(lambda i: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask))
        b_ms, b_by = bound_ms(*prefill_attention_work(lens, s, hq, hkv, d))
        print(f"  time {name}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
              f"library(sdpa) {t_l:.4f} ms, bound {b_ms:.5f} ms ({b_by}), "
              f"{100 * b_ms / t_k:.1f}% of it")
        entry = dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                     bound_by=b_by, shape=f"B={b} S={s} lens={lens} "
                     "Hq=Hkv=32 D=128 bf16")
        if b == 1 and s == 16:
            results["prefill_attention_kernel"] = entry
        else:
            results["prefill_attention_kernel"].setdefault(
                "more", []).append(entry)
    results["prefill_attention_kernel"]["max_abs_err"] = max_err


def check_prefill_vs_streaming(errors, results):
    """Rows 10 (the flash tile) and 12 (the warp-specialized tile) on the
    same bf16 inputs, B=1, 32 heads of 128, full length, at S = 512-8192:
    each against the plain version and timed beside SDPA (is_causal) and
    the operations bound. prefill_streaming_min_s (2048) sends longer
    prompts to row 12; this table says whether it should."""
    import torch
    import torch.nn.functional as F
    from trtllm_llama_tpu_torch.ops.kernels import prefill_attention as pa
    from trtllm_llama_tpu_torch.ops.kernels import (
        streaming_prefill_attention as spa,
    )

    print("rows 10 and 12 side by side (B=1, Hq=Hkv=32, D=128, bf16, full "
          "length):")
    g = torch.Generator(device="cuda").manual_seed(22)
    d, hq = 128, 32
    table = []
    for s in (512, 1024, 2048, 4096, LONG_PROMPT):
        q, k, v = (torch.randn((1, s, hq, d), generator=g, device="cuda"
                               ).to(torch.bfloat16) for _ in range(3))
        sl = torch.tensor([s], dtype=torch.int32, device="cuda")
        ref = pa.prefill_attention_kernel_plain(q, k, v, sl)
        err_10 = compare(f"row 10 S={s}", pa.prefill_attention_kernel(
            q, k, v, sl), ref, errors)
        err_12 = compare(f"row 12 S={s}",
                         spa.streaming_prefill_attention_kernel(q, k, v, sl),
                         ref, errors)
        del ref
        fold_err(results, "prefill_attention_kernel", err_10)
        fold_err(results, STREAMING, err_12)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        t_10 = time_ms(lambda i: pa.prefill_attention_kernel(q, k, v, sl))
        t_12 = time_ms(lambda i: spa.streaming_prefill_attention_kernel(
            q, k, v, sl))
        t_l = time_ms(lambda i: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        n_bytes, flops = prefill_attention_work([s], s, hq, hq, d)
        b_ms, b_by = bound_ms(n_bytes, flops)
        print(f"  S={s}: row 10 {t_10:.4f} ms ({flops / t_10 / 1e9:.1f} "
              f"TFLOP/s), row 12 {t_12:.4f} ms ({flops / t_12 / 1e9:.1f}), "
              f"library(sdpa, is_causal) {t_l:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}); row 10 {t_12 / t_10:.2f}x row 12's speed")
        table.append(dict(S=s, row10_ms=t_10, row12_ms=t_12, library_ms=t_l,
                          bound_ms=b_ms, bound_by=b_by))
        del q, k, v, qt, kt, vt
    results["_e2e"]["row 10 vs row 12"] = table


# ---------------------------------------------------------------------------
# kernel 3 (bf16 cache, path 1; int8 cache, path 2; e4m3 cache, path 8)
# ---------------------------------------------------------------------------

def check_decode(errors, results, kv=None):
    """Kernel 3 on a cache of kind kv (None: bf16; "int8"; "e4m3")
    against its plain version at the paths' shapes (S_max 128 pos 45, the
    bs4 ragged and GQA cases, path 5's 8320 rows; Task A's 1152 rows for a
    quantized cache, serving's for bf16) and the split's edges: the output
    within BF16_TOL, the caches equal to the plain write bit for bit, one
    launch a call; the bs1 MHA cases timed beside SDPA and the bound."""
    import torch
    import torch.nn.functional as F
    from trtllm_llama_tpu_torch.ops.kernels import decode_attention as da
    sms = da.sm_count(0)

    kind = (f"{kv} cache, scale {KV_SCALE} per layer" if kv
            else "bf16 cache")
    print(f"kernel dma_decode_attention (KV write + attention, {kind}):")
    g = torch.Generator(device="cuda").manual_seed(
        {None: 3, "int8": 4, "e4m3": 22}[kv])
    d, n_l, layer = 128, 2, 1
    cases = [  # (B, Hq, Hkv, S_max, positions)
        (1, 32, 32, 128, [45]), (1, 32, 32, 2048, [1037]),
        (1, 32, 32, 2048, [2047]),
        # path 5: the 8k cache mid-generation and at its last decode step
        # (63 steps write rows 8192-8254)
        (1, 32, 32, LONG_S_MAX, [8200]),
        (1, 32, 32, LONG_S_MAX, [LONG_PROMPT + LONG_NEW - 2]),
        (4, 32, 32, 128, [8, 5, 12, 3]),    # bs4 ragged
        (2, 32, 8, 128, [31, 100]),         # GQA group of 4
    ]
    if kv:   # Task A (paths 2 and 7): its first and last decode steps
        # over the session's cache (rows rounded up to 128, init_caches)
        s_task_a = -(-(1024 + 1 + TASK_A_DECODE) // 128) * 128
        cases += [(1, 32, 32, s_task_a, [TASK_A_PROMPT]),
                  (1, 32, 32, s_task_a, [TASK_A_PROMPT + TASK_A_DECODE - 1])]
    else:
        cases += [(1, 32, 32, 128, [0]), (1, 32, 32, 128, [127]),
                  (1, 32, 32, 2048, [0])]
        # serving (dense cache, bf16): the slots mid-generation and at their
        # last step of waves 1 and 3, the trash row at 0
        waves = serve_waves()
        s_serve = -(-SERVE_ENGINE["max_seq_len"] // 128) * 128
        cases += [(len(w) + 1, 32, 32, s_serve, [n + t for n in w] + [0])
                  for w, t in ((waves[1], SERVE_NEW // 2),
                               (waves[-1], SERVE_NEW - 2))]
        # chunked prefill: inactive rows (partial prompts, the trash row)
        # parked at max_seq_len
        park = SERVE_ENGINE["max_seq_len"]
        cases += [(len(waves[1]) + 1, 32, 32, s_serve,
                   [n + SERVE_NEW // 2 for n in waves[1][:4]]
                   + [park] * (len(waves[1]) - 3))]
    edges = split_edges()
    cases += edges
    kv_scale = (torch.full((n_l,), KV_SCALE, device="cuda") if kv
                else None)
    key = DECODE_KEYS[kv][0]
    max_err = 0.0
    for b, hq, hkv, s, pos in cases:
        shape = (n_l, b, hkv, s, d)
        kc, vc = kv_cache(shape, kv, g), kv_cache(shape, kv, g)
        q = torch.randn((b, hq, d), generator=g, device="cuda").to(torch.bfloat16)
        amp = NEW_KV_AMP[kv]    # quantized: the clamp / saturation is hit
        kn = (amp * torch.randn((b, hkv, d), generator=g, device="cuda")
              ).to(torch.bfloat16)
        vn = (amp * torch.randn((b, hkv, d), generator=g, device="cuda")
              ).to(torch.bfloat16)
        pt = torch.tensor(pos, dtype=torch.int32, device="cuda")
        kc2, vc2 = kc.clone(), vc.clone()
        n0 = da.dma_decode_attention.launches
        got = da.dma_decode_attention(q, kn, vn, kc, vc, layer, pt,
                                      kv_scale=kv_scale)
        ref = da.dma_decode_attention_plain(q, kn, vn, kc2, vc2, layer, pt,
                                            kv_scale=kv_scale)
        torch.cuda.synchronize()
        name = (f"B={b} Hq={hq} Hkv={hkv} S_max={s} pos={pos} splits "
                f"{da.decode_split(b, hkv, s, hq // hkv, sms)}")
        max_err = max(max_err, compare(name, got, ref, errors))
        same = torch.equal(kc, kc2) and torch.equal(vc, vc2)
        print(f"  {name}: cache equals the plain write bit for bit: {same}")
        if not same:
            errors.append(f"decode {kind} {name}: cache differs from the "
                          "plain write")
        if da.dma_decode_attention.launches != n0 + 1:
            errors.append(f"decode {kind} {name}: not one launch a call")
        if b != 1 or hq != hkv or (b, hq, hkv, s, pos) in edges:
            continue
        p = pos[0]
        t_k = time_ms(lambda i: da.dma_decode_attention(
            q, kn, vn, kc, vc, layer, pt, kv_scale=kv_scale))
        t_p = time_ms(lambda i: da.dma_decode_attention_plain(
            q, kn, vn, kc2, vc2, layer, pt, kv_scale=kv_scale))
        ql = q[:, :, None]
        # the yardstick reads bf16 K/V (dequantized beforehand)
        kl = kv_bf16(kc[layer, :, :, :p + 1], kv)
        vl = kv_bf16(vc[layer, :, :, :p + 1], kv)
        t_l = time_ms(lambda i: F.scaled_dot_product_attention(ql, kl, vl))
        b_ms, b_by = bound_ms(*decode_work([p + 1], hq, hkv, d, kv, True))
        lib = ("sdpa on bf16-dequantized K/V, no write" if kv
               else "sdpa, no write")
        print(f"  time {name}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
              f"library({lib}) {t_l:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
        if s == 128 and p == 45:
            results[key] = dict(
                ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                bound_by=b_by, shape=f"B=1 Hq=Hkv=32 S_max=128 pos=45 D=128 "
                f"bf16 q, {kv or 'bf16'} cache")
        elif kv:        # Task A's and path 5's rows
            results.setdefault(key, {}).setdefault("more", []).append(dict(
                ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                bound_by=b_by, shape=f"B=1 Hq=Hkv=32 S_max={s} pos={p} "
                f"D=128 bf16 q, {kv} cache"))
    results[key]["max_abs_err"] = max_err


# ---------------------------------------------------------------------------
# row 12: the streaming prefill (path 5)
# ---------------------------------------------------------------------------

def check_streaming_prefill(errors, results):
    import torch
    import torch.nn.functional as F
    from trtllm_llama_tpu_torch.ops.kernels import (
        streaming_prefill_attention as spa,
    )

    print("kernel streaming_prefill_attention_kernel (causal GQA, long "
          "prompts; the warp-specialized wgmma tile at D = 64 / 96 / 128, "
          "row 10's tile at 256, bf16; CUDA-core f32):")
    g = torch.Generator(device="cuda").manual_seed(12)
    cases = [  # (B, S, Hq, Hkv, D, lens, dtype)
        (1, LONG_PROMPT, 32, 32, 128, [LONG_PROMPT], torch.bfloat16),  # path 5
        (2, 2100, 32, 8, 128, [2100, 64], torch.bfloat16),  # GQA, ragged
        (2, 2100, 8, 2, 128, [2100, 0], torch.float32),     # a length of 0
        # the 128-row query tile's edges: one row past a tile, a length of 0
        # (V averaged over all S rows) and one of 1
        (3, 2049, 32, 8, 128, [2049, 0, 1], torch.bfloat16),
        (1, 4097, 32, 32, 128, [4097], torch.bfloat16),
        # Falcon-7B's 71 heads of 64 on one KV head
        (1, 2100, 71, 1, 64, [2100], torch.bfloat16),
        # GPT-J's and GPT-NeoX's head dims (prompts past 2048 rows)
        (1, 2100, 16, 16, 256, [2100], torch.bfloat16),
        (1, 2100, 16, 16, 96, [2100], torch.bfloat16),
        (1, 2100, 4, 4, 256, [1500], torch.float32),
    ]
    max_err = 0.0
    for b, s, hq, hkv, d, lens, dtype in cases:
        q, k, v = (torch.randn((b, s, h, d), generator=g, device="cuda"
                               ).to(dtype) for h in (hq, hkv, hkv))
        sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        got = spa.streaming_prefill_attention_kernel(q, k, v, sl)
        ref = spa.streaming_prefill_attention_kernel_plain(q, k, v, sl)
        torch.cuda.synchronize()
        f32 = dtype == torch.float32
        name = (f"B={b} S={s} Hq={hq} Hkv={hkv} D={d} lens={lens} "
                f"{'f32' if f32 else 'bf16'}")
        max_err = max(max_err, compare(name, got, ref, errors,
                                       tol=F32_TOL if f32 else BF16_TOL))
        if s != LONG_PROMPT:
            continue
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        t_k = time_ms(lambda i: spa.streaming_prefill_attention_kernel(
            q, k, v, sl))
        t_p = time_ms(lambda i: spa.streaming_prefill_attention_kernel_plain(
            q, k, v, sl), iters=2, warmup=1, reps=1)
        t_l = time_ms(lambda i: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        n_bytes, flops = prefill_attention_work(lens, s, hq, hkv, d,
                                                q.element_size())
        b_ms, b_by = bound_ms(n_bytes, flops)
        print(f"  time {name}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
              f"library(sdpa, is_causal) {t_l:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}), {flops / t_k / 1e9:.1f} TFLOP/s")
        results[STREAMING] = dict(
            ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
            bound_by=b_by, shape=f"B=1 S={s} Hq=Hkv=32 D=128 bf16 "
            "(path 5's prefill)")
        del qt, kt, vt
    results[STREAMING]["max_abs_err"] = max_err


# ---------------------------------------------------------------------------
# rows 8 and 9: the read-only and the one-launch decode ('split' / 'fused')
# ---------------------------------------------------------------------------

def check_decode_modes(errors, results, kv=None):
    """Row 8 over rows < lens and row 9 (write + attend) against their
    plain versions at path 1's shape (S_max 128, pos 45), path 5's (S_max
    8320, pos 8200), GQA groups of 4 and 32 and the edges (lengths 0, 1, S
    and past S, and ragged up to 8201 over the split of an 8320-row cache;
    positions 0, a split's last and first row, the last row and past S),
    one launch a call. Row 9's caches must equal the plain write and row 8's
    stay untouched. Times both, kernel 3 on the same inputs, their plain
    versions and SDPA over the live rows (no write). kv: the cache's kind
    (None: bf16, "int8", "e4m3")."""
    import torch
    import torch.nn.functional as F
    from trtllm_llama_tpu_torch.ops.kernels import decode_attention as da

    kind = f"{kv} cache, scale {KV_SCALE}" if kv else "bf16 cache"
    print(f"kernels decode_attention_kernel (read-only) and "
          f"fused_decode_attention (one launch), {kind}:")
    g = torch.Generator(device="cuda").manual_seed(
        {None: 8, "int8": 9, "e4m3": 23}[kv])
    d, n_l, layer = 128, 2, 1
    cases = [  # (B, Hq, Hkv, S_max, write positions; row 8 reads pos + 1)
        (1, 32, 32, 128, [45]), (1, 32, 32, LONG_S_MAX, [8200]),
        (2, 32, 8, 128, [31, 100]),
        (4, 32, 32, 128, [0, 127, 128, 300]),   # edges: first, last, past S
        # a group of 32 on one KV head, 2048 rows split over the card
        (2, 32, 1, 2048, [1037, 2047]),
    ]
    edges = split_edges()   # row 9's split edges (row 8 reads pos + 1)
    cases += edges
    kv_scale = (torch.full((n_l,), KV_SCALE, device="cuda") if kv
                else None)
    keys = DECODE_KEYS[kv][1:3]
    err = {key: 0.0 for key in keys}
    for b, hq, hkv, s, pos in cases:
        shape = (n_l, b, hkv, s, d)
        kc, vc = kv_cache(shape, kv, g), kv_cache(shape, kv, g)
        q = torch.randn((b, hq, d), generator=g, device="cuda").to(torch.bfloat16)
        amp = NEW_KV_AMP[kv]
        kn, vn = ((amp * torch.randn((b, hkv, d), generator=g, device="cuda")
                   ).to(torch.bfloat16) for _ in range(2))
        pt = torch.tensor(pos, dtype=torch.int32, device="cuda")
        lens = pt + 1
        if b == 4 and s == 128:   # row 8's edges: 0, S, past S, a mid length
            lens = torch.tensor([0, s, s + 72, 45], dtype=torch.int32,
                                device="cuda")
        elif b == 4:        # 0 and the split edges, ragged up to 8201
            lens[0] = 0
        name = f"B={b} Hq={hq} Hkv={hkv} S_max={s}"
        before = kc.clone(), vc.clone()
        n0 = da.decode_attention_kernel.launches
        got = da.decode_attention_kernel(q, kc, vc, layer, lens,
                                         kv_scale=kv_scale)
        ref = da.decode_attention_kernel_plain(q, kc, vc, layer, lens,
                                               kv_scale=kv_scale)
        torch.cuda.synchronize()
        err[keys[0]] = max(err[keys[0]], compare(
            f"read-only {name} lens={lens.tolist()}", got, ref, errors))
        if da.decode_attention_kernel.launches != n0 + 1:
            errors.append(f"read-only decode {kind} {name}: not one launch")
        if not (torch.equal(kc, before[0]) and torch.equal(vc, before[1])):
            errors.append(f"read-only decode {kind} {name}: cache written")
        kc2, vc2 = kc.clone(), vc.clone()
        n0 = da.fused_decode_attention.launches
        got = da.fused_decode_attention(q, kn, vn, kc, vc, layer, pt,
                                        kv_scale=kv_scale)
        ref = da.fused_decode_attention_plain(q, kn, vn, kc2, vc2, layer, pt,
                                              kv_scale=kv_scale)
        torch.cuda.synchronize()
        err[keys[1]] = max(err[keys[1]], compare(
            f"fused {name} pos={pos}", got, ref, errors))
        if da.fused_decode_attention.launches != n0 + 1:
            errors.append(f"fused decode {kind} {name}: not one launch")
        same = torch.equal(kc, kc2) and torch.equal(vc, vc2)
        moved = (kc != before[0]).any(-1).any(2) | (vc != before[1]).any(-1).any(2)
        allowed = torch.zeros_like(moved)
        for i, p_ in enumerate(pos):
            if p_ < s:
                allowed[layer, i, p_] = True
        only = not bool((moved & ~allowed).any())
        print(f"  fused {name}: caches equal the plain write bit for bit: "
              f"{same}; no row but pos moved: {only}")
        if not (same and only):
            errors.append(f"fused decode {kind} {name}: caches differ from "
                          "the plain write")
        if b != 1 or (b, hq, hkv, s, pos) in edges:
            continue
        p_ = pos[0]
        t_r = time_ms(lambda i: da.decode_attention_kernel(
            q, kc, vc, layer, lens, kv_scale=kv_scale))
        t_rp = time_ms(lambda i: da.decode_attention_kernel_plain(
            q, kc, vc, layer, lens, kv_scale=kv_scale))
        t_f = time_ms(lambda i: da.fused_decode_attention(
            q, kn, vn, kc, vc, layer, pt, kv_scale=kv_scale))
        t_fp = time_ms(lambda i: da.fused_decode_attention_plain(
            q, kn, vn, kc2, vc2, layer, pt, kv_scale=kv_scale))
        t_3 = time_ms(lambda i: da.dma_decode_attention(
            q, kn, vn, kc, vc, layer, pt, kv_scale=kv_scale))
        # the yardstick reads bf16 K/V (dequantized beforehand)
        kl = kv_bf16(kc[layer, :, :, :p_ + 1], kv)
        vl = kv_bf16(vc[layer, :, :, :p_ + 1], kv)
        t_l = time_ms(lambda i: F.scaled_dot_product_attention(
            q[:, :, None], kl, vl))
        # row 9 also reads the new K/V (row pos is written, not read)
        for key, t_k, t_p, write, what in (
                (keys[0], t_r, t_rp, False, "read-only"),
                (keys[1], t_f, t_fp, True, "fused")):
            b_ms, b_by = bound_ms(*decode_work([p_ + 1], hq, hkv, d, kv,
                                               write))
            print(f"  time {what} {name} pos={p_}: kernel {t_k:.4f} ms, "
                  f"plain {t_p:.4f} ms, library(sdpa, no write) {t_l:.4f} "
                  f"ms, bound {b_ms:.5f} ms ({b_by})")
            if s == 128:
                results[key] = dict(
                    ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                    bound_by=b_by, shape=f"B=1 Hq=Hkv=32 S_max=128 pos=45 "
                    f"D=128 bf16 q, {kv or 'bf16'} cache")
            elif kv:    # path 5's rows
                results[key].setdefault("more", []).append(dict(
                    ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                    bound_by=b_by, shape=f"B=1 Hq=Hkv=32 S_max={s} "
                    f"pos={p_} D=128 bf16 q, {kv} cache"))
        print(f"  time kernel 3 (dma_decode_attention, the same body) on the "
              f"same inputs: {t_3:.4f} ms; fused / kernel 3 = "
              f"{t_f / t_3:.2f}")
    for key in keys:
        results[key]["max_abs_err"] = err[key]


# ---------------------------------------------------------------------------
# kernel 4
# ---------------------------------------------------------------------------

def check_rmsnorm_quant(errors, results):
    import torch
    from trtllm_llama_tpu_torch.ops.kernels import rmsnorm_quant as rnq

    print("kernel rmsnorm_quant (RMSNorm -> per-row int8 + scale, bf16 x):")
    g = torch.Generator(device="cuda").manual_seed(5)
    max_err = 0.0
    # the paths' rows, Task A's 1024-row bucket, and D = 1000 (125 loads
    # of 8 elements: a row's threads hold unequal shares)
    for m, d in [(m, 4096) for m in PATH_ROWS + (1024,)] + [(3, 1000)]:
        x = (3 * torch.randn((m, d), generator=g, device="cuda")
             ).to(torch.bfloat16)
        w = (1 + 0.1 * torch.randn((d,), generator=g, device="cuda")
             ).to(torch.bfloat16)
        n0 = rnq.rmsnorm_quant.launches
        q, s = rnq.rmsnorm_quant(x, w)
        if rnq.rmsnorm_quant.launches != n0 + 1:
            errors.append(f"rmsnorm_quant M={m} D={d}: not one launch")
        q_ref, s_ref = rnq.rmsnorm_quant_plain(x, w)
        torch.cuda.synchronize()
        step = (q.int() - q_ref.int()).abs().max().item()
        moved = int((q != q_ref).sum())
        s_rel = ((s - s_ref).abs() / s_ref).max().item()
        err = (q.float() * s - q_ref.float() * s_ref).abs().max().item()
        max_err = max(max_err, err)
        ok = step <= 1 and s_rel <= 1e-6
        print(f"  M={m} D={d}: codes within {step} (tol 1; {moved} of "
              f"{m * d} moved), scale max rel err {s_rel:.2e} (tol 1e-6), "
              f"dequantized max_abs_err {err:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            errors.append(f"rmsnorm_quant M={m}: codes {step}, scale {s_rel:.2e}")
        t_k = time_ms(lambda i: rnq.rmsnorm_quant(x, w))
        t_p = time_ms(lambda i: rnq.rmsnorm_quant_plain(x, w))
        n_bytes = m * d * 2 + d * 2 + m * d + m * 4
        b_ms, b_by = bound_ms(n_bytes, 10 * m * d, F32_FLOPS)
        print(f"  time M={m} D={d}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
              f"library — (no single PyTorch call), bound {b_ms:.6f} ms "
              f"({b_by})")
        if m == 1:
            results["rmsnorm_quant"] = dict(
                ms=t_k, plain_ms=t_p, library_ms=None, bound_ms=b_ms,
                bound_by=b_by, shape="M=1 D=4096 bf16 (decode norm)")
        elif m == 1024:
            results["rmsnorm_quant"].update(m1024_ms=t_k, m1024_plain_ms=t_p,
                                            m1024_bound_ms=b_ms)
    results["rmsnorm_quant"]["max_abs_err"] = max_err


# ---------------------------------------------------------------------------
# kernel 5
# ---------------------------------------------------------------------------

def int_mm_ms(x_q, ws):
    """torch._int_mm (the int32 product on the int8 tensor cores, cuBLAS)
    over the weights `ws` in turn, a yardstick: (row-major [K, N] as the
    engine dir stores it, a column-major copy made outside the timed
    region); None where it refuses the layout."""
    import torch
    out = []
    for w in (ws, [v.t().contiguous().t() for v in ws]):
        try:
            out.append(time_ms(lambda i: torch._int_mm(x_q, w[i % len(w)])))
        except RuntimeError:
            out.append(None)
    return tuple(out)


def _fmt_ms(t, m=17):
    if m < 17:
        return "not run (it takes more than 16 rows)"
    return "refused" if t is None else f"{t:.4f} ms"


def check_w8a8(errors, results):
    """Row 6 at LLaMA-7B's four projection shapes, every W8A8_ROWS count
    (and 8192 rows at the qkv shape): the GEMM and the dp4a kernel, each
    forced onto its route, against the plain version bit for bit; their
    times side by side (the crossover), the plain version's, the bf16
    matmul of the dequantized operands and torch._int_mm (yardsticks) and
    the bound. Per-token s_x and per-channel s_w, as path 2 runs it (per-
    tensor s_w once, at 1024 rows)."""
    import torch
    from trtllm_llama_tpu_torch.config import ModelConfig
    from trtllm_llama_tpu_torch.ops.kernels import w8a8_matmul as w8a8

    print("kernel w8a8_matmul_stacked (int8 x int8 -> exact int32, f32 out): "
          "the dp4a kernel and the int8 wgmma GEMM:")
    cfg = ModelConfig.llama_7b()
    d, f = cfg.hidden_size, cfg.intermediate_size
    qkv = cfg.num_heads * cfg.head_dim + 2 * cfg.num_kv_heads * cfg.head_dim
    shapes = [("qkv", d, qkv), ("wo", d, d), ("gate/up", d, f), ("down", f, d)]
    g = torch.Generator(device="cuda").manual_seed(6)
    n_l = N_WEIGHT_LAYERS
    err_dp4a = err_gemm = 0.0
    table = {}
    for pname, k, n in shapes:
        w_q = torch.randint(-128, 128, (n_l, k, n), generator=g, device="cuda",
                            dtype=torch.int8)
        s_w = torch.rand((n_l, n), generator=g, device="cuda") * 1e-3 + 1e-4
        deq = (w_q.float() * s_w[:, None, :]).to(torch.bfloat16)  # yardstick
        rows = W8A8_ROWS + ((LONG_PROMPT,) if pname == "qkv" else ())
        table[pname] = {}
        for m in rows:
            x_q = torch.randint(-128, 128, (m, k), generator=g, device="cuda",
                                dtype=torch.int8)
            s_x = torch.rand((m, 1), generator=g, device="cuda") * 0.05 + 1e-3
            ref = w8a8.w8a8_matmul_stacked_plain(x_q, w_q, s_x, s_w, 1)
            with w8a8_route(gemm=True):
                err_gemm = max(err_gemm, exact(
                    f"{pname} K={k} N={n} M={m} (GEMM)",
                    w8a8.w8a8_matmul_stacked(x_q, w_q, s_x, s_w, 1), ref,
                    errors))
                if m == 1024:
                    s_w1 = s_w[:, :1].contiguous()
                    err_gemm = max(err_gemm, exact(
                        f"{pname} K={k} N={n} M={m} per-tensor s_w (GEMM)",
                        w8a8.w8a8_matmul_stacked(x_q, w_q, s_x, s_w1, 1),
                        w8a8.w8a8_matmul_stacked_plain(x_q, w_q, s_x, s_w1,
                                                       1), errors))
                t_gemm = time_ms(lambda i: w8a8.w8a8_matmul_stacked(
                    x_q, w_q, s_x, s_w, i % n_l))
            t_dp4a = None
            if m != LONG_PROMPT:        # the dp4a kernel takes ~80 ms there
                few = dict(iters=4, warmup=1, reps=1) if m > 64 else {}
                with w8a8_route(gemm=False):
                    err_dp4a = max(err_dp4a, exact(
                        f"{pname} K={k} N={n} M={m} (dp4a)",
                        w8a8.w8a8_matmul_stacked(x_q, w_q, s_x, s_w, 1), ref,
                        errors))
                    t_dp4a = time_ms(lambda i: w8a8.w8a8_matmul_stacked(
                        x_q, w_q, s_x, s_w, i % n_l), **few)
            del ref
            big = m > 64
            t_p = time_ms(lambda i: w8a8.w8a8_matmul_stacked_plain(
                x_q, w_q, s_x, s_w, i % n_l), iters=2 if big else 8,
                **(dict(warmup=1, reps=1) if big else {}))
            xd = (x_q.float() * s_x).to(torch.bfloat16)
            t_l = time_ms(lambda i: torch.matmul(xd, deq[i % n_l]))
            t_i, t_ic = ((None, None) if m < 17 else
                         int_mm_ms(x_q, [w_q[i] for i in range(n_l)]))
            n_bytes = k * n + n * 4 + m * k + m * 4 + m * n * 4
            b_ms, b_by = bound_ms(n_bytes, 2 * m * k * n, INT8_OPS)
            table[pname][m] = dict(gemm_ms=t_gemm, dp4a_ms=t_dp4a,
                                   plain_ms=t_p, library_ms=t_l,
                                   int_mm_ms=t_i, int_mm_col_major_ms=t_ic,
                                   bound_ms=b_ms, bound_by=b_by)
            print(f"  time {pname} M={m}: GEMM {t_gemm:.4f} ms "
                  f"({100 * b_ms / t_gemm:.1f}% of the bound), dp4a "
                  f"{'not timed' if t_dp4a is None else f'{t_dp4a:.4f} ms'}"
                  f", plain {t_p:.4f} ms, library(matmul bf16, dequantized "
                  f"operands) {t_l:.4f} ms, torch._int_mm row-major "
                  f"{_fmt_ms(t_i, m)} / column-major copy {_fmt_ms(t_ic, m)}, "
                  f"bound {b_ms:.4f} ms ({b_by}); GEMM {t_gemm / t_l:.2f}x "
                  "the bf16 library")
            if pname == "qkv" and m in (1, 1024):
                key = "w8a8_matmul_stacked" if m == 1 else W8A8_GEMM
                results[key] = dict(
                    ms=t_dp4a if m == 1 else t_gemm, plain_ms=t_p,
                    library_ms=t_l, bound_ms=b_ms, bound_by=b_by,
                    shape=f"M={m} K={k} N={n} ("
                          + ("decode qkv, dp4a)" if m == 1 else
                             "qkv, the Task A prefill's bucket, GEMM)"),
                    launches=0)
            del x_q, xd
        del w_q, deq
    results["w8a8_matmul_stacked"]["max_abs_err"] = err_dp4a
    results[W8A8_GEMM]["max_abs_err"] = err_gemm
    results["_e2e"]["row 6 GEMM vs dp4a"] = table
    # the crossover: the fewest rows from which the GEMM is the faster at
    # every timed count and shape
    rows = [m for m in W8A8_ROWS
            if all(table[p][r]["gemm_ms"] < table[p][r]["dp4a_ms"]
                   for p in table for r in W8A8_ROWS if r >= m)]
    cross = min(rows) if rows else None
    print(f"  W8A8 crossover: the GEMM is the faster from M = {cross} on at "
          f"every shape (W8A8_GEMM_MIN_ROWS {w8a8.W8A8_GEMM_MIN_ROWS}: "
          f"{'matches' if cross == w8a8.W8A8_GEMM_MIN_ROWS else 'DIFFERS'})")
    results["_e2e"]["row 6 crossover"] = dict(
        measured=cross, W8A8_GEMM_MIN_ROWS=w8a8.W8A8_GEMM_MIN_ROWS)
    for pname in table:
        factor = table[pname][1024]["dp4a_ms"] / table[pname][1024]["gemm_ms"]
        print(f"  {pname} M=1024: the GEMM {factor:.1f}x faster than dp4a "
              "(at least 10x required)")
        if factor < 10:
            errors.append(f"w8a8 GEMM {pname} M=1024: only {factor:.1f}x the "
                          "dp4a kernel's speed")
    check_w8a8_2d(errors, results)


# row 5's shapes on path 7 (static SmoothQuant): the fused qkv, wo, gate or
# up, the fused gate/up (TLLM_FUSE_GU) and down
W8A8_2D_SHAPES = [("qkv", 4096, 12288), ("wo", 4096, 4096),
                  ("gate, up", 4096, 11008), ("gate/up fused", 4096, 22016),
                  ("down", 11008, 4096)]
W8A8_2D_ROWS = (1, 8, 64, TASK_A_PROMPT)   # decode, bs1 prefill, ..., Task A


def check_w8a8_2d(errors, results):
    """The 2-D entry (row 5) at path 7's shapes and W8A8_2D_ROWS, with a
    static scalar s_x and per-tensor or per-channel s_w, bit for bit
    against the plain version on the route w8a8_gemm_route picks; timed
    over N_WEIGHT_LAYERS distinct weights in turn, so each call finds its
    weight cold in L2."""
    import torch
    from trtllm_llama_tpu_torch.ops.kernels import w8a8_matmul as w8a8

    print("kernel w8a8_matmul (2-D entry, static scalar s_x; L2-cold):")
    g = torch.Generator(device="cuda").manual_seed(15)
    n_l = N_WEIGHT_LAYERS
    s_x = torch.tensor(0.02, device="cuda")
    err_max = {False: 0.0, True: 0.0}
    for pname, k, n in W8A8_2D_SHAPES:
        ws = [torch.randint(-128, 128, (k, n), generator=g, device="cuda",
                            dtype=torch.int8) for _ in range(n_l)]
        for per_channel in (True, False):
            s_w = torch.rand((n if per_channel else 1,), generator=g,
                             device="cuda") * 1e-3 + 1e-4
            deq = [(w.float() * s_w).to(torch.bfloat16) for w in ws]
            sw_what = "per-channel" if per_channel else "per-tensor"
            for m in W8A8_2D_ROWS:
                gemm = w8a8.w8a8_gemm_route(m, k, n)
                kind = "GEMM" if gemm else "dp4a"
                x_q = torch.randint(-128, 128, (m, k), generator=g,
                                    device="cuda", dtype=torch.int8)
                err_max[gemm] = max(err_max[gemm], exact(
                    f"{pname} K={k} N={n} M={m} {sw_what} s_w ({kind})",
                    w8a8.w8a8_matmul(x_q, ws[1], s_x, s_w),
                    w8a8.w8a8_matmul_plain(x_q, ws[1], s_x, s_w), errors))
                t_k = time_ms(lambda i: w8a8.w8a8_matmul(
                    x_q, ws[i % n_l], s_x, s_w))
                big = m > 64
                t_p = time_ms(lambda i: w8a8.w8a8_matmul_plain(
                    x_q, ws[i % n_l], s_x, s_w), iters=2 if big else 8,
                    **(dict(warmup=1, reps=1) if big else {}))
                xd = (x_q.float() * s_x).to(torch.bfloat16)
                t_l = time_ms(lambda i: torch.matmul(xd, deq[i % n_l]))
                t_i = int_mm_ms(x_q, ws)[0] if m >= 17 else None
                n_bytes = k * n + s_w.numel() * 4 + m * k + 4 + m * n * 4
                b_ms, b_by = bound_ms(n_bytes, 2 * m * k * n, INT8_OPS)
                print(f"  time {pname} M={m} {sw_what} ({kind}): kernel "
                      f"{t_k:.4f} ms, plain {t_p:.4f} ms, library(matmul "
                      f"bf16, dequantized operands) {t_l:.4f} ms, "
                      f"torch._int_mm {_fmt_ms(t_i, m)}, bound {b_ms:.4f} ms "
                      f"({b_by}), {100 * b_ms / t_k:.1f}% of it")
                entry = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                             bound_ms=b_ms, bound_by=b_by,
                             shape=f"M={m} K={k} N={n} {sw_what} s_w "
                                   f"({pname}, {kind})")
                # path 7 runs qkv per-tensor: decode (M=1) on dp4a, the
                # Task A prefill on the GEMM
                key = ("w8a8_matmul" if not gemm else W8A8_GEMM_2D)
                if (pname == "qkv" and not per_channel
                        and m in (1, TASK_A_PROMPT)):
                    results[key] = dict(entry, launches=0)
                else:
                    results.setdefault(f"_{key} more", []).append(entry)
            del deq
        del ws
    results["w8a8_matmul"]["max_abs_err"] = err_max[False]
    results[W8A8_GEMM_2D]["max_abs_err"] = err_max[True]
    results["w8a8_matmul"]["more"] = results.pop("_w8a8_matmul more", [])
    results[W8A8_GEMM_2D]["more"] = results.pop(f"_{W8A8_GEMM_2D} more", [])


# ---------------------------------------------------------------------------
# kernels 13 and 14, at the serving phase's shapes
# ---------------------------------------------------------------------------

def check_packed_prefill(errors, results):
    """Row 13 against its plain version: segment edges, GQA, the head dims
    of the other families and fp16, and each packed serving wave's stream
    (bf16, 32 heads of 128; timed beside the bound and SDPA with the
    block-diagonal causal mask)."""
    import torch
    import torch.nn.functional as F
    from trtllm_llama_tpu_torch.ops.kernels import packed_prefill_attention as ppa

    print("kernel packed_prefill_attention_kernel (packed causal GQA; the "
          "wgmma flash tile):")
    g = torch.Generator(device="cuda").manual_seed(13)
    bf16, f16 = torch.bfloat16, torch.float16
    waves = serve_waves()
    first = waves[1]                 # the counted run's first admission
    cases = [  # (T, Hq, Hkv, D, dtype, segment lengths; pad rows follow)
        (64, 32, 32, 128, bf16, [20, 30, 1]),   # a 1-row segment, segments crossing tiles
        (256, 32, 8, 128, bf16, [100, 1, 77]),  # GQA group of 4
        # a 1-row segment on a tile edge, pad rows; GPT-NeoX's and GPT-J's
        # head dims, fp16
        (200, 32, 8, 96, bf16, [64, 1, 63, 65]),
        (200, 16, 16, 256, bf16, [64, 1, 63, 65]),
        (200, 32, 8, 128, f16, [64, 1, 63, 65]),
        (200, 16, 16, 256, f16, [64, 1, 63, 65]),
    ] + [(packed_len(sum(w)), 32, 32, 128, bf16, w) for w in waves]  # serving
    max_err, timed = 0.0, []
    for t, hq, hkv, d, dtype, lens in cases:
        q, k, v = (torch.randn((t, h, d), generator=g, device="cuda"
                               ).to(dtype) for h in (hq, hkv, hkv))
        seg = torch.full((t,), -1, dtype=torch.int32, device="cuda")
        off = 0
        for i, n in enumerate(lens):
            seg[off:off + n] = i
            off += n
        got = ppa.packed_prefill_attention_kernel(q, k, v, seg)
        ref = ppa.packed_prefill_attention_kernel_plain(q, k, v, seg)
        torch.cuda.synchronize()
        name = (f"T={t} Hq={hq} Hkv={hkv} D={d} "
                f"{'fp16' if dtype == f16 else 'bf16'} segments={lens}")
        if not bool(torch.isfinite(got.float()).all()):
            errors.append(f"packed prefill {name}: non-finite rows")
        real = seg >= 0
        max_err = max(max_err, compare(name, got[real], ref[real], errors))
        if lens not in waves:
            continue
        qt, kt, vt = (x.transpose(0, 1)[None] for x in (q, k, v))
        rows = torch.arange(t, device="cuda")
        mask = ((rows[None, :] <= rows[:, None])
                & (seg[:, None] == seg[None, :]))
        t_k = time_ms(lambda i: ppa.packed_prefill_attention_kernel(q, k, v, seg))
        t_p = time_ms(lambda i: ppa.packed_prefill_attention_kernel_plain(
            q, k, v, seg), iters=8)
        t_l = time_ms(lambda i: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask))
        b_ms, b_by = bound_ms(*packed_attention_work(lens, t, hq, hkv, d))
        print(f"  time {name}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
              f"library(sdpa, block-diagonal causal mask) {t_l:.4f} ms, "
              f"bound {b_ms:.5f} ms ({b_by}), {100 * b_ms / t_k:.1f}% of it")
        timed.append((lens is first, dict(
            ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
            bound_by=b_by, shape=f"T={t} ({sum(lens)} prompt rows in "
            f"{len(lens)} segments) Hq=Hkv=32 D=128 bf16")))
    # the counted run's first admission first, the other waves beside it
    results["packed_prefill_attention_kernel"] = dict(
        next(e for is_first, e in timed if is_first),
        more=[e for is_first, e in timed if not is_first],
        max_abs_err=max_err)


def check_paged_decode(errors, results, kv=None):
    """Row 14 (one launch of the split-cache body through the block table)
    against its plain version: serving's shapes (a sequence whose table is
    all -1 writing and reading trash row 0), block sizes 8 / 16 / 24 / 96
    (24 and 96 cross the body's 64-row tile), a position at MB * BS (the
    trash block), and path 5's length (B=1, 8201 live rows) through a
    shuffled table, timed beside kernel 3 on the same rows stored dense;
    the pools equal to the plain write bit for bit, every other row
    untouched, one launch a call. kv: the pools' kind (None: bf16,
    "int8", "e4m3")."""
    import torch
    import torch.nn.functional as F
    from trtllm_llama_tpu_torch.ops.kernels import decode_attention as da
    from trtllm_llama_tpu_torch.ops.kernels import paged_decode_attention as pda

    kind = (f"{kv} pools, scale {KV_SCALE} per layer" if kv
            else "bf16 pools")
    print(f"kernel paged_decode_attention (KV write through the block table "
          f"+ attention, {kind}):")
    g = torch.Generator(device="cuda").manual_seed(
        {None: 14, "int8": 15, "e4m3": 24}[kv])
    d, n_l, layer, hq, hkv = 128, 2, 1, 32, 32
    smax = SERVE_ENGINE["max_seq_len"]
    slots = SERVE_ENGINE["max_batch_size"]
    waves = serve_waves()
    serve_pos = [n + SERVE_NEW // 2 for n in waves[1]]   # mid-generation
    last_pos = [n + SERVE_NEW - 2 for n in waves[-1]]    # last decode step
    cases = [  # (block size, table blocks, positions, the trash row last)
        (SERVE_BLOCK, None, serve_pos + [0], True),     # the serving shapes
        (SERVE_BLOCK, None, last_pos + [0], True),
        (8, None, serve_pos, False), (16, None, serve_pos, False),
        (24, None, serve_pos, False), (96, None, serve_pos + [0], True),
        # a position at MB * BS: writes the trash block, attends MB blocks
        (SERVE_BLOCK, None,
         serve_pos[:7] + [-(-smax // SERVE_BLOCK) * SERVE_BLOCK], False),
        # path 5's length, one sequence through a shuffled table
        (SERVE_BLOCK, LONG_S_MAX // SERVE_BLOCK, [8200], False),
    ]
    kv_scale = (torch.full((n_l,), KV_SCALE, device="cuda") if kv
                else None)
    key = DECODE_KEYS[kv][3]
    sms = da.sm_count(0)
    max_err = 0.0
    for bs, mb, pos, trash_row in cases:
        long_case = mb is not None
        mb = mb or -(-smax // bs)
        b = len(pos)
        nb = (1 if long_case else slots) * mb + 1
        tables = torch.randperm(nb - 1, generator=g, device="cuda")[
            :(nb - 1) // mb * mb].reshape(-1, mb)
        if trash_row:
            tables = torch.cat([tables, torch.full((1, mb), -1,
                                                   device="cuda")])
        tables = tables[-b:] if trash_row else tables[:b]
        tables = tables.to(torch.int32).contiguous()
        shape = (n_l, nb, hkv, bs, d)
        pk, pv = kv_cache(shape, kv, g), kv_cache(shape, kv, g)
        q = torch.randn((b, hq, d), generator=g, device="cuda").to(torch.bfloat16)
        amp = NEW_KV_AMP[kv]
        kn = (amp * torch.randn((b, hkv, d), generator=g, device="cuda")
              ).to(torch.bfloat16)
        vn = (amp * torch.randn((b, hkv, d), generator=g, device="cuda")
              ).to(torch.bfloat16)
        pt = torch.tensor(pos, dtype=torch.int32, device="cuda")
        pk2, pv2, before = pk.clone(), pv.clone(), (pk.clone(), pv.clone())
        n0 = pda.paged_decode_attention.launches
        got = pda.paged_decode_attention(q, kn, vn, pk, pv, layer, tables, pt,
                                         kv_scale=kv_scale)
        ref = pda.paged_decode_attention_plain(q, kn, vn, pk2, pv2, layer,
                                               tables, pt, kv_scale=kv_scale)
        torch.cuda.synchronize()
        name = (f"B={b} BS={bs} MB={mb} pos={pos if b < 9 else 'serving'} "
                f"splits {da.decode_split(b, hkv, mb * bs, hq // hkv, sms)}")
        max_err = max(max_err, compare(name, got, ref, errors))
        same = torch.equal(pk, pk2) and torch.equal(pv, pv2)
        _, w_blk, w_row = pda._write_blocks(tables, pt, nb, bs)
        allowed = torch.zeros(pk.shape[:2] + (bs,), dtype=torch.bool,
                              device="cuda")
        allowed[layer, w_blk, w_row] = True
        moved = ((pk != before[0]).any(-1) | (pv != before[1]).any(-1)).any(2)
        only = not bool((moved & ~allowed).any())
        print(f"  {name}: pools equal the plain write bit for bit: {same}; "
              f"every row outside the write rows untouched: {only}")
        if not (same and only):
            errors.append(f"paged decode {kind} {name}: pools differ from "
                          "the plain write")
        if pda.paged_decode_attention.launches != n0 + 1:
            errors.append(f"paged decode {kind} {name}: not one launch a call")
        if pos is not cases[0][2] and not long_case:
            continue
        t_k = time_ms(lambda i: pda.paged_decode_attention(
            q, kn, vn, pk, pv, layer, tables, pt, kv_scale=kv_scale))
        t_p = time_ms(lambda i: pda.paged_decode_attention_plain(
            q, kn, vn, pk2, pv2, layer, tables, pt, kv_scale=kv_scale))
        # the yardstick reads K/V gathered (and dequantized) beforehand

        def gathered(pool):
            x = pool[layer][tables.long()].permute(0, 2, 1, 3, 4)
            return x.reshape(b, hkv, mb * bs, d).contiguous()
        kg, vg = gathered(pk), gathered(pv)
        kgl, vgl = kv_bf16(kg, kv), kv_bf16(vg, kv)
        mask = (torch.arange(mb * bs, device="cuda")[None, :]
                <= pt[:, None])[:, None, None]
        t_l = time_ms(lambda i: F.scaled_dot_product_attention(
            q[:, :, None], kgl, vgl, attn_mask=mask))
        live = [min(p + 1, mb * bs) for p in pos]
        n_bytes, flops = decode_work(live, hq, hkv, d, kv, True)
        b_ms, b_by = bound_ms(n_bytes + b * mb * 4, flops)   # + block table
        dense = ""
        if long_case:   # kernel 3 on the same rows, stored dense
            kc = torch.zeros((n_l, b, hkv, mb * bs, d), dtype=pk.dtype,
                             device="cuda")
            vc = torch.zeros_like(kc)
            kc[layer], vc[layer] = kg, vg
            got_d = da.dma_decode_attention(q, kn, vn, kc, vc, layer, pt,
                                            kv_scale=kv_scale)
            torch.cuda.synchronize()
            compare(f"{name}: kernel 3 on the rows stored dense", got_d, ref,
                    errors)
            t_d = time_ms(lambda i: da.dma_decode_attention(
                q, kn, vn, kc, vc, layer, pt, kv_scale=kv_scale))
            dense = f", kernel 3 on the same rows dense {t_d:.4f} ms"
            del kc, vc
        print(f"  time {name}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
              f"library(sdpa over pre-gathered K/V, no write) {t_l:.4f} ms, "
              f"bound {b_ms:.5f} ms ({b_by}){dense}")
        if b == 9:      # the 8 slots alone: 256 blocks, one wave of 2 an SM
            t_8 = time_ms(lambda i: pda.paged_decode_attention(
                q[:8], kn[:8], vn[:8], pk, pv, layer, tables[:8], pt[:8],
                kv_scale=kv_scale))
            print(f"  time {name}, its first 8 sequences alone: kernel "
                  f"{t_8:.4f} ms")
        if long_case:
            results[key].update(long_ms=t_k, long_dense_ms=t_d,
                                long_plain_ms=t_p, long_library_ms=t_l,
                                long_bound_ms=b_ms)
        else:
            results[key] = dict(
                ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                bound_by=b_by, shape=f"B=9 (8 slots + trash) BS={bs} MB={mb} "
                f"Hq=Hkv=32 D=128, {sum(live)} live rows, bf16 q, "
                f"{kv or 'bf16'} pools")
        del kg, vg, kgl, vgl
    results[key]["max_abs_err"] = max_err


# ---------------------------------------------------------------------------
# the two paths
# ---------------------------------------------------------------------------

def make_paths():
    """Each path: its config, its int8-KV scales, its kernels (JSON name ->
    (module, wrapper attribute)), the JSON name of its GEMM (kernels 1 and
    6 at bs4's 64-row prefill) and of its tensor-core GEMV (the 16-row bs1
    prefills and bs4's 4-row decode steps), and the wrappers replaced by
    their plain versions for the prefill-logits check."""
    from trtllm_llama_tpu_torch import ModelConfig, QuantMode
    from trtllm_llama_tpu_torch.ops.kernels import decode_attention as da
    from trtllm_llama_tpu_torch.ops.kernels import fp8_matmul as f8k
    from trtllm_llama_tpu_torch.ops.kernels import prefill_attention as pa
    from trtllm_llama_tpu_torch.ops.kernels import rmsnorm_quant as rnq
    from trtllm_llama_tpu_torch.ops.kernels import w8a8_matmul as w8a8
    from trtllm_llama_tpu_torch.ops.kernels import woq_matmul as woq

    attn = {"prefill_attention_kernel": pa, "dma_decode_attention": da}
    woq_gemm = dict(route=route, floor=lambda: woq.GEMM_MIN_ROWS)
    # Paths 3 and 4 run SHORT_DEPTH layers (the smoke's time budget): path
    # 8 runs path 4's weight kernels at full depth; the int4 ones run only
    # here.
    return [
        dict(tag="path 1", title="int8 weight-only per-channel, bf16 KV",
             mode=QuantMode.use_weight_only(), kv_scales=None,
             kernels={"woq_matmul_stacked": woq, GEMM_INT8: woq,
                      TC_INT8: woq, **attn},
             gemm=GEMM_INT8, tc=TC_INT8, **woq_gemm,
             plain=[(woq, "woq_matmul_stacked"),
                    (pa, "prefill_attention_kernel")],
             modes={"split": READ_ONLY, "fused": FUSED},
             decode="dma_decode_attention",
             fused=("woq_matmul_stacked", SWIGLU_INT8), sampling=True,
             rerun=False),
        dict(tag="path 2", title="SmoothQuant W8A8 (per-token activation, "
             f"per-channel weight scales), int8 KV (scale {KV_SCALE})",
             mode=(QuantMode.use_smooth_quant(per_token=True, per_channel=True)
                   | QuantMode.INT8_KV_CACHE),
             kv_scales=[KV_SCALE] * ModelConfig.llama_7b().num_layers,
             kernels={"rmsnorm_quant": rnq, "w8a8_matmul_stacked": w8a8,
                      W8A8_GEMM: w8a8, "prefill_attention_kernel": pa,
                      INT8_DECODE: da},
             gemm=W8A8_GEMM, route=w8a8_route,
             floor=lambda: w8a8.W8A8_GEMM_MIN_ROWS, exact=True, task_a=True,
             plain=[(rnq, "rmsnorm_quant"), (w8a8, "w8a8_matmul_stacked"),
                    (pa, "prefill_attention_kernel")],
             modes={"split": READ_ONLY_INT8, "fused": FUSED_INT8},
             decode=INT8_DECODE),
        dict(tag="path 3", title="int4 weight-only, g128 projections, int4 "
             "per-channel lm_head (quantize_params), bf16 KV",
             mode=QuantMode.use_weight_only(True, per_group=True),
             group_size=128, lm_head=True, kv_scales=None, depth=SHORT_DEPTH,
             kernels={INT4_STACKED: woq, INT4_2D: woq, GEMM_INT4: woq,
                      TC_INT4: woq, TC_INT4_2D: woq, **attn},
             gemm=GEMM_INT4, tc=TC_INT4, **woq_gemm,
             plain=[(woq, "woq_matmul_stacked"), (woq, "woq_matmul"),
                    (pa, "prefill_attention_kernel")],
             fused=("woq_matmul_stacked", SWIGLU_INT4)),
        dict(tag="path 4", title="fp8 (e4m3) per-channel projections, fp8 "
             "lm_head (quantize_params), bf16 KV",
             mode=QuantMode.FP8_QDQ, lm_head=True, kv_scales=None,
             depth=SHORT_DEPTH,
             kernels={"fp8_matmul_stacked": f8k, "fp8_matmul": f8k,
                      GEMM_FP8: f8k, TC_FP8: f8k, TC_FP8_2D: f8k, **attn},
             gemm=GEMM_FP8, tc=TC_FP8, **woq_gemm,
             plain=[(f8k, "fp8_matmul_stacked"), (f8k, "fp8_matmul"),
                    (pa, "prefill_attention_kernel")],
             fused=("fp8_matmul_stacked", SWIGLU_FP8)),
        # bench.py's fp8kv (bench.py:127, kv scale 0.05 at :142-145): path
        # 4's weights with an e4m3 cache; kernel 3, rows 8 and 9 on its
        # e4m3 branch; the GEMM / GEMV counts are path 4's to hold
        dict(tag="path 8", title="bench.py's fp8kv: fp8 (e4m3) per-channel "
             "projections, fp8 lm_head (quantize_params), e4m3 KV cache "
             f"(scale {KV_SCALE})",
             mode=QuantMode.FP8_QDQ | QuantMode.FP8_KV_CACHE, lm_head=True,
             kv_scales=[KV_SCALE] * ModelConfig.llama_7b().num_layers,
             kernels={"fp8_matmul_stacked": f8k, "fp8_matmul": f8k,
                      GEMM_FP8: f8k, TC_FP8: f8k, TC_FP8_2D: f8k,
                      "prefill_attention_kernel": pa, E4M3_DECODE: da},
             plain=[(f8k, "fp8_matmul_stacked"), (f8k, "fp8_matmul"),
                    (pa, "prefill_attention_kernel")],
             # 'split' (row 8 e4m3) is held in the kernel phase only (the
             # smoke's time budget): its counter, zeroed with the others
             # before the path's run, must read 0 at the path's end
             modes={"fused": FUSED_E4M3}, unrun={READ_ONLY_E4M3: da},
             decode=E4M3_DECODE, fp8kv=True),
    ]


def make_path7():
    """Path 7 (run_offline_build): static per-tensor SmoothQuant W8A8 with
    an int8 KV cache, from the engine dir. Row 5 runs every projection (5
    per layer and forward: the fused qkv, wo, gate, up, down; the GEMM in
    the forwards of at least W8A8_GEMM_MIN_ROWS rows), kernel 2 once per
    layer and prefill, kernel 3 (int8) once per layer and decode step; row
    6 and rmsnorm_quant never."""
    from trtllm_llama_tpu_torch.ops.kernels import decode_attention as da
    from trtllm_llama_tpu_torch.ops.kernels import prefill_attention as pa
    from trtllm_llama_tpu_torch.ops.kernels import w8a8_matmul as w8a8

    def expect(n_l, forwards, prefills, steps, gemm_forwards):
        counts = {"w8a8_matmul": 5 * n_l * forwards,
                  "prefill_attention_kernel": n_l * prefills,
                  "dma_decode_attention": n_l * steps}
        if gemm_forwards:
            counts["w8a8_matmul.gemm_launches"] = 5 * n_l * gemm_forwards
        return counts
    return dict(
        tag="path 7", title="static SmoothQuant W8A8 + int8 KV (engine dir)",
        kernels={"w8a8_matmul": w8a8, W8A8_GEMM_2D: w8a8,
                 "prefill_attention_kernel": pa, INT8_DECODE: da},
        gemm=W8A8_GEMM_2D, route=w8a8_route,
        floor=lambda: w8a8.W8A8_GEMM_MIN_ROWS, exact=True, task_a=True,
        plain=[(w8a8, "w8a8_matmul"), (pa, "prefill_attention_kernel")],
        expect=expect, fused=("w8a8_matmul", None), streamed=True)


# max_seq_len: room for Task A's prompt at its 1024-row bucket and its
# decode steps (a session's caches hold min(max_seq_len, bucket + new) rows)
PATH_ENGINE = dict(max_batch_size=4, max_input_len=1024,
                   max_seq_len=1024 + 1 + TASK_A_DECODE)


def run_path(path, args, errors, results):
    import torch
    from trtllm_llama_tpu_torch import EngineConfig, ModelConfig
    from trtllm_llama_tpu_torch.quantization.quantize import (
        init_random_quantized_params, quantize_params,
    )
    from trtllm_llama_tpu_torch.runtime.session import GenerationSession

    tag = path["tag"]
    cfg = ModelConfig.llama_7b(quant_mode=path["mode"],
                               num_layers=min(args.layers,
                                              path.get("depth", args.layers)),
                               group_size=path.get("group_size", 0))
    kv_scales = (None if path["kv_scales"] is None
                 else path["kv_scales"][:cfg.num_layers])
    print(f"{tag}: LLaMA-7B widths, {cfg.num_layers} layers, "
          f"{path['title']}, random weights born quantized (seed 0)")
    t0 = time.perf_counter()
    params = init_random_quantized_params(cfg, seed=0, device="cuda")
    if path.get("lm_head"):
        params = quantize_params(params, cfg.quant_mode, quantize_lm_head=True)
        head = params["lm_head"]
        print(f"  lm_head quantized: {type(head).__name__} "
              f"{tuple(head.qweight.shape)} {head.qweight.dtype}")
    torch.cuda.synchronize()
    print(f"  weights init: {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    sess = GenerationSession(cfg, params, EngineConfig(**PATH_ENGINE),
                             kv_scales=kv_scales, device="cuda")
    del params
    drive_path(path, sess, errors, results)


def drive_path(path, sess, errors, results):
    """One path's runs on its session: bs1 in8 out50 (twice), a second bs1
    prompt, bs4 ragged; the launches (of the path's kernels, and with
    path["expect"] every wrapper's count held exactly); the 7B prefill
    logits against the plain path; a profile; the decode-mode runs where
    the path has them, and its TLLM_FUSE_GU re-run where it has one."""
    import numpy as np
    import torch
    from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig

    tag, cfg = path["tag"], sess.cfg
    scfg = SamplingConfig(end_id=-1)     # no early stop: all tokens generated
    rng = np.random.default_rng(0)
    new = NEW_TOKENS
    p1 = rng.integers(3, cfg.vocab_size, (1, 8))
    p2 = rng.integers(3, cfg.vocab_size, (1, 8))
    lens4 = [8, 5, 12, 3]
    p4 = [rng.integers(3, cfg.vocab_size, n).tolist() for n in lens4]

    def generate(ids, n_new):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = sess.generate(ids, sampling=scfg, max_new_tokens=n_new)
        return out, (time.perf_counter() - t) * 1e3

    generate(p1, 4)                      # warm-up (cuBLAS, allocator, libs)
    wrappers = {name: getattr(mod, KERNELS[name][0])
                for name, mod in path["kernels"].items()}
    zero_counts()
    _, pre_ms = generate(p1, 1)
    out1, ms1 = generate(p1, new)
    out1b, _ = generate(p1, new)
    out2, ms2 = generate(p2, new)
    out4, ms4 = generate(p4, new)
    launches = {name: launches_of(name, fn) for name, fn in wrappers.items()}
    # (rows, forwards) of the run: four bs1 prefills at the bucket of 8
    # tokens, bs4's at 4 x the bucket of its longest prompt, the decode
    # steps of the three bs1 requests and of bs4
    ecfg = sess.engine_cfg
    forwards = [(ecfg.bucket_for(8), 4), (4 * ecfg.bucket_for(max(lens4)), 1),
                (1, 3 * (new - 1)), (4, new - 1)]
    gemm_forwards = 0
    if "gemm" in path:   # 5 projections a layer in each forward >= the floor
        floor = path["floor"]()
        gemm_forwards = sum(n for rows, n in forwards if rows >= floor)
        n_gemm = launches[path["gemm"]]
        want = 5 * cfg.num_layers * gemm_forwards
        other = next(k for k in path["kernels"] if k != path["gemm"]
                     and KERNELS[k][0] == KERNELS[path["gemm"]][0])
        print(f"  {tag}: GEMM launches {n_gemm} (expected {want}: the "
              f"forwards of at least {floor} rows, of (rows, forwards) "
              f"{forwards}), {other} launches {launches[other]} (the rest, "
              f"and a quantized lm_head): {'ok' if n_gemm == want else 'FAIL'}")
        if n_gemm != want:
            errors.append(f"{tag}: GEMM launches {n_gemm} != {want}")
    if "tc" in path:     # 5 projections a layer in each forward it takes
        tc_forwards = sum(n for rows, n in forwards if tc_rows(rows))
        n_tc, want = launches[path["tc"]], 5 * cfg.num_layers * tc_forwards
        print(f"  {tag}: tensor-core GEMV launches {n_tc} (expected {want}: "
              f"the forwards its route takes, of (rows, forwards) "
              f"{forwards}): {'ok' if n_tc == want else 'FAIL'}")
        if n_tc != want:
            errors.append(f"{tag}: tensor-core GEMV launches {n_tc} != {want}")
    if "expect" in path:       # 1 + 4 x new forwards, 5 prefills, 4 x 49 steps
        expect = path["expect"](cfg.num_layers, 1 + 4 * new, 5, 4 * (new - 1),
                                gemm_forwards)
        check_counts(f"{tag} every wrapper", read_counts(),
                     dict(launches=expect, alibi_decode=0), errors)

    dec_ms = (ms1 - pre_ms) / (new - 1)
    print(f"  bs1 in8 out{new}: prefill {pre_ms:.2f} ms, decode "
          f"{dec_ms:.3f} ms/token, {1e3 / dec_ms:.1f} decode tokens/s, "
          f"{new / ms1 * 1e3:.1f} tokens/s end to end ({ms1:.1f} ms)")
    print(f"  bs1 second prompt: {ms2:.1f} ms; bs4 ragged {lens4}: {ms4:.1f} "
          f"ms, {4 * new / ms4 * 1e3:.1f} tokens/s")
    print(f"  launches in {tag}'s run: {launches}")
    for name, n in launches.items():
        if n <= 0:
            errors.append(f"{tag}: kernel {name} was never launched")
        results[name]["launches"] = results[name].get("launches", 0) + n
    for what, out, b in (("bs1", out1, 1), ("bs1 second", out2, 1),
                         ("bs4", out4, 4)):
        ids = out.output_ids
        ok = (ids.shape == (b, new) and (ids >= 0).all()
              and (ids < cfg.vocab_size).all()
              and (out.lengths == new).all())
        print(f"  {what} tokens {ids.shape}: {ids[0, :12].tolist()}... "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            errors.append(f"{tag} {what}: bad output {ids.shape}")
    same = np.array_equal(out1.output_ids, out1b.output_ids)
    print(f"  bs1 repeat gives identical tokens: {same}")
    if not same:
        errors.append(f"{tag}: the same bs1 request gave different tokens")
    if "gemm" in path and path.get("rerun", True):
        # bs4 with the other kernel at every row count: W8A8 is exact on
        # both, so its tokens must match; kernels 1 and 6 sum in another
        # order, so theirs may differ at near ties (path 1 no longer
        # re-runs: the smoke's budget)
        with path["route"](gemm=False):
            out4v, _ = generate(p4, new)
        same = np.array_equal(out4.output_ids, out4v.output_ids)
        print(f"  bs4 tokens identical to a run with the "
              f"{'dp4a kernel' if path.get('exact') else 'GEMV'} at every "
              f"row count: {same}")
        if path.get("exact") and not same:
            errors.append(f"{tag}: bs4 tokens differ between the GEMM and "
                          "the dp4a route")
        for row in ([] if path.get("exact") else np.flatnonzero(
                (out4.output_ids != out4v.output_ids).any(1))):
            first_difference(f"{tag} GEMM vs GEMV bs4 row {row}", sess, sess,
                             p4, out4.output_ids, out4v.output_ids, row,
                             errors, route_b=False)
    results["_e2e"][tag] = dict(
        layers=cfg.num_layers, prefill_ms=pre_ms, decode_ms_per_token=dec_ms,
        decode_tokens_per_s=1e3 / dec_ms, e2e_tokens_per_s=new / ms1 * 1e3,
        bs4_tokens_per_s=4 * new / ms4 * 1e3)

    print("  7B prefill logits, kernels vs plain versions on the card:")
    prefill_logits_vs_plain("", path["plain"], sess, p1, p4, errors)
    if path.get("streamed"):
        streamed_logits_vs_plain(path, sess, p1, p4, errors)
    dev_tok, busy = profile_generate(sess, p1, scfg)
    results["_e2e"][tag].update(device_ms_per_decode_token=dev_tok,
                                device_busy_share=busy)
    # a bs1 decode step: every projection one launch of the one-row GEMV
    # (kernels 1 / 6) or the dp4a GEMV (rows 5 / 6), no split-K reduce
    # (PyTorch's own reductions are at::native::reduce_kernel): the
    # profile of the decode steps alone shows no reduce_kernel and the
    # one-launch kernels, the wrappers' counts one call a projection
    dl, dc = decode_step_launches(sess, p1, scfg)
    steps = PROFILE_NEW - 1
    want = 5 * cfg.num_layers * steps
    seen = dl["gemv::gemv_kernel"] + dl["dp4a_kernel"]
    ok = (dl["gemv::reduce_kernel"] + dl["w8a8::reduce_kernel"] == 0
          and dc["projections"] == want and dc["lm_head"] in (0, steps)
          and dc["other"] == 0
          and 0 < seen <= dc["projections"] + dc["lm_head"])
    print(f"  {tag} bs1 decode steps' launches: profile {dl}, wrappers {dc} "
          f"(no split-K reduce_kernel in the {steps} steps; {want} one-row "
          f"projection calls, the lm_head's 0 or {steps}, each one kernel "
          f"the profile saw, up to the records it drops): "
          f"{'ok' if ok else 'FAIL'}")
    results["_e2e"][tag]["decode_step_launches"] = dict(profile=dl,
                                                        wrappers=dc)
    if not ok:
        errors.append(f"{tag}: bs1 decode steps launched {dl}")
    if "tc" in path:     # bs4's decode steps (4 rows), tensor-core GEMV
        dev_step4, _ = profile_generate(sess, p4, scfg, row_limit=8)
        print(f"  {tag} bs4: {dev_step4:.3f} device ms per decode step on "
              "the tensor-core GEMV")
        results["_e2e"][tag].update(device_ms_per_decode_step_bs4=dev_step4)
    if path.get("task_a"):
        run_task_a(path, sess, errors, results)
    if path.get("fp8kv"):
        check_fp8kv_decode(path, sess, p1, errors, results)
    if path.get("modes"):
        run_decode_modes(path, sess, cfg, p1, out1, errors, results)
    for key, mod in path.get("unrun", {}).items():
        n = launches_of(key, getattr(mod, KERNELS[key][0]))
        print(f"  {tag}: {key} launches {n} in the path's run (expected 0: "
              f"no mode of this path runs it): {'ok' if n == 0 else 'FAIL'}")
        if n:
            errors.append(f"{tag}: {key} launched {n} times")
        results[key]["launches"] = results[key].get("launches", 0) + n
    if path.get("fused"):
        run_fused_gate_up(path, sess, p1, p4, out1, out4, errors, results)
    if path.get("sampling"):
        run_sampling(path, sess, p1, p4, out1, out4, errors, results)
        run_beams(path, sess, p1, errors, results)
        run_speculative(path, sess, p1, out1, errors, results)


def check_fp8kv_decode(path, sess, p1, errors, results):
    """Path 8's e4m3 cache through the session's weights: the first decode
    step (kernel 3 writes row 8 and attends 9 e4m3 rows a layer) against
    the plain path on copies of the same prefilled caches, within
    LOGITS_TOL; then DECODE_STEPS steps under the profiler: kernel 3 once
    per layer and step by its wrapper's count and in the profile (up to
    the records the profiler drops), no softmax kernel (the plain decode's)
    and the per-stream workspace neither made nor grown (_build's
    _WORKSPACE and _RETIRED unchanged): the decode kernel allocates nothing
    but its output."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from trtllm_llama_tpu_torch.models import llama
    from trtllm_llama_tpu_torch.ops.kernels import _build
    from trtllm_llama_tpu_torch.ops.kernels import decode_attention as da

    tag, cfg = path["tag"], sess.cfg
    n_l, n = cfg.num_layers, p1.shape[1]
    with torch.inference_mode():
        ids = torch.zeros((1, 16), dtype=torch.int32, device="cuda")
        ids[0, :n] = torch.as_tensor(p1[0], device="cuda")
        pos = torch.tensor([n], dtype=torch.int32, device="cuda")
        caches = llama.init_caches(cfg, 1, 66, "cuda", sess.kv_scales)
        logits, caches = llama.forward_prefill(sess.params, cfg, ids, pos,
                                               caches, rope=sess.rope)
        tok = logits.argmax(-1).to(torch.int32)
        plain_caches = caches._replace(k=caches.k.clone(), v=caches.v.clone())
        step, caches = llama.forward_decode(sess.params, cfg, tok, pos,
                                            caches, rope=sess.rope)
        with contextlib.ExitStack() as stack:
            for mod, attr in path["plain"] + [(da, "dma_decode_attention")]:
                stack.enter_context(patched(mod, attr,
                                            getattr(mod, attr + "_plain")))
            step_ref, plain_caches = llama.forward_decode(
                sess.params, cfg, tok, pos, plain_caches, rope=sess.rope)
        print(f"  {tag}: caches {caches.k.dtype} {tuple(caches.k.shape)}, "
              f"scales {sess.kv_scales.unique().tolist()}")
        compare(f"{tag} first decode step logits over the e4m3 cache, "
                "kernels vs plain", step, step_ref, errors, tol=LOGITS_TOL)
        del plain_caches, step_ref
        tok = step.argmax(-1).to(torch.int32)
        pos.add_(1)

        def steps(k):
            nonlocal tok
            for _ in range(k):
                out, _ = llama.forward_decode(sess.params, cfg, tok, pos,
                                              caches, rope=sess.rope)
                tok = out.argmax(-1).to(torch.int32)
                pos.add_(1)
        steps(1)
        torch.cuda.synchronize()
        ws = {k: [x.data_ptr() for x in v]
              for k, v in _build._WORKSPACE.items()}
        retired = len(_build._RETIRED)
        calls = da.dma_decode_attention.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            steps(DECODE_STEPS)
            torch.cuda.synchronize()
        calls = da.dma_decode_attention.launches - calls
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    k3 = sum(e.count for e in events if "flash_decode_kernel" in e.key)
    soft = sum(e.count for e in events if "softmax" in e.key.lower())
    same_ws = (len(_build._RETIRED) == retired and ws == {
        k: [x.data_ptr() for x in v] for k, v in _build._WORKSPACE.items()})
    want = n_l * DECODE_STEPS
    ok = calls == want and want - n_l <= k3 <= want and soft == 0 and same_ws
    print(f"  {tag} {DECODE_STEPS} decode steps over the e4m3 cache: kernel 3 "
          f"{calls} calls ({n_l} a step), {k3} flash_decode kernels in the "
          f"profile, {soft} softmax kernels, workspace unchanged: {same_ws}"
          f" {'ok' if ok else 'FAIL'}")
    if not ok:
        errors.append(f"{tag}: decode steps ran kernel 3 {calls} times "
                      f"({k3} in the profile, {soft} softmax kernels, "
                      f"workspace unchanged {same_ws}), not {want}")
    results["_e2e"][tag]["decode_steps_profile"] = dict(
        kernel3_calls=calls, flash_decode_kernels=k3, softmax_kernels=soft,
        workspace_unchanged=same_ws)


def run_task_a(path, sess, errors, results):
    """Task A's prefill on a W8A8 path's session: one bs1 prompt of
    TASK_A_PROMPT tokens (seed 0; the 1024-row bucket), with the routing
    rule (the GEMM in the prefill) and then with the dp4a kernel at every
    row count: the host-clock TTFT of each; the GEMM's launches (5 per
    layer in the prefill, none in a decode step); the first-token logits
    bit-identical between the two routes (both exact) and the greedy
    tokens of 1 + TASK_A_DECODE steps identical; decode ms/token over the
    prompt's int8 cache; a profile of the prefill (device time of the GEMM,
    kernel 2, row 7 and the rest) beside the plain activation
    quantization's device time per prefill (its calls timed alone at the
    prefill's shapes)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from trtllm_llama_tpu_torch.models import llama
    from trtllm_llama_tpu_torch.quantization import tensors

    tag, cfg = path["tag"], sess.cfg
    n_l, d, f = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    gemm_fn = _wrappers()[KERNELS[path["gemm"]][0]]
    prompt = np.random.default_rng(0).integers(3, cfg.vocab_size,
                                               (1, TASK_A_PROMPT))
    rows = sess.engine_cfg.bucket_for(TASK_A_PROMPT)
    new = 1 + TASK_A_DECODE
    print(f"  {tag} Task A: bs1, one {TASK_A_PROMPT}-token prompt ({rows}-"
          f"row bucket), then {TASK_A_DECODE} decode steps over its int8 "
          "cache; the GEMM route, then the dp4a kernel at every row count")

    def prefill_logits():
        with torch.inference_mode():
            ids = torch.zeros((1, rows), dtype=torch.int32, device="cuda")
            ids[0, :TASK_A_PROMPT] = torch.as_tensor(prompt[0], device="cuda")
            lens = torch.tensor([TASK_A_PROMPT], dtype=torch.int32,
                                device="cuda")
            caches = llama.init_caches(cfg, 1, rows, "cuda", sess.kv_scales)
            return llama.forward_prefill(sess.params, cfg, ids, lens, caches,
                                         rope=sess.rope)[0]

    run = {}
    for gemm in (True, False):
        what = "GEMM" if gemm else "dp4a"
        with (contextlib.nullcontext() if gemm
              else path["route"](gemm=False)):
            timed_generate(sess, prompt, 1)                     # warm-up
            zero_counts()
            _, ttft = timed_generate(sess, prompt, 1)
            n_pre = gemm_fn.gemm_launches
            zero_counts()
            out, ms = timed_generate(sess, prompt, new)
            n_req = gemm_fn.gemm_launches
            logits = prefill_logits()
        dec_ms = (ms - ttft) / TASK_A_DECODE
        want = 5 * n_l if gemm else 0
        ok = n_pre == want and n_req == want
        print(f"  {tag} Task A ({what}): TTFT {ttft:.2f} ms, decode "
              f"{dec_ms:.3f} ms/token over the {TASK_A_PROMPT}-row cache; "
              f"GEMM launches {n_pre} in the prefill, {n_req - n_pre} in the "
              f"{TASK_A_DECODE} decode steps (expected {want} and 0): "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            errors.append(f"{tag} Task A {what}: GEMM launches {n_pre} / "
                          f"{n_req} != {want}")
        check_tokens(f"{tag} Task A ({what})", out, new, cfg.vocab_size,
                     errors)
        run[what] = dict(ttft_ms=ttft, decode_ms_per_token=dec_ms,
                         gemm_launches_prefill=n_pre,
                         gemm_launches_decode=n_req - n_pre,
                         tokens=out.output_ids, logits=logits)
        if gemm:
            results[path["gemm"]]["launches"] += n_req
    same_logits = torch.equal(run["GEMM"]["logits"], run["dp4a"]["logits"])
    same_tokens = np.array_equal(run["GEMM"]["tokens"], run["dp4a"]["tokens"])
    print(f"  {tag} Task A: first-token logits bit-identical between the "
          f"routes: {same_logits}; greedy tokens identical: {same_tokens} "
          f"({run['GEMM']['tokens'][0, :8].tolist()}...); TTFT "
          f"{run['dp4a']['ttft_ms'] / run['GEMM']['ttft_ms']:.1f}x shorter "
          "on the GEMM")
    if not (same_logits and same_tokens):
        errors.append(f"{tag} Task A: the GEMM and dp4a routes differ "
                      f"(logits equal {same_logits}, tokens {same_tokens})")

    # where the prefill's device time goes (the routing rule: the GEMM)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        timed_generate(sess, prompt, 1)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]

    def dev_ms(sub=""):
        return sum(e.self_device_time_total for e in events
                   if sub in e.key) / 1e3
    parts = {"GEMM (w8a8_gemm_kernel)": dev_ms("w8a8_gemm_kernel"),
             "kernel 2 (row 10's tile, flash::flash_kernel)":
                 dev_ms("flash::flash_kernel"),
             "row 7 (rmsnorm_quant_kernel)": dev_ms("rmsnorm_quant_kernel")}
    total = dev_ms()
    parts["the rest (plain torch ops, the lm_head)"] = total - sum(
        parts.values())
    # the activation quantization by plain torch ops in one prefill: path 2
    # quantizes the wo and down inputs per token (row 7 the others), static
    # SmoothQuant every projection's input (5 a layer)
    per_token = sess.params["layers"]["wo"].per_token
    x = {k: torch.randn((rows, k), device="cuda").to(cfg.torch_dtype)
         for k in (d, f)}
    s_x = torch.tensor(0.02, device="cuda")
    if per_token:
        calls = {d: 1, f: 1}
        t_q = {k: time_ms(lambda i: tensors.quantize_per_token(x[k]))
               for k in calls}
    else:
        calls = {d: 4, f: 1}
        t_q = {k: time_ms(lambda i: tensors.quantize_static(x[k], s_x))
               for k in calls}
    quant_ms = n_l * sum(n * t_q[k] for k, n in calls.items())
    print(f"  {tag} Task A prefill profile: device {total:.2f} ms of "
          f"{run['GEMM']['ttft_ms']:.2f} ms TTFT; " + ", ".join(
              f"{k} {v:.2f} ms ({100 * v / total:.1f}%)"
              for k, v in parts.items())
          + f"; the activation quantization (plain ops, timed alone: "
          f"{' + '.join(f'{n} x {t_q[k]:.4f}' for k, n in calls.items())} "
          f"ms a layer) {quant_ms:.2f} ms")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=10, max_name_column_width=60))
    results["_e2e"][f"{tag} Task A"] = dict(
        prompt=TASK_A_PROMPT, rows=rows, decode_steps=TASK_A_DECODE,
        logits_bit_identical=same_logits, tokens_identical=same_tokens,
        prefill_device_ms=total, prefill_device_ms_by_part=parts,
        quantize_ms_per_prefill=quant_ms,
        **{f"{what} {k}": v for what, r in run.items() for k, v in r.items()
           if k not in ("tokens", "logits")})


def prefill_logits_vs_plain(label, plain, sess, p1, p4, errors):
    """The session's 7B prefill logits, bs1 (p1) and bs4 ragged (p4): its
    kernels against their plain versions (the wrappers in `plain` patched
    to their _plain twins) on the same inputs, within LOGITS_TOL."""
    import torch
    from trtllm_llama_tpu_torch.models import llama

    cfg = sess.cfg
    for what, prompts in (("bs1", [p1[0].tolist()]), ("bs4", p4)):
        b = len(prompts)
        with torch.inference_mode():
            ids = torch.zeros((b, 16), dtype=torch.int32, device="cuda")
            for row, prompt in enumerate(prompts):
                ids[row, :len(prompt)] = torch.as_tensor(prompt, device="cuda")
            lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                                device="cuda")

            def prefill():
                caches = llama.init_caches(cfg, b, 66, "cuda", sess.kv_scales)
                return llama.forward_prefill(sess.params, cfg, ids, lens,
                                             caches, rope=sess.rope)[0]
            got = prefill()
            with contextlib.ExitStack() as stack:
                for mod, attr in plain:
                    stack.enter_context(patched(
                        mod, attr, getattr(mod, attr + "_plain")))
                ref = prefill()
        compare(f"{label}{what} logits", got, ref, errors, tol=LOGITS_TOL)
        print(f"  {label}{what} argmax kernels {got.argmax(-1).tolist()} "
              f"plain {ref.argmax(-1).tolist()}")


def streamed_logits_vs_plain(path, sess, p1, p4, errors):
    """The session's bs1 and bs4 prefill logits with every prompt sent to
    row 12 (prefill_streaming_min_s 0), against the plain path within
    LOGITS_TOL, row 12 launched once per layer and prefill. Row 12 carries
    P at f32 precision; with P rounded to bf16, as row 12's earlier
    mma.sync loop rounded it, path 7's logits moved by 31-35% of the
    largest (attention_precision.py)."""
    from unittest import mock

    from trtllm_llama_tpu_torch.ops.kernels import (
        streaming_prefill_attention as spa,
    )
    from trtllm_llama_tpu_torch.ops.registry import KERNELS as ROUTES

    fn = spa.streaming_prefill_attention_kernel
    n0 = fn.launches
    print("  7B prefill logits with every prompt on row 12, kernels vs plain "
          "versions:")
    with mock.patch.dict(ROUTES, prefill_streaming_min_s=0):
        prefill_logits_vs_plain(
            "row 12 ",
            path["plain"] + [(spa, "streaming_prefill_attention_kernel")],
            sess, p1, p4, errors)
    n, want = fn.launches - n0, 2 * sess.cfg.num_layers
    print(f"  row 12 launches in the two prefills: {n} (expected {want}) "
          f"{'ok' if n == want else 'FAIL'}")
    if n != want:
        errors.append(f"{path['tag']}: row 12 launched {n} times in the "
                      f"streamed prefills, not {want}")


def fused_session(sess):
    """A session on the same weights with TLLM_FUSE_GU set: its params hold
    w_gate_up (the other weights are shared)."""
    from unittest import mock

    from trtllm_llama_tpu_torch.runtime.session import GenerationSession
    kv = None if sess.kv_scales is None else sess.kv_scales.cpu().numpy()
    with mock.patch.dict(os.environ, TLLM_FUSE_GU="1"):
        fsess = GenerationSession(sess.cfg, sess.params, sess.engine_cfg,
                                  kv_scales=kv, device="cuda")
    return fsess


def first_difference(tag, sess_a, sess_b, prompt, ids_a, ids_b, row,
                     errors, route_b=None):
    """Where row `row` of two runs of one request (`prompt`, output ids
    [B, new] ids_a and ids_b) first differs, at token k (a picked by
    sess_a, b by sess_b): both sessions' step k replayed at the run's
    batch shape on run a's first k tokens. The flip is a near tie when the
    replays pick a and b again and the two logits moved against each
    other, (la[a] - la[b]) - (lb[a] - lb[b]), by at most FUSE_GU_TOL x
    max |la|; that shift bounds each run's lead of its own token. Anything
    else is an error. route_b: run b's kernel 1 / 6 route (route(); None
    for the default), against which the limit is LOGITS_TOL x max |la|
    (the two routes sum in another order, as the plain path does)."""
    import numpy as np
    from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig

    scfg = SamplingConfig(end_id=-1)
    new = ids_a.shape[1]
    k = int(np.flatnonzero(ids_a[row] != ids_b[row])[0])
    a, b = int(ids_a[row, k]), int(ids_b[row, k])
    common = ids_a[:, :k]
    la = replay_logits(sess_a, prompt, common, scfg, new)[row].float()
    with (contextlib.nullcontext() if route_b is None else route(route_b)):
        lb = replay_logits(sess_b, prompt, common, scfg, new)[row].float()
    picks = int(la.argmax()) == a and int(lb.argmax()) == b
    lead_a, lead_b = float(la[a] - la[b]), float(lb[b] - lb[a])
    limit = (FUSE_GU_TOL if route_b is None else LOGITS_TOL) * float(
        la.abs().max())
    tie = picks and lead_a + lead_b <= limit
    print(f"  {tag}: tokens first differ at {k} ({a} vs {b}); replays pick "
          f"{int(la.argmax())} / {int(lb.argmax())}; leads {lead_a:.5f} / "
          f"{lead_b:.5f}, shift {lead_a + lead_b:.5f} (limit {limit:.5f}): "
          f"{'a near tie' if tie else 'NOT a near tie'}")
    if not tie:
        errors.append(f"{tag}: tokens differ at {k} and it is not a near tie")


def flip_check(tag, got, ref, errors):
    """Rows where two runs' logits ([B, V], got against ref) pick different
    tokens a and b: a near tie when the two logits moved against each
    other, (got[a] - got[b]) + (ref[b] - ref[a]), by at most LOGITS_TOL x
    max |ref|; anything else is an error."""
    import numpy as np
    got, ref = got.float(), ref.float()
    flips = np.flatnonzero((got.argmax(-1) != ref.argmax(-1)).cpu().numpy())
    print(f"  {tag}: argmax differs for {len(flips)} of {got.shape[0]} rows")
    for row in flips:
        a, b = int(got[row].argmax()), int(ref[row].argmax())
        shift = float(got[row, a] - got[row, b] + ref[row, b] - ref[row, a])
        limit = LOGITS_TOL * float(ref[row].abs().max())
        tie = shift <= limit
        print(f"  {tag} row {row}: {a} vs {b}, shift {shift:.5f} (limit "
              f"{limit:.5f}): {'a near tie' if tie else 'NOT a near tie'}")
        if not tie:
            errors.append(f"{tag} row {row}: tokens differ and it is not a "
                          "near tie")


def run_fused_gate_up(path, sess, p1, p4, out1, out4, errors, results):
    """The path's bs1 and bs4 requests again under TLLM_FUSE_GU=1 (one
    w_gate_up projection, its SwiGLU in the down projection's prologue):
    the launches (the stacked entry 4 per layer and forward; the SwiGLU
    prologue once per layer in every forward of at most FUSE_MAX_ROWS
    rows: the bs1 prefill and every decode step, not bs4's 64-row
    prefill; the tensor-core GEMV in the 16-row bs1 prefill and bs4's
    decode steps), tokens against the unfused runs (a row that differs must
    flip at a near tie, first_difference), the fused session's prefill
    logits against the plain path within LOGITS_TOL, its logits against
    the unfused session's within FUSE_GU_TOL (prefill and first decode
    step), decode ms/token and device ms per decode token beside the
    unfused run's."""
    import numpy as np
    import torch
    from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig

    tag, cfg, new = path["tag"], sess.cfg, NEW_TOKENS
    n_l = cfg.num_layers
    entry, key = path["fused"]
    fn = _wrappers()[entry]
    scfg = SamplingConfig(end_id=-1)
    fsess = fused_session(sess)
    fused_w = fsess.params["layers"]["w_gate_up"]
    print(f"  {tag} TLLM_FUSE_GU=1: w_gate_up {type(fused_w).__name__} "
          f"{tuple(fused_w.qweight.shape)}, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    fsess.generate(p1, sampling=scfg, max_new_tokens=4)          # warm-up
    got = {}
    for what, ids, ref, b in (("bs1", p1, out1, 1), ("bs4", p4, out4, 4)):
        zero_counts()
        outf, ms = timed_generate(fsess, ids, new)
        n, n_sw = fn.launches, getattr(fn, "swiglu_launches", None)
        n_gemm = getattr(fn, "gemm_launches", None)
        want_sw = None if n_sw is None else n_l * (new if b == 1 else new - 1)
        # the GEMM: 4 projections a layer in the prefill if its rows (16 at
        # bs1, 64 at bs4) reach the floor (decode steps: 1 or 4 rows)
        floor = path["floor"]()
        want_gemm = None if n_gemm is None else 4 * n_l * (
            (16 * b >= floor) + (new - 1) * (b >= floor))
        # the tensor-core GEMV: the forwards of TC_MIN_ROWS-16 rows (the
        # 16-row bs1 prefill, bs4's 4-row decode steps)
        n_tc = getattr(fn, "tc_launches", None)
        want_tc = None if n_tc is None else 4 * n_l * (
            tc_rows(16 * b) + (new - 1) * tc_rows(b))
        ok = (n == 4 * n_l * new and n_sw == want_sw
              and n_gemm == want_gemm and n_tc == want_tc)
        print(f"  {tag} fused {what}: {ms:.1f} ms; {entry} launches {n} "
              f"(expected {4 * n_l * new}), of them the GEMM's {n_gemm} "
              f"(expected {want_gemm}) and the tensor-core GEMV's {n_tc} "
              f"(expected {want_tc}), SwiGLU prologue {n_sw} (expected "
              f"{want_sw}): {'ok' if ok else 'FAIL'}; all counts "
              f"{read_counts()[0]}")
        if not ok:
            errors.append(f"{tag} fused {what}: launches {n} / {n_gemm} / "
                          f"{n_tc} / {n_sw}")
        got[what] = (n, n_sw)
        same = np.array_equal(outf.output_ids, ref.output_ids)
        print(f"  {tag} fused {what} tokens identical to the unfused run: "
              f"{same}")
        for row in np.flatnonzero((outf.output_ids != ref.output_ids).any(1)):
            first_difference(f"{tag} fused {what} row {row}", sess, fsess,
                             ids, ref.output_ids, outf.output_ids, row,
                             errors)
    print(f"  {tag} fused, 7B prefill logits, kernels vs plain versions:")
    prefill_logits_vs_plain("fused ", path["plain"], fsess, p1, p4, errors)
    diff = 0.0
    for k, what in ((0, "prefill"), (1, "first decode step")):
        common = out1.output_ids[:, :k]
        la = replay_logits(sess, np.asarray(p1), common, scfg, new)
        lb = replay_logits(fsess, np.asarray(p1), common, scfg, new)
        diff = max(diff, compare(f"{tag} fused vs unfused bs1 {what} logits",
                                 lb, la, errors, tol=FUSE_GU_TOL))
    _, pre_ms = timed_generate(fsess, p1, 1)
    _, ms = timed_generate(fsess, p1, new)
    dec_ms = (ms - pre_ms) / (new - 1)
    dev_tok, busy = profile_generate(fsess, p1, scfg, row_limit=8)
    base = results["_e2e"][tag]
    print(f"  {tag} fused: decode {dec_ms:.3f} ms/token (unfused "
          f"{base['decode_ms_per_token']:.3f}), device {dev_tok:.3f} ms per "
          f"decode token (unfused {base['device_ms_per_decode_token']:.3f})")
    results["_e2e"][f"{tag} TLLM_FUSE_GU"] = dict(
        layers=n_l, prefill_ms=pre_ms, decode_ms_per_token=dec_ms,
        device_ms_per_decode_token=dev_tok, device_busy_share=busy,
        max_logit_diff=diff, launches=got)
    if key is not None:
        results[key]["launches"] = sum(n_sw for _, n_sw in got.values())
    del fsess


# ---------------------------------------------------------------------------
# sampling and beam search on path 1's weights
# ---------------------------------------------------------------------------

SAMPLED = dict(temperature=0.8, top_k=40, top_p=0.95, repetition_penalty=1.1,
               end_id=-1)
SAMPLE_LP_TOL = 5e-2   # a run's logprobs against its replay's log_softmax
EDGE = 1e-4            # a kept-set decision this close to its cut is an edge
BEAM_WIDTH = 4
BEAM_BLOCK = 64        # beam_paged_block of the paged beam run
BEAM_ALPHA = 1.0       # the beams' length_penalty


def _padded(prompt):
    """(ids [B, n] int32, lens [B]) of a [B, n] array or B ragged lists."""
    import numpy as np
    if isinstance(prompt, (list, tuple)):
        lens = np.array([len(p) for p in prompt], np.int32)
        ids = np.zeros((len(prompt), int(lens.max())), np.int32)
        for row, p in enumerate(prompt):
            ids[row, :len(p)] = p
        return ids, lens
    ids = np.asarray(prompt, np.int32)
    return ids, np.full((ids.shape[0],), ids.shape[1], np.int32)


def near_tie(tag, logits, a, b, errors):
    """Token a picked where b was expected, on one row's logits: a near tie
    when b leads a by at most LOGITS_TOL x max |logits| (flip_check's
    limit); anything else is an error."""
    lead = float(logits[b] - logits[a])
    limit = LOGITS_TOL * float(logits.abs().max())
    tie = lead <= limit
    print(f"  {tag}: {a} vs {b}, lead of {b} {lead:.5f} (limit {limit:.5f}):"
          f" {'a near tie' if tie else 'NOT a near tie'}")
    if not tie:
        errors.append(f"{tag}: {a} vs {b} is not a near tie")


def kept_set_check(tag, steps, prompt, out, scfg, errors):
    """Each emitted token of `out` (a sampled run of scfg) must lie in the
    kept set of the plain sampler's filter (sampling.py's functions on the
    CPU in f32: penalties over the prompt's and earlier tokens' counts,
    temperature, top-k, top-p) on the replayed logits `steps`. Tokens whose
    top-k or top-p (when set) decision lies within EDGE of its cut are
    printed with their margins (the card's exp and sums round otherwise);
    the run's logprobs, when it has them, must be within SAMPLE_LP_TOL of
    the replay's log_softmax. Returns (tokens checked, edge tokens, max
    logprob error)."""
    import numpy as np
    import torch
    from trtllm_llama_tpu_torch.runtime import sampling as smp

    ids, lens = _padded(prompt)
    counts = smp.init_token_counts(torch.from_numpy(ids),
                                   torch.from_numpy(lens),
                                   steps[0].shape[-1])
    toks = torch.from_numpy(np.asarray(out.output_ids, np.int64))
    n_edge, lp_err, bad = 0, 0.0, []
    for k, raw in enumerate(steps):
        raw = raw.float().cpu()
        z = smp._div(smp.apply_repetition_penalty(
            raw, counts, scfg.repetition_penalty, scfg.presence_penalty,
            scfg.frequency_penalty), scfg.temperature)
        kept = smp.apply_top_p(smp.apply_top_k(z, scfg.top_k), scfg.top_p)
        lsm = torch.log_softmax(raw, -1)
        for r in range(raw.shape[0]):
            t = int(toks[r, k])
            if out.logprobs is not None:
                lp_err = max(lp_err, abs(float(lsm[r, t])
                                         - float(out.logprobs[r, k])))
            zr = z[r].double()
            kth = torch.topk(zr, scfg.top_k).values[-1]
            zk = torch.where(zr < kth, -torch.inf, zr)
            probs = torch.softmax(zk, -1)
            before = float(probs[zk > zr[t]].sum())
            m_k = float(zr[t] - kth)
            m_p = scfg.top_p - before if scfg.top_p > 0 else torch.inf
            if min(abs(m_k), abs(m_p)) < EDGE:
                n_edge += 1
                print(f"  {tag} step {k} row {r}: token {t} at the edge: "
                      f"z - kth {m_k:.3e}, top_p - mass before {m_p:.3e}, "
                      f"kept {bool(kept[r, t] > smp.NEG_INF / 2)}")
            elif not bool(kept[r, t] > smp.NEG_INF / 2):
                bad.append((k, r, t, m_k, m_p))
        smp.update_token_counts(counts, toks[:, k])
    print(f"  {tag}: {toks.numel()} tokens, {len(bad)} outside the kept set "
          f"({n_edge} at its edge); logprobs vs replay max abs err "
          f"{lp_err:.3e} (tol {SAMPLE_LP_TOL})")
    if bad:
        errors.append(f"{tag}: tokens outside the kept set {bad[:4]}")
    if lp_err > SAMPLE_LP_TOL:
        errors.append(f"{tag}: logprobs off by {lp_err:.3e}")
    return toks.numel(), n_edge, lp_err


def card_vs_cpu_sampler(tag, logits, errors):
    """The card's sample_step and sample_step_slots on real [B, V] logits
    against the same functions on the CPU in f32, the same noise tensor on
    both: the same tokens, or a near tie of logits + noise."""
    from unittest import mock

    import torch
    from trtllm_llama_tpu_torch.runtime import sampling as smp

    b, v = logits.shape
    noise = smp.gumbel_noise((b, v), torch.Generator(
        device="cuda").manual_seed(1)).cpu()
    scfg = smp.SamplingConfig(**SAMPLED)
    counts = torch.zeros((b, v), dtype=torch.int32)
    counts[:, :64] = 1                           # some seen tokens
    params = smp.SlotSamplingParams.neutral(b, 2, 2, "cpu")
    for row, cfg in enumerate([
            scfg, smp.SamplingConfig(top_p=0.9, min_length=4, end_id=7),
            smp.SamplingConfig(temperature=1.3, top_k=5,
                               bad_words=((int(logits[2].argmax()),),)),
            smp.SamplingConfig()][:b]):
        params = params.set_slot(row, cfg)
    gen_lens = torch.arange(b, dtype=torch.int32)
    picks = {}
    with mock.patch.object(smp, "gumbel_noise",
                           lambda shape, g: noise.to(g.device)):
        for dev in ("cpu", "cuda"):
            g = torch.Generator(device=dev)
            x = logits.float().to(dev)
            picks[dev] = (
                smp.sample_step(x, scfg, g, counts.to(dev),
                                gen_lens.to(dev)).cpu(),
                smp.sample_step_slots(
                    x, smp.SlotSamplingParams(*(
                        None if t is None else t.to(dev) for t in params)),
                    g, counts.to(dev), gen_lens.to(dev), 2).cpu())
    for name, got, want in (("sample_step", picks["cuda"][0],
                             picks["cpu"][0]),
                            ("sample_step_slots", picks["cuda"][1],
                             picks["cpu"][1])):
        same = torch.equal(got, want)
        print(f"  {tag} {name}: card {got.tolist()} cpu {want.tolist()}: "
              f"{'identical' if same else 'DIFFER'}")
        for r in (got != want).nonzero().flatten().tolist():
            near_tie(f"{tag} {name} row {r}", (logits[r].float().cpu()
                                               + noise[r]),
                     int(got[r]), int(want[r]), errors)


def run_sampling(path, sess, p1, p4, out1, out4, errors, results):
    """Path 1's weights under sampling: bs1 and bs4 in8 out50 with SAMPLED
    and return_logprobs, each twice with one seed (identical tokens and
    logprobs), every token in the plain filter's kept set on the session's
    own replay, logprobs against the replay; top_k=1 with top_p=0.9 against
    the greedy runs; greedy with the third greedy token a bad word and with
    greedy tokens 5-6 a stop word; the card's sampler against the CPU's on
    the bs4 prefill logits; device ms per sampled decode token."""
    import numpy as np
    from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig

    tag, new = path["tag"], NEW_TOKENS
    scfg = SamplingConfig(**SAMPLED)
    wrappers = {name: getattr(mod, KERNELS[name][0])
                for name, mod in path["kernels"].items()}
    print(f"  {tag} sampling {SAMPLED}, return_logprobs:")
    res = {}
    for what, prompt in (("bs1", p1), ("bs4", p4)):
        runs = []
        zero_counts()
        for _ in range(2):
            t = time.perf_counter()
            runs.append(sess.generate(prompt, sampling=scfg,
                                      max_new_tokens=new, seed=0,
                                      return_logprobs=True))
            ms = (time.perf_counter() - t) * 1e3
        a, b = runs
        launches = {name: launches_of(name, fn)
                    for name, fn in wrappers.items()}
        for name, n in launches.items():
            results[name]["launches"] = results[name].get("launches", 0) + n
        same = (np.array_equal(a.output_ids, b.output_ids)
                and np.array_equal(a.logprobs, b.logprobs))
        print(f"  {tag} sampled {what}: {ms:.1f} ms, tokens "
              f"{a.output_ids[0, :12].tolist()}..., the same seed twice "
              f"identical: {same}; launches {launches}")
        if not same:
            errors.append(f"{tag} sampled {what}: one seed, two results")
        if a.output_ids.shape != (len(prompt), new) or (a.lengths != new).any():
            errors.append(f"{tag} sampled {what}: bad output")
        steps = replay_steps(sess, prompt, a.output_ids[:, :new - 1], scfg,
                             new)
        n, edge, lp_err = kept_set_check(f"{tag} sampled {what}", steps,
                                         prompt, a, scfg, errors)
        res[what] = dict(ms=ms, tokens=n, edge=edge, logprob_err=lp_err)
        if what == "bs4":
            card_vs_cpu_sampler(f"{tag} bs4 prefill logits", steps[0], errors)
    # top_k=1, top_p=0.9: the filter keeps the top token (and its ties)
    for what, prompt, greedy in (("bs1", p1, out1), ("bs4", p4, out4)):
        got = sess.generate(prompt, sampling=SamplingConfig(
            top_k=1, top_p=0.9, end_id=-1), max_new_tokens=new)
        rows = np.flatnonzero((got.output_ids != greedy.output_ids).any(1))
        print(f"  {tag} top_k=1 top_p=0.9 {what}: tokens equal the greedy "
              f"run's in {len(greedy.output_ids) - len(rows)} of "
              f"{len(greedy.output_ids)} rows")
        for r in rows:
            k = int(np.flatnonzero(got.output_ids[r] != greedy.output_ids[r])[0])
            logits = replay_logits(sess, prompt, got.output_ids[:, :k],
                                   SamplingConfig(end_id=-1), new)[r].float()
            near_tie(f"{tag} top_k=1 {what} row {r} step {k}", logits,
                     int(got.output_ids[r, k]), int(greedy.output_ids[r, k]),
                     errors)
    g = [int(t) for t in out1.output_ids[0]]
    ban = g[2]
    got = sess.generate(p1, sampling=SamplingConfig(
        end_id=-1, bad_words=((ban,),)), max_new_tokens=new).output_ids[0]
    first = g.index(ban)          # the greedy tokens before it stay
    ok = ban not in got.tolist() and got.tolist()[:first] == g[:first]
    print(f"  {tag} greedy, bad word ({ban},): {len(got)} tokens, {ban} "
          f"never among them: {ok} ({got[:6].tolist()}...)")
    if not ok:
        errors.append(f"{tag}: the bad word {ban} was emitted")
    stop = (g[5], g[6])
    seq = [int(t) for t in p1[0]] + g
    n0 = len(p1[0])
    want = next(k + 1 for k in range(len(g))
                if tuple(seq[n0 + k - 1:n0 + k + 1]) == stop)
    out = sess.generate(p1, sampling=SamplingConfig(
        end_id=-1, stop_words=(stop,)), max_new_tokens=new)
    ok = (int(out.lengths[0]) == want
          and out.output_ids[0, :want].tolist() == g[:want])
    print(f"  {tag} greedy, stop word {stop}: length {int(out.lengths[0])} "
          f"(expected {want}, where the pair first completes): "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        errors.append(f"{tag}: stop word run length {out.lengths[0]} != {want}")
    dev_tok, busy = profile_generate(sess, p1, scfg, row_limit=10)
    greedy_tok = results["_e2e"][tag]["device_ms_per_decode_token"]
    print(f"  {tag} sampled bs1: {dev_tok:.3f} device ms per decode token "
          f"(greedy {greedy_tok:.3f}, {100 * (dev_tok / greedy_tok - 1):+.1f}%)")
    results["_e2e"][f"{tag} sampled"] = dict(
        layers=sess.cfg.num_layers, config=SAMPLED, runs=res,
        device_ms_per_decode_token=dev_tok, device_busy_share=busy,
        greedy_device_ms_per_decode_token=greedy_tok)


def run_beams(path, sess, p1, errors, results):
    """Beam search on path 1's weights: bs1, BEAM_WIDTH beams, in8 out50,
    on the dense cache and with beam_paged_block=BEAM_BLOCK: launches held
    exactly (the tiled 64-row prefill on the GEMM, 5 a layer; each decode
    step's 4 rows on the tensor-core GEMV, 5 a layer; kernel 3 or row 14 a
    layer a step; row 10 a layer), the two runs' beams identical (or scores
    within SAMPLE_LP_TOL where they differ), the best beam's score against
    its replayed log-probs over its length norm, device ms per decode
    step."""
    import numpy as np
    import torch
    from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
    from trtllm_llama_tpu_torch.runtime.session import GenerationSession

    tag, new, n_l = path["tag"], NEW_TOKENS, sess.cfg.num_layers
    scfg = SamplingConfig(beam_width=BEAM_WIDTH, end_id=-1,
                          length_penalty=BEAM_ALPHA)
    psess = GenerationSession(sess.cfg, sess.params, sess.engine_cfg,
                              device="cuda", beam_paged_block=BEAM_BLOCK)
    outs = {}
    for what, s, decode in (("dense", sess, "dma_decode_attention"),
                            (f"paged {BEAM_BLOCK}", psess,
                             "paged_decode_attention")):
        s.generate(p1, sampling=scfg, max_new_tokens=4)      # warm-up
        zero_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = s.generate(p1, sampling=scfg, max_new_tokens=new)
        ms = (time.perf_counter() - t) * 1e3
        counts = read_counts()
        steps = new - 1
        expect = {"woq_matmul_stacked": 5 * n_l * (1 + steps),
                  "woq_matmul_stacked.gemm_launches": 5 * n_l,
                  "woq_matmul_stacked.tc_launches": 5 * n_l * steps,
                  "prefill_attention_kernel": n_l, decode: n_l * steps}
        check_counts(f"{tag} beams {what}", counts,
                     dict(launches=expect, alibi_decode=0), errors)
        for name, n in ((GEMM_INT8, 5 * n_l), (TC_INT8, 5 * n_l * steps),
                        ("prefill_attention_kernel", n_l), (decode,
                                                            n_l * steps)):
            results[name]["launches"] = results[name].get("launches", 0) + n
        dev_step, busy = profile_generate(s, p1, scfg, row_limit=8)
        print(f"  {tag} beams {what}: {ms:.1f} ms for {new} tokens x "
              f"{BEAM_WIDTH} beams, {dev_step:.3f} device ms per decode step;"
              f" best beam {out.output_ids[0, :10].tolist()}..., scores "
              f"{np.round(out.beam_scores[0], 4).tolist()}")
        outs[what] = out
        results["_e2e"][f"{tag} beams {what}"] = dict(
            layers=n_l, beam_width=BEAM_WIDTH, ms=ms,
            device_ms_per_decode_step=dev_step, device_busy_share=busy,
            scores=out.beam_scores[0].tolist())
    dense, paged = outs.values()
    same = np.array_equal(dense.beam_ids, paged.beam_ids)
    gap = float(np.abs(dense.beam_scores - paged.beam_scores).max())
    print(f"  {tag} beams dense vs paged: identical {same}; scores differ by "
          f"at most {gap:.3e}")
    if not same and gap > SAMPLE_LP_TOL:
        errors.append(f"{tag} beams: dense and paged differ beyond a tie")
    best = dense.output_ids                       # [1, new]
    steps = replay_steps(sess, p1, best[:, :new - 1],
                         SamplingConfig(end_id=-1), new)
    n = int(dense.lengths[0])
    total = sum(float(torch.log_softmax(l[0].float(), -1)[int(best[0, k])])
                for k, l in enumerate(steps[:n]))
    want = total / ((5.0 + n) / 6.0) ** BEAM_ALPHA
    err = abs(want - float(dense.beam_scores[0, 0]))
    print(f"  {tag} best beam: score {float(dense.beam_scores[0, 0]):.5f}, "
          f"replayed log-probs {total:.5f} over the length norm {want:.5f}: "
          f"err {err:.3e} (tol {SAMPLE_LP_TOL}) "
          f"{'ok' if err <= SAMPLE_LP_TOL else 'FAIL'}")
    if err > SAMPLE_LP_TOL:
        errors.append(f"{tag}: best beam score off its replay by {err:.3e}")
    del psess


def replay_logits(sess, prompt, tokens, scfg, new):
    """f32 logits [B, V] that pick token k of `sess.generate(prompt,
    max_new_tokens=new)` in the current decode_attn_mode, with `tokens`
    ([B, k] ids) fed as the tokens before it; `prompt` is [B, n] ids or a
    list of B ragged prompts, as generate takes it. It makes the session's
    own calls (bucket, cache rows, prefill, one decode step per token), so
    it reproduces a run whose first k tokens were `tokens`. A row's logits
    do not depend on the other rows' tokens, only on the batch's shape."""
    return replay_steps(sess, prompt, tokens, scfg, new)[-1]


def replay_steps(sess, prompt, tokens, scfg, new):
    """As replay_logits, the logits of every step: [k + 1] tensors [B, V],
    those that picked tokens 0..k."""
    import numpy as np
    import torch

    cfg, ecfg, model = sess.cfg, sess.engine_cfg, sess.model
    if isinstance(prompt, (list, tuple)):
        n = np.array([len(p) for p in prompt], np.int32)
        arr = np.full((len(prompt), int(n.max())), scfg.pad_id, np.int32)
        for row, p in enumerate(prompt):
            arr[row, :len(p)] = p
    else:
        arr = np.asarray(prompt)
        n = np.full((arr.shape[0],), arr.shape[1], np.int32)
    b, s = arr.shape
    bucket = ecfg.bucket_for(s)
    padded = np.full((b, bucket), scfg.pad_id, np.int32)
    padded[:, :s] = arr
    with torch.inference_mode():
        caches = model.init_caches(cfg, b, min(ecfg.max_seq_len, bucket + new),
                                   "cuda", sess.kv_scales)
        ids = torch.as_tensor(padded, device="cuda")
        lens = torch.as_tensor(n, device="cuda")
        logits, caches = model.forward_prefill(sess.params, cfg, ids, lens,
                                               caches, rope=sess.rope)
        steps = [logits]
        pos = lens.clone()
        for t in np.asarray(tokens, np.int32).T:       # one step's [B] ids
            tok = torch.as_tensor(t, device="cuda")
            logits, caches = model.forward_decode(sess.params, cfg, tok, pos,
                                                  caches, rope=sess.rope)
            steps.append(logits)
            pos += 1
    return steps


# ---------------------------------------------------------------------------
# speculative decoding (runtime/speculative.py, runtime/serving_spec.py):
# path 1's weights at bs1, and two serving configurations
# ---------------------------------------------------------------------------

SPEC_GAMMA = 4
# bench.py:416-418's random draft: LLaMA-160M's shape, bf16
SPEC_DRAFT = dict(hidden_size=768, intermediate_size=2048, num_layers=12,
                  num_heads=12, num_kv_heads=12, head_dim=64)
SPEC_SAMPLED = dict(temperature=0.8, top_k=8, end_id=-1)
# bench.py:204-209's copy workload: make_copy_params over a 16-token cycle
# drawn from seed 42; prompts repeat it twice; prompt lookup's n-gram 3
COPY_CYCLE = 16
COPY_NGRAM = 3
SPEC_SERVE = "dense, speculative (random draft)"
LOOKUP_SERVE = "dense, prompt lookup (copy workload)"


def copy_cycle(vocab):
    import numpy as np
    return np.random.default_rng(42).integers(3, vocab,
                                              (COPY_CYCLE,)).tolist()


def draft_model_params(vocab):
    """The LLaMA-160M-shaped bf16 draft: (config, random params, seed 1)."""
    from trtllm_llama_tpu_torch import ModelConfig, QuantMode
    from trtllm_llama_tpu_torch.quantization.quantize import (
        init_random_quantized_params,
    )
    dcfg = ModelConfig(vocab_size=vocab, dtype="bfloat16", **SPEC_DRAFT)
    return dcfg, init_random_quantized_params(dcfg, seed=1,
                                              quant_mode=QuantMode(0),
                                              device="cuda")


class CallProfiler:
    """A model that forwards to `model` and runs each forward_decode and
    forward_extend call alone under torch.profiler (the stream synchronized
    before and after): their device ms and calls, by method."""

    def __init__(self, model):
        self._model = model
        self.ms, self.n = {}, {}

    def __getattr__(self, name):
        attr = getattr(self._model, name)
        if name not in ("forward_decode", "forward_extend"):
            return attr

        def call(*args, **kw):
            import torch
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                out = attr(*args, **kw)
                torch.cuda.synchronize()
            self.ms[name] = self.ms.get(name, 0.0) + device_ms_of(prof)
            self.n[name] = self.n.get(name, 0) + 1
            return out
        return call


def device_ms_of(prof):
    from torch.autograd import DeviceType
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3


def spec_counts(n_l, iters, prefill_rows, draft_layers, self_draft,
                gamma=SPEC_GAMMA):
    """Exact launches of a bs1 speculative request: the target's prefill
    (5 projections a layer on the route of its rows: the GEMM from
    GEMM_MIN_ROWS, else the tensor-core GEMV; row 10 a layer), a self
    draft's prefill the same; each verify 5 a layer on the tensor-core
    GEMV (gamma + 1 rows), each draft step kernel 3 a draft layer and, for
    a self draft, 5 a layer on the one-row GEMV; a bf16 draft's
    projections are stock torch."""
    from trtllm_llama_tpu_torch.ops.kernels import woq_matmul as woq
    gemm = prefill_rows >= woq.GEMM_MIN_ROWS
    prefills = 2 if self_draft else 1
    tc = 5 * n_l * (iters + (0 if gemm else prefills))
    gemm_n = 5 * n_l * prefills if gemm else 0
    one_row = 5 * n_l * (gamma + 1) * iters if self_draft else 0
    counts = {"woq_matmul_stacked": tc + gemm_n + one_row,
              "woq_matmul_stacked.tc_launches": tc,
              "woq_matmul_stacked.gemm_launches": gemm_n,
              "prefill_attention_kernel": n_l + draft_layers,
              "dma_decode_attention": draft_layers * (gamma + 1) * iters}
    return {k: v for k, v in counts.items() if v}


def spec_request(tag, sess, prompt, scfg, new, errors, results, draft_layers,
                 self_draft, seed=0):
    """One counted bs1 request on a speculative session (after a warm-up):
    wall ms per committed token, target weight reads (the prefill and one
    verify an iteration), acceptance (accepted proposals over proposals
    made), the launches held exactly (spec_counts). Returns the output and
    the ExtendRecorder of the request's verify slabs."""
    import numpy as np
    import torch
    from trtllm_llama_tpu_torch.ops.kernels import woq_matmul as woq

    if not tc_rows(SPEC_GAMMA + 1):
        errors.append(f"{tag}: a bs1 verify is not on the tensor-core GEMV")
    sess.generate(prompt, sampling=scfg, max_new_tokens=4, seed=seed)
    model, rec = sess.model, ExtendRecorder(sess.model)
    sess.model = rec
    zero_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    try:
        out = sess.generate(prompt, sampling=scfg, max_new_tokens=new,
                            seed=seed)
    finally:
        sess.model = model
    ms = (time.perf_counter() - t) * 1e3
    iters = sess.last_iters - 1
    n = int(out.lengths.sum())
    accepted = n - len(out.lengths) - iters        # past each verify's bonus
    rows = sess.engine_cfg.bucket_for(np.asarray(prompt).shape[-1])
    expect = spec_counts(sess.cfg.num_layers, iters, rows, draft_layers,
                         self_draft)
    counts = read_counts()
    check_counts(f"{tag} launches", counts, dict(launches=expect,
                                                 alibi_decode=0), errors)
    for name, fn in (("woq_matmul_stacked", woq.woq_matmul_stacked),
                     (TC_INT8, woq.woq_matmul_stacked),
                     (GEMM_INT8, woq.woq_matmul_stacked),
                     ("prefill_attention_kernel",
                      _wrappers()["prefill_attention_kernel"]),
                     ("dma_decode_attention",
                      _wrappers()["dma_decode_attention"])):
        results[name]["launches"] = (results[name].get("launches", 0)
                                     + launches_of(name, fn))
    acc = accepted / max(SPEC_GAMMA * iters, 1)
    print(f"  {tag}: {ms:.1f} ms for {n} tokens, {ms / n:.2f} ms per "
          f"committed token; {iters} verify iterations, "
          f"{(n - len(out.lengths)) / max(iters, 1):.2f} tokens per "
          f"iteration, acceptance {acc:.3f} ({accepted} of "
          f"{SPEC_GAMMA * iters} proposals)")
    results["_e2e"][tag] = dict(
        layers=sess.cfg.num_layers, gamma=SPEC_GAMMA, ms=ms,
        ms_per_committed_token=ms / n, verify_iterations=iters,
        tokens=n, acceptance=acc, launches=counts[0])
    return out, rec


def spec_first_difference(tag, sess, prompt, got, want, errors):
    """Speculative greedy tokens against the plain session's: equal up to
    the first difference, which must be a near tie on the plain session's
    replay over the common prefix."""
    from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
    a, b = got.output_ids[0], want.output_ids[0]
    k = first_difference_at(a.tolist(), b.tolist())
    print(f"  {tag}: tokens equal path 1's greedy tokens "
          f"{'all through' if k is None else f'up to token {k}'}")
    if k is not None:
        logits = replay_logits(sess, prompt, want.output_ids[:, :k],
                               SamplingConfig(end_id=-1), len(b))[0].float()
        near_tie(f"{tag} token {k}", logits, int(a[k]), int(b[k]), errors)


def profile_spec_iteration(tag, spec, prompt, scfg, card, results):
    """Device ms of one bs1 iteration: the profiled request of 2 tokens
    (the prefill and one iteration) less the prefill's alone; and its
    parts, each call profiled alone: the draft's gamma + 1 decode steps
    and the verify."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    spec.generate(prompt, sampling=scfg, max_new_tokens=2)
    times = {}
    for new in (1, 2):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            spec.generate(prompt, sampling=scfg, max_new_tokens=new)
            torch.cuda.synchronize()
        times[new] = device_ms_of(prof)
    it_ms = times[2] - times[1]
    model, dmodel = spec.model, getattr(spec, "draft_model", None)
    spec.model = CallProfiler(model)
    if dmodel is not None:
        spec.draft_model = CallProfiler(dmodel)
    try:
        spec.generate(prompt, sampling=scfg, max_new_tokens=2)
    finally:
        parts = {"verify": spec.model.ms.get("forward_extend", 0.0)}
        if dmodel is not None:
            parts["draft steps"] = spec.draft_model.ms.get("forward_decode",
                                                           0.0)
            spec.draft_model = dmodel
        spec.model = model
    print(f"  {tag}: one bs1 iteration {it_ms:.3f} device ms (profiled "
          f"request of 2 tokens {times[2]:.3f} less its prefill "
          f"{times[1]:.3f}); alone: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items())
          + f"; {card}")
    results["_e2e"][tag].update(device_ms_per_iteration=it_ms,
                                device_ms_parts=parts)


def run_speculative(path, sess, p1, out1, errors, results):
    """Path 1's weights under speculation, bs1 in8 out50, gamma 4: a random
    LLaMA-160M-shaped draft and a self draft (greedy tokens equal path 1's
    up to a near tie), the random draft sampling (every committed token in
    the target's kept set on its own verify logits, one seed twice the same
    tokens); the copy workload (make_copy_params on path 1's weights, a
    prompt repeating the cycle twice) through prompt lookup and a self
    draft: the cycle's successors exactly, gamma + 1 tokens committed by
    every iteration but the budget-capped last. Launches exact, device ms
    of one iteration and its parts, beside the card."""
    import numpy as np
    from trtllm_llama_tpu_torch.quantization.evaluate import make_copy_params
    from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
    from trtllm_llama_tpu_torch.runtime.speculative import (
        PromptLookupSession, SpeculativeSession,
    )

    tag, new, cfg = path["tag"], NEW_TOKENS, sess.cfg
    card = results["_card"]
    greedy = SamplingConfig(end_id=-1)
    dcfg, dparams = draft_model_params(cfg.vocab_size)
    print(f"  {tag} speculative, gamma {SPEC_GAMMA}: the random draft "
          f"LLaMA-160M-shaped ({SPEC_DRAFT}, bf16, seed 1); {card}")
    runs = {"random draft": (dcfg, dparams, dcfg.num_layers, False),
            "self draft": (cfg, sess.params, cfg.num_layers, True)}
    for what, (dc, dp, d_l, self_draft) in runs.items():
        name = f"{tag}, speculative, {what}"
        spec = SpeculativeSession(cfg, sess.params, dc, dp, sess.engine_cfg,
                                  gamma=SPEC_GAMMA, device="cuda")
        got, _ = spec_request(name, spec, p1, greedy, new, errors, results,
                              d_l, self_draft)
        spec_first_difference(name, sess, p1, got, out1, errors)
        profile_spec_iteration(name, spec, p1, greedy, card, results)
        if not self_draft:
            random_spec = spec
    name = f"{tag}, speculative, stochastic"
    scfg = SamplingConfig(**SPEC_SAMPLED)
    got, rec = spec_request(name, random_spec, p1, scfg, new, errors, results,
                            dcfg.num_layers, False)
    again = random_spec.generate(p1, sampling=scfg, max_new_tokens=new,
                                 seed=0)
    same = np.array_equal(got.output_ids, again.output_ids)
    print(f"  {name} {SPEC_SAMPLED}: tokens {got.output_ids[0, :12].tolist()}"
          f"..., the same seed twice identical: {same}")
    if not same:
        errors.append(f"{name}: one seed, two results")
    # each token's distribution: the prefill's logits for the first, then
    # the row of the verify slab that committed it
    steps = [replay_steps(sess, p1, np.zeros((1, 0), np.int32), greedy,
                          new)[0]]
    starts = [int(s[0]) + 1 - p1.shape[1] for _, s, _ in rec.calls]
    for t in range(1, new):
        i = max(j for j, lb in enumerate(starts) if lb <= t)
        steps.append(rec.calls[i][2][:, t - starts[i]])
    kept_set_check(name, steps, p1, got, scfg, errors)
    profile_spec_iteration(name, random_spec, p1, scfg, card, results)
    del random_spec, spec
    cycle = copy_cycle(cfg.vocab_size)
    copy = make_copy_params(cfg, sess.params, cycle)
    prompt = np.array([cycle * 2], np.int32)
    want = [cycle[i % COPY_CYCLE] for i in range(new)]
    print(f"  {tag}, copy workload: make_copy_params over the cycle {cycle} "
          f"(seed 42), prompt = the cycle twice")
    for what, spec, d_l, self_draft in (
            ("prompt lookup", PromptLookupSession(
                cfg, copy, sess.engine_cfg, gamma=SPEC_GAMMA,
                ngram=COPY_NGRAM, device="cuda"), 0, False),
            ("self draft", SpeculativeSession(
                cfg, copy, cfg, copy, sess.engine_cfg, gamma=SPEC_GAMMA,
                device="cuda"), cfg.num_layers, True)):
        name = f"{tag}, copy workload, {what}"
        got, rec = spec_request(name, spec, prompt, greedy, new, errors,
                                results, d_l, self_draft)
        starts = [int(s[0]) for _, s, _ in rec.calls]
        commits = np.diff(starts).tolist() + [
            new - 1 - (starts[-1] - starts[0])]
        full = SPEC_GAMMA + 1
        last = (new - 1) - full * (len(commits) - 1)
        ok_tok = got.output_ids[0].tolist() == want
        ok_commit = commits == [full] * (len(commits) - 1) + [last]
        print(f"  {name}: tokens are the cycle's successors: {ok_tok}; "
              f"tokens committed by each iteration {commits} (gamma + 1 but "
              f"the budget-capped last, {last}): "
              f"{'ok' if ok_commit else 'FAIL'}")
        if not ok_tok:
            errors.append(f"{name}: tokens are not the cycle's successors")
        if not ok_commit:
            errors.append(f"{name}: iterations committed {commits}")
        profile_spec_iteration(name, spec, prompt, greedy, card, results)
        del spec
    del copy, dparams


def run_serving_spec(cfg, params, prompts, dense, errors, results):
    """The speculative serving engines on serving's weights and engine
    settings: SPEC_SERVE (the random LLaMA-160M-shaped draft, gamma 4, the
    16 requests of the other configurations: tokens equal the dense run's
    up to near ties) and LOOKUP_SERVE (prompt lookup, n-gram 3, on
    make_copy_params of the weights, 16 prompts each a rotation of the
    cycle twice: the cycle's successors exactly, more tokens committed
    than verify iterations run). Launches exact from the engine's counts:
    row 2's GEMM 5 a layer at each admission prefill and each verify (the
    9 rows x gamma + 1 = 45-row slab), row 10 a target (and draft) layer
    at each prefill, kernel 3 a draft layer at each draft step."""
    import torch
    from trtllm_llama_tpu_torch import EngineConfig
    from trtllm_llama_tpu_torch.ops.kernels import woq_matmul as woq
    from trtllm_llama_tpu_torch.quantization.evaluate import make_copy_params
    from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
    from trtllm_llama_tpu_torch.runtime.serving_spec import (
        PromptLookupServingEngine, SpeculativeServingEngine,
    )

    n_l, greedy = cfg.num_layers, SamplingConfig(end_id=-1)
    dcfg, dparams = draft_model_params(cfg.vocab_size)
    cycle = copy_cycle(cfg.vocab_size)
    copy_prompts = [(cycle[i:] + cycle[:i]) * 2
                    for i in range(SERVE_REQUESTS)]
    slab = (SERVE_ENGINE["max_batch_size"] + 1) * (SPEC_GAMMA + 1)
    for name in (SPEC_SERVE, LOOKUP_SERVE):
        if name == SPEC_SERVE:
            eng = SpeculativeServingEngine(
                cfg, params, dcfg, dparams, EngineConfig(**SERVE_ENGINE),
                gamma=SPEC_GAMMA, sampling=greedy, decode_chunk=SERVE_CHUNK,
                device="cuda")
            reqs, d_l = prompts, dcfg.num_layers
        else:
            eng = PromptLookupServingEngine(
                cfg, make_copy_params(cfg, params, cycle),
                EngineConfig(**SERVE_ENGINE), gamma=SPEC_GAMMA,
                ngram=COPY_NGRAM, sampling=greedy, decode_chunk=SERVE_CHUNK,
                device="cuda")
            reqs, d_l = copy_prompts, 0
        for p in reqs[:SERVE_WARMUP]:
            eng.submit(p, 4)
        eng.run_to_completion()
        eng.phase_times = dict.fromkeys(eng.phase_times, 0.0)
        eng.phase_times["steps"] = 0
        eng.calls = dict.fromkeys(eng.calls, 0)
        eng.spec_iters = eng.spec_committed = 0
        eng._req_times.clear()
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rids = [eng.submit(p, SERVE_NEW) for p in reqs]
        done = eng.run_to_completion()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        outs = [list(done[r].output_ids) if r in done else [] for r in rids]
        n_tok = sum(len(o) for o in outs)
        prefills, iters = eng.calls["prefills"], eng.spec_iters
        expect = {"woq_matmul_stacked": 5 * n_l * (prefills + iters),
                  "woq_matmul_stacked.gemm_launches": 5 * n_l * (prefills
                                                                 + iters),
                  "prefill_attention_kernel": (n_l + d_l) * prefills,
                  "dma_decode_attention": d_l * (SPEC_GAMMA + 1) * iters}
        expect = {k: v for k, v in expect.items() if v}
        print(f"  serving {name}: {n_tok / wall:.1f} generated tokens/s "
              f"({n_tok} tokens in {wall:.2f} s); {prefills} prefills, "
              f"{iters} verify iterations of {slab} rows, "
              f"{eng.spec_committed} tokens committed by them "
              f"({eng.spec_committed / max(iters, 1):.2f} an iteration over "
              f"the pool); {results['_card']}")
        check_counts(f"serving {name} launches", read_counts(),
                     dict(launches=expect, alibi_decode=0), errors)
        if woq.gemm_route(slab, torch.bfloat16) is not True:
            errors.append(f"serving {name}: a {slab}-row verify is not on "
                          "the GEMM")
        for key, fn in ((GEMM_INT8, woq.woq_matmul_stacked),
                        ("prefill_attention_kernel",
                         _wrappers()["prefill_attention_kernel"]),
                        ("dma_decode_attention",
                         _wrappers()["dma_decode_attention"])):
            results[key]["launches"] = (results[key].get("launches", 0)
                                        + launches_of(key, fn))
        bad = [r for r in rids if r not in done
               or len(done[r].output_ids) != SERVE_NEW]
        if bad:
            errors.append(f"serving {name}: requests {bad} did not return "
                          f"{SERVE_NEW} tokens")
        if name == SPEC_SERVE:
            check_same_tokens(name, eng, prompts, outs, dense, errors)
        else:
            want = [[cycle[(i + j) % COPY_CYCLE] for j in range(SERVE_NEW)]
                    for i in range(SERVE_REQUESTS)]
            exact = outs == want
            multi = eng.spec_committed > eng.spec_iters
            print(f"  serving {name}: every request the cycle's successors: "
                  f"{exact}; committed {eng.spec_committed} > verify "
                  f"iterations {iters}: {multi}")
            if not (exact and multi):
                errors.append(f"serving {name}: tokens exact {exact}, "
                              f"multi-token commits {multi}")
        results["_e2e"][f"serving {name}"] = dict(
            layers=n_l, tokens_per_s=n_tok / wall, wall_s=wall,
            verify_iterations=iters, committed=eng.spec_committed,
            prefills=prefills, latency=eng.latency_stats(),
            phases=eng.phase_stats())
        print(f"  latency_stats {json.dumps(eng.latency_stats())}")
        print(f"  phase_stats (ms per engine step) "
              f"{json.dumps(eng.phase_stats())}")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    del dparams


def run_decode_modes(path, sess, cfg, prompt, out_auto, errors, results):
    """The path's bs1 request again under decode_attn_mode 'split' (row 8
    after the plain write) and 'fused' (row 9): decode ms/token, device
    ms/token, launches (the mode's kernel once per layer and decode step,
    kernel 3 never), first-decode-step logits against the 'auto' run's,
    and whether the tokens equal the 'auto' run's ('fused' must: row 9
    runs kernel 3's body). Where they first differ,
    at token k, both runs' step k is replayed on their common first k
    tokens: the mode's logits against the 'auto' ones, beside the top-2 gap
    of the 'auto' logits. The knob is restored."""
    from unittest import mock

    import numpy as np
    from trtllm_llama_tpu_torch.ops.kernels import decode_attention as da
    from trtllm_llama_tpu_torch.ops.registry import KERNELS as knobs
    from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig

    tag, new, n_l = path["tag"], NEW_TOKENS, cfg.num_layers
    scfg = SamplingConfig(end_id=-1)
    prompt = np.asarray(prompt)
    auto_ids = np.asarray(out_auto.output_ids)

    def replay(k):      # the logits of step k on the 'auto' run's tokens
        return replay_logits(sess, prompt, auto_ids[:, :k], scfg, new)

    ref = replay(1)
    for mode, key in path["modes"].items():
        first = None
        wrappers = {key: getattr(da, KERNELS[key][0]),
                    path["decode"]: da.dma_decode_attention}
        with mock.patch.dict(knobs, decode_attn_mode=mode):
            sess.generate(prompt, sampling=scfg, max_new_tokens=4)  # warm-up
            t = time.perf_counter()
            sess.generate(prompt, sampling=scfg, max_new_tokens=1)
            pre_ms = (time.perf_counter() - t) * 1e3
            for fn in wrappers.values():
                fn.launches = 0
            t = time.perf_counter()
            out = sess.generate(prompt, sampling=scfg, max_new_tokens=new)
            ms = (time.perf_counter() - t) * 1e3
            launches = {k: fn.launches for k, fn in wrappers.items()}
            got = replay(1)
            dec_ms = (ms - pre_ms) / (new - 1)
            print(f"  {tag} decode_attn_mode {mode!r}: decode {dec_ms:.3f} "
                  f"ms/token ({1e3 / dec_ms:.1f} tokens/s), prefill "
                  f"{pre_ms:.2f} ms")
            expect = {key: n_l * (new - 1), path["decode"]: 0}
            print(f"  launches {launches}, expected {expect}: "
                  f"{'ok' if launches == expect else 'FAIL'}")
            if launches != expect:
                errors.append(f"{tag} {mode}: launches {launches} != {expect}")
            results[key]["launches"] = (results[key].get("launches", 0)
                                        + launches[key])
            compare(f"{mode} first decode step logits vs 'auto'", got, ref,
                    errors, tol=LOGITS_TOL)
            same = np.array_equal(out.output_ids, auto_ids)
            print(f"  {mode} tokens identical to 'auto': {same} "
                  f"({out.output_ids[0, :12].tolist()}...)")
            if mode == "fused" and not same:  # row 9 runs kernel 3's body
                errors.append(f"{tag} 'fused': tokens differ from 'auto'")
            if not same:
                first = int(np.flatnonzero(out.output_ids[0] != auto_ids[0])[0])
                got_i = replay(first)
                picks = [int(got_i.argmax()), int(out.output_ids[0, first])]
            dev_tok, _ = profile_generate(sess, prompt, scfg, row_limit=6)
        if first is not None:         # the 'auto' logits of the same step
            ref_i = replay(first)
            picks += [int(ref_i.argmax()), int(auto_ids[0, first])]
            top2 = ref_i.float().topk(2, dim=-1).values[0]
            gap = float(top2[0] - top2[1])
            err = compare(f"{mode} logits vs 'auto' at token {first}, the "
                          "first that differs (same tokens before it)",
                          got_i, ref_i, errors, tol=LOGITS_TOL)
            print(f"  token {first}: the replays pick {picks[0]} ({mode}) and "
                  f"{picks[2]} ('auto'), the runs picked {picks[1]} and "
                  f"{picks[3]}; 'auto' top-2 gap {gap:.5f} against a max abs "
                  f"logit difference of {err:.5f} "
                  f"({'a near tie' if gap <= 2 * err else 'not a near tie'})")
        results["_e2e"][f"{tag} {mode}"] = dict(
            layers=n_l, prefill_ms=pre_ms, decode_ms_per_token=dec_ms,
            device_ms_per_decode_token=dev_tok,
            tokens_identical_to_auto=same)


def profile_generate(sess, ids, scfg, row_limit=24, new=None):
    """One request (bs1, or a batch) of `new` tokens (default PROFILE_NEW),
    timed on the host clock and then under torch.profiler: device time by
    kernel, and
    the device's busy share of the unprofiled wall; then the prefill alone
    (one token) under the profiler. Returns (device ms per decode token:
    the request's device time less the prefill's, over new - 1 steps; busy
    share). The profiler's cost grows with its events, so it sees a
    shorter request than the timed runs."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    new = new or PROFILE_NEW
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t = time.perf_counter()
    sess.generate(ids, sampling=scfg, max_new_tokens=new)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    t_prof = time.perf_counter()
    with profile(activities=acts) as prof:
        sess.generate(ids, sampling=scfg, max_new_tokens=new)
    events = prof.key_averages()

    def device_ms(evs):
        return sum(e.self_device_time_total for e in evs
                   if e.device_type == DeviceType.CUDA) / 1e3
    dev_ms = device_ms(events)
    with profile(activities=acts) as prof1:
        sess.generate(ids, sampling=scfg, max_new_tokens=1)
    pre_ms = device_ms(prof1.key_averages())
    dec_ms = (dev_ms - pre_ms) / (new - 1)
    print(f"  profile bs{len(ids)} out{new}: device busy {dev_ms:.1f} ms, "
          f"prefill alone {pre_ms:.2f} ms, so {dec_ms:.3f} ms per decode "
          f"step; of "
          f"{wall_ms:.1f} ms unprofiled wall: {100 * dev_ms / wall_ms:.1f}% "
          f"busy, {100 - 100 * dev_ms / wall_ms:.1f}% idle")
    print(events.table(sort_by="self_device_time_total", row_limit=row_limit,
                       max_name_column_width=60))
    print(f"  (the profiled request and its table took "
          f"{time.perf_counter() - t_prof:.1f} s)")
    return dec_ms, dev_ms / wall_ms


def decode_step_launches(sess, ids, scfg, new=PROFILE_NEW):
    """The decode steps of one request of `new` tokens, seen two ways from
    the request's first forward_decode (the prefill's kernels finished)
    to its end: (profile, calls). profile: each DECODE_KERNELS name's
    kernels in one profile of those steps alone (the profiler drops a
    record now and then: 0-2 of ~2400 GEMV kernels on an H100,
    so it shows which kernels ran, not their exact number); calls: the
    GEMV wrappers' exact one-row launches in the same steps ("projections":
    the stacked wrappers and the 2-D w8a8_matmul of static SmoothQuant;
    "lm_head": the 2-D woq / fp8 entries) and their tensor-core / GEMM
    launches ("other")."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    model = sess.model
    wrappers = _wrappers()
    groups = {"projections": ("woq_matmul_stacked", "fp8_matmul_stacked",
                              "w8a8_matmul_stacked", "w8a8_matmul"),
              "lm_head": ("woq_matmul", "fp8_matmul")}

    def calls():
        out = {"other": 0}
        for group, names in groups.items():
            out[group] = 0
            for name in names:
                fn = wrappers[name]
                other = (getattr(fn, "gemm_launches", 0)
                         + getattr(fn, "tc_launches", 0))
                out[group] += fn.launches - other
                out["other"] += other
        return out

    class StartAtFirstStep:
        before = None

        def __getattr__(self, name):
            return getattr(model, name)

        def forward_decode(self, *args, **kwargs):
            if self.before is None:
                torch.cuda.synchronize()       # the prefill's kernels ended
                self.before = calls()
                prof.start()
            return model.forward_decode(*args, **kwargs)

    sess.model = hook = StartAtFirstStep()
    try:
        sess.generate(ids, sampling=scfg, max_new_tokens=new)
        torch.cuda.synchronize()
    finally:
        sess.model = model
        if hook.before is not None:
            prof.stop()
    after = calls()
    events = prof.key_averages()
    return ({name: sum(e.count for e in events
                       if e.device_type == DeviceType.CUDA and name in e.key)
             for name in DECODE_KERNELS},
            {k: after[k] - hook.before[k] for k in after})


# ---------------------------------------------------------------------------
# path 7: the hackathon's offline build (SmoothQuant migration, static W8A8
# + int8 KV engine dir, the loader)
# ---------------------------------------------------------------------------

def hf_llama_state_dict(cfg, seed=0):
    """An HF-layout LLaMA state dict ([out, in] linear weights) drawn on
    the card in bf16: normal x fan_in**-0.5 (embedding and lm_head as
    init_random_quantized_params draws them), norms of ones."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    d, f, bf16 = cfg.hidden_size, cfg.intermediate_size, torch.bfloat16

    def normal(shape, fan_in):
        return torch.randn(shape, generator=g, device="cuda",
                           dtype=bf16) * fan_in ** -0.5
    sd = {}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            sd[p + f"self_attn.{name}.weight"] = normal((d, d), d)
        sd[p + "mlp.gate_proj.weight"] = normal((f, d), d)
        sd[p + "mlp.up_proj.weight"] = normal((f, d), d)
        sd[p + "mlp.down_proj.weight"] = normal((d, f), f)
        for norm in ("input_layernorm", "post_attention_layernorm"):
            sd[p + f"{norm}.weight"] = torch.ones(d, device="cuda", dtype=bf16)
    sd["model.embed_tokens.weight"] = normal((cfg.vocab_size, d), d)
    sd["lm_head.weight"] = normal((cfg.vocab_size, d), d)
    sd["model.norm.weight"] = torch.ones(d, device="cuda", dtype=bf16)
    return sd


def synthetic_ranges(sd, n_l, d, f, seed=0):
    """Calibration ranges made from a seed (no calibration corpus is at
    hand): x_absmax per layer and input channel |N(0, 1)| with
    OUTLIER_SHARE of the channels times OUTLIER_GAIN, shared by q/k/v and
    by gate/up; w_absmax from the weights, as capture_activation_ranges
    computes it; kv_absmax 127 x KV_SCALE in every layer."""
    import numpy as np
    from trtllm_llama_tpu_torch.quantization.calibrate import weight_absmax
    rng = np.random.default_rng(seed)

    def x_range(k):
        a = np.abs(rng.standard_normal((n_l, k)))
        a[rng.random((n_l, k)) < OUTLIER_SHARE] *= OUTLIER_GAIN
        return a.astype(np.float32)
    qkv, gate_up = x_range(d), x_range(d)
    x_absmax = {"wq": qkv, "wk": qkv.copy(), "wv": qkv.copy(), "wo": x_range(d),
                "w_gate": gate_up, "w_up": gate_up.copy(),
                "w_down": x_range(f)}
    return {"x_absmax": x_absmax, "w_absmax": weight_absmax(sd, n_l),
            "kv_absmax": np.full(n_l, 127.0 * KV_SCALE)}


def run_offline_build(args, errors, results):
    """Path 7: the offline build (build_offline), driven as paths 1-4 (row 5
    on every projection), and again under TLLM_FUSE_GU=1."""
    drive_path(make_path7(), build_offline(args, errors, results), errors,
               results)


def build_offline(args, errors, results):
    """Path 7's session: ModelConfig.from_hf_config of huggyllama/llama-7b's
    config.json fields; an HF-layout bf16 state dict drawn on the card;
    synthetic ranges; smooth_hf_state_dict (alpha 0.5) ->
    params_from_hf_state_dict (f32) -> quantize_params (static per-tensor
    SmoothQuant + int8 KV) -> cast_fp_leaves -> kv_scales_from_ranges ->
    save_engine -> load_engine(device="cuda"), every leaf byte-equal to the
    saved one, each stage timed; then GenerationSession on the loaded
    params."""
    import shutil
    import tempfile
    import types

    import numpy as np
    import torch
    from trtllm_llama_tpu_torch import EngineConfig, ModelConfig, QuantMode
    from trtllm_llama_tpu_torch.convert.convert import cast_fp_leaves
    from trtllm_llama_tpu_torch.convert.hf import params_from_hf_state_dict
    from trtllm_llama_tpu_torch.convert.serialize import (flatten, load_engine,
                                                          save_engine)
    from trtllm_llama_tpu_torch.quantization.calibrate import (
        act_ranges_for_smoothquant, kv_scales_from_ranges,
    )
    from trtllm_llama_tpu_torch.quantization.quantize import quantize_params
    from trtllm_llama_tpu_torch.quantization.smoothquant import (
        smooth_hf_state_dict,
    )
    from trtllm_llama_tpu_torch.runtime.session import GenerationSession

    mode = QuantMode.use_smooth_quant() | QuantMode.INT8_KV_CACHE
    hf = types.SimpleNamespace(**HF_LLAMA_7B)
    cfg = ModelConfig.from_hf_config(hf, dtype="bfloat16", quant_mode=mode)
    matches = cfg == ModelConfig.llama_7b(quant_mode=mode)
    if not matches:
        errors.append(f"path 7: from_hf_config gave {cfg}, not llama_7b's "
                      "fields")
    cfg = ModelConfig.from_hf_config(hf, dtype="bfloat16", quant_mode=mode,
                                     num_layers=min(args.layers, PATH7_DEPTH))
    n_l, d, f = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    print(f"path 7: the offline build, LLaMA-7B from huggyllama/llama-7b's "
          f"config.json (from_hf_config equals llama_7b: {matches}), {n_l} "
          "layers, static per-tensor SmoothQuant W8A8 + int8 KV, random "
          "HF-layout bf16 weights (seed 0), synthetic ranges (seed 0)")
    torch.cuda.reset_peak_memory_stats()
    stages = {}

    def stage(name, t):
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t
        print(f"  {name}: {stages[name]:.2f} s, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
        return time.perf_counter()

    t = time.perf_counter()
    sd = hf_llama_state_dict(cfg)
    t = stage("HF state dict (bf16, on the card)", t)
    ranges = synthetic_ranges(sd, n_l, d, f)
    t = stage("ranges (w_absmax from the weights)", t)
    sd, x_absmax = smooth_hf_state_dict(sd, ranges, n_l, alpha=SQ_ALPHA)
    t = stage(f"smooth_hf_state_dict (alpha {SQ_ALPHA})", t)
    params = params_from_hf_state_dict(sd, cfg, dtype="float32")
    del sd
    t = stage("params_from_hf_state_dict (f32)", t)
    q = quantize_params(params, mode, act_ranges=act_ranges_for_smoothquant(
        {"x_absmax": x_absmax}))
    del params
    q = cast_fp_leaves(q, cfg.torch_dtype)
    kv_scales = kv_scales_from_ranges(ranges)
    t = stage("quantize_params + cast_fp_leaves + kv_scales", t)
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    engine_dir = tempfile.mkdtemp(prefix="path7_engine_", dir=root)
    try:
        save_engine(engine_dir, cfg, q, kv_scales)
        t = stage("save_engine", t)
        n_bytes = sum(p.stat().st_size for p in Path(engine_dir).rglob("*")
                      if p.is_file())
        cfg2, loaded, kv2 = load_engine(engine_dir, device="cuda")
        t = stage("load_engine (device='cuda')", t)
    finally:
        shutil.rmtree(engine_dir)
    saved, back = flatten(q), flatten(loaded)
    same = (cfg2 == cfg and np.array_equal(kv2, kv_scales)
            and [n for n, _ in saved] == [n for n, _ in back]
            and all(a.dtype == b.dtype and a.shape == b.shape and torch.equal(
                a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
                for (_, a), (_, b) in zip(saved, back)))
    n_leaves = len(back)
    del q, saved, back
    t = stage("leaf comparison", t)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  engine dir: {n_leaves} leaves, {n_bytes / 1e9:.3f} GB; every "
          f"leaf byte-equal to the saved one, config and kv_scales equal: "
          f"{same}; peak device memory {peak:.2f} GiB")
    if not same:
        errors.append("path 7: the loaded engine dir differs from the saved "
                      "params")
    results["_e2e"]["path 7 build"] = dict(
        stages_s=stages, engine_dir_bytes=n_bytes, peak_gib=peak,
        leaves=n_leaves, byte_equal=same)
    w = loaded["layers"]["wq"]
    print(f"  wq: SQWeight {tuple(w.qweight.shape)}, per_token "
          f"{w.per_token}, per_channel {w.per_channel}, scale_x "
          f"{w.scale_x[:3].tolist()}...; kv_scales {kv2[:3].tolist()}...")
    return GenerationSession(cfg2, loaded, EngineConfig(**PATH_ENGINE),
                             kv_scales=kv2, device="cuda")


# ---------------------------------------------------------------------------
# path 5: long-context generation (8192-token prompt, int8 weights + KV)
# ---------------------------------------------------------------------------

def gemv_calls(events):
    """Device ms of each kernel-1 call in a profile, in launch order: a call
    is the one-row GEMV's kernel or the GEMM's kernel, plus the split-K
    reduce that follows the GEMM's."""
    from torch.autograd import DeviceType
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    calls = []
    for e in kernels:
        if "gemv::gemv_kernel" in e.name or "gemm::gemm_kernel" in e.name:
            calls.append(e.time_range.elapsed_us() / 1e3)
        elif "gemv::reduce_kernel" in e.name and calls:
            calls[-1] += e.time_range.elapsed_us() / 1e3
    return calls


def run_long_context(args, errors, results):
    """Path 5: bench.py's long-context int8_int8kv configuration through
    GenerationSession: one 8192-token prompt (seed 0), 64 greedy tokens
    (the counted run: row 12 once per layer, kernel 1's GEMM 5 times per
    layer in the prefill, its GEMV 5 times per layer and decode step,
    kernel 3 once per layer and decode step, kernel 2 and rows 8 and 9
    never). Then one prefill under the profiler (prefill ms, kernel 1's
    GEMM time per call at M=8192), its logits against the plain path's
    (the first token: where the argmaxes differ, a near tie), the first
    decode step's logits
    against the plain path's on a copy of the 8k cache, and decode steps
    over that cache (host wall, device ms, idle share). Decode ms/token is the generate's
    wall less the prefill's, over 63 steps."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from trtllm_llama_tpu_torch import EngineConfig, ModelConfig, QuantMode
    from trtllm_llama_tpu_torch.models import llama
    from trtllm_llama_tpu_torch.ops.kernels import decode_attention as da
    from trtllm_llama_tpu_torch.ops.kernels import prefill_attention as pa
    from trtllm_llama_tpu_torch.ops.kernels import (
        streaming_prefill_attention as spa,
    )
    from trtllm_llama_tpu_torch.ops.kernels import woq_matmul as woq
    from trtllm_llama_tpu_torch.quantization.quantize import (
        init_random_quantized_params,
    )
    from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
    from trtllm_llama_tpu_torch.runtime.session import GenerationSession

    cfg = ModelConfig.llama_7b(
        quant_mode=QuantMode.use_weight_only(False) | QuantMode.INT8_KV_CACHE,
        max_position_embeddings=LONG_ROPE, num_layers=args.layers)
    n_l = cfg.num_layers
    print(f"path 5: LLaMA-7B widths, {n_l} layers, int8 weight-only "
          f"per-channel, int8 KV (scale {KV_SCALE}), RoPE table of "
          f"{LONG_ROPE}, {LONG_ENGINE}; one {LONG_PROMPT}-token prompt "
          f"(seed 0), {LONG_NEW} greedy tokens, random weights born quantized")
    params = init_random_quantized_params(cfg, seed=0, device="cuda")
    sess = GenerationSession(cfg, params, EngineConfig(**LONG_ENGINE),
                             kv_scales=[KV_SCALE] * n_l, device="cuda")
    del params
    scfg = SamplingConfig(end_id=-1)
    prompt = np.random.default_rng(0).integers(3, cfg.vocab_size,
                                               (1, LONG_PROMPT))

    wrappers = {"woq_matmul_stacked": woq.woq_matmul_stacked,
                TC_INT8: woq.woq_matmul_stacked,
                GEMM_INT8: woq.woq_matmul_stacked,
                STREAMING: spa.streaming_prefill_attention_kernel,
                INT8_DECODE: da.dma_decode_attention,
                "prefill_attention_kernel": pa.prefill_attention_kernel,
                READ_ONLY_INT8: da.decode_attention_kernel,
                FUSED_INT8: da.fused_decode_attention}
    zero_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = sess.generate(prompt, sampling=scfg, max_new_tokens=LONG_NEW)
    ms = (time.perf_counter() - t) * 1e3
    launches = {k: launches_of(k, fn) for k, fn in wrappers.items()}
    print(f"  bs1 in{LONG_PROMPT} out{LONG_NEW}: {ms:.1f} ms, "
          f"{LONG_NEW / ms * 1e3:.2f} tokens/s end to end")
    dec = 5 * n_l * (LONG_NEW - 1)             # 1-row decode steps
    expect = {"woq_matmul_stacked": 0 if tc_rows(1) else dec,
              TC_INT8: dec if tc_rows(1) else 0,
              GEMM_INT8: 5 * n_l, STREAMING: n_l,
              INT8_DECODE: n_l * (LONG_NEW - 1),
              "prefill_attention_kernel": 0, READ_ONLY_INT8: 0,
              FUSED_INT8: 0}
    print(f"  launches {launches}, expected {expect}: "
          f"{'ok' if launches == expect else 'FAIL'}")
    if launches != expect:
        errors.append(f"path 5: launches {launches} != {expect}")
    for k in ("woq_matmul_stacked", TC_INT8, GEMM_INT8, STREAMING,
              INT8_DECODE):
        results[k]["launches"] = results[k].get("launches", 0) + launches[k]
    ids = out.output_ids
    ok = (ids.shape == (1, LONG_NEW) and (ids >= 0).all()
          and (ids < cfg.vocab_size).all() and (out.lengths == LONG_NEW).all())
    print(f"  tokens {ids.shape}: {ids[0, :12].tolist()}... "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        errors.append(f"path 5: bad output {ids.shape}")

    # the prefill under the profiler (its host wall is the prefill time:
    # the profiler adds ~1 us per launch to ~45 s), then the plain path
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    s_max = LONG_PROMPT + LONG_NEW
    with torch.inference_mode():
        ids_t = torch.as_tensor(prompt, dtype=torch.int32, device="cuda")
        lens = torch.tensor([LONG_PROMPT], dtype=torch.int32, device="cuda")

        def prefill():
            caches = llama.init_caches(cfg, 1, s_max, "cuda", sess.kv_scales)
            return llama.forward_prefill(sess.params, cfg, ids_t, lens,
                                         caches, rope=sess.rope)
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t = time.perf_counter()
            got, caches = prefill()
            torch.cuda.synchronize()
            pre_ms = (time.perf_counter() - t) * 1e3
        events = prof.events()
        dev_ms = sum(e.time_range.elapsed_us() for e in events
                     if e.device_type == DeviceType.CUDA) / 1e3
        calls = gemv_calls(events)
        k1_ms = sum(calls)
        dec_ms = (ms - pre_ms) / (LONG_NEW - 1)
        print(f"  prefill {pre_ms:.1f} ms (host wall); decode {dec_ms:.3f} "
              f"ms/token (the generate's wall less it, over {LONG_NEW - 1} "
              f"steps), {1e3 / dec_ms:.1f} decode tokens/s")
        print(f"  profile of the {LONG_PROMPT}-row prefill: device busy "
              f"{dev_ms:.1f} ms; kernel 1 (int8 GEMM, M={LONG_PROMPT}) "
              f"{len(calls)} calls, {k1_ms:.1f} ms ({100 * k1_ms / dev_ms:.1f}"
              f"% of the device time)")
        if len(calls) == 5 * n_l:
            per = {name: sum(calls[i::5]) / n_l for i, name in enumerate(
                ("qkv", "wo", "gate", "up", "down"))}
            print("  kernel 1 ms per call at M=8192 (profile): "
                  + ", ".join(f"{k} {v:.2f}" for k, v in per.items()))
            results["_e2e"]["path 5 kernel 1 ms per call"] = per
        gemv_8192_yardsticks(sess, results)
        print(prof.key_averages().table(sort_by="self_device_time_total",
                                        row_limit=8, max_name_column_width=60))
        with contextlib.ExitStack() as stack:
            for mod, attr in ((woq, "woq_matmul_stacked"),
                              (spa, "streaming_prefill_attention_kernel")):
                stack.enter_context(patched(mod, attr,
                                            getattr(mod, attr + "_plain")))
            ref, _ = prefill()
        compare(f"7B {LONG_PROMPT}-token prefill logits, kernels vs plain",
                got, ref, errors, tol=LOGITS_TOL)
        print(f"  argmax kernels {got.argmax(-1).tolist()} plain "
              f"{ref.argmax(-1).tolist()}")
        # the GEMM's first token against the plain path's (the GEMV's
        # arithmetic; the GEMV itself takes ~44 s for this prefill)
        flip_check("path 5 first token, GEMM vs plain", got, ref, errors)

        # the first decode step over the 8k cache (kernel 3 writes row 8192
        # and attends 8193 int8 rows), kernels vs plain on copies of the
        # same caches
        tok = got.argmax(-1).to(torch.int32)
        pos = lens.clone()
        plain_caches = caches._replace(k=caches.k.clone(), v=caches.v.clone())
        step, caches = llama.forward_decode(sess.params, cfg, tok, pos,
                                            caches, rope=sess.rope)
        with contextlib.ExitStack() as stack:
            for mod, attr in ((woq, "woq_matmul_stacked"),
                              (da, "dma_decode_attention")):
                stack.enter_context(patched(mod, attr,
                                            getattr(mod, attr + "_plain")))
            step_ref, plain_caches = llama.forward_decode(
                sess.params, cfg, tok, pos, plain_caches, rope=sess.rope)
        compare(f"7B decode step at row {LONG_PROMPT} of the {LONG_S_MAX}-row"
                " int8 cache, logits kernels vs plain", step, step_ref, errors,
                tol=LOGITS_TOL)
        del plain_caches, step_ref
        tok = step.argmax(-1).to(torch.int32)
        pos.add_(1)

        # decode steps over the 8k cache: host wall, then device time

        def steps(n):
            nonlocal tok
            for _ in range(n):
                logits, _ = llama.forward_decode(sess.params, cfg, tok, pos,
                                                 caches, rope=sess.rope)
                tok = logits.argmax(-1).to(torch.int32)
                pos.add_(1)
        n_steps = 16
        steps(1)
        torch.cuda.synchronize()
        t = time.perf_counter()
        steps(n_steps)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / n_steps
        calls = da.dma_decode_attention.launches
        with profile(activities=acts) as prof:
            steps(n_steps)
            torch.cuda.synchronize()
        calls = da.dma_decode_attention.launches - calls
        step_dev = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA) / 1e3 / n_steps
        # kernel 3 in the profile: at most one kernel a call (the profiler
        # may miss a kernel as it starts) and no partial / combine kernel
        k3 = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and "flash_decode" in e.key]
        k3_ms = sum(e.self_device_time_total for e in k3) / 1e3 / n_steps
        k3_n = sum(e.count for e in k3)
        stale = [e.key for e in prof.key_averages()
                 if "decode_partial" in e.key or "decode_combine" in e.key]
    print(f"  decode steps at positions {LONG_PROMPT + 2}-"
          f"{LONG_PROMPT + 1 + 2 * n_steps}: {wall:.3f} ms/token wall, "
          f"device {step_dev:.3f} ms/token: {100 * step_dev / wall:.1f}% "
          f"busy, {100 - 100 * step_dev / wall:.1f}% idle")
    print(f"  kernel 3 (flash_decode): {k3_n} kernels in the profile for "
          f"{calls} calls ({n_steps} steps of {n_l} layers), {k3_ms:.3f} "
          f"device ms per decode token of {step_dev:.3f}")
    if (calls != n_steps * n_l or k3_n > calls or k3_n < calls - n_l
            or stale):
        errors.append(f"path 5: kernel 3 ran {k3_n} kernels in the profile "
                      f"for {calls} calls (one a call), others {stale}")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=8, max_name_column_width=60))
    results["_e2e"]["path 5"] = dict(
        layers=n_l, prefill_ms=pre_ms, decode_ms_per_token=dec_ms,
        decode_tokens_per_s=1e3 / dec_ms, e2e_tokens_per_s=LONG_NEW / ms * 1e3,
        prefill_device_ms=dev_ms, prefill_kernel1_ms=k1_ms,
        decode_step_wall_ms=wall, decode_step_device_ms=step_dev,
        decode_step_kernel3_ms=k3_ms)


def gemv_8192_yardsticks(sess, results):
    """Kernel 1's plain version and the library call (torch.matmul of the
    bf16-dequantized weight) at path 5's M=8192, on layer 0 of the session's
    int8 weights: the qkv / wo / gate,up / down shapes (the kernel's own
    times, its GEMM's gemm_kernel, come from the path's profile)."""
    import torch
    from trtllm_llama_tpu_torch.ops.kernels import woq_matmul as woq

    g = torch.Generator(device="cuda").manual_seed(20)
    lw, out = sess.params["layers"], {}
    for name in ("wqkv", "wo", "w_up", "w_down"):
        w = lw[name]
        x = torch.randn((LONG_PROMPT, w.k_dim), generator=g,
                        device="cuda").to(torch.bfloat16)
        dq = (w.qweight[0].float() * w.scale[0]).to(torch.bfloat16)
        t_p = time_ms(lambda i: woq.woq_matmul_stacked_plain(x, w, 0),
                      iters=2, warmup=1, reps=1)
        t_l = time_ms(lambda i: torch.matmul(x, dq), iters=4)
        out[name] = dict(plain_ms=t_p, library_ms=t_l)
        del x, dq
    print("  kernel 1 (GEMM) at M=8192, plain / library (torch.matmul of "
          "the bf16-dequantized weight) ms: " + ", ".join(
              f"{k} {v['plain_ms']:.3f} / {v['library_ms']:.3f}"
              for k, v in out.items()))
    results["_e2e"]["path 5 kernel 1 M=8192 plain and library ms"] = out


# ---------------------------------------------------------------------------
# the serving phase: ServingEngine dense / paged / packed / paged int8 KV /
# paged fp8 KV
# ---------------------------------------------------------------------------

# (name, engine options, KV cache kind: None for the compute dtype, "int8"
# or "e4m3" at KV_SCALE)
PER_REQUEST = "dense, per-request sampling"
CHUNKED = "dense, chunked prefill 32"
MIXED = "dense, mixed step"
PIPELINED = "dense, pipelined"
PAGED_PIPELINED = "paged, pipelined"
SERVE_CONFIGS = [
    ("dense", {}, None),
    (PER_REQUEST, dict(per_request_sampling=True, return_logprobs=True,
                       max_bad_words=4), None),
    ("paged", dict(paged=True, block_size=SERVE_BLOCK), None),
    ("packed", dict(packed_prefill=True), None),
    ("paged int8 KV", dict(paged=True, block_size=SERVE_BLOCK), "int8"),
    ("paged fp8 KV", dict(paged=True, block_size=SERVE_BLOCK), "e4m3"),
    (CHUNKED, dict(prefill_chunk=SERVE_PREFILL_CHUNK), None),
    (MIXED, dict(mixed_step=True), None),
    (PIPELINED, dict(pipelined=True), None),
    (PAGED_PIPELINED, dict(paged=True, block_size=SERVE_BLOCK,
                           pipelined=True), None),
]
# the configurations whose decode step is profiled (profile_serving_step):
# dense, paged, packed and dense pipelined (the smoke's time budget: the
# per-request, int8-KV and fp8-KV chunks took 110.0-115.5 device ms
# against dense's 110.1); the dense pipelined one's busy share stands
# beside dense's
SERVE_PROFILED = ("dense", "paged", "packed", PIPELINED)


def serving_sampling(dense):
    """The per-request configs of the sampled serving run, one a request,
    from the dense greedy run's tokens `dense`: 6 greedy (None), 6 with
    temperature / top-k / top-p, 2 with penalties and a min_length, one
    with a two-token bad word and one with a stop word (both taken from its
    dense tokens), the stop request among the second wave's prompts so the
    admission waves stay those of the other configurations."""
    from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig

    def cfg(**kw):
        return SamplingConfig(end_id=-1, **kw)
    sampled = [cfg(temperature=0.8, top_k=40, top_p=0.95),
               cfg(temperature=1.0, top_p=0.9), cfg(temperature=0.7, top_k=20),
               cfg(temperature=1.2, top_k=50, top_p=0.8),
               cfg(top_p=0.5), cfg(temperature=0.9, top_k=5)]
    out = [None] * SERVE_REQUESTS
    for i, c in zip((1, 4, 7, 10, 13, 14), sampled):
        out[i] = c
    out[2] = cfg(repetition_penalty=1.1, min_length=8)
    out[5] = cfg(presence_penalty=0.5, frequency_penalty=0.3, min_length=4)
    out[8] = cfg(bad_words=((dense[8][4], dense[8][5]),))
    out[11] = cfg(stop_words=((dense[11][5], dense[11][6]),))
    return out


def serving_replay(eng, prompt, tokens):
    """f32 logits [V] that follow `prompt` and then `tokens` on the
    engine's (or a GenerationSession's) model and weights, replayed at bs1
    (the prompt's bucket, then one decode step a token); under tensor
    parallelism on every rank of its group at once."""
    import torch
    from trtllm_llama_tpu_torch.ops.linear import tp_scope

    cfg, dev, model = eng.model_cfg, eng.device, eng.model
    bucket = eng.engine_cfg.bucket_for(len(prompt))
    with torch.inference_mode(), tp_scope(eng.group):
        ids = torch.zeros((1, bucket), dtype=torch.int32, device=dev)
        ids[0, :len(prompt)] = torch.as_tensor(prompt, device=dev)
        pos = torch.tensor([len(prompt)], dtype=torch.int32, device=dev)
        caches = model.init_caches(cfg, 1, eng.engine_cfg.max_seq_len, dev,
                                   eng.kv_scales)
        logits, caches = model.forward_prefill(eng.params, cfg, ids, pos,
                                               caches, rope=eng.rope)
        pos = pos.clone()
        for t in tokens:
            logits, caches = model.forward_decode(
                eng.params, cfg, torch.tensor([t], dtype=torch.int32,
                                              device=dev), pos, caches,
                rope=eng.rope)
            pos += 1
    return logits[0].float()


def check_serving_sampling(eng, prompts, done, rids, cfgs, dense, errors):
    """The sampled serving run's requests: greedy ones equal the dense
    run's tokens (a difference must be a near tie on a bs1 replay), the
    bad word never completed, the stop request finished "stop_words" where
    its pair first completes, the others SERVE_NEW tokens; one logprob a
    token everywhere."""
    outs = [list(done[r].output_ids) for r in rids]
    greedy = [i for i, c in enumerate(cfgs) if c is None]
    differ = [i for i in greedy if outs[i] != dense[i]]
    print(f"  {PER_REQUEST}: greedy requests {greedy} equal the dense run's "
          f"tokens but {differ}")
    for i in differ:
        k = next(j for j, (a, b) in enumerate(zip(outs[i], dense[i]))
                 if a != b)
        near_tie(f"{PER_REQUEST} greedy request {i} token {k}",
                 serving_replay(eng, prompts[i], outs[i][:k]), outs[i][k],
                 dense[i][k], errors)
    (b1, b2), = cfgs[8].bad_words
    bad = outs[8]
    ok_bad = (b1, b2) not in zip(bad, bad[1:]) and len(bad) == SERVE_NEW
    stop = cfgs[11].stop_words[0]
    want = next(k + 1 for k in range(1, len(dense[11]))
                if tuple(dense[11][k - 1:k + 1]) == stop)
    ok_stop = (outs[11] == dense[11][:want]
               and done[rids[11]].finished_reason == "stop_words")
    ok_lp = all(len(done[r].logprobs) == len(done[r].output_ids)
                for r in rids)
    ok_len = all(len(outs[i]) == SERVE_NEW for i in range(SERVE_REQUESTS)
                 if i != 11)
    print(f"  {PER_REQUEST}: bad word ({b1}, {b2}) never completed: {ok_bad}"
          f" (dense completed it at token 5); stop word {stop} ends request "
          f"11 at {len(outs[11])} tokens, reason "
          f"{done[rids[11]].finished_reason!r} (expected {want}): {ok_stop}; "
          f"one logprob a token: {ok_lp}; the rest {SERVE_NEW} tokens: "
          f"{ok_len}; sampled requests' first tokens "
          f"{[outs[i][0] for i in (1, 4, 7, 10, 13, 14)]}")
    for ok, what in ((ok_bad, "a bad word was completed"),
                     (ok_stop, "the stop request did not stop at its pair"),
                     (ok_lp, "a request lacks a logprob a token"),
                     (ok_len, f"a request did not return {SERVE_NEW} tokens")):
        if not ok:
            errors.append(f"serving {PER_REQUEST}: {what}")


class ExtendRecorder:
    """A model that forwards to `model` and keeps, for each forward_extend
    call, its tokens, its start and its f32 logits [B, T, V] (on the card,
    no sync): the chunked serving run's final chunks, held against a
    monolithic prefill after the run; the speculative runs' verify slabs."""

    def __init__(self, model):
        self._model = model
        self.calls = []

    def __getattr__(self, name):
        return getattr(self._model, name)

    def forward_extend(self, params, cfg, tokens, start, caches, **kw):
        logits, caches = self._model.forward_extend(params, cfg, tokens,
                                                    start, caches, **kw)
        self.calls.append((tokens.clone(), start.clone(),
                           logits.float().clone()))
        return logits, caches


def serving_expect(eng, n_l, decode, prefill):
    """Exact launches of a serving run from the engine's own counts: the
    tensor-core GEMV 5 x layers at each 9-row decode step; the GEMM 5 x
    layers at each monolithic (batched, packed or mixed) prefill and each
    chunked-prefill call (32 rows a partial prompt, always past 16);
    row 10 or 13 once a layer and monolithic prefill (a chunk's attention
    is stock torch); kernel 3 / row 14 once a layer and decode step."""
    calls = eng.calls
    prefills = calls["packed_prefills" if eng.packed else "prefills"]
    steps = 5 * n_l * calls["decode_steps"]
    dec_tc = tc_rows(SERVE_ENGINE["max_batch_size"] + 1)
    return {"woq_matmul_stacked": 0 if dec_tc else steps,
            TC_INT8: steps if dec_tc else 0,
            GEMM_INT8: 5 * n_l * (prefills + len(eng.chunk_rows)),
            decode: n_l * calls["decode_steps"],
            prefill: n_l * prefills}


def first_difference_at(out, ref):
    return next((j for j, (a, b) in enumerate(zip(out, ref)) if a != b),
                None)


def check_same_tokens(name, eng, prompts, outs, dense, errors):
    """Every request's tokens equal the dense run's; where one differs
    first, at token k, the two picks must be a near tie on a bs1 replay of
    the engine's weights over the common first k tokens."""
    diffs = {i: first_difference_at(o, d)
             for i, (o, d) in enumerate(zip(outs, dense))}
    differ = {i: k for i, k in diffs.items() if k is not None}
    print(f"  {name} vs dense: {SERVE_REQUESTS - len(differ)} of "
          f"{SERVE_REQUESTS} requests token for token; first differing "
          f"positions of the others: {differ}")
    for i, k in differ.items():
        near_tie(f"{name} request {i} token {k}",
                 serving_replay(eng, prompts[i], outs[i][:k]), outs[i][k],
                 dense[i][k], errors)


def check_chunked(eng, prompts, outs, dense, errors, results):
    """The chunked run: the Σ rows of its chunk calls are C x the chunks of
    its long prompts; each long prompt's final chunk's last-row logits (the
    engine's own call, ExtendRecorder) against a monolithic forward_prefill
    of the prompt within LOGITS_TOL; first tokens equal the dense run's but
    at near ties (on the monolithic logits)."""
    import torch
    from trtllm_llama_tpu_torch.ops.kernels import woq_matmul as woq

    c = SERVE_PREFILL_CHUNK
    long = [i for i, p in enumerate(prompts) if len(p) > c]
    want_rows = c * sum(-(-len(prompts[i]) // c) for i in long)
    print(f"  {CHUNKED}: {len(long)} prompts longer than {c} tokens, "
          f"{eng.calls['chunk_prefills']} chunk calls of {eng.chunk_rows} "
          f"rows ({sum(eng.chunk_rows)} in all, expected {want_rows})")
    if sum(eng.chunk_rows) != want_rows:
        errors.append(f"serving {CHUNKED}: chunk rows {sum(eng.chunk_rows)} "
                      f"!= {want_rows}")
    if any(r < woq.GEMM_MIN_ROWS for r in eng.chunk_rows):
        errors.append(f"serving {CHUNKED}: a chunk call below the GEMM's "
                      f"{woq.GEMM_MIN_ROWS} rows (serving_expect counts "
                      "every chunk call on the GEMM)")
    finals = {}
    for tokens, _, logits in eng.model.calls:
        for row in range(tokens.shape[0]):
            finals[tuple(tokens[row].tolist())] = logits[row, -1]
    cfg, dev = eng.cfg, eng.device
    bucket = max(SERVE_ENGINE["prefill_buckets"])
    with torch.inference_mode():
        ids = torch.full((len(long), bucket), eng.scfg.pad_id,
                         dtype=torch.int32, device=dev)
        for j, i in enumerate(long):
            ids[j, :len(prompts[i])] = torch.as_tensor(prompts[i], device=dev)
        lens = torch.as_tensor([len(prompts[i]) for i in long],
                               dtype=torch.int32, device=dev)
        caches = eng.model.init_caches(cfg, len(long), bucket, dev,
                                       eng.kv_scales)
        mono, _ = eng.model.forward_prefill(eng.params, cfg, ids, lens, caches,
                                            rope=eng.rope)
    missing = [i for i in long if tuple(prompts[i][-c:]) not in finals]
    if missing:
        errors.append(f"serving {CHUNKED}: no final chunk recorded for "
                      f"requests {missing}")
        return
    got = torch.stack([finals[tuple(prompts[i][-c:])] for i in long])
    err = compare(f"{CHUNKED}: final-chunk logits of the {len(long)} long "
                  "prompts vs monolithic prefill", got, mono, errors,
                  tol=LOGITS_TOL)
    results["_e2e"][f"serving {CHUNKED}"]["final_chunk_logits_max_abs_err"] \
        = err
    for j, i in enumerate(long):
        if outs[i] and outs[i][0] != dense[i][0]:
            near_tie(f"{CHUNKED} request {i} first token", mono[j],
                     outs[i][0], dense[i][0], errors)
    firsts = sum(outs[i][:1] == dense[i][:1] for i in range(len(outs)))
    diffs = [first_difference_at(o, d) for o, d in zip(outs, dense)]
    print(f"  {CHUNKED}: first tokens equal the dense run's for {firsts} of "
          f"{len(outs)} requests; {sum(d is None for d in diffs)} token for "
          f"token; first differing positions of the others: "
          f"{[d for d in diffs if d is not None]}")


def serve_edge_request(eng, errors, results):
    """Paged pipelined: one request with input_len + max_new_tokens ==
    max_seq_len served alone to its end (the case where JAX's engine
    raises): all its tokens, reason "length", every block back."""
    import numpy as np
    prompt = np.random.default_rng(2).integers(
        3, eng.cfg.vocab_size, EDGE_PROMPT).tolist()
    new = SERVE_ENGINE["max_seq_len"] - EDGE_PROMPT
    rid = eng.submit(prompt, new)
    done = eng.run_to_completion()
    fr = done.get(rid)
    ok = (fr is not None and len(fr.output_ids) == new
          and fr.finished_reason == "length"
          and eng.kv_mgr.blocks.free_blocks == eng.num_blocks)
    print(f"  {PAGED_PIPELINED}: one request of {EDGE_PROMPT} + {new} = "
          f"max_seq_len tokens: {len(fr.output_ids) if fr else None} tokens, "
          f"reason {fr.finished_reason if fr else None!r}, "
          f"{eng.kv_mgr.blocks.free_blocks} of {eng.num_blocks} blocks free "
          f"after it: {'ok' if ok else 'FAIL'}")
    if not ok:
        errors.append(f"serving {PAGED_PIPELINED}: the max_seq_len request "
                      "was not served to its end")
    results["_e2e"][f"serving {PAGED_PIPELINED}"]["max_seq_len_request_ok"] \
        = ok


def check_extend_vs_decode(eng, errors, results):
    """forward_extend at full width on the serving weights (path 1's: int8
    weight-only, seed 0): an 8-token prefill, then T = EXTEND_T tokens as
    one slab against EXTEND_T forward_decode steps on another cache: the
    logits within LOGITS_TOL, the T written K/V rows too."""
    import numpy as np
    import torch

    cfg, dev, t = eng.cfg, eng.device, EXTEND_T
    rng = np.random.default_rng(3)
    ids = torch.as_tensor(rng.integers(3, cfg.vocab_size, (1, 8)),
                          dtype=torch.int32, device=dev)
    toks = torch.as_tensor(rng.integers(3, cfg.vocab_size, (1, t)),
                           dtype=torch.int32, device=dev)
    lens = torch.tensor([8], dtype=torch.int32, device=dev)
    with torch.inference_mode():
        caches = []
        for _ in range(2):
            c = eng.model.init_caches(cfg, 1, 128, dev, eng.kv_scales)
            eng.model.forward_prefill(eng.params, cfg, ids, lens, c,
                                      rope=eng.rope)
            caches.append(c)
        slab, _ = eng.model.forward_extend(eng.params, cfg, toks, lens,
                                           caches[0], rope=eng.rope)
        steps, pos = [], lens.clone()
        for i in range(t):
            lg, _ = eng.model.forward_decode(eng.params, cfg, toks[:, i], pos,
                                             caches[1], rope=eng.rope)
            steps.append(lg)
            pos += 1
        steps = torch.stack(steps, 1)
    print(f"  forward_extend of {t} tokens after an 8-token prefill vs {t} "
          f"forward_decode steps ({cfg.num_layers} layers, the serving "
          "weights):")
    err = compare(f"extend logits [1, {t}, {cfg.vocab_size}]", slab, steps,
                  errors, tol=LOGITS_TOL)
    for kv in ("k", "v"):
        compare(f"extend {kv.upper()} rows 8-{7 + t} written",
                getattr(caches[0], kv)[:, :, :, 8:8 + t],
                getattr(caches[1], kv)[:, :, :, 8:8 + t], errors,
                tol=LOGITS_TOL)
    same = bool((slab.argmax(-1) == steps.argmax(-1)).all())
    print(f"  extend and decode pick the same {t} tokens: {same}")
    results["_e2e"]["forward_extend vs decode"] = dict(
        layers=cfg.num_layers, tokens=t, logits_max_abs_err=err,
        same_argmax=same)


def run_serving(args, errors, results):
    """Each configuration serves the same 16 requests (64 new tokens each,
    greedy, no end token) on int8 weight-only LLaMA-7B (then the
    speculative engines, run_serving_spec); prints tokens/s,
    latency percentiles, phase times, the device busy share of one decode
    step (the configurations of SERVE_PROFILED), and checks the launch
    counts against the engine's own count of device calls; the chunked,
    mixed and pipelined runs' tokens against the dense run's; forward_extend
    at full width against decode steps."""
    import dataclasses
    import numpy as np
    import torch
    from trtllm_llama_tpu_torch import EngineConfig, ModelConfig, QuantMode
    from trtllm_llama_tpu_torch.models import llama
    from trtllm_llama_tpu_torch.ops.kernels import decode_attention as da
    from trtllm_llama_tpu_torch.ops.kernels import packed_prefill_attention as ppa
    from trtllm_llama_tpu_torch.ops.kernels import paged_decode_attention as pda
    from trtllm_llama_tpu_torch.ops.kernels import prefill_attention as pa
    from trtllm_llama_tpu_torch.ops.kernels import woq_matmul as woq
    from trtllm_llama_tpu_torch.quantization.quantize import (
        init_random_quantized_params,
    )
    from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
    from trtllm_llama_tpu_torch.runtime.serving import ServingEngine

    mode = QuantMode.use_weight_only()
    cfg = ModelConfig.llama_7b(quant_mode=mode, num_layers=args.layers)
    n_l = cfg.num_layers
    params = init_random_quantized_params(cfg, seed=0, device="cuda")
    lens = serve_prompt_lens()
    rng = np.random.default_rng(1)
    prompts = [rng.integers(3, cfg.vocab_size, n).tolist() for n in lens]
    n_tokens = SERVE_REQUESTS * SERVE_NEW
    print(f"serving: LLaMA-7B widths, {n_l} layers, int8 weight-only, random "
          f"weights (seed 0); {SERVE_REQUESTS} requests x {SERVE_NEW} new "
          f"tokens, prompts of {min(lens)}-{max(lens)} tokens (seed 0, "
          f"{sum(lens)} in all), greedy, end_id -1, decode_chunk "
          f"{SERVE_CHUNK}, {SERVE_ENGINE}")
    outs, gaps, phases_of = {}, {}, {}
    kv_flags = {"int8": QuantMode.INT8_KV_CACHE,
                "e4m3": QuantMode.FP8_KV_CACHE}
    for name, opts, kv in SERVE_CONFIGS:
        c = (dataclasses.replace(cfg, quant_mode=mode | kv_flags[kv])
             if kv else cfg)
        model = ExtendRecorder(llama) if name == CHUNKED else None
        eng = ServingEngine(
            c, params, EngineConfig(**SERVE_ENGINE),
            sampling=SamplingConfig(end_id=-1),
            kv_scales=[KV_SCALE] * n_l if kv else None,
            decode_chunk=SERVE_CHUNK, device="cuda", model=model, **opts)
        for p in prompts[:SERVE_WARMUP]:  # warm-up (cuBLAS, allocator)
            eng.submit(p, 4)
        eng.run_to_completion()
        decode = DECODE_KEYS[kv][3 if eng.paged else 0]
        prefill = ("packed_prefill_attention_kernel" if eng.packed
                   else "prefill_attention_kernel")
        wrappers = {"woq_matmul_stacked": woq.woq_matmul_stacked,
                    TC_INT8: woq.woq_matmul_stacked,
                    GEMM_INT8: woq.woq_matmul_stacked,
                    decode: (pda.paged_decode_attention if eng.paged
                             else da.dma_decode_attention),
                    prefill: (ppa.packed_prefill_attention_kernel
                              if eng.packed else pa.prefill_attention_kernel)}
        eng.phase_times = dict.fromkeys(eng.phase_times, 0.0)
        eng.phase_times["steps"] = 0
        eng.calls = dict.fromkeys(eng.calls, 0)
        eng.chunk_rows = []
        eng._req_times.clear()
        if model is not None:
            model.calls.clear()
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cfgs = (serving_sampling(outs["dense"]) if eng.per_request
                else [None] * SERVE_REQUESTS)
        rids = [eng.submit(p, SERVE_NEW, sampling=c)
                for p, c in zip(prompts, cfgs)]
        done = eng.run_to_completion()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: launches_of(k, fn) for k, fn in wrappers.items()}
        calls = dict(eng.calls, chunk_rows=list(eng.chunk_rows))
        prefills = calls["packed_prefills" if eng.packed else "prefills"]
        expect = serving_expect(eng, n_l, decode, prefill)
        print(f"  serving {name}: {n_tokens / wall:.1f} generated tokens/s "
              f"({n_tokens} tokens in {wall:.2f} s); device calls {calls}")
        print(f"  launches {launches}, expected {expect}: "
              f"{'ok' if launches == expect else 'FAIL'}")
        if launches != expect:
            errors.append(f"serving {name}: launches {launches} != {expect}")
        if name != CHUNKED and prefills != len(serve_waves()) - 1:
            errors.append(f"serving {name}: {prefills} prefill calls, not the "
                          "admission waves whose shapes the kernels were "
                          "checked at")
        for k, n in launches.items():
            results[k]["launches"] = results[k].get("launches", 0) + n
        stats, phases = eng.latency_stats(), eng.phase_stats()
        phases_of[name] = phases
        print(f"  latency_stats {json.dumps(stats)}")
        print(f"  phase_stats (ms per engine step) {json.dumps(phases)}")
        bad = [r for r in rids if r not in done
               or len(done[r].output_ids) != SERVE_NEW
               or done[r].finished_reason != "length"]
        tok_s = n_tokens / wall
        results["_e2e"][f"serving {name}"] = dict(
            layers=n_l, tokens_per_s=tok_s, wall_s=wall,
            latency=stats, phases=phases, calls=calls)
        if eng.per_request:
            n_gen = sum(len(done[r].output_ids) for r in rids if r in done)
            tok_s = n_gen / wall
            results["_e2e"][f"serving {name}"]["tokens_per_s"] = tok_s
            print(f"  serving {name}: {tok_s:.1f} generated tokens/s "
                  f"({n_gen} tokens: the stop request ends early)")
            bad = [r for r in rids if r not in done]
            if not bad:
                check_serving_sampling(eng, prompts, done, rids, cfgs,
                                       outs["dense"], errors)
        if bad:
            errors.append(f"serving {name}: requests {bad} did not return "
                          f"{SERVE_NEW} tokens")
        outs[name] = [list(done[r].output_ids) if r in done else []
                      for r in rids]
        if eng.packed:
            gaps = check_packed_vs_batched(eng, prompts, errors)
        if name == "dense":
            check_extend_vs_decode(eng, errors, results)
        if name == CHUNKED:
            check_chunked(eng, prompts, outs[name], outs["dense"], errors,
                          results)
        if name in (MIXED, PIPELINED, PAGED_PIPELINED):
            check_same_tokens(name, eng, prompts, outs[name], outs["dense"],
                              errors)
        if name == PAGED_PIPELINED:
            serve_edge_request(eng, errors, results)
        if name in SERVE_PROFILED:
            results["_e2e"][f"serving {name}"].update(profile_serving_step(
                eng, prompts, gemv_side_by_side=name == "dense"))
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    run_serving_spec(cfg, params, prompts, outs["dense"], errors, results)
    read = {n: phases_of[n]["readback"] for n in ("dense", "paged", PIPELINED,
                                                  PAGED_PIPELINED)}
    print(f"  readback ms per engine step (phase_stats): {json.dumps(read)}")
    firsts = {name: [o[0] if o else None for o in out]
              for name, out in outs.items()}
    same_first = firsts["dense"] == firsts["paged"]
    print(f"  first tokens identical, dense vs paged: {same_first}")
    if not same_first:
        errors.append("serving: dense and paged first tokens differ")
    for name in ("paged", "packed", "paged int8 KV", "paged fp8 KV"):
        diffs = [first_difference_at(x, y)
                 for x, y in zip(outs["dense"], outs[name])]
        n_same = sum(d is None for d in diffs)
        print(f"  {name} vs dense: {n_same} of {SERVE_REQUESTS} requests "
              f"token for token; first differing positions of the others: "
              f"{[d for d in diffs if d is not None]}")
        if name == "packed":
            print("  packed vs dense, requests whose first token differs: "
                  "top-2 gap of the batched prefill's logits: "
                  + json.dumps({r: gaps[r] for r, d in enumerate(diffs)
                                if d == 0}))


def check_packed_vs_batched(eng, prompts, errors):
    """The counted run's admission waves prefilled on the card both ways,
    with the engine's weights: batched at the 128-token bucket
    (forward_prefill, as dense admission does) and packed (the engine's own
    pack_prompts and forward_prefill_packed, as packed admission does).
    Holds the logits and every prompt row of the K/V written within
    LOGITS_TOL of the largest value. Returns each request's top-2 gap of
    the batched logits and prints it where the two argmaxes differ."""
    import torch
    from trtllm_llama_tpu_torch.models import llama
    from trtllm_llama_tpu_torch.ops.attention import PackedMeta
    from trtllm_llama_tpu_torch.runtime.serving import pack_prompts

    cfg, dev, scales = eng.cfg, eng.device, eng.kv_scales
    bucket = max(SERVE_ENGINE["prefill_buckets"])
    slots = SERVE_ENGINE["max_batch_size"]
    print(f"  packed vs batched prefill of each wave ({cfg.num_layers} "
          "layers, the engine's weights, on the card):")
    gaps, off = {}, 0
    for w, lens in enumerate(serve_waves()[1:], 1):
        wave, b = prompts[off:off + len(lens)], len(lens)
        tb = packed_len(sum(lens))
        with torch.inference_mode():
            ids = torch.full((b, bucket), eng.scfg.pad_id, dtype=torch.int32,
                             device=dev)
            for i, p in enumerate(wave):
                ids[i, :len(p)] = torch.as_tensor(p, device=dev)
            batched = llama.init_caches(cfg, b, bucket, dev, scales)
            ref, _ = llama.forward_prefill(
                eng.params, cfg, ids, torch.as_tensor(lens, dtype=torch.int32,
                                                      device=dev),
                batched, rope=eng.rope)
            tok, meta, last = pack_prompts(wave, range(b), tb, slots, slots)
            packed = llama.init_caches(cfg, slots + 1, bucket, dev, scales)
            got, _ = llama.forward_prefill_packed(
                eng.params, cfg, torch.as_tensor(tok, device=dev),
                PackedMeta(*torch.as_tensor(meta, device=dev)),
                torch.as_tensor(last, device=dev), packed, rope=eng.rope)
            got = got[:b]
            compare(f"wave {w} (T={tb}, {sum(lens)} prompt rows) logits",
                    got, ref, errors, tol=LOGITS_TOL)
            for kv in ("k", "v"):
                a, r = getattr(packed, kv), getattr(batched, kv)
                compare(f"wave {w} {kv.upper()} rows written", torch.cat(
                    [a[:, i, :, :n] for i, n in enumerate(lens)], 2),
                    torch.cat([r[:, i, :, :n] for i, n in enumerate(lens)],
                              2), errors, tol=LOGITS_TOL)
            top2 = ref.topk(2, dim=-1).values
            gap = (top2[:, 0] - top2[:, 1]).tolist()
            flips = (got.argmax(-1) != ref.argmax(-1)).tolist()
        for i in range(b):
            gaps[off + i] = round(gap[i], 5)
        print(f"  wave {w}: argmax differs for {sum(flips)} of {b} prompts; "
              f"their batched top-2 gaps "
              f"{[gaps[off + i] for i in range(b) if flips[i]]}, the "
              f"smallest gap of the wave {min(gap):.5f}")
        off += b
        del batched, packed
    return gaps


def profile_serving_step(eng, prompts, gemv_side_by_side=False):
    """Admits 8 requests (the admission step: one batched or packed prefill
    of the 8 prompts, then a decode chunk; unprofiled, for the smoke's
    time budget), times the next, decode-only step (one chunk of decode_chunk steps) on the host clock and
    profiles the one after it: device time by kernel and the device's busy
    share of the unprofiled decode step; with gemv_side_by_side, profiles
    one more decode step with kernel 1 forced onto its one-row GEMV (its
    other body at 9 rows). Drains the engine afterwards."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def profiled_step():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.step()
            torch.cuda.synchronize()
        events = prof.key_averages()
        dev_ms = sum(e.self_device_time_total for e in events
                     if e.device_type == DeviceType.CUDA) / 1e3
        return dev_ms, events

    for p in prompts[:SERVE_ENGINE["max_batch_size"]]:
        eng.submit(p, SERVE_NEW)
    eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    dev_ms, events = profiled_step()
    extra = {}
    if gemv_side_by_side:
        with tc_route_forced(False):
            extra["step_device_ms_one_row_gemv"], _ = profiled_step()
        print(f"  the next decode step with kernel 1 on the one-row GEMV: "
              f"device busy {extra['step_device_ms_one_row_gemv']:.2f} ms "
              f"(the tensor-core GEMV's step: {dev_ms:.2f} ms)")
    eng.run_to_completion()
    print(f"  profile of one decode step ({SERVE_CHUNK} tokens x 9 rows): "
          f"device busy {dev_ms:.2f} ms of the {step_ms:.2f} ms unprofiled "
          f"step: {100 * dev_ms / step_ms:.1f}% busy, "
          f"{100 - 100 * dev_ms / step_ms:.1f}% idle")
    print(events.table(sort_by="self_device_time_total", row_limit=12,
                       max_name_column_width=60))
    return dict(step_ms=step_ms,
                step_device_ms=dev_ms, step_busy_share=dev_ms / step_ms,
                **extra)


# ---------------------------------------------------------------------------
# rows 10 and 12 with ALiBi slopes, row 9 at large GQA groups, float16
# ---------------------------------------------------------------------------

def _alibi_mask(slopes, s, lens, dtype):
    """The float attn_mask of the SDPA yardstick: slope * key column where
    the reference keeps a score, NEG_INF where it masks (causal, length)."""
    import torch
    cols = torch.arange(s, device="cuda")
    keep = ((cols[None, :] <= cols[:, None])[None]
            & (cols[None, None, :] < lens[:, None, None]))[:, None]
    bias = slopes.reshape(1, -1, 1, 1) * cols.float()
    return torch.where(keep, bias, torch.full_like(bias, -1e9)).to(dtype)


def check_alibi_prefill(errors, results):
    """Rows 10 and 12 with Bloom's slopes (32 heads of 128, bf16) at the
    shapes path 6 and serving give them: row 10 at B=1 S=16 len 8, at
    the first serving wave (8 x 128) and at S=150 with lengths 150 / 77 / 0
    (the -inf padding columns), row 12 at one 3072-row prompt; each
    against its plain version with the same slopes, timed with and without
    slopes beside the bound (operations) and SDPA with a float attn_mask
    holding the bias and the causal and length mask."""
    import torch
    import torch.nn.functional as F
    from trtllm_llama_tpu_torch.ops.attention import alibi_slopes
    from trtllm_llama_tpu_torch.ops.kernels import prefill_attention as pa
    from trtllm_llama_tpu_torch.ops.kernels import (
        streaming_prefill_attention as spa,
    )

    print("kernels prefill_attention_kernel and "
          "streaming_prefill_attention_kernel with ALiBi slopes (bf16):")
    g = torch.Generator(device="cuda").manual_seed(16)
    d, hq = 128, 32
    slopes = alibi_slopes(hq, device="cuda")
    wave = serve_waves()[1]
    cases = [  # (JSON name, kernel module, attribute, B, S, lens)
        (ALIBI_PREFILL, pa, "prefill_attention_kernel", 1, 16, [8]),
        (ALIBI_PREFILL, pa, "prefill_attention_kernel", len(wave),
         max(SERVE_ENGINE["prefill_buckets"]), wave),
        # S off the 64-row tile, a length of 0 (-inf padding columns)
        (ALIBI_PREFILL, pa, "prefill_attention_kernel", 3, 150, [150, 77, 0]),
        (ALIBI_STREAMING, spa, "streaming_prefill_attention_kernel", 1,
         BLOOM_LONG, [BLOOM_LONG]),
    ]
    errs = {}
    for key, mod, attr, b, s, lens in cases:
        fn, plain = getattr(mod, attr), getattr(mod, attr + "_plain")
        q, k, v = (torch.randn((b, s, hq, d), generator=g, device="cuda"
                               ).to(torch.bfloat16) for _ in range(3))
        sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        got = fn(q, k, v, sl, alibi=slopes)
        ref = plain(q, k, v, sl, alibi=slopes)
        torch.cuda.synchronize()
        name = f"{attr} B={b} S={s} Hq=Hkv={hq} lens={lens}"
        errs[key] = max(errs.get(key, 0.0), compare(name, got, ref, errors))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = _alibi_mask(slopes, s, sl, torch.bfloat16)
        long = s == BLOOM_LONG
        t_k = time_ms(lambda i: fn(q, k, v, sl, alibi=slopes))
        t_n = time_ms(lambda i: fn(q, k, v, sl))
        t_p = time_ms(lambda i: plain(q, k, v, sl, alibi=slopes),
                      **(dict(iters=2, warmup=1, reps=1) if long else {}))
        t_l = time_ms(lambda i: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask))
        b_ms, b_by = bound_ms(*prefill_attention_work(lens, s, hq, hq, d,
                                                      alibi=True))
        print(f"  time {name}: kernel {t_k:.4f} ms with slopes, {t_n:.4f} "
              f"ms without; plain {t_p:.4f} ms, library(sdpa, float mask: "
              f"bias + causal + length) {t_l:.4f} ms, bound {b_ms:.5f} ms "
              f"({b_by})")
        entry = dict(ms=t_k, ms_without_slopes=t_n, plain_ms=t_p,
                     library_ms=t_l, bound_ms=b_ms, bound_by=b_by,
                     shape=f"B={b} S={s} lens={lens} Hq=Hkv=32 D=128 bf16, "
                     "Bloom's slopes")
        if key == ALIBI_STREAMING:   # row 10's tile on the same inputs
            entry["row10_ms"] = time_ms(lambda i: pa.prefill_attention_kernel(
                q, k, v, sl, alibi=slopes))
            print(f"  row 10's tile on the same inputs: {entry['row10_ms']:.4f}"
                  " ms")
        if key not in results:
            results[key] = entry
        else:
            results[key].setdefault("more", []).append(entry)
        del qt, kt, vt, mask
    for key, err in errs.items():
        results[key]["max_abs_err"] = err


def fold_err(results, key, err):
    """Fold a further check's error into the JSON entry `key`."""
    results[key]["max_abs_err"] = max(results[key]["max_abs_err"], err)


def check_fused_groups(errors, results):
    """Rows 9 and 3 with one KV head for a whole group: Falcon-7B's 71
    heads of 64 (the families' 'fused' and 'auto' runs) and a group of 32
    heads of 128, bf16 cache, each against the plain version (the caches
    must equal the plain write); row 9 timed beside kernel 3, the bound
    (the live K/V bytes) and SDPA on the expanded K/V."""
    import torch
    import torch.nn.functional as F
    from trtllm_llama_tpu_torch.ops.kernels import decode_attention as da
    sms = da.sm_count(0)

    print("kernels fused_decode_attention and dma_decode_attention at large "
          "GQA groups (one KV head, bf16 cache):")
    g = torch.Generator(device="cuda").manual_seed(17)
    n_l, layer = 2, 1
    max_err = err_3 = 0.0
    for hq, d, s, p in ((71, 64, 128, 45), (71, 64, 2048, 1037),
                        (32, 128, 128, 45), (32, 128, 2048, 1037)):
        shape = (n_l, 1, 1, s, d)
        kc, vc = (torch.randn(shape, generator=g, device="cuda"
                              ).to(torch.bfloat16) for _ in range(2))
        q = torch.randn((1, hq, d), generator=g, device="cuda").to(
            torch.bfloat16)
        kn, vn = (torch.randn((1, 1, d), generator=g, device="cuda").to(
            torch.bfloat16) for _ in range(2))
        pt = torch.tensor([p], dtype=torch.int32, device="cuda")
        kc2, vc2 = kc.clone(), vc.clone()
        kc3, vc3 = kc.clone(), vc.clone()
        ref = da.fused_decode_attention_plain(q, kn, vn, kc2, vc2, layer, pt)
        got = da.fused_decode_attention(q, kn, vn, kc, vc, layer, pt)
        got_3 = da.dma_decode_attention(q, kn, vn, kc3, vc3, layer, pt)
        torch.cuda.synchronize()
        name = f"group {hq} D={d} S_max={s} pos={p}"
        max_err = max(max_err, compare(f"row 9 {name}", got, ref, errors))
        err_3 = max(err_3, compare(f"kernel 3 {name}", got_3, ref, errors))
        for which, k_, v_ in (("row 9", kc, vc), ("kernel 3", kc3, vc3)):
            if not (torch.equal(k_, kc2) and torch.equal(v_, vc2)):
                errors.append(f"{which} {name}: cache differs from the "
                              "plain write")
        del kc3, vc3
        t_k = time_ms(lambda i: da.fused_decode_attention(
            q, kn, vn, kc, vc, layer, pt))
        t_3 = time_ms(lambda i: da.dma_decode_attention(
            q, kn, vn, kc, vc, layer, pt))
        t_p = time_ms(lambda i: da.fused_decode_attention_plain(
            q, kn, vn, kc2, vc2, layer, pt))
        kl = kc[layer, :, :, :p + 1].expand(1, hq, p + 1, d)
        vl = vc[layer, :, :, :p + 1].expand(1, hq, p + 1, d)
        t_l = time_ms(lambda i: F.scaled_dot_product_attention(
            q[:, :, None], kl, vl))
        b_ms, b_by = bound_ms(*decode_work([p + 1], hq, 1, d, None, True))
        print(f"  time {name}: kernel {t_k:.4f} ms (kernel 3 {t_3:.4f} ms), "
              f"plain {t_p:.4f} ms, library(sdpa on expanded K/V, no write)"
              f" {t_l:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
        entry = dict(ms=t_k, kernel3_ms=t_3, plain_ms=t_p, library_ms=t_l,
                     bound_ms=b_ms, bound_by=b_by,
                     shape=f"B=1 Hq={hq} Hkv=1 D={d} S_max={s} pos={p} bf16")
        if FUSED_G71 not in results:
            results[FUSED_G71] = entry
        else:
            results[FUSED_G71].setdefault("more", []).append(entry)
    # the split edges at one KV head: 2048 rows split over the card
    for hq, d in ((71, 64), (32, 128)):
        edge = da.decode_split(4, 1, 2048, hq, sms)[1] * da.TILE
        shape = (n_l, 4, 1, 2048, d)
        kc, vc = (torch.randn(shape, generator=g, device="cuda"
                              ).to(torch.bfloat16) for _ in range(2))
        q = torch.randn((4, hq, d), generator=g, device="cuda").to(
            torch.bfloat16)
        kn, vn = (torch.randn((4, 1, d), generator=g, device="cuda").to(
            torch.bfloat16) for _ in range(2))
        pt = torch.tensor([edge - 1, edge, 2047, 2051], dtype=torch.int32,
                          device="cuda")
        kc2, vc2 = kc.clone(), vc.clone()
        kc3, vc3 = kc.clone(), vc.clone()
        ref = da.fused_decode_attention_plain(q, kn, vn, kc2, vc2, layer, pt)
        got = da.fused_decode_attention(q, kn, vn, kc, vc, layer, pt)
        got_3 = da.dma_decode_attention(q, kn, vn, kc3, vc3, layer, pt)
        torch.cuda.synchronize()
        name = f"group {hq} D={d} B=4 S_max=2048 pos={pt.tolist()}"
        max_err = max(max_err, compare(f"row 9 {name}", got, ref, errors))
        err_3 = max(err_3, compare(f"kernel 3 {name}", got_3, ref, errors))
        for which, k_, v_ in (("row 9", kc, vc), ("kernel 3", kc3, vc3)):
            if not (torch.equal(k_, kc2) and torch.equal(v_, vc2)):
                errors.append(f"{which} {name}: cache differs from the "
                              "plain write")
        del kc, vc, kc2, vc2, kc3, vc3
    results[FUSED_G71]["max_abs_err"] = max_err
    fold_err(results, "dma_decode_attention", err_3)


# (tag, Hq, Hkv, D): GQA groups 1 (LLaMA-7B), 32 and 71 (Falcon-7B) on
# one KV head
DECODE_GROUPS = [("group 1", 32, 32, 128), ("group 32", 32, 1, 128),
                 ("group 71", 71, 1, 64)]
# (S_max, pos): paths 1-4, Task A, the families' long prompts, path 5
DECODE_LENGTHS = [(128, 45), (1152, TASK_A_PROMPT), (2048, 1037),
                  (LONG_S_MAX, 8200)]


def check_decode_table(errors, results):
    """Kernel 3 and row 9 (one body) timed side by side at S_max 128 /
    1152 / 2048 / 8320 and GQA groups 1 / 32 / 71, bf16, int8 and e4m3
    caches (one call: the three kinds' times comparable), each beside its
    byte bound (the live K/V, q, the new row, out) and SDPA over the live
    rows (bf16, a quantized cache dequantized beforehand, K/V expanded to
    the group; no write). The rows go into the `more` lists of the JSON
    entries of kernel 3 and row 9."""
    import torch
    import torch.nn.functional as F
    from trtllm_llama_tpu_torch.ops.kernels import decode_attention as da
    sms = da.sm_count(0)

    print("kernels dma_decode_attention (kernel 3) and fused_decode_attention "
          "(row 9) side by side:")
    g = torch.Generator(device="cuda").manual_seed(21)
    n_l, layer = 2, 1
    table = []
    for tag, hq, hkv, d in DECODE_GROUPS:
        for s, p in DECODE_LENGTHS:
            for kv in (None, "int8", "e4m3"):
                shape = (n_l, 1, hkv, s, d)
                kc, vc = kv_cache(shape, kv, g), kv_cache(shape, kv, g)
                kvs = (torch.full((n_l,), KV_SCALE, device="cuda") if kv
                       else None)
                q = torch.randn((1, hq, d), generator=g, device="cuda").to(
                    torch.bfloat16)
                kn, vn = (torch.randn((1, hkv, d), generator=g,
                                      device="cuda").to(torch.bfloat16)
                          for _ in range(2))
                pt = torch.tensor([p], dtype=torch.int32, device="cuda")
                t_3 = time_ms(lambda i: da.dma_decode_attention(
                    q, kn, vn, kc, vc, layer, pt, kv_scale=kvs))
                t_9 = time_ms(lambda i: da.fused_decode_attention(
                    q, kn, vn, kc, vc, layer, pt, kv_scale=kvs))
                kl = kv_bf16(kc[layer, :, :, :p + 1], kv)
                vl = kv_bf16(vc[layer, :, :, :p + 1], kv)
                kl = kl.expand(1, hq, p + 1, d) if hkv == 1 else kl
                vl = vl.expand(1, hq, p + 1, d) if hkv == 1 else vl
                t_l = time_ms(lambda i: F.scaled_dot_product_attention(
                    q[:, :, None], kl, vl))
                b_ms, b_by = bound_ms(*decode_work([p + 1], hq, hkv, d, kv,
                                                   True))
                label = kv or "bf16"
                shape_s = (f"B=1 Hq={hq} Hkv={hkv} D={d} S_max={s} pos={p} "
                           f"bf16 q, {label} cache")
                print(f"  {tag} S_max={s} pos={p} {label}: kernel 3 "
                      f"{t_3:.4f} ms, row 9 {t_9:.4f} ms, sdpa {t_l:.4f} ms, "
                      f"bound {b_ms:.5f} ms ({b_by}), splits "
                      f"{da.decode_split(1, hkv, s, hq // hkv, sms)}")
                keys = DECODE_KEYS[kv]
                for key, t_k in ((keys[0], t_3), (keys[2], t_9)):
                    results[key].setdefault("more", []).append(dict(
                        ms=t_k, library_ms=t_l, bound_ms=b_ms, bound_by=b_by,
                        shape=shape_s))
                table.append(dict(group=tag, s_max=s, pos=p, cache=label,
                                  kernel3_ms=t_3, row9_ms=t_9, sdpa_ms=t_l,
                                  bound_ms=b_ms))
                del kc, vc, kl, vl
    results["_e2e"]["decode table"] = table


def check_family_attention(errors, results):
    """Kernel 2 (B=1 S=16 len 8, the families' prefill) and kernel 3
    (S_max 128, positions 8 and 22, the first and last decode step of their
    16-token runs) at each decoder family's head shape, bf16, against the
    plain versions (kernel 3's caches must equal the plain write); timed
    at GPT-J's and GPT-NeoX's head dims (256, 96), which no LLaMA path
    reaches, beside the bound and SDPA."""
    import torch
    import torch.nn.functional as F
    from trtllm_llama_tpu_torch.ops.kernels import decode_attention as da
    from trtllm_llama_tpu_torch.ops.kernels import prefill_attention as pa

    print("kernels prefill_attention_kernel and dma_decode_attention at the "
          "decoder families' head shapes (bf16):")
    g = torch.Generator(device="cuda").manual_seed(20)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    err_2 = err_3 = 0.0
    for tag, over, _ in FAMILY_CONFIGS:
        hq, hkv, d = over["num_heads"], over["num_kv_heads"], over["head_dim"]
        timed = d not in (64, 128)
        q, k, v = rnd(1, 16, hq, d), rnd(1, 16, hkv, d), rnd(1, 16, hkv, d)
        sl = torch.tensor([8], dtype=torch.int32, device="cuda")
        name = f"{tag} Hq={hq} Hkv={hkv} D={d}"
        err_2 = max(err_2, compare(
            f"prefill B=1 S=16 len 8 {name}",
            pa.prefill_attention_kernel(q, k, v, sl),
            pa.prefill_attention_kernel_plain(q, k, v, sl), errors))
        if timed:
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            cols = torch.arange(16, device="cuda")
            mask = (cols[None, :] <= cols[:, None]) & (cols < 8)[None, :]
            t_k = time_ms(lambda i: pa.prefill_attention_kernel(q, k, v, sl))
            t_p = time_ms(lambda i: pa.prefill_attention_kernel_plain(
                q, k, v, sl))
            t_l = time_ms(lambda i: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask))
            b_ms, b_by = bound_ms(*prefill_attention_work([8], 16, hq, hkv,
                                                          d))
            print(f"  time prefill {name}: kernel {t_k:.4f} ms, plain "
                  f"{t_p:.4f} ms, library(sdpa, mask) {t_l:.4f} ms, bound "
                  f"{b_ms:.5f} ms ({b_by})")
            results["prefill_attention_kernel"].setdefault("more", []).append(
                dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                     bound_by=b_by, shape=f"B=1 S=16 len=8 Hq=Hkv={hq} "
                     f"D={d} bf16 ({tag})"))
        kc, vc = rnd(2, 1, hkv, 128, d), rnd(2, 1, hkv, 128, d)
        qd, kn, vn = rnd(1, hq, d), rnd(1, hkv, d), rnd(1, hkv, d)
        for p in (8, 8 + FAMILY_NEW - 2):
            pt = torch.tensor([p], dtype=torch.int32, device="cuda")
            kc2, vc2 = kc.clone(), vc.clone()
            got = da.dma_decode_attention(qd, kn, vn, kc, vc, 1, pt)
            ref = da.dma_decode_attention_plain(qd, kn, vn, kc2, vc2, 1, pt)
            torch.cuda.synchronize()
            err_3 = max(err_3, compare(f"decode S_max=128 pos={p} {name}",
                                       got, ref, errors))
            if not (torch.equal(kc, kc2) and torch.equal(vc, vc2)):
                errors.append(f"kernel 3 {name} pos={p}: cache differs from "
                              "the plain write")
        if timed:
            t_k = time_ms(lambda i: da.dma_decode_attention(
                qd, kn, vn, kc, vc, 1, pt))
            t_p = time_ms(lambda i: da.dma_decode_attention_plain(
                qd, kn, vn, kc2, vc2, 1, pt))
            kl, vl = kc[1, :, :, :p + 1], vc[1, :, :, :p + 1]
            t_l = time_ms(lambda i: F.scaled_dot_product_attention(
                qd[:, :, None], kl, vl))
            b_ms, b_by = bound_ms(*decode_work([p + 1], hq, hkv, d, None,
                                               True))
            print(f"  time decode {name} pos={p}: kernel {t_k:.4f} ms, plain "
                  f"{t_p:.4f} ms, library(sdpa, no write) {t_l:.4f} ms, "
                  f"bound {b_ms:.5f} ms ({b_by})")
            results["dma_decode_attention"].setdefault("more", []).append(
                dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                     bound_by=b_by, shape=f"B=1 Hq=Hkv={hq} D={d} S_max=128 "
                     f"pos={p} bf16 ({tag})"))
    fold_err(results, "prefill_attention_kernel", err_2)
    fold_err(results, "dma_decode_attention", err_3)


def check_draft_attention(errors, results):
    """Kernels 2 and 3 at the speculative draft's head shape (LLaMA-160M:
    12 heads of 64, bf16) and the calls its runs give them: the bs1
    prefill (B=1 S=16 len 8) and serving's first admission wave (B=8
    S=128 at the wave's lengths); kernel 3 at bs1 (S_max 128, positions 8
    and 61, the first and last draft step of an 8-token prompt and 50 new
    tokens) and over serving's 9 rows (S_max 256: max_seq_len + gamma + 1
    rounded, ragged positions up to max_seq_len + gamma); against the
    plain versions, kernel 3's caches against the plain write."""
    import torch
    from trtllm_llama_tpu_torch.ops.kernels import decode_attention as da
    from trtllm_llama_tpu_torch.ops.kernels import prefill_attention as pa

    hq = hkv = SPEC_DRAFT["num_heads"]
    d = SPEC_DRAFT["head_dim"]
    print(f"kernels prefill_attention_kernel and dma_decode_attention at the "
          f"speculative draft's head shape (Hq=Hkv={hq} D={d}, bf16):")
    g = torch.Generator(device="cuda").manual_seed(30)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    err_2 = err_3 = 0.0
    wave = serve_waves()[1]
    for b, s, lens in ((1, 16, [8]), (len(wave), 128, wave)):
        q, k, v = rnd(b, s, hq, d), rnd(b, s, hkv, d), rnd(b, s, hkv, d)
        sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        err_2 = max(err_2, compare(
            f"prefill B={b} S={s} lens {lens} draft",
            pa.prefill_attention_kernel(q, k, v, sl),
            pa.prefill_attention_kernel_plain(q, k, v, sl), errors))
    smax_serve = -(-(SERVE_ENGINE["max_seq_len"] + SPEC_GAMMA + 1)
                   // 128) * 128
    last = SERVE_ENGINE["max_seq_len"] + SPEC_GAMMA
    for b, smax, pos in ((1, 128, [8]), (1, 128, [8 + NEW_TOKENS + 3]),
                         (SERVE_ENGINE["max_batch_size"] + 1, smax_serve,
                          [0, 8, 60, 127, 128, 150, 199, last, 3])):
        kc, vc = rnd(2, b, hkv, smax, d), rnd(2, b, hkv, smax, d)
        qd, kn, vn = rnd(b, hq, d), rnd(b, hkv, d), rnd(b, hkv, d)
        pt = torch.tensor(pos, dtype=torch.int32, device="cuda")
        kc2, vc2 = kc.clone(), vc.clone()
        got = da.dma_decode_attention(qd, kn, vn, kc, vc, 1, pt)
        ref = da.dma_decode_attention_plain(qd, kn, vn, kc2, vc2, 1, pt)
        torch.cuda.synchronize()
        err_3 = max(err_3, compare(f"decode B={b} S_max={smax} pos {pos} "
                                   "draft", got, ref, errors))
        if not (torch.equal(kc, kc2) and torch.equal(vc, vc2)):
            errors.append(f"kernel 3 draft B={b} pos {pos}: cache differs "
                          "from the plain write")
    fold_err(results, "prefill_attention_kernel", err_2)
    fold_err(results, "dma_decode_attention", err_3)


def check_float16(errors, results):
    """Each kernel's float16 instantiation at one shape against its plain
    version (the same tolerance as bf16: a rounding step at the final
    cast)."""
    import torch
    from trtllm_llama_tpu_torch.ops.attention import alibi_slopes
    from trtllm_llama_tpu_torch.ops.kernels import decode_attention as da
    from trtllm_llama_tpu_torch.ops.kernels import fp8_matmul as f8k
    from trtllm_llama_tpu_torch.ops.kernels import packed_prefill_attention as ppa
    from trtllm_llama_tpu_torch.ops.kernels import paged_decode_attention as pda
    from trtllm_llama_tpu_torch.ops.kernels import prefill_attention as pa
    from trtllm_llama_tpu_torch.ops.kernels import rmsnorm_quant as rnq
    from trtllm_llama_tpu_torch.ops.kernels import (
        streaming_prefill_attention as spa,
    )
    from trtllm_llama_tpu_torch.ops.kernels import woq_matmul as woq

    print("float16 instantiations (one shape each):")
    g = torch.Generator(device="cuda").manual_seed(18)
    h = torch.float16

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(h)

    x = rnd(4, 4096)
    for fmt in ("int8", "int4 g128"):
        w = make_gemv_weight(fmt, 2, 4096, 4096, g)
        compare(f"woq_matmul_stacked {fmt} M=4 4096->4096",
                woq.woq_matmul_stacked(x, w, 1),
                woq.woq_matmul_stacked_plain(x, w, 1), errors)
    w = make_gemv_weight("fp8", 2, 4096, 4096, g)
    compare("fp8_matmul_stacked M=4 4096->4096",
            f8k.fp8_matmul_stacked(x, w, 1),
            f8k.fp8_matmul_stacked_plain(x, w, 1), errors)
    nw = (1 + 0.1 * torch.randn(4096, generator=g, device="cuda")).to(h)
    got, ref = rnq.rmsnorm_quant(x, nw), rnq.rmsnorm_quant_plain(x, nw)
    codes_off = (got[0].int() - ref[0].int()).abs().max().item()
    print(f"  rmsnorm_quant M=4 D=4096: codes within {codes_off} step(s)")
    compare("rmsnorm_quant scales", got[1], ref[1], errors, tol=1e-6)
    if codes_off > 1:
        errors.append(f"rmsnorm_quant f16: codes {codes_off} steps apart")
    q, k, v = rnd(1, 16, 32, 128), rnd(1, 16, 32, 128), rnd(1, 16, 32, 128)
    sl = torch.tensor([8], dtype=torch.int32, device="cuda")
    slopes = alibi_slopes(32, device="cuda")
    compare("prefill_attention_kernel B=1 S=16 len 8, slopes",
            pa.prefill_attention_kernel(q, k, v, sl, alibi=slopes),
            pa.prefill_attention_kernel_plain(q, k, v, sl, alibi=slopes),
            errors)
    q, k, v = rnd(2, 2100, 32, 128), rnd(2, 2100, 8, 128), rnd(2, 2100, 8, 128)
    sl = torch.tensor([2100, 64], dtype=torch.int32, device="cuda")
    compare("streaming_prefill_attention_kernel B=2 S=2100 GQA, slopes",
            spa.streaming_prefill_attention_kernel(q, k, v, sl, alibi=slopes),
            spa.streaming_prefill_attention_kernel_plain(q, k, v, sl,
                                                         alibi=slopes),
            errors)
    t = 64
    q, k, v = rnd(t, 32, 128), rnd(t, 32, 128), rnd(t, 32, 128)
    seg = torch.tensor([0] * 20 + [1] * 30 + [2] + [-1] * 13,
                       dtype=torch.int32, device="cuda")
    real = seg >= 0
    compare("packed_prefill_attention_kernel T=64",
            ppa.packed_prefill_attention_kernel(q, k, v, seg)[real],
            ppa.packed_prefill_attention_kernel_plain(q, k, v, seg)[real],
            errors)
    kc, vc = rnd(2, 1, 32, 128, 128), rnd(2, 1, 32, 128, 128)
    q, kn, vn = rnd(1, 32, 128), rnd(1, 32, 128), rnd(1, 32, 128)
    pt = torch.tensor([45], dtype=torch.int32, device="cuda")
    for fn, plain in ((da.dma_decode_attention, da.dma_decode_attention_plain),
                      (da.fused_decode_attention,
                       da.fused_decode_attention_plain)):
        a, b = kc.clone(), vc.clone()
        got = fn(q, kn, vn, kc.clone(), vc.clone(), 1, pt)
        compare(f"{fn.__name__} S_max=128 pos=45", got,
                plain(q, kn, vn, a, b, 1, pt), errors)
    compare("decode_attention_kernel S_max=128 len 46",
            da.decode_attention_kernel(q, kc, vc, 1, pt + 1),
            da.decode_attention_kernel_plain(q, kc, vc, 1, pt + 1), errors)
    pk, pv = rnd(2, 9, 32, 16, 128), rnd(2, 9, 32, 16, 128)
    tables = torch.tensor([[3, 0, 5, 1]], dtype=torch.int32, device="cuda")
    a, b = pk.clone(), pv.clone()
    compare("paged_decode_attention BS=16 pos=45",
            pda.paged_decode_attention(q, kn, vn, pk, pv, 1, tables, pt),
            pda.paged_decode_attention_plain(q, kn, vn, a, b, 1, tables, pt),
            errors)


# ---------------------------------------------------------------------------
# path 6: Bloom-7b1 (ALiBi; bf16 and int8 weight-only), and the other decoder
# families at their published widths, depth 2
# ---------------------------------------------------------------------------

def _wrappers():
    """Every kernel wrapper of the port: name -> wrapper."""
    from trtllm_llama_tpu_torch.ops.kernels import decode_attention as da
    from trtllm_llama_tpu_torch.ops.kernels import fp8_matmul as f8k
    from trtllm_llama_tpu_torch.ops.kernels import packed_prefill_attention as ppa
    from trtllm_llama_tpu_torch.ops.kernels import paged_decode_attention as pda
    from trtllm_llama_tpu_torch.ops.kernels import prefill_attention as pa
    from trtllm_llama_tpu_torch.ops.kernels import probes as pr
    from trtllm_llama_tpu_torch.ops.kernels import rmsnorm_quant as rnq
    from trtllm_llama_tpu_torch.ops.kernels import (
        streaming_prefill_attention as spa,
    )
    from trtllm_llama_tpu_torch.ops.kernels import w8a8_matmul as w8a8
    from trtllm_llama_tpu_torch.ops.kernels import woq_matmul as woq
    return {fn.__name__: fn for fn in (
        woq.woq_matmul_stacked, woq.woq_matmul, f8k.fp8_matmul_stacked,
        f8k.fp8_matmul, w8a8.w8a8_matmul_stacked, w8a8.w8a8_matmul,
        rnq.rmsnorm_quant, pa.prefill_attention_kernel,
        spa.streaming_prefill_attention_kernel,
        ppa.packed_prefill_attention_kernel, da.dma_decode_attention,
        da.decode_attention_kernel, da.fused_decode_attention,
        pda.paged_decode_attention, pr.probe_bitcast_u32_bf16,
        pr.probe_u16_ops, pr.probe_u32_bf16_construct, pr.probe_gemv_decodes,
        pr.probe_tc_pairs, pr.probe_fp8_planes, pr.probe_kv_codec)}


def zero_counts():
    """Every wrapper's launches (and GEMM, tensor-core GEMV and SwiGLU
    launches) and the ALiBi decode branch's count set to 0."""
    from trtllm_llama_tpu_torch.ops import attention
    for fn in _wrappers().values():
        fn.launches = 0
        for extra in ("gemm_launches", "tc_launches", "swiglu_launches",
                      "window_launches", "ragged_launches"):
            if hasattr(fn, extra):
                setattr(fn, extra, 0)
    attention.fused_decode_attention_at.alibi_calls = 0


def read_counts():
    """(launches, ALiBi decode calls) since zero_counts; only the non-zero
    counts: each wrapper's launches, and "<wrapper>.gemm_launches" /
    "<wrapper>.tc_launches" for the GEMM's and the tensor-core GEMV's
    shares of kernels 1 and 6."""
    from trtllm_llama_tpu_torch.ops import attention
    counts = {}
    for k, f in _wrappers().items():
        for attr, name in (("launches", k),
                           ("gemm_launches", f"{k}.gemm_launches"),
                           ("tc_launches", f"{k}.tc_launches"),
                           ("window_launches", f"{k}.window_launches"),
                           ("ragged_launches", f"{k}.ragged_launches")):
            if getattr(f, attr, 0):
                counts[name] = getattr(f, attr)
    return counts, attention.fused_decode_attention_at.alibi_calls


@contextlib.contextmanager
def plain_path(pairs):
    """Each (module, wrapper name) replaced by its plain version, behind a
    stand-in with the wrapper's launch counter."""
    with contextlib.ExitStack() as stack:
        for mod, attr in pairs:
            def stand_in(*a, _plain=getattr(mod, attr + "_plain"), **kw):
                return _plain(*a, **kw)
            stand_in.launches = 0
            stack.enter_context(patched(mod, attr, stand_in))
        yield


def attention_pairs():
    from trtllm_llama_tpu_torch.ops.kernels import decode_attention as da
    from trtllm_llama_tpu_torch.ops.kernels import prefill_attention as pa
    from trtllm_llama_tpu_torch.ops.kernels import (
        streaming_prefill_attention as spa,
    )
    return [(pa, "prefill_attention_kernel"),
            (spa, "streaming_prefill_attention_kernel"),
            (da, "dma_decode_attention"), (da, "fused_decode_attention"),
            (da, "decode_attention_kernel")]


def first_logits(model, sess, ids, pairs):
    """The prefill logits of one prompt (ids [1, n]) at the session's
    bucket, with the kernels and with `pairs` on their plain versions."""
    import torch
    cfg, n = sess.cfg, ids.shape[1]
    bucket = sess.engine_cfg.bucket_for(n)
    with torch.inference_mode():
        t = torch.zeros((1, bucket), dtype=torch.int32, device="cuda")
        t[0, :n] = torch.as_tensor(ids[0], device="cuda")
        lens = torch.tensor([n], dtype=torch.int32, device="cuda")

        def prefill():
            caches = model.init_caches(cfg, 1, bucket, "cuda")
            return model.forward_prefill(sess.params, cfg, t, lens, caches,
                                         rope=sess.rope)[0]
        got = prefill()
        with plain_path(pairs):
            ref = prefill()
    return got, ref


def timed_generate(sess, ids, new):
    import torch
    from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = sess.generate(ids, sampling=SamplingConfig(end_id=-1),
                        max_new_tokens=new)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def check_tokens(tag, out, new, vocab, errors):
    ids = out.output_ids
    ok = (ids.shape == (1, new) and (ids >= 0).all() and (ids < vocab).all()
          and (out.lengths == new).all())
    print(f"  {tag} tokens {ids.shape}: {ids[0, :16].tolist()} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        errors.append(f"{tag}: bad output {ids.shape}")


def check_counts(tag, counts, expect, errors):
    launches, alibi = counts
    got = dict(launches=launches, alibi_decode=alibi)
    ok = got == expect
    print(f"  {tag} counts {got}, expected {expect}: {'ok' if ok else 'FAIL'}")
    if not ok:
        errors.append(f"{tag}: counts {got} != {expect}")


def bloom_request(tag, sess, ids, new, expect, errors, results, floor):
    """Warm-up, the prefill alone, then the counted request: prefill ms,
    decode ms/token, the launches; a profile of the same request gives the
    device ms/token and the idle share beside the byte floor."""
    from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
    timed_generate(sess, ids, 2)
    _, pre_ms = timed_generate(sess, ids, 1)
    zero_counts()
    out, ms = timed_generate(sess, ids, new)
    check_counts(tag, read_counts(), expect, errors)
    check_tokens(tag, out, new, sess.cfg.vocab_size, errors)
    dec_ms = (ms - pre_ms) / (new - 1)
    dev_dec, busy = profile_generate(sess, ids, SamplingConfig(end_id=-1),
                                     row_limit=10)
    print(f"  {tag}: prefill {pre_ms:.2f} ms, decode {dec_ms:.3f} ms/token "
          f"(wall), device {dev_dec:.3f} ms per decode token, byte floor "
          f"{floor:.3f} ms/token; {ms:.1f} ms end to end")
    results["_e2e"][tag] = dict(
        layers=sess.cfg.num_layers, prefill_ms=pre_ms,
        decode_ms_per_token=dec_ms, device_ms_per_decode_token=dev_dec,
        device_busy_share=busy, byte_floor_ms_per_token=floor,
        e2e_ms=ms)
    return out


def hf_family_params(tag, cfg, errors, results):
    """Family `tag` as an HF model built on the card in f32 (seed 0) with
    its published fields at cfg.num_layers, loaded through
    convert/hf_families.py: the loader's config against the smoke's
    (widths, heads, rotary, eps) and the f32 first-step logits of an
    8-token prompt against HF's own forward within HF_TOL (TF32 off).
    Returns the params in cfg.dtype."""
    import dataclasses

    import numpy as np
    import torch
    import transformers
    from trtllm_llama_tpu_torch import EngineConfig
    from trtllm_llama_tpu_torch.convert import hf_families
    from trtllm_llama_tpu_torch.models import by_architecture
    from trtllm_llama_tpu_torch.runtime.session import GenerationSession

    cfg_cls, model_cls, suffix, fields = HF_FAMILIES[tag]
    hf_cfg = getattr(transformers, cfg_cls)(
        **fields, **{HF_LAYER_FIELD[cfg_cls]: cfg.num_layers})
    t0 = time.perf_counter()
    torch.manual_seed(0)
    with torch.device("cuda"):
        hf = getattr(transformers, model_cls)(hf_cfg).eval()
    conv_cfg = getattr(hf_families, f"config_from_hf_{suffix}")(
        hf_cfg, dtype="float32")
    keys = ("vocab_size", "hidden_size", "intermediate_size", "num_layers",
            "num_heads", "num_kv_heads", "head_dim", "rotary_dim",
            "rms_norm_eps")
    def field(c, k):    # a rotary_dim of 0 rotates the whole head
        return (c.rotary_dim or c.head_dim if k == "rotary_dim"
                and (c.rotary_dim or cfg.architecture in ROTARY_FAMILIES)
                else getattr(c, k))
    differ = {k: (field(conv_cfg, k), field(cfg, k)) for k in keys
              if field(conv_cfg, k) != field(cfg, k)}
    if differ:
        errors.append(f"{tag}: the loader's config differs {differ}")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = getattr(hf_families, f"params_from_hf_{suffix}")(hf, cfg32)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ids = np.random.default_rng(0).integers(3, cfg.vocab_size, (1, 8))
    model = by_architecture(cfg.architecture)
    sess = GenerationSession(cfg32, p32, EngineConfig(
        max_batch_size=1, max_input_len=16, max_seq_len=64), device="cuda",
        model=model)
    got, _ = first_logits(model, sess, ids, [])
    with torch.inference_mode():
        ref = hf(torch.as_tensor(ids, device="cuda")).logits[0, -1].float()
    err = compare(f"{tag} ({cfg.num_layers} layers) f32 first-step logits vs "
                  f"HF's forward", got[0], ref, errors, tol=HF_TOL)
    print(f"  {tag}: HF model built on the card and loaded in {build_s:.1f} "
          f"s; the loader's config matches the published fields: "
          f"{not differ}")
    results["_e2e"][f"{tag} HF weights"] = dict(
        layers=cfg.num_layers, build_s=build_s, max_abs_err_vs_hf=err)
    params = getattr(hf_families, f"params_from_hf_{suffix}")(hf, cfg)
    del sess, hf, p32
    gc.collect()
    torch.cuda.empty_cache()
    return params


def run_bloom(args, errors, results):
    """Path 6: Bloom-7b1 at full width and depth through
    GenerationSession(model=decoder.BLOOM). 6a, bf16 weights: the 8-token
    prompt with 50 tokens (row 10 with slopes, once per layer), the
    3072-token prompt's prefill (row 12 with slopes); 6b, the same
    tree through quantize_params (int8 weight-only per channel): the
    8-token prompt (kernel 1 at Bloom's six projection shapes). Decode
    attention takes the JAX package's plain ALiBi branch (counted apart).
    First-step logits of each against the plain path on the card."""
    import numpy as np
    import torch
    from trtllm_llama_tpu_torch import EngineConfig, ModelConfig, QuantMode
    from trtllm_llama_tpu_torch.models.decoder import BLOOM
    from trtllm_llama_tpu_torch.ops.kernels import prefill_attention as pa
    from trtllm_llama_tpu_torch.ops.kernels import (
        streaming_prefill_attention as spa,
    )
    from trtllm_llama_tpu_torch.ops.kernels import woq_matmul as woq
    from trtllm_llama_tpu_torch.quantization.quantize import quantize_params
    from trtllm_llama_tpu_torch.runtime.session import GenerationSession

    hf_cfg = ModelConfig(**{**BLOOM_7B1, "num_layers": min(
        args.layers, BLOOM_HF_LAYERS)})
    print(f"path 6: Bloom-7b1 from an HF model at {hf_cfg.num_layers} "
          "layers (convert/hf_families.py), then at full depth with random "
          "weights (the budget)")
    hf_params = hf_family_params("Bloom-7b1", hf_cfg, errors, results)
    sess = GenerationSession(hf_cfg, hf_params, EngineConfig(
        max_batch_size=1, max_input_len=16, max_seq_len=64), device="cuda",
        model=BLOOM)
    ids = np.random.default_rng(0).integers(3, hf_cfg.vocab_size, (1, 8))
    timed_generate(sess, ids, 2)
    zero_counts()
    out, _ = timed_generate(sess, ids, FAMILY_NEW)
    check_counts(f"path 6 HF weights ({hf_cfg.num_layers} layers)",
                 read_counts(), dict(
                     launches={"prefill_attention_kernel": hf_cfg.num_layers},
                     alibi_decode=hf_cfg.num_layers * (FAMILY_NEW - 1)),
                 errors)
    credit(results, ALIBI_PREFILL, hf_cfg.num_layers)
    check_tokens("path 6 HF weights", out, FAMILY_NEW, hf_cfg.vocab_size,
                 errors)
    del sess, hf_params
    gc.collect()
    torch.cuda.empty_cache()

    cfg = ModelConfig(**{**BLOOM_7B1, "num_layers": min(
        args.layers, BLOOM_7B1["num_layers"])})
    n_l = cfg.num_layers
    print(f"path 6: Bloom-7b1 (bigscience/bloom-7b1 config.json), "
          f"{n_l} layers, ALiBi, bf16, random weights (seed 0), "
          f"{BLOOM_ENGINE}")
    t0 = time.perf_counter()
    params = BLOOM.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"  weights init: {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    rng = np.random.default_rng(0)
    short = rng.integers(3, cfg.vocab_size, (1, 8))
    long = rng.integers(3, cfg.vocab_size, (1, BLOOM_LONG))
    ecfg = EngineConfig(**BLOOM_ENGINE)
    proj = n_l * (4 * 4096 * 4096 + 2 * 4096 * 16384)
    head = cfg.vocab_size * cfg.hidden_size
    floors = {"bf16": (proj + head) * 2 / HBM_BYTES_PER_S * 1e3,
              "int8": (proj + 2 * head) / HBM_BYTES_PER_S * 1e3}
    print(f"  per-token weight bytes: bf16 {(proj + head) * 2 / 1e9:.2f} GB "
          f"({floors['bf16']:.2f} ms at 3.35 TB/s), int8 projections + bf16 "
          f"lm_head {(proj + 2 * head) / 1e9:.2f} GB ({floors['int8']:.2f} ms)")

    sess = GenerationSession(cfg, params, ecfg, device="cuda", model=BLOOM)
    attn_pairs = [(pa, "prefill_attention_kernel"),
                  (spa, "streaming_prefill_attention_kernel")]
    bloom_request("path 6a bf16 in8 out50", sess, short, NEW_TOKENS, dict(
        launches={"prefill_attention_kernel": n_l},
        alibi_decode=n_l * (NEW_TOKENS - 1)), errors, results, floors["bf16"])
    credit(results, ALIBI_PREFILL, n_l)
    # the long request is its prefill alone (one token: a decode over the
    # 3k cache is left out for the smoke's time budget)
    timed_generate(sess, long, 1)                      # warm-up
    zero_counts()
    out, pre_ms = timed_generate(sess, long, 1)
    check_counts(f"path 6a bf16 in{BLOOM_LONG} out1", read_counts(), dict(
        launches={"streaming_prefill_attention_kernel": n_l},
        alibi_decode=0), errors)
    results[ALIBI_STREAMING]["launches"] = n_l
    check_tokens(f"path 6a in{BLOOM_LONG}", out, 1, cfg.vocab_size, errors)
    print(f"  bs1 in{BLOOM_LONG} out1: prefill {pre_ms:.1f} ms")
    results["_e2e"][f"path 6a bf16 in{BLOOM_LONG}"] = dict(
        layers=n_l, prefill_ms=pre_ms)
    for what, ids in (("in8", short), (f"in{BLOOM_LONG}", long)):
        got, ref = first_logits(BLOOM, sess, ids, attn_pairs)
        compare(f"path 6a {what} first-step logits, kernels vs plain", got,
                ref, errors, tol=LOGITS_TOL)
    del sess
    gc.collect()

    q = quantize_params(params, QuantMode.use_weight_only())
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  path 6b: int8 weight-only per-channel (quantize_params), "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    g = torch.Generator(device="cuda").manual_seed(19)
    lw = q["layers"]
    for name in ("wq", "wk", "wv", "wo", "w_fc", "w_proj"):
        w = lw[name]
        for m in (1, 16):
            x = torch.randn((m, w.k_dim), generator=g, device="cuda").to(
                torch.bfloat16)
            compare(f"woq_matmul_stacked {name} M={m} {w.k_dim}->"
                    f"{w.qweight.shape[-1]}", woq.woq_matmul_stacked(x, w, 0),
                    woq.woq_matmul_stacked_plain(x, w, 0), errors)
    sess = GenerationSession(cfg, q, ecfg, device="cuda", model=BLOOM)
    del q
    # six projections a layer and forward: the 16-row prefill (8 tokens at
    # the 16-row bucket) on the tensor-core GEMV, the decode steps on the
    # body tc_route gives one row
    n_tc = 6 * n_l * (tc_rows(16) + (NEW_TOKENS - 1) * tc_rows(1))
    launches = {"woq_matmul_stacked": 6 * n_l * NEW_TOKENS,
                "prefill_attention_kernel": n_l}
    if n_tc:
        launches["woq_matmul_stacked.tc_launches"] = n_tc
    bloom_request("path 6b int8 in8 out50", sess, short, NEW_TOKENS, dict(
        launches=launches, alibi_decode=n_l * (NEW_TOKENS - 1)), errors,
        results, floors["int8"])
    results[ALIBI_PREFILL]["launches"] += n_l
    results["woq_matmul_stacked"]["launches"] = (
        results["woq_matmul_stacked"].get("launches", 0)
        + 6 * n_l * NEW_TOKENS - n_tc)
    results[TC_INT8]["launches"] = results[TC_INT8].get("launches", 0) + n_tc
    got, ref = first_logits(BLOOM, sess, short, attn_pairs
                            + [(woq, "woq_matmul_stacked")])
    compare("path 6b in8 first-step logits, kernels vs plain", got, ref,
            errors, tol=LOGITS_TOL)
    del sess


def run_families(args, errors, results):
    """GPT-J-6B, GPT-NeoX-20B, OPT-6.7b and Falcon-7B at their published
    widths, FAMILY_LAYERS layers, from HF models built on the card (seed 0)
    and loaded through convert/hf_families.py (hf_family_params: f32
    first-step logits against HF's forward), then in bf16: one 8-token
    prompt, FAMILY_NEW greedy tokens per decode mode (Falcon also 'fused',
    row 9 at its group of 71, its tokens identical to 'auto''s: the same
    body); the launches (kernel 2 once per layer, kernel 3 or row 9 once
    per layer and decode step, at every family's head dim), the first-step
    logits against the plain path."""
    from unittest import mock

    import numpy as np
    import torch
    from trtllm_llama_tpu_torch import EngineConfig, ModelConfig
    from trtllm_llama_tpu_torch.models import by_architecture
    from trtllm_llama_tpu_torch.ops.registry import KERNELS as knobs
    from trtllm_llama_tpu_torch.runtime.session import GenerationSession

    for tag, over, modes in FAMILY_CONFIGS:
        cfg = ModelConfig(**over, num_layers=min(args.layers, FAMILY_LAYERS),
                          dtype="bfloat16")
        n_l, model = cfg.num_layers, by_architecture(cfg.architecture)
        params = hf_family_params(tag, cfg, errors, results)
        ids = np.random.default_rng(0).integers(3, cfg.vocab_size, (1, 8))
        tokens = {}
        for mode in modes:
            with mock.patch.dict(knobs, decode_attn_mode=mode):
                sess = GenerationSession(cfg, params, EngineConfig(
                    max_batch_size=1, max_input_len=16, max_seq_len=64),
                    device="cuda", model=model)
                timed_generate(sess, ids, 2)
                zero_counts()
                out, ms = timed_generate(sess, ids, FAMILY_NEW)
                launches, _ = read_counts()
                decode = {"auto": "dma_decode_attention",
                          "fused": "fused_decode_attention"}[mode]
                want = {"prefill_attention_kernel": n_l,
                        decode: n_l * (FAMILY_NEW - 1)}
                name = f"{tag} ({n_l} layers, '{mode}')"
                print(f"  {name}: head_dim {cfg.head_dim}, {ms:.1f} ms for "
                      f"{FAMILY_NEW} tokens; launches {launches} (expected "
                      f"{want})")
                if launches != want:
                    errors.append(f"{name}: launches {launches}, expected "
                                  f"{want}")
                if tag == "Falcon-7B" and mode == "fused":
                    results[FUSED_G71]["launches"] = launches.get(decode, 0)
                check_tokens(name, out, FAMILY_NEW, cfg.vocab_size, errors)
                tokens[mode] = np.asarray(out.output_ids)
                got, ref = first_logits(model, sess, ids, attention_pairs())
                compare(f"{name} first-step logits, kernels vs plain", got,
                        ref, errors, tol=LOGITS_TOL)
                ref_first = int(ref.argmax(-1)[0])
                print(f"  {name}: first token {int(out.output_ids[0, 0])}, "
                      f"plain path's argmax {ref_first}")
                results["_e2e"][name] = dict(
                    layers=n_l, head_dim=cfg.head_dim, wall_ms=ms,
                    launches=launches)
                del sess
        if len(tokens) > 1:   # row 9 runs kernel 3's body: the same tokens
            same = np.array_equal(tokens["fused"], tokens["auto"])
            print(f"  {tag}: 'fused' tokens identical to 'auto': {same}")
            if not same:
                errors.append(f"{tag}: 'fused' tokens differ from 'auto'")
        del params
        gc.collect()
        torch.cuda.empty_cache()


# Decoder families served through model= (published widths, FAMILY_LAYERS
# deep): with and without chunked prefill; prompts of 40 / 10 / 33 / 20
# tokens (the 40-, 33- and 20-token ones chunked)
FAMILY_SERVE = ("Bloom-7b1", "OPT-6.7b")
FAMILY_SERVE_ENGINE = dict(max_batch_size=4, max_input_len=64,
                           max_seq_len=128)
FAMILY_SERVE_CHUNK = 16
FAMILY_SERVE_PROMPTS = (40, 10, 33, 20)


def serve_families(args, errors, results):
    """Bloom-7b1 (ALiBi: its chunks' slab attention carries the bias) and
    OPT-6.7b (learned positions at +2 at per-row chunk starts) at their
    published widths, FAMILY_LAYERS deep, bf16 random weights (seed 0),
    served through ServingEngine(model=...) monolithic and with
    prefill_chunk=16: four requests of FAMILY_NEW tokens; the launches
    (row 10 once a layer and monolithic prefill, with slopes for Bloom;
    kernel 3 for OPT, the plain ALiBi decode for Bloom, once a layer and
    decode step); the chunked run's tokens equal the monolithic run's but
    at near ties (on a bs1 replay)."""
    import numpy as np
    import torch
    from trtllm_llama_tpu_torch import EngineConfig, ModelConfig
    from trtllm_llama_tpu_torch.models import by_architecture
    from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
    from trtllm_llama_tpu_torch.runtime.serving import ServingEngine

    fields = {"Bloom-7b1": BLOOM_7B1,
              **{tag: over for tag, over, _ in FAMILY_CONFIGS}}
    for tag in FAMILY_SERVE:
        cfg = ModelConfig(**{**fields[tag], "dtype": "bfloat16",
                             "num_layers": min(args.layers, FAMILY_LAYERS)})
        n_l, model = cfg.num_layers, by_architecture(cfg.architecture)
        params = model.init_params(cfg, seed=0, device="cuda")
        rng = np.random.default_rng(4)
        prompts = [rng.integers(3, cfg.vocab_size, n).tolist()
                   for n in FAMILY_SERVE_PROMPTS]
        alibi = cfg.architecture == "bloom"
        runs = {}
        for chunk in (None, FAMILY_SERVE_CHUNK):
            name = (f"serving {tag} ({n_l} layers, "
                    f"{'prefill_chunk ' + str(chunk) if chunk else 'monolithic'})")
            eng = ServingEngine(cfg, params,
                                EngineConfig(**FAMILY_SERVE_ENGINE),
                                sampling=SamplingConfig(end_id=-1),
                                decode_chunk=8, model=model,
                                prefill_chunk=chunk, device="cuda")
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rids = [eng.submit(p, FAMILY_NEW) for p in prompts]
            done = eng.run_to_completion()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            steps, prefills = eng.calls["decode_steps"], eng.calls["prefills"]
            launches = {k: v for k, v in {
                "prefill_attention_kernel": n_l * prefills,
                "dma_decode_attention": 0 if alibi else n_l * steps}.items()
                if v}
            check_counts(name, read_counts(),
                         dict(launches=launches,
                              alibi_decode=n_l * steps if alibi else 0),
                         errors)
            print(f"  {name}: {wall:.2f} s, device calls {eng.calls}, chunk "
                  f"rows {eng.chunk_rows}")
            outs = [list(done[r].output_ids) if r in done else []
                    for r in rids]
            if any(len(o) != FAMILY_NEW for o in outs):
                errors.append(f"{name}: a request did not return "
                              f"{FAMILY_NEW} tokens")
            pkey = ALIBI_PREFILL if alibi else "prefill_attention_kernel"
            results[pkey]["launches"] = (results[pkey].get("launches", 0)
                                         + n_l * prefills)
            if not alibi:
                results["dma_decode_attention"]["launches"] = (
                    results["dma_decode_attention"].get("launches", 0)
                    + n_l * steps)
            results["_e2e"][name] = dict(layers=n_l, wall_s=wall,
                                         calls=dict(eng.calls),
                                         chunk_rows=list(eng.chunk_rows))
            runs[chunk] = (eng, outs)
        eng, chunked = runs[FAMILY_SERVE_CHUNK]
        mono = runs[None][1]
        diffs = {i: first_difference_at(o, m)
                 for i, (o, m) in enumerate(zip(chunked, mono))}
        differ = {i: k for i, k in diffs.items() if k is not None}
        print(f"  {tag}: chunked vs monolithic: {len(prompts) - len(differ)} "
              f"of {len(prompts)} requests token for token; first differing "
              f"positions of the others: {differ}")
        for i, k in differ.items():
            near_tie(f"{tag} chunked request {i} token {k}",
                     serving_replay(eng, prompts[i], chunked[i][:k]),
                     chunked[i][k], mono[i][k], errors)
        del runs, eng, params
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Path 10: the quantization accuracy harness (quantization/evaluate.py)
# ---------------------------------------------------------------------------

# (a) golden scale: build_golden_setup's defaults (hidden 256, 4 layers, 8
# heads of 32, intermediate 512, vocab 512, f32). The JAX gates' own config
# (hidden 128, 8 heads) has head dim 16, below the 32-256 the attention
# kernels take, so on the card it raises.
ACC_PROMPTS = (2, 16)
ACC_CONT = 10
# card rows against CPU rows of the same mode: KL within 5% of the larger
# + 1e-6 nats, the ppl ratio within 2e-3, top-1 shares at most one position
# apart (both f32; quantized activations may round a code apart)
ACC_KL_REL, ACC_KL_ABS, ACC_PPL_ABS = 5e-2, 1e-6, 2e-3
# (b) LLaMA-7B width at ACC_7B_LAYERS layers (the smoke's budget):
# tests/test_accuracy_midscale.py's batch, prompt and continuation
ACC_7B = dict(hidden=4096, heads=32, intermediate=11008, vocab=32000)
ACC_7B_LAYERS = 4
ACC_7B_PROMPTS = (4, 48)
ACC_7B_CONT = 24
# (b)'s modes on structure_weights params (the midscale tier's, which runs
# them without calibrated ranges: KV scale 1): the int4 and fp8 weight
# formats, and int8 weight-only beside them for the int8-beats-int4 order
ACC_STRUCTURED = ("s-int8-wo", "int4-wo", "int4-wo-g", "fp8", "fp8+kv")


def accuracy_modes(group):
    """tests/test_accuracy_gates.py:34-52's ten modes: (name, QuantMode,
    group size; `group` for int4-wo-g)."""
    from trtllm_llama_tpu_torch import QuantMode
    return [
        ("int8-wo", QuantMode.use_weight_only(False), 0),
        ("int4-wo", QuantMode.use_weight_only(True), 0),
        ("int4-wo-g", QuantMode.use_weight_only(True, per_group=True), group),
        ("sq-static", QuantMode.use_smooth_quant(), 0),
        ("sq-ptpc", QuantMode.use_smooth_quant(per_token=True,
                                               per_channel=True), 0),
        ("int8-kv", QuantMode.INT8_KV_CACHE, 0),
        ("int8-wo+kv",
         QuantMode.use_weight_only(False) | QuantMode.INT8_KV_CACHE, 0),
        ("fp8", QuantMode.FP8_QDQ, 0),
        ("fp8-kv", QuantMode.FP8_KV_CACHE, 0),
        ("fp8+kv", QuantMode.FP8_QDQ | QuantMode.FP8_KV_CACHE, 0),
    ]


def accuracy_expect(mode, n_l, batch, prompt, cont, hidden):
    """Every wrapper's launches in one evaluate_quant_mode run (f32
    activations): one prefill of batch x prompt rows and `cont` decode
    steps of `batch` rows, 7 projections a layer and forward (q, k, v, o,
    gate, up, down; the lm_head stays f32). Weight-only and fp8 run the
    one-row GEMV at every row count (f32); W8A8 its GEMM from
    W8A8_GEMM_MIN_ROWS rows on; per-token SmoothQuant row 7 twice a layer
    and forward; row 10 once a layer, kernel 3 once a layer and step."""
    from trtllm_llama_tpu_torch.ops.kernels import w8a8_matmul as w8a8
    forwards = 1 + cont
    proj = 7 * n_l * forwards
    gemm = 7 * n_l * sum(n for rows, n in ((batch * prompt, 1),
                                           (batch, cont))
                         if w8a8.w8a8_gemm_route(rows, hidden, hidden))
    want = {"prefill_attention_kernel": n_l,
            "dma_decode_attention": n_l * cont}
    if mode.has_fp8_qdq():
        want["fp8_matmul_stacked"] = proj
    elif mode.is_weight_only():
        want["woq_matmul_stacked"] = proj
    elif mode.has_act_and_weight_quant():
        name = ("w8a8_matmul_stacked" if mode.has_per_token_dynamic_scaling()
                else "w8a8_matmul")
        want[name] = proj
        if gemm:
            want[f"{name}.gemm_launches"] = gemm
        if mode.has_per_token_dynamic_scaling():
            want["rmsnorm_quant"] = 2 * n_l * forwards
    return want


def credit(results, key, n):
    """Add n launches to the kernels line's entry `key`."""
    results[key]["launches"] = results[key].get("launches", 0) + n


def credit_launches(results, mode, launches):
    """Add one mode's launches to the kernels line's entries (by format and
    cache kind)."""
    def add(key, n):
        if n:
            credit(results, key, n)
    woq_key = (INT4_STACKED if mode.has_int4_weights()
               else "woq_matmul_stacked")
    add(woq_key, launches.get("woq_matmul_stacked", 0))
    add("fp8_matmul_stacked", launches.get("fp8_matmul_stacked", 0))
    for name, gemm_key in (("w8a8_matmul_stacked", W8A8_GEMM),
                           ("w8a8_matmul", W8A8_GEMM_2D)):
        n_gemm = launches.get(f"{name}.gemm_launches", 0)
        add(name, launches.get(name, 0) - n_gemm)
        add(gemm_key, n_gemm)
    add("rmsnorm_quant", launches.get("rmsnorm_quant", 0))
    add("prefill_attention_kernel", launches.get("prefill_attention_kernel", 0))
    decode_key = (INT8_DECODE if mode.has_int8_kv_cache() else E4M3_DECODE
                  if mode.has_fp8_kv_cache() else "dma_decode_attention")
    add(decode_key, launches.get("dma_decode_attention", 0))


def accuracy_row(tag, cfg, params, name, mode, gs, prompts, ref, cont,
                 act_ranges, kv_scales, device, errors):
    """One evaluate_quant_mode row on `device`; on the card with its
    launches held exactly. Returns (row, launches or None, seconds)."""
    import numpy as np
    import torch
    from trtllm_llama_tpu_torch.quantization.evaluate import (
        evaluate_quant_mode,
    )
    card = device == "cuda"
    if card:
        torch.cuda.synchronize()
        zero_counts()
    t = time.perf_counter()
    row = evaluate_quant_mode(cfg, params, name, mode, prompts,
                              act_ranges=act_ranges, kv_scales=kv_scales,
                              group_size=gs, cont_len=cont, ref_run=ref,
                              device=device)
    secs = time.perf_counter() - t
    bad = [k for k, v in row.items() if k != "mode" and not np.isfinite(v)]
    if bad:
        errors.append(f"{tag} {name}: non-finite {bad}")
    if not card:
        return row, None, secs
    launches, alibi = read_counts()
    want = accuracy_expect(mode, cfg.num_layers, *prompts.shape, cont,
                           cfg.hidden_size)
    if launches != want or alibi:
        errors.append(f"{tag} {name}: launches {launches}, expected {want}")
        print(f"  {tag} {name}: launches {launches}, expected {want}: FAIL")
    return row, launches, secs


def print_rows(tag, rows, launches=None):
    print(f"  {tag}: mode | prefill top-1 | prefill KL | decode top-1 | "
          f"decode KL | ppl ratio | max |err| | launches")
    for name, row in rows.items():
        print(f"    {name:10s} | {row['prefill_top1']:.4f} | "
              f"{row['prefill_kl']:.4e} | {row['decode_top1']:.4f} | "
              f"{row['decode_kl']:.4e} | {row['ppl_ratio']:.5f} | "
              f"{row['max_abs_err']:.4e} | "
              f"{(launches or {}).get(name, '')}")


def accuracy_orderings(tag, rows, errors, int8="int8-wo"):
    """The JAX gates' ordering checks (tests/test_accuracy_gates.py:78-98):
    int8 beats int4, per-token SmoothQuant beats static, the int8-KV
    prefill KL exactly 0 and its decode KL above 0."""
    checks = [
        ("int8 decode KL < int4's",
         rows[int8]["decode_kl"] < rows["int4-wo"]["decode_kl"]),
        ("int8 ppl ratio < int4's",
         rows[int8]["ppl_ratio"] < rows["int4-wo"]["ppl_ratio"]),
        ("sq-ptpc decode KL < sq-static's",
         rows["sq-ptpc"]["decode_kl"] < rows["sq-static"]["decode_kl"]),
        ("int8-kv prefill KL == 0", rows["int8-kv"]["prefill_kl"] == 0.0),
        ("int8-kv decode KL > 0", rows["int8-kv"]["decode_kl"] > 0.0),
    ]
    for what, ok in checks:
        print(f"  {tag}: {what}: {'ok' if ok else 'FAIL'}")
        if not ok:
            errors.append(f"{tag}: ordering check failed: {what}")


def run_accuracy(args, errors, results):
    """Path 10: quantization/evaluate.py on the card. (a) build_golden_setup
    at its defaults (an HF LlamaForCausalLM built on the card, seed 0, its
    calibration there): the ten gated modes on the card and through the
    plain versions on the CPU, in this process, on the same params, ranges
    and continuation; each card row against its CPU row, the launches of
    every mode held exactly, the gates' orderings. (b) LLaMA-7B width,
    ACC_7B_LAYERS layers, an f32 golden HF model built on the card: the ten
    modes (int4 at g128) on 4 x 48-token prompts and 24 teacher-forced
    decode steps, the int4 and fp8 weight formats on structure_weights
    params; every metric finite, the orderings, the table of rows and the
    launches per kernel per mode."""
    import numpy as np
    import torch
    from trtllm_llama_tpu_torch.quantization import evaluate

    # (a) golden scale, card against CPU
    t0 = time.perf_counter()
    cfg, params, act_ranges, kv_scales, hf = evaluate.build_golden_setup(
        device="cuda")
    del hf
    prompts = np.random.default_rng(0).integers(3, cfg.vocab_size,
                                                ACC_PROMPTS)
    print(f"path 10 (a): golden model (build_golden_setup defaults: hidden "
          f"{cfg.hidden_size}, {cfg.num_layers} layers, {cfg.num_heads} heads "
          f"of {cfg.head_dim}, intermediate {cfg.intermediate_size}, vocab "
          f"{cfg.vocab_size}, f32), prompts {ACC_PROMPTS}, {ACC_CONT} "
          f"teacher-forced steps; built and calibrated on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    ref = evaluate.reference_run(cfg, params, prompts, ACC_CONT)
    cont = ref[0]
    params_cpu = _tree_map(lambda t: t.cpu(), params)
    cont_cpu = evaluate.greedy_continuation(cfg, params_cpu, prompts,
                                            ACC_CONT, device="cpu")
    print(f"  the CPU's own greedy continuation equals the card's: "
          f"{np.array_equal(cont_cpu, cont)} (both sides score the card's)")
    ref_cpu = (cont, *evaluate.teacher_forced_logits(cfg, params_cpu, prompts,
                                                     cont, device="cpu"))
    err = float(np.abs(ref[1] - ref_cpu[1]).max() / np.abs(ref_cpu[1]).max())
    print(f"  f32 reference prefill logits, card vs CPU: max rel err "
          f"{err:.3e}")
    card_rows, cpu_rows, counts = {}, {}, {}
    for name, mode, gs in accuracy_modes(64):
        row, launches, secs = accuracy_row(
            "path 10 (a)", cfg, params, name, mode, gs, prompts, ref,
            ACC_CONT, act_ranges, kv_scales, "cuda", errors)
        card_rows[name], counts[name] = row, launches
        credit_launches(results, mode, launches)
        cpu_rows[name], _, secs_cpu = accuracy_row(
            "path 10 (a) CPU", cfg, params_cpu, name, mode, gs, prompts,
            ref_cpu, ACC_CONT, act_ranges, kv_scales, "cpu", errors)
        got, want = row, cpu_rows[name]
        diffs = {
            "prefill_top1": abs(got["prefill_top1"] - want["prefill_top1"])
            * ACC_PROMPTS[0] * ACC_PROMPTS[1],
            "decode_top1": abs(got["decode_top1"] - want["decode_top1"])
            * ACC_PROMPTS[0] * ACC_CONT,
        }
        ok = all(d <= 1 + 1e-9 for d in diffs.values())
        for k in ("prefill_kl", "decode_kl"):
            lim = ACC_KL_REL * max(got[k], want[k]) + ACC_KL_ABS
            ok = ok and abs(got[k] - want[k]) <= lim
        ok = ok and abs(got["ppl_ratio"] - want["ppl_ratio"]) <= ACC_PPL_ABS
        print(f"  {name}: card {secs:.2f} s, CPU {secs_cpu:.2f} s; decode KL "
              f"{got['decode_kl']:.4e} / {want['decode_kl']:.4e}, ppl "
              f"{got['ppl_ratio']:.5f} / {want['ppl_ratio']:.5f}, top-1 "
              f"positions apart {diffs}: {'ok' if ok else 'FAIL'}")
        if not ok:
            errors.append(f"path 10 (a) {name}: card row {got} vs CPU row "
                          f"{want}")
    print_rows("path 10 (a) card", card_rows)
    print_rows("path 10 (a) CPU", cpu_rows)
    accuracy_orderings("path 10 (a) card", card_rows, errors)
    results["_e2e"]["path 10 (a)"] = dict(card=card_rows, cpu=cpu_rows,
                                          launches=counts)
    del params, params_cpu
    gc.collect()
    torch.cuda.empty_cache()

    # (b) LLaMA-7B width
    n_l = min(args.layers, ACC_7B_LAYERS)
    t0 = time.perf_counter()
    cfg, params, act_ranges, kv_scales, hf = evaluate.build_golden_setup(
        layers=n_l, **ACC_7B, device="cuda")
    del hf
    torch.cuda.synchronize()
    print(f"path 10 (b): LLaMA-7B width (hidden 4096, 32 heads, intermediate "
          f"11008, vocab 32000), {n_l} layers, f32 golden HF model built and "
          f"calibrated on the card in {time.perf_counter() - t0:.1f} s; "
          f"prompts {ACC_7B_PROMPTS}, {ACC_7B_CONT} teacher-forced steps")
    prompts = np.random.default_rng(0).integers(3, cfg.vocab_size,
                                                ACC_7B_PROMPTS)
    t0 = time.perf_counter()
    ref = evaluate.reference_run(cfg, params, prompts, ACC_7B_CONT)
    print(f"  reference run: {time.perf_counter() - t0:.1f} s")
    structured = evaluate.structure_weights(params)
    t0 = time.perf_counter()
    ref_s = evaluate.reference_run(cfg, structured, prompts, ACC_7B_CONT)
    print(f"  structure_weights + its reference run: "
          f"{time.perf_counter() - t0:.1f} s")
    modes = accuracy_modes(128)
    modes.insert(0, ("s-int8-wo",) + modes[0][1:])
    rows, counts, times = {}, {}, {}
    for name, mode, gs in modes:
        s = name in ACC_STRUCTURED
        rows[name], launches, times[name] = accuracy_row(
            "path 10 (b)", cfg, structured if s else params, name, mode, gs,
            prompts, ref_s if s else ref, ACC_7B_CONT,
            None if s else act_ranges, None if s else kv_scales, "cuda",
            errors)
        counts[name] = launches
        credit_launches(results, mode, launches)
    print_rows(f"path 10 (b) ({', '.join(ACC_STRUCTURED)} on structured "
               "weights)", rows, {k: sum(v.values()) for k, v in
                                  counts.items()})
    for name, launches in counts.items():
        print(f"  {name}: {times[name]:.2f} s, launches {launches}")
    accuracy_orderings("path 10 (b)", rows, errors, int8="s-int8-wo")
    results["_e2e"]["path 10 (b)"] = dict(layers=n_l, rows=rows,
                                          launches=counts, seconds=times)


# ---------------------------------------------------------------------------
# Path 11: GPT-2 XL (models/gpt.py, convert/hf_gpt.py, prompt tuning)
# ---------------------------------------------------------------------------

# openai-community/gpt2-xl config.json: n_embd 1600, n_layer 48, n_head 25
# (head dim 64), n_inner null (4 x 1600), vocab_size 50257, n_positions
# 1024, activation_function gelu_new, layer_norm_epsilon 1e-5
GPT2_XL = dict(vocab_size=50257, n_embd=1600, n_layer=48, n_head=25,
               n_inner=None, n_positions=1024, activation_function="gelu_new",
               layer_norm_epsilon=1e-5)
GPT2_NEW = 16
GPT2_ENGINE = dict(max_batch_size=4, max_input_len=16, max_seq_len=64)
HF_TOL = 1e-3        # f32 logits against HF's own forward, x max |logit|
PT_TASKS, PT_TOKENS = 2, 8   # prompt tuning: tasks x virtual tokens each


def hf_greedy(hf, ids, new):
    """HF's own greedy tokens (a full forward a step, no cache) and the
    logits of each step: ([new] ints, [new] f32 [V] tensors)."""
    import torch
    seq = torch.as_tensor(ids, device="cuda")
    toks, steps = [], []
    with torch.inference_mode():
        for _ in range(new):
            lg = hf(seq).logits[0, -1].float()
            tok = int(lg.argmax())
            toks.append(tok)
            steps.append(lg)
            seq = torch.cat([seq, torch.tensor([[tok]], device="cuda")], 1)
    return toks, steps


def tokens_vs_plain(tag, sess, prompt, out, pairs, new, errors):
    """`out` (the kernels' tokens of `prompt`) against the same request
    with `pairs` on their plain versions: equal, or their first difference
    a near tie (both replays pick their own token, and the two logits
    moved against each other by at most LOGITS_TOL x max |logit|)."""
    import numpy as np
    from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
    scfg = SamplingConfig(end_id=-1)
    with plain_path(pairs):
        ref = sess.generate(prompt, sampling=scfg, max_new_tokens=new)
    a_ids, b_ids = out.output_ids, ref.output_ids
    rows = np.flatnonzero((a_ids != b_ids).any(1))
    print(f"  {tag}: tokens identical to the plain path's in "
          f"{a_ids.shape[0] - len(rows)} of {a_ids.shape[0]} rows")
    for row in rows:
        k = int(np.flatnonzero(a_ids[row] != b_ids[row])[0])
        a, b = int(a_ids[row, k]), int(b_ids[row, k])
        la = replay_logits(sess, prompt, a_ids[:, :k], scfg, new)[row].float()
        with plain_path(pairs):
            lb = replay_logits(sess, prompt, a_ids[:, :k], scfg,
                               new)[row].float()
        picks = int(la.argmax()) == a and int(lb.argmax()) == b
        shift = float(la[a] - la[b] + lb[b] - lb[a])
        limit = LOGITS_TOL * float(la.abs().max())
        tie = picks and shift <= limit
        print(f"  {tag} row {row}: first differ at {k} ({a} vs {b}), shift "
              f"{shift:.5f} (limit {limit:.5f}): "
              f"{'a near tie' if tie else 'NOT a near tie'}")
        if not tie:
            errors.append(f"{tag} row {row}: tokens differ from the plain "
                          f"path's at {k}, not a near tie")


def gpt2_expect(n_l, prefills, steps, proj=0, gemm=0, tc=0, ragged=0):
    """Launches of a GPT-2 run: row 10 a layer a prefill, kernel 3 a layer
    a decode step; with int8 weights row 2 six times a layer and forward
    (its GEMM / tensor-core GEMV / ragged-K GEMM shares given as forwards)."""
    want = {"prefill_attention_kernel": n_l * prefills,
            "dma_decode_attention": n_l * steps}
    if proj:
        want["woq_matmul_stacked"] = 6 * n_l * proj
        for key, n in (("gemm", gemm), ("tc", tc)):
            if n:
                want[f"woq_matmul_stacked.{key}_launches"] = 6 * n_l * n
        if ragged:   # q, k, v, o and fc have K = 1600 (12.5 GEMM tiles)
            want["woq_matmul_stacked.ragged_launches"] = 5 * n_l * ragged
    return want


def run_gpt2(args, errors, results):
    """Path 11: GPT-2 XL at its published widths and depth (GPT2_XL),
    GPT2LMHeadModel built on the card from seed 0, converted by
    convert/hf_gpt.py, run through GenerationSession(model=gpt): f32 (TF32
    off) first-token logits against HF's forward within HF_TOL and 16
    greedy tokens against HF's (near ties aside); bf16 tokens against the
    plain path, device ms a bs1 decode token against the byte floor; int8
    weight-only (row 2 on the six projections a layer: the one-row GEMV at
    bs1 decode, the tensor-core GEMV at the 16-row prefill and bs4 decode,
    the GEMM with its ragged K tile at bs4's 64-row prefill) against the
    plain path; prompt tuning (2 tasks x 8 virtual tokens whose table
    rows are real embeddings: tokens bit-identical to the real-token run;
    another table moves the logits; with a repetition penalty on, every
    token in the vocabulary). Launches held exactly in every run."""
    import dataclasses

    import numpy as np
    import torch
    from transformers import GPT2Config, GPT2LMHeadModel
    from trtllm_llama_tpu_torch import EngineConfig, QuantMode
    from trtllm_llama_tpu_torch.convert.hf_gpt import (config_from_hf_gpt2,
                                                       params_from_hf_gpt2)
    from trtllm_llama_tpu_torch.models import gpt
    from trtllm_llama_tpu_torch.ops.kernels import woq_matmul as woq
    from trtllm_llama_tpu_torch.quantization.quantize import quantize_params
    from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
    from trtllm_llama_tpu_torch.runtime.session import GenerationSession

    # the published depth, or --layers where it cuts the paths below 32
    n_l = GPT2_XL["n_layer"] if args.layers >= 32 else args.layers
    hf_cfg = GPT2Config(**{**GPT2_XL, "n_layer": n_l})
    t0 = time.perf_counter()
    torch.manual_seed(0)
    with torch.device("cuda"):
        hf = GPT2LMHeadModel(hf_cfg).eval()
    cfg = config_from_hf_gpt2(hf_cfg, dtype="float32")
    p32 = params_from_hf_gpt2(hf, cfg)
    torch.cuda.synchronize()
    print(f"path 11: GPT-2 XL (gpt2-xl config.json), {n_l} layers, 25 heads "
          f"of 64, vocab {cfg.vocab_size}; HF model built on the card (seed "
          f"0) and converted in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    ecfg = EngineConfig(**GPT2_ENGINE)
    scfg = SamplingConfig(end_id=-1)
    rng = np.random.default_rng(0)
    ids = rng.integers(3, cfg.vocab_size, (1, 8))
    p4 = [rng.integers(3, cfg.vocab_size, n).tolist() for n in (8, 5, 12, 3)]
    e2e = results["_e2e"].setdefault("path 11", dict(layers=n_l))

    # f32 against HF's own forward
    t0 = time.perf_counter()
    hf_toks, hf_steps = hf_greedy(hf, ids, GPT2_NEW)
    print(f"  HF greedy ({GPT2_NEW} tokens, full forwards): "
          f"{time.perf_counter() - t0:.1f} s, {hf_toks}")
    sess = GenerationSession(cfg, p32, ecfg, device="cuda", model=gpt)
    got, _ = first_logits(gpt, sess, ids, [])
    compare("path 11 f32 first-token logits vs HF's forward", got[0],
            hf_steps[0], errors, tol=HF_TOL)
    timed_generate(sess, ids, 2)
    zero_counts()
    out, ms = timed_generate(sess, ids, GPT2_NEW)
    check_counts("path 11 f32", read_counts(),
                 dict(launches=gpt2_expect(n_l, 1, GPT2_NEW - 1),
                      alibi_decode=0), errors)
    credit(results, "prefill_attention_kernel", n_l)
    credit(results, "dma_decode_attention", n_l * (GPT2_NEW - 1))
    mine = out.output_ids[0].tolist()
    print(f"  f32 tokens {mine} ({ms:.1f} ms); identical to HF's: "
          f"{mine == hf_toks}")
    if mine != hf_toks:
        k = next(i for i, (a, b) in enumerate(zip(mine, hf_toks)) if a != b)
        near_tie(f"path 11 f32 token {k} vs HF", hf_steps[k], mine[k],
                 hf_toks[k], errors)
    e2e.update(f32_ms=ms, f32_same_as_hf=mine == hf_toks)
    del sess, hf, hf_steps
    gc.collect()

    # bf16 against the plain path
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    p16 = _tree_map(lambda t: t.to(torch.bfloat16), p32)
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    w_bytes = sum(t.numel() * 2 for k, t in p16["layers"].items()) + (
        p16["lm_head"].numel() * 2)
    floor = w_bytes / HBM_BYTES_PER_S * 1e3
    sess = GenerationSession(cfg16, p16, ecfg, device="cuda", model=gpt)
    timed_generate(sess, ids, 2)
    _, pre_ms = timed_generate(sess, ids, 1)
    zero_counts()
    out16, ms = timed_generate(sess, ids, GPT2_NEW)
    check_counts("path 11 bf16", read_counts(),
                 dict(launches=gpt2_expect(n_l, 1, GPT2_NEW - 1),
                      alibi_decode=0), errors)
    credit(results, "prefill_attention_kernel", n_l)
    credit(results, "dma_decode_attention", n_l * (GPT2_NEW - 1))
    check_tokens("path 11 bf16", out16, GPT2_NEW, cfg.vocab_size, errors)
    tokens_vs_plain("path 11 bf16", sess, ids, out16, attention_pairs(),
                    GPT2_NEW, errors)
    got, ref = first_logits(gpt, sess, ids, attention_pairs())
    compare("path 11 bf16 first-token logits, kernels vs plain", got, ref,
            errors, tol=LOGITS_TOL)
    dev_tok, busy = profile_generate(sess, ids, scfg, row_limit=10)
    dec_ms = (ms - pre_ms) / (GPT2_NEW - 1)
    print(f"  bf16 bs1: prefill {pre_ms:.2f} ms, decode {dec_ms:.3f} ms/token "
          f"(wall), device {dev_tok:.3f} ms per decode token against the "
          f"byte floor {floor:.3f} ms ({w_bytes / 1e9:.2f} GB of bf16 "
          f"weights at 3.35 TB/s)")
    e2e.update(bf16_prefill_ms=pre_ms, bf16_decode_ms_per_token=dec_ms,
               bf16_device_ms_per_decode_token=dev_tok,
               bf16_device_busy_share=busy, bf16_byte_floor_ms=floor)

    # prompt tuning (bf16): virtual ids over real embeddings
    real = rng.integers(3, cfg.vocab_size, (PT_TASKS, 16)).astype(np.int32)
    table = torch.cat([p16["embed"][torch.as_tensor(real[t, :PT_TOKENS],
                                                    device="cuda").long()]
                       for t in range(PT_TASKS)])
    virt = real.copy()
    virt[:, :PT_TOKENS] = cfg.vocab_size + np.arange(PT_TOKENS)
    tasks = torch.arange(PT_TASKS, dtype=torch.int32, device="cuda")
    pt = gpt.PromptTuning(table, tasks, PT_TOKENS)
    zero_counts()
    out_r = sess.generate(real, sampling=scfg, max_new_tokens=GPT2_NEW)
    out_v = sess.generate(virt, sampling=scfg, max_new_tokens=GPT2_NEW,
                          prompt=pt)
    check_counts("path 11 prompt tuning", read_counts(),
                 dict(launches=gpt2_expect(n_l, 2, 2 * (GPT2_NEW - 1)),
                      alibi_decode=0), errors)
    same = np.array_equal(out_r.output_ids, out_v.output_ids)
    print(f"  prompt tuning ({PT_TASKS} tasks x {PT_TOKENS} virtual tokens "
          f"over real embeddings): tokens bit-identical to the real-token "
          f"run: {same}")
    if not same:
        errors.append("path 11: prompt-tuning tokens differ from the "
                      "real-token run")
    with torch.inference_mode():
        lens = torch.full((PT_TASKS,), 16, dtype=torch.int32, device="cuda")
        vt = torch.as_tensor(virt, device="cuda")

        def prefill(ids, prompt):
            caches = gpt.init_caches(cfg16, PT_TASKS, 32, "cuda")
            return gpt.forward_prefill(sess.params, cfg16, ids, lens, caches,
                                       prompt=prompt)[0]
        other = gpt.PromptTuning(
            torch.randn(table.shape, device="cuda").to(torch.bfloat16) * 0.05,
            tasks, PT_TOKENS)
        tuned = prefill(vt, pt)
        same_logits = torch.equal(
            tuned, prefill(torch.as_tensor(real, device="cuda"), None))
        moved = float((tuned - prefill(vt, other)).abs().max())
    print(f"  prompt tuning: first-token logits bit-identical to the "
          f"real-token prefill's: {same_logits}; another prompt table moves "
          f"them by {moved:.4f} (> 1e-3 required)")
    if not same_logits:
        errors.append("path 11: prompt-tuning logits differ from the "
                      "real-token prefill's")
    if not moved > 1e-3:
        errors.append("path 11: another prompt table leaves the logits")
    pen = sess.generate(virt, max_new_tokens=8, prompt=pt,
                        sampling=SamplingConfig(repetition_penalty=1.2,
                                                end_id=-1))
    ok = bool((pen.output_ids >= 0).all() and (pen.output_ids
                                                 < cfg.vocab_size).all())
    print(f"  virtual prompt with repetition penalty 1.2: tokens in the "
          f"vocabulary: {ok}")
    if not ok:
        errors.append("path 11: penalized prompt-tuning run left the "
                      "vocabulary")
    credit(results, "prefill_attention_kernel", 2 * n_l)
    credit(results, "dma_decode_attention", 2 * n_l * (GPT2_NEW - 1))
    e2e.update(prompt_tuning_same=same, prompt_table_moves=moved)
    del sess
    gc.collect()

    # int8 weight-only: row 2 on every route at K 1600 / 6400
    cfg8 = dataclasses.replace(cfg16, quant_mode=QuantMode.use_weight_only())
    q8 = quantize_params(p16, QuantMode.use_weight_only())
    del p16
    gc.collect()
    torch.cuda.empty_cache()
    sess = GenerationSession(cfg8, q8, ecfg, device="cuda", model=gpt)
    del q8
    bucket = ecfg.bucket_for(8)
    rows4 = 4 * ecfg.bucket_for(max(len(p) for p in p4))
    routes = {"bs1 prefill": (bucket, 1), "bs1 decode": (1, GPT2_NEW - 1),
              "bs4 prefill": (rows4, 1), "bs4 decode": (4, GPT2_NEW - 1)}
    tc = sum(n for r, n in routes.values()
             if not woq.gemm_route(r, torch.bfloat16, k=1600)
             and woq.tc_route(r, torch.bfloat16, 1600))
    gemm = sum(n for r, n in routes.values()
               if woq.gemm_route(r, torch.bfloat16, k=1600))
    print(f"  int8 routes (rows, forwards): {routes}; GEMM forwards {gemm}, "
          f"tensor-core GEMV forwards {tc}")
    timed_generate(sess, ids, 2)
    zero_counts()
    out8, ms8 = timed_generate(sess, ids, GPT2_NEW)
    out84 = sess.generate(p4, sampling=scfg, max_new_tokens=GPT2_NEW)
    want = gpt2_expect(n_l, 2, 2 * (GPT2_NEW - 1), proj=2 * GPT2_NEW,
                       gemm=gemm, tc=tc, ragged=gemm)
    counts = read_counts()
    check_counts("path 11 int8", counts, dict(launches=want, alibi_decode=0),
                 errors)
    launches = counts[0]
    n_gemm = launches.get("woq_matmul_stacked.gemm_launches", 0)
    n_tc = launches.get("woq_matmul_stacked.tc_launches", 0)
    for key, n in (("woq_matmul_stacked",
                    launches.get("woq_matmul_stacked", 0) - n_gemm - n_tc),
                   (GEMM_INT8, n_gemm), (TC_INT8, n_tc),
                   (GEMM_RAGGED,
                    launches.get("woq_matmul_stacked.ragged_launches", 0)),
                   ("prefill_attention_kernel", 2 * n_l),
                   ("dma_decode_attention", 2 * n_l * (GPT2_NEW - 1))):
        credit(results, key, n)
    check_tokens("path 11 int8", out8, GPT2_NEW, cfg.vocab_size, errors)
    pairs = attention_pairs() + [(woq, "woq_matmul_stacked")]
    tokens_vs_plain("path 11 int8 bs1", sess, ids, out8, pairs, GPT2_NEW,
                    errors)
    tokens_vs_plain("path 11 int8 bs4", sess, p4, out84, pairs, GPT2_NEW,
                    errors)
    got, ref = first_logits(gpt, sess, ids, pairs)
    compare("path 11 int8 first-token logits, kernels vs plain", got, ref,
            errors, tol=LOGITS_TOL)
    print(f"  int8 bs1: {ms8:.1f} ms for {GPT2_NEW} tokens")
    e2e.update(int8_ms=ms8, int8_launches=launches)
    del sess


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# the kernel phase at paths 10 and 11's shapes
# ---------------------------------------------------------------------------

def check_accuracy_shapes(errors, results):
    """The kernels at path 10's shapes (f32 activations: (a) hidden 256, 8
    heads of 32, B=2 S=16, decode rows 2; (b) hidden 4096, 32 heads of 128,
    B=4 S=48, decode rows 4) and path 11's (bf16 and f32, 25 heads of 64):
    rows 2 and 4 (int8, int4 per-channel and grouped, fp8) on the one-row
    GEMV, rows 5 and 6 (exact) and row 7 at the prefill and decode rows,
    row 10 at the prefills, kernel 3 on f32 / bf16, int8 and e4m3 caches at
    the decode steps, each against its plain version."""
    import torch
    from trtllm_llama_tpu_torch.ops.kernels import decode_attention as da
    from trtllm_llama_tpu_torch.ops.kernels import fp8_matmul as f8k
    from trtllm_llama_tpu_torch.ops.kernels import prefill_attention as pa
    from trtllm_llama_tpu_torch.ops.kernels import rmsnorm_quant as rnq
    from trtllm_llama_tpu_torch.ops.kernels import w8a8_matmul as w8a8
    from trtllm_llama_tpu_torch.ops.kernels import woq_matmul as woq
    from trtllm_llama_tpu_torch.quantization.tensors import (
        quantize_fp8_weight, quantize_per_token, quantize_weight_only,
    )

    print("kernels at path 10's shapes (f32) and path 11's (GPT-2 XL):")
    g = torch.Generator(device="cuda").manual_seed(31)
    f32 = torch.float32
    # (tag, [(K, N)], rows, int4 group)
    sizes = [("(a)", [(256, 256), (256, 512), (512, 256)], (2, 32), 64),
             ("(b)", [(4096, 4096), (4096, 11008), (11008, 4096)], (4, 192),
              128)]
    for tag, shapes, rows, group in sizes:
        for k, n in shapes:
            w = torch.randn((2, k, n), generator=g, device="cuda") * k ** -0.5
            weights = {"int8": quantize_weight_only(w, 8),
                       "int4": quantize_weight_only(w, 4),
                       f"int4 g{group}": quantize_weight_only(w, 4, group),
                       "fp8": quantize_fp8_weight(w)}
            for m in rows:
                x = torch.randn((m, k), generator=g, device="cuda")
                for fmt, wq in weights.items():
                    fn, plain = ((f8k.fp8_matmul_stacked,
                                  f8k.fp8_matmul_stacked_plain)
                                 if fmt == "fp8" else
                                 (woq.woq_matmul_stacked,
                                  woq.woq_matmul_stacked_plain))
                    compare(f"{tag} {fmt} f32 M={m} K={k} N={n}",
                            fn(x, wq, 1), plain(x, wq, 1), errors,
                            tol=F32_TOL)
                x_q, s_x = quantize_per_token(x)
                wsq = torch.randint(-127, 128, (2, k, n), generator=g,
                                    device="cuda", dtype=torch.int8)
                s_w = torch.rand((2, n), generator=g, device="cuda") * 1e-3
                exact(f"{tag} w8a8 per-token M={m} K={k} N={n}",
                      w8a8.w8a8_matmul_stacked(x_q, wsq, s_x, s_w, 1),
                      w8a8.w8a8_matmul_stacked_plain(x_q, wsq, s_x, s_w, 1),
                      errors)
                s_t = torch.tensor(0.02, device="cuda")
                exact(f"{tag} w8a8 static M={m} K={k} N={n}",
                      w8a8.w8a8_matmul(x_q, wsq[1], s_t, s_w[1]),
                      w8a8.w8a8_matmul_plain(x_q, wsq[1], s_t, s_w[1]),
                      errors)
                if (k, n) == shapes[0]:
                    nw = 1 + 0.1 * torch.randn((k,), generator=g,
                                               device="cuda")
                    qa, sa = rnq.rmsnorm_quant(x, nw)
                    qb, sb = rnq.rmsnorm_quant_plain(x, nw)
                    ok = bool((qa.int() - qb.int()).abs().max() <= 1)
                    compare(f"{tag} rmsnorm_quant f32 M={m} D={k} scale", sa,
                            sb, errors, tol=F32_TOL)
                    if not ok:
                        errors.append(f"{tag} rmsnorm_quant M={m}: codes "
                                      "more than one apart")
    # attention: (tag, dtype, B, S, H, D, lens)
    prefills = [("(a)", f32, 2, 16, 8, 32, [16, 16]),
                ("(b)", f32, 4, 48, 32, 128, [48] * 4),
                ("GPT-2 XL", f32, 1, 16, 25, 64, [8]),
                ("GPT-2 XL", torch.bfloat16, 1, 16, 25, 64, [8]),
                ("GPT-2 XL", torch.bfloat16, 4, 16, 25, 64, [8, 5, 12, 3]),
                ("GPT-2 XL prompt tuning", torch.bfloat16, 2, 16, 25, 64,
                 [16, 16])]
    for tag, dt, b, s, h, d, lens in prefills:
        q, k_, v = (torch.randn((b, s, h, d), generator=g, device="cuda")
                    .to(dt) for _ in range(3))
        sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        compare(f"{tag} row 10 {dt} B={b} S={s} H={h} D={d}",
                pa.prefill_attention_kernel(q, k_, v, sl),
                pa.prefill_attention_kernel_plain(q, k_, v, sl), errors,
                tol=F32_TOL if dt == f32 else BF16_TOL)
    # decode: (tag, q dtype, B, H, D, positions)
    decodes = [("(a)", f32, 2, 8, 32, [16, 25]),
               ("(b)", f32, 4, 32, 128, [48, 60, 71, 48]),
               ("GPT-2 XL", f32, 1, 25, 64, [8]),
               ("GPT-2 XL", torch.bfloat16, 1, 25, 64, [22]),
               ("GPT-2 XL", torch.bfloat16, 4, 25, 64, [8, 5, 26, 17])]
    for tag, dt, b, h, d, pos in decodes:
        for kv in ((None, "int8", "e4m3") if dt == f32 else (None,)):
            shape = (2, b, h, 128, d)
            kc = (kv_cache(shape, kv, g) if kv else
                  torch.randn(shape, generator=g, device="cuda").to(dt))
            vc = (kv_cache(shape, kv, g) if kv else
                  torch.randn(shape, generator=g, device="cuda").to(dt))
            q, kn, vn = (torch.randn((b, h, d), generator=g, device="cuda")
                         .to(dt) for _ in range(3))
            pt = torch.tensor(pos, dtype=torch.int32, device="cuda")
            scale = (torch.full((2,), KV_SCALE, device="cuda") if kv
                     else None)
            kc2, vc2 = kc.clone(), vc.clone()
            got = da.dma_decode_attention(q, kn, vn, kc, vc, 1, pt,
                                          kv_scale=scale)
            ref = da.dma_decode_attention_plain(q, kn, vn, kc2, vc2, 1, pt,
                                                kv_scale=scale)
            name = (f"{tag} kernel 3 {dt} q, {kv or dt} cache B={b} H={h} "
                    f"D={d} pos={pos}")
            compare(name, got, ref, errors,
                    tol=F32_TOL if dt == f32 else BF16_TOL)
            if not (torch.equal(kc, kc2) and torch.equal(vc, vc2)):
                errors.append(f"{name}: cache differs from the plain write")


def check_gpt2_shapes(errors, results):
    """Row 2 (int8, bf16) at GPT-2 XL's projections (K 1600 -> 1600, 1600
    -> 6400, 6400 -> 1600) at 1, 4, 16 and 64 rows, each on its route (the
    one-row GEMV, the tensor-core GEMV, the GEMM; counted) against its
    plain version; the GEMM at K = 1600 (12.5 tiles, the last one ragged)
    also bit for bit against the same call on operands zero-padded to 13
    whole tiles, and timed at 64 rows beside the plain version, the
    library and the bound (GEMM_RAGGED)."""
    import torch
    from trtllm_llama_tpu_torch.ops.kernels import woq_matmul as woq
    from trtllm_llama_tpu_torch.quantization.tensors import WOQWeight

    print("kernel woq_matmul_stacked at GPT-2 XL's shapes (int8, bf16):")
    g = torch.Generator(device="cuda").manual_seed(32)
    fn, plain = woq.woq_matmul_stacked, woq.woq_matmul_stacked_plain
    max_err = 0.0
    for k, n in ((1600, 1600), (1600, 6400), (6400, 1600)):
        w = make_gemv_weight("int8", 2, k, n, g)
        pad = -k % woq.GEMM_TILE_K
        w_pad = WOQWeight(torch.cat([w.qweight, w.qweight.new_zeros(
            (2, pad, n))], 1).contiguous(), w.scale, 8, 0, 0)
        for m in (1, 4, 16, 64):
            x = torch.randn((m, k), generator=g, device="cuda").to(
                torch.bfloat16)
            before = (fn.launches, fn.gemm_launches, fn.tc_launches,
                      fn.ragged_launches)
            got = fn(x, w, 1)
            torch.cuda.synchronize()
            after = (fn.launches, fn.gemm_launches, fn.tc_launches,
                     fn.ragged_launches)
            delta = tuple(a - b for a, b in zip(after, before))
            want = ((1, 1, 0, int(pad > 0)) if m > 16 else (1, 0, 1, 0)
                    if m > 1 else (1, 0, 0, 0))
            route_name = ("GEMM" if m > 16 else "tensor-core GEMV" if m > 1
                          else "one-row GEMV")
            err = compare(f"K={k} N={n} M={m} ({route_name})", got,
                          plain(x, w, 1), errors)
            max_err = max(max_err, err) if m > 16 and pad else max_err
            if delta != want:
                errors.append(f"GPT-2 XL K={k} N={n} M={m}: launches "
                              f"(all, GEMM, TC, ragged) {delta}, expected "
                              f"{want}")
            if m > 16 and pad:
                x_pad = torch.cat([x, x.new_zeros((m, pad))], 1)
                exact(f"K={k} N={n} M={m} ragged GEMM vs zero-padded K="
                      f"{k + pad}", got, fn(x_pad, w_pad, 1), errors)
                if n == 6400:
                    deq = torch.stack([(w.qweight[i].float() * w.scale[i])
                                       .to(torch.bfloat16) for i in range(2)])
                    t_k = time_ms(lambda i: fn(x, w, i % 2))
                    t_p = time_ms(lambda i: plain(x, w, i % 2), iters=8,
                                  warmup=1, reps=1)
                    t_l = time_ms(lambda i: torch.matmul(x, deq[i % 2]))
                    n_bytes = k * n + n * 4 + m * k * 2 + m * n * 4
                    b_ms, b_by = bound_ms(n_bytes, 2 * m * k * n)
                    print(f"  time K={k} N={n} M={m} (ragged GEMM): kernel "
                          f"{t_k:.4f} ms, plain {t_p:.4f} ms, "
                          f"library(matmul bf16 dequantized) {t_l:.4f} ms, "
                          f"bound {b_ms:.4f} ms ({b_by})")
                    results[GEMM_RAGGED] = dict(
                        ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                        bound_by=b_by, shape=f"M={m} K={k} N={n} int8 bf16, "
                        "GPT-2 XL c_fc (12.5 K tiles)", launches=0)
    results[GEMM_RAGGED]["max_abs_err"] = max_err


# Path 9: tensor parallelism, two ranks on the one card (parallel/launch.py)
PATH9 = "path 9 (tp=2)"
# every run's depth: at 32 layers (int8; W8A8 and fp8 at 8) the phase took
# 128.2 s on an H100 (PERF.md), past the ~90 s it may take
PATH9_LAYERS = 8
TP = 2
TP_COLLECTIVE_S = 300  # a rank's collective timeout
TP_JOIN_S = 900        # the launcher's join timeout for both ranks
# the kernel phase's windows: w_down's local shape at tp = 2 (K 11008 / 2,
# N 4096), the row-parallel overlap's 4 windows of 1024 columns and one
# more of 768 at 256 (whole tensor-core GEMV tiles of 256 columns)
WINDOW_K, WINDOW_N = 5504, 4096
WINDOWS = tuple((c * 1024, 1024) for c in range(4)) + ((256, 768),)
WINDOW_ROUTES = {"gemv": 1, "tc": 8, "gemm": 1024}


def check_windows(errors, results):
    """n_window on every route of rows 2, 4 and 6 at w_down's local
    shape: each window bit for bit against the full call's columns and
    within the tolerance of the plain version's window; the route and the
    window launches held by the counters; one windowed 1024-row GEMM timed
    against the full call, in int8, fp8 and W8A8."""
    import torch
    from trtllm_llama_tpu_torch.ops.kernels import fp8_matmul as f8k
    from trtllm_llama_tpu_torch.ops.kernels import w8a8_matmul as w8a8
    from trtllm_llama_tpu_torch.ops.kernels import woq_matmul as woq

    g = torch.Generator(device="cuda").manual_seed(31)
    k, n = WINDOW_K, WINDOW_N
    print(f"n_window at K={k} N={n} (w_down at tp=2), windows {WINDOWS}:")
    for fmt in ("int8", "int4 g128", "fp8"):
        w = make_gemv_weight(fmt, 2, k, n, g)
        fn, plain = ((f8k.fp8_matmul_stacked, f8k.fp8_matmul_stacked_plain)
                     if fmt == "fp8" else
                     (woq.woq_matmul_stacked, woq.woq_matmul_stacked_plain))
        for rte, m in WINDOW_ROUTES.items():
            x = torch.randn((m, k), generator=g, device="cuda").to(
                torch.bfloat16)
            full = fn(x, w, 1)
            before = (fn.window_launches, fn.gemm_launches, fn.tc_launches,
                      fn.launches)
            same, err = True, 0.0
            for s, ln in WINDOWS:
                got = fn(x, w, 1, n_window=(s, ln))
                same &= bool(torch.equal(got, full[:, s:s + ln]))
                err = max(err, compare(
                    f"{fmt} {rte} M={m} window ({s}, {ln}) vs plain", got,
                    plain(x, w, 1, n_window=(s, ln)), errors))
            nw = len(WINDOWS)
            d = [a - b for a, b in zip((fn.window_launches, fn.gemm_launches,
                                        fn.tc_launches, fn.launches), before)]
            want = [nw, nw if rte == "gemm" else 0, nw if rte == "tc" else 0,
                    nw]
            ok = same and d == want
            print(f"  {fmt} {rte} M={m}: {nw} windows bit-identical to the "
                  f"full call's columns: {same}; window / GEMM / tensor-core "
                  f"/ all launches {d} (expected {want}): "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                errors.append(f"n_window {fmt} {rte}: bit-identical {same}, "
                              f"launches {d} != {want}")
        if fmt in ("int8", "fp8"):
            time_window(fmt, w, g, results)
        del w
    for m in (2, 1024):             # W8A8: dp4a, then the GEMM
        x_q = torch.randint(-127, 128, (m, k), generator=g, device="cuda",
                            dtype=torch.int8)
        w_q = torch.randint(-127, 128, (2, k, n), generator=g, device="cuda",
                            dtype=torch.int8)
        s_x = torch.rand((m, 1), generator=g, device="cuda") * 1e-2 + 1e-3
        s_w = torch.rand((2, n), generator=g, device="cuda") * 1e-3 + 1e-4
        fn = w8a8.w8a8_matmul_stacked
        full = fn(x_q, w_q, s_x, s_w, 1)
        same = all(bool(torch.equal(fn(x_q, w_q, s_x, s_w, 1, n_window=wi),
                                    full[:, wi[0]:sum(wi)]))
                   and bool(torch.equal(
                       fn(x_q, w_q, s_x, s_w, 1, n_window=wi),
                       w8a8.w8a8_matmul_stacked_plain(
                           x_q, w_q, s_x, s_w, 1, n_window=wi)))
                   for wi in WINDOWS)
        print(f"  w8a8 {'dp4a' if m < 5 else 'GEMM'} M={m}: windows equal "
              f"the full call's columns and the plain version bit for bit: "
              f"{same}")
        if not same:
            errors.append(f"n_window w8a8 M={m}: not bit-identical")
    time_window("w8a8", w_q, g, results)


def time_window(fmt, w, g, results):
    """One windowed 1024-row GEMM (the overlap's first window) against the
    full call, the plain version's window, the library call on the
    window's dequantized columns and the bound. fmt: "int8" / "fp8" (w
    the stacked weight) or "w8a8" (w the stacked int8 codes)."""
    import torch
    from trtllm_llama_tpu_torch.ops.fp8 import fp8_decode
    from trtllm_llama_tpu_torch.ops.kernels import fp8_matmul as f8k
    from trtllm_llama_tpu_torch.ops.kernels import w8a8_matmul as w8a8
    from trtllm_llama_tpu_torch.ops.kernels import woq_matmul as woq

    m, win = 1024, WINDOWS[0]
    cols = slice(win[0], sum(win))
    if fmt == "w8a8":
        k, n = w.shape[1:]
        x = torch.randint(-127, 128, (m, k), generator=g, device="cuda",
                          dtype=torch.int8)
        s_x = torch.rand((m, 1), generator=g, device="cuda") * 1e-2 + 1e-3
        s_w = torch.rand((2, n), generator=g, device="cuda") * 1e-3 + 1e-4

        def call(i, nw=None):
            return w8a8.w8a8_matmul_stacked(x, w, s_x, s_w, i % 2,
                                            n_window=nw)

        def plain(i):
            return w8a8.w8a8_matmul_stacked_plain(x, w, s_x, s_w, i % 2,
                                                  n_window=win)
        xl = x.to(torch.bfloat16)
        deq = [w[layer][:, cols].to(torch.bfloat16) for layer in range(2)]
        peak, w_item = INT8_OPS, 1
        key = "w8a8_matmul_stacked"
    else:
        k, n = w.k_dim, w.qweight.shape[-1]
        x = xl = torch.randn((m, k), generator=g, device="cuda").to(
            torch.bfloat16)
        fn, pl = ((f8k.fp8_matmul_stacked, f8k.fp8_matmul_stacked_plain)
                  if fmt == "fp8" else
                  (woq.woq_matmul_stacked, woq.woq_matmul_stacked_plain))

        def call(i, nw=None):
            return fn(x, w, i % 2, n_window=nw)

        def plain(i):
            return pl(x, w, i % 2, n_window=win)
        codes = [(fp8_decode(w.codes(layer)) if fmt == "fp8"
                  else w.codes(layer).float()) for layer in range(2)]
        deq = [(codes[layer][:, cols] * w.scale[layer, cols]).to(
            torch.bfloat16).contiguous() for layer in range(2)]
        peak, w_item = BF16_FLOPS, 1
        key = "fp8_matmul_stacked" if fmt == "fp8" else "woq_matmul_stacked"
    t_win = time_ms(lambda i: call(i, win))
    t_full = time_ms(call)
    t_plain = time_ms(plain, iters=2, warmup=1, reps=1)
    t_lib = time_ms(lambda i: torch.matmul(xl, deq[i % 2]))
    n_bytes = (k * win[1] * w_item + win[1] * 4 + m * k * x.element_size()
               + m * win[1] * 4)
    b_ms, b_by = bound_ms(n_bytes, 2 * m * k * win[1], peak)
    print(f"  time {fmt} GEMM M={m} K={k}: window {win} {t_win:.4f} ms, "
          f"full N={n} {t_full:.4f} ms ({t_full / t_win:.2f}x), plain "
          f"window {t_plain:.4f} ms, library (bf16 matmul of the window's "
          f"dequantized columns) {t_lib:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by}): the window at {100 * b_ms / t_win:.1f}% of it")
    results[key].update(
        window_ms=t_win, window_full_ms=t_full, window_plain_ms=t_plain,
        window_library_ms=t_lib, window_bound_ms=b_ms, window_bound_by=b_by,
        window_shape=f"M={m} K={k} N={n} {fmt}, window {win} (GEMM)")


def tp_entries(counts, decode="dma_decode_attention"):
    """A rank's wrapper counts as kernels-line entries: each stacked
    wrapper's launches split by route, the attention kernels (the decode
    under `decode`), rmsnorm_quant; only the non-zero ones."""
    out = {}
    for fn, gemm_key, tc_key in (
            ("woq_matmul_stacked", GEMM_INT8, TC_INT8),
            ("fp8_matmul_stacked", GEMM_FP8, TC_FP8),
            ("w8a8_matmul_stacked", W8A8_GEMM, None)):
        gemm = counts.get(f"{fn}.gemm_launches", 0)
        tc = counts.get(f"{fn}.tc_launches", 0)
        out[fn] = counts.get(fn, 0) - gemm - tc
        out[gemm_key] = gemm
        if tc_key:
            out[tc_key] = tc
    out["prefill_attention_kernel"] = counts.get("prefill_attention_kernel",
                                                 0)
    out[decode] = counts.get("dma_decode_attention", 0)
    out["rmsnorm_quant"] = counts.get("rmsnorm_quant", 0)
    return {k: v for k, v in out.items() if v}


def run_tp(args, errors, results):
    """Path 9: LLaMA-7B at full width under tensor parallelism, tp = 2, two
    ranks on the one card (parallel/launch.py, backend gloo: NCCL refuses
    two ranks on one device; gloo stages CUDA tensors through the host).
    This process first runs the single-device references (the ranks hold
    half each): path 1's bs1 request, dense serving's 16 requests, path
    2's W8A8, all at PATH9_LAYERS. The ranks (tp_rank) then run (a) bs1
    in 8 out 50, (b) Task A's 923-token prompt under overlap_chunks 4 and 0,
    (c) dense serving, (d) W8A8, (e) fp8; the checks are theirs and this
    phase's, every rank's failure the phase's."""
    import tempfile
    import numpy as np
    import torch
    from trtllm_llama_tpu_torch import EngineConfig, ModelConfig, QuantMode
    from trtllm_llama_tpu_torch.parallel import launch
    from trtllm_llama_tpu_torch.quantization.quantize import (
        init_random_quantized_params,
    )
    from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
    from trtllm_llama_tpu_torch.runtime.serving import ServingEngine
    from trtllm_llama_tpu_torch.runtime.session import GenerationSession

    layers = min(args.layers, PATH9_LAYERS)
    scfg = SamplingConfig(end_id=-1)
    print(f"{PATH9}: LLaMA-7B widths, {layers} layers (int8 weight-only, "
          f"W8A8, fp8); {TP} ranks on the one card over gloo (host-staged: "
          "these times are no picture of TP speed)")
    t0 = time.perf_counter()
    cfg = ModelConfig.llama_7b(quant_mode=QuantMode.use_weight_only(),
                               num_layers=layers)
    params = init_random_quantized_params(cfg, seed=0, device="cuda")
    p1 = np.random.default_rng(0).integers(3, cfg.vocab_size, (1, 8))
    sess = GenerationSession(cfg, params, EngineConfig(**PATH_ENGINE),
                             device="cuda")
    ref_a = sess.generate(p1, sampling=scfg,
                          max_new_tokens=NEW_TOKENS).output_ids[0].tolist()
    del sess
    rng = np.random.default_rng(1)
    prompts = [rng.integers(3, cfg.vocab_size, n).tolist()
               for n in serve_prompt_lens()]
    eng = ServingEngine(cfg, params, EngineConfig(**SERVE_ENGINE),
                        sampling=scfg, decode_chunk=SERVE_CHUNK, device="cuda")
    rids = [eng.submit(p, SERVE_NEW) for p in prompts]
    done = eng.run_to_completion()
    ref_c = [list(done[r].output_ids) for r in rids]
    del eng, params
    sq_mode = (QuantMode.use_smooth_quant(per_token=True, per_channel=True)
               | QuantMode.INT8_KV_CACHE)
    sq = ModelConfig.llama_7b(quant_mode=sq_mode, num_layers=layers)
    params = init_random_quantized_params(sq, seed=0, device="cuda")
    sess = GenerationSession(sq, params, EngineConfig(**PATH_ENGINE),
                             kv_scales=[KV_SCALE] * layers, device="cuda")
    ref_d = sess.generate(p1, sampling=scfg,
                          max_new_tokens=NEW_TOKENS).output_ids[0].tolist()
    del sess, params
    gc.collect()
    torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t0
    print(f"  single-device references (this process): {t_ref:.1f} s")

    work = Path(tempfile.mkdtemp(prefix="tp_smoke_"))
    spec = dict(layers=layers, p1=p1.tolist(), ref_a=ref_a,
                prompts=prompts, ref_c=ref_c, ref_d=ref_d, out=str(work))
    (work / "spec.json").write_text(json.dumps(spec))
    t1 = time.perf_counter()
    ranks = launch.launch("chip_smoke:tp_rank", TP,
                          args=[str(work / "spec.json")], backend="gloo",
                          collective_timeout=TP_COLLECTIVE_S,
                          join_timeout=TP_JOIN_S,
                          sys_path=[str(Path(__file__).resolve().parent)])
    t_ranks = time.perf_counter() - t1
    for r in ranks:
        print(f"  --- rank {r.rank} (exit {r.returncode}) ---")
        print("\n".join("    " + line for line in r.output.splitlines()
                        if "socket.cpp" not in line))
    bad = [r.rank for r in ranks if not r.ok]
    if bad:
        errors.append(f"{PATH9}: ranks {bad} failed")
        return
    outs = [json.loads((work / f"rank{r}.json").read_text())
            for r in range(TP)]
    for r, o in enumerate(outs):
        errors.extend(f"{PATH9} rank {r}: {e}" for e in o["errors"])
    # launches: both ranks' kernels ran on the card in the path's run
    total = {}
    for o in outs:
        for sub, counts in o["counts"].items():
            for key, n in tp_entries(
                    counts, INT8_DECODE if sub == "d" else
                    "dma_decode_attention").items():
                total[key] = total.get(key, 0) + n
    windows = {fn: sum(c.get(f"{fn}.window_launches", 0)
                       for o in outs for c in o["counts"].values())
               for fn in ("woq_matmul_stacked", "fp8_matmul_stacked",
                          "w8a8_matmul_stacked")}
    need = ("woq_matmul_stacked", GEMM_INT8, TC_INT8,
            "prefill_attention_kernel", "dma_decode_attention",
            "w8a8_matmul_stacked", W8A8_GEMM, "rmsnorm_quant", INT8_DECODE,
            GEMM_FP8)
    print(f"  launches in {PATH9}'s run (both ranks): {total}; windowed: "
          f"{windows}")
    for key in need:
        if total.get(key, 0) <= 0:
            errors.append(f"{PATH9}: kernel {key} was never launched")
    for fn, n in windows.items():
        if n <= 0:
            errors.append(f"{PATH9}: {fn} launched no window")
    for key, n in total.items():
        results[key]["launches"] = results[key].get("launches", 0) + n
    for fn, n in windows.items():
        results[fn]["window_launches"] = n
    e2e = {"layers": layers, "backend": "gloo",
           "ranks_on_one_card": TP, "references_s": t_ref,
           "ranks_s": t_ranks, "card": results["_card"],
           "ranks": [o["metrics"] for o in outs]}
    results["_e2e"][PATH9] = e2e
    for r, o in enumerate(outs):
        m = o["metrics"]
        print(f"  rank {r}: bs1 decode {m['device_ms_per_decode_token']:.3f} "
              f"device ms a token ({m['wall_ms_per_decode_token']:.1f} wall), "
              f"all-reduce {m['allreduce_ms_per_decode_token']:.3f} ms a "
              f"token (the profile's c10d / gloo all-reduce events), on "
              f"{results['_card']}; two ranks share the card through "
              "host-staged gloo: no picture of TP speed")


def _tp_profile(sess, ids, scfg, new=PROFILE_NEW):
    """(device ms per decode token, all-reduce ms per decode token) of one
    request under torch.profiler, the prefill alone subtracted: the
    device time of every kernel and copy, and the profile's all-reduce
    events (c10d's op and gloo's own)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def run(n):
        with profile(activities=acts) as prof:
            sess.generate(ids, sampling=scfg, max_new_tokens=n)
        evs = prof.key_averages()
        dev = sum(e.self_device_time_total for e in evs
                  if e.device_type == DeviceType.CUDA) / 1e3
        ar = {e.key: e.cpu_time_total / 1e3 for e in evs
              if "allreduce" in e.key.lower() or "all_reduce" in e.key.lower()}
        return dev, ar
    dev, ar = run(new)
    dev1, ar1 = run(1)
    steps = new - 1
    ar_tok = {k: (v - ar1.get(k, 0.0)) / steps for k, v in ar.items()}
    return (dev - dev1) / steps, ar_tok


def tp_rank(rank, world, spec_path):
    """One rank of path 9 (started by run_tp through parallel/launch.py):
    loads the libraries the main process built (it never runs nvcc), makes
    the tp group over gloo, runs (a)-(e) and writes rank<r>.json (its
    errors, launch counts by run, metrics). Raises on a failed check of
    its own making, so the launcher sees the rank fail."""
    import numpy as np
    import torch
    from trtllm_llama_tpu_torch import EngineConfig, ModelConfig, QuantMode
    from trtllm_llama_tpu_torch.models import llama
    from trtllm_llama_tpu_torch.ops.kernels import _build
    from trtllm_llama_tpu_torch.ops.linear import tp_scope
    from trtllm_llama_tpu_torch.ops.registry import KERNELS as knobs
    from trtllm_llama_tpu_torch.parallel import Mapping, comm
    from trtllm_llama_tpu_torch.quantization.quantize import (
        init_random_quantized_params,
    )
    from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
    from trtllm_llama_tpu_torch.runtime.serving import ServingEngine
    from trtllm_llama_tpu_torch.runtime.session import GenerationSession

    spec = json.loads(Path(spec_path).read_text())
    missing = [n for n in _build.SOURCES if not _build._lib_path(n).exists()]
    if missing:
        raise RuntimeError(f"libraries not built: {missing} (the main "
                           "process builds them; a rank only loads)")
    torch.cuda.set_device(0)
    mapping = Mapping(tp=world)
    group, rank = mapping.make_group(backend="gloo", device="cuda")
    errors, counts, metrics = [], {}, {}
    scfg = SamplingConfig(end_id=-1)
    layers = spec["layers"]
    p1 = np.asarray(spec["p1"])
    tag = f"rank {rank}"
    print(f"{tag}: tp group of {world} over gloo on "
          f"{torch.cuda.get_device_name(0)}")

    # gloo on CUDA tensors: SUM with async_op, and MAX
    x = torch.full((4,), float(rank + 1), device="cuda")
    x, work = comm.all_reduce_sum(x, group, async_op=True)
    work.wait()
    mx = comm.all_reduce_max(torch.full((4,), float(rank), device="cuda"),
                             group)
    ok = (x.tolist() == [world * (world + 1) / 2] * 4
          and mx.tolist() == [float(world - 1)] * 4)
    print(f"{tag}: gloo all_reduce on CUDA tensors, SUM (async) "
          f"{x.tolist()} and MAX {mx.tolist()}: {'ok' if ok else 'FAIL'}")
    if not ok:
        errors.append("gloo's CUDA all_reduce gave wrong sums")

    def timed(s, ids, new):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = s.generate(ids, sampling=scfg, max_new_tokens=new)
        torch.cuda.synchronize()
        return out.output_ids, (time.perf_counter() - t) * 1e3

    def tokens_vs(name, s, prompt, got, want):
        """got against the single-device tokens: equal, or the first
        difference a near tie on this rank's replay."""
        k = first_difference_at(got, want)
        print(f"{tag} {name}: {len(got)} tokens, identical to the single "
              f"device's: {k is None}" + ("" if k is None else
                                          f" (first difference at {k})"))
        if k is not None:
            near_tie(f"{tag} {name} token {k}",
                     serving_replay(s, prompt, got[:k]), got[k], want[k],
                     errors)

    def prefill_logits(s, prompt, rows):
        with torch.inference_mode(), tp_scope(s.group):
            ids = torch.zeros((1, rows), dtype=torch.int32, device="cuda")
            ids[0, :prompt.shape[1]] = torch.as_tensor(prompt[0],
                                                       device="cuda")
            lens = torch.tensor([prompt.shape[1]], dtype=torch.int32,
                                device="cuda")
            caches = llama.init_caches(s.model_cfg, 1, rows, "cuda",
                                       s.kv_scales)
            return llama.forward_prefill(s.params, s.model_cfg, ids, lens,
                                         caches, rope=s.rope)[0]

    def task_a(s, name, fn_name, n_l, new):
        """Task A's prompt under overlap_chunks 4 and 0: tokens and
        first-token logits bit-identical, the windows counted (4 a
        row-parallel projection in the 1024-row prefill, none at 0)."""
        prompt = np.random.default_rng(0).integers(
            3, s.cfg.vocab_size, (1, TASK_A_PROMPT))
        rows = s.engine_cfg.bucket_for(TASK_A_PROMPT)
        runs = {}
        for chunks in (4, 0):
            knobs["overlap_chunks"] = chunks
            try:
                zero_counts()
                ids, ms = timed(s, prompt, new)
                c = read_counts()[0]
                logits = prefill_logits(s, prompt, rows)
            finally:
                knobs["overlap_chunks"] = 4
            runs[chunks] = (ids, logits, c, ms)
        same_ids = bool(np.array_equal(runs[4][0], runs[0][0]))
        same_logits = bool(torch.equal(runs[4][1], runs[0][1]))
        w4 = runs[4][2].get(f"{fn_name}.window_launches", 0)
        w0 = runs[0][2].get(f"{fn_name}.window_launches", 0)
        want = 2 * n_l * 4
        ok = same_ids and same_logits and w4 == want and w0 == 0
        print(f"{tag} {name}: {TASK_A_PROMPT}-token prompt ({rows} rows) + "
              f"{new - 1} decode steps, {runs[4][3]:.1f} / {runs[0][3]:.1f} "
              f"ms under overlap_chunks 4 / 0; tokens identical {same_ids}, "
              f"first-token logits bit-identical {same_logits}; windowed "
              f"launches {w4} / {w0} (expected {want}: wo and w_down, 4 "
              f"windows of {s.cfg.hidden_size // 4} columns, a layer / 0): "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            errors.append(f"{name}: overlap_chunks 4 vs 0: tokens "
                          f"{same_ids}, logits {same_logits}, windows "
                          f"{w4} / {w0}")
        return runs[4][2]

    # (a) int8, bs1 in 8 out 50
    cfg = ModelConfig.llama_7b(quant_mode=QuantMode.use_weight_only(),
                               num_layers=layers)
    params = init_random_quantized_params(cfg, seed=0, device="cuda")
    sess = GenerationSession(cfg, params, EngineConfig(**PATH_ENGINE),
                             device="cuda", mapping=mapping, group=group)
    torch.cuda.synchronize()
    print(f"{tag}: int8 shards of {layers} layers, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card "
          "(the full params too, kept for the engine of (c))")
    timed(sess, p1, 4)                                      # warm-up
    zero_counts()
    _, pre_ms = timed(sess, p1, 1)
    ids, ms = timed(sess, p1, NEW_TOKENS)
    counts["a"] = read_counts()[0]
    tokens_vs("(a) bs1 in8 out50", sess, spec["p1"][0], ids[0].tolist(),
              spec["ref_a"])
    dev_tok, ar_tok = _tp_profile(sess, p1, scfg)
    metrics.update(wall_ms_per_decode_token=(ms - pre_ms) / (NEW_TOKENS - 1),
                   prefill_ms=pre_ms, device_ms_per_decode_token=dev_tok,
                   allreduce_ms_per_decode_token=sum(ar_tok.values()),
                   allreduce_events_ms_per_decode_token=ar_tok)
    print(f"{tag} (a): prefill {pre_ms:.1f} ms, decode "
          f"{metrics['wall_ms_per_decode_token']:.1f} wall ms a token, "
          f"{dev_tok:.3f} device ms a token (profile), all-reduce events "
          f"a token {ar_tok}")

    # (b) Task A under overlap_chunks 4 and 0
    counts["b"] = task_a(sess, "(b) Task A int8", "woq_matmul_stacked",
                         layers, 1 + TASK_A_DECODE)
    del sess

    # (c) dense serving, serving's 16 requests
    eng = ServingEngine(cfg, params, EngineConfig(**SERVE_ENGINE),
                        sampling=scfg, decode_chunk=SERVE_CHUNK,
                        device="cuda", mapping=mapping, group=group)
    del params
    zero_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    rids = [eng.submit(p, SERVE_NEW) for p in spec["prompts"]]
    done = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts["c"] = read_counts()[0]
    got = [list(done[r].output_ids) for r in rids]
    same = sum(g == w for g, w in zip(got, spec["ref_c"]))
    print(f"{tag} (c) dense serving: {len(rids)} requests x {SERVE_NEW} "
          f"tokens in {wall:.2f} s ({eng.calls}); {same} of {len(rids)} "
          "token for token with the single device")
    metrics["serving_wall_s"] = wall
    for i, (g_, w_) in enumerate(zip(got, spec["ref_c"])):
        if g_ != w_:
            tokens_vs(f"(c) request {i}", eng, spec["prompts"][i], g_, w_)
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # (d) W8A8 (path 2's configuration), bs1, Task A
    sq_mode = (QuantMode.use_smooth_quant(per_token=True, per_channel=True)
               | QuantMode.INT8_KV_CACHE)
    sq = ModelConfig.llama_7b(quant_mode=sq_mode, num_layers=layers)
    params = init_random_quantized_params(sq, seed=0, device="cuda")
    sess = GenerationSession(sq, params, EngineConfig(**PATH_ENGINE),
                             kv_scales=[KV_SCALE] * layers, device="cuda",
                             mapping=mapping, group=group)
    del params
    timed(sess, p1, 2)
    zero_counts()
    ids, _ = timed(sess, p1, NEW_TOKENS)
    counts["d"] = read_counts()[0]
    tokens_vs("(d) W8A8 bs1 in8 out50", sess, spec["p1"][0],
              ids[0].tolist(), spec["ref_d"])
    dc = task_a(sess, "(d) Task A W8A8", "w8a8_matmul_stacked", layers, 2)
    for k_, v in dc.items():
        counts["d"][k_] = counts["d"].get(k_, 0) + v
    del sess

    # (e) fp8: Task A's prefill and a decode step
    f8 = ModelConfig.llama_7b(quant_mode=QuantMode.FP8_QDQ, num_layers=layers)
    params = init_random_quantized_params(f8, seed=0, device="cuda")
    sess = GenerationSession(f8, params, EngineConfig(**PATH_ENGINE),
                             device="cuda", mapping=mapping, group=group)
    del params
    timed(sess, p1, 2)
    counts["e"] = task_a(sess, "(e) Task A fp8", "fp8_matmul_stacked",
                         layers, 2)
    del sess
    gc.collect()
    torch.cuda.empty_cache()

    Path(spec["out"], f"rank{rank}.json").write_text(json.dumps(
        dict(errors=errors, counts=counts, metrics=metrics)))
    print(f"{tag}: {len(errors)} errors")


def check_kernels(errors, results):
    """Every kernel against its plain version at the shapes the paths and
    the serving phase give it."""
    check_gemv("int8", errors, results)
    check_prefill(errors, results)
    check_streaming_prefill(errors, results)
    check_prefill_vs_streaming(errors, results)
    for kv in (None, "int8", "e4m3"):
        check_decode(errors, results, kv)
        check_decode_modes(errors, results, kv)
    check_rmsnorm_quant(errors, results)
    check_w8a8(errors, results)
    for fmt in ("int4 g128", "int4 per-channel", "fp8"):
        check_gemv(fmt, errors, results)
    check_swiglu(errors, results)
    check_probes(errors, results)
    check_packed_prefill(errors, results)
    for kv in (None, "int8", "e4m3"):
        check_paged_decode(errors, results, kv)
    check_alibi_prefill(errors, results)
    check_fused_groups(errors, results)
    check_decode_table(errors, results)
    check_family_attention(errors, results)
    check_draft_attention(errors, results)
    check_float16(errors, results)
    check_windows(errors, results)
    check_accuracy_shapes(errors, results)
    check_gpt2_shapes(errors, results)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="model depth of every path (widths stay LLaMA-7B's)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on a GPU only",
              file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    if not (root / "trtllm_llama_tpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: trtllm_llama_tpu_torch not found beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    from trtllm_llama_tpu_torch.ops.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    reports = _build.build()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"({len(reports)} libraries compiled, one nvcc each, in parallel; "
          f"sm_90a)")
    for name, log in reports.items():
        print(f"  {name}: {ptxas_summary(log)}")

    errors, results = [], {"_e2e": {}, "_card": card}
    phases = [("kernels", lambda: check_kernels(errors, results))]
    phases += [(path["tag"], lambda path=path: run_path(path, args, errors,
                                                        results))
               for path in make_paths()]
    phases += [("path 7", lambda: run_offline_build(args, errors, results)),
               ("path 5", lambda: run_long_context(args, errors, results)),
               ("serving", lambda: run_serving(args, errors, results)),
               ("path 6", lambda: run_bloom(args, errors, results)),
               ("families", lambda: run_families(args, errors, results)),
               ("serving families",
                lambda: serve_families(args, errors, results)),
               (PATH9, lambda: run_tp(args, errors, results)),
               ("path 10", lambda: run_accuracy(args, errors, results)),
               ("path 11", lambda: run_gpt2(args, errors, results))]
    for name, phase in phases:
        t = time.perf_counter()
        zero_counts()
        phase()
        gc.collect()                 # free the phase's sessions and weights
        torch.cuda.empty_cache()
        print(f"phase {name}: {time.perf_counter() - t:.1f} s")
    if errors:
        print("chip_smoke FAILED:\n  " + "\n  ".join(errors), file=sys.stderr)
        return 1

    # every entry's launches were counted in this run (the probes, which
    # launch on no path, set 0 where they are checked)
    uncounted = [name for name in KERNELS if "launches" not in results[name]]
    if uncounted:
        print(f"chip_smoke FAILED: no launch count for {uncounted}",
              file=sys.stderr)
        return 1
    kernels = [dict(name=name, route="cuda", source=source, replaces=replaces,
                    **results[name])
               for name, (_, replaces, source) in KERNELS.items()]
    print(json.dumps({"end_to_end": results["_e2e"], "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
