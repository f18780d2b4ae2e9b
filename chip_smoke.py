#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py                 # everything (~5 minutes on an H100)
    python3 chip_smoke.py --kernels-only  # build + kernel phase only
    python3 chip_smoke.py --out run.json  # also write every number to JSON
    python3 chip_smoke.py --profile       # plus a traced serve of each model
                                          # and a traced step of each train
                                          # phase

Phases, each of which fails the run (exit code 1) on any error:

1. Device: needs CUDA; prints the card's name and power limit as
   ``nvidia-smi`` reports them; turns TF32 off for float32 products.
2. Build: compiles every kernel of the port from ``src/repro_torch/kernels/
   csrc`` with ``nvcc`` for ``sm_90a`` (one compiler per source, in
   parallel) and prints the build time and each kernel's registers and
   spills as ``-Xptxas -v`` reports them.
3. Kernels: each hand-written kernel against its plain PyTorch version on
   the card, in bf16 and fp32, with the tolerance stated: at every shape
   each model's serve path (decode and prefill steps), forward and train
   step give it at this script's settings (``served_cases``; zamba2's
   shared block gives flash D = 160, gemma-7b D = 256, zamba2 the SSD scan
   at d_state 64), and at larger and ragged edge cases; the backward
   kernels at every shape the train steps give them, plus S = T = 2048,
   ragged, S != T and D = 256 cases, and the SSD scan's backward at
   mamba2-780m's and zamba2-2.7b's train steps and at ragged S, h0 /
   h_final gradient, two-group and S < Q edges (RMSNorm also at
   command-r-plus-104b's 12,288 and on its looped body past 16,384 and at
   an odd width; flash at D = 160 and 256 with GQA at a ragged S, and its
   backward at D = 160 with S != T), held
   norm-wise against autograd through the plain versions (the SSD
   backward's bf16 rows also hold ddt, da and dh0, which stay fp32, at
   SSD_BWD_F32_TOL).  Kernel and
   plain times (and the library call's, where one PyTorch call computes
   the same function) are device times: 20 calls captured in one CUDA
   graph, the median of 5 replays between CUDA events.  A backward row's
   plain and library times are the backward's share: the captured
   forward + backward less the captured forward, each measured here.
   RMSNorm rows (both directions) and the flash and SSD backwards'
   train-shape rows also give a cold-L2 time (``cold_ms``): each captured
   call follows a write of 64 MB, more than the 50 MB L2, and the write's
   own captured time is subtracted.  The kernel's eager time per call from Python
   (``call_ms``) stands beside them: at the decode step's shapes that is
   the host's cost, not the device's.  Each row gives ``ms / library_ms`` (above 1: the kernel
   loses to the PyTorch call) and ``bound_ms / ms``.
4. Serve qwen3-8b: published widths and all 36 layers, bf16, random weights
   from a seeded generator, 8 greedy requests of 512 prompt tokens and 32
   new tokens through ``ContinuousBatchingEngine.generate``.  Every launch
   counter is set to 0 just before and read just after: no flash launch
   (the serve path's attention is paged, as in the reference), and
   exactly ``forward_launches`` RMSNorm launches a model call (prefill
   chunk or decode step), in this and every serve phase.
5. Forward qwen3-8b: ``lm_apply(impl="pallas")`` over 2 of the prompts
   (the flash kernel's path): exact launch counts (36 flash, 145 RMSNorm);
   the last-position logits and their argmax are held against the
   engine's own paged prefill logits for the same prompts.
6. Serve mamba2-780m: published widths and all 48 layers, bf16, seeded
   random weights, 8 greedy requests of 500 prompt tokens (a 256-token
   chunk, then a padded one of 244) and 32 new tokens, on slot-state
   pools.  Every request must finish with its tokens, every slot and
   block must come back, and the SSD counter must read 48 per prefill
   chunk.
7. Forward mamba2-780m: ``lm_apply(impl="pallas")`` over 2 of the prompts,
   one scan over 500 tokens from h0 = 0 (48 SSD and 97 RMSNorm launches),
   held against the engine's chunked prefill, which hands h0 and the conv
   buffers from one chunk to the next.
8. Train qwen3-8b: published widths at 4 layers (the serving weights are
   freed first), bf16, seeded weights; step 1's grads through the flash
   kernel and its backward (``impl="pallas"``) held per leaf against the
   grads through plain attention (``impl="xla"``) and plain RMSNorm
   (``kernels.ops.rmsnorm`` swapped for ``ref.rmsnorm_ref``, as every
   train phase's plain pass does), and both paths' grads
   reported against the same params' in fp32 and the kernels path's
   against a second run of itself; then 4 AdamW steps of
   ``make_train_step`` on ``SyntheticLM`` batches of 2 x 512 tokens: step
   time (median of steps 2-4, CUDA events), tokens/s, peak memory, the
   launches of every kernel a step (each backward kernel as often as its
   forward), losses and grad norms (finite).
9. Train mamba2-780m: published widths and all 48 layers, bf16, seeded
   weights (tied embeddings); step 1's grads through the SSD scan's
   kernels, forward and backward, held per leaf against the grads through
   the plain scan (``kernels.ops.ssd_scan`` swapped for
   ``ref.ssd_scan_ref`` here, for the check alone, and RMSNorm for its
   plain version as in phase 8; reported as in phase 8); then 4 AdamW
   steps on ``SyntheticLM``
   batches of 2 x 1024
   tokens (8 chunks of 128 a sequence): step time, tokens/s, peak memory,
   launches a step (the SSD backward once for each SSD forward, 48 a
   step), finite losses and grad norms.
10. Serve zamba2-2.7b: published widths (d 2560; 80 SSD heads of 64,
    d_state 64; the shared block over 2 x 2560 with 32 heads of 160,
    GeGLU), all 54 mamba2 layers and 9 applications of the shared block,
    bf16, seeded weights; phase 6's requests and settings and checks, on
    slot-state pools and a paged KV pool per application: 54 SSD launches
    per prefill chunk and no flash launch (the serve path's attention is
    paged, as in the reference).
11. Forward zamba2-2.7b: ``lm_apply(impl="pallas")`` over 2 of the prompts
    (9 flash at D = 160, 54 SSD and 127 RMSNorm launches), held against
    the engine's chunked prefill as in phase 7.
12. Serve gemma-7b: published widths (d 3072, 16 heads of 256, GeGLU, a
    256,000-token tied embedding), all 28 layers, bf16, seeded weights;
    phase 4's requests and settings and checks.
13. Forward gemma-7b: ``lm_apply(impl="pallas")`` over 2 of the prompts
    (28 flash at D = 256, 57 RMSNorm launches), held as in phase 5.
14. Train zamba2-2.7b: published widths and all 54 + 9 layers (2.62 B
    params; ~47 GB peak reckoned: bf16 params, grads and fp32 moments
    plus ~15 GB of activations, so no remat), ``SyntheticLM(32000, 1024,
    2)``; phase 9's grad check with plain attention and the plain scan both
    swapped in (the plain and fp32 reference passes under remat "full",
    which gives the same grads, so that the plain scan's fp32
    intermediates of 54 layers need not live at once), then 4 AdamW steps:
    flash, SSD and RMSNorm forward and backward, each as often as phase
    11 launches it, a step.

15. Serve minitron-4b: published widths (d 3072, 24 heads of 128 over 8
    KV heads, GQA ratio 3, untied 256,000-token embedding and head), all
    32 layers, bf16, seeded weights; phase 4's requests, settings and
    checks.
16. Forward minitron-4b (32 flash, 65 RMSNorm launches), held as in phase
    5.
17. Serve command-r-plus-104b: published widths (d 12,288: RMSNorm at
    12,288; 96 heads of 128 over 8, GQA ratio 12; a tied 256,000-token
    embedding) at 16 of its 64 layers (``SERVE_LAYERS``); phase 4's
    requests, settings and checks.
18. Forward command-r-plus-104b (16 flash, 33 RMSNorm), held as in phase
    5.
19. Serve deepseek-v3-671b: published widths (MLA with q / kv LoRA ranks
    1,536 / 512 on paged latent pools; 256 routed experts top-8 with
    sigmoid routing and a shared expert, all kept) at its 3 ``mla_dense``
    layers and 2 of its 58 ``mla`` layers; phase 4's requests, settings
    and checks.
20. Forward deepseek-v3-671b (0 flash: MLA's attention is a latent einsum,
    as in the reference; 21 RMSNorm, 4 a block and the final one).  A MoE
    layer's capacity C = int(1.25 K S / E) depends on the tokens of the
    call (20 at S = 512, 10 at a 256-token chunk), so the reference
    itself drops other assignments in a forward than in a chunked
    prefill: the forward is held instead against the same call with the
    kernels' plain versions patched in (``ref.rmsnorm_ref``,
    ``ref.flash_attention_ref``), at the same S, under FORWARD_REL_TOL;
    each MoE layer's top-k choices in the two runs are compared and the
    tokens whose expert set differs are reported.
21. Serve arctic-480b: published widths (56 heads of 128 over 8, GQA
    ratio 7; 128 experts top-2 with softmax routing, all kept, beside a
    dense residual FFN) at 2 of its 35 layers; phase 4's requests,
    settings and checks.
22. Forward arctic-480b (2 flash, 5 RMSNorm), held as in phase 20.
23. Train deepseek-v3-671b: published widths at 1 ``mla_dense`` layer and
    no MoE layer, plus the MTP head (3.14 B params; a MoE layer's training
    state does not fit one card), ``SyntheticLM(129280, 512, 2)``; phase
    8's grad check (the plain path's RMSNorm patched to its plain version
    too, as in every train phase: this model runs no flash and no SSD)
    and steps; the loss adds the MTP term, RMSNorm and its backward run 8
    times a step (5 in the model, 3 in the MTP head).
24. Serve whisper-medium: published widths and all 24 encoder and 24
    decoder layers (d 1,024, 16 heads of 64, LayerNorm, GELU, attention
    biases, a tied 51,865-token embedding), bf16, seeded weights; 8
    greedy requests of 384 prompt tokens (a 256-token chunk, then a
    padded one of 128) and 32 new within its 448-token decoder context,
    each with its own seeded frame embeddings (1, 1500, 1024).  phase 4's
    checks, and: the encoder runs once an admission (counted, and timed
    between CUDA events), the cross K/V are written once an admission, no
    flash and no RMSNorm launch (paged self-attention, LayerNorm), and slot 0's
    cross-K rows equal the direct projection of that request's encoder
    output (``check_cross_rows``); the same requests served without
    frontends give the TTFT without the encoder.
25. Forward whisper-medium: ``lm_apply(impl="pallas", frontend=...)`` over
    2 of the prompts and their frontends (the encoder in the forward):
    exactly 24 flash launches at D = 64 and no RMSNorm, held against the
    engine's paged prefill as in phase 5.
26. Serve llama-3.2-vision-90b: published widths (d 8,192, 64 heads of 128
    over 8, GQA ratio 8, d_ff 28,672, 128,256-token vocabulary) at 5 of
    its 20 segments (20 ``attn`` + 5 ``cross_attn`` layers,
    ``SERVE_LAYERS``), every tanh gate opened to ``GATE``, each request
    with its own seeded patch embeddings (1, 1601, 8192); phase 4's
    requests, settings and checks, 51 RMSNorm launches a step, and slot
    0's cross-K rows against the direct projection of its patches.
27. Forward llama-3.2-vision-90b (20 flash at GQA 8, 51 RMSNorm at 8,192),
    held as in phase 5.
28. Train whisper-medium whole (0.76 B params), ``SyntheticLM`` batches of
    2 x 448 decoder tokens, each with seeded frame embeddings (2, 1500,
    1024) through the encoder; phase 8's grad check and steps: flash and
    its backward 24 times a step each, no RMSNorm.

29. Sample qwen3-8b (after phase 5, on its weights): phase 4's requests at
    temperature 0.8, top_k 50, top_p 0.95, request i with the seed 100 + i
    and logprobs (``SAMPLING``): (a) two engines give the same tokens and
    logprobs bit for bit; (b) top_k = 1 at temperature 1.5 gives phase 4's
    greedy tokens, except at a step whose largest logit is tied (bf16
    logits tie often at 151,936 columns: the mask keeps every tied token
    and the draw picks one, where greedy takes the first), each tie
    recorded and any other departure a failure; (c) request 1 sampled
    among greedy requests leaves theirs equal to phase 4's; (d) a stop
    token (phase 4's third token of request 0) finishes that request with
    "stop" and gives its blocks and budget back (a token budget of one
    request's footprint admits request 1 only after it); (e) every logprob
    finite and <= 0; RMSNorm launches ``forward_launches`` a model call;
    a forced-preemption run (``PREEMPT_BLOCKS``) finishes every request
    and frees every block, each request's tokens compared to the ample
    run's (reported, not required: in bf16 a re-prefill's logits come from
    a chunked prefill, not from decode steps); tok/s, TPOT and TTFT beside
    phase 4's.
30. The sampler on the card at qwen3-8b's 151,936 columns: the threefry
    bits and uniforms on CUDA equal the CPU's over a (seed, position)
    grid; a row's token depends only on its logits, seed, position and
    params, not on its batch row or the batch size; 16,384 draws from one
    seeded logits row (T 0.8, top_k 50, top_p 0.9, positions 0 .. 16,383 in
    batches of 256) stay in the kept set, and the counts' chi-square
    against softmax(masked) (bins expecting < 5 merged) stays below its
    0.9999 quantile (scipy); one call at (4, 151,936) between CUDA events,
    stochastic and greedy, and the Gumbel draw alone.
31. Observe qwen3-8b: phase 4's requests with a ``ChromeTracer`` alone
    (TPOT beside phase 4's; the trace validated), then with the tracer,
    a ``SnapshotWriter`` every 0.05 s, the ``StepMonitor`` and a
    ``CacheSanitizer``, cancelling request 1 while it decodes and request
    7 while it is queued: both finish "cancelled" with their blocks freed,
    ``outstanding_tokens()`` drops by their budgets and reads 0 at drain,
    the sanitizer is clean, every snapshot line parses, the trace
    validates and the Prometheus text parses back to the summary.
32. Sample mamba2-780m (after phase 7): phase 6's requests in phase 29's
    form, checks (a), (b) and (e), and 48 SSD launches a prefill chunk.

The phases run in the order 1-5, 29-31, 6, 7, 32, 10-13, 15-22, 24-27
(each model's serve, then its forward, each model freed before the next),
8, 9, 14, 23, 28 (the trains, with every serving weight freed); each
phase's seconds and the total are printed before the result lines.
``--profile`` also traces a sampled serve of qwen3-8b (``profile sample
qwen3-8b``).

The last three lines of standard output are the ``{"kernels": [...]}`` JSON
line (one entry per kernel: its launches on the main path that runs it
most, every path's count under ``launches_by_path``, and the numbers of
its bf16 case at that path's most launched shape), the card line
(``gpu: <name>, <power limit>``) and
``{"ok": true, "device": {...}}``.  Without CUDA, or without the rest of the
repository beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import pathlib
import re
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core bf16
              "float32": 67e12}    # float32 outside the tensor cores
# |kernel - plain| <= atol + rtol * |plain|.  Kernel and plain version both
# compute in fp32 and differ only by summation order (~1e-6 relative).  In
# fp32 that is all; in bf16 both round that fp32 value once to 8
# significant bits, so they may land one rounding step apart, and one step
# is at most 2^-7 of the value.
TOL = {"float32": (2e-5, 1e-5), "bfloat16": (1e-5, 2.0 ** -7)}
# SSD scan: max |kernel - plain| <= SSD_REL_TOL * max |plain|, for y and for
# h_final, in both dtypes (the outputs are fp32 and both versions compute
# in fp32 from the same inputs).  Each output is a sum of up to Q + N = 256
# products plus the carried state, many times its own size, so sums in
# another order differ by ~1e-6 of the output's scale, also at outputs
# near 0, where an elementwise rtol would fail on summation order alone
# (the plain version and the JAX kernels differ by up to 4e-6 of it on the
# CPU, tests/test_torch_kernels.py).  The decays exp(cum_i - cum_j) are
# the one place where order costs more: |cum| reaches thousands at strong
# decay, so the kernel sums cum in the plain version's row order.  The
# wrong kernels of tests/test_torch_gpu.py miss this by orders of
# magnitude or go NaN.
SSD_REL_TOL = 1e-4
# forward vs the engine's chunked prefill, both bf16 end to end over all
# layers: two paths with other matmul shapes, so the logits agree only to
# bf16 rounding; max |diff| must stay under this share of max |logit|
# (qwen3-8b: about 4x the 0.0038 measured on the H100), and each
# forward's argmax must be the prefill's, or within that tolerance of its
# top logit.
FORWARD_REL_TOL = 0.015

# backward kernels: max |kernel - plain| <= tol * max |plain| for each
# gradient (the plain one is autograd through the plain forward).  In fp32
# both sum the same products in another order; in bf16 each gradient is
# rounded once at the end and its inputs (o, dO) are bf16, and gradients
# near 0 carry no relative accuracy, so the check is norm-wise.
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the SSD backward's gradients that stay fp32 in bf16 (ddt, da, dh0): the
# tensor-core body takes each fp32 factor as bf16 hi + lo (~16 significant
# bits), so they land a few 1e-6 of max |grad| from the plain scan's
# (tests/test_torch_kernels.py emulates it); a factor rounded to bf16
# once moves them by 1e-4 to 1e-3 of it.  Held norm-wise at this share,
# on top of BWD_TOL.
SSD_BWD_F32_TOL = 1e-4
# train phase: step 1's grads through the kernels vs through plain
# attention, both bf16 end to end, per param leaf, and their global norms
GRAD_COS_MIN = 0.999
GRAD_REL_L2_MAX = 2e-2
GRAD_NORM_REL_TOL = 2e-2
# leaves whose gradient is 0 in exact arithmetic: an attention's key bias
# (whisper's ``wk.b``) adds q.b to every logit of a query's row, which the
# softmax cancels, so each path's grad there is rounding noise (~4e-6 of
# the global grad norm in bf16 and ~4e-10 in fp32, measured on the CPU at
# whisper's smoke widths) and a cosine or relative L2 between two noises
# means nothing.  They are held instead to a norm of at most
# ZERO_GRAD_REL_MAX of the global grad norm, on both paths: a backward
# whose dS rows stopped summing to 0 would break it.
ZERO_GRAD_LEAF = ".wk.b"
ZERO_GRAD_REL_MAX = 1e-4

TIMED_LAUNCHES = 20                # per kernel time, after 3 warm-up launches
L2_FLUSH_BYTES = 64 << 20          # written before each call of a cold-L2 time
# phases 29 and 32: phase 4's / 6's requests sampled at these settings,
# request i with the seed SAMPLE_SEED + i
SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.95)
SAMPLE_SEED = 100
# phase 29's forced-preemption run: the 4 admitted prompts' blocks (32 of
# 16 tokens each) and 2 more, so the decode steps' growth preempts
PREEMPT_BLOCKS = 4 * 32 + 1 + 2
# phase 30: draws from one seeded logits row, in batches of DRAW_ROWS rows
# (positions 0 .. DRAWS - 1), at these settings; the counts' chi-square
# against softmax(masked) must stay below its CHI2_QUANTILE quantile (bins
# expecting fewer than CHI2_MIN_EXPECTED draws merged into one)
DRAWS, DRAW_ROWS = 16384, 256
DRAW_SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.9)
CHI2_QUANTILE, CHI2_MIN_EXPECTED = 0.9999, 5.0
SNAPSHOT_EVERY_S = 0.05            # phase 31's snapshot cadence

QWEN = "qwen3-8b"
MAMBA = "mamba2-780m"
ZAMBA = "zamba2-2.7b"
GEMMA = "gemma-7b"
MINITRON = "minitron-4b"
CMDR = "command-r-plus-104b"
DEEPSEEK = "deepseek-v3-671b"
ARCTIC = "arctic-480b"
WHISPER = "whisper-medium"
VISION = "llama-3.2-vision-90b"
# the serve cells; zamba2 takes mamba2's settings, whisper its own (its
# published decoder context is 448 tokens), every other model qwen's
_DENSE_SERVE = dict(requests=8, prompt_len=512, max_new=32, slots=4,
                    max_len=1024, block_size=16, prefill_chunk=256)
# 500 = 256 + 244: the second prefill chunk is padded
_SSM_SERVE = dict(_DENSE_SERVE, prompt_len=500)
# 384 = 256 + 128 (a padded chunk); 384 + 32 new tokens within 448
_WHISPER_SERVE = dict(_DENSE_SERVE, prompt_len=384, max_len=448)
SERVE = {QWEN: _DENSE_SERVE, MAMBA: _SSM_SERVE, ZAMBA: _SSM_SERVE,
         GEMMA: _DENSE_SERVE, MINITRON: _DENSE_SERVE, CMDR: _DENSE_SERVE,
         DEEPSEEK: _DENSE_SERVE, ARCTIC: _DENSE_SERVE,
         WHISPER: _WHISPER_SERVE, VISION: _DENSE_SERVE}
# llama-3.2-vision's tanh gates (each cross_attn block's attn.gate and
# mlp_gate) start at 0, which makes those blocks the identity: every phase
# opens them to this value, so that a fault in them shows
GATE = 0.5
# the serve cells' depth cuts: each segment's repeat (bf16, 2 bytes a
# parameter; every width, expert count and vocabulary as published).
# minitron-4b serves whole (5.1 B params, 10.2 GB). command-r-plus-104b:
# 1.573 B a layer (attention 327 M, MLP 3 x 12,288 x 33,792) and a tied
# 256,000 x 12,288 embedding (3.1 B): 16 of 64 layers, 28.3 B = 56.6 GB.
# deepseek-v3-671b: an mla layer 11.5 B (256 routed experts and 1 shared at
# 3 x 7,168 x 2,048 each, MLA 187 M), an mla_dense layer 0.58 B, untied
# embedding and head 1.85 B: its 3 mla_dense layers and 2 of its 58 mla
# layers, 27.3 B = 54.6 GB (the MTP head does not serve).  arctic-480b: a
# moe_attn layer 13.6 B (128 experts at 3 x 7,168 x 4,864, the dense
# residual FFN, attention): 2 of 35 layers, 27.5 B = 55 GB.  A depth cut
# keeps each layer's shapes: a cut in experts would change the capacity
# int(1.25 K S / E), the (E, C) buffers and the tokens each expert sees.
# llama-3.2-vision-90b: an attn or a cross_attn layer 0.856 B (attention
# 151 M at 64 heads over 8, MLP 3 x 8,192 x 28,672 = 705 M), untied
# 128,256 x 8,192 embedding and head 2.1 B: 5 of its 20 segments (4 attn
# + 1 cross_attn each), 23.5 B = 47 GB.  whisper-medium serves whole
# (0.76 B params).
SERVE_LAYERS = {CMDR: (16,), DEEPSEEK: (3, 2), ARCTIC: (2,), VISION: (5,)}
FORWARD_PROMPTS = 2                # batch of the lm_apply(impl="pallas") run
# the train phases: qwen3-8b's widths at 4 of its 36 layers (bf16 params
# and grads plus fp32 moments take 12 bytes a parameter: 98 GB at 36
# layers, 24 GB at 4); mamba2-780m whole (0.78 B params, ~12.5 GB of
# state); zamba2-2.7b whole (2.62 B params: bf16 params and grads, fp32
# moments and the step's fp32 grads ~42 GB, plus ~15 GB of activations at
# 2 x 1024 tokens, ~47 GB at the peak, so no remat); AdamW on a cosine
# schedule, SyntheticLM batches (mamba2, zamba2: 8 scan chunks of 128 a
# sequence, so the state passes between chunks).  ``check_remat``: the
# remat of the grad check's plain and fp32 passes (the plain scan keeps
# ~0.4 GB of fp32 intermediates a zamba2 layer, 23 GB over 54, and the
# fp32 pass twice that: "full" keeps one layer's at a time and gives the
# same grads)
# same grads).  deepseek-v3-671b at 1 mla_dense layer, no mla layer (an
# mla layer's 11.5 B params take ~184 GB of training state), and the MTP
# head: 3.14 B params, ~38 GB at 12 bytes a parameter plus 12.6 GB of the
# step's fp32 grads.  whisper-medium whole, its 448-token decoder context,
# a frame-embedding frontend (2, 1500, 1024) in every batch: 0.76 B params,
# ~12 GB of training state (bf16 params and grads, fp32 moments and the
# step's fp32 grads) plus ~17 GB of activations (the encoder's plain
# attention over 1,500 frames keeps ~0.45 GB of softmax a layer), ~30 GB,
# so no remat.  ``depth``: each segment's repeat (None: whole)
_TRAIN = dict(batch=2, steps=4, peak_lr=3e-4, warmup=1, total=10,
              check_remat="none", depth=None)
TRAIN = {QWEN: dict(_TRAIN, depth=(4,), seq_len=512),
         MAMBA: dict(_TRAIN, seq_len=1024),
         ZAMBA: dict(_TRAIN, seq_len=1024, check_remat="full"),
         DEEPSEEK: dict(_TRAIN, depth=(1, 0), seq_len=512),
         WHISPER: dict(_TRAIN, seq_len=448)}
KERNELS = ("rmsnorm", "rmsnorm_bwd", "flash_attention",
           "flash_attention_bwd", "ssd_scan", "ssd_scan_bwd")
# the CUDA kernels one ssd_scan call launches: the fp32 body's one, the
# bf16 body's three (chunk states, state passing, chunk outputs)
SSD_KERNELS = ("ssd_scan_kernel", "ssd_state_kernel", "ssd_pass_kernel",
               "ssd_out_kernel")
# and the four of one ssd_scan_bwd call: the bf16 body's (chunk states,
# gradients of a head slice, slice sums), the state passes both bodies
# run, then the fp32 FMA body's (chunk states, gradients of a head, group
# sums)
SSD_BWD_KERNELS = ("ssd_bwd_chunk_wgmma_kernel", "ssd_bwd_grad_wgmma_kernel",
                   "ssd_bwd_slice_sum_kernel", "ssd_bwd_pass_kernel",
                   "ssd_bwd_chunk_kernel", "ssd_bwd_grad_kernel",
                   "ssd_bwd_group_kernel")
# this repo's kernels in a trace, as ``traced`` names them
OWN_KERNELS = ("rmsnorm", "rmsnorm_bwd", "flash", "flash_bwd", "ssd_scan",
               "ssd_scan_bwd")
# cuBLAS's kernels in a trace (on Hopper most are named nvjet_*)
GEMM_NAMES = ("gemm", "gemv", "nvjet")
# the flash backward at the GQA ratios of the new paths' forwards (no
# train path runs them): the dK/dV kernel deals a group's (q head, q tile)
# items to four warpgroups, and groups of 3, 7 and 12 run there
BWD_GQA_EDGES = (MINITRON, ARCTIC, CMDR)
# RMSNorm rows past 8,192, forward and backward: command-r-plus-104b's
# d_model (12,288) on the register-held body, and the looped body at a
# vector width past the register-held 16,384 and at an odd width
NORM_WIDE_EDGES = [("edge", "command-r-plus-104b d_model", 1024, 12288),
                   ("edge", "looped: past 16,384", 256, 16392),
                   ("edge", "looped: odd width", 256, 12289)]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def call_ms(fn, iters: int) -> float:
    """Time of one eager call: ``iters`` calls issued back to back from
    Python after 3 warm-up calls, CUDA events around them.  At small shapes
    this is the rate at which the host issues calls, not device time."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_ms(fn, iters: int, replays: int = 5) -> float:
    """Device time of one call: ``iters`` calls captured in one CUDA graph
    (after 3 warm-up calls on a side stream), replayed once to warm up and
    then ``replays`` times, each between CUDA events; the median replay
    over ``iters``.  The replay takes the host's launch cost out, so a
    small kernel is timed on the device, not at Python's pace; the median
    keeps one slow replay (a clock change, a neighbour on the host) out of
    the reading."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[replays // 2]


def time_ms_cold(fn, iters: int, replays: int = 5) -> float:
    """``time_ms`` with a cold L2: each captured call follows a write of
    ``L2_FLUSH_BYTES`` (more than the H100's 50 MB L2), which evicts the
    call's inputs; the flush's own time, captured alone, is subtracted."""
    import torch
    buf = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                      device="cuda")

    def flushed():
        buf.zero_()
        fn()
    return time_ms(flushed, iters, replays) - time_ms(buf.zero_, iters,
                                                       replays)


def check_close(got, want, dtype_name):
    import torch
    atol, rtol = TOL[dtype_name]
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    ok = bool(torch.all(diff <= atol + rtol * want.float().abs()))
    if not torch.isfinite(got.float()).all():
        ok = False
    return err, ok, f"atol {atol:g} + rtol {rtol:g}*|plain|"


def _normwise(got, want, tol):
    """(max |got - want| over the outputs, whether every output is finite
    and within ``tol`` * max |want| of its plain version)."""
    import torch
    errs = [(g.float() - w.float()).abs().max() for g, w in zip(got, want)]
    ok = all(bool(torch.isfinite(g.float()).all()) and
             float(e) <= tol * float(w.float().abs().max())
             for g, w, e in zip(got, want, errs))
    return float(torch.stack(errs).max()), ok   # NaN if an output is NaN


def check_ssd(got, want):
    """The SSD scan's check: ``got`` and ``want`` are (y, h_final) pairs;
    each output's max |diff| must stay within SSD_REL_TOL of its plain
    version's max |value|, and every output must be finite."""
    err, ok = _normwise(got, want, SSD_REL_TOL)
    return err, ok, f"{SSD_REL_TOL:g}*max|plain| (y and h_final)"


def check_normwise(got, want, dtype_name):
    """A backward kernel's check: for each gradient, max |got - want| <=
    BWD_TOL * max |want|, and every gradient finite."""
    err, ok = _normwise(got, want, BWD_TOL[dtype_name])
    return err, ok, f"{BWD_TOL[dtype_name]:g}*max|plain| (each gradient)"


def check_ssd_bwd(got, want, dtype_name):
    """The SSD backward's check: ``check_normwise``, and in bf16 the
    gradients that stay fp32 (ddt, da and dh0, from the fourth on) within
    SSD_BWD_F32_TOL of max |plain| each."""
    err, ok, tol = check_normwise(got, want, dtype_name)
    if dtype_name == "bfloat16":
        ok = ok and _normwise(got[3:], want[3:], SSD_BWD_F32_TOL)[1]
        tol += f"; ddt, da, dh0 {SSD_BWD_F32_TOL:g}*max|plain|"
    return err, ok, tol


def ptxas_report(txt):
    """(kernel, registers line, spill line) for each kernel in the output
    of ``nvcc -Xptxas -v``; the kernel is its mangled name from the base
    name to the end of its template arguments
    (``rmsnorm_kernelI13__nv_bfloat16S1_Li8ELi256EE``: T, TS, VEC,
    LANES)."""
    out, kernel, spill = [], "?", ""
    for line in txt.splitlines():
        m = re.search(
            r"Compiling entry function '_Z\S*?\d+([a-z_]+kernel\S*?)'", line)
        if m:
            kernel = m.group(1)
            kernel = kernel[:kernel.find("EEv") + 1] if "EEv" in kernel \
                else kernel[:60]
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            regs = line.split(":", 1)[-1].strip()
            out.append((kernel, regs, spill))
    return out


def bound(nbytes, flops):
    """The least time for moving ``nbytes`` and doing ``flops``, a dict of
    operation counts by the type they run at, each at its peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(f / PEAK_FLOPS[t] for t, f in flops.items()) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def ssd_work(B, S, H, P, N, G, Q, dtype_name, itemsize, has_h0):
    """(bytes, flops by type) the scan must move and do: each input read
    once, each output written once; 2 flops per multiply-add over the
    causal triangle of each chunk's real rows, every product on the bf16
    tensor cores.  C.B^T depends on the group alone (decay and dt scale it
    afterwards), so it counts once per group: once with bf16 inputs (a
    product of two bf16 values summed in fp32 is exact), three times with
    fp32 ones (hi.hi + hi.lo + lo.hi of a split into bf16 hi + lo).  The
    score product, the inter-chunk term and the state update count once
    per head, each with an fp32 factor split into hi + lo: twice with bf16
    inputs, three times with fp32 ones."""
    cb = ops = 0
    for c0 in range(0, S, Q):
        q = min(Q, S - c0)
        tri = q * (q + 1) // 2
        cb += B * G * 2 * tri * N
        ops += B * H * (2 * tri * P + 4 * q * N * P)
    bf16 = dtype_name == "bfloat16"
    flops = {"bfloat16": (1 if bf16 else 3) * cb + (2 if bf16 else 3) * ops}
    nbytes = (B * S * H * P * itemsize + 2 * B * S * G * N * itemsize
              + 2 * B * S * H * 4 + B * S * H * P * 4
              + B * H * P * N * 4 * (2 if has_h0 else 1))
    return nbytes, flops


def ssd_bwd_work(B, S, H, P, N, G, Q, dtype_name, itemsize, has_h0,
                 has_dh):
    """(bytes, flops by type) of the scan's backward, counted as
    ``ssd_work`` counts the forward: each input (x, B, C, dt, a, h0, dy,
    dh_final) read once and each gradient written once; every product on
    the bf16 tensor cores, over the causal triangle of each chunk's real
    rows.  Once per group: C.B^T, and the intra terms of dB and dC (Mbar^T C
    and Mbar B, where Mbar sums the heads' dS o L diag(dt) first); per head:
    dS = dy.x^T and dx's intra term K^T dy, and five products of the
    state's size (the chunk states and the dy.C sums again, dh B_j, dh^T
    x_j, h^T dy_i; dcum's state term C_i.(h^T dy_i) reuses dC's h^T dy_i).
    A product counts once per bf16 product it takes: an fp32 factor goes
    in as hi + lo, so twice with one fp32 factor and three times (hi.hi +
    hi.lo + lo.hi) with two; with fp32 inputs every product has two.  This
    is the function's least work, not the kernel's: the bf16 body also
    takes C.h^T for dcum (2 products) and dh^T x_j with x scaled into fp32
    first (3, not 2)."""
    cb = mbar = tri_p = st = 0
    for c0 in range(0, S, Q):
        q = min(Q, S - c0)
        tri = q * (q + 1) // 2
        cb += B * G * 2 * tri * N
        mbar += B * G * 2 * (2 * tri * N)
        tri_p += B * H * 2 * tri * P
        st += B * H * 2 * q * N * P
    if dtype_name == "bfloat16":
        # dS 2, K^T dy 3; s_c 2, u_c 2, dh B_j 2, dh^T x_j 2, h^T dy_i 3
        ops = cb + 2 * mbar + 5 * tri_p + 11 * st
    else:
        ops = 3 * (cb + mbar + 2 * tri_p + 5 * st)
    flops = {"bfloat16": ops}
    state = B * H * P * N * 4
    nbytes = (2 * (B * S * H * P * itemsize + 2 * B * S * G * N * itemsize
                   + 2 * B * S * H * 4)
              + B * S * H * P * 4 + state * (2 if has_h0 else 0)
              + (state if has_dh else 0))
    return nbytes, flops


def _kinds(arch):
    return {k for seg in arch.pattern for k in seg.blocks}


def _norm_uses(arch, rows, mtp=False):
    """``(use, rows, D)`` of every RMSNorm of model ``arch`` over ``rows``
    tokens; uses at one (rows, D) are merged into one case: the block
    norms at d_model, the q/k norms once per q/kv head, MLA's q and kv
    norms at the LoRA ranks, a mamba2 block's gated norm at d_inner,
    zamba2's shared-block norms at 2 x d_model, and with ``mtp`` (the
    train step of an MTP arch) the MTP head's three norms at d_model.  A
    LayerNorm arch (whisper) has none: LayerNorm has no kernel (plain jnp
    in the reference); llama-vision's cross_attn blocks norm at d_model
    as its attn blocks do."""
    d, kinds = arch.d_model, _kinds(arch)
    uses = []
    if arch.norm == "layernorm":
        return uses
    if kinds & {"attn", "moe_attn", "cross_attn"}:
        uses.append(("norm1/norm2/final_norm", rows, d))
        if arch.qk_norm:
            uses += [("q_norm", rows * arch.n_heads, arch.head_dim),
                     ("k_norm", rows * arch.n_kv_heads, arch.head_dim)]
    if kinds & {"mla", "mla_dense"}:
        uses += [("norm1/norm2/final_norm", rows, d),
                 ("mla q_norm", rows, arch.mla.q_lora_rank),
                 ("mla kv_norm", rows, arch.mla.kv_lora_rank)]
    if "mamba2" in kinds:
        uses += [("norm/final_norm", rows, d),
                 ("gated norm", rows, arch.ssm.expand * d)]
    if "shared_attn" in kinds:
        uses.append(("shared norm1/norm2", rows, 2 * d))
    if mtp:
        uses.append(("mtp norms", rows, d))
    merged: dict = {}
    for use, r, D in uses:
        merged.setdefault((r, D), []).append(use)
    return [(", ".join(u), r, D) for (r, D), u in merged.items()]


def _attn_dims(arch):
    """(H, Hkv, D) of the attention model ``arch`` runs through flash:
    its own (``attn``, ``moe_attn`` and whisper's ``wdec`` self-attention),
    or zamba2's shared block's over 2 x d_model; None without (MLA's
    latent attention runs no flash, nor do the encoder's bidirectional and
    every cross attention, as in the reference)."""
    from repro_torch.models import blocks
    kinds = _kinds(arch)
    if not kinds & {"attn", "moe_attn", "shared_attn", "wdec"}:
        return None
    cfg = (blocks.shared_cfg_for(arch) if "shared_attn" in kinds
           else blocks.attn_cfg_for(arch))
    return cfg.n_heads, cfg.n_kv_heads, cfg.head_dim


def cut_depth(arch, depth):
    """``arch`` with each segment's repeat set to ``depth``'s (segments at
    0 dropped), or ``arch`` itself for ``depth`` None; widths unchanged."""
    import dataclasses

    from repro_torch.configs import Segment
    if depth is None:
        return arch
    pattern = tuple(Segment(seg.blocks, r)
                    for seg, r in zip(arch.pattern, depth) if r)
    return dataclasses.replace(
        arch, pattern=pattern,
        n_layers=sum(len(seg.blocks) * seg.repeat for seg in pattern))


def served_cases(name, arch):
    """The shapes each main path of model ``name`` gives the forward
    kernels at this script's settings, derived from ``SERVE[name]``,
    ``TRAIN[name]`` and the arch, plus the larger and ragged cases that
    test the kernels' edges.  RMSNorm: ``(path, use, rows, D)``
    (``_norm_uses``); flash: ``(path, B, S, T, causal, H, Hkv, D)``; SSD:
    ``(path, B, S, G, h0)``.  The serve path's decode step normalises
    ``slots`` rows, its prefill step ``prefill_chunk`` rows (a padded
    chunk, scanned from the carried state), the forward
    ``FORWARD_PROMPTS * prompt_len`` (scanned from h0 = 0), and the train
    step, where its shape differs from the forward's, ``batch x
    seq_len`` (flash and SSD)."""
    st = SERVE[name]
    tokens = {"serve decode": st["slots"], "serve prefill": st["prefill_chunk"],
              "forward": FORWARD_PROMPTS * st["prompt_len"]}
    S = st["prompt_len"]
    seqs = [(f"{name} forward", FORWARD_PROMPTS, S)]
    if name in TRAIN and (TRAIN[name]["batch"], TRAIN[name]["seq_len"]) != \
            (FORWARD_PROMPTS, S):
        seqs.append((f"{name} train", TRAIN[name]["batch"],
                     TRAIN[name]["seq_len"]))
    norm = [(f"{name} {path}", use, rr, D) for path, r in tokens.items()
            for use, rr, D in _norm_uses(arch, r)]
    flash, ssd = [], []
    dims = _attn_dims(arch)
    if dims:
        flash = [(p, B, Sq, Sq, True) + dims for p, B, Sq in seqs]
    if name == QWEN:
        norm += [("edge", "long rows", 2048, arch.d_model),
                 ("edge", "q_norm", 2048 * arch.n_heads, arch.head_dim)]
        norm += NORM_WIDE_EDGES
        flash += [c + dims for c in (
            ("edge", 1, 2048, 2048, True), ("edge", 1, 300, 300, True),
            ("edge", 1, 256, 700, True), ("edge", 1, 300, 700, False))]
    if name in (ZAMBA, GEMMA):
        # the wide heads with GQA (the paths' are MHA) at a ragged S
        flash.append(("edge", 1, 300, 300, True, 8, 4, dims[2]))
    if "mamba2" in _kinds(arch):
        G = arch.ssm.n_groups
        ssd = [(f"{name} serve prefill", 1, st["prefill_chunk"], G, True)]
        ssd += [(p, B, Sq, G, False) for p, B, Sq in seqs]
    if name == MAMBA:
        ssd += [("edge", 1, 300, G, False),         # ragged: 128 + 128 + 44
                ("edge", 1, 100, G, False),         # Q = 100 < chunk
                ("edge", 1, 256, 2, True),          # two groups, h0 != 0
                ("edge", 2, 300, 2, True)]
    return norm, flash, ssd


def ssd_inputs(torch, gen, B, S, H, P, N, G, dt_bias, dtype, has_h0):
    """The scan's inputs as the model makes them: x, B, C ~ N(0, 1) in the
    working dtype, dt = softplus(N(0, 1) + dt_bias) and a = dt·A with A =
    -(1..H) in fp32 (the init's A_log), h0 ~ N(0, 1) in fp32.  With these
    decays exp(cum_i - cum_j) overflows above the diagonal."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    x = randn(B, S, H, P).to(dtype)
    Bm = randn(B, S, G, N).to(dtype)
    Cm = randn(B, S, G, N).to(dtype)
    dt = torch.nn.functional.softplus(randn(B, S, H) + dt_bias)
    a = dt * -torch.arange(1, H + 1, device="cuda", dtype=torch.float32)
    h0 = randn(B, H, P, N) if has_h0 else None
    return x, Bm, Cm, dt, a, h0


def train_cases(name, arch):
    """The shapes model ``name``'s train phase gives the backward kernels
    (and edges), as ``served_cases`` gives them for the forward.  RMSNorm:
    ``(path, use, rows, D)`` (``_norm_uses``); flash: ``(path, B, S, T,
    H, Hkv, D, causal)``: the train step's attention, and for qwen3-8b the
    same at S = T = 2048 (where the products set the bound), a ragged S,
    S != T both ways, and gemma-7b's D = 256 (no train path runs it);
    the flash backward also at the forward paths' GQA ratios 3, 7 and 12
    (minitron-4b, arctic-480b, command-r-plus-104b heads at qwen3-8b's
    train S; ``BWD_GQA_EDGES``);
    SSD: ``(path, B, S, G, h0, dh_final)``: the train step's scan, from h0
    = 0 with no h_final gradient, and for mamba2-780m edges that take
    both, a ragged S, two groups and S < Q."""
    B, S = TRAIN[name]["batch"], TRAIN[name]["seq_len"]
    path = f"{name} train"
    norm = [(path, use, r, D)
            for use, r, D in _norm_uses(arch, B * S, mtp=arch.mtp)]
    flash, ssd = [], []
    dims = _attn_dims(arch)
    if dims:
        flash = [(path, B, S, S) + dims + (True,)]
    if name == QWEN:
        norm += [("edge", "ragged rows", 300, arch.d_model),
                 ("edge", "odd width", 37, 300)]
        norm += NORM_WIDE_EDGES
        flash += [c[:4] + dims + c[4:] for c in (
            ("edge", B, 2048, 2048, True), ("edge", 1, 300, 300, True),
            ("edge", 1, 256, 700, True), ("edge", 1, 300, 700, False))]
        from repro_torch.configs import get_arch
        for other in (GEMMA,) + BWD_GQA_EDGES:
            a = get_arch(other)
            flash.append((f"edge {other} attn", B, S, S, a.n_heads,
                          a.n_kv_heads, a.resolved_head_dim, True))
    if name == ZAMBA:
        # D = 160 with S != T, both ways of the causal mask
        flash += [("edge", 1, 256, 700) + dims + (True,),
                  ("edge", 1, 300, 700) + dims + (False,)]
    if "mamba2" in _kinds(arch):
        ssd = [(path, B, S, arch.ssm.n_groups, False, False)]
    if name == MAMBA:
        G = arch.ssm.n_groups
        ssd += [("edge", 1, 1000, G, True, True),    # ragged: 7 x 128 + 104
                ("edge", 1, 256, 2, True, False),    # two groups
                ("edge", 1, 100, G, False, True)]    # S < Q
    return norm, flash, ssd


def flash_work(B, S, Tk, H, HKV, D, causal, itemsize, backward):
    """(bytes, flops) of the forward (4 flops a pair a head dim: QK^T and
    PV) or the backward (10: S and dP recomputed, dV, dK, dQ): each input
    read once, each output written once.  Top-left causal: query i sees
    keys 0..i, so only the first min(S, T) keys are ever read."""
    pairs = (sum(min(i + 1, Tk) for i in range(S)) if causal else S * Tk)
    keys = min(S, Tk) if causal else Tk
    q, kv = B * S * H * D * itemsize, B * keys * HKV * D * itemsize
    if backward:      # q, o, dO, lse and k, v in; dq, dk, dv out
        return (4 * q + 4 * kv + B * H * S * 4, 10 * B * H * D * pairs)
    return 2 * q + 2 * kv, 4 * B * H * D * pairs


def bwd_share_ms(fwd, grad_out, iters):
    """A backward's device time: the captured forward + backward less the
    captured forward (``fwd`` returns the output and the inputs to
    differentiate; ``grad_out`` is the output's gradient)."""
    import torch

    def both():
        out, inputs = fwd()
        return torch.autograd.grad(out, inputs, grad_out)
    return time_ms(both, iters) - time_ms(fwd, iters)


def kernel_phase(torch, archs, iters):
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rmsnorm as RN

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)

    dtypes = ((torch.bfloat16, "bfloat16"), (torch.float32, "float32"))
    for name, arch in archs.items():
        norm_cases, flash_cases, ssd_cases = served_cases(name, arch)
        for path, use, R, D in norm_cases:
            for dt, dn in dtypes:
                x = randn(R, D, dtype=dt)
                scale = (1.0 + 0.1 * randn(D, dtype=torch.float32)).to(dt)
                got = RN.rmsnorm(x, scale)
                want = ref.rmsnorm_ref(x, scale)
                torch.cuda.synchronize()
                err, ok, tol = check_close(got, want, dn)
                ms = time_ms(lambda: RN.rmsnorm(x, scale), iters)
                cold = time_ms_cold(lambda: RN.rmsnorm(x, scale), iters)
                eager = call_ms(lambda: RN.rmsnorm(x, scale), iters)
                plain_ms = time_ms(lambda: ref.rmsnorm_ref(x, scale), iters)
                lib_ms = (time_ms(lambda: F.rms_norm(x, (D,), scale, 1e-6),
                                  iters) if hasattr(F, "rms_norm") else None)
                nbytes = 2 * R * D * x.element_size() \
                    + D * scale.element_size()
                flops = 4 * R * D
                rows.append(dict(
                    name="rmsnorm", path=path, use=use, shape=f"({R}, {D})",
                    dtype=dn, ok=ok, max_abs_err=err, tol=tol, ms=ms,
                    cold_ms=cold, call_ms=eager, plain_ms=plain_ms,
                    library_ms=lib_ms,
                    bytes=nbytes, flops=flops,
                    **bound(nbytes, {"float32": flops})))

        for path, B, S, Tk, causal, H, HKV, D in flash_cases:
            for dt, dn in dtypes:
                q = randn(B, S, H, D, dtype=dt)
                k = randn(B, Tk, HKV, D, dtype=dt)
                v = randn(B, Tk, HKV, D, dtype=dt)
                sc = 1.0 / D ** 0.5
                got = ops.flash_attention(q, k, v, scale=sc, causal=causal)
                want = ref.flash_attention_ref(q, k, v, scale=sc,
                                               causal=causal)
                torch.cuda.synchronize()
                err, ok, tol = check_close(got, want, dn)
                ms = time_ms(lambda: ops.flash_attention(
                    q, k, v, scale=sc, causal=causal), iters)
                eager = call_ms(lambda: ops.flash_attention(
                    q, k, v, scale=sc, causal=causal), iters)
                plain_ms = time_ms(lambda: ref.flash_attention_ref(
                    q, k, v, scale=sc, causal=causal), iters)
                qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
                lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, scale=sc, enable_gqa=True),
                    iters)
                nbytes, flops = flash_work(B, S, Tk, H, HKV, D, causal,
                                           q.element_size(), backward=False)
                rows.append(dict(
                    name="flash_attention", path=path, use="attention",
                    shape=f"B={B} S={S} T={Tk} H={H} Hkv={HKV} D={D}"
                          f"{' causal' if causal else ''}",
                    dtype=dn, ok=ok, max_abs_err=err, tol=tol, ms=ms,
                    call_ms=eager, plain_ms=plain_ms, library_ms=lib_ms,
                    bytes=nbytes, flops=flops, **bound(nbytes, {dn: flops})))

        for path, B, S, G, has_h0 in ssd_cases:
            s = arch.ssm
            H = s.expand * arch.d_model // s.head_dim
            P, N, chunk = s.head_dim, s.d_state, s.chunk
            Q = min(chunk, S)
            dt_bias = ssd_init_dt_bias(torch, gen, H)
            for dt, dn in dtypes:
                x, Bm, Cm, dtv, a, h0 = ssd_inputs(torch, gen, B, S, H, P, N,
                                                   G, dt_bias, dt, has_h0)

                def kernel():
                    return ops.ssd_scan(x, Bm, Cm, dtv, a, h0, chunk=chunk)

                def plain():
                    return ref.ssd_scan_ref(x, Bm, Cm, dtv, a, h0,
                                            chunk=chunk)
                got, want = kernel(), plain()
                torch.cuda.synchronize()
                err, ok, tol = check_ssd(got, want)
                nbytes, flops = ssd_work(B, S, H, P, N, G, Q, dn,
                                         x.element_size(), has_h0)
                rows.append(dict(
                    name="ssd_scan", path=path, use="scan",
                    shape=f"B={B} S={S} H={H} P={P} N={N} G={G} Q={Q}"
                          f"{' h0' if has_h0 else ''}",
                    dtype=dn, ok=ok, max_abs_err=err, tol=tol,
                    ms=time_ms(kernel, iters), call_ms=call_ms(kernel, iters),
                    plain_ms=time_ms(plain, iters), library_ms=None,
                    bytes=nbytes, flops=sum(flops.values()),
                    **bound(nbytes, flops)))
    for name, arch in archs.items():
        if name in TRAIN:
            rows += backward_rows(torch, name, arch, iters, gen, dtypes)
    return rows


def ssd_init_dt_bias(torch, gen, H):
    """The init's dt_bias: inverse softplus of log-uniform [1e-3, 0.1]."""
    u = torch.rand((H,), generator=gen, device="cuda")
    dt0 = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    return dt0 + torch.log(-torch.expm1(-dt0))


def ssd_backward_rows(torch, arch, cases, iters, gen, dtypes):
    """The SSD scan's backward kernel against autograd through the plain
    scan, at ``cases`` (``train_cases``).  No single PyTorch call computes
    this function (library_ms None); plain_ms is the backward's share of
    autograd through ``ref.ssd_scan_ref``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as SSD

    rows = []
    for path, B, S, G, has_h0, has_dh in cases:
        s = arch.ssm
        H = s.expand * arch.d_model // s.head_dim
        P, N, chunk = s.head_dim, s.d_state, s.chunk
        Q = min(chunk, S)
        dt_bias = ssd_init_dt_bias(torch, gen, H)
        for dt, dn in dtypes:
            x, Bm, Cm, dtv, a, h0 = ssd_inputs(torch, gen, B, S, H, P, N, G,
                                               dt_bias, dt, has_h0)
            dy = torch.randn((B, S, H, P), generator=gen, device="cuda")
            dh = (torch.randn((B, H, P, N), generator=gen, device="cuda")
                  if has_dh else None)

            def kernel():
                return SSD.ssd_scan_bwd(x, Bm, Cm, dtv, a, h0, dy, dh,
                                        chunk=chunk)
            ins = [t.clone().requires_grad_() for t in (x, Bm, Cm, dtv, a)]
            if has_h0:
                ins.append(h0.clone().requires_grad_())

            def plain():
                y, hf = ref.ssd_scan_ref(*ins[:5], ins[5] if has_h0 else None,
                                         chunk=chunk)
                return ((y, hf) if has_dh else y), ins
            grad_out = (dy, dh) if has_dh else dy
            got = [g for g in kernel() if g is not None]
            want = torch.autograd.grad(*plain(), grad_out)
            torch.cuda.synchronize()
            err, ok, tol = check_ssd_bwd(got, want, dn)
            nbytes, flops = ssd_bwd_work(B, S, H, P, N, G, Q, dn,
                                         x.element_size(), has_h0, has_dh)
            rows.append(dict(
                name="ssd_scan_bwd", path=path, use="scan",
                shape=f"B={B} S={S} H={H} P={P} N={N} G={G} Q={Q}"
                      f"{' h0' if has_h0 else ''}"
                      f"{' dh_final' if has_dh else ''}",
                dtype=dn, ok=ok, max_abs_err=err, tol=tol,
                ms=time_ms(kernel, iters),
                cold_ms=(None if path.startswith("edge")
                         else time_ms_cold(kernel, iters)),
                call_ms=call_ms(kernel, iters),
                plain_ms=bwd_share_ms(plain, grad_out, iters),
                library_ms=None, bytes=nbytes, flops=sum(flops.values()),
                **bound(nbytes, flops)))
    return rows


def backward_rows(torch, name, arch, iters, gen, dtypes):
    """The backward kernels against autograd through the plain versions,
    at ``train_cases(name, arch)``."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as RN

    rows = []

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)

    norm_cases, flash_cases, ssd_cases = train_cases(name, arch)
    for path, use, R, D in norm_cases:
        for dt, dn in dtypes:
            x, g = randn(R, D, dtype=dt), randn(R, D, dtype=dt)
            scale = (1.0 + 0.1 * randn(D, dtype=torch.float32)).to(dt)
            xr, sr = x.clone().requires_grad_(), scale.clone().requires_grad_()
            got = RN.rmsnorm_bwd(x, scale, g)
            want = torch.autograd.grad(ref.rmsnorm_ref(xr, sr), (xr, sr), g)
            torch.cuda.synchronize()
            err, ok, tol = check_normwise(got, want, dn)

            def plain():
                return ref.rmsnorm_ref(xr, sr), (xr, sr)

            def lib():
                return F.rms_norm(xr, (D,), sr, 1e-6), (xr, sr)
            nbytes = 3 * R * D * x.element_size() \
                + 2 * D * scale.element_size()
            flops = 8 * R * D
            rows.append(dict(
                name="rmsnorm_bwd", path=path, use=use, shape=f"({R}, {D})",
                dtype=dn, ok=ok, max_abs_err=err, tol=tol,
                ms=time_ms(lambda: RN.rmsnorm_bwd(x, scale, g), iters),
                cold_ms=time_ms_cold(lambda: RN.rmsnorm_bwd(x, scale, g),
                                     iters),
                call_ms=call_ms(lambda: RN.rmsnorm_bwd(x, scale, g), iters),
                plain_ms=bwd_share_ms(plain, g, iters),
                library_ms=(bwd_share_ms(lib, g, iters)
                            if hasattr(F, "rms_norm") else None),
                bytes=nbytes, flops=flops,
                **bound(nbytes, {"float32": flops})))

    for path, B, S, Tk, H, HKV, D, causal in flash_cases:
        for dt, dn in dtypes:
            # the model's layout: (B,S,H,D) tensors seen as (B,H,S,D) views
            q, do = (randn(B, S, H, D, dtype=dt).transpose(1, 2)
                     for _ in range(2))
            k, v = (randn(B, Tk, HKV, D, dtype=dt).transpose(1, 2)
                    for _ in range(2))
            sc = 1.0 / D ** 0.5
            o, lse = FA._forward(q, k, v, sc, causal, with_lse=True)

            def kernel():
                return FA.flash_attention_bwd(q, k, v, o, lse, do, scale=sc,
                                              causal=causal)
            qr, kr, vr = (t.transpose(1, 2).detach().requires_grad_()
                          for t in (q, k, v))
            got = kernel()
            want = torch.autograd.grad(ref.flash_attention_ref(
                qr, kr, vr, scale=sc, causal=causal), (qr, kr, vr),
                do.transpose(1, 2))
            torch.cuda.synchronize()
            err, ok, tol = check_normwise(
                [t.transpose(1, 2) for t in got], want, dn)

            def plain():
                return ref.flash_attention_ref(qr, kr, vr, scale=sc,
                                               causal=causal), (qr, kr, vr)
            qt, kt, vt = (t.detach().contiguous().requires_grad_()
                          for t in (q, k, v))

            def lib():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, scale=sc,
                    enable_gqa=True), (qt, kt, vt)
            nbytes, flops = flash_work(B, S, Tk, H, HKV, D, causal,
                                       q.element_size(), backward=True)
            rows.append(dict(
                name="flash_attention_bwd", path=path, use="attention",
                shape=f"B={B} S={S} T={Tk} H={H} Hkv={HKV} D={D}"
                      f"{' causal' if causal else ''}",
                dtype=dn, ok=ok, max_abs_err=err, tol=tol,
                ms=time_ms(kernel, iters),
                cold_ms=(None if path.startswith("edge")
                         else time_ms_cold(kernel, iters)),
                call_ms=call_ms(kernel, iters),
                plain_ms=bwd_share_ms(plain, do.transpose(1, 2), iters),
                library_ms=bwd_share_ms(lib, do.contiguous(), iters),
                bytes=nbytes, flops=flops, **bound(nbytes, {dn: flops})))
    return rows + ssd_backward_rows(torch, arch, ssd_cases, iters, gen,
                                    dtypes)


def _wrappers():
    """{kernel name: its wrapper, which carries the launch count}."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.kernels import ssd_scan as SSD
    return {"rmsnorm": RN.rmsnorm, "rmsnorm_bwd": RN.rmsnorm_bwd,
            "flash_attention": FA.flash_attention,
            "flash_attention_bwd": FA.flash_attention_bwd,
            "ssd_scan": SSD.ssd_scan, "ssd_scan_bwd": SSD.ssd_scan_bwd}


def reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


def block_counts(arch):
    """{block kind: its applications in one forward of the decoder}."""
    kinds = [k for seg in arch.pattern for k in seg.blocks
             for _ in range(seg.repeat)]
    return {k: kinds.count(k) for k in ("attn", "moe_attn", "mla",
                                        "mla_dense", "mamba2",
                                        "shared_attn", "cross_attn",
                                        "wdec")}


def forward_launches(arch):
    """Each forward kernel's launches in one forward under impl="pallas"
    (the whole-sequence one; a paged step's are the same): an attention
    block's (``attn``, ``moe_attn``) two norms (four with q/k norms) and
    one flash call, zamba2's shared block the same at 2 x d_model, an MLA
    block's four norms (norm1, q_norm, kv_norm, norm2) and no flash, a
    mamba2 block's two norms (the block's and the gated one) and one scan,
    a ``cross_attn`` block's two norms and no flash (its attention is
    cross attention, plain), a ``wdec`` block's one flash call (its
    self-attention), and the final norm.  A LayerNorm arch (whisper)
    launches no RMSNorm; its encoder's attention is bidirectional and
    launches no flash."""
    n = block_counts(arch)
    attn = n["attn"] + n["moe_attn"] + n["shared_attn"]
    norms = ((4 if arch.qk_norm else 2) * attn + 2 * n["cross_attn"]
             + 4 * (n["mla"] + n["mla_dense"]) + 2 * n["mamba2"] + 1)
    return {"rmsnorm": 0 if arch.norm == "layernorm" else norms,
            "flash_attention": attn + n["wdec"], "ssd_scan": n["mamba2"]}


def train_launches(arch):
    """Each kernel's launches in one train step: the forward's
    (``forward_launches``) plus, for an MTP arch, the MTP head's three
    norms (its own and its attn block's two; its attention is plain, as
    in the reference), each backward kernel as often as its forward."""
    want = forward_launches(arch)
    if arch.mtp:
        want["rmsnorm"] += 3
    want.update({f"{k}_bwd": n for k, n in want.items()})
    return want


def open_gates(params, arch):
    """Set every cross_attn block's attn.gate and mlp_gate to GATE."""
    for seg, segp in zip(arch.pattern, params["segments"]):
        for bi, kind in enumerate(seg.blocks):
            if kind == "cross_attn":
                segp[f"b{bi}"]["attn"]["gate"].fill_(GATE)
                segp[f"b{bi}"]["mlp_gate"].fill_(GATE)


def make_frontends(torch, arch, n):
    """``n`` seeded frontends (1, T, d_model) in the compute dtype: frame
    embeddings for whisper's encoder (T = 1,500), patch embeddings for
    llama-vision's cross attention (T = 1,601); [] without a frontend."""
    if not arch.frontend:
        return []
    T = arch.encoder.seq_len if arch.encoder else arch.n_img_tokens
    gen = torch.Generator(device="cuda").manual_seed(1)
    return [torch.randn((1, T, arch.d_model), generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(n)]


class Counting:
    """Counts the calls of ``module.name`` while it is entered (and, with
    ``timed``, their device time by CUDA events, in ms)."""

    def __init__(self, torch, module, name, timed=False):
        self.torch, self.module, self.name = torch, module, name
        self.timed, self.calls, self.ms = timed, 0, []

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def wrapped(*a, **k):
            self.calls += 1
            if not self.timed:
                return self.real(*a, **k)
            e0 = self.torch.cuda.Event(enable_timing=True)
            e1 = self.torch.cuda.Event(enable_timing=True)
            e0.record()
            out = self.real(*a, **k)
            e1.record()
            e1.synchronize()
            self.ms.append(e0.elapsed_time(e1))
            return out
        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def engine_kwargs(name):
    """The engine settings of model ``name``'s serve cell, on the card."""
    st = SERVE[name]
    return dict(device="cuda", slots=st["slots"], max_len=st["max_len"],
                block_size=st["block_size"],
                prefill_chunk=st["prefill_chunk"])


def serve_phase(torch, np, report, name, arch):
    from repro_torch import tree
    from repro_torch.models import transformer as T
    from repro_torch.runtime import steps as ST
    from repro_torch.serving.engine import ContinuousBatchingEngine, Request

    st = SERVE[name]
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = T.init_lm(arch, device="cuda", generator=gen)
    open_gates(params, arch)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree.leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in tree.leaves(params))
    from repro_torch.configs import get_arch
    print(f"serve: {name}, {arch.n_layers} of {get_arch(name).n_layers} "
          f"layers, d_model {arch.d_model}, {n_params / 1e9:.3f} B params "
          f"({n_bytes / 1e9:.2f} GB bf16), init "
          f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, arch.vocab, size=st["prompt_len"])
               .astype(np.int32) for _ in range(st["requests"])]
    # each request's own frontend (whisper's frames, llama-vision's patches)
    fronts = make_frontends(torch, arch, st["requests"])
    engine_kw = engine_kwargs(name)
    # warm-up engine (not timed, not counted): first cuBLAS calls
    warm = ContinuousBatchingEngine(arch, params, **engine_kw)
    warm.generate([Request(id=0, prompt=prompts[0][:16], max_new_tokens=2,
                           frontend=fronts[0] if fronts else None)])
    del warm
    torch.cuda.synchronize()

    def requests(with_frontends=True):
        return [Request(id=i, prompt=p, max_new_tokens=st["max_new"],
                        frontend=fronts[i] if fronts and with_frontends
                        else None)
                for i, p in enumerate(prompts)]
    eng = ContinuousBatchingEngine(arch, params, **engine_kw)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    # the encoder's runs (each timed between CUDA events on the stream)
    # and the cross-K/V writes, which must come once an admission
    with Counting(torch, T, "encode_frontend", timed=True) as enc, \
            Counting(torch, T, "_scatter_cross_kv") as scatter:
        t0 = time.perf_counter()
        outs = eng.generate(requests())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = read_counts()

    for o in outs:
        if o.n_tokens != st["max_new"] or o.finish_reason != "length":
            fail(f"{name} request {o.request_id}: {o.n_tokens} tokens, "
                 f"finish {o.finish_reason!r} (want {st['max_new']}, "
                 f"'length')")
        if not all(0 <= t < arch.vocab for t in o.token_ids):
            fail(f"{name} request {o.request_id}: token outside [0, vocab)")
    if eng.cache.allocator.num_used != 0:
        fail(f"{name}: {eng.cache.allocator.num_used} blocks still held "
             f"after drain")
    if any(s.busy for s in eng.slots):
        fail(f"{name}: a slot (and its slot-state row) still held after "
             f"drain")
    s = eng.metrics.summary()
    n_mamba = block_counts(arch)["mamba2"]
    calls = s["prefill_chunks"] + s["decode_steps"]   # model calls
    want_norms = forward_launches(arch)["rmsnorm"] * calls
    if counts["rmsnorm"] != want_norms:
        fail(f"{name}: {counts['rmsnorm']} RMSNorm launches on the serve "
             f"path, want {forward_launches(arch)['rmsnorm']} per step x "
             f"{calls}")
    admissions = len(outs) + s["preemptions"]
    n_cross = sum(k in ("cross_attn", "wdec") for seg in arch.pattern
                  for k in seg.blocks)
    want_enc = admissions if arch.encoder else 0
    if enc.calls != want_enc or scatter.calls != n_cross * admissions:
        fail(f"{name}: {enc.calls} encoder runs and {scatter.calls} cross-K/V "
             f"writes for {admissions} admissions (want {want_enc} and "
             f"{n_cross * admissions})")
    if counts["ssd_scan"] != n_mamba * s["prefill_chunks"]:
        fail(f"{name}: {counts['ssd_scan']} SSD launches, want {n_mamba} "
             f"per prefill chunk x {s['prefill_chunks']}")
    if counts["flash_attention"] != 0:
        fail(f"{name}: {counts['flash_attention']} flash launches on the "
             f"serve path, whose attention is paged")
    total = sum(o.n_tokens for o in outs)
    serve = dict(requests=len(outs), tokens=total, wall_s=wall,
                 tok_per_s=total / wall, ttft_p50_s=s["ttft_p50_s"],
                 ttft_max_s=s["ttft_max_s"], tpot_p50_s=s["tpot_p50_s"],
                 tpot_max_s=max(o.tpot_s for o in outs),
                 decode_steps=s["decode_steps"],
                 prefill_chunks=s["prefill_chunks"],
                 preemptions=s["preemptions"], launches=counts,
                 phases_host_s=s["phases"],
                 pool_gb=eng.cache.pool_bytes / 1e9,
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                 admissions=admissions, encoder_runs=enc.calls,
                 encoder_ms=enc.ms, cross_kv_writes=scatter.calls)
    enc_txt = ""
    if arch.encoder:
        # the same requests without frontends: TTFT without the encoder
        # (their rows zeroed at admission)
        bare = ContinuousBatchingEngine(arch, params, **engine_kw)
        bare.generate(requests(with_frontends=False))
        torch.cuda.synchronize()
        bs = bare.metrics.summary()
        serve.update(ttft_p50_no_encoder_s=bs["ttft_p50_s"],
                     ttft_max_no_encoder_s=bs["ttft_max_s"])
        med = sorted(enc.ms)[len(enc.ms) // 2]
        enc_txt = (f", encoder {enc.calls} runs for {admissions} "
                   f"admissions (median {med:.2f} ms each between CUDA "
                   f"events, the host's launch gaps included); "
                   f"TTFT p50 without frontends (no encoder) "
                   f"{bs['ttft_p50_s'] * 1e3:.1f} ms")
        del bare
    elif n_cross:
        enc_txt = f", cross-K/V written {scatter.calls} times"
    report[f"serve {name}"] = serve
    print(f"serve: {name}: {len(outs)} requests, {total} tokens in "
          f"{wall:.3f} s = {total / wall:.2f} tok/s, TTFT p50 "
          f"{s['ttft_p50_s'] * 1e3:.1f} ms, TPOT p50 "
          f"{s['tpot_p50_s'] * 1e3:.2f} ms, {s['decode_steps']} decode steps "
          f"/ {s['prefill_chunks']} prefill chunks, launches {counts}, "
          f"blocks and slots freed, cache pools {serve['pool_gb']:.2f} GB, "
          f"peak memory {serve['peak_mem_gb']:.2f} GB{enc_txt}")

    # the engine's own chunked prefill (its step, its cache, slot row 0
    # reset as admission does) for 2 prompts, without the fused sampler, to
    # get the first-token logits
    prefill = ST.make_paged_prefill_step(arch)
    admit = ST.make_slot_admit_step(arch)
    sid = (torch.tensor([0], device="cuda") if eng.cache.has_slot_state
           else None)
    ref_logits = []
    C = st["prefill_chunk"]
    for rid in range(FORWARD_PROMPTS):
        ctx = prompts[rid]
        if not eng.cache.reserve(1000 + rid, len(ctx)):
            fail("cannot reserve blocks for the reference prefill")
        admit(params, eng.cache.pools, 0, fronts[rid] if fronts else None)
        if fronts and rid == 0:
            check_cross_rows(torch, T, name, arch, params, eng.cache.pools,
                             fronts[0], report)
        table = torch.as_tensor(eng.cache.table_array([1000 + rid]),
                                device="cuda")
        for p0 in range(0, len(ctx), C):
            n = min(C, len(ctx) - p0)
            chunk = np.zeros((1, C), np.int32)   # padded, as the engine pads
            chunk[0, :n] = ctx[p0:p0 + n]
            last, _ = prefill(params, eng.cache.pools,
                              torch.as_tensor(chunk, device="cuda"),
                              torch.tensor([p0], device="cuda"), table,
                              torch.tensor([n], device="cuda"), sid)
        ref_logits.append(last[0])
        eng.cache.release(1000 + rid)
        first = int(torch.argmax(last[0, :arch.vocab]))
        if first != outs[rid].token_ids[0]:
            fail(f"{name} request {rid}: chunked prefill argmax {first} != "
                 f"the engine's first token {outs[rid].token_ids[0]}")
    return (params, prompts, fronts, torch.stack(ref_logits),
            [o.token_ids for o in outs])


def recording_sampler(np, ties):
    """A ``make_sampler`` that records, for each stochastic row it samples,
    whether the row's largest logit is shared by two or more tokens:
    ``ties[(seed, position)] = bool``."""
    from repro_torch.serving import sampling

    def make(vocab):
        sample = sampling.make_sampler(vocab)

        def recorded(logits, temperature, top_k, top_p, seeds, positions):
            if temperature is not None and np.any(temperature > 0):
                lg = logits[:, :vocab].float()
                tied = ((lg == lg.amax(-1, keepdim=True)).sum(-1) > 1)
                for sd, pos, t, tie in zip(seeds, positions.tolist(),
                                           temperature, tied.tolist()):
                    if t > 0:
                        ties[(int(sd), int(pos))] = tie
            return sample(logits, temperature, top_k, top_p, seeds,
                          positions)
        return recorded
    return make


def sample_phase(torch, np, report, name, arch, params, prompts, greedy):
    """29. / 32. Phase 4's (6's) requests sampled at ``SAMPLING``, request
    i with the seed ``SAMPLE_SEED + i`` and logprobs: (a) two engines give
    the same tokens and logprobs bit for bit; (b) top_k = 1 at temperature
    1.5 gives the greedy tokens, except where a step's largest logit is
    tied (the mask keeps every tied token and the draw picks one; greedy
    takes the first), which is recorded and reported; (e) every logprob
    finite and <= 0; the launch counts of the serve phase.  qwen3-8b also:
    (c) request 1 sampled among greedy ones leaves the others' tokens
    equal to phase 4's; (d) a stop token (phase 4's third token of request
    0) finishes it with "stop" and gives its blocks and budget back; and a
    forced-preemption run that must finish and free every block, with
    each request's tokens compared to the ample run's."""
    from unittest import mock

    from repro_torch.serving import engine as E
    from repro_torch.serving.engine import ContinuousBatchingEngine, Request
    from repro_torch.serving.sampling import SamplingParams
    from repro_torch.serving.scheduler import RequestScheduler

    st = SERVE[name]
    engine_kw = engine_kwargs(name)

    def sampled(i, **kw):
        return SamplingParams(seed=SAMPLE_SEED + i, logprobs=True,
                              **dict(SAMPLING, **kw))

    def serve(sampling, ids=None, **kw):
        eng = ContinuousBatchingEngine(arch, params, **dict(engine_kw, **kw))
        ids = range(len(prompts)) if ids is None else ids
        t0 = time.perf_counter()
        outs = eng.generate([Request(id=i, prompt=prompts[i],
                                     max_new_tokens=st["max_new"],
                                     sampling=sampling(i)) for i in ids])
        torch.cuda.synchronize()
        return eng, outs, time.perf_counter() - t0

    # warm-up (not timed, not counted): the stochastic branch's first sorts
    ContinuousBatchingEngine(arch, params, **engine_kw).generate([
        Request(id=0, prompt=prompts[0][:16], max_new_tokens=2,
                sampling=sampled(0))])
    torch.cuda.synchronize()
    reset_counts()
    eng, outs, wall = serve(sampled)
    counts = read_counts()
    _, again, _ = serve(sampled)
    for o, a in zip(outs, again):                                 # (a)
        if o.token_ids != a.token_ids or o.logprobs != a.logprobs:
            fail(f"sample {name} request {o.request_id}: two engines "
                 f"differ: {o.token_ids} vs {a.token_ids}")
    for o in outs:
        if o.n_tokens != st["max_new"] or o.finish_reason != "length" or \
                not all(0 <= t < arch.vocab for t in o.token_ids):
            fail(f"sample {name} request {o.request_id}: {o.n_tokens} "
                 f"tokens, finish {o.finish_reason!r}")
        if not all(math.isfinite(lp) and lp <= 0 for lp in o.logprobs):
            fail(f"sample {name} request {o.request_id}: logprobs not "
                 f"finite and <= 0: {o.logprobs}")                   # (e)
    if eng.cache.allocator.num_used or any(s.busy for s in eng.slots):
        fail(f"sample {name}: blocks or slots held after drain")
    s = eng.metrics.summary()
    calls = s["prefill_chunks"] + s["decode_steps"]
    want = {k: 0 for k in KERNELS}
    want.update(rmsnorm=forward_launches(arch)["rmsnorm"] * calls,
                ssd_scan=block_counts(arch)["mamba2"] * s["prefill_chunks"])
    if counts != want:                                                # (f)
        fail(f"sample {name}: launches {counts}, want {want}")
    differ = sum(o.token_ids != g for o, g in zip(outs, greedy))
    if differ == 0 and name == QWEN:
        fail(f"sample {name}: every sampled request equals its greedy one")

    ties: dict = {}
    with mock.patch.object(E, "make_sampler", recording_sampler(np, ties)):
        _, top1, _ = serve(lambda i: SamplingParams(
            temperature=1.5, top_k=1, seed=SAMPLE_SEED + i))         # (b)
    top1_diverged = []
    for i, (o, g) in enumerate(zip(top1, greedy)):
        k = next((j for j, (a, b) in enumerate(zip(o.token_ids, g))
                  if a != b), None)
        if k is None:
            continue
        pos = len(prompts[i]) + k
        if not ties.get((SAMPLE_SEED + i, pos)):
            fail(f"sample {name} request {i}: top_k = 1 leaves the greedy "
                 f"tokens at index {k} ({o.token_ids[k]} vs {g[k]}) with "
                 f"no tie at the largest logit")
        top1_diverged.append((i, k))
    n_ties = sum(ties.values())

    rep = dict(requests=len(outs), tokens=sum(o.n_tokens for o in outs),
               wall_s=wall, tok_per_s=sum(o.n_tokens for o in outs) / wall,
               ttft_p50_s=s["ttft_p50_s"], tpot_p50_s=s["tpot_p50_s"],
               decode_steps=s["decode_steps"],
               prefill_chunks=s["prefill_chunks"], launches=counts,
               phases_host_s=s["phases"], requests_unlike_greedy=differ,
               top1_steps=len(ties), top1_tied_steps=n_ties,
               top1_diverged=top1_diverged,
               logprob_min=min(lp for o in outs for lp in o.logprobs))
    extra = ""
    if name == QWEN:
        _, mixed, _ = serve(lambda i: sampled(i) if i == 1
                            else SamplingParams())                    # (c)
        for o, g in zip(mixed, greedy):
            if o.request_id != 1 and o.token_ids != g:
                fail(f"sample {name}: greedy request {o.request_id} beside "
                     f"a sampled one differs from phase 4's tokens")
        stop = greedy[0][2]                                           # (d)
        cut = greedy[0][:greedy[0].index(stop) + 1]
        sched = RequestScheduler(max_tokens_in_flight=len(prompts[0])
                                 + st["max_new"])   # one request at a time
        deng, stopped, _ = serve(
            lambda i: SamplingParams(stop_token_ids=(stop,) if i == 0
                                     else ()), ids=[0, 1], scheduler=sched)
        if stopped[0].finish_reason != "stop" or \
                stopped[0].token_ids != cut or \
                stopped[1].finish_reason != "length" or \
                deng.cache.allocator.num_used or sched._in_flight_tokens:
            fail(f"sample {name}: stop token {stop}: {stopped[0]} / "
                 f"{stopped[1].finish_reason}, blocks "
                 f"{deng.cache.allocator.num_used}, budget "
                 f"{sched._in_flight_tokens}")
        peng, tight, _ = serve(sampled, num_blocks=PREEMPT_BLOCKS)
        if any(o.n_tokens != st["max_new"] for o in tight) or \
                peng.cache.allocator.num_used or \
                peng.metrics.preemptions == 0:
            fail(f"sample {name}: forced preemption: tokens "
                 f"{[o.n_tokens for o in tight]}, blocks "
                 f"{peng.cache.allocator.num_used}, preemptions "
                 f"{peng.metrics.preemptions}")
        same = [sum(a == b for a, b in zip(o.token_ids, t.token_ids))
                for o, t in zip(outs, tight)]
        rep.update(preempt_blocks=PREEMPT_BLOCKS,
                   preemptions=peng.metrics.preemptions,
                   preempt_tokens_equal=same, stop_tokens=len(cut))
        extra = (f"; greedy rows beside a sampled one equal phase 4's; stop "
                 f"token {stop} after {len(cut)} tokens, blocks and budget "
                 f"freed; forced preemption ({PREEMPT_BLOCKS} blocks, "
                 f"{peng.metrics.preemptions} preemptions): every request "
                 f"finished, tokens equal to the ample run's by request "
                 f"{same} of {st['max_new']}")
    g = report[f"serve {name}"]
    report[f"sample {name}"] = rep
    print(f"sample: {name}: T={SAMPLING['temperature']} top_k="
          f"{SAMPLING['top_k']} top_p={SAMPLING['top_p']}: {rep['tokens']} "
          f"tokens in {wall:.3f} s = {rep['tok_per_s']:.2f} tok/s (greedy "
          f"{g['tok_per_s']:.2f}), TPOT p50 {s['tpot_p50_s'] * 1e3:.2f} ms "
          f"(greedy {g['tpot_p50_s'] * 1e3:.2f}), TTFT p50 "
          f"{s['ttft_p50_s'] * 1e3:.1f} ms (greedy "
          f"{g['ttft_p50_s'] * 1e3:.1f}); two engines equal bit for bit; "
          f"{differ} of {len(outs)} requests unlike greedy; logprobs finite, "
          f"min {rep['logprob_min']:.3f}; launches {counts}; top_k = 1 at "
          f"T = 1.5: {n_ties} of {len(ties)} steps tied at the largest "
          f"logit, requests left greedy at (request, index) "
          f"{top1_diverged}{extra}")


def sampler_phase(torch, np, report, vocab):
    """30. The sampler on the card at ``vocab``: the threefry bits and
    uniforms on CUDA equal the CPU's over a (seed, position) grid; a row's
    token depends only on its logits, seed, position and params, whatever
    its batch row or batch size; ``DRAWS`` draws from one seeded row stay
    in the kept set and their counts pass a chi-square test against
    softmax(masked) at ``CHI2_QUANTILE``; one call's time at (4, vocab)."""
    from scipy import stats

    from repro_torch.serving import threefry as TF
    from repro_torch.serving.sampling import (apply_top_k, apply_top_p,
                                              make_sampler)

    seeds = [0, 1, 12345, 2 ** 32 - 1, 7, 100]
    positions = [0, 1, 511, 2 ** 31 - 1, 16383, 123456]
    sd = torch.tensor([a for a in seeds for _ in positions])
    ps = torch.tensor([b for _ in seeds for b in positions])
    keys = TF.fold_in(TF.prng_key(sd), ps)
    keys_gpu = TF.fold_in(TF.prng_key(sd.cuda()), ps.cuda())
    if not torch.equal(TF.random_bits(keys_gpu, vocab).cpu(),
                       TF.random_bits(keys, vocab)) or not torch.equal(
            TF.uniform(keys_gpu, vocab, TF.TINY).cpu(),
            TF.uniform(keys, vocab, TF.TINY)):
        fail("sampler: threefry bits or uniforms on CUDA differ from the "
             "CPU's")

    sample = make_sampler(vocab)
    gen = torch.Generator(device="cuda").manual_seed(3)
    B = 8
    lg = 3 * torch.randn((B, vocab), generator=gen, device="cuda")
    temp = np.asarray([0.0, 0.3, 0.8, 1.5, 0.8, 1.0, 0.0, 1.2], np.float32)
    top_k = np.asarray([0, 0, 50, 0, 1, 50, 50, 0], np.int32)
    top_p = np.asarray([1.0, 0.9, 0.95, 0.3, 1.0, 0.9, 1.0, 1.0], np.float32)
    sds = np.asarray([5, 6, 7, 8, 9, 10, 11, 2 ** 32 - 1], np.uint32)
    pos = torch.tensor([0, 17, 511, 1000, 3, 2 ** 31 - 1, 9, 42],
                       device="cuda")
    full, _ = sample(lg, temp, top_k, top_p, sds, pos)
    perm = [7, 2, 5, 0, 3, 6, 1, 4]
    shuffled, _ = sample(lg[perm], temp[perm], top_k[perm], top_p[perm],
                         sds[perm], pos[perm])
    alone = [int(sample(lg[i:i + 1], temp[i:i + 1], top_k[i:i + 1],
                        top_p[i:i + 1], sds[i:i + 1], pos[i:i + 1])[0])
             for i in range(B)]
    if full[perm].tolist() != shuffled.tolist() or \
            full.tolist() != alone:
        fail(f"sampler: a row's token depends on its batch: {full.tolist()}"
             f", permuted {shuffled.tolist()}, alone {alone}")

    T, k, p = (DRAW_SAMPLING[x] for x in ("temperature", "top_k", "top_p"))
    row = 2 * torch.randn((1, vocab), generator=gen, device="cuda")
    masked = apply_top_p(apply_top_k(row / T, torch.tensor([k],
                                                           device="cuda")),
                         torch.tensor([p], device="cuda"))[0]
    kept = torch.isfinite(masked)
    probs = torch.softmax(masked.double(), -1).cpu().numpy()
    counts = np.zeros(vocab, np.int64)
    rows = row.expand(DRAW_ROWS, vocab)
    for b in range(DRAWS // DRAW_ROWS):
        tok, _ = sample(rows, np.full(DRAW_ROWS, T, np.float32),
                        np.full(DRAW_ROWS, k, np.int32),
                        np.full(DRAW_ROWS, p, np.float32),
                        np.full(DRAW_ROWS, 42, np.uint32),
                        torch.arange(b * DRAW_ROWS, (b + 1) * DRAW_ROWS,
                                     device="cuda"))
        counts += np.bincount(tok.cpu().numpy(), minlength=vocab)
    kept_np = kept.cpu().numpy()
    outside = int(counts[~kept_np].sum())
    if outside:
        fail(f"sampler: {outside} draws outside the kept set")
    expect = probs[kept_np] * DRAWS
    obs = counts[kept_np]
    small = expect < CHI2_MIN_EXPECTED
    exp_b = np.append(expect[~small], expect[small].sum())
    obs_b = np.append(obs[~small], obs[small].sum())
    if not small.any():
        exp_b, obs_b = exp_b[:-1], obs_b[:-1]
    chi2 = float(((obs_b - exp_b) ** 2 / exp_b).sum())
    df = len(exp_b) - 1
    thr = float(stats.chi2.ppf(CHI2_QUANTILE, df))
    if not chi2 < thr:
        fail(f"sampler: chi-square {chi2:.2f} >= {thr:.2f} ({df} degrees "
             f"of freedom) over {DRAWS} draws")

    lg4 = lg[:4].contiguous()
    pos4 = pos[:4]
    stoch_ms = call_ms(lambda: sample(lg4, np.full(4, 0.8, np.float32),
                                      np.full(4, 50, np.int32),
                                      np.full(4, 0.95, np.float32),
                                      sds[:4], pos4), 20)
    greedy_ms = call_ms(lambda: sample(lg4, None, None, None, None, pos4),
                        20)
    noise_ms = call_ms(lambda: TF.gumbel(torch.as_tensor(sds[:4].astype(
        np.int64), device="cuda"), pos4, vocab), 20)
    report["sampler"] = dict(vocab=vocab, bits_equal=True,
                             batch_invariant=True, draws=DRAWS,
                             kept_tokens=int(kept_np.sum()), chi2=chi2,
                             chi2_df=df, chi2_threshold=thr,
                             stochastic_call_ms=stoch_ms,
                             greedy_call_ms=greedy_ms, gumbel_call_ms=noise_ms)
    print(f"sampler: vocab {vocab}: threefry bits and uniforms on CUDA equal "
          f"the CPU's over {len(sd)} (seed, position) pairs; tokens "
          f"independent of batch row and size; {DRAWS} draws at T={T} "
          f"top_k={k} top_p={p}: all in the kept set of {int(kept_np.sum())}"
          f", chi-square {chi2:.2f} < {thr:.2f} (the {CHI2_QUANTILE} "
          f"quantile, {df} degrees of freedom); one call at (4, {vocab}) "
          f"between CUDA events: stochastic {stoch_ms:.3f} ms (the Gumbel "
          f"draw alone {noise_ms:.3f}), greedy {greedy_ms:.3f} ms")


def observe_phase(torch, np, report, name, arch, params, prompts):
    """31. Phase 4's requests with a ``ChromeTracer`` alone (TPOT beside
    phase 4's, the trace validated), then with the tracer, a
    ``SnapshotWriter`` every ``SNAPSHOT_EVERY_S`` s, the ``StepMonitor``
    and a ``CacheSanitizer`` attached, cancelling one running and one
    queued request: both finish "cancelled" and free their blocks,
    ``outstanding_tokens()`` drops by their budgets and reads 0 at drain,
    the sanitizer is clean, every snapshot line parses, the trace
    validates and the Prometheus text parses back to the summary."""
    from repro_torch.analysis.sanitizer import CacheSanitizer
    from repro_torch.serving import (ChromeTracer, ContinuousBatchingEngine,
                                     Request, SnapshotWriter,
                                     prometheus_text, validate_chrome_trace)
    from repro_torch.serving.export import parse_prometheus_text

    st = SERVE[name]
    engine_kw = engine_kwargs(name)

    def requests():
        return [Request(id=i, prompt=p, max_new_tokens=st["max_new"])
                for i, p in enumerate(prompts)]
    tracer = ChromeTracer()
    eng = ContinuousBatchingEngine(arch, params, tracer=tracer, **engine_kw)
    reset_counts()
    t0 = time.perf_counter()
    outs = eng.generate(requests())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    s = eng.metrics.summary()
    calls = s["prefill_chunks"] + s["decode_steps"]
    if counts["rmsnorm"] != forward_launches(arch)["rmsnorm"] * calls:
        fail(f"observe {name}: {counts['rmsnorm']} RMSNorm launches for "
             f"{calls} model calls")
    trace = validate_chrome_trace(tracer.to_dict())

    with tempfile.TemporaryDirectory() as d:
        snap = SnapshotWriter(pathlib.Path(d) / "snap.jsonl",
                              every_s=SNAPSHOT_EVERY_S)
        san, tr = CacheSanitizer(), ChromeTracer()
        oeng = ContinuousBatchingEngine(arch, params, tracer=tr,
                                        snapshot=snap, sanitizer=san,
                                        **engine_kw)
        for r in requests():
            oeng.submit(r)
        running, queued = 1, len(prompts) - 1
        while not any(sl.req is not None and sl.req.id == running
                      and sl.state == "decode" for sl in oeng.slots):
            oeng.step()
        if any(sl.req is not None and sl.req.id == queued
               for sl in oeng.slots):
            fail(f"observe {name}: request {queued} is not queued")
        before = oeng.outstanding_tokens()
        left = {rid: oeng._target_total(oeng._states[rid])
                - len(oeng._states[rid].req.prompt)
                - len(oeng._states[rid].out_tokens)
                for rid in (running, queued)}
        if not (oeng.cancel(running) and oeng.cancel(queued)) or \
                oeng.outstanding_tokens() != before - sum(left.values()):
            fail(f"observe {name}: cancel or outstanding_tokens wrong")
        oeng.run_until_drained()     # the sanitizer's drain check runs here
        snap.write(oeng.metrics)
        lines = [json.loads(x) for x in
                 (pathlib.Path(d) / "snap.jsonl").read_text().splitlines()]
    by_id = {o.request_id: o for o in oeng.completed}
    if by_id[running].finish_reason != "cancelled" or \
            by_id[queued].finish_reason != "cancelled" or \
            by_id[queued].token_ids or not by_id[running].token_ids or \
            oeng.cache.allocator.num_used or oeng.outstanding_tokens() or \
            len(oeng.completed) != len(prompts):
        fail(f"observe {name}: cancelled requests {by_id[running]} / "
             f"{by_id[queued]}, blocks {oeng.cache.allocator.num_used}, "
             f"outstanding {oeng.outstanding_tokens()}")
    rep_san = san.report()
    if rep_san["violations"] or not rep_san["step_checks"]:
        fail(f"observe {name}: sanitizer {rep_san}")
    otrace = validate_chrome_trace(tr.to_dict())
    os_ = oeng.metrics.summary()
    prom = parse_prometheus_text(prometheus_text(oeng.metrics))
    if float(prom["repro_serving_requests_completed_total"][0][1]) != \
            os_["completed"] or \
            float(prom["repro_serving_engine_steps_total"][0][1]) != \
            os_["engine_steps"]:
        fail(f"observe {name}: Prometheus text does not parse back to the "
             f"summary")
    g = report[f"serve {name}"]
    report[f"observe {name}"] = dict(
        wall_s=wall, tok_per_s=sum(o.n_tokens for o in outs) / wall,
        tpot_p50_s=s["tpot_p50_s"], ttft_p50_s=s["ttft_p50_s"],
        launches=counts, trace_events=trace["n_events"],
        snapshot_lines=len(lines), sanitizer=rep_san,
        cancelled_tokens=len(by_id[running].token_ids),
        step_time_ema_s=os_["window"]["step_time_ema_s"],
        observed_trace_events=otrace["n_events"])
    print(f"observe: {name}: traced serve {wall:.3f} s, TPOT p50 "
          f"{s['tpot_p50_s'] * 1e3:.2f} ms (phase 4 "
          f"{g['tpot_p50_s'] * 1e3:.2f}), TTFT p50 "
          f"{s['ttft_p50_s'] * 1e3:.1f} ms, {trace['n_events']} trace events "
          f"valid; with snapshots every {SNAPSHOT_EVERY_S} s, StepMonitor "
          f"and sanitizer: request {running} cancelled running after "
          f"{len(by_id[running].token_ids)} tokens and {queued} queued, "
          f"outstanding tokens {before} -> {before - sum(left.values())} -> "
          f"0, sanitizer clean ({rep_san['step_checks']} step checks, "
          f"{rep_san['allocs']} allocs), {len(lines)} snapshot lines parse, "
          f"{otrace['n_events']} trace events valid, Prometheus text parses "
          f"back to the summary; step-time EMA "
          f"{os_['window']['step_time_ema_s'] * 1e3:.2f} ms")


def check_cross_rows(torch, T, name, arch, params, pools, front, report):
    """Slot 0's cross-K rows in the first cross_attn / wdec layer, just
    admitted with ``front``, against the direct projection of the frontend
    (llama-vision) or of the encoder's output over it (whisper) through
    that layer's wk, under the bf16 tolerance."""
    from repro_torch.models import blocks
    from repro_torch.models import layers as L
    si, bi, kind = next((si, bi, k) for si, seg in enumerate(arch.pattern)
                        for bi, k in enumerate(seg.blocks)
                        if k in ("cross_attn", "wdec"))
    blk = params["segments"][si][f"b{bi}"]
    wk = {k: v[0] for k, v in
          blk["xattn" if kind == "wdec" else "attn"]["wk"].items()}
    src = (T.encode_frontend(params, arch, front)[0] if kind == "wdec"
           else front[0].to(T.compute_dtype(arch)))
    cfg = blocks.cross_cfg_for(arch, kind)
    want = L.dense(wk, src).reshape(-1, cfg.n_kv_heads, cfg.head_dim)
    pool = pools[si][f"b{bi}"]
    got = (pool["cross"] if kind == "wdec" else pool)["k"][0, 0]
    err, ok, tol = check_close(got, want, "bfloat16")
    report[f"cross rows {name}"] = dict(max_abs_err=err, ok=ok, tol=tol,
                                        shape=list(got.shape))
    print(f"serve: {name}: slot 0's cross-K rows {tuple(got.shape)} vs the "
          f"direct projection: max_abs_err {err:.3g} (tol {tol})")
    if not ok:
        fail(f"{name}: slot 0's cross-K rows differ from the direct "
             f"projection by {err:.4g}")


def traced(torch, label, fn):
    """Run ``fn`` once under ``torch.profiler`` -> a dict of the window's
    wall time, device busy time and share (the union of kernel intervals
    in the exported Chrome trace), device time by kernel (this repo's
    kernels by name, cuBLAS's as "gemm", the rest by their first 60
    characters; the 12 largest and every one of this repo's) and by the
    PyTorch operator that launched it, printed
    under ``label``.  Tracing adds host cost, so the
    wall time is no end-to-end number."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    trace = ROOT / "build" / f"chip_smoke_trace_{label.replace(' ', '_')}.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text()).get("traceEvents", [])
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    launches = sum(1 for e in events if e.get("cat") == "cuda_runtime"
                   and "LaunchKernel" in e.get("name", ""))
    out = dict(wall_s=wall, kernel_events=len(kernels),
               launch_calls=launches)
    if not kernels:
        out["device_busy_share"] = None      # the profiler saw no device
        print(f"profile {label}: no kernel events in the trace: device time "
              f"not measured")
        return out
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    busy, end = 0.0, None
    for a, b in spans:                       # union of kernel intervals
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    by_name: dict[str, list] = {}
    ssd_parts: dict[str, list] = {}          # the SSD call's CUDA kernels
    for e in kernels:
        n = e["name"]
        ssd = next((k for k in SSD_KERNELS + SSD_BWD_KERNELS if k in n),
                   None)
        key = ("rmsnorm_bwd" if "rmsnorm_bwd_kernel" in n
               or "rmsnorm_dscale_kernel" in n else
               "rmsnorm" if "rmsnorm_kernel" in n else
               "flash_bwd" if "flash_bwd_" in n else
               "flash" if "flash_fwd" in n else
               "ssd_scan_bwd" if ssd in SSD_BWD_KERNELS else
               "ssd_scan" if ssd else
               "gemm" if any(g in n.lower() for g in GEMM_NAMES) else
               n[:60])
        for d, k in ((by_name, key), (ssd_parts, ssd)):
            if k is not None:
                t = d.setdefault(k, [0, 0.0])
                t[0] += 1
                t[1] += e["dur"]
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    top = ranked[:12] + [kv for kv in ranked[12:] if kv[0] in OWN_KERNELS]
    # device time by the PyTorch operator that launched it (its self time:
    # what the templated elementwise kernels' names do not say)
    by_op = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0 and e.key.startswith("aten::"):
            by_op.append((e.key, e.count, us))
    by_op = sorted(by_op, key=lambda t: -t[2])[:12]
    out.update(device_busy_s=busy / 1e6, device_busy_share=busy / 1e6 / wall,
               by_kernel=[{"kernel": k, "count": c, "ms": us / 1e3}
                          for k, (c, us) in top],
               by_op=[{"op": k, "calls": c, "ms": us / 1e3}
                      for k, c, us in by_op],
               ssd_parts=[{"kernel": k, "count": c, "ms": us / 1e3}
                          for k, (c, us) in ssd_parts.items()])
    print(f"profile {label}: wall {wall * 1e3:.1f} ms, device busy "
          f"{busy / 1e3:.1f} ms ({100 * busy / 1e6 / wall:.1f}%), "
          f"{len(kernels)} kernels, {launches} launch calls")
    for k, (c, us) in top:
        print(f"  profile {label} kernel {k}: {c} launches, "
              f"{us / 1e3:.2f} ms")
    for k, (c, us) in ssd_parts.items():
        print(f"  profile {label} ssd_scan part {k}: {c} launches, "
              f"{us / 1e3:.2f} ms")
    for k, c, us in by_op:
        print(f"  profile {label} op {k}: {c} calls, {us / 1e3:.2f} ms")
    return out


def profile_phase(torch, report, name, arch, params, prompts, fronts,
                  sampling=None):
    """A traced serve of one full batch (``slots`` requests, 8 new tokens
    each): device busy share of the window and device time by kernel.  The
    untraced serve phase gives the end-to-end numbers.  With ``sampling``
    (phase 29's settings) each request samples, with the seed
    ``SAMPLE_SEED + i``, and the report is ``profile sample <name>``."""
    from repro_torch.serving.engine import ContinuousBatchingEngine, Request
    from repro_torch.serving.sampling import GREEDY, SamplingParams

    st = SERVE[name]
    eng = ContinuousBatchingEngine(arch, params, **engine_kwargs(name))
    reqs = [Request(id=i, prompt=p, max_new_tokens=8,
                    frontend=fronts[i] if fronts else None,
                    sampling=GREEDY if sampling is None else
                    SamplingParams(seed=SAMPLE_SEED + i, **sampling))
            for i, p in enumerate(prompts[:st["slots"]])]
    label = name if sampling is None else f"sample {name}"
    out = traced(torch, label, lambda: eng.generate(reqs))
    s = eng.metrics.summary()
    out.update(requests=len(reqs), decode_steps=s["decode_steps"],
               prefill_chunks=s["prefill_chunks"])
    print(f"profile {label}: traced serve of {len(reqs)} requests, "
          f"{s['decode_steps']} decode steps / {s['prefill_chunks']} prefill "
          f"chunks")
    report[f"profile {label}"] = out


def forward_phase(torch, np, report, name, arch, params, prompts, fronts,
                  ref_logits):
    """``lm_apply(impl="pallas")`` over ``FORWARD_PROMPTS`` prompts:
    exact launch counts, finite logits of the right shape, and the
    last-position logits held under FORWARD_REL_TOL against
    ``ref_logits`` (the engine's chunked prefill), or, for a MoE arch
    (``ref_logits`` None), against the same call with the kernels' plain
    versions patched in: a MoE layer's capacity depends on the tokens of
    the call, so a chunked prefill routes other assignments to the
    experts' buffers than one forward over the prompt.  Each MoE layer's
    top-k choices are recorded in both runs and the tokens whose expert
    set differs are reported (a bf16 rounding that flips a near-tied
    router score moves that token's output)."""
    from unittest import mock

    from repro_torch.kernels import ops, ref
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T

    B, S = FORWARD_PROMPTS, SERVE[name]["prompt_len"]
    tokens = torch.as_tensor(np.stack(prompts[:B]), device="cuda")
    # the requests' own frontends, batched (whisper's encoder runs in the
    # forward, llama-vision's cross attention reads the patches)
    front = torch.cat(fronts[:B]) if fronts else None
    routes = []            # per run: each MoE layer's (B, S, K) expert ids
    real_moe = MOE.moe

    def recording_moe(p, cfg, x):
        routes[-1].append(MOE.route(p, cfg, x)[2])
        return real_moe(p, cfg, x)

    def forward():
        routes.append([])
        with mock.patch.object(MOE, "moe", recording_moe):
            return T.lm_apply(params, arch, tokens, frontend=front,
                              impl="pallas")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = forward()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    want = {k: 0 for k in KERNELS}
    want.update(forward_launches(arch))
    if counts != want:
        fail(f"{name} forward launches {counts}, want {want}")
    against = "chunked prefill"
    flipped = None
    if ref_logits is None:
        against = "plain kernels"
        with mock.patch.object(ops, "rmsnorm", ref.rmsnorm_ref), \
                mock.patch.object(ops, "flash_attention",
                                  ref.flash_attention_ref):
            ref_logits = forward().logits[:, -1]
        flipped = [int((a.sort(-1).values != b.sort(-1).values).any(-1)
                       .sum()) for a, b in zip(*routes)]
    peak = torch.cuda.max_memory_allocated() / 1e9
    logits = out.logits[:, -1, :arch.vocab]
    refl = ref_logits[:, :arch.vocab]
    if out.logits.shape != (B, S, arch.padded_vocab) or \
            not torch.isfinite(out.logits).all():
        fail(f"{name} forward logits shape {tuple(out.logits.shape)} or not "
             f"finite")
    err = float((logits - refl).abs().max())
    scale = float(refl.abs().max())
    tol = FORWARD_REL_TOL * scale
    picks = [int(torch.argmax(logits[i])) for i in range(B)]
    best = [int(torch.argmax(refl[i])) for i in range(B)]
    # how far below the reference's top logit the forward's pick sits (0
    # when the two argmaxes agree)
    shortfall = [float(refl[i, best[i]] - refl[i, picks[i]]) for i in range(B)]
    report[f"forward {name}"] = dict(
        wall_s=wall, launches=counts, against=against, max_abs_err=err,
        max_abs_logit=scale, rel_tol=FORWARD_REL_TOL,
        argmax_agree=[p == b for p, b in zip(picks, best)],
        argmax_shortfall=shortfall, moe_tokens_rerouted=flipped,
        peak_mem_gb=peak)
    moe_txt = ("" if flipped is None else
               f"; tokens whose expert set differs, by MoE layer: "
               f"{flipped} of {B * S}")
    print(f"forward: {name}: lm_apply(impl='pallas') B={B} S={S} in "
          f"{wall * 1e3:.1f} ms, launches {counts}; last-position logits vs "
          f"{against}: max |diff| {err:.4g} (max |logit| {scale:.4g}, "
          f"tol {FORWARD_REL_TOL}*max = {tol:.4g}), argmax {picks} vs "
          f"{best}{moe_txt}; peak memory {peak:.2f} GB")
    if not err <= tol:
        fail(f"{name} forward logits differ from the {against} by "
             f"{err:.4g} > {tol:.4g}")
    if any(s > tol for s in shortfall):
        fail(f"{name} forward argmax {picks} != {against} argmax "
             f"{best}, and not a near tie (shortfall {shortfall} > {tol:.4g})")


def grad_diffs(torch, names, got, want):
    """-> {leaf name: (cosine, relative L2)} of grads ``got`` against
    ``want``, leaf by leaf."""
    out = {}
    for n, a, b in zip(names, got, want):
        a, b = a.float().flatten(), b.float().flatten()
        na, nb = torch.linalg.vector_norm(a), torch.linalg.vector_norm(b)
        out[n] = (float(torch.dot(a, b) / (na * nb).clamp_min(1e-30)),
                  float(torch.linalg.vector_norm(a - b) / nb.clamp_min(1e-30)))
    return out


def worst(diffs, text=False):
    """-> the leaf of ``diffs`` (``grad_diffs``) with the largest relative
    L2 and that L2, or with ``text`` the two as "L2 at leaf"."""
    n = max(diffs, key=lambda n: diffs[n][1])
    return f"{diffs[n][1]:.4g} at {n}" if text else (n, diffs[n][1])


def train_phase(torch, report, name, arch, card, profile=False):
    """Phases 8, 9, 14, 23 and 28: the training step of model ``name`` at its
    widths and ``TRAIN[name]["depth"]``, through the kernels forward and
    backward; step 1's grads held against the plain path's (plain
    attention under impl="xla", the plain SSD scan and plain RMSNorm);
    with ``profile``, one more step traced."""
    import dataclasses

    from unittest import mock

    from repro_torch import tree
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops, ref
    from repro_torch.models import transformer as T
    from repro_torch.optim import optimizers as O
    from repro_torch.optim import schedules as SC
    from repro_torch.runtime import steps as ST

    t_phase = time.perf_counter()
    cfg = TRAIN[name]
    full = arch.n_layers
    arch = cut_depth(arch, cfg["depth"])
    L = arch.n_layers
    label = f"train {arch.name}"
    gc.collect()                  # any reference cycles the serves left
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    params = T.init_lm(arch, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree.leaves(params))
    print(f"train: {arch.name} at {L} of {full} layers"
          f"{' plus the MTP head' if arch.mtp else ''}, d_model "
          f"{arch.d_model}, {n_params / 1e9:.3f} B params, init "
          f"{time.perf_counter() - t0:.1f} s; {held:.2f} GB held on the card "
          f"before it")

    def data():
        """SyntheticLM batches; an arch with a frontend gets a seeded one,
        (batch, T, d_model) in bf16, in every batch."""
        gen = torch.Generator(device="cuda").manual_seed(2)
        for batch in SyntheticLM(arch.vocab, cfg["seq_len"], cfg["batch"]):
            if arch.frontend:
                T = arch.encoder.seq_len if arch.encoder else \
                    arch.n_img_tokens
                batch["frontend"] = torch.randn(
                    (cfg["batch"], T, arch.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
            yield batch
    first = next(data())
    tok, lab = (torch.as_tensor(first[k], device="cuda")
                for k in ("tokens", "labels"))
    fe = first.get("frontend")
    # step 1's grads through the kernels (twice: how far the same path
    # moves between runs), through the plain path, and through the plain
    # path with the same params in fp32: the gradient both bf16 paths
    # approximate, so that an error of a kernel shows apart from rounding
    names = tree.names(params)
    kernel_loss = ST.make_loss_fn(arch, impl="pallas")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    loss_k, _, g_k = ST.loss_and_grads(kernel_loss, params, tok, lab, fe)
    grad_counts = read_counts()
    repeat = grad_diffs(torch, names, g_k, ST.loss_and_grads(
        kernel_loss, params, tok, lab, fe)[2])
    remat = cfg["check_remat"]
    with mock.patch.object(ops, "ssd_scan", ref.ssd_scan_ref), \
            mock.patch.object(ops, "rmsnorm", ref.rmsnorm_ref):
        loss_p, _, g_p = ST.loss_and_grads(
            ST.make_loss_fn(arch, impl="xla", remat=remat), params, tok, lab,
            fe)
        check_peak = torch.cuda.max_memory_allocated() / 1e9
        g_f = ST.loss_and_grads(
            ST.make_loss_fn(dataclasses.replace(arch, dtype="float32"),
                            impl="xla", remat=remat),
            tree.map(lambda t: t.float(), params), tok, lab,
            None if fe is None else fe.float())[2]
        fp32_peak = torch.cuda.max_memory_allocated() / 1e9
    gn_k, gn_p = float(O.global_norm(g_k)), float(O.global_norm(g_p))
    zero = {n: max(float(torch.linalg.vector_norm(g[i].float())) / gn
                   for g, gn in ((g_k, gn_k), (g_p, gn_p)))
            for i, n in enumerate(names) if n.endswith(ZERO_GRAD_LEAF)}
    diffs, k_f, p_f = ({n: d for n, d in dd.items() if n not in zero}
                       for dd in (grad_diffs(torch, names, g_k, g_p),
                                  grad_diffs(torch, names, g_k, g_f),
                                  grad_diffs(torch, names, g_p, g_f)))
    bad = [f"{n}: cos {c:.6f}, rel L2 {r:.3g}" for n, (c, r) in diffs.items()
           if not (c >= GRAD_COS_MIN and r <= GRAD_REL_L2_MAX)]
    bad += [f"{n}: |grad| {z:.3g} of the global norm (its gradient is 0 in "
            f"exact arithmetic)" for n, z in zero.items()
            if not z <= ZERO_GRAD_REL_MAX]
    cos_leaf = min(diffs, key=lambda n: diffs[n][0])
    rel_leaf, rel = worst(diffs)
    i = names.index(rel_leaf)     # that leaf layer by layer, if stacked
    by_layer = ([float(torch.linalg.vector_norm((a - b).float())
                       / torch.linalg.vector_norm(b.float()))
                 for a, b in zip(g_k[i], g_p[i])]
                if rel_leaf.startswith("segments.") else None)
    zero_txt = ("" if not zero else
                f"; key biases (grad 0 in exact arithmetic, held apart): "
                f"largest |grad| {max(zero.values()):.3g} of the global norm "
                f"(max {ZERO_GRAD_REL_MAX:g})")
    del g_k, g_p, g_f
    torch.cuda.empty_cache()
    after_check = torch.cuda.memory_allocated() / 1e9
    print(f"train: step 1's grads, kernels forward and backward vs the plain "
          f"path (plain attention, SSD scan and RMSNorm): {len(names)} "
          f"leaves over "
          f"{L} layers, worst cosine {diffs[cos_leaf][0]:.6f} at {cos_leaf} "
          f"(min {GRAD_COS_MIN}), worst rel L2 {rel:.4g} at {rel_leaf} (max "
          f"{GRAD_REL_L2_MAX}); against the fp32 model's grads, worst rel "
          f"L2 of the kernels {worst(k_f, text=True)}, of the plain path "
          f"{worst(p_f, text=True)}, at {rel_leaf} "
          f"{k_f[rel_leaf][1]:.4g} and {p_f[rel_leaf][1]:.4g}; the kernels "
          f"path against itself: worst rel L2 {worst(repeat, text=True)}; "
          f"grad norm {gn_k:.6g} vs "
          f"{gn_p:.6g}; loss {float(loss_k):.6f} vs {float(loss_p):.6f}; "
          f"launches {grad_counts}; reference passes under remat "
          f"{remat!r}; peak memory of the check {check_peak:.2f} GB "
          f"({fp32_peak:.2f} GB with the fp32 pass), {after_check:.2f} GB "
          f"held after it{zero_txt}")
    if bad:
        fail(f"{label}: kernel grads differ from the plain path's: {bad}")
    if not (math.isfinite(gn_k) and math.isfinite(float(loss_k))):
        fail(f"{label}: step 1's grad norm {gn_k} / loss {float(loss_k)} "
             f"not finite")
    if not abs(gn_k - gn_p) <= GRAD_NORM_REL_TOL * gn_p:
        fail(f"{label}: grad norm {gn_k} vs plain {gn_p}")

    opt = O.adamw(SC.cosine_schedule(cfg["peak_lr"], cfg["warmup"],
                                     cfg["total"]))
    state = opt[0](params)
    step = ST.make_train_step(arch, opt, impl="pallas")
    batches = data()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated() / 1e9    # params, moments, the rest
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    marks, metrics = [], []
    for _ in range(cfg["steps"]):
        batch = next(batches)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        params, state, m = step(params, state, batch)
        e1.record()
        marks.append((e0, e1))
        metrics.append(m)
    torch.cuda.synchronize()
    counts = read_counts()
    step_ms = [a.elapsed_time(b) for a, b in marks]
    med = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    tokens = cfg["batch"] * cfg["seq_len"]
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    per_step = {k: c / cfg["steps"] for k, c in counts.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    report[label] = dict(
        layers=L, params=n_params, tokens_per_step=tokens, step_ms=step_ms,
        step_ms_median=med, tok_per_s=tokens / med * 1e3, peak_mem_gb=peak,
        mem_before_steps_gb=base,
        launches=counts, launches_per_step=per_step, losses=losses,
        grad_norms=norms, grad_check=dict(
            worst_cos=diffs[cos_leaf][0], worst_cos_leaf=cos_leaf,
            worst_rel_l2=rel, worst_rel_l2_leaf=rel_leaf,
            worst_leaf_rel_l2_by_layer=by_layer,
            **{f"rel_l2_{k}": {n: r for n, (_, r) in d.items()}
               for k, d in (("plain", diffs), ("kernels_fp32", k_f),
                            ("plain_fp32", p_f), ("repeat", repeat))},
            grad_norm_kernels=gn_k, grad_norm_plain=gn_p,
            reference_remat=remat, peak_mem_gb=check_peak,
            peak_mem_fp32_gb=fp32_peak, zero_grad_leaves=zero))
    print(f"train: {arch.name} {L} layers, {cfg['steps']} AdamW steps of "
          f"{cfg['batch']} x {cfg['seq_len']} tokens: step "
          f"{', '.join(f'{t:.2f}' for t in step_ms)} ms, median of steps "
          f"2-{cfg['steps']} {med:.2f} ms = {tokens / med * 1e3:.0f} "
          f"tok/s, peak memory {peak:.2f} GB ({base:.2f} GB before the "
          f"steps) on {card}; losses "
          f"{[round(x, 5) for x in losses]}, grad norms "
          f"{[round(x, 5) for x in norms]}; launches a step {per_step}")
    if not all(math.isfinite(x) for x in losses + norms):
        fail(f"{label}: losses {losses} / grad norms {norms} not finite")
    want = train_launches(arch)
    for c, per in ((counts, cfg["steps"]), (grad_counts, 1)):
        if any(c[k] != n * per for k, n in want.items()):
            fail(f"{label}: launches {c}, want {want} a step")
    if profile:
        batch = next(batches)

        def one_step():
            nonlocal params, state
            params, state, _ = step(params, state, batch)
        report[f"profile {label}"] = traced(torch, label, one_step)
    report[label]["phase_s"] = time.perf_counter() - t_phase
    del params, state


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="build and check the kernels, skip serve/forward")
    ap.add_argument("--out", default=None,
                    help="also write every measured number to this JSON")
    ap.add_argument("--profile", action="store_true",
                    help="after each forward phase, trace one more serve, "
                         "and after the train steps one more step, with "
                         "torch.profiler (device busy share, time by "
                         "kernel)")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the "
             f"repository")
    sys.path.insert(0, str(SRC))

    # 1. device
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)} ({card}), torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}; TF32 off for "
          f"float32 matmul and cuDNN")

    # 2. build
    from repro_torch.kernels import build
    rep = build.build()
    print(f"build: {len(build.SOURCES)} libraries in {rep['seconds']:.1f} s "
          f"-> {build.BUILD_DIR}")
    for name, txt in rep["ptxas"].items():
        for kernel, regs, spill in ptxas_report(txt):
            print(f"  ptxas {name}: {kernel}: {regs}; {spill}")
        for line in txt.splitlines():      # warnings and ptxas advisories
            if "warning" in line.lower() or re.search(r"\(C7\d{3}\)", line):
                print(f"  ptxas {name}: {line.strip()}")

    from repro_torch.configs import get_arch
    archs = {n: get_arch(n) for n in SERVE}
    report = {"card": card, "build_s": rep["seconds"]}
    seconds = {"build": rep["seconds"]}             # each phase's
    # 3. kernels vs their plain versions
    t0 = time.perf_counter()
    rows = kernel_phase(torch, archs, TIMED_LAUNCHES)
    report["kernel_cases"] = rows
    report["kernel_phase_s"] = time.perf_counter() - t0
    for r in rows:
        # ms / library_ms (above 1: slower than the PyTorch call) and the
        # share of the bound reached, bound_ms / ms
        r["library_ratio"] = (None if r["library_ms"] is None
                              else r["ms"] / r["library_ms"])
        r["bound_share"] = r["bound_ms"] / r["ms"]
        cold = r.get("cold_ms")
        r["cold_bound_share"] = None if cold is None else r["bound_ms"] / cold
        cold_txt = ("" if cold is None else
                    f", cold L2 {cold:.4f} ms "
                    f"({100 * r['cold_bound_share']:.1f}% of the bound)")
        lib = ("n/a" if r["library_ms"] is None else
               f"{r['library_ms']:.4f} ms (kernel/library "
               f"{r['library_ratio']:.2f}x)")
        print(f"kernel {r['name']} [{r['path']}: {r['use']}] {r['shape']} "
              f"{r['dtype']}: {'ok' if r['ok'] else 'MISMATCH'} max_abs_err "
              f"{r['max_abs_err']:.3g} (tol {r['tol']}), {r['ms']:.4f} ms"
              f"{cold_txt} (eager call {r['call_ms']:.4f} ms), plain "
              f"{r['plain_ms']:.4f} ms, library {lib}, bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']}, "
              f"{100 * r['bound_share']:.1f}% of it)")
    seconds["kernels"] = report["kernel_phase_s"]
    print(f"kernels: {len(rows)} cases in {report['kernel_phase_s']:.1f} s")
    bad = [f"{r['name']} {r['shape']} {r['dtype']}" for r in rows
           if not r["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")

    # launches on each main path, each counted from 0 around its own run
    paths = [f"{p} {n}" for n in archs for p in ("serve", "forward")]
    paths += [f"sample {QWEN}", f"observe {QWEN}", f"sample {MAMBA}"]
    paths += [f"train {n}" for n in TRAIN]
    by_path = {p: {k: 0 for k in KERNELS} for p in paths}

    def timed(label, fn, *a, **kw):
        t = time.perf_counter()
        out = fn(*a, **kw)
        seconds[label] = time.perf_counter() - t
        print(f"{label}: phase done in {seconds[label]:.1f} s")
        return out
    if not args.kernels_only:
        for name, arch in archs.items():
            # 4./6./10./12./15./17./19./21./24./26. serve, 5./7./11./13./
            # 16./18./20./22./25./27. forward, at the serve cell's depth
            arch = cut_depth(arch, SERVE_LAYERS.get(name))
            params, prompts, fronts, ref_logits, greedy = timed(
                f"serve {name}", serve_phase, torch, np, report, name, arch)
            timed(f"forward {name}", forward_phase, torch, np, report, name,
                  arch, params, prompts, fronts,
                  None if arch.moe else ref_logits)
            if name in (QWEN, MAMBA):
                # 29./32. sampled serves; 30. the sampler; 31. observed
                timed(f"sample {name}", sample_phase, torch, np, report,
                      name, arch, params, prompts, greedy)
            if name == QWEN:
                timed("sampler", sampler_phase, torch, np, report,
                      arch.vocab)
                timed(f"observe {name}", observe_phase, torch, np, report,
                      name, arch, params, prompts)
            if args.profile:
                timed(f"profile {name}", profile_phase, torch, report, name,
                      arch, params, prompts, fronts)
                if name == QWEN:
                    timed(f"profile sample {name}", profile_phase, torch,
                          report, name, arch, params, prompts, fronts,
                          sampling=SAMPLING)
            del params, fronts, ref_logits
            gc.collect()
            torch.cuda.empty_cache()
        # 8./9./14./23./28. train, with the serving weights freed
        for name in TRAIN:
            timed(f"train {name}", train_phase, torch, report, name,
                  archs[name], card, profile=args.profile)
            gc.collect()
            torch.cuda.empty_cache()
        by_path = {p: report[p]["launches"] for p in paths}

    # one entry per kernel, on the main path that runs it most: its
    # numbers are the bf16 case of that path with the most launches (the
    # qwen decode step's (slots, d_model) norms; the qwen forward's
    # attention; the mamba2 prefill chunk's scan; the qwen train step's
    # (tokens, d_model) norms and attention and the mamba2 train step's
    # scan for the backward kernels), its
    # launches that path's count, and every path's count beside it.  The
    # backward kernels have no TPU twin (the reference trains through plain
    # jnp): "replaces" names the TPU kernel whose gradient they compute.
    headline = {
        "rmsnorm": (f"serve {QWEN}", f"{QWEN} serve decode",
                    "norm1/norm2/final_norm"),
        "rmsnorm_bwd": (f"train {QWEN}", f"{QWEN} train",
                        "norm1/norm2/final_norm"),
        "flash_attention": (f"forward {QWEN}", f"{QWEN} forward",
                            "attention"),
        "flash_attention_bwd": (f"train {QWEN}", f"{QWEN} train",
                                "attention"),
        "ssd_scan": (f"serve {MAMBA}", f"{MAMBA} serve prefill", "scan"),
        "ssd_scan_bwd": (f"train {MAMBA}", f"{MAMBA} train", "scan")}
    replaces = {"rmsnorm": "src/repro/kernels/rmsnorm.py:20",
                "rmsnorm_bwd": "src/repro/kernels/rmsnorm.py:20",
                "flash_attention": "src/repro/kernels/flash_attention.py:77",
                "flash_attention_bwd":
                    "src/repro/kernels/flash_attention.py:77",
                "ssd_scan": "src/repro/kernels/ssd_scan.py:71",
                "ssd_scan_bwd": "src/repro/kernels/ssd_scan.py:71"}
    sources = {"rmsnorm_bwd": "rmsnorm"}
    kernels = []
    for name, (path, case_path, use) in headline.items():
        r = next(r for r in rows if r["name"] == name and r["path"] ==
                 case_path and r["use"] == use and r["dtype"] == "bfloat16")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/"
                      f"{sources.get(name, name)}.cu",
            "replaces": replaces[name], "launches": by_path[path][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "cold_ms": r.get("cold_ms"), "call_ms": r["call_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "library_ratio": r["library_ratio"],
            "bound_share": r["bound_share"], "path": path,
            "shape": r["shape"], "dtype": r["dtype"], "tol": r["tol"],
            "launches_by_path": {p: c[name] for p, c in by_path.items()}})
    report["kernels"] = kernels
    seconds["total"] = time.perf_counter() - t_start
    report["seconds"] = seconds
    print("seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(f"gpu: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
