#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py                 # everything (~13 minutes on an H100)
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
   backward at D = 160 with S != T; flash forward and backward,
   bidirectional, at the paper's ViTs' train shapes, ``VISION_FLASH``, and
   in fp32 at the split-TF32 bodies' edges, ``TF32_FLASH_EDGES``; and at
   the shapes 2 tensor-parallel ranks give them, ``tp_rows``: the
   split-row RMSNorm, forward and backward, at zamba2-2.7b's and
   mamba2-780m's (rows, d_inner / 2), the SSD scan and its backward at
   40 of 80 and 24 of 48 heads, flash forward and backward at zamba2's
   16 of 32 heads of 160 and whisper-medium's 8 of 16 of 64), held
   norm-wise against autograd through the plain versions (the SSD
   backward's bf16 rows also hold ddt, da and dh0, which stay fp32, at
   SSD_BWD_F32_TOL).  Kernel and
   plain times (and the library call's, where one PyTorch call computes
   the same function) are device times: 10 calls captured in one CUDA
   graph, the median of 5 replays between CUDA events, for the bf16
   rows (``TIMED_DTYPES``); the fp32 rows are checked, not timed.  A backward row's
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
6. Serve mamba2-780m: published widths at 12 of its 48 layers
   (``SERVE_LAYERS``), bf16, seeded
   random weights, 8 greedy requests of 500 prompt tokens (a 256-token
   chunk, then a padded one of 244) and 32 new tokens, on slot-state
   pools.  Every request must finish with its tokens, every slot and
   block must come back, and the SSD counter must read 12 per prefill
   chunk.
7. Forward mamba2-780m: ``lm_apply(impl="pallas")`` over 2 of the prompts,
   one scan over 500 tokens from h0 = 0 (12 SSD and 25 RMSNorm launches),
   held against the engine's chunked prefill, which hands h0 and the conv
   buffers from one chunk to the next.
8. Train qwen3-8b: published widths at 2 layers (the serving weights are
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
9. Train mamba2-780m: published widths at 12 of its 48 layers, bf16, seeded
   weights (tied embeddings); step 1's grads through the SSD scan's
   kernels, forward and backward, held per leaf against the grads through
   the plain scan (``kernels.ops.ssd_scan`` swapped for
   ``ref.ssd_scan_ref`` here, for the check alone, and RMSNorm for its
   plain version as in phase 8; reported as in phase 8); then 4 AdamW
   steps on ``SyntheticLM``
   batches of 2 x 1024
   tokens (8 chunks of 128 a sequence): step time, tokens/s, peak memory,
   launches a step (the SSD backward once for each SSD forward, 12 a
   step), finite losses and grad norms.
10. Serve zamba2-2.7b: published widths (d 2560; 80 SSD heads of 64,
    d_state 64; the shared block over 2 x 2560 with 32 heads of 160,
    GeGLU), 2 of its 9 pattern repeats (12 mamba2 layers and 2
    applications of the shared block, ``SERVE_LAYERS``),
    bf16, seeded weights; phase 6's requests and settings and checks, on
    slot-state pools and a paged KV pool per application: 12 SSD launches
    per prefill chunk and no flash launch (the serve path's attention is
    paged, as in the reference).
11. Forward zamba2-2.7b: ``lm_apply(impl="pallas")`` over 2 of the prompts
    (2 flash at D = 160, 12 SSD and 29 RMSNorm launches), held against
    the engine's chunked prefill as in phase 7.
12. Serve gemma-7b: published widths (d 3072, 16 heads of 256, GeGLU, a
    256,000-token tied embedding), 7 of its 28 layers, bf16, seeded
    weights; phase 4's requests and settings and checks.
13. Forward gemma-7b: ``lm_apply(impl="pallas")`` over 2 of the prompts
    (7 flash at D = 256, 15 RMSNorm launches), held as in phase 5.
14. Train zamba2-2.7b: published widths at 2 of its 9 pattern repeats
    (12 + 2 layers; the whole model, 2.62 B params, fits at ~47 GB
    without remat), ``SyntheticLM(32000, 1024,
    2)``; phase 9's grad check with plain attention and the plain scan both
    swapped in (the plain and fp32 reference passes under remat "full",
    which gives the same grads, so that the plain scan's fp32
    intermediates of every layer need not live at once), then 4 AdamW steps:
    flash, SSD and RMSNorm forward and backward, each as often as phase
    11 launches it, a step.

15. Serve minitron-4b: published widths (d 3072, 24 heads of 128 over 8
    KV heads, GQA ratio 3, untied 256,000-token embedding and head), 8 of
    its 32 layers, bf16, seeded weights; phase 4's requests, settings and
    checks.
16. Forward minitron-4b (8 flash, 17 RMSNorm launches), held as in phase
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
24. Serve whisper-medium: published widths, all 24 encoder layers and 6
    of its 24 decoder layers (``SERVE_LAYERS``; d 1,024, 16 heads of 64, LayerNorm, GELU, attention
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
    exactly 6 flash launches at D = 64 and no RMSNorm, held against the
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

29. Sample qwen3-8b (after phase 5; this phase, 31 and 38 run qwen3-8b at
    9 of its 36 layers, ``QWEN_CUT_LAYERS``, and stand beside
    ``QWEN_CUT``, phase 4's requests, settings and checks at that depth,
    served first, whose greedy tokens they read as "phase 4's" below;
    depth only, for the script's time): phase 4's requests at
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
    form, checks (a), (b) and (e), and 12 SSD launches a prefill chunk.

33. Plan: ``AdaptiveScheduler(H100_SXM)`` (the port's H100 profile) plans
    qwen3-8b at phase 8's 2 layers and shape on a 1 x 1 mesh, and the
    whole model on (1, 1), which must come out infeasible (its training
    state is ~150 GB), (16, 16) and (2, 16, 16) (host-only planning);
    the DP / MP / HP baselines; ``ComponentProfiler`` times the
    embedding, one attn mixer, one MLP and the head forward and backward
    between CUDA events, ``calibrate`` takes measured / predicted per
    component, and the re-planned step time stands beside phase 8's.
34. Trainer qwen3-8b: ``runtime.trainer.Trainer`` on a 1 x 1
    ``DeviceMesh`` over a world-1 NCCL group (params and moments
    DTensors, the sharded step's gathers and reductions, as on many
    ranks) trains qwen3-8b at full width and phase 8's depth, bf16,
    impl="pallas", ``TrainConfig(lr=3e-4, warmup_steps=1,
    total_steps=10, checkpoint_every=4)``, 6 steps of phase 8's batches
    (one checkpoint, at step 4, for the script's time),
    deterministic algorithms on: every step launches phase 8's kernels
    (``train_launches``); median of steps 2-6 beside phase 8's; peak
    memory, the checkpoint's bytes, snapshot and write seconds (into a
    temporary directory, removed after; depth is cut, never width, if
    the disk lacks room); a fresh Trainer restores step 4 and every leaf
    equals the checkpoint's bits, and replays steps 5-6 to the same
    losses and params (an op without a deterministic CUDA form would be
    named and the replay held at 1e-6 relative); then ``python -m
    repro_torch.launch.train --arch qwen3-8b --smoke --steps 8
    --checkpoint-dir ...`` twice, the second resuming from the manifest.
35. Train ViT-B on CIFAR-100's widths (``models.vision``, ``ViTConfig()``:
    65 tokens, 12 heads of 64), ``SyntheticImages(100, 32, 256)``, seeded
    weights, fp32: step 1's loss and per-leaf grads through the flash
    kernel (bidirectional) against the plain flash, as in phase 8; the
    logits of 8 images against the CPU forward (``VISION_LOGIT_TOL``);
    6 AdamW steps of the reference demo's step (``examples.
    paper_repro_asa.make_image_step``): median of 2-6, peak memory, 12
    flash forward and 12 backward launches a step; the same in bf16.
36. Train ResNet-50 with its CIFAR stem at 256 images, fp32: the logits
    of 8 images against the CPU forward, step 1's loss and grads finite,
    6 AdamW steps; it launches no kernel of the repo's (library
    convolutions and BatchNorm: the reference has no Pallas kernel
    there).
37. The paper: ``examples.paper_repro``'s Table I, Fig 3 and Fig 6 for
    both models; the reference demo's reduced ViT trained 150 steps on the
    card (accuracy past 0.5 at the last step, 4 + 4 flash launches a
    step); ViT-B/16 at 224 (197 tokens) at 64 images, fp32 and bf16,
    beside ``_gpu_step``'s prediction at ``H100_SXM``; ``ComponentProfiler``
    measured / predicted for the embedding, one attention, one MLP and
    the head (bf16).

38. Placed serve qwen3-8b (after phase 31, on ``QWEN_CUT``'s weights):
    phase 4's requests and settings through ``ContinuousBatchingEngine``
    on a 1 x 1 ``DeviceMesh`` over a world-1 NCCL group
    (``make_host_mesh``): the ASA plan printed; every param and pool leaf
    a DTensor on that mesh (the params wrapped without a copy); tokens
    bit-equal to phase 4's; ``forward_launches`` RMSNorm launches a model
    call and no flash launch; tok/s, TTFT and TPOT beside phase 4's and
    the unplaced engine's once more after it (unplaced, placed, unplaced).
39. Cluster qwen3-8b (after qwen3-8b's weights are freed): ``python -m
    repro_torch.launch.serve_cluster --arch qwen3-8b --replicas 2`` at
    phase 4's settings as a subprocess, both replicas whole on the one
    card (round robin): the boot time; /healthz 200 with both live; each
    worker's boot line names a CUDA device; phase 4's 8 requests as
    concurrent HTTP posts, half streamed by SSE, each with phase 4's
    tokens; /metrics parses, 2 replicas live, the replicas' generated
    tokens sum to the tokens received, and each replica's RMSNorm
    launches (its ``repro_serving_kernel_launches_total``, counted from 0
    in the fresh worker) are ``forward_launches`` a model call, with no
    flash launch; one request streamed with a stop string from its own
    greedy output (``"t<id> "``) ends "stop", trimmed at the match;
    SIGTERM: ``workers exited with [0, 0]``, exit 0, no worker left;
    aggregate tok/s and each request's TTFT and TPOT beside phase 4's.

40. Tensor parallelism, zamba2-2.7b: published widths at 2 of its 9
    pattern repeats (2 applications of the shared block, 12 mamba2
    layers), two processes on the one card on a (data 1, model 2) mesh
    over gloo (NCCL refuses two ranks on one device; ``tp_rank``) under
    the uniform MP plan (``uniform_scheduler``): each rank runs 40 of the
    80 SSD heads, 16 of the shared block's 32 attention heads and half its
    d_ff, and the gated norms through the split-row RMSNorm.  Step 1's
    loss, grad norm and every gradient, gathered whole, held against the
    unplaced single-process step on the same weights and batch
    (``SyntheticLM(32000, 1024, 2)``, bf16, impl="pallas") at phase 14's
    tolerances (the loss at ``TP_LOSS_REL_TOL``); each rank's x_proj
    working tensor 2,560 of 5,120 columns and its scans 40 heads; 4 steps
    of the Trainer's step: their times, each rank's exact launches a step
    (phase 14's at this depth, the 12 gated norms split), its
    all-reduces and weight gathers; then, in fp32, the engine placed on
    the mesh serves the first 4 of phase 10's requests
    (``TP_SERVE_REQUESTS``): its tokens equal the unplaced
    engine's (rank 0, same depth) on every rank, each prefill call's
    logits within ``TP_LOGIT_TOL`` of max |logit|, every block on its own
    heads (``tp_shared_block``, ``tp_mamba2_block``), its launches
    ``forward_launches``' with the gated norms split.

41. Tensor and expert parallelism, deepseek-v3-671b, on phase 40's mesh
    and plan: each rank runs 64 of the 128 MLA heads (the q latent
    all-gathered before q_norm, the latents whole on both), half of each
    MLP's d_ff, the MTP head's projection by columns and its block by
    heads, and 128 of the 256 experts.  Train (``TP_MOE_TRAIN``: 1
    ``mla_dense`` layer and the MTP head, phase 23's cut, bf16,
    ``SyntheticLM(129280, 1024, 2)``): step 1 against the unplaced step
    as phase 40's, exact launches (8 RMSNorm forward and 8 backward a
    step), the all-reduces and weight gathers of 2 steps.  Serve
    (``TP_MOE_SERVE``: 1 ``mla_dense`` + 1 ``mla`` layer with all 256
    experts, fp32, weights drawn matrix by matrix from ``TP_MOE_SEED``
    (``seeded_params``: each rank draws only its shards; the unplaced
    engine, rank 0's alone, runs and frees its 55.8 GB before the ranks
    place theirs; the MTP head, which serving never reads, left out), 2
    requests of 128 prompt tokens, 8 new, chunk 128):
    tokens equal the unplaced engine's, prefill logits within
    ``TP_LOGIT_TOL``, 9 RMSNorm launches a model call, every block
    ``tp_mla_block``, and the latent pools bit-equal across the ranks.
    Contiguous (``tp_decode``, ``TP_DECODE_NAME``): the serve's weights
    and 2 prompts through the dry run's serving function, every block
    ``tp_mla_block`` on a contiguous cache placed by the plan's
    ``cache_specs`` (the latents split over `model` along time, gathered
    around each attention), one prefill and ``TP_DECODE_STEPS`` greedy
    decode steps: tokens equal rank 0's unplaced contiguous steps' (run
    on the whole weights before they are freed), logits within
    ``TP_LOGIT_TOL``, the gathered latent caches bit-equal across the
    ranks, 9 RMSNorm launches a call.  EP-major (``tp_ep_train``,
    ``TP_EP_NAME``, ``TP_EP_TRAIN``): deepseek at 1 ``mla_dense`` + 1
    ``mla`` layer, all 256 experts (the MTP head left out for memory),
    bf16, run first, on a (data 2, model 1) mesh of the same processes
    under the uniform HP plan with
    the EP-major specs (``moe_ep_axis("data")``: 128 experts a rank),
    each rank its own sequence of ``SyntheticLM(129280, 512, 2)``: step
    1's loss and gradients (``steps.sharded_loss_and_grads``, no
    optimizer: the layer's AdamW state does not fit) against rank 0's
    unplaced step, run first and freed (the loss within
    ``TP_LOSS_REL_TOL``, the grad norm within ``GRAD_NORM_REL_TOL``,
    every non-expert leaf's and a sample of both ranges' experts'
    gradients at phase 40's tolerances), exactly 4 all-to-alls (a MoE
    layer's dispatch and return, forward and backward) of E * C * D
    bf16 each, 9 RMSNorm launches forward and 9 backward; the peak
    memory a rank.

42. HP on a multi-pod mesh, mamba2-780m (``POD_TRAIN``: published
    widths, 2 of its 48 layers, bf16, ``SyntheticLM(50280, 1024, 4)``,
    one sequence a rank): four processes on the one card over gloo on a
    (pod 2, data 2, model 1) mesh from ``init_device_mesh`` (``pod_rank``)
    under the uniform HP plan with int8 moments.  Every rank's shard of
    every param (at init) and of every int8-moment array (after the
    steps) is the block that its spec gives the rank's coordinates, the
    reference's way (``spec_block``: HP's ``("data", "pod")`` and the
    moments' ``("data", "model", "pod")`` lay pod out strided).  Step 1
    against the unplaced step as phase 40's; 3 steps of the Trainer's
    step (the int8-moment branch: every leaf gathered whole by
    ``sharded.gather_full``): times, exact RMSNorm (the gated norms split,
    the plan lays mamba2 out over a `model` axis of one rank) and SSD
    launches forward and backward, all-reduces and all-gathers with their
    MB, peak memory; a checkpoint saved and restored bit-equal; a
    ``Trainer.resize`` onto (data 4, model 1) keeping every value;
    ``compressed_allreduce`` of each rank's own step-1 gradient over the
    pod group (the error-feedback identity exactly, the mean within half
    a quantum of the exact mean).

43. tracecheck on the card (``tracecheck_phase``): the five analyzers of
    ``repro_torch.analysis.tracecheck`` over qwen3-8b (all 36 layers) and
    mamba2-780m (all 48) at published widths, bf16.  Each serving step
    (prefill chunk, decode step, slot admission) runs once under
    ``analysis/ircost.py``'s recorders at the reference's geometry, under
    ``set_sync_debug_mode("error")``: no finding; the pools updated in
    place; 0 host syncs (the sanctioned host-to-device copies of the
    sampler's rows counted apart); exact RMSNorm and SSD launches
    (``_step_launches``); the counted FLOPs and bytes equal to the CPU's
    count of the same step (under FakeTensorMode, shapes only) and within
    ``predict_serving_step``'s tolerances; the reference's mixed workload
    through a real engine on its tight pool, one argument signature a
    step kind, with a preemption, and launches each step's.  The sharding
    analyzer in a process of its own (``trace_sharding_rank``): qwen3-8b's
    pools on the reference's (data 4, model 2) mesh over a fake process
    group of 8 ranks on the card; a refused group, a finding or any
    error in that process fails the run.  Each analyzer's seconds, the
    counts against the prediction and the temp bytes beside the pools'
    are printed.

44. Contiguous decode (``decode_phase``), right after each model's
    forward on its weights: qwen3-8b (all 36 layers) and mamba2-780m (12
    of 48), bf16, ``impl="pallas"``, 2 of phase 4's / 6's prompts
    (``DECODE``: 512 / 500 tokens), a contiguous cache of 1024 rows
    (``transformer.init_cache``), one ``make_prefill_step`` call, then 32
    greedy ``make_decode_step`` calls.  (a) Each step's logits against
    one ``lm_apply`` forward without a cache over the prompt and the
    tokens so far, within FORWARD_REL_TOL of max |logit|; (b) the same
    steps, fed the same tokens, with the plain RMSNorm and SSD scan
    patched in, within the same bound; (c) exact launches a step: the
    prefill and every decode step ``forward_launches`` RMSNorm, the
    prefill one SSD scan a mamba2 layer and a decode step none, no flash
    (the reference attends plainly over a cache); (d) the greedy tokens
    against phase 4's / 6's paged tokens (printed, with the first
    divergence; bf16 rounds a 64-token chunked prefill otherwise than one
    prefill, so it does not fail).  The prefill's ms and the decode's
    tok/s (CUDA events) are printed beside the paged serve's.

45. Dry run (``dryrun_start``, ``dryrun_phase``): ``python -m
    repro_torch.launch.dryrun`` in child processes, each cell on a fake
    process group of 256 ranks with fake CUDA tensors (``DRYRUN_CELLS``:
    qwen3-8b x train_4k and x decode_32k, mamba2-780m x long_500k, 16 x
    16), all three at once, started before the build and read after it:
    every cell ``ok``, its counted FLOPs, bytes and kernel calls equal to
    the CPU's (``DRYRUN_CPU_COST``, which the CPU tests hold to the CPU's
    count); memory and collectives printed.  A fourth process, started
    with them, runs deepseek-v3-671b x decode_32k ``--moe-ep``
    (``DRYRUN_EP_CELL``, all 61 layers; it traces for minutes, so it is
    read after phase 46, ``dryrun_ep_phase``): ``ok``, its all-to-alls
    2 a MoE layer (116), each E * B_l * C * D bf16 values (the specs'
    count), its trace seconds, memory, cost and collectives printed.  The
    dry run drives no kernel and no device work: it has no launch
    count.

46. The examples' twins (``examples_phase``):
    ``repro_torch.examples.serve_lm`` (the legacy ``Server`` shim, then
    ``--share-prefix``: a hit rate above 0), ``serve_continuous`` (every
    request finished, every token streamed, logprobs on the sampled
    ones), ``serve_hybrid_archs`` (zamba2 and whisper, frontends on every
    other request) and ``adaptive_switch`` (the plans before and after
    calibration; the Trainer on a world-1 NCCL mesh re-planning at steps
    20, 40 and 60 with losses bit-equal, under deterministic algorithms,
    to the same Trainer's with ``replan_every=0``), on the card.

The phases run in the order 1-5, 44, ``QWEN_CUT``, 29-31, 38, 39, 6, 7,
44, 32,
10-13, 15-22,
24-27 (each model's serve, then its forward, each model freed before the
next; 39 once qwen3-8b's weights are freed), 8, 9, 14, 23, 28 (the
trains, with every serving weight freed), 33, 34, 35, 36, 37, 40, 41,
42, 43, then 46 while 45's processes trace, then 45's ``--moe-ep`` cell
read; each
phase's seconds and the total are printed before the result lines.
Cut for the script's time (depth and repetitions, never a check): the
serve and train depths (``SERVE_LAYERS``, ``TRAIN``, ``QWEN_CUT``,
``POD_TRAIN``), phase 41's 2 timed steps and phase 42's 3, the fp32
kernel rows checked, not timed (``TIMED_DTYPES``), phase 40's placed
serve at 4 of phase 10's 8 requests (``TP_SERVE_REQUESTS``), phase 34's
one checkpoint (at step 4 of 6, where it saved at 3 and 6), and phase
45's ``--moe-ep`` cell read after phase 46, beside the card's phases.  ``--profile`` also traces a sampled serve of qwen3-8b
(``profile sample qwen3-8b``) and one more step of each of phases 35-37's
timed runs.

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
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# each kernel's bound: ``repro_torch.kernels.work`` (the bytes it must move
# over the H100 SXM's 3.35 TB/s, its operations over the peak of their type)
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

TIMED_LAUNCHES = 10                # per kernel time, after 3 warm-up launches
# the dtypes whose kernel rows are timed; the fp32 rows are checked at
# every shape, not timed, for the script's time (their times: PERF.md's
# table, from the PRs that built the fp32 bodies)
TIMED_DTYPES = ("bfloat16",)
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
# phase 39: the serving cluster's replicas (each holds the whole model on
# the one card), the seconds its launcher may take to report ready (each
# worker starts torch, draws 8.2 B params and plans), and an HTTP
# request's timeout
CLUSTER_REPLICAS = 2
CLUSTER_BOOT_S = 300
CLUSTER_REQUEST_S = 300

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
# qwen3-8b serves whole: phase 39's cluster serves the launcher's model,
# whole, and must give phase 4's tokens.  mamba2-780m at 12 of its 48
# layers, zamba2-2.7b at 2 of its 9 pattern repeats (2 applications of the
# shared block, 12 mamba2 layers), gemma-7b at 7 of 28 and minitron-4b at
# 8 of 32: depth only, for the script's time (a serve phase's time is the
# host's launching of eager ops, which grows with depth; phase 43 runs
# mamba2-780m whole).  command-r-plus-104b:
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
# + 1 cross_attn each), 23.5 B = 47 GB.  whisper-medium at 6 of its 24
# decoder layers, its encoder whole (24 layers)
# (0.76 B params).
SERVE_LAYERS = {MAMBA: (12,), ZAMBA: (2,), GEMMA: (7,), MINITRON: (8,),
                CMDR: (16,), DEEPSEEK: (3, 2), ARCTIC: (2,), VISION: (5,),
                WHISPER: (6,)}
# phases 29, 31 and 38 serve qwen3-8b at 9 of its 36 layers, held against
# the greedy tokens of a serve at that depth (``QWEN_CUT``, phase 4's
# requests, settings and checks); phase 4 and phase 39 serve it whole
QWEN_CUT_LAYERS = (9,)
QWEN_CUT = f"serve {QWEN} ({QWEN_CUT_LAYERS[0]} layers)"
FORWARD_PROMPTS = 2                # batch of the lm_apply(impl="pallas") run
# the train phases: qwen3-8b's widths at 2 of its 36 layers (bf16 params
# and grads plus fp32 moments take 12 bytes a parameter: 98 GB at 36
# layers, 19.6 GB at 2; phase 34's two checkpoints, 16.3 GB each, are
# written to disk in the run's time); mamba2-780m at 12 of its 48 layers
# and zamba2-2.7b at 2 of its 9 pattern repeats, depth only, for the
# script's time (whole, 0.78 B params and ~12.5 GB of state, and 2.62 B
# params, ~47 GB at the peak with ~15 GB of activations at 2 x 1024
# tokens, both fit without remat); AdamW on a cosine
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
TRAIN = {QWEN: dict(_TRAIN, depth=(2,), seq_len=512),
         MAMBA: dict(_TRAIN, depth=(12,), seq_len=1024),
         ZAMBA: dict(_TRAIN, depth=(2,), seq_len=1024, check_remat="full"),
         DEEPSEEK: dict(_TRAIN, depth=(1, 0), seq_len=512),
         WHISPER: dict(_TRAIN, seq_len=448)}
KERNELS = ("rmsnorm", "rmsnorm_bwd", "rmsnorm_split", "rmsnorm_split_bwd",
           "flash_attention", "flash_attention_bwd", "ssd_scan",
           "ssd_scan_bwd")
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
# phases 35-37, the paper's experiment (its images are CIFAR-100's shape,
# 32 x 32 x 3, 100 classes, synthetic): ViT-B (``ViTConfig()``: patch 4, 8
# x 8 patches + the cls token = 65 tokens, 12 heads of 64) and ResNet-50
# with its CIFAR stem, each at the paper's batch of 256 in fp32 (the
# reference's dtype; ViT-B once more in bf16); ViT-B/16 at 224 (197
# tokens) at 64, both dtypes; the reference demo's reduced ViT (4 heads of
# 32, 10 classes, batch 64, 150 steps).  ``steps``: timed AdamW steps, the
# median of steps 2 on read
VIT_B, RESNET, VIT_224, VIT_DEMO = ("vit-b", "resnet-50", "vit-b16-224",
                                    "vit-demo")
PAPER = {VIT_B: dict(batch=256, steps=6), RESNET: dict(batch=256, steps=6),
         VIT_224: dict(batch=64, steps=6)}
# every shape those steps give the flash kernel, forward and backward:
# (path, B, S, T, H, Hkv, D, causal)
VISION_FLASH = [(f"{VIT_B} train", 256, 65, 65, 12, 12, 64, False),
                (f"{VIT_224} train", 64, 197, 197, 12, 12, 64, False),
                (f"{VIT_DEMO} train", 64, 65, 65, 4, 4, 32, False)]
# the fp32 split-TF32 bodies' edges, forward and backward, in fp32 (no
# path runs them; qwen3-8b's causal B=2 S=T=512 H=32 Hkv=8 D=128 and its S
# = 300, T = 700 are path and edge rows already): one row, a 16-row slice
# and a row, exactly five slices, S != T not causal at ViT-B's heads, GQA 4
# at D = 64 (one block a head up to 128 keys, key tiles past it)
TF32_FLASH_EDGES = [("edge", 4, 1, 65, 12, 12, 64, False),
                    ("edge", 8, 17, 17, 12, 12, 64, True),
                    ("edge", 64, 80, 80, 12, 12, 64, False),
                    ("edge", 1, 300, 700, 12, 12, 64, False),
                    ("edge", 2, 100, 100, 32, 8, 64, True),
                    ("edge", 2, 512, 512, 32, 8, 64, True)]
# the card's logits of a batch of this many images against the same
# params' CPU forward (fp32, TF32 off on both sides of the card):
# max |diff| <= VISION_LOGIT_TOL * max(1, max |cpu|); the two sum the same
# fp32 products in other orders (~1e-6 of the logits' scale)
VISION_CHECK_BATCH = 8
VISION_LOGIT_TOL = 1e-4
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
# phase 40, tensor parallelism on the one card: zamba2-2.7b at published
# widths and 2 of its 9 pattern repeats (2 applications of the shared
# block, 12 mamba2 layers; the cut is depth only, for the script's time),
# TP_MODEL processes on a (data 1, model TP_MODEL) mesh over gloo (NCCL
# refuses two ranks on one device) under the uniform MP plan
TP_NAME = f"tp {ZAMBA}"
TP_DEPTH = (2,)
TP_MODEL = 2
# step 1's loss through the sharded step against the unplaced step's, both
# bf16 end to end through the kernels: the ranks' row-parallel products
# are summed in bf16 by the all-reduce where the unplaced product sums in
# fp32 once, which moves each layer's output by about one bf16 rounding;
# the mean over 2,048 tokens' cross-entropy moves far less than that
TP_LOSS_REL_TOL = 2e-3
# the placed fp32 serve's prefill logits against the unplaced engine's:
# max |diff| <= TP_LOGIT_TOL * max |unplaced| for each prefill call (the
# same fp32 sums in another order, ~1e-6 of the scale)
TP_LOGIT_TOL = 1e-4
# the placed fp32 serve of phase 40: the first 4 of phase 10's 8 requests
# (fp32 over gloo runs ~5 tok/s; cut from 8 for the script's time)
TP_SERVE_REQUESTS = 4
# phase 41, the MoE family on phase 40's mesh and plan: deepseek-v3-671b at
# published widths.  Train: 1 mla_dense layer and the MTP head (phase 23's
# cut; one mla layer's training state, ~184 GB, needs four cards), bf16, 2
# timed steps after the check (each ~8-10 s, for the script's time).
# Serve: 1 mla_dense + 1 mla layer with all 256 experts, fp32 so that
# tokens compare exactly; 2 requests of 128 prompt tokens and 8 new, few
# because every model call gathers the fp32 embedding and head (3.7 GB
# each) through gloo (~6.7 s a call)
TP_MOE_NAME = f"tp {DEEPSEEK}"
TP_MOE_TRAIN = dict(TRAIN[DEEPSEEK], depth=(1, 0), seq_len=1024, steps=2)
TP_MOE_SERVE = dict(depth=(1, 1), requests=2, prompt_len=128, max_new=8,
                    slots=2, max_len=256, block_size=16, prefill_chunk=128)
TP_MOE_SEED = 0
# phase 41's contiguous part: the serve's weights and its 2 prompts of 128
# tokens through ``tp_mla_block`` on the (1, 2) mesh, one prefill and
# TP_DECODE_STEPS greedy decode steps on a contiguous cache of the serve's
# max_len rows placed by the plan's ``cache_specs`` (the latents split
# over `model` along time, gathered around each attention)
TP_DECODE_NAME = f"tp decode {DEEPSEEK}"
TP_DECODE_STEPS = 4
# phase 41's EP-major part, run first: deepseek-v3-671b at published
# widths, 1 mla_dense + 1 mla layer with all 256 experts (the MTP head
# left out, as the serve leaves it: with it the two ranks' shards, bf16
# grads and gathered weights passed the card's 80 GB), bf16, on a (data 2,
# model 1) mesh of the same two processes under the uniform HP plan with
# the EP-major specs (``moe_ep_axis("data")``): each rank holds 128
# experts (11.3 GB) and its own sequence of ``SyntheticLM(129280, 512,
# 2)``.  Step 1's loss and gradients only: the layer's AdamW state does
# not fit one card.  ``sample``: the experts, offsets within each rank's
# range, whose gradients are held beside every other leaf's
TP_EP_NAME = f"ep {DEEPSEEK}"
TP_EP_TRAIN = dict(depth=(1, 1), seq_len=512, batch=2, sample=(0, 77, 127))
TP_EP_SEED = 1
# phase 42, HP on a multi-pod mesh: mamba2-780m at published widths, 2 of
# its 48 layers (depth cut for the script's time), four processes on the card over gloo on a (pod 2, data 2,
# model 1) mesh under the uniform HP plan with int8 moments: HP's ZeRO dim
# ("data", "pod") and the moments' ("data", "model", "pod") laid out in the
# reference's order (rank (pod p, data d) holds block 2 d + p); one
# sequence of 1,024 tokens a rank; 3 timed steps after the check
POD_NAME = f"pod {MAMBA}"
POD_SHAPE = (2, 2, 1)                       # (pod, data, model)
POD_AXES = ("pod", "data", "model")
POD_TRAIN = dict(_TRAIN, depth=(2,), seq_len=1024, batch=4, steps=3)
# phase 43, tracecheck on the card: the analyzers of
# ``repro_torch.analysis.tracecheck`` over qwen3-8b (all 36 layers) and
# mamba2-780m (all 48) at published widths, bf16: the static analyzers
# (``TRACE_STATIC``) at the reference's geometry (``DEFAULT_GEOM``: slots
# 4, max_len 64, block 8, chunk 16), trace-cache at its tight pool (slots
# 2, max_len 48, block 4, 13 blocks, chunk 8), the sharding analyzer over
# qwen3-8b's pools on the reference's (data 4, model 2) mesh in a process
# of its own
# 44. the contiguous decode cache: phase 4's / 6's first prompts
DECODE = dict(batch=2, max_len=1024, steps=32)
DECODE_TRACED = 4          # decode steps traced with --profile
DECODE_ARCHS = (QWEN, MAMBA)
# 45. the dry run's cells (16 x 16, a fake group of 256 ranks)
DRYRUN_CELLS = ((QWEN, "train_4k"), (QWEN, "decode_32k"),
                (MAMBA, "long_500k"))
DRYRUN_NAME = "dryrun"
DRYRUN_TIMEOUT_S = 600
# and one ``--moe-ep`` cell, read after phase 46 (it traces ~2-3 minutes,
# beside the card's phases): deepseek-v3-671b x decode_32k, all 61 layers
DRYRUN_EP_CELL = (DEEPSEEK, "decode_32k")
# each cell's counted cost with fake CPU tensors (``python -m
# repro_torch.launch.dryrun --arch A --shape S --no-save --device cpu``;
# tests/test_torch_dryrun*.py hold these to the CPU's count): the card's
# count must equal it
DRYRUN_CPU_COST = {
    (QWEN, "train_4k"): {
        "flops": 267676790292480, "bytes": 3346167111372,
        "kernel_calls": {"rmsnorm": 289, "rmsnorm_bwd": 145}},
    (QWEN, "decode_32k"): {
        "flops": 26887110656, "bytes": 382284557380,
        "kernel_calls": {"rmsnorm": 145}},
    (MAMBA, "long_500k"): {
        "flops": 280750080, "bytes": 643202392,
        "kernel_calls": {"rmsnorm": 49, "rmsnorm_split": 48}},
}
# the run's limit, and how much slower a host has run the whole script
# than the fastest seen: more than 1.29x (its host-bound phases up to
# 1.6x; PERF.md section 7)
TIME_LIMIT_S = 1200
SLOW_HOST = 1.3
EXAMPLES_NAME = "examples"
TRACE_NAME = "tracecheck"
TRACE_ARCHS = (QWEN, MAMBA)
TRACE_STATIC = ("donation", "host-transfer", "cost-drift")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def call_ms(fn, iters: int) -> float | None:
    """Time of one eager call: ``iters`` calls issued back to back from
    Python after 3 warm-up calls, CUDA events around them.  At small shapes
    this is the rate at which the host launches calls, not device time.
    None, and ``fn`` not called, for ``iters`` 0 (a row not timed)."""
    import torch
    if not iters:
        return None
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


def time_ms(fn, iters: int, replays: int = 5) -> float | None:
    """Device time of one call: ``iters`` calls captured in one CUDA graph
    (after 3 warm-up calls on a side stream), replayed once to warm up and
    then ``replays`` times, each between CUDA events; the median replay
    over ``iters``.  The replay takes the host's launch cost out, so a
    small kernel is timed on the device, not at Python's pace; the median
    keeps one slow replay (a clock change, a neighbour on the host) out of
    the reading.  None for ``iters`` 0 (a row not timed)."""
    import torch
    if not iters:
        return None
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


def time_ms_cold(fn, iters: int, replays: int = 5) -> float | None:
    """``time_ms`` with a cold L2: each captured call follows a write of
    ``L2_FLUSH_BYTES`` (more than the H100's 50 MB L2), which evicts the
    call's inputs; the flush's own time, captured alone, is subtracted."""
    import torch
    if not iters:
        return None
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
    (``_norm_uses``); flash: ``(path, B, S, T, H, Hkv, D, causal)``
    (``flash_rows``' order); SSD: ``(path, B, S, G, h0)``.  The serve path's decode step normalises
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
        flash = [(p, B, Sq, Sq) + dims + (True,) for p, B, Sq in seqs]
    if name == QWEN:
        norm += [("edge", "long rows", 2048, arch.d_model),
                 ("edge", "q_norm", 2048 * arch.n_heads, arch.head_dim)]
        norm += NORM_WIDE_EDGES
        flash += [c[:4] + dims + c[4:] for c in (
            ("edge", 1, 2048, 2048, True), ("edge", 1, 300, 300, True),
            ("edge", 1, 256, 700, True), ("edge", 1, 300, 700, False))]
    if name in (ZAMBA, GEMMA):
        # the wide heads with GQA (the paths' are MHA) at a ragged S
        flash.append(("edge", 1, 300, 300, 8, 4, dims[2], True))
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


def flash_ops(dtype_name, D, flops):
    """``flops`` of a flash row by the type it runs at: the bf16 bodies'
    on the bf16 tensor cores; fp32 at the split-TF32 bodies' head dims
    (``flash_attention.TF32_DIMS``) as three TF32 products a product (big
    and small parts, as ``ssd_work`` counts split products), on the FMA
    body's above them at the fp32 rate."""
    from repro_torch.kernels import flash_attention as FA
    if dtype_name == "float32" and D in FA.TF32_DIMS:
        return {"tfloat32": 3 * flops}
    return {dtype_name: flops}


def bwd_share_ms(fwd, grad_out, iters):
    """A backward's device time: the captured forward + backward less the
    captured forward (``fwd`` returns the output and the inputs to
    differentiate; ``grad_out`` is the output's gradient)."""
    import torch
    if not iters:
        return None

    def both():
        out, inputs = fwd()
        return torch.autograd.grad(out, inputs, grad_out)
    return time_ms(both, iters) - time_ms(fwd, iters)


def flash_rows(torch, cases, iters, randn, dtypes):
    """The flash forward kernel against its plain version at ``cases``,
    ``(path, B, S, T, H, Hkv, D, causal)`` each, in the model's (B, S, H,
    D) layout."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.work import bound, flash_work
    rows = []
    for path, B, S, Tk, H, HKV, D, causal in cases:
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
                q, k, v, scale=sc, causal=causal), iters[dn])
            eager = call_ms(lambda: ops.flash_attention(
                q, k, v, scale=sc, causal=causal), iters[dn])
            plain_ms = time_ms(lambda: ref.flash_attention_ref(
                q, k, v, scale=sc, causal=causal), iters[dn])
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, scale=sc, enable_gqa=True),
                iters[dn])
            nbytes, flops = flash_work(B, S, Tk, H, HKV, D, causal,
                                       q.element_size(), backward=False)
            rows.append(dict(
                name="flash_attention", path=path, use="attention",
                shape=f"B={B} S={S} T={Tk} H={H} Hkv={HKV} D={D}"
                      f"{' causal' if causal else ''}",
                dtype=dn, ok=ok, max_abs_err=err, tol=tol, ms=ms,
                call_ms=eager, plain_ms=plain_ms, library_ms=lib_ms,
                bytes=nbytes, flops=flops,
                **bound(nbytes, flash_ops(dn, D, flops))))
    return rows


def kernel_phase(torch, archs, iters, secs):
    """Every kernel case's row (phase 3), timed with ``iters[dtype name]``
    calls a CUDA graph (0: checked, not timed); ``secs`` gets each group
    of cases' seconds: each kernel's rows at the serve and forward shapes,
    the backward rows, the tensor-parallel, ViT and TF32-edge rows."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.kernels.work import bound, rmsnorm_work

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)

    dtypes = ((torch.bfloat16, "bfloat16"), (torch.float32, "float32"))

    def group(label, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        secs[label] = secs.get(label, 0.0) + time.perf_counter() - t
        return out
    for name, arch in archs.items():
        norm_cases, flash_cases, ssd_cases = served_cases(name, arch)
        t_norm = time.perf_counter()
        for path, use, R, D in norm_cases:
            for dt, dn in dtypes:
                x = randn(R, D, dtype=dt)
                scale = (1.0 + 0.1 * randn(D, dtype=torch.float32)).to(dt)
                got = RN.rmsnorm(x, scale)
                want = ref.rmsnorm_ref(x, scale)
                torch.cuda.synchronize()
                err, ok, tol = check_close(got, want, dn)
                ms = time_ms(lambda: RN.rmsnorm(x, scale), iters[dn])
                cold = time_ms_cold(lambda: RN.rmsnorm(x, scale), iters[dn])
                eager = call_ms(lambda: RN.rmsnorm(x, scale), iters[dn])
                plain_ms = time_ms(lambda: ref.rmsnorm_ref(x, scale), iters[dn])
                lib_ms = (time_ms(lambda: F.rms_norm(x, (D,), scale, 1e-6),
                                  iters[dn]) if hasattr(F, "rms_norm") else None)
                nbytes, fl = rmsnorm_work(R, D, x.element_size(),
                                          scale.element_size())
                flops = fl["float32"]
                rows.append(dict(
                    name="rmsnorm", path=path, use=use, shape=f"({R}, {D})",
                    dtype=dn, ok=ok, max_abs_err=err, tol=tol, ms=ms,
                    cold_ms=cold, call_ms=eager, plain_ms=plain_ms,
                    library_ms=lib_ms,
                    bytes=nbytes, flops=flops,
                    **bound(nbytes, {"float32": flops})))
        secs["rmsnorm"] = (secs.get("rmsnorm", 0.0) + time.perf_counter()
                           - t_norm)

        rows += group("flash", flash_rows, torch, flash_cases, iters, randn,
                      dtypes)

        if ssd_cases:
            rows += group("ssd_scan", ssd_rows, torch, arch.ssm,
                          ssd_heads(arch), ssd_cases, iters, gen, dtypes)
    for name, arch in archs.items():
        if name in TRAIN:
            rows += group("backward", backward_rows, torch, name, arch,
                          iters, gen, dtypes)
    # the shapes tensor parallelism on 2 ranks gives the kernels (phase 40)
    rows += group("tp", tp_rows, torch, archs, iters, gen, randn, dtypes)
    # the paper's ViTs (phases 35 and 37) train through flash, bidirectional
    rows += group("vision", flash_rows, torch, VISION_FLASH, iters, randn,
                  dtypes)
    rows += group("vision", flash_bwd_rows, torch, VISION_FLASH, iters,
                  randn, dtypes)
    fp32 = ((torch.float32, "float32"),)
    rows += group("tf32 edges", flash_rows, torch, TF32_FLASH_EDGES, iters,
                  randn, fp32)
    rows += group("tf32 edges", flash_bwd_rows, torch, TF32_FLASH_EDGES,
                  iters, randn, fp32)
    return rows


def ssd_heads(arch):
    return arch.ssm.expand * arch.d_model // arch.ssm.head_dim


def ssd_rows(torch, s, H, cases, iters, gen, dtypes):
    """The SSD scan kernel against its plain version at ``cases``, ``(path,
    B, S, G, h0)`` each, for the SSM spec ``s`` at ``H`` heads."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.work import bound, ssd_work
    rows = []
    for path, B, S, G, has_h0 in cases:
        P, N, chunk = s.head_dim, s.d_state, s.chunk
        Q = min(chunk, S)
        dt_bias = ssd_init_dt_bias(torch, gen, H)
        for dt, dn in dtypes:
            x, Bm, Cm, dtv, a, h0 = ssd_inputs(torch, gen, B, S, H, P, N, G,
                                               dt_bias, dt, has_h0)

            def kernel():
                return ops.ssd_scan(x, Bm, Cm, dtv, a, h0, chunk=chunk)

            def plain():
                return ref.ssd_scan_ref(x, Bm, Cm, dtv, a, h0, chunk=chunk)
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
                ms=time_ms(kernel, iters[dn]), call_ms=call_ms(kernel, iters[dn]),
                plain_ms=time_ms(plain, iters[dn]), library_ms=None,
                bytes=nbytes, flops=sum(flops.values()),
                **bound(nbytes, flops)))
    return rows


def split_norm_rows(torch, cases, iters, gen, dtypes):
    """The split-row RMSNorm's kernels, forward and backward, at ``cases``
    (``(path, use, rows, D)``: this rank's D of each row's 2 D columns, as
    2 ranks split mamba2's gated norm) against autograd through its plain
    version, ``ref.rmsnorm_split_ref`` over d_total = 2 D.  On one card
    without a group, the two launches of each direction run back to back
    (the all-reduce between them is phase 40's), the other rank's sums
    taken as 0.  No PyTorch call computes a split row (library_ms None).
    The backward's plain time is that of its formula in plain PyTorch
    (``split_norm_bwd_plain``; a CUDA graph that captures autograd through
    ``rmsnorm_split_ref`` fails on the card with "operation would make the
    legacy stream depend on a capturing blocking stream").  Bound: bytes,
    x, scale and g read once, y, dx and dscale written once, and each
    row's sums (4 bytes forward, 8 backward) written and read once."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.kernels.work import bound
    rows = []
    for path, use, R, D in cases:
        for dt, dn in dtypes:
            x, g = (torch.randn((R, D), generator=gen, device="cuda").to(dt)
                    for _ in range(2))
            scale = (1.0 + 0.1 * torch.randn(D, generator=gen,
                                             device="cuda")).to(dt)

            def fwd():
                return RN._split_forward(x, scale, 1e-6, 2 * D, None)

            def bwd():
                return RN._split_backward(x, scale, g, 1e-6, 2 * D, None)
            xr, sr = x.clone().requires_grad_(), scale.clone().requires_grad_()
            want = ref.rmsnorm_split_ref(xr, sr, d_total=2 * D)
            want_g = torch.autograd.grad(want, (xr, sr), g)
            got, got_g = fwd(), bwd()
            torch.cuda.synchronize()
            isz = x.element_size()
            for name, (err, ok, tol), ms, plain_ms, nbytes, flops in (
                    ("rmsnorm_split", check_close(got, want.detach(), dn),
                     time_ms(fwd, iters[dn]),
                     time_ms(lambda: ref.rmsnorm_split_ref(
                         x, scale, d_total=2 * D), iters[dn]),
                     2 * R * D * isz + D * isz + 8 * R, 4 * R * D),
                    ("rmsnorm_split_bwd",
                     check_normwise(got_g, want_g, dn), time_ms(bwd, iters[dn]),
                     time_ms(lambda: split_norm_bwd_plain(x, scale, g, 2 * D),
                             iters[dn]),
                     3 * R * D * isz + 2 * D * isz + 16 * R, 8 * R * D)):
                rows.append(dict(
                    name=name, path=path, use=use,
                    shape=f"({R}, {D}) of {2 * D}", dtype=dn, ok=ok,
                    max_abs_err=err, tol=tol, ms=ms,
                    call_ms=call_ms(fwd if name == "rmsnorm_split" else bwd,
                                    iters[dn]),
                    plain_ms=plain_ms, library_ms=None, bytes=nbytes,
                    flops=flops, **bound(nbytes, {"float32": flops})))
    return rows


def split_norm_bwd_plain(x, scale, g, d_total, eps=1e-6):
    """The split row's backward in plain PyTorch, fp32: dx = r (g s - xh
    r sum(g s x) / d_total), dscale = sum over rows of g xh, xh = x r, r
    = rsqrt(sum(x^2) / d_total + eps) (this rank's sums; the other
    ranks' taken as 0)."""
    import torch
    xf, gf, sf = x.float(), g.float(), scale.float()
    r = torch.rsqrt(xf.square().sum(-1, keepdim=True) / d_total + eps)
    gsx = (gf * sf * xf).sum(-1, keepdim=True)
    dx = r * (gf * sf - xf * r * r * gsx / d_total)
    return dx.to(x.dtype), (gf * xf * r).sum(0).to(scale.dtype)


def tp_rows(torch, archs, iters, gen, randn, dtypes):
    """The kernels at the shapes 2 tensor-parallel ranks give them:
    phase 40's zamba2-2.7b train step and placed serve, mamba2-780m's
    train step, whisper-medium's decoder self-attention at its train
    step.  The split-row RMSNorm at (rows, d_inner / 2); the SSD scan at H
    / 2, forward and backward (zamba2 40 of 80, mamba2-780m 24 of 48);
    flash at the local heads (zamba2's shared block 16 of 32 at D = 160,
    whisper's 8 of 16 at D = 64), forward and backward."""
    z, m, w = archs[ZAMBA], archs[MAMBA], archs[WHISPER]
    zt, mt, wt = TRAIN[ZAMBA], TRAIN[MAMBA], TRAIN[WHISPER]
    st = SERVE[ZAMBA]
    zi, mi = z.ssm.expand * z.d_model // 2, m.ssm.expand * m.d_model // 2
    use = "gated norm (split)"
    rows = split_norm_rows(torch, [
        (f"{TP_NAME} train", use, zt["batch"] * zt["seq_len"], zi),
        (f"{TP_NAME} serve prefill", use, st["prefill_chunk"], zi),
        (f"{TP_NAME} serve decode", use, st["slots"], zi),
        (f"tp {MAMBA} train", use, mt["batch"] * mt["seq_len"], mi)],
        iters, gen, dtypes)
    rows += ssd_rows(torch, z.ssm, ssd_heads(z) // 2, [
        (f"{TP_NAME} train", zt["batch"], zt["seq_len"], 1, False),
        (f"{TP_NAME} serve prefill", 1, st["prefill_chunk"], 1, True)],
        iters, gen, dtypes)
    rows += ssd_rows(torch, m.ssm, ssd_heads(m) // 2, [
        (f"tp {MAMBA} train", mt["batch"], mt["seq_len"], 1, False)],
        iters, gen, dtypes)
    rows += ssd_backward_rows(torch, z, [
        (f"{TP_NAME} train", zt["batch"], zt["seq_len"], 1, False, False)],
        iters, gen, dtypes, H=ssd_heads(z) // 2)
    rows += ssd_backward_rows(torch, m, [
        (f"tp {MAMBA} train", mt["batch"], mt["seq_len"], 1, False, False)],
        iters, gen, dtypes, H=ssd_heads(m) // 2)
    H, Hkv, D = _attn_dims(z)
    wH, wHkv, wD = _attn_dims(w)
    flash = [(f"{TP_NAME} train", zt["batch"], zt["seq_len"], zt["seq_len"],
              H // 2, Hkv // 2, D, True),
             (f"tp {WHISPER} train", wt["batch"], wt["seq_len"],
              wt["seq_len"], wH // 2, wHkv // 2, wD, True)]
    return rows + flash_rows(torch, flash, iters, randn, dtypes) + \
        flash_bwd_rows(torch, flash, iters, randn, dtypes)


def ssd_init_dt_bias(torch, gen, H):
    """The init's dt_bias: inverse softplus of log-uniform [1e-3, 0.1]."""
    u = torch.rand((H,), generator=gen, device="cuda")
    dt0 = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    return dt0 + torch.log(-torch.expm1(-dt0))


def ssd_backward_rows(torch, arch, cases, iters, gen, dtypes, H=None):
    """The SSD scan's backward kernel against autograd through the plain
    scan, at ``cases`` (``train_cases``), at the arch's heads or ``H``.
    No single PyTorch call computes this function (library_ms None);
    plain_ms is the backward's share of autograd through
    ``ref.ssd_scan_ref``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.kernels.work import bound, ssd_bwd_work

    rows = []
    for path, B, S, G, has_h0, has_dh in cases:
        H = H or ssd_heads(arch)
        s = arch.ssm
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
                ms=time_ms(kernel, iters[dn]),
                cold_ms=(None if path.startswith("edge")
                         else time_ms_cold(kernel, iters[dn])),
                call_ms=call_ms(kernel, iters[dn]),
                plain_ms=bwd_share_ms(plain, grad_out, iters[dn]),
                library_ms=None, bytes=nbytes, flops=sum(flops.values()),
                **bound(nbytes, flops)))
    return rows


def flash_bwd_rows(torch, cases, iters, randn, dtypes):
    """The flash backward kernels against autograd through the plain
    version at ``cases``, ``(path, B, S, T, H, Hkv, D, causal)`` each."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref
    from repro_torch.kernels.work import bound, flash_work
    rows = []
    for path, B, S, Tk, H, HKV, D, causal in cases:
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
                ms=time_ms(kernel, iters[dn]),
                cold_ms=(None if path.startswith("edge")
                         else time_ms_cold(kernel, iters[dn])),
                call_ms=call_ms(kernel, iters[dn]),
                plain_ms=bwd_share_ms(plain, do.transpose(1, 2), iters[dn]),
                library_ms=bwd_share_ms(lib, do.contiguous(), iters[dn]),
                bytes=nbytes, flops=flops,
                **bound(nbytes, flash_ops(dn, D, flops))))
    return rows


def backward_rows(torch, name, arch, iters, gen, dtypes):
    """The backward kernels against autograd through the plain versions,
    at ``train_cases(name, arch)``."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.kernels.work import bound, rmsnorm_bwd_work

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
            nbytes, fl = rmsnorm_bwd_work(R, D, x.element_size(),
                                          scale.element_size())
            flops = fl["float32"]
            rows.append(dict(
                name="rmsnorm_bwd", path=path, use=use, shape=f"({R}, {D})",
                dtype=dn, ok=ok, max_abs_err=err, tol=tol,
                ms=time_ms(lambda: RN.rmsnorm_bwd(x, scale, g), iters[dn]),
                cold_ms=time_ms_cold(lambda: RN.rmsnorm_bwd(x, scale, g),
                                     iters[dn]),
                call_ms=call_ms(lambda: RN.rmsnorm_bwd(x, scale, g), iters[dn]),
                plain_ms=bwd_share_ms(plain, g, iters[dn]),
                library_ms=(bwd_share_ms(lib, g, iters[dn])
                            if hasattr(F, "rms_norm") else None),
                bytes=nbytes, flops=flops,
                **bound(nbytes, {"float32": flops})))

    rows += flash_bwd_rows(torch, flash_cases, iters, randn, dtypes)
    return rows + ssd_backward_rows(torch, arch, ssd_cases, iters, gen,
                                    dtypes)


def _wrappers():
    """{kernel name: its wrapper, which carries the launch count}."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.kernels import ssd_scan as SSD
    return {"rmsnorm": RN.rmsnorm, "rmsnorm_bwd": RN.rmsnorm_bwd,
            "rmsnorm_split": RN.rmsnorm_split,
            "rmsnorm_split_bwd": RN.rmsnorm_split_bwd,
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


def serve_phase(torch, np, report, name, arch, key=None):
    """Model ``name`` (``arch``: its depth cut, if any) serving its cell's
    greedy requests, checked, kept in ``report`` under ``key`` (default
    ``serve <name>``) -> (params, prompts, frontends, the first-token
    logits of the engine's own chunked prefill, each request's tokens)."""
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
    report[key or f"serve {name}"] = serve
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


def sample_phase(torch, np, report, name, arch, params, prompts, greedy,
                 ref=None):
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
    src = ref or f"serve {name}"    # the greedy serve held against
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
                     f"a sampled one differs from {src}'s tokens")
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
        extra = (f"; greedy rows beside a sampled one equal {src}'s; stop "
                 f"token {stop} after {len(cut)} tokens, blocks and budget "
                 f"freed; forced preemption ({PREEMPT_BLOCKS} blocks, "
                 f"{peng.metrics.preemptions} preemptions): every request "
                 f"finished, tokens equal to the ample run's by request "
                 f"{same} of {st['max_new']}")
    g = report[src]
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


def observe_phase(torch, np, report, name, arch, params, prompts,
                  ref=None):
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
    src = ref or f"serve {name}"    # the greedy serve held against
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
    g = report[src]
    report[f"observe {name}"] = dict(
        wall_s=wall, tok_per_s=sum(o.n_tokens for o in outs) / wall,
        tpot_p50_s=s["tpot_p50_s"], ttft_p50_s=s["ttft_p50_s"],
        launches=counts, trace_events=trace["n_events"],
        snapshot_lines=len(lines), sanitizer=rep_san,
        cancelled_tokens=len(by_id[running].token_ids),
        step_time_ema_s=os_["window"]["step_time_ema_s"],
        observed_trace_events=otrace["n_events"])
    print(f"observe: {name}: traced serve {wall:.3f} s, TPOT p50 "
          f"{s['tpot_p50_s'] * 1e3:.2f} ms ({src} "
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


def placed_phase(torch, np, report, name, arch, params, prompts, greedy,
                 ref=None):
    """38. Phase 4's weights, requests and settings through the engine on
    a 1 x 1 ``DeviceMesh`` over a world-1 NCCL group (``make_host_mesh``):
    the plan printed, params and pools DTensors on that mesh, tokens
    bit-equal to phase 4's, ``forward_launches`` RMSNorm launches a model
    call and no flash launch; tok/s, TTFT and TPOT beside phase 4's and
    beside the unplaced engine's once more after it."""
    from torch.distributed.tensor import DTensor

    from repro_torch import tree
    from repro_torch.launch import mesh as M
    from repro_torch.serving.engine import ContinuousBatchingEngine, Request

    st = SERVE[name]
    src = ref or f"serve {name}"    # the greedy serve held against
    mesh = M.make_host_mesh(device="cuda")
    try:
        eng = ContinuousBatchingEngine(arch, params, mesh,
                                       **engine_kwargs(name))
        eng_plan = eng.plan.summary()
        print(eng_plan)
        leaves = tree.leaves(eng.params) + tree.leaves(eng.cache.pools)
        if not all(isinstance(x, DTensor) and x.device_mesh is mesh
                   for x in leaves):
            fail(f"placed {name}: a param or pool leaf is not a DTensor on "
                 f"the engine's mesh")
        shared = sum(x.to_local().data_ptr() == p.data_ptr() for x, p in
                     zip(tree.leaves(eng.params), tree.leaves(params)))
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        outs = eng.generate([Request(id=i, prompt=p,
                                     max_new_tokens=st["max_new"])
                             for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        s = eng.metrics.summary()
        calls = s["prefill_chunks"] + s["decode_steps"]
        bad = [o.request_id for o in outs
               if o.token_ids != greedy[o.request_id]]
        if bad:
            fail(f"placed {name}: requests {bad} differ from {src}'s "
                 f"tokens")
        if counts["rmsnorm"] != forward_launches(arch)["rmsnorm"] * calls \
                or counts["flash_attention"] != 0:
            fail(f"placed {name}: launches {counts} for {calls} model calls "
                 f"(want {forward_launches(arch)['rmsnorm']} RMSNorm a call, "
                 f"no flash)")
        if eng.cache.allocator.num_used != 0:
            fail(f"placed {name}: blocks still held after drain")
        del eng, outs
        # the unplaced engine once more, after the placed one: unplaced
        # (phase 4), placed, unplaced within one run
        again = ContinuousBatchingEngine(arch, params, **engine_kwargs(name))
        t0 = time.perf_counter()
        outs = again.generate([Request(id=i, prompt=p,
                                       max_new_tokens=st["max_new"])
                               for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
        wall_again = time.perf_counter() - t0
        if [o.token_ids for o in outs] != greedy:
            fail(f"placed {name}: the unplaced engine's second run differs "
                 f"from {src}'s tokens")
        s2 = again.metrics.summary()
        total = sum(o.n_tokens for o in outs)
        del again, outs
        p4 = report[src]
        report[f"placed {name}"] = dict(
            plan=eng_plan, tokens=total, wall_s=wall,
            tok_per_s=total / wall, ttft_p50_s=s["ttft_p50_s"],
            tpot_p50_s=s["tpot_p50_s"], launches=counts,
            params_shared=shared, n_params=len(tree.leaves(params)),
            phase4_tok_per_s=p4["tok_per_s"],
            phase4_ttft_p50_s=p4["ttft_p50_s"],
            phase4_tpot_p50_s=p4["tpot_p50_s"],
            unplaced_after_tok_per_s=total / wall_again,
            unplaced_after_ttft_p50_s=s2["ttft_p50_s"],
            unplaced_after_tpot_p50_s=s2["tpot_p50_s"])
        print(f"placed: {name} on a 1 x 1 mesh ({mesh.device_type}, world "
              f"{mesh.size()}): {len(greedy)} requests, tokens bit-equal to "
              f"{src}'s, {total} tokens in {wall:.3f} s = "
              f"{total / wall:.2f} tok/s ({src} {p4['tok_per_s']:.2f}, "
              f"unplaced after {total / wall_again:.2f}), TTFT p50 "
              f"{s['ttft_p50_s'] * 1e3:.1f} ms ({src} "
              f"{p4['ttft_p50_s'] * 1e3:.1f}, after "
              f"{s2['ttft_p50_s'] * 1e3:.1f}), TPOT p50 "
              f"{s['tpot_p50_s'] * 1e3:.2f} ms ({src} "
              f"{p4['tpot_p50_s'] * 1e3:.2f}, after "
              f"{s2['tpot_p50_s'] * 1e3:.2f}), launches {counts}, "
              f"{shared} of {len(tree.leaves(params))} param leaves placed "
              f"without a copy")
    finally:
        M.shutdown()


def _post(url, body, timeout):
    import urllib.request
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        if not body.get("stream"):
            return resp.status, [json.loads(resp.read())]
        events = []
        for raw in resp:
            line = raw.decode().strip()
            if line.startswith("data: "):
                events.append(json.loads(line[len("data: "):]))
        return resp.status, events


def _get(url, timeout=30):
    import urllib.request
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.read().decode()


def _replica_series(series, metric):
    return {lab["replica"]: float(v) for lab, v in series.get(metric, [])
            if "replica" in lab}


def cluster_phase(torch, np, report, name, arch, prompts, greedy):
    """39. ``python -m repro_torch.launch.serve_cluster`` with two
    replicas of ``name`` on the card at phase 4's settings, after phase
    38's weights are freed: boot time; /healthz 200 with both replicas
    live; each worker's boot line names a CUDA device; phase 4's 8
    requests as concurrent HTTP posts, half streamed by SSE, each with
    phase 4's tokens; /metrics parses, 2 replicas live, the replicas'
    generated tokens sum to the tokens the requests received and each
    replica's RMSNorm launches are ``forward_launches`` a model call
    (no flash); one request stopped by a stop string from its own greedy
    output, trimmed at the match; SIGTERM: ``workers exited with [0,
    0]`` and no worker left.  Aggregate tok/s and each request's TTFT and
    TPOT beside phase 4's."""
    import signal
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.serving.export import parse_prometheus_text

    st = SERVE[name]
    cmd = [sys.executable, "-m", "repro_torch.launch.serve_cluster",
           "--arch", name, "--replicas", str(CLUSTER_REPLICAS),
           "--slots", str(st["slots"]), "--max-len", str(st["max_len"]),
           "--block-size", str(st["block_size"]),
           "--prefill-chunk", str(st["prefill_chunk"])]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines, ready = [], threading.Event()

    def reader():
        for line in proc.stdout:
            lines.append(line.rstrip())
            print(f"  cluster| {line.rstrip()}", flush=True)
            if line.startswith("worker pids: "):
                ready.set()
        ready.set()
    threading.Thread(target=reader, daemon=True).start()
    pids = []
    try:
        if not ready.wait(CLUSTER_BOOT_S) or proc.poll() is not None:
            fail(f"cluster {name}: no 'worker pids' line within "
                 f"{CLUSTER_BOOT_S} s (exit {proc.poll()})")
        boot_s = time.perf_counter() - t0
        url = next(x.split()[2] for x in lines
                   if x.startswith("serving on "))
        pids = [int(p) for p in next(
            x for x in lines if x.startswith("worker pids: "))
            .split(":")[1].split()]
        boots = [x for x in lines if x.startswith("worker ")
                 and ": device " in x]
        if len(boots) != CLUSTER_REPLICAS or not all(
                ": device cuda" in b for b in boots):
            fail(f"cluster {name}: worker boot lines {boots} do not each "
                 f"name a CUDA device")
        status, body = _get(url + "/healthz")
        health = json.loads(body)
        if status != 200 or set(health["replicas"].values()) != {"live"} \
                or len(health["replicas"]) != CLUSTER_REPLICAS:
            fail(f"cluster {name}: /healthz {status} {health}")

        def one(i):
            body = {"prompt": prompts[i].tolist(),
                    "max_new_tokens": st["max_new"], "stream": i % 2 == 1}
            t = time.perf_counter()
            status, events = _post(url + "/v1/generate", body,
                                   CLUSTER_REQUEST_S)
            return status, events, time.perf_counter() - t
        t1 = time.perf_counter()
        with ThreadPoolExecutor(len(prompts)) as ex:
            res = list(ex.map(one, range(len(prompts))))
        wall = time.perf_counter() - t1
        done = []
        for i, (status, events, _) in enumerate(res):
            d = events[-1]
            if status != 200 or d.get("token_ids") != greedy[i] or \
                    d.get("finish_reason") != "length":
                fail(f"cluster {name} request {i}: status {status}, "
                     f"{d.get('finish_reason')!r}, tokens differ from phase "
                     f"4's: {d.get('token_ids') != greedy[i]}")
            if i % 2 == 1 and "".join(e.get("text", "") for e in
                                      events[:-1]) != d["text"]:
                fail(f"cluster {name} request {i}: streamed text is not "
                     f"the final text")
            done.append(d)
        received = sum(len(d["token_ids"]) for d in done)
        # /metrics: the replicas' stats come with their heartbeats
        t2 = time.perf_counter()
        while True:
            status, text = _get(url + "/metrics")
            series = parse_prometheus_text(text)
            toks = _replica_series(series,
                                   "repro_serving_tokens_generated_total")
            if sum(toks.values()) == received or \
                    time.perf_counter() - t2 > 15:
                break
            time.sleep(0.5)
        live = series["repro_serving_router_replicas_live"]
        if status != 200 or live != [({}, str(CLUSTER_REPLICAS))] or \
                sum(toks.values()) != received:
            fail(f"cluster {name}: /metrics {status}, replicas_live {live},"
                 f" tokens by replica {toks} for {received} received")
        prefill = _replica_series(series,
                                  "repro_serving_prefill_chunks_total")
        decode = _replica_series(series, "repro_serving_decode_steps_total")
        steps = {r: prefill[r] + decode[r] for r in toks}
        launches = {}
        for lab, v in series["repro_serving_kernel_launches_total"]:
            launches.setdefault(lab["replica"], {})[lab["kernel"]] = \
                int(float(v))
        per = forward_launches(arch)["rmsnorm"]
        for r in toks:
            if launches[r]["rmsnorm"] != per * steps[r] or \
                    launches[r]["flash_attention"] != 0:
                fail(f"cluster {name} replica {r}: launches {launches[r]} "
                     f"for {steps[r]:.0f} model calls (want {per} RMSNorm "
                     f"a call, no flash)")
        # a stop string from request 0's own greedy output: the first token
        # from the third on that it has not produced before
        k = next(j for j in range(2, len(greedy[0]))
                 if greedy[0][j] not in greedy[0][:j])
        stop = f"t{greedy[0][k]} "
        status, events = _post(url + "/v1/generate",
                               {"prompt": prompts[0].tolist(),
                                "max_new_tokens": st["max_new"],
                                "stream": True, "stop": [stop]},
                               CLUSTER_REQUEST_S)
        d = events[-1]
        streamed = "".join(e.get("text", "") for e in events[:-1])
        want_text = "".join(f"t{t} " for t in greedy[0][:k])
        if status != 200 or d.get("finish_reason") != "stop" or \
                d.get("matched_stop") != stop or \
                d.get("token_ids") != greedy[0][:k] or \
                d.get("text") != want_text or streamed != want_text:
            fail(f"cluster {name}: stop string {stop!r}: {d}")
        # SIGTERM: every worker exits 0 and none is left
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            fail(f"cluster {name}: the launcher did not exit on SIGTERM")
        time.sleep(0.5)                  # the reader's last lines
        left = [p for p in pids if _pid_alive(p)]
        if rc != 0 or "workers exited with [0, 0]" not in lines or left:
            fail(f"cluster {name}: exit {rc}, workers left {left}, last "
                 f"lines {lines[-3:]}")
        p4 = report[f"serve {name}"]
        ttft = [d["ttft_s"] for d in done]
        tpot = [d["tpot_s"] for d in done]
        report[f"cluster {name}"] = dict(
            boot_s=boot_s, replicas=CLUSTER_REPLICAS, requests=len(done),
            tokens=received, wall_s=wall, tok_per_s=received / wall,
            ttft_s=ttft, tpot_s=tpot,
            client_s=[r[2] for r in res], launches_by_replica=launches,
            model_calls=steps, tokens_by_replica=toks, stop=stop,
            stop_tokens=k, boot_lines=boots,
            phase4_tok_per_s=p4["tok_per_s"],
            phase4_ttft_p50_s=p4["ttft_p50_s"],
            phase4_tpot_p50_s=p4["tpot_p50_s"],
            # the path's counts: the replicas' sums, read through /metrics
            # before the stop-string request
            launches={k_: sum(c.get(k_, 0) for c in launches.values())
                      for k_ in KERNELS})
        print(f"cluster: {name} x {CLUSTER_REPLICAS} replicas on one card: "
              f"boot {boot_s:.1f} s; {len(done)} concurrent requests "
              f"({len(done) // 2} by SSE), tokens equal to phase 4's, "
              f"{received} tokens in {wall:.3f} s = {received / wall:.2f} "
              f"tok/s (phase 4 {p4['tok_per_s']:.2f}); TTFT ms "
              f"{[round(x * 1e3, 1) for x in ttft]} (phase 4 p50 "
              f"{p4['ttft_p50_s'] * 1e3:.1f}), TPOT ms "
              f"{[round(x * 1e3, 2) for x in tpot]} (phase 4 p50 "
              f"{p4['tpot_p50_s'] * 1e3:.2f}); tokens by replica {toks}, "
              f"launches {launches}; stop {stop!r} trimmed to {k} tokens; "
              f"SIGTERM: workers exited with [0, 0], none left")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        for p in pids:
            if _pid_alive(p):
                os.kill(p, 9)


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


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


def _component_fns(torch, arch, params):
    """{component name of the 4-layer plan: (fn, args)}: the embedding,
    one ``attn`` mixer (norm1 + attention with the flash kernel), one MLP
    (norm2 + SwiGLU) and the head (final norm, head, loss), each forward
    and backward (the cost model's train t_comp is three forwards) on
    phase 8's batch shape."""
    from repro_torch import tree
    from repro_torch.models import blocks as B
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    B_, S = TRAIN[QWEN]["batch"], TRAIN[QWEN]["seq_len"]
    gen = torch.Generator(device="cuda").manual_seed(5)
    tok = torch.randint(0, arch.vocab, (B_, S), generator=gen,
                        device="cuda")
    x = torch.randn((B_, S, arch.d_model), generator=gen, device="cuda",
                    dtype=torch.bfloat16).requires_grad_()
    layer = T._take(params["segments"][0]["b0"], 0)
    live = tree.map(lambda t: t.detach().requires_grad_(), {
        "embed": params["embed"], "final_norm": params["final_norm"],
        "head": params["head"], "layer": layer})
    cfg = B.attn_cfg_for(arch)

    def run(out):
        torch.autograd.backward(out, torch.ones_like(out))

    def embed(p, t):
        run(L.embed(p["embed"], t, arch.d_model))

    def mixer(p, h):
        y, _ = L.attention(p["layer"]["attn"], cfg,
                           B.norm_apply(arch, p["layer"]["norm1"], h),
                           impl="pallas")
        run(h + y)

    def ffn(p, h):
        run(h + L.mlp(p["layer"]["mlp"],
                      B.norm_apply(arch, p["layer"]["norm2"], h), arch.act))

    def head(p, h, t):
        hid = B.norm_apply(arch, p["final_norm"], h)
        loss = T.lm_loss(T._head(p, arch, hid), t, arch.vocab)
        loss.backward()
    return {"embed": (embed, (live, tok)),
            "seg0/b0:attn.mixer": (mixer, (live, x)),
            "seg0/b0:attn.ffn": (ffn, (live, x)),
            "head": (head, (live, x, tok))}


def plan_phase(torch, report, arch_full, card):
    """Phase 33: the ASA planner for the H100 (``H100_SXM``): qwen3-8b at
    phase 8's 2 layers on a 1 x 1 mesh at phase 8's shape, the whole model
    on (1, 1) (it must come out infeasible: its training state does not
    fit one card), (16, 16) and (2, 16, 16) (host-only planning), the
    DP / MP / HP baselines; then ``ComponentProfiler`` times the
    embedding, one attn mixer, one MLP and the head forward and backward
    between CUDA events, ``calibrate`` turns measured / predicted into
    factors, and the re-planned step time stands beside phase 8's."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.asa import AdaptiveScheduler
    from repro_torch.core.costmodel import MeshShape
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    arch = cut_depth(arch_full, TRAIN[QWEN]["depth"])
    shape = ShapeSpec("chip", TRAIN[QWEN]["seq_len"], TRAIN[QWEN]["batch"],
                      "train")
    sched = AdaptiveScheduler(H100_SXM, faithful=False)
    sp = sched.plan(arch, shape, MeshShape(1, 1))
    print(sp.summary())
    if not sp.plan.feasible:
        fail(f"plan: {arch.name} at {arch.n_layers} layers is infeasible "
             f"on one H100")
    whole = {}
    for ms in (MeshShape(1, 1), MeshShape(16, 16), MeshShape(16, 16, pod=2)):
        w = sched.plan(arch_full, shape, ms)
        print(w.summary())
        whole[f"{ms.pod}x{ms.data}x{ms.model}"] = dict(
            method=w.plan.method, feasible=w.plan.feasible,
            mem_per_device_gb=w.plan.cost["mem_per_device"] / 1e9,
            time_ms=w.plan.cost["time"] * 1e3)
    if whole["1x1x1"]["feasible"]:
        fail(f"plan: the whole {arch_full.name} came out feasible on one "
             f"card ({whole['1x1x1']['mem_per_device_gb']:.1f} GB)")
    base = {k: dict(method=p.method, feasible=p.feasible,
                    time_ms=p.cost["time"] * 1e3,
                    mem_per_device_gb=p.cost["mem_per_device"] / 1e9)
            for k, p in sched.baselines(arch, shape, MeshShape(1, 1)).items()}
    print("plan: baselines on (1, 1): " + "; ".join(
        f"{k} {v['method']} {v['time_ms']:.2f} ms {v['mem_per_device_gb']:.2f}"
        f" GB feasible={v['feasible']}" for k, v in base.items()))

    # one layer at full width is enough to time a component
    one = cut_depth(arch_full, (1,))
    params = T.init_lm(one, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(4))
    cm = sched._cost_model(MeshShape(1, 1), "train",
                           microbatches=sp.microbatches)
    predicted = {c.name: cm.component_cost(c, sp.assignment[c.name]).t_comp
                 for c in sp.comps}
    counts = {c.name: c.count for c in sp.comps}
    measured = {}
    for name, (fn, args) in _component_fns(torch, arch, params).items():
        r = sched.profiler.profile(name, fn, *args, iters=10)
        measured[name] = r.mean_s * counts[name]
    factors = {n: measured[n] / predicted[n] for n in measured}
    before = sp.plan.cost["time"]
    sched.calibrate(measured, predicted)
    sp2 = sched.replan(arch, shape, MeshShape(1, 1))
    step8 = report[f"train {arch.name}"]["step_ms_median"]
    print("plan: measured / predicted t_comp (CUDA events, forward + "
          "backward x applications, on " + card + "): " + "; ".join(
              f"{n} {measured[n] * 1e3:.3f} / {predicted[n] * 1e3:.3f} ms = "
              f"{factors[n]:.3f}" for n in measured))
    print(f"plan: predicted step {before * 1e3:.2f} ms, re-planned with "
          f"calibration {sp2.plan.cost['time'] * 1e3:.2f} ms "
          f"({sp2.plan.method}), phase 8 measured {step8:.2f} ms (the "
          f"components leave out the optimizer)")
    report["plan"] = dict(
        summary=sp.summary(), whole=whole, baselines=base,
        measured_s=measured, predicted_s=predicted, factors=factors,
        predicted_step_ms=before * 1e3,
        replanned_step_ms=sp2.plan.cost["time"] * 1e3,
        replanned_method=sp2.plan.method, phase8_step_ms=step8,
        phase_s=time.perf_counter() - t_phase)
    del params


def _dir_bytes(path):
    return sum(f.stat().st_size for f in pathlib.Path(path).rglob("*")
               if f.is_file())


def trainer_phase(torch, report, arch_full, card):
    """Phase 34: the Trainer on a 1 x 1 DeviceMesh over a world-1 NCCL
    group (the multi-rank code path: DTensor params and moments, gathers
    and reductions through DTensor) trains qwen3-8b at full width and
    phase 8's depth, bf16, impl="pallas", 6 steps with a checkpoint every
    4 (one, at step 4); launches per step equal phase 8's; a fresh Trainer
    restores step 4 bit for bit and replays 5-6 to the same losses
    (deterministic algorithms on); then the train launcher twice, the
    second resuming."""
    import dataclasses
    import shutil
    import warnings
    from unittest import mock

    from repro_torch import tree
    from repro_torch.checkpoint import store
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.components import param_count
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import mesh as M
    from repro_torch.runtime.trainer import TrainConfig, Trainer

    t_phase = time.perf_counter()
    label = f"trainer {arch_full.name}"
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        depth = TRAIN[QWEN]["depth"]
        free = shutil.disk_usage(ckdir).free
        # room for two checkpoints of bf16 params and fp32 moments:
        # cut depth, never width, until they fit
        while depth[0] > 1:
            if 2 * 10 * param_count(cut_depth(arch_full, depth)) < 0.9 * free:
                break
            depth = (depth[0] - 1,)
        arch = cut_depth(arch_full, depth)
        if depth != TRAIN[QWEN]["depth"]:
            print(f"trainer: {free / 1e9:.1f} GB free for checkpoints: depth "
                  f"cut to {depth[0]}")
        cfg = TrainConfig(lr=TRAIN[QWEN]["peak_lr"],
                          warmup_steps=TRAIN[QWEN]["warmup"],
                          total_steps=TRAIN[QWEN]["total"],
                          checkpoint_every=4, impl="pallas")
        shape = ShapeSpec("chip", TRAIN[QWEN]["seq_len"],
                          TRAIN[QWEN]["batch"], "train")
        mesh = M.make_host_mesh(device="cuda")
        torch.use_deterministic_algorithms(True, warn_only=True)
        # keep torch.empty's memory as phase 8 has it (deterministic mode
        # would fill it with NaN first: extra fills, and a kernel's padded
        # scratch is not written before it is read)
        torch.utils.deterministic.fill_uninitialized_memory = False
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tr = Trainer(arch, shape, mesh, cfg, checkpoint_dir=ckdir)
        print(tr.plan.summary())
        t0 = time.perf_counter()
        params, opt = tr.init_state()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        data = SyntheticLM(arch.vocab, shape.seq_len, shape.global_batch)
        writes = []
        real_save = store.save_pytree

        def timed_save(path, t, **kw):
            t0 = time.perf_counter()
            real_save(path, t, **kw)
            writes.append((str(path), time.perf_counter() - t0))
        want = train_launches(arch)
        losses, step_ms, snap_s, counts_all = [], [], [], {}
        nondet = []
        with mock.patch.object(store, "save_pytree", timed_save), \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for i in range(6):
                reset_counts()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                t0 = time.perf_counter()
                params, opt, h = tr.train(params, opt, data, steps=1)
                t1 = time.perf_counter()
                e1.record()
                e1.synchronize()
                c = read_counts()
                for k, n in c.items():
                    counts_all[k] = counts_all.get(k, 0) + n
                if any(c.get(k, 0) != n for k, n in want.items()):
                    fail(f"{label}: step {i + 1} launched {c}, phase 8's "
                         f"step {want}")
                losses.append(h[0]["loss"])
                step_ms.append(e0.elapsed_time(e1))
                if tr.step % cfg.checkpoint_every == 0:
                    snap_s.append(t1 - t0 - h[0]["step_time_s"])
                if tr.step == 4:        # what the checkpoint holds, on the card
                    saved4 = [(k, x.to_local().clone()
                               if hasattr(x, "to_local") else x)
                              for k, x in store._flat_with_paths(
                                  {"params": params, "opt": opt})]
            t0 = time.perf_counter()
            tr.ckpt.wait()
            tail_s = time.perf_counter() - t0
            nondet = sorted({str(w.message).split(" does not have")[0]
                             for w in caught if "deterministic" in
                             str(w.message)})
        peak = torch.cuda.max_memory_allocated() / 1e9
        ck_bytes = _dir_bytes(pathlib.Path(ckdir) / "step_0000000004")
        med = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
        step8 = report[f"train {arch.name}"]["step_ms_median"] \
            if f"train {arch.name}" in report else None
        losses8 = report.get(f"train {arch.name}", {}).get("losses")
        print(f"trainer: {arch.name} on a 1 x 1 NCCL mesh, 6 steps: "
              f"{', '.join(f'{t:.2f}' for t in step_ms)} ms, median of "
              f"steps 2-6 {med:.2f} ms (phase 8: {step8} ms), init "
              f"{init_s:.1f} s, peak memory {peak:.2f} GB on {card}; "
              f"losses {[round(x, 6) for x in losses]} (phase 8's first 4: "
              f"{None if losses8 is None else [round(x, 6) for x in losses8]})"
              f"; launches a step {want}")
        print(f"trainer: checkpoint {ck_bytes / 1e9:.2f} GB, host snapshot "
              f"{', '.join(f'{s:.2f}' for s in snap_s)} s (in the step that "
              f"saved), writes {', '.join(f'{s:.2f}' for _, s in writes)} s "
              f"(in the background; {tail_s:.2f} s waited at the end)")

        # a fresh Trainer restores step 4 and replays 5-6
        keep = [(t.full_tensor() if hasattr(t, "full_tensor") else t)
                for t in tree.leaves(params)]
        keep_losses = losses[4:]
        del params, opt
        gc.collect()
        torch.cuda.empty_cache()
        tr2 = Trainer(arch, shape, mesh, dataclasses.replace(
            cfg, checkpoint_every=1000), checkpoint_dir=ckdir)
        p2, o2 = tr2.init_state(seed=1)
        t0 = time.perf_counter()
        p2, o2 = tr2.maybe_restore(p2, o2, step=4)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if tr2.step != 4 or tr2.data_offset != 4:
            fail(f"{label}: restored step {tr2.step}, data offset "
                 f"{tr2.data_offset}")
        flat = store._flat_with_paths({"params": p2, "opt": o2})
        unequal = [k for (k, x), (k4, y) in zip(flat, saved4)
                   if k != k4 or not (torch.equal(x.to_local(), y)
                                      if hasattr(x, "to_local") else x == y)]
        del saved4
        if unequal:
            fail(f"{label}: restored leaves differ from the checkpoint: "
                 f"{unequal[:5]}")
        replay = []
        for _ in keep_losses:
            p2, o2, h = tr2.train(p2, o2, SyntheticLM(
                arch.vocab, shape.seq_len, shape.global_batch).skip(
                tr2.data_offset), steps=1)
            replay.append(h[0]["loss"])
        same = all(torch.equal(a.full_tensor(), b)
                   for a, b in zip(tree.leaves(p2), keep))
        tol = 0.0 if not nondet else 1e-6
        if not all(abs(a - b) <= tol * abs(b)
                   for a, b in zip(replay, keep_losses)) or \
                (not nondet and not same):
            fail(f"{label}: replayed losses {replay} vs {keep_losses}; "
                 f"params equal {same}; nondeterministic ops {nondet}")
        print(f"trainer: restored step 4 in {restore_s:.2f} s, every leaf "
              f"bit-equal to the state saved at step 4 ({len(flat)} "
              f"leaves); replayed "
              f"losses {replay} {'==' if tol == 0 else 'within 1e-6 of'} "
              f"{keep_losses}; params after step 6 bit-equal: {same}; "
              f"ops without a deterministic CUDA form: {nondet or 'none'}")
        del p2, o2, keep
        gc.collect()
        torch.cuda.empty_cache()
        torch.use_deterministic_algorithms(False)

        # the launcher, twice: the second run resumes from the manifest
        runs = []
        cli_dir = pathlib.Path(ckdir) / "cli"
        for _ in range(2):
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                 QWEN, "--smoke", "--steps", "8", "--checkpoint-dir",
                 str(cli_dir)], capture_output=True, text=True, timeout=600,
                cwd=ROOT, env={**os.environ, "PYTHONPATH": str(SRC)})
            runs.append((r, time.perf_counter() - t0))
            if r.returncode != 0:
                fail(f"{label}: the train launcher exited {r.returncode}: "
                     f"{r.stderr[-2000:]}")
        out1, out2 = runs[0][0].stdout, runs[1][0].stdout
        if "resumed from step 8" not in out2 or "resumed" in out1:
            fail(f"{label}: the launcher did not resume: {out2[-800:]}")
        print(f"trainer: launcher --arch {QWEN} --smoke --steps 8 twice: "
              f"{runs[0][1]:.1f} s / {runs[1][1]:.1f} s; "
              f"{out1.strip().splitlines()[-1]!r}, then "
              f"{[ln for ln in out2.splitlines() if 'resumed' in ln][0]!r}, "
              f"{out2.strip().splitlines()[-1]!r}")
        report[label] = dict(
            layers=arch.n_layers, step_ms=step_ms, step_ms_median=med,
            phase8_step_ms_median=step8, losses=losses,
            phase8_losses=losses8, launches=counts_all,
            launches_per_step=want, peak_mem_gb=peak, init_s=init_s,
            checkpoint_bytes=ck_bytes, snapshot_s=snap_s,
            write_s=[s for _, s in writes], wait_s=tail_s,
            restore_s=restore_s, replay_losses=replay,
            params_bit_equal=same, nondeterministic_ops=nondet,
            launcher_s=[t for _, t in runs],
            phase_s=time.perf_counter() - t_phase)
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(ckdir, ignore_errors=True)
        M.shutdown()


def card_images(torch, batch, dtype):
    """A ``SyntheticImages`` batch on the card: images in ``dtype`` (the
    ViT computes in the promoted type of its images and params), int32
    labels."""
    return (torch.as_tensor(batch["images"], device="cuda").to(dtype),
            torch.as_tensor(batch["labels"], device="cuda"))


def cpu_logits_check(torch, label, apply_fn, params, images):
    """The card's logits of ``images`` against the same params' forward on
    the CPU (the kernels' plain versions there) -> max |diff|; fails past
    ``VISION_LOGIT_TOL``."""
    from repro_torch import tree
    with torch.no_grad():
        got = apply_fn(params, images).cpu()
        want = apply_fn(tree.map(lambda t: t.cpu(), params), images.cpu())
    err = float((got - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    print(f"{label}: logits of {images.shape[0]} images on the card vs the "
          f"CPU forward: max |diff| {err:.3g} (max |logit| "
          f"{float(want.abs().max()):.4g}, tol {VISION_LOGIT_TOL} x "
          f"{scale:.4g})")
    if not (torch.isfinite(got).all() and err <= VISION_LOGIT_TOL * scale):
        fail(f"{label}: card logits differ from the CPU forward by {err}")
    return err


def image_steps(torch, label, apply_fn, params, data, steps, dtype,
                profile=False):
    """``steps`` of the reference demo's train step (``paper_repro_asa.
    make_image_step``: loss, grads, clip to 1.0, ``adamw(1e-3,
    weight_decay=0.01)``) on ``data``'s batches, each between CUDA events
    -> (a report: step times, the median of steps 2 on, peak memory,
    launches, losses, accuracies; params).  With ``profile``, one more
    step traced."""
    from repro_torch.examples import paper_repro_asa as ASA
    opt_init, step = ASA.make_image_step(apply_fn)
    state = opt_init(params)
    batches = [card_images(torch, next(data), dtype) for _ in range(steps)]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    marks, out = [], []
    for images, labels in batches:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        params, state, loss, acc = step(params, state, images, labels)
        e1.record()
        marks.append((e0, e1))
        out.append((loss, acc))
    torch.cuda.synchronize()
    counts = read_counts()
    step_ms = [a.elapsed_time(b) for a, b in marks]
    med = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    rep = dict(step_ms=step_ms, step_ms_median=med,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               mem_before_steps_gb=base, launches=counts,
               launches_per_step={k: c / steps for k, c in counts.items()},
               losses=[float(x) for x, _ in out],
               accuracies=[float(a) for _, a in out])
    if not all(math.isfinite(x) for x in rep["losses"]):
        fail(f"{label}: losses {rep['losses']} not finite")
    if profile:
        images, labels = batches[-1]

        def one_step():
            nonlocal params, state
            params, state, _, _ = step(params, state, images, labels)
        rep["profile"] = traced(torch, label, one_step)
    return rep, params


def _check_flash_launches(label, counts, per_step):
    """Each step launches the flash forward and backward ``per_step`` times
    each (one a layer) and no other kernel of the repo's."""
    want = {k: 0 for k in KERNELS}
    want["flash_attention"] = want["flash_attention_bwd"] = per_step
    if counts != want:
        fail(f"{label}: launches {counts}, want {want}")


def vit_phase(torch, report, card, profile=False):
    """Phase 35: ViT-B at CIFAR-100's widths (``ViTConfig()``, 65 tokens,
    head dim 64) at batch 256, seeded weights, through the flash kernel
    forward and backward (bidirectional): step 1's loss and per-leaf
    grads against the same params through the plain flash, in fp32; the
    logits of 8 images against the CPU forward; 6 AdamW steps (median of
    2-6, peak memory, 24 flash launches a step); the 6 steps again in
    bf16 (bf16 params and images: a bf16 forward and backward)."""
    from unittest import mock

    from repro_torch import tree
    from repro_torch.data import SyntheticImages
    from repro_torch.examples import paper_repro_asa as ASA
    from repro_torch.kernels import ops, ref
    from repro_torch.models import vision as V
    from repro_torch.optim import optimizers as O
    from repro_torch.runtime import steps as ST

    t_phase = time.perf_counter()
    label = f"train {VIT_B}"
    cfg, B, steps = V.ViTConfig(), PAPER[VIT_B]["batch"], PAPER[VIT_B]["steps"]

    def apply(p, x):
        return V.vit_apply(p, cfg, x)
    params = V.init_vit(cfg, device="cuda", seed=0)
    names = tree.names(params)
    n_params = sum(t.numel() for t in tree.leaves(params))
    data = SyntheticImages(cfg.n_classes, cfg.image_size, B, seed=0)
    images, labels = card_images(torch, next(data), torch.float32)
    print(f"{label}: ViT-B d_model {cfg.d_model}, {cfg.n_layers} layers, "
          f"{cfg.n_heads} heads, patch {cfg.patch} ({cfg.n_patches + 1} "
          f"tokens), {n_params / 1e6:.2f} M params, batch {B}, fp32")

    # step 1's grads through the kernels and through the plain flash
    loss_fn = ASA.image_loss(apply)
    reset_counts()
    loss_k, _, g_k = ST.loss_and_grads(loss_fn, params, images, labels)
    grad_counts = read_counts()
    with mock.patch.object(ops, "flash_attention", ref.flash_attention_ref):
        loss_p, _, g_p = ST.loss_and_grads(loss_fn, params, images, labels)
    _check_flash_launches(f"{label} grad check", grad_counts, cfg.n_layers)
    gn_k, gn_p = float(O.global_norm(g_k)), float(O.global_norm(g_p))
    zero = {n: max(float(torch.linalg.vector_norm(g[i])) / gn
                   for g, gn in ((g_k, gn_k), (g_p, gn_p)))
            for i, n in enumerate(names) if n.endswith(ZERO_GRAD_LEAF)}
    diffs = {n: d for n, d in grad_diffs(torch, names, g_k, g_p).items()
             if n not in zero}
    bad = [f"{n}: cos {c:.6f}, rel L2 {r:.3g}" for n, (c, r) in diffs.items()
           if not (c >= GRAD_COS_MIN and r <= GRAD_REL_L2_MAX)]
    bad += [f"{n}: |grad| {z:.3g} of the global norm" for n, z in
            zero.items() if not z <= ZERO_GRAD_REL_MAX]
    if not abs(gn_k - gn_p) <= GRAD_NORM_REL_TOL * gn_p:
        bad.append(f"grad norm {gn_k} vs plain {gn_p}")
    if not (math.isfinite(gn_k) and math.isfinite(float(loss_k))):
        bad.append(f"grad norm {gn_k} / loss {float(loss_k)} not finite")
    cos_leaf = min(diffs, key=lambda n: diffs[n][0])
    print(f"{label}: step 1's grads through the flash kernel vs the plain "
          f"flash: {len(names)} leaves, worst cosine "
          f"{diffs[cos_leaf][0]:.8f} at {cos_leaf}, worst rel L2 "
          f"{worst(diffs, text=True)}; key biases (grad 0 in exact "
          f"arithmetic) at most {max(zero.values()):.3g} of the global norm; "
          f"grad norm {gn_k:.6g} vs {gn_p:.6g}; loss {float(loss_k):.6f} vs "
          f"{float(loss_p):.6f}; launches {grad_counts}")
    if bad:
        fail(f"{label}: kernel grads differ from the plain path's: {bad}")
    check = dict(worst_cos=diffs[cos_leaf][0], worst_cos_leaf=cos_leaf,
                 worst_rel_l2=worst(diffs)[1], worst_rel_l2_leaf=worst(diffs)[0],
                 grad_norm_kernels=gn_k, grad_norm_plain=gn_p,
                 loss_kernels=float(loss_k), loss_plain=float(loss_p),
                 zero_grad_leaves=zero)
    del g_k, g_p
    logit_err = cpu_logits_check(torch, label, apply, params,
                                 images[:VISION_CHECK_BATCH])

    run, params = image_steps(torch, label, apply, params, data, steps,
                              torch.float32, profile)
    _check_flash_launches(label, run["launches"], cfg.n_layers * steps)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cfg16 = V.ViTConfig(dtype="bfloat16")
    params = V.init_vit(cfg16, device="cuda", seed=0)
    run16, params = image_steps(
        torch, f"{label} bf16", lambda p, x: V.vit_apply(p, cfg16, x),
        params, SyntheticImages(cfg.n_classes, cfg.image_size, B, seed=0),
        steps, torch.bfloat16, profile)
    _check_flash_launches(f"{label} bf16", run16["launches"],
                          cfg.n_layers * steps)
    for dn, r in (("fp32", run), ("bf16", run16)):
        print(f"{label}: {steps} AdamW steps of {B} images, {dn}: step "
              f"{', '.join(f'{t:.2f}' for t in r['step_ms'])} ms, median of "
              f"steps 2-{steps} {r['step_ms_median']:.2f} ms = "
              f"{B / r['step_ms_median'] * 1e3:.0f} images/s, peak memory "
              f"{r['peak_mem_gb']:.2f} GB on {card}; losses "
              f"{[round(x, 5) for x in r['losses']]}; launches a step "
              f"{r['launches_per_step']}")
    report[label] = dict(params=n_params, batch=B, grad_check=check,
                         logits_max_abs_diff=logit_err, **run, bf16=run16,
                         phase_s=time.perf_counter() - t_phase)
    del params


def resnet_phase(torch, report, card, profile=False):
    """Phase 36: ResNet-50 with its CIFAR stem (``ResNetConfig()``) at batch
    256, fp32, seeded weights: the logits of 8 images against the CPU
    forward, step 1's loss and grads finite, 6 AdamW steps (median of
    2-6, peak memory).  It launches no kernel of the repo's: its convs are
    library convolutions, as in the reference (no Pallas kernel)."""
    from repro_torch import tree
    from repro_torch.data import SyntheticImages
    from repro_torch.examples import paper_repro_asa as ASA
    from repro_torch.models import vision as V
    from repro_torch.runtime import steps as ST

    t_phase = time.perf_counter()
    label = f"train {RESNET}"
    cfg = V.ResNetConfig()
    B, steps = PAPER[RESNET]["batch"], PAPER[RESNET]["steps"]

    def apply(p, x):
        return V.resnet_apply(p, cfg, x)
    params = V.init_resnet(cfg, device="cuda", seed=0)
    n_params = sum(t.numel() for t in tree.leaves(params))
    data = SyntheticImages(cfg.n_classes, cfg.image_size, B, seed=0)
    images, labels = card_images(torch, next(data), torch.float32)
    print(f"{label}: stages {cfg.stage_sizes}, width {cfg.width}, CIFAR "
          f"stem, {n_params / 1e6:.2f} M params, batch {B}, fp32")
    logit_err = cpu_logits_check(torch, label, apply, params,
                                 images[:VISION_CHECK_BATCH])
    loss, _, grads = ST.loss_and_grads(ASA.image_loss(apply), params,
                                       images, labels)
    finite = math.isfinite(float(loss)) and all(
        bool(torch.isfinite(g).all()) for g in grads)
    print(f"{label}: step 1's loss {float(loss):.6f}, grads finite: {finite}")
    if not finite:
        fail(f"{label}: step 1's loss or grads not finite")
    del grads
    run, params = image_steps(torch, label, apply, params, data, steps,
                              torch.float32, profile)
    if any(run["launches"].values()):
        fail(f"{label}: launched {run['launches']}: ResNet-50 runs no "
             f"kernel of the repo's")
    print(f"{label}: {steps} AdamW steps of {B} images, fp32: step "
          f"{', '.join(f'{t:.2f}' for t in run['step_ms'])} ms, median of "
          f"steps 2-{steps} {run['step_ms_median']:.2f} ms = "
          f"{B / run['step_ms_median'] * 1e3:.0f} images/s, peak memory "
          f"{run['peak_mem_gb']:.2f} GB on {card}; losses "
          f"{[round(x, 5) for x in run['losses']]}; no kernel of the repo's "
          f"launched (library convolutions and BatchNorm, no TPU kernel "
          f"in the reference's ResNet)")
    report[label] = dict(params=n_params, batch=B,
                         logits_max_abs_diff=logit_err, **run,
                         phase_s=time.perf_counter() - t_phase)
    del params


def _vit_component_fns(torch, cfg, params, images, labels):
    """{component of ``paper_repro.vit_b16_components``: (fn, args)}: the
    embedding, one attention (norm1 + attention + residual), one MLP
    (norm2 + MLP + residual) and the head (final norm, head, loss), each
    forward and backward."""
    import torch.nn.functional as F

    from repro_torch import tree
    from repro_torch.models import vision as V
    live = tree.map(lambda t: t.detach().requires_grad_(), params)
    layer = tree.map(lambda t: t[0], live["layers"])
    with torch.no_grad():
        x = V._embed(params, cfg, images)
    x.requires_grad_()

    def run(out):
        torch.autograd.backward(out, torch.ones_like(out))

    def head(p, h, y):
        logp = F.log_softmax(V._head(p, h), dim=-1)
        (-torch.gather(logp, -1, y[:, None].long()).mean()).backward()
    return {"embed": (lambda p, im: run(V._embed(p, cfg, im)),
                      (live, images)),
            "layer0/attn": (lambda lp, h: run(V._mixer(lp, cfg, h)),
                            (layer, x)),
            "layer0/mlp": (lambda lp, h: run(V._ffn(lp, h)), (layer, x)),
            "head": (head, (live, x, labels))}


def paper_phase(torch, report, card, profile=False):
    """Phase 37: the paper's tables from the port (``examples.paper_repro``
    at the V100 profile: Table I, Fig 3, Fig 6 for both models); the
    reference demo's reduced ViT trained 150 steps on the card (accuracy
    past 0.5 at the last step); ViT-B/16 at 224 (197 tokens) at batch 64,
    fp32 and bf16, beside the single-card step ``_gpu_step`` predicts for
    it at ``H100_SXM``; ``ComponentProfiler``'s measured / predicted for
    the embedding, one attention, one MLP and the head (bf16)."""
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.profiler import ComponentProfiler
    from repro_torch.core.strategy import Strategy
    from repro_torch.data import SyntheticImages
    from repro_torch.examples import paper_repro as PR
    from repro_torch.examples import paper_repro_asa as ASA
    from repro_torch.models import vision as V

    t_phase = time.perf_counter()
    tables = {}
    for model in ("vit", "resnet50"):
        t1, f3 = PR.table1(model), PR.fig3_comm(model)
        f6 = PR.fig6_strategy_map(model)
        print(f"paper {model}: Table I speedup over one V100, ours / the "
              f"paper's: " + "; ".join(
                  f"{k} {t1['ours_speedup'][k]:.2f}x / "
                  f"{t1['paper_speedup'][k]:.2f}x"
                  for k in ("DP", "MP", "HP", "adaptive"))
              + f"; adaptive over HP {t1['ours_adaptive_over_hp']:.3f} / "
                f"{t1['paper_adaptive_over_hp']:.3f}")
        print(f"paper {model}: Fig 3 communication share, ours / the "
              f"paper's: " + "; ".join(
                  f"{k} {f3['ours'][k]:.1f} / {f3['paper'][k]:.1f} %"
                  for k in ("DP", "MP", "HP", "adaptive")))
        print(f"paper {model}: Fig 6 the adaptive plan's strategy by "
              f"component: {f6}")
        tables[model] = dict(table1=t1, fig3=f3, fig6=f6)

    # the reference demo on the card
    label = f"train {VIT_DEMO}"
    reset_counts()
    t0 = time.perf_counter()
    hist = ASA.small_scale_training("cuda")
    demo_s = time.perf_counter() - t0
    demo_counts = read_counts()
    acc = hist[-1][1]
    print(f"{label}: {len(hist)} steps in {demo_s:.1f} s, accuracy "
          f"{acc:.4f} at the last step (must pass 0.5), loss "
          f"{hist[0][0]:.4f} -> {hist[-1][0]:.4f}; launches {demo_counts}")
    if not acc > 0.5:
        fail(f"{label}: accuracy {acc} at step {len(hist)}")
    _check_flash_launches(label, demo_counts,
                          ASA.DEMO_VIT.n_layers * len(hist))
    report[label] = dict(steps=len(hist), seconds=demo_s, accuracy=acc,
                         losses=[l for l, _ in hist], launches=demo_counts)

    # ViT-B/16 at 224, both dtypes, and the cost model's step for it
    label = f"train {VIT_224}"
    B, steps = PAPER[VIT_224]["batch"], PAPER[VIT_224]["steps"]
    runs = {}
    for dn, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        cfg = V.ViTConfig(image_size=224, patch=16,
                          dtype="float32" if dn == "fp32" else "bfloat16")
        params = V.init_vit(cfg, device="cuda", seed=0)
        runs[dn], params = image_steps(
            torch, f"{label} {dn}", lambda p, x, c=cfg: V.vit_apply(p, c, x),
            params, SyntheticImages(cfg.n_classes, 224, B, seed=0), steps,
            dt, profile)
        _check_flash_launches(f"{label} {dn}", runs[dn]["launches"],
                              cfg.n_layers * steps)
        if dn == "fp32":
            del params
            gc.collect()
            torch.cuda.empty_cache()
    comps = PR.vit_b16_components(B)
    dp = {c.name: Strategy.DP for c in comps}
    t_comp, t_comm, mem = PR._gpu_step(comps, n_gpus=1, dp=1, pp=1,
                                       strategies=dp, hw=H100_SXM)
    for dn, r in runs.items():
        print(f"{label}: {steps} AdamW steps of {B} images at 224 (197 "
              f"tokens), {dn}: step "
              f"{', '.join(f'{t:.2f}' for t in r['step_ms'])} ms, median of "
              f"steps 2-{steps} {r['step_ms_median']:.2f} ms = "
              f"{B / r['step_ms_median'] * 1e3:.0f} images/s, peak memory "
              f"{r['peak_mem_gb']:.2f} GB on {card}; launches a step "
              f"{r['launches_per_step']}")
    print(f"{label}: _gpu_step(vit_b16_components({B}), one card, all DP, "
          f"H100_SXM) predicts {t_comp * 1e3:.2f} ms of compute + "
          f"{t_comm * 1e3:.2f} ms of communication, {mem / 1e9:.2f} GB "
          f"(bf16 peak x {H100_SXM.matmul_efficiency}; no optimizer "
          f"term); measured fp32 {runs['fp32']['step_ms_median']:.2f}, "
          f"bf16 {runs['bf16']['step_ms_median']:.2f} ms")

    # measured / predicted per component, bf16 (the H100 profile's rate)
    cfg = V.ViTConfig(image_size=224, patch=16, dtype="bfloat16")
    images, labels = card_images(
        torch, next(SyntheticImages(cfg.n_classes, 224, B, seed=1)),
        torch.bfloat16)
    by_name = {c.name: c for c in comps}
    prof = ComponentProfiler()
    measured, predicted = {}, {}
    for name, (fn, args) in _vit_component_fns(torch, cfg, params, images,
                                               labels).items():
        measured[name] = prof.profile(name, fn, *args, iters=10).mean_s
        c = by_name[name]
        predicted[name] = PR._gpu_step([c], n_gpus=1, dp=1, pp=1,
                                       strategies={name: Strategy.DP},
                                       hw=H100_SXM)[0]
    factors = {n: measured[n] / predicted[n] for n in measured}
    print(f"{label}: measured / predicted t_comp a component (bf16, CUDA "
          f"events, forward + backward, on {card}): " + "; ".join(
              f"{n} {measured[n] * 1e3:.3f} / {predicted[n] * 1e3:.3f} ms "
              f"= {factors[n]:.3f}" for n in measured))
    report[label] = dict(batch=B, **runs["fp32"], bf16=runs["bf16"],
                         predicted_step_ms=(t_comp + t_comm) * 1e3,
                         predicted_mem_gb=mem / 1e9,
                         measured_s=measured, predicted_s=predicted,
                         factors=factors)
    report["paper"] = dict(tables=tables,
                           phase_s=time.perf_counter() - t_phase)
    del params


def uniform_scheduler(strategy):
    """The ASA scheduler for the H100 whose plan is ``strategy`` on every
    component (the reference's ``solve_uniform`` baseline), one
    microbatch."""
    from repro_torch.core import solver as SV
    from repro_torch.core.asa import AdaptiveScheduler
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.strategy import Strategy

    class Uniform(AdaptiveScheduler):
        def plan(self, arch, shape, mesh):
            sp = super().plan(arch, shape, mesh)
            cm = self._cost_model(mesh, shape.kind)
            sp.plan = SV.solve_uniform(cm, sp.comps, Strategy(strategy))
            sp.microbatches = 1
            return sp
    return Uniform(H100_SXM, faithful=False)


def _free_port():
    import socket
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def _spawn_ranks(label, phase, world=TP_MODEL, fn=None):
    """Runs ``fn`` (default ``tp_rank``) for ``phase`` in ``world``
    processes on the card -> rank 0's results."""
    return _join_ranks(label, *_start_ranks(fn or tp_rank, phase, world))


def _start_ranks(fn, phase, world):
    """Starts ``fn`` for ``phase`` in ``world`` processes on the card ->
    (their output directory, their processes) for ``_join_ranks``."""
    import torch.multiprocessing as mp

    out = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_tp_"))
    return out, mp.start_processes(fn, args=(world, _free_port(), str(out),
                                             phase),
                                   nprocs=world, join=False,
                                   start_method="spawn")


def _join_ranks(label, out, procs):
    """Waits for ``_start_ranks``'s processes -> rank 0's results."""
    import shutil

    try:
        while not procs.join():
            pass
        if not (out / "tp.json").exists():
            fail(f"{label}: the ranks exited without a result")
        return json.loads((out / "tp.json").read_text())
    finally:
        shutil.rmtree(out, ignore_errors=True)


def _train_line(t, card):
    """The printed summary of a TP train part (``tp_train``)."""
    return (f"step 1 loss {t['loss']:.6f} vs unplaced "
            f"{t['loss_unplaced']:.6f}, grad norm {t['grad_norm']:.6g} vs "
            f"{t['grad_norm_unplaced']:.6g}, {t['n_leaves']} gathered grads: "
            f"worst cosine {t['worst_cos']:.6f} at {t['worst_cos_leaf']}, "
            f"worst rel L2 {t['worst_rel_l2']:.4g} at "
            f"{t['worst_rel_l2_leaf']}; {len(t['step_s'])} steps: "
            f"{', '.join(f'{x * 1e3:.1f}' for x in t['step_s'])} ms (median "
            f"of 2-{len(t['step_s'])} {t['step_ms_median']:.1f} ms; the "
            f"unplaced step on one process {t['unplaced_step_ms']:.1f} ms), "
            f"losses {[round(x, 5) for x in t['losses']]}; rank 0's launches "
            f"a step {t['launches_per_step']}; all-reduces a step "
            f"{t['tp_all_reduces_per_step']} "
            f"({t['tp_all_reduce_mb_per_step']:.1f} MB), weight gathers a "
            f"step {t['gathers_per_step']}; peak memory "
            f"{t['peak_mem_gb']:.2f} GB a rank, on {card}")


def _serve_line(sv):
    """The printed summary of a placed serve (``tp_serve``,
    ``tp_moe_serve``)."""
    return (f"tokens equal the unplaced engine's; {sv['prefills']} prefill "
            f"calls' logits within {sv['worst_logit_rel']:.3g} of max "
            f"|logit| (max {TP_LOGIT_TOL:g}); blocks {sv['block_fns']}; "
            f"{sv['tokens']} tokens in {sv['wall_s']:.2f} s = "
            f"{sv['tok_per_s']:.1f} tok/s (unplaced "
            f"{sv['unplaced_tok_per_s']:.1f}); launches {sv['launches']}")


def tp_phase(torch, report, card):
    """40. zamba2-2.7b tensor-parallel on the one card: TP_MODEL processes
    on a (data 1, model TP_MODEL) mesh over gloo, under the uniform MP plan
    (``tp_rank``); the ranks' results printed and kept."""
    res = _spawn_ranks(TP_NAME, 40)
    t, sv = res["train"], res["serve"]
    report[TP_NAME] = dict(res, launches=t["launches"])
    print(f"tp: {ZAMBA} at {t['layers']} layers (2 x 2560 shared block, 12 "
          f"mamba2), {TP_MODEL} ranks of a (1, {TP_MODEL}) mesh over "
          f"{res['backend']} on one card, uniform MP ({t['method']}): "
          f"x_proj working {t['x_proj']}, SSD heads {t['ssd_heads']}; "
          + _train_line(t, card))
    print(f"tp: placed fp32 serve of {sv['requests']} requests on the mesh: "
          + _serve_line(sv))


def tp_moe_phase(torch, report, card):
    """41. deepseek-v3-671b tensor- and expert-parallel on the one card, on
    phase 40's mesh and plan (``tp_rank``); the ranks' results printed and
    kept."""
    res = _spawn_ranks(TP_MOE_NAME, 41)
    t, sv, ep = res["train"], res["serve"], res["ep"]
    dec = sv["contiguous"]
    report[TP_MOE_NAME] = dict(res, launches=t["launches"])
    report[TP_DECODE_NAME] = dict(dec, launches=dec["launches"])
    report[TP_EP_NAME] = dict(ep, launches=ep["launches"])
    print(f"tp: {DEEPSEEK} at {t['layers']} mla_dense layer and the MTP "
          f"head, {TP_MODEL} ranks of a (1, {TP_MODEL}) mesh over "
          f"{res['backend']} on one card, uniform MP ({t['method']}): MLA "
          f"heads a rank {t['mla_heads']} of 128; " + _train_line(t, card))
    print(f"tp: placed fp32 serve of {DEEPSEEK} at 1 mla_dense + 1 mla "
          f"layer, all 256 experts, {sv['requests']} requests: experts a "
          f"rank {sv['experts']}, MLA heads {sv['mla_heads']}, latent pools "
          f"equal across the ranks ({sv['pool_digest']}); peak memory "
          f"{sv['peak_mem_gb']:.2f} GB a rank (unplaced "
          f"{sv['unplaced_peak_mem_gb']:.2f} GB); " + _serve_line(sv))
    print(f"tp: contiguous fp32 prefill + {TP_DECODE_STEPS} decode steps of "
          f"the serve's prompts through {dec['blocks']}, the latents split "
          f"over `model` along time (local {dec['cache_local']}): tokens "
          f"equal the unplaced steps', logits within "
          f"{dec['worst_logit_rel']:.3g} of max |logit| (max "
          f"{TP_LOGIT_TOL:g}), {dec['latent_writes']} gathered latent "
          f"caches bit-equal across the ranks; {dec['wall_s']:.2f} s "
          f"(unplaced {dec['unplaced_wall_s']:.2f} s); launches "
          f"{dec['launches']}")
    print(f"tp: {DEEPSEEK}'s parts' seconds {res['part_s']}: serve "
          f"{sv['part_s']}, EP-major {ep['part_s']}")
    print(f"tp: EP-major {DEEPSEEK} at {ep['layers']} layers (1 mla_dense + "
          f"1 mla, all 256 experts), bf16, on a "
          f"({res['world']}, 1) mesh over gloo, uniform HP "
          f"({ep['method']}), experts a rank {ep['experts']}: step 1 loss "
          f"{ep['loss']:.6f} vs unplaced {ep['loss_unplaced']:.6f}, grad "
          f"norm {ep['grad_norm']:.6g} vs {ep['grad_norm_unplaced']:.6g}, "
          f"{ep['n_leaves']} leaves' grads (sampled experts): worst cosine "
          f"{ep['worst_cos']:.6f} at {ep['worst_cos_leaf']}, worst rel L2 "
          f"{ep['worst_rel_l2']:.4g} at {ep['worst_rel_l2_leaf']}; "
          f"all-to-alls {ep['all_to_all']['count']} "
          f"({ep['all_to_all_mb']:.1f} MB), all-reduces {ep['all_reduces']} "
          f"({ep['all_reduce_mb']:.1f} MB), all-gathers {ep['all_gathers']} "
          f"({ep['all_gather_mb']:.1f} MB) a rank; step {ep['step_s']:.2f} s"
          f" (unplaced {ep['unplaced_step_s']:.2f} s); peak memory "
          f"{ep['peak_mem_gb']:.2f} GB a rank (unplaced "
          f"{ep['unplaced_peak_mem_gb']:.2f} GB); launches "
          f"{ep['launches']}; on {card}")


def tp_rank(rank, world, port, out, phase):
    """Rank ``rank`` of ``world`` processes on card 0 for ``phase``: a gloo
    group over CUDA tensors and a (1, world) mesh; phase 40's train check
    and steps (``tp_train``) and placed serve (``tp_serve``) of zamba2,
    or phase 41's of deepseek (the EP-major step on a (world, 1) mesh,
    ``tp_ep_train``, then ``tp_train`` and ``tp_moe_serve`` with its
    contiguous part); rank 0 writes the results to ``out``/tp.json."""
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      LOCAL_RANK="0")
    if phase == 41:     # two ranks' 36 GB beside each other: less slack
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_arch
    from repro_torch.launch import mesh as M
    mesh = M.make_host_mesh(model=world, device="cuda", backend="gloo")
    res = {"backend": "gloo", "world": world, "part_s": {}}

    def part(key, fn, *a):          # each part's result and its seconds
        t0 = time.perf_counter()
        res[key] = fn(*a)
        res["part_s"][key] = time.perf_counter() - t0
    try:
        if phase == 40:
            part("train", tp_train, torch, mesh, TP_NAME, cut_depth(
                get_arch(ZAMBA), TP_DEPTH), TRAIN[ZAMBA])
            part("serve", tp_serve, torch, np, mesh)
        else:
            # the EP-major step first, on an empty card: its two ranks'
            # shards and bf16 grads take ~70 GB together
            part("ep", tp_ep_train, torch, TP_EP_NAME)
            part("train", tp_train, torch, mesh, TP_MOE_NAME, cut_depth(
                get_arch(DEEPSEEK), TP_MOE_TRAIN["depth"]), TP_MOE_TRAIN)
            part("serve", tp_moe_serve, torch, np, mesh)
    finally:
        M.shutdown()
    if rank == 0:
        pathlib.Path(out, "tp.json").write_text(json.dumps(res))


class _Recorder:
    """Counts and records what a step computes on this rank while entered:
    the x_proj width of every mamba2 mixer, the heads of every SSD scan
    and of every latent attention, the experts of every MoE layer's
    stacks, the all-reduces (``torch.distributed.all_reduce``: Megatron's
    f and g, the split norm's sums, the q latent gather's backward, the
    replicated leaves' gradients, the step's metrics and norm) with their
    bytes, the weight gathers (``sharded._Gather``: each leaf's, or
    each application's of a stacked leaf), and the all-gathers under them
    and under ``gather_full`` (``sharded._all_gather``) with the bytes
    they gather."""

    def __init__(self):
        self.x_proj, self.ssd_heads = set(), set()
        self.mla_heads, self.experts = set(), set()
        self.all_reduces, self.all_reduce_bytes, self.gathers = 0, 0, 0
        self.all_gathers, self.all_gather_bytes = 0, 0

    def __enter__(self):
        from unittest import mock

        import torch.distributed as dist

        from repro_torch.kernels import ops
        from repro_torch.models import blocks as B
        from repro_torch.models import mla as MLA
        from repro_torch.models import moe as MOE
        from repro_torch.runtime import sharded as SD
        mixer, scan = B.mamba2_mixer, ops.ssd_scan
        attend, routed = MLA._attend, MOE.routed
        reduce, gather = dist.all_reduce, SD._Gather.apply
        all_gather = SD._all_gather

        def mixer_(p, *a, **k):
            self.x_proj.add(tuple(p["x_proj"]["w"].shape))
            return mixer(p, *a, **k)

        def scan_(x, *a, **k):
            self.ssd_heads.add(x.shape[2])
            return scan(x, *a, **k)

        def attend_(cfg, q_nope, *a, **k):
            self.mla_heads.add(q_nope.shape[2])
            return attend(cfg, q_nope, *a, **k)

        def routed_(p, *a, **k):
            self.experts.add(p["w_in"].shape[0])
            return routed(p, *a, **k)

        def reduce_(t, *a, **k):
            self.all_reduces += 1
            self.all_reduce_bytes += t.numel() * t.element_size()
            return reduce(t, *a, **k)

        def gather_(*a):
            self.gathers += 1
            return gather(*a)

        def all_gather_(x, dim, n, *a):
            self.all_gathers += 1
            self.all_gather_bytes += n * x.numel() * x.element_size()
            return all_gather(x, dim, n, *a)
        self.patches = [mock.patch.object(B, "mamba2_mixer", mixer_),
                        mock.patch.object(ops, "ssd_scan", scan_),
                        mock.patch.object(MLA, "_attend", attend_),
                        mock.patch.object(MOE, "routed", routed_),
                        mock.patch.object(dist, "all_reduce", reduce_),
                        mock.patch.object(SD._Gather, "apply", gather_),
                        mock.patch.object(SD, "_all_gather", all_gather_)]
        for pt in self.patches:
            pt.start()
        return self

    def __exit__(self, *exc):
        for pt in self.patches:
            pt.stop()


def _split_shares(arch):
    """{what ``_Recorder`` reads: the set each rank must see} for model
    ``arch`` under MP on TP_MODEL ranks: x_proj at d_inner / TP_MODEL
    columns and the scans at H / TP_MODEL heads (mamba2), the latent
    attention at H / TP_MODEL heads (MLA), the MoE at E / TP_MODEL
    experts."""
    kinds, want = _kinds(arch), {}
    if "mamba2" in kinds:
        d_inner = arch.ssm.expand * arch.d_model
        want.update(x_proj={(arch.d_model, d_inner // TP_MODEL)},
                    ssd_heads={d_inner // arch.ssm.head_dim // TP_MODEL})
    if kinds & {"mla", "mla_dense"}:
        want["mla_heads"] = {arch.n_heads // TP_MODEL}
    if kinds & {"mla", "moe_attn"}:
        want["experts"] = {arch.moe.n_experts // TP_MODEL}
    return want


def _check_shares(label, rank, seen, arch):
    want = _split_shares(arch)
    got = {k: getattr(seen, k) for k in want}
    if got != want:
        fail(f"{label}: rank {rank} computes on {got}, want {want}")


def tp_train(torch, mesh, label, arch, cfg):
    """A TP phase's train part on this rank: model ``arch`` (bf16,
    impl="pallas") on ``cfg``'s batches.  Step 1's loss, grad norm and
    every gradient (gathered whole) through the sharded step, held
    against the unplaced single-process step (rank 0) on the same weights
    and batch at phase 14's tolerances; what each rank computes on
    (``_split_shares``); then ``cfg["steps"]`` steps of the Trainer's
    step: their times (host clock, synchronised), this rank's launches a
    step (each kernel's exact count) and its collectives."""
    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core import sharding as SH
    from repro_torch.data import SyntheticLM
    from repro_torch.models import transformer as T
    from repro_torch.optim import optimizers as O
    from repro_torch.runtime import sharded as SD
    from repro_torch.runtime import steps as ST
    from repro_torch.runtime.trainer import TrainConfig, Trainer

    rank = dist.get_rank()
    params = T.init_lm(arch, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(0))
    data = SyntheticLM(arch.vocab, cfg["seq_len"], cfg["batch"])
    batches = [next(data) for _ in range(cfg["steps"] + 1)]
    tok, lab = (torch.as_tensor(batches[0][k], device="cuda")
                for k in ("tokens", "labels"))
    names = tree.names(params)
    if rank == 0:   # the unplaced single-process step, timed as one step
        loss_fn = ST.make_loss_fn(arch, impl="pallas")
        ST.loss_and_grads(loss_fn, params, tok, lab)       # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss_u, _, g_u = ST.loss_and_grads(loss_fn, params, tok, lab)
        torch.cuda.synchronize()
        unplaced_s = time.perf_counter() - t0
    tr = Trainer(arch, ShapeSpec("tp", cfg["seq_len"], cfg["batch"],
                                 "train"), mesh,
                 TrainConfig(lr=cfg["peak_lr"], warmup_steps=cfg["warmup"],
                             total_steps=cfg["total"], impl="pallas",
                             microbatches=1),
                 scheduler=uniform_scheduler("MP"))
    # every rank holds the same whole params: each keeps its shards
    p = SH.place(params, tr._pns)
    o = tr._init_opt(p)
    del params
    # step 1's grads through the sharded step: no clipping, an optimizer
    # that keeps the reduced grads and updates nothing
    kept = {}

    def keep(grads, state, params_):
        kept["g"] = tree.leaves(grads)
        return tree.map(torch.zeros_like, grads), state
    _, _, act_ns = tr._specs()
    check = ST.make_train_step(arch, (None, keep), microbatches=1,
                               impl="pallas", act_sharding=act_ns,
                               grad_shardings=tr._pns,
                               clip_norm=float("inf"))
    with _Recorder() as seen:
        p, o, m1 = check(p, o, batches[0])
    _check_shares(label, rank, seen, arch)
    # each grad gathered whole and held one leaf at a time (all of them
    # whole at once would not fit beside the training state; gather_full:
    # DTensor's full_tensor faults on gloo over CUDA)
    diffs = {}
    for i, (g, ns) in enumerate(zip(kept.pop("g"), tree.leaves(tr._pns))):
        g = SD.gather_full(g, mesh, ns.placements)
        if rank == 0:
            diffs.update(grad_diffs(torch, names[i:i + 1], [g], [g_u[i]]))
        del g
    out = {}
    if rank == 0:
        bad = [f"{n}: cos {c:.6f}, rel L2 {r:.3g}"
               for n, (c, r) in diffs.items()
               if not (c >= GRAD_COS_MIN and r <= GRAD_REL_L2_MAX)]
        gn_u = float(O.global_norm(g_u))
        gn, loss = float(m1["grad_norm"]), float(m1["loss"])
        if not abs(loss - float(loss_u)) <= TP_LOSS_REL_TOL * abs(
                float(loss_u)):
            bad.append(f"loss {loss} vs unplaced {float(loss_u)}")
        if not abs(gn - gn_u) <= GRAD_NORM_REL_TOL * gn_u:
            bad.append(f"grad norm {gn} vs unplaced {gn_u}")
        if bad:
            fail(f"{label}: step 1 differs from the unplaced step's: {bad}")
        cos_leaf = min(diffs, key=lambda n: diffs[n][0])
        rel_leaf, rel = worst(diffs)
        out.update(loss=loss, loss_unplaced=float(loss_u), grad_norm=gn,
                   grad_norm_unplaced=gn_u, n_leaves=len(names),
                   worst_cos=diffs[cos_leaf][0], worst_cos_leaf=cos_leaf,
                   worst_rel_l2=rel, worst_rel_l2_leaf=rel_leaf,
                   rel_l2={n: r for n, (_, r) in diffs.items()},
                   unplaced_step_ms=unplaced_s * 1e3)
        del g_u
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    reset_counts()
    step_s, losses, gnorms = [], [], []
    with _Recorder() as coll:
        for b in batches[1:]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, o, m = tr._step_fn(p, o, b)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
    counts = read_counts()
    steps = cfg["steps"]
    # the gated norms run split; every other kernel as the unplaced step's
    want = train_launches(arch)
    g = block_counts(arch)["mamba2"]
    want.update(rmsnorm=want["rmsnorm"] - g,
                rmsnorm_bwd=want["rmsnorm_bwd"] - g, rmsnorm_split=g,
                rmsnorm_split_bwd=g)
    if any(counts[k] != n * steps for k, n in want.items()):
        fail(f"{label}: rank {rank}'s launches {counts}, want {want} a step")
    if not all(math.isfinite(x) for x in losses + gnorms):
        fail(f"{label}: losses {losses} / grad norms {gnorms} not finite")
    out.update(
        layers=arch.n_layers, method=tr.plan.plan.method,
        x_proj=sorted(seen.x_proj), ssd_heads=sorted(seen.ssd_heads),
        mla_heads=sorted(seen.mla_heads), experts=sorted(seen.experts),
        step_s=step_s,
        step_ms_median=sorted(step_s[1:])[len(step_s[1:]) // 2] * 1e3,
        losses=losses, grad_norms=gnorms, launches=counts,
        launches_per_step={k: c / steps for k, c in counts.items()},
        tp_all_reduces_per_step=coll.all_reduces / steps,
        tp_all_reduce_mb_per_step=coll.all_reduce_bytes / steps / 1e6,
        gathers_per_step=coll.gathers / steps,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    del p, o
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _serve_run(torch, eng, requests):
    """``eng`` serving ``requests`` -> ({request: tokens}, each prefill
    call's logits at the rows it serves, seconds)."""
    from unittest import mock

    from repro_torch.models import transformer as T
    real, logits = T.lm_apply, []

    def lm_apply(*a, **k):
        out = real(*a, **k)
        nl = k.get("new_lens")
        if k.get("cache") is not None and nl is not None:
            live = nl > 0
            last = (nl - 1).clamp_min(0).long()
            logits.append(out.logits[torch.arange(
                len(nl), device=nl.device), last][live].float().cpu())
        return out
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(T, "lm_apply", lm_apply):
        outs = eng.generate(requests)
    torch.cuda.synchronize()
    return ({o.request_id: o.token_ids for o in outs}, logits,
            time.perf_counter() - t0)


def _placed_checks(torch, label, eng, got, logits, want, want_logits,
                   wanted_fns):
    """The checks every placed TP serve shares -> its numbers: every block
    runs its tensor-parallel function (``wanted_fns``), every rank's
    tokens are the same and (rank 0) the unplaced engine's, each prefill
    call's logits within TP_LOGIT_TOL of max |logit|; the launches are
    read by the caller."""
    import torch.distributed as dist

    fns = {bi if si == 0 else (si, bi): fn.__qualname__.split(".")[0]
           for si, f in eng._placed.block_fns.items() if si != "encoder"
           for bi, fn in f.items()}
    if fns != wanted_fns:
        fail(f"{label}: the placed blocks run {fns}, want {wanted_fns}")
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, got)
    if any(e != every[0] for e in every):
        fail(f"{label}: the ranks' placed tokens differ")
    out = dict(block_fns={str(k): v for k, v in fns.items()},
               prefills=len(logits), tokens=sum(map(len, got.values())))
    if dist.get_rank() == 0:
        if got != want:
            bad = [i for i in want if got[i] != want[i]]
            fail(f"{label}: placed requests {bad} differ from the unplaced "
                 f"engine's tokens")
        if len(logits) != len(want_logits):
            fail(f"{label}: {len(logits)} placed prefill calls, "
                 f"{len(want_logits)} unplaced")
        rels = [float((a - b).abs().max() / b.abs().max())
                for a, b in zip(logits, want_logits)]
        if not max(rels) <= TP_LOGIT_TOL:
            fail(f"{label}: placed prefill logits differ by up to "
                 f"{max(rels):.3g} of max |logit| (max {TP_LOGIT_TOL:g})")
        out["worst_logit_rel"] = max(rels)
    return out


def tp_serve(torch, np, mesh):
    """Phase 40's serve part: zamba2 at ``TP_DEPTH`` in fp32, seeded
    weights, the first ``TP_SERVE_REQUESTS`` of phase 10's requests and its
    settings; rank 0 serves them unplaced
    first, then every rank through the engine placed on ``mesh`` under
    the uniform MP plan.  The placed tokens must equal the unplaced
    engine's on every rank, each prefill call's logits (the rows it
    serves) within TP_LOGIT_TOL of max |logit|, every block must run its
    tensor-parallel function, and the launches must be
    ``forward_launches``' with the gated norms split."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ContinuousBatchingEngine, Request

    rank = dist.get_rank()
    st = SERVE[ZAMBA]
    arch = dataclasses.replace(cut_depth(get_arch(ZAMBA), TP_DEPTH),
                               dtype="float32", param_dtype="float32")
    params = T.init_lm(arch, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, arch.vocab, size=st["prompt_len"])
               .astype(np.int32) for _ in range(st["requests"])]
    prompts = prompts[:TP_SERVE_REQUESTS]

    def requests():
        return [Request(id=i, prompt=q, max_new_tokens=st["max_new"])
                for i, q in enumerate(prompts)]
    kw = engine_kwargs(ZAMBA)
    want = want_logits = None
    if rank == 0:
        want, want_logits, want_s = _serve_run(
            torch, ContinuousBatchingEngine(arch, params, **kw), requests())
    dist.barrier()
    eng = ContinuousBatchingEngine(arch, params, mesh,
                                   asa=uniform_scheduler("MP"), **kw)
    reset_counts()
    got, logits, wall = _serve_run(torch, eng, requests())
    counts = read_counts()
    out = _placed_checks(torch, TP_NAME, eng, got, logits, want,
                         want_logits, {0: "tp_shared_block", **{
                             bi: "tp_mamba2_block" for bi in range(1, 7)}})
    s = eng.metrics.summary()
    calls = s["prefill_chunks"] + s["decode_steps"]
    fl = forward_launches(arch)
    g = block_counts(arch)["mamba2"]
    want_counts = dict(rmsnorm=(fl["rmsnorm"] - g) * calls,
                       rmsnorm_split=g * calls, flash_attention=0,
                       ssd_scan=fl["ssd_scan"] * s["prefill_chunks"])
    if any(counts[k] != n for k, n in want_counts.items()):
        fail(f"{TP_NAME}: placed serve launches {counts}, want "
             f"{want_counts} for {s['prefill_chunks']} prefill chunks and "
             f"{s['decode_steps']} decode steps")
    out.update(requests=len(prompts), launches=counts, wall_s=wall,
               tok_per_s=out["tokens"] / wall)
    if rank == 0:
        out.update(unplaced_wall_s=want_s,
                   unplaced_tok_per_s=out["tokens"] / want_s)
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def seeded_params(torch, arch, seed, shardings=None):
    """Params of model ``arch`` (``init_lm``'s tree, shapes and dtypes)
    drawn matrix by matrix from ``seed``: every matrix (a leaf's last two
    dims, at each index of its leading ones: a stacked layer's, an
    expert's) from its own generator on the card, seeded by (seed, leaf,
    index), as stddev * N(0, 1) truncated to [-2, 2] (stddev 1 for the
    embedding, else 1 / sqrt(fan in)), norm scales 1, biases 0.  With
    ``shardings`` (the params' tree of ``NamedSharding``) each leaf is
    this rank's DTensor, of which it draws only the matrices its shard
    holds (the expert stacks' other experts never exist on this rank)
    and cuts each matrix to its shard; without, the whole leaves."""
    import itertools

    from torch.distributed.tensor import DTensor, Shard

    from repro_torch import tree
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    meta = T.init_lm(arch, device="meta", generator=torch.Generator())
    nss = None if shardings is None else tree.leaves(shardings)
    out = []
    for i, (name, m) in enumerate(zip(tree.names(meta), tree.leaves(meta))):
        shape = tuple(m.shape)
        span = [(0, n) for n in shape]       # this rank's (start, size)
        if nss is not None:
            ns = nss[i]
            for mdim, pl in enumerate(ns.placements):
                k = ns.mesh.shape[mdim]
                if isinstance(pl, Shard) and k > 1:
                    r = ns.mesh.get_local_rank(mesh_dim=mdim)
                    st, n = span[pl.dim]
                    span[pl.dim] = (st + r * (n // k), n // k)
        local = torch.empty(tuple(n for _, n in span), dtype=m.dtype,
                            device="cuda")
        leaf = name.rsplit(".", 1)[-1]
        if len(shape) < 2:
            if leaf not in ("scale", "b"):
                fail(f"seeded_params: no rule for the leaf {name}")
            local.fill_(1.0 if leaf == "scale" else 0.0)
        else:
            lead = shape[:-2]
            std = 1.0 if leaf == "embedding" else shape[-2] ** -0.5
            rows, cols = (slice(s, s + n) for s, n in span[-2:])
            for idx in itertools.product(*(range(s, s + n)
                                           for s, n in span[:-2])):
                flat = 0
                for j, n in zip(idx, lead):
                    flat = flat * n + j
                g = torch.Generator(device="cuda").manual_seed(
                    (seed << 40) + (i << 20) + flat)
                w = L._normal(shape[-2:], m.dtype, std, g, "cuda")
                at = tuple(j - s for j, (s, _) in zip(idx, span[:-2]))
                local[at] = w[rows, cols]
                del w
        if nss is not None:
            local = DTensor.from_local(local, nss[i].mesh, nss[i].placements,
                                       run_check=False, shape=m.shape,
                                       stride=m.stride())
        out.append(local)
    return tree.unflatten(meta, out)


def tp_moe_serve(torch, np, mesh):
    """Phase 41's serve part: deepseek at ``TP_MOE_SERVE``'s depth, all
    256 experts, fp32, weights from ``seeded_params`` (55.8 GB without
    the MTP head, which serving never reads).  Rank 0 serves the
    requests unplaced first, alone on the card, and frees that model;
    then every rank draws its own shards and serves them through the
    engine placed on ``mesh`` under the uniform MP plan.  Phase 40's
    checks (``_placed_checks``; both blocks ``tp_mla_block``), 9 RMSNorm
    launches a model call, each rank's MoE on 128 of the 256 experts and
    its latent attention on 64 of the 128 heads, and the latent pools
    bit-equal across the ranks (every rank writes the same latents).
    Then the contiguous part on the same weights (``tp_decode``, its
    reference run by rank 0 on the unplaced weights before they are
    freed)."""
    import dataclasses
    import hashlib

    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core import sharding as SH
    from repro_torch.launch.mesh import mesh_shape_of
    from repro_torch.serving.engine import ContinuousBatchingEngine, Request

    rank = dist.get_rank()
    st = TP_MOE_SERVE
    # (the MTP head, which serving never reads, left out of the weights)
    arch = dataclasses.replace(cut_depth(get_arch(DEEPSEEK), st["depth"]),
                               dtype="float32", param_dtype="float32",
                               mtp=False)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, arch.vocab, size=st["prompt_len"])
               .astype(np.int32) for _ in range(st["requests"])]

    def requests():
        return [Request(id=i, prompt=q, max_new_tokens=st["max_new"])
                for i, q in enumerate(prompts)]
    kw = dict(device="cuda", slots=st["slots"], max_len=st["max_len"],
              block_size=st["block_size"], prefill_chunk=st["prefill_chunk"])
    want = want_logits = None
    marks = [time.perf_counter()]
    if rank == 0:
        torch.cuda.reset_peak_memory_stats()
        params = seeded_params(torch, arch, TP_MOE_SEED)
        eng = ContinuousBatchingEngine(arch, params, **kw)
        want, want_logits, want_s = _serve_run(torch, eng, requests())
        unplaced_peak = torch.cuda.max_memory_allocated() / 1e9
        del eng
        # the contiguous part's reference: the same weights and prompts
        # through the unplaced contiguous steps
        from repro_torch.models import transformer as T
        from repro_torch.runtime import steps as ST
        pf, dc = ST.make_prefill_step(arch), ST.make_decode_step(arch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dec_logits, dec_toks = _greedy_steps(
            torch, lambda k, t: pf(params, k, t),
            lambda k, t: dc(params, k, t),
            T.init_cache(arch, len(prompts), st["max_len"], device="cuda",
                         dtype=torch.float32),
            torch.as_tensor(np.stack(prompts), device="cuda"),
            TP_DECODE_STEPS)
        torch.cuda.synchronize()
        dec_want = (dec_logits, dec_toks, time.perf_counter() - t0)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    marks.append(time.perf_counter())
    torch.cuda.reset_peak_memory_stats()
    plan = uniform_scheduler("MP").plan(
        arch, ShapeSpec("serve", st["max_len"], st["slots"], "decode"),
        mesh_shape_of(mesh))
    eng = ContinuousBatchingEngine(
        arch, seeded_params(torch, arch, TP_MOE_SEED, SH.shardings(
            plan.param_specs(), mesh)), mesh, asa=uniform_scheduler("MP"),
        **kw)
    reset_counts()
    with _Recorder() as seen:
        got, logits, wall = _serve_run(torch, eng, requests())
    counts = read_counts()
    out = _placed_checks(torch, TP_MOE_NAME, eng, got, logits, want,
                         want_logits, {0: "tp_mla_block",
                                       (1, 0): "tp_mla_block"})
    _check_shares(TP_MOE_NAME, rank, seen, arch)
    s = eng.metrics.summary()
    calls = s["prefill_chunks"] + s["decode_steps"]
    want_counts = dict(rmsnorm=forward_launches(arch)["rmsnorm"] * calls,
                       flash_attention=0)
    if any(counts[k] != n for k, n in want_counts.items()):
        fail(f"{TP_MOE_NAME}: placed serve launches {counts}, want "
             f"{want_counts} for {s['prefill_chunks']} prefill chunks and "
             f"{s['decode_steps']} decode steps")
    # the replicated latent pools: every rank's copy, bit for bit
    digest = hashlib.sha1()
    for seg in eng.cache.pools:
        for pool in seg.values():
            for key in ("c_kv", "k_rope"):
                digest.update(pool[key].to_local().cpu().numpy().tobytes())
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, digest.hexdigest())
    if any(e != every[0] for e in every):
        fail(f"{TP_MOE_NAME}: the ranks' latent pools differ: {every}")
    out.update(requests=len(prompts), launches=counts, wall_s=wall,
               tok_per_s=out["tokens"] / wall,
               experts=sorted(seen.experts), mla_heads=sorted(seen.mla_heads),
               pool_digest=every[0][:12],
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if rank == 0:
        out.update(unplaced_wall_s=want_s,
                   unplaced_tok_per_s=out["tokens"] / want_s,
                   unplaced_peak_mem_gb=unplaced_peak)
    marks.append(time.perf_counter())
    out["contiguous"] = tp_decode(torch, np, mesh, arch, plan, eng, prompts,
                                  dec_want if rank == 0 else None)
    marks.append(time.perf_counter())
    out["part_s"] = dict(zip(("unplaced", "placed", "contiguous"),
                             (b - a for a, b in zip(marks, marks[1:]))))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _greedy_steps(torch, prefill, decode, cache, tokens, steps):
    """One ``prefill`` of ``tokens`` on the contiguous ``cache``, then
    ``steps`` greedy ``decode`` steps -> (each call's logits on the host,
    the tokens fed and the last one chosen, (B, steps + 1))."""
    logits, fed = [], []
    with torch.no_grad():
        lg, _ = prefill(cache, tokens)
        for _ in range(steps):
            logits.append(lg.float().cpu())
            fed.append(lg.argmax(-1))
            lg, _ = decode(cache, fed[-1][:, None].to(torch.int32))
    logits.append(lg.float().cpu())
    fed.append(lg.argmax(-1))
    return logits, torch.stack(fed, 1).cpu()


def tp_decode(torch, np, mesh, arch, plan, eng, prompts, want):
    """Phase 41's contiguous part, after the placed serve: the placed
    engine's weights (``eng``) through the dry run's serving function
    (``plan_layout``'s ``tp_mla_block``s, the plan's ``cache_specs``
    placing a contiguous cache of the serve's max_len rows: the latents
    split over `model` along time), one prefill of the 2 prompts and
    TP_DECODE_STEPS greedy decode steps.  ``want``: rank 0's unplaced
    contiguous run on the whole weights (``_greedy_steps``).  Tokens equal
    the unplaced ones on every rank, each call's logits within
    TP_LOGIT_TOL of max |logit|, every block ``tp_mla_block``, the whole
    latent caches each attention gathers and writes bit-equal across the
    ranks (every rank writes the same latents), ``forward_launches``
    RMSNorm launches a call and no flash."""
    import hashlib
    from unittest import mock

    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.core import sharding as SH
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import mesh_shape_of
    from repro_torch.models import transformer as T
    from repro_torch.runtime import sharded as SD

    st = TP_MOE_SERVE
    B = len(prompts)
    pspecs, cspecs = plan.param_specs(), plan.cache_specs(B)
    cache = SH.place(T.init_cache(arch, B, st["max_len"], device="cuda",
                                  dtype=torch.float32),
                     SH.shardings(cspecs, mesh))
    local = tree.map(lambda x: x.to_local(), cache)
    batch = SH.P(SH.batch_axes(mesh_shape_of(mesh), B), None)
    fns = {k: DR._serving_fn(arch, k, eng._placed.params, pspecs, cspecs,
                             mesh, batch) for k in ("prefill", "decode")}
    blocks = sorted({fn.__qualname__.split(".")[0]
                     for f in fns["decode"].block_fns.values()
                     for fn in f.values()})
    if blocks != ["tp_mla_block"]:
        fail(f"{TP_DECODE_NAME}: the blocks run {blocks}, want tp_mla_block")
    digests, back = [], SD._time_back

    def time_back(c, whole, tp):
        h = hashlib.sha1()
        for k in sorted(whole):
            h.update(whole[k].cpu().numpy().tobytes())
        digests.append(h.hexdigest())
        return back(c, whole, tp)
    tokens = torch.as_tensor(np.stack(prompts), device="cuda")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(SD, "_time_back", time_back):
        logits, toks = _greedy_steps(
            torch, lambda k, t: fns["prefill"](None, k, t),
            lambda k, t: fns["decode"](None, k, t), local, tokens,
            TP_DECODE_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    calls = TP_DECODE_STEPS + 1
    want_counts = dict(rmsnorm=forward_launches(arch)["rmsnorm"] * calls,
                       flash_attention=0)
    if any(counts[k] != n for k, n in want_counts.items()):
        fail(f"{TP_DECODE_NAME}: launches {counts}, want {want_counts} for "
             f"{calls} calls")
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (toks.tolist(), digests))
    if any(e != every[0] for e in every):
        fail(f"{TP_DECODE_NAME}: the ranks' tokens or gathered latent "
             f"caches differ")
    out = dict(blocks=blocks, calls=calls, launches=counts, wall_s=wall,
               latent_writes=len(digests), latent_digest=digests[-1][:12],
               cache_local=[tuple(x.to_local().shape)
                            for x in tree.leaves(cache) if x.ndim == 4])
    if dist.get_rank() == 0:
        want_logits, want_toks, want_s = want
        if not torch.equal(toks, want_toks):
            fail(f"{TP_DECODE_NAME}: tokens {toks.tolist()} differ from the "
                 f"unplaced contiguous steps' {want_toks.tolist()}")
        rels = [float((a - b).abs().max() / b.abs().max())
                for a, b in zip(logits, want_logits)]
        if not max(rels) <= TP_LOGIT_TOL:
            fail(f"{TP_DECODE_NAME}: logits differ by up to {max(rels):.3g} "
                 f"of max |logit| (max {TP_LOGIT_TOL:g})")
        out.update(worst_logit_rel=max(rels), unplaced_wall_s=want_s)
    return out


def _sum_squares(torch, g, chunk=1 << 26):
    """sum(g^2) in fp32, ``chunk`` elements at a time (an fp32 copy of one
    expert stack's gradient would not fit beside the step)."""
    total = torch.zeros((), dtype=torch.float64, device=g.device)
    for part in g.reshape(-1).split(chunk):
        total += part.float().square().sum()
    return total


def _chunked_diffs(torch, a, b, chunk=1 << 26):
    """``grad_diffs``'s (cosine, relative L2) of ``a`` against ``b`` in
    float64, ``chunk`` elements at a time on their device (a float64
    copy of an embedding's gradient would not fit beside the step)."""
    s = torch.zeros(4, dtype=torch.float64, device=a.device)
    for x, y in zip(a.reshape(-1).split(chunk), b.reshape(-1).split(chunk)):
        x, y = x.double(), y.double()
        d = x - y
        s += torch.stack([x @ y, x @ x, y @ y, d @ d])
    dot, aa, bb, dd = s.tolist()
    return (dot / max(math.sqrt(aa * bb), 1e-30),
            math.sqrt(dd) / max(math.sqrt(bb), 1e-30))


def _chunked_norm(torch, grads):
    """The global L2 norm of ``grads`` (``_sum_squares``)."""
    return math.sqrt(float(sum(_sum_squares(torch, g) for g in grads)))


def tp_ep_train(torch, label):
    """Phase 41's EP-major part (``TP_EP_TRAIN``): rank 0 runs step 1's
    loss and gradients unplaced on the whole model first, alone on the
    card, keeps on the host each non-expert gradient and the sampled
    experts', and frees the rest; then both ranks draw their own shards
    (``seeded_params``) by the uniform HP plan with the EP-major specs on
    a (data 2, model 1) mesh and run the sharded step's loss and
    gradients (``steps.sharded_loss_and_grads``: each rank routes its own
    sequence, one all-to-all over `data` sends each expert's slots to its
    owner and one brings them back).  Checks: the loss within
    TP_LOSS_REL_TOL and the grad norm within GRAD_NORM_REL_TOL of the
    unplaced step's, every non-expert leaf's gradient and the sampled
    experts' at GRAD_COS_MIN / GRAD_REL_L2_MAX, each rank's stacks its
    128 experts, exactly 4 all-to-alls (a MoE layer's dispatch and return
    forward and backward) of E * C * D bf16 each, and the RMSNorm
    launches of a train step (``train_launches``)."""
    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core import sharding as SH
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import mesh as M
    from repro_torch.launch.mesh import mesh_shape_of
    from repro_torch.models import transformer as T
    from repro_torch.runtime import sharded as SD
    from repro_torch.runtime import steps as ST

    import dataclasses

    import numpy as np

    cfg = TP_EP_TRAIN
    rank, world = dist.get_rank(), dist.get_world_size()
    arch = dataclasses.replace(cut_depth(get_arch(DEEPSEEK), cfg["depth"]),
                               mtp=False)
    start_gb = torch.cuda.memory_allocated() / 1e9
    E = arch.moe.n_experts
    per = E // world
    sample = [r * per + o for r in range(world) for o in cfg["sample"]]
    batch = next(SyntheticLM(arch.vocab, cfg["seq_len"], cfg["batch"]))
    names = tree.names(T.init_lm(arch, device="meta",
                                 generator=torch.Generator()))
    from unittest import mock

    from repro_torch.models import moe as MOE
    real_route, routes = MOE.route, []

    def route(*a, **k):         # each MoE call's top-k expert choices
        out = real_route(*a, **k)
        routes.append(out[2].cpu())
        return out

    def held(grads):            # the held leaves' grads, on the host
        return [g[:, sample].cpu() if ".moe.w_" in n else g.cpu()
                for n, g in zip(names, grads)]
    want, part_s, last = {}, {}, [time.perf_counter()]

    def lap(key):               # the seconds since the last lap
        torch.cuda.synchronize()
        now = time.perf_counter()
        part_s[key], last[0] = now - last[0], now
    if rank == 0:       # the unplaced step, alone on the card
        torch.cuda.reset_peak_memory_stats()
        params = seeded_params(torch, arch, TP_EP_SEED)
        lap("unplaced params")
        tok, lab = (torch.as_tensor(batch[k], device="cuda")
                    for k in ("tokens", "labels"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mock.patch.object(MOE, "route", route):
            loss_u, _, g_u = ST.loss_and_grads(
                ST.make_loss_fn(arch, impl="pallas"), params, tok, lab)
        torch.cuda.synchronize()
        want.update(loss=float(loss_u), step_s=time.perf_counter() - t0,
                    grad_norm=_chunked_norm(torch, g_u),
                    peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                    routes=routes[:])
        want["grads"] = held(g_u)
        del g_u, params, tok, lab
        gc.collect()
        torch.cuda.empty_cache()
        routes.clear()
        lap("unplaced step")
    dist.barrier()
    lap("wait")
    torch.cuda.reset_peak_memory_stats()
    mesh = M.make_host_mesh(model=1, device="cuda", backend="gloo")
    ms = mesh_shape_of(mesh)
    with SH.moe_ep_axis("data"):
        plan = uniform_scheduler("HP").plan(
            arch, ShapeSpec("ep", cfg["seq_len"], cfg["batch"], "train"), ms)
        pns = SH.shardings(plan.param_specs(), mesh)
    p = seeded_params(torch, arch, TP_EP_SEED, pns)
    lap("place")
    stacks = {tuple(x.to_local().shape) for n, x in zip(names,
                                                        tree.leaves(p))
              if ".moe.w_" in n}
    if {s[1] for s in stacks} != {per}:
        fail(f"{label}: rank {rank}'s expert stacks {stacks}, want {per} "
             f"experts")
    act_ns = SH.NamedSharding(mesh, SH.P(SH.batch_axes(ms, cfg["batch"]),
                                         None, None))
    a2a = {"count": 0, "bytes": 0}
    real = dist.all_to_all_single

    def all_to_all(out, inp, *a, **k):
        a2a["count"] += 1
        a2a["bytes"] += inp.numel() * inp.element_size()
        return real(out, inp, *a, **k)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _Recorder() as seen, mock.patch.object(
            dist, "all_to_all_single", all_to_all), \
            mock.patch.object(MOE, "route", route):
        total, _, grads = ST.sharded_loss_and_grads(
            arch, p, batch, act_sharding=act_ns, grad_shardings=pns,
            impl="pallas")
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    lap("step")
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    # the global norm over the shards, as ``sharded.global_norm`` sums it
    # (a replicated leaf's squares divided by its replicas), in chunks
    lays = SD.layouts(pns, SD.plan_layout(arch, SH.map_specs(
        lambda ns: ns.spec, pns), mesh, act_ns.spec)[0])
    sq = sum(_sum_squares(torch, g) / SD.replicas(lay, mesh)
             for g, lay in zip(grads, lays))
    dist.all_reduce(sq)
    gnorm = math.sqrt(float(sq))
    loss = torch.stack([total.float()])
    dist.all_reduce(loss)
    loss = float(loss[0]) / world
    bad = [f"{k} {counts[k]} (want {n})"
           for k, n in train_launches(arch).items() if counts[k] != n]
    C = max(1, int(arch.moe.capacity_factor * arch.moe.top_k *
                   cfg["seq_len"] / E))
    one = E * (cfg["batch"] // world) * C * arch.d_model * torch.empty(
        (), dtype=T.compute_dtype(arch)).element_size()
    if a2a != {"count": 4, "bytes": 4 * one}:
        bad.append(f"all-to-alls {a2a}, want 4 of {one} bytes")
    # the tokens whose top-k expert set differs from the unplaced step's
    # (bf16 rounding moves near-ties; a moved choice shifts the capacity
    # slots of the tokens after it)
    every = [None] * world
    dist.all_gather_object(every, [r.numpy() for r in routes])
    flips = 0
    if rank == 0:
        for layer, ru in enumerate(want["routes"]):
            rp = np.concatenate([e[layer] for e in every])
            flips += int((np.sort(ru.numpy(), -1) != np.sort(rp, -1))
                         .any(-1).sum())
    lap("norm and routes")
    # every gradient held on rank 0, on the card, which the params leave
    # room for: non-expert leaves gathered whole one at a time, the
    # sampled experts from each rank's range
    del p
    gc.collect()
    torch.cuda.empty_cache()
    diffs = {}
    for i, (n, g, ns) in enumerate(zip(names, grads, tree.leaves(pns))):
        if ".moe.w_" in n:
            part = g[:, list(cfg["sample"])].contiguous()
            got = SD._all_gather(part, 1, world, dist.group.WORLD)
        else:
            got = SD.gather_full(g, mesh, ns.placements)
        if rank == 0:
            diffs[n] = _chunked_diffs(torch, got,
                                      want["grads"][i].to(got.device))
        del got
    lap("diffs")
    out = dict(layers=arch.n_layers, method=plan.plan.method, part_s=part_s,
               start_mem_gb=start_gb,
               experts=sorted(s[1] for s in stacks), loss=loss,
               grad_norm=gnorm, step_s=step_s, peak_mem_gb=peak,
               launches=counts, all_to_all=a2a,
               all_to_all_mb=a2a["bytes"] / 1e6,
               all_reduces=seen.all_reduces,
               all_reduce_mb=seen.all_reduce_bytes / 1e6,
               all_gathers=seen.all_gathers,
               all_gather_mb=seen.all_gather_bytes / 1e6, route_flips=flips)
    if rank == 0:
        print(f"{label}: every leaf's (cosine, rel L2) against the unplaced "
              f"step: {diffs}; {flips} tokens' expert sets differ from the "
              f"unplaced step's", flush=True)
        bad += [f"{n}: cos {c:.6f}, rel L2 {r:.3g}"
                for n, (c, r) in diffs.items()
                if not (c >= GRAD_COS_MIN and r <= GRAD_REL_L2_MAX)]
        if not abs(loss - want["loss"]) <= TP_LOSS_REL_TOL * abs(
                want["loss"]):
            bad.append(f"loss {loss} vs unplaced {want['loss']}")
        if not abs(gnorm - want["grad_norm"]) <= \
                GRAD_NORM_REL_TOL * want["grad_norm"]:
            bad.append(f"grad norm {gnorm} vs unplaced {want['grad_norm']}")
        cos_leaf = min(diffs, key=lambda n: diffs[n][0])
        rel_leaf, rel = worst(diffs)
        out.update(loss_unplaced=want["loss"],
                   grad_norm_unplaced=want["grad_norm"],
                   unplaced_step_s=want["step_s"],
                   unplaced_peak_mem_gb=want["peak_gb"], n_leaves=len(diffs),
                   worst_cos=diffs[cos_leaf][0], worst_cos_leaf=cos_leaf,
                   worst_rel_l2=rel, worst_rel_l2_leaf=rel_leaf)
    if bad:
        fail(f"{label}: rank {rank}: {bad}")
    del grads
    gc.collect()
    torch.cuda.empty_cache()
    return out


def spec_block(full, spec, sizes, coords):
    """The block of ``full`` that spec ``spec`` gives the device at
    ``coords`` ({axis: index}) of a mesh of ``sizes``, the reference's
    (JAX's) way: along each dim, the mixed-radix index of its axes, the
    first axis the major one."""
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        k, n = 0, 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            k, n = k * sizes[a] + coords[a], n * sizes[a]
        size = full.shape[d] // n
        full = full.narrow(d, k * size, size)
    return full


def pod_phase(torch, report, card):
    """42. HP on a multi-pod mesh, mamba2-780m: four processes on the card
    over gloo on a (pod 2, data 2, model 1) mesh (``pod_rank``); the
    ranks' results printed and kept."""
    res = _spawn_ranks(POD_NAME, 42, world=math.prod(POD_SHAPE),
                       fn=pod_rank)
    t = res["train"]
    report[POD_NAME] = dict(res, launches=t["launches"])
    print(f"pod: {MAMBA} at {t['layers']} of 48 layers, "
          f"{math.prod(POD_SHAPE)} ranks of a (pod, data, model) = "
          f"{POD_SHAPE} mesh over {res['backend']} on one card, uniform HP "
          f"({t['method']}) with int8 moments: every rank's shard of "
          f"{t['params_checked']} params ({t['params_strided']} laid out "
          f"with pod strided over data) and {t['moments_checked']} int8 "
          f"moment arrays ({t['moments_strided']} strided) is the "
          f"reference's block for its coordinates; " + _train_line(t, card)
          + f"; all-gathers a step {t['all_gathers_per_step']} "
          f"({t['all_gather_mb_per_step']:.1f} MB)")
    c = t["ckpt"]
    print(f"pod: checkpoint of {c['gb']:.2f} GB saved in {c['save_s']:.2f} "
          f"s, restored bit-equal in {c['restore_s']:.2f} s; "
          f"Trainer.resize onto (data 4, model 1) in {c['resize_s']:.2f} s, "
          f"every value equal")
    e = t["ef"]
    print(f"pod: compressed_allreduce of step 1's grads ({e['leaves']} "
          f"leaves, each rank's own sequence) over the pod group in "
          f"{e['s']:.2f} s: corrected - deq == new error exactly on every "
          f"leaf; worst |mean - exact mean| {e['worst_err']:.3g} against "
          f"half a quantum {e['worst_bound']:.3g} at {e['worst_leaf']} "
          f"(largest share of the bound {e['worst_share']:.3f})")


def pod_rank(rank, world, port, out, phase):
    """Rank ``rank`` of ``world`` processes on card 0 for phase 42: a gloo
    group over CUDA tensors and a ``POD_SHAPE`` mesh from
    ``init_device_mesh``; ``pod_train``; rank 0 writes the results to
    ``out``/tp.json."""
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      LOCAL_RANK="0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.launch import mesh as M
    M.init_world("cuda", backend="gloo")
    mesh = init_device_mesh("cuda", POD_SHAPE, mesh_dim_names=POD_AXES)
    res = {"backend": "gloo", "world": world}
    try:
        res["train"] = pod_train(torch, np, mesh)
    finally:
        M.shutdown()
    if rank == 0:
        pathlib.Path(out, "tp.json").write_text(json.dumps(res))


def _check_blocks(label, torch, mesh, arrays):
    """Each (local, whole, spec) of ``arrays`` against the reference's
    block of the whole for this rank's coordinates -> how many."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    coords = {a: mesh.get_local_rank(mesh_dim=i)
              for i, a in enumerate(mesh.mesh_dim_names)}
    for name, local, whole, spec in arrays:
        if not torch.equal(local, spec_block(whole, spec, sizes, coords)):
            fail(f"{label}: {name}'s shard at {coords} is not the "
                 f"reference's block of spec {spec!r}")
    return len(arrays)


def pod_train(torch, np, mesh):
    """Phase 42's train part on this rank (``POD_TRAIN``): the params'
    shards at init against the reference's blocks; step 1's loss and
    every gradient (gathered whole, one leaf at a time) through the
    sharded step against the unplaced step (rank 0) at phase 40's
    tolerances; ``POD_TRAIN["steps"]`` steps of the Trainer's step (the
    int8-moment branch: every leaf gathered whole): times, exact
    launches, collectives; the int8 moments' shards against the
    reference's blocks; a checkpoint saved and restored bit-equal;
    ``Trainer.resize`` onto (data 4, model 1); ``compressed_allreduce`` of
    each rank's own step-1 gradient over the pod group."""
    import shutil

    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core import sharding as SH
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.mesh import mesh_shape_of
    from repro_torch.models import transformer as T
    from repro_torch.optim import compression as EF
    from repro_torch.optim import optimizers as O
    from repro_torch.optim.quantized import QLeaf
    from repro_torch.runtime import sharded as SD
    from repro_torch.runtime import steps as ST
    from repro_torch.runtime.trainer import TrainConfig, Trainer
    from torch.distributed.device_mesh import init_device_mesh

    label, cfg = POD_NAME, POD_TRAIN
    rank = dist.get_rank()
    arch = cut_depth(get_arch(MAMBA), cfg["depth"])
    params = T.init_lm(arch, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(0))
    data = SyntheticLM(arch.vocab, cfg["seq_len"], cfg["batch"])
    batches = [next(data) for _ in range(cfg["steps"] + 1)]
    tok, lab = (torch.as_tensor(batches[0][k], device="cuda")
                for k in ("tokens", "labels"))
    names = tree.names(params)
    loss_fn = ST.make_loss_fn(arch, impl="pallas")
    if rank == 0:   # the unplaced single-process step, timed as one step
        ST.loss_and_grads(loss_fn, params, tok, lab)       # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss_u, _, g_u = ST.loss_and_grads(loss_fn, params, tok, lab)
        torch.cuda.synchronize()
        unplaced_s = time.perf_counter() - t0
    tr = Trainer(arch, ShapeSpec("pod", cfg["seq_len"], cfg["batch"],
                                 "train"), mesh,
                 TrainConfig(lr=cfg["peak_lr"], warmup_steps=cfg["warmup"],
                             total_steps=cfg["total"], impl="pallas",
                             microbatches=1, quantized_opt=True),
                 scheduler=uniform_scheduler("HP"))
    # every rank holds the same whole params: each keeps its shards, which
    # must be the reference's blocks of them
    p = SH.place(params, tr._pns)
    specs = [ns.spec for ns in tree.leaves(tr._pns)]
    n_params = _check_blocks(label, torch, mesh, [
        (n, x.to_local(), w, sp) for n, x, w, sp in
        zip(names, tree.leaves(p), tree.leaves(params), specs)])
    strided = [n for n, x in zip(names, tree.leaves(p)) if any(
        type(pl).__name__ == "_StridedShard" for pl in x.placements)]
    o = tr._init_opt(p)
    # step 1's grads through the sharded step: no clipping, an optimizer
    # that keeps the reduced grads and updates nothing (the int8 branch
    # hands it every leaf whole)
    kept = {}

    def keep(grads, state, params_):
        kept["g"] = tree.leaves(grads)
        return tree.map(torch.zeros_like, grads), state
    _, _, act_ns = tr._specs()
    check = ST.make_train_step(arch, (None, keep), microbatches=1,
                               impl="pallas", act_sharding=act_ns,
                               grad_shardings=tr._pns,
                               clip_norm=float("inf"))
    p, o, m1 = check(p, o, batches[0])
    diffs = {}
    for i, (g, x, ns) in enumerate(zip(kept.pop("g"), tree.leaves(p),
                                       tree.leaves(tr._pns))):
        if tuple(g.shape) != tuple(x.shape):
            g = SD.gather_full(g, mesh, ns.placements)
        if rank == 0:
            diffs.update(grad_diffs(torch, names[i:i + 1], [g], [g_u[i]]))
        del g
    out = {}
    if rank == 0:
        bad = [f"{n}: cos {c:.6f}, rel L2 {r:.3g}"
               for n, (c, r) in diffs.items()
               if not (c >= GRAD_COS_MIN and r <= GRAD_REL_L2_MAX)]
        gn_u = float(O.global_norm(g_u))
        gn, loss = float(m1["grad_norm"]), float(m1["loss"])
        if not abs(loss - float(loss_u)) <= TP_LOSS_REL_TOL * abs(
                float(loss_u)):
            bad.append(f"loss {loss} vs unplaced {float(loss_u)}")
        if not abs(gn - gn_u) <= GRAD_NORM_REL_TOL * gn_u:
            bad.append(f"grad norm {gn} vs unplaced {gn_u}")
        if bad:
            fail(f"{label}: step 1 differs from the unplaced step's: {bad}")
        cos_leaf = min(diffs, key=lambda n: diffs[n][0])
        rel_leaf, rel = worst(diffs)
        out.update(loss=loss, loss_unplaced=float(loss_u), grad_norm=gn,
                   grad_norm_unplaced=gn_u, n_leaves=len(names),
                   worst_cos=diffs[cos_leaf][0], worst_cos_leaf=cos_leaf,
                   worst_rel_l2=rel, worst_rel_l2_leaf=rel_leaf,
                   rel_l2={n: r for n, (_, r) in diffs.items()},
                   unplaced_step_ms=unplaced_s * 1e3)
        del g_u
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    reset_counts()
    step_s, losses, gnorms = [], [], []
    with _Recorder() as coll:
        for b in batches[1:]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, o, m = tr._step_fn(p, o, b)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    steps = cfg["steps"]
    # the gated norms run split where the plan lays mamba2 out
    # tensor-parallel (over a `model` axis of one rank here)
    want = train_launches(arch)
    _, fns = SD.plan_layout(arch, SH.map_specs(lambda ns: ns.spec, tr._pns),
                            mesh, act_ns.spec)
    g = block_counts(arch)["mamba2"] if fns else 0
    want.update(rmsnorm=want["rmsnorm"] - g,
                rmsnorm_bwd=want["rmsnorm_bwd"] - g, rmsnorm_split=g,
                rmsnorm_split_bwd=g)
    if any(counts[k] != n * steps for k, n in want.items()):
        fail(f"{label}: rank {rank}'s launches {counts}, want {want} a step")
    if not all(math.isfinite(x) for x in losses + gnorms):
        fail(f"{label}: losses {losses} / grad norms {gnorms} not finite")
    # the int8 moments' shards after the steps
    sds = tr.opt[0](tree.map(lambda x: torch.empty(
        x.shape, dtype=x.dtype, device="meta"), p))
    ospecs = SH.opt_state_specs(sds, tr._pspecs, mesh_shape_of(mesh))
    moments = []
    for part, m_specs in ((o.mu, ospecs.mu), (o.nu, ospecs.nu)):
        for n, q, sp in zip(names, tree.leaves(part),
                            SH.spec_leaves(m_specs)):
            if not isinstance(q, QLeaf):
                fail(f"{label}: {n}'s moment is not int8")
            for t_, s_ in ((q.q, sp.q), (q.scale, sp.scale)):
                moments.append((n, t_.to_local(), SD.whole(t_), s_))
    n_moments = _check_blocks(label, torch, mesh, moments)
    m_strided = sum(1 for _, _, _, s_ in moments
                    if ("data", "model", "pod") in tuple(s_))
    del moments

    def whole_state(p_, o_):
        return [SD.whole(x) for x in tree.leaves(p_)] + [
            SD.whole(t_) for part in (o_.mu, o_.nu)
            for q in tree.leaves(part) for t_ in (q.q, q.scale)]
    # a checkpoint: saved (gathered by gather_full, written by rank 0),
    # restored into the live state's placements, bit-equal shard by shard
    ck = [tempfile.mkdtemp(prefix="chip_smoke_pod_") if rank == 0
          else None]
    dist.broadcast_object_list(ck)
    mgr = CheckpointManager(ck[0], async_save=False)
    t0 = time.perf_counter()
    mgr.save(tr.step, {"params": p, "opt": o})
    mgr.wait()
    save_s = time.perf_counter() - t0
    gb = _dir_bytes(pathlib.Path(ck[0])) / 1e9 if rank == 0 else 0.0
    t0 = time.perf_counter()
    got, _ = mgr.restore({"params": p, "opt": o})
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    a = [x.to_local() for x in tree.leaves(p)] + [
        t_.to_local() for part in (o.mu, o.nu) for q in tree.leaves(part)
        for t_ in (q.q, q.scale)]
    b = [x.to_local() for x in tree.leaves(got["params"])] + [
        t_.to_local() for part in (got["opt"].mu, got["opt"].nu)
        for q in tree.leaves(part) for t_ in (q.q, q.scale)]
    if len(a) != len(b) or not all(torch.equal(x, y) for x, y in zip(a, b)):
        fail(f"{label}: the restored state differs from the saved one")
    del got, a, b
    dist.barrier()
    if rank == 0:
        shutil.rmtree(ck[0], ignore_errors=True)
    # Trainer.resize onto (data 4, model 1): every value kept
    before = whole_state(p, o)
    flat = init_device_mesh("cuda", (math.prod(POD_SHAPE), 1),
                            mesh_dim_names=("data", "model"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p3, o3 = tr.resize(flat, p, o)
    torch.cuda.synchronize()
    resize_s = time.perf_counter() - t0
    after = whole_state(p3, o3)
    if not all(torch.equal(x, y) for x, y in zip(before, after)):
        fail(f"{label}: Trainer.resize changed a value")
    del before, after, p3, o3, p, o
    gc.collect()
    torch.cuda.empty_cache()
    # compressed_allreduce over the pod group of each rank's own step-1
    # gradient (its own sequence, the whole model): the error-feedback
    # identity exactly, the mean within half a quantum (max block scale /
    # 254: each rank's dequantized value is within half of its own) of
    # the exact fp32 mean, plus the fp32 rounding of the two sums
    pod = mesh.get_group("pod")
    n_pod = dist.get_world_size(pod)
    own = ST.loss_and_grads(loss_fn, params, tok[rank:rank + 1],
                            lab[rank:rank + 1])[2]
    del params
    err0 = EF.init_error_state(own)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    avg, new_err = EF.compressed_allreduce(own, err0, pod)
    torch.cuda.synchronize()
    ef_s = time.perf_counter() - t0
    q, corrected = EF.compress(own, err0)
    deq = [x.dense() for x in q]
    worst_ef = (0.0, 1.0, 0.0, "")
    for n, c, d, e, qq, a_, g_ in zip(names, corrected, deq, new_err, q,
                                      avg, own):
        if not torch.equal(c - d, e):
            fail(f"{label}: corrected - deq != new error at {n}")
        exact = g_.float().clone()
        dist.all_reduce(exact, group=pod)
        exact /= n_pod
        scale = qq.scale.max().reshape(1)
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=pod)
        mag = exact.abs().max().reshape(1) * n_pod
        bound = float(scale) / 254 + 4 * float(mag) * 2.0 ** -24
        err = float((a_ - exact).abs().max())
        if not err <= bound:
            fail(f"{label}: compressed mean off by {err} at {n}, more than "
                 f"half a quantum {bound}")
        if err / bound > worst_ef[2]:
            worst_ef = (err, bound, err / bound, n)
    del own, avg, new_err, q, corrected, deq
    out.update(
        layers=arch.n_layers, method=tr.plan.plan.method,
        params_checked=n_params, params_strided=len(strided),
        strided_leaves=strided, moments_checked=n_moments,
        moments_strided=m_strided, step_s=step_s,
        step_ms_median=sorted(step_s[1:])[len(step_s[1:]) // 2] * 1e3,
        losses=losses, grad_norms=gnorms, launches=counts,
        launches_per_step={k: c / steps for k, c in counts.items()},
        tp_all_reduces_per_step=coll.all_reduces / steps,
        tp_all_reduce_mb_per_step=coll.all_reduce_bytes / steps / 1e6,
        gathers_per_step=coll.gathers / steps,
        all_gathers_per_step=coll.all_gathers / steps,
        all_gather_mb_per_step=coll.all_gather_bytes / steps / 1e6,
        peak_mem_gb=peak,
        ckpt=dict(gb=gb, save_s=save_s, restore_s=restore_s,
                  resize_s=resize_s),
        ef=dict(leaves=len(names), s=ef_s, worst_err=worst_ef[0],
                worst_bound=worst_ef[1], worst_share=worst_ef[2],
                worst_leaf=worst_ef[3]))
    if rank == 0 and not strided:
        fail(f"{label}: no param is laid out over ('data', 'pod')")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _step_launches(arch, kind):
    """Each kernel's launches in one serving step: a forward's norms
    (``forward_launches``) in a prefill chunk and a decode step, its scans
    in a prefill chunk only (a decode step runs the recurrence), none in a
    slot admission; no flash (the paged path's attention is plain)."""
    fl = forward_launches(arch)
    want = {"rmsnorm": 0, "rmsnorm_split": 0, "flash_attention": 0,
            "ssd_scan": 0}
    if kind != "slot_admit":
        want["rmsnorm"] = fl["rmsnorm"]
    if kind == "paged_prefill":
        want["ssd_scan"] = fl["ssd_scan"]
    return want


def _trace_step_facts(IC, TC, name, ctx, kind):
    """One traced step's facts (the static analyzers' trace, which gave
    the verdicts), and what they do not hold, checked: exact launches,
    the counted FLOPs and bytes equal to the CPU's count of the same step
    (run under FakeTensorMode at the same widths and geometry)."""
    ts = ctx.traced(kind)
    cost, syncs = IC.cost_report(ts), IC.host_syncs(ts)
    t = time.perf_counter()
    cpu_ts = IC.trace_step(ctx.arch, kind, ctx.geom, device="cpu",
                           shapes_only=True)
    cpu = IC.cost_report(cpu_ts)
    want = _step_launches(ctx.arch, kind)
    f = dict(flops=cost["flops"], bytes=cost["bytes"],
             cpu_flops=cpu["flops"], cpu_bytes=cpu["bytes"],
             cpu_count_s=time.perf_counter() - t,
             temp_bytes=cost["temp_bytes"],
             cache_bytes=IC.donation_report(ts)["cache_bytes"],
             argument_bytes=cost["argument_bytes"],
             h2d_copies=syncs["h2d_copies"], h2d_bytes=syncs["h2d_bytes"],
             launches=ts.launches, kernel_calls=cost["kernel_calls"],
             ops=len(IC.op_census(ts)))
    if kind != "slot_admit":
        row = TC.bench_row(ctx, kind)
        f.update({k: row[k] for k in ("flops_predicted", "bytes_predicted",
                                      "flops_rel_err", "bytes_ratio")})
    label = f"{TRACE_NAME}: {name} {kind}"
    if ts.launches != want or cost["kernel_calls"] != {
            k: v for k, v in want.items() if v}:
        fail(f"{label}: launches {ts.launches}, kernel calls "
             f"{cost['kernel_calls']}, want {want}")
    if (cost["flops"], cost["bytes"]) != (cpu["flops"], cpu["bytes"]):
        ops = sorted(set(ts.rec.by_op) | set(cpu_ts.rec.by_op))
        diff = {op: (ts.rec.by_op[op], cpu_ts.rec.by_op[op]) for op in ops
                if ts.rec.by_op[op] != cpu_ts.rec.by_op[op]}
        fail(f"{label}: counted {cost['flops']:.6g} FLOPs / "
             f"{cost['bytes']:.6g} bytes on the card, {cpu['flops']:.6g} / "
             f"{cpu['bytes']:.6g} on the CPU; (card, CPU) bytes by op "
             f"where they differ: {diff}")
    return f


def _trace_arch(torch, IC, TC, name, card):
    """Phase 43's part for one arch: the static analyzers at
    ``DEFAULT_GEOM`` and trace-cache at its tight pool, any finding
    fatal; each step's facts (``_trace_step_facts``); the audit's exact
    launches; printed -> its results."""
    from repro_torch.configs import get_arch

    arch = get_arch(name)
    ctx = TC.ArchContext(arch, TC.DEFAULT_GEOM, torch.device("cuda"))
    t = time.perf_counter()
    ctx.params                     # the weights, drawn on the card
    secs = {"init": time.perf_counter() - t}

    def run(a, **kw):
        t = time.perf_counter()
        findings = TC.ANALYZERS[a][0](ctx, **kw)
        secs[a] = time.perf_counter() - t
        if findings:
            fail(f"{TRACE_NAME}: {name}: " + "; ".join(
                f.format() for f in findings))
    for a in TRACE_STATIC:
        run(a)
    drained = []
    before = read_counts()
    run("trace-cache", drained=drained.append)
    eng, = drained
    m = eng.metrics
    got = {k: v - before[k] for k, v in read_counts().items()}
    want = {k: m.prefill_chunks * _step_launches(arch, "paged_prefill")[k]
            + m.decode_steps * _step_launches(arch, "paged_decode")[k]
            for k in ("rmsnorm", "ssd_scan")}
    if {k: got[k] for k in want} != want:
        fail(f"{TRACE_NAME}: {name} audit launches {got}, want {want}")
    audit = dict(signatures={k: len(v) for k, v in eng.signatures.items()},
                 preemptions=m.preemptions, prefill_chunks=m.prefill_chunks,
                 decode_steps=m.decode_steps, launches=got)
    steps = {kind: _trace_step_facts(IC, TC, name, ctx, kind)
             for kind in ctx.kinds()}
    for kind, f in steps.items():
        pred = ("" if kind == "slot_admit" else
                f" (predicted {f['flops_predicted']:.6g}, rel err "
                f"{f['flops_rel_err']:.4f})")
        bpred = ("" if kind == "slot_admit" else
                 f" (predicted {f['bytes_predicted']:.6g}, ratio "
                 f"{f['bytes_ratio']:.2f})")
        print(f"{TRACE_NAME}: {name} {kind}: {f['flops']:.6g} FLOPs{pred} "
              f"and {f['bytes']:.6g} bytes{bpred}, both equal to the CPU's "
              f"count ({f['cpu_count_s']:.1f} s); temp "
              f"{f['temp_bytes'] / 2**20:.1f} MiB beside "
              f"{f['cache_bytes'] / 2**20:.1f} MiB of pools; pools in "
              f"place, 0 host syncs, {f['h2d_copies']} host-to-device "
              f"copies of the host rows ({f['h2d_bytes']} B); launches "
              f"{ {k: v for k, v in f['launches'].items() if v} }; "
              f"{f['ops']} op kinds; on {card}")
    print(f"{TRACE_NAME}: {name} trace-cache: signatures "
          f"{audit['signatures']}, {audit['preemptions']} preemptions, "
          f"{audit['prefill_chunks']} prefill chunks and "
          f"{audit['decode_steps']} decode steps, launches "
          f"{ {k: v for k, v in got.items() if v} } as each step's; seconds "
          + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    del ctx, eng, drained
    IC.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return dict(steps=steps, audit=audit, seconds=secs)


def tracecheck_phase(torch, report, card):
    """43. tracecheck on the card: ``repro_torch.analysis.tracecheck``'s
    analyzers over qwen3-8b (36 layers) and mamba2-780m (48) at published
    widths in bf16 (``TRACE_ARCHS``), checked and printed
    (``_trace_arch``); the sharding analyzer in a process of its own
    (``trace_sharding_rank``), beside mamba2-780m's part, which holds ~2
    GB of the card."""
    from repro_torch.analysis import ircost as IC
    from repro_torch.analysis import tracecheck as TC

    reset_counts()
    res = {"archs": {TRACE_ARCHS[0]: _trace_arch(torch, IC, TC,
                                                 TRACE_ARCHS[0], card)}}
    t = time.perf_counter()
    pending = _start_ranks(trace_sharding_rank, 43, 1)
    for name in TRACE_ARCHS[1:]:
        res["archs"][name] = _trace_arch(torch, IC, TC, name, card)
    res["launches"] = read_counts()
    sh = _join_ranks(f"{TRACE_NAME} sharding", *pending)
    res["sharding"] = dict(sh, s=time.perf_counter() - t)
    if sh["findings"]:
        fail(f"{TRACE_NAME}: sharding: {sh['findings']}")
    print(f"{TRACE_NAME}: sharding {QWEN} on a {sh['mesh']} mesh over a "
          f"fake process group of {sh['world']} ranks: 0 findings, every "
          f"pool of every step as paged_cache_specs places it: "
          f"{sh['pools']}; analyzer {sh['analyzer_s']:.1f} s, peak memory "
          f"{sh['peak_mem_gb']:.2f} GB; {res['sharding']['s']:.1f} s from "
          f"its start")
    report[TRACE_NAME] = res


def trace_sharding_rank(rank, world, port, out, phase):
    """Phase 43's sharding analyzer in a process of its own: qwen3-8b at
    published widths, its pools placed by the plan on the reference's
    (data 4, model 2) mesh over a fake process group of 8 ranks on the
    card (``tracecheck.serve_mesh``; a refusal fails the phase).  Writes
    ``out``/tp.json: the findings, and how many pool leaves each step
    returned at each placements."""
    sys.path.insert(0, str(SRC))
    import torch

    from repro_torch.analysis import tracecheck as TC
    from repro_torch.configs import get_arch

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    ctx = TC.ArchContext(get_arch(QWEN), TC.DEFAULT_GEOM, dev)
    t = time.perf_counter()
    with TC.serve_mesh(dev) as mesh:
        findings, seen = TC.sharding_report(ctx, mesh)
        shape, size = list(mesh.shape), mesh.size()
    pools = {}
    for kind, got in seen.items():
        for _, pl in got:
            key = f"{kind} {pl}"
            pools[key] = pools.get(key, 0) + 1
    pathlib.Path(out, "tp.json").write_text(json.dumps({
        "mesh": shape, "world": size,
        "findings": [f.format() for f in findings], "pools": pools,
        "analyzer_s": time.perf_counter() - t,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}))


def _decode_run(torch, T, ST, arch, params, prompts, feed=None):
    """One contiguous prefill of ``prompts`` (B, S) then DECODE["steps"]
    greedy decode steps -> (each step's logits (steps+1, B, V) fp32, the
    tokens fed or picked (B, steps+1), the launches of each step, prefill
    ms, decode ms; both between CUDA events).  ``feed``: tokens to feed
    instead of the argmax (a teacher-forced rerun)."""
    B = prompts.shape[0]
    cache = T.init_cache(arch, B, DECODE["max_len"], device="cuda")
    prefill = ST.make_prefill_step(arch, impl="pallas")
    decode = ST.make_decode_step(arch, impl="pallas")
    logits, toks, launches = [], [], []
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    with torch.no_grad():
        reset_counts()
        ev[0].record()
        last, cache = prefill(params, cache, prompts)
        ev[1].record()
        launches.append(read_counts())
        for i in range(DECODE["steps"] + 1):
            logits.append(last[:, :arch.vocab].float())
            nxt = (feed[:, i] if feed is not None
                   else torch.argmax(logits[-1], dim=-1))
            toks.append(nxt)
            if i == DECODE["steps"]:
                break
            reset_counts()
            last, cache = decode(params, cache, nxt[:, None].int())
            launches.append(read_counts())
        ev[2].record()
    torch.cuda.synchronize()
    return (torch.stack(logits), torch.stack(toks, 1), launches,
            ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]))


def _decode_traced(torch, T, ST, name, arch, params, tokens):
    """One contiguous prefill of ``tokens``, then DECODE_TRACED greedy
    decode steps, each window under ``traced`` -> {"profile_prefill": ..,
    "profile_decode": ..}."""
    cache = T.init_cache(arch, tokens.shape[0], DECODE["max_len"],
                         device="cuda")
    prefill = ST.make_prefill_step(arch, impl="pallas")
    decode = ST.make_decode_step(arch, impl="pallas")
    state = {}

    def pre():
        state["last"], state["cache"] = prefill(params, cache, tokens)

    def dec():
        for _ in range(DECODE_TRACED):
            nxt = torch.argmax(state["last"][:, :arch.vocab], dim=-1)
            state["last"], state["cache"] = decode(params, state["cache"],
                                                   nxt[:, None].int())
    with torch.no_grad():
        return {"profile_prefill": traced(torch, f"decode prefill {name}",
                                          pre),
                "profile_decode": traced(torch, f"decode {DECODE_TRACED} "
                                         f"steps {name}", dec)}


def decode_phase(torch, np, report, name, arch, params, prompts, greedy,
                 profile=False):
    """44. The contiguous decode cache on ``arch`` (this model's serve
    depth and weights): ``make_prefill_step`` over DECODE["batch"] of the
    serve cell's prompts, then DECODE["steps"] greedy ``make_decode_step``
    calls; checks (a)-(c) of the module docstring fail the run, (d) is
    printed.  With ``profile``, one more prefill and DECODE_TRACED decode
    steps are traced (``traced``: the device's busy share, time by kernel
    and by operator)."""
    from unittest import mock

    from repro_torch.kernels import ops, ref
    from repro_torch.models import transformer as T
    from repro_torch.runtime import steps as ST

    B, n = DECODE["batch"], DECODE["steps"]
    tokens = torch.as_tensor(np.stack(prompts[:B]), device="cuda")
    S = tokens.shape[1]
    logits, toks, launches, pre_ms, dec_ms = _decode_run(
        torch, T, ST, arch, params, tokens)
    fl = forward_launches(arch)
    want_pre = {k: 0 for k in KERNELS}
    want_pre.update(rmsnorm=fl["rmsnorm"], ssd_scan=fl["ssd_scan"])
    want_dec = dict(want_pre, ssd_scan=0)
    if launches[0] != want_pre:
        fail(f"decode {name}: prefill launches {launches[0]}, want "
             f"{want_pre}")
    bad = [i for i, c in enumerate(launches[1:], 1) if c != want_dec]
    if bad:
        fail(f"decode {name}: decode step {bad[0]} launches "
             f"{launches[bad[0]]}, want {want_dec}")
    total = {k: sum(c[k] for c in launches) for k in KERNELS}
    if not torch.isfinite(logits).all():
        fail(f"decode {name}: logits not finite")
    # (a) one forward without a cache over the prompt and the tokens fed
    seq = torch.cat([tokens, toks[:, :n].to(tokens.dtype)], dim=1)
    with torch.no_grad():
        full = T.lm_apply(params, arch, seq, impl="pallas").logits
    want = full[:, S - 1:, :arch.vocab].float().transpose(0, 1)
    del full

    def worst(got, ref_):
        # per step: max |diff| against FORWARD_REL_TOL * max |logit|
        err = (got - ref_).abs().amax(dim=(1, 2))
        tol = FORWARD_REL_TOL * ref_.abs().amax(dim=(1, 2))
        return float((err / tol).max()), float(err.max()), \
            [i for i, ok in enumerate((err <= tol).tolist()) if not ok]
    ratio_a, err_a, bad_a = worst(logits, want)
    # (b) the same steps, the same tokens, the plain kernels
    with mock.patch.object(ops, "rmsnorm", ref.rmsnorm_ref), \
            mock.patch.object(ops, "ssd_scan", ref.ssd_scan_ref):
        plain, _, _, _, _ = _decode_run(torch, T, ST, arch, params, tokens,
                                        feed=toks)
    ratio_b, err_b, bad_b = worst(logits, plain)
    # (d) the greedy tokens against the paged serve's
    paged = np.asarray([g[:n] for g in greedy[:B]])
    mine = toks[:, :n].cpu().numpy()
    agree = float((paged == mine).mean())
    first = [int(np.argmax(r != p)) if (r != p).any() else None
             for r, p in zip(mine, paged)]
    sv = report[f"serve {name}"]
    tok_s = B * n / (dec_ms / 1e3)
    report[f"decode {name}"] = dict(
        batch=B, prompt_len=S, max_len=DECODE["max_len"], steps=n,
        prefill_ms=pre_ms, decode_ms=dec_ms, decode_tok_per_s=tok_s,
        launches=total, prefill_launches=launches[0],
        decode_step_launches=launches[1], max_abs_err_forward=err_a,
        tol_share_forward=ratio_a, max_abs_err_plain=err_b,
        tol_share_plain=ratio_b, paged_agreement=agree,
        first_divergence=first, paged_tok_per_s=sv["tok_per_s"],
        paged_ttft_p50_s=sv["ttft_p50_s"], paged_tpot_p50_s=sv["tpot_p50_s"])
    print(f"decode: {name}: contiguous cache B={B} S={S} max_len "
          f"{DECODE['max_len']}, prefill {pre_ms:.2f} ms, {n} decode steps "
          f"in {dec_ms:.2f} ms = {tok_s:.1f} tok/s (the paged serve: "
          f"{sv['tok_per_s']:.2f} tok/s over 8 requests, TTFT p50 "
          f"{sv['ttft_p50_s'] * 1e3:.1f} ms, TPOT p50 "
          f"{sv['tpot_p50_s'] * 1e3:.2f} ms); launches prefill "
          f"{launches[0]}, each decode step {launches[1]}; logits vs the "
          f"forward: max |diff| {err_a:.4g} ({100 * ratio_a:.1f}% of the "
          f"bound), vs the plain kernels {err_b:.4g} "
          f"({100 * ratio_b:.1f}%); greedy tokens vs the paged serve's: "
          f"{100 * agree:.1f}% agree, first divergence {first}")
    if profile:
        report[f"decode {name}"].update(_decode_traced(
            torch, T, ST, name, arch, params, tokens))
    if bad_a:
        fail(f"decode {name}: steps {bad_a} differ from the forward by more "
             f"than {FORWARD_REL_TOL} of max |logit|")
    if bad_b:
        fail(f"decode {name}: steps {bad_b} differ from the plain kernels "
             f"by more than {FORWARD_REL_TOL} of max |logit|")


def dryrun_start():
    """45, started: the dry run's cells (``DRYRUN_CELLS``) in child
    processes, each on a fake process group of 256 ranks with fake CUDA
    tensors, all at once -> (their processes, the start time).  They hold
    host cores and no device memory: ``main`` starts them before the
    build."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = {}
    for key in DRYRUN_CELLS + (DRYRUN_EP_CELL + ("moe-ep",),):
        arch, shape = key[:2]
        procs[key] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--no-save", "--device", "cuda"]
            + (["--moe-ep"] if len(key) > 2 else []),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=str(ROOT))
    return procs, time.perf_counter()


def _dryrun_records(procs, keys):
    """The ``record`` of each cell ``keys`` names, from its process of
    ``procs`` (``dryrun_start``): each must exit 0 with status ``ok``."""
    recs, errors = {}, []
    for key in keys:
        p = procs[key]
        try:
            out, err = p.communicate(timeout=DRYRUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
            errors.append(f"{key}: over {DRYRUN_TIMEOUT_S} s")
            continue
        rec = [json.loads(l[7:]) for l in out.splitlines()
               if l.startswith("record ")]
        if p.returncode != 0 or not rec or rec[0]["status"] != "ok":
            errors.append(f"{key}: exit {p.returncode}, "
                          f"{rec[0].get('error') if rec else err[-1500:]}")
            continue
        recs[key] = rec[0]
    if errors:
        fail(f"{DRYRUN_NAME}: {errors}")
    return recs


def dryrun_ep_phase(torch, report, card, pending):
    """45, the ``--moe-ep`` cell (``DRYRUN_EP_CELL``), read after phase 46:
    ``ok``, and its all-to-alls those of its specs: the dispatch and the
    return of each MoE layer in a decode step, each E * B_l * C * D bf16
    values (B_l = the batch over 16 `data` ranks, C at one token a row);
    its memory, cost and collectives printed."""
    from repro_torch.configs import SHAPES, get_arch
    procs, t0 = pending
    key = DRYRUN_EP_CELL + ("moe-ep",)
    rec = _dryrun_records(procs, [key])[key]
    arch, shape = get_arch(key[0]), SHAPES[key[1]]
    m = arch.moe
    layers = block_counts(arch)["mla"] + block_counts(arch)["moe_attn"]
    C = max(1, int(m.capacity_factor * m.top_k / m.n_experts))
    one = m.n_experts * (shape.global_batch // 16) * C * arch.d_model * 2
    want = {"count": 2 * layers, "bytes": 2 * layers * one,
            "result_bytes": 2 * layers * one}
    got = rec["collectives"]["all-to-all"]
    if got != want:
        fail(f"{DRYRUN_NAME} {key}: all-to-alls {got}, want {want}")
    coll = {k: (v["count"], v["bytes"]) for k, v in
            rec["collectives"].items() if isinstance(v, dict)}
    print(f"{DRYRUN_NAME}: {key[0]} x {key[1]} --moe-ep on 16x16 "
          f"({rec['method']}): ok, traced in {rec['trace_s']:.1f} s; "
          f"all-to-alls {got['count']} ({got['bytes']} bytes, the specs' "
          f"count); memory a rank {rec['memory']}; cost flops "
          f"{rec['cost']['flops']} bytes {rec['cost']['bytes']}, kernel "
          f"calls {rec['cost']['kernel_calls']}; collectives (count, bytes "
          f"from the other ranks) {coll}; model flops "
          f"{rec['model_flops']:.4g}")
    report[f"{DRYRUN_NAME} moe-ep"] = {
        k: rec[k] for k in ("method", "assignment", "memory", "cost",
                            "collectives", "model_flops", "trace_s")}


def dryrun_phase(torch, report, card, pending):
    """45. The dry run's records, ``pending`` from ``dryrun_start``: every
    cell ``ok`` and its counted cost (FLOPs, bytes, kernel calls) equal
    to the CPU's, ``DRYRUN_CPU_COST``."""
    procs, t0 = pending
    recs = _dryrun_records(procs, DRYRUN_CELLS)
    res = {}
    for arch, shape in DRYRUN_CELLS:
        gpu, cpu = recs[(arch, shape)], DRYRUN_CPU_COST[(arch, shape)]
        if gpu["cost"] != cpu:
            fail(f"{DRYRUN_NAME} {arch} x {shape}: the card's count "
                 f"{gpu['cost']} != the CPU's {cpu}")
        res[f"{arch} x {shape}"] = {
            k: gpu[k] for k in ("method", "microbatches", "memory", "cost",
                                "collectives", "model_flops", "trace_s")}
        coll = {k: (v["count"], v["bytes"]) for k, v in
                gpu["collectives"].items() if isinstance(v, dict)}
        print(f"{DRYRUN_NAME}: {arch} x {shape} on 16x16 ({gpu['method']}, "
              f"mb {gpu['microbatches']}): ok, traced in "
              f"{gpu['trace_s']:.1f} s; memory a rank {gpu['memory']}; "
              f"cost flops {gpu['cost']['flops']} bytes "
              f"{gpu['cost']['bytes']} (equal to the CPU's), kernel calls "
              f"{gpu['cost']['kernel_calls']}; collectives (count, bytes "
              f"from the other ranks) {coll}; model flops "
              f"{gpu['model_flops']:.4g}")
    report[DRYRUN_NAME] = dict(res, s=time.perf_counter() - t0)
    print(f"{DRYRUN_NAME}: {len(recs)} processes done "
          f"{report[DRYRUN_NAME]['s']:.1f} s after their start")


def examples_phase(torch, report, card):
    """46. The four example twins' functions on the card, each checked as
    its CPU test checks what does not need the reference."""
    import warnings

    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.examples import adaptive_switch as AS
    from repro_torch.examples import serve_continuous as SC
    from repro_torch.examples import serve_hybrid_archs as SH
    from repro_torch.examples import serve_lm as SL

    res = {}
    reset_counts()
    legacy = SL.main(["--device", "cuda"])
    if len(legacy) != 10 or any(len(r.out_tokens) != 12 for r in legacy):
        fail(f"{EXAMPLES_NAME}: serve_lm legacy: {len(legacy)} requests")
    outs, s, stats = SL.main(["--device", "cuda", "--share-prefix"])
    if not s["prefix_hit_rate"] > 0 or \
            any(o.finish_reason != "length" for o in outs):
        fail(f"{EXAMPLES_NAME}: serve_lm --share-prefix: hit rate "
             f"{s['prefix_hit_rate']}, {[o.finish_reason for o in outs]}")
    res["serve_lm"] = dict(prefix_hit_rate=s["prefix_hit_rate"],
                           prefill_chunks=s["prefill_chunks"])
    outs, s, streamed = SC.main(["--device", "cuda"])
    if (len(outs) != 10 or any(o.finish_reason != "length" for o in outs)
            or len(streamed) != s["total_tokens"]
            or any((o.logprobs is None) != (o.request_id % 2 == 0)
                   for o in outs)):
        fail(f"{EXAMPLES_NAME}: serve_continuous: {len(outs)} outputs, "
             f"{len(streamed)} of {s['total_tokens']} tokens streamed")
    res["serve_continuous"] = dict(tokens=s["total_tokens"],
                                   decode_steps=s["decode_steps"])
    for (outs, s, fe), front in zip(SH.main(["--device", "cuda"]),
                                    (set(), {0, 2, 4, 6})):
        if len(outs) != 8 or fe != front or \
                any(o.finish_reason != "length" for o in outs):
            fail(f"{EXAMPLES_NAME}: serve_hybrid_archs: {len(outs)} "
                 f"outputs, frontends {fe}")
    res["serve_hybrid_archs"] = "ok"
    rows = AS.plan_shift_demo()
    if len(rows) != 4 or rows[3]["time"] == rows[2]["time"]:
        fail(f"{EXAMPLES_NAME}: plan_shift_demo: {rows}")
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            hist, replans = AS.live_replan_demo("cuda")
            base, _ = AS.live_replan_demo("cuda", replan_every=0)
    finally:
        torch.use_deterministic_algorithms(prev)
    losses = [m["loss"] for m in hist]
    if not {20, 40, 60} <= set(replans) or \
            losses != [m["loss"] for m in base] or \
            not losses[-1] < losses[0]:
        fail(f"{EXAMPLES_NAME}: live_replan_demo re-planned at {replans}, "
             f"losses {losses[:3]}...{losses[-1:]} vs "
             f"{[m['loss'] for m in base][:3]}")
    res["adaptive_switch"] = dict(
        plans=[(r["shape"], r["method"], r["time"]) for r in rows],
        replans=replans, first_loss=losses[0], last_loss=losses[-1],
        step_ms_median=sorted(m["step_time_s"] for m in hist)[30] * 1e3)
    res["launches"] = read_counts()
    print(f"{EXAMPLES_NAME}: serve_lm (10 legacy requests; shared prefix "
          f"hit rate {res['serve_lm']['prefix_hit_rate']:.2f}), "
          f"serve_continuous ({res['serve_continuous']}), "
          f"serve_hybrid_archs (zamba2, whisper), adaptive_switch (plans "
          f"{res['adaptive_switch']['plans']}; re-planned at {replans}, "
          f"losses bit-equal to replan_every=0, {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, median step "
          f"{res['adaptive_switch']['step_ms_median']:.1f} ms) on the card; "
          f"launches {res['launches']}")
    report[EXAMPLES_NAME] = res


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

    # phase 34 runs with deterministic algorithms, whose cuBLAS check
    # reads this (the H100's default workspace already is 8 x 4 MiB)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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

    # 45. the dry run's cells start now, in child processes that hold host
    # cores and no device memory, while the kernels build; none outlives
    # the script
    pending = None if args.kernels_only else dryrun_start()
    try:
        return _run(args, torch, np, card, t_start, pending)
    finally:
        for p in (pending[0].values() if pending else ()):
            if p.poll() is None:
                p.kill()
                p.wait()


def _run(args, torch, np, card, t_start, pending) -> int:
    """``main`` from the build on; ``pending`` from ``dryrun_start``."""
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
    if pending is not None:
        # 45. the dry run's records (the seconds its processes added)
        t0 = time.perf_counter()
        dryrun_phase(torch, report, card, pending)
        seconds[DRYRUN_NAME] = time.perf_counter() - t0
    # 3. kernels vs their plain versions
    t0 = time.perf_counter()
    group_s = {}
    iters = {dn: TIMED_LAUNCHES if dn in TIMED_DTYPES else 0
             for dn in ("bfloat16", "float32")}
    rows = kernel_phase(torch, archs, iters, group_s)
    report["kernel_cases"] = rows
    report["kernel_phase_s"] = time.perf_counter() - t0
    report["kernel_group_s"] = group_s
    for r in rows:
        if r["ms"] is None:                 # checked, not timed
            r.update(library_ratio=None, bound_share=None,
                     cold_bound_share=None)
            print(f"kernel {r['name']} [{r['path']}: {r['use']}] "
                  f"{r['shape']} {r['dtype']}: "
                  f"{'ok' if r['ok'] else 'MISMATCH'} max_abs_err "
                  f"{r['max_abs_err']:.3g} (tol {r['tol']}), not timed")
            continue
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
    print(f"kernels: {len(rows)} cases in {report['kernel_phase_s']:.1f} s"
          f" (" + ", ".join(f"{k} {v:.1f}" for k, v in group_s.items())
          + ")")
    bad = [f"{r['name']} {r['shape']} {r['dtype']}" for r in rows
           if not r["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")

    # launches on each main path, each counted from 0 around its own run
    paths = [f"{p} {n}" for n in archs for p in ("serve", "forward")]
    paths += [f"sample {QWEN}", f"observe {QWEN}", f"sample {MAMBA}"]
    paths += [QWEN_CUT, f"placed {QWEN}", f"cluster {QWEN}"]
    paths += [f"train {n}" for n in TRAIN] + [f"trainer {QWEN}"]
    paths += [f"train {n}" for n in (VIT_B, RESNET, VIT_DEMO, VIT_224)]
    paths += [TP_NAME, TP_MOE_NAME, TP_DECODE_NAME, TP_EP_NAME, POD_NAME,
              TRACE_NAME]
    paths += [f"decode {n}" for n in DECODE_ARCHS]
    paths += [EXAMPLES_NAME]
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
            if name in DECODE_ARCHS:
                # 44. the contiguous decode cache on the same weights
                timed(f"decode {name}", decode_phase, torch, np, report,
                      name, arch, params, prompts, greedy,
                      profile=args.profile)
            # the model, weights and greedy tokens phases 29-32 and 38 run
            # on: qwen3-8b's at QWEN_CUT_LAYERS, served first
            follow = (arch, params, greedy, None)
            if name == QWEN:
                cut = cut_depth(arch, QWEN_CUT_LAYERS)
                p_cut, _, _, _, g_cut = timed(
                    QWEN_CUT, serve_phase, torch, np, report, name, cut,
                    key=QWEN_CUT)
                follow = (cut, p_cut, g_cut, QWEN_CUT)
                del p_cut
            f_arch, f_params, f_greedy, ref = follow
            if name in (QWEN, MAMBA):
                # 29./32. sampled serves; 30. the sampler; 31. observed
                timed(f"sample {name}", sample_phase, torch, np, report,
                      name, f_arch, f_params, prompts, f_greedy, ref=ref)
            if name == QWEN:
                timed("sampler", sampler_phase, torch, np, report,
                      arch.vocab)
                timed(f"observe {name}", observe_phase, torch, np, report,
                      name, f_arch, f_params, prompts, ref=ref)
                # 38. the engine placed on a 1 x 1 mesh
                timed(f"placed {name}", placed_phase, torch, np, report,
                      name, f_arch, f_params, prompts, f_greedy, ref=ref)
            del follow, f_params
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
            if name == QWEN:
                # 39. the serving cluster: two replicas on the card
                timed(f"cluster {name}", cluster_phase, torch, np, report,
                      name, arch, prompts, greedy)
        # 8./9./14./23./28. train, with the serving weights freed
        for name in TRAIN:
            timed(f"train {name}", train_phase, torch, report, name,
                  archs[name], card, profile=args.profile)
            gc.collect()
            torch.cuda.empty_cache()
        # 33. the planner for the H100; 34. the Trainer on a 1 x 1 mesh
        timed("plan", plan_phase, torch, report, archs[QWEN], card)
        gc.collect()
        torch.cuda.empty_cache()
        timed(f"trainer {QWEN}", trainer_phase, torch, report, archs[QWEN],
              card)
        # 35.-37. the paper's experiment: ViT-B, ResNet-50, then the
        # tables, the reference demo and ViT-B/16 at 224
        for label, phase in ((f"train {VIT_B}", vit_phase),
                             (f"train {RESNET}", resnet_phase),
                             ("paper", paper_phase)):
            gc.collect()
            torch.cuda.empty_cache()
            timed(label, phase, torch, report, card, profile=args.profile)
        # 40. zamba2 tensor-parallel on 2 ranks of the one card
        gc.collect()
        torch.cuda.empty_cache()
        timed(TP_NAME, tp_phase, torch, report, card)
        # 41. deepseek tensor- and expert-parallel on the same mesh
        gc.collect()
        torch.cuda.empty_cache()
        timed(TP_MOE_NAME, tp_moe_phase, torch, report, card)
        # 42. HP on a (pod 2, data 2, model 1) mesh: four ranks of the card
        gc.collect()
        torch.cuda.empty_cache()
        timed(POD_NAME, pod_phase, torch, report, card)
        # 43. tracecheck's five analyzers on the card
        gc.collect()
        torch.cuda.empty_cache()
        timed(TRACE_NAME, tracecheck_phase, torch, report, card)
        # 46. the examples' twins
        gc.collect()
        torch.cuda.empty_cache()
        timed(EXAMPLES_NAME, examples_phase, torch, report, card)
        # 45, read late: the --moe-ep cell traced beside the card's phases
        timed(f"{DRYRUN_NAME} moe-ep", dryrun_ep_phase, torch, report, card,
              pending)
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
        "ssd_scan_bwd": (f"train {MAMBA}", f"{MAMBA} train", "scan"),
        "rmsnorm_split": (TP_NAME, f"{TP_NAME} train", "gated norm (split)"),
        "rmsnorm_split_bwd": (TP_NAME, f"{TP_NAME} train",
                              "gated norm (split)")}
    # the split-row RMSNorm partitions the whole-row one: it replaces the
    # same TPU kernel, whose rows the reference's GSPMD splits with one
    # all-reduce of the sums of squares
    replaces = {"rmsnorm": "src/repro/kernels/rmsnorm.py:20",
                "rmsnorm_bwd": "src/repro/kernels/rmsnorm.py:20",
                "rmsnorm_split": "src/repro/kernels/rmsnorm.py:20",
                "rmsnorm_split_bwd": "src/repro/kernels/rmsnorm.py:20",
                "flash_attention": "src/repro/kernels/flash_attention.py:77",
                "flash_attention_bwd":
                    "src/repro/kernels/flash_attention.py:77",
                "ssd_scan": "src/repro/kernels/ssd_scan.py:71",
                "ssd_scan_bwd": "src/repro/kernels/ssd_scan.py:71"}
    sources = {"rmsnorm_bwd": "rmsnorm", "rmsnorm_split": "rmsnorm",
               "rmsnorm_split_bwd": "rmsnorm"}
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
    slow = SLOW_HOST * seconds["total"]
    print(f"time: {seconds['total']:.1f} s; on a host {SLOW_HOST}x slower "
          f"{slow:.0f} s of the {TIME_LIMIT_S} s limit"
          + (" (OVER: cut an earlier phase's depth)" if slow > TIME_LIMIT_S
             else ""))
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
