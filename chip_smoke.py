#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which either passes or ends the script with a non-zero
exit code:

1. **device** — ``nvidia-smi`` name and power limit, torch/CUDA versions;
   the CUDA kernels are built from ``paddle_tpu_torch/ops/kernels/csrc``
   with nvcc (one process per source, started together) and timed.
2. **kernel parity** — each hand-written kernel against its plain PyTorch
   version on the card: ragged paged attention on a mixed launch (decode
   rows, a whole-prompt prefill, a mid-page chunk continuation, an unused
   row, pad tokens; H=16, D=128, page 16; MHA and GQA KVH=4; f32 and bf16)
   and LayerNorm on ``[T, 2048]`` (f32 and bf16). Then a 2-layer f32 model
   at ``gpt_1p3b`` widths serves through the engine and is held against a
   dense causal forward written here in plain torch (greedy tokens equal,
   logits within 1e-3).
3. **serve** — ``gpt_1p3b`` in bf16 with random weights from a seed on
   ``ServingEngine(jit=True)`` (16 slots, page 16, 2048 pages, chunked
   prefill 256): ``warm_ragged()`` captures one CUDA graph per token pad
   (prints the graph count, the capture seconds and the device memory
   the captures reserved), then 36 requests under Poisson arrivals — 32
   of mixed length (16-512 prompt tokens) and 4 sharing a 128-token head
   so prefix hits run — 32 new tokens each, every round a replay.
   Launch counters are zeroed after ``warm_ragged()``, just before the
   load, and read just after; each served round must have launched the
   attention kernel once per layer and the LayerNorm kernel 2 x layers +
   1 times (a replay adds the launches its capture recorded). Prints
   tokens/s, TTFT/ITL p50/p99, rounds, distinct pads and peak KV
   occupancy. Then the largest mixed round and the widest decode round
   run again on the engine, replayed and eager, on the same inputs: the
   greedy tokens must be equal and the logits bit-equal.
4. **timing** — ragged attention held against its plain version at the
   serve phase's largest mixed and widest decode rounds on the served
   layer-0 pools (f32 within 1e-4, bf16 within 4e-3); then device time per
   call of each kernel at the serve phase's largest round, beside its
   bound (bytes over 3.35 TB/s or operations over 989 TFLOP/s, the
   larger), its plain version's time and,
   for LayerNorm, ``torch.nn.functional.layer_norm``'s time as
   ``library_ms`` (the port never calls it). Kernel times are device
   time from ``torch.profiler`` (CUDA events when the trace is empty).
   The ragged kernel's entry adds the widest decode round's time and
   bound as ``decode_ms`` and ``decode_bound_ms`` beside the mixed
   round's ``ms`` and ``bound_ms``; its ``max_abs_err`` is the larger of
   the two rounds' bf16 errors.
5. **profile** — a steady decode round of 16 rows on the host clock and
   under ``torch.profiler``: device busy share and device time by kernel
   family, for eager rounds (``jit=False``), then replays (``jit=True``),
   the host ms split into the
   scheduler and assembly, the program call (staging copy and replay, or
   the eager forward) and the wait on the fetch. A replayed round's trace
   must show the ragged attention and LayerNorm kernels.
6. **train-kernel parity** — the flash forward, dQ and dK/dV kernels
   against their plain versions at ``[2, S, 16, 128]`` (S = 1024 and the
   unaligned 1000, and in bf16 also 1 and 129, causal and not; the bf16
   forward, dQ and dK/dV are the Hopper kernels of
   ``csrc/flash_attention_sm90.cu``; f32 within 1e-4, bf16 within 2e-2
   elementwise, a few bf16 ulps at these magnitudes, and within 1e-2 in
   ``||got - plain|| / ||plain||``), q/k/v read as strided views of one
   fused projection; the autograd gradients of ``flash_attention_bshd``
   against autograd through the plain chain (f32, 1e-4); fused AdamW in
   one multi-tensor launch over mixed sizes with one bf16 tensor (f32
   within 1e-6, bf16 within one rounding).
7. **train parity** — a 2-layer f32 model at ``gpt_1p3b`` widths takes one
   step (B 2, S 512) through the kernels: its loss and every gradient are
   held against autograd through a dense plain forward written here, then
   its AdamW step against the plain update.
8. **train** — ``gpt_1p3b`` (24 layers), f32 master weights, ``auto_cast``
   O1 bf16, ``AdamW(1e-4)``, a fixed batch of B 8 x S 1024 from numpy
   seed 0: 2 warm-up steps, then 10 timed steps. The losses must be finite
   and fall; the counters, zeroed after warm-up, must read exactly 24
   launches of each flash kernel, one of AdamW and 49 of LayerNorm per
   step. Prints median step ms, tokens/s, ``gpt_train_step_mfu``
   (``bench.py:435`` FLOPs over step time over 989 TFLOP/s) and peak
   memory.
9. **train timing and profile** — one step under ``torch.profiler``
   (device time by family, the flash backward split into dQ and dK/dV;
   busy share); each new kernel held against its
   plain version at the slice's shapes (flash at ``[8, 1024, 16, 128]``
   bf16 causal with phase 6's limits; AdamW in one launch over the
   model's 292 tensors against the plain update of clones, within 1e-6),
   whose errors are the kernels' ``max_abs_err``; then device time per
   call of each beside its bound, its plain version's time and
   ``library_ms`` (``F.scaled_dot_product_attention`` forward,
   its backward for the two backward kernels, ``torch._fused_adamw_``;
   timed here only, never called by the port). The entries of the bf16
   forward, dQ and dK/dV kernels add their registers and spill bytes from the
   ``ptxas -v`` build log and their shared memory per block.
10. **bucketed parity** — once the training model is freed: the paged
    decode kernel against its plain version (H 16, D 128, page 16, MHA
    and GQA KVH 4, f32 within 1e-4, bf16 within 2e-2; contexts crossing
    pages and the full ``max_pages * page``, contexts one key either side
    of the split edges of the kernel's launch plan, tables padded with
    -1, a context-0 row that must be exactly zero), RMSNorm on ``[T, 2048]``
    (f32 and bf16, with and without bias); then a 2-layer f32
    ``gpt_1p3b(use_rms_norm=True)`` served through
    ``ServingEngine(ragged=False)``, unchunked (a prefix hit, a prompt in
    the 16-token seq bucket) and with ``prefill_chunk=16``, against the
    dense plain forward (greedy tokens equal, logits within 1e-3); the
    flash kernels at the smallest seq bucket, S = 16, and in bf16 at S = 1
    and 129.
11. **bucketed serve** — ``gpt_1p3b(use_rms_norm=True)`` bf16 (24 layers,
    random weights from seed 0) on ``ServingEngine(ragged=False)``: 16
    slots, page 16, 2048 pages, unchunked, so misses take the dense
    prefill (the flash forward kernel; the head on each row's last token)
    and prefix hits the chunk step; every round is a program
    (``jit=True``): a CUDA graph per (batch, seq) bucket of the prefill
    and of the chunk step, captured at the bucket's first round, and one
    of the decode step. A short ``generate`` captures the decode step and
    one prefill bucket, then phase 3's 36-request Poisson load runs twice,
    from phase 3's seed and from another (the second over the programs
    the first captured), counters zeroed just before each; launches must
    equal exactly 24 paged attention per decode step, 49 RMSNorm per
    forward (decode steps, dense prefills and chunk steps) and 24 flash
    forward per dense prefill, a capture's warm-up run counted as a
    round. Prints tokens/s, TTFT/ITL p50/p99 of both loads, rounds, peak
    KV occupancy, the graphs and the device memory they reserved; the
    widest decode step, the largest dense prefill and the largest chunk
    step replayed and eager (tokens equal, logits bit-equal); and a
    steady decode step profiled as in phase 5 (the paged decode kernel
    must show as its own family, and RMSNorm, in the replayed steps).
12. **bucketed timing** — paged attention at the serve's widest decode
    step on the served layer-0 pools (f32-upcast within 1e-4, bf16 within
    4e-3 against plain) and RMSNorm at [rows of the largest dense prefill,
    2048] bf16, each beside its bound, its plain version and, for
    RMSNorm, ``torch.nn.functional.rms_norm`` as ``library_ms``; the
    paged entry adds its build's registers and spills, its shared memory
    a block and split count, and a sweep at the engine's widths (16 rows
    x 128, 512 and 1024 keys, 1 row x 1024; each checked, timed, beside
    its bound and GB/s); the flash forward at the largest dense prefill's
    shape beside ``F.scaled_dot_product_attention``. (``paged_splits.py``
    times the paged kernel at other split counts.)

13. **O2 train** — ``gpt_1p3b`` (24 layers) built in f32 from seed 0 and
    decorated ``amp.decorate(level="O2", dtype="bfloat16")``: bf16
    parameters, ``AdamW(multi_precision=True)`` with f32 masters (the
    fused AdamW kernel's master mode), ``ClipGradByGlobalNorm(1.0)`` and
    ``LinearWarmup(CosineAnnealingDecay(1e-4, T_max=100), 4, 0, 1e-4)``
    stepped every step, under ``auto_cast`` O2 (the tied head a bf16
    product); phase 8's batch, 2 warm-up and 10 timed steps. The losses
    must be finite and fall, and the launches exact: per step the flash
    forward, dQ and dK/dV 24 times each, LayerNorm 49 and AdamW once.
    Prints step ms, tokens/s, ``gpt_train_step_mfu``, peak memory, one
    profiled step (families, busy share) and the losses. Then the same
    with ``recompute=True``: the flash forward 48 and LayerNorm 97 times
    a step, a lower peak, and losses within 1e-3 of the run without
    recompute.
14. **master mode and resume** — the fused AdamW kernel's master mode
    (f32 masters and moments, the bf16 parameters written in the same
    pass) and bf16-moment mode, each one launch over the O2 model's 292
    tensors, against the plain version (f32 within 1e-6, bf16 within one
    rounding, each parameter exactly its master rounded); both timed as
    one launch over a prebuilt table (CUDA events over back-to-back
    launches, the wrapper's host work and synchronous table copy left
    out) beside their bounds (28 and 14 bytes a parameter) and the f32
    mode on the same tensors, master mode also beside
    ``torch._fused_adamw_`` on the masters with upcast gradients plus
    ``torch._foreach_copy_`` into the parameters (each part printed);
    a resume at full width and 2 layers (2 steps, model, optimizer and
    scheduler saved to the host, 2 more, against a restore plus the same
    2: bit-equal); a ``GradScaler`` whose injected inf skips the step,
    leaves weights and masters alone and halves the scale.

15. **generate** — the flash forward at one query row (``Sk`` 1, 17,
    129, 383, 1000; f32 within 1e-4, bf16 with phase 6's limits) against
    its plain version, and timed at ``Sk = 383`` beside its bound and
    ``F.scaled_dot_product_attention``; then ``GPTForCausalLM.generate``
    on ``gpt_1p3b`` bf16 (24 layers, seed 0), batch 4, 128-token prompts,
    256 new tokens: greedy compiled twice (the step one CUDA graph,
    captured in the first call), the same static step eagerly (bit-equal
    to the replays), greedy eager over the dense cache (the flash forward
    at ``Sq = 1``) and sampled with ``top_k=50`` twice from one seed
    (equal). Launches exact (LayerNorm 49 a forward; the flash forward 24
    a dense-cache forward, none in the static step); every greedy token
    the argmax of a no-cache forward over its sequence within ``2e-2 +
    2e-2 |max|``, every sampled one within that of its step's top 50.
    Prints ms a step and tokens/s on the host clock and the capture
    seconds.
16. **operations** — the serving engine's operational surface on
    ``gpt_1p3b`` bf16 (24 layers, seed 0) with two ragged engines A and B
    on one model (16 slots, page 16, 2048 pages each, chunked prefill
    256, ``jit=True``): (a) after ``warm_ragged()``, phase 3's load twice
    on A, once with request tracing at sample rate 1 and a metrics
    registry writing JSONL, once with both off (tokens/s, TTFT/ITL
    p50/p99, the host ms a round split as in phase 5; every request's
    trace runs ``enqueue`` … ``request_done``, one ``decode_round`` span a
    round, ``trace_report`` one row a request, the JSONL's counters equal
    the engine's own; launches exact: 24 ragged attention and 49
    LayerNorm a round); (b) a 200-token request decoded alone on A for 8
    rounds moves to B by ``fleet.migrate_request``: ``snapshot_kv`` on B
    equals A's payload bit for bit, and B's continuation gives the tokens
    and the bit-equal logits of the same request run unmigrated on A
    (payload bytes and the ms of snapshot, release and adopt printed);
    (c) 16 requests on A, 8 of them migrated to B after 8 rounds and one
    more aborted (slot freed, pages back to refcount 0, ``on_done`` never
    fired), every other request finishing with its tokens, each greedy
    token the argmax of a no-cache forward within phase 15's tolerance,
    launches exact on both engines; (f) an engine built with
    ``attn_backend="auto"`` reports the gate's plain and kernel times,
    stays ``"pallas"`` and launches the ragged kernel in its next round,
    and ``"xla"`` on the card raises; (d) 36 requests into 16 slots, then
    ``shutdown(drain_s=30)`` after 4 rounds (queued requests fail with
    ``EngineShuttingDown``, every in-flight one finishes, the summary
    counts both, the JSONL is flushed), and ``drain_s=0`` on a fresh load
    (the in-flight requests fail naming the deadline); (e) a child
    process (``chip_smoke.py --sigterm-child``: a 2-layer model at
    ``gpt_1p3b`` widths, ``install_sigterm``, a request started) is sent
    SIGTERM and must exit 75 after printing the request's complete
    tokens; (g) the bucketed engine (2 layers at full width, RMSNorm,
    ``ragged=False``) migrates a request alone as in (b), tokens equal
    and logits bit-equal, launches exact (2 paged attention and 5 RMSNorm
    a decode step, 2 flash forward a dense prefill, a capture's warm-up
    counted).
17. **the other models' kernel shapes** — the flash forward, dQ and dK/dV
    against their plain versions in the ``DP = 64`` tiles: [2, S, 12, 64]
    for S in 512, 1, 129, 1000, [4, 7, 4, 16] over 11 keys and
    [2, 300, 4, 32] over 77 (f32 within 1e-4, bf16 within phase 6's
    limits, causal and not); ``flash_attention_bshd``'s autograd at
    [2, 512, 12, 64] f32 non-causal against the plain chain; LayerNorm
    at [8192, 768] (f32 and bf16, epsilon 1e-12 and 1e-5); fused AdamW's
    master mode over f16 parameters (each exactly its master rounded).
    Then the flash trio at BERT-base's [16, 512, 12, 64] bf16 non-causal
    and LayerNorm at [8192, 768] bf16, timed beside their bounds, plain
    versions and ``F.scaled_dot_product_attention`` / ``F.layer_norm``.
18. **LeNet** — ``bench.py:379-397``'s step (B 64 x 1 x 28 x 28 f32 from
    numpy seed 0, ``Adam(1e-3)``): 5 warm-up and 30 timed steps, steps/s
    on the host clock, falling losses, one AdamW launch a step.
19. **ResNet-50 O2 float16** (BASELINE config 2, one card) —
    ``resnet50(num_classes=1000)`` at full depth and width, B 128 x 3 x
    224 x 224 random images and labels from numpy seed 0,
    ``decorate(level="O2", dtype="float16")``, ``Momentum(0.1, 0.9,
    L2Decay(1e-4), multi_precision=True)``, ``GradScaler(2**15)``: 2
    warm-up and 10 timed steps; the first step's loss and update against
    the same step in f32 from the same weights (loss within 1e-2
    relative, each group's update norm within 10%, the classifier's
    update within 10%), losses finite and the
    lowest of steps 1-3 below step 0's, every BatchNorm statistic finite
    and moved; images/s, step ms, peak memory,
    the scale, a profiled step (convolution, batch norm, GEMM and
    elementwise families, busy share); then O1 bf16 on f32 weights.
20. **BERT-base** — (a) a 2-layer f32 ``BertForMaskedLM`` at
    ``bert_base`` widths: its loss and every gradient against autograd
    through a dense plain forward (as phase 7); (b) ``BertForMaskedLM(
    bert_base(dropout=0.0))`` at full size, O2 bf16 with ``AdamW(1e-4,
    multi_precision=True)``, B 16 x S 512, 2 warm-up and 10 timed steps:
    launches exact (flash forward, dQ and dK/dV 12 a step each,
    LayerNorm 26, AdamW 1), step ms, tokens/s, peak, MFU (``6 N tokens +
    12 L B S^2 h`` over 989 TFLOP/s) and a profiled step; (c)
    ``BertForSequenceClassification`` in eval, bf16: flash without a
    mask, the plain chain with an all-ones mask, logits within bf16
    limits of each other.
21. **seq2seq** — ``tests/test_models.py:216-260``'s copy task on the
    card (vocab 16, d_model 64, nhead 4, 120 Adam steps): the loss under
    0.1 x the first, ``translate`` reproducing at least 90% of the source
    tokens, the flash trio launched exactly twice a training step (the
    encoder's self-attention and the cross-attention).

22. **to_static** — ``paddle_tpu_torch.jit.to_static``: the f16
    instantiation of the flash forward, dQ and dK/dV against their plain
    versions at [8, 1024, 16, 128] causal and [16, 512, 12, 64] full
    (phase 6's bf16 limits) and timed at the first beside bound, plain
    version and f16 ``F.scaled_dot_product_attention``; then each train
    step below eager and staged (``to_static(step, capture=(model,
    opt))``: its first call the eager warm-up, its second the capture and
    first replay, every later one a replay of one CUDA graph) from the
    same weights and batch, each call ending in ``float(loss)``: ms a
    step, steps/s, peak allocated (the graph pool's included) and
    reserved memory, and one profiled step's device busy share, staged
    beside eager; the counters zeroed after the warm-up calls must read
    the replays' launches exactly. (a) LeNet at ``bench.py:379-397``'s
    configuration (f32, B 64, ``Adam(1e-3)``, 5 warm-up and 30 timed
    steps): losses and weights bit-equal to eager, or within 1e-5 where
    a second eager run is not bit-equal either; one AdamW launch a step.
    (b) ``bench_gpt``'s model (``bench.py:400-437``: vocab 8192, hidden
    512, 8 layers, 8 heads, S 512, B 16, O1 bf16, ``AdamW(1e-4)``; 3 and
    20 steps): the flash trio 8 each, LayerNorm 17, AdamW 1 a step, MFU by
    ``bench.py:435``'s formula. (c) phase 13's O2 ``gpt_1p3b`` step (B 8
    x S 1024, masters, clip, the schedule stepped outside the staged
    step; 2 and 10 steps): losses within 1e-3 of eager, each timed step's
    mean change of one f32 master within 1% of eager's (the lr changes
    every step and the replays read it from the static AdamW table),
    the flash trio 24 each, LayerNorm 49, AdamW 1 a step; the peak with
    the graph pool. (d) phase 20b's BERT-base O2 step: losses within
    1e-3, the flash trio 12 each, LayerNorm 26, AdamW 1 a step; then
    AdamW's master mode over BERT's tensors checked and timed as phase
    14 times gpt_1p3b's. (e) phase 19's ResNet-50 O2 float16 step with
    its ``GradScaler``: exactly one graph-break warning (``unscale_``'s
    ``bool()``), every later call eager, losses equal phase 19's (or
    within 2e-3 where two eager runs differ too), and ``full_graph=True``
    raising at its capture with parameters, masters, velocities, ``.grad``
    and the scale untouched. (f) ``to_static(BertForMaskedLM(bert_base))``
    in eval, bf16: every call's logits bit-equal to the eager forward's,
    the replays' launches exact.

23. **the vision zoo and the other optimizers** — (a) every factory of
    ``models/vision_zoo.py`` and ``vision_zoo2.py`` (31, ``num_classes=
    1000``, f32, batch norms calibrated on the batch): eval logits at B 8
    x 3 x 224 x 224 (299 for InceptionV3) against the port's CPU forward
    of the same weights (``2e-3 + 2e-3 |cpu|``, norm error 1e-3), one
    training step with finite gradients, fwd + bwd timed at B 64 with its
    peak memory; (b) MobileNetV2 with the paper's ``RMSProp(0.045, rho
    0.9, momentum 0.9, L2Decay(4e-5))``, masters, ``ExponentialDecay(
    0.98)`` a call, O2 bf16, B 96, eager and staged (0 breaks, equal to
    eager, no hand kernel; images/s, busy share, families with the
    depthwise convolutions' share); (c) phase 20b's BERT-base step with
    ``Lamb(1e-4, lamb_weight_decay=0.01)``, eager and staged (0 breaks,
    equal to eager, the flash trio 12 each and LayerNorm 26 a replayed
    step), then the Lamb step alone timed over the same 205 tensors as
    22d's fused AdamW; (d) LeNet with Adagrad, Adadelta, Adamax, Rprop and
    centered RMSProp, eager, staged and against the CPU, and LBFGS with
    the strong-Wolfe search against the CPU.

24. **the high-level API** — (a) the hapi quick-start: ``Model(LeNet())``
    with ``Adam(1e-3)``, ``CrossEntropyLoss`` and ``Accuracy(topk=(1,
    5))`` fits 8192 MNIST-shaped images (labels a fixed function of the
    image, numpy seed 0) for 2 epochs at B 64 three times, through
    ``DataLoader(num_workers=0)`` without and with the buffered reader and
    with 2 workers (cuDNN deterministic): batches equal, losses bit-equal,
    one graph, 0 breaks, one AdamW launch a step; ``evaluate``,
    ``predict``, ``save`` and a fresh ``Model.load`` evaluating to the
    same; (b) BERT-base fine-tuning through ``Model.fit`` on the BERT
    paper's GLUE recipe (``BertForSequenceClassification(bert_base(
    dropout=0.0))``, B 32 x S 128, ``AdamW`` wd 0.01 at 2e-5 with a 10%
    ``LinearWarmup`` and linear decay stepped by
    ``callbacks.LRScheduler``, ``amp_configs="O1"``, ``Accuracy()``, 3200
    sequences through ``DataLoader(num_workers=2)``, 100 steps, telemetry
    on), then ``evaluate`` on 640: losses equal a hand-written
    ``to_static`` loop's within 1e-3 with the same moving lrs, one
    capture, 0 breaks, launches exact (flash 12 / 12 / 12, LayerNorm 25,
    AdamW 1 a replayed step; flash 12 and LayerNorm 25 an evaluate
    batch); steps/s, samples/s, tokens/s, ``bert_train_step_mfu`` beside
    telemetry's ``mfu_pct``, the data-wait share, peak memory, eval
    accuracy, ``pt.summary`` / ``pt.flops``; the flash trio at [32, 128,
    12, 64] bf16 (phase 6's limits), LayerNorm at [4096, 768] f32 and
    fused AdamW's f32 mode over the model's tensors, checked and timed.
25. **op surface** — (a) every case of the CPU parity table
    (``tests/torch_surface_cases.py``: the ``paddle.*`` creation, math,
    manipulation, logic, search and linalg ops) on the card against the
    same port call on CPU tensors: ints and bools exact, f32 within
    1e-5, f64 1e-10, factorised f32 linear algebra 1e-4, decompositions
    by their invariants; each output on the card with the CPU's dtype
    and shape; (b) one ``gpt_1p3b`` decoder block in bf16 at B 8 x S 1024
    through ``GPTBlock.forward`` and written against the surface
    (``pt.matmul`` + ``pt.add``, heads by ``pt.reshape`` /
    ``pt.transpose`` / ``pt.split``, flash attention through
    ``scaled_dot_product_attention``, the block's LayerNorms): outputs and
    every gradient within a relative L2 of 1e-2, the flash trio and
    LayerNorm launched (counters and a ``torch.profiler`` trace), host ms
    of both ways, ``pt.grad`` against ``backward``; (c)
    ``top_p_sampling`` at [16, 50304] (ids in their nucleus, repeatable
    under ``pt.seed``, total variation at most 0.05 over 4096 draws),
    ``multinomial`` without replacement, ``topk`` against the CPU; (d)
    host us a call of ``pt.add`` / ``reshape`` / ``matmul`` / ``sum``
    against bare torch.
26. **nn.Layer, initializers, ParamAttr** — (a) a BERT-base classifier
    written as a user writes it, a subclass of ``pt.nn.Layer``
    (:func:`user_bert`: ``nn.Embedding(30522, 768, padding_idx=0)`` at
    half the rate, a frozen position table from ``create_parameter``,
    12 ``nn.TransformerEncoderLayer`` (768, 12 heads, FFN 3072, GELU)
    drawn from ``TruncatedNormal(std=0.02)`` in an
    ``nn.TransformerEncoder``, ``nn.LayerNorm(768, epsilon=1e-12)``, a
    head ``nn.Linear(768, 2)`` at ten times the rate with a bias the clip
    passes through), B 32 x S 128 (the BERT paper's GLUE recipe, as 24b),
    O1 bf16 on f32 weights, ``AdamW(2e-5, weight_decay=0.01)`` with
    ``ClipGradByGlobalNorm(1.0)``, eager (2 + 5 steps) and staged by
    ``to_static`` (2 + 20): 1 graph, 0 breaks, launches exact (the flash
    trio 12, LayerNorm 25, AdamW 1 a replay), losses falling, the frozen
    table and the padding row bit-unchanged, one replay's update of the
    head weight and of an embedding row equal to ``torch.optim.AdamW``'s
    at the scaled rate (and not the unscaled one); (b) the step-0 state
    through ``pt.save`` / ``pt.load`` and ``set_state_dict`` between
    replays: the next replay's loss the eager step 0's, a wrong shape a
    ``ValueError``, missing and unexpected keys returned; (c) each
    initializer at [768, 3072] from a CUDA generator by its support and
    moments, ``QQ^T = I`` for ``Orthogonal``, draws repeated by
    ``pt.seed``; (d) host us a call of ``pt.nn.Linear(768, 768)``'s
    ``layer(x)`` and ``layer.forward(x)`` on [32, 128, 768] bf16 beside
    a bare ``torch.nn.Linear``'s.
27. **the rest of nn** — (a) every case of ``tests/torch_nn_cases.py``
    (each functional and layer the ``nn`` slice added: the convolutions
    and transposed ones, the 1-D / 3-D and adaptive pools and the
    unpools, ``pad`` in its four modes, ``interpolate``, ``grid_sample``,
    ``fold``, the norms, the RNN cells and layers, CTC, RNN-T and the
    long-tail losses, ``nn.utils``' reparameterisations) on the card
    against the same call on CPU tensors: outputs and every gradient
    within rtol 1e-4 / atol 1e-5 (f32, TF32 off), the worst error per
    op; (b) the flash trio at the Conformer-M shape [16, 255, 4, 64]
    bf16 non-causal (255 is no multiple of the tiles) against its plain
    versions and timed beside its bound and sdpa, LayerNorm at
    [4080, 256] f32 and fused AdamW's f32 mode over the model; then a
    Conformer-Transducer written as a user writes it
    (:func:`conformer_transducer`; Conformer-M of Gulati et al. 2020,
    Table 1: 16 blocks, d 256, 4 heads, FFN 1024, conv kernel 32, an
    LSTM(640) predictor, V 1024) on 80-bin features of 1024 frames, B
    16, labels of 32-64 tokens (U + 1 = 65), O1 bf16, ``AdamW(beta 0.9 /
    0.98, eps 1e-9, weight_decay 1e-6)`` on ``NoamDecay(256, 10000)``
    from its peak, eager (2 + 3 steps) and staged by ``to_static`` (2 +
    10): 1 graph, 0 breaks, launches exact (the flash trio 16, LayerNorm
    80, AdamW 1 a replay), losses falling, the staged step-0 loss the
    eager one's, the profiled replay's largest kernels; RNN-T and CTC
    alone at the model's shapes, eager and replayed from a graph; (c)
    beam search (``BeamSearchDecoder`` + ``dynamic_decode``, beam 4, 16
    steps) over the trained predictor's ``LSTMCell`` on the card and on
    a CPU copy: the same ids.
28. **the core runtime modules and the incubate fused surface** — (a)
    every case of ``tests/torch_incubate_cases.py`` (each function of
    ``incubate`` and ``incubate.nn.functional`` and each ``incubate.nn``
    layer) on the card against the CPU as 27a, then the kernel-backed
    ones in bf16 against their kernels' plain versions, each launching
    its kernel once: ``incubate.flash_attention`` at [8, 1024, 16, 128]
    causal, ``fused_layer_norm`` and ``fused_rms_norm`` at [8192, 2048],
    ``block_multihead_attention`` over 16 decode rows of a page-16 pool;
    (b) a decoder written as a Paddle LLM user writes it
    (:func:`rope_decoder`, ``gpt_1p3b(use_rms_norm=True)``'s widths and
    depth: ``fused_rms_norm``, ``fused_rotary_position_embedding``,
    ``incubate.flash_attention`` and a user ``PyLayer`` GELU), trained O2
    bf16 with ``AdamW`` masters at B 8 x S 1024, eager (2 steps) and
    staged by ``to_static`` (2 + 10): 1 graph, 0 breaks, launches exact
    (the flash trio 24, RMSNorm 49, AdamW 1 a replay), losses falling,
    the staged step-0 loss the eager one's, the peak memory through
    ``pt.device.max_memory_allocated`` equal to torch's, and one batch
    loaded on a side ``Stream`` under ``stream_guard`` giving a loss
    bit-equal to the default stream's; (c) the trained model decodes 16
    rows of 128-token prompts greedily, the prefill through the flash
    path and 63 steps through ``block_multihead_attention`` on the paged
    kernel (exact launches; every token the argmax of a no-cache forward
    within phase 15's tolerance; ms a decode step; the paged kernel at
    that shape beside its bound); (d) ``FusedMultiTransformer`` at the
    same widths (2 layers, [4, 512]) in bf16 on the card against an f32
    copy on the CPU, the tensor checker raising on an Inf on the card,
    the operator statistics, a step staged under the enabled checker
    capturing as 1 graph, ``FLAGS_use_flash_attention=False`` refused on
    a CUDA tensor, ``utils.run_check``, and ``jacobian`` / ``hessian`` /
    ``vjp`` / ``jvp`` of a small MLP equal on the card and the CPU.
29. **exported programs, the predictor, static mode and control flow** —
    (a) BERT-base classification O2 bf16 exported by ``jit.save`` with
    ``InputSpec([None, 128], "int64")``: the loaded program holds 12
    ``paddle_tpu_torch::flash_fwd`` and 25 ``::layer_norm`` ops and no
    plain attention or norm, and at batches 1, 8 and 32 each call (the
    shape's warm-up, capture and a replay) launches 12 flash forwards and
    25 LayerNorms and gives the eager logits within bf16 rounding;
    ``gpt_1p3b(use_rms_norm=True)`` bf16 at [1, 1024] exported (its 2.6 GB
    ``.pdiparams`` in a temporary directory) holds 24 ``flash_fwd`` and 49
    ``rms_norm`` ops and matches eager; ``bert_tiny`` exported on the CPU
    launches kernels 1 and 8 on the card; the host cost of a kernel op
    over its bare wrapper; (b) ``create_predictor(Config(path))`` on the
    BERT-base export (handle flow, direct run), then ``BatchingPredictor``
    (buckets 1-32, ``max_wait_ms=2``, each bucket captured before the
    load): 512 single-example requests of 128 tokens from 32 threads,
    every row the eager model's, 12 + 25 launches a batch, requests/s,
    latency p50 / p99 and the ms of a replay per bucket; (c) the
    fit-a-line static script of ``tests/test_static_program.py:19``
    unmodified, then a BERT-base-width ``TransformerEncoder`` (12 layers,
    bf16) recorded on ``static.data([None, 128, 768])``: ``Executor.run``
    launches 12 flash forwards and 24 LayerNorms and equals the eager
    layers, and ``save_inference_model`` -> ``load_inference_model`` and
    a ``Predictor`` give its output; (d) ``cond``, ``while_loop(max_steps)``,
    ``scan_loop``, ``case`` and ``switch_case`` eager and staged on the
    card against the CPU (an unbounded ``while_loop`` breaks the graph
    and runs eagerly), then phase 22c's ``gpt_1p3b`` O2 step with a
    z-loss behind a Python ``if z_weight > 0:`` that dy2static converts,
    for ``z_weight`` 1e-4 and 0: 1 graph, 0 breaks, launches exact a
    replay, the staged step-0 loss the eager one's, ms a step beside
    phase 22c's.
30. **resilient training** — BERT-base classification (BERT-base's
    hidden dropout 0.1, attention-probability dropout 0) fine-tuned by
    ``Model.fit`` at B 32 x S 128, O1 bf16, staged, 48 steps with
    ``lineage``, ``snapshot_interval=16``, ``async_snapshot=True`` and
    ``integrity=True``, as jobs of the port's launcher
    (``python -m paddle_tpu_torch.distributed.launch --nproc_per_node 1
    chip_smoke.py --resilience-worker``): (a) uninterrupted, alone on the
    card: every step's loss, a CRC32 digest of the parameters, launches
    exact over the replayed steps, the fit step's ms beside 24b's, the
    snapshot's bytes, the training thread's stall a snapshot (sync and
    async) and the write rate; then three jobs at once: (b) SIGTERM in
    step 23 -> a sync save, ``PREEMPT_SAVED 24``, exit 75, relaunched
    with ``--max_restarts 0`` ("does not consume max_restarts"),
    ``RESUMED`` at 24; (c) ``crash@step:40,torn_write@ckpt:3`` with sync
    snapshots and ``--max_restarts 1``: rc 43, a restart, the torn step-32
    snapshot skipped by its CRC, resumed at 16; (e) ``hang@step:30`` under
    ``--watchdog_timeout 30`` (a capture of the step beside two other jobs
    outlasted 10 s): the watchdog's flight-recorder dump and
    exit 19, the launcher's post-mortem naming rank 0 and its last step,
    a restart and a resume at 16. Every loss and the digest of (b), (c)
    and (e) bit-equal to (a)'s; each resume's seconds from the relaunch
    to its first step and the steps lost. (d) Meanwhile in this process:
    ``loss_spike@batch:21`` (the batch's labels leave the classes: a NaN
    loss) under ``integrity={"rewind_after": 1}``: the guard rewinds to
    the step-16 snapshot and skips step 20; the digest and every loss
    equal a clean run over the same data without that batch.
31. **elastic training and resumable distributed linear algebra** —
    jobs of the port's launcher under ``--np 2:3 --max_restarts 0``
    (``chip_smoke.py --dlinalg-worker`` / ``--elastic-worker``), rank 2
    SIGKILLing itself mid-run in the first incarnation; 31a, then 31b,
    each alone on the card. (a) ``dlinalg``
    on the device backend (torch f64): ``summa_matmul`` at world 3
    (threads on one ``LocalExchange``, as ``bench.py``'s linalg leg) of
    a 4096 x 4096 by 4096 x 16 product, block 256, relative residual
    under 1e-12 against ``matmul_reference``, GFLOP/s; then the
    resumable eigensolve (N 4096, block 256: 16 panels a sweep, p 16,
    seed 5, tol 1e-9; every rank builds A by a host QR of a 4096 x 4096
    Gaussian in every incarnation, which sets its size; two BLAS
    threads a rank), killed in
    sweep 1: a scale event and a relaunch at world 2, both survivors
    resumed at the last committed (sweep, panel) with no panel
    recomputed, ``DONE`` residual and ``THETA_ERR`` (against the
    spectrum the construction fixes) under 1e-6; the recovery time
    (``SELF_SIGKILL`` to the first resumed ``PANEL``) and a sweep's
    time. (b) phase 30's BERT-base classifier through ``Model.fit``
    wrapped in ``DataParallel`` over gloo (each rank's shard of 512
    sequences, B 32 x S 128 a rank, O1, sync snapshots every 4 steps
    through a ``CheckpointLineage`` and its store commit barrier), rank
    2 killed after its 5th step: a scale event, a relaunch at world 2,
    both survivors resumed at exactly global step 4 (the last committed
    snapshot) and ran each remaining batch once, one graph break each
    (the gloo sync runs eagerly, never in a graph), the first synced
    step's averaged gradients in each incarnation held against the plain
    mean of every rank's own (gathered over gloo as CPU tensors: the
    small leaves element by element, every leaf by its sum and a seeded
    projection, within 2^-20 of the ranks' summed magnitudes), bit-equal
    parameter digests, the flash trio's, LayerNorm's and AdamW's launches exact
    for the steps each incarnation ran; the step time at world 3 and 2,
    the all-reduce's share of a step and the recovery time.
32. **the serving fleet** — (a) in this process: ``gpt_1p3b`` bf16 (24
    layers) on engines e0 and e1 at phase 16's settings, each with a
    ``PageShareClient`` on a ``TCPStore`` of this host, behind a
    ``FleetRouter``: (1) a 128-token head prefilled on e0 and published
    (8 pages), then imported by e1's admission, each page bit-equal to
    e0's and e1's greedy tokens equal to e0's on the same prompt; (2) a
    session piled on e0 spills to e1, whose prefetch (the router's own
    thread) imports the head before the request is admitted; (3) a
    hedge on a stalled e0 wins on e1, the loser aborted (its pages at
    refcount 0, its ``on_done`` never fired); (4) 8 sessions x 6
    requests (head 128, tails 16-256, 32 new) at 16 req/s through
    ``run_poisson_load`` on the router, every token the argmax of a
    no-cache forward within phase 15's tolerance, TTFT split by
    remote-hit, local-hit and cold admission; (5) ``engine_die@
    serve_loop`` aimed at e1 mid-load, its requests re-dispatched to e0
    (their tokens, and the hedge's, equal to e0 alone or a near-tie
    within that tolerance at the first divergence); (6) an
    ``EngineAutoscaler`` strikes e1, scales a warm third engine (512
    pages) up under a burst and down when idle, both scale events
    counted. Launches exact over every round of every engine (24
    attention, 49 LayerNorm); publish, fetch and import ms a page and
    MB/s through the store. (b) two engine processes
    (``chip_smoke.py --fleet-engine-worker``: the remote module's
    ``main`` at ``gpt_1p3b`` widths, 24 layers, bf16, 512 pages, page
    share), a primary and a shadow ``frontdoor`` process; 24 requests by
    client id (the primary's go to e0, the rest to e1, which imports
    e0's heads); the primary SIGKILLs itself at its 13th dispatch
    (``router_die@route``), the shadow adopts (``adopt_s``), every
    request finishes once (one leg each, streams without a duplicate),
    its tokens equal to an in-process engine of the same configuration
    and seed or a near-tie; a resubmitted terminal id is answered from
    the ledger with no engine's submissions or decode tokens moving;
    each engine process's launches exact for its rounds.
33. **tensor-parallel serving** — ``gpt_1p3b`` bf16 (24 layers, 16
    heads) at mp 2: the mp 1 ragged and bucketed engines in this process
    serve 12 requests (32-200 prompt tokens from the seed, 32 new, greedy,
    submitted at once, ``step()`` until idle) as the reference; then a
    launcher job (``--nproc_per_node 2``, both ranks on the one card,
    gloo; ``chip_smoke.py --tp-worker``) in which each rank: (a) runs
    ``all_reduce`` (f32 and bf16), ``broadcast``, ``all_gather``,
    ``reduce_scatter`` and ``all_to_all`` on CUDA tensors over the
    model-parallel group, each equal to a host computation of every
    rank's inputs (bf16 within one rounding); (b) calls the three serving
    wrappers and ``sharded_flash_attention`` with whole 16-head tensors:
    the stitched output against the unsharded kernel on all 16 heads
    (ragged 4e-3, paged 2e-2, flash phase 6's limits), each rank's
    launch recorded at 8 heads, the local call on the rank's contiguous
    slice, and a strided head slice of the pools refused by the local
    call and by the kernel; (c) derives ``gpt_1p3b`` from the seed on the
    card, keeps its shard (``params_from_paddle_tpu``), and serves the
    same 12 requests on the ragged engine at mp 2 (``mesh=``, every round
    eager: no graph); (d) the same on the bucketed engine. Launches are
    counted on each rank and must be exact: 24 ragged attention and 49
    LayerNorm a round, 24 flash forward a dense prefill, 24 paged decode
    a decode step, every attention launch at 8 heads. The two ranks'
    tokens are equal, and each request's equals the mp 1 engine's or, at
    the first divergence, both argmaxes lie within phase 15's tolerance
    of a no-cache forward. Prints, beside the card's name and power
    limit, the steady decode round's ms at mp 2 against mp 1, the share
    of the mp 2 rounds in collectives (each timed after a card sync),
    tokens/s and the launches per rank.

The lines before the last carry the ``{"kernels": [...]}`` JSON (all eight
kernels; the ``fused_adamw`` entry adds the master and bf16-moment modes'
numbers and phase 13's launches, and its ``max_abs_err`` is the largest of
its modes'; the ``flash_fwd`` entry adds phase 15's ``sq1_*``
numbers and the dense-cache loop's launches, ``layer_norm`` the compiled
loop's; the entries of the kernels phase 16 runs add its launches as
``ops_launches``, and the ragged entry the gate's plain and kernel ms;
phases 17-21 add the flash entries' ``d64_*`` numbers, ``layer_norm``'s
``h768_*``, ``fused_adamw``'s ``f16_master_max_abs_err``, and each of
these kernels' launches in phase 20b and 21 as ``bert_launches`` and
``seq2seq_launches``; phase 22 adds the flash entries' ``f16_*`` numbers,
``fused_adamw``'s ``bert_*`` (its master mode over BERT-base's tensors),
and to every entry ``to_static_launches``, the kernel's launches over the
replayed timed steps of 22a-22d, with ``to_static_parts`` by part;
phase 23 adds ``lamb_launches``, each kernel's launches over 23c's
replayed steps, and to ``fused_adamw`` the ``bert_lamb_*`` step times;
phase 24 adds to every entry ``hapi_launches`` (its launches over 24a's
three fits and 24b's fit and evaluate) and to the flash entries,
``layer_norm`` and ``fused_adamw`` the ``s128_*`` numbers at 24b's
shapes; phase 25 adds to every entry ``surface_launches``, its launches
over 25b's one surface forward and backward; phase 26 adds to every
entry ``layer_launches``, its launches over 26a's 20 replayed steps;
phase 27 adds to every entry ``nn_launches``, its launches over 27b's
10 replayed Conformer steps, and the flash entries' ``t255_*`` and
``layer_norm``'s / ``fused_adamw``'s ``conformer_*`` numbers at 27b's
shapes; phase 28 adds to every entry ``incubate_launches``, its launches
over 28b's 10 replayed steps and 28c's prefill and decode steps, and to
``paged_attention`` the ``incubate_*`` numbers at 28c's decode shape;
phase 29 adds to every entry ``export_launches``, its launches through
the exported programs of 29a-29c (loaded programs, the predictor, the
saved static program); phase 30 adds to every entry
``resilience_launches``, its launches over 30a-30e's workers and 30d's
two fits; phase 31 adds to every entry ``elastic_launches``, its
launches over 31b's workers; phase 32 adds to every entry
``fleet_launches``, its launches over phase 32, and apart
``fleet_launches_in_process`` (32a) and ``fleet_launches_processes``
(32b's engine processes); phase 33 adds to every entry ``tp_launches``,
its launches over both ranks' engines and 33b's wrappers, and to the
attention entries ``tp_max_abs_err``; every ``max_abs_err`` is
the largest of its entry's errors) and the
``nvidia-smi`` line; the last line is ``{"ok": true, "device": {...}}``.
Without CUDA, or without the repository beside it, the script exits
non-zero and prints no result.
"""
import ctypes
import gc
import importlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings
import zlib

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12        # dense bf16 tensor-core peak
F32_FLOPS_PER_S = 67e12          # f32 outside the tensor cores
SEED = 0
NUMBERS = {}   # numbers a later phase prints beside its own


def log(*a):
    print(*a, flush=True)


_START = time.perf_counter()


def clock(what):
    """Log the seconds since the script started as ``what`` begins (each
    phase's share of the run)."""
    log(f"[clock] {time.perf_counter() - _START:.1f} s: {what}")


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _device_events(prof):
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.events() if e.device_type == cuda]


def queued_ms(fn, iters, host_ms):
    """Device ms per call with the host's launch overhead hidden: a sleep
    kernel holds the stream for ten times ``host_ms`` (the host's time to
    issue the ``iters`` calls), and 20 ms at least, while the host queues
    them, so CUDA events around the calls time the card alone, the gaps
    between its launches included. None when the card reached the calls
    before the host had queued them all (``fn`` waits on the card, or the
    sleep was short): then the events would count host time."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(max(10 * host_ms, 20) * 2e6))  # ~2e6 cycles a ms
    a.record()
    for _ in range(iters):
        fn()
    queued = not a.query()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters if queued else None


def time_ms(fn, iters=10, warmup=3):
    """-> ``(ms, wall_ms, source)`` per call. ``ms`` is device time: the
    summed duration of every GPU kernel and copy the ``iters`` calls
    launched, from a ``torch.profiler`` trace, over ``iters``. A trace can
    lose device events late in a long process (it read a kernel at a third
    of its byte bound's time, and a multi-tensor AdamW under its bound):
    when the trace's sum falls short of :func:`queued_ms`'s time of the
    same calls by more than a tenth of that time plus 4 us a traced
    kernel (the gaps between queued launches: 2.4-3.2 us a launch on an
    H100 80GB HBM3 where the trace was whole), ``ms`` is the queued time
    instead (``source`` says which); a function that waits on the card
    keeps the trace's sum. ``wall_ms`` is CUDA-event time around
    the loop over ``iters``: it also counts the host's launch overhead
    whenever the host is slower than the card."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    b.record()
    b.synchronize()
    wall_ms = a.elapsed_time(b) / iters
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = _device_events(prof)
    dev_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3 / iters
    queued = queued_ms(fn, iters, host_ms)
    if queued is not None and \
            dev_ms < 0.9 * queued - 4e-3 * len(events) / iters:
        return queued, wall_ms, "cuda events (queued; the trace lost " \
            f"device events: {dev_ms:.4f} ms)"
    return dev_ms, wall_ms, "profiler"


def check_close(name, got, want, rtol, atol, norm_tol=None):
    """Elementwise ``|got - want| <= atol + rtol |want|``; with
    ``norm_tol`` also ``||got - want|| / ||want|| <= norm_tol``, which
    catches a fault that moves every output by a few percent where an
    elementwise bound wide enough for bf16's worst element would not.
    ``||want||`` is floored at ``atol * sqrt(n)``: an output whose every
    element lies below ``atol`` (dK at S = 1, where dS is rounding noise
    around 0) is held by the elementwise bound. -> the max abs error."""
    err = (got.float() - want.float()).abs()
    max_abs = float(err.max()) if err.numel() else 0.0
    ok = bool(torch.all(err <= atol + rtol * want.float().abs()))
    finite = bool(torch.isfinite(got.float()).all())
    norm = ""
    if norm_tol is not None:
        floor = atol * math.sqrt(max(err.numel(), 1))
        rel = float(err.norm() / want.float().norm().clamp_min(floor))
        ok = ok and rel <= norm_tol
        norm = f" rel_norm_err={rel:.3e} (tolerance {norm_tol:g})"
    log(f"  {name}: max_abs_err={max_abs:.3e} (tolerance atol={atol:g} "
        f"rtol={rtol:g}){norm} finite={finite} {'ok' if ok else 'MISMATCH'}")
    if not (ok and finite):
        fail(f"{name} disagrees with its plain version")
    return max_abs


# ------------------------------------------------------------ phase 2 data
def mixed_launch(H, KVH, D, dtype, page=16, num_pages=96, max_pages=64,
                 seed=0):
    """Two decode rows (contexts 300 and 17), a whole 40-token prefill, a
    chunk continuation at positions 37..65 (mid-page start, crosses
    pages), an unused row and 57 pad tokens: T = 128."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    T = 128
    q = torch.randn(T, H, D, device="cuda", generator=g).to(dtype)
    k = torch.randn(num_pages, page, KVH, D, device="cuda",
                    generator=g).to(dtype)
    v = torch.randn(num_pages, page, KVH, D, device="cuda",
                    generator=g).to(dtype)
    perm = torch.randperm(num_pages - 1, device="cuda", generator=g) + 1
    bt = torch.zeros(5, max_pages, dtype=torch.int32, device="cuda")
    bt[0, :19] = perm[:19]
    bt[1, :2] = perm[19:21]
    bt[2, :3] = perm[21:24]
    bt[3, :5] = perm[24:29]
    rs = torch.tensor([0, 1, 2, 42, T], dtype=torch.int32, device="cuda")
    rl = torch.tensor([1, 1, 40, 29, 0], dtype=torch.int32, device="cuda")
    kl = torch.tensor([300, 17, 40, 66, 0], dtype=torch.int32,
                      device="cuda")
    return q, k, v, rs, rl, kl, bt


def dense_reference_logits(model, ids):
    """Plain causal forward of the port's GPT over ``ids`` (a list of S
    tokens, or a [B, S] tensor; no cache, no kernels, differentiable in
    the model's parameters; LayerNorm or RMSNorm as the config says): ->
    f32 logits [S, V] or [B, S, V]."""
    from paddle_tpu_torch.ops.kernels import (layer_norm_reference,
                                              rms_norm_reference)
    cfg, g = model.config, model.gpt

    def ln(x, w, b, eps):
        if cfg.use_rms_norm:
            return rms_norm_reference(x, w, None, eps)
        return layer_norm_reference(x, w, b, eps)

    H, KVH = cfg.num_heads, cfg.num_kv_heads
    D = cfg.hidden_size // H
    eps = cfg.layer_norm_epsilon
    dev = model.device
    idx = torch.as_tensor(ids, device=dev)
    one_row = idx.dim() == 1
    idx = idx[None] if one_row else idx
    B, S = idx.shape
    x = g.wte.weight[idx] + g.wpe.weight[torch.arange(S, device=dev)]
    causal = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    for blk in g.h:
        a = blk.attn
        h = ln(x, blk.ln_1.weight, getattr(blk.ln_1, "bias", None), eps)
        qkv = h @ a.qkv_proj.weight + a.qkv_proj.bias
        q = qkv[..., :H * D].reshape(B, S, H, D)
        k = qkv[..., H * D:(H + KVH) * D].reshape(B, S, KVH, D)
        v = qkv[..., (H + KVH) * D:].reshape(B, S, KVH, D)
        k = k.repeat_interleave(H // KVH, dim=2)
        v = v.repeat_interleave(H // KVH, dim=2)
        s = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(D)
        p = torch.softmax(s.masked_fill(~causal, -1e30), dim=-1)
        o = torch.einsum("bhst,bthd->bshd", p, v).reshape(B, S, H * D)
        x = x + o @ a.out_proj.weight + a.out_proj.bias
        h = ln(x, blk.ln_2.weight, getattr(blk.ln_2, "bias", None), eps)
        f = torch.nn.functional.gelu(h @ blk.mlp.fc1.weight
                                     + blk.mlp.fc1.bias, approximate="tanh")
        x = x + f @ blk.mlp.fc2.weight + blk.mlp.fc2.bias
    x = ln(x, g.ln_f.weight, getattr(g.ln_f, "bias", None), eps)
    logits = (x @ g.wte.weight.t()).float()
    return logits[0] if one_row else logits


# ---------------------------------------------------------------- bounds
def attention_work(rs, rl, kl, bt, H, KVH, D, page, itemsize, row_meta=3):
    """Bytes the launch must move (q read, out written, the K and V of
    every key some row's context covers read once, ``row_meta`` int32 a
    row and the table entries the contexts cover) and the flops its data
    needs (QK and PV over each valid token's causal context)."""
    rs, rl, kl, bt = (np.asarray(a) for a in (rs, rl, kl, bt))
    T_valid = int(rl.sum())
    keys, entries, flops = {}, 0, 0   # page id -> keys of it read
    for r in range(len(rs)):
        if rl[r] <= 0:
            continue
        kv = int(kl[r])
        n = -(-kv // page)
        for i, p in enumerate(bt[r, :n].tolist()):
            keys[p] = max(keys.get(p, 0), min(page, kv - i * page))
        entries += n
        ctx = np.arange(kl[r] - rl[r], kl[r]) + 1
        flops += 4 * H * D * int(ctx.sum())
    kv_bytes = 2 * sum(keys.values()) * KVH * D * itemsize
    nbytes = 2 * T_valid * H * D * itemsize + kv_bytes \
        + 4 * (row_meta * len(rs) + entries)
    return nbytes, flops, T_valid


def bound(nbytes, flops, flops_per_s):
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def kernel_family(name):
    """The family a device event's name belongs to in the profiles."""
    name = name.lower()
    return ("ragged_paged_attention" if "ragged_paged" in name else
            "paged_attention" if "paged_attention" in name else
            "layer_norm (triton)" if "layer_norm_fwd" in name else
            "rms_norm (triton)" if "rms_norm_fwd" in name else
            "matmul (cuBLAS)" if any(k in name for k in (
                "gemm", "gemv", "nvjet", "cutlass", "xmma")) else
            "copies" if "memcpy" in name or "memset" in name else
            "other elementwise/index")


def host_functions(eng, n_rounds, top=8):
    """``n_rounds`` more steps under ``cProfile`` -> the host functions
    with the most own time: ``(ms per round, calls per round, name)``
    (``cProfile`` slows Python, so read shares, not times)."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(n_rounds):
        eng.step()
    torch.cuda.synchronize()
    prof.disable()
    rows = sorted(pstats.Stats(prof).stats.items(),
                  key=lambda kv: -kv[1][2])[:top]
    return [(tt * 1e3 / n_rounds, nc / n_rounds,
             f"{func} ({os.path.basename(path)}:{line})")
            for (path, line, func), (_, nc, tt, _, _) in rows]


def profile_decode_rounds(eng, vocab, n_rounds=20):
    """Where a steady decode round's time goes (either engine path, eager
    or replayed as ``eng``'s ``jit`` says): 16 requests with 200-token
    prompts are prefilled (no logit capture, as served), then
    ``n_rounds`` rounds in which every slot
    decodes are timed on the host clock (no profiler), again under
    ``torch.profiler``, and again under ``cProfile``. -> per-round host
    ms, device busy ms (union of the device intervals), device time by
    kernel family, the top kernels and copies, the host ms split into the
    program call and the wait on the fetch (the engine's
    ``round_host_s``) and the rest, and the top host functions."""
    from torch.profiler import ProfilerActivity, profile
    # as served: no test capture of every round's f32 logit rows (the
    # serve phases' checks turn it on), so each round fetches its tokens
    eng.capture_logits = None
    rng = np.random.RandomState(SEED + 10)
    reqs = [eng.submit(rng.randint(1, vocab, size=200).tolist(),
                       max_new_tokens=96) for _ in range(eng.max_slots)]
    while any(r.state != "active" or not r.generated for r in reqs):
        eng.step()
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    host0 = dict(eng.stats()["round_host_s"])
    t0 = time.perf_counter()
    for _ in range(n_rounds):
        eng.step()
    torch.cuda.synchronize()
    round_ms = (time.perf_counter() - t0) * 1e3 / n_rounds
    host1 = eng.stats()["round_host_s"]
    split = {k: (host1[k] - host0[k]) * 1e3 / n_rounds for k in host0}
    split["scheduler and assembly"] = round_ms - split["call"] \
        - split["wait"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_rounds):
            eng.step()
        torch.cuda.synchronize()
    families, names, spans = {}, {}, []
    for e in _device_events(prof):
        spans.append((e.time_range.start, e.time_range.end))
        fam = kernel_family(e.name)
        ms = e.time_range.elapsed_us() / 1e3 / n_rounds
        families[fam] = families.get(fam, 0.0) + ms
        names[e.name] = names.get(e.name, 0.0) + ms
    host = host_functions(eng, n_rounds)
    eng.run_until_idle()
    # busy = the union of device intervals: a synchronous copy's interval
    # can span the kernels it waits behind, so the sum double-counts
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    top = sorted(names.items(), key=lambda kv: -kv[1])[:8]
    top += sorted((kv for kv in names.items() if kv not in top
                   and kernel_family(kv[0]) == "copies"),
                  key=lambda kv: -kv[1])
    return round_ms, busy_us / 1e3 / n_rounds, families, top, split, host


def report_round_profiles(tag, eng, vocab, families_needed, absent=(),
                          unit="round"):
    """Phase 5 / 11: :func:`profile_decode_rounds` for eager rounds, then
    replays, on ``eng``; fails if
    a trace holds no device events, lacks any of ``families_needed`` (for
    a replay: the trace cannot see the kernels inside the graph) or holds
    one of ``absent``."""
    for jit in (False, True):
        eng._jit = jit
        round_ms, busy_ms, families, top, split, host = \
            profile_decode_rounds(eng, vocab)
        mode = "replay (jit=True)" if jit else "eager (jit=False)"
        if busy_ms <= 0:
            fail(f"{tag}: the torch.profiler trace of the {mode} {unit}s "
                 f"held no device events")
        missing = [f for f in families_needed if families.get(f, 0) <= 0]
        if missing:
            fail(f"{tag}: " + ("the trace cannot see the kernels inside a "
                               "replay" if jit else "the eager trace lacks "
                               "the kernels") +
                 f": no {missing} among {sorted(families)}")
        if any(f in families for f in absent):
            fail(f"{tag}: {absent} in the trace ({sorted(families)}): a "
                 f"kernel's symbol is not in its own family")
        total_ms = sum(families.values())
        log(f"[{tag}] steady decode {unit}, 16 rows, {mode}: {round_ms:.3f} "
            f"ms on the host clock (scheduler and assembly "
            f"{split['scheduler and assembly']:.3f}, program call "
            f"{split['call']:.3f}, fetch wait {split['wait']:.3f}); device "
            f"busy {busy_ms:.3f} ms per {unit} (union of device intervals; "
            f"{total_ms:.3f} ms summed) = {100 * busy_ms / round_ms:.1f}% "
            f"busy, {100 - 100 * busy_ms / round_ms:.1f}% idle")
        for fam, ms in sorted(families.items(), key=lambda kv: -kv[1]):
            log(f"  {fam}: {ms:.4f} ms per {unit} "
                f"({100 * ms / total_ms:.1f}% of summed device time)")
        for name, ms in top:
            log(f"    {ms:.4f} ms per {unit}  {name[:110]}")
        log(f"  host functions by own time under cProfile, per {unit}:")
        for ms, calls, name in host:
            log(f"    {ms:.3f} ms ({calls:g} calls)  {name[:110]}")
    eng._jit = True


def reserved_bytes():
    """Device memory the caching allocator holds once its free cached
    blocks are released (graph pools stay reserved while their graphs
    live)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_stats()["reserved_bytes.all.current"]


def check_replay_matches_eager(tag, label, run, args):
    """One recorded round run again on its engine, replayed (``jit=True``)
    and eager (``jit=False``) on the same inputs: greedy tokens equal and
    logits bit-equal (the same kernels at the same shapes; the round's
    K/V writes are the same values, so the pools do not diverge)."""
    tok_r, rows_r = run(*args, need_rows=True, jit=True)
    tok_e, rows_e = run(*args, need_rows=True, jit=False)
    diff = float(np.abs(rows_r - rows_e).max())
    log(f"  {label} replayed vs eager: tokens "
        f"{'equal' if tok_r == tok_e else 'DIFFER'}, logits {rows_r.shape} "
        f"largest absolute difference {diff}")
    if tok_r != tok_e or diff != 0.0:
        fail(f"{tag}: the replayed {label} differs from the eager round "
             f"(tokens equal: {tok_r == tok_e}, logits by {diff})")


# ------------------------------------------------------------ train phases
def _bhsd(x):
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d)


def _bshd(x, b, h):
    return x.reshape(b, h, -1, x.shape[-1]).transpose(1, 2)


def flash_inputs(B, S, H, D, dtype, seed):
    """q, k, v as views of one fused [B, S, 3*H*D] projection (the GPT's
    layout: strided, no copy), and dO."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(B, S, 3 * H * D, device="cuda", generator=g).to(dtype)
    q, k, v = (qkv[..., i * H * D:(i + 1) * H * D].reshape(B, S, H, D)
               for i in range(3))
    do = torch.randn(B, S, H, D, device="cuda", generator=g).to(dtype)
    return qkv, q, k, v, do


def flash_plain(q, k, v, do, scale, causal):
    """The three plain versions chained as the autograd Function chains the
    kernels: -> O, lse, delta, dQ, dK, dV (in [B, S, H, D] / [B, H, S])."""
    from paddle_tpu_torch.ops import kernels as K
    B, S, H, _ = q.shape
    ro, rl = K.flash_fwd_reference(_bhsd(q), _bhsd(k), _bhsd(v), scale,
                                   causal)
    ro = _bshd(ro, B, H)
    delta = K.flash_delta(ro, do)
    rl = rl.reshape(B, H, S)
    args = [_bhsd(x) for x in (q, k, v, do)] + [
        rl.reshape(B * H, S), delta.reshape(B * H, S), scale, causal]
    rq = _bshd(K.flash_bwd_dq_reference(*args), B, H)
    rk, rv = (_bshd(x, B, H) for x in K.flash_bwd_dkv_reference(*args))
    return ro, rl, delta, rq, rk, rv


# bf16 flash limits: elementwise 2e-2 (the causal rows with few keys
# carry |O| near 1, where a bf16 ulp is 8e-3), and the error's norm within
# 1e-2 of the plain output's
FLASH_BF16_TOL, FLASH_BF16_NORM_TOL = 2e-2, 1e-2


def check_flash(K, tag, q, k, v, do, scale, causal, tol, norm_tol):
    """The flash forward, dQ and dK/dV kernels against their plain
    versions on the same inputs (the backward kernels take the plain
    chain's lse and delta). -> max abs errors {kernel: err}."""
    ro, rl, delta, rq, rk, rv = flash_plain(q, k, v, do, scale, causal)
    o, lse = K.flash_fwd(q, k, v, scale, causal)
    dq = K.flash_bwd_dq(q, k, v, do, rl, delta, scale, causal)
    dk, dv = K.flash_bwd_dkv(q, k, v, do, rl, delta, scale, causal)
    torch.cuda.synchronize()
    errs = {"flash_fwd": check_close(f"flash_fwd O {tag}", o, ro, tol, tol,
                                     norm_tol)}
    check_close(f"flash_fwd lse {tag}", lse, rl, 1e-4, 1e-4)
    errs["flash_bwd_dq"] = check_close(f"flash_bwd_dq {tag}", dq, rq, tol,
                                       tol, norm_tol)
    errs["flash_bwd_dkv"] = max(
        check_close(f"flash_bwd_dkv dK {tag}", dk, rk, tol, tol, norm_tol),
        check_close(f"flash_bwd_dkv dV {tag}", dv, rv, tol, tol, norm_tol))
    return errs


def train_kernel_parity(K):
    """Flash forward, dQ and dK/dV against their plain versions at
    [2, S, 16, 128], S in (1024, 1000), and in bf16 also 1 and 129 (one
    row; one past the new kernels' 128-row tiles), causal and not, f32 and
    bf16; the
    autograd gradients of ``flash_attention_bshd`` against autograd
    through the plain chain; fused AdamW multi-tensor against its plain
    version over mixed sizes."""
    for dt, tol, norm_tol in ((torch.float32, 1e-4, None),
                              (torch.bfloat16, FLASH_BF16_TOL,
                               FLASH_BF16_NORM_TOL)):
        for S in (1024, 1000) + ((1, 129) if dt == torch.bfloat16 else ()):
            for causal in (True, False):
                _, q, k, v, do = flash_inputs(2, S, 16, 128, dt, seed=S)
                tag = f"{str(dt)[6:]} S={S} {'causal' if causal else 'full'}"
                check_flash(K, tag, q, k, v, do, 1.0 / math.sqrt(128),
                            causal, tol, norm_tol)
    # the full autograd path (delta and both backward kernels) on the
    # strided views of one fused projection, f32
    qkv, q, k, v, do = flash_inputs(2, 1000, 16, 128, torch.float32, 7)
    qkv.requires_grad_(True)
    B, S, H, D = q.shape

    def split(t):
        return [t[..., i * H * D:(i + 1) * H * D].reshape(B, S, H, D)
                for i in range(3)]

    got = torch.autograd.grad((K.flash_attention_bshd(*split(qkv))
                               * do).sum(), qkv)[0]
    q, k, v = split(qkv)
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(D)
    causal = torch.ones(S, S, dtype=torch.bool, device="cuda").tril()
    o = torch.einsum("bhqk,bkhd->bqhd",
                     sc.masked_fill(~causal, -1e30).softmax(-1), v)
    want = torch.autograd.grad((o * do).sum(), qkv)[0]
    check_close("flash_attention_bshd autograd d[qkv] vs plain chain "
                "(f32, S=1000)", got, want, 1e-4, 1e-4)
    del qkv, q, k, v, do, got, want, sc, o
    # fused AdamW: one multi-tensor launch, mixed sizes and one bf16 w
    g = torch.Generator(device="cuda").manual_seed(8)
    shapes = [(2048, 6144), (6144,), (3,), (50304, 2048), (1000, 33)]
    ws = [torch.randn(sh, device="cuda", generator=g) for sh in shapes]
    ws.append(torch.randn(777, device="cuda", generator=g).bfloat16())
    gs = [torch.randn(w.shape, device="cuda", generator=g) for w in ws]
    ms = [0.1 * torch.randn(w.shape, device="cuda", generator=g)
          for w in ws]
    vs = [torch.rand(w.shape, device="cuda", generator=g) for w in ws]
    n = len(ws)
    wds = [0.1 * (i % 2) for i in range(n)]
    c1, c2 = 1.0 / (1 - 0.9 ** 3), 1.0 / (1 - 0.95 ** 3)
    want = [K.fused_adamw_reference(w, gr, m, v, 1e-3, 0.9, 0.95, 1e-8, wd,
                                    c1, c2)
            for w, gr, m, v, wd in zip(ws, gs, ms, vs, wds)]
    K.fused_adamw(ws, gs, ms, vs, [1e-3] * n, 0.9, 0.95, 1e-8, wds,
                  [c1] * n, [c2] * n)
    torch.cuda.synchronize()
    for (w2, m2, v2), w, m, v in zip(want, ws, ms, vs):
        # f32: IEEE sqrt and division, FMA contraction: within 1e-6;
        # bf16 w: one bf16 rounding of the updated value
        wtol = 1e-6 if w.dtype == torch.float32 else 8e-3
        tag = f"{tuple(w.shape)} {str(w.dtype)[6:]}"
        check_close(f"fused_adamw w {tag}", w, w2, wtol, wtol)
        check_close(f"fused_adamw m {tag}", m, m2, 1e-6, 1e-6)
        check_close(f"fused_adamw v {tag}", v, v2, 1e-6, 1e-6)


def train_parity(pt, K):
    """A 2-layer f32 model at gpt_1p3b widths takes one AdamW step (B 2,
    S 512) through the kernels; its loss and every gradient are held
    against autograd through :func:`dense_reference_logits` over the same
    parameters, then the step against the plain AdamW update."""
    cfg = pt.gpt_1p3b(dropout=0.0)
    cfg.num_layers = 2
    model = pt.GPTForCausalLM(cfg, dtype=torch.float32, seed=SEED + 2)
    model.train()
    rng = np.random.RandomState(SEED + 2)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 512))).cuda()
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                          (2, 512))).cuda()
    params = list(model.parameters())
    names = [p.param_name for p in params]
    want_loss = torch.nn.functional.cross_entropy(
        dense_reference_logits(model, ids).reshape(-1, cfg.vocab_size),
        labels.reshape(-1))
    want_grads = torch.autograd.grad(want_loss, params)
    opt = pt.AdamW(learning_rate=1e-4, parameters=params)
    K.reset_launch_counts()
    loss = pt.GPTPretrainingCriterion(cfg)(model(ids), labels)
    loss.backward()
    torch.cuda.synchronize()
    launched = K.launch_counts()
    if min(launched["flash_fwd"], launched["flash_bwd_dq"],
           launched["flash_bwd_dkv"], launched["layer_norm"]) <= 0:
        fail(f"train parity: the step did not run the kernels {launched}")
    check_close("loss vs dense plain forward", loss.detach(),
                want_loss.detach(), 1e-5, 1e-5)
    worst = 0.0
    for name, p, wg in zip(names, params, want_grads):
        scale = float(wg.abs().max())
        err = (p.grad - wg).abs()
        ok = bool((err <= 1e-4 * scale + 1e-3 * wg.abs()).all())
        worst = max(worst, float(err.max()) / max(scale, 1e-30))
        if not ok or not bool(torch.isfinite(p.grad).all()):
            fail(f"train parity: grad of {name} disagrees (max abs err "
                 f"{float(err.max()):.3e}, max |grad| {scale:.3e})")
    log(f"  {len(params)} gradients within 1e-4 x max|grad| + 1e-3 x |grad| "
        f"of the plain chain's; worst max-err/max|grad| {worst:.3e}")
    before = [(p.detach().clone(), p.grad.clone()) for p in params]
    opt.step()
    torch.cuda.synchronize()
    if K.fused_adamw.launches != 1:
        fail(f"train parity: AdamW launched {K.fused_adamw.launches} "
             f"kernels for one step")
    worst = 0.0
    for name, p, (w0, g0) in zip(names, params, before):
        zero = torch.zeros_like(w0)
        w2, _, _ = K.fused_adamw_reference(w0, g0, zero, zero, 1e-4, 0.9,
                                           0.999, 1e-8, 0.01, 1 / (1 - 0.9),
                                           1 / (1 - 0.999))
        err = float((p.detach() - w2).abs().max())
        worst = max(worst, err)
        if err > 1e-6:
            fail(f"train parity: AdamW step of {name} off by {err:.3e}")
    log(f"  AdamW step (one launch over {len(params)} tensors) vs the plain "
        f"update: max abs err {worst:.3e} (tolerance 1e-6)")


def train_flops(n_params, B, S, L, h):
    """Model FLOPs of one step, the formula of ``bench.py:435``."""
    return 6 * n_params * B * S + 6 * L * B * S * S * h


def train_slice(pt, K, steps=10, warmup=2, B=8, S=1024):
    """gpt_1p3b, f32 master weights, auto_cast O1 bf16, AdamW(1e-4) on a
    fixed batch from numpy seed 0. -> the model, the optimizer, the step
    function and the timed steps' launch counts; fails unless the losses
    are finite and fall and the kernels launched exactly as the step
    prescribes."""
    cfg = pt.gpt_1p3b(dropout=0.0)
    t0 = time.perf_counter()
    model = pt.GPTForCausalLM(cfg, dtype=torch.float32, seed=SEED)
    model.train()
    crit = pt.GPTPretrainingCriterion(cfg)
    opt = pt.AdamW(learning_rate=1e-4, parameters=model.parameters())
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.RandomState(SEED)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, S))).cuda()
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                          (B, S))).cuda()
    torch.cuda.synchronize()
    log(f"[train] gpt_1p3b f32 master weights, {n_params / 1e9:.4f} B "
        f"params, {len(list(model.parameters()))} tensors, built in "
        f"{time.perf_counter() - t0:.2f} s; B={B} S={S} "
        f"({B * S} tokens/step), auto_cast O1 bf16, AdamW(lr=1e-4)")

    def step():
        with pt.auto_cast(level="O1", dtype="bfloat16"):
            loss = crit(model(ids), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.item()

    losses, times = [], []
    for _ in range(warmup):
        losses.append(step())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log("  losses: " + " ".join(f"{x:.4f}" for x in losses)
        + f" (first {warmup} are warm-up)")
    log("  step ms: " + " ".join(f"{x:.2f}" for x in times))
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        fail(f"train: losses not finite or not falling: {losses}")
    L = cfg.num_layers
    # per step: one flash forward and one dQ and one dK/dV launch per
    # layer, one AdamW launch (the multi-tensor kernel over all tensors),
    # two LayerNorms per layer plus ln_f (forward kernels; the backward
    # is plain torch); no ragged attention
    want = {name: 0 for name in launches}
    want.update({"layer_norm": steps * (2 * L + 1), "flash_fwd": steps * L,
                 "flash_bwd_dq": steps * L, "flash_bwd_dkv": steps * L,
                 "fused_adamw": steps})
    log(f"  launches over {steps} timed steps: {launches}")
    if launches != want:
        fail(f"train: kernel launches {launches} != {want}")
    med = float(np.median(times))
    flops = train_flops(n_params, B, S, L, cfg.hidden_size)
    summary = {"step_ms_median": med, "tokens_per_s": B * S / med * 1e3,
               "gpt_train_step_mfu": flops / (med / 1e3) / BF16_FLOPS_PER_S,
               "model_tflop_per_step": flops / 1e12,
               "max_memory_allocated_gb": peak / 1e9,
               "first_loss": losses[0], "last_loss": losses[-1]}
    log(f"  {json.dumps(summary)}")
    return model, opt, step, launches


def _busy_ms(spans):
    """The union of device intervals (a synchronous copy's interval can
    span the kernels it waits behind, so the sum double-counts)."""
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return busy_us / 1e3


def profile_train_step(step):
    """One call of ``step`` (a training step, or phase 15's block of
    replays) under ``torch.profiler``: device time by kernel family, the
    union of device intervals and the call's host time. -> (host ms, busy
    ms, ms by family, the top kernels, device events)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    families, names, spans = {}, {}, []
    for e in _device_events(prof):
        spans.append((e.time_range.start, e.time_range.end))
        name = e.name.lower()
        fam = ("flash forward" if "flash_fwd" in name else
               "flash backward dQ" if "flash_bwd_dq" in name else
               "flash backward dK/dV" if "flash_bwd_dkv" in name else
               "fused_adamw" if "fused_adamw" in name else
               "layer_norm (triton)" if "layer_norm_fwd" in name else
               "depthwise convolution" if any(k in name for k in (
                   "depthwise", "grouped")) else
               "convolution (cuDNN)" if any(k in name for k in (
                   "conv", "fprop", "dgrad", "wgrad")) else
               "batch norm" if "batch_norm" in name or "bn_" in name else
               "matmul (cuBLAS)" if any(k in name for k in (
                   "gemm", "gemv", "nvjet", "cutlass", "xmma")) else
               "copies" if "memcpy" in name or "memset" in name else
               "other elementwise/reduction")
        ms = e.time_range.elapsed_us() / 1e3
        families[fam] = families.get(fam, 0.0) + ms
        names[(fam, e.name)] = names.get((fam, e.name), 0.0) + ms
    ranked = sorted(names.items(), key=lambda kv: -kv[1])
    # the ten largest kernels, and the six largest of the catch-all family
    top = ranked[:10] + [kv for kv in ranked[10:] if kv[0][0].startswith(
        "other")][:6]
    return wall_ms, _busy_ms(spans), families, top, len(spans)


# the bf16 kernels of csrc/flash_attention_sm90.cu: mangled-name part of
# their D = 128 instantiation, and their index for the shared-memory query
SM90_KERNELS = {
    "flash_fwd": ("flash_fwd_sm90_kernelILi128E13__nv_bfloat16E", 0),
    "flash_bwd_dkv": ("flash_bwd_dkv_sm90_kernelILi128E13__nv_bfloat16E", 1),
    "flash_bwd_dq": ("flash_bwd_dq_sm90_kernelILi128E13__nv_bfloat16E", 2)}


def ptxas_stats(lib, entry):
    """-> (registers, spill bytes stored and loaded) that ``ptxas -v``
    reported for the kernel whose mangled name holds ``entry``, from the
    build log ``build/<lib>.log``."""
    from paddle_tpu_torch.ops.kernels import _build
    with open(os.path.join(_build.BUILD_DIR, f"{lib}.log")) as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and entry in line:
            text = "\n".join(lines[i + 1:i + 6])
            regs = re.search(r"Used (\d+) registers", text)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                              r"spill loads", text)
            if regs and spill:
                return (int(regs[1]), int(spill[1]) + int(spill[2]))
    fail(f"ptxas statistics of {entry} not found in {lib}.log")


def train_timing(K, model, opt, launches):
    """Each new kernel at the slice's shapes: held against its plain
    version on the same inputs (the flash kernels at [8, 1024, 16, 128]
    bf16 causal on views of one fused projection, AdamW over the model's
    whole parameter list), then its device time per call beside its
    bound, its plain version's time and one PyTorch call's
    (``library_ms``, timed here only). -> the kernels' JSON entries, with
    these comparisons' errors as ``max_abs_err``."""
    from paddle_tpu_torch.ops.kernels import _build
    B, S, H, D = 8, 1024, 16, 128
    scale = 1.0 / math.sqrt(D)
    _, q, k, v, do = flash_inputs(B, S, H, D, torch.bfloat16, seed=9)
    errs = check_flash(K, f"bf16 [{B}, {S}, {H}, {D}] causal (main path)",
                       q, k, v, do, scale, True, FLASH_BF16_TOL,
                       FLASH_BF16_NORM_TOL)
    torch.cuda.empty_cache()
    o, lse = K.flash_fwd(q, k, v, scale, True)
    delta = K.flash_delta(o, do)
    plain = {}
    plain["flash_fwd"] = lambda: K.flash_fwd_reference(
        _bhsd(q), _bhsd(k), _bhsd(v), scale, True)
    bargs = lambda: [_bhsd(x) for x in (q, k, v, do)] + [  # noqa: E731
        lse.reshape(B * H, S), delta.reshape(B * H, S), scale, True]
    plain["flash_bwd_dq"] = lambda: K.flash_bwd_dq_reference(*bargs())
    plain["flash_bwd_dkv"] = lambda: K.flash_bwd_dkv_reference(*bargs())
    kern = {"flash_fwd": lambda: K.flash_fwd(q, k, v, scale, True),
            "flash_bwd_dq": lambda: K.flash_bwd_dq(q, k, v, do, lse, delta,
                                                   scale, True),
            "flash_bwd_dkv": lambda: K.flash_bwd_dkv(q, k, v, do, lse,
                                                     delta, scale, True)}
    # library: F.scaled_dot_product_attention forward, and its backward
    # for the two backward kernels together
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ot = sdpa(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    lib_fwd, _, _ = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True))
    lib_bwd, _, _ = time_ms(lambda: torch.autograd.grad(
        ot, (qt, kt, vt), dot, retain_graph=True))
    library = {"flash_fwd": lib_fwd, "flash_bwd_dq": lib_bwd,
               "flash_bwd_dkv": lib_bwd}
    el = 2                                             # bf16
    act = B * S * H * D * el                           # one [B,S,H,D] tensor
    rows = B * H * S * 4                               # lse or delta, f32
    causal_pairs = B * H * S * (S + 1) // 2            # (q, k) pairs kept
    work = {"flash_fwd": (4 * act + rows, 4 * causal_pairs * D),
            "flash_bwd_dq": (5 * act + 2 * rows, 6 * causal_pairs * D),
            "flash_bwd_dkv": (6 * act + 2 * rows, 8 * causal_pairs * D)}
    entries = []
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        ms, wall, src = time_ms(kern[name])
        plain_ms, _, _ = time_ms(plain[name], iters=3, warmup=1)
        nbytes, flops = work[name]
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
        log(f"[train timing] {name} [{B}, {S}, {H}, {D}] bf16 causal: "
            f"kernel {ms:.4f} ms ({src}; {wall:.4f} ms per call with "
            f"launch) plain {plain_ms:.4f} ms library {library[name]:.4f} "
            f"ms bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP) = {100 * b_ms / ms:.1f}% of bound")
        entry = {
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/ops/kernels/csrc/flash_attention.cu",
            "replaces": "paddle_tpu/ops/pallas/flash_attention.py:"
                        + {"flash_fwd": "106", "flash_bwd_dq": "262",
                           "flash_bwd_dkv": "285"}[name],
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library[name]}
        if name in SM90_KERNELS:
            # the bf16 kernels of the main path: their build's registers
            # and spills, and the shared memory a block launches with
            entry["source"] = ("paddle_tpu_torch/ops/kernels/csrc/"
                               "flash_attention_sm90.cu")
            regs, spill = ptxas_stats("flash_attention_sm90",
                                      SM90_KERNELS[name][0])
            smem = _build.load("flash_attention_sm90") \
                .flash_attention_sm90_smem_bytes(SM90_KERNELS[name][1], D)
            entry.update({"registers": regs, "spill_bytes": spill,
                          "smem_bytes": smem})
            log(f"  {name}: {regs} registers at launch (setmaxnreg 240 "
                f"consumer / 24 producer), {spill} spill bytes, {smem} "
                f"bytes of shared memory a block")
        entries.append(entry)
    del qt, kt, vt, ot, q, k, v, do, o, lse, delta
    # AdamW over the model's whole parameter list, as a step runs it
    params = list(model.parameters())
    n_t = len(params)
    gs = [torch.randn_like(p) * 1e-3 for p in params]
    ms_ = [opt._get_accumulator("moment1", p) for p in params]
    vs_ = [opt._get_accumulator("moment2", p) for p in params]
    c1, c2 = 1 / (1 - 0.9 ** 13), 1 / (1 - 0.999 ** 13)
    with torch.no_grad():
        ws = [p.detach() for p in params]
        # one launch over all the tensors against the plain update of
        # clones taken before it: f32 within 1e-6 (as in phase 6)
        before = [(w.clone(), m.clone(), v.clone())
                  for w, m, v in zip(ws, ms_, vs_)]
        K.fused_adamw(ws, gs, ms_, vs_, [1e-4] * n_t, 0.9, 0.999, 1e-8,
                      [0.01] * n_t, [c1] * n_t, [c2] * n_t)
        torch.cuda.synchronize()
        adam_err = {"w": 0.0, "m": 0.0, "v": 0.0}
        for i, ((w0, m0, v0), w, g, m, v) in enumerate(
                zip(before, ws, gs, ms_, vs_)):
            want = K.fused_adamw_reference(w0, g, m0, v0, 1e-4, 0.9, 0.999,
                                           1e-8, 0.01, c1, c2)
            for key, got, ref in zip("wmv", (w, m, v), want):
                err = (got - ref).abs()
                adam_err[key] = max(adam_err[key], float(err.max()))
                if not bool((err <= 1e-6 + 1e-6 * ref.abs()).all()):
                    fail(f"fused_adamw over the model's tensors: {key} of "
                         f"{params[i].param_name} off by "
                         f"{float(err.max()):.3e}")
        del before, want
        torch.cuda.empty_cache()
        log(f"  fused_adamw, one launch over {n_t} tensors "
            f"({sum(p.numel() for p in params) / 1e9:.4f} B params) vs the "
            f"plain update of clones: max abs err w {adam_err['w']:.3e} "
            f"m {adam_err['m']:.3e} v {adam_err['v']:.3e} (tolerance 1e-6 "
            f"+ 1e-6 x |plain|) ok")
        ms, wall, src = time_ms(lambda: K.fused_adamw(
            ws, gs, ms_, vs_, [1e-4] * n_t, 0.9, 0.999, 1e-8, [0.01] * n_t,
            [c1] * n_t, [c2] * n_t), iters=10)
        plain_ms, _, _ = time_ms(lambda: [K.fused_adamw_reference(
            w, g, m, v, 1e-4, 0.9, 0.999, 1e-8, 0.01, c1, c2)
            for w, g, m, v in zip(ws, gs, ms_, vs_)], iters=2, warmup=1)
        steps_t = [torch.tensor(13.0, device="cuda") for _ in params]
        lib_ms, _, _ = time_ms(lambda: torch._fused_adamw_(
            ws, gs, ms_, vs_, [], steps_t, lr=1e-4, beta1=0.9, beta2=0.999,
            weight_decay=0.01, eps=1e-8, amsgrad=False, maximize=False),
            iters=10)
    n = sum(p.numel() for p in params)
    nbytes = sum(w.numel() * (2 * w.element_size() + g.element_size() + 16)
                 for w, g in zip(ws, gs))
    b_ms, b_by = bound(nbytes, 12 * n, F32_FLOPS_PER_S)
    log(f"[train timing] fused_adamw over {len(params)} tensors, "
        f"{n / 1e9:.4f} B params: kernel {ms:.4f} ms ({src}; {wall:.4f} "
        f"ms per call with launch) plain {plain_ms:.4f} ms "
        f"torch._fused_adamw_ {lib_ms:.4f} ms bound {b_ms:.4f} ms "
        f"({b_by}: {nbytes / 1e9:.2f} GB) = {100 * b_ms / ms:.1f}% of bound")
    entries.append({
        "name": "fused_adamw", "route": "cuda",
        "source": "paddle_tpu_torch/ops/kernels/csrc/fused_adamw.cu",
        "replaces": "paddle_tpu/ops/pallas/fused_adamw.py:60",
        "launches": launches["fused_adamw"],
        "max_abs_err": max(adam_err.values()), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms})
    return entries


# --------------------------------------------------------- bucketed phases
def paged_split_edges(B, H, KVH, D, max_pages, page=16):
    """Contexts one key either side of the 16-key tile edges where a row's
    used splits change under the launch plan for B rows on this card (16 u
    - 1, 16 u, 16 u + 1 for u = n_split - 1, n_split, n_split + 1)."""
    import importlib
    pa = importlib.import_module(
        "paddle_tpu_torch.ops.kernels.paged_attention")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n = pa.launch_plan(B, H, KVH, D, max_pages, page, sms)["n_split"]
    return [c for u in (n - 1, n, n + 1) for c in (16 * u - 1, 16 * u,
                                                   16 * u + 1)
            if 0 <= c <= max_pages * page]


def paged_decode_inputs(H, KVH, D, dtype, page=16, num_pages=96,
                        max_pages=64, seed=0):
    """Fifteen decode rows: contexts 300 (crosses 19 pages), 32 (ends on a
    page edge), the full ``max_pages * page``, 0 (must come out exactly
    zero), 1 and 17, then contexts either side of the split edges of the
    launch plan for 15 rows (padded with 1023 where the plan gives
    fewer); every table padded with -1 past its context."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    ctx = [300, 32, max_pages * page, 0, 1, 17]
    ctx += (paged_split_edges(15, H, KVH, D, max_pages, page)
            + [1023] * 9)[:9]
    B = len(ctx)
    q = torch.randn(B, H, D, device="cuda", generator=g).to(dtype)
    k, v = (torch.randn(num_pages, page, KVH, D, device="cuda",
                        generator=g).to(dtype) for _ in range(2))
    bt = torch.full((B, max_pages), -1, dtype=torch.int32, device="cuda")
    for r, c in enumerate(ctx):
        n = -(-c // page)
        bt[r, :n] = (torch.randperm(num_pages - 1, device="cuda",
                                    generator=g) + 1)[:n]
    return (q, k, v, bt, torch.tensor(ctx, dtype=torch.int32,
                                      device="cuda"))


def bucketed_kernel_parity(K):
    """The paged decode kernel and the RMSNorm kernel against their plain
    versions: paged attention at H 16, D 128, page 16, MHA and GQA KVH 4,
    f32 within 1e-4 and bf16 within 2e-2; RMSNorm on [T, 2048], f32 within
    1e-4 and bf16 within 2e-2, with and without bias. Then the flash
    kernels at the dense prefill's smallest seq bucket, S = 16, on views
    of one fused projection, with phase 6's limits, and in bf16 at S = 1
    and 129."""
    log("[bucketed parity] paged_attention vs plain (H=16, D=128, page 16)")
    for kvh in (16, 4):
        for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            args = paged_decode_inputs(16, kvh, 128, dt, seed=kvh)
            log(f"  contexts {args[4].tolist()}")
            got = K.paged_attention(*args)
            torch.cuda.synchronize()
            check_close(f"paged KVH={kvh} {str(dt)[6:]}", got,
                        K.paged_attention_reference(*args), tol, tol)
            if not bool((got[3] == 0).all()):
                fail("paged_attention: the context-0 row is not zero")
    log("[bucketed parity] rms_norm vs plain ([T, 2048])")
    t0 = time.perf_counter()
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        g = torch.Generator(device="cuda").manual_seed(4)
        x = (torch.randn(300, 2048, device="cuda", generator=g) * 2
             + 1).to(dt)
        w = (1 + 0.1 * torch.randn(2048, device="cuda", generator=g)).to(dt)
        b = (0.1 * torch.randn(2048, device="cuda", generator=g)).to(dt)
        for bias in (None, b):
            got = K.rms_norm(x, w, bias, 1e-5)
            torch.cuda.synchronize()
            check_close(f"rms_norm {str(dt)[6:]} "
                        f"{'with' if bias is not None else 'without'} bias",
                        got, K.rms_norm_reference(x, w, bias, 1e-5), tol,
                        tol)
    log(f"  (Triton compile + first launches {time.perf_counter() - t0:.2f}"
        " s)")
    log("[bucketed parity] flash kernels at the smallest seq bucket "
        "[4, 16, 16, 128] causal, and bf16 at S = 1 and 129")
    for dt, tol, norm_tol, S in (
            (torch.float32, 1e-4, None, 16),
            (torch.bfloat16, FLASH_BF16_TOL, FLASH_BF16_NORM_TOL, 16),
            (torch.bfloat16, FLASH_BF16_TOL, FLASH_BF16_NORM_TOL, 1),
            (torch.bfloat16, FLASH_BF16_TOL, FLASH_BF16_NORM_TOL, 129)):
        _, q, k, v, do = flash_inputs(4, S, 16, 128, dt, seed=16 + S)
        check_flash(K, f"{str(dt)[6:]} S={S} causal", q, k, v, do,
                    1.0 / math.sqrt(128), True, tol, norm_tol)


def bucketed_model_parity(pt):
    """A 2-layer f32 ``gpt_1p3b(use_rms_norm=True)`` served through the
    bucketed fallback, unchunked (a dense prefill, then a prefix hit whose
    tail takes the chunk step, then an 11-token prompt in the 16-token
    seq bucket) and with ``prefill_chunk=16``, held against
    :func:`dense_reference_logits`: greedy tokens equal, every decode
    step's logits within 1e-3."""
    cfg = pt.gpt_1p3b(use_rms_norm=True, dropout=0.0)
    cfg.num_layers = 2
    small = pt.GPTForCausalLM(cfg, dtype=torch.float32, seed=SEED + 3)
    rng = np.random.RandomState(SEED + 3)
    head = rng.randint(1, cfg.vocab_size, size=37).tolist()
    prompts = [head, head[:32] + rng.randint(1, cfg.vocab_size,
                                             size=9).tolist(),
               rng.randint(1, cfg.vocab_size, size=11).tolist()]
    for chunk in (None, 16):
        eng = pt.ServingEngine(small, page_size=16, num_pages=64,
                               max_slots=4, prefill_chunk=chunk,
                               ragged=False)
        worst = 0.0
        for prompt in prompts:
            eng.capture_logits = []
            new = eng.generate(prompt, max_new_tokens=8)
            with torch.no_grad():
                dense = dense_reference_logits(small, prompt + new)
            want = dense[len(prompt) - 1:].argmax(-1).tolist()
            if new != want[:8]:
                fail(f"bucketed engine (chunk {chunk}) tokens {new} != "
                     f"dense greedy {want[:8]}")
            for i, (slot_map, cap) in enumerate(eng.capture_logits):
                slot = next(iter(slot_map))
                err = (torch.from_numpy(cap[slot])
                       - dense[len(prompt) + i].cpu()).abs()
                worst = max(worst, float(err.max()))
                if not bool((err <= 1e-3 + 1e-3 * dense[len(prompt) + i]
                             .cpu().abs()).all()):
                    fail(f"bucketed engine (chunk {chunk}) decode step {i} "
                         f"logits off by {float(err.max()):.3e}")
        st = eng.stats()
        launched = st["bucketed_launches"]
        if st["prefix_hits"] < 1 or launched["chunk"] < 1 or (
                chunk is None and launched["prefill"] < 1):
            fail(f"bucketed parity (chunk {chunk}): the paths did not run "
                 f"({launched}, {st['prefix_hits']} prefix hits)")
        log(f"  prefill_chunk={chunk}: greedy tokens equal for the three "
            f"prompts (prefix hits {st['prefix_hits']}, prefill shapes "
            f"{st['prefill_shapes']}, launches "
            f"{launched}); max decode logit err {worst:.3e} (tolerance "
            f"1e-3 + 1e-3 x |plain|)")
    del eng, small


def bucketed_load(K, eng, rec, seed, label):
    """Phase 3's 36-request Poisson load (32 mixed-length prompts and 4
    sharing a 128-token head, from ``seed``) on the bucketed engine,
    counters zeroed just before and read just after. The dense prefill and
    chunk programs of buckets the load meets first are captured in it (a
    warm-up run, then the replay), so the expected launches count those
    warm-ups too. -> (the load's summary, the launches, the rounds by
    kind, the captures by kind)."""
    from paddle_tpu_torch.serving import (make_mixed_length_prompts,
                                          make_shared_prefix_prompts,
                                          run_poisson_load)
    cfg = eng.cfg
    mixed, news = make_mixed_length_prompts(
        32, (16, 512), cfg.vocab_size, decode_heavy=0.5,
        max_new_tokens=(32, 32), seed=seed)
    shared = make_shared_prefix_prompts(4, (16, 64), cfg.vocab_size, 128,
                                        seed=seed + 1)
    prompts = [shared[0]] + mixed + shared[1:]
    news = [32] + news + [32] * 3
    rec["n"] = {"decode": 0, "prefill": 0, "chunk": 0}
    before = eng.stats()
    programs = set(eng._programs)
    cap_s = before["graph_capture_s"]
    K.reset_launch_counts()
    eng.start()
    try:
        res = run_poisson_load(eng, qps=16.0, prompts=prompts,
                               max_new_tokens=news, seed=seed,
                               timeout=600.0)
    finally:
        eng.stop()
    torch.cuda.synchronize()
    launches = K.launch_counts()
    st = eng.stats()
    n = rec["n"]
    caps = {k: 0 for k in n}
    for key in eng._programs - programs:
        caps[key[0]] += 1
    log(f"  {label}: {json.dumps(res)}")
    log(f"  {label}: rounds={st['steps'] - before['steps']} decode_steps="
        f"{n['decode']} dense_prefills={n['prefill']} chunk_steps="
        f"{n['chunk']} programs captured in the load {caps} in "
        f"{st['graph_capture_s'] - cap_s:.3f} s (graphs now "
        f"{st['graphs']}) prefill_shapes={st['prefill_shapes']} "
        f"chunk_shapes={st['chunk_shapes']} kv_occupancy_peak_pct="
        f"{st['kv_occupancy_peak_pct']} prefix_hits="
        f"{st['prefix_hits'] - before['prefix_hits']} prefix_hit_tokens="
        f"{st['prefix_hit_tokens'] - before['prefix_hit_tokens']} "
        f"evictions={st['evictions']}")
    log(f"  {label}: launches {launches}")
    if res["requests_ok"] != len(prompts) or res["requests_failed"]:
        fail(f"bucketed serve ({label}): {res['requests_failed']} "
             f"request(s) failed")
    if res["tokens"] != sum(news):
        fail(f"bucketed serve ({label}): {res['tokens']} tokens generated, "
             f"{sum(news)} asked")
    if st["prefix_hits"] - before["prefix_hits"] < 1:
        fail(f"bucketed serve ({label}): no prefix-cache hit ran")
    counted = {k: st["bucketed_launches"][k] - before["bucketed_launches"][k]
               for k in n}
    if counted != n:
        fail(f"bucketed serve ({label}): engine counted {counted}, the "
             f"recorder {n}")
    if st["graphs"] != st["distinct_programs"]:
        fail(f"bucketed serve ({label}): {st['graphs']} graphs for "
             f"{st['distinct_programs']} programs")
    # every round, replayed or the warm-up before a capture: a decode step
    # runs each layer's paged attention once; every forward (decode, dense
    # prefill, chunk) two RMSNorms per layer plus ln_f; a dense prefill
    # each layer's flash forward
    L = cfg.num_layers
    runs = {k: n[k] + caps[k] for k in n}
    want = {name: 0 for name in launches}
    want.update({"paged_attention": runs["decode"] * L,
                 "rms_norm": sum(runs.values()) * (2 * L + 1),
                 "flash_fwd": runs["prefill"] * L})
    if n["decode"] <= 0 or n["prefill"] <= 0 or n["chunk"] <= 0 \
            or launches != want:
        fail(f"bucketed serve ({label}): kernel launches {launches} != "
             f"{want} expected from {n} rounds and {caps} warm-ups")
    return res, launches, n, caps


def bucketed_serve(pt, K):
    """``gpt_1p3b(use_rms_norm=True)`` bf16 (24 layers, hidden 2048, random
    weights from seed 0) on ``ServingEngine(ragged=False)``: 16 slots,
    page 16, 2048 pages, unchunked, every round a program (``jit=True``).
    A short ``generate`` captures the decode step and one prefill bucket,
    then phase 3's load runs twice (:func:`bucketed_load`): first from
    phase 3's seed, capturing the buckets it meets, then from another seed
    over the programs captured so far. Then the widest decode step, the
    largest dense prefill and the largest chunk step run again replayed
    and eager. -> the engine, the model, the recorded rounds and the
    first load's launches."""
    cfg = pt.gpt_1p3b(use_rms_norm=True, dropout=0.0)
    t0 = time.perf_counter()
    model = pt.GPTForCausalLM(cfg, dtype=torch.bfloat16, seed=SEED)
    torch.cuda.synchronize()
    log(f"[bucketed serve] gpt_1p3b(use_rms_norm=True) bf16 built in "
        f"{time.perf_counter() - t0:.2f} s "
        f"({sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params)")
    mem0 = reserved_bytes()
    eng = pt.ServingEngine(model, page_size=16, num_pages=2048,
                           max_slots=16, prefill_chunk=None, ragged=False,
                           jit=True)
    mem_kv = reserved_bytes()
    rec = {"decode": None, "prefill": None, "chunk": None,
           "n": {"decode": 0, "prefill": 0, "chunk": 0}}
    fns = {name: getattr(eng, f"_{name}_fn")
           for name in ("decode", "prefill", "chunk")}

    def recording(name):
        def run(*args, **kw):
            rec["n"][name] += 1
            if name == "decode":
                rows = int((args[2][:, 0] > 0).sum())
                if rec["decode"] is None or rows > rec["decode"][0]:
                    rec["decode"] = (rows, args)
            else:
                cells = args[0].size
                if rec[name] is None or cells > rec[name][0]:
                    rec[name] = (cells, args)
            return fns[name](*args, **kw)
        return run

    for name in fns:
        setattr(eng, f"_{name}_fn", recording(name))
    t0 = time.perf_counter()
    eng.generate(list(range(1, 21)), max_new_tokens=2)
    torch.cuda.synchronize()
    warm = eng.stats()
    log(f"  warm-up generate (Triton compile, first launches, the captures "
        f"of the decode step and the (1, 32) prefill) "
        f"{time.perf_counter() - t0:.2f} s: {warm['graphs']} graph(s), "
        f"captured in {warm['graph_capture_s']:.3f} s")
    if warm["graphs"] != 2 or warm["distinct_programs"] != 2:
        fail(f"bucketed serve: {warm['graphs']} graphs for "
             f"{warm['distinct_programs']} programs after the warm-up, 2 "
             f"(the decode step, one prefill bucket) expected")
    res, launches, n, _ = bucketed_load(K, eng, rec, SEED, "load 1")
    res2, _, _, _ = bucketed_load(K, eng, rec, SEED + 20, "load 2")
    st = eng.stats()
    log(f"  TTFT p50/p99 {res['ttft_ms_p50']} / {res['ttft_ms_p99']} ms "
        f"(load 1, its buckets' captures inside), {res2['ttft_ms_p50']} / "
        f"{res2['ttft_ms_p99']} ms (load 2); tokens/s "
        f"{res['tokens_per_sec']} / {res2['tokens_per_sec']}; with an eager "
        f"prefill and chunk step this load's TTFT p50 was 21-25 ms "
        f"(PERF.md)")
    log(f"  {st['graphs']} graphs ({st['distinct_programs']} programs: "
        f"{sorted(eng._programs)}) captured in "
        f"{st['graph_capture_s']:.3f} s; device memory reserved: KV pools "
        f"and the engine's buffers {mem_kv - mem0} bytes, the graphs' "
        f"shared pool and static buffers {reserved_bytes() - mem_kv} bytes")
    eng.capture_logits = []
    check = eng.generate(list(range(1, 65)), max_new_tokens=4)
    cap = eng.capture_logits[-1][1]
    if cap.shape != (16, cfg.vocab_size) or not np.isfinite(cap).all() \
            or not all(0 <= t < cfg.vocab_size for t in check):
        fail("bucketed serve: decode logits not finite / of the wrong shape")
    log(f"  decode logits finite, shape {cap.shape}")
    for name in fns:
        setattr(eng, f"_{name}_fn", fns[name])
    check_replay_matches_eager("bucketed serve", "widest decode step",
                               eng._decode_fn, rec["decode"][1])
    # the largest dense prefill with an all-zero table: its K/V goes to
    # the scrap page, so no request's pages are touched
    ids, lens, bt = rec["prefill"][1]
    check_replay_matches_eager("bucketed serve", "largest dense prefill",
                               eng._prefill_fn, (ids, lens, 0 * bt))
    check_replay_matches_eager("bucketed serve", "largest chunk step",
                               eng._chunk_fn, rec["chunk"][1])
    return eng, model, rec, launches


# the paged decode kernel's main-path instantiation (bf16, D 128, one
# query head a block): mangled-name part for ptxas_stats
PAGED_MAIN = "paged_attention_kernelI13__nv_bfloat16Li128ELi1E"


def paged_sweep(K, H, KVH, D, page, max_pages, num_pages=2048):
    """The paged decode kernel at the engine's widths in bf16 over fresh
    random pools: 16 rows at contexts 128, 512 and 1024, and one row of
    1024 keys (where split-K matters most); each held against its plain
    version (within 4e-3) and timed beside its byte bound. -> a list of
    points."""
    g = torch.Generator(device="cuda").manual_seed(8)
    k, v = (torch.randn(num_pages, page, KVH, D, device="cuda",
                        generator=g).to(torch.bfloat16) for _ in range(2))
    points = []
    for rows, c in ((16, 128), (16, 512), (16, 1024), (1, 1024)):
        q = torch.randn(rows, H, D, device="cuda", generator=g).to(
            torch.bfloat16)
        n = -(-c // page)
        perm = (torch.randperm(num_pages - 1, device="cuda", generator=g)
                + 1).int()
        bt = perm[:rows * n].reshape(rows, n)
        bt = torch.cat([bt, torch.full((rows, max_pages - n), -1,
                                       dtype=torch.int32, device="cuda")],
                       1).contiguous()
        ctx = torch.full((rows,), c, dtype=torch.int32, device="cuda")
        args = (q, k, v, bt, ctx)
        check_close(f"paged bf16 sweep {rows} rows x {c} keys",
                    K.paged_attention(*args),
                    K.paged_attention_reference(*args), 4e-3, 4e-3)
        ms, wall, src = time_ms(lambda: K.paged_attention(*args))
        nbytes, flops, _ = attention_work(
            np.arange(rows), np.ones(rows, np.int64), np.full(rows, c),
            bt.cpu().numpy(), H, KVH, D, page, 2, row_meta=1)
        b_ms, _ = bound(nbytes, flops, BF16_FLOPS_PER_S)
        pt = {"rows": rows, "context": c, "ms": ms, "bound_ms": b_ms,
              "pct_of_bound": 100 * b_ms / ms,
              "gb_per_s": nbytes / ms / 1e6}
        log(f"[bucketed timing] paged_attention sweep {rows} rows x {c} "
            f"keys: {ms:.4f} ms ({src}; {wall:.4f} ms per call with launch)"
            f" bound {b_ms:.4f} ms ({nbytes / 1e6:.2f} MB) = "
            f"{pt['pct_of_bound']:.1f}% of bound, {pt['gb_per_s']:.1f} GB/s")
        points.append(pt)
    return points


def bucketed_timing(K, eng, model, rec, launches):
    """Both new kernels at the bucketed serve's shapes: paged attention at
    its widest decode step on the served layer-0 pools (f32-upcast within
    1e-4, bf16 within 4e-3 against plain), RMSNorm at [rows of the largest
    dense prefill, 2048] bf16 with the served ln_1 weight; each timed
    beside its bound, its plain version and, for RMSNorm,
    ``torch.nn.functional.rms_norm`` (timed here only). Then the flash
    forward at the largest dense prefill's shape, held against its plain
    version and timed beside ``F.scaled_dot_product_attention``. -> the
    kernels' JSON entries."""
    cfg = model.config
    H, KVH, D, page = cfg.num_heads, cfg.num_kv_heads, 128, 16
    rows, (tokens, positions, bt) = rec["decode"]
    B = tokens.shape[0]
    g = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn(B, H, D, device="cuda", generator=g).to(torch.bfloat16)
    bt_d = torch.from_numpy(bt.astype(np.int32)).cuda()
    ctx = torch.from_numpy((positions + 1).astype(np.int32)).cuda()
    args = (q, eng.kv.k[0], eng.kv.v[0], bt_d, ctx)
    args32 = (q.float(), eng.kv.k[0].float(), eng.kv.v[0].float(), bt_d,
              ctx)
    check_close(f"paged f32 at the widest decode step ({rows} rows)",
                K.paged_attention(*args32),
                K.paged_attention_reference(*args32), 1e-4, 1e-4)
    del args32
    err = check_close(f"paged bf16 at the widest decode step ({rows} rows)",
                      K.paged_attention(*args),
                      K.paged_attention_reference(*args), 4e-3, 4e-3)
    ms, wall, src = time_ms(lambda: K.paged_attention(*args))
    plain_ms, _, _ = time_ms(lambda: K.paged_attention_reference(*args),
                             iters=5)
    ctx_np = positions + 1
    nbytes, flops, _ = attention_work(np.arange(B), np.ones(B, np.int64),
                                      ctx_np, bt, H, KVH, D, page, 2,
                                      row_meta=1)
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
    log(f"[bucketed timing] paged_attention widest decode step: B={B} "
        f"rows={rows} contexts {int(ctx_np.min())}-{int(ctx_np.max())} "
        f"kernel {ms:.4f} ms ({src}; {wall:.4f} ms per call with launch) "
        f"plain {plain_ms:.4f} ms bound {b_ms:.4f} ms ({b_by}: "
        f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.4f} GFLOP)")
    # the build's registers and spills of the main path's instantiation
    # (bf16, D 128, one query head a block) and the shared memory a block
    # of this launch takes
    import importlib
    pa = importlib.import_module(
        "paddle_tpu_torch.ops.kernels.paged_attention")
    from paddle_tpu_torch.ops.kernels import _build
    regs, spill = ptxas_stats("paged_attention", PAGED_MAIN)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_pages = bt.shape[1]
    n_split = pa.launch_plan(B, H, KVH, D, max_pages, page, sms)["n_split"]
    smem_fn = _build.load("paged_attention").paged_attention_smem_bytes
    smem_fn.argtypes = [ctypes.c_int] * 7
    smem_fn.restype = ctypes.c_longlong
    smem = smem_fn(H, KVH, D, max_pages, page, n_split, 1)
    log(f"  paged_attention: {regs} registers, {spill} spill bytes, {smem} "
        f"bytes of dynamic shared memory a block, {n_split} splits a (row, "
        f"KV head) = {100 * b_ms / ms:.1f}% of bound, "
        f"{nbytes / ms / 1e6:.1f} GB/s")
    entries = [{
        "name": "paged_attention", "route": "cuda",
        "source": "paddle_tpu_torch/ops/kernels/csrc/paged_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/paged_attention.py:175",
        "launches": launches["paged_attention"], "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "registers": regs, "spill_bytes": spill,
        "smem_bytes": smem, "n_split": n_split,
        "sweep": paged_sweep(K, H, KVH, D, page, max_pages)}]
    del args, q
    nb, sb = rec["prefill"][1][0].shape
    R = nb * sb
    eps = cfg.layer_norm_epsilon
    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn(R, 2048, device="cuda", generator=g).to(torch.bfloat16)
    w = model.gpt.h[0].ln_1.weight.detach()
    err = check_close(f"rms_norm at [{R}, 2048] bf16", K.rms_norm(x, w, None,
                                                                  eps),
                      K.rms_norm_reference(x, w, None, eps), 2e-2, 2e-2)
    ms, wall, src = time_ms(lambda: K.rms_norm(x, w, None, eps))
    plain_ms, _, _ = time_ms(lambda: K.rms_norm_reference(x, w, None, eps))
    lib_ms, lib_wall, _ = time_ms(lambda: torch.nn.functional.rms_norm(
        x, (2048,), w, eps))
    b_ms, b_by = bound(2 * x.numel() * 2 + 2048 * 2, 4 * x.numel(),
                       F32_FLOPS_PER_S)
    log(f"[bucketed timing] rms_norm [{R}, 2048] bf16 (the largest dense "
        f"prefill, [{nb}, {sb}]): kernel {ms:.4f} ms ({src}; {wall:.4f} ms "
        f"per call with launch) plain {plain_ms:.4f} ms F.rms_norm "
        f"{lib_ms:.4f} ms ({lib_wall:.4f} ms per call) bound {b_ms:.4f} ms "
        f"({b_by})")
    # the flash forward as the bucketed serve runs it: one dense prefill
    # at the largest shape it launched (bf16 causal, q/k/v views of one
    # fused projection), beside F.scaled_dot_product_attention
    H, D = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    scale = 1.0 / math.sqrt(D)
    _, q, k, v, _ = flash_inputs(nb, sb, H, D, torch.bfloat16, seed=7)
    o, lse = K.flash_fwd(q, k, v, scale, True)
    ro, rl = K.flash_fwd_reference(_bhsd(q), _bhsd(k), _bhsd(v), scale, True)
    check_close(f"flash_fwd O at the largest dense prefill [{nb}, {sb}]", o,
                _bshd(ro, nb, H), FLASH_BF16_TOL, FLASH_BF16_TOL,
                FLASH_BF16_NORM_TOL)
    check_close(f"flash_fwd lse at the largest dense prefill [{nb}, {sb}]",
                lse, rl.reshape(nb, H, sb), 1e-4, 1e-4)
    fl_ms, fl_wall, src = time_ms(lambda: K.flash_fwd(q, k, v, scale, True))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa_ms, _, _ = time_ms(lambda: torch.nn.functional
                            .scaled_dot_product_attention(qt, kt, vt,
                                                          is_causal=True))
    log(f"[bucketed timing] flash_fwd at the largest dense prefill [{nb}, "
        f"{sb}, {H}, {D}] bf16 causal: kernel {fl_ms:.4f} ms ({src}; "
        f"{fl_wall:.4f} ms per call with launch) "
        f"F.scaled_dot_product_attention {sdpa_ms:.4f} ms")
    entries.append({
        "name": "rms_norm", "route": "triton",
        "source": "paddle_tpu_torch/ops/kernels/rms_norm.py",
        "replaces": "paddle_tpu/ops/pallas/rms_norm.py:39",
        "launches": launches["rms_norm"], "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms})
    return entries


# ------------------------------------------------------------ O2 phases
def o2_model(pt, cfg, seed=SEED):
    """``cfg`` built in f32 from ``seed``, with the O2 pretraining run's
    optimizer: AdamW with master weights, a global-norm clip at 1.0 and
    ``LinearWarmup(CosineAnnealingDecay(1e-4, T_max=100), 4, 0, 1e-4)``,
    decorated O2 bf16 (``bench.py:690-720`` plus the schedule and clip).
    -> (model, optimizer, scheduler)"""
    lr = pt.optimizer.lr
    model = pt.GPTForCausalLM(cfg, dtype=torch.float32, seed=seed).train()
    sched = lr.LinearWarmup(lr.CosineAnnealingDecay(1e-4, T_max=100), 4,
                            0.0, 1e-4)
    opt = pt.AdamW(learning_rate=sched, parameters=model.parameters(),
                   multi_precision=True,
                   grad_clip=pt.nn.ClipGradByGlobalNorm(1.0))
    model, opt = pt.amp.decorate(model, opt, level="O2", dtype="bfloat16")
    return model, opt, sched


def o2_step_fn(pt, model, opt, sched, ids, labels):
    crit = pt.GPTPretrainingCriterion(model.config)

    def step():
        with pt.auto_cast(level="O2", dtype="bfloat16"):
            loss = crit(model(ids), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        return loss.item()
    return step


def o2_train_slice(pt, K, recompute, steps=10, warmup=2, B=8, S=1024):
    """gpt_1p3b trained O2 (:func:`o2_model`) on phase 8's fixed batch:
    ``warmup`` steps, then ``steps`` timed ones. Fails unless the losses
    are finite and fall and the kernels launched exactly as the step
    prescribes. -> (model, optimizer, scheduler, losses, summary, the
    timed steps' launch counts)"""
    cfg = pt.gpt_1p3b(dropout=0.0, recompute=recompute)
    t0 = time.perf_counter()
    model, opt, sched = o2_model(pt, cfg)
    dev = model.device
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.RandomState(SEED)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, S))).to(dev)
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                          (B, S))).to(dev)
    step = o2_step_fn(pt, model, opt, sched, ids, labels)
    torch.cuda.synchronize()
    tag = "recompute" if recompute else "no recompute"
    log(f"[o2 train] gpt_1p3b {tag}: {n_params / 1e9:.4f} B params in "
        f"bf16 ({len(list(model.parameters()))} tensors) with f32 masters,"
        f" built and decorated in {time.perf_counter() - t0:.2f} s; B={B} "
        f"S={S}; auto_cast O2 bf16, AdamW(multi_precision) with "
        f"ClipGradByGlobalNorm(1.0), LinearWarmup(CosineAnnealingDecay)")
    losses, times, lrs = [], [], []
    for _ in range(warmup):
        losses.append(step())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    for _ in range(steps):
        lrs.append(opt.get_lr())
        t0 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log("  losses: " + " ".join(f"{x:.4f}" for x in losses)
        + f" (first {warmup} are warm-up)")
    log("  lr: " + " ".join(f"{x:.3e}" for x in lrs))
    log("  step ms: " + " ".join(f"{x:.2f}" for x in times))
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        fail(f"o2 train ({tag}): losses not finite or not falling: "
             f"{losses}")
    L = cfg.num_layers
    # per step: the flash forward once a layer (twice with recompute: the
    # replay runs it again), dQ and dK/dV once a layer, LayerNorm twice a
    # layer plus ln_f (again twice a layer in the replay), AdamW once
    fwd = 2 * L if recompute else L
    want = {name: 0 for name in launches}
    want.update({"layer_norm": steps * (2 * fwd + 1),
                 "flash_fwd": steps * fwd, "flash_bwd_dq": steps * L,
                 "flash_bwd_dkv": steps * L, "fused_adamw": steps})
    log(f"  launches over {steps} timed steps: {launches}")
    if launches != want:
        fail(f"o2 train ({tag}): kernel launches {launches} != {want}")
    wall_ms, busy_ms, families, top, _ = profile_train_step(step)
    total_ms = sum(families.values())
    log(f"  one step under torch.profiler: {wall_ms:.2f} ms host, device "
        f"busy {busy_ms:.2f} ms = {100 * busy_ms / wall_ms:.1f}% busy")
    for fam, fam_ms in sorted(families.items(), key=lambda kv: -kv[1]):
        log(f"    {fam}: {fam_ms:.3f} ms ({100 * fam_ms / total_ms:.1f}%)")
    for (fam, name), k_ms in top[:8]:
        log(f"      {k_ms:.3f} ms  [{fam}] {name[:90]}")
    med = float(np.median(times))
    flops = train_flops(n_params, B, S, L, cfg.hidden_size)
    summary = {"recompute": recompute, "step_ms_median": med,
               "step_ms_min": min(times), "step_ms_max": max(times),
               "tokens_per_s": B * S / med * 1e3,
               "gpt_train_step_mfu": flops / (med / 1e3) / BF16_FLOPS_PER_S,
               "max_memory_allocated_gb": peak / 1e9,
               "device_busy_pct": 100 * busy_ms / wall_ms,
               "first_loss": losses[0], "last_loss": losses[-1]}
    log(f"  {json.dumps(summary)}")
    return model, opt, sched, losses, summary, launches


def o2_train(pt, K):
    """Phase 13: the O2 run without recompute, then with it (the first
    model freed before the second is built). The recompute run must show
    a lower peak and the same losses within 1e-3 (the kernels are the
    same; only the summation order of a nondeterministic reduction could
    move them). -> (the recompute run's model, optimizer, the two
    summaries, the recompute run's launches)"""
    model, opt, sched, plain, s_plain, _ = o2_train_slice(pt, K, False)
    del model, opt, sched
    gc.collect()
    torch.cuda.empty_cache()
    model, opt, sched, remat, s_remat, launches = o2_train_slice(pt, K,
                                                                 True)
    diff = max(abs(a - b) for a, b in zip(plain, remat))
    log(f"[o2 train] recompute vs not: losses differ by at most "
        f"{diff:.3e} (tolerance 1e-3); peak "
        f"{s_remat['max_memory_allocated_gb']:.2f} GB against "
        f"{s_plain['max_memory_allocated_gb']:.2f} GB; step "
        f"{s_remat['step_ms_median']:.2f} ms against "
        f"{s_plain['step_ms_median']:.2f} ms")
    if diff > 1e-3:
        fail(f"o2 train: recompute's losses {remat} differ from {plain}")
    if s_remat["max_memory_allocated_gb"] >= \
            s_plain["max_memory_allocated_gb"]:
        fail("o2 train: recompute did not lower the peak memory")
    return model, opt, (s_plain, s_remat), launches


def check_update(K, before, gs, after, c1, c2, rtol, what):
    """Each tensor's ``(w, m, v)`` in ``after`` against the plain update
    of its clones in ``before`` (one tensor at a time, so the plain
    results never all live at once), within ``1e-6 + rtol |plain|``.
    -> the max abs error"""
    worst = 0.0
    for i, ((w0, m0, v0), gr) in enumerate(zip(before, gs)):
        want = K.fused_adamw_reference(w0, gr, m0, v0, 1e-4, 0.9, 0.999,
                                       1e-8, 0.01, c1, c2)
        for key, got, ref in zip("wmv", [x[i] for x in after], want):
            err = (got.float() - ref.float()).abs()
            worst = max(worst, float(err.max()))
            if got.dtype != ref.dtype or not bool(
                    (err <= 1e-6 + rtol * ref.float().abs()).all()):
                fail(f"{what}: {key} of tensor {i} off by "
                     f"{float(err.max()):.3e}")
    return worst


def launch_ms(args, iters=10, warmup=2):
    """Device ms of one fused AdamW launch over ``args`` (the wrapper's
    arguments, ``params`` last): the table is built once, then CUDA
    events bracket ``iters`` launches issued back to back, so the
    wrapper's host work and its synchronous table copy, which hold the
    card idle between calls, are left out."""
    FA = importlib.import_module("paddle_tpu_torch.ops.kernels.fused_adamw")
    ws, gs, ms, vs, lr, b1, b2, eps, wd, bc1, bc2, params = args
    fn, chunk = FA._kernel()
    n = len(ws)
    plan = FA._table(ws, gs, ms, vs, params or [None] * n, lr, wd, bc1,
                     bc2, chunk)
    for _ in range(warmup):
        FA._launch(fn, plan, b1, b2, eps)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(iters):
        FA._launch(fn, plan, b1, b2, eps)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def master_mode_timing(K, model, opt, tag="o2 timing"):
    """Phase 14 (kernel): master mode and bf16-moment mode over the
    model's tensors, each one launch, against the plain version on clones
    (f32 within 1e-6 + 1e-6 |plain|, bf16 within one rounding, the bf16
    parameter exactly its new master rounded); then both timed beside
    their bounds (28 and 14 bytes a parameter over 3.35 TB/s) and master
    mode beside ``torch._fused_adamw_`` on the f32 masters with the
    gradients upcast plus ``torch._foreach_copy_`` into the bf16
    parameters (timed here only). -> a dict of the numbers for the
    ``fused_adamw`` entry"""
    params = list(model.parameters())
    n_t, n = len(params), sum(p.numel() for p in params)
    g = torch.Generator(device=params[0].device).manual_seed(11)
    gs = [(1e-3 * torch.randn(p.shape, device=p.device, generator=g))
          .bfloat16() for p in params]
    ws = [opt._master_of(p) for p in params]
    ms_ = [opt._get_accumulator("moment1", p) for p in params]
    vs_ = [opt._get_accumulator("moment2", p) for p in params]
    c1, c2 = 1 / (1 - 0.9 ** 23), 1 / (1 - 0.999 ** 23)
    args = lambda w, m, v, ps: (  # noqa: E731
        w, gs, m, v, [1e-4] * n_t, 0.9, 0.999, 1e-8, [0.01] * n_t,
        [c1] * n_t, [c2] * n_t, ps)
    out = {}
    with torch.no_grad():
        before = [(w.clone(), m.clone(), v.clone())
                  for w, m, v in zip(ws, ms_, vs_)]
        K.fused_adamw(*args(ws, ms_, vs_, params))
        torch.cuda.synchronize()
        err = check_update(K, before, gs, (ws, ms_, vs_), c1, c2, 1e-6,
                           "fused_adamw master mode")
        del before
        for p, w in zip(params, ws):
            if not torch.equal(p, w.bfloat16()):
                fail(f"fused_adamw master mode: "
                     f"{getattr(p, 'param_name', tuple(p.shape))} is not "
                     f"its master rounded to bf16")
        out["master_max_abs_err"] = err
        log(f"  master mode, one launch over {n_t} tensors ({n / 1e9:.4f} "
            f"B params): w, m, v within 1e-6 + 1e-6 |plain| (max abs err "
            f"{err:.3e}); every bf16 parameter equals its new master "
            f"rounded to nearest even")
        # bf16 moments: bf16 w, g, m, v (O2 without master weights)
        wb = [p.detach().clone() for p in params]
        mb = [m.bfloat16() for m in ms_]
        vb = [v.bfloat16() for v in vs_]
        before = [(w.clone(), m.clone(), v.clone())
                  for w, m, v in zip(wb, mb, vb)]
        K.fused_adamw(*args(wb, mb, vb, None))
        torch.cuda.synchronize()
        # one bf16 rounding of values the kernel and the plain version may
        # round from f32 results that differ in the last bit (FMA)
        err_b = check_update(K, before, gs, (wb, mb, vb), c1, c2, 8e-3,
                             "fused_adamw bf16 moments")
        del before
        out["bf16_moment_max_abs_err"] = err_b
        log(f"  bf16-moment mode, one launch over {n_t} tensors: w, m, v "
            f"within one bf16 rounding (8e-3 |plain|; max abs err "
            f"{err_b:.3e})")
        torch.cuda.empty_cache()
        ms, wall, src = time_ms(lambda: K.fused_adamw(
            *args(ws, ms_, vs_, params)), iters=10)
        plain_ms, _, _ = time_ms(lambda: [K.fused_adamw_reference(
            w, gr, m, v, 1e-4, 0.9, 0.999, 1e-8, 0.01, c1, c2)
            for w, gr, m, v in zip(ws, gs, ms_, vs_)], iters=2, warmup=1)
        ms_b, _, _ = time_ms(lambda: K.fused_adamw(*args(wb, mb, vb, None)),
                             iters=10)
        g32 = [x.float() for x in gs]
        # the same launches with the table built once (device time alone),
        # and the O1 mode (f32 w and g) on the same tensors beside them
        ev = {"master": launch_ms(args(ws, ms_, vs_, params)),
              "bf16_moment": launch_ms(args(wb, mb, vb, None)),
              "f32": launch_ms((ws, g32) + args(ws, ms_, vs_, None)[2:])}
        del wb, mb, vb
        steps_t = [torch.tensor(23.0, device=p.device) for p in params]
        lib_adam, _, _ = time_ms(lambda: torch._fused_adamw_(
            ws, g32, ms_, vs_, [], steps_t, lr=1e-4, beta1=0.9,
            beta2=0.999, weight_decay=0.01, eps=1e-8, amsgrad=False,
            maximize=False), iters=10)
        pdata = [p.detach() for p in params]
        lib_copy, _, _ = time_ms(lambda: torch._foreach_copy_(pdata, ws),
                                 iters=10)
        del g32
    b_ms, b_by = bound(28 * n, 12 * n, F32_FLOPS_PER_S)
    bb_ms, bb_by = bound(14 * n, 12 * n, F32_FLOPS_PER_S)
    # the kernel's time is the launch over a prebuilt table: the
    # profiler's sum over the wrapper's calls (``ms``, ``ms_b``) read 20%
    # low in these modes (two of ten launches missing from its trace)
    log(f"[{tag}] fused_adamw master mode over {n_t} tensors: kernel "
        f"{ev['master']:.4f} ms (one launch over a prebuilt table, CUDA "
        f"events over back-to-back launches) = "
        f"{100 * b_ms / ev['master']:.1f}% of bound {b_ms:.4f} ms ({b_by}: "
        f"28 B/param, {28 * n / 1e9:.2f} GB); the wrapper {wall:.4f} ms a "
        f"call with its host work (profiler device sum {ms:.4f} ms, {src});"
        f" plain {plain_ms:.4f} ms; library torch._fused_adamw_ "
        f"{lib_adam:.4f} ms + torch._foreach_copy_ {lib_copy:.4f} ms = "
        f"{lib_adam + lib_copy:.4f} ms")
    log(f"[{tag}] fused_adamw bf16-moment mode: kernel "
        f"{ev['bf16_moment']:.4f} ms (prebuilt table) = "
        f"{100 * bb_ms / ev['bf16_moment']:.1f}% of bound {bb_ms:.4f} ms "
        f"({bb_by}: 14 B/param; profiler device sum {ms_b:.4f} ms); f32 w "
        f"and g, phase 9's mode, on the same tensors: {ev['f32']:.4f} ms "
        f"(prebuilt table) = {100 * b_ms / ev['f32']:.1f}% of bound")
    out.update({"master_ms": ev["master"], "master_wrapper_ms": wall,
                "master_plain_ms": plain_ms, "master_bound_ms": b_ms,
                "master_library_ms": lib_adam + lib_copy,
                "master_library_fused_adamw_ms": lib_adam,
                "master_library_foreach_copy_ms": lib_copy,
                "bf16_moment_ms": ev["bf16_moment"],
                "bf16_moment_bound_ms": bb_ms, "f32_launch_ms": ev["f32"]})
    return out


def resume_and_scaler_check(pt, K, layers=2, B=2, S=512):
    """Phase 14 (state): at full width and ``layers`` layers, train 2 O2
    steps, save model, optimizer and scheduler to the host, train 2 more;
    a fresh model and optimizer restored from the saved state and trained
    the same 2 steps must hold bit-equal weights, masters and moments.
    Then ``GradScaler``: an inf injected into one gradient must skip the
    step (weights, masters and step counts untouched) and halve the
    scale, and the next step must update."""
    cfg = pt.gpt_1p3b(dropout=0.0)
    cfg.num_layers = layers
    rng = np.random.RandomState(SEED + 3)
    batches = [tuple(torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                                  (B, S))) for _ in range(2))
               for _ in range(4)]

    def run(model, opt, sched, bs):
        dev = model.device
        for ids, labels in bs:
            o2_step_fn(pt, model, opt, sched, ids.to(dev),
                       labels.to(dev))()

    model, opt, sched = o2_model(pt, cfg, seed=SEED + 3)
    run(model, opt, sched, batches[:2])
    saved_w = {n: p.detach().cpu().clone()
               for n, p in model.named_parameters()}
    saved_opt = pt.opt_state_to_numpy(opt.state_dict())
    run(model, opt, sched, batches[2:])
    model2, opt2, sched2 = o2_model(pt, cfg, seed=SEED + 4)
    with torch.no_grad():
        for n, p in model2.named_parameters():
            p.copy_(saved_w[n])
    opt2.set_state_dict(saved_opt)
    run(model2, opt2, sched2, batches[2:])
    torch.cuda.synchronize()
    worst = {"weights": 0.0, "masters": 0.0, "moments": 0.0}
    for (n, p), p2 in zip(model.named_parameters(), model2.parameters()):
        pairs = [("weights", p, p2),
                 ("masters", opt._master_weights[p],
                  opt2._master_weights[p2])]
        pairs += [("moments", opt._accumulators[a][p],
                   opt2._accumulators[a][p2])
                  for a in ("moment1", "moment2")]
        for key, a, b in pairs:
            worst[key] = max(worst[key], float((a.float() - b.float())
                                               .abs().max().detach()))
        if opt._accumulators["beta_pow"][p] != \
                opt2._accumulators["beta_pow"][p2]:
            fail(f"resume: step count of {n} differs")
    if sched.last_epoch != sched2.last_epoch or \
            opt._global_step != opt2._global_step:
        fail("resume: scheduler or global step differs")
    log(f"[resume] 2 + 2 O2 steps against a host save after 2, restored "
        f"and stepped 2 ({layers} layers at gpt_1p3b widths, B={B} S={S}): "
        f"max abs difference {worst}")
    if any(worst.values()):
        fail(f"resume: the restored run differs from the continuous one "
             f"{worst}")
    log("  bit-equal: weights, f32 masters, moments, step counts, "
        "schedule")
    del model2, opt2, sched2, saved_w, saved_opt
    # GradScaler: an inf skips the step and halves the scale
    scaler = pt.amp.GradScaler(init_loss_scaling=2.0 ** 10)
    crit = pt.GPTPretrainingCriterion(cfg)
    dev = model.device
    ids, labels = (x.to(dev) for x in batches[0])
    params = list(model.parameters())
    for inject in (True, False):
        with pt.auto_cast(level="O2", dtype="bfloat16"):
            loss = crit(model(ids), labels)
        scaler.scale(loss).backward()
        if inject:
            params[4].grad.view(-1)[7] = float("inf")
        snap = [(p.detach().clone(), opt._master_weights[p].clone())
                for p in params]
        steps_before = opt._global_step
        scale_before = scaler._scale
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        torch.cuda.synchronize()
        same = all(torch.equal(p, w) and torch.equal(opt._master_weights[p],
                                                     mw)
                   for p, (w, mw) in zip(params, snap))
        if inject and not (same and opt._global_step == steps_before
                           and scaler._scale == scale_before / 2):
            fail(f"GradScaler: an inf gradient did not skip the step "
                 f"(weights untouched {same}, scale {scaler._scale})")
        if not inject and same:
            fail("GradScaler: a finite step left the weights unchanged")
        log(f"[scaler] {'inf injected' if inject else 'finite'}: step "
            f"{'skipped' if same else 'taken'}, scale {scale_before:g} -> "
            f"{scaler._scale:g}")
    del model, opt, sched, snap


# ------------------------------------------------------- generate phase
def flash_decode_parity(K, B=4, H=16, D=128):
    """The flash forward at one query row over ``Sk`` keys, the eager
    ``generate``'s dense-cache step (not causal), against its plain
    version: ``Sk`` in 1, 17, 129, 383 (the generate phase's last step)
    and 1000; q a row of one fused projection, k and v contiguous as the
    concatenated cache; f32 within 1e-4, bf16 within phase 6's limits.
    Then the kernel at ``Sk = 383`` bf16 timed beside its bound, its plain
    version and ``F.scaled_dot_product_attention``. -> the JSON keys it
    adds to the flash forward's entry."""
    scale = 1.0 / math.sqrt(D)
    worst = 0.0
    for dt, tol, norm_tol in ((torch.float32, 1e-4, None),
                              (torch.bfloat16, FLASH_BF16_TOL,
                               FLASH_BF16_NORM_TOL)):
        for sk in (1, 17, 129, 383, 1000):
            g = torch.Generator(device="cuda").manual_seed(sk)
            qkv = torch.randn(B, 1, 3 * H * D, device="cuda",
                              generator=g).to(dt)
            q = qkv[..., :H * D].reshape(B, 1, H, D)
            k, v = (torch.randn(B, sk, H, D, device="cuda",
                                generator=g).to(dt) for _ in range(2))
            o, lse = K.flash_fwd(q, k, v, scale, False)
            ro, rl = K.flash_fwd_reference(_bhsd(q), _bhsd(k), _bhsd(v),
                                           scale, False)
            tag = f"Sq=1 Sk={sk} {str(dt)[6:]}"
            err = check_close(f"flash_fwd O {tag}", o, _bshd(ro, B, H), tol,
                              tol, norm_tol)
            check_close(f"flash_fwd lse {tag}", lse, rl.reshape(B, H, 1),
                        1e-4, 1e-4)
            if dt == torch.bfloat16:
                worst = max(worst, err)
    kc, vc = k[:, :383].contiguous(), v[:, :383].contiguous()
    ms, wall, src = time_ms(lambda: K.flash_fwd(q, kc, vc, scale, False))
    plain_ms, _, _ = time_ms(lambda: K.flash_fwd_reference(
        _bhsd(q), _bhsd(kc), _bhsd(vc), scale, False))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, kc, vc))
    lib_ms, _, _ = time_ms(lambda: torch.nn.functional
                           .scaled_dot_product_attention(qt, kt, vt))
    # q, k, v read once, O written, lse written; QK^T and PV
    nbytes = 2 * B * H * D * (2 + 2 * 383) + 4 * B * H
    b_ms, b_by = bound(nbytes, 4 * B * H * 383 * D, BF16_FLOPS_PER_S)
    log(f"[generate timing] flash_fwd at Sq=1 Sk=383 [{B}, 1, {H}, {D}] bf16: "
        f"kernel {ms:.4f} ms ({src}; {wall:.4f} ms per call with launch) "
        f"plain {plain_ms:.4f} ms F.scaled_dot_product_attention "
        f"{lib_ms:.4f} ms bound {b_ms:.4f} ms ({b_by}: "
        f"{nbytes / 1e6:.2f} MB)")
    return {"sq1_max_abs_err": worst, "sq1_ms": ms, "sq1_plain_ms": plain_ms,
            "sq1_bound_ms": b_ms, "sq1_bound_by": b_by,
            "sq1_library_ms": lib_ms}


def teacher_forced(model, out, P, top_k=None, rtol=2e-2, atol=2e-2):
    """Every token of ``out`` after the prompt against the logits of one
    no-cache forward over ``out`` (the flash forward, causal): greedy
    (``top_k`` None) when its logit is the row's largest, or below it by
    at most ``atol + rtol * |largest|`` (bf16 logits of two differently
    rounded paths); sampled with ``top_k`` when its logit is at least the
    k-th largest less that margin. -> (tokens at or above the reference
    logit, tokens, the largest shortfall, whether every token passes)."""
    with torch.no_grad():
        logits = model(out[:, :-1])[:, P - 1:].float()
    chosen = logits.gather(-1, out[:, P:, None])[..., 0]
    if top_k is None:
        ref = logits.max(dim=-1).values
    else:
        ref = logits.topk(top_k, dim=-1).values[..., -1]
    short = ref - chosen
    ok = short <= atol + rtol * ref.abs()
    return int((short <= 0).sum()), short.numel(), float(short.max()), \
        bool(ok.all())


def generate_phase(pt, K, B=4, P=128, N=256):
    """``GPTForCausalLM.generate`` on ``gpt_1p3b`` bf16 (24 layers, random
    weights from seed 0), batch 4, 128-token prompts from seed 0, 256 new
    tokens: greedy compiled (twice: the first call captures the step's
    graph after one eager warm-up step, the second only replays), the
    same static step run eagerly (bit-equal to the replays), greedy eager
    over the dense cache (the flash forward at Sq = 1, counted) and
    sampled with ``top_k=50`` (twice from one generator seed: equal).
    Every greedy token passes the teacher-forced check of
    :func:`teacher_forced`, every sampled one is among its step's 50
    largest; the launches are exact. Prints ms a step and tokens/s on the
    host clock. -> the JSON keys the phase adds to the layer_norm and
    flash forward entries."""
    from paddle_tpu_torch.models.generate import generate_compiled
    cfg = pt.gpt_1p3b(dropout=0.0)
    model = pt.GPTForCausalLM(cfg, dtype=torch.bfloat16, seed=SEED)
    ids = torch.from_numpy(np.random.RandomState(SEED).randint(
        1, cfg.vocab_size, (B, P))).to(model.device)
    L = cfg.num_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def timed(label, fn, want):
        K.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in K.launch_counts().items() if v}
        log(f"[generate] {label}: {wall:.3f} s, {wall * 1e3 / N:.3f} ms a "
            f"step, {B * N / wall:.1f} tokens/s (batch {B}, {N} steps); "
            f"launches {launches}")
        if launches != want:
            fail(f"generate {label}: launches {launches} != {want}")
        if out.shape != (B, P + N) or not bool((out[:, :P] == ids).all()):
            fail(f"generate {label}: output {tuple(out.shape)} does not "
                 f"extend the prompt to [{B}, {P + N}]")
        return out, wall

    # the compiled step: prefill, then N - 1 steps, one LayerNorm a
    # layer twice plus ln_f each
    want = {"layer_norm": (2 * L + 1) * N}
    progs = model.decode_programs
    first, _ = timed("greedy compiled, first call", lambda: model.generate(
        ids, max_new_tokens=N, temperature=0.0), want)
    log(f"  {progs.graphs} graph captured in {progs.capture_s:.3f} s")
    comp, comp_s = timed("greedy compiled, replays", lambda: model.generate(
        ids, max_new_tokens=N, temperature=0.0), want)
    static, _ = timed("greedy static step, eager", lambda: generate_compiled(
        model, ids, N, None, replay=False), want)
    if progs.graphs != 1 or not (torch.equal(first, comp)
                                 and torch.equal(comp, static)):
        fail(f"generate: {progs.graphs} graphs; the replayed steps equal "
             f"the eager static step: {torch.equal(comp, static)}, the two "
             f"compiled calls: {torch.equal(first, comp)}")
    log("  the replayed steps' tokens equal the eager static step's")
    # 16 replays of the step under the profiler: where its device time
    # goes
    dec = next(iter(progs._decoders.values()))
    dec.prefill(ids, -1)
    wall_ms, busy_ms, families, top, events = profile_train_step(
        lambda: [dec.captured.replay() for _ in range(16)])
    log(f"[generate profile] 16 replayed steps: {wall_ms / 16:.3f} ms a step "
        f"on the host clock, device busy {busy_ms / 16:.3f} ms a step "
        f"({100 * busy_ms / wall_ms:.1f}%), {events / 16:g} device "
        f"kernels a step")
    for fam, ms in sorted(families.items(), key=lambda kv: -kv[1]):
        log(f"  {fam}: {ms / 16:.4f} ms a step")
    for (fam, name), ms in top[:10]:
        log(f"    {ms / 16:.4f} ms a step  [{fam}] {name[:100]}")
    # the dense cache: N + 1 forwards (the loop's last one is not read);
    # twice, as the first call also grows the allocator's cache
    for run in ("first call", "second call"):
        dense, dense_s = timed(
            f"greedy eager, dense cache, {run}", lambda: model.generate(
                ids, max_new_tokens=N, temperature=0.0, compiled=False),
            {"flash_fwd": L * (N + 1),
             "layer_norm": (2 * L + 1) * (N + 1)})
    flash_launches = L * (N + 1)
    same = int((dense[:, P:] == comp[:, P:]).all(dim=0).long().cumprod(
        0).sum())
    log(f"  the dense and the static path agree on their first {same} of "
        f"{N} steps in every row (bf16: each path is held to itself)")
    for label, out in (("compiled", comp), ("dense cache", dense)):
        exact, n, short, ok = teacher_forced(model, out, P)
        log(f"  teacher-forced, greedy {label}: {exact} of {n} tokens the "
            f"exact argmax of a no-cache forward, the largest shortfall "
            f"{short:.4f} (tolerance 2e-2 + 2e-2 x |max|)")
        if not ok:
            fail(f"generate: a greedy {label} token is not the argmax of "
                 f"the no-cache forward within bf16 tolerance")
    draws = []
    for _ in range(2):
        gen = torch.Generator(device=model.device).manual_seed(SEED)
        out, samp_s = timed(
            "sampled, top_k 50", lambda: model.generate(
                ids, max_new_tokens=N, temperature=1.0, top_k=50,
                generator=gen),
            {"flash_fwd": L * (N + 1), "layer_norm": (2 * L + 1) * (N + 1)})
        draws.append(out)
    exact, n, short, ok = teacher_forced(model, draws[0], P, top_k=50)
    log(f"  sampled: the two draws from one seed equal: "
        f"{torch.equal(*draws)}; {n} tokens, the largest shortfall below "
        f"the 50th logit {short:.4f}")
    if not (ok and torch.equal(*draws)):
        fail("generate: sampling not reproducible or outside the top 50")
    mem = torch.cuda.max_memory_allocated()
    log(f"  ms a step: compiled {comp_s * 1e3 / N:.3f}, dense cache "
        f"{dense_s * 1e3 / N:.3f}, sampled {samp_s * 1e3 / N:.3f}; "
        f"peak memory {mem / 1e9:.2f} GB")
    del model
    return {"generate_launches": flash_launches}, \
        {"generate_launches": want["layer_norm"]}


# ------------------------------------------------------ operations phase
OPS_ENGINE = dict(page_size=16, num_pages=2048, max_slots=16,
                  prefill_chunk=256, jit=True)


def phase3_load(vocab):
    """Phase 3's 36 requests (32 mixed-length, 4 sharing a 128-token
    head) and their token budgets."""
    from paddle_tpu_torch.serving import (make_mixed_length_prompts,
                                          make_shared_prefix_prompts)
    mixed, news = make_mixed_length_prompts(
        32, (16, 512), vocab, decode_heavy=0.5, max_new_tokens=(32, 32),
        seed=SEED)
    shared = make_shared_prefix_prompts(4, (16, 64), vocab, 128,
                                        seed=SEED + 1)
    return [shared[0]] + mixed + shared[1:], [32] + news + [32] * 3


def count_rounds(eng):
    """Count ``eng``'s launched ragged rounds in ``eng.launched`` (an
    instance wrapper over its round function)."""
    run = eng._ragged_fn
    eng.launched = 0

    def counting(*a, **kw):
        eng.launched += 1
        return run(*a, **kw)

    eng._ragged_fn = counting


def check_launches(K, tag, rounds, L):
    """The counts since the last reset against ``rounds`` ragged rounds
    of ``L`` layers: attention L and LayerNorm 2L + 1 times a round."""
    torch.cuda.synchronize()
    launches = {k: v for k, v in K.launch_counts().items() if v}
    want = {"ragged_paged_attention": rounds * L,
            "layer_norm": rounds * (2 * L + 1)}
    log(f"  {tag}: launches {launches} over {rounds} rounds")
    if rounds <= 0 or launches != want:
        fail(f"operations {tag}: launches {launches} != {want}")
    return launches


def ops_load(K, eng, prompts, news, label):
    """Phase 3's Poisson load on ``eng``'s serve loop, counters zeroed
    just before -> (summary, rounds launched, host ms a round split into
    scheduler and assembly / program call / fetch wait, stats before and
    after). Each round's host time is taken around ``step()``."""
    from paddle_tpu_torch.serving import run_poisson_load
    step, host = eng.step, [0.0]

    def timed_step():
        t0 = time.perf_counter()
        try:
            return step()
        finally:
            host[0] += time.perf_counter() - t0

    eng.step = timed_step
    before = eng.stats()
    launched0 = eng.launched
    K.reset_launch_counts()
    eng.start()
    try:
        res = run_poisson_load(eng, qps=16.0, prompts=prompts,
                               max_new_tokens=news, seed=SEED,
                               timeout=600.0)
    finally:
        eng.stop()
        del eng.step
    st = eng.stats()
    rounds = eng.launched - launched0
    steps = st["steps"] - before["steps"]
    split = {"round": host[0] * 1e3 / steps}
    for k in ("call", "wait"):
        split[k] = (st["round_host_s"][k] - before["round_host_s"][k]) \
            * 1e3 / steps
    split["scheduler and assembly"] = split["round"] - split["call"] \
        - split["wait"]
    log(f"[operations] load {label}: {res['tokens_per_sec']} tokens/s, "
        f"TTFT p50 {res['ttft_ms_p50']} / p99 {res['ttft_ms_p99']} ms, ITL "
        f"p50 {res['itl_ms_p50']} / p99 {res['itl_ms_p99']} ms; {steps} "
        f"rounds, host {split['round']:.4f} ms a round (scheduler and "
        f"assembly {split['scheduler and assembly']:.4f}, program call "
        f"{split['call']:.4f}, fetch wait {split['wait']:.4f})")
    log(f"  {json.dumps(res)}")
    if res["requests_ok"] != len(prompts) or res["requests_failed"] \
            or res["tokens"] != sum(news):
        fail(f"operations load {label}: {res['requests_failed']} failed, "
             f"{res['tokens']} of {sum(news)} tokens")
    if rounds != steps:
        fail(f"operations load {label}: {rounds} launched rounds in "
             f"{steps} steps")
    if st["graphs"] != before["graphs"]:
        fail(f"operations load {label}: a pad was captured mid-load")
    return res, rounds, split, before, st


def ops_trace_and_metrics(K, A, prompts, news, work):
    """16a: the load traced with a JSONL registry, then untraced. -> the
    rounds of both loads."""
    from paddle_tpu_torch.observability import (MetricsRegistry,
                                                trace_report, tracing)
    from paddle_tpu_torch.serving import ServingMetrics
    L, eid = A.cfg.num_layers, A.engine_id
    reg = MetricsRegistry(rank=0, out_dir=work)
    A.metrics = ServingMetrics(registry=reg, engine=eid)
    path = os.path.join(work, "trace.0.json")
    os.environ["PADDLE_TPU_TRACE_SAMPLE"] = "1"
    tracing.start(path=path, rank=0)
    try:
        res_on, rounds_on, split_on, st0, st1 = ops_load(
            K, A, prompts, news, "traced, metrics JSONL on")
    finally:
        tracing.stop()
        os.environ.pop("PADDLE_TPU_TRACE_SAMPLE")
    check_launches(K, "traced load", rounds_on, L)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("name") == "decode_round"]
    lanes = {}
    for e in events:
        tid = (e.get("args") or {}).get("trace")
        if tid is not None:
            lanes.setdefault(tid, []).append(e["name"])
    rows = trace_report.build_request_rows(trace_report.load_events(path))
    whole = all(n[0] == "enqueue" and n[-1] == "request_done"
                for n in lanes.values())
    log(f"  trace: {len(events)} events, {len(spans)} decode_round spans "
        f"for {rounds_on} rounds, {len(lanes)} request traces (each "
        f"enqueue ... request_done: {whole}), trace_report {len(rows)} "
        f"rows")
    if len(spans) != rounds_on or len(lanes) != len(prompts) or not whole \
            or len(rows) != len(prompts):
        fail("operations: the trace does not hold one decode_round a round "
             "and one whole lifecycle a request")
    reg.flush()
    with open(reg.out_path()) as f:
        last = json.loads(f.read().splitlines()[-1])
    c = last["counters"]
    got = {"ok": c.get(f"serving_requests_total{{engine={eid},status=ok}}"),
           "tokens": c.get(f"serving_tokens_total{{engine={eid}}}"),
           "prefill": c.get("serving_prefill_chunk_tokens_total"
                            f"{{engine={eid}}}")}
    want = {"ok": len(prompts), "tokens": res_on["tokens"],
            "prefill": st1["prefill_chunk_tokens"]
            - st0["prefill_chunk_tokens"]}
    decoded = st1["decode_tokens"] - st0["decode_tokens"]
    log(f"  JSONL line {last['seq']}: {got}; the engine: {want}, {decoded} "
        f"decode tokens + {len(prompts)} first tokens")
    if got != want or got["tokens"] != decoded + len(prompts):
        fail(f"operations: the JSONL counters {got} != the engine's {want}")
    A.metrics = ServingMetrics(registry=None, engine=eid)
    if A.metrics.enabled:
        fail("operations: the untraced run has a metrics registry")
    A.prefix.clear()     # the same prompts must not hit the first run's
    _, rounds_off, split_off, _, _ = ops_load(
        K, A, prompts, news, "untraced, metrics off")
    check_launches(K, "untraced load", rounds_off, L)
    log(f"  tracing and JSONL on minus off: "
        f"{split_on['scheduler and assembly'] - split_off['scheduler and assembly']:.4f}"
        f" ms a round of scheduler and assembly, "
        f"{split_on['round'] - split_off['round']:.4f} ms a round in all")
    A.prefix.clear()
    return rounds_on + rounds_off


def greedy_run(eng, prompt, new, rounds_before, on_migrate=None):
    """``prompt`` alone on ``eng``: ``rounds_before`` rounds (the first
    prefills), then ``on_migrate(req)`` (which moves the request and
    returns the engine it is on) if given, then to the end with
    ``capture_logits`` on -> (tokens, the request's logit rows of the
    captured rounds)."""
    req = eng.submit(prompt, max_new_tokens=new)
    for _ in range(rounds_before):
        eng.step()
    on = eng if on_migrate is None else on_migrate(req)
    on.capture_logits = []
    on.run_until_idle()
    rows = [cap[next(s for s, r in m.items() if r == req.request_id)]
            for m, cap in on.capture_logits]
    on.capture_logits = None
    return req.result(1), np.stack(rows)


def timed_migration(src, dst, req, times, payload):
    """``fleet.migrate_request(src, dst, req)`` with snapshot, release and
    adopt each timed (synchronised) and the payload kept -> outcome."""
    from paddle_tpu_torch.serving.fleet import migrate_request

    def timed(name, fn):
        def run(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            times[name] = (time.perf_counter() - t0) * 1e3
            if name == "snapshot_kv":
                payload.extend(out)
            return out
        return run

    src.snapshot_kv = timed("snapshot_kv", src.snapshot_kv)
    src.release_request = timed("release_request", src.release_request)
    dst.adopt_request = timed("adopt_request", dst.adopt_request)
    try:
        return migrate_request(src, dst, req)
    finally:
        del src.snapshot_kv, src.release_request, dst.adopt_request


def lone_migration(tag, A, B, vocab, rounds_before=8, new=24):
    """16b / 16g: a 200-token request alone on A for ``rounds_before``
    rounds (the bucketed engine's first round prefills and decodes) moves
    to B (B's snapshot equals A's payload bit for bit); its
    tokens and logit rows on B against the same request run unmigrated on
    A (bit-equal). -> the payload's size and the steps' ms."""
    prompt = np.random.RandomState(SEED + 30).randint(
        1, vocab, size=200).tolist()
    times, payload, snap = {}, [], []

    def migrate(req):
        outcome = timed_migration(A, B, req, times, payload)
        if outcome != "migrated":
            fail(f"operations {tag}: migrate_request -> {outcome}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snap.extend(B.snapshot_kv(req))
        times["second snapshot_kv (on B)"] = (time.perf_counter() - t0) * 1e3
        return B

    toks, rows = greedy_run(A, prompt, new, rounds_before, migrate)
    A.prefix.clear()     # the reference prefills as the first run did
    ref_toks, ref_rows = greedy_run(A, prompt, new, rounds_before)
    ks, vs, length = payload
    same_kv = snap[2] == length and all(
        torch.equal(a, b) for a, b in zip(ks + vs, snap[0] + snap[1]))
    nbytes = 2 * sum(k.numel() * k.element_size() for k in ks)
    L, KVH, Dh = len(ks), ks[0].shape[1], ks[0].shape[2]
    same_rows = rows.shape == ref_rows.shape \
        and np.array_equal(rows, ref_rows)
    diff = float(np.abs(rows - ref_rows).max()) \
        if rows.shape == ref_rows.shape else float("nan")
    snap_ms, adopt_ms = times["snapshot_kv"], times["adopt_request"]
    log(f"[operations] {tag}: {length} tokens moved, payload {nbytes} bytes "
        f"(2 x {L} layers x {length} x {KVH} x {Dh} x 2 B); snapshot_kv "
        f"{snap_ms:.3f} ms ({nbytes / snap_ms / 1e6:.2f} GB/s), "
        f"release_request {times['release_request']:.3f} ms, adopt_request "
        f"{adopt_ms:.3f} ms ({nbytes / adopt_ms / 1e6:.2f} GB/s); a second "
        f"snapshot_kv (on B, its pinned buffers cached) "
        f"{times['second snapshot_kv (on B)']:.3f} ms")
    log(f"  snapshot on B equals A's payload: {same_kv}; tokens "
        f"{'equal' if toks == ref_toks else 'DIFFER'} over {len(toks)}; "
        f"{rows.shape[0]} continuation rounds' logits bit-equal: "
        f"{same_rows} (largest difference {diff})")
    if not (same_kv and toks == ref_toks and same_rows):
        fail(f"operations {tag}: the migrated request differs from the "
             f"unmigrated one")
    return {"payload_bytes": nbytes, "tokens": length, **times}


def migrate_under_load(K, A, B, model, vocab):
    """16c: 16 requests on A; after 8 rounds 8 active ones move to B and a
    prefilling one is aborted; both engines run to idle. -> its rounds."""
    from paddle_tpu_torch.serving import make_mixed_length_prompts
    from paddle_tpu_torch.serving.fleet import migrate_request
    L = A.cfg.num_layers
    # prompts of at most one chunk: one prompt completes a round
    prompts, news = make_mixed_length_prompts(
        16, (16, 256), vocab, decode_heavy=0.5, max_new_tokens=(32, 32),
        seed=SEED + 40)
    done = []
    a0, b0 = A.launched, B.launched
    K.reset_launch_counts()
    reqs = [A.submit(p, max_new_tokens=n,
                     on_done=lambda r: done.append(r.request_id))
            for p, n in zip(prompts, news)]
    for _ in range(8):
        A.step()
    active = sorted((r for r in A.scheduler.active.values()
                     if r.state == "active"), key=lambda r: r.slot)
    victim = next((r for r in reqs if r.state == "prefilling"), None)
    if len(active) < 8 or victim is None:
        fail(f"operations under load: {len(active)} active after 8 rounds")
    outcomes = [migrate_request(A, B, r) for r in active[:8]]
    pages = list(victim.pages)
    alloc = A.kv.allocator
    aborted = A.abort_request(victim)
    freed = victim.slot is None and not victim.pages and all(
        alloc.refcount(p) == 0 for p in pages)
    again = A.abort_request(victim)
    while A.scheduler.has_work() or B.scheduler.has_work():
        for eng in (A, B):
            if eng.scheduler.has_work():
                eng.step()
    rounds = (A.launched - a0) + (B.launched - b0)
    check_launches(K, "migration and abort under load", rounds, L)
    short = [r.request_id for r, n in zip(reqs, news)
             if r is not victim and len(r.result(1)) != n]
    log(f"[operations] under load: migrations {outcomes}; aborted a "
        f"prefilling request: {aborted} (slot freed, its {len(pages)} "
        f"pages at refcount 0: {freed}; a second abort refused: "
        f"{not again}; on_done fired for it: {victim.request_id in done}); "
        f"{len(done)} requests done; A {A.launched - a0} rounds, B "
        f"{B.launched - b0}")
    if outcomes != ["migrated"] * 8 or not aborted or not freed or again \
            or victim.request_id in done or short or len(done) != 15:
        fail("operations under load: a migration, the abort or a request's "
             "tokens went wrong")
    worst, exact, n_tok = 0.0, 0, 0
    for r, p in zip(reqs, prompts):
        if r is victim:
            continue
        out = torch.tensor([p + r.generated], device=model.device)
        e, n, short_by, ok = teacher_forced(model, out, len(p))
        exact, n_tok, worst = exact + e, n_tok + n, max(worst, short_by)
        if not ok:
            fail(f"operations under load: request {r.request_id}'s tokens "
                 f"are not the argmax of a no-cache forward")
    log(f"  teacher-forced: {exact} of {n_tok} tokens the exact argmax, the "
        f"largest shortfall {worst:.4f} (tolerance 2e-2 + 2e-2 x |max|)")
    return rounds


def ab_gate_check(K, pt, model):
    """16f: the measure-only gate keeps the kernel; "xla" raises. -> the
    gate's row."""
    eng = pt.ServingEngine(model, page_size=16, num_pages=64, max_slots=16,
                           prefill_chunk=256, attn_backend="auto",
                           jit=False)
    ab = eng.stats()["attn_ab"]
    K.reset_launch_counts()
    eng.generate(list(range(1, 21)), max_new_tokens=1)
    torch.cuda.synchronize()
    launches = {k: v for k, v in K.launch_counts().items() if v}
    L = model.config.num_layers
    log(f"[operations] gate attn_backend='auto': {ab}; attn_backend "
        f"{eng.attn_backend}; the next round's launches {launches}")
    if eng.attn_backend != "pallas" or ab["xla_ms"] is None \
            or ab["pallas_ms"] is None or launches != {
                "ragged_paged_attention": L, "layer_norm": 2 * L + 1}:
        fail("operations: the gate did not measure both or demoted the "
             "kernel")
    eng.close()
    try:
        pt.ServingEngine(model, page_size=16, num_pages=8,
                         attn_backend="xla")
    except ValueError as e:
        log(f"  attn_backend='xla' on the card raises: {e}")
    else:
        fail("operations: attn_backend='xla' ran on the card")
    return ab


def drain_check(A, B, prompts, news, work):
    """16d: a drain with a 30 s deadline under 36 requests, then a zero
    deadline on a fresh load. -> the drain's ms."""
    from paddle_tpu_torch.observability import MetricsRegistry
    from paddle_tpu_torch.serving import EngineShuttingDown, ServingMetrics
    reg = MetricsRegistry(rank=1, out_dir=work)
    A.metrics = ServingMetrics(registry=reg, engine=A.engine_id)
    reqs = [A.submit(p, max_new_tokens=n) for p, n in zip(prompts, news)]
    for _ in range(4):
        A.step()
    inflight = list(A.scheduler.active.values())
    queued = list(A.scheduler.waiting)
    t0 = time.perf_counter()
    out = A.shutdown(drain_s=30)
    drain_ms = (time.perf_counter() - t0) * 1e3
    finished = sum(len(r.result(0)) == n for r, n in zip(reqs, news)
                   if r in inflight)
    refused = 0
    for r in queued:
        try:
            r.result(0)
        except EngineShuttingDown:
            refused += 1
    with open(reg.out_path()) as f:
        c = json.loads(f.read().splitlines()[-1])["counters"]
    eid = A.engine_id
    counted = (c.get(f"serving_requests_total{{engine={eid},status=ok}}"),
               c.get(f"serving_requests_total{{engine={eid},"
                     f"status=failed}}"))
    log(f"[operations] drain: shutdown(drain_s=30) after 4 rounds -> {out} "
        f"in {drain_ms:.1f} ms; {finished} of {len(inflight)} in flight "
        f"finished, {refused} of {len(queued)} queued failed with "
        f"EngineShuttingDown; the flushed JSONL's ok / failed {counted}")
    if out["failed_queued"] != len(queued) or out["failed_inflight"] \
            or out["drained_tokens"] <= 0 or finished != len(inflight) \
            or refused != len(queued) or counted != (len(inflight),
                                                     len(queued)):
        fail("operations: the drain lost or miscounted a request")
    for p, n in zip(prompts, news):
        B.submit(p, max_new_tokens=n)
    for _ in range(2):
        B.step()
    inflight = list(B.scheduler.active.values())
    out0 = B.shutdown(drain_s=0)
    named = 0
    for r in inflight:
        try:
            r.result(0)
        except EngineShuttingDown as e:
            named += "drain deadline" in str(e)
    log(f"  shutdown(drain_s=0) -> {out0}; {named} of {len(inflight)} in "
        f"flight failed naming the deadline")
    if not inflight or out0["failed_inflight"] < len(inflight) \
            or named != len(inflight):
        fail("operations: the zero-deadline drain did not fail the "
             "in-flight requests")
    return drain_ms


SIGTERM_TOKENS = 64


def sigterm_child():
    """``chip_smoke.py --sigterm-child``: a 2-layer model at ``gpt_1p3b``
    widths, ``install_sigterm``, one request stepped to its first token,
    then ``STARTED`` on stdout; on SIGTERM the drain finishes the request
    (its ``on_done`` prints its tokens) and the process exits 75."""
    import paddle_tpu_torch as pt
    cfg = pt.gpt_1p3b(dropout=0.0)
    cfg.num_layers = 2
    model = pt.GPTForCausalLM(cfg, dtype=torch.bfloat16, seed=SEED)
    eng = pt.ServingEngine(model, page_size=16, num_pages=64, max_slots=4,
                           prefill_chunk=256, jit=True)
    if not eng.install_sigterm(drain_s=60):
        return 3
    prompt = np.random.RandomState(SEED + 50).randint(
        1, cfg.vocab_size, size=64).tolist()

    def done(r):
        print(json.dumps({"tokens": r.generated, "state": r.state,
                          "draining": eng._draining}), flush=True)

    req = eng.submit(prompt, max_new_tokens=SIGTERM_TOKENS, on_done=done)
    while not req.generated:
        eng.step()
    print("STARTED", flush=True)
    while True:            # the drain runs on the watcher thread
        time.sleep(0.05)


def sigterm_check():
    """16e: SIGTERM to the child -> exit 75 with the complete tokens. ->
    ms from the signal to the exit."""
    import signal as _signal
    child = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                              "--sigterm-child"], cwd=HERE,
                             stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        for line in child.stdout:
            if line.strip() == "STARTED":
                break
        else:
            fail(f"operations: the SIGTERM child exited {child.wait()} "
                 f"before its request started")
        t1 = time.perf_counter()
        child.send_signal(_signal.SIGTERM)
        rest, _ = child.communicate(timeout=120)
        t2 = time.perf_counter()
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    rc = child.returncode
    outs = [json.loads(x) for x in rest.splitlines() if x.startswith("{")]
    log(f"[operations] SIGTERM child: ready in {t1 - t0:.2f} s, exit {rc} "
        f"{(t2 - t1) * 1e3:.1f} ms after the signal; on_done: "
        f"{[(len(o['tokens']), o['state'], o['draining']) for o in outs]}")
    if rc != 75 or len(outs) != 1 \
            or len(outs[0]["tokens"]) != SIGTERM_TOKENS \
            or outs[0]["state"] != "finished" or not outs[0]["draining"]:
        fail(f"operations: the SIGTERM child exited {rc} with {outs}")
    return (t2 - t1) * 1e3


def bucketed_migration(K, pt):
    """16g: a lone migration on the bucketed engine (2 layers at full
    width, RMSNorm), launches exact over both engines. -> its numbers and
    launches."""
    cfg = pt.gpt_1p3b(use_rms_norm=True, dropout=0.0)
    cfg.num_layers = L = 2
    model = pt.GPTForCausalLM(cfg, dtype=torch.bfloat16, seed=SEED)
    kw = dict(page_size=16, num_pages=256, max_slots=16, prefill_chunk=None,
              ragged=False, jit=True)
    GA = pt.ServingEngine(model, engine_id="GA", **kw)
    GB = pt.ServingEngine(model, engine_id="GB", **kw)

    def runs():
        # forwards of each kind, a capture's warm-up run counted
        out = {}
        for eng in (GA, GB):
            for k, v in eng.stats()["bucketed_launches"].items():
                out[k] = out.get(k, 0) + v + sum(
                    1 for key, prog in eng._rounds._progs.items()
                    if key[0] == k and prog.captured is not None)
        return out

    K.reset_launch_counts()
    before = runs()
    numbers = lone_migration("bucketed lone migration", GA, GB,
                             cfg.vocab_size)
    torch.cuda.synchronize()
    launches = {k: v for k, v in K.launch_counts().items() if v}
    n = {k: v - before[k] for k, v in runs().items()}
    want = {"paged_attention": n["decode"] * L,
            "rms_norm": sum(n.values()) * (2 * L + 1),
            "flash_fwd": n["prefill"] * L}
    log(f"  bucketed: {n} forwards on GA and GB (a capture's warm-up "
        f"counted), launches {launches}")
    if launches != {k: v for k, v in want.items() if v} or n["prefill"] < 2:
        fail(f"operations bucketed: launches {launches} != {want}")
    GA.close()
    GB.close()
    return numbers, launches


def operations_phase(pt, K):
    """Phase 16 (module docstring) -> its numbers and the launches it
    adds to the kernel entries."""
    import tempfile
    cfg = pt.gpt_1p3b(dropout=0.0)
    model = pt.GPTForCausalLM(cfg, dtype=torch.bfloat16, seed=SEED)
    L = cfg.num_layers
    A = pt.ServingEngine(model, engine_id="A", **OPS_ENGINE)
    B = pt.ServingEngine(model, engine_id="B", **OPS_ENGINE)
    for eng in (A, B):
        eng.warm_ragged()
        count_rounds(eng)
    log(f"[operations] gpt_1p3b bf16, engines A and B "
        f"({A.kv.nbytes() / 1e9:.2f} GB of KV each, {A.stats()['graphs']} "
        f"graphs each); A's gate at construction: {A.stats()['attn_ab']}")
    prompts, news = phase3_load(cfg.vocab_size)
    out = {}
    with tempfile.TemporaryDirectory() as work:
        rounds_a = ops_trace_and_metrics(K, A, prompts, news, work)
        # the prefill round, then 8 decode rounds
        out["migration"] = lone_migration("lone migration", A, B,
                                          cfg.vocab_size, rounds_before=9)
        rounds_c = migrate_under_load(K, A, B, model, cfg.vocab_size)
        out["gate"] = ab_gate_check(K, pt, model)
        out["drain_ms"] = drain_check(A, B, prompts, news, work)
    del A, B, model
    gc.collect()
    torch.cuda.empty_cache()
    out["sigterm_exit_ms"] = sigterm_check()
    out["bucketed_migration"], g_launches = bucketed_migration(K, pt)
    gc.collect()
    torch.cuda.empty_cache()
    rounds = rounds_a + rounds_c
    out["launches"] = {"ragged_paged_attention": rounds * L,
                       "layer_norm": rounds * (2 * L + 1), **g_launches}
    return out


# -------------------------------------------- other models (phases 17-21)
def cross_inputs(B, Sq, Sk, H, D, dtype, seed):
    """q and dO [B, Sq, H, D], k and v [B, Sk, H, D] (the decoder's
    cross-attention: separate projections, contiguous)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn(B, Sq, H, D, device="cuda", generator=g).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(B, Sk, H, D, device="cuda", generator=g).to(dtype)
            for _ in range(2))
    return q, k, v, do


def flash_work(B, Sq, Sk, H, D, causal, el=2):
    """(bytes, operations) of the flash forward, dQ and dK/dV at one
    shape: each input read once and each output written once (lse and
    delta f32), and 4 / 6 / 8 multiply-adds x 2 per (query, key) pair
    kept a head dim."""
    q_b, kv_b = B * Sq * H * D * el, B * Sk * H * D * el
    rows = B * H * Sq * 4
    pairs = B * H * (sum(min(i + 1, Sk) for i in range(Sq)) if causal
                     else Sq * Sk)
    return {"flash_fwd": (2 * q_b + 2 * kv_b + rows, 4 * pairs * D),
            "flash_bwd_dq": (3 * q_b + 2 * kv_b + 2 * rows, 6 * pairs * D),
            "flash_bwd_dkv": (2 * q_b + 4 * kv_b + 2 * rows, 8 * pairs * D)}


# (B, Sq, Sk, H, D): BERT-base's encoder at S 512 and around the 64- and
# 128-row tiles at head dim 64, the seq2seq copy task's cross-attention
# (D 16) and a D 32 cross-attention, every one in the DP = 64 tiles
MODEL_FLASH_SHAPES = [(2, 512, 512, 12, 64), (2, 1, 1, 12, 64),
                      (2, 129, 129, 12, 64), (2, 1000, 1000, 12, 64),
                      (4, 7, 11, 4, 16), (2, 300, 77, 4, 32)]


def flash_timing(K, tag, B, S, H, D, seed):
    """The flash forward, dQ and dK/dV at ``[B, S, H, D]`` bf16
    non-causal: held against their plain versions with phase 6's limits,
    then timed beside their bounds, their plain versions and
    ``F.scaled_dot_product_attention``'s forward / backward (the library
    call, timed here only). -> {kernel: {ms, plain_ms, bound_ms, bound_by,
    library_ms, max_abs_err}}"""
    scale = 1.0 / math.sqrt(D)
    q, k, v, do = cross_inputs(B, S, S, H, D, torch.bfloat16, seed)
    errs = check_flash(K, f"bf16 [{B}, {S}, {H}, {D}] full", q, k, v, do,
                       scale, False, FLASH_BF16_TOL, FLASH_BF16_NORM_TOL)
    o, lse = K.flash_fwd(q, k, v, scale, False)
    delta = K.flash_delta(o, do)
    bargs = lambda: [_bhsd(x) for x in (q, k, v, do)] + [  # noqa: E731
        lse.reshape(B * H, S), delta.reshape(B * H, S), scale, False]
    kern = {"flash_fwd": lambda: K.flash_fwd(q, k, v, scale, False),
            "flash_bwd_dq": lambda: K.flash_bwd_dq(q, k, v, do, lse, delta,
                                                   scale, False),
            "flash_bwd_dkv": lambda: K.flash_bwd_dkv(q, k, v, do, lse,
                                                     delta, scale, False)}
    plain = {"flash_fwd": lambda: K.flash_fwd_reference(
        _bhsd(q), _bhsd(k), _bhsd(v), scale, False),
        "flash_bwd_dq": lambda: K.flash_bwd_dq_reference(*bargs()),
        "flash_bwd_dkv": lambda: K.flash_bwd_dkv_reference(*bargs())}
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ot = sdpa(qt, kt, vt)
    lib_fwd, _, _ = time_ms(lambda: sdpa(qt, kt, vt))
    lib_bwd, _, _ = time_ms(lambda: torch.autograd.grad(
        ot, (qt, kt, vt), do.transpose(1, 2), retain_graph=True))
    work = flash_work(B, S, S, H, D, False)
    out = {}
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        ms, wall, src = time_ms(kern[name])
        plain_ms, _, _ = time_ms(plain[name], iters=3, warmup=1)
        lib = lib_fwd if name == "flash_fwd" else lib_bwd
        nbytes, flops = work[name]
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
        log(f"[{tag}] {name} [{B}, {S}, {H}, {D}] bf16 full: "
            f"kernel {ms:.4f} ms ({src}; {wall:.4f} ms per call with "
            f"launch) plain {plain_ms:.4f} ms library {lib:.4f} ms bound "
            f"{b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP) = {100 * b_ms / ms:.1f}% of bound")
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": lib,
                     "max_abs_err": errs[name]}
    del q, k, v, do, o, lse, delta, qt, kt, vt, ot
    torch.cuda.empty_cache()
    return out


def layer_norm_timing(K, tag, rows, H, dtype, eps, seed):
    """LayerNorm at ``[rows, H]`` in ``dtype``: held against its plain
    version (f32 within 1e-4, bf16 within 2e-2), then timed beside its
    bound, its plain version and ``F.layer_norm`` (timed here only).
    -> {ms, plain_ms, bound_ms, bound_by, library_ms, max_abs_err}"""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(rows, H, device="cuda", generator=g) * 2 + 1).to(dtype)
    w = (1 + 0.1 * torch.randn(H, device="cuda", generator=g)).to(dtype)
    b = (0.1 * torch.randn(H, device="cuda", generator=g)).to(dtype)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    name = f"layer_norm [{rows}, {H}] {str(dtype)[6:]}"
    err = check_close(name, K.layer_norm(x, w, b, eps),
                      K.layer_norm_reference(x, w, b, eps), tol, tol)
    ms, wall, src = time_ms(lambda: K.layer_norm(x, w, b, eps))
    plain_ms, _, _ = time_ms(lambda: K.layer_norm_reference(x, w, b, eps))
    lib_ms, _, _ = time_ms(lambda: torch.nn.functional.layer_norm(
        x, (H,), w, b, eps))
    el = x.element_size()
    b_ms, b_by = bound(2 * x.numel() * el + 2 * H * el, 8 * x.numel(),
                       F32_FLOPS_PER_S)
    log(f"[{tag}] {name}: kernel {ms:.4f} ms ({src}; {wall:.4f} ms per "
        f"call with launch) plain {plain_ms:.4f} ms F.layer_norm "
        f"{lib_ms:.4f} ms bound {b_ms:.4f} ms ({b_by})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms, "max_abs_err": err}


def models_kernel_parity(K):
    """Phase 17: the kernels at the other models' shapes against their
    plain versions — the flash trio (:data:`MODEL_FLASH_SHAPES`, f32
    within 1e-4 and bf16 within phase 6's limits, causal and not), the
    autograd of ``flash_attention_bshd`` at BERT's [2, 512, 12, 64] f32
    non-causal against autograd through the plain chain, LayerNorm at
    [8192, 768] (f32 and bf16, epsilon 1e-12 and 1e-5), and fused AdamW's
    master mode over f16 parameters (each parameter exactly its new
    master rounded to f16). Then the flash trio at BERT-base's training
    shape [16, 512, 12, 64] bf16 non-causal and LayerNorm at [8192, 768]
    bf16, timed beside their bounds, plain versions and library calls.
    -> {kernel: the numbers it adds to its JSON entry}"""
    worst = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for B, Sq, Sk, H, D in MODEL_FLASH_SHAPES:
        for dt, tol, norm_tol in ((torch.float32, 1e-4, None),
                                  (torch.bfloat16, FLASH_BF16_TOL,
                                   FLASH_BF16_NORM_TOL)):
            for causal in (False, True):
                q, k, v, do = cross_inputs(B, Sq, Sk, H, D, dt,
                                           seed=Sq + Sk + D)
                tag = (f"{str(dt)[6:]} [{B}, {Sq}, {H}, {D}] Sk={Sk} "
                       f"{'causal' if causal else 'full'}")
                errs = check_flash(K, tag, q, k, v, do, 1.0 / math.sqrt(D),
                                   causal, tol, norm_tol)
                for name, e in errs.items():
                    worst[name] = max(worst[name], e)
    # autograd through the kernels at BERT's shape, non-causal, f32
    q, k, v, do = cross_inputs(2, 512, 512, 12, 64, torch.float32, 17)
    qkv = [x.requires_grad_(True) for x in (q, k, v)]
    got = torch.autograd.grad((K.flash_attention_bshd(*qkv, causal=False)
                               * do).sum(), qkv)
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k) / 8.0
    o = torch.einsum("bhqk,bkhd->bqhd", sc.softmax(-1), v)
    want = torch.autograd.grad((o * do).sum(), qkv)
    for name, a, b in zip("qkv", got, want):
        check_close(f"flash_attention_bshd autograd d{name} vs plain chain "
                    f"(f32 [2, 512, 12, 64] full)", a, b, 1e-4, 1e-4)
    del q, k, v, do, qkv, got, want, sc, o
    # LayerNorm at BERT's width, both epsilons
    g = torch.Generator(device="cuda").manual_seed(18)
    ln_err = 0.0
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        x = (torch.randn(8192, 768, device="cuda", generator=g) * 2
             + 1).to(dt)
        w = (1 + 0.1 * torch.randn(768, device="cuda", generator=g)).to(dt)
        b = (0.1 * torch.randn(768, device="cuda", generator=g)).to(dt)
        for eps in (1e-12, 1e-5):
            e = check_close(f"layer_norm [8192, 768] {str(dt)[6:]} "
                            f"eps={eps:g}", K.layer_norm(x, w, b, eps),
                            K.layer_norm_reference(x, w, b, eps), tol, tol)
            if dt == torch.bfloat16:
                ln_err = max(ln_err, e)
    # fused AdamW master mode over f16 parameters (BERT's sizes)
    shapes = [(30522, 768), (768, 3072), (3072,), (768,), (3,)]
    params = [(0.05 * torch.randn(s, device="cuda", generator=g)).half()
              for s in shapes]
    ws = [p.float() for p in params]
    gs = [(1e-3 * torch.randn(s, device="cuda", generator=g)).half()
          for s in shapes]
    ms_ = [1e-4 * torch.randn(s, device="cuda", generator=g) for s in shapes]
    vs_ = [1e-6 * torch.rand(s, device="cuda", generator=g) for s in shapes]
    n = len(shapes)
    c1, c2 = 1 / (1 - 0.9 ** 5), 1 / (1 - 0.999 ** 5)
    want = [K.fused_adamw_reference(w, gr, m, v, 1e-4, 0.9, 0.999, 1e-8,
                                    0.01, c1, c2)
            for w, gr, m, v in zip(ws, gs, ms_, vs_)]
    K.fused_adamw(ws, gs, ms_, vs_, [1e-4] * n, 0.9, 0.999, 1e-8,
                  [0.01] * n, [c1] * n, [c2] * n, params=params)
    torch.cuda.synchronize()
    f16_err = 0.0
    for (w2, m2, v2), w, m, v, p in zip(want, ws, ms_, vs_, params):
        tag = f"{tuple(w.shape)}"
        f16_err = max(f16_err,
                      check_close(f"fused_adamw f16 master w {tag}", w, w2,
                                  1e-6, 1e-6),
                      check_close(f"fused_adamw f16 master m {tag}", m, m2,
                                  1e-6, 1e-6),
                      check_close(f"fused_adamw f16 master v {tag}", v, v2,
                                  1e-6, 1e-6))
        if p.dtype != torch.float16 or not torch.equal(p, w.half()):
            fail(f"fused_adamw f16 master mode: the parameter {tag} is not "
                 f"its new master rounded to f16")
    log(f"  fused_adamw f16 master mode: {n} tensors, each f16 parameter "
        f"exactly its new f32 master rounded; max abs err {f16_err:.3e}")
    del params, ws, gs, ms_, vs_, want
    torch.cuda.empty_cache()
    out = {name: {"d64_max_abs_err": e} for name, e in worst.items()}
    out["layer_norm"] = {"h768_max_abs_err": ln_err}
    out["fused_adamw"] = {"f16_master_max_abs_err": f16_err}
    # timing at BERT-base's training shape
    for name, t in flash_timing(K, "models timing", 16, 512, 12, 64,
                                19).items():
        out[name].update({f"d64_{k}": v for k, v in t.items()
                          if k != "max_abs_err"})
        out[name]["d64_max_abs_err"] = max(out[name]["d64_max_abs_err"],
                                           t["max_abs_err"])
    t = layer_norm_timing(K, "models timing", 8192, 768, torch.bfloat16,
                          1e-12, 18)
    out["layer_norm"].update({f"h768_{k}": v for k, v in t.items()
                              if k != "max_abs_err"})
    torch.cuda.empty_cache()
    return out


def timed_steps(step, warmup, steps):
    """``warmup`` calls of ``step`` (each returns its loss as a float),
    then ``steps`` timed ones on the host clock with the launch counters
    zeroed just before them. -> (losses, step ms, launch counts, peak
    bytes of the timed steps)"""
    from paddle_tpu_torch.ops import kernels as K
    losses = [step() for _ in range(warmup)]
    torch.cuda.synchronize()
    gc.collect()             # earlier phases' garbage is not this peak's
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return losses, times, K.launch_counts(), torch.cuda.max_memory_allocated()


def check_training(tag, losses, warmup, launches, want, falls="last"):
    """Fails unless the losses are finite and fall and the launches are
    exactly ``want`` (zero for every kernel it does not name). ``falls``:
    ``"last"`` holds the last loss below the first, ``"early"`` the lowest
    of steps 1-3 below step 0's (a run whose later steps are chaotic)."""
    log(f"  losses: " + " ".join(f"{x:.4f}" for x in losses)
        + f" (first {warmup} are warm-up)")
    fell = losses[-1] < losses[0] if falls == "last" else \
        min(losses[1:4]) < losses[0]
    if not all(math.isfinite(x) for x in losses) or not fell:
        fail(f"{tag}: losses not finite or not falling ({falls}): "
             f"{losses}")
    full = {name: 0 for name in launches}
    full.update(want)
    log(f"  launches over the timed steps: {launches}")
    if launches != full:
        fail(f"{tag}: kernel launches {launches} != {full}")


def report_profile(tag, step):
    """Logs one call of ``step`` under ``torch.profiler``: device time by
    kernel family, the largest kernels and the busy share (the union of
    device intervals over the host time)."""
    wall_ms, busy_ms, families, top, _ = profile_train_step(step)
    total = sum(families.values())
    log(f"[{tag} profile] one step under torch.profiler: {wall_ms:.2f} ms "
        f"on the host clock; device busy {busy_ms:.2f} ms (union of device "
        f"intervals; {total:.2f} ms summed) = "
        f"{100 * busy_ms / wall_ms:.1f}% busy")
    for fam, ms in sorted(families.items(), key=lambda kv: -kv[1]):
        log(f"  {fam}: {ms:.3f} ms per step "
            f"({100 * ms / total:.1f}% of summed device time)")
    for (fam, name), ms in top:
        log(f"    {ms:.3f} ms per step  [{fam}] {name[:100]}")


def lenet_build(pt, B=64):
    """``bench.py:379-397``'s LeNet step: B 64 x 1 x 28 x 28 f32 from numpy
    seed 0, ``Adam(1e-3)``, cross-entropy -> (model, optimizer, None, the
    step function returning the loss tensor, its arguments)."""
    F = pt.nn.functional
    model = pt.LeNet(seed=SEED)
    opt = pt.Adam(learning_rate=1e-3, parameters=model.parameters())
    rng = np.random.RandomState(SEED)
    x = torch.from_numpy(rng.randn(B, 1, 28, 28).astype(np.float32)).cuda()
    y = torch.from_numpy(rng.randint(0, 10, B)).cuda()

    def train_step(xb, yb):
        loss = F.cross_entropy(model(xb), yb)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    return model, opt, None, train_step, (x, y)


def lenet_phase(pt, warmup=5, steps=30, B=64):
    """Phase 18: LeNet as ``bench.py:379-397`` trains it
    (:func:`lenet_build`), 5 warm-up and 30 timed steps, each ending in
    ``loss.item()``: steps/s on the host clock, falling losses, one AdamW
    launch a step and nothing else."""
    _, _, _, train_step, args = lenet_build(pt, B)
    log(f"[lenet] LeNet f32, B={B} x 1 x 28 x 28, Adam(1e-3), {warmup} "
        f"warm-up and {steps} timed steps")
    losses, times, launches, peak = timed_steps(
        lambda: train_step(*args).item(), warmup, steps)
    check_training("lenet", losses, warmup, launches,
                   {"fused_adamw": steps})
    med = float(np.median(times))
    log("  " + json.dumps({"steps_per_s": 1e3 / med, "step_ms_median": med,
                           "step_ms_min": min(times),
                           "max_memory_allocated_gb": peak / 1e9,
                           "first_loss": losses[0],
                           "last_loss": losses[-1]}))


def update_gaps(names, base, other):
    """-> {group: (relative error, norm ratio)} of the updates ``other``
    against ``base`` over each :func:`_param_group` and over ``all``."""
    acc = {}
    for name, d, e in zip(names, base, other):
        for g in (_param_group(name), "all"):
            v = acc.setdefault(g, [0.0, 0.0, 0.0])
            v[0] += float((e - d).norm()) ** 2
            v[1] += float(d.norm()) ** 2
            v[2] += float(e.norm()) ** 2
    return {g: (math.sqrt(v[0] / v[1]), math.sqrt(v[2] / v[1]))
            for g, v in acc.items()}


def _param_group(name):
    if name.startswith("fc."):
        return "fc"
    return "batch norm" if ".bn" in f".{name}" or "downsample.1" in name \
        else "conv"


def resnet_first_step_f32(pt, x, y):
    """Phase 19's reference: one step of ``resnet50(num_classes=1000,
    seed=SEED)`` in f32 (``Momentum(0.1, 0.9, L2Decay(1e-4))``, no AMP, no
    scaler) on the phase's batch, from its weights rounded to float16
    (the weights the O2 model and its f32 masters start from); then the
    same step from those weights times ``1 + 2^-11 u`` (``u`` uniform in
    [-1, 1], a float16 rounding's size), whose update's distance from the
    first measures how well-conditioned the step is. -> (the weights,
    each parameter's update, the loss, the noisy step's
    :func:`update_gaps`), the first two lists f32 tensors on the card"""
    F = pt.nn.functional
    model = pt.resnet50(num_classes=1000, seed=SEED)
    names = [n for n, _ in model.named_parameters()]
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(p.half().float())
    w0 = [p.detach().clone() for p in model.parameters()]
    g = torch.Generator(device=w0[0].device).manual_seed(SEED + 19)
    noisy = [w * (1 + 2.0 ** -11 * (2 * torch.rand(
        w.shape, device=w.device, generator=g) - 1)) for w in w0]
    updates, losses = [], []
    for start in (w0, noisy):
        with torch.no_grad():
            for p, w in zip(model.parameters(), start):
                p.copy_(w)
        opt = pt.Momentum(0.1, 0.9, parameters=model.parameters(),
                          weight_decay=pt.regularizer.L2Decay(1e-4))
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        updates.append([p.detach() - w for p, w in
                        zip(model.parameters(), start)])
        losses.append(loss.item())
    spread = update_gaps(names, updates[0], updates[1])
    del model, opt, loss, noisy, updates[1]
    free()
    return w0, updates[0], losses[0], spread


def check_first_o2_step(opt, params, loss16, w0, d32, loss32, spread):
    """Phase 19's first O2 float16 step against the f32 step from the same
    (float16-rounded) weights, within float16 limits: the loss within
    1e-2 relative; the update (each f32 master's change) of the whole
    model and of each group (convolutions, batch norms, the classifier)
    within 10% of the f32 update's norm; and the classifier's update
    within 10% of it in direction too. The convolutions' and batch norms'
    directions are not held: at initialisation they are ill-conditioned,
    so only their size is; ``spread`` (the f32 step from weights with a
    float16 rounding's noise, :func:`resnet_first_step_f32`) is printed
    beside them to show it."""
    names = [p.param_name for p in params]
    gaps = update_gaps(names, d32, [opt._master_of(p) - w
                                    for p, w in zip(params, w0)])
    loss_rel = abs(loss16 - loss32) / abs(loss32)
    ok = math.isfinite(loss16) and loss_rel <= 1e-2
    parts = []
    for name, (rel, ratio) in gaps.items():
        ok = ok and abs(ratio - 1) <= 0.1 and (name != "fc" or rel <= 0.1)
        parts.append(f"{name}: norm ratio {ratio:.4f}, relative error "
                     f"{rel:.3e} (the f32 step from weights with 2^-11 "
                     f"noise: {spread[name][1]:.4f}, {spread[name][0]:.3e})")
    log(f"  first O2 f16 step vs f32 from the same weights: loss "
        f"{loss16:.5f} vs {loss32:.5f} (relative {loss_rel:.2e}, tolerance "
        f"1e-2); updates (norm ratio within 10%; the classifier's error "
        f"within 10%): " + "; ".join(parts))
    if not ok:
        fail("resnet: the first O2 float16 step disagrees with f32")


def resnet_phase(pt, warmup=2, steps=10, B=128):
    """Phase 19: ResNet-50 at full depth and width (``resnet50(
    num_classes=1000)``) under AMP O2 float16, BASELINE config 2 on one
    card: B 128 x 3 x 224 x 224 random images and labels from numpy seed
    0, ``decorate(level="O2", dtype="float16")``, ``Momentum(0.1, 0.9,
    weight_decay=L2Decay(1e-4), multi_precision=True)``,
    ``GradScaler(init_loss_scaling=2**15)``; 2 warm-up and 10 timed
    steps. Checks: the first step's loss and parameter updates (its f32
    masters' change) against the same step in f32 from the same weights
    (:func:`resnet_first_step_f32`, :func:`check_first_o2_step`); losses
    finite and
    the lowest of steps 1-3 below step 0's (at lr 0.1 and momentum 0.9 on
    one batch the later steps are chaotic: both tie-gradient rules rise
    again after step 3), every BatchNorm's running statistics finite and
    moved, no hand kernel launched (none is on this path). Prints
    images/s, step ms, peak memory, the scaler's scale and one profiled
    step; then one O1 bf16 step on f32 weights for comparison."""
    F = pt.nn.functional
    rng = np.random.RandomState(SEED)
    x = torch.from_numpy(rng.randn(B, 3, 224, 224).astype(np.float32)).cuda()
    y = torch.from_numpy(rng.randint(0, 1000, B)).cuda()
    w0, d32, loss32, spread = resnet_first_step_f32(pt, x, y)
    t0 = time.perf_counter()
    model = pt.resnet50(num_classes=1000, seed=SEED)
    opt = pt.Momentum(0.1, 0.9, parameters=model.parameters(),
                      weight_decay=pt.regularizer.L2Decay(1e-4),
                      multi_precision=True)
    model, opt = pt.amp.decorate(model, opt, level="O2", dtype="float16")
    scaler = pt.amp.GradScaler(init_loss_scaling=2.0 ** 15)
    n_params = sum(p.numel() for p in model.parameters())
    stats0 = {n: b.detach().float().clone() for n, b in model.named_buffers()}
    torch.cuda.synchronize()
    log(f"[resnet] resnet50 O2 float16: {n_params / 1e6:.3f} M params, "
        f"{len(stats0)} BatchNorm statistics, built in "
        f"{time.perf_counter() - t0:.2f} s; B={B} x 3 x 224 x 224, "
        f"Momentum(0.1, 0.9, L2Decay(1e-4), multi_precision), "
        f"GradScaler(2**15)")

    def step():
        with pt.auto_cast(level="O2", dtype="float16"):
            loss = F.cross_entropy(model(x), y)
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        return loss.item()

    first = step()
    check_first_o2_step(opt, list(model.parameters()), first, w0, d32,
                        loss32, spread)
    del w0, d32
    losses, times, launches, peak = timed_steps(step, warmup - 1, steps)
    losses = [first] + losses
    check_training("resnet", losses, warmup, launches, {}, falls="early")
    if any(p.dtype != torch.float16 for p in model.parameters()):
        fail("resnet: a parameter is not float16 under O2")
    moved = 0
    for name, b in model.named_buffers():
        if not bool(torch.isfinite(b.float()).all()):
            fail(f"resnet: BatchNorm statistic {name} is not finite")
        moved += int(not torch.equal(b.float(), stats0[name]))
    if moved != len(stats0):
        fail(f"resnet: only {moved} of {len(stats0)} running statistics "
             f"moved")
    med = float(np.median(times))
    summary = {"images_per_s": B / med * 1e3, "step_ms_median": med,
               "step_ms_min": min(times),
               "max_memory_allocated_gb": peak / 1e9,
               "loss_scale": float(scaler.get_loss_scaling()),
               "first_loss": losses[0], "last_loss": losses[-1]}
    o2_losses = losses
    log(f"  {len(stats0)} BatchNorm statistics finite and moved; "
        + json.dumps(summary))
    report_profile("resnet", step)
    del model, opt, scaler
    gc.collect()
    torch.cuda.empty_cache()
    # O1 bf16 on f32 weights, for comparison
    model = pt.resnet50(num_classes=1000, seed=SEED)
    opt = pt.Momentum(0.1, 0.9, parameters=model.parameters(),
                      weight_decay=pt.regularizer.L2Decay(1e-4))

    def o1_step():
        with pt.auto_cast(level="O1", dtype="bfloat16"):
            loss = F.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.item()

    losses, times, _, peak = timed_steps(o1_step, 1, 3)
    log(f"[resnet] O1 bf16 on f32 weights, same batch: step ms "
        + " ".join(f"{t:.2f}" for t in times) + f" (median "
        f"{float(np.median(times)):.2f}; {B / float(np.median(times)) * 1e3:.1f}"
        f" images/s), peak {peak / 1e9:.2f} GB, losses "
        + " ".join(f"{v:.4f}" for v in losses))
    del model, opt, x
    gc.collect()
    torch.cuda.empty_cache()
    return summary, o2_losses


def bert_plain_logits(model, ids):
    """The MLM logits of ``model`` (a port ``BertForMaskedLM``, no token
    types, no mask, post-norm GELU layers) by a dense forward in plain
    torch over its own parameters: torch's LayerNorm, attention by
    softmax over all keys, exact GELU."""
    tF = torch.nn.functional
    bert, cfg = model.bert, model.config
    emb = bert.embeddings
    pos = torch.arange(ids.shape[1], device=ids.device)
    h = emb.word_embeddings.weight[ids] + emb.position_embeddings.weight[pos]
    ln = lambda x, m: tF.layer_norm(x, (x.shape[-1],), m.weight,  # noqa
                                    m.bias, m.epsilon)
    lin = lambda x, m: x @ m.weight + m.bias  # noqa: E731
    h = ln(h, emb.layer_norm)
    B, S, E = h.shape
    nh = cfg.num_heads
    for layer in bert.encoder.layers:
        a = layer.self_attn
        q, k, v = (lin(h, p).reshape(B, S, nh, E // nh)
                   for p in (a.q_proj, a.k_proj, a.v_proj))
        sc = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(E // nh)
        o = torch.einsum("bhqk,bkhd->bqhd", sc.softmax(-1), v)
        h = ln(h + lin(o.reshape(B, S, E), a.out_proj), layer.norm1)
        f = lin(tF.gelu(lin(h, layer.linear1)), layer.linear2)
        h = ln(h + f, layer.norm2)
    t = ln(tF.gelu(lin(h, model.transform)), model.layer_norm)
    return lin(t, model.decoder)


def bert_parity(pt, K, layers=2, B=2, S=512):
    """Phase 20a: a 2-layer f32 ``BertForMaskedLM`` at ``bert_base``
    widths on the card; its loss and every gradient against autograd
    through :func:`bert_plain_logits` over the same parameters (as phase
    7 holds the GPT)."""
    cfg = pt.bert_base(dropout=0.0)
    cfg.num_layers = layers
    model = pt.BertForMaskedLM(cfg, seed=SEED + 3).train()
    rng = np.random.RandomState(SEED + 3)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, S))).cuda()
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, S))).cuda()
    params = list(model.parameters())
    names = [p.param_name for p in params]
    want_loss = torch.nn.functional.cross_entropy(
        bert_plain_logits(model, ids).reshape(-1, cfg.vocab_size),
        labels.reshape(-1))
    # the token-type table and the pooler take no part in the MLM loss
    want_grads = torch.autograd.grad(want_loss, params, allow_unused=True)
    K.reset_launch_counts()
    loss = pt.nn.functional.cross_entropy(
        model(ids).reshape(-1, cfg.vocab_size), labels.reshape(-1))
    loss.backward()
    torch.cuda.synchronize()
    launched = K.launch_counts()
    want = {name: 0 for name in launched}
    want.update({"flash_fwd": layers, "flash_bwd_dq": layers,
                 "flash_bwd_dkv": layers, "layer_norm": 2 * layers + 2})
    if launched != want:
        fail(f"bert parity: launches {launched} != {want}")
    check_close("bert loss vs dense plain forward", loss.detach(),
                want_loss.detach(), 1e-5, 1e-5)
    want_max = {n: float(wg.abs().max()) for n, wg in zip(names, want_grads)
                if wg is not None}
    worst, unused, key_bias = 0.0, 0, 0.0
    for name, p, wg in zip(names, params, want_grads):
        if wg is None:
            unused += 1
            if p.grad is not None:
                fail(f"bert parity: {name} got a gradient the plain chain "
                     f"does not give it")
            continue
        if name.endswith("k_proj.bias"):
            # zero in exact arithmetic (a constant added to a row's scores
            # leaves its softmax alone): both sides are rounding noise,
            # held under 1e-4 of the key weight's largest gradient
            ref = want_max[name[:-len("bias")] + "weight"]
            got = float(p.grad.abs().max())
            key_bias = max(key_bias, got / ref, want_max[name] / ref)
            if max(got, want_max[name]) > 1e-4 * ref:
                fail(f"bert parity: {name} {got:.3e} (plain "
                     f"{want_max[name]:.3e}) is not zero against its "
                     f"weight's {ref:.3e}")
            continue
        scale = float(wg.abs().max())
        err = (p.grad - wg).abs()
        worst = max(worst, float(err.max()) / max(scale, 1e-30))
        if not bool((err <= 1e-4 * scale + 1e-3 * wg.abs()).all()) \
                or not bool(torch.isfinite(p.grad).all()):
            fail(f"bert parity: grad of {name} disagrees (max abs err "
                 f"{float(err.max()):.3e}, max |grad| {scale:.3e})")
    log(f"  {len(params) - unused} gradients within 1e-4 x max|grad| + "
        f"1e-3 x |grad| of the plain chain's (worst max-err/max|grad| "
        f"{worst:.3e}; the key biases' at most {key_bias:.3e} of their "
        f"weights'; {unused} tensors outside the loss got none); launches "
        f"{launched}")
    del model, params, want_grads, loss, want_loss
    gc.collect()
    torch.cuda.empty_cache()


def bert_build(pt, B=16, S=512, make_opt=None):
    """Phase 20b's step: ``BertForMaskedLM(bert_base(dropout=0.0))`` built
    in f32 from seed 0, decorated O2 bf16 with ``AdamW(1e-4,
    multi_precision=True)`` (or ``make_opt(model)``), B x S token ids
    and labels from numpy seed 0, no mask -> (model, optimizer, None, the
    step function returning the loss tensor, its arguments)."""
    F = pt.nn.functional
    cfg = pt.bert_base(dropout=0.0)
    V = cfg.vocab_size
    model = pt.BertForMaskedLM(cfg, seed=SEED).train()
    opt = make_opt(model) if make_opt is not None else pt.AdamW(
        learning_rate=1e-4, parameters=model.parameters(),
        multi_precision=True)
    model, opt = pt.amp.decorate(model, opt, level="O2", dtype="bfloat16")
    rng = np.random.RandomState(SEED)
    ids = torch.from_numpy(rng.randint(0, V, (B, S))).cuda()
    labels = torch.from_numpy(rng.randint(0, V, (B, S))).cuda()

    def train_step(x, y):
        with pt.auto_cast(level="O2", dtype="bfloat16"):
            loss = F.cross_entropy(model(x).reshape(-1, V), y.reshape(-1))
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    return model, opt, None, train_step, (ids, labels)


def bert_train(pt, warmup=2, steps=10, B=16, S=512):
    """Phase 20b: ``BertForMaskedLM(bert_base(dropout=0.0))`` at full size
    (12 layers, 768, 12 heads, 3072, vocab 30522), built in f32 from seed
    0, decorated O2 bf16 with ``AdamW(1e-4, multi_precision=True)``; B 16
    x S 512 from numpy seed 0, no attention mask (so the encoder runs the
    flash kernels, non-causal, at head dim 64); 2 warm-up and 10 timed
    steps. Launches exact: per step the flash forward, dQ and dK/dV 12
    each, LayerNorm 26, AdamW 1. Prints step ms, tokens/s, peak memory,
    MFU (``6 N tokens + 12 L B S^2 h`` over 989 TFLOP/s: non-causal
    attention is twice ``bench.py:435``'s causal term) and one profiled
    step. -> (summary, the timed steps' launches)"""
    cfg = pt.bert_base(dropout=0.0)
    t0 = time.perf_counter()
    model, opt, _, train_step, args = bert_build(pt, B, S)
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    log(f"[bert] BertForMaskedLM(bert_base) O2 bf16: {n_params / 1e6:.3f} M "
        f"params, {len(list(model.parameters()))} tensors, built in "
        f"{time.perf_counter() - t0:.2f} s; B={B} S={S}, "
        f"AdamW(1e-4, multi_precision)")

    def step():
        return train_step(*args).item()

    losses, times, launches, peak = timed_steps(step, warmup, steps)
    L = cfg.num_layers
    check_training("bert", losses, warmup, launches, {
        "flash_fwd": steps * L, "flash_bwd_dq": steps * L,
        "flash_bwd_dkv": steps * L, "layer_norm": steps * (2 * L + 2),
        "fused_adamw": steps})
    med = float(np.median(times))
    flops = 6 * n_params * B * S + 12 * L * B * S * S * cfg.hidden_size
    summary = {"step_ms_median": med, "step_ms_min": min(times),
               "tokens_per_s": B * S / med * 1e3,
               "bert_train_step_mfu": flops / (med / 1e3) / BF16_FLOPS_PER_S,
               "model_tflop_per_step": flops / 1e12,
               "max_memory_allocated_gb": peak / 1e9,
               "first_loss": losses[0], "last_loss": losses[-1]}
    log("  " + json.dumps(summary))
    report_profile("bert", step)
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return summary, launches


def bert_classify(pt, K, B=16, S=512):
    """Phase 20c: ``BertForSequenceClassification(bert_base)`` in eval,
    built in bf16: with no mask the encoder runs the flash forward (12
    launches), with an all-ones ``attention_mask`` the plain chain (none);
    the two logits agree within bf16 limits (4e-2 elementwise, 2e-2 on
    the error's norm: the two attention paths round to bf16 at other
    places in each of 12 layers)."""
    cfg = pt.bert_base()
    model = pt.BertForSequenceClassification(cfg, seed=SEED + 4,
                                             dtype=torch.bfloat16).eval()
    rng = np.random.RandomState(SEED + 4)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, S))).cuda()
    with torch.no_grad():
        K.reset_launch_counts()
        flash = model(ids)
        torch.cuda.synchronize()
        n_flash = K.launch_counts()["flash_fwd"]
        K.reset_launch_counts()
        plain = model(ids, attention_mask=torch.ones_like(ids))
        torch.cuda.synchronize()
        n_plain = K.launch_counts()["flash_fwd"]
    if (n_flash, n_plain) != (12, 0):
        fail(f"bert classify: flash forward launches {n_flash} unmasked, "
             f"{n_plain} masked; 12 and 0 expected")
    check_close("bert classify logits, flash vs masked plain chain (bf16)",
                flash, plain, 4e-2, 4e-2, 2e-2)
    log(f"  logits {tuple(flash.shape)}; flash forward launches 12 "
        f"unmasked, 0 with the mask")
    del model
    torch.cuda.empty_cache()


def seq2seq_phase(pt, steps=120, B=32, S=6, vocab=16):
    """Phase 21: the copy task of ``tests/test_models.py:216-260`` on the
    card — vocab 16, d_model 64, nhead 4 (head dim 16), one encoder and
    one decoder layer, ``Adam(2e-3)``, B 32 x S 6 from numpy seed 0, 120
    steps. The loss must end under 0.1 x the first and ``translate`` must
    reproduce at least 90% of the first 4 rows' tokens; per training step
    the flash trio launches exactly twice each (the encoder's
    self-attention and the cross-attention, Sq 7 over Sk 6; the decoder's
    masked self-attention takes the plain chain), LayerNorm 5 times and
    AdamW once. -> the launches of the training steps"""
    from paddle_tpu_torch.ops import kernels as K
    F = pt.nn.functional
    rng = np.random.RandomState(SEED)
    src = rng.randint(2, vocab, (B, S))
    tgt = np.concatenate([np.full((B, 1), 0), src, np.full((B, 1), 1)], 1)
    model = pt.Seq2SeqTransformer(vocab, vocab, d_model=64, nhead=4,
                                  num_encoder_layers=1, num_decoder_layers=1,
                                  dim_feedforward=128, seed=SEED).train()
    opt = pt.Adam(learning_rate=2e-3, parameters=model.parameters())
    xs, tin, tout = (torch.from_numpy(a).cuda()
                     for a in (src, tgt[:, :-1], tgt[:, 1:]))
    K.reset_launch_counts()
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = F.cross_entropy(model(xs, tin).reshape(-1, vocab),
                               tout.reshape(-1))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    train_s = time.perf_counter() - t0
    launches = K.launch_counts()
    model.eval()
    got = model.translate(xs[:4], max_new_tokens=S + 1).cpu().numpy()[:, :S]
    acc = float((got == src[:4]).mean())
    log(f"[seq2seq] copy task, {steps} Adam steps in {train_s:.2f} s "
        f"({1e3 * train_s / steps:.2f} ms a step): loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; translate reproduces {100 * acc:.1f}% of the "
        f"source tokens; launches {launches}")
    if not losses[-1] < 0.1 * losses[0]:
        fail(f"seq2seq: loss {losses[-1]} not under 0.1 x {losses[0]}")
    if acc <= 0.9:
        fail(f"seq2seq: translate reproduced {acc:.3f} of the tokens")
    want = {name: 0 for name in launches}
    want.update({"flash_fwd": 2 * steps, "flash_bwd_dq": 2 * steps,
                 "flash_bwd_dkv": 2 * steps, "layer_norm": 5 * steps,
                 "fused_adamw": steps})
    if launches != want:
        fail(f"seq2seq: kernel launches {launches} != {want}")
    del model, opt
    torch.cuda.empty_cache()
    return launches


def models_phases(pt, K):
    """Phases 17-21. -> ({kernel: the numbers they add to its JSON
    entry}, phase 19's O2 losses)"""
    log("[models parity] the kernels at the other models' shapes: flash at "
        "head dims 64/32/16 with Sq != Sk, LayerNorm at 768, f16 AdamW "
        "master mode")
    extra = models_kernel_parity(K)
    lenet_phase(pt)
    _, resnet_losses = resnet_phase(pt)
    log("[bert parity] 2-layer f32 BertForMaskedLM at bert_base widths vs "
        "autograd through a dense plain forward")
    bert_parity(pt, K)
    _, bert_launches = bert_train(pt)
    bert_classify(pt, K)
    s2s_launches = seq2seq_phase(pt)
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "layer_norm",
                 "fused_adamw"):
        extra[name].update({"bert_launches": bert_launches[name],
                            "seq2seq_launches": s2s_launches[name]})
    return extra, resnet_losses


# ------------------------------------------------------------ phase 22
# f16 flash checks: the GPT's shape causal, BERT's non-causal
F16_FLASH_SHAPES = [(8, 1024, 16, 128, True), (16, 512, 12, 64, False)]


def flash_f16_parity(K):
    """Phase 22 (f16 flash): the f16 instantiation of the Hopper forward,
    dQ and dK/dV against their plain versions at ``F16_FLASH_SHAPES``
    (phase 6's bf16 limits; f16 rounds finer), q/k/v strided views of one
    fused projection; then the three timed at the GPT's causal shape
    beside their bounds, plain versions and f16
    ``F.scaled_dot_product_attention`` (forward, and its backward for the
    two backward kernels). -> {kernel: its ``f16_*`` numbers}"""
    out = {name: {"f16_max_abs_err": 0.0}
           for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    for B, S, H, D, causal in F16_FLASH_SHAPES:
        _, q, k, v, do = flash_inputs(B, S, H, D, torch.float16, seed=S + D)
        tag = f"f16 [{B}, {S}, {H}, {D}] {'causal' if causal else 'full'}"
        errs = check_flash(K, tag, q, k, v, do, 1.0 / math.sqrt(D), causal,
                           FLASH_BF16_TOL, FLASH_BF16_NORM_TOL)
        for name, e in errs.items():
            out[name]["f16_max_abs_err"] = max(out[name]["f16_max_abs_err"],
                                               e)
    B, S, H, D, causal = F16_FLASH_SHAPES[0]
    scale = 1.0 / math.sqrt(D)
    _, q, k, v, do = flash_inputs(B, S, H, D, torch.float16, seed=23)
    o, lse = K.flash_fwd(q, k, v, scale, causal)
    delta = K.flash_delta(o, do)
    bargs = lambda: [_bhsd(x) for x in (q, k, v, do)] + [  # noqa: E731
        lse.reshape(B * H, S), delta.reshape(B * H, S), scale, causal]
    kern = {"flash_fwd": lambda: K.flash_fwd(q, k, v, scale, causal),
            "flash_bwd_dq": lambda: K.flash_bwd_dq(q, k, v, do, lse, delta,
                                                   scale, causal),
            "flash_bwd_dkv": lambda: K.flash_bwd_dkv(q, k, v, do, lse,
                                                     delta, scale, causal)}
    plain = {"flash_fwd": lambda: K.flash_fwd_reference(
        _bhsd(q), _bhsd(k), _bhsd(v), scale, causal),
        "flash_bwd_dq": lambda: K.flash_bwd_dq_reference(*bargs()),
        "flash_bwd_dkv": lambda: K.flash_bwd_dkv_reference(*bargs())}
    # the bf16 instantiation on the same values, timed in the same call
    qb, kb, vb, dob = (x.bfloat16() for x in (q, k, v, do))
    ob, lseb = K.flash_fwd(qb, kb, vb, scale, causal)
    deltab = K.flash_delta(ob, dob)
    bf16 = {"flash_fwd": lambda: K.flash_fwd(qb, kb, vb, scale, causal),
            "flash_bwd_dq": lambda: K.flash_bwd_dq(
                qb, kb, vb, dob, lseb, deltab, scale, causal),
            "flash_bwd_dkv": lambda: K.flash_bwd_dkv(
                qb, kb, vb, dob, lseb, deltab, scale, causal)}
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ot = sdpa(qt, kt, vt, is_causal=causal)
    lib = {"flash_fwd": time_ms(lambda: sdpa(qt, kt, vt,
                                             is_causal=causal))[0]}
    lib["flash_bwd_dq"] = lib["flash_bwd_dkv"] = time_ms(
        lambda: torch.autograd.grad(ot, (qt, kt, vt), do.transpose(1, 2),
                                    retain_graph=True))[0]
    work = flash_work(B, S, S, H, D, causal)
    for name in kern:
        ms, wall, src = time_ms(kern[name])
        bf_ms, _, _ = time_ms(bf16[name])
        plain_ms, _, _ = time_ms(plain[name], iters=3, warmup=1)
        nbytes, flops = work[name]
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
        log(f"[f16 timing] {name} [{B}, {S}, {H}, {D}] f16 causal: kernel "
            f"{ms:.4f} ms ({src}; {wall:.4f} ms per call with launch; bf16 "
            f"on the same values {bf_ms:.4f} ms) plain {plain_ms:.4f} ms "
            f"library {lib[name]:.4f} ms bound {b_ms:.4f} ms ({b_by}) = "
            f"{100 * b_ms / ms:.1f}% of bound")
        out[name].update({"f16_ms": ms, "f16_plain_ms": plain_ms,
                          "f16_bound_ms": b_ms, "f16_bound_by": b_by,
                          "f16_library_ms": lib[name],
                          "f16_bf16_same_call_ms": bf_ms})
    del q, k, v, do, o, lse, delta, qt, kt, vt, ot, qb, kb, vb, dob, ob
    del lseb, deltab
    torch.cuda.empty_cache()
    return out


def free():
    """Collect what the caller dropped and give the cached blocks back."""
    gc.collect()
    torch.cuda.empty_cache()


def train_run(pt, build, staged, warmup, steps, track=None):
    """One training run of what ``build()`` returns, ``(model, optimizer,
    scheduler or None, step function, its arguments)``: eager, or the step
    through ``pt.jit.to_static(step, capture=(model, optimizer))`` (its
    first call the warm-up step, its second the capture and first replay,
    every later one a replay). Each call ends in ``float(loss)``; the
    scheduler steps after it, outside the staged step. ``warmup`` calls,
    then ``steps`` timed ones with the counters zeroed before them; then
    one profiled call. ``track()`` names a tensor whose mean absolute
    change each timed step records. -> a dict of the run's numbers, its
    model, optimizer and staged step"""
    from paddle_tpu_torch.ops import kernels as K
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model, opt, sched, fn, args = build()
    torch.cuda.synchronize()
    built_s = time.perf_counter() - t0
    step = pt.jit.to_static(fn, capture=(model, opt)) if staged else fn
    lrs, deltas = [], []

    def one():
        before = track().detach().clone() if track is not None else None
        lrs.append(opt.get_lr())
        loss = float(step(*args))
        if sched is not None:
            sched.step()
        if before is not None:
            deltas.append(float((track() - before).abs().mean()))
        return loss

    t0 = time.perf_counter()
    losses = [one() for _ in range(warmup)]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    del lrs[:], deltas[:]
    K.reset_launch_counts()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(one())
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated() - mem0
    reserved = torch.cuda.memory_reserved()
    host_ms, busy_ms, families, top, _ = profile_train_step(one)
    med = float(np.median(times))
    out = {"losses": losses, "times": times, "launches": launches,
           "lrs": lrs, "deltas": deltas, "step_ms_median": med,
           "step_ms_min": min(times), "steps_per_s": 1e3 / med,
           "peak_allocated_gb": peak / 1e9, "reserved_gb": reserved / 1e9,
           "profiled_host_ms": host_ms, "profiled_busy_ms": busy_ms,
           "device_busy_pct": 100 * busy_ms / host_ms,
           "families": families, "top": top, "built_s": built_s,
           "warmup_s": warm_s,
           "model": model, "opt": opt, "step": step}
    if staged:
        out["stats"] = step.stats()
    return out


def summary_of(run, extra=None):
    """The run's numbers for the log: ``busy_of_median_pct`` sets the
    profiled step's device time against the timed steps' median, which
    the profiler's own host cost does not inflate."""
    keys = ("step_ms_median", "step_ms_min", "steps_per_s",
            "peak_allocated_gb", "reserved_gb", "device_busy_pct",
            "profiled_host_ms", "profiled_busy_ms", "warmup_s")
    out = {k: run[k] for k in keys}
    out["busy_of_median_pct"] = min(
        100.0, 100 * run["profiled_busy_ms"] / run["step_ms_median"])
    if "stats" in run:
        out["stats"] = run["stats"]
    out.update(extra or {})
    return out


def host_params(model):
    return [p.detach().cpu() for p in model.parameters()]


def weights_diff(a, b):
    """-> (every tensor equal, the largest absolute difference)"""
    worst = max(float((x.float() - y.float()).abs().max()) for x, y in
                zip(a, b))
    return worst == 0.0, worst


def compare_runs(tag, eager, staged, rerun, loss_tol, weight_tol):
    """The staged run against the eager run from the same weights and
    batches: bit-equal losses and weights pass. Otherwise ``rerun()``
    gives a second eager run; the staged run fails if the two eager runs
    are bit-equal (then the difference is the staging's), and is held
    within ``loss_tol`` / ``weight_tol`` of the first eager run if they
    are not. -> a dict of what was found"""
    d_loss = max(abs(a - b) for a, b in zip(eager["losses"],
                                            staged["losses"]))
    same_w, d_w = weights_diff(eager["weights"], staged["weights"])
    out = {"bit_equal": d_loss == 0.0 and same_w,
           "max_loss_diff": d_loss, "max_weight_diff": d_w}
    if out["bit_equal"]:
        log(f"  [{tag}] staged vs eager: losses and weights bit-equal "
            f"over {len(eager['losses'])} steps")
        return out
    again = rerun()
    e_loss = max(abs(a - b) for a, b in zip(eager["losses"],
                                            again["losses"]))
    e_same, e_w = weights_diff(eager["weights"], again["weights"])
    out.update({"eager_vs_eager_loss_diff": e_loss,
                "eager_vs_eager_weight_diff": e_w})
    log(f"  [{tag}] staged vs eager: losses differ by at most {d_loss:.3e}"
        f", weights by {d_w:.3e}; eager vs eager: {e_loss:.3e} and "
        f"{e_w:.3e} (tolerances {loss_tol:g} and {weight_tol:g})")
    if e_loss == 0.0 and e_same:
        fail(f"{tag}: the staged run differs from the eager run while two "
             f"eager runs are bit-equal")
    if d_loss > loss_tol or d_w > weight_tol:
        fail(f"{tag}: the staged run differs from the eager run by "
             f"{d_loss:.3e} (losses) / {d_w:.3e} (weights)")
    return out


def check_replay_launches(tag, launches, steps, per_step):
    want = {name: 0 for name in launches}
    want.update({k: steps * n for k, n in per_step.items()})
    log(f"  [{tag}] launches over the {steps} replayed steps: {launches}")
    if launches != want:
        fail(f"{tag}: replayed launches {launches} != {want}")


def report_pair(tag, eager, staged, extra=None):
    e, s = summary_of(eager), summary_of(staged, extra)
    log(f"[{tag}] eager:  " + json.dumps(e))
    log(f"[{tag}] staged: " + json.dumps(s))
    log(f"  [{tag}] staged step {s['step_ms_median']:.3f} ms vs eager "
        f"{e['step_ms_median']:.3f} ms "
        f"({e['step_ms_median'] / s['step_ms_median']:.2f}x); device busy "
        f"{s['device_busy_pct']:.1f}% vs {e['device_busy_pct']:.1f}% of the "
        f"profiled step, {s['busy_of_median_pct']:.1f}% vs "
        f"{e['busy_of_median_pct']:.1f}% of the median step")
    total = sum(staged["families"].values())
    log(f"  [{tag}] the staged step's device ms by family: " + ", ".join(
        f"{fam} {ms:.3f} ({100 * ms / total:.1f}%)" for fam, ms in sorted(
            staged["families"].items(), key=lambda kv: -kv[1])))
    return {"eager": e, "staged": s}


def lenet_static(pt, warmup=5, steps=30, B=64):
    """Phase 22a: ``bench.py:379-397``'s LeNet step (f32, B 64, Adam(1e-3))
    eager, and through ``to_static(train_step, capture=(model, opt))``,
    from the same weights and batch; 5 warm-up and 30 timed steps. The
    staged run must equal the eager one bit for bit, or hold within 1e-5
    where a second eager run shows that eager runs differ too; one AdamW
    launch a replayed step and no other kernel."""
    def build():
        return lenet_build(pt, B)

    def run(staged):
        r = train_run(pt, build, staged, warmup, steps)
        r["weights"] = host_params(r["model"])
        return r

    log(f"[to_static lenet] LeNet f32, B={B}, Adam(1e-3): eager, then "
        f"staged; {warmup} warm-up and {steps} timed steps each")
    eager, staged = run(False), run(True)
    cmp = compare_runs("lenet", eager, staged, lambda: run(False), 1e-5,
                       1e-5)
    check_replay_launches("lenet", staged["launches"], steps,
                          {"fused_adamw": 1})
    out = report_pair("to_static lenet", eager, staged, cmp)
    return out, staged["launches"]


def gpt_bench_static(pt, warmup=3, steps=20, B=16, S=512):
    """Phase 22b: ``bench_gpt``'s model (``bench.py:400-437``: vocab 8192,
    hidden 512, 8 layers, 8 heads, S 512, f32 weights) under ``auto_cast``
    O1 bf16 with ``AdamW(1e-4)``, B 16, eager and staged from the same
    weights and batch: 3 warm-up and 20 timed steps. Losses and weights
    as phase 13 holds recompute (within 1e-3), launches a replayed step:
    the flash trio 8 each, LayerNorm 17, AdamW 1; ms a step and MFU by
    ``bench.py:435``'s formula over 989 TFLOP/s."""
    cfg = pt.GPTConfig(vocab_size=8192, hidden_size=512, num_layers=8,
                       num_heads=8, max_seq_len=512, dropout=0.0)
    rng = np.random.RandomState(SEED)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, S))).cuda()
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, S))).cuda()

    def build():
        model = pt.GPTForCausalLM(cfg, seed=SEED).train()
        crit = pt.GPTPretrainingCriterion(cfg)
        opt = pt.AdamW(learning_rate=1e-4, parameters=model.parameters())

        def train_step(x, y):
            with pt.auto_cast(level="O1", dtype="bfloat16"):
                loss = crit(model(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss
        return model, opt, None, train_step, (ids, labels)

    def run(staged):
        r = train_run(pt, build, staged, warmup, steps)
        r["weights"] = host_params(r["model"])
        return r

    log(f"[to_static gpt bench] bench_gpt's model (8192, 512, 8 layers, 8 "
        f"heads), B={B} S={S}, O1 bf16, AdamW(1e-4): eager, then staged; "
        f"{warmup} warm-up and {steps} timed steps each")
    eager, staged = run(False), run(True)
    n_params = sum(w.numel() for w in eager["weights"])
    cmp = compare_runs("gpt bench", eager, staged, lambda: run(False), 1e-3,
                       1e-3)
    L = cfg.num_layers
    check_replay_launches("gpt bench", staged["launches"], steps, {
        "flash_fwd": L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
        "layer_norm": 2 * L + 1, "fused_adamw": 1})
    flops = 6 * n_params * B * S + 6 * L * B * S * S * cfg.hidden_size
    mfu = {k: flops / (r["step_ms_median"] / 1e3) / BF16_FLOPS_PER_S
           for k, r in (("eager_mfu", eager), ("staged_mfu", staged))}
    out = report_pair("to_static gpt bench", eager, staged,
                      dict(cmp, n_params=n_params, **mfu,
                           tokens_per_s=B * S / staged["step_ms_median"]
                           * 1e3))
    log(f"  [gpt bench] MFU staged {100 * mfu['staged_mfu']:.2f}% vs eager "
        f"{100 * mfu['eager_mfu']:.2f}% ({n_params / 1e6:.2f} M params)")
    return out, staged["launches"]


def gpt_o2_static(pt, warmup=2, steps=10, B=8, S=1024):
    """Phase 22c: phase 13's O2 step (``o2_model``: ``gpt_1p3b`` at full
    width and depth, bf16 parameters, f32 masters in AdamW's master mode,
    ``ClipGradByGlobalNorm(1.0)``, ``LinearWarmup(CosineAnnealingDecay)``
    stepped after every step, outside the staged step) at B 8 x S 1024,
    eager then staged from the same weights and batch; 2 warm-up and 10
    timed steps. The lr changes every timed step, so the replays must
    read it from the static AdamW table: each step's mean change of one
    f32 master follows the eager run's within 1%, and the losses equal
    the eager run's within phase 13's 1e-3. Launches a replayed step: the
    flash trio 24 each, LayerNorm 49, AdamW 1. Prints the peak memory
    with the graph pool."""
    cfg = pt.gpt_1p3b(dropout=0.0)
    rng = np.random.RandomState(SEED)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, S))).cuda()
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, S))).cuda()
    held = {}

    def build():
        model, opt, sched = o2_model(pt, cfg)
        crit = pt.GPTPretrainingCriterion(cfg)
        held["master"] = opt._master_of(model.gpt.h[0].attn.qkv_proj.weight)

        def train_step(x, y):
            with pt.auto_cast(level="O2", dtype="bfloat16"):
                loss = crit(model(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss
        return model, opt, sched, train_step, (ids, labels)

    def run(staged):
        r = train_run(pt, build, staged, warmup, steps,
                      track=lambda: held["master"])
        r["weights"] = host_params(r["model"])
        del r["model"], r["opt"], r["step"]
        held.clear()
        free()
        return r

    log(f"[to_static gpt o2] gpt_1p3b O2 bf16 (masters, clip, schedule), "
        f"B={B} S={S}: eager, then staged; {warmup} warm-up and {steps} "
        f"timed steps each")
    eager = run(False)
    staged = run(True)
    cmp = compare_runs("gpt o2", eager, staged, lambda: run(False), 1e-3,
                       1e-2)
    rel = max(abs(a - b) / max(abs(b), 1e-30)
              for a, b in zip(staged["deltas"], eager["deltas"]))
    log("  [gpt o2] lr and mean |change| of h.0.attn.qkv_proj's master a "
        "timed step (staged / eager):")
    for lr, a, b in zip(staged["lrs"], staged["deltas"], eager["deltas"]):
        log(f"    lr {lr:.4e}: {a:.4e} / {b:.4e} ({a / lr:.4f} / "
            f"{b / lr:.4f} of lr)")
    if staged["lrs"] != eager["lrs"] or len(set(staged["lrs"])) < 2:
        fail("gpt o2: the timed steps' lr did not change, or differs")
    if rel > 1e-2:
        fail(f"gpt o2: the staged weights' change a step differs from the "
             f"eager run's by {rel:.3e} (relative): the replays do not "
             f"follow the lr")
    L = cfg.num_layers
    check_replay_launches("gpt o2", staged["launches"], steps, {
        "flash_fwd": L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
        "layer_norm": 2 * L + 1, "fused_adamw": 1})
    n_params = sum(w.numel() for w in eager["weights"])
    flops = train_flops(n_params, B, S, L, cfg.hidden_size)
    mfu = {k: flops / (r["step_ms_median"] / 1e3) / BF16_FLOPS_PER_S
           for k, r in (("eager_mfu", eager), ("staged_mfu", staged))}
    NUMBERS["gpt_o2_staged_ms"] = staged["step_ms_median"]
    out = report_pair("to_static gpt o2", eager, staged,
                      dict(cmp, max_delta_rel_diff=rel, **mfu,
                           tokens_per_s=B * S / staged["step_ms_median"]
                           * 1e3))
    log(f"  [gpt o2] peak allocated with the graph pool "
        f"{staged['peak_allocated_gb']:.2f} GB (eager "
        f"{eager['peak_allocated_gb']:.2f}), reserved "
        f"{staged['reserved_gb']:.2f} GB; fits in 80 GB without recompute")
    return out, staged["launches"]


def bert_static(pt, K, warmup=2, steps=10, B=16, S=512):
    """Phase 22d: phase 20b's BERT-base MLM step (O2 bf16, ``AdamW(1e-4,
    multi_precision)``, B 16 x S 512, no mask) eager then staged from the
    same weights and batch, 2 warm-up and 10 timed steps: losses within
    1e-3, launches a replayed step the flash trio 12 each, LayerNorm 26,
    AdamW 1; the busy share beside the eager step's. Then the fused AdamW
    kernel's master mode over this model's tensors against its plain
    version and timed beside its bound and the library call (phase 14's
    :func:`master_mode_timing`). -> (summary, launches, AdamW numbers)"""
    cfg = pt.bert_base(dropout=0.0)

    def build():
        return bert_build(pt, B, S)

    def run(staged, keep=False):
        r = train_run(pt, build, staged, warmup, steps)
        r["weights"] = host_params(r["model"])
        if not keep:
            del r["model"], r["opt"], r["step"]
            free()
        return r

    log(f"[to_static bert] BertForMaskedLM(bert_base) O2 bf16, B={B} S={S}:"
        f" eager, then staged; {warmup} warm-up and {steps} timed steps "
        f"each")
    eager = run(False)
    staged = run(True, keep=True)
    cmp = compare_runs("bert", eager, staged, lambda: run(False), 1e-3,
                       1e-2)
    L = cfg.num_layers
    check_replay_launches("bert", staged["launches"], steps, {
        "flash_fwd": L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
        "layer_norm": 2 * L + 2, "fused_adamw": 1})
    n_params = sum(w.numel() for w in eager["weights"])
    flops = 6 * n_params * B * S + 12 * L * B * S * S * cfg.hidden_size
    mfu = {k: flops / (r["step_ms_median"] / 1e3) / BF16_FLOPS_PER_S
           for k, r in (("eager_mfu", eager), ("staged_mfu", staged))}
    out = report_pair("to_static bert", eager, staged, dict(
        cmp, **mfu, tokens_per_s=B * S / staged["step_ms_median"] * 1e3))
    model, opt = staged["model"], staged["opt"]
    del staged["model"], staged["opt"], staged["step"]
    free()
    log("[to_static bert] fused_adamw master mode over BERT-base's "
        "tensors, held against the plain version, then timed")
    adam = master_mode_timing(K, model, opt, tag="bert adamw")
    del model, opt
    free()
    return out, staged["launches"], adam


def resnet_static(pt, phase19_losses, warmup=2, steps=10, B=128):
    """Phase 22e: phase 19's ResNet-50 O2 float16 step with its
    ``GradScaler`` through ``to_static``: the capture meets
    ``unscale_``'s ``bool()`` and breaks, exactly one warning is raised,
    and the key runs eagerly. Its losses equal phase 19's eager run from
    the same weights and batch (bit-equal, or within 2e-3 where a second
    eager run shows that eager runs differ too: cuDNN's backward may sum
    in another order), every later call is eager (``stats()``), and a
    ``full_graph=True`` staging of the same step raises at its capture
    and leaves parameters, masters, velocities and the scale as they
    were. Prints steps/s beside phase 19's."""
    F = pt.nn.functional
    rng = np.random.RandomState(SEED)
    x = torch.from_numpy(rng.randn(B, 3, 224, 224).astype(np.float32)).cuda()
    y = torch.from_numpy(rng.randint(0, 1000, B)).cuda()
    model = pt.resnet50(num_classes=1000, seed=SEED)
    opt = pt.Momentum(0.1, 0.9, parameters=model.parameters(),
                      weight_decay=pt.regularizer.L2Decay(1e-4),
                      multi_precision=True)
    model, opt = pt.amp.decorate(model, opt, level="O2", dtype="float16")
    scaler = pt.amp.GradScaler(init_loss_scaling=2.0 ** 15)

    def train_step(xb, yb):
        with pt.auto_cast(level="O2", dtype="float16"):
            loss = F.cross_entropy(model(xb), yb)
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        return loss

    step = pt.jit.to_static(train_step, capture=(model, opt))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        losses, times, launches, peak = timed_steps(
            lambda: float(step(x, y)), warmup, steps)
    breaks = [str(w.message) for w in caught
              if "to_static: falling back to eager" in str(w.message)]
    st = step.stats()
    log(f"[to_static resnet] resnet50 O2 float16 with GradScaler, B={B}: "
        f"{len(breaks)} graph-break warning(s): {breaks[:1]}; stats {st}")
    if len(breaks) != 1 or st["graph_breaks"] != 1 or st["graphs"] != 0:
        fail(f"resnet to_static: {len(breaks)} graph-break warnings, stats "
             f"{st}; exactly one break and no graph expected")
    if st["eager_calls"] != warmup + steps - 1 or st["warmups"] != 1:
        fail(f"resnet to_static: the calls after the break are not eager "
             f"({st})")
    d = max(abs(a - b) for a, b in zip(losses, phase19_losses))
    log("  losses: " + " ".join(f"{v:.4f}" for v in losses)
        + f"; against phase 19's eager run: max diff {d:.3e}")
    if d != 0.0:
        log("  [resnet] not bit-equal: a second eager run, for the spread")
        em = pt.resnet50(num_classes=1000, seed=SEED)
        eo = pt.Momentum(0.1, 0.9, parameters=em.parameters(),
                         weight_decay=pt.regularizer.L2Decay(1e-4),
                         multi_precision=True)
        em, eo = pt.amp.decorate(em, eo, level="O2", dtype="float16")
        es = pt.amp.GradScaler(init_loss_scaling=2.0 ** 15)

        def eager_step():
            with pt.auto_cast(level="O2", dtype="float16"):
                loss = F.cross_entropy(em(x), y)
            es.scale(loss).backward()
            es.step(eo)
            es.update()
            eo.clear_grad()
            return loss.item()

        again, _, _, _ = timed_steps(eager_step, warmup, steps)
        e = max(abs(a - b) for a, b in zip(again, phase19_losses))
        log(f"  eager vs eager (phase 19 and now): max loss diff {e:.3e} "
            f"(tolerance 2e-3)")
        if e == 0.0:
            fail("resnet to_static: the fallback's losses differ from "
                 "phase 19's while two eager runs are bit-equal")
        if d > 2e-3:
            fail(f"resnet to_static: losses differ from phase 19's by {d}")
        del em, eo, es
        free()
    probe = pt.jit.to_static(train_step, capture=(model, opt),
                             full_graph=True)
    probe(x, y)                         # its warm-up: a real step
    torch.cuda.synchronize()
    snap = [t.detach().clone() for t in list(model.parameters())
            + list(opt._master_weights.values())
            + list(opt._accumulators["velocity"].values())]
    scale = scaler._scale
    try:
        probe(x, y)
    except pt.jit.GraphBreak as e:
        log(f"  full_graph=True: the capture raised GraphBreak ({e})")
    else:
        fail("resnet to_static: full_graph=True did not raise")
    torch.cuda.synchronize()
    now = (list(model.parameters()) + list(opt._master_weights.values())
           + list(opt._accumulators["velocity"].values()))
    intact = all(torch.equal(a, b) for a, b in zip(now, snap))
    grads = all(p.grad is None for p in model.parameters())
    log(f"  after the aborted capture: {len(snap)} parameters, masters and "
        f"velocities {'intact' if intact else 'CHANGED'}; .grad "
        f"{'None' if grads else 'SET'}; scale {scaler._scale} (was {scale})")
    if not (intact and grads and scaler._scale == scale):
        fail("resnet to_static: the aborted capture changed the state")
    med = float(np.median(times))
    out = {"steps_per_s": 1e3 / med, "step_ms_median": med,
           "max_memory_allocated_gb": peak / 1e9, "graph_breaks": len(breaks),
           "max_loss_diff_vs_phase19": d, "stats": st}
    log("  " + json.dumps(out))
    del model, opt, scaler, step, probe, snap, now
    free()
    return out


def bert_forward_static(pt, B=16, S=512, calls=4):
    """Phase 22f: ``to_static(model)`` on ``BertForMaskedLM(bert_base)``
    in eval, bf16: the first call eager (its warm-up), the second captures
    one forward graph and replays it, later ones replay; every call's MLM
    logits equal the eager forward's bit for bit, and the replays add the
    captured launches (the flash forward 12, LayerNorm 26 a call)."""
    from paddle_tpu_torch.ops import kernels as K
    cfg = pt.bert_base()
    rng = np.random.RandomState(SEED + 5)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, S))).cuda()
    model = pt.BertForMaskedLM(cfg, seed=SEED + 5,
                               dtype=torch.bfloat16).eval()
    with torch.no_grad():
        want = model(ids)
        staged = pt.jit.to_static(model)
        for i in range(calls):
            if i == 2:
                torch.cuda.synchronize()
                K.reset_launch_counts()
            got = staged(ids)
            if not torch.equal(got, want):
                d = float((got.float() - want.float()).abs().max())
                fail(f"bert forward to_static: call {i} differs from the "
                     f"eager forward by {d}")
        torch.cuda.synchronize()
        launches = K.launch_counts()
        st = staged.forward.stats()
        ms = time_ms(lambda: staged(ids), iters=10)[1]
        eager_ms = time_ms(lambda: model.__class__.forward(model, ids),
                           iters=10)[1]
    L, n = cfg.num_layers, calls - 2
    want_l = {name: 0 for name in launches}
    want_l.update({"flash_fwd": n * L, "layer_norm": n * (2 * L + 2)})
    log(f"[to_static bert forward] eval bf16 B={B} S={S}: logits "
        f"{tuple(want.shape)} bit-equal to the eager forward on {calls} "
        f"calls; stats {st}; launches over {n} replays {launches}; "
        f"{ms:.3f} ms a replayed call vs {eager_ms:.3f} ms eager (CUDA "
        f"events)")
    if st["graphs"] != 1 or st["replays"] != calls - 1 or launches != want_l:
        fail(f"bert forward to_static: stats {st}, launches {launches} != "
             f"{want_l}")
    del model, staged, want
    free()
    return {"replay_ms": ms, "eager_ms": eager_ms}


def static_phases(pt, K, phase19_losses):
    """Phase 22. -> {kernel: the numbers it adds to its JSON entry}"""
    log("[f16 flash] the sm90 kernels' f16 instantiation vs plain at "
        "[8, 1024, 16, 128] causal and [16, 512, 12, 64] full, then timed")
    extra = flash_f16_parity(K)
    parts, lsum = {}, {}
    _, parts["lenet"] = lenet_static(pt)
    _, parts["gpt_bench"] = gpt_bench_static(pt)
    _, parts["gpt_1p3b_o2"] = gpt_o2_static(pt)
    _, parts["bert_o2"], adam = bert_static(pt, K)
    resnet_static(pt, phase19_losses)
    bert_forward_static(pt)
    for part, launches in parts.items():
        for name, n in launches.items():
            lsum.setdefault(name, {})[part] = n
    for name, by_part in lsum.items():
        extra.setdefault(name, {}).update({
            "to_static_launches": sum(by_part.values()),
            "to_static_parts": by_part})
    extra["fused_adamw"].update({f"bert_{k}": v for k, v in adam.items()})
    return extra


# ------------------------------------------------------------- phase 23
# every factory of models/vision_zoo.py and models/vision_zoo2.py:
# (label, factory name, kwargs); InceptionV3 takes 3 x 299 x 299
ZOO_FACTORIES = (
    [(f"vgg{d}{'_bn' if bn else ''}", f"vgg{d}", dict(batch_norm=bn))
     for d in (11, 13, 16, 19) for bn in (False, True)]
    + [(n, n, {}) for n in ("MobileNetV1", "MobileNetV2", "alexnet")]
    + [(f"densenet{d}", f"densenet{d}", {}) for d in (121, 161, 169, 201,
                                                      264)]
    + [(n, n, {}) for n in (
        "googlenet", "inception_v3", "mobilenet_v3_large",
        "mobilenet_v3_small", "mobilenet_v1", "mobilenet_v2",
        "shufflenet_v2_x0_25", "shufflenet_v2_x0_33", "shufflenet_v2_x0_5",
        "shufflenet_v2_x1_0", "shufflenet_v2_x1_5", "shufflenet_v2_x2_0",
        "shufflenet_v2_swish", "squeezenet1_0", "squeezenet1_1")])


def zoo_loss(F, out, y):
    """Cross-entropy of the logits, summed over GoogLeNet's training
    triple ``(out, aux1, aux2)``."""
    outs = out if isinstance(out, tuple) else (out,)
    return sum(F.cross_entropy(o, y) for o in outs)


def calibrate_batch_norms(pt, model, x):
    """Set every batch norm's running statistics to those of the batch
    ``x`` (one train-mode forward without gradients at momentum 0), so an
    eval forward of a fresh model normalises as a trained one's does:
    at initialisation (running mean 0, variance 1) the mobile nets'
    eval activations shrink towards 0 and a comparison of their logits
    would hold nothing."""
    bns = [m for m in model.modules() if isinstance(m, pt.nn.BatchNorm)]
    saved = [m._momentum for m in bns]
    for m in bns:
        m._momentum = 0.0
    model.train()
    with torch.no_grad():
        model(x)
    for m, momentum in zip(bns, saved):
        m._momentum = momentum


def zoo_phase(pt, B=8, B_time=64, factories=ZOO_FACTORIES, hw=224,
              hw_inception=299):
    """Phase 23a: every factory of the two zoo files at ``num_classes=
    1000``, f32, random weights from seed 0, inputs from numpy seed 0,
    its batch norms calibrated on the batch (:func:`calibrate_batch_norms`):
    the card's eval logits at B 8 x 3 x 224 x 224 (299 for InceptionV3)
    against the port's CPU forward of the same weights (within ``2e-3 +
    2e-3 |cpu|`` and ``||card - cpu|| / ||cpu|| <= 1e-3``: cuDNN's and
    the CPU's f32 convolutions round differently through up to 264
    layers), one train-mode forward and backward at B 8 with every
    gradient finite, then forward plus backward timed at B 64 (1 warm-up
    and 2 timed steps, host clock around a synchronise) with its peak
    memory. -> {label: numbers}"""
    F = pt.nn.functional
    zoo = pt.vision.models
    out = {}
    log(f"[zoo] {len(factories)} factories, num_classes=1000, f32: eval "
        f"logits at B={B} against the CPU forward, a train step's "
        f"gradients, fwd+bwd timed at B={B_time}")
    for label, name, kw in factories:
        side = hw_inception if name == "inception_v3" else hw
        rng = np.random.RandomState(SEED)
        x = torch.from_numpy(rng.randn(B, 3, side, side).astype(np.float32))
        y = torch.from_numpy(rng.randint(0, 1000, B))
        t0 = time.perf_counter()
        model = getattr(zoo, name)(num_classes=1000, seed=SEED, **kw)
        n_params = sum(p.numel() for p in model.parameters())
        calibrate_batch_norms(pt, model, x.cuda())
        cpu = getattr(zoo, name)(num_classes=1000, device="cpu", seed=None,
                                 **kw)
        cpu.load_state_dict({k: v.cpu() for k, v in
                             model.state_dict().items()})
        model.eval()
        cpu.eval()
        with torch.no_grad():
            got = model(x.cuda()).cpu()
            want = cpu(x)
        err = check_close(f"{label} eval logits [{B}, 1000] card vs CPU",
                          got, want, 2e-3, 2e-3, norm_tol=1e-3)
        del cpu, got, want
        model.train()
        loss = zoo_loss(F, model(x.cuda()), y.cuda())
        loss.backward()
        grads = [p.grad for p in model.parameters()]
        if any(g is None for g in grads) or not all(
                bool(torch.isfinite(g).all()) for g in grads) or \
                not math.isfinite(float(loss.detach())):
            fail(f"zoo {label}: a train step's loss or gradients are not "
                 f"finite (or missing)")
        model.zero_grad(set_to_none=True)
        xt = torch.from_numpy(np.random.RandomState(SEED + 1).randn(
            B_time, 3, side, side).astype(np.float32)).cuda()
        yt = torch.from_numpy(np.random.RandomState(SEED + 1).randint(
            0, 1000, B_time)).cuda()

        def fwd_bwd():
            zoo_loss(F, model(xt), yt).backward()
            model.zero_grad(set_to_none=True)

        fwd_bwd()
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(2):
            t1 = time.perf_counter()
            fwd_bwd()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        ms = float(np.median(times))
        out[label] = {"params_m": n_params / 1e6, "eval_max_abs_err": err,
                      "train_loss": float(loss.detach()), "fwd_bwd_ms": ms,
                      "images_per_s": B_time / ms * 1e3,
                      "peak_gb": peak / 1e9,
                      "total_s": time.perf_counter() - t0}
        log(f"  [zoo] {label}: {n_params / 1e6:.2f} M params, train loss "
            f"{float(loss.detach()):.4f} with finite gradients; fwd+bwd "
            f"B={B_time} {ms:.2f} ms ({B_time / ms * 1e3:.1f} images/s), peak "
            f"{peak / 1e9:.2f} GB; {out[label]['total_s']:.1f} s")
        del model, loss, grads, xt, yt
        free()
    return out


def mobilenet_rmsprop(pt, warmup=2, steps=10, B=96):
    """Phase 23b: MobileNetV2 (``mobilenet_v2(num_classes=1000)``, full
    width and depth) with the paper's recipe (Sandler et al.,
    arXiv:1801.04381 §6.1): ``RMSProp(0.045, rho=0.9, momentum=0.9,
    weight_decay=L2Decay(4e-5), multi_precision=True)`` with the x 0.98
    decay one ``ExponentialDecay(gamma=0.98)`` step a call, O2 bf16, B 96
    x 3 x 224 x 224 from numpy seed 0; eager, then staged from the same
    weights and batch, 2 warm-up and 10 timed steps each. The staged run
    has 0 graph breaks, equals eager bit for bit (or within 1e-2 on the
    losses and 2e-2 on the weights where a second eager run differs too:
    cuDNN's weight gradients need not sum in one order), and no hand
    kernel runs. Prints step ms, images/s, the busy share and the device
    families, the depthwise convolutions' share among them."""
    F = pt.nn.functional
    rng = np.random.RandomState(SEED)
    x = torch.from_numpy(rng.randn(B, 3, 224, 224).astype(
        np.float32)).cuda()
    y = torch.from_numpy(rng.randint(0, 1000, B)).cuda()

    def build():
        model = pt.vision.models.mobilenet_v2(num_classes=1000,
                                              seed=SEED).train()
        sched = pt.optimizer.lr.ExponentialDecay(0.045, gamma=0.98)
        opt = pt.RMSProp(sched, rho=0.9, momentum=0.9,
                         parameters=model.parameters(),
                         weight_decay=pt.regularizer.L2Decay(4e-5),
                         multi_precision=True)
        model, opt = pt.amp.decorate(model, opt, level="O2",
                                     dtype="bfloat16")

        def train_step(xb, yb):
            with pt.auto_cast(level="O2", dtype="bfloat16"):
                loss = F.cross_entropy(model(xb), yb)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss
        return model, opt, sched, train_step, (x, y)

    def run(staged):
        r = train_run(pt, build, staged, warmup, steps)
        r["weights"] = host_params(r["model"])
        del r["model"], r["opt"], r["step"]
        free()
        return r

    log(f"[mobilenet_v2 rmsprop] MobileNetV2 O2 bf16, B={B} x 3 x 224 x "
        f"224, RMSProp(0.045, rho 0.9, momentum 0.9, L2Decay(4e-5), "
        f"masters), ExponentialDecay(0.98) a step: eager, then staged; "
        f"{warmup} warm-up and {steps} timed steps each")
    eager = run(False)
    staged = run(True)
    for r in (eager, staged):
        if not all(math.isfinite(v) for v in r["losses"]):
            fail(f"mobilenet_v2 rmsprop: losses not finite: {r['losses']}")
    cmp = compare_runs("mobilenet_v2 rmsprop", eager, staged,
                       lambda: run(False), 1e-2, 2e-2)
    st = staged["stats"]
    if st["graph_breaks"] or st["graphs"] != 1 or st["eager_calls"]:
        fail(f"mobilenet_v2 rmsprop: staging stats {st}")
    check_replay_launches("mobilenet_v2 rmsprop", staged["launches"], steps,
                          {})
    fams = staged["families"]
    total = max(sum(fams.values()), 1e-9)
    dw = fams.get("depthwise convolution", 0.0)
    out = report_pair("mobilenet_v2 rmsprop", eager, staged, dict(
        cmp, images_per_s=B / staged["step_ms_median"] * 1e3,
        eager_images_per_s=B / eager["step_ms_median"] * 1e3,
        depthwise_ms=dw, depthwise_share_pct=100 * dw / total))
    log(f"  [mobilenet_v2 rmsprop] stats {st}; staged "
        f"{B / staged['step_ms_median'] * 1e3:.1f} images/s vs eager "
        f"{B / eager['step_ms_median'] * 1e3:.1f}; depthwise convolutions "
        f"{dw:.3f} ms = {100 * dw / total:.1f}% of the staged step's "
        f"device time; losses {staged['losses']}")
    return out


def lamb_step_timing(model, opt):
    """The Lamb step alone over BERT-base's tensors (master mode, one
    ``opt.step()`` on fixed bf16 gradients): device time by ``time_ms``
    and CUDA-event time a call with its host work, beside its bound (28
    bytes a parameter, as fused AdamW's; phase 22d times that kernel on
    the same tensors). -> numbers for the ``fused_adamw`` entry"""
    params = list(model.parameters())
    n = sum(p.numel() for p in params)
    g = torch.Generator(device=params[0].device).manual_seed(12)
    grads = [(1e-3 * torch.randn(p.shape, device=p.device, generator=g))
             .bfloat16() for p in params]

    def step():
        for p, gr in zip(params, grads):
            p.grad = gr
        opt.step()

    lamb_ms, lamb_wall, src = time_ms(step, iters=10)
    for p in params:
        p.grad = None
    b_ms, b_by = bound(28 * n, 20 * n, F32_FLOPS_PER_S)
    log(f"[bert lamb timing] Lamb master-mode step over {len(params)} "
        f"tensors ({n / 1e6:.1f} M params): {lamb_ms:.4f} ms device "
        f"({src}), {lamb_wall:.4f} ms a call with its host work; bound "
        f"{b_ms:.4f} ms ({b_by}, 28 B/param) = "
        f"{100 * b_ms / lamb_ms:.1f}%")
    return {"bert_lamb_step_ms": lamb_ms, "bert_lamb_step_wall_ms":
            lamb_wall, "bert_lamb_bound_ms": b_ms}


def bert_lamb(pt, warmup=2, steps=10, B=16, S=512):
    """Phase 23c: phase 20b's BERT-base MLM step (O2 bf16, B 16 x S 512,
    no mask) with ``Lamb(1e-4, lamb_weight_decay=0.01,
    multi_precision=True)`` (LAMB's published beta 0.9 / 0.999 and epsilon
    1e-6, You et al. arXiv:1904.00962, the JAX defaults), eager then
    staged from the same weights and batch, 2 warm-up and 10 timed steps:
    0 graph breaks, losses within 1e-3 and weights within 1e-2 of eager
    (or bit-equal), and inside the replayed graph the flash trio 12 each
    and LayerNorm 26 a step (no AdamW). Then the Lamb step alone timed
    (:func:`lamb_step_timing`). -> (summary, launches, the Lamb timing)"""
    cfg = pt.bert_base(dropout=0.0)

    def make_opt(model):
        return pt.Lamb(1e-4, lamb_weight_decay=0.01,
                       parameters=model.parameters(), multi_precision=True)

    def run(staged, keep=False):
        r = train_run(pt, lambda: bert_build(pt, B, S, make_opt), staged,
                      warmup, steps)
        r["weights"] = host_params(r["model"])
        if not keep:
            del r["model"], r["opt"], r["step"]
            free()
        return r

    log(f"[bert lamb] BertForMaskedLM(bert_base) O2 bf16, B={B} S={S}, "
        f"Lamb(1e-4, wd 0.01, masters): eager, then staged; {warmup} "
        f"warm-up and {steps} timed steps each")
    eager = run(False)
    staged = run(True, keep=True)
    cmp = compare_runs("bert lamb", eager, staged, lambda: run(False), 1e-3,
                       1e-2)
    st = staged["stats"]
    if st["graph_breaks"] or st["graphs"] != 1 or st["eager_calls"]:
        fail(f"bert lamb: staging stats {st}")
    L = cfg.num_layers
    check_replay_launches("bert lamb", staged["launches"], steps, {
        "flash_fwd": L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
        "layer_norm": 2 * L + 2})
    n_params = sum(w.numel() for w in eager["weights"])
    flops = 6 * n_params * B * S + 12 * L * B * S * S * cfg.hidden_size
    mfu = {k: flops / (r["step_ms_median"] / 1e3) / BF16_FLOPS_PER_S
           for k, r in (("eager_mfu", eager), ("staged_mfu", staged))}
    out = report_pair("bert lamb", eager, staged, dict(
        cmp, **mfu, tokens_per_s=B * S / staged["step_ms_median"] * 1e3))
    model, opt = staged["model"], staged["opt"]
    del staged["model"], staged["opt"], staged["step"]
    free()
    lamb = lamb_step_timing(model, opt)
    del model, opt
    free()
    return out, staged["launches"], lamb


# 23d's optimizers on LeNet: (label, class name, args, kwargs, the
# staged-vs-eager loss and weight tolerances where eager runs differ)
LENET_OPTIMIZERS = [
    ("adagrad", "Adagrad", (0.005,), {}, 1e-5),
    # lr 1.0 on the JAX layers' initial weights overshoots (the loss
    # rises at step 8 on the card and the CPU alike) and a 1e-6 gap grows
    # 100x a step: 257x the tolerance by step 9; 0.2 keeps it at the
    # other optimizers' level
    ("adadelta", "Adadelta", (0.2,), {}, 1e-5),
    ("adamax", "Adamax", (0.002,), {}, 1e-5),
    ("rprop", "Rprop", (0.001,), {}, 1e-5),
    # sqrt(ms - mg^2 + eps) and momentum 0.9 magnify a 2e-6 difference of
    # cuDNN's weight gradients to 1e-4 in the losses and 1.3e-3 in the
    # weights over 10 steps, between two eager runs as much as between
    # staged and eager
    ("rmsprop_centered", "RMSProp", (0.001,), dict(centered=True,
                                                   momentum=0.9), 2e-3),
]


def lenet_cpu_losses(pt, weights, make_opt, x, y, n):
    """``n`` eager steps of the port's CPU path from ``weights`` on the
    same batch -> losses."""
    F = pt.nn.functional
    model = pt.params_from_paddle_tpu(weights, pt.LeNet(device="cpu",
                                                        seed=None))
    opt = make_opt(model)
    losses = []
    for _ in range(n):
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    return losses


def lenet_optimizers(pt, warmup=2, steps=8, B=64):
    """Phase 23d: phase 18's LeNet (f32, B 64 from numpy seed 0) with
    Adagrad, Adadelta, Adamax, Rprop and RMSProp(centered=True), each
    eager and staged on the card with cuDNN's deterministic algorithms (0
    breaks; staged equal to eager bit for bit, or within the table's
    tolerance on losses and weights where a second eager run differs
    too) and against
    the same 11 steps on the port's CPU path; then
    ``LBFGS(line_search_fn="strong_wolfe", max_iter=4)`` for 5 closure
    steps on the card against the CPU. The losses are held within
    ``1e-4 + 1e-4 |cpu|``: cuDNN's and the CPU's f32 convolutions round
    differently, and each adaptive step divides by running gradient
    magnitudes, which grows that rounding step by step (Adagrad at lr
    0.01 with cuDNN's default algorithms drifted 0.5% by step 10, so the
    rates here are moderate). -> {label: numbers}"""
    F = pt.nn.functional
    rng = np.random.RandomState(SEED)
    xh = torch.from_numpy(rng.randn(B, 1, 28, 28).astype(np.float32))
    yh = torch.from_numpy(rng.randint(0, 10, B))
    x, y = xh.cuda(), yh.cuda()
    out = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    for label, cls, args, kw, tol in LENET_OPTIMIZERS:
        held = {}

        def make_opt(model, cls=cls, args=args, kw=kw):
            return getattr(pt.optimizer, cls)(
                *args, parameters=model.parameters(), **kw)

        def build(make_opt=make_opt):
            model = pt.LeNet(seed=SEED)
            held["weights"] = pt.params_to_numpy(model)
            opt = make_opt(model)

            def train_step(xb, yb):
                loss = F.cross_entropy(model(xb), yb)
                loss.backward()
                opt.step()
                opt.clear_grad()
                return loss
            return model, opt, None, train_step, (x, y)

        def run(staged):
            r = train_run(pt, build, staged, warmup, steps)
            r["weights"] = host_params(r["model"])
            del r["model"], r["opt"], r["step"]
            return r

        eager, staged = run(False), run(True)
        cmp = compare_runs(f"lenet {label}", eager, staged,
                           lambda: run(False), tol, tol)
        st = staged["stats"]
        if st["graph_breaks"] or st["eager_calls"]:
            fail(f"lenet {label}: staging stats {st}")
        check_replay_launches(f"lenet {label}", staged["launches"], steps,
                              {})
        cpu = lenet_cpu_losses(pt, held["weights"], make_opt, xh, yh,
                               len(eager["losses"]))
        worst = max(abs(a - b) / (1e-4 + 1e-4 * abs(b))
                    for a, b in zip(eager["losses"], cpu))
        log(f"  [lenet {label}] card losses {eager['losses']}; CPU "
            f"{cpu}; worst |card - cpu| / (1e-4 + 1e-4 |cpu|) = "
            f"{worst:.3f}; staged {staged['step_ms_median']:.3f} ms vs "
            f"eager {eager['step_ms_median']:.3f} ms a step")
        if worst > 1.0 or not eager["losses"][-1] < eager["losses"][0]:
            fail(f"lenet {label}: the card's losses leave the CPU run's, "
                 f"or do not fall")
        out[label] = dict(cmp, staged_ms=staged["step_ms_median"],
                          eager_ms=eager["step_ms_median"],
                          worst_vs_cpu=worst, stats=st)
        free()
    torch.backends.cudnn.deterministic = deterministic
    # LBFGS: host-driven, eager, with the strong-Wolfe line search
    weights = pt.params_to_numpy(pt.LeNet(seed=SEED))
    runs = {}
    for dev, xb, yb in ((None, x, y), ("cpu", xh, yh)):
        model = pt.params_from_paddle_tpu(weights, pt.LeNet(
            device=dev, seed=None))
        opt = pt.LBFGS(learning_rate=1.0, max_iter=4, history_size=10,
                       line_search_fn="strong_wolfe",
                       parameters=model.parameters())

        def closure(model=model, opt=opt, xb=xb, yb=yb):
            opt.clear_grad()
            loss = F.cross_entropy(model(xb), yb)
            loss.backward()
            return loss

        t0 = time.perf_counter()
        runs[dev] = ([opt.step(closure) for _ in range(5)],
                     opt._state["n_evals"], time.perf_counter() - t0)
    (lc, ec, sc), (lh, eh, _) = runs[None], runs["cpu"]
    worst = max(abs(a - b) / (1e-4 + 1e-4 * abs(b)) for a, b in zip(lc, lh))
    log(f"  [lenet lbfgs] strong_wolfe, 5 closure steps: card {lc} ({ec} "
        f"evaluations, {sc:.2f} s) vs CPU {lh} ({eh}); worst "
        f"|card - cpu| / (1e-4 + 1e-4 |cpu|) = {worst:.3f}")
    if worst > 1.0 or not lc[-1] < lc[0]:
        fail("lenet lbfgs: the card's losses leave the CPU run's, or do "
             "not fall")
    out["lbfgs"] = {"losses": lc, "evaluations": ec, "seconds": sc,
                    "worst_vs_cpu": worst}
    return out


def zoo_optimizer_phases(pt):
    """Phase 23. -> {kernel: the numbers it adds to its JSON entry}"""
    zoo_phase(pt)
    mobilenet_rmsprop(pt)
    _, launches, lamb = bert_lamb(pt)
    lenet_optimizers(pt)
    extra = {name: {"lamb_launches": n} for name, n in launches.items()}
    extra["fused_adamw"].update(lamb)
    return extra


# ------------------------------------------------------------- phase 24
# 24a's three loaders: (label, DataLoader keywords)
HAPI_LOADERS = (("in process", dict(num_workers=0, use_buffer_reader=False)),
                ("buffered reader", dict(num_workers=0)),
                ("2 workers", dict(num_workers=2, timeout=120)))


def array_dataset(pt, x, y):
    """A map-style ``pt.io.Dataset`` over the numpy arrays ``x``, ``y``:
    sample ``i`` is ``(x[i], y[i])``."""
    class ArrayDataset(pt.io.Dataset):
        def __getitem__(self, i):
            return x[i], y[i]

        def __len__(self):
            return len(x)

    return ArrayDataset()


def mnist_like(pt, n, seed):
    """``n`` MNIST-shaped [1, 28, 28] f32 images from numpy ``seed``: one
    of ten fixed random templates (numpy seed 1000) plus unit noise, each
    labelled by the template it correlates with most, a fixed function of
    the image, so accuracy means something."""
    rng = np.random.RandomState(seed)
    templates = np.random.RandomState(1000).randn(10, 784)
    x = templates[rng.randint(0, 10, n)] + rng.randn(n, 784)
    y = (x @ templates.T).argmax(1).astype(np.int64)
    return array_dataset(pt, x.reshape(n, 1, 28, 28).astype(np.float32), y)


def token_sequences(pt, n, S, vocab, seed):
    """``n`` token sequences of length ``S`` from numpy ``seed``, labelled
    1 when the first token lies in the lower half of the vocabulary."""
    ids = np.random.RandomState(seed).randint(0, vocab, (n, S))
    return array_dataset(pt, ids, (ids[:, 0] < vocab // 2).astype(np.int64))


def batch_recorder(pt, K, opt=None):
    """A callback keeping each train step's logged loss, the host clock at
    its end, the optimizer's lr it ran with (read before the
    ``LRScheduler`` callback after it steps) and the launch counts at the
    end of step 0 (the warm-up step)."""
    class Recorder(pt.hapi.callbacks.Callback):
        def __init__(self):
            self.losses, self.ends, self.lrs, self.counts = [], [], [], None

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])
            self.ends.append(time.perf_counter())
            if opt is not None:
                self.lrs.append(opt.get_lr())
            if self.counts is None:
                self.counts = K.launch_counts()

    return Recorder()


def hapi_lenet(pt, K, n=8192, n_eval=1024, B=64, epochs=2):
    """Phase 24a: the hapi quick-start. ``Model(LeNet())`` with
    ``prepare(Adam(1e-3), CrossEntropyLoss(), Accuracy(topk=(1, 5)))`` fits
    :func:`mnist_like`'s 8192 images for 2 epochs at B 64, in order, three
    times: through ``DataLoader(num_workers=0)`` without and with the
    buffered reader and with 2 workers (cuDNN's deterministic algorithms).
    Checks: the three loaders' batches equal, the logged losses and the
    histories bit-equal, one graph captured, 0 breaks, exactly one AdamW
    launch a step and no other kernel; then ``evaluate`` and ``predict``
    on 1024 held-out images (top-1 of the predictions equals evaluate's),
    ``save`` and a fresh ``Model.load``, which must evaluate to the same
    loss and accuracy. -> (launches over the three fits, numbers)"""
    train, held = mnist_like(pt, n, SEED), mnist_like(pt, n_eval, SEED + 1)
    steps = epochs * n // B
    log(f"[hapi lenet] Model(LeNet()).fit: {n} MNIST-shaped images, B={B}, "
        f"{epochs} epochs ({steps} steps), Adam(1e-3), Accuracy(topk=(1, "
        f"5)); three loaders")
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    total = {name: 0 for name in K.launch_counts()}
    runs, first = [], None
    try:
        for label, kw in HAPI_LOADERS:
            loader = pt.io.DataLoader(train, batch_size=B, shuffle=False,
                                      **kw)
            batches = [(x.clone(), y.clone()) for x, y in loader]
            if first is None:
                first = batches
            elif len(batches) != len(first) or not all(
                    torch.equal(a, c) and torch.equal(b, d)
                    for (a, b), (c, d) in zip(batches, first)):
                fail(f"hapi lenet: the {label} loader's batches differ from "
                     f"the in-process loader's")
            del batches
            net = pt.LeNet(seed=SEED)
            model = pt.Model(net)
            model.prepare(pt.Adam(1e-3, parameters=net.parameters()),
                          pt.nn.CrossEntropyLoss(),
                          pt.metric.Accuracy(topk=(1, 5)))
            rec = batch_recorder(pt, K)
            torch.cuda.synchronize()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            hist = model.fit(loader, epochs=epochs, verbose=0,
                             callbacks=[rec])
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            launches = K.launch_counts()
            stats = model._step_fn.stats()
            want = {name: 0 for name in launches}
            want["fused_adamw"] = steps
            if launches != want:
                fail(f"hapi lenet ({label}): launches {launches} != {want}")
            if stats["graphs"] != 1 or stats["graph_breaks"] or \
                    stats["eager_calls"] or len(rec.losses) != steps:
                fail(f"hapi lenet ({label}): staging {stats}, "
                     f"{len(rec.losses)} steps")
            if not all(math.isfinite(v) for v in rec.losses):
                fail(f"hapi lenet ({label}): a loss is not finite")
            for k, v in launches.items():
                total[k] += v
            gaps = np.diff(rec.ends[1:]) * 1e3
            log(f"  {label}: history {hist['loss']}, fit {fit_s:.2f} s, "
                f"{1e3 / float(np.median(gaps)):.1f} steps/s (median step "
                f"{float(np.median(gaps)):.3f} ms), staging {stats}, "
                f"launches {launches}")
            runs.append({"label": label, "losses": rec.losses,
                         "hist": hist["loss"], "fit_s": fit_s,
                         "steps_per_s": 1e3 / float(np.median(gaps)),
                         "model": model})
        for r in runs[1:]:
            if r["losses"] != runs[0]["losses"] or \
                    r["hist"] != runs[0]["hist"]:
                d = max(abs(a - b) for a, b in zip(r["losses"],
                                                   runs[0]["losses"]))
                fail(f"hapi lenet: the {r['label']} run's losses differ "
                     f"from the in-process run's by up to {d:.3e}")
        log(f"  the three loaders' batches equal and their {steps} losses "
            f"bit-equal: first {runs[0]['losses'][0]:.4f}, last "
            f"{runs[0]['losses'][-1]:.4f}")
        model = runs[-1]["model"]
        ev = model.evaluate(held, batch_size=256, verbose=0)
        pred = model.predict(held, batch_size=256, stack_outputs=True)[0]
        labels = np.asarray([held[i][1] for i in range(n_eval)])
        top1 = float((pred.argmax(1) == labels).mean())
        if pred.shape != (n_eval, 10) or not np.isfinite(pred).all() or \
                abs(top1 - ev["acc"][0]) > 1e-12:
            fail(f"hapi lenet: predict {pred.shape} top-1 {top1} vs "
                 f"evaluate {ev}")
        net = pt.LeNet(seed=None)
        fresh = pt.Model(net)
        fresh.prepare(pt.Adam(1e-3, parameters=net.parameters()),
                      pt.nn.CrossEntropyLoss(),
                      pt.metric.Accuracy(topk=(1, 5)))
        with tempfile.TemporaryDirectory() as d:
            model.save(os.path.join(d, "lenet"))
            fresh.load(os.path.join(d, "lenet"))
        ev2 = fresh.evaluate(held, batch_size=256, verbose=0)
        if ev2["loss"] != ev["loss"] or list(ev2["acc"]) != list(ev["acc"]):
            fail(f"hapi lenet: the reloaded model evaluates to {ev2}, the "
                 f"trained one to {ev}")
        log(f"  evaluate on {n_eval} held-out images: {ev}; predict "
            f"{pred.shape}, top-1 {top1:.4f}; save + a fresh Model.load "
            f"evaluates to the same")
    finally:
        torch.backends.cudnn.deterministic = det
    out = {"eval_loss": ev["loss"], "eval_acc": [float(a) for a in ev["acc"]],
           "steps_per_s": {r["label"]: r["steps_per_s"] for r in runs}}
    del runs, model, fresh, first
    free()
    return total, out


def adamw_f32_timing(K, model, tag):
    """Fused AdamW's f32 mode (f32 w, g, m, v: no ``decorate``) in one
    launch over ``model``'s tensors, against the plain version (within
    1e-6 + 1e-6 |plain|), then timed over a prebuilt table beside its
    bound (28 bytes a parameter), its plain version and
    ``torch._fused_adamw_`` (timed here only). -> {ms, plain_ms, bound_ms,
    bound_by, library_ms, max_abs_err}"""
    params = list(model.parameters())
    n_t, n = len(params), sum(p.numel() for p in params)
    g = torch.Generator(device="cuda").manual_seed(12)
    ws = [p.detach().clone() for p in params]
    gs = [1e-3 * torch.randn(p.shape, device="cuda", generator=g)
          for p in params]
    ms_ = [1e-4 * torch.randn(p.shape, device="cuda", generator=g)
           for p in params]
    vs_ = [1e-6 * torch.rand(p.shape, device="cuda", generator=g)
           for p in params]
    c1, c2 = 1 / (1 - 0.9 ** 23), 1 / (1 - 0.999 ** 23)
    args = (ws, gs, ms_, vs_, [1e-4] * n_t, 0.9, 0.999, 1e-8, [0.01] * n_t,
            [c1] * n_t, [c2] * n_t, None)
    before = [(w.clone(), m.clone(), v.clone())
              for w, m, v in zip(ws, ms_, vs_)]
    K.fused_adamw(*args[:-1])
    torch.cuda.synchronize()
    err = check_update(K, before, gs, (ws, ms_, vs_), c1, c2, 1e-6,
                       f"fused_adamw f32 mode ({tag})")
    del before
    ms = launch_ms(args)
    plain_ms, _, _ = time_ms(lambda: [K.fused_adamw_reference(
        w, gr, m, v, 1e-4, 0.9, 0.999, 1e-8, 0.01, c1, c2)
        for w, gr, m, v in zip(ws, gs, ms_, vs_)], iters=2, warmup=1)
    steps_t = [torch.tensor(23.0, device="cuda") for _ in params]
    lib_ms, _, _ = time_ms(lambda: torch._fused_adamw_(
        ws, gs, ms_, vs_, [], steps_t, lr=1e-4, beta1=0.9, beta2=0.999,
        weight_decay=0.01, eps=1e-8, amsgrad=False, maximize=False),
        iters=10)
    b_ms, b_by = bound(28 * n, 12 * n, F32_FLOPS_PER_S)
    log(f"[{tag}] fused_adamw f32 mode over {n_t} tensors ({n / 1e6:.2f} M "
        f"params): max abs err {err:.3e}; kernel {ms:.4f} ms (one launch "
        f"over a prebuilt table) = {100 * b_ms / ms:.1f}% of bound "
        f"{b_ms:.4f} ms ({b_by}: 28 B/param); plain {plain_ms:.4f} ms; "
        f"torch._fused_adamw_ {lib_ms:.4f} ms")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms, "max_abs_err": err}


def hapi_bert(pt, K, n=3200, n_eval=640, B=32, S=128):
    """Phase 24b: BERT-base fine-tuning through ``Model.fit``, the BERT
    paper's GLUE recipe: ``BertForSequenceClassification(bert_base(
    dropout=0.0), num_classes=2)`` in f32 from seed 0, B 32 x S 128,
    ``AdamW(weight_decay=0.01)`` at lr 2e-5 under ``LinearWarmup`` over
    the first 10% of the steps and a linear decay after
    (``PolynomialDecay``), stepped by ``callbacks.LRScheduler(by_step=
    True)``; ``amp_configs="O1"`` (bf16), ``Accuracy()``; 3200 sequences
    (:func:`token_sequences`) read by ``DataLoader(num_workers=2)``, one
    epoch of 100 steps, with metrics on (telemetry); then ``evaluate`` on
    640 held-out sequences. Checks: the losses finite and equal within
    1e-3 to a hand-written loop over the same batches from the same
    weights through ``pt.jit.to_static`` (its scheduler stepped after
    each step), the lrs equal and moving; one capture, 0 breaks; launches
    over the 99 replayed steps exactly 12 of each flash kernel, 25
    LayerNorm and 1 AdamW a step; each evaluate batch 12 flash forwards
    and 25 LayerNorms. Then one more replay of the hand loop's step
    profiled (device busy share, time by family), and the flash trio at
    this shape ([32, 128, 12, 64] bf16 non-causal), LayerNorm at [4096,
    768] f32 and fused AdamW's f32 mode over the model's tensors, checked
    and timed.
    -> (launches over the fit and evaluate, numbers a kernel adds)"""
    cfg = pt.bert_base(dropout=0.0)
    L, h, V = cfg.num_layers, cfg.hidden_size, cfg.vocab_size
    steps, warm = n // B, n // B // 10
    train = token_sequences(pt, n, S, V, SEED)
    held = token_sequences(pt, n_eval, S, V, SEED + 1)

    def build():
        net = pt.BertForSequenceClassification(cfg, num_classes=2, seed=SEED)
        lr = pt.optimizer.lr
        sched = lr.LinearWarmup(lr.PolynomialDecay(2e-5, steps - warm, 0.0),
                                warm, 0.0, 2e-5)
        opt = pt.AdamW(sched, parameters=net.parameters(),
                       weight_decay=0.01)
        return net, sched, opt

    net, sched, opt = build()
    n_params = sum(p.numel() for p in net.parameters())
    info = pt.summary(net, (B, S), dtypes="int64")
    fwd_flops = pt.flops(net, [B, S])
    log(f"[hapi bert] BertForSequenceClassification(bert_base) f32, "
        f"{n_params / 1e6:.3f} M params; pt.summary {info}; pt.flops "
        f"{fwd_flops / 1e9:.2f} GFLOP a forward at [{B}, {S}]; fit: {n} "
        f"sequences, B={B} S={S}, {steps} steps, AdamW(wd 0.01) at 2e-5 "
        f"with {warm} warm-up steps, O1 bf16, DataLoader(num_workers=2)")
    model = pt.Model(net)
    model.prepare(opt, pt.nn.CrossEntropyLoss(), pt.metric.Accuracy(),
                  amp_configs="O1")
    loader = pt.io.DataLoader(train, batch_size=B, shuffle=False,
                              num_workers=2, timeout=120)
    rec = batch_recorder(pt, K, opt)
    metrics = pt.observability.metrics
    reg = metrics.enable()
    free()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        model.fit(loader, epochs=1, verbose=0, callbacks=[
            rec, pt.hapi.callbacks.LRScheduler(by_step=True)])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        snap = reg.snapshot()
    finally:
        metrics.disable()
    after = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    stats = model._step_fn.stats()
    replayed = {k: after[k] - rec.counts[k] for k in after}
    check_replay_launches("hapi bert", replayed, steps - 1, {
        "flash_fwd": L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
        "layer_norm": 2 * L + 1, "fused_adamw": 1})
    if stats["graphs"] != 1 or stats["graph_breaks"] or \
            stats["eager_calls"] or stats["replays"] != steps - 1:
        fail(f"hapi bert: staging {stats}")
    if len(rec.losses) != steps or not all(math.isfinite(v)
                                           for v in rec.losses):
        fail(f"hapi bert: losses {rec.losses}")
    nb = n_eval // B
    t0 = time.perf_counter()
    ev = model.evaluate(held, batch_size=B, verbose=0)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    total = K.launch_counts()
    ev_launches = {k: total[k] - after[k] for k in total}
    want = {k: 0 for k in total}
    want.update({"flash_fwd": L * nb, "layer_norm": (2 * L + 1) * nb})
    if ev_launches != want:
        fail(f"hapi bert: evaluate launched {ev_launches} != {want}")
    gaps = np.diff(rec.ends[1:]) * 1e3
    step_ms = float(np.median(gaps))
    tokens = B * S
    mfu = (6 * n_params * tokens + 12 * L * B * S * S * h) / \
        (step_ms / 1e3) / BF16_FLOPS_PER_S
    hs = snap["histograms"]
    numbers = {
        "steps_per_s": 1e3 / step_ms, "step_ms_median": step_ms,
        "step_ms_min": float(gaps.min()), "samples_per_s": B * 1e3 / step_ms,
        "tokens_per_s": tokens * 1e3 / step_ms, "fit_s": fit_s,
        "bert_train_step_mfu": mfu,
        "telemetry_mfu_pct": snap["gauges"].get("mfu_pct"),
        "telemetry_tokens_per_sec": snap["gauges"].get("tokens_per_sec"),
        "telemetry_steps": snap["counters"].get("steps_total"),
        "data_wait_share": hs["data_wait_ms"]["sum"]
        / hs["step_time_ms"]["sum"],
        "data_wait_ms_mean": hs["data_wait_ms"]["sum"]
        / hs["data_wait_ms"]["count"],
        "step_time_ms_mean": hs["step_time_ms"]["sum"]
        / hs["step_time_ms"]["count"],
        "max_memory_allocated_gb": peak / 1e9, "eval_loss": ev["loss"],
        "eval_acc": float(ev["acc"]), "eval_s": eval_s,
        "summary_total_params": info["total_params"],
        "flops_forward": fwd_flops, "staging": stats,
        "first_loss": rec.losses[0], "last_loss": rec.losses[-1]}
    log(f"  replayed {steps - 1} steps; launches a replayed step exact; "
        f"evaluate on {n_eval} sequences ({nb} batches): {ev}, launches "
        f"exact")
    log("  " + json.dumps(numbers))
    fit_losses, fit_lrs = rec.losses, rec.lrs
    del model, net, opt, sched, rec, loader
    free()
    # the same batches from the same weights through a hand-written loop
    net, sched, opt = build()
    F = pt.nn.functional

    def train_step(x, y):
        with pt.auto_cast(level="O1", dtype="bfloat16"):
            loss = F.cross_entropy(net(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    step = pt.jit.to_static(train_step, capture=(net, opt))
    hand, hand_lrs = [], []
    for x, y in pt.io.DataLoader(train, batch_size=B, shuffle=False):
        hand_lrs.append(opt.get_lr())
        hand.append(float(step(x, y)))
        sched.step()
    d = max(abs(a - b) for a, b in zip(fit_losses, hand))
    log(f"  Model.fit vs the hand-written staged loop: losses differ by at "
        f"most {d:.3e} over {steps} steps (tolerance 1e-3); lr "
        f"{fit_lrs[0]:.3g} -> {max(fit_lrs):.3g} -> {fit_lrs[-1]:.3g}; "
        f"losses " + " ".join(f"{v:.4f}" for v in fit_losses[::10]))
    if len(hand) != steps or d > 1e-3:
        fail(f"hapi bert: Model.fit's losses differ from the hand loop's by "
             f"{d:.3e}")
    if fit_lrs != hand_lrs or len(set(fit_lrs)) < steps // 2:
        fail("hapi bert: the lrs fit ran with differ from the hand loop's "
             "or did not move")
    numbers["max_loss_diff_vs_hand_loop"] = d
    # where the replayed step's time goes (one more replay, profiled)
    report_profile("hapi bert", lambda: float(step(x, y)))
    out = {name: {f"s128_{k}": v for k, v in t.items()} for name, t in
           flash_timing(K, "hapi timing", B, S, cfg.num_heads,
                        h // cfg.num_heads, 24).items()}
    out["layer_norm"] = {f"s128_{k}": v for k, v in layer_norm_timing(
        K, "hapi timing", B * S, h, torch.float32, 1e-5, 25).items()}
    out["fused_adamw"] = {f"s128_{k}": v for k, v in adamw_f32_timing(
        K, net, "hapi timing").items()}
    del net, opt, sched, step
    free()
    return total, numbers, out


def hapi_phases(pt, K):
    """Phase 24: the high-level API on the card (24a, 24b). -> ({kernel:
    the numbers it adds to its JSON entry}, the phase's numbers)"""
    lenet_launches, lenet = hapi_lenet(pt, K)
    bert_launches, bert, extra = hapi_bert(pt, K)
    for name in lenet_launches:
        extra.setdefault(name, {})["hapi_launches"] = \
            lenet_launches[name] + bert_launches[name]
    return extra, {"lenet": lenet, "bert": bert}


# ------------------------------------------------------------- phase 25
# 25a's tolerances by family (tests/torch_surface_cases.py's FAMILIES):
# ints and bools exact, f32 rtol/atol 1e-5 (TF32 off), f64 1e-10, f32
# linear algebra through a factorisation 1e-4
def _surface_cases():
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import torch_surface_cases as C
    return C


def _leaf_err(C, case, cpu, dev, where="cuda"):
    """-> the max abs error of one output pair (CPU vs card), after
    checking dtype, shape and that the card's output lies on the card."""
    rtol, atol = C.FAMILIES[case.fam]
    if not isinstance(dev, torch.Tensor):
        if cpu != dev:
            fail(f"[surface] {case.id}: {dev!r} on the card != {cpu!r}")
        return 0.0
    if dev.device.type != where:
        fail(f"[surface] {case.id}: output on {dev.device}, not {where}")
    if dev.dtype != cpu.dtype or dev.shape != cpu.shape:
        fail(f"[surface] {case.id}: {dev.dtype} {list(dev.shape)} on the "
             f"card != {cpu.dtype} {list(cpu.shape)}")
    a, b = dev.detach().cpu(), cpu.detach()
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    if not a.numel():
        return 0.0
    if not (a.is_floating_point()):
        if not torch.equal(a, b):
            fail(f"[surface] {case.id}: the card's {a.tolist()} != "
                 f"{b.tolist()}")
        return 0.0
    a64, b64 = a.double(), b.double()
    both_nan = torch.isnan(a64) & torch.isnan(b64)
    err = torch.where(both_nan, torch.zeros_like(a64), (a64 - b64).abs())
    ok = bool((err <= atol + rtol * b64.abs()).all())
    if not ok:
        fail(f"[surface] {case.id}: max abs err {float(err.max()):.3e} "
             f"over rtol {rtol:g} / atol {atol:g}")
    return float(err.max())


def surface_sweep(pt, cases=None, where="cuda"):
    """Phase 25a: every case of the CPU parity table
    (``tests/torch_surface_cases.py``) on the card against the same port
    call on CPU tensors: values within the family's tolerance, dtype and
    shape equal, every output on the card. Decompositions are held by
    their invariants (reconstruction, singular / eigen values) on both
    sides. -> {family: worst error}, ops, cases."""
    C = _surface_cases()
    cases = cases or [c for t in C.ALL_TABLES.values() for c in t]
    worst, ops = {}, set()
    t0 = time.perf_counter()
    for case in cases:
        raw = [m(np.random.RandomState(0)) for m in case.make]
        pt.set_device("cpu")
        cpu = C.invoke(pt, case, [C.to_torch(v) for v in raw])
        pt.set_device(where)
        args = [C.to_torch(v) for v in raw]
        args = [[a.to(where) if isinstance(a, torch.Tensor) else a
                 for a in v] if isinstance(v, list) else
                v.to(where) if isinstance(v, torch.Tensor) else v
                for v in args]
        dev = C.invoke(pt, case, args)
        ops.add(case.op)
        fam = case.fam
        if case.check is not None:
            got, want = case.check(dev, raw[0])
            got_c, _ = case.check(cpu, raw[0])
            got = C._np(got)
            tol = max(C.FAMILIES[fam][0], 1e-8)
            for name, g, w in (("invariant", got, want),
                               ("cpu", got, C._np(got_c))):
                if not np.allclose(g, w, rtol=tol, atol=tol):
                    fail(f"[surface] {case.id}: {name} check off by "
                         f"{float(np.abs(g - w).max()):.3e}")
            for a, b in zip(C._leaves(cpu), C._leaves(dev)):
                if b.device.type != where or a.dtype != b.dtype or \
                        a.shape != b.shape:
                    fail(f"[surface] {case.id}: {b.device} {b.dtype} "
                         f"{list(b.shape)} vs {a.dtype} {list(a.shape)}")
            err = float(np.abs(got - want).max())
        else:
            lc, ld = C._leaves(cpu), C._leaves(dev)
            if len(lc) != len(ld):
                fail(f"[surface] {case.id}: {len(ld)} outputs != {len(lc)}")
            err = max([_leaf_err(C, case, a, b, where)
                       for a, b in zip(lc, ld)] or [0.0])
        worst[fam] = max(worst.get(fam, 0.0), err)
    pt.set_device(where)
    log(f"[surface 25a] {len(ops)} ops, {len(cases)} cases on the card vs "
        f"the CPU in {time.perf_counter() - t0:.2f} s; worst error by "
        f"family: " + ", ".join(f"{k} {v:.3e} (tolerance "
                                f"{C.FAMILIES[k][0]:g})"
                                for k, v in sorted(worst.items())))
    return worst, len(ops), len(cases)


def surface_block_forward(pt, blk, x):
    """One ``gpt_1p3b`` decoder block written against the public surface
    with the block's own parameters: the projections as ``pt.matmul`` +
    ``pt.add``, the heads through ``pt.reshape`` / ``pt.transpose`` /
    ``pt.split``, attention through
    ``pt.nn.functional.scaled_dot_product_attention`` (the flash
    kernels), the norms as the block's own ``ln_1`` / ``ln_2`` (the
    LayerNorm kernel)."""
    F = pt.nn.functional
    b, s, h = x.shape
    H = blk.attn.num_heads
    Dh = h // H
    at, mlp = blk.attn, blk.mlp
    a = blk.ln_1(x)
    qkv = pt.add(pt.matmul(a, at.qkv_proj.weight), at.qkv_proj.bias)
    qkv = pt.transpose(pt.reshape(qkv, [b, s, 3, H, Dh]), [2, 0, 1, 3, 4])
    q, k, v = (pt.reshape(t, [b, s, H, Dh]) for t in pt.split(qkv, 3, 0))
    o = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                       dropout_p=0.0, training=False)
    o = pt.add(pt.matmul(pt.reshape(o, [b, s, h]), at.out_proj.weight),
               at.out_proj.bias)
    x1 = pt.add(x, o)
    f = pt.add(pt.matmul(blk.ln_2(x1), mlp.fc1.weight), mlp.fc1.bias)
    f = F.gelu(f, approximate=True)
    f = pt.add(pt.matmul(f, mlp.fc2.weight), mlp.fc2.bias)
    return pt.add(x1, f)


def _rel_l2(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def surface_block(pt, K, B=8, S=1024, warmup=2, iters=10, dev="cuda"):
    """Phase 25b: a ``gpt_1p3b`` decoder block in bf16 at B x S, through
    its own ``forward`` and written against the public surface; outputs,
    the input's and every parameter's gradient held within a relative L2
    error of 1e-2; the surface way's launches of the flash trio and
    LayerNorm from the counters (zeroed just before one forward and
    backward; a ``torch.profiler`` trace of one more is logged); host ms
    of both (median of ``iters`` after ``warmup``); ``pt.grad`` against
    ``backward``; the LayerNorm kernel at the block's [B * S, hidden]
    bf16 against its plain version, timed beside its bound, its plain
    version and ``F.layer_norm``. -> numbers"""
    from paddle_tpu_torch.models.gpt import GPTBlock
    cfg = pt.gpt_1p3b(dropout=0.0)
    g = torch.Generator(device=dev).manual_seed(SEED + 25)
    blk = GPTBlock(cfg, device=dev, dtype=torch.bfloat16, generator=g)
    blk.eval()
    with torch.no_grad():
        for name, p in blk.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.02, generator=g)
    x = torch.randn(B, S, cfg.hidden_size, device=dev, generator=g,
                    dtype=torch.float32).to(torch.bfloat16)
    dy = torch.randn(B, S, cfg.hidden_size, device=dev, generator=g,
                     dtype=torch.float32).to(torch.bfloat16)
    params = dict(blk.named_parameters())

    def run(way):
        xi = x.detach().clone().requires_grad_(True)
        for p in params.values():
            p.grad = None
        out = blk(xi) if way == "forward" else surface_block_forward(
            pt, blk, xi)
        out.backward(dy)
        return out.detach(), xi.grad, {n: p.grad for n, p in params.items()}

    for _ in range(warmup):
        run("forward")
        run("surface")
    torch.cuda.synchronize()
    out_a, gx_a, gp_a = run("forward")
    K.reset_launch_counts()
    out_b, gx_b, gp_b = run("surface")
    torch.cuda.synchronize()
    launches = K.launch_counts()
    log(f"[surface 25b] gpt_1p3b block bf16 at [{B}, {S}, "
        f"{cfg.hidden_size}], one surface forward + backward: launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    want = {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1,
            "layer_norm": 2}
    for name, n in want.items():
        if launches[name] != n:
            fail(f"[surface 25b] {name} launched {launches[name]} times on "
                 f"the surface block's path, not {n}")
    worst = {"out": _rel_l2(out_b, out_a), "x.grad": _rel_l2(gx_b, gx_a)}
    for n in params:
        worst[n] = _rel_l2(gp_b[n], gp_a[n])
    log("  relative L2 error, surface vs GPTBlock.forward (tolerance "
        "1e-2): " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))
    if max(worst.values()) > 1e-2 or not bool(torch.isfinite(
            out_b.float()).all()):
        fail(f"[surface 25b] the surface block disagrees: {worst}")
    # one trace, logged: a trace late in this long process can lose device
    # events (PERF.md), so the counters above are what the run is held to
    from torch.profiler import ProfilerActivity, profile
    marks = {"flash_fwd": "flash_fwd_sm90", "flash_bwd_dq":
             "flash_bwd_dq_sm90", "flash_bwd_dkv": "flash_bwd_dkv_sm90",
             "layer_norm": "layer_norm_fwd"}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run("surface")
        torch.cuda.synchronize()
    names = [e.name for e in _device_events(prof)]
    traced = {k: sum(m in n for n in names) for k, m in marks.items()}
    log(f"  torch.profiler device kernels of one surface forward + "
        f"backward: {traced}")
    # pt.grad against backward on the surface way
    xi = x.detach().clone().requires_grad_(True)
    loss = pt.sum(pt.multiply(surface_block_forward(pt, blk, xi).float(),
                              dy.float()))
    (gx,) = pt.grad(loss, [xi])
    grad_err = _rel_l2(gx, gx_b)
    log(f"  pt.grad(loss, [x]) vs x.grad from backward(): relative L2 "
        f"{grad_err:.2e} (tolerance 1e-2)")
    if grad_err > 1e-2:
        fail(f"[surface 25b] pt.grad disagrees with backward: {grad_err}")
    times = {}
    for way in ("forward", "surface", "forward", "surface"):
        ts = []
        for i in range(warmup + iters):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(way)
            torch.cuda.synchronize()
            if i >= warmup:
                ts.append((time.perf_counter() - t0) * 1e3)
        times.setdefault(way, []).append(float(np.median(ts)))
    fwd_ms, surf_ms = min(times["forward"]), min(times["surface"])
    log(f"  host ms a forward + backward (median of {iters} after "
        f"{warmup}, two turns each): GPTBlock.forward "
        f"{times['forward']}, surface {times['surface']}; the surface's "
        f"own cost {surf_ms - fwd_ms:+.3f} ms")
    # LayerNorm at the block's rows, against its plain version and timed
    ln = layer_norm_timing(K, "surface 25b", B * S, cfg.hidden_size,
                           torch.bfloat16, cfg.layer_norm_epsilon, SEED + 27)
    return {"launches": launches, "traced": traced, "rel_l2": worst,
            "grad_rel_l2": grad_err, "forward_ms": times["forward"],
            "surface_ms": times["surface"], "layer_norm": ln}


def surface_sampling(pt, slots=16, vocab=50304, draws=4096, ps=0.9,
                     dev="cuda"):
    """Phase 25c: serving-shaped sampling at gpt_1p3b's vocabulary:
    ``top_p_sampling`` at ``ps`` (every id in its row's nucleus; the same
    ``seed`` repeats the ids; over ``draws`` draws of one row the total-
    variation distance to the renormalised nucleus at most 0.05),
    ``multinomial`` without replacement (no id repeats in a row), and
    ``topk`` equal to the CPU's. Each row puts most of its mass on 8
    tokens, as a trained model's next-token distribution does."""
    g = torch.Generator(device=dev).manual_seed(SEED + 26)
    logits = torch.randn(slots, vocab, device=dev, generator=g)
    hot = torch.randint(0, vocab, (slots, 8), device=dev, generator=g)
    logits.scatter_(1, hot, 12.0 + torch.randn(slots, 8, device=dev,
                                                generator=g))
    probs = torch.softmax(logits, -1)
    psv = torch.full((slots,), ps, device=dev)
    t0 = time.perf_counter()
    pt.seed(3)
    scores, ids = pt.top_p_sampling(probs, psv)
    pt.seed(3)
    _, ids2 = pt.top_p_sampling(probs, psv)
    torch.cuda.synchronize()
    if not torch.equal(ids, ids2):
        fail("[surface 25c] the same seed gave other ids")
    sp, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    keep = (torch.cumsum(sp, -1) - sp) < ps
    keep[:, 0] = True
    nucleus = [set(order[r][keep[r]].tolist()) for r in range(slots)]
    bad = [r for r in range(slots) if int(ids[r, 0]) not in nucleus[r]]
    if bad or ids.device.type != dev or ids.dtype != torch.int64:
        fail(f"[surface 25c] ids outside their nucleus in rows {bad}")
    if not torch.equal(scores, torch.gather(probs, 1, ids)):
        fail("[surface 25c] scores are not the chosen ids' probabilities")
    row = probs[:1].expand(draws, vocab).contiguous()
    _, many = pt.top_p_sampling(row, torch.full((draws,), ps, device=dev))
    counts = torch.bincount(many[:, 0], minlength=vocab).double() / draws
    target = torch.zeros(vocab, dtype=torch.float64, device=dev)
    kept = order[0][keep[0]]
    target[kept] = probs[0, kept].double()
    target /= target.sum()
    tv = 0.5 * float((counts - target).abs().sum())
    log(f"[surface 25c] top_p_sampling [{slots}, {vocab}] ps {ps}: every "
        f"id in its nucleus (sizes {sorted(len(n) for n in nucleus)}); "
        f"{draws} draws of row 0: total variation {tv:.4f} (limit 0.05)")
    if tv > 0.05:
        fail(f"[surface 25c] total variation {tv} over 0.05")
    m = pt.multinomial(probs, 32)
    if any(len(set(r)) != 32 for r in m.tolist()):
        fail("[surface 25c] multinomial without replacement repeated an id")
    vals, idx = pt.topk(probs, 50)
    cv, ci = pt.topk(probs.cpu(), 50)
    if not (torch.equal(vals.cpu(), cv) and torch.equal(idx.cpu(), ci)):
        fail("[surface 25c] topk on the card differs from the CPU's")
    torch.cuda.synchronize()
    log(f"  multinomial [{slots}, 32] without replacement: no repeats; "
        f"topk(50) equal to the CPU's; phase 25c in "
        f"{time.perf_counter() - t0:.2f} s")
    return {"tv": tv, "nucleus_sizes": sorted(len(n) for n in nucleus)}


def surface_overhead(pt, n=5000):
    """Phase 25d: host us a call of ``pt.add`` (tensor and Python-number
    operands, f32 and bf16), ``pt.multiply`` and ``pt.clip`` with
    numbers, ``pt.add_``,
    ``pt.reshape``, ``pt.matmul`` and ``pt.sum`` against the bare torch
    call on a small CUDA tensor (the wrapper's own cost: the AMP lookup,
    the dtype handling, a number's fill on the device); two turns each,
    the lower taken."""
    x = torch.randn(64, 64, device="cuda")
    y = torch.randn(64, 64, device="cuda")
    z = torch.randn(64, 64, device="cuda")
    xb = x.to(torch.bfloat16)
    pairs = {
        "add": (lambda: pt.add(x, y), lambda: torch.add(x, y)),
        "add(x, 1.0)": (lambda: pt.add(x, 1.0), lambda: torch.add(x, 1.0)),
        "add(bf16 x, 1.0)": (lambda: pt.add(xb, 1.0),
                             lambda: torch.add(xb, 1.0)),
        "multiply(x, 0.5)": (lambda: pt.multiply(x, 0.5),
                             lambda: torch.mul(x, 0.5)),
        "clip(x, 0.0, 6.0)": (lambda: pt.clip(x, 0.0, 6.0),
                              lambda: torch.clamp(x, 0.0, 6.0)),
        "add_": (lambda: pt.add_(z, y), lambda: z.add_(y)),
        "reshape": (lambda: pt.reshape(x, [32, 128]),
                    lambda: torch.reshape(x, (32, 128))),
        "matmul": (lambda: pt.matmul(x, y), lambda: torch.matmul(x, y)),
        "sum": (lambda: pt.sum(x), lambda: torch.sum(x)),
    }
    out = {}
    for name, (ours, bare) in pairs.items():
        res = {"pt": [], "torch": []}
        for _ in range(2):
            for label, fn in (("pt", ours), ("torch", bare)):
                for _ in range(200):
                    fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(n):
                    fn()
                res[label].append((time.perf_counter() - t0) * 1e6 / n)
                torch.cuda.synchronize()
        out[name] = {"pt_us": min(res["pt"]), "torch_us": min(res["torch"])}
    log("[surface 25d] host us a call on a [64, 64] CUDA tensor (pt vs "
        "bare torch, lower of two turns of "
        f"{n}): " + "; ".join(f"{k} {v['pt_us']:.2f} vs "
                              f"{v['torch_us']:.2f} "
                              f"(+{v['pt_us'] - v['torch_us']:.2f})"
                              for k, v in out.items()))
    return out


def surface_phases(pt, K):
    """Phase 25: the tensor op surface on the card (25a-25d). -> ({kernel:
    numbers for its JSON entry}, the phase's numbers)"""
    t0 = time.perf_counter()
    worst, n_ops, n_cases = surface_sweep(pt)
    blk = surface_block(pt, K)
    gc.collect()
    torch.cuda.empty_cache()
    samp = surface_sampling(pt)
    over = surface_overhead(pt)
    log(f"[surface] phase 25 in {time.perf_counter() - t0:.1f} s")
    extra = {name: {"surface_launches": blk["launches"][name]}
             for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                          "layer_norm")}
    extra["layer_norm"].update(
        {f"surface_{k}": v for k, v in blk["layer_norm"].items()})
    return extra, {"sweep": worst, "ops": n_ops, "cases": n_cases,
                   "block": blk, "sampling": samp, "overhead": over}


# ------------------------------------------------------------- phase 26
def user_bert(pt, vocab=30522, hidden=768, layers=12, heads=12, ffn=3072,
              max_len=512, num_classes=2):
    """Phase 26's model: a BERT-base classifier as a Paddle user writes it,
    a subclass of ``pt.nn.Layer`` built from the port's layers with
    per-parameter attributes: the word embeddings at half the rate with a
    padding row, a frozen position table of its own
    (``create_parameter`` with ``trainable=False``), encoder layers drawn
    from ``TruncatedNormal(std=0.02)``, and a head at ten times the rate
    whose bias the global clip passes through (``need_clip=False``)."""
    nn, init = pt.nn, pt.nn.initializer

    class UserBert(nn.Layer):
        def __init__(self):
            super().__init__()
            self.word = nn.Embedding(
                vocab, hidden, padding_idx=0,
                weight_attr=pt.ParamAttr(learning_rate=0.5))
            self.pos = self.create_parameter(
                [max_len, hidden], attr=pt.ParamAttr(trainable=False),
                default_initializer=init.TruncatedNormal(std=0.02))
            layer = nn.TransformerEncoderLayer(
                hidden, heads, ffn, dropout=0.0, activation="gelu",
                weight_attr=pt.ParamAttr(
                    initializer=init.TruncatedNormal(std=0.02)))
            self.encoder = nn.TransformerEncoder(layer, layers)
            self.norm = nn.LayerNorm(hidden, epsilon=1e-12)
            self.head = nn.Linear(
                hidden, num_classes,
                weight_attr=pt.ParamAttr(learning_rate=10.0),
                bias_attr=pt.ParamAttr(need_clip=False))

        def forward(self, ids):
            x = self.norm(pt.add(self.word(ids), self.pos[:ids.shape[1]]))
            return self.head(self.encoder(x)[:, 0])

    return UserBert()


def user_bert_batch(pt, B, S, vocab, seed=SEED):
    """A batch of B token sequences of length S on the current device:
    ids from numpy ``seed`` whose last S / 8 tokens are padding (id 0),
    labelled by the parity of the second token."""
    ids = np.random.RandomState(seed).randint(1, vocab, (B, S))
    ids[:, S - S // 8:] = 0
    labels = (ids[:, 1] % 2).astype(np.int64)
    dev = pt.resolve_device(None)
    return (torch.from_numpy(ids).to(dev),
            torch.from_numpy(labels).to(dev))


def adamw_reference(w, g, m, v, t, lr, wd, beta1=0.9, beta2=0.999,
                    eps=1e-8):
    """``torch.optim.AdamW``'s update of a copy of ``w`` with gradient
    ``g`` from moments ``m``, ``v`` after ``t - 1`` steps, at rate ``lr``
    -> the new value."""
    w = w.detach().clone().requires_grad_(True)
    opt = torch.optim.AdamW([w], lr=lr, betas=(beta1, beta2), eps=eps,
                            weight_decay=wd, foreach=False, fused=False)
    opt.state[w] = {"step": torch.tensor(float(t - 1)),
                    "exp_avg": m.clone(), "exp_avg_sq": v.clone()}
    w.grad = g.clone()
    opt.step()
    return w.detach()


def check_scaled_update(tag, before, after, lr, wd, scale, t):
    """One replayed step's update of one tensor (``before`` and ``after``:
    its value, first and second moments) against
    :func:`adamw_reference` at ``lr * scale``. The step's gradient (after
    the clip) is recovered from the moments, ``g = (m' - b1 m) / (1 -
    b1)``. The update must match the scaled rate's within 1e-3 of its
    size, and miss the unscaled rate's. -> the largest difference"""
    w0, m0, v0 = before
    w1, m1, v1 = after
    g = (m1 - 0.9 * m0) / 0.1
    want = adamw_reference(w0, g, m0, v0, t, lr * scale, wd)
    plain = adamw_reference(w0, g, m0, v0, t, lr, wd)
    step, ref = (w1 - w0).abs().max(), (want - w0).abs().max()
    err = float((w1 - want).abs().max())
    miss = float((w1 - plain).abs().max())
    tol = 1e-3 * float(ref) + 1e-7
    log(f"  [{tag}] replayed update at lr x {scale:g}: max |dw| "
        f"{float(step):.3e}, against torch's AdamW at the scaled rate "
        f"{err:.3e} (tolerance {tol:.3e}), at the unscaled rate {miss:.3e}")
    if not err <= tol or not miss > 10 * tol or float(step) == 0.0:
        fail(f"layer {tag}: the replayed update is not AdamW's at lr x "
             f"{scale:g} (error {err:.3e}, unscaled {miss:.3e}, tolerance "
             f"{tol:.3e})")
    return err


def layer_staged(pt, K, B=32, S=128, steps=20, dims=None):
    """Phase 26a and 26b: :func:`user_bert` (BERT-base widths by default,
    f32 weights) trained on one batch (:func:`user_bert_batch`) under O1
    bf16 with ``AdamW(2e-5, weight_decay=0.01)`` and
    ``ClipGradByGlobalNorm(1.0)``, eager and through ``pt.jit.to_static``
    (whole step): 1 graph and 0 breaks; launches over ``steps`` replays
    exactly the flash trio once a layer, LayerNorm once a ``LayerNorm`` of
    the model and fused AdamW once a step; losses finite and falling; the
    frozen position table and the padding row bit-unchanged; one more
    replay's update of the head weight (rate x 10) and of an embedding row
    (x 0.5) against torch's AdamW at the scaled rate. Then 26b: the
    step-0 state saved and loaded with ``pt.save`` / ``pt.load`` and set
    into the staged model between replays: the next replay's loss is the
    eager run's step-0 loss; a wrong shape raises ``ValueError``; missing
    and unexpected keys are returned. -> (launches over the replays,
    numbers)"""
    dims = dims or {}
    vocab = dims.get("vocab", 30522)
    F = pt.nn.functional
    ids, labels = user_bert_batch(pt, B, S, vocab)
    init = {}

    def build():
        pt.seed(SEED)
        model = user_bert(pt, **dims)
        init["pos"] = model.pos.detach().clone()
        init["pad"] = model.word.weight[0].detach().clone()
        init["state"] = {k: v.detach().clone()
                         for k, v in model.state_dict().items()}
        opt = pt.AdamW(2e-5, parameters=model.parameters(),
                       weight_decay=0.01,
                       grad_clip=pt.nn.ClipGradByGlobalNorm(1.0))

        def train_step(x, y):
            with pt.auto_cast(level="O1", dtype="bfloat16"):
                loss = F.cross_entropy(model(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        return model, opt, None, train_step, (ids, labels)

    eager = train_run(pt, build, False, 2, 5)
    eager_loss0 = eager["losses"][0]
    del eager["model"], eager["opt"], eager["step"]
    free()
    staged = train_run(pt, build, True, 2, steps)
    model, opt, step = staged["model"], staged["opt"], staged["step"]
    L = len(model.encoder.layers)
    n_ln = sum(isinstance(m, pt.nn.LayerNorm) for m in model.sublayers())
    stats = step.stats()
    n_all = sum(p.numel() for p in model.parameters())
    n_frozen = sum(p.numel() for p in model.parameters() if not p.trainable)
    log(f"[layer] user-written BERT-base nn.Layer: {L} layers, "
        f"{n_all / 1e6:.3f} M parameters ({n_frozen / 1e6:.3f} M frozen), "
        f"{n_ln} LayerNorms; staging {stats}")
    if stats["graphs"] != 1 or stats["graph_breaks"] or \
            stats["eager_calls"]:
        fail(f"layer: staging {stats}")
    check_training("layer", staged["losses"], 2, staged["launches"], {
        "flash_fwd": steps * L, "flash_bwd_dq": steps * L,
        "flash_bwd_dkv": steps * L, "layer_norm": steps * n_ln,
        "fused_adamw": steps})
    if not torch.equal(model.pos.detach(), init["pos"]) or \
            not torch.equal(model.word.weight[0].detach(), init["pad"]):
        fail("layer: the frozen position table or the padding row moved")
    if float(init["pad"].abs().max()) != 0.0:
        fail("layer: the padding row was not zeroed at creation")
    log(f"  frozen position table and padding row bit-unchanged after "
        f"{steps + 3} staged steps ({steps + 1} replays)")
    # one more replay, its update held against torch's AdamW
    row = int(ids[0, 1])
    tensors = {"head.weight": (model.head.weight, 10.0, slice(None)),
               f"word.weight[{row}]": (model.word.weight, 0.5, row)}
    acc = opt._accumulators
    snap = {}
    for name, (p, scale, idx) in tensors.items():
        snap[name] = [t[idx].detach().clone() for t in (
            p, acc["moment1"][p], acc["moment2"][p])]
    t = acc["beta_pow"][model.head.weight] + 1
    loss_t = float(step(ids, labels))
    update_err = {}
    for name, (p, scale, idx) in tensors.items():
        after = [t_[idx].detach().clone() for t_ in (
            p, acc["moment1"][p], acc["moment2"][p])]
        update_err[name] = check_scaled_update(
            name, snap[name], after, opt.get_lr(), 0.01, scale, t)
    # 26b: the step-0 state through pt.save / pt.load, into the staged model
    with tempfile.TemporaryDirectory() as work:
        path = os.path.join(work, "user_bert.pdparams")
        pt.save(init["state"], path)
        state = pt.load(path)
        saved_bytes = os.path.getsize(path)
    ptrs = [p.data_ptr() for p in model.parameters()]
    missing, unexpected = model.set_state_dict(state)
    if missing or unexpected or ptrs != [p.data_ptr()
                                         for p in model.parameters()]:
        fail(f"layer: set_state_dict missing {missing}, unexpected "
             f"{unexpected}, or a parameter's storage moved")
    loss_load = float(step(ids, labels))
    spread = abs(eager_loss0 - staged["losses"][0])
    tol = max(spread, 2e-5 * abs(eager_loss0))
    log(f"  [set_state_dict] step-0 state saved ({saved_bytes} bytes) "
        f"and loaded between replays: next replay's loss "
        f"{loss_load:.6f} vs the eager run's step 0 {eager_loss0:.6f} "
        f"(diff {abs(loss_load - eager_loss0):.3e}; eager vs eager "
        f"step 0 {spread:.3e}; tolerance {tol:.3e}); the replay before "
        f"the load {loss_t:.6f}")
    if abs(loss_load - eager_loss0) > tol:
        fail(f"layer: the replay after set_state_dict gave {loss_load} "
             f"where the eager step 0 gave {eager_loss0}")
    try:
        model.set_state_dict({"head.weight": torch.zeros(3, 3)})
        fail("layer: a wrong shape did not raise")
    except ValueError as e:
        log(f"  [set_state_dict] a wrong shape raises ValueError: {e}")
    partial = dict(state)
    del partial["head.bias"]
    partial["head.extra"] = torch.zeros(1)
    got = model.set_state_dict(partial)
    if got != (["head.bias"], ["head.extra"]):
        fail(f"layer: set_state_dict returned {got}")
    log(f"  [set_state_dict] missing / unexpected keys returned: {got}")
    numbers = report_pair("layer", eager, staged, {
        "losses": staged["losses"], "update_err": update_err,
        "loss_after_load": loss_load, "eager_loss0": eager_loss0})
    launches = staged["launches"]
    del model, opt, step, staged, eager
    free()
    return launches, numbers


def layer_initializers(pt, shape=(768, 3072), dev="cuda"):
    """Phase 26c: each initializer at ``shape`` drawn on the card from a
    CUDA generator and held by its support and moments (five standard
    errors): Xavier and Kaiming standard deviations from the fans,
    TruncatedNormal within its bounds, Uniform's, ``QQ^T = I`` for
    Orthogonal within 1e-4, Constant and Assign exact; ``pt.seed`` and a
    generator repeat a draw. -> {name: (mean, std)}"""
    I = pt.nn.initializer
    rows, cols = shape
    n = rows * cols
    g = torch.Generator(device=dev).manual_seed(SEED)
    xn = math.sqrt(2.0 / (rows + cols))
    xu = math.sqrt(6.0 / (rows + cols))
    kn = math.sqrt(2.0 / rows)
    ku = math.sqrt(2.0) * math.sqrt(3.0 / rows)
    pdf = lambda v: math.exp(-v * v / 2) / math.sqrt(2 * math.pi)  # noqa
    z = math.erf(2 / math.sqrt(2))
    tn_std = 0.02 * math.sqrt(1 - 2 * 2 * pdf(2) / z)
    inf = math.inf
    cases = {
        "Normal": (I.Normal(0.0, 0.02), 0.0, 0.02, -inf, inf),
        "TruncatedNormal": (I.TruncatedNormal(std=0.02), 0.0, tn_std,
                            -0.04, 0.04),
        "Uniform": (I.Uniform(-0.1, 0.3), 0.1, 0.4 / math.sqrt(12), -0.1,
                    0.3),
        "XavierNormal": (I.XavierNormal(), 0.0, xn, -inf, inf),
        "XavierUniform": (I.XavierUniform(), 0.0, xu / math.sqrt(3), -xu,
                          xu),
        "KaimingNormal": (I.KaimingNormal(), 0.0, kn, -inf, inf),
        "KaimingUniform": (I.KaimingUniform(), 0.0, ku / math.sqrt(3), -ku,
                           ku)}
    out = {}
    t0 = time.perf_counter()
    for name, (init, mean, std, lo, hi) in cases.items():
        x = init(shape, generator=g)
        if x.device.type != dev or x.dtype != torch.float32:
            fail(f"layer initializers: {name} gave {x.dtype} on {x.device}")
        m, s = float(x.mean()), float(x.std())
        lo_x, hi_x = float(x.min()), float(x.max())
        out[name] = (m, s)
        if abs(m - mean) > 5 * std / math.sqrt(n) or \
                abs(s - std) > 5 * std / math.sqrt(n / 2) or \
                lo_x < lo - 1e-7 or hi_x > hi + 1e-7:
            fail(f"layer initializers: {name} mean {m:.4e} std {s:.4e} "
                 f"range [{lo_x:.4e}, {hi_x:.4e}] against mean {mean:.4e} "
                 f"std {std:.4e} support [{lo}, {hi}]")
        log(f"  [26c] {name} {list(shape)}: mean {m:+.3e} (want {mean:+.3e}"
            f"), std {s:.5e} (want {std:.5e}), range [{lo_x:.4e}, "
            f"{hi_x:.4e}]")
    q = I.Orthogonal()(shape, generator=g)
    gram_err = float((q @ q.T - torch.eye(rows, device=dev)).abs().max())
    log(f"  [26c] Orthogonal {list(shape)}: max |QQ^T - I| {gram_err:.3e}")
    if gram_err > 1e-4:
        fail(f"layer initializers: Orthogonal's QQ^T is off I by "
             f"{gram_err:.3e}")
    c = I.Constant(0.125)(shape, "bfloat16")
    a = I.Assign(q)(shape)
    if not bool((c == 0.125).all()) or c.dtype != torch.bfloat16 or \
            not torch.equal(a, q) or a.data_ptr() == q.data_ptr():
        fail("layer initializers: Constant or Assign")
    pt.seed(5)
    d1 = I.XavierUniform()(shape)
    pt.seed(5)
    d2 = I.XavierUniform()(shape)
    g.manual_seed(9)
    e1 = I.TruncatedNormal(std=0.02)(shape, generator=g)
    g.manual_seed(9)
    e2 = I.TruncatedNormal(std=0.02)(shape, generator=g)
    if not torch.equal(d1, d2) or not torch.equal(e1, e2) or \
            d1.device.type != dev:
        fail("layer initializers: pt.seed or a generator did not repeat a "
             "draw")
    torch.cuda.synchronize()
    log(f"  [26c] Constant and Assign exact, pt.seed and a CUDA generator "
        f"repeat their draws; {time.perf_counter() - t0:.2f} s")
    out["orthogonal_gram_err"] = gram_err
    return out


def layer_call_overhead(pt, n=500, reps=8, B=32, S=128, H=768,
                        dev="cuda"):
    """Phase 26d: host us a call of ``layer(x)`` and ``layer.forward(x)``
    for ``pt.nn.Linear(H, H)`` on [B, S, H] bf16, beside the same for a
    bare ``torch.nn.Linear`` (the median of ``reps`` loops of ``n`` calls
    each, the four taken in a rotated order each time; the card keeps up
    with these launches, so the host sets the pace). -> {"<which>_us": us
    a call, "port_gap_us", "torch_gap_us"}"""
    x = torch.randn(B, S, H, device=dev, dtype=torch.bfloat16)
    port = pt.nn.Linear(H, H, dtype=torch.bfloat16)
    bare = torch.nn.Linear(H, H, device=dev, dtype=torch.bfloat16)
    fns = {"port_call": lambda: port(x), "port_forward":
           lambda: port.forward(x), "torch_call": lambda: bare(x),
           "torch_forward": lambda: bare.forward(x)}
    us = {k: [] for k in fns}
    order = list(fns)
    with torch.no_grad():
        for r in range(reps):
            for k in order[r % 4:] + order[:r % 4]:
                fn = fns[k]
                for _ in range(20):
                    fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(n):
                    fn()
                us[k].append((time.perf_counter() - t0) * 1e6 / n)
                torch.cuda.synchronize()
    out = {f"{k}_us": float(np.median(v)) for k, v in us.items()}
    out["port_gap_us"] = out["port_call_us"] - out["port_forward_us"]
    out["torch_gap_us"] = out["torch_call_us"] - out["torch_forward_us"]
    log(f"  [26d] host us a call, Linear({H}, {H}) on [{B}, {S}, {H}] "
        f"bf16: " + ", ".join(f"{k} {v:.2f}" for k, v in out.items()))
    return out


def layer_phases(pt, K):
    """Phase 26: ``nn.Layer``, ``nn.initializer`` and ``ParamAttr`` on the
    card (26a-26d). -> ({kernel: numbers for its JSON entry}, the phase's
    numbers)"""
    t0 = time.perf_counter()
    launches, staged = layer_staged(pt, K)
    inits = layer_initializers(pt)
    over = layer_call_overhead(pt)
    log(f"[layer] phase 26 in {time.perf_counter() - t0:.1f} s")
    extra = {name: {"layer_launches": n} for name, n in launches.items()}
    return extra, {"staged": staged, "initializers": inits,
                   "overhead": over}


# ------------------------------------------------------------- phase 27
def case_table(name):
    """A JAX-free case table of ``tests/`` (``torch_nn_cases``,
    ``torch_incubate_cases``)."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    return importlib.import_module(name)


def nn_sweep(pt, where="cuda"):
    """Phase 27a: every case of ``tests/torch_nn_cases.py`` on the card
    against the same call on CPU tensors (:func:`case_sweep`). -> {op:
    worst error}"""
    return case_sweep(pt, case_table("torch_nn_cases"), "nn 27a", where)


def case_sweep(pt, C, tag, where="cuda"):
    """Every case of the table ``C`` on the card against the same call on
    CPU tensors: each output on the card with the CPU's dtype and shape,
    values and every gradient within the table's f32 tolerance. -> {op:
    worst error}"""
    worst = {}
    t0 = time.perf_counter()
    for case in C.CASES:
        cpu, cpu_g, _ = C.run(pt, case, "cpu")
        dev, dev_g, where_out = C.run(pt, case, where)
        if any(d != where for d in where_out):
            fail(f"[{tag}] {case[0]}: outputs on {where_out}")
        if len(cpu) != len(dev) or len(cpu_g) != len(dev_g):
            fail(f"[{tag}] {case[0]}: {len(dev)} outputs / {len(dev_g)} "
                 f"gradients on the card, {len(cpu)} / {len(cpu_g)} on "
                 f"the CPU")
        err = 0.0
        for a, b in zip(cpu + cpu_g, dev + dev_g):
            if a is None or b is None:
                if (a is None) != (b is None):
                    fail(f"[{tag}] {case[0]}: a gradient missing on one "
                         f"side")
                continue
            if a.dtype != b.dtype or a.shape != b.shape:
                fail(f"[{tag}] {case[0]}: {b.dtype} {list(b.shape)} on "
                     f"the card != {a.dtype} {list(a.shape)}")
            if not a.is_floating_point():
                if not torch.equal(a, b):
                    fail(f"[{tag}] {case[0]}: integer outputs differ")
                continue
            d = (a.double() - b.double()).abs()
            if not bool((d <= C.ATOL + C.RTOL * a.double().abs()).all()):
                fail(f"[{tag}] {case[0]}: max abs err {float(d.max()):.3e}"
                     f" over rtol {C.RTOL:g} / atol {C.ATOL:g}")
            err = max(err, float(d.max()) if d.numel() else 0.0)
        worst[case[0]] = err
    pt.set_device(where)
    top = sorted(worst.items(), key=lambda kv: -kv[1])
    log(f"[{tag}] {len(C.CASES)} cases on the card vs the CPU in "
        f"{time.perf_counter() - t0:.2f} s (rtol {C.RTOL:g} / atol "
        f"{C.ATOL:g}); worst errors: " + ", ".join(
            f"{k} {v:.3e}" for k, v in top[:12]))
    log("  every case's worst error: " + json.dumps(
        {k: float(f"{v:.3e}") for k, v in worst.items()}))
    return worst


def sinusoid(n, d):
    """The Transformer's sinusoidal position table [n, d], made with numpy."""
    pos = np.arange(n)[:, None] / np.power(
        10000.0, 2 * (np.arange(d)[None, :] // 2) / d)
    return np.where(np.arange(d) % 2 == 0, np.sin(pos),
                    np.cos(pos)).astype(np.float32)


def conformer_transducer(pt, d_model=256, heads=4, blocks=16, ffn=1024,
                         kernel=32, n_mels=80, pred=640, vocab=1024,
                         dropout=0.1, max_frames=1024, ctc_weight=0.3):
    """Phase 27's model: a Conformer-Transducer written as a Paddle user
    writes it, against ``pt.nn`` / ``pt.nn.functional`` (Conformer-M of
    Gulati et al. 2020, arXiv:2005.08100, Table 1, by default). ``pt`` is
    the port here; ``tests/test_torch_port_conformer.py`` builds this body
    at tiny widths over both packages. The
    subsampling is ``Conv2D(1, d, 3, 2)``, ReLU, ``Conv2D(d, d, 3, 2)``,
    ReLU and ``Linear(d * F', d)`` plus a sinusoidal table: the paper's
    relative positions are not in the JAX package's ``nn``, so the
    positions are absolute. Each block: half-step feed-forward, attention
    (``MultiHeadAttention``, dropout on its output), the convolution
    module (pointwise ``Conv1D`` to 2d, ``glu``, ``pad`` of the even
    kernel [15, 16], depthwise ``Conv1D`` without bias, since the
    ``BatchNorm1D`` after it cancels one, ``swish``, pointwise
    ``Conv1D``), half-step feed-forward, and ``F.layer_norm``. The
    predictor embeds the blank-prefixed labels into ``LSTM(pred,
    pred)``; the joint sums ``Linear(d, pred)`` and ``Linear(pred,
    pred)`` over [B, T, U + 1, pred], then tanh and ``Linear(pred,
    vocab)``. The loss is ``rnnt_loss`` + ``ctc_weight`` x ``ctc_loss``
    of a ``Linear(d, vocab)`` head's log-softmax."""
    nn, F = pt.nn, pt.nn.functional

    class FeedForward(nn.Layer):
        def __init__(self):
            super().__init__()
            self.norm = nn.LayerNorm(d_model)
            self.fc1 = nn.Linear(d_model, ffn)
            self.drop = nn.Dropout(dropout)
            self.fc2 = nn.Linear(ffn, d_model)

        def forward(self, x):
            return self.fc2(self.drop(F.swish(self.fc1(self.norm(x)))))

    class ConvModule(nn.Layer):
        def __init__(self):
            super().__init__()
            self.norm = nn.LayerNorm(d_model)
            self.pw1 = nn.Conv1D(d_model, 2 * d_model, 1)
            self.dw = nn.Conv1D(d_model, d_model, kernel, groups=d_model,
                                bias_attr=False)
            self.bn = nn.BatchNorm1D(d_model)
            self.pw2 = nn.Conv1D(d_model, d_model, 1)
            self.drop = nn.Dropout(dropout)

        def forward(self, x):
            y = pt.transpose(self.norm(x), [0, 2, 1])
            y = F.glu(self.pw1(y), axis=1)
            y = F.pad(y, [(kernel - 1) // 2, kernel // 2], data_format="NCL")
            y = F.swish(self.bn(self.dw(y)))
            return pt.transpose(self.drop(self.pw2(y)), [0, 2, 1])

    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.ff1 = FeedForward()
            self.attn_norm = nn.LayerNorm(d_model)
            self.attn = nn.MultiHeadAttention(d_model, heads, dropout=0.0)
            self.attn_drop = nn.Dropout(dropout)
            self.conv = ConvModule()
            self.ff2 = FeedForward()
            self.out_w = self.create_parameter(
                [d_model], default_initializer=nn.initializer.Constant(1.0))
            self.out_b = self.create_parameter([d_model], is_bias=True)

        def forward(self, x):
            x = x + 0.5 * self.ff1(x)
            h = self.attn_norm(x)
            x = x + self.attn_drop(self.attn(h, h, h))
            x = x + self.conv(x)
            x = x + 0.5 * self.ff2(x)
            return F.layer_norm(x, [d_model], self.out_w, self.out_b)

    class ConformerTransducer(nn.Layer):
        def __init__(self):
            super().__init__()
            self.sub1 = nn.Conv2D(1, d_model, 3, 2)
            self.sub2 = nn.Conv2D(d_model, d_model, 3, 2)
            f = ((n_mels - 1) // 2 - 1) // 2
            self.proj = nn.Linear(d_model * f, d_model)
            self.register_buffer("pos", pt.to_tensor(
                sinusoid(max_frames, d_model)), persistable=False)
            self.blocks = nn.LayerList([Block() for _ in range(blocks)])
            self.ctc_head = nn.Linear(d_model, vocab)
            self.embed = nn.Embedding(vocab, pred)
            self.lstm = nn.LSTM(pred, pred)
            self.joint_enc = nn.Linear(d_model, pred)
            self.joint_pred = nn.Linear(pred, pred)
            self.joint_out = nn.Linear(pred, vocab)

        def encode(self, feats):
            x = F.relu(self.sub1(pt.unsqueeze(feats, 1)))
            x = F.relu(self.sub2(x))
            b, c, t, f = x.shape
            x = pt.reshape(pt.transpose(x, [0, 2, 1, 3]), [b, t, c * f])
            x = self.proj(x) + self.pos[:t]
            for blk in self.blocks:
                x = blk(x)
            return x

        def forward(self, feats, labels, label_lengths):
            enc = self.encode(feats)
            b, t = enc.shape[0], enc.shape[1]
            enc_len = pt.full([b], t, dtype="int64")
            ids = pt.concat([pt.zeros([b, 1], dtype="int64"), labels], axis=1)
            g, _ = self.lstm(self.embed(ids))
            joint = pt.tanh(pt.unsqueeze(self.joint_enc(enc), 2)
                            + pt.unsqueeze(self.joint_pred(g), 1))
            rnnt = F.rnnt_loss(self.joint_out(joint), labels, enc_len,
                               label_lengths)
            lp = pt.transpose(F.log_softmax(self.ctc_head(enc), -1),
                              [1, 0, 2])
            ctc = F.ctc_loss(lp, labels, enc_len, label_lengths)
            return rnnt + ctc_weight * ctc

    return ConformerTransducer()


def conformer_batch(pt, B, frames, n_mels, U, vocab, seed=SEED):
    """B utterances of ``frames`` 80-bin log-mel-like frames (numpy
    normals, every utterance full length: a length-bucketed batch) and
    labels of 32-64 random word-piece ids (1..vocab-1; 0 is the blank)
    padded to ``U``, on the current device."""
    rng = np.random.RandomState(seed)
    feats = rng.randn(B, frames, n_mels).astype(np.float32)
    labels = rng.randint(1, vocab, (B, U)).astype(np.int64)
    lens = rng.randint(U // 2, U + 1, (B,)).astype(np.int64)
    dev = pt.resolve_device(None)
    return tuple(torch.from_numpy(a).to(dev) for a in (feats, labels, lens))


def nn_conformer(pt, K, B=16, frames=1024, U=64, warmup=2, steps=10,
                 eager_steps=3, dims=None):
    """Phase 27b. The flash trio at the model's attention shape (held
    against the plain versions, timed), LayerNorm at its rows, then the
    Conformer-Transducer trained eager and staged (the module's doc).
    The schedule starts at its peak (``last_epoch=9999``, a run resumed
    at the end of its 10000 warm-up steps), where a dozen steps move the
    loss. -> (launches over the replays, kernel numbers, the phase's
    numbers, the trained model)"""
    dims = dims or {}
    d = dims.get("d_model", 256)
    heads = dims.get("heads", 4)
    T = ((frames - 1) // 2 - 1) // 2
    kern = {}
    for name, numbers in flash_timing(K, "nn 27b", B, T, heads, d // heads,
                                      SEED + 27).items():
        kern[name] = {f"t255_{k}": v for k, v in numbers.items()}
    ln = layer_norm_timing(K, "nn 27b", B * T, d, torch.float32, 1e-5,
                           SEED + 28)
    kern["layer_norm"] = {f"conformer_{k}": v for k, v in ln.items()}
    feats, labels, lens = conformer_batch(
        pt, B, frames, dims.get("n_mels", 80), U, dims.get("vocab", 1024))

    def build():
        pt.seed(SEED)
        model = conformer_transducer(pt, **dims)
        sched = pt.optimizer.lr.NoamDecay(d_model=d, warmup_steps=10000,
                                          last_epoch=9999)
        opt = pt.AdamW(learning_rate=sched, beta1=0.9, beta2=0.98,
                       epsilon=1e-9, weight_decay=1e-6,
                       parameters=model.parameters())

        def train_step(x, y, n):
            with pt.auto_cast(level="O1", dtype="bfloat16"):
                loss = model(x, y, n)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        return model, opt, sched, train_step, (feats, labels, lens)

    eager = train_run(pt, build, False, warmup, eager_steps)
    eager_loss0 = eager["losses"][0]
    kern["fused_adamw"] = {f"conformer_{k}": v for k, v in
                           adamw_f32_timing(K, eager["model"],
                                            "nn 27b").items()}
    del eager["model"], eager["opt"], eager["step"]
    free()
    staged = train_run(pt, build, True, warmup, steps)
    model, step = staged["model"], staged["step"]
    L = len(model.blocks)
    n_ln = sum(isinstance(m, pt.nn.LayerNorm) for m in model.sublayers()) \
        + L
    stats = step.stats()
    n_all = sum(p.numel() for p in model.parameters())
    log(f"[nn 27b] user-written Conformer-Transducer: {L} blocks, "
        f"{n_all / 1e6:.3f} M parameters, {n_ln} LayerNorms a forward "
        f"(F.layer_norm included); B {B} x {frames} frames -> T {T}, "
        f"U + 1 = {U + 1}; staging {stats}")
    if stats["graphs"] != 1 or stats["graph_breaks"] or \
            stats["eager_calls"]:
        fail(f"nn conformer: staging {stats}")
    check_training("nn conformer", staged["losses"], warmup,
                   staged["launches"], {
                       "flash_fwd": steps * L, "flash_bwd_dq": steps * L,
                       "flash_bwd_dkv": steps * L,
                       "layer_norm": steps * n_ln, "fused_adamw": steps})
    diff = abs(staged["losses"][0] - eager_loss0)
    log(f"  [nn 27b] staged step-0 loss {staged['losses'][0]:.6f} vs the "
        f"eager run's {eager_loss0:.6f} (diff {diff:.3e}; tolerance "
        f"{1e-4 * abs(eager_loss0):.3e}); eager losses "
        + " ".join(f"{x:.4f}" for x in eager["losses"]))
    if diff > 1e-4 * abs(eager_loss0):
        fail(f"nn conformer: staged step 0 {staged['losses'][0]} vs eager "
             f"{eager_loss0}")
    numbers = report_pair("nn conformer", eager, staged, {
        "losses": staged["losses"], "eager_losses": eager["losses"],
        "params_m": n_all / 1e6, "T": T, "U1": U + 1})
    for (fam, name), ms in staged["top"][:8]:
        log(f"    [nn 27b] staged, profiled step: {ms:.3f} ms  [{fam}] "
            f"{name[:90]}")
    numbers["losses_alone"] = nn_loss_timing(pt, B, T, U,
                                             dims.get("vocab", 1024))
    launches = staged["launches"]
    del staged["opt"], staged["step"], eager
    return launches, kern, numbers, model


def nn_loss_timing(pt, B, T, U, V, seed=SEED + 30):
    """RNN-T and CTC alone at the model's shapes (bf16 joint logits [B, T,
    U + 1, V]; f32 log-probabilities [T, B, V]; labels of 32-64 tokens),
    forward and backward: eager (device ms from the trace, host ms a call)
    and replayed from a CUDA graph captured here (device ms). -> numbers"""
    F = pt.nn.functional
    g = torch.Generator(device="cuda").manual_seed(seed)
    logits = torch.randn(B, T, U + 1, V, device="cuda", generator=g) \
        .bfloat16().requires_grad_(True)
    lp = torch.randn(T, B, V, device="cuda", generator=g) \
        .log_softmax(-1).requires_grad_(True)
    lab = torch.randint(1, V, (B, U), device="cuda", generator=g)
    in_len = torch.full((B,), T, device="cuda", dtype=torch.int64)
    lab_len = torch.randint(U // 2, U + 1, (B,), device="cuda", generator=g)
    calls = {"rnnt_loss": lambda: torch.autograd.grad(
        F.rnnt_loss(logits, lab, in_len, lab_len), logits),
        "ctc_loss": lambda: torch.autograd.grad(
            F.ctc_loss(lp, lab, in_len, lab_len), lp)}
    out = {}
    for name, fn in calls.items():
        ms, wall, src = time_ms(fn, iters=1, warmup=1)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        g_ms, g_wall, g_src = time_ms(graph.replay, iters=3, warmup=1)
        log(f"[nn 27b] {name} forward + backward alone: eager {ms:.3f} ms "
            f"of device time ({src}), {wall:.3f} ms a call on the host; "
            f"replayed from one CUDA graph {g_ms:.3f} ms ({g_src}), "
            f"{g_wall:.3f} ms a replay")
        out[name] = {"eager_device_ms": ms, "eager_wall_ms": wall,
                     "graph_ms": g_ms, "graph_wall_ms": g_wall}
        del graph
    del logits, lp
    free()
    return out


def nn_beam(pt, model, B=4, beam=4, steps=16, seed=SEED + 29, dev="cuda"):
    """Phase 27c: beam search over the trained predictor's ``LSTMCell``
    (the blank as the start token, token 1 as the end, the joint's
    predictor path as the output projection) from random states, on the
    card and on a CPU copy of the same layers: the ids must be equal and
    the scores within 1e-4. -> numbers"""
    import copy
    parts = (model.embed, model.lstm._cells_fw[0], model.joint_pred,
             model.joint_out)
    H = parts[1].hidden_size
    rng = np.random.RandomState(seed)
    h0 = [torch.from_numpy(0.5 * rng.randn(B, H).astype(np.float32))
          for _ in range(2)]
    out = {}
    for where, key in ((dev, "card"), ("cpu", "cpu")):
        emb, cell, jp, jo = (parts if key == "card" else
                             [copy.deepcopy(p).to("cpu") for p in parts])
        dec = pt.nn.BeamSearchDecoder(
            cell, 0, 1, beam, embedding_fn=emb,
            output_fn=lambda h, jp=jp, jo=jo: jo(pt.tanh(jp(h))))
        t0 = time.perf_counter()
        ids, scores = pt.nn.dynamic_decode(
            dec, tuple(h.to(where) for h in h0), max_step_num=steps)
        torch.cuda.synchronize()
        out[key] = (ids.cpu(), scores.cpu(), time.perf_counter() - t0)
    (ids_d, sc_d, t_d), (ids_c, sc_c, t_c) = out["card"], out["cpu"]
    err = float((sc_d - sc_c).abs().max())
    log(f"[nn 27c] beam search (beam {beam}, {steps} steps, B {B}) over the "
        f"trained LSTMCell: ids {list(ids_d.shape)} equal to the CPU's: "
        f"{torch.equal(ids_d, ids_c)}; scores max abs diff {err:.3e}; "
        f"{t_d:.3f} s on the card, {t_c:.3f} s on the CPU")
    if not torch.equal(ids_d, ids_c) or err > 1e-4:
        fail(f"nn beam: the card's ids / scores differ from the CPU's "
             f"(score err {err:.3e})")
    return {"ids_shape": list(ids_d.shape), "score_err": err,
            "card_s": t_d, "cpu_s": t_c}


def nn_phases(pt, K):
    """Phase 27: the rest of ``nn`` on the card (27a-27c). -> ({kernel:
    numbers for its JSON entry}, the phase's numbers)"""
    t0 = time.perf_counter()
    sweep = nn_sweep(pt)
    launches, kern, numbers, model = nn_conformer(pt, K)
    beam = nn_beam(pt, model)
    del model
    free()
    log(f"[nn] phase 27 in {time.perf_counter() - t0:.1f} s")
    extra = {name: dict(kern.get(name, {}), nn_launches=n)
             for name, n in launches.items()}
    return extra, {"sweep_worst": max(sweep.values()),
                   "conformer": numbers, "beam": beam}


# ------------------------------------------------------------- phase 28
def rope_tables(n, d):
    """The neox RoPE tables [1, n, 1, d] (angles t / 10000^(2i/d) over
    both halves), made with numpy: (sin, cos)."""
    inv = 1.0 / (10000.0 ** (np.arange(0, d, 2, dtype=np.float64) / d))
    emb = np.outer(np.arange(n, dtype=np.float64), inv)
    emb = np.concatenate([emb, emb], axis=-1)[None, :, None, :]
    return np.sin(emb).astype(np.float32), np.cos(emb).astype(np.float32)


def rope_decoder(P, vocab=50304, hidden=2048, layers=24, heads=16,
                 ffn=8192, max_len=1024, eps=1e-6):
    """Phase 28's model: a decoder written as a Paddle LLM user writes it
    against ``paddle.incubate`` (``gpt_1p3b(use_rms_norm=True)``'s widths
    and depth by default, ``paddle_tpu/models/gpt.py:77``): each block is
    ``incubate.nn.functional.fused_rms_norm``, one ``Linear`` to q, k and
    v, ``fused_rotary_position_embedding`` on q and k with tables from
    numpy, ``incubate.flash_attention`` (causal), the output ``Linear``,
    ``fused_rms_norm`` and an MLP whose GELU (the tanh form) is the user's
    own ``autograd.PyLayer`` with its own backward. Rotary positions take
    the place of ``GPTForCausalLM``'s learned ones (user code, as phase
    27's Conformer chose its positions); the head is tied to the
    embedding. ``P`` is the port here; ``tests/test_torch_port_incubate
    .py`` builds this body at tiny widths over both packages.
    ``model(ids)`` gives the logits, ``model(ids, labels)`` the mean
    cross-entropy."""
    nn, F = P.nn, P.nn.functional
    IF = P.incubate.nn.functional
    hd = hidden // heads
    c = math.sqrt(2.0 / math.pi)

    class GELU(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return 0.5 * x * (1.0 + P.tanh(c * (x + 0.044715 * x * x * x)))

        @staticmethod
        def backward(ctx, dy):
            x, = ctx.saved_tensor()
            t = P.tanh(c * (x + 0.044715 * x * x * x))
            return dy * (0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * c
                         * (1.0 + 3 * 0.044715 * x * x))

    class RMSNorm(nn.Layer):
        def __init__(self):
            super().__init__()
            self.weight = self.create_parameter(
                [hidden], default_initializer=nn.initializer.Constant(1.0))

        def forward(self, x):
            return IF.fused_rms_norm(x, self.weight, None, eps)

    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.ln1 = RMSNorm()
            self.qkv = nn.Linear(hidden, 3 * hidden)
            self.proj = nn.Linear(hidden, hidden)
            self.ln2 = RMSNorm()
            self.fc1 = nn.Linear(hidden, ffn)
            self.fc2 = nn.Linear(ffn, hidden)

        def qkv_rope(self, x, sin, cos):
            b, s = x.shape[0], x.shape[1]
            q, k, v = (P.reshape(t, [b, s, heads, hd]) for t in
                       P.split(self.qkv(self.ln1(x)), 3, axis=-1))
            q, k, _ = IF.fused_rotary_position_embedding(
                q, k, None, sin=P.cast(sin, q.dtype), cos=P.cast(cos, q.dtype))
            return q, k, v

        def mlp(self, x):
            return x + self.fc2(GELU.apply(self.fc1(self.ln2(x))))

        def forward(self, x, sin, cos, cache=None):
            b, s = x.shape[0], x.shape[1]
            q, k, v = self.qkv_rope(x, sin, cos)
            if cache is not None:
                cache.append((k, v))
            o, _ = P.incubate.flash_attention(q, k, v, causal=True)
            return self.mlp(x + self.proj(P.reshape(o, [b, s, hidden])))

    class RopeDecoder(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(vocab, hidden)
            self.blocks = nn.LayerList([Block() for _ in range(layers)])
            self.norm = RMSNorm()
            sin, cos = rope_tables(max_len, hd)
            self.register_buffer("rope_sin", P.to_tensor(sin),
                                 persistable=False)
            self.register_buffer("rope_cos", P.to_tensor(cos),
                                 persistable=False)

        def logits(self, h):
            return P.matmul(self.norm(h), self.embed.weight, transpose_y=True)

        def forward(self, ids, labels=None, cache=None):
            s = ids.shape[1]
            sin, cos = self.rope_sin[:, :s], self.rope_cos[:, :s]
            h = self.embed(ids)
            for blk in self.blocks:
                h = blk(h, sin, cos, cache)
            logits = self.logits(h)
            if labels is None:
                return logits
            return F.cross_entropy(P.reshape(logits, [-1, vocab]),
                                   P.reshape(labels, [-1]))

    return RopeDecoder()


def incubate_sweep(pt, where="cuda"):
    """Phase 28a's table: every case of ``tests/torch_incubate_cases.py``
    on the card against the CPU (:func:`case_sweep`). -> {op: worst
    error}"""
    return case_sweep(pt, case_table("torch_incubate_cases"),
                      "incubate 28a", where)


def incubate_kernel_cases(pt, K, seed=SEED + 28):
    """Phase 28a's kernel-backed entry points in bf16 on the card against
    their kernels' plain versions on the same inputs, each launching its
    kernel once: ``incubate.flash_attention`` at [8, 1024, 16, 128]
    causal (phase 6's bf16 limits), ``fused_layer_norm`` and
    ``fused_rms_norm`` at [8192, 2048] (2e-2), ``block_multihead_attention``
    over 16 decode rows of a page-16 pool with contexts 1-1024 (4e-3, phase
    12's bf16 limit). -> {name: max abs error}"""
    IF, inc = pt.incubate.nn.functional, pt.incubate
    g = torch.Generator(device="cuda").manual_seed(seed)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, device="cuda", generator=g) * scale
                + shift).to(bf)

    def launched(name, fn):
        K.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        n = K.launch_counts()[name]
        if n != 1:
            fail(f"[incubate 28a] {name}: {n} launches for one call")
        return out

    errs = {}
    B, S, H, D = 8, 1024, 16, 128
    q, k, v = (randn(B, S, H, D) for _ in range(3))
    out, none = launched("flash_fwd", lambda: inc.flash_attention(
        q, k, v, causal=True))
    if none is not None:
        fail("[incubate 28a] flash_attention returned a softmax")
    ro, _ = K.flash_fwd_reference(_bhsd(q), _bhsd(k), _bhsd(v),
                                  1.0 / math.sqrt(D), True)
    errs["flash_attention"] = check_close(
        f"[incubate 28a] incubate.flash_attention [{B}, {S}, {H}, {D}] bf16 "
        f"causal", out, _bshd(ro, B, H), FLASH_BF16_TOL, FLASH_BF16_TOL,
        FLASH_BF16_NORM_TOL)
    del q, k, v, out, ro
    x = randn(8192, 2048, scale=2.0, shift=1.0)
    w, b = randn(2048, scale=0.1, shift=1.0), randn(2048, scale=0.1)
    errs["fused_layer_norm"] = check_close(
        "[incubate 28a] incubate.fused_layer_norm [8192, 2048] bf16",
        launched("layer_norm", lambda: inc.fused_layer_norm(x, w, b, 1e-5)),
        K.layer_norm_reference(x, w, b, 1e-5), 2e-2, 2e-2)
    errs["fused_rms_norm"] = check_close(
        "[incubate 28a] incubate.nn.functional.fused_rms_norm [8192, 2048] "
        "bf16", launched("rms_norm", lambda: IF.fused_rms_norm(
            x, w, None, 1e-6)),
        K.rms_norm_reference(x, w, None, 1e-6), 2e-2, 2e-2)
    del x
    rows, page, max_pages = 16, 16, 64
    ctx = torch.randint(1, max_pages * page + 1, (rows,), device="cuda",
                        generator=g, dtype=torch.int32)
    pools = [randn(rows * max_pages + 1, page, H, D) for _ in range(2)]
    bt = (torch.randperm(rows * max_pages, device="cuda", generator=g)
          .reshape(rows, max_pages) + 1).to(torch.int32)
    q1 = randn(rows, H, D)
    errs["block_multihead_attention"] = check_close(
        f"[incubate 28a] block_multihead_attention ({rows} decode rows, "
        f"page {page}, contexts {int(ctx.min())}-{int(ctx.max())}) bf16",
        launched("paged_attention", lambda: IF.block_multihead_attention(
            q1, *pools, None, ctx, None, block_tables=bt)),
        K.paged_attention_reference(q1, *pools, bt, ctx), 4e-3, 4e-3)
    return errs


def rope_batch(pt, B, S, vocab, seed=SEED + 28):
    """Phase 28b's fixed batch: token ids and next-token labels from
    numpy, on the current device."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (B, S + 1))
    dev = pt.resolve_device(None)
    return (torch.from_numpy(ids[:, :-1]).to(dev),
            torch.from_numpy(ids[:, 1:]).to(dev))


def rope_train(pt, K, B=8, S=1024, eager_steps=2, warmup=2, steps=10,
               dims=None):
    """Phase 28b: :func:`rope_decoder` trained O2 bf16 (``amp.decorate``,
    ``AdamW(1e-4, weight_decay 0.01, multi_precision)`` with f32 masters)
    on one fixed batch of B x S, eager for ``eager_steps`` and staged by
    ``to_static`` (``warmup`` + ``steps``): 1 graph, 0 breaks, launches
    exact a replay (the flash trio one a layer, RMSNorm 2 a layer + 1,
    AdamW 1), losses falling, the staged step-0 loss the eager one's, the
    peak memory through ``pt.device`` equal to torch's; then one batch
    loaded on a side ``Stream`` under ``stream_guard`` after
    ``wait_stream`` gives a loss bit-equal to the default stream's. ->
    (launches over the replays, the phase's numbers, the trained model)"""
    dims = dict(dims or {})
    L = dims.get("layers", 24)
    ids, labels = rope_batch(pt, B, S, dims.get("vocab", 50304))

    def build():
        pt.seed(SEED)
        model = rope_decoder(pt, max_len=S, **dims)
        opt = pt.AdamW(learning_rate=1e-4, parameters=model.parameters(),
                       weight_decay=0.01, multi_precision=True)
        model, opt = pt.amp.decorate(model, opt, level="O2",
                                     dtype="bfloat16")

        def train_step(x, y):
            with pt.auto_cast(level="O2", dtype="bfloat16"):
                loss = model(x, y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        return model, opt, None, train_step, (ids, labels)

    eager = train_run(pt, build, False, 0, eager_steps)
    eager_loss0 = eager["losses"][0]
    del eager["model"], eager["opt"], eager["step"]
    free()
    staged = train_run(pt, build, True, warmup, steps)
    peak_port = pt.device.max_memory_allocated()
    peak_torch = torch.cuda.max_memory_allocated()
    model, step = staged["model"], staged["step"]
    stats = step.stats()
    n_all = sum(p.numel() for p in model.parameters())
    log(f"[incubate 28b] user-written RMSNorm/RoPE decoder: {L} layers, "
        f"{n_all / 1e9:.4f} B parameters, B {B} x S {S}, O2 bf16; staging "
        f"{stats}")
    if stats["graphs"] != 1 or stats["graph_breaks"] or \
            stats["eager_calls"]:
        fail(f"incubate decoder: staging {stats}")
    check_training("incubate decoder", staged["losses"], warmup,
                   staged["launches"], {
                       "flash_fwd": steps * L, "flash_bwd_dq": steps * L,
                       "flash_bwd_dkv": steps * L,
                       "rms_norm": steps * (2 * L + 1),
                       "fused_adamw": steps})
    diff = abs(staged["losses"][0] - eager_loss0)
    log(f"  [incubate 28b] staged step-0 loss {staged['losses'][0]:.6f} vs "
        f"the eager run's {eager_loss0:.6f} (diff {diff:.3e}; tolerance "
        f"{1e-4 * abs(eager_loss0):.3e}); eager losses "
        + " ".join(f"{x:.4f}" for x in eager["losses"]))
    if diff > 1e-4 * abs(eager_loss0):
        fail(f"incubate decoder: staged step 0 {staged['losses'][0]} vs "
             f"eager {eager_loss0}")
    log(f"  [incubate 28b] peak allocated over the staged run: "
        f"pt.device.max_memory_allocated() {peak_port} B, "
        f"torch.cuda.max_memory_allocated() {peak_torch} B; "
        f"memory_stats {pt.device.memory_stats()}")
    if peak_port != peak_torch:
        fail("incubate decoder: pt.device.max_memory_allocated disagrees "
             "with torch.cuda.max_memory_allocated")
    flops = train_flops(n_all, B, S, L, dims.get("hidden", 2048))
    numbers = report_pair("incubate decoder", eager, staged, {
        "losses": staged["losses"], "eager_losses": eager["losses"],
        "params_b": n_all / 1e9, "peak_port_bytes": peak_port,
        "peak_torch_bytes": peak_torch,
        "staged_mfu": flops / (staged["step_ms_median"] / 1e3)
        / BF16_FLOPS_PER_S})
    launches = staged["launches"]
    del staged["opt"], staged["step"], step, eager
    free()
    numbers["side_stream"] = side_stream_loss(pt, model, ids, labels)
    return launches, numbers, model


def side_stream_loss(pt, model, ids, labels):
    """The batch copied from pinned host memory on a side stream under
    ``stream_guard``, the default stream made to ``wait_stream`` for it,
    then the model's loss: bit-equal to the loss of the same batch
    copied on the default stream. -> numbers"""
    dev, where = pt.device, ids.device
    host = [t.cpu() for t in (ids, labels)]
    if where.type == "cuda":
        host = [t.pin_memory() for t in host]
    with torch.no_grad(), pt.auto_cast(level="O2", dtype="bfloat16"):
        want = model(*[t.to(where) for t in host])
        side = dev.Stream()
        with dev.stream_guard(side):
            if where.type == "cuda" and \
                    torch.cuda.current_stream() != side.cuda_stream:
                fail("incubate decoder: stream_guard did not make the side "
                     "stream current")
            moved = [t.to(where, non_blocking=True) for t in host]
        dev.current_stream().wait_stream(side)
        got = model(*moved)
    dev.synchronize()
    equal = bool(torch.equal(got, want))
    log(f"  [incubate 28b] batch loaded on a side stream: loss "
        f"{float(got):.6f} vs the default stream's {float(want):.6f}, "
        f"bit-equal {equal}")
    if not equal:
        fail("incubate decoder: the side-stream batch's loss differs")
    return {"loss": float(got), "bit_equal": equal}


def rope_decode_step(pt, model, tok, pos, pools, bt, page=16):
    """One greedy decode step of :func:`rope_decoder`, written as a user
    writes it: each block's q, k, v at position ``pos`` (RoPE row
    ``pos``), k and v written into the block's page pools, then
    ``incubate.nn.functional.block_multihead_attention`` over the rows'
    pages (contexts ``pos + 1``). -> the next token of each row"""
    IF = pt.incubate.nn.functional
    rows = tok.shape[0]
    hidden = model.embed.weight.shape[1]
    x = model.embed(tok[:, None])
    sin = model.rope_sin[:, pos:pos + 1]
    cos = model.rope_cos[:, pos:pos + 1]
    lens = torch.full((rows,), pos + 1, dtype=torch.int32, device=tok.device)
    page_i, slot = bt[:, pos // page], pos % page
    for blk, (kp, vp) in zip(model.blocks, pools):
        q, k, v = blk.qkv_rope(x, sin, cos)
        kp[page_i, slot] = k[:, 0]
        vp[page_i, slot] = v[:, 0]
        o = IF.block_multihead_attention(q[:, 0], kp, vp, None, lens, None,
                                         block_tables=bt)
        x = blk.mlp(x + blk.proj(pt.reshape(o, [rows, 1, hidden])))
    return model.logits(x)[:, -1].argmax(-1)


def rope_decode(pt, K, model, rows=16, P=128, N=64, page=16,
                seed=SEED + 31):
    """Phase 28c: the trained model decodes greedily: ``rows`` prompts of P
    tokens prefilled in one forward through the flash path (its k and v
    written into one page pool a layer), then N - 1 steps of
    :func:`rope_decode_step` on the paged decode kernel. Launches exact
    (prefill: flash forward one a layer, RMSNorm 2 a layer + 1; a step:
    paged attention one a layer, RMSNorm 2 a layer + 1), every greedy
    token the argmax of a no-cache forward within phase 15's tolerance
    (:func:`teacher_forced`); the paged kernel held against its plain
    version and timed at the last step's shape beside its bound. ->
    (launches, numbers)"""
    L = len(model.blocks)
    vocab, hidden = model.embed.weight.shape
    hd = model.rope_sin.shape[-1]
    heads = hidden // hd
    dtype, dev = model.embed.weight.dtype, model.embed.weight.device
    rng = np.random.RandomState(seed)
    prompt = torch.from_numpy(rng.randint(0, vocab, (rows, P))).to(dev)
    n_pages = -(-(P + N) // page)
    pools = [tuple(torch.zeros(rows * n_pages + 1, page, heads, hd,
                               dtype=dtype, device=dev) for _ in range(2))
             for _ in range(L)]
    bt = (torch.arange(rows * n_pages, dtype=torch.int32, device=dev)
          .reshape(rows, n_pages) + 1)
    model.eval()
    with torch.no_grad(), pt.auto_cast(level="O2", dtype="bfloat16"):
        K.reset_launch_counts()
        t0 = time.perf_counter()
        cache = []
        tok = model(prompt, cache=cache)[:, -1].argmax(-1)
        pos = torch.arange(P, device=dev)
        pages, slots = bt[:, pos // page], pos % page
        for (kp, vp), (k, v) in zip(pools, cache):
            kp[pages, slots] = k
            vp[pages, slots] = v
        del cache
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        prefill = K.launch_counts()
        K.reset_launch_counts()
        out, times = [tok], []
        for i in range(N - 1):
            t0 = time.perf_counter()
            tok = rope_decode_step(pt, model, tok, P + i, pools, bt, page)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            out.append(tok)
        decode = K.launch_counts()
    steps = N - 1
    for tag, got, want in (
            ("prefill", prefill, {"flash_fwd": L, "rms_norm": 2 * L + 1}),
            ("decode", decode, {"paged_attention": steps * L,
                                "rms_norm": steps * (2 * L + 1)})):
        full = {name: 0 for name in got}
        full.update(want)
        log(f"  [incubate 28c] {tag} launches: {got}")
        if got != full:
            fail(f"incubate decode: {tag} launches {got} != {full}")
    ids = torch.cat([prompt, torch.stack(out, 1)], 1)

    def no_cache(x):
        with pt.auto_cast(level="O2", dtype="bfloat16"):
            return model(x)

    at_or_above, n, short, ok = teacher_forced(no_cache, ids, P)
    med = float(np.median(times))
    log(f"[incubate 28c] greedy decode, {rows} rows x {P}-token prompts "
        f"(prefill {prefill_ms:.2f} ms) + {N} new tokens: {med:.3f} ms a "
        f"decode step (median of {steps}; min {min(times):.3f}, max "
        f"{max(times):.3f}); {at_or_above} of {n} tokens at or above the "
        f"no-cache forward's largest logit, the largest shortfall "
        f"{short:.4f}: {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail("incubate decode: a greedy token is not the no-cache argmax")
    # kernel 5 at the last step's shape, on layer 0's pools
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(rows, heads, hd, device=dev, generator=g).to(dtype)
    ctx = torch.full((rows,), P + N - 1, dtype=torch.int32, device=dev)
    args = (q, pools[0][0], pools[0][1], bt, ctx)
    err = check_close(f"[incubate 28c] paged_attention at the last decode "
                      f"step ({rows} rows, context {P + N - 1}) bf16",
                      K.paged_attention(*args),
                      K.paged_attention_reference(*args), 4e-3, 4e-3)
    ms, wall, src = time_ms(lambda: K.paged_attention(*args))
    plain_ms, _, _ = time_ms(lambda: K.paged_attention_reference(*args),
                             iters=5)
    ctx_np = np.full(rows, P + N - 1)
    nbytes, flops, _ = attention_work(
        np.arange(rows), np.ones(rows, np.int64), ctx_np, bt.cpu().numpy(),
        heads, heads, hd, page, 2, row_meta=1)
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
    log(f"[incubate 28c] paged_attention at the decode shape: kernel "
        f"{ms:.4f} ms ({src}; {wall:.4f} ms per call with launch) plain "
        f"{plain_ms:.4f} ms bound {b_ms:.4f} ms ({b_by}: "
        f"{nbytes / 1e6:.3f} MB) = {100 * b_ms / ms:.1f}% of bound")
    launches = {name: prefill[name] + decode[name] for name in decode}
    return launches, {
        "decode_ms_median": med, "decode_ms_min": min(times),
        "prefill_ms": prefill_ms, "tokens_at_or_above": at_or_above,
        "tokens": n, "largest_shortfall": short,
        "paged": {"ms": ms, "wall_ms": wall, "plain_ms": plain_ms,
                  "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
                  "source": src}}


def fused_multi_transformer_check(pt, B=4, S=512, hidden=2048, heads=16,
                                  ffn=8192, layers=2, seed=SEED + 32):
    """Phase 28d: ``FusedMultiTransformer`` at the decoder's widths, built
    on the CPU from the seed, forward in bf16 on the card against an f32
    copy on the CPU: relative L2 error within 2e-2 (bf16 products over
    K 2048 and 8192). -> numbers"""
    import copy
    pt.set_device("cpu")
    pt.seed(seed)
    fmt = pt.incubate.nn.FusedMultiTransformer(hidden, heads, ffn,
                                               num_layers=layers).eval()
    pt.set_device("cuda")
    x = np.random.RandomState(seed).randn(B, S, hidden).astype(np.float32)
    t0 = time.perf_counter()
    with torch.no_grad():
        want = fmt(torch.from_numpy(x))
    cpu_s = time.perf_counter() - t0
    card = copy.deepcopy(fmt).to("cuda", torch.bfloat16)
    with torch.no_grad():
        got = card(torch.from_numpy(x).cuda().bfloat16())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = card(torch.from_numpy(x).cuda().bfloat16())
        torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t0) * 1e3
    rel = _rel_l2(got.cpu(), want)
    log(f"[incubate 28d] FusedMultiTransformer ({layers} layers, hidden "
        f"{hidden}, {heads} heads, FFN {ffn}) on [{B}, {S}]: bf16 on the card "
        f"{card_ms:.2f} ms vs f32 on the CPU {cpu_s:.2f} s; relative L2 "
        f"{rel:.3e} (tolerance 2e-2), output {got.dtype} "
        f"{list(got.shape)}")
    if rel > 2e-2 or got.dtype != torch.bfloat16 or \
            not bool(torch.isfinite(got).all()):
        fail("incubate: FusedMultiTransformer on the card disagrees with "
             "the CPU")
    del card, got
    free()
    return {"rel_l2": rel, "card_ms": card_ms, "cpu_s": cpu_s}


def runtime_checks(pt):
    """Phase 28d's runtime modules on the card: the tensor checker raises
    on an injected Inf (``CHECK_NAN_INF`` prints and carries on), the
    operator statistics count, a step staged under the enabled checker
    still captures as 1 graph with 0 breaks, ``FLAGS_use_flash_attention
    =False`` refuses attention on a CUDA tensor, ``utils.run_check``
    passes (it holds the RMSNorm kernel against its plain version), and
    ``jacobian``, ``hessian``, ``vjp`` and ``jvp`` of a small MLP equal the
    CPU's within 1e-5. -> numbers"""
    from paddle_tpu_torch.amp import debugging as dbg
    from paddle_tpu_torch.core import op_hook
    out = {}
    dbg.enable_tensor_checker(dbg.TensorCheckerConfig())
    x = torch.ones(4, device="cuda")
    try:
        torch.log(x - 1.0)
        fail("incubate: the tensor checker let -inf through on the card")
    except FloatingPointError as e:
        log(f"[incubate 28d] tensor checker on the card: {e}")
    dbg.enable_tensor_checker(dbg.TensorCheckerConfig(
        debug_mode=dbg.DebugMode.CHECK_NAN_INF))
    torch.log(x - 1.0)              # prints, carries on
    # a step staged under the checker: 1 graph, 0 breaks
    pt.seed(SEED)
    net = pt.nn.Sequential(pt.nn.Linear(64, 128), pt.nn.ReLU(),
                           pt.nn.Linear(128, 8))
    opt = pt.AdamW(1e-3, parameters=net.parameters())

    def step(a, y):
        loss = pt.nn.functional.mse_loss(net(a), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    staged = pt.jit.to_static(step, capture=(net, opt), full_graph=True)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    a = torch.randn(32, 64, device="cuda", generator=g)
    y = torch.randn(32, 8, device="cuda", generator=g)
    losses = [float(staged(a, y)) for _ in range(4)]
    stats = staged.stats()
    log(f"[incubate 28d] a step staged under the enabled checker: "
        f"{stats}; losses {losses}")
    if stats["graphs"] != 1 or stats["graph_breaks"] or stats["replays"] < 3:
        fail(f"incubate: a staged step under the checker did not capture "
             f"as one graph: {stats}")
    dbg.disable_tensor_checker()
    with dbg.collect_operator_stats():
        step(a, y)
        counts = dict(dbg._op_stats)
    n_ops = sum(counts.values())
    log(f"[incubate 28d] operator statistics of one eager step: {n_ops} "
        f"ops, {len(counts)} (op, dtype) keys")
    if not counts.get(("linear", "torch.float32")) and \
            not any(k[0] in ("matmul", "addmm", "linear") for k in counts):
        fail(f"incubate: operator statistics missed the step's products: "
             f"{sorted(counts)}")
    if op_hook.installed():
        fail("incubate: the op seam stayed installed with nothing on")
    out["staged_under_checker"] = stats
    out["op_stats_ops"] = n_ops
    pt.set_flags({"FLAGS_use_flash_attention": False})
    try:
        q = torch.randn(1, 16, 2, 64, device="cuda").bfloat16()
        pt.incubate.flash_attention(q, q, q)
        fail("incubate: FLAGS_use_flash_attention=False did not refuse "
             "attention on the card")
    except RuntimeError as e:
        log(f"[incubate 28d] FLAGS_use_flash_attention=False: {e}")
    finally:
        pt.set_flags({"FLAGS_use_flash_attention": True})
    pt.utils.run_check()
    # the functional derivatives of a small MLP, card against CPU
    rng = np.random.RandomState(SEED + 33)
    w1, w2 = (torch.from_numpy(rng.randn(*s).astype(np.float32) * 0.5)
              for s in ((6, 5), (5, 3)))
    xs = torch.from_numpy(rng.randn(4, 6).astype(np.float32))
    worst = 0.0
    for name, call in (
            ("jacobian", lambda f, x: pt.autograd.jacobian(f, x)),
            ("hessian", lambda f, x: pt.autograd.hessian(
                lambda z: f(z).sum(), x)),
            ("vjp", lambda f, x: pt.autograd.vjp(f, x)[1]),
            ("jvp", lambda f, x: pt.autograd.jvp(f, x)[1])):
        res = []
        for dev in ("cpu", "cuda"):
            a1, a2 = w1.to(dev), w2.to(dev)
            res.append(call(lambda z: torch.tanh(z @ a1) @ a2,
                            xs.to(dev)).cpu())
        err = float((res[0] - res[1]).abs().max())
        worst = max(worst, err)
        log(f"  [incubate 28d] {name} {list(res[1].shape)}: card vs CPU "
            f"max abs {err:.3e}")
        if err > 1e-5:
            fail(f"incubate: {name} on the card differs from the CPU")
    out["derivatives_worst"] = worst
    return out


def incubate_phases(pt, K):
    """Phase 28: the core runtime modules and the incubate fused surface on
    the card (28a-28d). -> ({kernel: numbers for its JSON entry}, the
    phase's numbers)"""
    t0 = time.perf_counter()
    sweep = incubate_sweep(pt)
    kern_errs = incubate_kernel_cases(pt, K)
    t_launches, train, model = rope_train(pt, K)
    d_launches, decode = rope_decode(pt, K, model)
    del model
    free()
    fmt = fused_multi_transformer_check(pt)
    rt = runtime_checks(pt)
    log(f"[incubate] phase 28 in {time.perf_counter() - t0:.1f} s")
    extra = {name: {"incubate_launches": t_launches[name] + d_launches[name]}
             for name in t_launches}
    p = decode["paged"]
    extra["paged_attention"].update({
        f"incubate_{k}": v for k, v in p.items()})
    return extra, {"sweep_worst": max(sweep.values()), "kernels": kern_errs,
                   "train": train, "decode": decode, "fmt": fmt,
                   "runtime": rt, "train_launches": t_launches,
                   "decode_launches": d_launches}


# ------------------------------------------------------------- phase 29
PLAIN_MARKERS = ("softmax", "aten.layer_norm", "aten.native_layer_norm",
                 "aten.rms_norm", "aten._fused_rms_norm")


def exported_ops(layer):
    """-> {op target: count} of a loaded program's graph."""
    out = {}
    for n in layer._exported.graph.nodes:
        if n.op == "call_function":
            out[str(n.target)] = out.get(str(n.target), 0) + 1
    return out


def check_export_ops(tag, layer, want):
    """The loaded program holds exactly ``want`` kernel ops ({"flash_fwd":
    n, ...}) and no plain attention or norm chain. -> the kernel ops"""
    ops = exported_ops(layer)
    got = {k.split(".")[1]: v for k, v in ops.items()
           if k.startswith("paddle_tpu_torch.")}
    plain = sorted(k for k in ops if any(m in k for m in PLAIN_MARKERS))
    log(f"  [{tag}] kernel ops in the program: {got}; plain attention or "
        f"norm ops: {plain or 'none'}")
    if got != want or plain:
        fail(f"{tag}: the exported program holds {got} (want {want}) and "
             f"plain ops {plain}")
    return got


def per_call_launches(K, tag, fn, want, calls):
    """``calls`` calls of ``fn``, each launching exactly ``want`` -> the
    launches of all of them."""
    total = {}
    for i in range(calls):
        K.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        got = {k: v for k, v in K.launch_counts().items() if v}
        if got != want:
            fail(f"{tag}: call {i} launched {got}, want {want}")
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
    return total


def add_counts(acc, counts):
    for k, v in counts.items():
        acc[k] = acc.get(k, 0) + v


def export_bert(pt, K, tmp, acc, batches=(1, 8, 32), S=128):
    """29a: BERT-base classification (``bert_base()``, random weights from
    the seed) decorated O2 bf16, exported by ``jit.save`` with
    ``InputSpec([None, 128], "int64")``: 12 ``flash_fwd`` and 25
    ``layer_norm`` ops and no plain chain; at each batch three calls (the
    warm-up, the capture, a replay) of the loaded program, each launching
    12 flash forwards and 25 LayerNorms, with logits equal to the eager
    model's within bf16 rounding. -> (model, path, numbers)"""
    model = pt.BertForSequenceClassification(pt.bert_base(), seed=SEED)
    model.eval()
    model = pt.amp.decorate(model, level="O2", dtype="bfloat16")
    path = os.path.join(tmp, "bert_base")
    t0 = time.perf_counter()
    pt.jit.save(model, path, input_spec=[pt.jit.InputSpec([None, S],
                                                          "int64")])
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    layer = pt.jit.load(path)
    load_s = time.perf_counter() - t0
    sizes = {ext: os.path.getsize(path + ext)
             for ext in (".pdmodel", ".pdiparams", ".pdmeta")}
    log(f"[export 29a] BERT-base O2 bf16 exported in {save_s:.2f} s, loaded "
        f"in {load_s:.2f} s; file bytes {sizes}")
    check_export_ops("bert export", layer, {"flash_fwd": 12,
                                            "layer_norm": 25})
    rng = np.random.RandomState(SEED + 29)
    errs = {}
    for b in batches:
        ids = torch.from_numpy(rng.randint(0, 30522, (b, S))).cuda()
        with torch.no_grad():
            want = model(ids)
        outs = []
        add_counts(acc, per_call_launches(
            K, f"bert export B={b}", lambda: outs.append(layer(ids)),
            {"flash_fwd": 12, "layer_norm": 25}, 3))
        for i, got in enumerate(outs):
            errs[b] = max(errs.get(b, 0.0), check_close(
                f"bert export B={b} call {i} vs eager", got, want, 2e-2,
                2e-2, 1e-2))
    st = layer.stats()
    log(f"  [bert export] staging of the loaded program: {st}")
    if st["graphs"] != len(batches) or st["graph_breaks"]:
        fail(f"bert export: {st['graphs']} graphs for {len(batches)} "
             f"shapes, {st['graph_breaks']} breaks")
    return model, path, {"save_s": save_s, "load_s": load_s,
                         "bytes": sizes, "max_abs_err": errs, "stats": st}


def export_gpt(pt, K, acc, S=1024):
    """29a: ``gpt_1p3b(use_rms_norm=True)`` bf16 (24 layers, random weights
    from the seed) forward at [1, 1024], exported with its 2.6 GB
    ``.pdiparams`` in a temporary directory (deleted): 24 ``flash_fwd``
    and 49 ``rms_norm`` ops; two calls of the loaded program (warm-up and
    capture) launch 24 and 49 each and equal the eager logits within bf16
    rounding."""
    cfg = pt.gpt_1p3b(use_rms_norm=True, dropout=0.0)
    model = pt.GPTForCausalLM(cfg, dtype=torch.bfloat16, seed=SEED).eval()
    ids = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (1, S))).cuda()
    with torch.no_grad():
        want = model(ids)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "gpt")
        t0 = time.perf_counter()
        pt.jit.save(model, path, input_spec=[pt.jit.InputSpec([1, S],
                                                              "int64")])
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path + ".pdiparams")
        t0 = time.perf_counter()
        layer = pt.jit.load(path)
        load_s = time.perf_counter() - t0
    log(f"[export 29a] gpt_1p3b(use_rms_norm=True) bf16 exported in "
        f"{save_s:.2f} s ({nbytes / 1e9:.2f} GB of .pdiparams, deleted), "
        f"loaded in {load_s:.2f} s")
    L = cfg.num_layers
    check_export_ops("gpt export", layer, {"flash_fwd": L,
                                           "rms_norm": 2 * L + 1})
    outs = []
    add_counts(acc, per_call_launches(
        K, "gpt export", lambda: outs.append(layer(ids)),
        {"flash_fwd": L, "rms_norm": 2 * L + 1}, 2))
    err = max(check_close(f"gpt export call {i} vs eager", got, want, 2e-2,
                          2e-2, 1e-2) for i, got in enumerate(outs))
    del model, layer, outs, want
    free()
    return {"save_s": save_s, "load_s": load_s, "pdiparams_bytes": nbytes,
            "max_abs_err": err}


def export_cpu_to_card(pt, K, acc, tmp):
    """29a: ``bert_tiny`` (the CPU tests' model) exported on the CPU and
    loaded on the card: the program's ops launch kernels 1 and 8, and its
    logits equal the CPU model's within f32 rounding."""
    before = pt.device.DEFAULT_DEVICE
    pt.device.DEFAULT_DEVICE = "cpu"
    try:
        model = pt.BertForSequenceClassification(pt.bert_tiny(),
                                                 device="cpu", seed=SEED)
        model.eval()
        path = os.path.join(tmp, "bert_tiny_cpu")
        pt.jit.save(model, path, input_spec=[pt.jit.InputSpec([None, 16],
                                                              "int64")])
    finally:
        pt.device.DEFAULT_DEVICE = before
    layer = pt.jit.load(path)
    ids = np.random.RandomState(SEED + 1).randint(0, 1024, (4, 16))
    outs = []
    add_counts(acc, per_call_launches(
        K, "cpu-exported bert_tiny on the card",
        lambda: outs.append(layer(ids)),
        {"flash_fwd": 2, "layer_norm": 5}, 3))
    with torch.no_grad():
        want = model(torch.from_numpy(ids))
    err = max(check_close(f"cpu-exported bert_tiny call {i} vs the CPU",
                          got.cpu(), want, 1e-4, 1e-4)
              for i, got in enumerate(outs))
    return {"max_abs_err": err}


def op_overhead(K, n=5000):
    """Host us a call of each kernel op against its bare wrapper on a
    small CUDA tensor (the dispatcher's own cost; phase 25d's method: two
    turns each, the lower taken)."""
    lib = torch.ops.paddle_tpu_torch
    x = torch.randn(8, 768, device="cuda", dtype=torch.bfloat16)
    w = torch.ones(768, device="cuda", dtype=torch.bfloat16)
    b = torch.zeros(768, device="cuda", dtype=torch.bfloat16)
    q = torch.randn(1, 16, 2, 64, device="cuda", dtype=torch.bfloat16)
    pairs = {
        "layer_norm": (lambda: lib.layer_norm(x, w, b, 1e-5),
                       lambda: K.layer_norm(x, w, b, 1e-5)),
        "rms_norm": (lambda: lib.rms_norm(x, w, None, 1e-6),
                     lambda: K.rms_norm(x, w, None, 1e-6)),
        "flash_fwd": (lambda: lib.flash_fwd(q, q, q, 0.125, False),
                      lambda: K.flash_fwd(q, q, q, 0.125, False)),
    }
    out = {}
    for name, (op, bare) in pairs.items():
        res = {"op": [], "wrapper": []}
        for _ in range(2):
            for label, fn in (("op", op), ("wrapper", bare)):
                for _ in range(200):
                    fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(n):
                    fn()
                res[label].append((time.perf_counter() - t0) * 1e6 / n)
                torch.cuda.synchronize()
        out[name] = {"op_us": min(res["op"]),
                     "wrapper_us": min(res["wrapper"])}
    log("[export 29a] host us a call, kernel op vs bare wrapper (lower of "
        f"two turns of {n}): " + "; ".join(
            f"{k} {v['op_us']:.2f} vs {v['wrapper_us']:.2f} "
            f"(+{v['op_us'] - v['wrapper_us']:.2f})" for k, v in out.items()))
    return out


def serve_predictor(pt, K, model, path, acc, n_req=512, clients=32, S=128,
                    buckets=(1, 2, 4, 8, 16, 32)):
    """29b: ``create_predictor(Config(path))`` on the BERT-base export
    (the handle flow, then a direct ``run``), then ``BatchingPredictor``
    (buckets ``buckets``, ``max_wait_ms=2``): each bucket captured before
    the load (its warm-up and capture calls), then ``n_req``
    single-example requests of ``S`` tokens from ``clients`` threads.
    Every result equals the eager model's row within bf16 rounding, no
    bucket is captured again, and each batch launches 12 flash forwards
    and 25 LayerNorms. -> numbers"""
    import threading
    from paddle_tpu_torch.inference import (BatchingPredictor, Config,
                                            create_predictor)
    pred = create_predictor(Config(path))
    rng = np.random.RandomState(SEED + 30)
    ids = rng.randint(0, 30522, (n_req, S)).astype("int64")
    with torch.no_grad():
        want = torch.cat([model(torch.from_numpy(ids[i:i + 32]).cuda())
                          for i in range(0, n_req, 32)]).float().cpu()
    h = pred.get_input_handle(pred.get_input_names()[0])
    h.copy_from_cpu(ids[:8])
    K.reset_launch_counts()
    pred.run()
    add_counts(acc, K.launch_counts())
    got = pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()
    check_close("predictor handle flow B=8", torch.from_numpy(got), want[:8],
                2e-2, 2e-2, 1e-2)
    K.reset_launch_counts()
    direct = pred.run([ids[8:16]])[0]
    add_counts(acc, K.launch_counts())
    check_close("predictor direct run B=8", torch.from_numpy(direct),
                want[8:16], 2e-2, 2e-2, 1e-2)
    layer = pred._layer
    K.reset_launch_counts()
    for b in buckets:
        for _ in range(2):
            pred.run([ids[:b]])
    add_counts(acc, K.launch_counts())
    st0 = layer.stats()
    bp = BatchingPredictor(pred, max_batch_size=max(buckets), max_wait_ms=2,
                           batch_buckets=list(buckets))
    sizes = []
    run = pred.run

    def counted(inputs=None):
        sizes.append(len(inputs[0]))
        return run(inputs)

    pred.run = counted
    results, lat = [None] * n_req, [0.0] * n_req

    def client(c):
        for i in range(c, n_req, clients):
            t0 = time.perf_counter()
            results[i] = bp.predict(ids[i], timeout=120.0)
            lat[i] = (time.perf_counter() - t0) * 1e3

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    K.reset_launch_counts()
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in K.launch_counts().items() if v}
    bp.close()
    pred.run = run
    add_counts(acc, launches)
    st = layer.stats()
    if any(r is None for r in results):
        fail("batching predictor: a request got no result")
    err = check_close(f"batching predictor, {n_req} rows vs eager",
                      torch.from_numpy(np.stack(results)), want, 2e-2, 2e-2,
                      1e-2)
    per_bucket = {b: sizes.count(b) for b in buckets}
    want_l = {"flash_fwd": 12 * len(sizes), "layer_norm": 25 * len(sizes)}
    if launches != want_l:
        fail(f"batching predictor: {launches} over {len(sizes)} batches, "
             f"want {want_l}")
    if st["graphs"] != st0["graphs"] or st0["graphs"] != len(buckets) \
            or st["warmups"] != st0["warmups"] or st["graph_breaks"]:
        fail(f"batching predictor: staging before the load {st0}, after "
             f"{st}: a bucket was captured again or never")
    replay_ms = {}
    for b in buckets:
        x = torch.from_numpy(ids[:b]).cuda()
        replay_ms[b], _, _ = time_ms(lambda: layer(x), iters=10)
    numbers = {"requests_per_s": n_req / wall, "wall_s": wall,
               "latency_p50_ms": float(np.percentile(lat, 50)),
               "latency_p99_ms": float(np.percentile(lat, 99)),
               "batches": len(sizes), "batches_per_bucket": per_bucket,
               "replay_ms_per_bucket": replay_ms,
               "launches_per_batch": {"flash_fwd": 12, "layer_norm": 25},
               "max_abs_err": err, "stats": st}
    log(f"[export 29b] BatchingPredictor: {json.dumps(numbers)}")
    return numbers


def fit_a_line(paddle):
    """``tests/test_static_program.py:19``'s script, unmodified (its
    ``CPUPlace`` too: the program runs where it was recorded, the card).
    -> (losses, prediction error)"""
    paddle.enable_static()

    main = paddle.static.Program()
    startup = paddle.static.Program()
    with paddle.static.program_guard(main, startup):
        x = paddle.static.data(name="x", shape=[None, 13], dtype="float32")
        y = paddle.static.data(name="y", shape=[None, 1], dtype="float32")
        pred = paddle.static.nn.fc(x, size=1)
        cost = paddle.nn.functional.square_error_cost(input=pred, label=y)
        avg_loss = paddle.mean(cost)
        sgd = paddle.optimizer.SGD(learning_rate=0.05)
        sgd.minimize(avg_loss)

    exe = paddle.static.Executor(paddle.CPUPlace())
    exe.run(startup)

    rng = np.random.RandomState(0)
    true_w = rng.randn(13, 1).astype("float32")
    X = rng.randn(64, 13).astype("float32")
    Y = X @ true_w

    losses = []
    for _ in range(60):
        (loss_val,) = exe.run(main, feed={"x": X, "y": Y},
                              fetch_list=[avg_loss])
        losses.append(float(loss_val))
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.05 * losses[0], (losses[0], losses[-1])

    test_prog = main.clone(for_test=True)
    (p_val,) = exe.run(test_prog, feed={"x": X, "y": Y},
                       fetch_list=[pred])
    assert p_val.shape == (64, 1)
    np.testing.assert_allclose(p_val, Y, atol=0.6)
    paddle.disable_static()
    return losses, float(np.abs(p_val - Y).max())


def static_programs(pt, K, tmp, acc, B=8, S=128, layers=12):
    """29c: the fit-a-line script on the card; then a BERT-base-width
    encoder recorded in static mode (``static.data([None, 128, 768],
    "bfloat16")`` through ``TransformerEncoder``, 12 layers, 12 heads, no
    mask): ``Executor.run`` launches 12 flash forwards and 24 LayerNorms
    and equals the same layers run eagerly; ``save_inference_model`` ->
    ``load_inference_model`` and a ``Predictor`` on the saved program give
    the executor's output."""
    from paddle_tpu_torch.inference import Config, create_predictor
    t0 = time.perf_counter()
    losses, p_err = fit_a_line(pt)
    log(f"[static 29c] fit-a-line on the card: loss {losses[0]:.4f} -> "
        f"{losses[-1]:.6f} over 60 runs, |pred - Y| <= {p_err:.4f} "
        f"({time.perf_counter() - t0:.2f} s)")
    pt.enable_static()
    try:
        main = pt.static.Program()
        with pt.static.program_guard(main):
            h = pt.static.data(name="h", shape=[None, S, 768],
                               dtype="bfloat16")
            layer = pt.nn.TransformerEncoderLayer(768, 12, 3072,
                                                  dropout=0.0)
            enc = pt.amp.decorate(pt.nn.TransformerEncoder(layer, layers),
                                  level="O2", dtype="bfloat16")
            enc.eval()
            out = enc(h)
        names = [getattr(n.func, "__name__", "?") for n in main._nodes]
        counts = {k: names.count(k) for k in ("flash_fwd", "layer_norm")}
        log(f"  [static 29c] encoder program: {len(names)} nodes, kernel "
            f"ops {counts}, softmax nodes {names.count('softmax')}")
        if counts != {"flash_fwd": layers, "layer_norm": 2 * layers} \
                or "softmax" in names:
            fail(f"static encoder: program kernel ops {counts}")
        exe = pt.static.Executor()
        H = torch.randn(B, S, 768, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(SEED)).to(torch.bfloat16)
        K.reset_launch_counts()
        (got,) = exe.run(main, feed={"h": H}, fetch_list=[out],
                         return_numpy=False)
        torch.cuda.synchronize()
        launches = {k: v for k, v in K.launch_counts().items() if v}
        path = os.path.join(tmp, "encoder")
        pt.static.save_inference_model(path, [h], [out], exe)
    finally:
        pt.disable_static()
    want_l = {"flash_fwd": layers, "layer_norm": 2 * layers}
    log(f"  [static 29c] Executor.run launches {launches}")
    if launches != want_l:
        fail(f"static encoder: Executor.run launched {launches}, want "
             f"{want_l}")
    with torch.no_grad():
        eager = enc(H)
    err = check_close("static encoder vs the layers run eagerly", got,
                      eager, 2e-2, 2e-2, 1e-2)
    loaded = pt.static.load_inference_model(path)
    K.reset_launch_counts()
    again = loaded(H)
    add_counts(acc, K.launch_counts())
    check_close("saved encoder program vs Executor.run", again, got, 2e-2,
                2e-2, 1e-2)
    pred = create_predictor(Config(path))
    K.reset_launch_counts()
    (p_out,) = pred.run([H])
    add_counts(acc, K.launch_counts())
    check_close("Predictor on the saved encoder vs Executor.run",
                torch.from_numpy(p_out), got.float().cpu(), 2e-2, 2e-2, 1e-2)
    del enc, loaded, pred
    free()
    return {"fit_a_line_losses": [losses[0], losses[-1]],
            "fit_a_line_pred_err": p_err, "encoder_max_abs_err": err,
            "encoder_launches": launches}


def zloss_training(pt, K, eager_steps=2, warmup=2, steps=10, B=8, S=1024,
                   z=1e-4):
    """29d: phase 22c's ``gpt_1p3b`` O2 step with a z-loss behind a Python
    ``if z_weight > 0:`` on a device tensor, which dy2static converts:
    for ``z_weight`` = ``z`` and 0, eager (``eager_steps``) and staged by
    ``to_static`` (``warmup`` + ``steps``) from the same weights: 1 graph,
    0 breaks, a replay launching the flash trio 24 each, LayerNorm 49 and
    AdamW 1 (both branches run; only the model launches kernels), and the
    staged step-0 loss the eager one's. -> numbers"""
    cfg = pt.gpt_1p3b(dropout=0.0)
    rng = np.random.RandomState(SEED)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, S))).cuda()
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, S))).cuda()
    L = cfg.num_layers
    out = {}
    for zw in (z, 0.0):
        flag = torch.full((), zw, device="cuda")

        def build():
            model, opt, sched = o2_model(pt, cfg)
            crit = pt.GPTPretrainingCriterion(cfg)

            def zloss_step(x, y, z_weight):
                with pt.auto_cast(level="O2", dtype="bfloat16"):
                    logits = model(x)
                    loss = crit(logits, y)
                if z_weight > 0:
                    loss = loss + z_weight * torch.logsumexp(
                        logits.float(), -1).pow(2).mean()
                loss.backward()
                opt.step()
                opt.clear_grad()
                return loss
            return model, opt, sched, zloss_step, (ids, labels, flag)

        eager = train_run(pt, build, False, 0, eager_steps)
        loss0 = eager["losses"][0]
        del eager["model"], eager["opt"], eager["step"]
        free()
        staged = train_run(pt, build, True, warmup, steps)
        st = staged["stats"]
        log(f"[control flow 29d] z_weight {zw}: staging {st}")
        if st["graphs"] != 1 or st["graph_breaks"] or st["eager_calls"]:
            fail(f"z-loss step z_weight={zw}: staging {st}")
        check_training(f"z-loss step z_weight={zw}", staged["losses"],
                       warmup, staged["launches"], {
                           "flash_fwd": steps * L,
                           "flash_bwd_dq": steps * L,
                           "flash_bwd_dkv": steps * L,
                           "layer_norm": steps * (2 * L + 1),
                           "fused_adamw": steps})
        diff = abs(staged["losses"][0] - loss0)
        log(f"  [control flow 29d] staged step-0 loss "
            f"{staged['losses'][0]:.6f} vs eager {loss0:.6f} (diff "
            f"{diff:.3e}); staged {staged['step_ms_median']:.2f} ms a step "
            f"vs phase 22c's staged O2 step "
            f"{NUMBERS.get('gpt_o2_staged_ms', float('nan')):.2f} ms")
        if diff > 1e-4 * abs(loss0):
            fail(f"z-loss step z_weight={zw}: staged step 0 "
                 f"{staged['losses'][0]} vs eager {loss0}")
        out[zw] = {"step_ms_median": staged["step_ms_median"],
                   "step0_diff": diff, "losses": staged["losses"],
                   "launches": staged["launches"],
                   "device_busy_pct": staged["device_busy_pct"]}
        del staged["model"], staged["opt"], staged["step"], staged
        free()
    out["phase22c_staged_ms"] = NUMBERS.get("gpt_o2_staged_ms")
    return out


def control_flow_cases(pt):
    """29d at small sizes: ``cond``, ``while_loop(max_steps=...)``,
    ``scan_loop``, ``case`` and ``switch_case`` on the card, eager and
    staged (warm-up, capture, replays; 1 graph, 0 breaks), against the
    same calls on the CPU; an unbounded ``while_loop`` staged breaks the
    graph and runs eagerly with the CPU's values. -> the worst error"""
    from paddle_tpu_torch.jit import (case, cond, scan_loop, switch_case,
                                      while_loop)

    def f_cond(x, a):
        return cond(a > 0, lambda: x * 2 + 1, lambda: x.sin())

    def f_while(x, a):
        i = torch.zeros((), dtype=torch.int32, device=x.device)
        return while_loop(lambda i, y: y.abs().sum() < 100.0 * a.abs(),
                          lambda i, y: [i + 1, y * 2.0], [i, x],
                          max_steps=16)[1]

    def f_scan(x, a):
        return scan_loop(lambda i, y: y * 0.5 + i.float() * a, x, 5)

    def f_case(x, a):
        return case([(a > 1, lambda: x * 3), (a > 0, lambda: x * 2)],
                    default=lambda: x - 1)

    def f_switch(x, a):
        idx = (a > 0).long() + (a > 1).long()
        return switch_case(idx, {0: lambda: x * 1.0, 1: lambda: x * 2.0,
                                 2: lambda: x.cos()})

    x = torch.from_numpy(np.random.RandomState(SEED).randn(4, 8).astype(
        "float32"))
    worst, args = 0.0, [torch.tensor(v) for v in (2.0, -1.0, 0.5, 3.0)]
    for fn in (f_cond, f_while, f_scan, f_case, f_switch):
        staged = pt.jit.to_static(fn, full_graph=True)
        for a in args:
            want = fn(x, a)
            for got in (fn(x.cuda(), a.cuda()), staged(x.cuda(), a.cuda())):
                worst = max(worst, check_close(
                    f"{fn.__name__} a={float(a)} card vs CPU", got.cpu(),
                    want, 1e-5, 1e-5))
        st = staged.stats()
        if st["graphs"] != 1 or st["graph_breaks"] or \
                st["replays"] != len(args) - 1:
            fail(f"{fn.__name__}: staging {st}")

    def f_unbounded(x, n):
        i = torch.zeros((), dtype=torch.int32, device=x.device)
        return while_loop(lambda i, y: i < n, lambda i, y: [i + 1, y * 2.0],
                          [i, x])[1]

    staged = pt.jit.to_static(f_unbounded)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for n in (3, 5, 3):
            n_t = torch.tensor(n, dtype=torch.int32)
            worst = max(worst, check_close(
                f"unbounded while_loop n={n} card vs CPU",
                staged(x.cuda(), n_t.cuda()).cpu(), f_unbounded(x, n_t),
                1e-5, 1e-5))
    st = staged.stats()
    log(f"  [control flow 29d] unbounded while_loop staged: {st}")
    if st["graph_breaks"] != 1 or st["graphs"]:
        fail(f"unbounded while_loop: staging {st} (a graph break that runs "
             f"eagerly expected)")
    return worst


def export_phases(pt, K):
    """Phase 29: exported programs, the inference predictor, static mode
    and tensor control flow on the card (29a-29d). -> ({kernel: numbers
    for its JSON entry}, the phase's numbers)"""
    t0 = time.perf_counter()
    acc = {}
    with tempfile.TemporaryDirectory() as tmp:
        model, path, bert = export_bert(pt, K, tmp, acc)
        over = op_overhead(K)
        gpt = export_gpt(pt, K, acc)
        cpu = export_cpu_to_card(pt, K, acc, tmp)
        serve = serve_predictor(pt, K, model, path, acc)
        del model
        free()
        static = static_programs(pt, K, tmp, acc)
    cf_small = control_flow_cases(pt)
    zl = zloss_training(pt, K)
    log(f"[export] phase 29 in {time.perf_counter() - t0:.1f} s; launches "
        f"through exported programs {acc}")
    extra = {name: {"export_launches": n} for name, n in acc.items()}
    return extra, {"bert": bert, "gpt": gpt, "cpu_to_card": cpu,
                   "op_overhead": over, "serve": serve, "static": static,
                   "control_flow_worst": cf_small, "zloss": zl}


# ------------------------------------------------------------- phase 30
# resilient training: a BERT-base fine-tune through Model.fit under the
# port's launcher, through a preemption, a crash with a torn snapshot, a
# loss spike and a hung step
RES_STEPS, RES_B, RES_S, RES_INTERVAL = 48, 32, 128, 16
# what the launcher starts as phase 30's worker
RES_WORKER = [os.path.abspath(__file__), "--resilience-worker"]


def resilience_model(pt, drop=()):
    """Phase 30's job: ``BertForSequenceClassification(bert_base(),
    num_classes=2)`` from seed 0 with BERT-base's hidden dropout (0.1;
    the attention-probability dropout 0, as the flash kernels have none:
    with it the attention takes the plain chain), ``AdamW(wd 0.01)`` at
    2e-5 under 24b's warm-up and linear decay, ``amp_configs="O1"``
    (bf16), on ``steps * B`` token sequences (numpy seed 40) less the
    batches ``drop`` names. -> (model, dataset)."""
    steps, B, S = RES_STEPS, RES_B, RES_S
    cfg = pt.bert_base()
    net = pt.BertForSequenceClassification(cfg, num_classes=2, seed=SEED)
    for m in net.modules():
        if isinstance(m, pt.nn.MultiHeadAttention):
            m.dropout = 0.0
    warm = steps // 10
    lr = pt.optimizer.lr
    sched = lr.LinearWarmup(lr.PolynomialDecay(2e-5, steps - warm, 0.0),
                            warm, 0.0, 2e-5)
    opt = pt.AdamW(sched, parameters=net.parameters(), weight_decay=0.01)
    model = pt.Model(net)
    model.prepare(opt, pt.nn.CrossEntropyLoss(), amp_configs="O1")
    ids = np.random.RandomState(SEED + 40).randint(
        0, cfg.vocab_size, (steps * B, S))
    keep = [i for i in range(steps * B) if i // B not in set(drop)]
    ids = ids[keep]
    labels = (ids[:, 0] < cfg.vocab_size // 2).astype(np.int64)
    return model, array_dataset(pt, ids, labels)


def params_digest(net):
    """CRC32 over every parameter's bytes, in order (hex)."""
    crc = 0
    for p in net.parameters():
        crc = zlib.crc32(p.detach().cpu().contiguous().numpy().tobytes(),
                         crc)
    return f"{crc & 0xFFFFFFFF:08x}"


def resilience_fit(pt, K, model, data, lineage, async_snapshot=True,
                   preempt_at=None, out=print, integrity=True, shuffle=True):
    """``model.fit`` as phase 30 runs it (one epoch, the epoch-keyed
    shuffle or none, ``lineage``, ``snapshot_interval=16``,
    ``integrity``), printing through
    ``out`` a ``STEP <i> <loss> <host clock> <launch counts>`` line a
    step, the wall clock at the first step's end and a ``SAVE`` line
    (host ms on the training thread) per snapshot; SIGTERM to itself as
    step ``preempt_at`` begins."""
    import signal
    from paddle_tpu_torch.distributed import resumable

    class Rec(pt.hapi.callbacks.Callback):
        first = True

        def on_train_batch_begin(self, step, logs=None):
            if step == preempt_at:
                os.kill(os.getpid(), signal.SIGTERM)

        def on_train_batch_end(self, step, logs=None):
            if self.first:
                self.first = False
                out(f"FIRST_STEP_DONE {time.time()!r}")
            out(f"STEP {step} {logs['loss']!r} {time.perf_counter()!r} "
                f"{json.dumps(K.launch_counts())}")

    saves = []
    real_save = resumable.ResumableTraining._save

    def timed_save(rt, epoch, step_in_epoch, sync=False):
        t0 = time.perf_counter()
        real_save(rt, epoch, step_in_epoch, sync)
        ms = (time.perf_counter() - t0) * 1e3
        h = rt.lineage._inflight
        kind = "async" if h is not None else "sync"
        saves.append((rt.global_step, kind, ms, h))
        out(f"SAVE {rt.global_step} {kind} {ms!r}")

    resumable.ResumableTraining._save = timed_save
    try:
        model.fit(data, batch_size=RES_B, epochs=1, verbose=0,
                  shuffle=shuffle,
                  lineage=lineage, snapshot_interval=RES_INTERVAL,
                  async_snapshot=async_snapshot, integrity=integrity,
                  callbacks=[Rec(), pt.hapi.callbacks.LRScheduler(
                      by_step=True)])
    finally:
        resumable.ResumableTraining._save = real_save
    for step, kind, ms, h in saves:
        if h is not None and h.stats:
            out(f"ASYNC_STATS {step} {json.dumps(h.stats)}")
    return saves


def process_start_time():
    """This process's start on the wall clock (``/proc/self/stat``'s start
    time after the boot time of ``/proc/stat``)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        boot = next(int(line.split()[1]) for line in f
                    if line.startswith("btime"))
    return boot + ticks / os.sysconf("SC_CLK_TCK")


def resilience_worker():
    """``chip_smoke.py --resilience-worker``: one incarnation of phase
    30's job under the port's launcher (``R_DIR`` the lineage,
    ``R_PREEMPT_AT`` a step to be preempted at, ``R_SYNC=1`` for sync
    snapshots). Prints the ``STEP`` / ``SAVE`` lines of
    :func:`resilience_fit`, ``DIGEST`` and ``DONE`` at the end."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import watchdog
    from paddle_tpu_torch.ops import kernels as K
    print(f"SPAWNED {process_start_time()!r}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    K.reset_launch_counts()
    model, data = resilience_model(pt)
    at = os.environ.get("R_PREEMPT_AT")
    resilience_fit(pt, K, model, data, os.environ["R_DIR"],
                   async_snapshot=os.environ.get("R_SYNC") != "1",
                   preempt_at=None if at is None else int(at),
                   out=lambda s: print(s, flush=True))
    watchdog.stop_step_watchdog()
    torch.cuda.synchronize()
    print(f"DIGEST {params_digest(model.network)}", flush=True)
    print("DONE", flush=True)
    return 0


def parse_incarnations(log_dir):
    """The worker logs of one job, one dict an incarnation: ``losses``
    {step: float}, ``ends`` {step: host clock}, ``launches`` (the counts
    at its last step; ``first_launches`` at its first), ``saves`` [(step, kind, ms)], ``async`` {step:
    stats}, ``first_done`` (wall clock), ``digest``, ``text``."""
    out = []
    names = sorted((n for n in os.listdir(log_dir)
                    if n.startswith("workerlog.0")),
                   key=lambda n: int(n.split("restart")[1])
                   if "restart" in n else 0)
    for name in names:
        with open(os.path.join(log_dir, name)) as f:
            text = f.read()
        inc = {"losses": {}, "ends": {}, "launches": {}, "saves": [],
               "async": {}, "first_done": None, "digest": None,
               "spawned": None, "text": text}
        for line in text.splitlines():
            w = line.split(" ", 4)
            if w[0] == "STEP":
                i = int(w[1])
                inc["losses"][i] = float(w[2])
                inc["ends"][i] = float(w[3])
                inc["launches"] = json.loads(w[4])
                inc.setdefault("first_launches", inc["launches"])
            elif w[0] == "SAVE":
                inc["saves"].append((int(w[1]), w[2], float(w[3])))
            elif w[0] == "ASYNC_STATS":
                inc["async"][int(w[1])] = json.loads(line.split(" ", 2)[2])
            elif w[0] == "FIRST_STEP_DONE":
                inc["first_done"] = float(w[1])
            elif w[0] == "SPAWNED":
                inc["spawned"] = float(w[1])
            elif w[0] == "DIGEST":
                inc["digest"] = w[1]
        out.append(inc)
    return out


def start_job(tag, root, args, env):
    """Start one launcher job of phase 30 in a process of its own
    (``python -m paddle_tpu_torch.distributed.launch``, which starts the
    workers) -> a handle for :func:`finish_job`."""
    log_dir = os.path.join(root, f"{tag}_logs")
    err = open(os.path.join(root, f"{tag}_launcher.txt"), "w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "1", "--log_dir", log_dir] + args + RES_WORKER,
        env=dict(os.environ, **{k: str(v) for k, v in env.items()}),
        cwd=os.path.dirname(os.path.abspath(__file__)), stdout=err,
        stderr=subprocess.STDOUT)
    return tag, proc, log_dir, err, time.perf_counter()


def finish_job(job, timeout=600):
    """Wait for a job of :func:`start_job` -> (rc, what the launcher
    printed, its incarnations as :func:`parse_incarnations` reads them)."""
    tag, proc, log_dir, err, t0 = job
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = None
    err.seek(0)
    text = err.read()
    err.close()
    incs = parse_incarnations(log_dir) if os.path.isdir(log_dir) else []
    log(f"  [{tag}] launcher rc {rc} in {time.perf_counter() - t0:.1f} s, "
        f"{len(incs)} incarnation(s); launcher said:")
    for line in text.splitlines():
        log(f"    {line}")
    return rc, text, incs


def merged(incs):
    """Losses over the incarnations, the later ones winning."""
    out = {}
    for inc in incs:
        out.update(inc["losses"])
    return out


def check_equal_run(tag, ref, incs):
    """Every loss and the final digest bit-equal to the uninterrupted
    run's."""
    got = merged(incs)
    if sorted(got) != list(range(RES_STEPS)):
        fail(f"resilience {tag}: steps {sorted(got)}")
    bad = [i for i in range(RES_STEPS) if got[i] != ref["losses"][i]]
    if bad:
        fail(f"resilience {tag}: losses differ from the uninterrupted run "
             f"at steps {bad[:8]} (e.g. {got[bad[0]]!r} vs "
             f"{ref['losses'][bad[0]]!r})")
    if incs[-1]["digest"] != ref["digest"]:
        fail(f"resilience {tag}: digest {incs[-1]['digest']} != "
             f"{ref['digest']}")


def resume_seconds(incs):
    """Seconds from each relaunch (the worker process's start) to its
    first step done."""
    return [inc["first_done"] - inc["spawned"] for inc in incs[1:]
            if inc["first_done"] is not None and inc["spawned"]]


def add_launches(acc, counts):
    for k, v in counts.items():
        acc[k] = acc.get(k, 0) + v


def check_job(tag, rc, err, incs, ref, markers, launcher_says):
    """A resumed job's checks: rc 0, two incarnations, the launcher's
    lines and the workers' markers present, every loss and the digest
    bit-equal to 30a's."""
    text = "".join(i["text"] for i in incs)
    missing = [m for m in launcher_says if m not in err] + \
        [m for m in markers if m not in text]
    if rc != 0 or len(incs) != 2 or missing:
        fail(f"resilience {tag}: rc {rc}, {len(incs)} incarnations, "
             f"missing {missing}\n{err}\n{text[-3000:]}")
    check_equal_run(tag, ref, incs)


def resilience_phases(pt, K, plain_step_ms):
    """Phase 30 (see the module docstring): 30a alone (its times are the
    phase's step, stall and write numbers), then 30b, 30c and 30e as
    three launcher jobs at once while 30d runs in this process. ->
    ({kernel: its ``resilience_launches``}, the phase's numbers)."""
    import shutil
    from paddle_tpu_torch.distributed import fault
    t_phase = time.perf_counter()
    free()
    root = tempfile.mkdtemp(prefix="resilience_")
    L = pt.bert_base().num_layers
    per_step = {"flash_fwd": L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
                "layer_norm": 2 * L + 1, "fused_adamw": 1}
    acc, numbers = {}, {}
    try:
        # ---- 30a: uninterrupted, alone on the card
        rc, err, incs = finish_job(start_job(
            "30a", root, ["--max_restarts", "0"],
            {"R_DIR": os.path.join(root, "a")}))
        a = incs[0] if incs else {}
        if rc != 0 or len(incs) != 1 or a["digest"] is None or \
                sorted(a["losses"]) != list(range(RES_STEPS)):
            fail(f"resilience 30a: rc {rc}, {len(incs)} incarnations\n"
                 + (incs[-1]["text"][-3000:] if incs else err))
        ref = a
        replayed = {k: a["launches"][k] - a["first_launches"][k]
                    for k in per_step}
        want = {k: v * (RES_STEPS - 1) for k, v in per_step.items()}
        if replayed != want:
            fail(f"resilience 30a: launches over the {RES_STEPS - 1} "
                 f"replayed steps {replayed} != {want}")
        if not all(math.isfinite(v) for v in a["losses"].values()):
            fail(f"resilience 30a: losses {a['losses']}")
        gaps = np.diff([a["ends"][i] for i in range(RES_STEPS)]) * 1e3
        saved = {s for s, _, _ in a["saves"]}
        step_ms = float(np.median([g for i, g in enumerate(gaps, 1)
                                   if i not in saved and i - 1 not in saved
                                   and i > 1]))
        syncs = [ms for _, kind, ms in a["saves"] if kind == "sync"]
        asyncs = [ms for _, kind, ms in a["saves"] if kind == "async"]
        excess = [float(gaps[s] - step_ms) for s, kind, _ in a["saves"]
                  if kind == "async" and s < len(gaps)]
        stats = list(a["async"].values())
        snap_bytes = stats[0]["bytes"] if stats else None
        numbers["30a"] = {
            "fit_step_ms_median": step_ms,
            "plain_24b_step_ms": plain_step_ms, "snapshot_bytes": snap_bytes,
            "sync_stall_ms": syncs, "async_stall_ms": asyncs,
            "async_next_step_excess_ms": excess, "async_stats": a["async"],
            "write_gb_per_s": [st["bytes"] / st["write_s"] / 1e9
                               for st in stats if st.get("write_s")],
            "serialize_crc_gb_per_s": [
                st["bytes"] / st["serialize_crc_s"] / 1e9 for st in stats
                if st.get("serialize_crc_s")],
            "first_last_loss": [a["losses"][0], a["losses"][RES_STEPS - 1]],
            "digest": a["digest"]}
        add_launches(acc, a["launches"])
        rates = {k: [round(x, 3) for x in numbers["30a"][k]]
                 for k in ("write_gb_per_s", "serialize_crc_gb_per_s")}
        log(f"  30a: {RES_STEPS} steps, digest {a['digest']}; fit step "
            f"{step_ms:.3f} ms median with lineage, async snapshots and "
            f"integrity on (24b's plain fit step {plain_step_ms} ms); "
            f"snapshot {snap_bytes} B; training-thread stall a snapshot: "
            f"sync {[round(x, 1) for x in syncs]} ms, async "
            f"{[round(x, 1) for x in asyncs]} ms (the next step "
            f"{[round(x, 3) for x in excess]} ms longer); async write "
            f"{rates['write_gb_per_s']} GB/s after serialize + CRC at "
            f"{rates['serialize_crc_gb_per_s']} GB/s; launches exact over "
            f"the replayed steps")
        shutil.rmtree(os.path.join(root, "a"), ignore_errors=True)

        # ---- 30b, 30c, 30e: three jobs at once
        jobs = [
            # 30b: SIGTERM in step 23 -> PREEMPT_SAVED 24
            start_job("30b", root, ["--max_restarts", "0"],
                      {"R_DIR": os.path.join(root, "b"),
                       "R_PREEMPT_AT": 23}),
            # 30c: crash at step 40 with the step-32 snapshot torn (sync
            # snapshots: a torn async one never commits; the ckpt hits
            # are the baseline at 0, then 16, then 32)
            start_job("30c", root, ["--max_restarts", "1"],
                      {"R_DIR": os.path.join(root, "c"), "R_SYNC": "1",
                       "PADDLE_TPU_FAULTS":
                           "crash@step:40,torn_write@ckpt:3"}),
            # 30e: a hung step under the watchdog; 30 s, as the step's
            # capture beside two other jobs can outlast 10 s
            start_job("30e", root, ["--max_restarts", "1",
                                    "--watchdog_timeout", "30"],
                      {"R_DIR": os.path.join(root, "e"),
                       "PADDLE_TPU_FLIGHT_RECORDER": "256",
                       "PADDLE_TPU_FAULTS": "hang@step:30"})]

        # ---- 30d: a loss spike, in this process meanwhile. The poisoned
        # batch's labels scaled 1000x leave the classes: its loss is NaN
        # (JAX's fill-mode gather) and its gradient finite (the NaN rows
        # pass none), so one trip is all the guard sees: rewind_after=1.
        # Both runs read the data in order, so the twin's batches are the
        # poisoned run's less the window
        K.reset_launch_counts()
        guard = {"rewind_after": 1}
        lines = []
        fault.set_fault_spec("loss_spike@batch:21")
        try:
            model, data = resilience_model(pt)
            resilience_fit(pt, K, model, data, os.path.join(root, "d"),
                           out=lines.append, integrity=guard, shuffle=False)
        finally:
            fault.set_fault_spec(None)
        poisoned = params_digest(model.network)
        got = {}
        for line in lines:
            if line.startswith("STEP "):
                w = line.split(" ", 4)
                got[int(w[1])] = float(w[2])
        del model, data
        free()
        window = (20, 20)
        drop = range(window[0], window[1] + 1)
        model, data = resilience_model(pt, drop=drop)
        twin_lines = []
        resilience_fit(pt, K, model, data, os.path.join(root, "d2"),
                       out=twin_lines.append, integrity=guard, shuffle=False)
        twin = params_digest(model.network)
        tl = [float(line.split(" ", 4)[2]) for line in twin_lines
              if line.startswith("STEP ")]
        del model, data
        free()
        kept = [i for i in range(RES_STEPS) if i not in drop]
        if sorted(got) != kept:
            fail(f"resilience 30d: steps recorded {sorted(got)} (the guard "
                 f"should have rewound at step 20 and skipped it)")
        if poisoned != twin or [got[i] for i in kept] != tl:
            fail(f"resilience 30d: the rewound run ({poisoned}) differs "
                 f"from the clean run that skips steps {window} ({twin})")
        add_launches(acc, K.launch_counts())
        numbers["30d"] = {"digest": poisoned, "skip_window": list(window)}
        log(f"  30d: loss_spike@batch:21 -> a NaN loss at step 20, the "
            f"guard's rewind to the step-16 snapshot, window {window} "
            f"skipped; digest {poisoned} equal to the clean run without "
            f"that batch, its {len(kept)} losses bit-equal")

        (rb, eb, ib), (rc_, ec, ic), (re_, ee, ie) = \
            [finish_job(j) for j in jobs]
        check_job("30b", rb, eb, ib, ref,
                  ["PREEMPT_SAVED 24", "RESUMED epoch=0 step=24 "
                   "global_step=24"],
                  ["rc=75", "does not consume max_restarts"])
        pre_sync = [ms for s, k, ms in ib[0]["saves"] if s == 24 and
                    k == "sync"]
        numbers["30b"] = {"resume_s": resume_seconds(ib), "steps_lost": 0,
                          "preempt_sync_save_ms": pre_sync}
        log(f"  30b: SIGTERM in step 23 -> PREEMPT_SAVED 24, exit 75, "
            f"relaunched without consuming max_restarts, RESUMED at 24; "
            f"the sync save {[round(x, 1) for x in pre_sync]} ms; resume "
            f"{numbers['30b']['resume_s']} s; 0 steps lost; every loss and "
            f"the digest bit-equal to 30a")
        check_job("30c", rc_, ec, ic, ref,
                  ["skipping snapshot step_00000032",
                   "RESUMED epoch=0 step=16 global_step=16"],
                  ["rc=43", "restarting workers (1/1)"])
        done = max(ic[0]["losses"])
        numbers["30c"] = {"resume_s": resume_seconds(ic),
                          "steps_lost": done + 1 - 16,
                          "sync_save_ms": [ms for _, _, ms in ic[0]["saves"]]}
        log(f"  30c: crashed (rc 43) after step {done}; the torn step-32 "
            f"snapshot skipped by its CRC, resumed at 16; resume "
            f"{numbers['30c']['resume_s']} s; {done + 1 - 16} steps lost; "
            f"sync snapshots "
            f"{[round(x, 1) for x in numbers['30c']['sync_save_ms']]} ms; "
            f"every loss and the digest bit-equal to 30a")
        done = max(ie[0]["losses"]) if ie else -1
        pm = re.search(r"rank 0 \[watchdog_timeout\]: completed step "
                       r"seq=\d+ \(step (\d+)\)", ee)
        if pm is None or int(pm.group(1)) != done + 1:
            fail(f"resilience 30e: the post-mortem does not name rank 0 at "
                 f"step {done + 1}\n{ee}")
        check_job("30e", re_, ee, ie, ref,
                  ["RESUMED epoch=0 step=16 global_step=16"],
                  ["rc=19", "[post-mortem]"])
        numbers["30e"] = {"resume_s": resume_seconds(ie),
                          "steps_lost": done + 1 - 16,
                          "post_mortem_step": int(pm.group(1))}
        log(f"  30e: hung before step {done + 1}; the watchdog (30 s) "
            f"dumped the ring and exited 19; the post-mortem names rank 0 "
            f"at step {pm.group(1)}; restarted, resumed at 16; resume "
            f"{numbers['30e']['resume_s']} s; {done + 1 - 16} steps lost; "
            f"every loss and the digest bit-equal to 30a")
        for inc in ib + ic + ie:
            add_launches(acc, inc["launches"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for k in per_step:
        if not acc.get(k):
            fail(f"resilience: kernel {k} never launched")
    numbers["launches"] = {k: acc.get(k, 0) for k in per_step}
    numbers["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 30 launches {numbers['launches']}; "
        f"{numbers['phase_s']:.1f} s")
    log("  " + json.dumps(numbers, default=str))
    return {k: {"resilience_launches": acc.get(k, 0)} for k in per_step}, \
        numbers


# ------------------------------------------------------------- phase 31
# elastic training and resumable distributed linear algebra: jobs of the
# port's launcher under --np 2:3, rank 2 SIGKILLing itself mid-run
DLA_N, DLA_BLOCK, DLA_P, DLA_SEED, DLA_TOL = 4096, 256, 16, 5, 1e-9
# the eigensolve's kill: rank 2 after 21 committed panels, the fifth
# panel of sweep 1 (16 panels a sweep)
DLA_KILL = "2:21"
# 31b: B 32 x S 128 a rank over 512 sequences (an epoch is 6 steps at
# world 3, the last one short, and 8 at world 2), a sync snapshot every 4
# steps, rank 2 killed at the end of its 5th step: one snapshot in each
# incarnation (the second at the epoch's end)
EL_B, EL_S, EL_INTERVAL, EL_KILL_AFTER = 32, 128, 4, 5
EL_SAMPLES = 16 * EL_B
# the host BLAS threads of each eigensolve rank: three host QRs of A at
# once on the card machine's 8 cores
DLA_THREADS = 2
# what the launcher starts as phase 31's workers
EL_WORKER = {"dlinalg": [os.path.abspath(__file__), "--dlinalg-worker"],
             "elastic": [os.path.abspath(__file__), "--elastic-worker"]}


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dla_matrix(n, p, seed):
    """``tests/workers/dlinalg_worker.py``'s symmetric A with a spectral
    gap, built on the host (a QR of an n x n Gaussian: at n 4096 that QR
    sets the size of phase 31a's job) -> (A, its p dominant eigenvalues,
    which the construction fixes)."""
    rng = np.random.default_rng(seed)
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    d = np.concatenate([np.linspace(p + 1.0, 2.0, p),
                        np.sort(rng.uniform(0.0, 0.05, n - p))[::-1]])
    return (V * d) @ V.T, d[:p]


def dlinalg_worker():
    """``chip_smoke.py --dlinalg-worker``: one incarnation of 31a's
    eigensolve under the launcher, as ``tests/torch_dlinalg_worker.py``
    runs it (its markers; ``PADDLE_TPU_DLA_KILL`` once a job), on the
    device backend, with THETA_ERR against the spectrum the construction
    fixes and ``START`` / ``BUILT`` stamps."""
    import signal
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import dlinalg, fault
    print(f"SPAWNED {process_start_time()!r}", flush=True)
    dist.init_parallel_env()
    world, rank = dist.get_world_size(), dist.get_rank()
    inc = int(os.environ.get("PADDLE_TPU_RESTART_NUM", "0"))
    print(f"WORLD {world}", flush=True)
    root = os.environ["PADDLE_TPU_CKPT_DIR"]
    store = None
    if world > 1:
        store = dist.TCPStore(
            "127.0.0.1", int(os.environ["PADDLE_TPU_FT_STORE_PORT"]),
            is_master=(rank == 0), world_size=world, timeout=120)
    lineage = fault.CheckpointLineage(root, store=store, world_size=world,
                                      rank=rank)
    t0 = time.perf_counter()
    A_full, ref = dla_matrix(DLA_N, DLA_P, DLA_SEED)
    print(f"BUILT {time.perf_counter() - t0!r}", flush=True)
    A = dlinalg.ShardedMatrix.from_global(A_full, DLA_BLOCK, world=world,
                                          rank=rank)
    del A_full
    exchange = (dlinalg.StoreExchange(store, job="chip") if store
                else dlinalg.LocalExchange())
    spec = dlinalg.SweepSpec(DLA_N, DLA_P, block_rows=DLA_BLOCK,
                             seed=DLA_SEED, tol=DLA_TOL, max_sweeps=60,
                             checkpoint_panels=True, backend="xla")
    solver = dlinalg.SubspaceEigensolver(A, spec, exchange, lineage=lineage,
                                         job="chip")
    if store is not None:
        exchange.barrier(f"start/i{inc}", world, timeout=120)
    step = solver.restore()
    if store is not None:
        exchange.barrier(f"restored/i{inc}", world, timeout=120)
    print("FRESH" if step is None else f"RESUMED step={step} sweep="
          f"{solver.sweep} panel={solver.panel}", flush=True)
    kill_rank, kill_after = (int(x) for x in
                             os.environ.get("PADDLE_TPU_DLA_KILL",
                                            "-1:0").split(":"))
    marker = os.path.join(root, "chaos_killed.marker")
    committed = 0

    def on_panel(s, b):
        nonlocal committed
        committed += 1
        print(f"PANEL {s} {b} {time.time():.6f}", flush=True)
        if rank == kill_rank and committed == kill_after and \
                not os.path.exists(marker):
            with open(marker, "w") as f:
                f.write(f"i{inc} s{s} b{b}\n")
            print(f"SELF_SIGKILL {time.time():.6f}", flush=True)
            os.kill(os.getpid(), signal.SIGKILL)

    def on_sweep(s, resid):
        print(f"SWEEP {s} {resid:.6e} {time.time():.6f}", flush=True)

    print(f"START {time.time():.6f}", flush=True)
    try:
        theta, _, _ = solver.run(on_panel=on_panel, on_sweep=on_sweep)
    except dlinalg.OracleViolation as e:
        print(f"ORACLE_FAIL {e.what} {e.value:.6e}", flush=True)
        return fault.EXIT_ORACLE
    err = float(np.max(np.abs(theta - ref)) / np.max(np.abs(ref)))
    print(f"THETA_ERR {err:.6e}", flush=True)
    if store is not None:
        exchange.barrier(f"exit/i{inc}", world, timeout=60)
    print(f"DONE {solver.sweep} {solver.residual_history[-1]:.6e}",
          flush=True)
    return 0


def elastic_model(pt):
    """31b's job: phase 30's BERT-base classifier (seed 0, hidden dropout
    0.1, attention-probability dropout 0) under ``AdamW(2e-5, wd 0.01)``
    and ``amp_configs="O1"``, prepared in the parallel env (so wrapped in
    ``DataParallel`` at world > 1), on ``EL_SAMPLES`` token sequences
    (numpy seed 41). -> (model, dataset)."""
    cfg = pt.bert_base()
    net = pt.BertForSequenceClassification(cfg, num_classes=2, seed=SEED)
    for m in net.modules():
        if isinstance(m, pt.nn.MultiHeadAttention):
            m.dropout = 0.0
    model = pt.Model(net)
    model.prepare(pt.AdamW(2e-5, parameters=net.parameters(),
                           weight_decay=0.01),
                  pt.nn.CrossEntropyLoss(), amp_configs="O1")
    ids = np.random.RandomState(SEED + 41).randint(
        0, cfg.vocab_size, (EL_SAMPLES, EL_S))
    labels = (ids[:, 0] < cfg.vocab_size // 2).astype(np.int64)
    return model, array_dataset(pt, ids, labels)


# the largest leaf 31b's gradient check compares element by element
GRAD_CHECK_SMALL = 65536


def grad_sync_check(dp, sync):
    """Run ``sync`` (``DataParallel._sync_grads``) on ``dp`` and hold the
    averaged gradients against the plain mean of every rank's own
    (pre-sync) gradients, gathered as CPU tensors over the same gloo
    group: every leaf of up to ``GRAD_CHECK_SMALL`` elements element by
    element, and every leaf by its f64 sum and its dot with a seeded
    random vector (the same on every rank). The bound is 2^-20 of the
    summed magnitudes over the ranks (f32 sums and a division round at
    most 3 x 2^-24 of them): a wrong division, a bucket copied back at a
    wrong offset or a stale buffer exceeds it. -> {"leaves", "small",
    "elem_ratio", "proj_ratio"} (the worst error over its bound; <= 1
    passes)."""
    import torch.distributed as tdist
    grads = [p.grad for p in dp.parameters() if p.grad is not None]
    world = tdist.get_world_size()

    def weights(i, g):
        gen = torch.Generator(device=g.device)
        gen.manual_seed(1000 + i)
        return torch.randn(g.numel(), generator=gen, device=g.device,
                           dtype=torch.float64)

    def stats(with_abs):
        rows = []
        for i, g in enumerate(grads):
            gd, wd = g.detach().reshape(-1).double(), weights(i, g)
            row = [gd.sum(), (gd * wd).sum()]
            if with_abs:
                row += [gd.abs().sum(), (gd * wd).abs().sum()]
            rows.append(torch.stack(row))
        return torch.stack(rows).cpu()

    small = [i for i, g in enumerate(grads) if g.numel() <= GRAD_CHECK_SMALL]
    local = torch.cat([grads[i].detach().reshape(-1).float()
                       for i in small]).cpu()
    pre = stats(True)
    sync(dp)
    post = stats(False)
    after = torch.cat([grads[i].detach().reshape(-1).double()
                       for i in small]).cpu()
    tdist.all_reduce(pre)
    gathered = [torch.empty_like(local) for _ in range(world)]
    tdist.all_gather(gathered, local)
    every = torch.stack(gathered).double()
    bound = 2.0 ** -20
    elem = ((after - every.mean(0)).abs()
            / (bound * every.abs().sum(0)).clamp_min(1e-300))
    proj = ((post - pre[:, :2] / world).abs()
            / (bound * pre[:, 2:]).clamp_min(1e-300))
    return {"leaves": len(grads), "small": int(local.numel()),
            "elem_ratio": float(elem.max()),
            "proj_ratio": float(proj.max())}


def elastic_worker():
    """``chip_smoke.py --elastic-worker``: one incarnation of 31b under
    the launcher. Prints ``WORLD``, fit's ``RESUMED`` line, a ``BATCH
    <epoch> <step> <executed> <wall clock> <host clock> <all-reduce s>
    <launch counts>`` line a step (the loss fetched every step), and
    ``DIGEST`` / ``DONE`` at the end; rank 2 of the first incarnation
    SIGKILLs itself at the end of step ``EL_KILL_AFTER``."""
    import signal
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import fault, parallel
    from paddle_tpu_torch.ops import kernels as K
    print(f"SPAWNED {process_start_time()!r}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_parallel_env()
    world, rank = dist.get_world_size(), dist.get_rank()
    inc = int(os.environ.get("PADDLE_TPU_RESTART_NUM", "0"))
    print(f"WORLD {world}", flush=True)
    store = dist.TCPStore("127.0.0.1",
                          int(os.environ["PADDLE_TPU_FT_STORE_PORT"]),
                          is_master=(rank == 0), world_size=world,
                          timeout=120)
    lineage = fault.CheckpointLineage(os.environ["PADDLE_TPU_CKPT_DIR"],
                                      store=store, world_size=world,
                                      rank=rank)
    # the all-reduce's time: the gradient sync between two card syncs
    sync_s = []
    real_sync = parallel.DataParallel._sync_grads

    def timed_sync(self):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if sync_s:
            real_sync(self)
        else:
            # the first synced step of the incarnation: its average held
            # against the plain mean of every rank's gradients
            got = grad_sync_check(self, real_sync)
            ok = got["elem_ratio"] <= 1.0 and got["proj_ratio"] <= 1.0
            print(f"GRAD_SYNC world={world} {json.dumps(got)} "
                  f"{'ok' if ok else 'BAD'}", flush=True)
            if not ok:
                raise RuntimeError(f"DataParallel's gradient average is "
                                   f"off its plain mean: {got}")
        torch.cuda.synchronize()
        sync_s.append(time.perf_counter() - t0)

    parallel.DataParallel._sync_grads = timed_sync
    K.reset_launch_counts()
    model, data = elastic_model(pt)

    class Markers(pt.hapi.callbacks.Callback):
        executed = 0
        epoch = 0

        def on_epoch_begin(self, epoch, logs=None):
            self.epoch = epoch

        def on_train_batch_end(self, step, logs=None):
            self.executed += 1
            ar = sync_s[-1] if sync_s else 0.0
            print(f"BATCH {self.epoch} {step} {self.executed} "
                  f"{time.time():.6f} {time.perf_counter()!r} {ar!r} "
                  f"{json.dumps(K.launch_counts())}", flush=True)
            if inc == 0 and rank == 2 and self.executed == EL_KILL_AFTER:
                print(f"SELF_SIGKILL {time.time():.6f}", flush=True)
                os.kill(os.getpid(), signal.SIGKILL)

    model.fit(data, batch_size=EL_B, epochs=1, shuffle=False, verbose=0,
              lineage=lineage, snapshot_interval=EL_INTERVAL,
              async_snapshot=False, loss_fetch_every=1,
              callbacks=[Markers()])
    parallel.DataParallel._sync_grads = real_sync
    torch.cuda.synchronize()
    print(f"GRAPH_BREAKS {model._step_fn.stats()['graph_breaks']}",
          flush=True)
    print(f"DIGEST {params_digest(model.network)}", flush=True)
    print("DONE", flush=True)
    return 0


def run_elastic_job(tag, root, mode, env, timeout=420):
    """One ``--np 2:3 --max_restarts 0`` job of the port's launcher over
    ``chip_smoke.py``'s ``mode`` worker -> (rc, what the launcher
    printed, log dir, seconds)."""
    log_dir = os.path.join(root, f"{tag}_logs")
    env = dict(os.environ, PADDLE_TPU_CKPT_DIR=os.path.join(root, tag),
               PADDLE_TPU_FT_STORE_PORT=str(free_port()),
               **{k: str(v) for k, v in env.items()})
    t0 = time.perf_counter()
    # a session of its own: a job past its time is killed whole, the
    # launcher and its workers
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--np", "2:3", "--max_restarts", "0",
         "--master", f"127.0.0.1:{free_port()}",
         "--elastic_port", str(free_port()),
         "--terminate_grace", "5", "--log_dir", log_dir] + EL_WORKER[mode],
        env=env, cwd=HERE, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        _, err = proc.communicate(timeout=timeout)
        rc = proc.returncode
    except subprocess.TimeoutExpired:
        import signal
        os.killpg(proc.pid, signal.SIGKILL)
        _, err = proc.communicate()
        rc = None
    secs = time.perf_counter() - t0
    log(f"  [{tag}] launcher rc {rc} in {secs:.1f} s; launcher said:")
    for line in err.splitlines():
        if line.startswith("[") or "scale event" in line:
            log(f"    {line}")
    return rc, err, log_dir, secs


def rank_log(log_dir, rank):
    """A rank's logs, its incarnations in order."""
    names = sorted((n for n in os.listdir(log_dir)
                    if n.split(".")[:2] == ["workerlog", str(rank)]),
                   key=lambda n: int(n.split("restart")[1])
                   if "restart" in n else 0)
    text = ""
    for n in names:
        with open(os.path.join(log_dir, n)) as f:
            text += f.read()
    return text


def scale_checks(tag, rc, err, log_dir):
    """The launcher's scale event, and rank 2's self-kill at world 3."""
    if rc != 0 or "scale event" not in err or \
            "relaunching at world_size=2" not in err:
        fail(f"{tag}: rc {rc}, no scale event to world 2\n{err[-3000:]}\n"
             + rank_log(log_dir, 0)[-3000:])
    k = rank_log(log_dir, 2)
    if "WORLD 3" not in k or "SELF_SIGKILL" not in k:
        fail(f"{tag}: rank 2 did not SIGKILL itself at world 3\n{k[-2000:]}")
    return float(re.search(r"SELF_SIGKILL ([\d.]+)", k).group(1))


def dlinalg_phase(pt):
    """31a: the SUMMA matmul at world 3 in this process, then the elastic
    eigensolve job. -> its numbers."""
    import threading
    from paddle_tpu_torch.distributed import dlinalg
    out = {}
    # ---- the matmul: thread-per-rank world 3 on one LocalExchange, as
    # bench.py's linalg leg runs it, A N x N times B N x p
    world = 3
    # a product of one block a rank warms the card's GEMMs first; the
    # full one is timed once
    for n in (world * DLA_BLOCK, DLA_N):
        rng = np.random.default_rng(7)
        A_full = rng.standard_normal((n, n))
        B_full = rng.standard_normal((n, DLA_P))
        ex = dlinalg.LocalExchange()
        res, errs = [None] * world, []

        def target(r):
            try:
                A = dlinalg.ShardedMatrix.from_global(A_full, DLA_BLOCK,
                                                      world=world, rank=r)
                B = dlinalg.ShardedMatrix.from_global(B_full, DLA_BLOCK,
                                                      world=world, rank=r)
                res[r] = dlinalg.summa_matmul(A, B, ex, tag="chip",
                                              backend="xla")
            except BaseException as e:  # noqa: BLE001 - failed below
                errs.append(e)

        threads = [threading.Thread(target=target, args=(r,), daemon=True)
                   for r in range(world)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        wall = time.perf_counter() - t0
        if errs or any(t.is_alive() for t in threads):
            fail(f"dlinalg summa: {errs[:1]}")
    ref = dlinalg.matmul_reference(A_full, B_full)
    C = np.zeros_like(ref)
    for r in range(world):
        for b in res[r].owned:
            lo, hi = res[r].layout.row_range(b)
            C[lo:hi] = res[r].block(b)
    resid = float(np.linalg.norm(C - ref) / np.linalg.norm(ref))
    gflops = 2.0 * DLA_N * DLA_N * DLA_P / wall / 1e9
    log(f"  31a summa_matmul world 3 (threads), N {DLA_N} x p {DLA_P}, "
        f"block {DLA_BLOCK}, device backend (torch f64): {wall * 1e3:.2f} "
        f"ms, {gflops:.3f} GFLOP/s, relative residual {resid:.3e}")
    if not resid < 1e-12:
        fail(f"dlinalg summa: relative residual {resid} >= 1e-12")
    out["summa"] = {"ms": wall * 1e3, "gflop_per_s": gflops,
                    "residual": resid}
    del A_full, B_full, C, ref, res

    # ---- the elastic eigensolve
    root = tempfile.mkdtemp(prefix="dlinalg_")
    try:
        rc, err, log_dir, secs = run_elastic_job(
            "31a", root, "dlinalg", {
                "PADDLE_TPU_DLA_KILL": DLA_KILL,
                **{v: DLA_THREADS for v in ("OMP_NUM_THREADS",
                                            "OPENBLAS_NUM_THREADS",
                                            "MKL_NUM_THREADS")}})
        killed_at = scale_checks("dlinalg 31a", rc, err, log_dir)
        k = rank_log(log_dir, 2)
        if not re.search(r"PANEL 1 \d", k):
            fail("dlinalg 31a: rank 2 committed no panel of sweep 1")
        first_panel, sweep_s = [], []
        for rank in (0, 1):
            text = rank_log(log_dir, rank)
            if "WORLD 3" not in text or "WORLD 2" not in text:
                fail(f"dlinalg 31a: rank {rank} missed an incarnation\n"
                     f"{text[-2000:]}")
            round1 = text.split("WORLD 2", 1)[1]
            m = re.search(r"RESUMED step=(\d+) sweep=(\d+) panel=(\d+)",
                          round1)
            if m is None:
                fail(f"dlinalg 31a: rank {rank} resumed fresh\n"
                     f"{round1[-2000:]}")
            sweep, panel = int(m.group(2)), int(m.group(3))
            panels = [(int(a), int(b), float(c)) for a, b, c in re.findall(
                r"PANEL (\d+) (\d+) ([\d.]+)", round1)]
            if not panels or panels[0][:2] != (sweep, panel) or \
                    (sweep, panel) < (1, 0):
                fail(f"dlinalg 31a: rank {rank} resumed at "
                     f"{(sweep, panel)} but its first panel was "
                     f"{panels[:1]}")
            if len(set(p[:2] for p in panels)) != len(panels):
                fail(f"dlinalg 31a: rank {rank} recomputed a panel")
            done = re.search(r"DONE (\d+) ([\d.eE+-]+)", round1)
            th = re.search(r"THETA_ERR ([\d.eE+-]+)", round1)
            if done is None or th is None or not float(done.group(2)) \
                    < 1e-6 or not float(th.group(1)) < 1e-6:
                fail(f"dlinalg 31a: rank {rank}: {done and done.group(0)} "
                     f"{th and th.group(0)}\n{round1[-1500:]}")
            first_panel.append(panels[0][2])
            stamps = [float(s) for s in re.findall(
                r"SWEEP \d+ \S+ ([\d.]+)", round1)]
            sweep_s += list(np.diff(stamps))
            if rank == 0:
                out["resumed_at"] = [sweep, panel]
                out["residual"] = float(done.group(2))
                out["theta_err"] = float(th.group(1))
                out["sweeps"] = int(done.group(1))
        t0 = rank_log(log_dir, 0)
        w3 = t0.split("WORLD 2", 1)[0]
        start = float(re.search(r"START ([\d.]+)", w3).group(1))
        sweep0 = float(re.search(r"SWEEP 0 \S+ ([\d.]+)", w3).group(1))
        built = [float(x) for x in re.findall(r"BUILT ([\d.eE+-]+)", t0)]
        out.update({
            "recovery_s": min(first_panel) - killed_at,
            "sweep_s_world3": sweep0 - start,
            "sweep_s_world2_median": float(np.median(sweep_s))
            if sweep_s else None,
            "matrix_build_s": built, "job_s": secs})
        log(f"  31a eigensolve N {DLA_N}, block {DLA_BLOCK}, p {DLA_P}, "
            f"tol {DLA_TOL}, --np 2:3: rank 2 SIGKILLed itself in sweep 1, "
            f"a scale event, both survivors resumed at (sweep, panel) "
            f"{out['resumed_at']} with no panel recomputed; DONE after "
            f"{out['sweeps']} sweeps, residual {out['residual']:.3e}, "
            f"THETA_ERR {out['theta_err']:.3e}; recovery (SELF_SIGKILL to "
            f"the first resumed PANEL) {out['recovery_s']:.2f} s; a sweep "
            f"{out['sweep_s_world3']:.2f} s at world 3 (sweep 0), "
            f"{out['sweep_s_world2_median']} s at world 2 (median); host "
            f"build of A {[round(b, 2) for b in built]} s a rank; job "
            f"{secs:.1f} s")
    finally:
        import shutil
        shutil.rmtree(root, ignore_errors=True)
    return out


def elastic_phase(pt):
    """31b: the elastic BERT-base fine-tune. -> ({kernel: its launches},
    the numbers)."""
    L = pt.bert_base().num_layers
    per_step = {"flash_fwd": L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
                "layer_norm": 2 * L + 1, "fused_adamw": 1}
    root = tempfile.mkdtemp(prefix="elastic_")
    acc, out = {}, {}
    try:
        rc, err, log_dir, secs = run_elastic_job("31b", root, "elastic", {})
        killed_at = scale_checks("elastic 31b", rc, err, log_dir)
        digests, steps, shares, first = [], {3: [], 2: []}, \
            {3: [], 2: []}, []
        grad_checks = []
        last_committed = (EL_KILL_AFTER - 1) // EL_INTERVAL * EL_INTERVAL
        per_epoch2 = EL_SAMPLES // (2 * EL_B)
        for rank in (0, 1, 2):
            text = rank_log(log_dir, rank)
            incs = [c for c in re.split(r"(?=SPAWNED )", text) if c.strip()]
            for c in incs:
                world = int(re.search(r"WORLD (\d+)", c).group(1))
                g = re.search(r"GRAD_SYNC world=\d+ (\{.*\}) ok", c)
                if g is None:
                    fail(f"elastic 31b: rank {rank} world {world}: no "
                         f"passing gradient check\n{c[-2000:]}")
                grad_checks.append(json.loads(g.group(1)))
                rows = [line.split(" ", 7) for line in c.splitlines()
                        if line.startswith("BATCH ")]
                if rows:
                    got = json.loads(rows[-1][7])
                    want = {k: v * len(rows) for k, v in per_step.items()}
                    if {k: got.get(k, 0) for k in per_step} != want:
                        fail(f"elastic 31b: rank {rank} world {world}: "
                             f"launches {got} != {want} for {len(rows)} "
                             f"steps")
                    add_launches(acc, got)
                if rank == 2:
                    continue
                host = [float(r[5]) for r in rows]
                ar = [float(r[6]) for r in rows]
                saved = set(range(EL_INTERVAL - 1, 64, EL_INTERVAL))
                for i in range(2, len(rows)):
                    if int(rows[i][2]) - 1 in saved:
                        continue    # the sync snapshot before this step
                    steps[world].append((host[i] - host[i - 1]) * 1e3)
                    shares[world].append(ar[i] / (host[i] - host[i - 1]))
                if world == 2:
                    m = re.search(r"RESUMED epoch=(\d+) step=(\d+) "
                                  r"global_step=(\d+)", c)
                    if m is None or int(m.group(3)) != last_committed:
                        fail(f"elastic 31b: rank {rank} resumed at "
                             f"{m and m.group(0)}, the last committed step "
                             f"is {last_committed}\n{c[-2000:]}")
                    order = [(int(r[1]), int(r[2])) for r in rows]
                    want = [(0, s) for s in range(int(m.group(2)),
                                                  per_epoch2)]
                    if order != want:
                        fail(f"elastic 31b: rank {rank} ran batches {order}"
                             f" after the resume, not {want}")
                    if "RESUMED_RESHARDED world=3->2" not in c or \
                            "GRAPH_BREAKS 1" not in c:
                        fail(f"elastic 31b: rank {rank}: no reshard note "
                             f"or not one graph break\n{c[-1500:]}")
                    first.append(float(rows[0][4]))
                    d = re.search(r"DIGEST (\w+)", c)
                    digests.append(d and d.group(1))
        if len(digests) != 2 or digests[0] is None or \
                digests[0] != digests[1]:
            fail(f"elastic 31b: replicas' digests {digests}")
        for k in per_step:
            if not acc.get(k):
                fail(f"elastic 31b: kernel {k} never launched")
        out = {
            "step_ms_world3": steps[3], "step_ms_world2": steps[2],
            "step_ms_world3_median": float(np.median(steps[3])),
            "step_ms_world2_median": float(np.median(steps[2])),
            "allreduce_share_world3": float(np.median(shares[3])),
            "allreduce_share_world2": float(np.median(shares[2])),
            "recovery_s": min(first) - killed_at, "digest": digests[0],
            "grad_sync": {
                "checks": len(grad_checks),
                "leaves": grad_checks[0]["leaves"],
                "small_elements": grad_checks[0]["small"],
                "elem_ratio_max": max(c["elem_ratio"] for c in grad_checks),
                "proj_ratio_max": max(c["proj_ratio"]
                                      for c in grad_checks)},
            "resumed_at_global_step": last_committed, "job_s": secs,
            "launches": {k: acc.get(k, 0) for k in per_step}}
        log(f"  31b BERT-base fit, B {EL_B} x S {EL_S} a rank, O1, "
            f"DataParallel over gloo, --np 2:3: rank 2 SIGKILLed itself "
            f"after step {EL_KILL_AFTER}, a scale event, ranks 0 and 1 "
            f"resumed at global step {last_committed} (the last committed "
            f"snapshot) at world 2 and ran each remaining batch once; "
            f"digests bit-equal ({digests[0]}); the first synced step's "
            f"average held against the plain mean of the ranks' "
            f"gradients in each incarnation ({out['grad_sync']}; errors "
            f"over their bound, <= 1 passes); step "
            f"{out['step_ms_world3_median']:.1f} ms at world 3, "
            f"{out['step_ms_world2_median']:.1f} ms at world 2 (medians; "
            f"eager: the gloo sync breaks the staged step); the "
            f"all-reduce {out['allreduce_share_world3']:.1%} / "
            f"{out['allreduce_share_world2']:.1%} of a step; recovery "
            f"(SELF_SIGKILL to the first resumed step's end) "
            f"{out['recovery_s']:.2f} s; launches exact an incarnation "
            f"{out['launches']}; job {secs:.1f} s")
    finally:
        import shutil
        shutil.rmtree(root, ignore_errors=True)
    return {k: {"elastic_launches": acc.get(k, 0)} for k in per_step}, out


def elastic_phases(pt, K):
    """Phase 31: 31a, then 31b, each alone on the card. -> ({kernel: its
    ``elastic_launches``}, the numbers)."""
    t0 = time.perf_counter()
    free()
    numbers = {"31a": dlinalg_phase(pt)}
    free()
    launches, numbers["31b"] = elastic_phase(pt)
    numbers["phase_s"] = time.perf_counter() - t0
    log(f"  phase 31 {numbers['phase_s']:.1f} s")
    log("  " + json.dumps(numbers, default=str))
    return launches, numbers


# ----------------------------------------------- the serving fleet (32)
FLEET_JOB = "p32"
FL_SESSIONS, FL_PER_SESSION, FL_HEAD, FL_TAILS = 8, 6, 128, (16, 256)
FL_NEW, FL_QPS = 32, 16.0
FL_BURST, FL_WAVE, FL_BURST_NEW = 24, 8, 16
FD_REQUESTS, FD_NEW, FD_LAYERS, FD_POOL, FD_DIE_AT = 24, 32, 24, 512, 13
FD_DEVICE = "cuda"
FD_WORKER = [os.path.abspath(__file__), "--fleet-engine-worker"]


class FleetTimers:
    """Host seconds of one engine's page-share work, by wrapping its
    cache's and share client's methods: the gather and copy of a publish
    (``_page_payload``), the store writes (``publish``), an insert's whole
    stall (``insert``, a prompt's publish inside its round), the store
    reads of an import (``fetch``) and its writes into the pools
    (``_write_page``)."""

    def __init__(self, eng):
        self.s = {k: 0.0 for k in ("gather", "publish", "insert", "fetch",
                                   "write")}
        self.n = {k: 0 for k in self.s}
        self.fetched_bytes = 0
        self.inserts = []        # (seconds, pages published) per insert
        self.remote_prompts = set()
        cache, share = eng.prefix, eng.prefix.share
        for obj, name, key in ((cache, "_page_payload", "gather"),
                               (share, "publish", "publish"),
                               (share, "fetch", "fetch"),
                               (cache, "_write_page", "write")):
            setattr(obj, name, self._timed(getattr(obj, name), key))
        insert, lookup = cache.insert, cache.lookup

        def timed_insert(tokens, pages):
            before, t0 = share.published, time.perf_counter()
            insert(tokens, pages)
            dt = time.perf_counter() - t0
            self.s["insert"] += dt
            self.n["insert"] += 1
            self.inserts.append((dt, share.published - before))

        def recording_lookup(tokens):
            before = share.remote_hits
            out = lookup(tokens)
            if share.remote_hits > before:
                self.remote_prompts.add(tuple(int(t) for t in tokens))
            return out

        cache.insert, cache.lookup = timed_insert, recording_lookup

    def _timed(self, fn, key):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            self.s[key] += time.perf_counter() - t0
            self.n[key] += 1
            if key == "fetch" and out is not None:
                self.fetched_bytes += len(out)
            return out
        return timed


def fleet_pages(eng, tokens, n):
    """The local pages of ``tokens``' first ``n`` full pages in ``eng``'s
    trie, walked from the root."""
    ps, node, out = eng.page_size, -1, []
    for i in range(n):
        node = eng.prefix._index[(node, tuple(tokens[i * ps:(i + 1) * ps]))]
        out.append(node)
    return out


def fleet_drive(engines, until, max_steps=2000):
    """Step ``engines`` round-robin (no serve loops) until ``until()``."""
    for _ in range(max_steps):
        for e in engines:
            if not e._closed:
                e.step()
        if until():
            return
    fail("fleet: the engines did not converge")


class FleetLaunches:
    """Phase 32a's launch accounting: segments between resets, each held
    against the rounds the engines launched in it (24 attention and 49
    LayerNorm launches a round at 24 layers; a pad captured in the
    segment launches its eager warm-up beside its first replay)."""

    def __init__(self, K, L):
        self.K, self.L, self.total, self.rounds = K, L, {}, 0
        self.start([])

    def start(self, engines):
        torch.cuda.synchronize()
        self.K.reset_launch_counts()
        self.marks = {id(e): e.launched for e in engines}

    def check(self, tag, engines, extra_rounds=0):
        rounds = extra_rounds + sum(
            e.launched - self.marks.get(id(e), 0) for e in engines)
        got = check_launches(self.K, f"fleet {tag}", rounds, self.L)
        add_launches(self.total, got)
        self.rounds += rounds
        self.start(engines)
        return rounds


def near_tie_check(model, prompt, got, want):
    """``got`` against ``want`` (greedy tokens of one prompt): equal, or
    at the first divergence both are argmaxes within phase 15's bf16
    tolerance of one no-cache forward over ``got`` -> "equal" or
    "near-tie at i"; fails otherwise."""
    if got == want:
        return "equal"
    i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
    for seq in (got, want):
        ids = torch.tensor([prompt + seq[:i + 1]], device=model.device)
        _, _, short, ok = teacher_forced(model, ids, len(prompt))
        if not ok:
            fail(f"fleet: tokens diverge at {i} and are no near-tie "
                 f"(shortfall {short:.4g})")
    return f"near-tie at {i}"


def fleet_teacher_forced(model, frs):
    """Every request's greedy tokens against one no-cache forward over
    prompt + tokens (phase 15's tolerance) -> (at the reference, tokens,
    largest shortfall)."""
    top = n = 0
    worst = 0.0
    for fr in frs:
        ids = torch.tensor([fr.prompt_ids + fr.generated],
                           device=model.device)
        a, b, short, ok = teacher_forced(model, ids, len(fr.prompt_ids))
        if not ok:
            fail(f"fleet: request {fr.request_id}: a greedy token is not "
                 f"the argmax of the no-cache forward (shortfall "
                 f"{short:.4g})")
        top, n, worst = top + a, n + b, max(worst, short)
    return top, n, worst


def fleet_share_checks(acc, model, e0, e1, r):
    """32a (1) and (2): a head published on e0, imported by e1 bit for
    bit; a prefetch on an affinity spill imports a head before the
    spilled request is admitted. Engines stepped by hand here."""
    rng = np.random.RandomState(SEED + 32)
    V, ps = model.config.vocab_size, e0.page_size
    head = rng.randint(1, V, FL_HEAD).tolist()
    n_pages = FL_HEAD // ps
    a = r.submit(head + rng.randint(1, V, 40).tolist(), max_new_tokens=16,
                 engine="e0")
    fleet_drive([e0], a.done)
    if e0.prefix.share.published != n_pages:
        fail(f"fleet: e0 published {e0.prefix.share.published} pages, "
             f"not {n_pages}")
    tail_b = head + rng.randint(1, V, 24).tolist()
    # a session key of its own: no affinity to e0, so no prefetch, and
    # e1's admission imports the head itself
    b = r.submit(tail_b, max_new_tokens=16, engine="e1", session="b")
    e1.step()
    leg = b._leg
    if leg.prefix_hit_tokens != FL_HEAD or \
            e1.prefix.share.remote_hits != 1:
        fail(f"fleet: e1's admission hit {leg.prefix_hit_tokens} tokens "
             f"({e1.prefix.share.remote_hits} remote hits), not the "
             f"{FL_HEAD}-token head")
    mine, theirs = fleet_pages(e1, tail_b, n_pages), \
        fleet_pages(e0, tail_b, n_pages)
    for p1, p0 in zip(mine, theirs):
        if e1.prefix._page_payload(p1) != e0.prefix._page_payload(p0):
            fail(f"fleet: imported page {p1} differs from e0's {p0}")
    fleet_drive([e1], b.done)
    c = r.submit(tail_b, max_new_tokens=16, engine="e0", session="c")
    fleet_drive([e0], c.done)
    if b.result(1) != c.result(1):
        fail(f"fleet: e1 (imported head) {b.result(1)} != e0 (its own "
             f"head) {c.result(1)}")
    acc.check("page sharing", [e0, e1])
    log(f"  (1) page sharing: e0 published {n_pages} pages of its "
        f"{FL_HEAD}-token head; e1's admission imported them "
        f"({e1.prefix.share.remote_hit_tokens} tokens), each page's "
        f"{len(e0.prefix._page_payload(theirs[0]))} B bit-equal to e0's; "
        f"e1's {len(b.generated)} greedy tokens equal e0's on the same "
        f"prompt")
    # (2) a second session's head on e0; five fillers pile on e0 so the
    # session's next request spills to e1, whose prefetch (the router's
    # own thread) imports the head while e1 is not stepping
    head2 = rng.randint(1, V, FL_HEAD).tolist()
    d = r.submit(head2 + rng.randint(1, V, 20).tolist(), max_new_tokens=8,
                 engine="e0")
    fleet_drive([e0], d.done)
    fillers = [r.submit(rng.randint(1, V, 16).tolist(), max_new_tokens=4,
                        engine="e0") for _ in range(5)]
    hit0, tok0, pf0 = e1.prefix.share.remote_hits, \
        e1.prefix.share.remote_hit_tokens, r.prefetch_pages
    spill = r.submit(head2 + rng.randint(1, V, 20).tolist(),
                     max_new_tokens=8)
    if spill.engine_id != "e1":
        fail(f"fleet: the session did not spill ({spill.engine_id})")
    t0 = time.perf_counter()
    while r.prefetch_pages - pf0 < n_pages and \
            time.perf_counter() - t0 < 60:
        time.sleep(0.005)
    t_pf = time.perf_counter() - t0
    if r.prefetch_pages - pf0 != n_pages or \
            spill._leg.state != "waiting" or \
            e1.prefix.share.remote_hit_tokens - tok0 != FL_HEAD:
        fail(f"fleet: prefetch imported {r.prefetch_pages - pf0} pages "
             f"(request {spill._leg.state})")
    e1.step()
    if spill._leg.prefix_hit_tokens != FL_HEAD or \
            e1.prefix.share.remote_hits != hit0 + 1:
        fail(f"fleet: the spilled request hit "
             f"{spill._leg.prefix_hit_tokens} tokens")
    fleet_drive([e0, e1], lambda: all(f.done() for f in fillers + [spill]))
    acc.check("prefetch", [e0, e1])
    log(f"  (2) affinity spill: the session's request went to e1 "
        f"(e0 {len(fillers)} deeper); the router's prefetch thread "
        f"imported {r.prefetch_pages - pf0} pages in {t_pf * 1e3:.1f} ms, "
        f"before admission; "
        f"its admission then hit the {FL_HEAD}-token head locally")
    return [a, b, c, d, spill] + fillers


def fleet_hedge_check(acc, model, e0, e1):
    """32a (3): a hedge on a stalled e0; the duplicate on e1 wins, the
    loser is aborted (slot and pages back at refcount 0, its on_done never
    fired)."""
    from paddle_tpu_torch.serving.fleet import FleetRouter
    r = FleetRouter(hedge_after_s=0.5)
    r.add_engine(e0, "e0")
    r.add_engine(e1, "e1")
    done_legs = []
    on_done = r._on_leg_done

    def recording(leg):
        done_legs.append(leg)
        on_done(leg)

    r._on_leg_done = recording
    prompt = np.random.RandomState(SEED + 33).randint(
        1, model.config.vocab_size, 200).tolist()
    stream = []
    fr = r.submit(prompt, max_new_tokens=24, engine="e0",
                  on_token=lambda q, t, fin: stream.append(t))
    e0.step()
    e0.step()
    leg0 = fr._leg
    pages0 = list(leg0.pages)
    if r.hedge_sweep(now=fr.t_submit + 99.0) != 1:
        fail("fleet: no hedge fired")
    fleet_drive([e1], fr.done)
    alloc = e0.kv.allocator
    if not (r.hedges_won == 1 and r.aborts == 1 and leg0.state == "aborted"
            and not e0.scheduler.active and fr.engine_id == "e1"
            and all(alloc.refcount(p) == 0 for p in pages0)
            and leg0 not in done_legs and stream == fr.result(1)):
        fail(f"fleet: hedge won {r.hedges_won}, aborts {r.aborts}, loser "
             f"{leg0.state}, e0 active {len(e0.scheduler.active)}, "
             f"refcounts {[alloc.refcount(p) for p in pages0]}")
    acc.check("hedge", [e0, e1])
    log(f"  (3) hedge: e0 stalled after 2 rounds; the duplicate on e1 won "
        f"({len(fr.generated)} tokens, the stream without a duplicate), "
        f"the loser aborted: {len(pages0)} pages at refcount 0, its "
        f"on_done never fired")
    return fr, prompt


def fleet_load(acc, model, e0, e1, r, timers):
    """32a (4): the session load through the router on the serve loops,
    e1 killed mid-load by ``engine_die@serve_loop``."""
    import threading
    from paddle_tpu_torch.distributed import fault
    from paddle_tpu_torch.serving import (make_session_prompts,
                                          run_poisson_load)
    prompts, _ = make_session_prompts(
        FL_SESSIONS, FL_PER_SESSION, FL_HEAD, FL_TAILS,
        model.config.vocab_size, seed=SEED + 34)
    sent = []
    submit = r.submit

    def recording_submit(prompt, **kw):
        sent.append(submit(prompt, **kw))
        return sent[-1]

    os.environ["PADDLE_TPU_FAULT_ENGINE"] = "e1"
    r.submit = recording_submit
    killed = {}

    def kill_e1():
        while len(sent) < len(prompts) // 2 or not e1.scheduler.active:
            if len(sent) >= len(prompts):
                return
            time.sleep(0.002)
        killed["at"] = len(sent)
        fault.set_fault_spec("engine_die@serve_loop:1")

    r.start()
    watcher = threading.Thread(target=kill_e1, daemon=True)
    watcher.start()
    try:
        res = run_poisson_load(r, qps=FL_QPS, prompts=prompts,
                               max_new_tokens=FL_NEW, seed=SEED,
                               timeout=300.0, by_engine=True)
    finally:
        del r.submit
        watcher.join(5)
        fault.set_fault_spec(None)
        os.environ.pop("PADDLE_TPU_FAULT_ENGINE", None)
    if e1._loop_error is None or "engine_die" not in str(e1._loop_error):
        fail(f"fleet: e1 did not die mid-load ({e1._loop_error})")
    if res["requests_ok"] != len(prompts) or res["requests_failed"] or \
            res["tokens"] != len(prompts) * FL_NEW:
        fail(f"fleet load: {res['requests_failed']} failed, "
             f"{res['tokens']} tokens of {len(prompts) * FL_NEW}")
    moved = [f for f in sent if f.redispatches]
    if not moved or any(f.engine_ids[-1] != "e0" for f in moved):
        fail(f"fleet: {len(moved)} requests re-dispatched from e1, "
             f"ending on {[f.engine_ids for f in moved]}")
    groups = {"remote hit": [], "local hit": [], "cold": []}
    remote = timers["e0"].remote_prompts | timers["e1"].remote_prompts
    for f in sent:
        if tuple(f.prompt_ids) in remote:
            groups["remote hit"].append(f)
        elif f._leg is not None and f._leg.prefix_hit_tokens and \
                not f.redispatches:
            groups["local hit"].append(f)
        else:
            groups["cold"].append(f)
    ttft = {k: (len(v),
                float(np.percentile([f.ttft_s() * 1e3 for f in v], 50))
                if v else None,
                float(np.percentile([f.ttft_s() * 1e3 for f in v], 99))
                if v else None) for k, v in groups.items()}
    log(f"  (4) session load ({FL_SESSIONS} sessions x {FL_PER_SESSION}, "
        f"head {FL_HEAD}, tails {FL_TAILS}, {FL_NEW} new, Poisson "
        f"{FL_QPS} req/s) through the router: {res['tokens_per_sec']} "
        f"tokens/s, TTFT p50 {res['ttft_ms_p50']} / p99 "
        f"{res['ttft_ms_p99']} ms, ITL p50 {res['itl_ms_p50']} / p99 "
        f"{res['itl_ms_p99']} ms; by engine {json.dumps(res['by_engine'])}")
    log("      TTFT by admission (requests, p50, p99 ms): " + ", ".join(
        f"{k} {n} / {p50 and round(p50, 2)} / {p99 and round(p99, 2)}"
        for k, (n, p50, p99) in ttft.items()))
    log(f"  (5) engine loss: engine_die@serve_loop aimed at e1 after "
        f"{killed.get('at')} submissions; {len(moved)} of its requests "
        f"re-dispatched to e0 and finished")
    rounds = acc.check("load", [e0, e1])
    res["ttft_by_admission"] = ttft
    res["rounds"] = rounds
    return res, sent, moved


def fleet_autoscale(acc, model, e0, r, reg):
    """32a (6): a burst on the one live engine spawns a warm third
    (512 pages); idle, the autoscaler drains it again."""
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.serving.fleet import EngineAutoscaler
    spawned = {}

    def spawn(eid):
        # "pallas": the kernel, without the measure-only A/B gate a
        # construction would otherwise time (its launches are no round's)
        eng = ServingEngine(model, engine_id=eid, attn_backend="pallas",
                            **{**OPS_ENGINE, "num_pages": 512})
        count_rounds(eng)
        # the launch counts are process-wide: warm (capture) while the
        # live engine's rounds wait, so no replay lands in a capture
        with e0._step_lock:
            eng.spawn_pads = len(eng.warm_ragged())
        spawned[eid] = eng
        return eng

    sc = EngineAutoscaler(r, spawn, min_engines=1, max_engines=2,
                          queue_high=4.0, queue_low=0.5, up_ticks=2,
                          down_ticks=2, cooldown_s=0.0)
    rng = np.random.RandomState(SEED + 35)
    V = model.config.vocab_size
    burst = [r.submit(rng.randint(1, V, int(n)).tolist(),
                      max_new_tokens=FL_BURST_NEW)
             for n in rng.randint(16, 256, FL_BURST)]
    acts, now = [], 0.0
    while "up" not in acts and now < 20:
        now += 1.0
        acts.append(sc.tick(now=now))
    wave = [r.submit(rng.randint(1, V, int(n)).tolist(),
                     max_new_tokens=FL_BURST_NEW)
            for n in rng.randint(16, 256, FL_WAVE)]
    for f in burst + wave:
        f.result(120)
    spare = spawned.get("a0")
    while "down" not in acts and now < 40:
        now += 1.0
        acts.append(sc.tick(now=now))
    c = reg.snapshot()["counters"]
    ev = {d: c.get(f"serving_scale_events_total{{direction={d}}}", 0)
          for d in ("up", "down")}
    if spare is None or acts.count("up") != 1 or acts.count("down") != 1 \
            or ev != {"up": 1, "down": 1} or not spare._closed \
            or set(r.handles()) != {"e0"} or spare.launched <= \
            spare.spawn_pads:
        fail(f"fleet autoscale: actions {acts}, scale events {ev}, "
             f"roster {sorted(r.handles())}")
    served = sum(1 for f in wave if "a0" in f.engine_ids)
    acc.check("autoscale", [e0, spare], extra_rounds=spare.spawn_pads)
    log(f"  (6) autoscaler: e1 struck ({sc.quarantine.quarantined()}); "
        f"a burst of {FL_BURST} on e0 -> scale up after "
        f"{acts.index('up') + 1} ticks (a0: 512 pages, "
        f"{spare.spawn_pads} pads captured before rotation), a wave of "
        f"{FL_WAVE} ({served} on a0), idle -> scale down; "
        f"serving_scale_events_total {ev}; events "
        f"{[(e['dir'], e['engine'], e['n_engines']) for e in sc.events]}")
    sc.close()
    return burst + wave


def fleet_inprocess(pt, K):
    """32a: the fleet in this process -> (launches, numbers)."""
    from paddle_tpu_torch.distributed.tcp_store import TCPStore
    from paddle_tpu_torch.observability import metrics as obsm
    from paddle_tpu_torch.serving.fleet import FleetRouter, PageShareClient
    t0 = time.perf_counter()
    cfg = pt.gpt_1p3b(dropout=0.0)
    L = cfg.num_layers
    model = pt.GPTForCausalLM(cfg, dtype=torch.bfloat16, seed=SEED)
    port = free_port()
    master = TCPStore("127.0.0.1", port, is_master=True)
    reg = obsm.enable(out_dir=None, interval_s=0)
    engines, timers = {}, {}
    for eid in ("e0", "e1"):
        share = PageShareClient(TCPStore("127.0.0.1", port), eid,
                                job=FLEET_JOB)
        eng = pt.ServingEngine(model, engine_id=eid, page_share=share,
                               **OPS_ENGINE)
        eng.warm_ragged()
        count_rounds(eng)
        timers[eid] = FleetTimers(eng)
        engines[eid] = eng
    e0, e1 = engines["e0"], engines["e1"]
    log(f"[fleet] 32a: gpt_1p3b bf16, e0 and e1 ({e0.kv.nbytes() / 1e9:.2f}"
        f" GB of KV each, {e0.stats()['graphs']} graphs each, page share "
        f"over a TCPStore on this host) behind a FleetRouter; set up in "
        f"{time.perf_counter() - t0:.1f} s")
    acc = FleetLaunches(K, L)
    try:
        r = FleetRouter()
        r.add_engine(e0, "e0")
        r.add_engine(e1, "e1")
        frs = fleet_share_checks(acc, model, e0, e1, r)
        h_fr, h_prompt = fleet_hedge_check(acc, model, e0, e1)
        res, load_frs, moved = fleet_load(acc, model, e0, e1, r, timers)
        burst = fleet_autoscale(acc, model, e0, r, reg)
        launches = dict(acc.total)
        # correctness of every token (after the launch counts: these
        # forwards launch kernels of their own)
        e0.stop()
        top, n, worst = fleet_teacher_forced(
            model, frs + [h_fr] + load_frs + burst)
        verdicts = [near_tie_check(model, f.prompt_ids, f.result(1),
                                   e0.generate(f.prompt_ids,
                                               max_new_tokens=FL_NEW))
                    for f in moved]
        verdicts.append(near_tie_check(
            model, h_prompt, h_fr.result(1),
            e0.generate(h_prompt, max_new_tokens=24)))
        log(f"  tokens: {top} of {n} at the no-cache forward's argmax, the "
            f"rest within phase 15's tolerance (largest shortfall "
            f"{worst:.4g}); re-dispatched and hedged requests against e0 "
            f"alone: {verdicts}")
        num = fleet_share_numbers(timers)
        r.close()
    finally:
        obsm.disable()
        for eng in engines.values():
            eng.close()
        del master
    out = {"load": {k: res[k] for k in (
        "tokens_per_sec", "ttft_ms_p50", "ttft_ms_p99", "itl_ms_p50",
        "itl_ms_p99", "requests_ok", "by_engine", "ttft_by_admission",
        "rounds")},
        "share": num, "redispatched": len(moved),
        "redispatch_verdicts": verdicts, "rounds": acc.rounds,
        "teacher_forced": {"at_argmax": top, "tokens": n,
                           "worst_shortfall": worst},
        "phase_s": time.perf_counter() - t0}
    return launches, out


def fleet_share_numbers(timers):
    """Publish, fetch and import host times over both engines."""
    tot = {k: sum(t.s[k] for t in timers.values())
           for k in ("gather", "publish", "insert", "fetch", "write")}
    cnt = {k: sum(t.n[k] for t in timers.values()) for k in tot}
    nbytes = sum(t.fetched_bytes for t in timers.values())
    pages = sum(p for t in timers.values() for _, p in t.inserts)
    stalls = [dt * 1e3 for t in timers.values() for dt, p in t.inserts
              if p]
    num = {
        "published_pages": pages,
        "publish_ms_per_page": (tot["gather"] + tot["publish"]) * 1e3
        / max(pages, 1),
        "gather_ms_per_page": tot["gather"] * 1e3 / max(cnt["gather"], 1),
        "store_set_ms_per_page": tot["publish"] * 1e3
        / max(cnt["publish"], 1),
        "insert_stall_ms_p50": float(np.median(stalls)) if stalls else None,
        "insert_stall_ms_max": max(stalls) if stalls else None,
        "fetched_pages": cnt["write"],
        "fetch_ms_per_page": tot["fetch"] * 1e3 / max(cnt["write"], 1),
        "import_write_ms_per_page": tot["write"] * 1e3
        / max(cnt["write"], 1),
        "fetch_MB_per_s": nbytes / 1e6 / tot["fetch"] if tot["fetch"]
        else None}
    log(f"  page share: {pages} pages published, "
        f"{num['publish_ms_per_page']:.3f} ms a page (gather and copy "
        f"{num['gather_ms_per_page']:.3f}, store writes "
        f"{num['store_set_ms_per_page']:.3f}); an insert that publishes "
        f"stalls its round {num['insert_stall_ms_p50']} ms (median), "
        f"{num['insert_stall_ms_max']} ms (max); {num['fetched_pages']} "
        f"pages imported, fetch {num['fetch_ms_per_page']:.3f} ms a page "
        f"({num['fetch_MB_per_s']} MB/s through the store), write into "
        f"the pools {num['import_write_ms_per_page']:.3f} ms a page")
    return num


def fleet_engine_worker(argv):
    """``chip_smoke.py --fleet-engine-worker ARGS``: one engine process of
    32b, ``paddle_tpu_torch.serving.fleet.remote.main(ARGS)``, with its
    rounds, the legs it was given and its kernels' launches counted from
    the start of its store-RPC loop and printed at exit as ``FLEET_ENGINE
    {...}``."""
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.serving import engine as E
    remote = importlib.import_module("paddle_tpu_torch.serving.fleet.remote")
    counts = {"rounds": 0, "legs": 0}
    ragged_fn, submit = E.ServingEngine._ragged_fn, \
        E.ServingEngine.submit_request
    serve = remote.serve_over_store
    held = []

    def counting_fn(self, *a, **kw):
        counts["rounds"] += 1
        return ragged_fn(self, *a, **kw)

    def counting_submit(self, req, block=True, timeout=10.0):
        counts["legs"] += 1
        return submit(self, req, block=block, timeout=timeout)

    def counted_serve(eng, *a, **kw):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        counts.update(rounds=0, legs=0, graphs=eng.stats()["graphs"])
        held.append(eng)
        print(f"FLEET_ENGINE_READY {time.time():.6f}", flush=True)
        return serve(eng, *a, **kw)

    E.ServingEngine._ragged_fn = counting_fn
    E.ServingEngine.submit_request = counting_submit
    remote.serve_over_store = counted_serve
    rc = remote.main(argv)
    torch.cuda.synchronize()
    eng = held[0]
    st = eng.stats()
    print("FLEET_ENGINE " + json.dumps({
        "layers": eng.cfg.num_layers, "rounds": counts["rounds"],
        "legs": counts["legs"], "decode_tokens": st["decode_tokens"],
        "launches": {k: v for k, v in K.launch_counts().items() if v},
        "remote_hits": st.get("prefix_remote_hits"),
        "published": st.get("prefix_published_pages"),
        "graphs": counts["graphs"]}), flush=True)
    return rc


def fleet_spawn(args, env, tag, root):
    """Start one process of 32b, its output into ``root/tag.log``."""
    out = open(os.path.join(root, f"{tag}.log"), "w")
    proc = subprocess.Popen(args, env=env, cwd=HERE, stdout=out,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    proc.log_path = out.name
    out.close()
    return proc


def fleet_log(proc):
    with open(proc.log_path) as f:
        return f.read()


def fleet_frontdoor(pt):
    """32b: two engine processes, a primary and a shadow front door, the
    primary SIGKILLed mid-stream -> (launches, numbers)."""
    import signal
    import threading
    from paddle_tpu_torch.distributed import keyspace
    from paddle_tpu_torch.distributed.tcp_store import TCPStore
    from paddle_tpu_torch.serving import make_session_prompts
    from paddle_tpu_torch.serving.fleet import (EngineRegistry,
                                                RouterClient, RouterLease)
    t0 = time.perf_counter()
    job = "fd"
    port = free_port()
    master = TCPStore("127.0.0.1", port, is_master=True)
    store = f"127.0.0.1:{port}"
    cfg = pt.gpt_1p3b(dropout=0.0)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PADDLE_TPU_")}
    root = tempfile.mkdtemp(prefix="fleet_")
    eng_args = ["--store", store, "--job", job, "--seed", str(SEED),
                "--share", "--device", FD_DEVICE, "--dtype", "bfloat16",
                "--vocab", str(cfg.vocab_size), "--hidden",
                str(cfg.hidden_size), "--layers", str(FD_LAYERS),
                "--heads", str(cfg.num_heads), "--seq",
                str(cfg.max_seq_len), "--page", "16", "--pool",
                str(FD_POOL), "--slots", "16", "--chunk", "256",
                "--idle-timeout", "300"]
    procs = {eid: fleet_spawn([sys.executable] + FD_WORKER + eng_args
                              + ["--engine-id", eid], env, eid, root)
             for eid in ("e0", "e1")}
    registry = EngineRegistry(TCPStore("127.0.0.1", port), job=job)
    out = {}
    try:
        deadline = time.perf_counter() + 300
        while set(registry.engines()) != {"e0", "e1"}:
            for eid, p in procs.items():
                if p.poll() is not None:
                    fail(f"fleet 32b: engine {eid} exited {p.returncode}\n"
                         + fleet_log(p)[-3000:])
            if time.perf_counter() > deadline:
                fail("fleet 32b: the engine processes never registered")
            time.sleep(0.2)
        t_engines = time.perf_counter() - t0
        fd = [sys.executable, "-m", "paddle_tpu_torch.serving.fleet."
              "frontdoor", "--store", store, "--job", job, "--engines",
              "e0,e1", "--ttl", "1.0"]
        procs["primary"] = fleet_spawn(
            fd + ["--role", "primary"],
            dict(env, PADDLE_TPU_FAULTS=f"router_die@route:{FD_DIE_AT}"),
            "primary", root)
        procs["shadow"] = fleet_spawn(fd + ["--role", "shadow", "--grace",
                                            "2.0"], env, "shadow", root)
        watch = RouterLease(TCPStore("127.0.0.1", port), job=job)
        while watch.read() is None:
            if time.perf_counter() > deadline or \
                    procs["primary"].poll() is not None:
                fail("fleet 32b: the primary never leased\n"
                     + fleet_log(procs["primary"])[-3000:])
            time.sleep(0.1)
        prompts, _ = make_session_prompts(4, FD_REQUESTS // 4, FL_HEAD,
                                          (16, 128), cfg.vocab_size,
                                          seed=SEED + 36)
        rpc = {eid: keyspace.fleet_engine_rpc(job, eid)
               for eid in ("e0", "e1")}
        streams = [[] for _ in prompts]
        results, errors = [None] * len(prompts), []
        t_submit = time.perf_counter()

        def one(i):
            # the primary's dispatches go to e0, the shadow's to e1, which
            # imports the sessions' heads e0 published
            client = RouterClient(TCPStore("127.0.0.1", port), job=job,
                                  resubmit_after=2.0)
            client.submit(f"fd-{i}", prompts[i], max_new_tokens=FD_NEW,
                          engine="e0" if i < FD_DIE_AT - 1 else "e1")
            try:
                results[i] = client.result(
                    f"fd-{i}", timeout=240.0,
                    on_token=lambda t, fin, s=streams[i]: s.append(t))
            except Exception as e:
                errors.append(f"fd-{i}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        t_done = time.perf_counter() - t_submit
        procs["primary"].wait(60)
        plog = fleet_log(procs["primary"])
        if errors or procs["primary"].returncode != -signal.SIGKILL or \
                "ROUTER_DIE" not in plog:
            fail(f"fleet 32b: errors {errors}; primary rc "
                 f"{procs['primary'].returncode}\n{plog[-3000:]}")
        bad = [i for i, (s, t) in enumerate(zip(streams, results))
               if s != t or len(t) != FD_NEW]
        if bad:
            fail(f"fleet 32b: requests {bad} streamed tokens other than "
                 f"their result, or not {FD_NEW}")
        # a resubmitted terminal id: answered from the ledger, no engine
        # touched (their submission logs and decode counters stand still)
        time.sleep(1.0)
        heads = {e: int(master.add(f"{k}/in_seq", 0))
                 for e, k in rpc.items()}
        decoded = {e: registry.record(e)["decode_tokens"] for e in rpc}
        again = RouterClient(TCPStore("127.0.0.1", port), job=job)
        t_re = time.perf_counter()
        again.submit("fd-0", prompts[0], max_new_tokens=FD_NEW)
        replay = again.result("fd-0", timeout=60.0)
        replay_ms = (time.perf_counter() - t_re) * 1e3
        time.sleep(2.0)          # a heartbeat and a few router ticks
        heads2 = {e: int(master.add(f"{k}/in_seq", 0))
                  for e, k in rpc.items()}
        decoded2 = {e: registry.record(e)["decode_tokens"] for e in rpc}
        if replay != results[0] or heads2 != heads or decoded2 != decoded:
            fail(f"fleet 32b: the terminal replay {replay} vs "
                 f"{results[0]}; engine submissions {heads} -> {heads2}, "
                 f"decode tokens {decoded} -> {decoded2}")
        master.set(f"{keyspace.fleet_registry(job)}/stop", b"1")
        for name, p in procs.items():
            if name != "primary":
                p.wait(120)
        slog = fleet_log(procs["shadow"])
        m = re.search(r"ROUTER_ADOPTED term=(\d+) adopt_s=([\d.]+) "
                      r"adopted=(\d+)", slog)
        if procs["shadow"].returncode != 0 or m is None:
            fail(f"fleet 32b: the shadow (rc "
                 f"{procs['shadow'].returncode}) did not adopt\n"
                 f"{slog[-3000:]}")
        acc, legs, per = {}, 0, {}
        for eid in ("e0", "e1"):
            text = fleet_log(procs[eid])
            g = re.search(r"FLEET_ENGINE (\{.*\})", text)
            if procs[eid].returncode != 0 or g is None:
                fail(f"fleet 32b: engine {eid} rc "
                     f"{procs[eid].returncode}\n{text[-3000:]}")
            rec = json.loads(g.group(1))
            L = rec["layers"]
            want = {"ragged_paged_attention": rec["rounds"] * L,
                    "layer_norm": rec["rounds"] * (2 * L + 1)}
            if rec["rounds"] <= 0 or rec["launches"] != want:
                fail(f"fleet 32b: engine {eid} launches "
                     f"{rec['launches']} != {want}")
            add_launches(acc, rec["launches"])
            legs += rec["legs"]
            per[eid] = rec
        if legs != FD_REQUESTS or not per["e1"]["remote_hits"]:
            fail(f"fleet 32b: the engines generated {legs} legs for "
                 f"{FD_REQUESTS} requests; e1 imported "
                 f"{per['e1']['remote_hits']} heads from e0")
        out = {"adopt_s": float(m.group(2)), "adopted": int(m.group(3)),
               "term": int(m.group(1)), "engines": per,
               "engines_ready_s": t_engines, "requests_s": t_done,
               "replay_ms": replay_ms}
        log(f"[fleet] 32b: two engine processes at gpt_1p3b widths, "
            f"{FD_LAYERS} layers, bf16, {FD_POOL} pages, page share "
            f"(ready in {t_engines:.1f} s); primary and shadow front "
            f"doors; {FD_REQUESTS} requests by client id; the primary "
            f"SIGKILLed itself at its {FD_DIE_AT}th dispatch "
            f"(router_die@route); the shadow adopted term {m.group(1)} in "
            f"{m.group(2)} s ({m.group(3)} in-flight records); every "
            f"request done once ({legs} engine legs, streams without a "
            f"duplicate) in {t_done:.1f} s; a resubmitted terminal id "
            f"answered from the ledger in {replay_ms:.1f} ms, no engine "
            f"touched; engine launches exact: "
            + "; ".join(f"{e} {r['rounds']} rounds over {r['graphs']} "
                        f"graphs {r['launches']}, {r['legs']} legs, "
                        f"{r['remote_hits']} remote hits"
                        for e, r in per.items()))
        out["prompts"], out["results"] = prompts, results
    finally:
        for p in procs.values():
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        import shutil
        shutil.rmtree(root, ignore_errors=True)
        del master
    return acc, out


def fleet_reference(pt, out):
    """32b's tokens against an in-process engine of the processes'
    configuration and seed: equal, or a near-tie (bf16 rounds of another
    batch)."""
    cfg = pt.gpt_1p3b(dropout=0.0)
    cfg.num_layers = FD_LAYERS
    model = pt.GPTForCausalLM(cfg, dtype=torch.bfloat16, seed=SEED)
    eng = pt.ServingEngine(model, **{**OPS_ENGINE, "num_pages": FD_POOL})
    eng.warm_ragged()
    reqs = [eng.submit(p, max_new_tokens=FD_NEW) for p in out["prompts"]]
    eng.run_until_idle()
    verdicts = [near_tie_check(model, p, got, req.result(1))
                for p, got, req in zip(out["prompts"], out["results"],
                                       reqs)]
    eng.close()
    log(f"  32b tokens against an in-process engine of the same "
        f"configuration and seed: {verdicts.count('equal')} of "
        f"{len(verdicts)} equal, the rest "
        f"{[v for v in verdicts if v != 'equal']}")
    return verdicts


def fleet_phases(pt, K):
    """Phase 32: 32a, then 32b. -> ({kernel: its fleet launches}, the
    numbers)."""
    t0 = time.perf_counter()
    free()
    in_proc, numbers = fleet_inprocess(pt, K)
    numbers = {"32a": numbers}
    free()
    procs, numbers["32b"] = fleet_frontdoor(pt)
    numbers["32b"]["verdicts"] = fleet_reference(pt, numbers["32b"])
    del numbers["32b"]["prompts"], numbers["32b"]["results"]
    free()
    numbers["phase_s"] = time.perf_counter() - t0
    log(f"  phase 32 {numbers['phase_s']:.1f} s")
    log("  " + json.dumps(numbers, default=str))
    names = set(in_proc) | set(procs)
    return {k: {"fleet_launches": in_proc.get(k, 0) + procs.get(k, 0),
                "fleet_launches_in_process": in_proc.get(k, 0),
                "fleet_launches_processes": procs.get(k, 0)}
            for k in names}, numbers


# --------------------------------------- phase 33: tensor-parallel serving
TP_MP = 2
TP_REQUESTS = 12
TP_NEW = 32
TP_PROMPT = (32, 200)
TP_WORKER = [os.path.abspath(__file__), "--tp-worker"]
# the engines of phase 33, at mp 1 in this process and mp 2 in the ranks
TP_ENGINE = dict(page_size=16, num_pages=512, max_slots=16,
                 attn_backend="pallas", jit=True)
TP_KINDS = (("ragged", dict(prefill_chunk=256)), ("bucketed",
                                                   dict(ragged=False)))
TP_DEVICE = "cuda"     # where phase 33's own tensors go (a CPU rehearsal)


def tp_prompts(vocab, seed=SEED + 33):
    """Phase 33's requests: TP_REQUESTS prompts of 32-200 tokens, their
    lengths from the seed and their tokens from ``seed`` (another seed
    gives the warm-up load: the same round shapes, no prefix hit)."""
    lens = np.random.RandomState(SEED + 33).randint(
        TP_PROMPT[0], TP_PROMPT[1] + 1, TP_REQUESTS)
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=int(n)).tolist() for n in lens]


def tp_serve(eng, prompts):
    """Submit every prompt (TP_NEW greedy tokens each) at once, then step
    until idle, each step ended by a card sync -> dict: the tokens, the
    wall seconds, each step's seconds and the decode-only steps' (no
    request queued or mid-prefill before the step) seconds."""
    reqs = [eng.submit(p, max_new_tokens=TP_NEW) for p in prompts]
    steps, decode = [], []
    t_all = time.perf_counter()
    while eng.scheduler.has_work():
        steady = eng.scheduler.queue_depth() == 0 and not any(
            r.state == "prefilling" for r in eng.scheduler.active.values())
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
        if steady:
            decode.append(steps[-1])
    wall = time.perf_counter() - t_all
    return {"tokens": [r.result(60) for r in reqs], "wall_s": wall,
            "steps": len(steps), "step_s": steps, "decode_s": decode,
            "tokens_per_s": TP_REQUESTS * TP_NEW / wall,
            "decode_ms_median": 1e3 * float(np.median(decode))
            if decode else None}


def tp_collectives(C, group, rank, world):
    """33a: all_reduce, broadcast, all_gather, reduce_scatter and
    all_to_all over the model-parallel group on CUDA tensors, each against
    a host computation from every rank's inputs (each rank draws them all
    from the seed) -> {op: max abs err}."""
    g = torch.Generator(device=TP_DEVICE)
    xs = [torch.randn(4096, device=TP_DEVICE,
                      generator=g.manual_seed(330 + r))
          for r in range(world)]
    host = [x.cpu() for x in xs]
    total = sum(host[1:], host[0].clone())
    errs = {}

    def check(name, got, want, tol=0.0):
        if got.device.type != TP_DEVICE:
            fail(f"33a {name}: the result left the card ({got.device})")
        err = float((got.float().cpu() - want.float()).abs().max())
        bound = tol * float(want.float().abs().max())
        log(f"  33a {name}: max_abs_err={err:.3e} (bound {bound:.3e}) "
            f"{'ok' if err <= bound else 'MISMATCH'}")
        if err > bound:
            fail(f"33a {name} disagrees with the host computation")
        errs[name] = err

    t = xs[rank].clone()
    C.all_reduce(t, group=group)
    check("all_reduce f32", t, total)
    t = xs[rank].to(torch.bfloat16)
    C.all_reduce(t, group=group)
    want = sum((h.to(torch.bfloat16).float() for h in host[1:]),
               host[0].to(torch.bfloat16).float())
    check("all_reduce bf16", t, want, tol=2.0 ** -8)
    t = xs[rank].clone()
    C.broadcast(t, src=1, group=group)
    check("broadcast", t, host[1])
    parts = []
    C.all_gather(parts, xs[rank], group=group)
    check("all_gather", torch.stack(parts), torch.stack(host))
    c = 4096 // world
    t = torch.empty(c, device=TP_DEVICE)
    C.reduce_scatter(t, xs[rank], group=group)
    check("reduce_scatter", t, total[rank * c:(rank + 1) * c])
    got = []
    C.all_to_all(got, list(xs[rank].view(world, c).unbind(0)), group=group)
    check("all_to_all", torch.stack(got),
          torch.stack([h.view(world, c)[rank] for h in host]))
    return errs


def tp_wrappers(pt, K, mesh, rank, world, heads):
    """33b: the three serving wrappers and sharded_flash_attention with
    JAX's whole-head signature at gpt_1p3b's widths (H 16, D 128, bf16):
    each rank's kernel launch runs on its contiguous head slice; the
    stitched output against the unsharded kernel on all 16 heads, to the
    tolerance of phases 4 and 10; each local call on the rank's slice; a
    strided head slice of the pools refused by the local call and by the
    kernel. -> ({name: max abs err}, {kernel: launches}, refusals)."""
    S = pt.serving
    errs, refused = {}, {}
    K.reset_launch_counts()
    heads.clear()
    for kvh in (16, 4):
        args = mixed_launch(16, kvh, 128, torch.bfloat16, seed=33 + kvh)
        full = K.ragged_paged_attention(*args)
        f = S.sharded_ragged_attention(mesh)
        errs[f"ragged KVH={kvh}"] = check_close(
            f"33b sharded_ragged_attention KVH={kvh} (16 heads stitched)",
            f(*args), full, 4e-3, 4e-3)
        q, k, v = args[:3]
        h, kh = 16 // world, kvh // world
        mine = (q[:, rank * h:(rank + 1) * h],
                k[:, :, rank * kh:(rank + 1) * kh],
                v[:, :, rank * kh:(rank + 1) * kh])
        errs[f"ragged local KVH={kvh}"] = check_close(
            f"33b ragged local call KVH={kvh}",
            f.local(*(x.contiguous() for x in mine), *args[3:]),
            full[:, rank * h:(rank + 1) * h], 4e-3, 4e-3)
        for who, fn in (("local call", f.local), ("kernel",
                                                  K.ragged_paged_attention)):
            try:
                fn(mine[0].contiguous(), mine[1], mine[2], *args[3:])
            except ValueError as e:
                refused[f"ragged {who} KVH={kvh}"] = str(e)
            else:
                fail(f"33b: the {who} read a strided head slice of the "
                     "pools")
        args = paged_decode_inputs(16, kvh, 128, torch.bfloat16,
                                   seed=34 + kvh)
        errs[f"paged KVH={kvh}"] = check_close(
            f"33b sharded_paged_attention KVH={kvh} (16 heads stitched)",
            S.sharded_paged_attention(mesh)(*args),
            K.paged_attention(*args), 2e-2, 2e-2)
    dev = TP_DEVICE
    g = torch.Generator(device=dev).manual_seed(35)
    q = torch.randn(2, 64, 16, 128, device=dev, generator=g).to(
        torch.bfloat16)
    kp, vp = (torch.randn(96, 16, 4, 128, device=dev, generator=g).to(
        torch.bfloat16) for _ in range(2))
    bt = (torch.randperm(95, device=dev, generator=g)[:40] + 1).to(
        torch.int32).view(2, 20)
    start = torch.tensor([0, 200], dtype=torch.int32, device=dev)
    lens = torch.tensor([64, 40], dtype=torch.int32, device=dev)
    want = K.paged_prefill_reference(q, kp, vp, bt, start, lens)
    got = S.sharded_paged_prefill(mesh)(q, kp, vp, bt, start, lens)
    errs["prefill"] = check_close("33b sharded_paged_prefill (no kernel)",
                                  got[1, :40], want[1, :40], 2e-2, 2e-2)
    check_close("33b sharded_paged_prefill row 0", got[0], want[0], 2e-2,
                2e-2)
    q, k, v = (torch.randn(2, 256, 16, 128, device=dev,
                           generator=g).to(torch.bfloat16) for _ in range(3))
    # the unsharded kernel through its wrapper (the instrumented call
    # records the sharded launches only)
    want = K.flash_fwd(q, k, v, 1.0 / math.sqrt(128), True)[0]
    errs["flash"] = check_close(
        "33b sharded_flash_attention (16 heads stitched)",
        pt.ops.kernels.sharded_flash_attention(mesh)(q, k, v), want,
        FLASH_BF16_TOL, FLASH_BF16_TOL, FLASH_BF16_NORM_TOL)
    torch.cuda.synchronize()
    launches = {k: v for k, v in K.launch_counts().items() if v}
    return errs, launches, refused, sorted(heads)


def tp_instrument(pt):
    """Record the heads each attention kernel launch of this rank runs on,
    and time every collective (after a card sync, so the time is the
    collective's own: gloo stages a CUDA tensor through the host, which
    waits for the card anyway) -> (the heads set, the timer)."""
    import importlib
    from paddle_tpu_torch.distributed import collective as C
    heads = set()
    coll = {"s": 0.0, "n": 0}
    ra = importlib.import_module("paddle_tpu_torch.serving.ragged_attention")
    de = importlib.import_module("paddle_tpu_torch.serving.decode")
    fa = importlib.import_module("paddle_tpu_torch.ops.kernels."
                                 "flash_attention")

    def seen(name, fn, dim):
        def run(q, *a, **kw):
            heads.add((name, int(q.shape[dim])))
            return fn(q, *a, **kw)
        return run

    # the serving modules' own names for the wrappers, and the flash
    # autograd function's forward (the wrappers' names in their own
    # modules count their launches)
    ra._kernel = seen("ragged_paged_attention", ra._kernel, 1)
    de.paged_attention = seen("paged_attention", de.paged_attention, 1)
    forward = fa._FlashAttention.forward

    def flash_forward(ctx, q, *a):
        heads.add(("flash_fwd", int(q.shape[2])))
        return forward(ctx, q, *a)

    fa._FlashAttention.forward = staticmethod(flash_forward)

    def timed(fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                coll["s"] += time.perf_counter() - t0
                coll["n"] += 1
        return run

    C._run_all_reduce = timed(C._run_all_reduce)
    C.all_gather = timed(C.all_gather)
    return heads, coll


def tp_worker():
    """``chip_smoke.py --tp-worker``: one rank of phase 33 under the
    launcher (``--nproc_per_node 2``, both ranks on the one card, gloo):
    33a and 33b, then ``gpt_1p3b`` bf16 derived from the seed on the card,
    cut to this rank's shard, served at mp 2 by the ragged and the
    bucketed engine (33c, 33d). Writes ``rank<r>.json`` into
    ``CS_TP_ROOT``."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.ops import kernels as K
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    dist.init_parallel_env()
    rank, world = dist.get_rank(), dist.get_world_size()
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": world,
                               "pp_degree": 1, "sharding_degree": 1,
                               "sep_degree": 1}
    hcg = fleet.init(is_collective=True, strategy=strategy)
    group = hcg.get_model_parallel_group()
    res = {"rank": rank, "world": world}
    res["33a"] = tp_collectives(C, group, rank, world)
    heads, coll = tp_instrument(pt)
    (res["33b"], res["33b_launches"], res["33b_refused"],
     res["33b_heads"]) = tp_wrappers(pt, K, hcg.mesh, rank, world, heads)
    t0 = time.perf_counter()
    cfg = pt.gpt_1p3b(dropout=0.0)
    full = pt.GPTForCausalLM(cfg, dtype=torch.bfloat16, seed=SEED)
    model = pt.params_from_paddle_tpu(
        full.state_dict(), pt.gpt_1p3b(dropout=0.0, tensor_parallel=True),
        device=TP_DEVICE, dtype=torch.bfloat16, mp_rank=rank,
        mp_degree=world)
    del full
    free()
    torch.cuda.synchronize()
    res["shard_s"] = time.perf_counter() - t0
    res["shard_params"] = sum(p.numel() for p in model.parameters())
    prompts = tp_prompts(cfg.vocab_size)
    for tag, kw in TP_KINDS:
        eng = pt.ServingEngine(model, mesh=hcg.mesh, mesh_axis="model",
                               **TP_ENGINE, **kw)
        tp_serve(eng, tp_prompts(cfg.vocab_size, SEED + 34))   # warm-up
        before = eng.stats()
        heads.clear()
        coll.update(s=0.0, n=0)
        K.reset_launch_counts()
        run = tp_serve(eng, prompts)
        run["launches"] = {k: v for k, v in K.launch_counts().items() if v}
        st = eng.stats()
        run["stats"] = {k: st[k] for k in (
            "mp_degree", "graphs", "jit", "num_kv_heads",
            "distinct_programs")}
        # the timed load's own rounds and launches
        for k in ("eager_rounds", "steps"):
            run["stats"][k] = st[k] - before[k]
        run["stats"]["bucketed_launches"] = {
            k: v - before["bucketed_launches"][k]
            for k, v in st["bucketed_launches"].items()}
        run["heads"] = sorted(heads)
        run["collective_s"], run["collectives"] = coll["s"], coll["n"]
        run["collective_share"] = coll["s"] / sum(run["step_s"])
        eng.close()
        res[tag] = run
        log(f"  rank {rank} {tag}: {run['steps']} steps, "
            f"{run['tokens_per_s']:.1f} tokens/s, launches "
            f"{run['launches']}, heads {run['heads']}")
    res["worker_s"] = time.perf_counter() - t_start
    with open(os.path.join(os.environ["CS_TP_ROOT"],
                           f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    print("TP33 DONE", flush=True)
    return 0


def tp_job(root):
    """Phase 33's launcher job (2 ranks) -> (rc, seconds)."""
    t0 = time.perf_counter()
    out = open(os.path.join(root, "launcher.txt"), "w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", str(TP_MP), "--master",
         f"127.0.0.1:{free_port()}", "--log_dir",
         os.path.join(root, "logs")] + TP_WORKER,
        env=dict(os.environ, CS_TP_ROOT=root), cwd=HERE, stdout=out,
        stderr=subprocess.STDOUT)
    try:
        rc = proc.wait(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = None
    out.seek(0)
    text = out.read()
    out.close()
    secs = time.perf_counter() - t0
    log(f"  [33] launcher rc {rc} in {secs:.1f} s")
    if rc != 0:
        logs = os.path.join(root, "logs")
        for name in sorted(os.listdir(logs)) if os.path.isdir(logs) else []:
            with open(os.path.join(logs, name)) as f:
                log(f"  --- {name}\n{f.read()[-4000:]}")
        fail(f"phase 33: the launcher job ended with rc {rc}\n{text[-3000:]}")
    return secs


def tp_phases(pt, K, smi):
    """Phase 33: the mp 1 engines in this process (the reference), then the
    mp 2 job, and every check of 33a-33d. -> ({kernel: its launches over
    both ranks' engines and 33b's wrappers}, the numbers)."""
    t_phase = time.perf_counter()
    free()
    cfg = pt.gpt_1p3b(dropout=0.0)
    L = cfg.num_layers
    prompts = tp_prompts(cfg.vocab_size)
    model = pt.GPTForCausalLM(cfg, dtype=torch.bfloat16, seed=SEED)
    ref = {}
    for tag, kw in TP_KINDS:
        eng = pt.ServingEngine(model, **TP_ENGINE, **kw)
        # the warm-up load captures the graphs of the round shapes the
        # timed load meets
        tp_serve(eng, tp_prompts(cfg.vocab_size, SEED + 34))
        graphs = eng.stats()["graphs"]
        ref[tag] = tp_serve(eng, prompts)
        ref[tag]["graphs"] = eng.stats()["graphs"]
        ref[tag]["graphs_captured_timed"] = ref[tag]["graphs"] - graphs
        eng.close()
        free()
    root = tempfile.mkdtemp(prefix="cs_tp_")
    job_s = tp_job(root)
    ranks = [json.load(open(os.path.join(root, f"rank{r}.json")))
             for r in range(TP_MP)]
    numbers = {"job_s": job_s, "card": smi}
    acc, errs = {}, {}
    for res in ranks:
        r = res["rank"]
        log(f"  33a rank {r}: {res['33a']}")
        if sorted(map(tuple, res["33b_heads"])) != [
                ("flash_fwd", 8), ("paged_attention", 8),
                ("ragged_paged_attention", 8)]:
            fail(f"33b rank {r}: kernel launches at heads "
                 f"{res['33b_heads']}, not the rank's 8")
        for name, n in res["33b_launches"].items():
            acc[name] = acc.get(name, 0) + n
        for name, e in res["33b"].items():
            errs[name] = max(errs.get(name, 0.0), e)
        log(f"  33b rank {r}: launches {res['33b_launches']}, refusals "
            f"{sorted(res['33b_refused'])}")
    verdicts = {}
    for tag, _ in TP_KINDS:
        rows = []
        for res in ranks:
            run, st = res[tag], res[tag]["stats"]
            n = st["eager_rounds"]
            if st["graphs"] != 0 or st["mp_degree"] != TP_MP or n <= 0:
                fail(f"33 {tag} rank {res['rank']}: {st} (a round at mp "
                     f"{TP_MP} runs eagerly, no graph)")
            got = run["launches"]
            if tag == "ragged":
                want = {"ragged_paged_attention": L * n,
                        "layer_norm": (2 * L + 1) * n}
                kinds = [["ragged_paged_attention", 8]]
            else:
                b = st["bucketed_launches"]
                want = {"flash_fwd": L * b["prefill"],
                        "paged_attention": L * b["decode"],
                        "layer_norm": (2 * L + 1) * sum(b.values())}
                kinds = [["flash_fwd", 8], ["paged_attention", 8]]
            want = {k: v for k, v in want.items() if v}
            if got != want or run["heads"] != kinds:
                fail(f"33 {tag} rank {res['rank']}: launches {got} != "
                     f"{want} counted from {n} eager rounds, heads "
                     f"{run['heads']} (want {kinds})")
            for name, v in got.items():
                acc[name] = acc.get(name, 0) + v
            rows.append(run)
        a, b = (r["tokens"] for r in rows)
        if a != b:
            fail(f"33 {tag}: the two ranks decoded different tokens")
        verdicts[tag] = [near_tie_check(model, p, g, w) for p, g, w in zip(
            prompts, a, ref[tag]["tokens"])]
        mp1, mp2 = ref[tag], rows[0]
        numbers[tag] = {
            "rounds_mp1": mp1["steps"], "rounds_mp2": mp2["steps"],
            "decode_round_ms_mp1": mp1["decode_ms_median"],
            "decode_round_ms_mp2": [r["decode_ms_median"] for r in rows],
            "collective_share_mp2": [r["collective_share"] for r in rows],
            "collectives_mp2": [r["collectives"] for r in rows],
            "tokens_per_s_mp1": mp1["tokens_per_s"],
            "tokens_per_s_mp2": [r["tokens_per_s"] for r in rows],
            "launches_per_rank": [r["launches"] for r in rows],
            "graphs_mp1": mp1["graphs"],
            "graphs_captured_in_timed_mp1": mp1["graphs_captured_timed"],
            "tokens": f"{verdicts[tag].count('equal')} of {TP_REQUESTS} "
                      "equal to mp 1, the rest near-ties"}
        log(f"  [33 {tag}] {smi}: decode round "
            f"{numbers[tag]['decode_round_ms_mp2']} ms at mp 2 (eager) vs "
            f"{mp1['decode_ms_median']:.2f} ms at mp 1 (graphs); "
            f"collectives {numbers[tag]['collective_share_mp2']} of the "
            f"rounds; {numbers[tag]['tokens_per_s_mp2']} tokens/s vs "
            f"{mp1['tokens_per_s']:.1f}; launches per rank "
            f"{numbers[tag]['launches_per_rank']}; tokens "
            f"{verdicts[tag]}")
    numbers["shard_s"] = [r["shard_s"] for r in ranks]
    numbers["worker_s"] = [r["worker_s"] for r in ranks]
    numbers["33a_max_abs_err"] = max(max(r["33a"].values()) for r in ranks)
    numbers["33b_max_abs_err"] = errs
    del model
    free()
    numbers["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 33 {numbers['phase_s']:.1f} s ({smi})")
    log("  " + json.dumps(numbers, default=str))
    names = {"ragged_paged_attention": "ragged", "paged_attention": "paged",
             "flash_fwd": "flash", "layer_norm": None}
    out = {}
    for name in acc:
        key = names.get(name)
        e = max((v for k, v in errs.items() if key and k.startswith(key)),
                default=0.0)
        out[name] = {"tp_launches": acc[name], "tp_max_abs_err": e}
    return out, numbers

def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script drives the port on an NVIDIA GPU", file=sys.stderr)
        return 2
    try:
        import paddle_tpu_torch as pt
        from paddle_tpu_torch.ops import kernels as K
        from paddle_tpu_torch.ops.kernels import _build
        from paddle_tpu_torch.serving import (make_mixed_length_prompts,
                                              make_shared_prefix_prompts,
                                              run_poisson_load)
    except ImportError as e:
        print(f"chip_smoke: the paddle_tpu_torch package is not beside "
              f"this script ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {smi} | torch {torch.__version__} CUDA "
        f"{torch.version.cuda} | {kind} x{torch.cuda.device_count()}")

    clock("phase 1")
    # ------------------------------------------------------ phase 1: build
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"[build] nvcc {_build.NVCC_FLAGS}: {sorted(libs)} in "
        f"{build_s:.2f} s")
    for name in libs:
        with open(os.path.join(_build.BUILD_DIR, f"{name}.log")) as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")

    clock("phase 2")
    # ---------------------------------------------- phase 2: kernel parity
    log("[parity] ragged_paged_attention vs plain (H=16, D=128, page 16)")
    for kvh in (16, 4):
        for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            args = mixed_launch(16, kvh, 128, dt, seed=kvh)
            got = K.ragged_paged_attention(*args)
            torch.cuda.synchronize()
            want = K.ragged_paged_attention_reference(*args)
            check_close(f"ragged KVH={kvh} {str(dt)[6:]}", got, want, tol,
                        tol)
            if not bool((got[71:] == 0).all()):
                fail("pad tokens of the ragged launch are not zero")
    log("[parity] layer_norm vs plain ([T, 2048])")
    t0 = time.perf_counter()
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        g = torch.Generator(device="cuda").manual_seed(1)
        x = (torch.randn(300, 2048, device="cuda", generator=g) * 2 + 1).to(dt)
        w = (1 + 0.1 * torch.randn(2048, device="cuda", generator=g)).to(dt)
        b = (0.1 * torch.randn(2048, device="cuda", generator=g)).to(dt)
        got = K.layer_norm(x, w, b)
        torch.cuda.synchronize()
        check_close(f"layer_norm {str(dt)[6:]}", got,
                    K.layer_norm_reference(x, w, b), tol, tol)
    log(f"  (Triton compile + first launches {time.perf_counter() - t0:.2f}"
        " s)")

    log("[parity] 2-layer f32 model at gpt_1p3b widths: engine vs dense "
        "plain forward")
    small_cfg = pt.gpt_1p3b(dropout=0.0)
    small_cfg.num_layers = 2
    small = pt.GPTForCausalLM(small_cfg, dtype=torch.float32, seed=SEED + 1)
    eng = pt.ServingEngine(small, page_size=16, num_pages=64, max_slots=4,
                           prefill_chunk=16)
    eng.capture_logits = []
    prompt = np.random.RandomState(SEED).randint(1, 50304, size=37).tolist()
    new = eng.generate(prompt, max_new_tokens=8)
    ids = prompt + new
    with torch.no_grad():
        dense = dense_reference_logits(small, ids)
    want = dense[len(prompt) - 1:].argmax(-1).tolist()
    if new != want[:8]:
        fail(f"engine tokens {new} != dense greedy {want[:8]}")
    worst = 0.0
    for i, (slot_map, cap) in enumerate(eng.capture_logits):
        slot = next(iter(slot_map))
        worst = max(worst, check_close(
            f"decode round {i} logits", torch.from_numpy(cap[slot]),
            dense[len(prompt) + i].cpu(), 1e-3, 1e-3))
    log(f"  greedy tokens equal over {len(new)} steps; "
        f"max logit err {worst:.3e}")
    del eng, small
    torch.cuda.empty_cache()

    clock("phase 3")
    # ---------------------------------------------------- phase 3: serve
    cfg = pt.gpt_1p3b(dropout=0.0)
    t0 = time.perf_counter()
    model = pt.GPTForCausalLM(cfg, dtype=torch.bfloat16, seed=SEED)
    torch.cuda.synchronize()
    log(f"[serve] gpt_1p3b bf16 built in {time.perf_counter() - t0:.2f} s "
        f"({sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params)")
    eng = pt.ServingEngine(model, page_size=16, num_pages=2048,
                           max_slots=16, prefill_chunk=256, jit=True)
    log(f"  KV pools {eng.kv.nbytes() / 1e9:.2f} GB "
        f"({eng.kv.num_pages} pages of 16 tokens)")
    rounds = {"mixed": None, "decode": None, "launched": 0}
    run_round = eng._ragged_fn

    def recording_round(tokens, rs, rl, kl, bt, **kw):
        rounds["launched"] += 1
        n_valid, n_rows = int(rl.sum()), int((rl > 0).sum())
        if rounds["mixed"] is None or n_valid > rounds["mixed"][0]:
            rounds["mixed"] = (n_valid, (tokens, rs, rl, kl, bt))
        if bool((rl <= 1).all()) and (rounds["decode"] is None
                                     or n_rows > rounds["decode"][0]):
            rounds["decode"] = (n_rows, (tokens, rs, rl, kl, bt))
        return run_round(tokens, rs, rl, kl, bt, **kw)

    eng._ragged_fn = recording_round
    mixed, news = make_mixed_length_prompts(
        32, (16, 512), cfg.vocab_size, decode_heavy=0.5,
        max_new_tokens=(32, 32), seed=SEED)
    shared = make_shared_prefix_prompts(4, (16, 64), cfg.vocab_size, 128,
                                        seed=SEED + 1)
    prompts = [shared[0]] + mixed + shared[1:]
    news = [32] + news + [32] * 3
    mem0 = reserved_bytes()
    t0 = time.perf_counter()
    pads = eng.warm_ragged()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm = eng.stats()
    log(f"  warm_ragged: {warm['graphs']} graphs (one per token pad "
        f"{pads}) captured in {warm['graph_capture_s']:.3f} s of "
        f"{warm_s:.3f} s; {reserved_bytes() - mem0} bytes of device memory "
        f"reserved by the captures (their shared graph pool and static "
        f"buffers)")
    if warm["graphs"] != len(pads):
        fail(f"serve: {warm['graphs']} graphs for {len(pads)} token pads")
    rounds["launched"] = 0
    K.reset_launch_counts()
    eng.start()
    try:
        res = run_poisson_load(eng, qps=16.0, prompts=prompts,
                               max_new_tokens=news, seed=SEED,
                               timeout=600.0)
    finally:
        eng.stop()
    torch.cuda.synchronize()
    launches = K.launch_counts()
    served_rounds = rounds["launched"]
    st = eng.stats()
    log(f"  warm_ragged pads {pads} in {warm_s:.2f} s")
    log(f"  {json.dumps(res)}")
    log(f"  rounds={st['steps']} distinct_pads={len(st['ragged_token_pads'])}"
        f" {st['ragged_token_pads']} kv_occupancy_peak_pct="
        f"{st['kv_occupancy_peak_pct']} prefix_hits={st['prefix_hits']} "
        f"prefix_hit_tokens={st['prefix_hit_tokens']} "
        f"evictions={st['evictions']}")
    log(f"  launches during the serve phase: {launches} over "
        f"{served_rounds} launched rounds")
    if res["requests_ok"] != len(prompts) or res["requests_failed"]:
        fail(f"serve: {res['requests_failed']} request(s) failed")
    if res["tokens"] != sum(news):
        fail(f"serve: {res['tokens']} tokens generated, {sum(news)} asked")
    if st["prefix_hits"] < 1:
        fail("serve: no prefix-cache hit ran")
    # every served round runs each layer's attention and its two
    # LayerNorms, plus the final LayerNorm, through the kernels
    L = cfg.num_layers
    want = {name: 0 for name in launches}      # no training kernel runs
    want.update({"ragged_paged_attention": served_rounds * L,
                 "layer_norm": served_rounds * (2 * L + 1)})
    if served_rounds <= 0 or launches != want:
        fail(f"serve: kernel launches {launches} != {want} expected from "
             f"{served_rounds} rounds of {L} layers")
    eng.capture_logits = []
    check = eng.generate(prompts[1][:64], max_new_tokens=4)
    cap = eng.capture_logits[-1][1]
    if cap.shape != (16, cfg.vocab_size) or not np.isfinite(cap).all() \
            or not all(0 <= t < cfg.vocab_size for t in check):
        fail("serve: decode logits not finite / of the wrong shape")
    log(f"  decode logits finite, shape {cap.shape}")
    if eng.stats()["graphs"] != len(pads):
        fail("serve: a token pad outside warm_ragged's was captured mid-run")
    for label, key in (("largest mixed round", "mixed"),
                       ("widest decode round", "decode")):
        check_replay_matches_eager("serve", label, run_round,
                                   rounds[key][1])

    clock("phase 4")
    # --------------------------------------------------- phase 4: timing
    H, KVH, D, page = cfg.num_heads, cfg.num_kv_heads, 128, 16
    kernels = []
    for label, key in (("largest mixed round", "mixed"),
                       ("widest decode round", "decode")):
        tokens, rs, rl, kl, bt = rounds[key][1]
        T = tokens.shape[0]
        g = torch.Generator(device="cuda").manual_seed(2)
        q = torch.randn(T, H, D, device="cuda", generator=g).to(
            torch.bfloat16)
        meta = [torch.from_numpy(a.astype(np.int32)).cuda()
                for a in (rs, rl, kl, bt)]
        args = (q, eng.kv.k[0], eng.kv.v[0], *meta)
        # f32 first (q and the served layer-0 pools upcast): a skipped page
        # or a cut context shows far above 1e-4; then bf16 as served, within
        # a few bf16 roundings of the output
        args32 = (q.float(), eng.kv.k[0].float(), eng.kv.v[0].float(),
                  *meta)
        check_close(f"ragged f32 at {label} (T={T})",
                    K.ragged_paged_attention(*args32),
                    K.ragged_paged_attention_reference(*args32), 1e-4, 1e-4)
        del args32
        err = check_close(f"ragged bf16 at {label} (T={T})",
                          K.ragged_paged_attention(*args),
                          K.ragged_paged_attention_reference(*args),
                          4e-3, 4e-3)
        ms, wall, src = time_ms(lambda: K.ragged_paged_attention(*args))
        plain_ms, _, _ = time_ms(
            lambda: K.ragged_paged_attention_reference(*args), iters=5)
        nbytes, flops, t_valid = attention_work(rs, rl, kl, bt, H, KVH, D,
                                                page, 2)
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
        log(f"[timing] ragged_paged_attention {label}: T={T} "
            f"valid={t_valid} rows={int((rl > 0).sum())} kernel {ms:.4f} ms"
            f" ({src}; {wall:.4f} ms per call with launch) plain "
            f"{plain_ms:.4f} ms bound {b_ms:.4f} ms ({b_by}: "
            f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
        if key == "mixed":
            ragged = {
                "name": "ragged_paged_attention", "route": "cuda",
                "source": "paddle_tpu_torch/ops/kernels/csrc/"
                          "ragged_paged_attention.cu",
                "replaces": "paddle_tpu/ops/pallas/ragged_attention.py:108",
                "launches": launches["ragged_paged_attention"],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
            kernels.append(ragged)
            ln_rows = T
        else:
            # the widest decode round beside the mixed one
            ragged.update({"decode_ms": ms, "decode_bound_ms": b_ms,
                           "max_abs_err": max(ragged["max_abs_err"], err)})
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(ln_rows, 2048, device="cuda", generator=g).to(
        torch.bfloat16)
    blk = model.gpt.h[0].ln_1
    w, b = blk.weight.detach(), blk.bias.detach()
    err = check_close(f"layer_norm at [{ln_rows}, 2048] bf16",
                      K.layer_norm(x, w, b),
                      K.layer_norm_reference(x, w, b), 2e-2, 2e-2)
    ms, wall, src = time_ms(lambda: K.layer_norm(x, w, b))
    plain_ms, _, _ = time_ms(lambda: K.layer_norm_reference(x, w, b))
    lib_ms, lib_wall, _ = time_ms(lambda: torch.nn.functional.layer_norm(
        x, (2048,), w, b, 1e-5))
    b_ms, b_by = bound(2 * x.numel() * 2 + 2 * 2048 * 2, 8 * x.numel(),
                       F32_FLOPS_PER_S)
    log(f"[timing] layer_norm [{ln_rows}, 2048] bf16: kernel {ms:.4f} ms "
        f"({src}; {wall:.4f} ms per call with launch) plain {plain_ms:.4f} "
        f"ms F.layer_norm {lib_ms:.4f} ms ({lib_wall:.4f} ms per call) "
        f"bound {b_ms:.4f} ms ({b_by})")
    kernels.append({
        "name": "layer_norm", "route": "triton",
        "source": "paddle_tpu_torch/ops/kernels/layer_norm.py",
        "replaces": "paddle_tpu/ops/pallas/layer_norm.py:39",
        "launches": launches["layer_norm"], "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms})

    clock("phase 5")
    # ------------------------------------- phase 5: where the time goes
    report_round_profiles("profile", eng, cfg.vocab_size,
                          ("ragged_paged_attention", "layer_norm (triton)"))
    eng.close()
    del eng, model, run_round, args, blk, w, b
    gc.collect()
    torch.cuda.empty_cache()

    clock("phase 6")
    # ------------------------------------- phase 6: train-kernel parity
    log("[train parity] flash forward / dQ / dK/dV vs plain at "
        "[2, S, 16, 128] (f32 within 1e-4, bf16 within 2e-2 and a relative "
        "norm error within 1e-2), autograd, fused AdamW multi-tensor")
    train_kernel_parity(K)
    torch.cuda.empty_cache()

    clock("phase 7")
    # ------------------------------- phase 7: 2-layer train-step parity
    log("[train parity] 2-layer f32 model at gpt_1p3b widths, one step "
        "(B=2, S=512) vs autograd through a dense plain forward")
    train_parity(pt, K)
    torch.cuda.empty_cache()

    clock("phase 8")
    # ------------------------------------------------- phase 8: train
    t_model, t_opt, t_step, t_launches = train_slice(pt, K)

    clock("phase 9")
    # ------------------------------- phase 9: train timing and profile
    report_profile("train", t_step)
    log("[train timing] the new kernels at the slice's shapes, held "
        "against their plain versions, then timed")
    kernels += train_timing(K, t_model, t_opt, t_launches)
    del t_model, t_opt, t_step
    torch.cuda.empty_cache()

    clock("phase 10")
    # ---------------------------------------- phase 10: bucketed parity
    bucketed_kernel_parity(K)
    log("[bucketed parity] 2-layer f32 gpt_1p3b(use_rms_norm=True) through "
        "ServingEngine(ragged=False) vs dense plain forward")
    bucketed_model_parity(pt)
    torch.cuda.empty_cache()

    clock("phase 11")
    # ------------------------------------------ phase 11: bucketed serve
    b_eng, b_model, rec, b_launches = bucketed_serve(pt, K)
    report_round_profiles("bucketed profile", b_eng,
                          b_model.config.vocab_size,
                          ("paged_attention", "rms_norm (triton)"),
                          absent=("ragged_paged_attention",), unit="step")

    clock("phase 12")
    # ----------------------------------------- phase 12: bucketed timing
    kernels += bucketed_timing(K, b_eng, b_model, rec, b_launches)
    b_eng.close()
    del b_eng, b_model, rec
    gc.collect()
    torch.cuda.empty_cache()

    clock("phase 13")
    # ------------------------------------------------ phase 13: O2 train
    o_model, o_opt, _, o_launches = o2_train(pt, K)

    clock("phase 14")
    # --------------------------- phase 14: master-mode kernel and resume
    log("[o2 timing] fused_adamw master and bf16-moment modes over the "
        "model's tensors, held against the plain version, then timed")
    adam_o2 = master_mode_timing(K, o_model, o_opt)
    del o_model, o_opt
    gc.collect()
    torch.cuda.empty_cache()
    resume_and_scaler_check(pt, K)
    clock("phase 15")
    # ------------------------------------------------ phase 15: generate
    log("[generate parity] flash_fwd at one query row (the dense-cache "
        "step) vs plain")
    flash_sq1 = flash_decode_parity(K)
    flash_gen, ln_gen = generate_phase(pt, K)
    gc.collect()
    torch.cuda.empty_cache()
    flash = next(e for e in kernels if e["name"] == "flash_fwd")
    flash.update(flash_sq1)
    flash.update(flash_gen)
    flash["max_abs_err"] = max(flash["max_abs_err"],
                               flash_sq1["sq1_max_abs_err"])
    next(e for e in kernels if e["name"] == "layer_norm").update(ln_gen)

    clock("phase 16")
    # ---------------------------------------------- phase 16: operations
    ops = operations_phase(pt, K)
    for name, n in ops["launches"].items():
        next(e for e in kernels if e["name"] == name)["ops_launches"] = n
    gate = ops["gate"]
    ragged_entry = next(e for e in kernels
                        if e["name"] == "ragged_paged_attention")
    ragged_entry.update({"ops_gate_plain_ms": gate["xla_ms"],
                         "ops_gate_kernel_ms": gate["pallas_ms"]})

    adam = next(e for e in kernels if e["name"] == "fused_adamw")
    adam.update(adam_o2)
    adam["o2_launches"] = o_launches["fused_adamw"]

    clock("phases 17-21")
    # ------------------------------- phases 17-21: the other models
    extra, resnet_losses = models_phases(pt, K)
    for name, numbers in extra.items():
        next(e for e in kernels if e["name"] == name).update(numbers)

    clock("phase 22")
    # ---------------------------------------------- phase 22: to_static
    for name, numbers in static_phases(pt, K, resnet_losses).items():
        next(e for e in kernels if e["name"] == name).update(numbers)
    for e in kernels:
        e.setdefault("to_static_launches", 0)

    clock("phase 23")
    # ------------------------------- phase 23: the zoo, the optimizers
    for name, numbers in zoo_optimizer_phases(pt).items():
        next(e for e in kernels if e["name"] == name).update(numbers)

    clock("phase 24")
    # ------------------------------------- phase 24: the high-level API
    hapi, hapi_numbers = hapi_phases(pt, K)
    for name, numbers in hapi.items():
        next(e for e in kernels if e["name"] == name).update(numbers)
    clock("phase 25")
    # ------------------------------------------- phase 25: the op surface
    surface, _ = surface_phases(pt, K)
    for name, numbers in surface.items():
        next(e for e in kernels if e["name"] == name).update(numbers)
    for e in kernels:
        e.setdefault("surface_launches", 0)
    clock("phase 26")
    # ------------------------------------- phase 26: nn.Layer, ParamAttr
    layer, _ = layer_phases(pt, K)
    for name, numbers in layer.items():
        next(e for e in kernels if e["name"] == name).update(numbers)
    for e in kernels:
        e.setdefault("layer_launches", 0)
    clock("phase 27")
    # ---------------------------------------- phase 27: the rest of nn
    nn_extra, _ = nn_phases(pt, K)
    for name, numbers in nn_extra.items():
        next(e for e in kernels if e["name"] == name).update(numbers)
    for e in kernels:
        e.setdefault("nn_launches", 0)
    clock("phase 28")
    # ------------- phase 28: the core runtime modules, the incubate surface
    inc_extra, _ = incubate_phases(pt, K)
    for name, numbers in inc_extra.items():
        next(e for e in kernels if e["name"] == name).update(numbers)
    for e in kernels:
        e.setdefault("incubate_launches", 0)
    clock("phase 29")
    # -------- phase 29: exported programs, the predictor, static mode and
    # tensor control flow
    exp_extra, _ = export_phases(pt, K)
    for name, numbers in exp_extra.items():
        next(e for e in kernels if e["name"] == name).update(numbers)
    for e in kernels:
        e.setdefault("export_launches", 0)
    clock("phase 30")
    # ------------------------------------- phase 30: resilient training
    res_extra, _ = resilience_phases(
        pt, K, hapi_numbers["bert"]["step_ms_median"])
    for name, numbers in res_extra.items():
        next(e for e in kernels if e["name"] == name).update(numbers)
    for e in kernels:
        e.setdefault("resilience_launches", 0)
    clock("phase 31")
    # ------------ phase 31: elastic training, resumable linear algebra
    el_extra, _ = elastic_phases(pt, K)
    for name, numbers in el_extra.items():
        next(e for e in kernels if e["name"] == name).update(numbers)
    for e in kernels:
        e.setdefault("elastic_launches", 0)
    clock("phase 32")
    # ------------------------------------------------ phase 32: the fleet
    fl_extra, _ = fleet_phases(pt, K)
    for name, numbers in fl_extra.items():
        next(e for e in kernels if e["name"] == name).update(numbers)
    for e in kernels:
        for key in ("fleet_launches", "fleet_launches_in_process",
                    "fleet_launches_processes"):
            e.setdefault(key, 0)
    clock("phase 33")
    # ------------------------------------- phase 33: tensor-parallel serving
    tp_extra, _ = tp_phases(pt, K, smi)
    for name, numbers in tp_extra.items():
        next(e for e in kernels if e["name"] == name).update(numbers)
    for e in kernels:
        e.setdefault("tp_launches", 0)
    for e in kernels:
        e["max_abs_err"] = max([e["max_abs_err"]] + [
            v for k, v in e.items() if k.endswith("_max_abs_err")])

    clock("the result")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--sigterm-child"]:
        sys.exit(sigterm_child())
    if sys.argv[1:] == ["--resilience-worker"]:
        sys.exit(resilience_worker())
    if sys.argv[1:] == ["--dlinalg-worker"]:
        sys.exit(dlinalg_worker())
    if sys.argv[1:] == ["--elastic-worker"]:
        sys.exit(elastic_worker())
    if sys.argv[1:2] == ["--fleet-engine-worker"]:
        sys.exit(fleet_engine_worker(sys.argv[2:]))
    if sys.argv[1:] == ["--tp-worker"]:
        sys.exit(tp_worker())
    sys.exit(main())
