#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --only train_kernels,train_timing
    python3 chip_smoke.py --only tf_kernels,tf_train,tf_service,tf_loop
    python3 chip_smoke.py --only disc_engines,disc_profile,bptt_reverse
    python3 chip_smoke.py --only decode_modes,decode_impls
    python3 chip_smoke.py --only persistent,kernel,carry_kernel,qserve_kernel,decode_modes,bptt_reverse
    python3 chip_smoke.py --only train_kernels,wrappers
    python3 chip_smoke.py --only eval_decode
    python3 chip_smoke.py --only resume,scst
    python3 chip_smoke.py --only bf16
    python3 chip_smoke.py --only tf_bf16
    python3 chip_smoke.py --only config5
    python3 chip_smoke.py --only serving_rest
    python3 chip_smoke.py --only bf16_rest,extras

Drives ``gan_image_captioning_tpu_torch`` at the full width of preset
config3 with the bench's vocabulary (2-layer LSTM, E = H = 512,
V = 11008, T = 36; CNN discriminator with embed 64, num_rep 64, filters
3/4/5 x 300; float32), of config2 and config3 conditional, of config4
(the transformer GAN) and of config5 (ViT-B encoder, GPT-2-small
generator, bfloat16), and prints one JSON line per phase:

1. ``device``  — the card (``nvidia-smi`` name and power limit).
2. ``build``   — every kernel built from ``kernels/csrc`` with nvcc
   (sm_90a), with ptxas's register and shared-memory report.
2a. ``persistent`` — the persistent decode (dense and quantized), reverse
   BPTT and BPTT chain kernels at config3 width: their launch plans on
   this card (grid, threads, dynamic shared memory, the resident branch,
   barriers per step), registers and spills; config3 and config2
   (B = 64, 8, 1) must keep the LSTM weights resident, the chain and the
   int8 / int4 decode (B = 8, 64) theirs; one call of every decode mode,
   of the quantized decode (int8 and int4, full T at B = 8 and 64 and a
   carried chunk at B = 8), of the reverse and of the chain under
   torch.profiler must be one launch of the persistent kernel (and one
   ``embed_kernel`` for sample_embed); block 0's clock64 cycles per phase
   (layers, barrier waits, projection, row combine; gate gradients and
   products in the reverse and the chain).
3. ``train_kernels`` — the four training kernels against their plain
   PyTorch versions at B = 64 on the same inputs: the ``sample_resid``
   decode with fed uniforms (ids equal, or each kernel id within 1e-4 of
   the max score when the plain version is teacher-forced on the kernel's
   ids; soft within 1e-5, h/c/gates within 1e-4), its Philox draw (seeded,
   mean and share below 0.1 of the 25 M uniforms within 1e-3), the BPTT
   chain (d_pre within 1e-4 of its max), the conv forward (pooled within
   1e-5, argmax rows equal outside ties within 1e-6, one launch a pass by
   its plan and its wrapper's count; the profiler's kernel events are
   reported) and backward-dX, from the masked gradient and from the raw
   one with the mask and db in the launch (the autograd route): dW within
   1e-4 of its max, dX and db within 1e-5, two calls bit-equal, one launch
   for the banks and one reduction a pass by its plan and one count.
4. ``train_timing`` — each training kernel's ``device_ms`` beside its
   plain version's (CUDA events for the decode and chain loops) and its
   bound; the conv backward from the masked and from the raw gradient,
   and the ``mxu`` autograd route's two choices (the mask and db in
   torch around the backward, or in its launch).
5. ``train``   — 3 MLE steps, then 4 adversarial steps (disc_train_freq
   2, temperature 10) through ``train/steps.py`` with every launch
   counter reset before and read after (each must equal the launches per
   step by design); then one adversarial step through the kernels against
   the same step through the plain versions on the same state and fed
   noise (losses within 1e-4, every gradient within 1e-3 of its tensor's
   max), the plain conv pooling at the kernel route's argmax rows and
   both ReLUs of the discriminator (at the pool and in the highway)
   taking the kernel route's decisions, each such tie within 1e-6.
6. ``train_timing`` (steps) and ``train_profile`` — ms per MLE and
   adversarial step on both routes, and device time and launches per
   kernel (every kernel, and their totals) and the device's busy share
   over 4 adversarial steps, two discriminator updates (torch.profiler),
   with the card's clocks, power draw and temperature read just after.
7. ``kernel``  — the serve decode kernel against its plain version at
   B = 1, 8, 64: ids equal (where a row differs, each kernel id within
   1e-4 of the plain max logit when the plain version is teacher-forced
   on the kernel's ids), per-token logprobs within 1e-4, sequence sums
   within 1e-3.
8. ``service`` — the serve entry point's request loop (``serve.main``) on
   a seeded checkpoint written in the reference layout: ``{"n": 1}``,
   ``{"n": 8}``, ``{"n": 20}``, ``{"stats": true}``.  Captions must match
   the plain decode and the kernel's launch count the service's
   ``device_calls``.
9. ``timing`` / ``profile`` — the serve decode's times, request latency,
   device time per kernel and busy share at B = 8 and 64.
10. ``carry_kernel`` — the carried-state serve kernel at B = 8 and 64:
    ceil(36 / 8) chained chunks (K = 8, the last one 4 steps) against one
    full-T kernel call (ids equal, logprobs within 1e-6: the same
    operations), and one chunk from a carried state against the plain
    version (ids equal or the teacher-forced rule, logprobs and hT / cT
    within 1e-4).
11. ``qserve_kernel`` — the quantized serve kernel, int8 and int4, B = 8
    and 64, full T and one carried chunk: against its plain version (ids
    equal or the teacher-forced rule, logprobs within 1e-4) and against
    the dense serve kernel on the dequantized weights (ids equal,
    logprobs within 1e-4).
12. ``continuous_service`` — ``serve.main --serve-continuous`` (dense,
    ``--quantize int8`` and ``--quantize int4``): ``{"n": 1}``,
    ``{"n": 8}``, ``{"n": 20}``, a ``{"stream": true}`` request and
    ``{"stats": true}``; captions equal to the full-T kernel decode of the
    same decoder, the stream's last partial equal to its caption, and the
    carried (dense) or quantized kernel's launch count equal to the
    engine's ``device_calls``.  Then ``--serve-exact`` on 20 random rows:
    ids equal to the full-T decode (or the teacher-forced rule).
13. ``continuous_timing`` / ``continuous_profile`` — ``device_ms`` of
    one chunk (B = 8, K = 8) and of the full-T quantized decode at B = 8
    and 64 beside the plain versions, the dense kernel and the bounds;
    request p50 / p90 of the continuous service; device time by kernel
    and busy share of the quantized decode and of a continuous request.

14. ``image_norm_kernel`` — the ``image_norm`` kernel against its plain
    version at B = 64, 3 x 256 x 256, at B = 3, 3 x 37 x 37 (a plane of
    H*W % 4 = 1: the scalar tail and groups that span two planes) and on
    a view at an odd byte offset (the scalar kernel): max |diff| <= 1e-6,
    one launch per call; its time beside the plain version's, one
    ``torch.addcmul`` (the library call) and the bound.
15. ``cond_service`` — preset config2 (conditional, ResNet-18, E = H = 512,
    2 layers, 256 x 256 images) greedy (``--beam-size 1``), V = 11008:
    ``serve.CaptionService`` with seeded weights, the device part of
    ``{"image": …}`` (``caption_images`` on seeded normalized images,
    N = 1 and 8) on the coalescing and the continuous engine; captions
    equal to the full-T kernel decode of the same features, sequence
    logprobs within 1e-3, the decode kernels' launches equal to the
    engines' ``device_calls``; the encoder's features on the card against
    the same module on the CPU (max |diff| / max |feature| <= 1e-4, TF32
    off); request p50 / p90.
16. ``cond_train`` — config3 + ``--conditional-gan 1`` at B = 64 on uint8
    images (``images_u8``, normalized by ``image_norm`` in the step): two
    MLE steps (free), two (teacher) and two adversarial steps with the
    launch counts (``image_norm`` once per step, the reverse BPTT once per
    layer in each MLE step's backward); then each step's losses,
    gradients and updated running statistics through the kernels against
    the plain route on the same state (losses within 1e-4, gradients
    within 1e-3 of the largest gradient of their side, statistics within
    1e-4; the per-tensor errors are reported too: at initialization the
    discriminator's gradient is a difference of nearly equal real and
    fake terms, and the head projection's bias has a zero gradient under
    train-mode BatchNorm, so a tensor's own max can be rounding), a
    ``--trainable-backbone 1`` adversarial step likewise; ms per step on
    both routes; the encoder pass's time and share of the step (also with
    cuDNN's TF32 convolutions, PyTorch's default), device time by kernel
    and busy share (torch.profiler).
17. ``loop`` — ``gan_image_captioning_tpu_torch.main`` in this process:
    synthetic conditional data (256 items), preset config3 at the bench
    geometry, one pretrain and one adversarial epoch on the card; every
    kernel of the path launched, every logged loss finite, and both
    checkpoints served through ``caption_images``.

18. ``tf_kernels`` — preset config4's kernels against their plain
    versions: flash forward and backward at the generator's MLE shape
    [64, 37, 8, 32] (causal, lengths + 1) and log-prob pass (causal), the
    discriminator's [64, 36, 8, 16] and the rollouts' [256, 36, 8, 16]
    (full), GPT-2's head dim at [8, 37, 12, 64] (causal, lengths + 1):
    outputs within 2e-6, gradients within 1e-5 of their largest;
    the backward one launch (delta, dQ, dK and dV), by its plan: the fused
    kernel at those five, the tiled one at [2, 200, 2, 24], [2, 37, 2, 72]
    and the long captions of ``--max-seq-len 126`` (config4's generator
    [64, 129, 8, 32], causal, lengths + 1; its discriminator [64, 128, 8,
    16] and rollouts [256, 128, 8, 16], full; config5's generator [64,
    129, 12, 64], causal, lengths + 1), two calls bit-equal, and zero,
    finite gradients for a row of key length 0;
    the Gumbel sampler at [64, 11008] on fed uniforms (its plan: cluster
    size and CTAs; soft within 1e-6, ids equal outside near-ties, two calls
    bit-equal), its Philox draw (reproducible, the sample_resid decode's
    stream, the same bits as the kernel fed the uniforms it drew, the ids'
    sha256 to compare checkouts, a histogram of 2^18 ids within 0.01 of
    softmax(logits)), its times at [64, 11008] and at [64, 11007] (scalar
    accesses, soft within 1e-6); the forward's kernel per case as the
    wrapper reports its launch and the profiler names it (the fused
    kernels at the four config4 cases and at D = 64, the tiled one at [2,
    200, 2, 24], D = 72 and the long captions), two forward calls
    bit-equal, and a batch row of key length 0 (out 0, lse below -1e29);
    times beside the plain versions', the per-case bounds (the tiled
    backward's products at the TF32 rate) and
    ``scaled_dot_product_attention`` (forward, backward alone, and
    forward + backward).
18a. ``gumbel_ids`` — sha256 of the sampler's ids and drawn uniforms at
    fixed logits and (seed, step), [64, 11008], [64, 11007] and [3, 50257],
    by the public signature only (to compare checkouts).
19. ``tf_train`` — config4 at full width (V = 11008, T = 36, B = 64,
    rollouts 4 every 4, greedy baseline): 2 MLE and 2 REINFORCE steps
    with the launch counts (each equal to the design's per step); one MLE
    and one REINFORCE step through the kernels against the plain route on
    the same state and fed noise (losses within 1e-4, gradients by
    ``routes_agree``); ms per step on both routes; device time by kernel
    and busy share.
20. ``tf_service`` — config4's generator behind the coalescing engine,
    ``{"n": 1}`` and ``{"n": 8}``: captions whose ids are the argmax of the
    flash causal pass over them, sequence logprobs within 1e-3; p50 / p90.
21. ``tf_loop`` — ``main.py --preset config4`` on 256 synthetic items:
    one pretrain and one REINFORCE epoch, every kernel launched, losses
    finite, both checkpoints served.

22. ``disc_engines`` — the ``--disc-engine`` kernels at config3 width
    (``conv_inputs``): the per-batch-row forward (the ``mxu`` forward's
    kernel) against its plain version (pooled within 1e-5, argmax rows
    equal outside ties within 1e-6), bit-equal to the ``mxu`` forward, one
    launch a pass by its plan, counted once on its own counter and not on
    the ``mxu`` one; the per-batch-row backward (``d_emb`` and ``db``
    within 1e-5 times the larger of 1 and their largest entry, as the
    ``mxu`` backward's dX is held; ``dW`` within 1e-4 of its max; two
    calls bit-equal; one launch and one reduction a pass) and the
    DXS backward (DXS, and the overlap-added ``d_emb`` against the ``mxu``
    backward's, within 1e-5 likewise; ``dW`` within 1e-4 of its max;
    ``db`` within 1e-5 likewise) from the raw gradient (the autograd
    route: mask and db in the launch) against their plain versions, two
    calls and the masked route bit-equal, one launch for the banks and one
    reduction a pass by its plan and one count;
    one adversarial step under each of ``auto``, ``xla``, ``pallas``,
    ``hybrid``, ``mxu`` and ``mxu_dxs`` with the launch counts of its
    engine, and its losses (within 1e-4) and gradients (``routes_agree``)
    against the plain route on the same state and fed noise (argmax rows
    and ReLU decisions replayed, ties within 1e-6); ms per step;
    ``device_ms`` of the new kernels (the DXS backward from the raw
    gradient) and, re-timed the same way, of the ``mxu``
    conv kernels and the BPTT chain, beside the plain versions and the
    bounds.
22a. ``disc_profile`` — device time and launches by kernel
    (torch.profiler) of the adversarial step under ``mxu`` and
    ``mxu_dxs``, over one discriminator update cycle (2 steps).
23. ``bptt_reverse`` — the single-layer reverse BPTT kernel at
    [36, 64, 512] from a non-zero (h0, c0) against its plain version
    (``d_pre`` within 1e-4 of its max, ``dh0`` and ``dc0`` within 1e-4);
    the unconditional config3 ``--mle-objective teacher`` step through it
    (``NL`` launches) against the plain route (loss within 1e-4, gradients
    by ``routes_agree``); ms per step on both routes; its ``device_ms``.

24. ``decode_modes`` — the decode modes of the last slice at config3 width,
    B = 64: ``sample`` (ids bit-equal to ``sample_resid``'s on fed
    uniforms and on a seed; noise within 1e-5 of the plain version's),
    ``pretrain`` (ids bit-equal to ``greedy``'s; logits within 1e-4 of the
    plain decode fed the kernel's ids, each id within 1e-4 of that
    decode's max), ``sample_embed`` (ids, soft, hs, cs and gates bit-equal
    to ``sample_resid``'s; emb within 1e-5 of its largest entry against
    the float64 product of the same soft and Wd^T) and the fused-embed
    backward (dWp and dbp within 1e-4 of their largest entry, d_htop
    within 1e-5, two calls bit-equal); ``device_ms`` of those and,
    re-timed the same way, of serve at B = 8 and 64, ``sample_resid``
    and the carried chunk, beside the plain versions and the bounds (the
    embed backward's at the 3xTF32 rate its products run at, and its
    three cuBLAS products alone as its library time).
25. ``decode_impls`` — one adversarial and one MLE (free) pass under each
    decode route (``kernel``, ``kernel_rescore``, ``kernel_embed``,
    ``decoupled``) from the same state and fed noise (uniforms, keep
    masks, flips), the conv banks pooled at the default route's argmax
    rows: losses within 1e-4 of the default route's and the plain
    route's, gradients by ``routes_agree``; then the adversarial, MLE and
    both eval steps through the entry points, each with the launch counts
    of the design; ms per step.
26. ``wrappers`` — at config3 width, what one call of the conv-bank
    forward, of both conv backwards, of the DXS backward from the raw
    gradient and of the fused-embed backward costs
    the host (argument checks, launch plans, allocations, launches:
    ``host_us``, timed while the device waits behind a spin) and its
    device time split by kernel (torch.profiler), and the sha256 of its
    outputs.  It calls the wrappers by their public signatures only.
27. ``eval_decode`` — beam search and sampling at config3 width, B = 64:
    beam 1 against the serve kernel's greedy ids (a row that differs must
    part at a tie within 1e-4, the decode's rule); beam 4 against greedy:
    a row whose beam-4 score is below its greedy sequence log-probability
    - 1e-4 (beam search can prune the greedy prefix; the JAX package's
    beam search ends below greedy on the same rows of these weights) must
    be below by the same margin, within 1e-4, as the plain beam search on
    the CPU; diverse
    search at one group and no penalty equal to beam 4; beam 4, diverse
    (K = 4, G = 2) and ``sample_decode`` on fed Gumbel noise (plain,
    filtered, penalized) on the card against the same calls on the CPU at
    B = 4 / 8 (ids equal or equally scored, scores within 1e-4); top-k 1
    sampling equal to greedy; no repeated trigram under
    ``no_repeat_ngram=3``; ``beam_topk``'s ties to the lower index on the
    card; host-clock ms and kernel launches per call of beam 4, the
    diverse search, sampling and the greedy kernel; the config2 service
    at its own beam 4 on 20 ``{"image"}`` requests (captions equal to
    ``beam_search`` on the same features) and the config3 top-p sample
    service on ``{"n": 8}``, p50 / p90; ``evaluate.py`` (beam 4 with every
    metric and the discriminator score, greedy, int8 greedy) with the
    launches of the pretrain decode (NLL_gen), the serve, quantized serve
    and conv forward kernels; and ``main.py --eval-bleu-every 1
    --beam-size 4`` logging ``[EVAL]`` with a finite BLEU-4.
28. ``resume`` — config3 at full width, unconditional, 256 synthetic
    items, ``--pretrain-epochs 1 --scst-epochs 1 --adv-epochs 1
    --checkpoint-every 1 --keep-checkpoints 2 --resume auto``, each run a
    new process of ``main.py`` under ``torch.use_deterministic_algorithms
    (True, warn_only=True)`` with ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` in
    its environment: run A uninterrupted; run B sent SIGTERM 0.2 s after
    its first snapshot is written, then the identical command line,
    which resumes from the interrupt save.  The final snapshots
    (``state_0.ckpt``: modules, Adam states, counters, generator state)
    must be equal tensor by tensor; if not, a second uninterrupted run
    gives the spread that bounds the difference.  Prints the interrupt's
    phase, epoch and batch, and every op that warned it has no
    deterministic implementation.
29. ``scst`` — ``main.py`` at config3 width (B = 64, 256 items) with
    ``--pretrain-epochs 1 --scst-epochs 1 --adv-epochs 0``, the counters set
    to 0 just before the SCST phase and read just after: the serve kernel
    once a step and once a val batch, the reverse BPTT ``NL`` times a step,
    nothing else; then config4 (one SCST epoch): the flash forward and
    backward 4 times a step each.  Rewards and losses finite;
    ``scst_model.ckpt`` served by ``serve.py`` (the greedy kernel) and
    ``caption.py``; one SCST update's loss and gradients through the
    kernels against the plain route (loss within 1e-4, gradients by
    ``routes_agree``, as ``bptt_reverse`` holds the teacher step); the
    SCST step's host time split into rollout, reward and update, and its
    launches (torch.profiler); an asynchronous full-state save followed
    by an in-place adversarial step loads the values before the step.

30. ``step_options`` — the step options and batching at config3 width
    (B = 64, T = 36, the default route): one MLE and one adversarial step
    at ``--grad-accum 2`` with the launches of the design (the decode and
    the chain 2 a step, the conv forward and backward 6 each, the greedy
    decode 2 and the reverse BPTT 2 ``NL`` in the MLE step); the
    accumulated adversarial, teacher-forced MLE and free MLE passes at 2
    x 32 and 4 x 16 through the kernels against the plain route on fed
    noise (losses within 1e-4, adversarial gradients within 1e-3 of each
    tensor's max with the argmax rows and ReLU decisions replayed, MLE
    gradients by ``routes_agree``; the free pass's greedy ids, from the
    ``decode_serve`` kernel at each microbatch's rows and width, replayed
    into the plain route, each id that differs a tie within 1e-4); ``--length-buckets 16,24``: one MLE
    and one adversarial step at T = 16, 24 and 36 with the launch counts
    and the same comparisons; scheduled sampling at p = 1 against the
    mode-``pretrain`` kernel's logits (within 1e-4 up to a row's first
    differing id, which must be a tie within 1e-4) and two MLE steps at
    p = 0.5 that train; the cosine schedule with warmup against its
    formula, the first update at lr 0 leaving the parameters; a batch of
    NaN weights under ``--skip-nonfinite-grads 1`` with the EMA on leaving
    parameters, moments, counts and EMA bit-equal while the step counters
    advance, and ``--debug-nans`` raising on it; ``--steps-per-call 4``
    bit-equal to four single adversarial steps in a new process under
    deterministic algorithms (as ``resume``); ``main.py`` with the options
    on (``--steps-per-call 2 --length-buckets 16,24 --grad-accum 2
    --ema-decay --lr-schedule cosine --skip-nonfinite-grads 1
    --profile-dir``): the Chrome trace names the decode, chain and conv
    kernels, and ``adv_model_ema.ckpt`` serves ``{"n": 8}`` through
    ``serve.py``; config4's Gumbel adversarial step at ``--grad-accum 2``
    under ``--use-pallas on`` (the sampler 2 T times) and ``off`` (never);
    conditional config3 at ``--grad-accum 2`` on ``images_u8``
    (``image_norm`` twice, at B = 32, against its plain version; the
    running statistics those of the last microbatch from the old ones,
    within 1e-4); every kernel of the path launched in the counted drive;
    the adversarial step at B = 64 against the ``--grad-accum 2`` step
    and the step under ``--skip-nonfinite-grads 1`` (host clock in turns,
    device time by kernel of the first two).

31. ``bf16`` — ``--dtype bfloat16`` on the config3 main path (B = 64,
    T = 36). Every bfloat16 instantiation against its plain version on
    the card, in bfloat16: ``sample_resid`` (fed uniforms; the plain
    decode fed the kernel's ids: each kernel id a tie within 4 bfloat16
    units of the largest |score| of the plain max score, the bfloat16
    soft sample, hs, cs and gates within 2 units, a unit being 2^-8 of
    the largest entry: both round the same float32 value summed in
    another order, and a rounding of h that tips the other way moves a
    score by up to 2 units), ``pretrain`` (ids the
    same rule, bfloat16 logits within 2 units; ``greedy``'s ids equal
    to ``pretrain``'s), the quantized serve at int8 and int4 (B = 8 and
    64: ids the same rule, log-probabilities within 2 units of the
    largest: a rounding of h that tips the other way moves them about one
    unit), the BPTT chain on the decode's bfloat16 residuals and the
    reverse on bfloat16 inputs (float32 ``d_pre``, ``dh0``, ``dc0`` within
    1e-4 of their largest), the ``mxu`` conv forward (bfloat16 pooled
    within 2 units, argmax rows equal outside ties within 1e-6) and its
    backward from the raw bfloat16 gradient (float32 ``d_emb`` and
    ``db`` within 1e-5 times the larger of 1 and their largest, ``dW``
    within 1e-4 of its largest), ``image_norm`` bit-equal; each kernel's
    ``device_ms`` beside its plain version's and its bound (bytes in their
    dtypes; products of bfloat16 operands at 989 TFLOP/s, of float32 ones
    at 67). Then ``--dtype bfloat16`` training with ``bf16_mu``: 3 MLE, 4
    adversarial and one MLE eval step with the launches of the design,
    every first moment bfloat16 and every master float32; one adversarial
    and one MLE pass through the kernels against the plain route on the
    same state and fed noise (the conv argmax rows, ReLU decisions and
    sampled and greedy ids of the kernel route replayed, each a tie within
    4 units of the largest score, pooled value or ReLU input):
    losses within 4 units, each side's gradients within 8 units of the
    side's largest (the routes part where a float32 sum in another order
    tips a rounding of a residual); the conditional step on 256 x 256
    ``images_u8`` (``image_norm``'s bfloat16 instantiation once a step,
    the running statistics bfloat16); ``main.py --dtype bfloat16`` (its
    config given ``bf16_mu``) for an epoch of each phase, unconditional
    with full-state snapshots, one loaded back with bfloat16 first
    moments, and conditional on the repository's COCO sample through
    ``images_u8`` (batches of 8); ``serve.py --quantize int8|int4
    --dtype bfloat16`` on ``{"n": 8}`` (captions those of the plain
    quantized decode in bfloat16, launches equal to ``device_calls``);
    and the float32 and bfloat16 adversarial and MLE steps on the same
    weights in turns, device time by kernel (torch.profiler) and launches
    by the wrappers' counters.

32. ``tf_bf16`` — ``--dtype bfloat16`` for the transformer family at
    config4's full width (B = 64, T = 36). The flash kernels' bfloat16
    instantiations at the generator's MLE shape [64, 37, 8, 32] (causal,
    lengths + 1) and log-prob pass (causal), the discriminator's [64, 36,
    8, 16] and the rollouts' [256, 36, 8, 16] (full; the fused forward
    and backward), GPT-2's head dim at [8, 37, 12, 64] (causal, lengths
    + 1; the column-half fused kernels), [2, 200, 2, 24] and the long
    captions of ``tf_kernels`` (the tiled forward and backward),
    and the sampler's at [64, 11008] and [64, 11007], against their plain
    versions on the same bfloat16 inputs (each output and gradient entry
    within one bfloat16 step, plus the float32 kernels' 1e-5 of the
    largest entry where a sum cancels; ids equal or ties within 1e-4) and
    against the float32 instantiations on the widened inputs (bit-equal
    once rounded); one bfloat16 launch a call; the Philox draw's ids
    distributed as softmax(logits); ``device_ms`` beside the plain
    versions', the bounds (bfloat16 bytes at 3.35 TB/s or float32
    operations at 67 TFLOP/s) and ``scaled_dot_product_attention`` in
    bfloat16 (forward, backward alone). Then one MLE, one REINFORCE and
    one Gumbel adversarial step in bfloat16 (``bf16_mu``) with the
    launches of the design, none float32; each step's losses (4 units)
    and gradients through the kernels against the same step through the
    plain versions on the same state and fed noise (sampled ids equal;
    each gradient tensor within 8 units of its largest entry, of its
    side's for the attention's key bias, whose gradient is zero but for
    rounding, and where it stays below 1e-5 of that, or at least as close
    to the float32 step as the plain route's); config3's REINFORCE step with
    rollouts in bfloat16 (the LSTM kernels' bfloat16 instantiations only);
    ``main.py --preset config4 --dtype bfloat16`` on 128 synthetic items,
    an epoch of each phase, its full-state snapshot loaded back and its
    adversarial checkpoint served; the config4 REINFORCE and MLE steps'
    device time and launches (torch.profiler), float32 and bfloat16 in
    turns on the same weights; and at ``--max-seq-len 126`` (B = 64
    captions of 3-126 tokens; rollouts every 32 positions) one bfloat16
    MLE and one REINFORCE step: the launches of the design at T = 128,
    every backward one launch of the tiled kernel, device ms, launches
    and busy share (torch.profiler).

33. ``config5`` — preset config5 at full width, bfloat16, random weights
    from seed 0: ViT-B/16 at 256 x 256 (frozen), the GPT-2-small generator
    (768 / 3072, 12 layers, 12 heads) cross-attending over the patch
    grid, V = 50261 (GPT-2's ids and the 4 specials), T = 36, B = 64, the
    default CNN discriminator, ``images_u8``.  The fused flash kernels
    (head dim 64: the column-half forward and backward) at [64, 37, 12,
    64], causal with lengths and causal, in bfloat16 and float32, and the
    sampler at [64, 50261] (the scalar cluster path), against their plain
    versions with phase ``tf_bf16``'s and ``tf_kernels``' tolerances,
    timed beside the plain versions, their bounds, SDPA and (flash) the
    tiled kernels at the same shape; ``image_norm`` on the batch into
    bfloat16.  Then 2 MLE and 2 Gumbel adversarial steps with the launches
    of the design (12 fused forwards and 12 fused backwards an MLE step;
    36 sampler
    launches, 3 conv passes a Gumbel step; ``image_norm`` once each),
    every one bfloat16; the frozen ViT bit-unchanged after them; each
    step's losses and gradients through the kernels against the plain
    versions as ``tf_bf16`` holds them; each step's device time by
    kernel, launches, busy share and peak memory (torch.profiler).
    config4 with ``--conditional-gan 1`` (the ResNet grid): an MLE step
    against the plain route and a REINFORCE step.  ``main.py --preset
    config5 --dataset synthetic`` on 128 items, an epoch of each phase;
    its checkpoint, with the decoder drawn afresh from a seed so that the
    greedy ids are not all ``<PAD>``, served (``{"image"}`` rows with
    their grid) and captioned by ``caption.py``: the same ids and
    captions, ids that differ across the images, and rows decoded without
    their grid that decode apart.

34. ``serving_rest`` — the rest of serving at full width, random weights
    from seeds.  config4 (its output projection scaled by 50 so that
    argmaxes are decisive, written as a checkpoint): 16 random feature
    rows through the continuous engine (transformer slots) and the
    coalescing engine of one ``--serve-continuous`` service, and through
    ``--serve-adaptive-chunk 8``: ids equal, or where a row parts before
    its first ``<E>`` the two tokens equally scored within 1e-4 by the
    flash causal pass over the coalescing ids, sequence logprobs of equal
    rows within 1e-3; ``--quantize int8`` (fake quantization) on both
    engines against the greedy decode of the fake-quantized twin by the
    same rule; ``{"n": 1}`` / ``{"n": 8}`` p50 / p90 on both engines in
    turns.  config5 (ViT-B/16, GPT-2-small, V = 50261, projection scaled
    likewise): 8 seeded images' rows (features and grid) through the slots
    and the coalescing engine by the same rule, the slot pool's bytes and
    the peak memory of a request, 1 / 8 image p50 / p90 on both engines.
    config3 ``--decode-mode speculative --draft-len 4`` (the int8 twin
    drafts) on both engines at B = 8 and 64 against the serve kernel's
    greedy ids (the decode's tie rule), the accepted share, tokens a
    block, host ms a call beside the greedy kernel.  An HTTP front end
    over config3's continuous engine, dense and ``--quantize int8``:
    ``POST {"n": 8}``, ``/stats``, ``/metrics``, a stream, ``{"reload"}``
    to a second checkpoint (seed 1) whose captions differ, ``POST`` again:
    captions and logprobs those of the full-T kernel decode of each
    checkpoint, every code 200, the carried (dense) or quantized kernel's
    launches equal to both engines' device calls and no other decode
    kernel launched; ``POST`` latency beside ``handle_request``.  The
    coalescing engine's reload (the full-T serve kernel, launches equal to
    its device calls) and one ``--serve-watch`` reload of a rewritten
    checkpoint; each reload's time.

35. ``bf16_rest`` — the rest of ``--dtype bfloat16`` at config3 width (B =
    64, T = 36, V = 11008).  The four new bfloat16 instantiations against
    their plain versions on the same bfloat16 inputs, with phase
    ``bf16``'s tolerances: decode mode ``sample`` (the noise within a
    bfloat16 step, ids ties within 4 units, ids equal to
    ``sample_resid``'s on the same uniforms), mode ``sample_embed`` (ids,
    residuals and soft sample as ``sample_resid``'s; emb within a step
    plus 1e-5 of its largest entry, the float32 embedding's tolerance,
    where a sum over V cancels), the embed backward on the decode's own
    soft sample and top h (float32 dWp and dbp within 1e-4 of their
    largest, bfloat16 d_htop within 2 units, two calls bit-equal) and the
    DXS backward from the raw bfloat16 gradient (float32 DXS and db within
    1e-5 times the larger of 1 and their largest, dW within 1e-4); each
    one's ``device_ms`` beside its plain version's and its bound (bfloat16
    bytes at 3.35 TB/s, bfloat16 products at 989 TFLOP/s), the embed
    backward's three cuBLAS products in bfloat16 as its library time
    (together and one by one) and its six launches one by one
    (torch.profiler) against its plan's count.
    Then one bfloat16 adversarial step (``bf16_mu``) on each of
    ``kernel_rescore``, ``kernel_embed``, ``decoupled``, ``hybrid`` and
    ``mxu_dxs`` with the launches of the design, every one bfloat16, each
    step's losses (4 units) and gradients (8 units of each tensor's
    largest entry) through the kernels against the same step with its
    kernels swapped for their plain versions on the same state and fed
    noise (the decode's outputs shared after the plain computation holds
    them; the conv argmax rows and ReLU decisions replayed); a step under
    ``bf16_grads`` against the same step without it (the same losses, the
    gradients float32 and within 8 units); and the int8 service at
    ``--dtype float32`` with ``int8_dtype="bfloat16"``: ``{"n": 8}``
    captions of the plain quantized decode in bfloat16, every quantized
    launch bfloat16 and equal to the engine's device calls.

36. ``extras`` — the data and model extras at full width: config3
    conditional on 256 x 256 ``images_u8`` with ``--random-flip 1
    --random-crop-pad 4`` (an MLE and an adversarial step, the fed coins
    and offsets taken bit for bit, ``image_norm`` once a step after the
    augmentation); an adversarial step with ``--disc-arch bilstm`` (embed
    64, hidden 128, 4 layers a direction; the reverse BPTT kernel 24 times:
    3 passes x 2 directions x 4 layers) against the plain route (losses
    within 1e-4, ``routes_agree``); ``main.py --cache-features 1`` on 128
    synthetic conditional items, an epoch of each phase, and the MLE
    step's time on images against cached features with the precompute's
    time per image; ``--encoder-init natural``: eval-mode features of
    distinct images that part (spread above 1e-2 and 1000 times the swept
    encoder's); config4's (float32) and config5's (bfloat16) MLE step under
    ``tf_remat`` against the same step without it (the loss and every
    gradient within 1e-6, a bfloat16 unit for config5, of their largest;
    more launches: the recompute), each one's peak memory and device time.

Then the ``kernels`` line (every ported kernel: the five of the training
and serving paths, the carried serve kernel, the quantized serve kernel at
8 and 4 bits, ``image_norm``, the three flash-attention kernels, the
Gumbel sampler, the per-batch-row conv forward and backward, the DXS
backward, the reverse BPTT, the decode modes ``sample``, ``pretrain`` and
``sample_embed``, the fused-embed backward, and the bfloat16
instantiations of phases ``bf16``, ``tf_bf16`` and ``bf16_rest``, and
config5's shapes,
with their launches in their drives; ``serving_rest_launches``: their
launches in phase ``serving_rest``'s HTTP and reload drives) and,
last, ``{"ok": true,
"device": …}``.  The entries of the kernels on the evaluation path carry
``eval_decode_launches`` too, every entry ``scst_launches``, its
launches in the SCST phases of ``scst``, and ``step_options_launches``,
its launches in ``step_options``' counted drive (the comparisons with the
plain versions left out).
Any failed phase raises, so the script exits non-zero; without CUDA it
exits non-zero before printing a result.  The plain versions' matrix
products and convolutions run in full float32: TF32 is switched off below.
"""

import argparse
import contextlib
import copy
import hashlib
import io
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
V, E, H, NL, MAX_SEQ_LEN = 11008, 512, 512, 2, 34
T = MAX_SEQ_LEN + 2
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
F32_FLOP_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
TF32_FLOP_PER_S = 495e12         # H100 SXM dense TF32 on the tensor cores
LP_ATOL, SEQ_ATOL, ID_ATOL = 1e-4, 1e-3, 1e-4
TPU_KERNEL = "gan_image_captioning_tpu/kernels/decode_sample.py:121"
Q_TPU_KERNEL = "gan_image_captioning_tpu/kernels/decode_sample.py:622"
KERNEL_SOURCES = ["decode_serve", "lstm_bptt", "disc_conv", "image_norm",
                  "flash_attention", "gumbel_sample", "decode_embed_bwd"]
MODEL_FLAGS = ["--dataset", "synthetic", "--vocab-multiple", str(V),
               "--gen-embed-dim", str(E), "--gen-hidden-dim", str(H),
               "--gen-num-layers", str(NL), "--max-seq-len", str(MAX_SEQ_LEN)]


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps, warmup=2):
    """Mean device time of ``fn`` per call (CUDA events over ``reps``)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def decode_work(B):
    """Bytes the decode must move (each input read once, each output
    written once) and its float operations, at batch B."""
    layer_w = sum(4 * H * ((E if l == 0 else H) + H) + 2 * 4 * H
                  for l in range(NL))
    weights = layer_w + V * H + V
    inputs = 4 * (weights + B * E + B * T * E)   # + embedding rows gathered
    outputs = 4 * B * T * 2                      # ids int32, lps float32
    matmul = 2 * B * T * (sum(4 * H * ((E if l == 0 else H) + H)
                              for l in range(NL)) + V * H)
    return inputs + outputs, matmul


def bound_ms(B):
    nbytes, flops = decode_work(B)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def teacher_forced(layers, w_proj, b_proj, embed, x0, ids, state=None):
    """The plain decode with the input at step t+1 = embed[ids[:, t]],
    from ``state = (h, c)`` (zeros when None) and the first input ``x0``
    → (logits [B, T, V], (hT, cT))."""
    from gan_image_captioning_tpu_torch.models import lstm

    fused = lstm.fuse_layer_params(layers)
    if state is None:
        state = lstm.zero_state(len(layers), x0.shape[0],
                                layers[0]["w_hh"].shape[1], x0.dtype,
                                x0.device)
    x, out = x0, []
    for t in range(ids.shape[1]):
        h_top, state = lstm.lstm_step(fused, x, state)
        out.append(h_top @ w_proj.T + b_proj)
        x = embed[ids[:, t].long()]
    return torch.stack(out, dim=1), state


def teacher_forced_logits(dec, feats, ids):
    """Plain logits [B, T, V] with the input at step t+1 = embed[ids[:, t]]."""
    return teacher_forced(dec.lstm.layers(), dec.linear.weight,
                          dec.linear.bias, dec.embed.weight, feats, ids)[0]


def tf_errors(weights, x0, ids, lps, state=None, final=None):
    """The teacher-forced rule of a kernel's ``ids``/``lps`` (and final
    state ``(hT, cT)``): each kernel id's gap below the plain max logit,
    and the logprob (and state) differences against the plain decode fed
    the kernel's ids."""
    logits, (h, c) = teacher_forced(*weights, x0, ids, state)
    chosen = logits.gather(2, ids.long()[..., None])[..., 0]
    out = {"max_id_gap": float((logits.max(dim=2).values - chosen).max()),
           "max_abs_lp_diff": float((lps - (chosen - torch.logsumexp(
               logits, dim=2))).abs().max())}
    if final is not None:
        out["max_abs_h_diff"] = float((final[0] - h).abs().max())
        out["max_abs_c_diff"] = float((final[1] - c).abs().max())
    return out


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def phase_build():
    from gan_image_captioning_tpu_torch.kernels import build

    t0 = time.perf_counter()
    libs = build.build(KERNEL_SOURCES)
    ptxas = [ln.strip() for log in build.BUILD_LOGS.values()
             for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "libraries": [str(p.relative_to(ROOT)) for p in libs.values()],
          "ptxas": ptxas})


def ptxas_report(name):
    """ptxas's register / spill lines for the kernel ``name``."""
    from gan_image_captioning_tpu_torch.kernels import build

    out, take = [], 0
    for log in build.BUILD_LOGS.values():
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                take = 3 if name in ln else 0
            elif take and ("registers" in ln or "spill" in ln):
                out.append(ln.strip())
                take -= 1
    return out


def other_kernels(launches, names):
    """Profiler keys of kernels outside ``names`` (memsets and copies are
    not kernels: the barrier counter is zeroed by a memset)."""
    return [k for k in launches if not any(n in k for n in names)
            and not k.startswith(("Memset", "Memcpy"))]


def phase_persistent(device):
    """The persistent decode and reverse kernels at config3 width (then
    the chain and the quantized decode: ``persistent_chain``,
    ``persistent_qserve``): their launch plans on this card (grid,
    threads, dynamic shared memory, the resident branch, barriers per
    step), registers and spills; config3
    and config2 (the same LSTM widths) at the training and serving batch
    must keep their weights resident; then one call of every decode mode
    and of the reverse under torch.profiler: one launch of the persistent
    kernel per call (sample_embed: and one embed_kernel), no other kernel
    (a memset zeroes the barrier counter)."""
    from gan_image_captioning_tpu_torch.kernels import build, lstm_bptt
    from gan_image_captioning_tpu_torch.kernels import decode_sample as ds
    from gan_image_captioning_tpu_torch.models import lstm

    n_sm, optin = build.device_limits(ds._library(), device)
    dec = full_width_generator(device).decoder
    w = dense_weights(dec)
    f8, f64 = seeded((8, E), 108, device), seeded((B_TRAIN, E), 164, device)
    st = (seeded((NL, 8, H), 109, device, 0.1),
          seeded((NL, 8, H), 110, device, 0.1), f8)
    wd = seeded((DISC_E, V), 91, device, 0.1)
    calls = {
        "serve_b8": lambda: ds.decode_sample(f8, *w, T, mode="serve"),
        "serve_b64": lambda: ds.decode_sample(f64, *w, T, mode="serve"),
        "carry_chunk_b8": lambda: ds.decode_sample(
            f8, *w, K_CHUNK, mode="serve", init_state=st),
        "pretrain": lambda: ds.decode_sample_logits(f64, *w, T),
        "sample": lambda: ds.decode_sample_noise(f64, *w, T, seed=3),
        "sample_resid": lambda: ds.decode_sample_resid(
            f64, *w, T, seed=3, temperature=TEMP),
        "sample_embed": lambda: ds.decode_sample_embed(
            f64, *w, T, wd, seed=3, temperature=TEMP),
    }
    names = DECODE_KERNEL_NAMES + ("reverse_persistent_kernel",)
    rows = {}
    for preset, B in (("config3", B_TRAIN), ("config3", 8), ("config2", 8),
                      ("config2", 1)):
        plan = ds.persistent_plan(B, E, H, V, NL, n_sm, optin)
        check(plan["resident"], f"{preset} B={B}: the decode's weights are "
              f"not resident: {plan['ints']}")
    plan = ds.persistent_plan(B_TRAIN, E, H, V, NL, n_sm, optin)
    launches = {}
    for mode, fn in calls.items():
        prof = profile_calls(fn, 1, names)
        launches[mode] = prof.get("launches_per_call", {})
        want = {"decode_persistent_kernel": 1,
                **({"embed_kernel": 1} if mode == "sample_embed" else {})}
        got = {k: launches[mode].get(k, 0) for k in DECODE_KERNEL_NAMES}
        check(got == {**{k: 0 for k in DECODE_KERNEL_NAMES}, **want}
              and not other_kernels(launches[mode], names),
              f"{mode}: kernel launches per call {launches[mode]}")
    # where block 0's time goes, per phase (clock64 cycles of one call)
    phase_share = {mode: block0_share(ds.set_phase_profile, ds.PROFILE_SLOTS,
                                      calls[mode], device)
                   for mode in ("serve_b8", "serve_b64", "sample_resid")}
    rows["decode"] = {
        "kernel": "decode_persistent_kernel", "n_sm": n_sm,
        "smem_optin": optin, "grid": plan["blocks"],
        "threads": plan["threads"], "units_per_block": plan["units_per_block"],
        "dynamic_smem_bytes": plan["smem_bytes"],
        "resident": plan["resident"], "proj_batch_chunk":
            plan["proj_batch_chunk"],
        "barriers_per_step": plan["barriers_per_step"],
        **ds.kernel_attrs(), "ptxas": ptxas_report("decode_persistent_kernel"),
        "launches_per_call": launches, "phase_share_block0": phase_share,
        "B": B_TRAIN}
    emit({"phase": "persistent", **rows["decode"]})

    lp = lstm.fuse_layer_params(dec.lstm.layers())[0]
    h0, c0 = seeded((B_TRAIN, H), 81, device, 0.5), seeded((B_TRAIN, H), 82,
                                                           device, 0.5)
    _, cs, gates = lstm._layer_seq_scan(
        lp["w"], lp["b"], seeded((T, B_TRAIN, E), 80, device), h0, c0)
    rargs = (lp["w"][E:].contiguous(), seeded((T, B_TRAIN, H), 83, device),
             gates, torch.cat([c0[None], cs[:-1]]), cs)
    rplan = lstm_bptt.reverse_plan(B_TRAIN, H, n_sm, optin)
    check(rplan["resident"], f"reverse: w_hh rows not resident {rplan}")
    prof = profile_calls(lambda: lstm_bptt.lstm_bptt_reverse(*rargs), 1,
                         names)
    rl = prof.get("launches_per_call", {})
    rshare = block0_share(lstm_bptt.set_phase_profile,
                          lstm_bptt.PROFILE_SLOTS,
                          lambda: lstm_bptt.lstm_bptt_reverse(*rargs), device)
    check(rl.get("reverse_persistent_kernel", 0) == 1
          and not other_kernels(rl, ("reverse_persistent_kernel",)),
          f"reverse: kernel launches per call {rl}")
    rows["reverse"] = {
        "kernel": "reverse_persistent_kernel", "grid": rplan["blocks"],
        "threads": rplan["threads"],
        "units_per_block": rplan["units_per_block"],
        "dynamic_smem_bytes": rplan["smem_bytes"],
        "resident": rplan["resident"],
        "barriers_per_step": rplan["barriers_per_step"],
        **lstm_bptt.kernel_attrs(),
        "ptxas": ptxas_report("reverse_persistent_kernel"),
        "launches_per_call": rl, "phase_share_block0": rshare,
        "B": B_TRAIN}
    emit({"phase": "persistent", **rows["reverse"]})
    rows["chain"] = persistent_chain(dec, device, n_sm, optin, f64, w)
    rows["qserve"] = persistent_qserve(dec, device, n_sm, optin, f8, f64)
    return rows


def block0_share(set_profile, slots, fn, device):
    """Block 0's clock64 cycles per phase over one call of ``fn`` (the
    kernel's phase profile switched on by ``set_profile``), and each
    phase's share."""
    prof = torch.zeros(len(slots), dtype=torch.int64, device=device)
    try:
        set_profile(prof)
        fn()
        torch.cuda.synchronize()
    finally:
        set_profile(None)
    cyc = prof.tolist()
    return {"cycles": sum(cyc), **{k: c / max(sum(cyc), 1)
                                   for k, c in zip(slots, cyc)}}


def persistent_chain(dec, device, n_sm, optin, f64, w):
    """The BPTT chain at [36, 2, 64, 512] on the sample_resid decode's
    residuals: its plan (resident, the whole batch in one chunk),
    registers, one launch per call, block 0's phase clocks; and
    ``device_ms`` of the streamed branch at [36, 2, 64, 1024] (seeded
    inputs), where the weight rows do not fit."""
    from gan_image_captioning_tpu_torch.kernels import decode_sample as ds
    from gan_image_captioning_tpu_torch.kernels import lstm_bptt

    plan = lstm_bptt.chain_plan(B_TRAIN, H, NL, n_sm, optin)
    check(plan["resident"] and plan["batch_chunk"] == B_TRAIN,
          f"chain: weight rows not resident or batch chunked {plan}")
    _, _, _, cs, gates = ds.decode_sample_resid(f64, *w, T, seed=3,
                                                temperature=TEMP)
    layers = dec.lstm.layers()
    args = (torch.stack([lp["w_hh"].T for lp in layers]).contiguous(),
            torch.stack([lp["w_ih"].T for lp in layers[1:]]).contiguous(),
            seeded((T, B_TRAIN, H), 65, device), gates, cs)
    name = "chain_persistent_kernel"
    launches = profile_calls(lambda: lstm_bptt.lstm_bptt_chain(*args), 1,
                             (name,)).get("launches_per_call", {})
    check(launches.get(name, 0) == 1 and not other_kernels(launches, (name,)),
          f"chain: kernel launches per call {launches}")
    row = {"kernel": name, "grid": plan["blocks"],
           "threads": plan["threads"],
           "units_per_block": plan["units_per_block"],
           "dynamic_smem_bytes": plan["smem_bytes"],
           "resident": plan["resident"],
           "batch_chunk": plan["batch_chunk"],
           "barriers_per_step": plan["barriers_per_step"],
           **lstm_bptt.kernel_attrs("chain"), "ptxas": ptxas_report(name),
           "launches_per_call": launches,
           "phase_share_block0": block0_share(
               lambda p: lstm_bptt.set_phase_profile(p, "chain"),
               lstm_bptt.PROFILE_SLOTS,
               lambda: lstm_bptt.lstm_bptt_chain(*args), device),
           "shape": [T, NL, B_TRAIN, H]}
    wide = (seeded((NL, 2 * H, 8 * H), 66, device, (2 * H) ** -0.5),
            seeded((NL - 1, 2 * H, 8 * H), 67, device, (2 * H) ** -0.5),
            seeded((T, B_TRAIN, 2 * H), 68, device),
            seeded((T, NL, B_TRAIN, 8 * H), 69, device),
            seeded((T, NL, B_TRAIN, 2 * H), 70, device, 0.5))
    wplan = lstm_bptt.chain_plan(B_TRAIN, 2 * H, NL, n_sm, optin)
    check(not wplan["resident"], f"chain H = {2 * H}: rows resident {wplan}")
    row["streamed"] = {"shape": [T, NL, B_TRAIN, 2 * H],
                       "units_per_block": wplan["units_per_block"],
                       "dynamic_smem_bytes": wplan["smem_bytes"],
                       "device_ms": device_ms(
                           lambda: lstm_bptt.lstm_bptt_chain(*wide), 20)}
    emit({"phase": "persistent", **row})
    return row


def persistent_qserve(dec, device, n_sm, optin, f8, f64):
    """The quantized serve decode, int8 and int4: its plans at B = 8 and
    64 (resident, with the byte ring), registers, one launch of the
    persistent kernel per call (full T at B = 8 and 64, a carried chunk at
    B = 8), block 0's phase clocks."""
    from gan_image_captioning_tpu_torch.kernels import decode_sample as ds
    from gan_image_captioning_tpu_torch.ops.quantize import (
        quantize_lstm_decoder)

    plans = {}
    for B in (8, 64):
        plan = ds.persistent_plan(B, E, H, V, NL, n_sm, optin,
                                  quantized=True)
        check(plan["resident"], f"qserve B={B}: not resident {plan['ints']}")
        plans[B] = plan
    zeros = torch.zeros(NL, 8, H, device=device)
    out = {"kernel": "decode_persistent_kernel (quantized)",
           "grid": plans[8]["blocks"], "threads": plans[8]["threads"],
           "units_per_block": plans[8]["units_per_block"],
           "dynamic_smem_bytes": plans[8]["smem_bytes"],
           "resident": plans[8]["resident"],
           "proj_batch_chunk": {B: p["proj_batch_chunk"]
                                for B, p in plans.items()},
           "barriers_per_step": plans[8]["barriers_per_step"],
           **ds.kernel_attrs(quantized=True)}
    for name, bits in QUANT_BITS.items():
        q = quantize_lstm_decoder(dec, bits)
        st = ds.decode_sample_q_serve(f8, q, K_CHUNK, (zeros, zeros, f8),
                                      bits)[2]
        calls = {"full_b8": lambda: ds.decode_sample_q_serve(f8, q, T,
                                                             bits=bits),
                 "full_b64": lambda: ds.decode_sample_q_serve(f64, q, T,
                                                              bits=bits),
                 "carry_chunk_b8": lambda: ds.decode_sample_q_serve(
                     st[2], q, K_CHUNK, st, bits)}
        launches, share = {}, {}
        for mode, fn in calls.items():
            launches[mode] = profile_calls(fn, 1, DECODE_KERNEL_NAMES).get(
                "launches_per_call", {})
            check(launches[mode].get("decode_persistent_kernel", 0) == 1
                  and not other_kernels(launches[mode],
                                        ("decode_persistent_kernel",)),
                  f"{name} {mode}: kernel launches per call "
                  f"{launches[mode]}")
            if mode != "carry_chunk_b8":
                share[mode] = block0_share(ds.set_phase_profile,
                                           ds.PROFILE_SLOTS, fn, device)
        out[name] = {"launches_per_call": launches,
                     "phase_share_block0": share}
    emit({"phase": "persistent", **out})
    return out


def full_width_generator(device):
    from gan_image_captioning_tpu_torch.config import Config
    from gan_image_captioning_tpu_torch.models.generator import (
        init_generator_params)

    config = Config(vocab_size=V, gen_embed_dim=E, gen_hidden_dim=H,
                    gen_num_layers=NL, max_seq_len=MAX_SEQ_LEN)
    # un-swept initial weights: the sweep's U(-0.05, 0.05) makes greedy
    # decode repeat one token, which would check almost nothing
    gen = init_generator_params(torch.Generator().manual_seed(0), config,
                                device, sweep=False)
    return gen.requires_grad_(False)


def decode_args(dec, feats):
    return (feats, dec.lstm.layers(), dec.linear.weight, dec.linear.bias,
            dec.embed.weight, T)


def phase_kernel(dec, device):
    from gan_image_captioning_tpu_torch.eval.decode import masked_logprob_sum
    from gan_image_captioning_tpu_torch.kernels.decode_sample import (
        decode_sample, decode_sample_plain)

    rows = []
    for B in (1, 8, 64):
        feats = torch.from_numpy(np.random.default_rng(B).standard_normal(
            (B, E)).astype(np.float32)).to(device)
        ids_k, lps_k = decode_sample(*decode_args(dec, feats), mode="serve")
        ids_g = decode_sample(*decode_args(dec, feats), mode="greedy")
        torch.cuda.synchronize()
        ids_p, _ = decode_sample_plain(*decode_args(dec, feats))
        ids_equal = bool(torch.equal(ids_k, ids_p))
        # the plain version teacher-forced on the kernel's ids: equal to
        # the free-running one where the ids agree
        logits = teacher_forced_logits(dec, feats, ids_k)
        chosen = logits.gather(2, ids_k.long()[..., None])[..., 0]
        id_gap = float((logits.max(dim=2).values - chosen).max())
        lps_p = chosen - torch.logsumexp(logits, dim=2)
        lp_diff = float((lps_k - lps_p).abs().max())
        seq_diff = float((masked_logprob_sum(ids_k, lps_k)
                          - masked_logprob_sum(ids_k, lps_p)).abs().max())
        row = {"B": B, "ids_equal": ids_equal,
               "rows_differing": int((ids_k != ids_p).any(dim=1).sum()),
               "distinct_ids": int(ids_k.unique().numel()),
               "greedy_mode_equal": bool(torch.equal(ids_g, ids_k)),
               "max_id_gap": id_gap, "max_abs_lp_diff": lp_diff,
               "max_abs_seq_diff": seq_diff,
               "lps_finite": bool(torch.isfinite(lps_k).all())}
        rows.append(row)
        emit({"phase": "kernel", **row})
        check(row["greedy_mode_equal"], f"B={B}: greedy mode ids != serve ids")
        check(row["lps_finite"], f"B={B}: non-finite kernel logprobs")
        check(id_gap <= ID_ATOL, f"B={B}: kernel id {id_gap} below the max")
        check(lp_diff <= LP_ATOL, f"B={B}: per-token lp diff {lp_diff}")
        check(seq_diff <= SEQ_ATOL, f"B={B}: sequence lp diff {seq_diff}")
    return rows


def phase_service(gen, workdir):
    """The serving entry point's stdin request loop, in this process so
    the kernel's launch count can be read."""
    from gan_image_captioning_tpu_torch import serve
    from gan_image_captioning_tpu_torch.data.synthetic import synthetic_vocab
    from gan_image_captioning_tpu_torch.eval.decode import masked_logprob_sum
    from gan_image_captioning_tpu_torch.eval.metrics import (ids_to_words,
                                                             strip_caption)
    from gan_image_captioning_tpu_torch.kernels.decode_sample import (
        decode_sample, decode_sample_plain)
    from gan_image_captioning_tpu_torch.models.generator import (
        start_token_features)

    ckpt = workdir / "gen_full_width.ckpt"
    reqs = [{"n": 1}, {"n": 8}, {"n": 20}, {"stats": True}]
    stdin = io.StringIO("".join(json.dumps(r) + "\n" for r in reqs))
    out = io.StringIO()
    argv = ["--checkpoint", str(ckpt), *MODEL_FLAGS]
    old_stdin = sys.stdin
    decode_sample.launches = 0
    t0 = time.perf_counter()
    try:
        sys.stdin = stdin
        with contextlib.redirect_stdout(out):
            serve.main(argv)
    finally:
        sys.stdin = old_stdin
    seconds = time.perf_counter() - t0
    launches = decode_sample.launches
    lines = [json.loads(ln) for ln in out.getvalue().splitlines()]
    ready, resps, stats = lines[0], lines[1:4], lines[4]["coalescing"]
    check(ready.get("status") == "ready", f"service not ready: {ready}")

    # the reference: plain greedy decode of one <S> row (every row of an
    # unconditional request is the same row)
    feats = start_token_features(gen.decoder, 1)
    ids_p, lps_p = decode_sample_plain(*decode_args(gen.decoder, feats))
    want_cap = " ".join(ids_to_words(strip_caption(ids_p[0].tolist()),
                                     synthetic_vocab()[1]))
    want_lp = float(masked_logprob_sum(ids_p, lps_p)[0])
    for req, resp in zip(reqs, resps):
        check("captions" in resp, f"{req}: {resp}")
        check(len(resp["captions"]) == req["n"]
              and len(resp["logprobs"]) == req["n"], f"{req}: row count")
        check(all(math.isfinite(x) for x in resp["logprobs"]),
              f"{req}: non-finite logprob")
        check(all(c == want_cap for c in resp["captions"]),
              f"{req}: caption differs from the plain decode")
        check(all(abs(x - want_lp) <= SEQ_ATOL for x in resp["logprobs"]),
              f"{req}: logprob differs from the plain decode")
    check(launches > 0, "the service never launched the decode kernel")
    check(launches == stats["device_calls"],
          f"kernel launches {launches} != device_calls "
          f"{stats['device_calls']}")
    row = {"phase": "service", "requests": reqs[:3],
           "latency_ms": [r["latency_ms"] for r in resps],
           "caption": want_cap, "logprob": want_lp, "stats": stats,
           "kernel_launches": launches, "seconds": round(seconds, 3)}
    emit(row)
    return row


def phase_timing(dec, device, workdir):
    from gan_image_captioning_tpu_torch import serve
    from gan_image_captioning_tpu_torch.kernels.decode_sample import (
        decode_sample, decode_sample_plain)

    out = {}
    for B in (8, 64):
        feats = torch.from_numpy(np.random.default_rng(B).standard_normal(
            (B, E)).astype(np.float32)).to(device)
        args = decode_args(dec, feats)
        plain_a = cuda_ms(lambda: decode_sample_plain(*args), reps=5)
        kern_a = cuda_ms(lambda: decode_sample(*args, mode="serve"), reps=30)
        kern_b = cuda_ms(lambda: decode_sample(*args, mode="serve"), reps=30)
        plain_b = cuda_ms(lambda: decode_sample_plain(*args), reps=5)
        torch.cuda.synchronize()
        enqueue = []
        for _ in range(10):     # host time of the call alone: no sync inside
            t0 = time.perf_counter()
            decode_sample(*args, mode="serve")
            enqueue.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        b_ms, b_by, nbytes, flops = bound_ms(B)
        out[B] = {"kernel_ms": [kern_a, kern_b], "plain_ms": [plain_a, plain_b],
                  "host_enqueue_ms": float(np.median(enqueue)),
                  "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                  "flop": flops}
        emit({"phase": "timing", "B": B, **out[B]})

    args = serve.parse_args(["--checkpoint",
                             str(workdir / "gen_full_width.ckpt"),
                             *MODEL_FLAGS])
    service = serve.CaptionService(args)
    try:
        lat = {}
        for n in (1, 8):
            ms = [service.handle_request({"n": n})["latency_ms"]
                  for _ in range(60)]
            lat[n] = {"p50_ms": float(np.percentile(ms, 50)),
                      "p90_ms": float(np.percentile(ms, 90)),
                      "samples": len(ms)}
    finally:
        service.close()
    emit({"phase": "timing", "service_request_latency": lat,
          "note": "sequential requests, host clock, batch 8"})
    out["service"] = lat
    return out


# profiler keys are matched by substring: the decode's one persistent
# kernel (dense and quantized instantiations) and the embedding product
DECODE_KERNEL_NAMES = ("decode_persistent_kernel", "embed_kernel")
SERVE_KERNEL_NAMES = DECODE_KERNEL_NAMES


def profile_calls(fn, calls, names=SERVE_KERNEL_NAMES):
    """Device time by kernel (torch.profiler, CUPTI) over ``calls`` calls
    of ``fn`` after one warm call, and the device's busy share of that
    window's wall time.  Profiled again once where the profiler recorded
    no device event at all (it has dropped a whole window's events in a
    long process)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        us, count = {}, {}
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA:
                continue
            key = next((n for n in names if n in ev.key), ev.key[:40])
            us[key] = us.get(key, 0.0) + ev.self_device_time_total / calls
            count[key] = count.get(key, 0) + ev.count / calls
        if us:
            return {"device_us_per_call": us, "launches_per_call": count,
                    "device_busy_share": sum(us.values()) * calls / wall_us,
                    "wall_ms_per_call": wall_us / calls / 1e3}
    return {"device_time": "not measured"}


def kernel_events(fn, calls):
    """The device's kernel launches (torch.profiler) of ``calls`` calls of
    ``fn`` after one warm call, in launch order: ``[(name, µs), ...]``
    (memsets and copies are not kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not e.name.startswith(("Memset", "Memcpy"))),
                 key=lambda e: e.time_range.start)
    return [(e.name, e.time_range.elapsed_us()) for e in evs]


def forward_kernels(fn):
    """The names of the flash forward kernels that one call of ``fn``
    launches (torch.profiler; profiled again once where it saw none)."""
    names = []
    for _ in range(2):
        names = [n for n, _ in kernel_events(fn, 1) if "flash_fwd" in n]
        if names:
            break
    return names


def kernel_split(fn, calls=5):
    """The kernels that ``calls`` calls of ``fn`` launch, by name
    (torch.profiler; profiled again once where it saw no kernel): events
    seen and mean device µs an event (the profiler may drop events)."""
    us = {}
    evs = kernel_events(fn, calls) or kernel_events(fn, calls)
    for n, t in evs:
        us.setdefault(n[:120], []).append(t)
    return {"calls_profiled": calls, "kernel_events": len(evs),
            "by_kernel": {n: {"events": len(v), "mean_us": sum(v) / len(v)}
                          for n, v in us.items()}}


def phase_profile(dec, device, calls=3):
    """Device time by kernel and busy share of the serve decode."""
    from gan_image_captioning_tpu_torch.kernels.decode_sample import (
        decode_sample)

    rows = {}
    for B in (8, 64):
        feats = torch.from_numpy(np.random.default_rng(B).standard_normal(
            (B, E)).astype(np.float32)).to(device)
        args = decode_args(dec, feats)
        rows[B] = profile_calls(lambda: decode_sample(*args, mode="serve"),
                                calls)
        emit({"phase": "profile", "B": B, **rows[B]})
    return rows


# ------------------------------------------- continuous and quantized serving

K_CHUNK = 8
CHAIN_ATOL = 1e-6
QUANT_BITS = {"int8": 8, "int4": 4}


def dense_weights(dec):
    return (dec.lstm.layers(), dec.linear.weight, dec.linear.bias,
            dec.embed.weight)


def chunk_work(B, steps, weight_bytes):
    """Bytes and operations of ``steps`` serve steps at batch B: the
    weights read once, features or the carried state in and out, one
    embedding row per token, ids and logprobs out."""
    _, flops_t = decode_work(B)
    flops = flops_t * steps // T
    state = 4 * (2 * NL * B * H + B * E)
    nbytes = weight_bytes + 2 * state + 4 * B * steps * E + 8 * B * steps
    return nbytes, flops


def weight_bytes(qdec=None):
    """The decoder's weight bytes: float32 (dense), or each quantized
    payload, scale and bias as stored."""
    if qdec is None:
        layer_w = sum(4 * H * ((E if l == 0 else H) + H) + 2 * 4 * H
                      for l in range(NL))
        return 4 * (layer_w + V * H + V + V * E)
    tensors = [qdec["embed"].q, qdec["embed"].scale, qdec["linear"]["w"].q,
               qdec["linear"]["w"].scale, qdec["linear"]["b"]]
    for lq in qdec["lstm_q"]:
        tensors += [lq["w"].q, lq["w"].scale, lq["b"]]
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_carry_kernel(dec, device):
    """Chained chunks of the carried kernel against one full-T call, and
    one carried chunk against the carried plain version."""
    from gan_image_captioning_tpu_torch.kernels.decode_sample import (
        decode_sample, decode_sample_plain)

    w = dense_weights(dec)
    rows = []
    for B in (8, 64):
        feats = seeded((B, E), 100 + B, device)
        ids, lps = decode_sample(feats, *w, T, mode="serve")
        h = torch.zeros(NL, B, H, device=device)
        c, x, parts, states, t = h.clone(), feats, [], [], 0
        while t < T:
            k = min(K_CHUNK, T - t)
            i, lp, (h, c, x) = decode_sample(x, *w, k, mode="serve",
                                             init_state=(h, c, x))
            parts.append((i, lp))
            states.append((h, c, x))
            t += k
        torch.cuda.synchronize()
        ids_c = torch.cat([p[0] for p in parts], dim=1)
        lps_c = torch.cat([p[1] for p in parts], dim=1)
        row = {"B": B, "chunks": [p[0].shape[1] for p in parts],
               "chain_ids_equal": bool(torch.equal(ids_c, ids)),
               "chain_max_abs_lp_diff": float((lps_c - lps).abs().max())}
        # one chunk from the state after the first, kernel against plain
        st = states[0]
        ik, lk, (hk, ck, xk) = decode_sample(st[2], *w, K_CHUNK,
                                             mode="serve", init_state=st)
        torch.cuda.synchronize()
        ip, lp_, (hp, cp, _) = decode_sample_plain(st[2], *w, K_CHUNK,
                                                   init_state=st)
        row["ids_equal"] = bool(torch.equal(ik, ip))
        row["rows_differing"] = int((ik != ip).any(dim=1).sum())
        row["distinct_ids"] = int(ik.unique().numel())
        row.update(tf_errors(w, st[2], ik, lk, st[:2], (hk, ck)))
        row["xT_is_embed_of_last_id"] = bool(torch.equal(
            xk, w[3][ik[:, -1].long()]))
        rows.append(row)
        emit({"phase": "carry_kernel", **row})
        check(row["chain_ids_equal"], f"B={B}: chained chunk ids differ")
        check(row["chain_max_abs_lp_diff"] <= CHAIN_ATOL,
              f"B={B}: chained chunk lps {row['chain_max_abs_lp_diff']}")
        check(row["max_id_gap"] <= ID_ATOL, f"B={B}: carried id gap {row}")
        for key in ("max_abs_lp_diff", "max_abs_h_diff", "max_abs_c_diff"):
            check(row[key] <= LP_ATOL, f"B={B}: carried {key} {row}")
        check(row["xT_is_embed_of_last_id"], f"B={B}: xT")
    return rows


def phase_qserve_kernel(dec, device):
    """The quantized serve kernel (int8, int4) against its plain version
    and against the dense kernel on the dequantized weights, full T and
    one carried chunk."""
    from gan_image_captioning_tpu_torch.kernels.decode_sample import (
        decode_sample, decode_sample_q_serve, decode_sample_q_serve_plain,
        dequantized_decoder)
    from gan_image_captioning_tpu_torch.ops.quantize import (
        quantize_lstm_decoder)

    out = {}
    for name, bits in QUANT_BITS.items():
        qdec = quantize_lstm_decoder(dec, bits)
        deq = dequantized_decoder(qdec, bits)
        rows = []
        for B in (8, 64):
            feats = seeded((B, E), 200 + B, device)
            _, _, st = decode_sample_q_serve(
                feats, qdec, K_CHUNK, bits=bits, init_state=(
                    torch.zeros(NL, B, H, device=device),
                    torch.zeros(NL, B, H, device=device), feats))
            for carry in (False, True):
                state = st if carry else None
                x0 = st[2] if carry else feats
                steps = K_CHUNK if carry else T
                res = decode_sample_q_serve(x0, qdec, steps, bits=bits,
                                            init_state=state)
                dense = decode_sample(x0, *deq, steps, mode="serve",
                                      init_state=state)
                torch.cuda.synchronize()
                plain = decode_sample_q_serve_plain(x0, qdec, steps,
                                                    init_state=state,
                                                    bits=bits)
                row = {"bits": bits, "B": B, "carry": carry, "steps": steps,
                       "ids_equal": bool(torch.equal(res[0], plain[0])),
                       "rows_differing": int((res[0] != plain[0]).any(
                           dim=1).sum()),
                       "distinct_ids": int(res[0].unique().numel()),
                       "dense_ids_equal": bool(torch.equal(res[0], dense[0])),
                       "dense_max_abs_lp_diff": float(
                           (res[1] - dense[1]).abs().max())}
                row.update(tf_errors(deq, x0, res[0], res[1],
                                     state[:2] if carry else None,
                                     res[2][:2] if carry else None))
                rows.append(row)
                emit({"phase": "qserve_kernel", **row})
                check(row["max_id_gap"] <= ID_ATOL, f"qserve id gap {row}")
                for key in ("max_abs_lp_diff", "max_abs_h_diff",
                            "max_abs_c_diff", "dense_max_abs_lp_diff"):
                    check(row.get(key, 0.0) <= LP_ATOL, f"qserve {key} {row}")
                check(row["dense_ids_equal"],
                      f"qserve ids != the dense kernel's {row}")
        out[name] = rows
    return out


def continuous_reference(gen_or_q, feats):
    """The full-T serve kernel decode of the dense or quantized decoder."""
    from gan_image_captioning_tpu_torch.eval.decode import decoder_of
    from gan_image_captioning_tpu_torch.kernels.decode_sample import (
        decode_sample, decode_sample_q_serve)
    from gan_image_captioning_tpu_torch.ops.quantize import (is_quantized,
                                                             payload_bits)

    dec = decoder_of(gen_or_q)
    if is_quantized(dec):
        return decode_sample_q_serve(feats, dec, T, bits=payload_bits(dec))
    return decode_sample(feats, *dense_weights(dec), T, mode="serve")


def phase_continuous_service(gen, workdir):
    """``serve.main --serve-continuous`` over stdin, dense and quantized,
    with the launch count of its kernel; then ``--serve-exact`` ids."""
    from gan_image_captioning_tpu_torch import serve
    from gan_image_captioning_tpu_torch.config import Config
    from gan_image_captioning_tpu_torch.data.synthetic import synthetic_vocab
    from gan_image_captioning_tpu_torch.eval.decode import masked_logprob_sum
    from gan_image_captioning_tpu_torch.eval.metrics import (ids_to_words,
                                                             strip_caption)
    from gan_image_captioning_tpu_torch.kernels.decode_sample import (
        decode_sample, decode_sample_carry, decode_sample_q_serve)
    from gan_image_captioning_tpu_torch.models.generator import (
        start_token_features)
    from gan_image_captioning_tpu_torch.ops.quantize import quantize_generator

    ckpt = workdir / "gen_full_width.ckpt"
    i2w = synthetic_vocab()[1]
    reqs = [{"n": 1}, {"n": 8}, {"n": 20}, {"n": 2, "stream": True},
            {"stats": True}]
    counters = {"carry": decode_sample_carry, "qserve": decode_sample_q_serve,
                "full": decode_sample}
    out = {}
    for variant in ("dense", "int8", "int4"):
        quant = [] if variant == "dense" else ["--quantize", variant]
        argv = ["--checkpoint", str(ckpt), *MODEL_FLAGS, "--serve-continuous",
                *quant]
        stdin = io.StringIO("".join(json.dumps(r) + "\n" for r in reqs))
        buf = io.StringIO()
        old_stdin = sys.stdin
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        try:
            sys.stdin = stdin
            with contextlib.redirect_stdout(buf):
                serve.main(argv)
        finally:
            sys.stdin = old_stdin
        seconds = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        lines = [json.loads(ln) for ln in buf.getvalue().splitlines()]
        check(lines[0].get("status") == "ready", f"{variant}: {lines[0]}")
        resps, stream = [], []
        for ln in lines[1:]:
            (stream if "row" in ln else resps).append(ln)
        stats = resps[-1]
        cont = stats["continuous"]

        # the reference: the full-T kernel decode of the same decoder on
        # the <S> row (every row of an unconditional request)
        config = Config(vocab_size=V, gen_embed_dim=E, gen_hidden_dim=H,
                        gen_num_layers=NL, max_seq_len=MAX_SEQ_LEN,
                        quantize=variant if quant else "none")
        params = gen if not quant else quantize_generator(gen, config)
        feats = start_token_features(gen.decoder, 1)
        ids_r, lps_r = continuous_reference(params, feats)
        want_cap = " ".join(ids_to_words(strip_caption(ids_r[0].tolist()),
                                         i2w))
        want_lp = float(masked_logprob_sum(ids_r, lps_r)[0])
        for req, resp in zip(reqs[:4], resps[:4]):
            check("captions" in resp, f"{variant} {req}: {resp}")
            check(len(resp["captions"]) == req["n"], f"{variant} {req}")
            check(all(c == want_cap for c in resp["captions"]),
                  f"{variant} {req}: caption differs from the full decode")
            check(all(abs(x - want_lp) <= SEQ_ATOL
                      for x in resp["logprobs"]), f"{variant} {req}: lp")
        for j in range(2):
            rows = [ln for ln in stream if ln["row"] == j]
            check(rows and rows[-1]["done"]
                  and rows[-1]["partial"] == resps[3]["captions"][j],
                  f"{variant}: stream of row {j}: {rows}")
        key = "carry" if variant == "dense" else "qserve"
        check(launches[key] > 0, f"{variant}: no {key} kernel launch")
        check(launches[key] == cont["device_calls"],
              f"{variant}: {key} launches {launches[key]} != device_calls "
              f"{cont['device_calls']}")
        check(cont["completed"] == 1 + 1 + 8 + 20 + 2,
              f"{variant}: completed {cont}")
        row = {"variant": variant, "caption": want_cap, "logprob": want_lp,
               "latency_ms": [r["latency_ms"] for r in resps[:4]],
               "stream_lines": len(stream), "stats": stats,
               "launches": launches, "seconds": seconds}
        emit({"phase": "continuous_service", **row})
        out[variant] = row

    # --serve-exact on random rows: ids equal to the full-T decode (each
    # differing row held to the teacher-forced rule)
    from gan_image_captioning_tpu_torch.kernels.decode_sample import (
        dequantized_decoder)

    for variant in ("dense", "int8"):
        quant = [] if variant == "dense" else ["--quantize", variant]
        service = serve.CaptionService(serve.parse_args(
            ["--checkpoint", str(ckpt), *MODEL_FLAGS, "--serve-continuous",
             "--serve-exact", *quant]))
        try:
            feats = seeded((20, E), 300, torch.device("cpu"))
            ids, lps = service._continuous(feats.numpy(), None)
            params = service.dec_params
        finally:
            service.close()
        dev_feats = feats.to(gen.decoder.embed.weight.device)
        ids_r, _ = continuous_reference(params, dev_feats)
        ids_t = torch.from_numpy(ids).to(dev_feats.device)
        weights = (dense_weights(gen.decoder) if variant == "dense" else
                   dequantized_decoder(params["decoder"], 8))
        lps_t = torch.zeros(ids_t.shape, device=dev_feats.device)
        tf = tf_errors(weights, dev_feats, ids_t, lps_t)
        row = {"variant": variant, "exact": True, "rows": 20,
               "ids_equal": bool(torch.equal(ids_t, ids_r)),
               "rows_differing": int((ids_t != ids_r).any(dim=1).sum()),
               "max_id_gap": tf["max_id_gap"],
               "distinct_ids": int(ids_t.unique().numel())}
        emit({"phase": "continuous_service", **row})
        check(row["max_id_gap"] <= ID_ATOL, f"exact-mode ids {row}")
        out[f"{variant}_exact"] = row
    return out


def phase_continuous_timing(dec, device, workdir):
    """``device_ms`` of one chunk and of the full-T quantized decode (the
    plain versions by CUDA events), in turns, beside the dense kernel and
    the bounds; request latency of the continuous service."""
    from gan_image_captioning_tpu_torch import serve
    from gan_image_captioning_tpu_torch.kernels.decode_sample import (
        decode_sample, decode_sample_plain, decode_sample_q_serve,
        decode_sample_q_serve_plain)
    from gan_image_captioning_tpu_torch.ops.quantize import (
        quantize_lstm_decoder)

    w = dense_weights(dec)
    qdecs = {n: quantize_lstm_decoder(dec, b) for n, b in QUANT_BITS.items()}
    wbytes = {"dense": weight_bytes(),
              **{n: weight_bytes(q) for n, q in qdecs.items()}}
    emit({"phase": "continuous_timing", "weight_bytes": wbytes})
    out = {"weight_bytes": wbytes}

    def kern_plain(variant, x0, steps, state):
        if variant == "dense":
            return (lambda: decode_sample(x0, *w, steps, mode="serve",
                                          init_state=state),
                    lambda: decode_sample_plain(x0, *w, steps, state))
        bits = QUANT_BITS[variant]
        q = qdecs[variant]
        return (lambda: decode_sample_q_serve(x0, q, steps, state, bits),
                lambda: decode_sample_q_serve_plain(x0, q, steps, state,
                                                    bits))

    for B, steps, variants in ((8, K_CHUNK, ("dense", "int8", "int4")),
                               (8, T, ("dense", "int8", "int4")),
                               (64, T, ("dense", "int8", "int4"))):
        feats = seeded((B, E), 400 + B, device)
        _, _, st = decode_sample(feats, *w, K_CHUNK, mode="serve",
                                 init_state=(
                                     torch.zeros(NL, B, H, device=device),
                                     torch.zeros(NL, B, H, device=device),
                                     feats))
        state = st if steps == K_CHUNK else None
        x0 = st[2] if state is not None else feats
        for variant in variants:
            kern, plain = kern_plain(variant, x0, steps, state)
            # the plain loops' launches overflow the queue behind the
            # spin: CUDA events at the host's pace (time_pair)
            k_calls, p_calls = (40, 10) if steps == K_CHUNK else (20, 5)
            key = f"{variant}_B{B}_T{steps}"
            out[key] = {**time_pair(kern, plain,
                                    chunk_work(B, steps, wbytes[variant]),
                                    k_calls, p_calls, plain_events=True),
                        "B": B, "steps": steps,
                        "carried": state is not None}
            emit({"phase": "continuous_timing", "variant": variant,
                  **out[key]})

    lat = {}
    for variant in ("dense", "int8", "int4"):
        quant = [] if variant == "dense" else ["--quantize", variant]
        service = serve.CaptionService(serve.parse_args(
            ["--checkpoint", str(workdir / "gen_full_width.ckpt"),
             *MODEL_FLAGS, "--serve-continuous", *quant]))
        try:
            for n in (1, 8):
                ms = [service.handle_request({"n": n})["latency_ms"]
                      for _ in range(40)]
                lat[f"{variant}_n{n}"] = {
                    "p50_ms": float(np.percentile(ms, 50)),
                    "p90_ms": float(np.percentile(ms, 90)),
                    "samples": len(ms)}
            lat[f"{variant}_stats"] = service.continuous.stats()
        finally:
            service.close()
    emit({"phase": "continuous_timing", "service_request_latency": lat,
          "note": "sequential requests, host clock, 8 slots, 8-step chunks, "
                  "early exit"})
    out["service"] = lat
    return out


def phase_continuous_profile(dec, device, workdir, calls=3):
    """Device time by kernel and busy share of the full-T quantized decode
    (B = 8) and of a ``{"n": 8}`` request on the continuous service."""
    from gan_image_captioning_tpu_torch import serve
    from gan_image_captioning_tpu_torch.kernels.decode_sample import (
        decode_sample_q_serve)
    from gan_image_captioning_tpu_torch.ops.quantize import (
        quantize_lstm_decoder)

    out = {}
    feats = seeded((8, E), 408, device)
    for name, bits in QUANT_BITS.items():
        qdec = quantize_lstm_decoder(dec, bits)
        out[name] = profile_calls(
            lambda: decode_sample_q_serve(feats, qdec, T, bits=bits), calls)
        emit({"phase": "continuous_profile", "variant": name, "B": 8,
              **out[name]})
    for variant in ("dense", "int8"):
        quant = [] if variant == "dense" else ["--quantize", variant]
        service = serve.CaptionService(serve.parse_args(
            ["--checkpoint", str(workdir / "gen_full_width.ckpt"),
             *MODEL_FLAGS, "--serve-continuous", *quant]))
        try:
            row = profile_calls(lambda: service.handle_request({"n": 8}),
                                calls)
        finally:
            service.close()
        out[f"service_{variant}"] = row
        emit({"phase": "continuous_profile", "request": {"n": 8},
              "variant": variant, **row})
    return out


def continuous_entries(smi, carry_rows, q_rows, times, service):
    """The kernels-line entries of the carried serve kernel and of the
    quantized serve kernel at 8 and 4 bits."""
    src = "gan_image_captioning_tpu_torch/kernels/csrc/"
    chunk = times[f"dense_B8_T{K_CHUNK}"]
    out = [{
        "name": "decode_serve_carry", "route": "cuda",
        "source": src + "decode_serve.cu", "replaces": TPU_KERNEL,
        "launches": service["dense"]["launches"]["carry"],
        "max_abs_err": max(max(r["max_abs_lp_diff"], r["max_abs_h_diff"],
                               r["max_abs_c_diff"]) for r in carry_rows),
        "ms": min(chunk["kernel_ms"]), "plain_ms": min(chunk["plain_ms"]),
        "bound_ms": chunk["bound_ms"], "bound_by": chunk["bound_by"],
        "library_ms": None, "B": 8, "steps": K_CHUNK, "card": smi}]
    for name, bits in QUANT_BITS.items():
        full = times[f"{name}_B8_T{T}"]
        full64 = times[f"{name}_B64_T{T}"]
        out.append({
            "name": f"decode_qserve_{name}", "route": "cuda",
            "source": src + "decode_serve.cu", "replaces": Q_TPU_KERNEL,
            "launches": service[name]["launches"]["qserve"],
            "max_abs_err": max(max(r["max_abs_lp_diff"],
                                   r.get("max_abs_h_diff", 0.0),
                                   r.get("max_abs_c_diff", 0.0))
                               for r in q_rows[name]),
            "ms": min(full["kernel_ms"]), "plain_ms": min(full["plain_ms"]),
            "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
            "library_ms": None, "B": 8, "steps": T, "bits": bits,
            "ms_b64": min(full64["kernel_ms"]),
            "plain_ms_b64": min(full64["plain_ms"]),
            "bound_ms_b64": full64["bound_ms"],
            "weight_bytes": times["weight_bytes"][name], "card": smi})
    return out


# ----------------------------------------------------------------- training

DISC_E, DISC_R = 64, 64
BANKS = ((300, 3), (300, 4), (300, 5))
B_TRAIN, TEMP = 64, 10.0
SOFT_ATOL, RESID_ATOL, CHAIN_RTOL = 1e-5, 1e-4, 1e-4
POOL_ATOL, TIE_GAP, DW_RTOL, DX_ATOL = 1e-5, 1e-6, 1e-4, 1e-5
TRAIN_TPU_KERNELS = {
    "decode_sample_resid": "gan_image_captioning_tpu/kernels/decode_sample.py:121",
    "lstm_bptt_chain": "gan_image_captioning_tpu/kernels/lstm_bptt.py:59",
    "disc_conv_fwd": "gan_image_captioning_tpu/kernels/disc_conv.py:477",
    "disc_conv_bwd_dx": "gan_image_captioning_tpu/kernels/disc_conv.py:515",
}
TRAIN_SOURCES = {
    "decode_sample_resid": "decode_serve.cu", "lstm_bptt_chain": "lstm_bptt.cu",
    "disc_conv_fwd": "disc_conv.cu", "disc_conv_bwd_dx": "disc_conv.cu",
}


def bound(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def resid_work(B):
    """sample_resid: the decode's inputs and products, and its outputs
    (ids, soft [T, B, V], hs/cs [T, NL, B, H], gates [T, NL, B, 4H])."""
    nbytes, flops = decode_work(B)
    nbytes += 4 * (T * B * V + T * NL * B * 6 * H) - 4 * B * T  # no lps
    return nbytes, flops


def chain_work(B):
    products = T * (2 * NL - 1)
    nbytes = 4 * ((2 * NL - 1) * H * 4 * H + T * B * H
                  + 2 * T * NL * B * 4 * H + T * NL * B * H)
    return nbytes, 2 * products * B * 4 * H * H


def conv_work(B, backward=False):
    """One pass (all banks) of the conv forward or backward."""
    q, maxf, lp = B * DISC_R, max(f for _, f in BANKS), T + 4
    n_all = sum(n for n, _ in BANKS)
    emb = 4 * B * lp * DISC_E
    w = 4 * n_all * maxf
    if backward:   # emb, w, idx, dpm in; d_emb, dW out
        nbytes = 2 * emb + 2 * w + 2 * 4 * q * n_all
        flops = sum(4 * q * n * f for n, f in BANKS)
    else:          # emb, w, b in; pooled, idx out
        nbytes = emb + w + 4 * n_all + 2 * 4 * q * n_all
        flops = sum(2 * q * n * (T - f + 1) * f for n, f in BANKS)
    return nbytes, flops


def seeded(shape, seed, device, scale=1.0):
    return torch.from_numpy((np.random.default_rng(seed).standard_normal(
        shape) * scale).astype(np.float32)).to(device)


def resid_teacher_forced(dec, feats, ids, u, temp):
    """The plain sample_resid arithmetic with the input at step t+1 =
    embed[ids[:, t]] → (scores [T, B, V], soft, hs, cs, gates)."""
    from gan_image_captioning_tpu_torch.ops.gumbel import gumbel_noise

    layers = dec.lstm.layers()
    B = feats.shape[0]
    h = [feats.new_zeros(B, H) for _ in layers]
    c = [feats.new_zeros(B, H) for _ in layers]
    x, out = feats, {k: [] for k in ("scores", "soft", "hs", "cs", "gates")}
    for t in range(ids.shape[1]):
        inp, gs = x, []
        for l, p in enumerate(layers):
            g = (inp @ p["w_ih"].T + h[l] @ p["w_hh"].T
                 + (p["b_ih"] + p["b_hh"]))
            gi, gf, gg, go = g.chunk(4, dim=-1)
            c[l] = torch.sigmoid(gf) * c[l] + torch.sigmoid(gi) * torch.tanh(gg)
            h[l] = torch.sigmoid(go) * torch.tanh(c[l])
            inp = h[l]
            gs.append(g)
        scores = (inp @ dec.linear.weight.T + dec.linear.bias
                  + gumbel_noise(u[t].shape, u=u[t]))
        out["scores"].append(scores)
        out["soft"].append(torch.softmax(scores * temp, dim=-1))
        out["hs"].append(torch.stack(h))
        out["cs"].append(torch.stack(c))
        out["gates"].append(torch.stack(gs))
        x = dec.embed.weight[ids[:, t].long()]
    return {k: torch.stack(v) for k, v in out.items()}


def conv_inputs(device):
    """Full-width conv bank inputs at unit scale: emb_pad [B, T+4, 64]
    (zero time padding), w_all [900, 5], b_all [900]."""
    from gan_image_captioning_tpu_torch.kernels.disc_conv import (
        fuse_bank_params)

    B = B_TRAIN
    emb = seeded((B, T, DISC_E), 11, device)
    convs = [(seeded((n, 1, f, 1), 12 + f, device, 1 / math.sqrt(f)),
              seeded((n,), 20 + f, device, 0.1)) for n, f in BANKS]
    w_all, b_all, banks = fuse_bank_params(convs, 1)
    emb_pad = torch.nn.functional.pad(emb, (0, 0, 0, 4)).contiguous()
    return emb_pad, w_all.contiguous(), b_all.contiguous(), banks


def idx_mismatch(emb_pad, w_all, b_all, banks, pooled, idx_a, idx_b):
    """Argmax rows of two conv forwards (eds = 1): how many live (r, n)
    differ where the top two time rows are more than TIE_GAP apart, and how
    many live ones are near-ties."""
    x = emb_pad[:, None, :T, :]
    idx_bad = ties = 0
    off = 0
    for (n, f), ia, ib in zip(banks, idx_a, idx_b):
        z = torch.relu(torch.nn.functional.conv2d(
            x, w_all[off:off + n, :f].reshape(n, 1, f, 1),
            b_all[off:off + n]))                            # [B, n, lv, R]
        top2 = z.topk(2, dim=2).values
        clear = ((top2[:, :, 0] - top2[:, :, 1]) > TIE_GAP).transpose(1, 2)
        live = pooled[..., off:off + n] > 0
        ties += int((live & ~clear).sum())
        idx_bad += int(((ia != ib) & live & clear).sum())
        off += n
    return idx_bad, ties


def phase_train_kernels(dec, device):
    """The four training kernels against their plain versions at the
    training width, B = 64, on the same inputs."""
    from gan_image_captioning_tpu_torch.kernels import disc_conv
    from gan_image_captioning_tpu_torch.kernels.decode_sample import (
        decode_sample_resid, decode_sample_resid_plain)
    from gan_image_captioning_tpu_torch.kernels.lstm_bptt import (
        lstm_bptt_chain, lstm_bptt_chain_plain)

    B, out = B_TRAIN, {}
    feats = seeded((B, E), 64, device)
    args = decode_args(dec, feats)
    gen = torch.Generator(device=device).manual_seed(5)
    u = torch.rand((T, B, V), generator=gen, device=device)

    # --- sample_resid with fed uniforms
    k = decode_sample_resid(*args, temperature=TEMP, uniforms=u)
    torch.cuda.synchronize()
    p = decode_sample_resid_plain(*args, u, TEMP)
    tf = resid_teacher_forced(dec, feats, k[0], u, TEMP)
    chosen = tf["scores"].gather(2, k[0].T.long()[..., None])[..., 0]
    row = {"ids_equal": bool(torch.equal(k[0], p[0])),
           "rows_differing": int((k[0] != p[0]).any(dim=1).sum()),
           "distinct_ids": int(k[0].unique().numel()),
           "max_id_gap": float((tf["scores"].max(dim=2).values
                                - chosen).max())}
    for i, name in enumerate(("soft", "hs", "cs", "gates"), start=1):
        row[f"max_abs_{name}_diff"] = float((k[i] - tf[name]).abs().max())
    row["soft_finite"] = bool(torch.isfinite(k[1]).all())
    row["soft_row_sum_err"] = float((k[1].sum(dim=2) - 1).abs().max())
    check(row["max_id_gap"] <= ID_ATOL, f"sample_resid id gap {row}")
    check(row["max_abs_soft_diff"] <= SOFT_ATOL, f"sample_resid soft {row}")
    for name in ("hs", "cs", "gates"):
        check(row[f"max_abs_{name}_diff"] <= RESID_ATOL,
              f"sample_resid {name} {row}")
    out["decode_sample_resid"] = row
    emit({"phase": "train_kernels", "kernel": "decode_sample_resid", **row})

    # --- the Philox draw: reproducible per seed, uniform in distribution
    u_out = torch.empty_like(u)
    ids_a = decode_sample_resid(*args, seed=1234, temperature=TEMP,
                                uniforms_out=u_out)[0]
    ids_b = decode_sample_resid(*args, seed=1234, temperature=TEMP)[0]
    ids_c = decode_sample_resid(*args, seed=4321, temperature=TEMP)[0]
    ids_fed = decode_sample_resid(*args, temperature=TEMP, uniforms=u_out)[0]
    row = {"same_seed_same_ids": bool(torch.equal(ids_a, ids_b)),
           "other_seed_other_ids": not bool(torch.equal(ids_a, ids_c)),
           "fed_back_same_ids": bool(torch.equal(ids_a, ids_fed)),
           "uniform_mean": float(u_out.double().mean()),
           "share_below_0.1": float((u_out < 0.1).double().mean()),
           "uniform_min": float(u_out.min()), "uniform_max": float(u_out.max()),
           "samples": u_out.numel()}
    emit({"phase": "train_kernels", "kernel": "philox", **row})
    check(row["same_seed_same_ids"] and row["other_seed_other_ids"]
          and row["fed_back_same_ids"], f"philox ids {row}")
    check(abs(row["uniform_mean"] - 0.5) <= 1e-3
          and abs(row["share_below_0.1"] - 0.1) <= 1e-3, f"philox {row}")
    out["philox"] = row

    # --- lstm_bptt_chain on the kernel's residuals
    layers = dec.lstm.layers()
    w_hhs = torch.stack([lp["w_hh"].T for lp in layers]).contiguous()
    w_ihs = torch.stack([lp["w_ih"].T for lp in layers[1:]]).contiguous()
    d_hs = seeded((T, B, H), 65, device)
    gates, cs = k[4], k[3]
    d_k = lstm_bptt_chain(w_hhs, w_ihs, d_hs, gates, cs)
    torch.cuda.synchronize()
    d_p = lstm_bptt_chain_plain(w_hhs, w_ihs, d_hs, gates, cs)
    scale = float(d_p.abs().max())
    row = {"max_abs_diff": float((d_k - d_p).abs().max()),
           "max_abs_d_pre": scale}
    row["rel"] = row["max_abs_diff"] / scale
    emit({"phase": "train_kernels", "kernel": "lstm_bptt_chain", **row})
    check(row["rel"] <= CHAIN_RTOL, f"lstm_bptt_chain {row}")
    out["lstm_bptt_chain"] = row

    # --- disc conv forward and backward-dX
    emb_pad, w_all, b_all, banks = conv_inputs(device)
    before = disc_conv.conv_bank_forward.launches
    pooled_k, idx_k = disc_conv.conv_bank_forward(emb_pad, w_all, b_all,
                                                  banks, DISC_R, 1)
    counted = disc_conv.conv_bank_forward.launches - before
    torch.cuda.synchronize()
    plan = disc_conv.conv_fwd_plan(B * DISC_R, emb_pad.shape[1] - max(
        f for _, f in banks) + 1, 1, banks)
    pooled_p, idx_p = disc_conv.conv_relu_maxpool_plain(
        emb_pad, w_all, b_all, banks, DISC_R, 1)
    idx_bad, ties = idx_mismatch(emb_pad, w_all, b_all, banks, pooled_p,
                                 idx_k, idx_p)
    evs = kernel_events(lambda: disc_conv.conv_bank_forward(
        emb_pad, w_all, b_all, banks, DISC_R, 1), 3)
    row = {"max_abs_pooled_diff": float((pooled_k - pooled_p).abs().max()),
           "max_pooled": float(pooled_p.max()),
           "idx_mismatch_outside_ties": idx_bad, "near_ties": ties,
           "live_share": float((pooled_p > 0).double().mean()),
           "plan_launches": len(plan["launches"]), "counted": counted,
           "profiler_kernel_events_per_pass": len(evs) / 3,
           "kernels": sorted({n[:60] for n, _ in evs})}
    emit({"phase": "train_kernels", "kernel": "disc_conv_fwd", **row})
    check(row["max_abs_pooled_diff"] <= POOL_ATOL and idx_bad == 0,
          f"disc conv forward {row}")
    check(row["plan_launches"] == 1 and counted == 1,
          f"disc conv forward: {row['plan_launches']} launches planned, "
          f"{counted} counted for one pass, expected 1")
    out["disc_conv_fwd"] = row

    # the backward-dX from the masked gradient (the JAX package's kernel
    # signature) and from the raw one (the autograd route: mask and db in
    # the launch); its plan and its count: one launch for the banks and
    # one reduction a pass
    d_pooled = seeded(tuple(pooled_k.shape), 70, device)
    dpms, db_p = disc_conv._masked(pooled_k, d_pooled, banks)
    L = emb_pad.shape[1] - max(f for _, f in banks) + 1
    before = disc_conv.conv_bank_backward.launches
    d_emb_k, dw_k = disc_conv.conv_bank_backward(emb_pad, w_all, banks,
                                                 DISC_R, 1, idx_k, dpms)
    counted = disc_conv.conv_bank_backward.launches - before
    raw_args = (emb_pad, w_all, banks, DISC_R, 1, pooled_k, idx_k, d_pooled)
    raw_k = disc_conv.conv_bank_backward_raw(*raw_args)
    again = (disc_conv.conv_bank_backward(emb_pad, w_all, banks, DISC_R, 1,
                                          idx_k, dpms)
             + disc_conv.conv_bank_backward_raw(*raw_args))
    torch.cuda.synchronize()
    d_emb_p, dw_p = disc_conv.conv_bwd_dx_plain(emb_pad, w_all, banks,
                                                DISC_R, 1, idx_k, dpms)
    plans = [disc_conv.conv_bwd_plan(B * DISC_R, L, 1, banks, raw)
             for raw in (False, True)]
    row = {"dw_rel": float((dw_k - dw_p).abs().max() / dw_p.abs().max()),
           "max_abs_dx_diff": float((d_emb_k - d_emb_p).abs().max()),
           "max_abs_dx": float(d_emb_p.abs().max()),
           "raw_dw_rel": float((raw_k[1] - dw_p).abs().max()
                               / dw_p.abs().max()),
           "raw_max_abs_dx_diff": float((raw_k[0] - d_emb_p).abs().max()),
           "raw_max_abs_db_diff": float((raw_k[2] - db_p).abs().max()),
           "max_abs_db": float(db_p.abs().max()),
           "bit_equal_repeat": all(torch.equal(a, b) for a, b in zip(
               (d_emb_k, dw_k, *raw_k), again)),
           "bit_equal_masked_raw": bool(torch.equal(d_emb_k, raw_k[0])
                                        and torch.equal(dw_k, raw_k[1])),
           "plan_launches": [len(p["launches"]) for p in plans],
           "plan_kernel_launches": [p["kernel_launches"] for p in plans],
           "counted": counted,
           "grid": plans[0]["blocks"], "slabs": plans[0]["slabs"]}
    emit({"phase": "train_kernels", "kernel": "disc_conv_bwd_dx", **row})
    for pre in ("", "raw_"):
        check(row[pre + "dw_rel"] <= DW_RTOL, f"disc conv backward dW {row}")
        check(row[pre + "max_abs_dx_diff"]
              <= DX_ATOL * max(1.0, row["max_abs_dx"]),
              f"disc conv backward dX {row}")
    check(row["raw_max_abs_db_diff"] <= DX_ATOL * max(1.0, row["max_abs_db"]),
          f"disc conv backward db {row}")
    check(row["bit_equal_repeat"] and row["bit_equal_masked_raw"],
          f"disc conv backward: two calls differ {row}")
    check(row["plan_launches"] == [1, 1] and row["plan_kernel_launches"]
          == [2, 2] and counted == 1,
          f"disc conv backward: {row['plan_launches']} launches of the banks "
          f"planned (expected 1, and one reduction), {counted} counted for "
          "one pass")
    out["disc_conv_bwd_dx"] = row
    return out


def phase_train_kernel_timing(dec, device):
    """Each training kernel's ``device_ms`` at B = 64 beside its plain
    version's and its bound, in turns (plain, kernel, kernel, plain)."""
    from gan_image_captioning_tpu_torch.kernels import disc_conv
    from gan_image_captioning_tpu_torch.kernels.decode_sample import (
        decode_sample_resid, decode_sample_resid_plain)
    from gan_image_captioning_tpu_torch.kernels.lstm_bptt import (
        lstm_bptt_chain, lstm_bptt_chain_plain)

    B = B_TRAIN
    feats = seeded((B, E), 64, device)
    args = decode_args(dec, feats)
    u = torch.rand((T, B, V), generator=torch.Generator(
        device=device).manual_seed(5), device=device)
    _, _, _, cs, gates = decode_sample_resid(*args, seed=3, temperature=TEMP)
    layers = dec.lstm.layers()
    w_hhs = torch.stack([lp["w_hh"].T for lp in layers]).contiguous()
    w_ihs = torch.stack([lp["w_ih"].T for lp in layers[1:]]).contiguous()
    d_hs = seeded((T, B, H), 65, device)
    emb_pad, w_all, b_all, banks = conv_inputs(device)
    pooled, idxs = disc_conv.conv_bank_forward(emb_pad, w_all, b_all, banks,
                                               DISC_R, 1)
    d_pooled = seeded(tuple(pooled.shape), 70, device)
    dpms, _ = disc_conv._masked(pooled, d_pooled, banks)
    raw_args = (emb_pad, w_all, banks, DISC_R, 1, pooled, idxs, d_pooled)

    cases = {
        "decode_sample_resid": (
            lambda: decode_sample_resid(*args, seed=3, temperature=TEMP),
            lambda: decode_sample_resid_plain(*args, u, TEMP),
            resid_work(B), 10, 3),
        "lstm_bptt_chain": (
            lambda: lstm_bptt_chain(w_hhs, w_ihs, d_hs, gates, cs),
            lambda: lstm_bptt_chain_plain(w_hhs, w_ihs, d_hs, gates, cs),
            chain_work(B), 20, 3),
        "disc_conv_fwd": (
            lambda: disc_conv.conv_bank_forward(emb_pad, w_all, b_all, banks,
                                                DISC_R, 1),
            lambda: disc_conv.conv_relu_maxpool_plain(emb_pad, w_all, b_all,
                                                      banks, DISC_R, 1),
            conv_work(B), 50, 20),
        "disc_conv_bwd_dx": (
            lambda: disc_conv.conv_bank_backward(emb_pad, w_all, banks,
                                                 DISC_R, 1, idxs, dpms),
            lambda: disc_conv.conv_bwd_dx_plain(emb_pad, w_all, banks, DISC_R,
                                                1, idxs, dpms),
            conv_work(B, backward=True), 50, 4),
        # the autograd route's: the mask and db in the launch
        "disc_conv_bwd_dx_raw": (
            lambda: disc_conv.conv_bank_backward_raw(*raw_args),
            lambda: disc_conv.conv_rows_backward_plain(*raw_args),
            rows_bwd_work(B), 50, 4),
    }
    rows = {}
    for name, (kern, plain, work, k_calls, p_calls) in cases.items():
        # the plain decode and chain loops' launches overflow the queue
        # behind the spin: CUDA events at the host's pace (time_pair)
        rows[name] = {**time_pair(kern, plain, work, k_calls, p_calls,
                                  plain_events=name in (
                                      "decode_sample_resid",
                                      "lstm_bptt_chain")), "B": B}
        emit({"phase": "train_timing", "kernel": name, **rows[name]})

    # the mxu autograd route's choice: the ReLU mask and db in torch around
    # conv_bank_backward, or in its launch (conv_bank_backward_raw)
    def mask_outside():
        dp, _ = disc_conv._masked(pooled, d_pooled, banks)
        return disc_conv.conv_bank_backward(emb_pad, w_all, banks, DISC_R, 1,
                                            idxs, dp)

    def mask_in_launch():
        return disc_conv.conv_bank_backward_raw(*raw_args)

    route = {"mask_outside_ms": [device_ms(mask_outside, 50)
                                 for _ in range(2)],
             "mask_in_launch_ms": [device_ms(mask_in_launch, 50)
                                   for _ in range(2)]}
    emit({"phase": "train_timing", "kernel": "disc_conv_bwd_dx_route", "B": B,
          **route})
    return rows


COUNTERS = ("decode_serve", "decode_sample_resid", "lstm_bptt_chain",
            "disc_conv_fwd", "disc_conv_bwd_dx", "lstm_bptt_reverse",
            "disc_conv_rows_fwd", "disc_conv_rows_bwd", "disc_conv_bwd_dxs",
            "decode_sample_noise", "decode_sample_logits",
            "decode_sample_embed", "decode_sample_embed_bwd")
MLE_STEPS, ADV_STEPS, DISC_EVERY = 3, 4, 2
# launches per step by design: the MLE step runs one greedy decode and the
# rescore's backward, one reverse recurrence per layer; the adversarial
# step one sample_resid decode, one BPTT chain, and a conv forward and
# backward for each of its three discriminator passes
PER_MLE_STEP = {"decode_serve": 1, "lstm_bptt_reverse": NL}
PER_ADV_STEP = {"decode_sample_resid": 1, "lstm_bptt_chain": 1,
                "disc_conv_fwd": 3, "disc_conv_bwd_dx": 3}
LOSS_RTOL, GRAD_RTOL = 1e-4, 1e-3


def counters():
    from gan_image_captioning_tpu_torch.kernels import decode_sample as ds
    from gan_image_captioning_tpu_torch.kernels import disc_conv
    from gan_image_captioning_tpu_torch.kernels.lstm_bptt import (
        lstm_bptt_chain, lstm_bptt_reverse)

    return dict(zip(COUNTERS, (ds.decode_sample, ds.decode_sample_resid,
                               lstm_bptt_chain, disc_conv.conv_bank_forward,
                               disc_conv.conv_bank_backward,
                               lstm_bptt_reverse,
                               disc_conv.conv_rows_forward,
                               disc_conv.conv_rows_backward,
                               disc_conv.conv_bank_dxs,
                               ds.decode_sample_noise,
                               ds.decode_sample_logits,
                               ds.decode_sample_embed,
                               ds.decode_sample_embed_bwd)))


def train_setup(device):
    """bench.py's config3 geometry in float32: the generator and
    discriminator with un-swept initial weights from seed 0, and B = 64
    captions of 30 random tokens in [4, 11000)."""
    from gan_image_captioning_tpu_torch.config import Config
    from gan_image_captioning_tpu_torch.models import api
    from gan_image_captioning_tpu_torch.train.state import create_train_state

    config = Config(vocab_size=V, gen_embed_dim=E, gen_hidden_dim=H,
                    gen_num_layers=NL, max_seq_len=MAX_SEQ_LEN,
                    disc_embed_dim=DISC_E, disc_num_rep=DISC_R,
                    disc_filter_sizes=tuple(f for _, f in BANKS),
                    disc_num_filters=tuple(n for n, _ in BANKS),
                    disc_train_freq=DISC_EVERY)
    disc = api.init_discriminator(torch.Generator().manual_seed(1), config,
                                  device, sweep=False)
    state = create_train_state(config, 0, device,
                               gen=full_width_generator(device)
                               .requires_grad_(True), disc=disc)
    return config, state, train_batch(device)


def train_batch(device):
    """B = 64 captions of 30 random tokens in [4, 11000)."""
    from gan_image_captioning_tpu_torch.data.loader import make_batch
    from gan_image_captioning_tpu_torch.train.steps import batch_to

    caps = [np.random.default_rng(i).integers(4, min(11000, V), size=30)
            for i in range(B_TRAIN)]
    return batch_to(make_batch(caps, None, T), device)


def fed_noise(config, device, seed=9):
    gen = torch.Generator(device=device).manual_seed(seed)
    keep_shape = (B_TRAIN * DISC_R, config.disc_feature_dim)
    return {"uniforms": torch.rand((T, B_TRAIN, V), generator=gen,
                                   device=device),
            "keep": [torch.rand(keep_shape, generator=gen, device=device)
                     < 0.8 for _ in range(3)]}


def phase_train(device):
    """3 MLE steps, then 4 adversarial steps (disc_train_freq 2,
    temperature 10) through the entry points, with the launch counts; then
    one adversarial step through the kernels against the same step
    through the plain versions, on the same state and fed noise."""
    from gan_image_captioning_tpu_torch.train.steps import (
        adv_grads, make_adv_step, make_mle_step)

    config, state, batch = train_setup(device)
    before = {k: v.detach().clone() for m in (state.gen, state.disc)
              for k, v in m.state_dict().items()}
    mle, adv = make_mle_step(config), make_adv_step(config)
    cnt = counters()
    for fn in cnt.values():
        fn.launches = 0
    metrics = []
    t0 = time.perf_counter()
    for _ in range(MLE_STEPS):
        state, m = mle(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    for _ in range(ADV_STEPS):
        state, m = adv(state, batch, TEMP)
        metrics.append({k: float(v) for k, v in m.items()})
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in cnt.items()}
    expected = {k: MLE_STEPS * PER_MLE_STEP.get(k, 0)
                + ADV_STEPS * PER_ADV_STEP.get(k, 0) for k in COUNTERS}
    after = {k: v for m in (state.gen, state.disc)
             for k, v in m.state_dict().items()}
    moved = {k: float((after[k] - before[k]).abs().max()) for k in before}
    row = {"metrics": metrics, "launches": launches,
           "expected_launches": expected, "seconds": seconds,
           "gen_steps": state.gen_steps, "disc_steps": state.disc_steps,
           "params_unmoved": [k for k, d in moved.items() if d == 0.0]}
    emit({"phase": "train", **row})
    check(all(math.isfinite(x) for m in metrics for x in m.values()),
          "non-finite training metric")
    check(not row["params_unmoved"], f"params that did not move: "
          f"{row['params_unmoved']}")
    check(state.disc_steps == 2 and state.gen_steps == ADV_STEPS,
          f"counters {state.gen_steps}, {state.disc_steps}")
    check(launches == expected, f"launches {launches} != {expected}")

    # kernels against plain versions, one adversarial step, fed noise.  The
    # plain route pools at the kernel route's argmax rows (each within
    # TIE_GAP of the plain max) and takes its ReLU decisions at the pool
    # and in the highway (where they differ, both inputs within TIE_GAP of
    # 0), as the decode check teacher-forces on the kernel's ids: without
    # that, a near-tie that the two routes break differently moves a whole
    # d_emb column, or a ReLU input within rounding of 0 passes one
    # route's gradient and stops the other's.  The comparison without the
    # replay is reported too.
    from gan_image_captioning_tpu_torch.kernels import disc_conv

    noise = fed_noise(config, device)
    plain_cfg = config.replace(decode_impl="plain", disc_engine="plain")
    with disc_conv.argmax_record() as rows:
        kern = adv_grads(config, state, batch, TEMP, noise)
    with disc_conv.argmax_replay(rows) as report:
        plain = adv_grads(plain_cfg, state, batch, TEMP, noise)
    free = adv_grads(plain_cfg, state, batch, TEMP, noise)
    cmp = {"replayed": compare_grads(kern, plain),
           "not_replayed": compare_grads(kern, free),
           "argmax_gap": max(g for g, _ in report),
           "argmax_moved": [m for _, m in report]}
    emit({"phase": "train", "kernels_vs_plain": cmp})
    rep = cmp["replayed"]
    check(rep["ids_equal"], "the routes sampled different ids")
    check(cmp["argmax_gap"] <= TIE_GAP, f"argmax gap {cmp['argmax_gap']}")
    for name in ("g_loss", "d_loss"):
        a, b = rep[name]
        check(abs(a - b) <= LOSS_RTOL * abs(b), f"{name} {a} vs {b}")
    worst = sorted(rep["grad_rel_err"].items(), key=lambda kv: -kv[1])[:5]
    check(rep["max_grad_rel_err"] <= GRAD_RTOL, f"gradients: {worst}")
    row["kernels_vs_plain"] = cmp
    return row, (config, state, batch)


def compare_grads(a, b):
    """Losses and per-tensor gradient error (max |a - b| over max |b|) of
    two ``adv_grads`` results; and each side's largest error over the
    side's largest gradient."""
    errs, side_errs = {}, {}
    for side, ga, gb in (("gen", a[2], b[2]), ("disc", a[3], b[3])):
        diffs = {k: float((ga[k] - gb[k]).abs().max()) for k in ga}
        scales = {k: float(gb[k].abs().max()) for k in ga}
        for k in ga:
            errs[f"{side}.{k}"] = diffs[k] / max(scales[k], 1e-30)
        if ga:
            side_errs[side] = max(diffs.values()) / max(max(scales.values()),
                                                        1e-30)
    return {"g_loss": [float(a[0]), float(b[0])],
            "d_loss": [float(a[1]), float(b[1])],
            "ids_equal": bool(torch.equal(a[4]["gen_ids"], b[4]["gen_ids"])),
            "grad_rel_err": errs, "max_grad_rel_err": max(errs.values()),
            "grad_side_rel_err": side_errs}


def step_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def phase_train_step_timing(device, setup):
    """ms per MLE and adversarial step (host clock, synchronised), the
    kernel route against the plain route, in turns."""
    from gan_image_captioning_tpu_torch.train.steps import (make_adv_step,
                                                            make_mle_step)

    config, state, batch = setup
    plain_cfg = config.replace(decode_impl="plain", disc_engine="plain")
    out = {}
    for kind in ("mle", "adv"):
        fns = {}
        for route, cfg in (("kernel", config), ("plain", plain_cfg)):
            if kind == "mle":
                step = make_mle_step(cfg)
                fns[route] = lambda step=step: step(state, batch)
            else:
                step = make_adv_step(cfg)
                fns[route] = lambda step=step: step(state, batch, TEMP)
        p_a = step_ms(fns["plain"], 3)
        k_a = step_ms(fns["kernel"], 5)
        k_b = step_ms(fns["kernel"], 5)
        p_b = step_ms(fns["plain"], 3)
        out[kind] = {"kernel_ms": [k_a, k_b], "plain_ms": [p_a, p_b]}
        emit({"phase": "train_timing", "step": kind, "B": B_TRAIN,
              **out[kind]})
    return out


KERNEL_NAMES = ("decode_persistent_kernel", "embed_kernel",
                "reverse_persistent_kernel", "chain_persistent_kernel",
                "conv_fwd_kernel", "conv_bwd_kernel",
                "conv_bwd_reduce_kernel")


def phase_train_profile(device, setup, steps=2 * DISC_EVERY):
    """Device time and launches by kernel, and their totals
    (torch.profiler), over 4 adversarial steps of the kernel route: two
    cycles of the discriminator's update cadence, so the window holds two
    of its updates whatever steps ran before; the device's busy share of
    their wall time; the card's clocks, power draw and temperature
    (``nvidia-smi``) just after."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gan_image_captioning_tpu_torch.train.steps import make_adv_step

    config, state, batch = setup
    step = make_adv_step(config)
    step(state, batch, TEMP)
    torch.cuda.synchronize()
    updates = state.disc_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(state, batch, TEMP)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    updates = state.disc_steps - updates
    check(updates == steps // DISC_EVERY,
          f"train_profile: {updates} discriminator updates in {steps} steps")
    us, count = {}, {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        key = next((n for n in KERNEL_NAMES if n in ev.key), ev.key[:60])
        us[key] = us.get(key, 0.0) + ev.self_device_time_total / steps
        count[key] = count.get(key, 0) + ev.count / steps
    if not us:
        row = {"device_time": "not measured"}
    else:
        busy = sum(us.values()) * steps
        ours = sum(v for k, v in us.items() if k in KERNEL_NAMES)
        order = sorted(us, key=lambda k: -us[k])
        row = {"device_ms_per_step_total": sum(us.values()) / 1e3,
               "launches_per_step_total": sum(count.values()),
               "device_us_per_step": {k: us[k] for k in order},
               "launches_per_step": {k: count[k] for k in order},
               "hand_written_share": ours / sum(us.values()),
               "device_busy_share": busy / wall_us,
               "wall_ms_per_step": wall_us / steps / 1e3}
    row["card_after"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, check=True, timeout=60).stdout.strip()
    emit({"phase": "train_profile", "B": B_TRAIN, "steps": steps,
          "disc_updates": updates, **row})
    return row


def kernel_entries(smi, train_kernel_rows, train_times, launches):
    """The four training kernels' entries of the ``kernels`` line."""
    errs = {"decode_sample_resid": train_kernel_rows["decode_sample_resid"][
                "max_abs_soft_diff"],
            "lstm_bptt_chain": train_kernel_rows["lstm_bptt_chain"][
                "max_abs_diff"],
            "disc_conv_fwd": train_kernel_rows["disc_conv_fwd"][
                "max_abs_pooled_diff"],
            "disc_conv_bwd_dx": max(train_kernel_rows["disc_conv_bwd_dx"][
                k] for k in ("raw_max_abs_dx_diff", "raw_max_abs_db_diff"))}
    out = []
    for name, tpu in TRAIN_TPU_KERNELS.items():
        # the step's route of the conv backward: from the raw gradient
        t = train_times[name + ("_raw" if name == "disc_conv_bwd_dx"
                                else "")]
        out.append({
            "name": name, "route": "cuda",
            "source": "gan_image_captioning_tpu_torch/kernels/csrc/"
                      + TRAIN_SOURCES[name],
            "replaces": tpu, "launches": launches[name],
            "max_abs_err": errs[name], "ms": min(t["kernel_ms"]),
            "plain_ms": min(t["plain_ms"]), "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None, "B": t["B"],
            "card": smi})
        if name == "disc_conv_bwd_dx":
            # the entry from the masked gradient (the JAX kernel's
            # signature), off the step's route
            r, k = train_times[name], train_kernel_rows[name]
            out[-1].update({"ms_masked": min(r["kernel_ms"]),
                            "plain_ms_masked": min(r["plain_ms"]),
                            "bound_ms_masked": r["bound_ms"],
                            "max_abs_err_masked": k["max_abs_dx_diff"]})
    return out


# ------------------------------------------------ conditional captioning

IMG_S = 256
NORM_ATOL, ENC_RTOL, STAT_RTOL = 1e-6, 1e-4, 1e-4
NORM_TPU_KERNEL = "gan_image_captioning_tpu/kernels/image_norm.py:34"
COND_FLAGS = ["--preset", "config2", "--beam-size", "1", *MODEL_FLAGS,
              "--image-size", str(IMG_S)]


def seeded_u8(shape, seed, device):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, shape, dtype=np.uint8)).to(device)


def norm_work(n):
    """image_norm: one byte read and four written per element; a multiply
    and an add."""
    return 5 * n, 2 * n


def phase_image_norm_kernel(device):
    """The image_norm kernel against its plain version, with one launch
    per call; times at B = 64, 256 x 256."""
    from gan_image_captioning_tpu_torch.kernels import image_norm as inorm

    rows = []
    big = seeded_u8((3 * 3 * 37 * 37 + 1,), 37, device)
    cases = [("b64", seeded_u8((B_TRAIN, 3, IMG_S, IMG_S), 64, device)),
             ("odd", seeded_u8((3, 3, 37, 37), 3, device)),
             ("offset_view", big[1:].view(3, 3, 37, 37))]
    for name, u8 in cases:
        inorm.normalize_images.launches = 0
        out_k = inorm.normalize_images(u8)
        torch.cuda.synchronize()
        launches = inorm.normalize_images.launches
        out_p = inorm.normalize_images_plain(u8)
        row = {"case": name, "shape": list(u8.shape), "launches": launches,
               "max_abs_diff": float((out_k - out_p).abs().max()),
               "bit_equal": bool(torch.equal(out_k, out_p)),
               "finite": bool(torch.isfinite(out_k).all())}
        rows.append(row)
        emit({"phase": "image_norm_kernel", **row})
        check(launches == 1, f"image_norm launches {launches} != 1")
        check(row["finite"] and row["max_abs_diff"] <= NORM_ATOL,
              f"image_norm {row}")

    u8 = cases[0][1]
    scale, shift = inorm._affine(device)
    lib = torch.addcmul(shift, u8, scale)
    lib_err = float((lib - inorm.normalize_images_plain(u8)).abs().max())
    kern = lambda: inorm.normalize_images(u8)               # noqa: E731
    plain = lambda: inorm.normalize_images_plain(u8)       # noqa: E731
    library = lambda: torch.addcmul(shift, u8, scale)      # noqa: E731
    # the plain version's handful of launches a call outpaces the host
    # behind the spin: CUDA events at the host's pace, an upper bound
    p_a = cuda_ms(plain, reps=20)
    k_a, l_a = (device_ms(f, 50) for f in (kern, library))
    l_b, k_b = (device_ms(f, 50) for f in (library, kern))
    p_b = cuda_ms(plain, reps=20)
    nbytes, flops = norm_work(u8.numel())
    b_ms, b_by = bound(nbytes, flops)
    times = {"kernel_ms": [k_a, k_b], "plain_ms": [p_a, p_b],
             "timer": "device_ms (plain: cuda_ms)",
             "library_ms": [l_a, l_b], "library": "torch.addcmul(shift, u8, "
             "scale), [1, 3, 1, 1] float32 operands",
             "library_max_abs_diff": lib_err, "bound_ms": b_ms,
             "bound_by": b_by, "bytes": nbytes, "flop": flops,
             "shape": list(u8.shape)}
    emit({"phase": "image_norm_kernel", **times})
    return {"rows": rows, "times": times}


def phase_cond_service(device):
    """config2's conditional service, seeded: the device part of an image
    request on both engines against the full-T kernel decode of the same
    features, with the decode kernels' launch counts; the encoder on the
    card against the CPU; request latency."""
    from gan_image_captioning_tpu_torch import serve
    from gan_image_captioning_tpu_torch.data.synthetic import synthetic_vocab
    from gan_image_captioning_tpu_torch.eval.decode import masked_logprob_sum
    from gan_image_captioning_tpu_torch.eval.metrics import (ids_to_words,
                                                             strip_caption)
    from gan_image_captioning_tpu_torch.kernels.decode_sample import (
        decode_sample, decode_sample_carry)
    from gan_image_captioning_tpu_torch.models import encoder as encoder_lib

    i2w = synthetic_vocab()[1]
    images = {n: seeded((n, 3, IMG_S, IMG_S), 500 + n,
                        torch.device("cpu")).numpy() for n in (1, 8)}
    out = {}
    for engine in ("coalescing", "continuous"):
        extra = [] if engine == "coalescing" else ["--serve-continuous"]
        service = serve.CaptionService(serve.parse_args(
            ["--init-seed", "0", *COND_FLAGS, *extra]))
        try:
            counter = (decode_sample if engine == "coalescing"
                       else decode_sample_carry)
            stats = (service.batcher.stats if engine == "coalescing"
                     else service.continuous.stats)
            calls0 = stats()["device_calls"]
            counter.launches = 0
            resps = {n: service.caption_images(images[n]) for n in (1, 8)}
            launches = counter.launches
            calls = stats()["device_calls"] - calls0
            row = {"engine": engine, "launches": launches,
                   "device_calls": calls,
                   "latency_ms": {n: r["latency_ms"]
                                  for n, r in resps.items()}}
            for n, resp in resps.items():
                feats = torch.from_numpy(service.features_from_images(
                    images[n])).to(device)
                ids_r, lps_r = continuous_reference(service.dec_params, feats)
                want = [" ".join(ids_to_words(strip_caption(r.tolist()), i2w))
                        for r in ids_r]
                want_lp = masked_logprob_sum(ids_r, lps_r).tolist()
                check(resp["captions"] == want,
                      f"{engine} N={n}: captions differ from the kernel "
                      f"decode: {resp['captions']} vs {want}")
                lp_diff = max(abs(a - b) for a, b in zip(resp["logprobs"],
                                                        want_lp))
                check(lp_diff <= SEQ_ATOL, f"{engine} N={n}: lp {lp_diff}")
                row[f"n{n}"] = {"distinct_captions": len(set(want)),
                                "distinct_logprobs": len(set(
                                    resp["logprobs"])),
                                "max_abs_seq_lp_diff": lp_diff,
                                "caption_0": want[0]}
            check(launches > 0 and launches == calls,
                  f"{engine}: decode launches {launches} != device_calls "
                  f"{calls}")
            if engine == "coalescing":
                # the encoder on the card against the same module on the CPU
                enc_cpu = copy.deepcopy(service.generator.encoder).cpu()
                with torch.no_grad():
                    f_cpu = encoder_lib.encode(
                        enc_cpu, torch.from_numpy(images[8]), service.config,
                        train=False)
                f_dev = torch.from_numpy(service.features_from_images(
                    images[8]))
                rel = float((f_dev - f_cpu).abs().max() / f_cpu.abs().max())
                row["encoder_card_vs_cpu_rel"] = rel
                check(rel <= ENC_RTOL, f"encoder card vs CPU: {rel}")
            lat = {}
            for n in (1, 8):
                ms = [service.caption_images(images[n])["latency_ms"]
                      for _ in range(20)]
                lat[n] = {"p50_ms": float(np.percentile(ms, 50)),
                          "p90_ms": float(np.percentile(ms, 90)),
                          "samples": len(ms)}
            row["request_latency"] = lat
        finally:
            service.close()
        emit({"phase": "cond_service", **row,
              "note": f"caption_images: normalized {IMG_S} x {IMG_S} images in, one "
                      "eval-mode encoder pass, greedy decode; host clock"})
        out[engine] = row
    return out


COND_COUNTERS = COUNTERS + ("image_norm",)


def cond_counters():
    from gan_image_captioning_tpu_torch.kernels import image_norm as inorm

    return {**counters(), "image_norm": inorm.normalize_images}


def cond_setup(device, **overrides):
    """config3 + --conditional-gan 1 at bench.py's geometry, float32, with
    un-swept initial weights, B = 64 captions and seeded uint8 images."""
    from gan_image_captioning_tpu_torch.config import Config
    from gan_image_captioning_tpu_torch.data.loader import make_batch
    from gan_image_captioning_tpu_torch.models import api
    from gan_image_captioning_tpu_torch.models.generator import (
        init_generator_params)
    from gan_image_captioning_tpu_torch.train.state import create_train_state
    from gan_image_captioning_tpu_torch.train.steps import batch_to

    config = Config(vocab_size=V, gen_embed_dim=E, gen_hidden_dim=H,
                    gen_num_layers=NL, max_seq_len=MAX_SEQ_LEN,
                    disc_embed_dim=DISC_E, disc_num_rep=DISC_R,
                    disc_filter_sizes=tuple(f for _, f in BANKS),
                    disc_num_filters=tuple(n for n, _ in BANKS),
                    disc_train_freq=DISC_EVERY, conditional_gan=1,
                    image_size=IMG_S, **overrides)
    gen = init_generator_params(torch.Generator().manual_seed(0), config,
                                device, sweep=False)
    disc = api.init_discriminator(torch.Generator().manual_seed(1), config,
                                  device, sweep=False)
    state = create_train_state(config, 0, device, gen=gen, disc=disc)
    caps = [np.random.default_rng(i).integers(4, min(11000, V), size=30)
            for i in range(B_TRAIN)]
    imgs = [np.random.default_rng(1000 + i).integers(
        0, 256, (3, IMG_S, IMG_S), dtype=np.uint8) for i in range(B_TRAIN)]
    batch = batch_to(make_batch(caps, imgs, T), device)
    check("images_u8" in batch, "the batch is not uint8")
    return config, state, batch


def running_stats(gen):
    return {k: v.detach().clone() for k, v in gen.state_dict().items()
            if "running" in k}


def restore_stats(gen, stats):
    sd = gen.state_dict()
    with torch.no_grad():
        for k, v in stats.items():
            sd[k].copy_(v)


def stats_rel_err(a, b):
    return max(float((a[k] - b[k]).abs().max())
               / max(float(b[k].abs().max()), 1e-30) for k in b)


def cond_grads(kind, config, state, batch, noise):
    """One forward and backward of a conditional step without the update:
    ``(g_loss, d_loss, gen_grads, disc_grads, aux)`` like ``adv_grads``
    (the MLE kinds fill the generator side only)."""
    from gan_image_captioning_tpu_torch.train import steps

    if kind == "adv":
        return steps.adv_grads(config, state, batch, TEMP, noise)
    cfg = config.replace(mle_objective=kind.split("_")[1])
    loss = steps.mle_loss(cfg, state, batch)
    gen_grads, = steps._grads(loss, state.gen)
    return loss.detach(), loss.detach() * 0, gen_grads, {}, {
        "gen_ids": torch.zeros(1)}


def float64_copy(config, state, batch, noise):
    """The state's models, the batch (its images normalized by the plain
    version) and the fed noise in float64, for a reference gradient."""
    import dataclasses

    from gan_image_captioning_tpu_torch.kernels.image_norm import (
        normalize_images_plain)

    state64 = dataclasses.replace(state,
                                  gen=copy.deepcopy(state.gen).double(),
                                  disc=copy.deepcopy(state.disc).double())
    batch64 = {k: v for k, v in batch.items() if k != "images_u8"}
    batch64["images"] = normalize_images_plain(batch["images_u8"]).double()
    batch64["weights"] = batch["weights"].double()
    noise64 = {"uniforms": noise["uniforms"].double(), "keep": noise["keep"]}
    return state64, batch64, noise64


def compare_routes(kind, config, state, batch):
    """A step's losses, gradients and new running statistics through the
    kernels against the plain route, from the same state and noise; for
    the adversarial step also both routes against the plain route in
    float64 (the conv pools at the kernel route's rows in both)."""
    from gan_image_captioning_tpu_torch.kernels import disc_conv

    noise = fed_noise(config, device=batch["captions"].device)
    plain_cfg = config.replace(decode_impl="plain", disc_engine="plain",
                               image_norm_impl="plain")
    start = running_stats(state.gen)
    with disc_conv.argmax_record() as rows:
        kern = cond_grads(kind, config, state, batch, noise)
    stats_k = running_stats(state.gen)
    restore_stats(state.gen, start)
    with disc_conv.argmax_replay(rows) as report:
        plain = cond_grads(kind, plain_cfg, state, batch, noise)
    stats_p = running_stats(state.gen)
    restore_stats(state.gen, start)
    cmp = compare_grads(kern, plain)
    cmp["stats_rel_err"] = stats_rel_err(stats_k, stats_p)
    cmp["stats_moved"] = any(not torch.equal(stats_k[k], start[k])
                             for k in start)
    if kind == "adv":
        cmp["argmax_gap"] = max([g for g, _ in report] or [0.0])
        with disc_conv.argmax_replay(rows):
            ref = cond_grads(kind, plain_cfg,
                             *float64_copy(config, state, batch, noise))
        cmp["kernel_vs_float64"] = compare_grads(kern, ref)[
            "grad_side_rel_err"]
        cmp["plain_vs_float64"] = compare_grads(plain, ref)[
            "grad_side_rel_err"]
    return cmp


def routes_agree(cmp):
    """Each side's gradients within GRAD_RTOL of the side's largest
    gradient; or, for the adversarial step, the kernel route no further
    from the float64 plain route than twice the float32 plain route."""
    for side, err in cmp["grad_side_rel_err"].items():
        if err <= GRAD_RTOL:
            continue
        if "kernel_vs_float64" not in cmp:
            return False
        if (cmp["kernel_vs_float64"][side]
                > 2 * cmp["plain_vs_float64"][side]):
            return False
    return True


def phase_cond_train(device):
    """Conditional MLE (free, teacher) and adversarial steps on uint8
    batches with the launch counts; each against the plain route; a
    trainable-backbone step; times and the profile."""
    from gan_image_captioning_tpu_torch.kernels import image_norm as inorm
    from gan_image_captioning_tpu_torch.models import encoder as encoder_lib
    from gan_image_captioning_tpu_torch.train.steps import (make_adv_step,
                                                            make_mle_step)

    config, state, batch = cond_setup(device)
    steps = {"mle_free": make_mle_step(config),
             "mle_teacher": make_mle_step(config.replace(
                 mle_objective="teacher")),
             "adv": make_adv_step(config)}
    stats0 = running_stats(state.gen)
    conv1 = state.gen.encoder.resnet.conv1.weight.detach().clone()
    cnt = cond_counters()
    for fn in cnt.values():
        fn.launches = 0
    metrics = []
    t0 = time.perf_counter()
    for kind in ("mle_free", "mle_free", "mle_teacher", "mle_teacher", "adv",
                 "adv"):
        args = (TEMP,) if kind == "adv" else ()
        state, m = steps[kind](state, batch, *args)
        metrics.append({"step": kind, **{k: float(v) for k, v in m.items()}})
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in cnt.items()}
    # the free steps' rescore and the teacher steps' pass run the reverse
    # recurrence once per layer
    expected = {**{k: 0 for k in COND_COUNTERS}, "image_norm": 6,
                "decode_serve": 2, "decode_sample_resid": 2,
                "lstm_bptt_chain": 2, "disc_conv_fwd": 6,
                "disc_conv_bwd_dx": 6, "lstm_bptt_reverse": 4 * NL}
    row = {"metrics": metrics, "launches": launches,
           "expected_launches": expected, "seconds": seconds,
           "stats_moved_max_abs": max(
               float((v - stats0[k]).abs().max())
               for k, v in running_stats(state.gen).items()),
           "frozen_backbone_unchanged": bool(torch.equal(
               state.gen.encoder.resnet.conv1.weight, conv1))}
    emit({"phase": "cond_train", **row})
    check(all(math.isfinite(v) for m in metrics for k, v in m.items()
              if k != "step"), "non-finite conditional metric")
    check(launches == expected, f"launches {launches} != {expected}")
    check(row["stats_moved_max_abs"] > 0, "running statistics did not move")
    check(row["frozen_backbone_unchanged"], "the frozen backbone moved")

    routes = {}
    for kind in ("mle_free", "mle_teacher", "adv"):
        cmp = compare_routes(kind, config, state, batch)
        routes[kind] = cmp
        worst = sorted(cmp["grad_rel_err"].items(), key=lambda kv: -kv[1])[:3]
        emit({"phase": "cond_train", "kernels_vs_plain": kind,
              "g_loss": cmp["g_loss"], "d_loss": cmp["d_loss"],
              "ids_equal": cmp["ids_equal"],
              "max_grad_rel_err": cmp["max_grad_rel_err"], "worst": worst,
              "grad_side_rel_err": cmp["grad_side_rel_err"],
              **{k: cmp[k] for k in ("argmax_gap", "kernel_vs_float64",
                                     "plain_vs_float64") if k in cmp},
              "stats_rel_err": cmp["stats_rel_err"],
              "stats_moved": cmp["stats_moved"]})
        for name in ("g_loss", "d_loss"):
            a, b = cmp[name]
            check(abs(a - b) <= LOSS_RTOL * max(abs(b), 1e-30),
                  f"{kind} {name} {a} vs {b}")
        check(cmp["ids_equal"], f"{kind}: the routes sampled different ids")
        check(routes_agree(cmp), f"{kind}: {cmp['grad_side_rel_err']}, "
              f"{cmp.get('kernel_vs_float64')}, "
              f"{cmp.get('plain_vs_float64')}, {worst}")
        check(cmp["stats_moved"] and cmp["stats_rel_err"] <= STAT_RTOL,
              f"{kind}: running statistics {cmp['stats_rel_err']}")

    # --trainable-backbone 1: one adversarial step, and against plain
    cfg_t, state_t, batch_t = cond_setup(device, trainable_backbone=1)
    cmp = compare_routes("adv", cfg_t, state_t, batch_t)
    check(any(k.startswith("gen.encoder.resnet.")
              for k in cmp["grad_rel_err"]),
          "no backbone gradient under --trainable-backbone 1")
    worst = sorted(cmp["grad_rel_err"].items(), key=lambda kv: -kv[1])[:3]
    check(routes_agree(cmp), f"trainable: {cmp['grad_side_rel_err']}, "
          f"{cmp.get('kernel_vs_float64')}, {cmp.get('plain_vs_float64')}, "
          f"{worst}")
    check(cmp["stats_rel_err"] <= STAT_RTOL, f"trainable stats {cmp}")
    conv1 = state_t.gen.encoder.resnet.conv1.weight.detach().clone()
    inorm.normalize_images.launches = 0
    state_t, m = make_adv_step(cfg_t)(state_t, batch_t, TEMP)
    torch.cuda.synchronize()
    moved = not torch.equal(state_t.gen.encoder.resnet.conv1.weight, conv1)
    trainable = {"max_grad_rel_err": cmp["max_grad_rel_err"], "worst": worst,
                 "grad_side_rel_err": cmp["grad_side_rel_err"],
                 "kernel_vs_float64": cmp["kernel_vs_float64"],
                 "plain_vs_float64": cmp["plain_vs_float64"],
                 "stats_rel_err": cmp["stats_rel_err"],
                 "backbone_moved": moved,
                 "image_norm_launches": inorm.normalize_images.launches,
                 "metrics": {k: float(v) for k, v in m.items()}}
    emit({"phase": "cond_train", "trainable_backbone": trainable})
    check(moved and trainable["image_norm_launches"] == 1,
          f"trainable step {trainable}")
    del state_t, batch_t

    # ms per step, kernel route against plain route, in turns
    plain_cfg = config.replace(decode_impl="plain", disc_engine="plain",
                               image_norm_impl="plain")
    times = {}
    for kind in ("mle_free", "mle_teacher", "adv"):
        fns = {}
        for route, cfg in (("kernel", config), ("plain", plain_cfg)):
            if kind == "adv":
                step = make_adv_step(cfg)
                fns[route] = lambda step=step: step(state, batch, TEMP)
            else:
                step = make_mle_step(cfg.replace(
                    mle_objective=kind.split("_")[1]))
                fns[route] = lambda step=step: step(state, batch)
        p_a = step_ms(fns["plain"], 2)
        k_a = step_ms(fns["kernel"], 4)
        k_b = step_ms(fns["kernel"], 4)
        p_b = step_ms(fns["plain"], 2)
        times[kind] = {"kernel_ms": [k_a, k_b], "plain_ms": [p_a, p_b]}
        emit({"phase": "cond_train", "timing": kind, "B": B_TRAIN,
              **times[kind]})
    # the encoder pass alone (image_norm + train-mode ResNet-18 + head);
    # then it and the adversarial step with cuDNN's TF32 convolutions,
    # PyTorch's default outside this script
    def encoder_pass():
        return encoder_lib.encode(state.gen.encoder,
                                  inorm.normalize_images(batch["images_u8"]),
                                  config, train=True)

    enc_ms = cuda_ms(encoder_pass, reps=5)
    torch.backends.cudnn.allow_tf32 = True
    try:
        enc_tf32 = cuda_ms(encoder_pass, reps=5)
        adv_tf32 = step_ms(lambda: steps["adv"](state, batch, TEMP), 4)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    enc = {"encoder_ms": enc_ms,
           "share_of_step": {k: enc_ms / min(v["kernel_ms"])
                             for k, v in times.items()},
           "cudnn_tf32": {"encoder_ms": enc_tf32, "adv_step_ms": adv_tf32,
                          "share_of_adv_step": enc_tf32 / adv_tf32}}
    emit({"phase": "cond_train", "encoder_pass": enc})
    prof = profile_calls(lambda: steps["adv"](state, batch, TEMP), 3,
                         KERNEL_NAMES + ("image_norm",))
    emit({"phase": "cond_train", "profile": "adv", **prof})
    return {"launches": launches, "routes": routes, "times": times,
            "encoder": enc, "profile": prof, "trainable": trainable}


def phase_loop(device, workdir):
    """``main.main`` in this process: one pretrain and one adversarial
    epoch of conditional synthetic data at the bench geometry; then both
    checkpoints through the conditional service."""
    import shutil

    from gan_image_captioning_tpu_torch import main as train_main
    from gan_image_captioning_tpu_torch import serve

    save = workdir / "loop"
    shutil.rmtree(save, ignore_errors=True)
    geometry = ["--preset", "config3", "--conditional-gan", "1",
                *MODEL_FLAGS, "--image-size", str(IMG_S),
                "--disc-embed-dim", str(DISC_E), "--disc-num-rep", str(DISC_R),
                "--disc-filter-sizes", ",".join(str(f) for _, f in BANKS),
                "--disc-num-filters", ",".join(str(n) for n, _ in BANKS)]
    argv = [*geometry, "--synthetic-items", "256", "--pretrain-epochs", "1",
            "--adv-epochs", "1", "--save-dir", str(save), "--expt-name",
            "smoke"]
    cnt = cond_counters()
    for fn in cnt.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as log:
        inst = train_main.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in cnt.items()}
    rows = [json.loads(ln) for ln in open(Path(inst.config.save_dir)
                                          / "metrics.jsonl")]
    losses = [r for r in rows if r["tag"].endswith("_loss")]
    row = {"seconds": seconds, "launches": launches,
           "pretrain_steps": inst.pretrain_steps,
           "gen_steps": inst.state.gen_steps,
           "disc_steps": inst.state.disc_steps,
           "temperature": inst.state.temperature,
           "logged_losses": len(losses),
           "all_finite": all(math.isfinite(r["value"]) for r in rows),
           "log_tail": log.getvalue().splitlines()[-4:]}
    for kernel in ("decode_serve", "decode_sample_resid", "lstm_bptt_chain",
                   "disc_conv_fwd", "disc_conv_bwd_dx", "lstm_bptt_reverse"):
        check(launches[kernel] > 0, f"loop: {kernel} never launched")
    check(row["all_finite"] and len(losses) > 0, "loop: non-finite metric")
    check(inst.pretrain_steps == 4 and inst.state.gen_steps == 4,
          f"loop counters {row}")
    images = seeded((2, 3, IMG_S, IMG_S), 900, torch.device("cpu")).numpy()
    served = {}
    for name in ("pretrained_model.ckpt", "adv_model.ckpt"):
        path = Path(inst.config.model_dir) / name
        check(path.is_file(), f"loop: {name} missing")
        service = serve.CaptionService(serve.parse_args(
            ["--checkpoint", str(path), *geometry]))
        try:
            resp = service.caption_images(images)
        finally:
            service.close()
        check(len(resp["captions"]) == 2
              and all(math.isfinite(x) for x in resp["logprobs"]),
              f"loop: {name} served {resp}")
        served[name] = resp
    row["served"] = served
    emit({"phase": "loop", **row})
    return row


# ------------------------------------------- the transformer GAN (config4)

TF_D, TF_MLP, TF_NL, TF_HEADS = 256, 256, 4, 8
TF_DISC_E, TF_DISC_D, TF_DISC_NL, TF_DISC_HEADS = 64, 128, 4, 8
TF_ROLLOUT_NUM, TF_ROLLOUT_STRIDE = 4, 4
FLASH_OUT_ATOL, FLASH_GRAD_RTOL, GUMBEL_SOFT_ATOL = 2e-6, 1e-5, 1e-6
HIST_ATOL = 0.01
FLASH_TPU = "gan_image_captioning_tpu/kernels/flash_attention.py"
TF_TPU_KERNELS = {"flash_fwd": f"{FLASH_TPU}:81",
                  "flash_dq": f"{FLASH_TPU}:156",
                  "flash_dkv": f"{FLASH_TPU}:193",
                  "gumbel_sample": "gan_image_captioning_tpu/kernels/"
                                   "gumbel_sample.py:36"}
TF_SOURCES = {"flash_fwd": "flash_attention.cu",
              "flash_dq": "flash_attention.cu",
              "flash_dkv": "flash_attention.cu",
              "gumbel_sample": "gumbel_sample.cu"}
TF_MODEL_FLAGS = ["--preset", "config4", "--dataset", "synthetic",
                  "--vocab-multiple", str(V),
                  "--max-seq-len", str(MAX_SEQ_LEN)]
# launches per step by design (disc_train_freq 1): the MLE step is one
# causal pass over the generator's 4 layers and its backward; a REINFORCE
# step samples T = 36 steps through the Gumbel kernel and runs the
# discriminator's 4 layers forward for real and sampled ids (2 passes, with
# backward), for each of the 8 rollout prefixes and the full sequence
# (9 passes) and for the greedy baseline (1), then the generator's 4
# layers for the log-probs (with backward); each backward is one launch
# (the fused kernel at T <= 64, D <= 64; the tiled one past them)
TF_PER_MLE_STEP = {"flash_fwd": TF_NL, "flash_bwd": TF_NL,
                   "gumbel_sample": 0}
TF_PREFIXES = len(range(TF_ROLLOUT_STRIDE, T, TF_ROLLOUT_STRIDE))
TF_PER_RL_STEP = {"gumbel_sample": T,
                  "flash_fwd": TF_DISC_NL * (2 + TF_PREFIXES + 1 + 1) + TF_NL,
                  "flash_bwd": 2 * TF_DISC_NL + TF_NL}


def tf_counters():
    from gan_image_captioning_tpu_torch.kernels import flash_attention as fa
    from gan_image_captioning_tpu_torch.kernels import gumbel_sample as gs

    return {"flash_fwd": fa.flash_fwd, "flash_bwd": fa.flash_bwd,
            "gumbel_sample": gs.gumbel_sample}


def attention_pairs(b, t, h, causal, lengths):
    """(query, key) pairs the mask lets through, over all heads."""
    i = torch.arange(t)
    ok = torch.ones((b, t, t), dtype=torch.bool)
    if causal:
        ok &= (i[None, :] <= i[:, None])[None]
    if lengths is not None:
        ok &= (i[None, None, :] < lengths.cpu()[:, None, None])
    return int(ok.sum()) * h


def flash_work(kind, b, t, h, d, pairs):
    """Bytes (each input read once, each output written once) and float
    operations of one flash kernel call."""
    x, vec = 4 * b * t * h * d, 4 * b * t * h
    if kind == "flash_fwd":      # q, k, v in; out, lse out
        return 4 * x + vec, 4 * d * pairs
    # the whole backward (fused or tiled): q, k, v, dO, out, lse in; dq,
    # dk, dv out; five products of D a pair
    return 8 * x + vec, 10 * d * pairs


def tiled_bwd_bound(b, t, h, d, pairs, bf16):
    """The tiled backward's bound (ms, what bounds it): its bytes (float32
    or bfloat16 q, k, v, dO, out, dq, dk, dv; float32 lse) at 3.35 TB/s,
    or its products at the card's rate for their operands: S and dP (4 D a
    pair) at 989 TFLOP/s on bfloat16 operands, as 3xTF32 (three TF32
    products at 495) on float32 ones; dV, dK and dQ (6 D a pair) have the
    float32 P or dS as an operand: two TF32 products on bfloat16 (the other
    operand is exact in TF32), three on float32."""
    esz = 2 if bf16 else 4
    nbytes = 8 * esz * b * t * h * d + 4 * b * t * h
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = d * pairs * ((4 / BF16_FLOP_PER_S + 12 / TF32_FLOP_PER_S) if bf16
                         else 30 / TF32_FLOP_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


SPIN_CYCLES = 100_000_000   # about 50 ms of one SM's clock


def device_ms(fn, calls=20):
    """Device time per call of ``fn``: ``calls`` calls enqueued behind a
    spin kernel (``torch.cuda._sleep``), so that they run back to back on
    the device whatever the host's pace, timed with CUDA events.  CUDA
    events around calls issued one after another would measure the host's
    pace for calls of a few tens of microseconds.  A measurement where
    enqueueing outlasted the spin (the device would have waited for the
    host) is not taken: it is made once more behind a spin long enough for
    the pace just seen, and fails if enqueueing outlasts that one too; so
    does a function of more launches than the card's launch queue holds
    (about a thousand), which blocks the host until the spin ends."""
    fn()
    torch.cuda.synchronize()
    spin0 = torch.cuda.Event(enable_timing=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = SPIN_CYCLES
    for attempt in range(2):
        spin0.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        spin_ms = spin0.elapsed_time(start)
        if host_ms < spin_ms:
            return start.elapsed_time(end) / calls
        cycles = int(cycles * 2 * host_ms / spin_ms) + 1
    check(False, f"enqueueing {calls} calls took {host_ms} ms, longer than "
          f"the {spin_ms} ms spin")


# the long captions of --max-seq-len 126 (seq_len 128: paragraph-length
# captions of up to 126 words): past T = 64 every transformer backward
# takes the tiled kernel
LONG_MAX_SEQ_LEN = 126
LONG_T = LONG_MAX_SEQ_LEN + 2


def long_caption_cases(device, rng):
    """The flash cases of the long captions → ``{name: (shape, causal,
    lengths, route)}``: config4's generator MLE pass [64, 129, 8, 32]
    (causal, the captions' lengths + 1), its discriminator [64, 128, 8, 16]
    and rollouts [256, 128, 8, 16] (full), and config5's generator [64,
    129, 12, 64] (causal, lengths + 1); every one on the tiled route."""
    lens = torch.from_numpy(rng.integers(3, LONG_T + 1, B_TRAIN).astype(
        np.int32) + 1).to(device)
    hd, dd = TF_D // TF_HEADS, TF_DISC_D // TF_DISC_HEADS
    return {"long_gen": ((B_TRAIN, LONG_T + 1, TF_HEADS, hd), True, lens,
                         "tiled"),
            "long_disc": ((B_TRAIN, LONG_T, TF_DISC_HEADS, dd), False, None,
                          "tiled"),
            "long_rollout": ((B_TRAIN * TF_ROLLOUT_NUM, LONG_T,
                              TF_DISC_HEADS, dd), False, None, "tiled"),
            "long_c5_gen": ((B_TRAIN, LONG_T + 1, C5_HEADS, C5_HD), True,
                            lens, "tiled")}


def phase_tf_kernels(device):
    """The four kernels against their plain versions at config4's shapes:
    flash forward and backward at the three masks (the generator's MLE
    pass, causal with lengths + 1; its log-prob pass, causal; the
    discriminator, full, at B = 64 and the rollouts' 256: the fused
    kernels; causal with lengths at [2, 200, 2, 24], and the long captions
    of ``--max-seq-len 126`` (``long_caption_cases``): the tiled kernels,
    as the C side reports their launches), and the Gumbel
    sampler on fed uniforms and on its Philox draw; their device times
    (``device_ms``) beside the plain versions', the bounds and
    scaled_dot_product_attention's, and the per-call rate of calls issued
    one after another (CUDA events)."""
    import torch.nn.functional as F

    from gan_image_captioning_tpu_torch.kernels import flash_attention as fa
    from gan_image_captioning_tpu_torch.kernels import gumbel_sample as gs
    from gan_image_captioning_tpu_torch.kernels.decode_sample import (
        decode_sample_resid)

    rng = np.random.default_rng(55)
    lens_gen = torch.from_numpy(rng.integers(3, T + 1, B_TRAIN).astype(
        np.int32) + 1).to(device)
    # a shape past the fused forward (T > 64): the tiled forward, causal
    # with key lengths
    lens_tiled = torch.from_numpy(rng.integers(1, 201, 2).astype(
        np.int32)).to(device)
    hd, dd = TF_D // TF_HEADS, TF_DISC_D // TF_DISC_HEADS
    # (flash_fwd_fused_kernel up to D = 32, flash_fwd_fused64_kernel past)
    kernel_names = {"fused": "flash_fwd_fused", "tiled": "flash_fwd_kernel"}
    cases = {"gen_mle": ((B_TRAIN, T + 1, TF_HEADS, hd), True, lens_gen,
                         "fused"),
             "gen_logprob": ((B_TRAIN, T + 1, TF_HEADS, hd), True, None,
                             "fused"),
             "disc": ((B_TRAIN, T, TF_DISC_HEADS, dd), False, None, "fused"),
             "disc_rollout": ((B_TRAIN * TF_ROLLOUT_NUM, T, TF_DISC_HEADS, dd),
                              False, None, "fused"),
             "tiled_t200": ((2, 200, 2, 24), True, lens_tiled, "tiled"),
             # GPT-2's head dim (the column-half kernels) and one past it
             "fused_d64": ((8, T + 1, C5_HEADS, C5_HD), True, lens_gen[:8],
                           "fused"),
             "tiled_d72": ((2, T + 1, 2, 72), True, lens_gen[:2], "tiled"),
             **long_caption_cases(device, rng)}
    cnt = tf_counters()
    rows, times = {}, {}
    for name, (shape, causal, lens, want) in cases.items():
        q, k, v = (seeded(shape, 60 + i, device).requires_grad_(True)
                   for i in range(3))
        g = seeded(shape, 63, device)
        for fn in cnt.values():
            fn.launches = 0
        out = fa.flash_attention(q, k, v, causal, lens)
        grads = torch.autograd.grad(out, (q, k, v), g)
        torch.cuda.synchronize()
        launches = {n: cnt[n].launches for n in ("flash_fwd", "flash_bwd")}
        bwd_ran = fa.flash_bwd.last_kernel
        ref = fa.attention_plain(q, k, v, causal, lens)
        ref_grads = torch.autograd.grad(ref, (q, k, v), g)
        qd, kd, vd = (x.detach() for x in (q, k, v))
        again = fa.flash_fwd(qd, kd, vd, causal, lens)
        # the kernel the C side launched, as it reports it and as the
        # profiler names it (the profiler drops every event at times in a
        # long process: its names are checked where it saw the launch)
        ran = fa.flash_fwd.last_kernel
        seen = forward_kernels(lambda: fa.flash_fwd(qd, kd, vd, causal,
                                                    lens))
        bwd_again = [fa.flash_bwd(qd, kd, vd, again[0], g, again[1], causal,
                                  lens) for _ in range(2)]
        row = {"shape": list(shape), "causal": causal,
               "lengths": lens is not None, "launches": launches,
               "forward_kernel": ran, "profiler_forward_kernels": seen,
               "backward_kernel": bwd_ran,
               "max_abs_out_diff": float((out - ref).detach().abs().max()),
               "out_finite": bool(torch.isfinite(out).all()),
               "forward_bit_equal_repeat": bool(torch.equal(again[0], out)),
               "backward_bit_equal_repeat": all(
                   torch.equal(a, b) and torch.equal(b, c)
                   for a, b, c in zip(grads, *bwd_again))}
        for n, a, b in zip(("dq", "dk", "dv"), grads, ref_grads):
            row[f"{n}_max_abs_diff"] = float((a - b).abs().max())
            row[f"{n}_rel"] = row[f"{n}_max_abs_diff"] / float(b.abs().max())
        emit({"phase": "tf_kernels", "kernel": "flash", "case": name, **row})
        check(launches == {"flash_fwd": 1, "flash_bwd": 1}
              and want == fa.flash_bwd_plan(*shape[1:])["route"],
              f"flash {name}: launches {launches}")
        check(bwd_ran == want and row["backward_bit_equal_repeat"],
              f"flash {name} backward {row}")
        check(ran == want and row["forward_bit_equal_repeat"]
              and (not seen or (len(seen) == 1
                                and kernel_names[want] in seen[0])),
              f"flash {name} {row}")
        check(row["out_finite"] and row["max_abs_out_diff"] <= FLASH_OUT_ATOL,
              f"flash {name} forward {row}")
        for n in ("dq", "dk", "dv"):
            check(row[f"{n}_rel"] <= FLASH_GRAD_RTOL,
                  f"flash {name} {n} {row}")
        rows[name] = row

        # times: each kernel alone, the whole backward (fused, and the
        # tiled route: delta, dQ, dK/dV), the plain version forward,
        # backward alone and forward + backward, and the library call
        # likewise (boolean mask, [B, H, T, D] views made contiguous outside
        # the timing)
        o, lse = again
        b_, t_, h_, d_ = shape
        mask = torch.ones((1, 1, t_, t_), dtype=torch.bool, device=device)
        if causal:
            mask = torch.tril(mask)
        if lens is not None:
            mask = mask & (torch.arange(t_, device=device)[None, :]
                           < lens[:, None])[:, None, None, :]
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                      for x in (qd, kd, vd))
        gt = g.transpose(1, 2).contiguous()
        lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        lib_err = float((lib.transpose(1, 2) - ref).detach().abs().max())

        def lib_fwd_bwd():
            o_ = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
            torch.autograd.grad(o_, (qt, kt, vt), gt)

        def plain_fwd_bwd():
            o_ = fa.attention_plain(q, k, v, causal, lens)
            torch.autograd.grad(o_, (q, k, v), g)

        # the backward alone: one forward, then its graph again and again
        plain_o = fa.attention_plain(q, k, v, causal, lens)

        def lib_bwd():
            torch.autograd.grad(lib, (qt, kt, vt), gt, retain_graph=True)

        def plain_bwd():
            torch.autograd.grad(plain_o, (q, k, v), g, retain_graph=True)

        fns = {"flash_fwd": lambda: fa.flash_fwd(qd, kd, vd, causal, lens),
               "flash_bwd": lambda: fa.flash_bwd(qd, kd, vd, o, g, lse,
                                                 causal, lens)}
        with torch.no_grad():
            def plain_f():
                return fa.attention_plain(qd, kd, vd, causal, lens)

            def lib_f():
                return F.scaled_dot_product_attention(
                    qt.detach(), kt.detach(), vt.detach(), attn_mask=mask)

            # device time in turns, and CUDA events around 50 calls issued
            # one after another (the host's pace at these sizes)
            p_a, l_a = device_ms(plain_f), device_ms(lib_f)
            k_ms = {n: [device_ms(f), device_ms(f)] for n, f in fns.items()}
            l_b, p_b = device_ms(lib_f), device_ms(plain_f)
            ev_ms = {n: cuda_ms(f, 50) for n, f in fns.items()}
            ev_ms["plain_fwd"] = cuda_ms(plain_f, 20)
            ev_ms["library_fwd"] = cuda_ms(lib_f, 20)
        pb = [device_ms(plain_fwd_bwd, 10), device_ms(plain_fwd_bwd, 10)]
        lb = [device_ms(lib_fwd_bwd, 10), device_ms(lib_fwd_bwd, 10)]
        pbo = [device_ms(plain_bwd, 10), device_ms(plain_bwd, 10)]
        lbo = [device_ms(lib_bwd, 10), device_ms(lib_bwd, 10)]
        del lib, plain_o
        pairs = attention_pairs(b_, t_, h_, causal, lens)
        t_row = {"kernel_ms": k_ms, "plain_fwd_ms": [p_a, p_b],
                 "plain_fwd_bwd_ms": pb, "library_fwd_ms": [l_a, l_b],
                 "library_fwd_bwd_ms": lb, "plain_bwd_ms": pbo,
                 "library_bwd_ms": lbo, "event_ms_per_call": ev_ms,
                 "library_max_abs_diff": lib_err, "pairs": pairs}
        for n in fns:
            nbytes, flops = flash_work(n, b_, t_, h_, d_, pairs)
            t_row[n] = dict(zip(("bound_ms", "bound_by"), bound(nbytes,
                                                               flops)),
                            bytes=nbytes, flop=flops)
        if want == "tiled":     # the tiled backward's products: TF32 terms
            t_row["flash_bwd"].update(zip(("bound_ms", "bound_by"),
                                          tiled_bwd_bound(b_, t_, h_, d_,
                                                          pairs, False)))
        emit({"phase": "tf_kernels", "timing": "flash", "case": name,
              **t_row})
        times[name] = t_row

    # a batch row with no valid key (the rollouts' shape, lengths 0 and
    # T): out 0 and lse about -1e30, the other row as the plain version
    shape = cases["disc_rollout"][0]
    q0, k0, v0 = (seeded(shape, 64 + i, device) for i in range(3))
    lens0 = torch.tensor([0, T] * (shape[0] // 2), dtype=torch.int32,
                         device=device)
    o0, lse0 = fa.flash_fwd(q0, k0, v0, False, lens0)
    ref0 = fa.attention_plain(q0, k0, v0, False, lens0)
    zero = {"max_abs_out_empty": float(o0[0::2].abs().max()),
            "max_lse_empty": float(lse0[0::2].max()),
            "max_abs_out_diff": float((o0[1::2] - ref0[1::2]).abs().max())}
    # its gradients: dq, dk and dv 0 in the empty rows (every key past the
    # length), finite, the full rows within FLASH_GRAD_RTOL of plain's
    qkv0 = [x.clone().requires_grad_(True) for x in (q0, k0, v0)]
    g0 = seeded(shape, 67, device)
    fa.flash_bwd.launches = 0
    grads0 = torch.autograd.grad(fa.flash_attention(*qkv0, False, lens0),
                                 qkv0, g0)
    torch.cuda.synchronize()
    zero["backward_launches"] = fa.flash_bwd.launches
    zero["backward_kernel"] = fa.flash_bwd.last_kernel
    ref0g = torch.autograd.grad(fa.attention_plain(*qkv0, False, lens0),
                                qkv0, g0)
    zero["max_abs_grad_empty"] = max(float(a[0::2].abs().max())
                                     for a in grads0)
    zero["grads_finite"] = all(bool(torch.isfinite(a).all()) for a in grads0)
    for n, a, b in zip(("dq", "dk", "dv"), grads0, ref0g):
        zero[f"{n}_rel"] = float((a[1::2] - b[1::2]).abs().max()
                                 / b[1::2].abs().max())
    emit({"phase": "tf_kernels", "kernel": "flash", "case": "length_zero",
          **zero})
    check(zero["max_abs_out_empty"] == 0.0 and zero["max_lse_empty"] <= -1e29
          and zero["max_abs_out_diff"] <= FLASH_OUT_ATOL,
          f"flash length 0 {zero}")
    check(zero["backward_launches"] == 1
          and zero["backward_kernel"] == "fused"
          and zero["max_abs_grad_empty"] == 0.0 and zero["grads_finite"]
          and all(zero[f"{n}_rel"] <= FLASH_GRAD_RTOL
                  for n in ("dq", "dk", "dv")),
          f"flash length 0 gradients {zero}")

    # --- the Gumbel sampler at [64, V]: its plan, fed uniforms against the
    # plain version, two calls bit-equal
    logits = seeded((B_TRAIN, V), 70, device, 3.0)
    u = torch.rand((B_TRAIN, V), generator=torch.Generator(
        device=device).manual_seed(71), device=device)
    plan = gs.gumbel_plan(B_TRAIN, V)
    emit({"phase": "tf_kernels", "kernel": "gumbel_sample", "shape":
          [B_TRAIN, V], "plan": plan})
    g_rows = []
    for temp in (1.0, TEMP):
        gs.gumbel_sample.launches = 0
        soft, ids = gs.gumbel_sample(logits, temp, uniforms=u)
        torch.cuda.synchronize()
        launches = gs.gumbel_sample.launches
        soft_r, ids_r = gs.gumbel_sample(logits, temp, uniforms=u)
        soft_p, ids_p = gs.gumbel_sample_plain(logits, temp, u)
        x = (logits - torch.log(-torch.log(u + gs.EPS) + gs.EPS)) * temp
        top2 = x.topk(2, dim=-1).values
        gap = top2[:, 0] - top2[:, 1]
        differ = ids != ids_p
        row = {"temperature": temp, "launches": launches,
               "max_abs_soft_diff": float((soft - soft_p).abs().max()),
               "soft_row_sum_err": float((soft.sum(dim=-1) - 1).abs().max()),
               "ids_differing": int(differ.sum()),
               "ids_differing_outside_ties": int(
                   (differ & (gap > ID_ATOL * temp)).sum()),
               "distinct_ids": int(ids.unique().numel()),
               "bit_equal_repeat": bool(torch.equal(soft, soft_r)
                                        and torch.equal(ids, ids_r))}
        emit({"phase": "tf_kernels", "kernel": "gumbel_sample", **row})
        check(launches == 1, f"gumbel launches {launches}")
        check(row["max_abs_soft_diff"] <= GUMBEL_SOFT_ATOL
              and row["ids_differing_outside_ties"] == 0
              and row["bit_equal_repeat"], f"gumbel {row}")
        g_rows.append(row)

    # Philox: reproducible per (seed, step), the sample_resid decode's
    # stream, the same x (so the same ids and soft) as the kernel fed the
    # uniforms it drew, and categorical in distribution; the ids' digest
    # compares two checkouts (x's rounding is pinned, so a redesign that
    # keeps it gives the same ids)
    u_out = torch.empty_like(u)
    soft_a, ids_a = gs.gumbel_sample(logits, 1.0, seed=99, step=3,
                                     uniforms_out=u_out)
    ids_b = gs.gumbel_sample(logits, 1.0, seed=99, step=3)[1]
    ids_c = gs.gumbel_sample(logits, 1.0, seed=99, step=4)[1]
    soft_f, ids_f = gs.gumbel_sample(logits, 1.0, uniforms=u_out)
    small = {"w_ih": seeded((4 * 8, 8), 72, device),
             "w_hh": seeded((4 * 8, 8), 73, device),
             "b_ih": torch.zeros(32, device=device),
             "b_hh": torch.zeros(32, device=device)}
    u_resid = torch.empty((4, B_TRAIN, V), device=device)
    decode_sample_resid(torch.zeros((B_TRAIN, 8), device=device), [small],
                        torch.zeros((V, 8), device=device),
                        torch.zeros(V, device=device),
                        torch.zeros((V, 8), device=device), 4, seed=99,
                        uniforms_out=u_resid)
    n_hist, v_hist = 1 << 18, 16
    h_logits = torch.linspace(-2, 2, v_hist, device=device)
    h_ids = gs.gumbel_sample(h_logits.expand(n_hist, v_hist).contiguous(),
                             1.0, seed=5)[1]
    hist = torch.bincount(h_ids.long(), minlength=v_hist).double() / n_hist
    want = torch.softmax(h_logits.double(), dim=0)
    torch.cuda.synchronize()
    philox = {"same_seed_same_ids": bool(torch.equal(ids_a, ids_b)),
              "other_step_other_ids": not bool(torch.equal(ids_a, ids_c)),
              "uniforms_equal_sample_resid_step_3": bool(torch.equal(
                  u_out, u_resid[3])),
              "bit_equal_fed_its_uniforms": bool(
                  torch.equal(ids_a, ids_f) and torch.equal(soft_a, soft_f)),
              "ids_sha256": sha256(ids_a),
              "uniform_mean": float(u_out.double().mean()),
              "hist_max_abs_diff": float((hist - want).abs().max()),
              "hist_rows": n_hist, "hist_V": v_hist,
              "hist_plan": gs.gumbel_plan(n_hist, v_hist)}
    emit({"phase": "tf_kernels", "kernel": "gumbel_philox", **philox})
    check(philox["same_seed_same_ids"] and philox["other_step_other_ids"]
          and philox["uniforms_equal_sample_resid_step_3"]
          and philox["bit_equal_fed_its_uniforms"], f"philox {philox}")
    check(abs(philox["uniform_mean"] - 0.5) <= 2e-3
          and philox["hist_max_abs_diff"] <= HIST_ATOL, f"philox {philox}")

    # times at [64, V] and at V - 1 (not a multiple of 4: scalar accesses)
    times["gumbel_sample"] = gumbel_times(gs, logits, u, V)
    odd = seeded((B_TRAIN, V - 1), 74, device, 3.0)
    u_odd = torch.rand((B_TRAIN, V - 1), generator=torch.Generator(
        device=device).manual_seed(75), device=device)
    soft_o, ids_o = gs.gumbel_sample(odd, 1.0, uniforms=u_odd)
    soft_op, _ = gs.gumbel_sample_plain(odd, 1.0, u_odd)
    err_odd = float((soft_o - soft_op).abs().max())
    check(err_odd <= GUMBEL_SOFT_ATOL, f"gumbel V - 1: {err_odd}")
    times["gumbel_sample_odd_v"] = {
        **gumbel_times(gs, odd, u_odd, V - 1), "max_abs_soft_diff": err_odd}
    for key in ("gumbel_sample", "gumbel_sample_odd_v"):
        emit({"phase": "tf_kernels", "timing": key, **times[key]})
    return {"flash": rows, "length_zero": zero, "gumbel": g_rows,
            "philox": philox, "times": times}


def gumbel_times(gs, logits, u, v):
    """device_ms of the sampler on its Philox draw and on fed uniforms, in
    turns with the plain version, and its plan and bound at [B, v]."""
    kern = lambda: gs.gumbel_sample(logits, 1.0, seed=7)        # noqa: E731
    fed = lambda: gs.gumbel_sample(logits, 1.0, uniforms=u)     # noqa: E731
    plain = lambda: gs.gumbel_sample_plain(logits, 1.0, u)      # noqa: E731
    p_a, k_a, f_a = device_ms(plain), device_ms(kern), device_ms(fed)
    f_b, k_b, p_b = device_ms(fed), device_ms(kern), device_ms(plain)
    ev_ms = {"kernel": cuda_ms(kern, 50), "plain": cuda_ms(plain, 50)}
    b = logits.shape[0]
    n = b * v
    # logits read, soft written, ids; two logs, an exp, add, multiply,
    # subtract and divide per element (Philox's integer rounds not counted)
    nbytes, flops = 8 * n + 4 * b, 7 * n
    b_ms, b_by = bound(nbytes, flops)
    return {"kernel_ms": [k_a, k_b], "kernel_fed_uniforms_ms": [f_a, f_b],
            "plain_ms": [p_a, p_b], "event_ms_per_call": ev_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
            "flop": flops, "shape": [b, v], "plan": gs.gumbel_plan(b, v)}


def phase_gumbel_ids(device):
    """sha256 of the sampler's ids, and of the uniforms it drew, for fixed
    logits and (seed, step) at [64, V], [64, V - 1] and [3, 50257], at
    temperatures 1 and TEMP, through ``gumbel_sample``'s public signature
    only: two checkouts whose digests agree draw the same uniforms and pick
    the same ids (a copy of this script run from an older checkout's root
    digests that checkout's kernel)."""
    from gan_image_captioning_tpu_torch.kernels import gumbel_sample as gs

    out = {}
    for b, v in ((B_TRAIN, V), (B_TRAIN, V - 1), (3, 50257)):
        logits = seeded((b, v), 76, device, 3.0)
        u_out = torch.empty_like(logits)
        ids = [gs.gumbel_sample(logits, temp, seed=99, step=step,
                                uniforms_out=u_out)[1]
               for temp in (1.0, TEMP) for step in (0, 3)]
        out[f"{b}x{v}"] = {"ids_sha256": sha256(ids),
                           "uniforms_sha256": sha256(u_out)}
    emit({"phase": "gumbel_ids", **out})
    return out


def tf_config(**overrides):
    from gan_image_captioning_tpu_torch.config import (build_parser,
                                                       config_from_args)

    args = build_parser().parse_args([*TF_MODEL_FLAGS, "--device", "cuda"])
    args.vocab_size = V
    return config_from_args(args).replace(disc_train_freq=1, **overrides)


def tf_setup(device, **overrides):
    """config4 at full width (gen 256/256, 4 layers, 8 heads; disc 64/128,
    4 layers, 8 heads; V = 11008, T = 36, rollouts 4 every 4), float32
    unless ``overrides`` say otherwise, un-swept initial weights from seed
    0, and B = 64 captions of 3-34 random tokens (ragged lengths for the
    MLE pass's masks)."""
    from gan_image_captioning_tpu_torch.data.loader import make_batch
    from gan_image_captioning_tpu_torch.train.state import create_train_state
    from gan_image_captioning_tpu_torch.train.steps import batch_to

    config = tf_config(**overrides)
    state = create_train_state(config, 0, device, sweep=False)
    rng = np.random.default_rng(77)
    caps = [rng.integers(4, min(11000, V), size=rng.integers(3, 35))
            for _ in range(B_TRAIN)]
    return config, state, batch_to(make_batch(caps, None, T), device)


def tf_noise(config, device, seed=81, dtype=torch.float32):
    """Every draw of one REINFORCE step: the sample's uniforms, each
    rollout prefix's, the two dropout masks."""
    from gan_image_captioning_tpu_torch.models.api import disc_keep_shape

    gen = torch.Generator(device=device).manual_seed(seed)
    rows = B_TRAIN * config.rollout_num
    keep_shape = disc_keep_shape(config, B_TRAIN)
    return {"uniforms": torch.rand((T, B_TRAIN, V), generator=gen,
                                   device=device, dtype=dtype),
            "rollout_uniforms": [torch.rand((T, rows, V), generator=gen,
                                            device=device, dtype=dtype)
                                 for _ in range(TF_PREFIXES)],
            "keep": [torch.rand(keep_shape, generator=gen, device=device)
                     < 0.8 for _ in range(2)], "seed": seed}


def tf_grads(kind, config, state, batch, noise):
    from gan_image_captioning_tpu_torch.train import steps

    if kind == "rl":
        return steps.adv_grads(config, state, batch, 1.0, noise)
    loss = steps.mle_loss(config, state, batch)
    gen_grads, = steps._grads(loss, state.gen)
    return loss.detach(), loss.detach() * 0, gen_grads, {}, {
        "gen_ids": torch.zeros(1)}


def phase_tf_train(device):
    """config4 at full width: 2 MLE and 2 REINFORCE steps through the entry
    points with the launch counts; each step's losses and gradients through
    the kernels against the plain route (attn_impl and decode_impl plain)
    on the same state and fed noise, and against the plain route in float64
    where a side's gradients differ by more than 1e-3 of its largest; ms
    per step on both routes; the device's busy share (torch.profiler)."""
    import dataclasses

    from gan_image_captioning_tpu_torch.train.steps import (make_adv_step,
                                                            make_mle_step)

    config, state, batch = tf_setup(device)
    mle, adv = make_mle_step(config), make_adv_step(config)
    cnt = tf_counters()
    for fn in cnt.values():
        fn.launches = 0
    metrics = []
    t0 = time.perf_counter()
    for kind in ("mle", "mle", "rl", "rl"):
        state, m = (mle(state, batch) if kind == "mle"
                    else adv(state, batch, 1.0))
        metrics.append({"step": kind, **{k: float(v) for k, v in m.items()}})
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in cnt.items()}
    expected = {k: 2 * TF_PER_MLE_STEP[k] + 2 * TF_PER_RL_STEP[k]
                for k in cnt}
    row = {"metrics": metrics, "launches": launches,
           "expected_launches": expected, "seconds": seconds,
           "gen_steps": state.gen_steps, "disc_steps": state.disc_steps}
    emit({"phase": "tf_train", **row})
    check(all(math.isfinite(v) for m in metrics for k, v in m.items()
              if k != "step"), "non-finite config4 metric")
    check(launches == expected, f"launches {launches} != {expected}")
    check(state.gen_steps == 2 and state.disc_steps == 2,
          f"counters {state.gen_steps}, {state.disc_steps}")

    plain_cfg = config.replace(attn_impl="plain", decode_impl="plain")
    routes = {}
    for kind in ("mle", "rl"):
        noise = tf_noise(config, device)
        kern = tf_grads(kind, config, state, batch, noise)
        plain = tf_grads(kind, plain_cfg, state, batch, noise)
        cmp = compare_grads(kern, plain)
        if any(e > GRAD_RTOL for e in cmp["grad_side_rel_err"].values()):
            state64 = dataclasses.replace(
                state, gen=copy.deepcopy(state.gen).double(),
                disc=copy.deepcopy(state.disc).double())
            batch64 = dict(batch, weights=batch["weights"].double())
            noise64 = dict(noise, uniforms=noise["uniforms"].double(),
                           rollout_uniforms=[u.double() for u in
                                             noise["rollout_uniforms"]])
            ref = tf_grads(kind, plain_cfg, state64, batch64, noise64)
            cmp["kernel_vs_float64"] = compare_grads(kern, ref)[
                "grad_side_rel_err"]
            cmp["plain_vs_float64"] = compare_grads(plain, ref)[
                "grad_side_rel_err"]
            del state64, ref
        worst = sorted(cmp["grad_rel_err"].items(), key=lambda kv: -kv[1])[:3]
        emit({"phase": "tf_train", "kernels_vs_plain": kind,
              "g_loss": cmp["g_loss"], "d_loss": cmp["d_loss"],
              "ids_equal": cmp["ids_equal"],
              "max_grad_rel_err": cmp["max_grad_rel_err"], "worst": worst,
              "grad_side_rel_err": cmp["grad_side_rel_err"],
              **{k: cmp[k] for k in ("kernel_vs_float64", "plain_vs_float64")
                 if k in cmp}})
        for name in ("g_loss", "d_loss"):
            a, b = cmp[name]
            check(abs(a - b) <= LOSS_RTOL * max(abs(b), 1e-30),
                  f"{kind} {name} {a} vs {b}")
        check(cmp["ids_equal"], f"{kind}: the routes sampled different ids")
        check(routes_agree(cmp), f"{kind}: {cmp['grad_side_rel_err']}, "
              f"{cmp.get('kernel_vs_float64')}, "
              f"{cmp.get('plain_vs_float64')}, {worst}")
        routes[kind] = {k: cmp[k] for k in ("g_loss", "d_loss",
                                            "grad_side_rel_err")}
        del noise, kern, plain

    times = {}
    for kind in ("mle", "rl"):
        fns = {}
        for route, cfg in (("kernel", config), ("plain", plain_cfg)):
            if kind == "mle":
                step = make_mle_step(cfg)
                fns[route] = lambda step=step: step(state, batch)
            else:
                step = make_adv_step(cfg)
                fns[route] = lambda step=step: step(state, batch, 1.0)
        p_a = step_ms(fns["plain"], 2)
        k_a = step_ms(fns["kernel"], 3)
        k_b = step_ms(fns["kernel"], 3)
        p_b = step_ms(fns["plain"], 2)
        times[kind] = {"kernel_ms": [k_a, k_b], "plain_ms": [p_a, p_b]}
        emit({"phase": "tf_train", "timing": kind, "B": B_TRAIN,
              **times[kind]})
    names = ("flash_fwd_fused_kernel", "flash_fwd_kernel",
             "flash_bwd_fused_kernel", "flash_bwd_tiled_kernel",
             "gumbel_cluster_kernel", "gumbel_rows_kernel")
    prof = {"mle": profile_calls(lambda: mle(state, batch), 3, names),
            "rl": profile_calls(lambda: adv(state, batch, 1.0), 2, names)}
    for kind, p in prof.items():
        emit({"phase": "tf_train", "profile": kind, **p})
    return {"launches": launches, "routes": routes, "times": times,
            "profile": prof}


def phase_tf_service(device):
    """config4's generator (seeded, full width, V = 11008) behind the
    coalescing engine: ``{"n": 1}`` and ``{"n": 8}``; every caption's ids
    are the argmax of the parallel causal pass over them (flash attention
    on the card: an independent route), and the sequence logprobs agree
    with it within 1e-3; request p50 / p90."""
    from gan_image_captioning_tpu_torch import serve
    from gan_image_captioning_tpu_torch.eval.decode import masked_logprob_sum
    from gan_image_captioning_tpu_torch.models import transformer as ttf

    service = serve.CaptionService(serve.parse_args(
        ["--init-seed", "0", *TF_MODEL_FLAGS]))
    try:
        row = {}
        for n in (1, 8):
            resp = service.handle_request({"n": n})
            feats = torch.from_numpy(service._features_unconditional(
                service.batch_size)).to(device)
            ids, lps = service._run_decode(feats.cpu().numpy())
            with torch.no_grad():
                logits = ttf.teacher_forced(service.generator.decoder, feats,
                                            ids, service.config)[:, :T]
            chosen = logits.gather(2, ids.long()[..., None])[..., 0]
            gap = float((logits.max(dim=2).values - chosen).max())
            lp_ref = masked_logprob_sum(ids, chosen - torch.logsumexp(
                logits, dim=2))
            lp_diff = float((lp_ref - lps).abs().max())
            want = [service._caption(r.tolist()) for r in ids[:n]]
            check(resp["captions"] == want, f"n={n}: captions {resp}")
            check(gap <= ID_ATOL, f"n={n}: id {gap} below the max")
            check(lp_diff <= SEQ_ATOL, f"n={n}: logprob {lp_diff}")
            row[f"n{n}"] = {"caption_0": want[0], "max_id_gap": gap,
                            "max_abs_seq_lp_diff": lp_diff,
                            "distinct_ids": int(ids.unique().numel())}
        lat = {}
        for n in (1, 8):
            ms = [service.handle_request({"n": n})["latency_ms"]
                  for _ in range(20)]
            lat[n] = {"p50_ms": float(np.percentile(ms, 50)),
                      "p90_ms": float(np.percentile(ms, 90)),
                      "samples": len(ms)}
        row["request_latency"] = lat
        row["stats"] = service.batcher.stats()
    finally:
        service.close()
    emit({"phase": "tf_service", **row,
          "note": "coalescing engine, batch 8, sequential requests, host "
                  "clock; the cache decode is dense attention (no kernel of "
                  "this slice runs in it, as in the JAX package)"})
    return row


def phase_tf_loop(device, workdir):
    """``main.main --preset config4`` in this process on 256 synthetic
    items at full width: one pretrain and one adversarial (REINFORCE)
    epoch; every kernel of the path launched, every logged loss finite,
    both checkpoints served."""
    import shutil

    from gan_image_captioning_tpu_torch import main as train_main
    from gan_image_captioning_tpu_torch import serve

    save = workdir / "tf_loop"
    shutil.rmtree(save, ignore_errors=True)
    argv = [*TF_MODEL_FLAGS, "--synthetic-items", "256", "--pretrain-epochs",
            "1", "--adv-epochs", "1", "--save-dir", str(save), "--expt-name",
            "smoke"]
    cnt = tf_counters()
    for fn in cnt.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as log:
        inst = train_main.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in cnt.items()}
    rows = [json.loads(ln) for ln in open(Path(inst.config.save_dir)
                                          / "metrics.jsonl")]
    losses = [r for r in rows if r["tag"].endswith("_loss")]
    row = {"seconds": seconds, "launches": launches,
           "pretrain_steps": inst.pretrain_steps,
           "gen_steps": inst.state.gen_steps,
           "disc_steps": inst.state.disc_steps,
           "logged_losses": len(losses),
           "all_finite": all(math.isfinite(r["value"]) for r in rows),
           "log_tail": log.getvalue().splitlines()[-4:]}
    for kernel, n in launches.items():     # the tiled dQ, dK/dV: never
        on_path = TF_PER_MLE_STEP[kernel] or TF_PER_RL_STEP[kernel]
        check(n > 0 if on_path else n == 0,
              f"tf_loop: {kernel} launched {n} times")
    check(row["all_finite"] and len(losses) > 0, "tf_loop: non-finite metric")
    check(inst.pretrain_steps == 4 and inst.state.gen_steps == 4,
          f"tf_loop counters {row}")
    served = {}
    for name in ("pretrained_model.ckpt", "adv_model.ckpt"):
        path = Path(inst.config.model_dir) / name
        check(path.is_file(), f"tf_loop: {name} missing")
        service = serve.CaptionService(serve.parse_args(
            ["--checkpoint", str(path), *TF_MODEL_FLAGS]))
        try:
            resp = service.handle_request({"n": 2})
        finally:
            service.close()
        check(len(resp["captions"]) == 2
              and all(math.isfinite(x) for x in resp["logprobs"]),
              f"tf_loop: {name} served {resp}")
        served[name] = resp
    row["served"] = served
    emit({"phase": "tf_loop", **row})
    return row


def tf_entries(smi, tfk, tf_train):
    """The four TPU kernels' entries of the ``kernels`` line: times and
    bounds at the generator's MLE shape (flash) and at [64, V] (Gumbel).
    ``_dq_kernel`` and ``_dkv_kernel`` are both redesigned as one launch,
    the fused backward (T <= 64, D <= 64) or the tiled one (past them: the
    long captions): each entry gives its launches and its time, bound and
    the backward alone of the plain version and of SDPA, and every case's,
    the tiled ones among them, in ``by_case``."""
    mle = tfk["times"]["gen_mle"]
    errs = {"flash_fwd": max(r["max_abs_out_diff"]
                             for r in tfk["flash"].values()),
            "flash_dq": max(r["dq_max_abs_diff"]
                            for r in tfk["flash"].values()),
            "flash_dkv": max(max(r["dk_max_abs_diff"], r["dv_max_abs_diff"])
                             for r in tfk["flash"].values()),
            "gumbel_sample": max(r["max_abs_soft_diff"]
                                 for r in tfk["gumbel"])}
    out = []
    for name, tpu in TF_TPU_KERNELS.items():
        if name == "gumbel_sample":
            t = tfk["times"]["gumbel_sample"]
            ms, plain_ms, lib_ms = min(t["kernel_ms"]), min(t["plain_ms"]), None
            b_ms, b_by, shape = t["bound_ms"], t["bound_by"], t["shape"]
        else:
            fwd = name == "flash_fwd"
            kern = name if fwd else "flash_bwd"
            ms = min(mle["kernel_ms"][kern])
            plain_ms = min(mle["plain_fwd_ms" if fwd else "plain_bwd_ms"])
            lib_ms = min(mle["library_fwd_ms" if fwd else "library_bwd_ms"])
            b_ms, b_by = mle[kern]["bound_ms"], mle[kern]["bound_by"]
            shape = tfk["flash"]["gen_mle"]["shape"]
        launches = tf_train["launches"][
            name if name in ("flash_fwd", "gumbel_sample") else "flash_bwd"]
        out.append({
            "name": name, "route": "cuda",
            "source": "gan_image_captioning_tpu_torch/kernels/csrc/"
                      + TF_SOURCES[name],
            "replaces": tpu, "launches": launches,
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "shape": shape, "card": smi,
            "note": None if name in ("flash_fwd", "gumbel_sample") else
            "one launch computes delta, dQ, dK and dV (flash_bwd_fused_kernel "
            "at T <= 64 and D <= 64, flash_bwd_tiled_kernel past them): "
            "launches, ms, bound_ms, plain_ms and library_ms are the whole "
            "backward's (plain and SDPA: the backward alone); by_case long_* "
            "are the tiled kernel at the long captions of --max-seq-len "
            "126"})
        check(launches > 0, f"{name} never launched")
        if name != "gumbel_sample":     # every case: ms beside its bound
            by_case = {}
            for case, t in tfk["times"].items():
                if case not in tfk["flash"]:
                    continue
                kern = name if fwd else "flash_bwd"
                by_case[case] = {
                    "shape": tfk["flash"][case]["shape"], "kernel": kern,
                    "route": tfk["flash"][case][
                        "forward_kernel" if fwd else "backward_kernel"],
                    "ms": min(t["kernel_ms"][kern]),
                    "bound_ms": t[kern]["bound_ms"],
                    "library_ms": min(t["library_fwd_ms" if fwd
                                        else "library_bwd_ms"]),
                    "plain_ms": min(t["plain_fwd_ms" if fwd
                                      else "plain_bwd_ms"])}
            out[-1]["by_case"] = by_case
    return out


def image_norm_entry(smi, norm, cond_train):
    times = norm["times"]
    return {
        "name": "image_norm", "route": "cuda",
        "source": "gan_image_captioning_tpu_torch/kernels/csrc/image_norm.cu",
        "replaces": NORM_TPU_KERNEL,
        "launches": cond_train["launches"]["image_norm"],
        "max_abs_err": max(r["max_abs_diff"] for r in norm["rows"]),
        "ms": min(times["kernel_ms"]), "plain_ms": min(times["plain_ms"]),
        "bound_ms": times["bound_ms"], "bound_by": times["bound_by"],
        "library_ms": min(times["library_ms"]), "shape": times["shape"],
        "card": smi}


# ------------------------------------------- the engines of --disc-engine

DISC_TPU = "gan_image_captioning_tpu/kernels/disc_conv.py"
ENGINE_TPU_KERNELS = {
    "disc_conv_rows_fwd": f"{DISC_TPU}:76",
    "disc_conv_rows_bwd": f"{DISC_TPU}:115",
    "disc_conv_bwd_dxs": f"{DISC_TPU}:496",
    "lstm_bptt_reverse": "gan_image_captioning_tpu/kernels/lstm_bptt.py:163",
}
ENGINE_SOURCES = {"disc_conv_rows_fwd": "disc_conv.cu",
                  "disc_conv_rows_bwd": "disc_conv.cu",
                  "disc_conv_bwd_dxs": "disc_conv.cu",
                  "lstm_bptt_reverse": "lstm_bptt.cu"}
DB_ATOL, DXS_ATOL, BPTT_ATOL = 1e-5, 1e-5, 1e-4
# conv launches per adversarial step by design (three discriminator
# passes), besides one sample_resid decode and one BPTT chain
PER_ENGINE_STEP = {
    "auto": {"disc_conv_fwd": 3, "disc_conv_bwd_dx": 3},
    "xla": {},
    "pallas": {"disc_conv_rows_fwd": 3, "disc_conv_rows_bwd": 3},
    "hybrid": {"disc_conv_rows_bwd": 3},
    "mxu": {"disc_conv_fwd": 3, "disc_conv_bwd_dx": 3},
    "mxu_dxs": {"disc_conv_fwd": 3, "disc_conv_bwd_dxs": 3},
}


def rows_bwd_work(B):
    """The per-batch-row backward: emb, w, pooled, idx, dpool in; d_emb,
    dW, db out."""
    q, n_all = B * DISC_R, sum(n for n, _ in BANKS)
    emb, w = 4 * B * (T + 4) * DISC_E, 4 * n_all * max(f for _, f in BANKS)
    return (2 * emb + 2 * w + 3 * 4 * q * n_all + 4 * n_all,
            sum(4 * q * n * f for n, f in BANKS))


def dxs_work(B):
    """The DXS backward: emb, w, idx, the raw pooled gradient and pooled
    in; DXS [lv, Q, f], dW and db out."""
    q, n_all = B * DISC_R, sum(n for n, _ in BANKS)
    emb, w = 4 * B * (T + 4) * DISC_E, 4 * n_all * max(f for _, f in BANKS)
    dxs = sum(4 * (T - f + 1) * q * f for _, f in BANKS)
    return (emb + 2 * w + 3 * 4 * q * n_all + dxs + 4 * n_all,
            sum(4 * q * n * f for n, f in BANKS))


def reverse_work(B):
    """One layer's reverse recurrence: w_hh, d_hs, gates, c_prev, cs in;
    d_pre, dh0, dc0 out."""
    nbytes = 4 * (4 * H * H + 3 * T * B * H + 2 * T * B * 4 * H + 2 * B * H)
    return nbytes, 2 * T * B * 4 * H * H


def time_pair(kern, plain, work, k_calls=20, p_calls=20, plain_events=False):
    """device_ms of a kernel and its plain version in turns (plain,
    kernel, kernel, plain), with the bound of ``work``.  ``plain_events``:
    a plain version of thousands of launches (the BPTT loops), more than
    the launch queue holds behind the spin, is timed by CUDA events around
    ``p_calls`` calls issued one after another (``cuda_ms``): the host's
    pace, an upper bound on its device time."""
    def plain_ms():
        if plain_events:
            return cuda_ms(plain, reps=p_calls, warmup=1)
        return device_ms(plain, p_calls)

    p_a = plain_ms()
    k_a = device_ms(kern, k_calls)
    k_b = device_ms(kern, k_calls)
    p_b = plain_ms()
    b_ms, b_by = bound(*work)
    return {"kernel_ms": [k_a, k_b], "plain_ms": [p_a, p_b], "bound_ms": b_ms,
            "bound_by": b_by, "bytes": work[0], "flop": work[1],
            "plain_timer": "cuda_ms" if plain_events else "device_ms"}


def phase_disc_engines(device):
    """The per-batch-row conv kernels and the DXS backward against their
    plain versions (and the mxu kernels) at config3 width; one adversarial
    step under each --disc-engine value with the launch counts, and its
    gradients against the plain route; device_ms times of the new kernels
    and, re-timed the same way, of the mxu conv kernels and the chain."""
    from gan_image_captioning_tpu_torch.kernels import disc_conv
    from gan_image_captioning_tpu_torch.train.steps import (adv_grads,
                                                            make_adv_step)

    B, out = B_TRAIN, {"rows": {}}
    emb_pad, w_all, b_all, banks = conv_inputs(device)
    args = (emb_pad, w_all, b_all, banks, DISC_R, 1)
    fwd_counters = (disc_conv.conv_rows_forward, disc_conv.conv_bank_forward)
    before = [f.launches for f in fwd_counters]
    pooled_k, idx_k = disc_conv.conv_rows_forward(*args)
    torch.cuda.synchronize()
    counted = [f.launches - b for f, b in zip(fwd_counters, before)]
    pooled_p, idx_p = disc_conv.conv_relu_maxpool_plain(*args)
    pooled_m, idx_m = disc_conv.conv_bank_forward(*args)
    bad_p, ties = idx_mismatch(emb_pad, w_all, b_all, banks, pooled_p, idx_k,
                               idx_p)
    plan = disc_conv.conv_fwd_plan(B * DISC_R, T, 1, banks)
    row = {"max_abs_pooled_diff": float((pooled_k - pooled_p).abs().max()),
           "bit_equal_mxu": bool(torch.equal(pooled_k, pooled_m)) and all(
               torch.equal(a, b) for a, b in zip(idx_k, idx_m)),
           "idx_mismatch_outside_ties": bad_p, "near_ties": ties,
           "plan_launches": len(plan["launches"]),
           "counted_rows_mxu": counted}
    emit({"phase": "disc_engines", "kernel": "disc_conv_rows_fwd", **row})
    # the mxu forward's kernel: its bits, one launch a pass, counted on the
    # row engine's counter only
    check(row["max_abs_pooled_diff"] <= POOL_ATOL and bad_p == 0
          and row["bit_equal_mxu"] and row["plan_launches"] == 1
          and counted == [1, 0], f"rows forward {row}")
    out["rows"]["disc_conv_rows_fwd"] = row

    d_pooled = seeded(tuple(pooled_p.shape), 71, device)
    bwd_args = (emb_pad, w_all, banks, DISC_R, 1, pooled_p, idx_p, d_pooled)
    before = disc_conv.conv_rows_backward.launches
    d_emb, dw, db = disc_conv.conv_rows_backward(*bwd_args)
    counted = disc_conv.conv_rows_backward.launches - before
    again = disc_conv.conv_rows_backward(*bwd_args)
    torch.cuda.synchronize()
    w_emb, w_dw, w_db = disc_conv.conv_rows_backward_plain(*bwd_args)
    plan = disc_conv.conv_bwd_plan(B * DISC_R, T, 1, banks, raw=True)
    row = {"max_abs_dx_diff": float((d_emb - w_emb).abs().max()),
           "max_abs_dx": float(w_emb.abs().max()),
           "dw_rel": float((dw - w_dw).abs().max() / w_dw.abs().max()),
           "max_abs_db_diff": float((db - w_db).abs().max()),
           "max_abs_db": float(w_db.abs().max()),
           "bit_equal_repeat": all(torch.equal(a, b)
                                   for a, b in zip((d_emb, dw, db), again)),
           "plan_launches": len(plan["launches"]),
           "plan_kernel_launches": plan["kernel_launches"],
           "counted": counted}
    emit({"phase": "disc_engines", "kernel": "disc_conv_rows_bwd", **row})
    check(row["plan_launches"] == 1 and row["plan_kernel_launches"] == 2
          and counted == 1 and row["bit_equal_repeat"],
          f"rows backward: one launch for the banks and one reduction a "
          f"pass, two calls bit-equal, expected {row}")
    # d_emb and db are sums of hundreds (of thousands, for db) of terms:
    # held as the mxu backward's dX is, within the tolerance times the
    # larger of 1 and their largest entry
    check(row["max_abs_dx_diff"] <= DX_ATOL * max(1.0, row["max_abs_dx"])
          and row["dw_rel"] <= DW_RTOL
          and row["max_abs_db_diff"] <= DB_ATOL * max(1.0, row["max_abs_db"]),
          f"rows backward {row}")
    out["rows"]["disc_conv_rows_bwd"] = row

    # the DXS backward from the raw gradient (the autograd route: mask and
    # db in the launch) and, through the same kernels, from the masked one
    dpms, _ = disc_conv._masked(pooled_p, d_pooled, banks)
    dxs_args = (emb_pad, w_all, banks, DISC_R, 1, idx_p, dpms)
    raw_args = (emb_pad, w_all, banks, DISC_R, 1, pooled_p, idx_p, d_pooled)
    before = disc_conv.conv_bank_dxs.launches
    dxss, dw, db = disc_conv.conv_bank_dxs_raw(*raw_args)
    counted = disc_conv.conv_bank_dxs.launches - before
    again = disc_conv.conv_bank_dxs_raw(*raw_args)
    m_dxss, m_dw = disc_conv.conv_bank_dxs(*dxs_args)
    torch.cuda.synchronize()
    w_dxss, w_dw, w_db = disc_conv.conv_dxs_raw_plain(*raw_args)
    d_emb = disc_conv.overlap_add(dxss, banks, emb_pad.shape, DISC_R, 1)
    dx_emb, _ = disc_conv.conv_bank_backward(*dxs_args)
    plan = disc_conv.conv_dxs_plan(B * DISC_R, T, 1, banks)
    row = {"max_abs_dxs_diff": max(float((a - b).abs().max())
                                   for a, b in zip(dxss, w_dxss)),
           "max_abs_dxs": max(float(b.abs().max()) for b in w_dxss),
           "dw_rel": float((dw - w_dw).abs().max() / w_dw.abs().max()),
           "max_abs_db_diff": float((db - w_db).abs().max()),
           "max_abs_db": float(w_db.abs().max()),
           "max_abs_dx_diff_vs_mxu": float((d_emb - dx_emb).abs().max()),
           "max_abs_dx": float(dx_emb.abs().max()),
           "bit_equal_repeat": all(torch.equal(a, b) for a, b in zip(
               [*dxss, dw, db], [*again[0], *again[1:]])),
           "bit_equal_masked_route": all(torch.equal(a, b) for a, b in zip(
               [*dxss, dw], [*m_dxss, m_dw])),
           "plan": [{k: v for k, v in launch.items() if k != "ints"}
                    for launch in plan["launches"]],
           "plan_kernel_launches": plan["kernel_launches"],
           "counted": counted,
           "dxs_mb": sum(d.numel() for d in dxss) * 4 / 1e6}
    emit({"phase": "disc_engines", "kernel": "disc_conv_bwd_dxs", **row})
    check(len(row["plan"]) == 1 and row["plan_kernel_launches"] == 2
          and counted == 1 and row["bit_equal_repeat"]
          and row["bit_equal_masked_route"],
          f"DXS: one launch for the banks and one reduction a pass, two "
          f"calls and both routes bit-equal, expected {row}")
    check(row["max_abs_dxs_diff"] <= DXS_ATOL * max(1.0, row["max_abs_dxs"])
          and row["dw_rel"] <= DW_RTOL
          and row["max_abs_db_diff"] <= DB_ATOL * max(1.0, row["max_abs_db"])
          and row["max_abs_dx_diff_vs_mxu"]
          <= DX_ATOL * max(1.0, row["max_abs_dx"]), f"DXS {row}")
    out["rows"]["disc_conv_bwd_dxs"] = row

    # one adversarial step per engine value through make_adv_step, with the
    # launch counts; then its gradients against the plain route
    config, state, batch = train_setup(device)
    plain_cfg = config.replace(decode_impl="plain", disc_engine="plain")
    cnt = counters()
    out["steps"] = {}
    for engine, per_step in PER_ENGINE_STEP.items():
        cfg = config.replace(disc_engine=engine)
        for fn in cnt.values():
            fn.launches = 0
        state, m = make_adv_step(cfg)(state, batch, TEMP)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in cnt.items()}
        expected = {**{k: 0 for k in COUNTERS}, "decode_sample_resid": 1,
                    "lstm_bptt_chain": 1, **per_step}
        noise = fed_noise(config, device)
        with disc_conv.argmax_record() as rows:
            kern = adv_grads(cfg, state, batch, TEMP, noise)
        with disc_conv.argmax_replay(rows) as report:
            plain = adv_grads(plain_cfg, state, batch, TEMP, noise)
        cmp = compare_grads(kern, plain)
        row = {"launches": launches, "expected_launches": expected,
               "metrics": {k: float(v) for k, v in m.items()},
               "g_loss": cmp["g_loss"], "d_loss": cmp["d_loss"],
               "ids_equal": cmp["ids_equal"],
               "grad_side_rel_err": cmp["grad_side_rel_err"],
               "max_grad_rel_err": cmp["max_grad_rel_err"],
               "argmax_gap": max(g for g, _ in report),
               "argmax_moved": [mv for _, mv in report]}
        emit({"phase": "disc_engines", "engine": engine, **row})
        check(launches == expected, f"{engine}: launches {launches} != "
              f"{expected}")
        check(all(math.isfinite(v) for v in row["metrics"].values()),
              f"{engine}: non-finite metric")
        check(cmp["ids_equal"], f"{engine}: the routes sampled different ids")
        check(row["argmax_gap"] <= TIE_GAP, f"{engine}: argmax gap")
        for name in ("g_loss", "d_loss"):
            a, b = cmp[name]
            check(abs(a - b) <= LOSS_RTOL * max(abs(b), 1e-30),
                  f"{engine} {name} {a} vs {b}")
        check(routes_agree(cmp), f"{engine}: {cmp['grad_side_rel_err']}")
        step = make_adv_step(cfg)
        row["step_ms"] = [step_ms(lambda: step(state, batch, TEMP), 3)
                          for _ in range(2)]
        emit({"phase": "disc_engines", "engine": engine, "B": B,
              "step_ms": row["step_ms"]})
        out["steps"][engine] = row
    del state, batch

    # device times: the new kernels, and the mxu conv kernels and the BPTT
    # chain re-timed by the same method
    from gan_image_captioning_tpu_torch.kernels.decode_sample import (
        decode_sample_resid)
    from gan_image_captioning_tpu_torch.kernels.lstm_bptt import (
        lstm_bptt_chain, lstm_bptt_chain_plain)

    gen = full_width_generator(device)
    _, _, _, cs, gates = decode_sample_resid(
        *decode_args(gen.decoder, seeded((B, E), 64, device)), seed=3,
        temperature=TEMP)
    layers = gen.decoder.lstm.layers()
    w_hhs = torch.stack([lp["w_hh"].T for lp in layers]).contiguous()
    w_ihs = torch.stack([lp["w_ih"].T for lp in layers[1:]]).contiguous()
    d_hs = seeded((T, B, H), 65, device)
    cases = {
        "disc_conv_rows_fwd": (
            lambda: disc_conv.conv_rows_forward(*args),
            lambda: disc_conv.conv_relu_maxpool_plain(*args),
            conv_work(B), 20, 20),
        "disc_conv_rows_bwd": (
            lambda: disc_conv.conv_rows_backward(*bwd_args),
            lambda: disc_conv.conv_rows_backward_plain(*bwd_args),
            rows_bwd_work(B), 20, 4),
        "disc_conv_bwd_dxs": (
            lambda: disc_conv.conv_bank_dxs_raw(*raw_args),
            lambda: disc_conv.conv_dxs_raw_plain(*raw_args),
            dxs_work(B), 20, 4),
        "disc_conv_fwd": (
            lambda: disc_conv.conv_bank_forward(*args),
            lambda: disc_conv.conv_relu_maxpool_plain(*args),
            conv_work(B), 20, 20),
        "disc_conv_bwd_dx": (
            lambda: disc_conv.conv_bank_backward(*dxs_args),
            lambda: disc_conv.conv_bwd_dx_plain(*dxs_args),
            conv_work(B, backward=True), 20, 4),
        "lstm_bptt_chain": (
            lambda: lstm_bptt_chain(w_hhs, w_ihs, d_hs, gates, cs),
            lambda: lstm_bptt_chain_plain(w_hhs, w_ihs, d_hs, gates, cs),
            chain_work(B), 5, 2),
    }
    out["times"] = {}
    for name, (kern, plain, work, k_calls, p_calls) in cases.items():
        out["times"][name] = time_pair(
            kern, plain, work, k_calls, p_calls,
            plain_events=name == "lstm_bptt_chain")
        emit({"phase": "disc_engines", "timing": name, "B": B,
              **out["times"][name]})
    return out


# conv_bwd_dxs_kernel: the DXS kernel's name before its redesign
DXS_PROFILE_KEYS = KERNEL_NAMES + ("conv_dxs_kernel", "conv_bwd_dxs_kernel")


def phase_disc_profile(device):
    """Device time and launches by kernel (torch.profiler) of the
    adversarial step under ``mxu`` and ``mxu_dxs``, over one cycle of the
    discriminator's update cadence: what the DXS route adds.  It uses only
    what every tree since the DXS route's port has (``make_adv_step``,
    ``Config.replace``), so this function can profile an older checkout."""
    from gan_image_captioning_tpu_torch.train.steps import make_adv_step

    config, state, batch = train_setup(device)
    out = {}
    for engine in ("mxu", "mxu_dxs"):
        step = make_adv_step(config.replace(disc_engine=engine))
        prof = profile_calls(lambda: step(state, batch, TEMP), DISC_EVERY,
                             names=DXS_PROFILE_KEYS)
        us = prof.get("device_us_per_call", {})
        count = prof.get("launches_per_call", {})
        conv = {k: {"us": us[k], "launches": count[k]} for k in us
                if k in DXS_PROFILE_KEYS and "conv" in k}
        out[engine] = {
            "device_ms_per_step_total": sum(us.values()) / 1e3,
            "launches_per_step_total": sum(count.values()),
            "conv_kernels": conv,
            "device_busy_share": prof.get("device_busy_share"),
            "wall_ms_per_step": prof.get("wall_ms_per_call")}
        emit({"phase": "disc_profile", "engine": engine, "B": B_TRAIN,
              "steps": DISC_EVERY, **out[engine]})
    return out


def phase_bptt_reverse(device):
    """The reverse recurrence kernel at [36, 64, 512] from a non-zero
    (h0, c0) against its plain version; the unconditional config3
    teacher-forced MLE step through it against the plain route, with its
    launch counts; its device time."""
    from gan_image_captioning_tpu_torch.kernels.lstm_bptt import (
        lstm_bptt_reverse, lstm_bptt_reverse_plain)
    from gan_image_captioning_tpu_torch.models import lstm
    from gan_image_captioning_tpu_torch.train.steps import make_mle_step

    B = B_TRAIN
    gen = full_width_generator(device)
    lp = lstm.fuse_layer_params(gen.decoder.lstm.layers())[0]
    h0, c0 = seeded((B, H), 81, device, 0.5), seeded((B, H), 82, device, 0.5)
    _, cs, gates = lstm._layer_seq_scan(lp["w"], lp["b"],
                                        seeded((T, B, E), 80, device), h0, c0)
    c_prev = torch.cat([c0[None], cs[:-1]])
    w_hh = lp["w"][E:].contiguous()
    rargs = (w_hh, seeded((T, B, H), 83, device), gates, c_prev, cs)
    got = lstm_bptt_reverse(*rargs)
    torch.cuda.synchronize()
    want = lstm_bptt_reverse_plain(*rargs)
    scale = float(want[0].abs().max())
    row = {"max_abs_d_pre_diff": float((got[0] - want[0]).abs().max()),
           "max_abs_d_pre": scale,
           "max_abs_dh0_diff": float((got[1] - want[1]).abs().max()),
           "max_abs_dc0_diff": float((got[2] - want[2]).abs().max())}
    row["d_pre_rel"] = row["max_abs_d_pre_diff"] / scale
    emit({"phase": "bptt_reverse", "kernel": "lstm_bptt_reverse", **row})
    check(row["d_pre_rel"] <= BPTT_ATOL
          and row["max_abs_dh0_diff"] <= BPTT_ATOL
          and row["max_abs_dc0_diff"] <= BPTT_ATOL, f"reverse BPTT {row}")
    out = {"kernel": row}

    config, state, batch = train_setup(device)
    config = config.replace(mle_objective="teacher")
    cnt = counters()
    for fn in cnt.values():
        fn.launches = 0
    state, m = make_mle_step(config)(state, batch)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in cnt.items()}
    expected = {**{k: 0 for k in COUNTERS}, "lstm_bptt_reverse": NL}
    plain_cfg = config.replace(decode_impl="plain", disc_engine="plain")
    cmp = compare_grads(cond_grads("mle_teacher", config, state, batch, None),
                        cond_grads("mle_teacher", plain_cfg, state, batch,
                                   None))
    step = {"launches": launches, "expected_launches": expected,
            "metrics": {k: float(v) for k, v in m.items()},
            "loss": cmp["g_loss"],
            "grad_side_rel_err": cmp["grad_side_rel_err"],
            "max_grad_rel_err": cmp["max_grad_rel_err"]}
    emit({"phase": "bptt_reverse", "step": "mle_teacher", **step})
    check(launches == expected, f"teacher step launches {launches} != "
          f"{expected}")
    a, b = cmp["g_loss"]
    check(abs(a - b) <= LOSS_RTOL * abs(b), f"teacher loss {a} vs {b}")
    check(routes_agree(cmp), f"teacher step {cmp['grad_side_rel_err']}")
    times = {}
    for route, cfg in (("plain", plain_cfg), ("kernel", config),
                       ("kernel", config), ("plain", plain_cfg)):
        mle = make_mle_step(cfg)
        times.setdefault(route, []).append(
            step_ms(lambda: mle(state, batch), 3))
    step["kernel_ms"], step["plain_ms"] = times["kernel"], times["plain"]
    emit({"phase": "bptt_reverse", "timing": "mle_teacher", "B": B, **times})
    out["step"] = step
    out["time"] = time_pair(lambda: lstm_bptt_reverse(*rargs),
                            lambda: lstm_bptt_reverse_plain(*rargs),
                            reverse_work(B), k_calls=10, p_calls=2,
                            plain_events=True)
    emit({"phase": "bptt_reverse", "timing": "lstm_bptt_reverse", "B": B,
          **out["time"]})
    return out


def engine_entries(smi, engines, reverse):
    """The four kernels' entries of the ``kernels`` line: launches from the
    adversarial step under ``pallas`` (rows forward and backward) and
    ``mxu_dxs`` (DXS), and from the teacher-forced MLE step (reverse)."""
    times = {**engines["times"], "lstm_bptt_reverse": reverse["time"]}
    launches = {
        "disc_conv_rows_fwd": engines["steps"]["pallas"]["launches"],
        "disc_conv_rows_bwd": engines["steps"]["pallas"]["launches"],
        "disc_conv_bwd_dxs": engines["steps"]["mxu_dxs"]["launches"],
        "lstm_bptt_reverse": reverse["step"]["launches"]}
    rows = engines["rows"]
    errs = {"disc_conv_rows_fwd": rows["disc_conv_rows_fwd"][
                "max_abs_pooled_diff"],
            "disc_conv_rows_bwd": rows["disc_conv_rows_bwd"][
                "max_abs_dx_diff"],
            "disc_conv_bwd_dxs": rows["disc_conv_bwd_dxs"]["max_abs_dxs_diff"],
            "lstm_bptt_reverse": reverse["kernel"]["max_abs_d_pre_diff"]}
    out = []
    for name, tpu in ENGINE_TPU_KERNELS.items():
        t = times[name]
        out.append({
            "name": name, "route": "cuda",
            "source": "gan_image_captioning_tpu_torch/kernels/csrc/"
                      + ENGINE_SOURCES[name],
            "replaces": tpu, "launches": launches[name][name],
            "max_abs_err": errs[name], "ms": min(t["kernel_ms"]),
            "plain_ms": min(t["plain_ms"]), "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None, "B": B_TRAIN,
            "card": smi})
        check(out[-1]["launches"] > 0, f"{name} never launched")
    return out


# ------------------------------------------------ decode modes and routes

DECODE_TPU = "gan_image_captioning_tpu/kernels/decode_sample.py"
MODE_TPU_KERNELS = {
    "decode_sample_noise": f"{DECODE_TPU}:121",      # _kernel, mode sample
    "decode_sample_logits": f"{DECODE_TPU}:121",     # mode pretrain
    "decode_sample_embed": f"{DECODE_TPU}:121",      # mode sample_embed
    "decode_sample_embed_bwd": f"{DECODE_TPU}:826",  # _embed_bwd_kernel
}
MODE_SOURCES = {"decode_sample_noise": "decode_serve.cu",
                "decode_sample_logits": "decode_serve.cu",
                "decode_sample_embed": "decode_serve.cu",
                "decode_sample_embed_bwd": "decode_embed_bwd.cu"}
NOISE_ATOL, EMB_RTOL, DWP_RTOL, DHTOP_RTOL = 1e-5, 1e-5, 1e-4, 1e-5
# launches per step by design at config3 width (besides the conv banks'
# 3 + 3 per adversarial step): the adversarial and MLE (free) train steps,
# and the eval steps (no backward) of make_adv_eval_step and
# make_mle_eval_step
ROUTE_LAUNCHES = {
    "kernel": {"adv": {"decode_sample_resid": 1, "lstm_bptt_chain": 1},
               "mle": {"decode_serve": 1, "lstm_bptt_reverse": NL},
               "adv_eval": {"decode_sample_resid": 1},
               "mle_eval": {"decode_sample_logits": 1}},
    "kernel_rescore": {"adv": {"decode_sample_noise": 1,
                               "lstm_bptt_reverse": NL},
                       "mle": {"decode_serve": 1, "lstm_bptt_reverse": NL},
                       "adv_eval": {"decode_sample_noise": 1},
                       "mle_eval": {"decode_sample_logits": 1}},
    "kernel_embed": {"adv": {"decode_sample_embed": 1,
                             "decode_sample_embed_bwd": 1,
                             "lstm_bptt_chain": 1},
                     "mle": {"decode_serve": 1, "lstm_bptt_reverse": NL},
                     "adv_eval": {"decode_sample_embed": 1},
                     "mle_eval": {"decode_sample_logits": 1}},
    "decoupled": {"adv": {"lstm_bptt_reverse": NL},
                  "mle": {"lstm_bptt_reverse": NL},
                  "adv_eval": {}, "mle_eval": {}},
}
CONV_PER_ADV = {"disc_conv_fwd": 3, "disc_conv_bwd_dx": 3}


def mode_work(kind, B):
    """Bytes and operations of the mode ``kind`` at batch B (Philox noise:
    no uniforms read)."""
    nbytes, flops = decode_work(B)
    nbytes -= 4 * B * T                          # no log-probabilities
    if kind in ("noise", "logits"):              # g or the logits written
        return nbytes + 4 * T * B * V, flops
    nbytes, flops = resid_work(B)                # embed: + wd in, emb out
    return (nbytes + 4 * (DISC_E * V + T * B * DISC_E),
            flops + 2 * T * B * V * DISC_E)


def embed_bwd_work(B):
    """h_top, soft, d_emb, w_proj, wd in; dWp, dbp, d_htop out."""
    nbytes = 4 * (2 * T * B * H + T * B * V + T * B * DISC_E + 2 * V * H
                  + DISC_E * V + V)
    return nbytes, 2 * T * B * V * (DISC_E + 2 * H)


def tf32x3_bound(nbytes, flops):
    """The bound of float32 products run as three TF32 tensor-core
    products each (3xTF32): 3 * flops at the TF32 peak, or the bytes."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 3 * flops / TF32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def embed_bwd_products(h_top, d_emb, w_proj, wd, d_logits):
    """The three float32 cuBLAS products of the embed backward (TF32 off),
    each a function: d_soft = d_emb @ wd, dWp = h_top^T @ d_logits,
    d_htop = d_logits @ w_proj, at [T·B] rows."""
    h2, e2 = h_top.reshape(-1, h_top.shape[-1]), d_emb.reshape(
        -1, d_emb.shape[-1])
    return {"d_soft": lambda: e2 @ wd, "dwp": lambda: h2.T @ d_logits,
            "d_htop": lambda: d_logits @ w_proj}


def rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def phase_decode_modes(device):
    """The decode modes sample, pretrain and sample_embed and the fused
    embed backward at config3 width against their plain versions and the
    ported modes; device_ms of the decode family (serve at B = 8 and 64,
    sample_resid, the carried chunk and the new modes) beside the plain
    versions and the bounds."""
    from gan_image_captioning_tpu_torch.kernels import decode_sample as ds

    B, out = B_TRAIN, {"rows": {}}
    dec = full_width_generator(device).decoder
    feats = seeded((B, E), 64, device)
    args = decode_args(dec, feats)
    u = torch.rand((T, B, V), generator=torch.Generator(
        device=device).manual_seed(5), device=device)
    wd = seeded((DISC_E, V), 91, device, 0.1)

    # --- sample: the ids of sample_resid on the same noise
    ids_n, noise = ds.decode_sample_noise(*args, uniforms=u)
    resid = ds.decode_sample_resid(*args, temperature=TEMP, uniforms=u)
    seeded_n = ds.decode_sample_noise(*args, seed=3)[0]
    seeded_r = ds.decode_sample_resid(*args, seed=3, temperature=TEMP)[0]
    torch.cuda.synchronize()
    ids_p, noise_p = ds.decode_sample_noise_plain(*args, u)
    row = {"ids_equal_sample_resid_fed": bool(torch.equal(ids_n, resid[0])),
           "ids_equal_sample_resid_seeded": bool(torch.equal(seeded_n,
                                                             seeded_r)),
           "ids_equal_plain": bool(torch.equal(ids_n, ids_p)),
           "distinct_ids": int(ids_n.unique().numel()),
           "max_abs_noise_diff": float((noise - noise_p).abs().max())}
    emit({"phase": "decode_modes", "kernel": "decode_sample_noise", **row})
    check(row["ids_equal_sample_resid_fed"]
          and row["ids_equal_sample_resid_seeded"], f"sample ids {row}")
    check(row["max_abs_noise_diff"] <= NOISE_ATOL, f"sample noise {row}")
    out["rows"]["decode_sample_noise"] = row
    del noise, noise_p

    # --- pretrain: greedy's ids; logits against the plain decode fed the
    # kernel's ids (the teacher-forced rule)
    ids_l, logits = ds.decode_sample_logits(*args)
    greedy = ds.decode_sample(*args, mode="greedy")
    torch.cuda.synchronize()
    ids_lp, logits_p = ds.decode_sample_logits_plain(*args)
    tf = teacher_forced_logits(dec, feats, ids_l).transpose(0, 1)
    chosen = tf.gather(2, ids_l.T.long()[..., None])[..., 0]
    row = {"ids_equal_greedy": bool(torch.equal(ids_l, greedy)),
           "ids_equal_plain": bool(torch.equal(ids_l, ids_lp)),
           "rows_differing": int((ids_l != ids_lp).any(dim=1).sum()),
           "distinct_ids": int(ids_l.unique().numel()),
           "max_id_gap": float((tf.max(dim=2).values - chosen).max()),
           "max_abs_logits_diff": float((logits - tf).abs().max())}
    same = (ids_l == ids_lp).all(dim=1)
    row["max_abs_logits_diff_vs_plain_equal_rows"] = float(
        (logits - logits_p)[:, same].abs().max()) if same.any() else None
    emit({"phase": "decode_modes", "kernel": "decode_sample_logits", **row})
    check(row["ids_equal_greedy"], f"pretrain ids {row}")
    check(row["max_id_gap"] <= ID_ATOL
          and row["max_abs_logits_diff"] <= LP_ATOL, f"pretrain {row}")
    out["rows"]["decode_sample_logits"] = row
    del logits, logits_p, tf

    # --- sample_embed: sample_resid's outputs bit for bit, and emb
    got = ds.decode_sample_embed(*args, wd, temperature=TEMP, uniforms=u)
    torch.cuda.synchronize()
    want = (got[2].double() @ wd.double().T).float()
    row = {"ids_equal_sample_resid": bool(torch.equal(got[0], resid[0])),
           "resid_bit_equal": {n: bool(torch.equal(a, b)) for n, a, b in zip(
               ("soft", "hs", "cs", "gates"), got[2:], resid[1:])},
           "emb_rel": rel_err(got[1], want),
           "max_abs_emb_diff": float((got[1] - want).abs().max())}
    emit({"phase": "decode_modes", "kernel": "decode_sample_embed", **row})
    check(row["ids_equal_sample_resid"]
          and all(row["resid_bit_equal"].values()), f"sample_embed {row}")
    check(row["emb_rel"] <= EMB_RTOL, f"sample_embed emb {row}")
    out["rows"]["decode_sample_embed"] = row
    del got, want

    # --- the embed backward against its plain version
    h_top = resid[2][:, NL - 1].contiguous()
    soft = resid[1]
    d_emb = seeded((T, B, DISC_E), 92, device)
    bargs = (h_top, soft, d_emb, dec.linear.weight, wd, TEMP)
    k = ds.decode_sample_embed_bwd(*bargs)
    k2 = ds.decode_sample_embed_bwd(*bargs)
    torch.cuda.synchronize()
    p = ds.decode_sample_embed_bwd_plain(*bargs)
    row = {"dwp_rel": rel_err(k[0], p[0]), "dbp_rel": rel_err(k[1], p[1]),
           "d_htop_rel": rel_err(k[2], p[2]),
           "max_abs_dwp_diff": float((k[0] - p[0]).abs().max()),
           "max_abs_d_htop_diff": float((k[2] - p[2]).abs().max()),
           "two_calls_bit_equal": all(torch.equal(a, b)
                                      for a, b in zip(k, k2)),
           "plan": ds.embed_bwd_plan(T * B, H, V, DISC_E,
                                     torch.cuda.get_device_properties(
                                         device).multi_processor_count)[
                                             "ints"]}
    emit({"phase": "decode_modes", "kernel": "decode_sample_embed_bwd",
          **row})
    check(row["dwp_rel"] <= DWP_RTOL and row["dbp_rel"] <= DWP_RTOL
          and row["d_htop_rel"] <= DHTOP_RTOL, f"embed backward {row}")
    check(row["two_calls_bit_equal"], "embed backward not deterministic")
    out["rows"]["decode_sample_embed_bwd"] = row
    d_logits = seeded((T * B, V), 96, device, 1e-4)
    products = embed_bwd_products(h_top, d_emb, dec.linear.weight, wd,
                                  d_logits)
    del k, k2, p, resid

    # --- device times of the decode family (a decode is one launch; the
    # plain decodes' thousands of launches overflow the launch queue
    # behind the spin and are timed by CUDA events, the host's pace)
    w = dense_weights(dec)
    f8, f64 = seeded((8, E), 108, device), seeded((64, E), 164, device)
    st = (seeded((NL, 8, H), 109, device, 0.1),
          seeded((NL, 8, H), 110, device, 0.1), f8)
    cases = {
        "decode_sample_noise": (
            lambda: ds.decode_sample_noise(*args, seed=3),
            lambda: ds.decode_sample_noise_plain(*args, u),
            mode_work("noise", B), True),
        "decode_sample_logits": (
            lambda: ds.decode_sample_logits(*args),
            lambda: ds.decode_sample_logits_plain(*args),
            mode_work("logits", B), True),
        "decode_sample_embed": (
            lambda: ds.decode_sample_embed(*args, wd, seed=3,
                                           temperature=TEMP),
            lambda: ds.decode_sample_embed_plain(*args, u, TEMP, wd),
            mode_work("embed", B), True),
        "decode_sample_embed_bwd": (
            lambda: ds.decode_sample_embed_bwd(*bargs),
            lambda: ds.decode_sample_embed_bwd_plain(*bargs),
            embed_bwd_work(B), False),
        "decode_sample_resid": (
            lambda: ds.decode_sample_resid(*args, seed=3, temperature=TEMP),
            lambda: ds.decode_sample_resid_plain(*args, u, TEMP),
            resid_work(B), True),
        "decode_serve_b8": (
            lambda: ds.decode_sample(f8, *w, T, mode="serve"),
            lambda: ds.decode_sample_plain(f8, *w, T),
            decode_work(8), True),
        "decode_serve_b64": (
            lambda: ds.decode_sample(f64, *w, T, mode="serve"),
            lambda: ds.decode_sample_plain(f64, *w, T),
            decode_work(64), True),
        "decode_serve_carry_chunk": (
            lambda: ds.decode_sample(f8, *w, K_CHUNK, mode="serve",
                                     init_state=st),
            lambda: ds.decode_sample_plain(f8, *w, K_CHUNK, st),
            chunk_work(8, K_CHUNK, weight_bytes()), True),
    }
    out["times"] = {}
    for name, (kern, plain, work, decode) in cases.items():
        k_calls = 10 if decode and name != "decode_serve_carry_chunk" else 20
        out["times"][name] = time_pair(kern, plain, work, k_calls,
                                       p_calls=2 if decode else 10,
                                       plain_events=decode)
        if name == "decode_sample_embed_bwd":
            t = out["times"][name]
            t["bound_ms_f32"] = t["bound_ms"]
            t["bound_ms"], t["bound_by"] = tf32x3_bound(*work)
            t["bound_peak"] = "3 x flop at 495 TFLOP/s TF32 (3xTF32)"
            # the library yardstick: the plain version's three cuBLAS
            # products alone, together and each
            t["library_ms"] = [device_ms(lambda: [f() for f in
                                                  products.values()], 10)
                               for _ in range(2)]
            t["library_each_ms"] = {k: device_ms(f, 10)
                                    for k, f in products.items()}
        emit({"phase": "decode_modes", "timing": name, **out["times"][name]})
    return out


def route_noise(config, device, seed=9):
    """fed_noise with the noisy-label flips."""
    noise = fed_noise(config, device, seed)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    noise["flip"] = torch.rand(B_TRAIN, generator=gen, device=device) < 0.25
    return noise


def phase_decode_impls(device):
    """Under each decode route, from the same state and fed noise: one
    adversarial and one MLE (free) pass, losses and gradients against the
    default kernel route's and the plain route's; then one adversarial and
    one MLE train step and their eval steps with the launch counts of the
    design, and ms per train step."""
    from gan_image_captioning_tpu_torch.kernels import disc_conv
    from gan_image_captioning_tpu_torch.train.steps import (
        make_adv_eval_step, make_adv_step, make_mle_eval_step, make_mle_step)

    config, state, batch = train_setup(device)
    config = config.replace(noisy_labels=0.25, label_smoothing=0.1)
    noise = route_noise(config, device)
    plain_cfg = config.replace(decode_impl="plain", disc_engine="plain")
    # the references: the default route (its conv argmax rows recorded)
    # and the plain route pooled at those rows.  Each route's adversarial
    # pass pools at them too (the plain conv engine replaying them): a
    # near-tie in the max-pool that two routes summing in another order
    # break differently is not what this compares
    with disc_conv.argmax_record() as rows:
        ref = {"adv": cond_grads("adv", config, state, batch, noise)}
    with disc_conv.argmax_replay(rows):
        plain = {"adv": cond_grads("adv", plain_cfg, state, batch, noise)}
    ref["mle"] = cond_grads("mle_free", config, state, batch, None)
    plain["mle"] = cond_grads("mle_free", plain_cfg, state, batch, None)
    out = {}
    for route in ROUTE_LAUNCHES:
        cfg = config.replace(decode_impl=route)
        with disc_conv.argmax_replay(rows) as report:
            got = {"adv": cond_grads("adv", cfg.replace(disc_engine="plain"),
                                     state, batch, noise)}
        got["mle"] = cond_grads("mle_free", cfg, state, batch, None)
        row = {"argmax_gap": max(g for g, _ in report),
               "vs_kernel_not_replayed": compare_grads(
                   cond_grads("adv", cfg, state, batch, noise),
                   ref["adv"])["grad_side_rel_err"]}
        for kind in ("adv", "mle"):
            for against, want in (("vs_kernel", ref), ("vs_plain", plain)):
                cmp = compare_grads(got[kind], want[kind])
                row[f"{kind}_{against}"] = {k: cmp[k] for k in (
                    "g_loss", "d_loss", "ids_equal", "grad_side_rel_err",
                    "max_grad_rel_err")}
                tag = f"{route} {kind} {against}"
                check(kind == "mle" or cmp["ids_equal"], f"{tag}: ids")
                for name in ("g_loss", "d_loss"):
                    a, b = cmp[name]
                    check(abs(a - b) <= LOSS_RTOL * max(abs(b), 1e-30),
                          f"{tag} {name} {a} vs {b}")
                check(routes_agree(cmp), f"{tag}: "
                      f"{cmp['grad_side_rel_err']}")
        check(row["argmax_gap"] <= TIE_GAP, f"{route}: argmax gap")
        emit({"phase": "decode_impls", "route": route, **row})
        out[route] = row

    # the train and eval steps through the entry points, counts reset
    # before each and read after it
    cnt = counters()
    for route, per_kind in ROUTE_LAUNCHES.items():
        cfg = config.replace(decode_impl=route)
        steps = {"adv": (make_adv_step(cfg), (TEMP, noise)),
                 "mle": (make_mle_step(cfg), ()),
                 "adv_eval": (make_adv_eval_step(cfg), (TEMP, noise)),
                 "mle_eval": (make_mle_eval_step(cfg), ())}
        launches, metrics, expected = {}, {}, {}
        for kind, (step, extra) in steps.items():
            for fn in cnt.values():
                fn.launches = 0
            _, m = step(state, batch, *extra)
            torch.cuda.synchronize()
            launches[kind] = {k: fn.launches for k, fn in cnt.items()}
            metrics[kind] = {k: float(v) for k, v in m.items()}
            conv = {"adv": CONV_PER_ADV,
                    "adv_eval": {"disc_conv_fwd": 3}}.get(kind, {})
            expected[kind] = {**{k: 0 for k in COUNTERS}, **per_kind[kind],
                              **conv}
        row = {"launches": launches, "expected_launches": expected,
               "metrics": metrics}
        row["adv_step_ms"] = [step_ms(lambda: steps["adv"][0](
            state, batch, TEMP, noise), 3) for _ in range(2)]
        row["mle_step_ms"] = [step_ms(lambda: steps["mle"][0](state, batch),
                                      3) for _ in range(2)]
        emit({"phase": "decode_impls", "route": route, "B": B_TRAIN, **row})
        check(launches == expected, f"{route}: launches {launches} != "
              f"{expected}")
        check(all(math.isfinite(v) for m in metrics.values()
                  for v in m.values()), f"{route}: non-finite metric")
        out[route].update(row)
    return out


def mode_entries(smi, modes, impls):
    """The four new kernels' entries of the ``kernels`` line: launches
    from the kernel_rescore (sample) and kernel_embed (sample_embed, embed
    backward) adversarial steps and the default route's MLE eval step
    (pretrain)."""
    launches = {
        "decode_sample_noise": impls["kernel_rescore"]["launches"]["adv"],
        "decode_sample_logits": impls["kernel"]["launches"]["mle_eval"],
        "decode_sample_embed": impls["kernel_embed"]["launches"]["adv"],
        "decode_sample_embed_bwd": impls["kernel_embed"]["launches"]["adv"]}
    rows = modes["rows"]
    errs = {"decode_sample_noise": rows["decode_sample_noise"][
                "max_abs_noise_diff"],
            "decode_sample_logits": rows["decode_sample_logits"][
                "max_abs_logits_diff"],
            "decode_sample_embed": rows["decode_sample_embed"][
                "max_abs_emb_diff"],
            "decode_sample_embed_bwd": rows["decode_sample_embed_bwd"][
                "max_abs_d_htop_diff"]}
    out = []
    for name, tpu in MODE_TPU_KERNELS.items():
        t = modes["times"][name]
        out.append({
            "name": name, "route": "cuda",
            "source": "gan_image_captioning_tpu_torch/kernels/csrc/"
                      + MODE_SOURCES[name],
            "replaces": tpu, "launches": launches[name][name],
            "max_abs_err": errs[name], "ms": min(t["kernel_ms"]),
            "plain_ms": min(t["plain_ms"]), "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": min(t["library_ms"]) if "library_ms" in t
            else None, "B": B_TRAIN, "card": smi})
        check(out[-1]["launches"] > 0, f"{name} never launched")
    return out


# ------------------------------------------- the wrappers' host cost

def embed_bwd_inputs(device):
    """Seeded inputs of the embed backward at config3 width: h_top, soft
    (a softmax), d_emb, w_proj, wd and the temperature."""
    return (seeded((T, B_TRAIN, H), 93, device),
            torch.softmax(seeded((T, B_TRAIN, V), 94, device, 3.0), dim=-1),
            seeded((T, B_TRAIN, DISC_E), 92, device),
            seeded((V, H), 95, device, 1 / math.sqrt(H)),
            seeded((DISC_E, V), 91, device, 0.1), TEMP)


def host_us(fn, calls):
    """Host µs per call of ``fn``, its calls enqueued while the device
    waits behind a spin (``torch.cuda._sleep``): what a call costs the
    host, apart from the device's own time."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return us


def sha256(out):
    """sha256 of the bytes of a call's output tensors, in order."""
    h = hashlib.sha256()
    for t in (out if isinstance(out, (tuple, list)) else (out,)):
        if isinstance(t, (tuple, list)):
            h.update(sha256(t).encode())
        else:
            h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def phase_wrappers(device):
    """The host's cost per call of the conv-bank forward, of both conv
    backwards (``mxu`` from the masked gradient, the per-batch-row engine's
    from the raw one) and of the fused-embed backward at config3 width
    (three batches of calls), each call's device time split by kernel, and
    the sha256 of its outputs (two checkouts whose digests agree give
    bit-equal outputs).  Only the wrappers' public signatures are used."""
    from gan_image_captioning_tpu_torch.kernels import decode_sample as ds
    from gan_image_captioning_tpu_torch.kernels import disc_conv

    cargs = (*conv_inputs(device), DISC_R, 1)
    bargs = embed_bwd_inputs(device)
    emb_pad, w_all, _, banks = cargs[:4]
    pooled, idxs = disc_conv.conv_bank_forward(*cargs)
    d_pooled = seeded(tuple(pooled.shape), 70, device)
    offs = np.cumsum([0] + [n for n, _ in banks])
    dpms = [torch.where(pooled[..., o:o + n] > 0, d_pooled[..., o:o + n],
                        torch.zeros((), device=device)).contiguous()
            for o, (n, _) in zip(offs, banks)]
    for name, fn, calls in (
            ("disc_conv_fwd",
             lambda: disc_conv.conv_bank_forward(*cargs), 100),
            ("disc_conv_bwd_dx",
             lambda: disc_conv.conv_bank_backward(
                 emb_pad, w_all, banks, DISC_R, 1, idxs, dpms), 100),
            ("disc_conv_rows_bwd",
             lambda: disc_conv.conv_rows_backward(
                 emb_pad, w_all, banks, DISC_R, 1, pooled, idxs, d_pooled),
             100),
            ("disc_conv_bwd_dxs",
             lambda: disc_conv.conv_bank_dxs_raw(
                 emb_pad, w_all, banks, DISC_R, 1, pooled, idxs, d_pooled),
             100),
            ("decode_sample_embed_bwd",
             lambda: ds.decode_sample_embed_bwd(*bargs), 20)):
        emit({"phase": "wrappers", "kernel": name, "calls": calls,
              "sha256": sha256(fn()),
              "host_us": [host_us(fn, calls) for _ in range(3)],
              **kernel_split(fn)})


# --------------------------------- evaluation decode and caption quality

EVAL_B, EVAL_K, EVAL_G = 64, 4, 2
EVAL_CPU_B, SAMPLE_CPU_B = 4, 8
SCORE_ATOL = 1e-4


def eval_config(**overrides):
    from gan_image_captioning_tpu_torch.config import Config

    return Config(vocab_size=V, gen_embed_dim=E, gen_hidden_dim=H,
                  gen_num_layers=NL, max_seq_len=MAX_SEQ_LEN, **overrides)


def prefix(row):
    """A decoded row through its first <E> (the caption and its mask)."""
    from gan_image_captioning_tpu_torch.data.vocab import END

    row = [int(t) for t in row]
    return row[:row.index(END) + 1] if END in row else row


def step_ties(dec, feats, a, b):
    """Rows whose ids ``a`` and ``b`` differ before the first <E>: at the
    first position t where they part, the gap between the two tokens'
    plain log-probabilities after their common prefix (each must be a tie
    within ``ID_ATOL``, the decode's rule) → (rows differing, max gap)."""
    diff = [i for i in range(a.shape[0])
            if prefix(a[i].tolist()) != prefix(b[i].tolist())]
    if not diff:
        return 0, 0.0
    rows = torch.tensor(diff, device=feats.device)
    logits = teacher_forced_logits(dec, feats[rows], a[rows])
    logp = torch.log_softmax(logits, dim=-1)
    gaps = []
    for j, i in enumerate(diff):
        t = int((a[i] != b[i]).nonzero()[0])
        gaps.append(float((logp[j, t, int(a[i, t])]
                           - logp[j, t, int(b[i, t])]).abs()))
    return len(diff), max(gaps)


def seq_ties(ids_a, s_a, ids_b, s_b):
    """Rows whose decoded sequences differ must score alike (within
    ``SCORE_ATOL``: equally good beams) → (rows differing, max score
    gap over them, max score difference over all rows)."""
    a, b = ids_a.reshape(-1, ids_a.shape[-1]), ids_b.reshape(-1,
                                                              ids_b.shape[-1])
    sa, sb = s_a.reshape(-1), s_b.reshape(-1)
    diff = [i for i in range(a.shape[0]) if not torch.equal(a[i], b[i])]
    gap = max((float((sa[i] - sb[i]).abs()) for i in diff), default=0.0)
    return len(diff), gap, float((sa - sb).abs().max())


def host_ms(fn, calls=5):
    """Host-clock ms per synchronised call of ``fn`` (after one warm call),
    every call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def percentiles(ms):
    return {"p50_ms": float(np.percentile(ms, 50)),
            "p90_ms": float(np.percentile(ms, 90)), "samples": len(ms)}


def eval_counters():
    from gan_image_captioning_tpu_torch.kernels import decode_sample as ds
    from gan_image_captioning_tpu_torch.kernels import disc_conv

    return {"decode_serve": ds.decode_sample,
            "decode_sample_logits": ds.decode_sample_logits,
            "decode_qserve_int8": ds.decode_sample_q_serve,
            "disc_conv_fwd": disc_conv.conv_bank_forward}


def run_entry(fn, argv):
    """An entry point's ``main(argv)`` in this process with every eval
    counter set to 0 just before → (its stdout, seconds, launches)."""
    cnt = eval_counters()
    for c in cnt.values():
        c.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        result = fn(argv)
    torch.cuda.synchronize()
    return (out.getvalue(), result, time.perf_counter() - t0,
            {k: c.launches for k, c in cnt.items()})


def phase_eval_decode(gen, device, workdir):
    """Beam search, diverse beam search and sampled decoding at config3
    width against the serve kernel, the CPU and each other; the beam and
    sample services; the evaluation entry point and the loop's quality
    eval, with the launches of the kernels on their path."""
    from gan_image_captioning_tpu_torch import evaluate as evaluate_main
    from gan_image_captioning_tpu_torch import main as train_main
    from gan_image_captioning_tpu_torch import serve
    from gan_image_captioning_tpu_torch.data.synthetic import synthetic_vocab
    from gan_image_captioning_tpu_torch.eval import decode as decode_lib
    from gan_image_captioning_tpu_torch.eval.metrics import (ids_to_words,
                                                             strip_caption)
    from gan_image_captioning_tpu_torch.kernels.decode_sample import (
        decode_sample)
    from gan_image_captioning_tpu_torch.models.api import init_discriminator
    from gan_image_captioning_tpu_torch.train.checkpoint import (
        save_generator_checkpoint)

    t_phase = time.perf_counter()
    config, dec = eval_config(), gen.decoder
    feats = seeded((EVAL_B, E), 1500, device)
    row = {}

    # beam 1 against the serve kernel's greedy decode
    decode_sample.launches = 0
    ids_k, lps_k = decode_sample(*decode_args(dec, feats), mode="serve")
    check(decode_sample.launches == 1, "serve kernel not launched")
    greedy_lp = decode_lib.masked_logprob_sum(ids_k, lps_k)
    b1_ids, b1_scores = decode_lib.beam_search(gen, feats, config,
                                               beam_size=1)
    n_diff, gap = step_ties(dec, feats, ids_k, b1_ids)
    row["beam1_vs_serve_kernel"] = {
        "rows_differing": n_diff, "max_tie_gap": gap,
        "max_abs_score_diff": float((b1_scores - greedy_lp).abs().max())}
    check(gap <= ID_ATOL, f"beam 1 vs the serve kernel: gap {gap}")

    # beam 4 against greedy: beam search may prune the greedy prefix and
    # end below it, so every row below greedy must be one where the plain
    # beam search on the CPU (the JAX package's algorithm) ends below it
    # by the same margin
    gen_cpu = copy.deepcopy(gen).cpu()
    b4_ids, b4_scores = decode_lib.beam_search(gen, feats, config,
                                               beam_size=EVAL_K)
    margins = b4_scores - greedy_lp
    below = (margins < -1e-4).nonzero()[:, 0]
    row["beam4_vs_greedy"] = {
        "min_score_margin": float(margins.min()),
        "rows_better": int((margins > 1e-4).sum()),
        "rows_below": below.tolist()}
    if below.numel():
        xb = feats[below].cpu()
        ref = (decode_lib.beam_search(gen_cpu, xb, config,
                                      beam_size=EVAL_K)[1]
               - decode_lib.greedy_with_logprobs(gen_cpu, xb, config)[1])
        worst = float((ref - margins[below].cpu()).abs().max())
        row["beam4_vs_greedy"]["cpu_margins_below"] = ref.tolist()
        row["beam4_vs_greedy"]["max_abs_margin_diff_vs_cpu"] = worst
        check(worst <= SCORE_ATOL, f"beam 4 below greedy on the card by "
              f"other margins than the CPU's ({worst})")
    d1_ids, d1_scores = decode_lib.diverse_beam_search(
        gen, feats, config, beam_size=EVAL_K, num_groups=1,
        diversity_strength=0.0)
    n_diff, gap, worst = seq_ties(d1_ids[:, 0], d1_scores[:, 0], b4_ids,
                                  b4_scores)
    row["diverse_g1_vs_beam"] = {"rows_differing": n_diff,
                                 "max_tie_gap": gap,
                                 "max_abs_score_diff": worst}
    check(n_diff == 0 and worst <= 1e-5, f"diverse G=1 vs beam: {n_diff}, "
          f"{worst}")

    # the card against the CPU on the same weights, B = 4 (beam, diverse)
    # and B = 8 (sample on fed noise)
    xb = feats[:EVAL_CPU_B]
    cases = {
        "beam4": lambda g, x: decode_lib.beam_search(
            g, x, config, beam_size=EVAL_K),
        "diverse_k4_g2": lambda g, x: decode_lib.diverse_beam_search(
            g, x, config, beam_size=EVAL_K, num_groups=EVAL_G)}
    for name, fn in cases.items():
        card = fn(gen, xb)
        cpu = fn(gen_cpu, xb.cpu())
        n_diff, gap, worst = seq_ties(card[0].cpu(), card[1].cpu(), *cpu)
        row[f"{name}_card_vs_cpu"] = {"rows_differing": n_diff,
                                      "max_tie_gap": gap,
                                      "max_abs_score_diff": worst}
        check(worst <= SCORE_ATOL, f"{name} card vs CPU: scores {worst}")
        check(gap <= SCORE_ATOL, f"{name} card vs CPU: ids differ")
    noise = seeded((T, SAMPLE_CPU_B, V), 1501, torch.device("cpu"))
    noise = -torch.log(-torch.log(torch.sigmoid(noise)))   # Gumbel noise
    xs = feats[:SAMPLE_CPU_B]
    sample_cases = {"plain": {}, "filtered": dict(top_k=40, top_p=0.9,
                                                  temperature=0.8),
                    "penalized": dict(repetition_penalty=1.3,
                                      no_repeat_ngram=3, min_length=4,
                                      early_stop=True)}
    for name, knobs in sample_cases.items():
        card = decode_lib.sample_decode(gen, xs, config,
                                        noise=noise.to(device), **knobs)
        cpu = decode_lib.sample_decode(gen_cpu, xs.cpu(), config,
                                       noise=noise, **knobs)
        n_diff, gap, worst = seq_ties(card[0].cpu(), card[1].cpu(), *cpu)
        row[f"sample_{name}_card_vs_cpu"] = {"rows_differing": n_diff,
                                             "max_abs_lp_diff": worst}
        check(n_diff == 0 and worst <= SCORE_ATOL,
              f"sample {name} card vs CPU: {n_diff} rows, {worst}")
    del gen_cpu
    rng = torch.Generator(device=device).manual_seed(7)
    top1 = decode_lib.sample_decode(gen, feats, config, rng, top_k=1)[0]
    n_diff, gap = step_ties(dec, feats, ids_k, top1)
    row["sample_top1_vs_serve_kernel"] = {"rows_differing": n_diff,
                                          "max_tie_gap": gap}
    check(gap <= ID_ATOL, f"sample top_k=1 vs greedy: gap {gap}")
    rng = torch.Generator(device=device).manual_seed(8)
    ng = decode_lib.sample_decode(gen, feats, config, rng,
                                  no_repeat_ngram=3)[0].tolist()
    repeats = sum(len(r) - 2 - len({tuple(r[i:i + 3])
                                    for i in range(len(r) - 2)}) for r in ng)
    row["no_repeat_trigram"] = {"repeated_trigrams": repeats,
                                "distinct_ids": len({t for r in ng
                                                     for t in r})}
    check(repeats == 0, f"--no-repeat-ngram 3: {repeats} repeated trigrams")

    # beam_topk's tie order on the card
    x = seeded((EVAL_B, EVAL_K * V), 1502, device)
    x[:, 100:140] = x.max(dim=1, keepdim=True).values + 1.0
    x[1] = 0.5
    vals, idx = decode_lib.beam_topk(x, 8)
    want = torch.arange(100, 108, device=device).expand(EVAL_B, 8).clone()
    want[1] = torch.arange(8, device=device)
    row["beam_topk_ties"] = {"lower_index_first": bool(torch.equal(idx,
                                                                   want))}
    check(torch.equal(idx, want), "beam_topk: ties not to the lower index")

    # ms per call (host clock, synchronised) and launches per call
    # (torch.profiler's kernel events: library kernels included)
    timed = {
        "beam4": lambda: decode_lib.beam_search(gen, feats, config,
                                                beam_size=EVAL_K),
        "diverse_k4_g2": lambda: decode_lib.diverse_beam_search(
            gen, feats, config, beam_size=EVAL_K, num_groups=EVAL_G),
        "sample": lambda: decode_lib.sample_decode(
            gen, feats, config, torch.Generator(device=device), top_p=0.9),
        "greedy_kernel": lambda: decode_sample(*decode_args(dec, feats),
                                               mode="serve")}
    row["timing"] = {name: {"host_ms": host_ms(fn),
                            "kernel_launches_per_call":
                                len(kernel_events(fn, 1))}
                     for name, fn in timed.items()}

    # the services: config2 (conditional) at its own beam 4 answering
    # {"image"} requests; config3 sampling with top-p answering {"n": 8}
    i2w = synthetic_vocab()[1]
    paths = sorted(str(p) for p in (ROOT / "data" / "mini_coco"
                                    / "val2014").glob("*.jpg"))
    check(len(paths) > 0, "no images under data/mini_coco/val2014")
    service = serve.CaptionService(serve.parse_args(
        ["--init-seed", "0", "--preset", "config2", *MODEL_FLAGS,
         "--image-size", str(IMG_S)]))
    try:
        check(service.config.beam_size == 4 and service.mode == "beam",
              "config2 does not serve at beam 4")
        lat, mismatched = [], 0
        for i in range(20):
            path = paths[i % len(paths)]
            resp = service.handle_request({"image": path})
            lat.append(resp["latency_ms"])
            f = service.features_from_images(service._load_images([path]))
            rows = torch.from_numpy(np.repeat(f, service.batch_size,
                                              axis=0)).to(device)
            ids = decode_lib.beam_search(service.dec_params, rows,
                                         service.config, beam_size=4)[0]
            want = " ".join(ids_to_words(strip_caption(ids[0].tolist()),
                                         i2w))
            mismatched += resp["captions"] != [want]
        row["config2_beam_service"] = {"requests": 20,
                                       "mismatched": mismatched,
                                       "caption_0": resp["captions"][0],
                                       **percentiles(lat)}
        check(mismatched == 0, f"config2 beam service: {mismatched} "
              "captions differ from beam_search on the same features")
    finally:
        service.close()
    service = serve.CaptionService(serve.parse_args(
        ["--init-seed", "0", *MODEL_FLAGS, "--decode-mode", "sample",
         "--top-p", "0.9"]))
    try:
        resps = [service.handle_request({"n": 8}) for _ in range(20)]
        for resp in resps:
            check(len(resp["captions"]) == 8 and all(
                math.isfinite(v) for v in resp["logprobs"]),
                f"sample service: {resp}")
        row["config3_sample_service"] = {
            "requests": 20, "distinct_captions": len({c for r in resps
                                                      for c in r["captions"]}),
            **percentiles([r["latency_ms"] for r in resps])}
    finally:
        service.close()

    # evaluate.py on synthetic data at config3 width: a checkpoint of this
    # phase's generator with a discriminator (seeded)
    disc = init_discriminator(torch.Generator().manual_seed(1), config,
                              device, sweep=False)
    ckpt = workdir / "eval_adv_model.ckpt"
    save_generator_checkpoint(str(ckpt), gen, disc.state_dict())
    del disc
    base = [*MODEL_FLAGS, "--checkpoint", str(ckpt), "--synthetic-items",
            "256"]
    runs = {"beam4": ["--beam-size", "4", "--diversity", "--cider",
                      "--rouge", "--meteor", "--multi-ref", "--disc-score"],
            "greedy": [], "greedy_int8": ["--quantize", "int8"]}
    row["evaluate"] = {}
    for name, extra in runs.items():
        _, result, seconds, launches = run_entry(evaluate_main.main,
                                                 [*base, *extra])
        row["evaluate"][name] = {"result": result, "seconds": seconds,
                                 "launches": launches}
        check(all(math.isfinite(v) for v in result.values()),
              f"evaluate {name}: {result}")
        check(0.0 <= result["bleu4"] <= 1.0, f"evaluate {name}: BLEU")
        check(launches["decode_sample_logits"] > 0,
              f"evaluate {name}: NLL_gen without the pretrain decode kernel")
        want = {"beam4": "disc_conv_fwd", "greedy": "decode_serve",
                "greedy_int8": "decode_qserve_int8"}[name]
        check(launches[want] > 0, f"evaluate {name}: {want} not launched")
    check({"cider_d", "rouge_l", "meteor", "self_bleu4", "bleu4_multiref",
           "disc_score_generated"} <= set(row["evaluate"]["beam4"]["result"]),
          "evaluate: a metric is missing")

    # the loop's quality eval: main.py --eval-bleu-every 1 --beam-size 4
    save = workdir / "eval_loop"
    import shutil

    shutil.rmtree(save, ignore_errors=True)
    _, inst, seconds, _ = run_entry(train_main.main, [
        "--preset", "config3", *MODEL_FLAGS, "--synthetic-items", "128",
        "--pretrain-epochs", "1", "--adv-epochs", "1",
        "--eval-bleu-every", "1", "--beam-size", "4",
        "--save-dir", str(save), "--expt-name", "eval"])
    log = open(inst.config.log_file + ".txt").read().splitlines()
    evals = [ln for ln in log if "[EVAL]" in ln]
    check(len(evals) == 1, f"loop: {len(evals)} [EVAL] lines")
    bleu = float(evals[0].split("BLEU-4")[1].split("|")[0])
    check(math.isfinite(bleu) and 0.0 <= bleu <= 1.0, f"loop BLEU {bleu}")
    row["loop"] = {"eval_line": evals[0].split("[EVAL]")[1].strip(),
                   "seconds": seconds}
    row["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "eval_decode", "B": EVAL_B, "beam": EVAL_K, **row,
          "note": "host-clock times; launches per call by torch.profiler "
                  "(every kernel, PyTorch's included)"})
    return row


# ------------------------------- interrupt and resume, and the SCST phase

RESUME_ITEMS = 256
DISC_FLAGS = ["--disc-embed-dim", str(DISC_E), "--disc-num-rep", str(DISC_R),
              "--disc-filter-sizes", ",".join(str(f) for _, f in BANKS),
              "--disc-num-filters", ",".join(str(n) for n, _ in BANKS)]
CONFIG3_FLAGS = ["--preset", "config3", *MODEL_FLAGS, *DISC_FLAGS]
RESUME_FLAGS = [*CONFIG3_FLAGS, "--synthetic-items", str(RESUME_ITEMS),
                "--pretrain-epochs", "1", "--scst-epochs", "1",
                "--adv-epochs", "1", "--checkpoint-every", "1",
                "--keep-checkpoints", "2", "--resume", "auto",
                "--expt-name", "resume"]
# the training entry point under deterministic algorithms; an op without a
# deterministic implementation warns (and is reported) instead of raising
DETERMINISTIC_MAIN = (
    "import sys, torch\n"
    "torch.use_deterministic_algorithms(True, warn_only=True)\n"
    "from gan_image_captioning_tpu_torch import main\n"
    "main.main(sys.argv[1:])\n")
NONDETERMINISTIC = "does not have a deterministic implementation"
RESUME_SIGNAL_DELAY_S = 0.2      # about two SCST steps at config3, B = 64


def training_process(save, log_name):
    """``main.py`` with ``RESUME_FLAGS`` in a new process (cuBLAS's
    workspace fixed before CUDA starts, deterministic algorithms on) →
    ``(Popen, its stderr path)``."""
    import os

    save.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8",
           "PYTHONPATH": str(ROOT)}
    err = save / (log_name + ".stderr")
    with open(save / (log_name + ".stdout"), "w") as out, \
            open(err, "w") as errf:
        proc = subprocess.Popen(
            [sys.executable, "-c", DETERMINISTIC_MAIN, *RESUME_FLAGS,
             "--save-dir", str(save)], cwd=str(ROOT), env=env, stdout=out,
            stderr=errf)
    return proc, err


def finish(proc, err, what, timeout=300):
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise
    text = err.read_text()
    check(rc == 0, f"resume: {what} exited {rc}: {text[-2000:]}")
    return sorted({ln.strip() for ln in text.splitlines()
                   if NONDETERMINISTIC in ln})


def snapshot_diff(a_path, b_path):
    """Per tensor of two full-state files: max |a - b| / max(max |a|, 1e-30),
    and whether every tensor and value is equal."""
    a = torch.load(a_path, map_location="cpu", weights_only=True)
    b = torch.load(b_path, map_location="cpu", weights_only=True)
    diffs, equal = {}, True

    def walk(x, y, key):
        nonlocal equal
        if isinstance(x, dict):
            check(isinstance(y, dict) and x.keys() == y.keys(),
                  f"resume: snapshot keys differ at {key}")
            for k in x:
                walk(x[k], y[k], f"{key}.{k}" if key else k)
        elif isinstance(x, torch.Tensor):
            same = torch.equal(x, y)
            equal &= same
            if not same and x.is_floating_point():
                diffs[key] = float((x - y).abs().max()) / max(
                    float(x.abs().max()), 1e-30)
            elif not same:
                diffs[key] = float("inf")
        else:
            equal &= x == y
            if x != y:
                diffs[key] = float("inf")

    walk(a, b, "")
    return equal, diffs


def phase_resume(workdir):
    """config3 at full width, unconditional, 256 synthetic items: one
    pretrain, one SCST and one adversarial epoch with a snapshot every
    epoch.  Run A uninterrupted; run B gets SIGTERM 0.2 s after its
    first snapshot is written, then the identical command line
    (``--resume auto``) finishes it.  The final snapshots must be
    bit-equal; if they are not, a second uninterrupted run gives the
    spread the resumed run is held to."""
    import shutil

    t0 = time.perf_counter()
    root = workdir / "resume"
    shutil.rmtree(root, ignore_errors=True)
    started = []
    try:
        row = resume_runs(root, started)
    finally:
        for proc in started:            # a failed check leaves none behind
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    row["seconds"] = time.perf_counter() - t0
    emit({"phase": "resume", **row})
    return row


def resume_runs(root, started):
    """Runs A and B of :func:`phase_resume` (each process it starts goes
    into ``started``) → the phase's row."""
    import signal

    def start(save, log_name):
        proc, err = training_process(save, log_name)
        started.append(proc)
        return proc, err

    row = {"nondeterministic_ops": []}
    proc_a, err_a = start(root / "a", "run")
    row["nondeterministic_ops"] += finish(proc_a, err_a, "run A")
    final_a = root / "a" / "resume_1" / "models" / "state_0.ckpt"
    check(final_a.is_file(), "resume: run A wrote no state_0.ckpt")

    save_b = root / "b"
    proc_b, err_b = start(save_b, "first")
    models_1 = save_b / "resume_1" / "models"
    trigger = models_1 / "state_pre_0.ckpt"     # renamed in when written
    deadline = time.time() + 300
    while not trigger.exists() and proc_b.poll() is None:
        check(time.time() < deadline, "resume: run B wrote no snapshot")
        time.sleep(0.01)
    # a moment into the next phase, so that the signal lands in a sweep
    time.sleep(RESUME_SIGNAL_DELAY_S)
    check(proc_b.poll() is None, "resume: run B ended before the signal")
    proc_b.send_signal(signal.SIGTERM)
    row["nondeterministic_ops"] += finish(proc_b, err_b, "run B")
    interrupt = models_1 / "interrupt_state.ckpt"
    check(interrupt.is_file(), "resume: SIGTERM saved no interrupt state")
    side = json.loads((models_1 / "interrupt_state.ckpt.schedule.json")
                      .read_text())
    row["interrupt"] = {k: side[k] for k in ("phase", "epoch",
                                             "batches_done", "scst_step",
                                             "pretrain_steps",
                                             "adv_batch_steps")}
    print("resume: interrupted at phase %s, epoch %d, batch %d"
          % (side["phase"], side["epoch"], side["batches_done"]), flush=True)
    proc_r, err_r = start(save_b, "resumed")
    row["nondeterministic_ops"] += finish(proc_r, err_r, "run B resumed")
    log = (save_b / "resumed.stdout").read_text()
    check(f"Resumed the training state from {interrupt}" in log,
          "resume: the second run did not resume the interrupt state")
    final_b = save_b / "resume_2" / "models" / "state_0.ckpt"
    if not final_b.is_file():           # the signal came after adv epoch 0
        final_b = models_1 / "state_0.ckpt"
    row["final_snapshot_b"] = str(final_b.relative_to(root))
    equal, diffs = snapshot_diff(final_a, final_b)
    row["bit_equal"] = equal
    row["max_rel_diff"] = max(diffs.values(), default=0.0)
    if not equal:
        proc_c, err_c = start(root / "c", "run")
        row["nondeterministic_ops"] += finish(proc_c, err_c, "run A'")
        _, spread = snapshot_diff(
            final_a, root / "c" / "resume_1" / "models" / "state_0.ckpt")
        row["spread_max_rel_diff"] = max(spread.values(), default=0.0)
        row["worst_tensors"] = sorted(diffs.items(), key=lambda kv: -kv[1])[:5]
        check(row["max_rel_diff"] <= row["spread_max_rel_diff"],
              f"resume: the resumed run differs beyond the spread of two "
              f"uninterrupted runs {row}")
    row["nondeterministic_ops"] = sorted(set(row["nondeterministic_ops"]))
    return row


SCST_STEP_CALLS = 5


def scst_counters():
    return {**{k: fn for k, fn in counters().items()
               if k in ("decode_serve", "lstm_bptt_reverse",
                        "decode_sample_logits", "decode_sample_resid",
                        "lstm_bptt_chain")},
            **tf_counters()}


def run_scst_main(argv):
    """``main.main(argv)`` in this process with every counter set to 0
    just before the SCST phase and read just after → (instructor,
    launches in the phase, its seconds)."""
    from gan_image_captioning_tpu_torch import main as train_main
    from gan_image_captioning_tpu_torch.train.instructor import GANInstructor

    cnt, seen = scst_counters(), {}
    real = GANInstructor.scst_finetune

    def counted(self, epochs):
        for fn in cnt.values():
            fn.launches = 0
        t0 = time.perf_counter()
        real(self, epochs)
        torch.cuda.synchronize()
        seen["seconds"] = time.perf_counter() - t0
        seen["launches"] = {k: fn.launches for k, fn in cnt.items()}

    GANInstructor.scst_finetune = counted
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            inst = train_main.main(argv)
    finally:
        GANInstructor.scst_finetune = real
    return inst, seen["launches"], seen["seconds"]


def scst_scalars(inst):
    rows = [json.loads(ln) for ln in open(Path(inst.config.save_dir)
                                          / "metrics.jsonl")]
    return {tag: [r["value"] for r in rows if r["tag"] == tag]
            for tag in ("SCST_val_reward", "SCST_train_loss")}


def phase_scst(device, workdir):
    """``main.py`` with one pretrain and one SCST epoch at config3 width
    (B = 64, 256 synthetic items), then one SCST epoch of config4: the
    launches of the phase against the design, finite rewards; one SCST
    update's loss and gradients through the kernels against the plain
    route; the SCST step's host time split into rollout, reward and
    update, and its launches; ``scst_model.ckpt`` through ``serve.py``
    and ``caption.py``; an asynchronous full-state save followed by an
    in-place step loads the values before the step."""
    import shutil

    from gan_image_captioning_tpu_torch import caption as caption_main
    from gan_image_captioning_tpu_torch import serve
    from gan_image_captioning_tpu_torch.eval.metrics import strip_caption
    from gan_image_captioning_tpu_torch.train import checkpoint as ckpt_lib
    from gan_image_captioning_tpu_torch.train import scst
    from gan_image_captioning_tpu_torch.train.state import create_train_state
    from gan_image_captioning_tpu_torch.train.steps import (_grads,
                                                            make_adv_step)

    t_phase = time.perf_counter()
    root = workdir / "scst"
    shutil.rmtree(root, ignore_errors=True)
    row = {}
    steps = RESUME_ITEMS // B_TRAIN
    val_batches = -(-max(RESUME_ITEMS // 4, 16) // B_TRAIN)

    # config3: the greedy baseline and val decodes through the serve
    # kernel, the update's backward through the reverse BPTT kernel
    argv = [*CONFIG3_FLAGS, "--synthetic-items", str(RESUME_ITEMS),
            "--pretrain-epochs", "1", "--scst-epochs", "1", "--adv-epochs",
            "0", "--save-dir", str(root / "c3"), "--expt-name", "scst"]
    inst, launches, seconds = run_scst_main(argv)
    expected = {k: 0 for k in launches}
    expected.update(decode_serve=steps + val_batches,
                    lstm_bptt_reverse=steps * NL)
    scalars = scst_scalars(inst)
    row["config3"] = {"launches": launches, "expected": expected,
                      "seconds": seconds, "scst_steps": inst._scst_step,
                      **scalars}
    check(launches == expected, f"scst config3 launches {launches} != "
          f"{expected}")
    check(inst._scst_step == steps and inst.state.gen_steps == steps,
          f"scst config3 steps {inst._scst_step}")
    check(all(len(v) == 1 and math.isfinite(v[0]) for v in scalars.values()),
          f"scst config3 scalars {scalars}")
    ckpt = Path(inst.config.model_dir) / "scst_model.ckpt"
    check(ckpt.is_file(), "scst: scst_model.ckpt missing")

    # the checkpoint through serve.py (the greedy kernel) and caption.py
    cnt = scst_counters()
    cnt["decode_serve"].launches = 0
    service = serve.CaptionService(serve.parse_args(
        ["--checkpoint", str(ckpt), *CONFIG3_FLAGS]))
    try:
        resp = service.handle_request({"n": 4})
    finally:
        service.close()
    torch.cuda.synchronize()
    served_launches = cnt["decode_serve"].launches
    check(len(resp["captions"]) == 4 and served_launches > 0
          and all(math.isfinite(x) for x in resp["logprobs"]),
          f"scst: serve {resp}, {served_launches} launches")
    out = root / "captions.jsonl"
    with contextlib.redirect_stdout(io.StringIO()):
        caption_main.main(["--checkpoint", str(ckpt), *CONFIG3_FLAGS,
                           "--decode-mode", "greedy", "--num-samples", "4",
                           "--output", str(out)])
    lines = [json.loads(ln) for ln in out.read_text().splitlines()]
    check(len(lines) == 4 and all("caption" in ln for ln in lines),
          f"scst: caption.py wrote {lines}")
    row["served"] = {"serve": resp["captions"][:2],
                     "serve_launches": served_launches,
                     "caption": [ln["caption"] for ln in lines[:2]]}

    # config4: the update's causal pass through the flash kernels
    argv = [*TF_MODEL_FLAGS, "--synthetic-items", str(RESUME_ITEMS),
            "--pretrain-epochs", "0", "--scst-epochs", "1", "--adv-epochs",
            "0", "--save-dir", str(root / "c4"), "--expt-name", "scst"]
    inst4, launches4, seconds4 = run_scst_main(argv)
    expected4 = {k: 0 for k in launches4}
    expected4.update(flash_fwd=steps * TF_NL, flash_bwd=steps * TF_NL)
    scalars4 = scst_scalars(inst4)
    row["config4"] = {"launches": launches4, "expected": expected4,
                      "seconds": seconds4, **scalars4}
    check(launches4 == expected4, f"scst config4 launches {launches4} != "
          f"{expected4}")
    check(all(len(v) == 1 and math.isfinite(v[0])
              for v in scalars4.values()), f"scst config4 {scalars4}")
    check((Path(inst4.config.model_dir) / "scst_model.ckpt").is_file(),
          "scst: config4 scst_model.ckpt missing")

    # one update through the kernels against the plain route
    config, state, batch = train_setup(device)
    roll, update, _ = scst.make_scst_programs(config)
    sampled, greedy = roll(state.gen, batch,
                           scst.rollout_generator(0, 0, device))
    caps = batch["captions"].cpu().numpy()
    row_refs = [[strip_caption(r)] for r in caps]
    reward_fn = scst.build_reward_fn(config, None, row_refs=row_refs)
    adv_np = scst.batch_advantage(reward_fn, sampled.cpu().numpy(),
                                  greedy.cpu().numpy(), caps)
    check(np.isfinite(adv_np).all(), f"scst: advantage {adv_np}")
    adv = torch.from_numpy(adv_np).to(device)
    if not adv_np.any():        # an untrained model may tie every row
        adv = seeded((B_TRAIN,), 1601, device)
    results = {}
    for route, cfg in (("kernel", config),
                       ("plain", config.replace(decode_impl="plain"))):
        cnt["lstm_bptt_reverse"].launches = 0
        loss = scst.scst_loss(cfg, state, batch, sampled, adv)
        grads, = _grads(loss, state.gen)
        torch.cuda.synchronize()
        results[route] = (loss.detach(), loss.detach() * 0, grads, {},
                          {"gen_ids": sampled})
        row.setdefault("reverse_launches", {})[route] = \
            cnt["lstm_bptt_reverse"].launches
    cmp = compare_grads(results["kernel"], results["plain"])
    row["update_vs_plain"] = {"loss": cmp["g_loss"],
                              "grad_side_rel_err": cmp["grad_side_rel_err"],
                              "max_grad_rel_err": cmp["max_grad_rel_err"],
                              "reverse_launches": row.pop(
                                  "reverse_launches")}
    a, b = cmp["g_loss"]
    check(abs(a - b) <= LOSS_RTOL * max(abs(b), 1e-30),
          f"scst update loss {a} vs {b}")
    check(routes_agree(cmp), f"scst update {cmp['grad_side_rel_err']}")
    check(row["update_vs_plain"]["reverse_launches"] == {"kernel": NL,
                                                         "plain": 0},
          f"scst update reverse launches {row['update_vs_plain']}")

    # the SCST step's host time: rollout, reward, update; its launches
    rng = [scst.rollout_generator(0, 1, device)]

    def do_rollout():
        return roll(state.gen, batch, rng[0])

    s_ids, g_ids = do_rollout()
    s_np, g_np = s_ids.cpu().numpy(), g_ids.cpu().numpy()

    def do_reward():
        return scst.batch_advantage(reward_fn, s_np, g_np, caps)

    def do_update():
        update(state, batch, s_ids, adv)

    def whole_step():
        s, g = do_rollout()
        a = scst.batch_advantage(reward_fn, s.cpu().numpy(),
                                 g.cpu().numpy(), caps)
        update(state, batch, s, torch.from_numpy(a).to(device))

    timing = {"rollout_ms": host_ms(do_rollout, SCST_STEP_CALLS),
              "reward_ms": host_ms(do_reward, SCST_STEP_CALLS),
              "update_ms": host_ms(do_update, SCST_STEP_CALLS),
              "step_ms": host_ms(whole_step, SCST_STEP_CALLS)}
    timing["launches_per_step"] = len(kernel_events(whole_step, 1))
    timing["launches_per_rollout"] = len(kernel_events(do_rollout, 1))
    timing["launches_per_update"] = len(kernel_events(do_update, 1))
    row["step_timing"] = timing
    emit({"phase": "scst", "timing": "step", "B": B_TRAIN, **timing,
          "note": "host clock, synchronised after each part; launches by "
                  "torch.profiler (every kernel, PyTorch's included)"})

    # an asynchronous save, then an in-place step: the file holds the
    # values before the step
    before = {k: v.detach().clone()
              for k, v in ckpt_lib.state_dict_of(state)["gen"].items()}
    mu_before = {k: v.clone() for k, v in state.gen_opt.mu.items()}
    path = root / "async_state.ckpt"
    ckpt_lib.save_state(str(path), state)
    make_adv_step(config)(state, batch, TEMP)
    ckpt_lib.wait_for_checkpoints()
    loaded = ckpt_lib.load_state(str(path), create_train_state(config, 5,
                                                               device))
    same = all(torch.equal(loaded.gen.state_dict()[k], v)
               for k, v in before.items())
    same &= all(torch.equal(loaded.gen_opt.mu[k], v)
                for k, v in mu_before.items())
    moved = any(not torch.equal(state.gen.state_dict()[k], v)
                for k, v in before.items())
    row["async_save"] = {"loads_pre_step_values": same, "step_moved": moved}
    check(same and moved, f"scst: async save {row['async_save']}")
    row["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "scst", **{k: v for k, v in row.items()
                              if k != "step_timing"}})
    return row


# ------------------------------------- step options and batching (config3)

SO_ACCUMS = (2, 4)                 # microbatches of 32 and 16 rows
SO_BUCKETS = (16, 24)              # --length-buckets: widths 16, 24, 36
SO_MULTI_K = 4                     # --steps-per-call
SO_EMA = 0.999
SO_ITEMS = 128
SO_SCHEDULE = dict(lr_schedule="cosine", lr_warmup_steps=2,
                   lr_decay_steps=4, lr_min_ratio=0.1)
# launches per --grad-accum 2 step by design: each microbatch runs what a
# whole batch does (PER_MLE_STEP, PER_ADV_STEP)
PER_ACCUM2_MLE = {k: 2 * v for k, v in PER_MLE_STEP.items()}
PER_ACCUM2_ADV = {k: 2 * v for k, v in PER_ADV_STEP.items()}
# the kernels this slice's path must launch at least once
SO_PATH_KERNELS = ("decode_serve", "decode_sample_resid", "lstm_bptt_chain",
                   "lstm_bptt_reverse", "disc_conv_fwd", "disc_conv_bwd_dx",
                   "gumbel_sample", "flash_fwd", "flash_bwd", "image_norm")
SO_LOOP_KERNELS = ("decode_persistent_kernel", "chain_persistent_kernel",
                   "conv_fwd_kernel", "conv_bwd_kernel")


def so_counters():
    return {**cond_counters(), **tf_counters()}


class DriveCounts:
    """Launches of the slice's drive: each drive segment runs with every
    counter set to 0 just before it and read just after; the comparisons
    with the plain versions run outside the segments and do not count."""

    def __init__(self):
        self.cnt = so_counters()
        self.total = {k: 0 for k in self.cnt}

    @contextlib.contextmanager
    def segment(self, seen=None):
        for fn in self.cnt.values():
            fn.launches = 0
        yield
        torch.cuda.synchronize()
        got = {k: fn.launches for k, fn in self.cnt.items()}
        for k, v in got.items():
            self.total[k] += v
        if seen is not None:
            seen.update(got)


def so_micro_noise(config, device, rows, seed):
    """fed_noise for a microbatch of ``rows`` rows."""
    gen = torch.Generator(device=device).manual_seed(seed)
    keep_shape = (rows * DISC_R, config.disc_feature_dim)
    return {"uniforms": torch.rand((T, rows, V), generator=gen,
                                   device=device),
            "keep": [torch.rand(keep_shape, generator=gen, device=device)
                     < 0.8 for _ in range(3)]}


def so_grads(kind, config, state, batch, noise):
    """The accumulated step's losses and gradients without its update, in
    ``adv_grads``' form: ``adv_grads`` (``adv``), or ``mle_grads`` on the
    ``mle_teacher`` or ``mle_free`` objective."""
    from gan_image_captioning_tpu_torch.train import steps

    if kind == "adv":
        return steps.adv_grads(config, state, batch, TEMP, noise)
    cfg = config.replace(mle_objective=kind.split("_")[1])
    loss, grads = steps.mle_grads(cfg, state, batch)
    return loss, loss * 0, grads, {}, {"gen_ids": torch.zeros(1)}


@contextlib.contextmanager
def greedy_replay(kernel_ids=None):
    """Within it, the free MLE objective's greedy decodes
    (``generator.greedy_ids``, one a microbatch) are recorded
    (``kernel_ids`` None: the list yielded gathers each call's ids), or
    replayed: each decode runs, and the recorded ids of the same call go
    on in its place, so that both routes rescore the same ids, as the
    decode checks teacher-force on the kernel's ids.  Replaying, the list
    yielded gathers per call (rows whose ids differ, the largest plain
    logit gap between the two ids at each such row's first differing
    step, which must be a tie within ``ID_ATOL``)."""
    from gan_image_captioning_tpu_torch.models import generator as gen_lstm

    orig, out = gen_lstm.greedy_ids, []

    def record(decoder, features, seq_len, plain=False):
        ids = orig(decoder, features, seq_len, plain)
        out.append(ids)
        return ids

    def replay(decoder, features, seq_len, plain=False):
        ids = orig(decoder, features, seq_len, plain)
        want = kernel_ids[len(out)]
        rows = (ids != want).any(1).nonzero().flatten()
        gap = 0.0
        if len(rows):
            with torch.no_grad():
                logits = teacher_forced_logits(decoder, features[rows],
                                               want[rows])
            t = (ids[rows] != want[rows]).int().argmax(1)
            at = logits[torch.arange(len(rows), device=rows.device), t]
            gap = float((at.gather(1, ids[rows, t].long()[:, None])
                         - at.gather(1, want[rows, t].long()[:, None]))
                        .abs().max())
        out.append((len(rows), gap))
        return want

    gen_lstm.greedy_ids = record if kernel_ids is None else replay
    try:
        yield out
    finally:
        gen_lstm.greedy_ids = orig


def so_route_check(tag, config, state, batch, noise):
    """One accumulated adversarial, teacher MLE and free MLE pass through
    the kernels against the plain route on the same state and fed noise
    (the conv argmax rows and ReLU decisions replayed, as phase ``train``;
    the free objective's greedy ids replayed, each differing id a tie)."""
    from gan_image_captioning_tpu_torch.kernels import disc_conv

    plain_cfg = config.replace(decode_impl="plain", disc_engine="plain")
    accum = max(1, int(config.grad_accum))
    out = {}
    for kind in ("adv", "mle_teacher", "mle_free"):
        stats = (running_stats(state.gen) if state.gen.encoder is not None
                 else None)
        with disc_conv.argmax_record() as rows, greedy_replay() as ids:
            kern = so_grads(kind, config, state, batch, noise)
        with disc_conv.argmax_replay(rows) as report, \
                greedy_replay(ids) as ties:
            plain = so_grads(kind, plain_cfg, state, batch, noise)
        if stats:
            restore_stats(state.gen, stats)
        cmp = compare_grads(kern, plain)
        gap = max([g for g, _ in report] or [0.0])
        a, b = cmp["g_loss"]
        res = {"loss": cmp["g_loss"], "d_loss": cmp["d_loss"],
               "ids_equal": cmp["ids_equal"], "argmax_gap": gap,
               "max_grad_rel_err": cmp["max_grad_rel_err"],
               "grad_side_rel_err": cmp["grad_side_rel_err"]}
        out[kind] = res
        check(abs(a - b) <= LOSS_RTOL * abs(b), f"{tag} {kind} loss {a} vs "
              f"{b}")
        if kind == "mle_free":
            # the greedy kernel at each microbatch's rows and width
            res["greedy_shapes"] = [list(i.shape) for i in ids]
            res["greedy_rows_differ"] = sum(n for n, _ in ties)
            res["greedy_tie_gap"] = max(g for _, g in ties)
            check(len(ids) == len(ties) == accum,
                  f"{tag}: {len(ids)} greedy decodes for {accum} "
                  "microbatches")
            check(res["greedy_tie_gap"] <= ID_ATOL,
                  f"{tag}: greedy ids {res['greedy_rows_differ']} rows, "
                  f"gap {res['greedy_tie_gap']}")
        if kind == "adv":
            check(cmp["ids_equal"], f"{tag}: the routes sampled other ids")
            check(gap <= TIE_GAP, f"{tag}: argmax gap {gap}")
            c, d = cmp["d_loss"]
            check(abs(c - d) <= LOSS_RTOL * abs(d), f"{tag} d_loss {c} vs "
                  f"{d}")
            check(cmp["max_grad_rel_err"] <= GRAD_RTOL,
                  f"{tag} adv gradients {cmp['max_grad_rel_err']}")
        else:
            check(routes_agree(cmp), f"{tag} mle gradients "
                  f"{cmp['grad_side_rel_err']}")
    return out


class VariedCaptions:
    """Captions of 1-34 tokens in [4, 11000) (every bucket of
    ``SO_BUCKETS`` and the full width gets rows), no images."""

    def __init__(self, n):
        self.lens = np.random.default_rng(61).integers(1, MAX_SEQ_LEN + 1, n)

    def __len__(self):
        return len(self.lens)

    def caption_length(self, i):
        return int(self.lens[i])

    def sample(self, i):
        rng = np.random.default_rng(7000 + i)
        return rng.integers(4, min(11000, V), size=self.lens[i]), None


def so_bucket_batches(device):
    """The first batch of each width of a ``--length-buckets 16,24``
    loader over ``VariedCaptions``."""
    from gan_image_captioning_tpu_torch.data.loader import Batcher
    from gan_image_captioning_tpu_torch.train.steps import batch_to

    loader = Batcher(VariedCaptions(40 * B_TRAIN), B_TRAIN, T, shuffle=True,
                     seed=5, drop_last=True, bucket_bounds=list(SO_BUCKETS))
    by_width = {}
    for b in loader:
        by_width.setdefault(b["captions"].shape[1], b)
    check(sorted(by_width) == [*SO_BUCKETS, T], f"bucket widths "
          f"{sorted(by_width)}")
    return {w: batch_to(b, device) for w, b in sorted(by_width.items())}


def so_width_noise(config, device, width, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    keep_shape = (B_TRAIN * DISC_R, config.disc_feature_dim)
    return {"uniforms": torch.rand((width, B_TRAIN, V), generator=gen,
                                   device=device),
            "keep": [torch.rand(keep_shape, generator=gen, device=device)
                     < 0.8 for _ in range(3)]}


def so_state_snapshot(state):
    """Every tensor a step may change, and the counts."""
    snap = {f"m.{k}": v.detach().clone() for m in (state.gen, state.disc)
            for k, v in m.state_dict().items()}
    for name in ("pretrain_opt", "gen_opt", "disc_opt"):
        opt = getattr(state, name)
        snap.update({f"{name}.mu.{k}": v.clone() for k, v in opt.mu.items()})
        snap.update({f"{name}.nu.{k}": v.clone() for k, v in opt.nu.items()})
    if state.ema_gen is not None:
        snap.update({f"ema.{k}": v.clone() for k, v in state.ema_gen.items()})
    counts = {name: getattr(state, name).count
              for name in ("pretrain_opt", "gen_opt", "disc_opt")}
    return snap, counts


def so_changed(a, b):
    return [k for k in a if not torch.equal(a[k], b[k])]


MULTI_CHILD = (
    "import json, sys, torch\n"
    "torch.use_deterministic_algorithms(True, warn_only=True)\n"
    "import chip_smoke\n"
    "print(json.dumps(chip_smoke.multi_step_child()))\n")


def multi_step_child(device="cuda"):
    """Run in a child process under deterministic algorithms: four
    adversarial steps one by one and the same four in one
    ``--steps-per-call 4`` call, from two equal states; are the states
    bit-equal after?"""
    import warnings

    from gan_image_captioning_tpu_torch.data.loader import (make_batch,
                                                            stack_batches)
    from gan_image_captioning_tpu_torch.train.steps import (batch_to,
                                                            make_adv_step,
                                                            make_multi_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device)
    hosts = []
    for j in range(SO_MULTI_K):
        caps = [np.random.default_rng(100 * j + i).integers(
            4, min(11000, V), size=30) for i in range(B_TRAIN)]
        hosts.append(make_batch(caps, None, T))
    temps = [TEMP * (j + 1) for j in range(SO_MULTI_K)]
    with warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        config, a, _ = train_setup(device)
        _, b, _ = train_setup(device)
        step = make_adv_step(config)
        for host, temp in zip(hosts, temps):
            a, _ = step(a, batch_to(host, device), temp)
        stacked = batch_to(next(stack_batches(iter(hosts), SO_MULTI_K))[0],
                           device)
        b, metrics = make_multi_step(config, "adv")(b, stacked, temps)
        if device.type == "cuda":
            torch.cuda.synchronize()
    sa, ca = so_state_snapshot(a)
    sb, cb = so_state_snapshot(b)
    differ = so_changed(sa, sb)
    return {"steps": SO_MULTI_K, "bit_equal": not differ and ca == cb
            and (a.gen_steps, a.disc_steps) == (b.gen_steps, b.disc_steps)
            and torch.equal(a.generator.get_state(), b.generator.get_state()),
            "differing": differ[:5],
            "max_abs_diff": max([float((sa[k] - sb[k]).abs().max())
                                 for k in differ] or [0.0]),
            "metric_shape": list(metrics["gen_adv_loss"].shape),
            "nondeterministic_ops": sorted({str(w.message)[:160]
                                            for w in warned
                                            if NONDETERMINISTIC
                                            in str(w.message)})}


def so_multi_step(workdir):
    """``multi_step_child`` in a new process (cuBLAS's workspace fixed
    before CUDA starts, deterministic algorithms on, as phase
    ``resume``)."""
    import os

    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8",
           "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", MULTI_CHILD], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    check(proc.returncode == 0, f"steps-per-call child failed: "
          f"{proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def cosine_lr(base, count):
    """The cosine schedule with warmup of ``SO_SCHEDULE``, in float64:
    ``base · c / w`` during the warmup, then ``base · ((1 - a) · (1 + cos(pi
    · min(c - w, D) / D)) / 2 + a)``."""
    w, d = SO_SCHEDULE["lr_warmup_steps"], SO_SCHEDULE["lr_decay_steps"]
    a = SO_SCHEDULE["lr_min_ratio"]
    if count < w:
        return base * count / w
    c = min(count - w, d)
    return base * ((1 - a) * 0.5 * (1 + math.cos(math.pi * c / d)) + a)


def so_timing(config, state, batch):
    """The adversarial step at B = 64, the ``--grad-accum 2`` step at 2 x
    32 and the B = 64 step under ``--skip-nonfinite-grads 1`` (its one
    read of the norms a step) on the same state: ms by host clock in turns
    (64, 2x32, guard, guard, 2x32, 64), and device time by kernel over 2
    steps each of the first two (torch.profiler)."""
    from gan_image_captioning_tpu_torch.train.steps import make_adv_step

    fns = {"b64": make_adv_step(config),
           "2x32": make_adv_step(config.replace(grad_accum=2)),
           "b64_guard": make_adv_step(config.replace(skip_nonfinite_grads=1))}
    ms = {k: [] for k in fns}
    for key in ("b64", "2x32", "b64_guard", "b64_guard", "2x32", "b64"):
        step = fns[key]
        ms[key].append(step_ms(lambda: step(state, batch, TEMP), 4))
    prof = {k: profile_calls(lambda step=fns[k]: step(state, batch, TEMP), 2,
                             KERNEL_NAMES) for k in ("b64", "2x32")}
    return {"host_ms": ms, "device": prof}


def phase_step_options(device, workdir, smi=None):
    """Step options and batching at config3 width (E = H = 512, V =
    11008, B = 64, T = 36): see the module docstring, phase 30.  ``smi``:
    the card's name and power limit, printed with the times."""
    import shutil

    from gan_image_captioning_tpu_torch import main as train_main
    from gan_image_captioning_tpu_torch import serve
    from gan_image_captioning_tpu_torch.kernels import decode_sample as ds
    from gan_image_captioning_tpu_torch.kernels import image_norm as inorm
    from gan_image_captioning_tpu_torch.models import api
    from gan_image_captioning_tpu_torch.models import generator as gen_lstm
    from gan_image_captioning_tpu_torch.models.generator import (
        scheduled_sample)
    from gan_image_captioning_tpu_torch.train import state as state_lib
    from gan_image_captioning_tpu_torch.train.steps import (
        make_adv_step, make_mle_step, split_micro)

    t_phase = time.perf_counter()
    drive = DriveCounts()
    row = {}

    # accumulation: one MLE and one adversarial step at --grad-accum 2,
    # then the accumulated passes at 2 x 32 and 4 x 16 against the plain
    # route on fed noise
    config, state, batch = train_setup(device)
    acc2 = config.replace(grad_accum=2)
    seen = {}
    with drive.segment(seen):
        state, m_mle = make_mle_step(acc2)(state, batch)
        state, m_adv = make_adv_step(acc2)(state, batch, TEMP)
    want = {k: PER_ACCUM2_MLE.get(k, 0) + PER_ACCUM2_ADV.get(k, 0)
            for k in seen}
    row["accum_launches"] = {"launches": seen, "expected": want}
    check(seen == want, f"grad-accum 2 launches {seen} != {want}")
    metrics = {**{k: float(v) for k, v in m_mle.items()},
               **{k: float(v) for k, v in m_adv.items()}}
    check(all(math.isfinite(v) for v in metrics.values()),
          f"grad-accum 2 metrics {metrics}")
    row["accum_routes"] = {}
    for k in SO_ACCUMS:
        cfg = config.replace(grad_accum=k)
        noise = [so_micro_noise(cfg, device, B_TRAIN // k, 300 + 10 * k + i)
                 for i in range(k)]
        row["accum_routes"][k] = so_route_check(f"grad-accum {k}", cfg,
                                                state, batch, noise)
    emit({"phase": "step_options", "accumulation": row["accum_routes"],
          "launches": row["accum_launches"]})

    # buckets: the kernels at T = 16, 24 and 36, one step each through the
    # entry points (launch counts) and against the plain route
    row["buckets"] = {}
    mle, adv = make_mle_step(config), make_adv_step(config)
    for width, wbatch in so_bucket_batches(device).items():
        seen = {}
        with drive.segment(seen):
            state, _ = mle(state, wbatch)
            state, _ = adv(state, wbatch, TEMP)
        want = {k: PER_MLE_STEP.get(k, 0) + PER_ADV_STEP.get(k, 0)
                for k in seen}
        check(seen == want, f"T={width} launches {seen} != {want}")
        noise = so_width_noise(config, device, width, 400 + width)
        res = so_route_check(f"T={width}", config, state, wbatch, noise)
        row["buckets"][width] = {"launches": seen, **res}
    emit({"phase": "step_options", "buckets": row["buckets"]})

    # scheduled sampling: p = 1 against the greedy kernel's logits; p =
    # 0.5 trains
    dec = state.gen.decoder
    feats = api.start_token_features(config, state.gen, B_TRAIN)
    caps = batch["captions"]
    with torch.no_grad():
        ss = scheduled_sample(dec, feats, caps, 1.0)
        ids_k, logits_k = ds.decode_sample_logits(
            *gen_lstm._detached_args(dec, feats, T))
    logits_k = logits_k.transpose(0, 1)
    ss_ids = ss.argmax(-1)
    same = ss_ids == ids_k.long()
    first = torch.where(same.all(1), T, (~same).int().argmax(1))
    t_idx = torch.arange(T, device=device)[None]
    upto = t_idx <= first[:, None].clamp(max=T - 1)
    diff = ((ss - logits_k).abs().amax(-1) * upto).max()
    diverged = (first < T).nonzero().flatten().tolist()
    gaps = [float(ss[r, first[r]].max() - ss[r, first[r], ids_k[r, first[r]]])
            for r in diverged]
    sched = {"max_abs_logit_diff": float(diff), "rows_diverged": diverged,
             "tie_gaps": gaps}
    check(float(diff) <= LP_ATOL, f"scheduled p=1 logits {sched}")
    check(all(g <= ID_ATOL for g in gaps), f"scheduled p=1 ties {sched}")
    ss_cfg = config.replace(mle_objective="scheduled")
    ss_step = make_mle_step(ss_cfg)
    before = {k: v.clone() for k, v in state.gen.state_dict().items()}
    losses = []
    with drive.segment():
        for _ in range(2):
            state, m = ss_step(state, batch, 0.5)
            losses.append(float(m["gen_pretrain_loss"]))
    moved = [k for k, v in state.gen.state_dict().items()
             if not torch.equal(v, before[k])]
    sched.update(losses_p05=losses, params_moved=len(moved))
    check(all(math.isfinite(x) for x in losses) and moved,
          f"scheduled p=0.5 {sched}")
    row["scheduled"] = sched
    emit({"phase": "step_options", "scheduled": sched})

    # the cosine schedule with warmup, the guard and --debug-nans
    cfg = config.replace(ema_decay=SO_EMA, skip_nonfinite_grads=1,
                         **SO_SCHEDULE)
    lrs = [state_lib.lr_at(cfg.pretrain_lr, cfg, c) for c in range(9)]
    want_lrs = [cosine_lr(cfg.pretrain_lr, c) for c in range(9)]
    check(all(abs(a - b) <= 1e-6 * max(abs(b), 1e-30) + 1e-12
              for a, b in zip(lrs, want_lrs)), f"lr {lrs} vs {want_lrs}")
    _, g_state, g_batch = train_setup(device)
    g_state.ema_gen = state_lib.ema_init(g_state.gen)
    mle_g, adv_g = make_mle_step(cfg), make_adv_step(cfg)
    snap0, _ = so_state_snapshot(g_state)
    with drive.segment():
        g_state, _ = mle_g(g_state, g_batch)
    snap1, counts1 = so_state_snapshot(g_state)
    gen_params = {f"m.{k}" for k, _ in g_state.gen.named_parameters()}
    # warmup: the first update's lr is 0, the parameters stay, the
    # moments and the count move
    check(not (set(so_changed(snap0, snap1)) & gen_params)
          and counts1["pretrain_opt"] == 1, "warmup: lr 0 moved parameters")
    poisoned = dict(g_batch, weights=torch.full_like(g_batch["weights"],
                                                     float("nan")))
    steps0 = (g_state.gen_steps, g_state.disc_steps)
    with drive.segment():
        g_state, m_bad = adv_g(g_state, poisoned, TEMP)
        g_state, m_bad2 = mle_g(g_state, poisoned)
    snap2, counts2 = so_state_snapshot(g_state)
    guard = {"changed": so_changed(snap1, snap2)[:5], "counts": counts2,
             "steps": [g_state.gen_steps, g_state.disc_steps],
             "norms": [float(m_bad["gen_grad_norm"]),
                       float(m_bad["disc_grad_norm"]),
                       float(m_bad2["gen_grad_norm"])]}
    check(not guard["changed"] and counts2 == counts1
          and (g_state.gen_steps, g_state.disc_steps)
          == (steps0[0] + 1, steps0[1] + 1)
          and not any(math.isfinite(x) for x in guard["norms"]),
          f"guard {guard}")
    try:
        make_mle_step(cfg.replace(debug_nans=True))(g_state, poisoned)
        raised = None
    except FloatingPointError as exc:
        raised = str(exc)
    check(raised is not None and "gen_pretrain_loss" in raised,
          f"--debug-nans did not raise: {raised}")
    row["schedule_and_guard"] = {"lr": lrs, "guard": guard,
                                 "debug_nans": raised}
    emit({"phase": "step_options", **row["schedule_and_guard"]})
    del g_state, g_batch, poisoned

    # --steps-per-call 4 against four single steps, deterministic
    row["steps_per_call"] = so_multi_step(workdir)
    emit({"phase": "step_options", "steps_per_call": row["steps_per_call"]})
    check(row["steps_per_call"]["bit_equal"],
          f"steps-per-call {row['steps_per_call']}")

    # main.py with the options on: profile trace, EMA checkpoints served
    save = workdir / "step_options"
    shutil.rmtree(save, ignore_errors=True)
    argv = [*CONFIG3_FLAGS, "--synthetic-items", str(SO_ITEMS),
            "--pretrain-epochs", "1", "--adv-epochs", "1", "--ema-decay",
            str(SO_EMA), "--profile-dir", str(save / "profile"),
            "--steps-per-call", "2", "--length-buckets",
            ",".join(str(b) for b in SO_BUCKETS), "--grad-accum", "2",
            "--lr-schedule", "cosine", "--lr-decay-steps", "8",
            "--lr-warmup-steps", "1", "--skip-nonfinite-grads", "1",
            "--save-dir", str(save), "--expt-name", "options"]
    loop = {}
    t0 = time.perf_counter()
    with drive.segment(loop), contextlib.redirect_stdout(io.StringIO()):
        inst = train_main.main(argv)
    loop_s = time.perf_counter() - t0
    trace = json.loads((save / "profile" / "adv_epoch0.trace.json")
                       .read_text())
    names = {ev.get("name", "") for ev in trace["traceEvents"]
             if ev.get("cat") == "kernel"}
    found = {k: any(k in n for n in names) for k in SO_LOOP_KERNELS}
    mdir = Path(inst.config.model_dir)
    cnt = drive.cnt
    cnt["decode_serve"].launches = 0
    service = serve.CaptionService(serve.parse_args(
        ["--checkpoint", str(mdir / "adv_model_ema.ckpt"), *CONFIG3_FLAGS]))
    try:
        resp = service.handle_request({"n": 8})
    finally:
        service.close()
    torch.cuda.synchronize()
    served = cnt["decode_serve"].launches
    row["loop"] = {"seconds": loop_s, "launches": loop,
                   "trace_kernels": found, "trace_kernel_names": len(names),
                   "ema_files": sorted(p.name for p in mdir.glob("*_ema.ckpt")),
                   "served": resp["captions"][:2], "serve_launches": served,
                   "gen_steps": inst.state.gen_steps,
                   "pretrain_steps": inst.pretrain_steps}
    emit({"phase": "step_options", "loop": row["loop"]})
    check(all(found.values()), f"profile trace kernels {found}")
    check(row["loop"]["ema_files"] == ["adv_model_ema.ckpt",
                                       "pretrained_model_ema.ckpt"],
          f"EMA files {row['loop']['ema_files']}")
    check(len(resp["captions"]) == 8 and served > 0
          and all(math.isfinite(x) for x in resp["logprobs"]),
          f"EMA checkpoint served {resp}, {served} launches")

    # config4: a Gumbel adversarial step at --grad-accum 2 under
    # --use-pallas on (the sampler) and off (the plain draw)
    _, tf_state, tf_batch = tf_setup(device)
    row["config4"] = {}
    for mode in ("on", "off"):
        tcfg = tf_config(adv_objective="gumbel", grad_accum=2,
                         use_pallas=mode)
        seen = {}
        with drive.segment(seen):
            tf_state, m = make_adv_step(tcfg)(tf_state, tf_batch, TEMP)
        row["config4"][mode] = {"launches": seen,
                                "metrics": {k: float(v)
                                            for k, v in m.items()}}
        want_g = 2 * T if mode == "on" else 0
        check(seen["gumbel_sample"] == want_g and seen["flash_fwd"] > 0
              and seen["flash_bwd"] > 0, f"config4 use-pallas {mode} "
              f"launches {seen}")
        check(all(math.isfinite(v) for v in
                  row["config4"][mode]["metrics"].values()),
              f"config4 use-pallas {mode} metrics")
    emit({"phase": "step_options", "config4": row["config4"]})
    del tf_state, tf_batch

    # conditional config3: one adversarial step at --grad-accum 2 on
    # uint8 images (image_norm at B = 32), the running statistics of the
    # last microbatch from the old ones
    c_cfg, c_state, c_batch = cond_setup(device, grad_accum=2)
    old = running_stats(c_state.gen)
    seen = {}
    with drive.segment(seen):
        c_state, m = make_adv_step(c_cfg)(c_state, c_batch, TEMP)
    got = running_stats(c_state.gen)
    restore_stats(c_state.gen, old)
    last = split_micro(c_batch, 2)[1]
    plain_cfg = c_cfg.replace(image_norm_impl="plain")
    with torch.no_grad():
        api.generator_condition(plain_cfg, c_state.gen, last, train=True)
    want_stats = running_stats(c_state.gen)
    micro_u8 = last["images_u8"]
    norm_err = float((inorm.normalize_images(micro_u8)
                      - inorm.normalize_images_plain(micro_u8)).abs().max())
    cond = {"launches": seen, "stats_rel_err": stats_rel_err(got, want_stats),
            "image_norm_b32_max_abs_err": norm_err,
            "metrics": {k: float(v) for k, v in m.items()}}
    row["cond"] = cond
    emit({"phase": "step_options", "cond": cond})
    check(seen["image_norm"] == 2 and seen["decode_sample_resid"] == 2,
          f"conditional grad-accum launches {seen}")
    check(cond["stats_rel_err"] <= STAT_RTOL, f"running statistics {cond}")
    check(norm_err <= NORM_ATOL, f"image_norm at B = 32: {norm_err}")
    del c_state, c_batch

    # every kernel of the slice's path launched in the drive
    row["launches"] = dict(drive.total)
    missing = [k for k in SO_PATH_KERNELS if not drive.total.get(k)]
    check(not missing, f"step_options: never launched {missing}")

    # times: the adversarial step at B = 64 and at --grad-accum 2
    row["timing"] = so_timing(config, state, batch)
    emit({"phase": "step_options", "card": smi, "timing": row["timing"]})
    row["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "step_options", "launches": row["launches"],
          "seconds": row["seconds"]})
    return row


def step_options_launches(entry, row):
    """An entry's launches in phase ``step_options``' drive; the fused
    flash backward stands for the dQ and dK/dV entries."""
    name = entry["name"]
    if name in ("flash_dq", "flash_dkv"):
        name = "flash_bwd"
    return row["launches"].get(name, 0)


def scst_launches(entry, scst_row):
    """An entry's launches in the SCST phases (config3 and config4); the
    fused flash backward stands for the dQ and dK/dV entries."""
    name = entry["name"]
    if name in ("flash_dq", "flash_dkv"):
        name = "flash_bwd"
    return sum(scst_row[run]["launches"].get(name, 0)
               for run in ("config3", "config4"))


# ------------------------------------------------------------ bfloat16

BF16 = torch.bfloat16
BF16_UNIT = 2.0 ** -8            # one rounding to bfloat16, relative
BF16_FLOP_PER_S = 989e12         # H100 SXM dense bfloat16 (tensor cores)
# a bfloat16 output of a kernel against its plain version on the same
# bfloat16 inputs: the two round float32 values that differ by a float32
# sum order, so each entry is equal or one bfloat16 step apart (a step of
# a normal x is at most 2^-7 |x|; the least normal float32 as the floor)
BF16_STEP = 2.0 ** -7
# a bfloat16 carry (h, c, gates) against the plain decode's fed the same
# ids: a rounding that tipped at one step moves the later ones too, by
# units of the largest entry (2 of them)
BF16_OUT_UNITS = 2
# a float32 result computed from bfloat16 carries that a rounding of h
# tipped the other way (each such tip moves a logit or a log-probability
# by about one unit): 2 units of the largest |log-probability|
BF16_LP_UNITS = 2
# the step through the kernels against the plain route on the card: the
# routes share the decode's outputs and every PyTorch bfloat16 operation,
# and part only where a kernel's float32 sum in another order (the chain,
# the conv backward) tips a rounding to bfloat16, one unit of that entry,
# which the backward carries through B rows and T steps: losses within 4
# units, each gradient tensor within 8 units of its own largest entry
BF16_LOSS_UNITS, BF16_GRAD_UNITS = 4, 8
# ids: equal, or the kernel's id a tie in the plain decode fed the
# kernel's ids: within 4 units of the largest |score| of its max (each of
# the two scores may sit 2 units off, as the logits do)
BF16_ID_UNITS = 4
BF16_ITEMS = 128
BF16_TPU_KERNELS = {
    "decode_sample_resid_bf16": f"{DECODE_TPU}:121",
    "decode_serve_bf16": f"{DECODE_TPU}:121",
    "decode_sample_logits_bf16": f"{DECODE_TPU}:121",
    "decode_qserve_int8_bf16": Q_TPU_KERNEL,
    "decode_qserve_int4_bf16": Q_TPU_KERNEL,
    "lstm_bptt_chain_bf16": "gan_image_captioning_tpu/kernels/lstm_bptt.py:59",
    "lstm_bptt_reverse_bf16":
        "gan_image_captioning_tpu/kernels/lstm_bptt.py:163",
    "disc_conv_fwd_bf16": f"{DISC_TPU}.py:477",
    "disc_conv_bwd_dx_bf16": f"{DISC_TPU}.py:515",
    "image_norm_bf16": NORM_TPU_KERNEL,
}
BF16_SOURCES = {k: ("decode_serve.cu" if k.startswith("decode")
                    else "lstm_bptt.cu" if k.startswith("lstm")
                    else "disc_conv.cu" if k.startswith("disc")
                    else "image_norm.cu") for k in BF16_TPU_KERNELS}


def bf16_counters():
    """The wrappers behind each bfloat16 entry: each counts every launch
    on ``launches`` and the bfloat16 instantiation's on
    ``bf16_launches``, at the launch."""
    from gan_image_captioning_tpu_torch.kernels import decode_sample as ds
    from gan_image_captioning_tpu_torch.kernels import disc_conv
    from gan_image_captioning_tpu_torch.kernels import image_norm as inorm
    from gan_image_captioning_tpu_torch.kernels.lstm_bptt import (
        lstm_bptt_chain, lstm_bptt_reverse)

    return {"decode_sample_resid_bf16": ds.decode_sample_resid,
            "decode_serve_bf16": ds.decode_sample,
            "decode_sample_logits_bf16": ds.decode_sample_logits,
            "decode_qserve_bf16": ds.decode_sample_q_serve,
            "lstm_bptt_chain_bf16": lstm_bptt_chain,
            "lstm_bptt_reverse_bf16": lstm_bptt_reverse,
            "disc_conv_fwd_bf16": disc_conv.conv_bank_forward,
            "disc_conv_bwd_dx_bf16": disc_conv.conv_bank_backward,
            "image_norm_bf16": inorm.normalize_images}


def bf16_reset():
    cnt = bf16_counters()
    for fn in cnt.values():
        fn.launches = fn.bf16_launches = 0
    return cnt


def bf16_launches(cnt, what):
    """The bfloat16 launches of each wrapper since ``bf16_reset``; fails
    where a wrapper launched its float32 instantiation in a bfloat16
    drive."""
    f32 = {k: fn.launches - fn.bf16_launches for k, fn in cnt.items()
           if fn.launches != fn.bf16_launches}
    check(not f32, f"{what}: float32 launches in a bfloat16 drive {f32}")
    return {k: fn.bf16_launches for k, fn in cnt.items()}


def bf16_bound(nbytes, flops, rate=BF16_FLOP_PER_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def bf16_decode_work(B, kind):
    """The bfloat16 decode's bytes (weights, features and gathered rows 2
    bytes; ids 4; ``resid``: soft and residuals 2 bytes; ``pretrain``:
    logits 2 bytes; ``serve``: lps 4) and its products, whose bfloat16
    operands the tensor cores could take."""
    layer_w = sum(4 * H * ((E if l == 0 else H) + H) + 2 * 4 * H
                  for l in range(NL))
    nbytes = 2 * (layer_w + V * H + V + B * E + B * T * E) + 4 * B * T
    if kind == "resid":
        nbytes += 2 * (T * B * V + T * NL * B * 6 * H)
    elif kind == "pretrain":
        nbytes += 2 * T * B * V
    elif kind == "serve":
        nbytes += 4 * B * T
    flops = 2 * B * T * (sum(4 * H * ((E if l == 0 else H) + H)
                             for l in range(NL)) + V * H)
    return nbytes, flops


def bf16_qserve_work(qdec, B):
    """Payload bytes (int8, or two int4 a byte), float32 scales and
    biases, bfloat16 features; ids and lps out."""
    payload = sum(lq["w"].q.numel() for lq in qdec["lstm_q"])
    payload += qdec["linear"]["w"].q.numel() + qdec["embed"].q.numel()
    small = sum(lq["w"].scale.numel() + lq["b"].numel()
                for lq in qdec["lstm_q"])
    small += (qdec["linear"]["w"].scale.numel() + qdec["linear"]["b"].numel()
              + qdec["embed"].scale.numel())
    nbytes = payload + 4 * small + 2 * B * E + 8 * B * T
    return nbytes, bf16_decode_work(B, "serve")[1]


def bf16_chain_work(B):
    """float32 weights, d_hs and d_pre; bfloat16 gates and cells; the
    products float32 (d_pre is float32)."""
    nbytes = (4 * ((2 * NL - 1) * H * 4 * H + T * B * H
                   + T * NL * B * 4 * H)
              + 2 * (T * NL * B * 4 * H + T * NL * B * H))
    return nbytes, 2 * T * (2 * NL - 1) * B * 4 * H * H


def bf16_reverse_work(B):
    """bfloat16 w_hh, d_hs, gates, c_prev and cs in; float32 d_pre, dh0,
    dc0 out; the products float32."""
    nbytes = (2 * (H * 4 * H + T * B * H + T * B * 4 * H + 2 * T * B * H)
              + 4 * (T * B * 4 * H + 2 * B * H))
    return nbytes, 2 * T * B * 4 * H * H


def bf16_conv_work(B, backward=False):
    q, maxf, lp = B * DISC_R, max(f for _, f in BANKS), T + 4
    n_all = sum(n for n, _ in BANKS)
    emb, w = B * lp * DISC_E, n_all * maxf
    if backward:   # emb, w, pooled, d_pooled bf16 and idx in; f32 out
        nbytes = 2 * (emb + w + 2 * q * n_all) + 4 * q * n_all \
            + 4 * (emb + w + n_all)
        flops = sum(4 * q * n * f for n, f in BANKS)
    else:          # emb, w, b in; pooled bf16, idx out
        nbytes = 2 * (emb + w + n_all + q * n_all) + 4 * q * n_all
        flops = sum(2 * q * n * (T - f + 1) * f for n, f in BANKS)
    return nbytes, flops


def bf16_close(a, b, units, what):
    """max |a - b| (as float32) and the check that it is within ``units``
    bfloat16 units of b's largest entry."""
    a, b = a.float(), b.float()
    err = float((a - b).abs().max())
    tol = units * BF16_UNIT * float(b.abs().max())
    check(err <= tol, f"bf16 {what}: {err} > {tol}")
    return err


def bf16_steps(a, b, what, floor=0.0):
    """bfloat16 ``a`` and ``b`` each entry equal or one bfloat16 step
    apart (``BF16_STEP``), plus ``floor`` times b's largest entry (where a
    float32 sum that cancels far below its terms is rounded) → max |a - b|
    and the largest |a - b| over its bound (at most 1)."""
    a, b = a.float(), b.float()
    bound = (BF16_STEP * torch.maximum(a.abs(), b.abs())
             + floor * float(b.abs().max()) + torch.finfo(torch.float32).tiny)
    ratio = float(((a - b).abs() / bound).max())
    check(ratio <= 1.0, f"bf16 {what}: an entry is {ratio} of a bfloat16 "
          "step off")
    return float((a - b).abs().max()), ratio


def bf16_decoder(dec):
    """A decoder's weights rounded to bfloat16 (the compute cast)."""
    return ([{k: v.to(BF16) for k, v in lp.items()}
             for lp in dec.lstm.layers()], dec.linear.weight.to(BF16),
            dec.linear.bias.to(BF16), dec.embed.weight.to(BF16))


def bf16_forced(weights, feats, ids, u=None, temp=1.0):
    """The plain bfloat16 decode (``decode_sample``'s ``_stack_step`` and
    float32 logits) fed back the given ``ids [B, T]`` → float32 scores
    (logits, + Gumbel noise of ``u`` when given), the soft sample and the
    residuals in bfloat16, and the log-probabilities of ``ids``."""
    from gan_image_captioning_tpu_torch.kernels import decode_sample as ds
    from gan_image_captioning_tpu_torch.ops.gumbel import gumbel_noise

    layers, w_proj, b_proj, embed = weights
    h, c = ds._zero_state(feats, layers)
    x, out = feats, {k: [] for k in ("scores", "soft", "hs", "cs", "gates",
                                     "lps")}
    with torch.no_grad():
        for t in range(ids.shape[1]):
            gates = ds._stack_step(layers, x, h, c)
            logits = ds._logits(h[-1], w_proj, b_proj)
            s = logits if u is None else logits + gumbel_noise(u[t].shape,
                                                               u=u[t])
            idt = ids[:, t].long()
            out["scores"].append(s)
            out["soft"].append(torch.softmax(s * temp, dim=-1).to(BF16))
            out["hs"].append(torch.stack(h))
            out["cs"].append(torch.stack(c).to(BF16))
            out["gates"].append(torch.stack(gates).to(BF16))
            out["lps"].append(torch.log_softmax(logits, -1).gather(
                1, idt[:, None])[:, 0])
            x = embed[idt]
    return {k: torch.stack(v) for k, v in out.items()}


def bf16_id_gap(scores_tm, ids):
    """The largest gap between a step's max score and the score of the
    given id (0 where the id is the argmax), in bfloat16 units of the
    largest |score|: a tie within BF16_ID_UNITS."""
    chosen = scores_tm.gather(2, ids.T.long()[..., None])[..., 0]
    gap = float((scores_tm.max(dim=2).values - chosen).max())
    return gap / (BF16_UNIT * float(scores_tm.abs().max()))


def bf16_time(kern, plain, work, rate=BF16_FLOP_PER_S, **kw):
    """``time_pair`` with the bound of ``work`` at the flop ``rate`` of
    its products' operands (bfloat16 by default)."""
    out = time_pair(kern, plain, work, **kw)
    out["bound_ms"], out["bound_by"] = bf16_bound(*work, rate)
    return out


def bf16_kernels(gen, device):
    """Every bfloat16 instantiation against its plain version on the card,
    in bfloat16, at config3 width (B = 64; the quantized decode at B = 8
    and 64), with its device time beside the plain version's and the
    bound."""
    from gan_image_captioning_tpu_torch.kernels import decode_sample as ds
    from gan_image_captioning_tpu_torch.kernels import disc_conv
    from gan_image_captioning_tpu_torch.kernels import image_norm as inorm
    from gan_image_captioning_tpu_torch.kernels.lstm_bptt import (
        lstm_bptt_chain, lstm_bptt_chain_plain, lstm_bptt_reverse,
        lstm_bptt_reverse_plain)
    from gan_image_captioning_tpu_torch.ops.gumbel import gumbel_noise
    from gan_image_captioning_tpu_torch.ops.quantize import (
        quantize_lstm_decoder)

    B = B_TRAIN
    weights = bf16_decoder(gen.decoder)
    feats = seeded((B, E), 801, device).to(BF16)
    u = torch.rand((T, B, V), generator=torch.Generator(device=device)
                   .manual_seed(802), device=device)
    temp = float(torch.tensor(TEMP, dtype=BF16))
    rows, times = {}, {}

    # sample_resid: the kernel's ids replayed into the plain decode
    ids, soft, hs, cs, gates = ds.decode_sample_resid(
        feats, *weights, T, temperature=temp, uniforms=u)
    check(all(t.dtype == BF16 for t in (soft, hs, cs, gates)),
          "bf16 sample_resid outputs are not bfloat16")
    ref = bf16_forced(weights, feats, ids, u, temp)
    own = ds.decode_sample_resid_plain(feats, *weights, T, u, temp)
    row = {"ids_equal": bool(torch.equal(ids, own[0])),
           "id_gap_units": bf16_id_gap(ref["scores"], ids)}
    check(row["id_gap_units"] <= BF16_ID_UNITS,
          f"bf16 sample_resid ids {row}")
    for name, a in (("hs", hs), ("cs", cs), ("gates", gates)):
        row[f"max_abs_{name}_diff"] = bf16_close(a, ref[name],
                                                 BF16_OUT_UNITS,
                                                 f"sample_resid {name}")
    # the soft sample against the plain one from the kernel's own top h
    # (the same bfloat16 inputs): each entry within a bfloat16 step
    s_own = ds._logits(hs[:, -1], weights[1], weights[2]) + gumbel_noise(
        u.shape, u=u)
    row["max_abs_soft_diff"], row["soft_step_ratio"] = bf16_steps(
        soft, torch.softmax(s_own * temp, dim=-1).to(BF16),
        "sample_resid soft")
    del s_own
    rows["decode_sample_resid_bf16"] = row
    times["decode_sample_resid_bf16"] = bf16_time(
        lambda: ds.decode_sample_resid(feats, *weights, T, temperature=temp,
                                       uniforms=u),
        lambda: ds.decode_sample_resid_plain(feats, *weights, T, u, temp),
        bf16_decode_work(B, "resid"), k_calls=10, p_calls=3,
        plain_events=True)

    # pretrain (the MLE eval step) and greedy (the MLE step): one kernel
    ids_p, logits = ds.decode_sample(feats, *weights, T, mode="pretrain")
    ids_g = ds.decode_sample(feats, *weights, T, mode="greedy")
    ref = bf16_forced(weights, feats, ids_p)
    row = {"greedy_equals_pretrain": bool(torch.equal(ids_g, ids_p)),
           "ids_equal": bool(torch.equal(
               ids_p, ds.decode_sample_logits_plain(feats, *weights,
                                                   T)[0])),
           "id_gap_units": bf16_id_gap(ref["scores"], ids_p),
           "max_abs_logit_diff": bf16_close(logits, ref["scores"],
                                            BF16_OUT_UNITS, "pretrain")}
    check(logits.dtype == BF16, "bf16 pretrain logits are not bfloat16")
    check(row["greedy_equals_pretrain"], "bf16 greedy ids != pretrain ids")
    check(row["id_gap_units"] <= BF16_ID_UNITS, f"bf16 pretrain ids {row}")
    rows["decode_sample_logits_bf16"] = row
    rows["decode_serve_bf16"] = row
    rows["logit_scale"] = float(ref["scores"].abs().max())
    times["decode_sample_logits_bf16"] = bf16_time(
        lambda: ds.decode_sample(feats, *weights, T, mode="pretrain"),
        lambda: ds.decode_sample_logits_plain(feats, *weights, T),
        bf16_decode_work(B, "pretrain"), k_calls=10, p_calls=3,
        plain_events=True)
    times["decode_serve_bf16"] = bf16_time(
        lambda: ds.decode_sample(feats, *weights, T, mode="greedy"),
        lambda: ds.decode_sample_plain(feats, *weights, T),
        bf16_decode_work(B, "greedy"), k_calls=10, p_calls=3,
        plain_events=True)

    # the quantized serve decode in bfloat16, int8 and int4, B = 8 and 64
    for bits in (8, 4):
        name = f"decode_qserve_int{bits}_bf16"
        qdec = quantize_lstm_decoder(gen.decoder, bits)
        qweights = ds.dequantized_decoder(qdec, bits, BF16)
        row = {}
        for b in (8, B):
            f = feats[:b]
            q_ids, q_lps = ds.decode_sample_q_serve(f, qdec, T, bits=bits)
            ref = bf16_forced(qweights, f, q_ids)
            row[f"id_gap_units_b{b}"] = bf16_id_gap(ref["scores"], q_ids)
            row[f"max_abs_lp_diff_b{b}"] = bf16_close(
                q_lps, ref["lps"].T, BF16_LP_UNITS, f"{name} lps B={b}")
            check(row[f"id_gap_units_b{b}"] <= BF16_ID_UNITS,
                  f"{name} ids {row}")
        rows[name] = row
        times[name] = bf16_time(
            lambda: ds.decode_sample_q_serve(feats[:8], qdec, T, bits=bits),
            lambda: ds.decode_sample_q_serve_plain(feats[:8], qdec, T,
                                                   bits=bits),
            bf16_qserve_work(qdec, 8), k_calls=10, p_calls=3,
            plain_events=True)
        times[name]["B"] = 8

    # the BPTT chain on the decode's bfloat16 residuals
    layers = weights[0]
    w_hhs = torch.stack([lp["w_hh"].T.float() for lp in layers]).contiguous()
    w_ihs = torch.stack([lp["w_ih"].T.float() for lp in layers[1:]]
                        or [w_hhs[0]]).contiguous()
    d_hs = seeded((T, B, H), 803, device, 1e-3)
    d_pre = lstm_bptt_chain(w_hhs, w_ihs, d_hs, gates, cs)
    d_pre_p = lstm_bptt_chain_plain(w_hhs, w_ihs, d_hs, gates, cs)
    err = float((d_pre - d_pre_p).abs().max())
    check(err <= CHAIN_RTOL * float(d_pre_p.abs().max()),
          f"bf16 chain d_pre {err}")
    rows["lstm_bptt_chain_bf16"] = {"max_abs_diff": err}
    times["lstm_bptt_chain_bf16"] = bf16_time(
        lambda: lstm_bptt_chain(w_hhs, w_ihs, d_hs, gates, cs),
        lambda: lstm_bptt_chain_plain(w_hhs, w_ihs, d_hs, gates, cs),
        bf16_chain_work(B), F32_FLOP_PER_S, k_calls=10, p_calls=3,
        plain_events=True)

    # the reverse BPTT, every input bfloat16
    w_hh = layers[0]["w_hh"].T.contiguous()
    g0, c0 = gates[:, 0].contiguous(), cs[:, 0].contiguous()
    c_prev = torch.cat([torch.zeros_like(c0[:1]), c0[:-1]]).contiguous()
    d_hs16 = d_hs.to(BF16)
    out_k = lstm_bptt_reverse(w_hh, d_hs16, g0, c_prev, c0)
    out_p = lstm_bptt_reverse_plain(w_hh, d_hs16, g0, c_prev, c0)
    row = {}
    for name, a, b in zip(("d_pre", "dh0", "dc0"), out_k, out_p):
        row[f"max_abs_{name}_diff"] = float((a - b).abs().max())
        check(a.dtype == torch.float32, f"bf16 reverse {name} dtype")
        check(row[f"max_abs_{name}_diff"]
              <= CHAIN_RTOL * max(float(b.abs().max()), 1e-30),
              f"bf16 reverse {name} {row}")
    rows["lstm_bptt_reverse_bf16"] = row
    times["lstm_bptt_reverse_bf16"] = bf16_time(
        lambda: lstm_bptt_reverse(w_hh, d_hs16, g0, c_prev, c0),
        lambda: lstm_bptt_reverse_plain(w_hh, d_hs16, g0, c_prev, c0),
        bf16_reverse_work(B), F32_FLOP_PER_S, k_calls=10, p_calls=3,
        plain_events=True)

    # the mxu conv forward and backward (the raw gradient: the step's
    # route), every input bfloat16
    emb_pad, w_all, b_all, banks = (t.to(BF16) if torch.is_tensor(t) else t
                                    for t in conv_inputs(device))
    pooled, idx = disc_conv.conv_bank_forward(emb_pad, w_all, b_all, banks,
                                              DISC_R, 1)
    pooled_p, idx_p = disc_conv.conv_relu_maxpool_plain(emb_pad, w_all,
                                                        b_all, banks,
                                                        DISC_R, 1)
    bad, ties = idx_mismatch(emb_pad.float(), w_all.float(), b_all.float(),
                             banks, pooled_p.float(), idx, idx_p)
    check(pooled.dtype == BF16, "bf16 conv pooled is not bfloat16")
    err, ratio = bf16_steps(pooled, pooled_p, "conv pooled")
    rows["disc_conv_fwd_bf16"] = {
        "max_abs_pooled_diff": err, "pooled_step_ratio": ratio,
        "idx_mismatch_outside_ties": bad, "near_ties": ties}
    check(bad == 0, f"bf16 conv argmax rows differ outside ties: {bad}")
    times["disc_conv_fwd_bf16"] = bf16_time(
        lambda: disc_conv.conv_bank_forward(emb_pad, w_all, b_all, banks,
                                            DISC_R, 1),
        lambda: disc_conv.conv_relu_maxpool_plain(emb_pad, w_all, b_all,
                                                  banks, DISC_R, 1),
        bf16_conv_work(B))
    d_pooled = seeded(tuple(pooled.shape), 804, device).to(BF16)
    got = disc_conv.conv_bank_backward_raw(emb_pad, w_all, banks, DISC_R, 1,
                                           pooled, idx, d_pooled)
    want = disc_conv.conv_rows_backward_plain(emb_pad, w_all, banks, DISC_R,
                                              1, pooled, idx, d_pooled)
    row = {}
    for name, a, b, rtol in (("dx", got[0], want[0], DX_ATOL),
                             ("dw", got[1], want[1], DW_RTOL),
                             ("db", got[2], want[2], DX_ATOL)):
        row[f"max_abs_{name}_diff"] = float((a - b).abs().max())
        check(row[f"max_abs_{name}_diff"]
              <= rtol * max(1.0, float(b.abs().max())),
              f"bf16 conv backward {name} {row}")
    rows["disc_conv_bwd_dx_bf16"] = row
    times["disc_conv_bwd_dx_bf16"] = bf16_time(
        lambda: disc_conv.conv_bank_backward_raw(
            emb_pad, w_all, banks, DISC_R, 1, pooled, idx, d_pooled),
        lambda: disc_conv.conv_rows_backward_plain(
            emb_pad, w_all, banks, DISC_R, 1, pooled, idx, d_pooled),
        bf16_conv_work(B, backward=True), p_calls=5, plain_events=True)

    # image_norm into bfloat16, B = 64 at 256 x 256
    u8 = seeded_u8((B, 3, IMG_S, IMG_S), 805, device)
    out_k = inorm.normalize_images(u8, BF16)
    out_p = inorm.normalize_images_plain(u8, BF16)
    rows["image_norm_bf16"] = {
        "bit_equal": bool(torch.equal(out_k, out_p)),
        "max_abs_diff": float((out_k.float() - out_p.float()).abs().max())}
    check(out_k.dtype == BF16 and rows["image_norm_bf16"]["bit_equal"],
          f"bf16 image_norm {rows['image_norm_bf16']}")
    n = u8.numel()
    # the library call: torch.addcmul of the same affine map into a
    # bfloat16 output
    scale, shift = inorm._affine(device)
    lib_out = torch.empty(u8.shape, dtype=BF16, device=device)
    library = lambda: torch.addcmul(shift, u8, scale,      # noqa: E731
                                    out=lib_out)
    library()
    rows["image_norm_bf16"]["library_max_abs_diff"] = float(
        (lib_out.float() - out_p.float()).abs().max())
    kern = lambda: inorm.normalize_images(u8, BF16)       # noqa: E731
    k_a, l_a = (device_ms(f, 50) for f in (kern, library))
    l_b, k_b = (device_ms(f, 50) for f in (library, kern))
    times["image_norm_bf16"] = {
        "kernel_ms": [k_a, k_b], "library_ms": [l_a, l_b],
        "library": "torch.addcmul(shift, u8, scale, out=bfloat16)",
        "plain_ms": [cuda_ms(lambda: inorm.normalize_images_plain(u8, BF16),
                             reps=20) for _ in range(2)],
        "plain_timer": "cuda_ms"}
    times["image_norm_bf16"].update(zip(("bound_ms", "bound_by"),
                                        bf16_bound(3 * n, 2 * n,
                                                   F32_FLOP_PER_S)))
    from gan_image_captioning_tpu_torch.kernels import lstm_bptt

    emit({"phase": "bf16", "kernel_attrs": {
        "decode_persistent_kernel": ds.kernel_attrs(bf16=True),
        "decode_persistent_kernel_quantized": ds.kernel_attrs(True, True),
        "chain_persistent_kernel": lstm_bptt.kernel_attrs("chain", True),
        "reverse_persistent_kernel": lstm_bptt.kernel_attrs("reverse",
                                                            True)}})
    for name in BF16_TPU_KERNELS:
        emit({"phase": "bf16", "kernel": name, **rows[name],
              **{k: v for k, v in times[name].items()
                 if k in ("kernel_ms", "plain_ms", "bound_ms", "bound_by",
                          "plain_timer", "B", "library_ms", "library")}})
    return rows, times


def bf16_config(**overrides):
    from gan_image_captioning_tpu_torch.config import Config

    return Config(vocab_size=V, gen_embed_dim=E, gen_hidden_dim=H,
                  gen_num_layers=NL, max_seq_len=MAX_SEQ_LEN,
                  disc_embed_dim=DISC_E, disc_num_rep=DISC_R,
                  disc_filter_sizes=tuple(f for _, f in BANKS),
                  disc_num_filters=tuple(n for n, _ in BANKS),
                  disc_train_freq=DISC_EVERY, dtype="bfloat16",
                  bf16_mu=True, **overrides)


@contextlib.contextmanager
def bf16_resid_record():
    """Within it, the kernel route's ``sample_resid`` decodes are recorded
    in call order: ``(ids, soft, hs, cs, gates)`` each."""
    from gan_image_captioning_tpu_torch.models import generator as gen_lstm

    orig, out = gen_lstm.decode_sample_resid, []

    def record(*args, **kwargs):
        out.append(orig(*args, **kwargs))
        return out[-1]

    gen_lstm.decode_sample_resid = record
    try:
        yield out
    finally:
        gen_lstm.decode_sample_resid = orig


@contextlib.contextmanager
def bf16_resid_replay(kernel_outs):
    """Within it, the plain route's ``sample_resid`` decodes return the
    kernel route's outputs of the same call (in call order), so the two
    routes' steps share the sample and its residuals; each call first
    checks them against the plain computation from the plain route's own
    arguments: the soft sample entry by entry within a bfloat16 step of
    the softmax of the kernel's top h (``bf16_steps``), and the kernel's
    ids a tie of the plain decode fed those ids.  The list yielded
    gathers ``(id gap in bfloat16 units, soft step ratio)`` a call."""
    from gan_image_captioning_tpu_torch.kernels import decode_sample as ds
    from gan_image_captioning_tpu_torch.models import generator as gen_lstm
    from gan_image_captioning_tpu_torch.ops.gumbel import gumbel_noise

    orig, out = gen_lstm.decode_sample_resid_plain, []

    def shared(features, layers, w_proj, b_proj, embed, seq_len, uniforms,
               temperature):
        ids, soft, hs, cs, gates = kernel_outs[len(out)]
        ref = bf16_forced((layers, w_proj, b_proj, embed), features, ids,
                          uniforms, temperature)
        s = ds._logits(hs[:, -1], w_proj, b_proj) + gumbel_noise(
            uniforms.shape, u=uniforms)
        _, ratio = bf16_steps(soft, torch.softmax(s * temperature, dim=-1)
                              .to(soft.dtype), "step soft sample")
        out.append((bf16_id_gap(ref["scores"], ids), ratio))
        return ids, soft, hs, cs, gates

    gen_lstm.decode_sample_resid_plain = shared
    try:
        yield out
    finally:
        gen_lstm.decode_sample_resid_plain = orig


def bf16_grad_errs(a, b):
    """Each gradient tensor's largest difference over its own largest
    entry, by ``side.name``."""
    out = {}
    for side, ga, gb in (("gen", a[2], b[2]), ("disc", a[3], b[3])):
        for k in gb:
            out[f"{side}.{k}"] = (float((ga[k] - gb[k]).abs().max())
                                  / max(float(gb[k].abs().max()), 1e-30))
    return out


def bf16_train(gen, device, logit_scale):
    """``--dtype bfloat16`` steps with ``bf16_mu`` at config3: 3 MLE steps, 4
    adversarial steps and an MLE eval step through the kernels with the
    launch counts of the design, none of them float32; one adversarial
    and one MLE pass through the kernels against the plain route on the
    same state and fed noise, each gradient tensor within
    ``BF16_GRAD_UNITS`` of its own largest entry.  The adversarial routes
    share the decode's outputs (``bf16_resid_replay``, which holds them
    to the plain computation entry by entry): with two decodes the
    discriminator's dense-layer gradients, differences of nearly equal
    sums over the real and the fake rows at this state, magnify a
    bfloat16 step of the soft sample to 8-14 units of their own largest
    entry (call 10)."""
    from gan_image_captioning_tpu_torch.kernels import disc_conv
    from gan_image_captioning_tpu_torch.models import api
    from gan_image_captioning_tpu_torch.train.state import create_train_state
    from gan_image_captioning_tpu_torch.train.steps import (
        adv_grads, make_adv_step, make_mle_eval_step, make_mle_step,
        mle_grads)

    config = bf16_config()
    disc = api.init_discriminator(torch.Generator().manual_seed(1), config,
                                  device, sweep=False)
    g = copy.deepcopy(gen).requires_grad_(True)
    state = create_train_state(config, 0, device, gen=g, disc=disc)
    batch = train_batch(device)
    mle, adv = make_mle_step(config), make_adv_step(config)
    evals = make_mle_eval_step(config)
    cnt = bf16_reset()
    metrics = []
    for _ in range(MLE_STEPS):
        state, m = mle(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    for _ in range(ADV_STEPS):
        state, m = adv(state, batch, TEMP)
        metrics.append({k: float(v) for k, v in m.items()})
    _, m = evals(state, batch)
    metrics.append({k: float(v) for k, v in m.items()})
    torch.cuda.synchronize()
    launches = bf16_launches(cnt, "bf16 steps")
    expected = {"decode_serve_bf16": MLE_STEPS,
                "lstm_bptt_reverse_bf16": MLE_STEPS * NL,
                "decode_sample_resid_bf16": ADV_STEPS,
                "lstm_bptt_chain_bf16": ADV_STEPS,
                "disc_conv_fwd_bf16": 3 * ADV_STEPS,
                "disc_conv_bwd_dx_bf16": 3 * ADV_STEPS,
                "decode_sample_logits_bf16": 1}
    check(all(math.isfinite(x) for m in metrics for x in m.values()),
          f"bf16 non-finite metric {metrics}")
    check({k: launches[k] for k in expected} == expected,
          f"bf16 launches {launches} != {expected}")
    check(all(v.dtype == BF16 for opt in (state.pretrain_opt, state.gen_opt,
                                          state.disc_opt)
              for v in opt.mu.values()), "bf16_mu: a first moment is not "
          "bfloat16")
    check(all(p.dtype == torch.float32 for m in (state.gen, state.disc)
              for p in m.parameters()), "a master weight is not float32")
    row = {"metrics": metrics, "launches": launches,
           "expected_launches": expected}

    # the routes: the plain route takes the kernel route's conv argmax
    # rows, ReLU decisions, sampled and greedy ids
    noise = fed_noise(config, device)
    plain_cfg = config.replace(decode_impl="plain", disc_engine="plain")
    with disc_conv.argmax_record() as rec, bf16_resid_record() as outs:
        kern = adv_grads(config, state, batch, TEMP, noise)
    with disc_conv.argmax_replay(rec) as report, \
            bf16_resid_replay(outs) as gaps:
        plain = adv_grads(plain_cfg, state, batch, TEMP, noise)
    # a conv argmax or ReLU decision the routes take differently is a tie
    # within 4 units of the largest pooled value or ReLU input recorded
    # (the conv's inputs are bfloat16 products that may sit a unit apart)
    tie_scale = max([float(p.abs().max()) for _, p in rec["pool"]]
                    + [float(x.abs().max()) for x in rec["relu"]])
    adv_cmp = {"g_loss": [float(kern[0]), float(plain[0])],
               "d_loss": [float(kern[1]), float(plain[1])],
               "grad_rel_err": bf16_grad_errs(kern, plain),
               "argmax_gap_units": max(gp for gp, _ in report)
               / (BF16_UNIT * tie_scale),
               "id_gap_units": max(g for g, _ in gaps),
               "soft_step_ratio": max(r for _, r in gaps)}
    with greedy_replay() as k_ids:
        k_loss, k_g = mle_grads(config, state, batch)
    with greedy_replay(k_ids) as replayed:
        p_loss, p_g = mle_grads(plain_cfg, state, batch)
    mle_cmp = {"loss": [float(k_loss), float(p_loss)],
               "grad_rel_err": {
                   f"gen.{k}": float((k_g[k] - p_g[k]).abs().max())
                   / max(float(p_g[k].abs().max()), 1e-30) for k in p_g},
               "greedy_replay": replayed}
    row.update(adv_vs_plain=adv_cmp, mle_vs_plain=mle_cmp)
    emit({"phase": "bf16", "train": row})
    check(adv_cmp["argmax_gap_units"] <= BF16_ID_UNITS
          and adv_cmp["id_gap_units"] <= BF16_ID_UNITS,
          f"bf16 adversarial ties {adv_cmp}")
    # greedy_replay's gaps are of the plain route's bfloat16 logits, whose
    # largest |entry| the phase's pretrain check measured
    check(all(gap <= BF16_ID_UNITS * BF16_UNIT * logit_scale
              for _, gap in replayed), f"bf16 greedy ties {replayed}")
    for a, b in (adv_cmp["g_loss"], adv_cmp["d_loss"], mle_cmp["loss"]):
        check(abs(a - b) <= BF16_LOSS_UNITS * BF16_UNIT * abs(b),
              f"bf16 losses {adv_cmp} {mle_cmp}")
    check(max(adv_cmp["grad_rel_err"].values()) <= BF16_GRAD_UNITS
          * BF16_UNIT and max(mle_cmp["grad_rel_err"].values())
          <= BF16_GRAD_UNITS * BF16_UNIT,
          f"bf16 gradients {adv_cmp} {mle_cmp}")
    return row, (config, state, batch)


def bf16_cond(device):
    """The conditional bfloat16 step on 256 x 256 ``images_u8``: one MLE
    and one adversarial step, ``image_norm``'s bfloat16 instantiation
    once each, the running statistics kept in bfloat16."""
    from gan_image_captioning_tpu_torch.train.steps import (make_adv_step,
                                                            make_mle_step)

    config, state, batch = cond_setup(device, dtype="bfloat16",
                                      bf16_mu=True)
    cnt = bf16_reset()
    state, m1 = make_mle_step(config)(state, batch)
    state, m2 = make_adv_step(config)(state, batch, TEMP)
    torch.cuda.synchronize()
    launches = bf16_launches(cnt, "bf16 conditional")
    stats = running_stats(state.gen)
    row = {"metrics": {k: float(v) for m in (m1, m2) for k, v in m.items()},
           "launches": launches,
           "stats_dtypes": sorted({str(v.dtype) for v in stats.values()})}
    emit({"phase": "bf16", "conditional": row})
    check(all(math.isfinite(v) for v in row["metrics"].values()),
          f"bf16 conditional {row}")
    check(launches["image_norm_bf16"] == 2 and
          launches["decode_sample_resid_bf16"] == 1 and
          launches["decode_serve_bf16"] == 1,
          f"bf16 conditional launches {launches}")
    check(row["stats_dtypes"] == ["torch.bfloat16"],
          f"bf16 running statistics {row['stats_dtypes']}")
    return row


def bf16_main(argv):
    """``main.main(argv)`` in this process with the config given
    ``bf16_mu`` (a ``Config`` field, as the JAX package's ``GIC_BF16_MU``
    is no flag) → (instructor, launches, seconds, logged metrics)."""
    from gan_image_captioning_tpu_torch import main as train_main

    real = train_main.config_from_args
    train_main.config_from_args = lambda args: real(args).replace(
        bf16_mu=True)
    cnt = bf16_reset()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            inst = train_main.main(argv)
    finally:
        train_main.config_from_args = real
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    rows = [json.loads(ln) for ln in open(Path(inst.config.save_dir)
                                          / "metrics.jsonl")]
    check(inst.config.dtype == "bfloat16" and inst.config.bf16_mu,
          "bf16 loop: the flags did not reach the config")
    check(rows and all(math.isfinite(r["value"]) for r in rows),
          "bf16 loop: non-finite metric")
    return inst, bf16_launches(cnt, "bf16 loop"), seconds


def bf16_loop(workdir):
    """``main.py --dtype bfloat16`` (with ``bf16_mu``): one pretrain and
    one adversarial epoch of 128 synthetic items with a full-state
    snapshot per epoch, the snapshot then loaded back; and conditional
    config3 on the repository's COCO sample (at ``IMG_S``, batches of 8,
    ``--device-preprocess 1``: ``images_u8``
    batches through ``image_norm``'s bfloat16 instantiation), one epoch
    each; every kernel of the path launched in both."""
    import shutil

    from gan_image_captioning_tpu_torch.train import checkpoint as ckpt
    from gan_image_captioning_tpu_torch.train.state import create_train_state

    shutil.rmtree(workdir / "bf16_loop", ignore_errors=True)
    common = [*CONFIG3_FLAGS, "--dtype", "bfloat16", "--pretrain-epochs",
              "1", "--adv-epochs", "1", "--save-dir",
              str(workdir / "bf16_loop")]
    inst, launches, seconds = bf16_main(
        [*common, "--synthetic-items", str(BF16_ITEMS), "--checkpoint-every",
         "1", "--expt-name", "bf16"])
    snaps = sorted(Path(inst.config.model_dir).glob("state_*.ckpt"))
    check(snaps, "bf16 loop: no full-state snapshot")
    back = ckpt.load_state(str(snaps[-1]), create_train_state(
        inst.config, 0, next(inst.state.gen.parameters()).device))
    row = {"seconds": seconds, "launches": launches,
           "snapshot": snaps[-1].name,
           "pretrain_steps": inst.pretrain_steps,
           "gen_steps": inst.state.gen_steps,
           "mu_dtypes": sorted({str(v.dtype) for opt in (
               back.pretrain_opt, back.gen_opt, back.disc_opt)
               for v in opt.mu.values()})}
    check(row["mu_dtypes"] == ["torch.bfloat16"],
          f"bf16 loop: reloaded mu {row['mu_dtypes']}")
    for k in ("decode_serve_bf16", "decode_sample_resid_bf16",
              "lstm_bptt_chain_bf16", "lstm_bptt_reverse_bf16",
              "disc_conv_fwd_bf16", "disc_conv_bwd_dx_bf16"):
        check(launches[k] > 0, f"bf16 loop: {k} never launched")
    # the sample's training split: batches of 8 (3 steps a phase)
    inst, launches, seconds = bf16_main(
        [*common, "--dataset", "coco", "--data-dir",
         str(ROOT / "data" / "mini_coco"), "--captions-per-image", "5",
         "--conditional-gan", "1", "--device-preprocess", "1",
         "--image-size", str(IMG_S), "--expt-name", "bf16_cond",
         *(x for f in ("pre-train", "pre-eval", "adv-train", "adv-eval")
           for x in (f"--{f}-batch-size", "8"))])
    stats = running_stats(inst.state.gen)
    row["conditional"] = {
        "seconds": seconds, "launches": launches,
        "pretrain_steps": inst.pretrain_steps,
        "gen_steps": inst.state.gen_steps,
        "stats_dtypes": sorted({str(v.dtype) for v in stats.values()})}
    emit({"phase": "bf16", "loop": row})
    check(inst.pretrain_steps > 0 and inst.state.gen_steps > 0,
          f"bf16 conditional loop steps {row['conditional']}")
    for k in ("image_norm_bf16", "decode_serve_bf16",
              "decode_sample_resid_bf16", "lstm_bptt_chain_bf16",
              "lstm_bptt_reverse_bf16", "disc_conv_bwd_dx_bf16"):
        check(launches[k] > 0, f"bf16 conditional loop: {k} never launched "
              f"{launches}")
    check(row["conditional"]["stats_dtypes"] == ["torch.bfloat16"],
          f"bf16 conditional loop statistics {row['conditional']}")
    return row


def bf16_service(gen, workdir):
    """``serve.main --quantize int8|int4 --dtype bfloat16``: ``{"n": 8}``
    requests; each caption the plain quantized decode in bfloat16 of the
    same row (ids equal, or each served id a tie), the quantized kernel's
    launches equal to the engine's ``device_calls``."""
    from gan_image_captioning_tpu_torch import serve
    from gan_image_captioning_tpu_torch.data.synthetic import synthetic_vocab
    from gan_image_captioning_tpu_torch.eval.metrics import (ids_to_words,
                                                             strip_caption)
    from gan_image_captioning_tpu_torch.kernels import decode_sample as ds
    from gan_image_captioning_tpu_torch.models.generator import (
        start_token_features)
    from gan_image_captioning_tpu_torch.ops.quantize import (
        quantize_lstm_decoder)
    from gan_image_captioning_tpu_torch.train.checkpoint import (
        save_generator_checkpoint)

    path = workdir / "gen_full_width_bf16.ckpt"
    save_generator_checkpoint(str(path), gen)
    out = {}
    for bits in (8, 4):
        reqs = [{"n": 8}, {"n": 8}, {"stats": True}]
        stdin = io.StringIO("".join(json.dumps(r) + "\n" for r in reqs))
        buf = io.StringIO()
        cnt = bf16_reset()
        old = sys.stdin
        try:
            sys.stdin = stdin
            with contextlib.redirect_stdout(buf):
                serve.main(["--checkpoint", str(path), *MODEL_FLAGS,
                            "--quantize", f"int{bits}", "--dtype",
                            "bfloat16"])
        finally:
            sys.stdin = old
        lines = [json.loads(ln) for ln in buf.getvalue().splitlines()]
        resps, stats = lines[1:3], lines[3]["coalescing"]
        launches = bf16_launches(cnt, "bf16 service")["decode_qserve_bf16"]
        feats = start_token_features(gen.decoder, 1).to(BF16)
        qdec = quantize_lstm_decoder(gen.decoder, bits)
        ids_p, _ = ds.decode_sample_q_serve_plain(feats, qdec, T, bits=bits)
        want = " ".join(ids_to_words(strip_caption(ids_p[0].tolist()),
                                     synthetic_vocab()[1]))
        same = all(c == want for r in resps for c in r["captions"])
        gap = 0.0
        if not same:    # the kernel's ids of the same row, teacher-forced
            ids_k, _ = ds.decode_sample_q_serve(feats, qdec, T, bits=bits)
            ref = bf16_forced(ds.dequantized_decoder(qdec, bits, BF16),
                              feats, ids_k)
            gap = bf16_id_gap(ref["scores"], ids_k)
        row = {"captions_equal_plain": same, "id_gap_units": gap,
               "kernel_launches": launches,
               "device_calls": stats["device_calls"],
               "latency_ms": [r["latency_ms"] for r in resps]}
        out[f"int{bits}"] = row
        emit({"phase": "bf16", "service": f"int{bits}", **row})
        check(all(len(r["captions"]) == 8 for r in resps)
              and all(math.isfinite(x) for r in resps
                      for x in r["logprobs"]), f"bf16 service {row}")
        check(same or gap <= BF16_ID_UNITS, f"bf16 service captions {row}")
        check(launches > 0 and launches == stats["device_calls"],
              f"bf16 service launches {row}")
    return out


def bf16_profile(config, state, batch, kind, steps):
    """Device time and launches by kernel (torch.profiler) and host ms per
    step of ``kind`` (``"mle"`` / ``"adv"``), over ``steps`` steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gan_image_captioning_tpu_torch.train.steps import (make_adv_step,
                                                            make_mle_step)

    step = make_mle_step(config) if kind == "mle" else make_adv_step(config)
    run = ((lambda: step(state, batch)) if kind == "mle"
           else (lambda: step(state, batch, TEMP)))
    run()
    torch.cuda.synchronize()
    cnt = bf16_reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    us, count = {}, {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        key = next((n for n in KERNEL_NAMES if n in ev.key), ev.key[:60])
        us[key] = us.get(key, 0.0) + ev.self_device_time_total / steps
        count[key] = count.get(key, 0) + ev.count / steps
    row = {"host_ms_per_step": wall / steps,
           "wrapper_launches_per_step": {
               k.removesuffix("_bf16"): fn.launches / steps
               for k, fn in cnt.items() if fn.launches},
           "bf16_launches_per_step": {
               k: fn.bf16_launches / steps for k, fn in cnt.items()
               if fn.bf16_launches}}
    if us:
        order = sorted(us, key=lambda k: -us[k])
        row.update(device_ms_per_step=sum(us.values()) / 1e3,
                   launches_per_step=sum(count.values()),
                   device_us_per_step={k: us[k] for k in order[:16]},
                   busy_share=sum(us.values()) * steps / 1e3 / wall)
    else:
        row["device_time"] = "not measured"
    return row


def bf16_timing(setup):
    """float32 against bfloat16 steps on the same weights, in turns
    (float32, bfloat16, bfloat16, float32): two adversarial steps (one
    discriminator update) and two MLE steps each, profiled."""
    config, state, batch = setup
    f32_cfg = config.replace(dtype="float32", bf16_mu=False)
    out = {"f32": [], "bf16": []}
    for dt, cfg in (("f32", f32_cfg), ("bf16", config), ("bf16", config),
                    ("f32", f32_cfg)):
        out[dt].append({kind: bf16_profile(cfg, state, batch, kind,
                                           DISC_EVERY)
                        for kind in ("adv", "mle")})
    emit({"phase": "bf16", "timing": out})
    for dt, runs in out.items():
        for run in runs:
            for kind, row in run.items():
                n_all = sum(row["wrapper_launches_per_step"].values())
                n_bf16 = sum(row["bf16_launches_per_step"].values())
                check(n_all > 0 and n_bf16 == (n_all if dt == "bf16"
                                               else 0),
                      f"bf16 timing: {dt} {kind} launches {row}")
    return out


def phase_bf16(gen, device, workdir):
    """``--dtype bfloat16`` on the config3 main path (the chip_smoke
    docstring's ``bf16``)."""
    t0 = time.perf_counter()
    rows, times = bf16_kernels(gen, device)
    train, setup = bf16_train(gen, device, rows["logit_scale"])
    cond = bf16_cond(device)
    loop = bf16_loop(workdir)
    service = bf16_service(gen, workdir)
    timing = bf16_timing(setup)
    seconds = time.perf_counter() - t0
    emit({"phase": "bf16", "seconds": seconds})
    return {"rows": rows, "times": times, "train": train, "cond": cond,
            "loop": loop, "service": service, "timing": timing}


def bf16_entries(smi, row):
    """The bfloat16 instantiations' entries of the ``kernels`` line; each
    one's launches from this phase's drives: the training steps (decode,
    chain, reverse, conv, and the MLE eval step's pretrain decode), the
    conditional step (``image_norm``) and the services (quantized
    decode)."""
    train = row["train"]["launches"]
    launches = {**train,
                "image_norm_bf16": row["cond"]["launches"]["image_norm_bf16"],
                **{f"decode_qserve_{b}_bf16": s["kernel_launches"]
                   for b, s in row["service"].items()}}
    errs = {name: max((v for k, v in row["rows"][name].items()
                       if k.startswith("max_abs")), default=0.0)
            for name in BF16_TPU_KERNELS}
    out = []
    for name, tpu in BF16_TPU_KERNELS.items():
        t = row["times"][name]
        out.append({
            "name": name, "route": "cuda",
            "source": "gan_image_captioning_tpu_torch/kernels/csrc/"
                      + BF16_SOURCES[name],
            "replaces": tpu, "launches": launches[name],
            "max_abs_err": errs[name], "ms": min(t["kernel_ms"]),
            "plain_ms": min(t["plain_ms"]), "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": min(t["library_ms"]) if "library_ms" in t
            else None,
            "dtype": "bfloat16", "B": t.get("B", B_TRAIN), "card": smi})
    return out


# ------------------------------------------- bfloat16, the transformer family

TF_BF16_TPU_KERNELS = {"flash_fwd_bf16": f"{FLASH_TPU}:81",
                       "flash_dq_bf16": f"{FLASH_TPU}:156",
                       "flash_dkv_bf16": f"{FLASH_TPU}:193",
                       "gumbel_sample_bf16": "gan_image_captioning_tpu/kernels/"
                                             "gumbel_sample.py:36"}
TF_BF16_COUNTERS = {"flash_fwd_bf16": "flash_fwd", "flash_dq_bf16": "flash_bwd",
                    "flash_dkv_bf16": "flash_bwd",
                    "gumbel_sample_bf16": "gumbel_sample"}
# launches per config4 Gumbel adversarial step (transformer generator): the
# sampler once a decode step, the discriminator's layers forward and
# backward for the real, fake and generator passes; the cache decode is
# dense
TF_PER_GUMBEL_STEP = {"gumbel_sample": T, "flash_fwd": 3 * TF_DISC_NL,
                      "flash_bwd": 3 * TF_DISC_NL}
TF_BF16_ITEMS = 128


def tf_bf16_reset():
    cnt = tf_counters()
    for fn in cnt.values():
        fn.launches = fn.bf16_launches = 0
    return cnt


def flash_bf16_work(kind, b, t, h, d, pairs):
    """Bytes (bfloat16 q, k, v, out, dO, dq, dk, dv; float32 lse) and
    float32 operations of one bfloat16 flash call: the forward, or the
    whole backward (delta included)."""
    x, vec = 2 * b * t * h * d, 4 * b * t * h
    if kind == "fwd":
        return 4 * x + vec, 4 * d * pairs
    return 8 * x + vec, 10 * d * pairs


def tf_bf16_flash(device):
    """The flash kernels' bfloat16 instantiations at config4's shapes,
    GPT-2's head dim at [8, 37, 12, 64] (the column-half kernels) and the
    tiled ones' [2, 200, 2, 24] and long captions (``long_caption_cases``):
    against the plain versions on the
    same bfloat16 inputs (out, dq, dk, dv each entry within a bfloat16
    step, plus FLASH_GRAD_RTOL of the largest entry; lse within
    FLASH_GRAD_RTOL), against the float32 instantiation on the widened
    inputs (bit-equal once rounded), one bfloat16 launch a call; device
    time beside the plain versions', the bound and SDPA in bfloat16
    (forward, and backward alone)."""
    import torch.nn.functional as F

    from gan_image_captioning_tpu_torch.kernels import flash_attention as fa

    rng = np.random.default_rng(56)
    lens_gen = torch.from_numpy(rng.integers(3, T + 1, B_TRAIN).astype(
        np.int32) + 1).to(device)
    lens_tiled = torch.from_numpy(rng.integers(1, 201, 2).astype(
        np.int32)).to(device)
    hd, dd = TF_D // TF_HEADS, TF_DISC_D // TF_DISC_HEADS
    cases = {"gen_mle": ((B_TRAIN, T + 1, TF_HEADS, hd), True, lens_gen),
             "gen_logprob": ((B_TRAIN, T + 1, TF_HEADS, hd), True, None),
             "disc": ((B_TRAIN, T, TF_DISC_HEADS, dd), False, None),
             "disc_rollout": ((B_TRAIN * TF_ROLLOUT_NUM, T, TF_DISC_HEADS,
                               dd), False, None),
             "tiled_t200": ((2, 200, 2, 24), True, lens_tiled),
             "fused_d64": ((8, T + 1, C5_HEADS, C5_HD), True, lens_gen[:8]),
             **{n: c[:3] for n, c in long_caption_cases(device, rng).items()}}
    rows, times = {}, {}
    for name, (shape, causal, lens) in cases.items():
        t_case = time.perf_counter()
        q, k, v, g = (seeded(shape, 90 + i, device).to(BF16)
                      for i in range(4))
        cnt = tf_bf16_reset()
        out, lse = fa.flash_fwd(q, k, v, causal, lens)
        dq, dk, dv = fa.flash_bwd(q, k, v, out, g, lse, causal, lens)
        torch.cuda.synchronize()
        launches = bf16_launches(cnt, f"tf_bf16 flash {name}")
        fused = fa.flash_bwd.last_kernel == "fused"
        p_out, p_lse = fa.flash_fwd_plain(q, k, v, causal, lens)
        p_grads = fa.flash_bwd_plain(q, k, v, out, g, lse, causal, lens)
        f_out, f_lse = fa.flash_fwd(q.float(), k.float(), v.float(), causal,
                                    lens)
        f_grads = fa.flash_bwd(q.float(), k.float(), v.float(), out.float(),
                               g.float(), lse, causal, lens)
        row = {"shape": list(shape), "causal": causal,
               "lengths": lens is not None, "launches": launches,
               "backward_kernel": fa.flash_bwd.last_kernel,
               "lse_max_abs_diff": float((lse - p_lse).abs().max()),
               "float32_rounded_bit_equal": bool(
                   torch.equal(out, f_out.to(BF16)) and torch.equal(lse, f_lse)
                   and all(torch.equal(a, b.to(BF16))
                           for a, b in zip((dq, dk, dv), f_grads)))}
        for n, a, b in zip(("out", "dq", "dk", "dv"), (out, dq, dk, dv),
                           (p_out, *p_grads)):
            row[f"{n}_max_abs_diff"], row[f"{n}_step_ratio"] = bf16_steps(
                a, b, f"tf_bf16 flash {name} {n}", floor=FLASH_GRAD_RTOL)
        emit({"phase": "tf_bf16", "kernel": "flash", "case": name, **row})
        check(launches == {"flash_fwd": 1, "flash_bwd": 1,
                           "gumbel_sample": 0},
              f"tf_bf16 flash {name}: launches {launches}")
        check(fused == (name != "tiled_t200" and not name.startswith("long")),
              f"tf_bf16 flash {name} {row}")
        check(fa.flash_fwd.last_kernel == row["backward_kernel"],
              f"tf_bf16 flash {name}: the forward's route {row}")
        check(row["lse_max_abs_diff"] <= FLASH_GRAD_RTOL
              * float(p_lse.abs().max()), f"tf_bf16 flash {name} lse {row}")
        check(row["float32_rounded_bit_equal"],
              f"tf_bf16 flash {name}: not the float32 kernel rounded {row}")
        rows[name] = row
        t_timed = time.perf_counter()

        # times, in turns: the kernels, the plain versions, SDPA in
        # bfloat16 (boolean mask; [B, H, T, D] views made contiguous
        # outside the timing), the forward and the backward alone
        b_, t_, h_, d_ = shape
        mask = torch.ones((1, 1, t_, t_), dtype=torch.bool, device=device)
        if causal:
            mask = torch.tril(mask)
        if lens is not None:
            mask = mask & (torch.arange(t_, device=device)[None, :]
                           < lens[:, None])[:, None, None, :]
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                      for x in (q, k, v))
        gt = g.transpose(1, 2).contiguous()
        t_lib = time.perf_counter()
        lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        lib_err = float((lib.detach().transpose(1, 2).float()
                         - p_out.float()).abs().max())

        def lib_bwd():
            torch.autograd.grad(lib, (qt, kt, vt), gt, retain_graph=True)

        lib_bwd()
        torch.cuda.synchronize()
        t_lib = time.perf_counter() - t_lib

        with torch.no_grad():
            fns = {
                "kernel_fwd": lambda: fa.flash_fwd(q, k, v, causal, lens),
                "kernel_bwd": lambda: fa.flash_bwd(q, k, v, out, g, lse,
                                                   causal, lens),
                "plain_fwd": lambda: fa.flash_fwd_plain(q, k, v, causal,
                                                        lens),
                "plain_bwd": lambda: fa.flash_bwd_plain(q, k, v, out, g, lse,
                                                        causal, lens),
                "library_fwd": lambda: F.scaled_dot_product_attention(
                    qt.detach(), kt.detach(), vt.detach(), attn_mask=mask)}
            ms = {n: [device_ms(f)] for n, f in fns.items()}
            for n, f in reversed(list(fns.items())):
                ms[n].append(device_ms(f))
        ms["library_bwd"] = [device_ms(lib_bwd, 10), device_ms(lib_bwd, 10)]
        del lib
        pairs = attention_pairs(b_, t_, h_, causal, lens)
        t_row = {"ms": ms, "library_max_abs_diff": lib_err, "pairs": pairs,
                 "seconds": {"checks": t_timed - t_case,
                             "library_first_call": t_lib,
                             "timing": time.perf_counter() - t_timed}}
        for kind in ("fwd", "bwd"):
            nbytes, flops = flash_bf16_work(kind, b_, t_, h_, d_, pairs)
            t_row[kind] = dict(zip(("bound_ms", "bound_by"),
                                   bound(nbytes, flops)),
                               bytes=nbytes, flop=flops)
        if not fused:           # the tiled backward's products: TF32 terms
            t_row["bwd"].update(zip(("bound_ms", "bound_by"),
                                    tiled_bwd_bound(b_, t_, h_, d_, pairs,
                                                    True)))
        emit({"phase": "tf_bf16", "timing": "flash", "case": name, **t_row})
        times[name] = t_row
    return rows, times


def tf_bf16_gumbel(device):
    """The sampler's bfloat16 instantiation at [64, V] (vector accesses)
    and [64, V - 1] (scalar ones) on fed uniforms: ids equal, or each a tie
    within ID_ATOL of the row's max score; soft within a bfloat16 step of
    the plain version's; bit-equal to the float32 instantiation on the
    widened logits, rounded (its Philox uniforms and ids too); one
    bfloat16 launch a call; the Philox draw's ids distributed as
    softmax(logits) (2^18 rows of 16 bfloat16 logits); device time beside
    the plain version's and the bound."""
    from gan_image_captioning_tpu_torch.kernels import gumbel_sample as gs

    rows, times = {}, {}
    for b, v in ((B_TRAIN, V), (B_TRAIN, V - 1)):
        logits = seeded((b, v), 170, device, 3.0).to(BF16)
        u = torch.rand((b, v), generator=torch.Generator(
            device=device).manual_seed(171), device=device)
        cnt = tf_bf16_reset()
        soft, ids = gs.gumbel_sample(logits, 1.0, uniforms=u)
        torch.cuda.synchronize()
        launches = bf16_launches(cnt, f"tf_bf16 gumbel {v}")
        p_soft, p_ids = gs.gumbel_sample_plain(logits, 1.0, u)
        x = (logits.float() - torch.log(-torch.log(u + gs.EPS) + gs.EPS))
        gap = float((x.max(dim=-1).values
                     - x.gather(1, ids.long()[:, None])[:, 0]).max())
        f_soft, f_ids = gs.gumbel_sample(logits.float(), 1.0, uniforms=u)
        u_a, u_b = torch.empty_like(u), torch.empty_like(u)
        s_a, i_a = gs.gumbel_sample(logits, 1.0, seed=99, step=3,
                                    uniforms_out=u_a)
        s_b, i_b = gs.gumbel_sample(logits.float(), 1.0, seed=99, step=3,
                                    uniforms_out=u_b)
        row = {"shape": [b, v], "plan": gs.gumbel_plan(b, v),
               "launches": launches["gumbel_sample"],
               "ids_equal": bool(torch.equal(ids, p_ids)), "id_gap": gap,
               "float32_rounded_bit_equal": bool(
                   torch.equal(ids, f_ids) and torch.equal(soft,
                                                           f_soft.to(BF16))),
               "philox_float32_rounded_bit_equal": bool(
                   torch.equal(u_a, u_b) and torch.equal(i_a, i_b)
                   and torch.equal(s_a, s_b.to(BF16)))}
        row["max_abs_soft_diff"], row["soft_step_ratio"] = bf16_steps(
            soft, p_soft, f"tf_bf16 gumbel {v} soft")
        emit({"phase": "tf_bf16", "kernel": "gumbel_sample", **row})
        check(launches == {"flash_fwd": 0, "flash_bwd": 0,
                           "gumbel_sample": 1},
              f"tf_bf16 gumbel launches {launches}")
        check(gap <= ID_ATOL and row["float32_rounded_bit_equal"]
              and row["philox_float32_rounded_bit_equal"],
              f"tf_bf16 gumbel {row}")
        rows[v] = row
        n = b * v
        # bfloat16 logits read, soft written, ids; Philox noise (fed
        # uniforms: 4 more bytes an element)
        nbytes, flops = 4 * n + 4 * b, 7 * n
        kern = lambda: gs.gumbel_sample(logits, 1.0, seed=7)   # noqa: E731
        fed = lambda: gs.gumbel_sample(logits, 1.0, uniforms=u)  # noqa: E731
        plain = lambda: gs.gumbel_sample_plain(logits, 1.0, u)  # noqa: E731
        p_a, k_a, f_a = device_ms(plain), device_ms(kern), device_ms(fed)
        f_b, k_b, p_b = device_ms(fed), device_ms(kern), device_ms(plain)
        b_ms, b_by = bound(nbytes, flops)
        times[v] = {"kernel_ms": [k_a, k_b], "kernel_fed_uniforms_ms":
                    [f_a, f_b], "plain_ms": [p_a, p_b], "bound_ms": b_ms,
                    "bound_by": b_by, "bytes": nbytes, "flop": flops,
                    "shape": [b, v]}
        emit({"phase": "tf_bf16", "timing": "gumbel_sample", **times[v]})
    n_hist, v_hist = 1 << 18, 16
    h_logits = torch.linspace(-2, 2, v_hist, device=device).to(BF16)
    h_ids = gs.gumbel_sample(h_logits.expand(n_hist, v_hist).contiguous(),
                             1.0, seed=5)[1]
    hist = torch.bincount(h_ids.long(), minlength=v_hist).double() / n_hist
    want = torch.softmax(h_logits.double(), dim=0)
    rows["hist_max_abs_diff"] = float((hist - want).abs().max())
    emit({"phase": "tf_bf16", "kernel": "gumbel_philox",
          "hist_max_abs_diff": rows["hist_max_abs_diff"]})
    check(rows["hist_max_abs_diff"] <= HIST_ATOL, f"tf_bf16 philox {rows}")
    return rows, times


@contextlib.contextmanager
def tf_plain_versions():
    """Within it, the transformer's flash attention is its plain version
    (``flash_attention_plain``: in bfloat16 the kernels' arithmetic) and
    the fused sampler its plain version on the fed uniforms: the kernel
    route with each kernel replaced by the function it is held against."""
    from gan_image_captioning_tpu_torch.kernels import flash_attention as fa
    from gan_image_captioning_tpu_torch.kernels import gumbel_sample as gs
    from gan_image_captioning_tpu_torch.models import transformer as ttf

    real_attn, real_gs = ttf.flash_attention, gs.gumbel_sample

    def plain_sampler(logits, temperature, seed=0, step=0, uniforms=None,
                      uniforms_out=None):
        check(uniforms is not None, "the plain sampler needs fed uniforms")
        return gs.gumbel_sample_plain(logits, float(temperature), uniforms)

    ttf.flash_attention, gs.gumbel_sample = fa.flash_attention_plain, \
        plain_sampler
    try:
        yield
    finally:
        ttf.flash_attention, gs.gumbel_sample = real_attn, real_gs


def tf_bf16_grads(kind, config, state, batch, noise):
    from gan_image_captioning_tpu_torch.train import steps

    if kind == "mle":
        return tf_grads(kind, config, state, batch, noise)
    return steps.adv_grads(config.replace(adv_objective=(
        "reinforce" if kind == "rl" else "gumbel")), state, batch,
        1.0 if kind == "rl" else TEMP, noise)


def tf_bf16_compare(kern, plain, ref32):
    """Per gradient tensor: max |kernel - plain| in bfloat16 units of the
    plain route's largest entry, or of the side's largest where the
    float32 kernel step's gradient (``ref32``) stays below
    FLASH_GRAD_RTOL of its side's largest (the attention's key bias, zero
    but for rounding since the softmax is invariant to a shift of a row
    of scores; its query and key projections at initialization), as
    ``tests/torch_bf16_parity.py:grad_misses`` holds them; and whether an
    entry outside BF16_GRAD_UNITS is at least as close (L2) to ``ref32``
    as the plain route's."""
    out, misses = {}, []
    for side, i in (("gen", 2), ("disc", 3)):
        a, b, r = kern[i], plain[i], ref32[i]
        if not b:
            continue
        top = max(float(x.abs().max()) for x in b.values())
        top32 = max(float(x.abs().max()) for x in r.values())
        for k in b:
            small = float(r[k].abs().max()) < FLASH_GRAD_RTOL * top32
            scale = top if small else float(b[k].abs().max())
            units = float((a[k] - b[k]).abs().max()) / max(
                BF16_UNIT * scale, 1e-30)
            out[f"{side}.{k}"] = units
            if units > BF16_GRAD_UNITS:
                ours = float((a[k].float() - r[k].float()).norm())
                theirs = float((b[k].float() - r[k].float()).norm())
                tol = (BF16_GRAD_UNITS * BF16_UNIT * scale
                       * math.sqrt(b[k].numel()))
                if ours > theirs + tol:
                    misses.append((f"{side}.{k}", units, ours, theirs))
    return out, misses


def tf_bf16_steps(device):
    """config4 at full width in bfloat16 (``bf16_mu``): one MLE, one
    REINFORCE and one Gumbel adversarial step with the launches of the
    design, every one bfloat16; each step's losses and gradients through
    the kernels against the plain versions (``tf_plain_versions``) on the
    same state and fed noise: sampled ids equal, losses within
    BF16_LOSS_UNITS, each gradient tensor within BF16_GRAD_UNITS of its
    largest entry or at least as close to the float32 kernel step as the
    plain route's; then config3's repaired REINFORCE step (LSTM, CNN) in
    bfloat16: every launch a bfloat16 instantiation."""
    from gan_image_captioning_tpu_torch.train.state import create_train_state
    from gan_image_captioning_tpu_torch.train.steps import (make_adv_step,
                                                            make_mle_step)

    config, state, batch = tf_setup(device, dtype="bfloat16", bf16_mu=True)
    row = {}
    for kind, cfg, per in (("mle", config, TF_PER_MLE_STEP),
                           ("rl", config, TF_PER_RL_STEP),
                           ("gumbel", config.replace(adv_objective="gumbel"),
                            TF_PER_GUMBEL_STEP)):
        cnt = tf_bf16_reset()
        if kind == "mle":
            state, m = make_mle_step(cfg)(state, batch)
        else:
            state, m = make_adv_step(cfg)(state, batch, 1.0)
        torch.cuda.synchronize()
        launches = bf16_launches(cnt, f"tf_bf16 {kind} step")
        row[kind] = {"launches": launches,
                     "metrics": {k: float(v) for k, v in m.items()}}
        check(launches == per, f"tf_bf16 {kind} launches {launches} != {per}")
        check(all(math.isfinite(x) for x in row[kind]["metrics"].values()),
              f"tf_bf16 {kind} metrics {row[kind]}")
    check(all(v.dtype == BF16 for opt in (state.pretrain_opt, state.gen_opt,
                                          state.disc_opt)
              for v in opt.mu.values()), "tf_bf16: a first moment is not "
          "bfloat16")

    for kind in ("mle", "rl", "gumbel"):
        noise = tf_noise(config, device)
        noise["keep"] = noise["keep"] + [noise["keep"][0].clone()]
        kern = tf_bf16_grads(kind, config, state, batch, noise)
        with tf_plain_versions():
            plain = tf_bf16_grads(kind, config, state, batch, noise)
        ref32 = tf_bf16_grads(kind, config.replace(dtype="float32"), state,
                              batch, noise)
        units, misses = tf_bf16_compare(kern, plain, ref32)
        worst = sorted(units.items(), key=lambda kv: -kv[1])[:4]
        cmp = {"g_loss": [float(kern[0]), float(plain[0])],
               "d_loss": [float(kern[1]), float(plain[1])],
               "ids_equal": bool(torch.equal(kern[4]["gen_ids"],
                                             plain[4]["gen_ids"])),
               "worst_grad_units": worst, "misses": misses}
        emit({"phase": "tf_bf16", "kernels_vs_plain": kind, **cmp})
        for a, b in (cmp["g_loss"], cmp["d_loss"]):
            check(abs(a - b) <= BF16_LOSS_UNITS * BF16_UNIT * max(abs(b),
                                                                  1e-30),
                  f"tf_bf16 {kind} losses {cmp}")
        check(cmp["ids_equal"], f"tf_bf16 {kind}: the routes sampled apart")
        check(not misses, f"tf_bf16 {kind} gradients {cmp}")
        row[f"{kind}_vs_plain"] = cmp
        del kern, plain, ref32

    # config3's REINFORCE step, now inside the compute cast
    lstm_cfg = bf16_config(adv_objective="reinforce", rollout_num=4)
    lstm_state = create_train_state(lstm_cfg, 0, device, sweep=False)
    cnt = bf16_reset()
    lstm_state, m = make_adv_step(lstm_cfg)(lstm_state, train_batch(device),
                                           1.0)
    torch.cuda.synchronize()
    launches = bf16_launches(cnt, "tf_bf16 LSTM REINFORCE step")
    row["lstm_reinforce"] = {"launches": launches, "metrics": {
        k: float(v) for k, v in m.items()}}
    emit({"phase": "tf_bf16", "lstm_reinforce": row["lstm_reinforce"]})
    for k in ("decode_sample_resid_bf16", "decode_sample_logits_bf16",
              "lstm_bptt_reverse_bf16", "disc_conv_fwd_bf16",
              "disc_conv_bwd_dx_bf16"):
        check(launches[k] > 0, f"tf_bf16 LSTM REINFORCE: {k} never launched "
              f"{launches}")
    check(all(math.isfinite(x) for x in row["lstm_reinforce"]["metrics"]
              .values()), f"tf_bf16 LSTM REINFORCE {row['lstm_reinforce']}")
    return row, (config, state, batch)


def tf_bf16_loop(workdir):
    """``main.py --preset config4 --dtype bfloat16`` (with ``bf16_mu``) on
    128 synthetic items: one pretrain and one REINFORCE epoch with a
    full-state snapshot an epoch, every launch bfloat16; the snapshot
    loaded back (bfloat16 first moments) and the adversarial checkpoint
    served."""
    import shutil

    from gan_image_captioning_tpu_torch import main as train_main
    from gan_image_captioning_tpu_torch import serve
    from gan_image_captioning_tpu_torch.train import checkpoint as ckpt
    from gan_image_captioning_tpu_torch.train.state import create_train_state

    save = workdir / "tf_bf16_loop"
    shutil.rmtree(save, ignore_errors=True)
    argv = [*TF_MODEL_FLAGS, "--dtype", "bfloat16", "--synthetic-items",
            str(TF_BF16_ITEMS), "--pretrain-epochs", "1", "--adv-epochs",
            "1", "--checkpoint-every", "1", "--save-dir", str(save),
            "--expt-name", "tf_bf16"]
    real = train_main.config_from_args
    train_main.config_from_args = lambda args: real(args).replace(
        bf16_mu=True)
    cnt = tf_bf16_reset()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            inst = train_main.main(argv)
    finally:
        train_main.config_from_args = real
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = bf16_launches(cnt, "tf_bf16 loop")
    rows = [json.loads(ln) for ln in open(Path(inst.config.save_dir)
                                          / "metrics.jsonl")]
    snaps = sorted(Path(inst.config.model_dir).glob("state_*.ckpt"))
    check(snaps, "tf_bf16 loop: no full-state snapshot")
    back = ckpt.load_state(str(snaps[-1]), create_train_state(
        inst.config, 0, next(inst.state.gen.parameters()).device))
    service = serve.CaptionService(serve.parse_args(
        ["--checkpoint", str(Path(inst.config.model_dir) / "adv_model.ckpt"),
         *TF_MODEL_FLAGS]))
    try:
        resp = service.handle_request({"n": 2})
    finally:
        service.close()
    row = {"seconds": seconds, "launches": launches,
           "pretrain_steps": inst.pretrain_steps,
           "gen_steps": inst.state.gen_steps, "snapshot": snaps[-1].name,
           "mu_dtypes": sorted({str(v.dtype) for opt in (
               back.pretrain_opt, back.gen_opt, back.disc_opt)
               for v in opt.mu.values()}),
           "served_captions": resp["captions"]}
    emit({"phase": "tf_bf16", "loop": row})
    check(inst.config.dtype == "bfloat16" and inst.config.bf16_mu,
          "tf_bf16 loop: the flags did not reach the config")
    check(rows and all(math.isfinite(r["value"]) for r in rows),
          "tf_bf16 loop: non-finite metric")
    check(inst.pretrain_steps > 0 and inst.state.gen_steps > 0,
          f"tf_bf16 loop steps {row}")
    check(all(launches[k] > 0 for k in ("flash_fwd", "flash_bwd",
                                         "gumbel_sample")),
          f"tf_bf16 loop launches {launches}")
    check(row["mu_dtypes"] == ["torch.bfloat16"],
          f"tf_bf16 loop: reloaded mu {row['mu_dtypes']}")
    check(len(resp["captions"]) == 2 and all(
        math.isfinite(x) for x in resp["logprobs"]),
        f"tf_bf16 loop: served {resp}")
    return row


def tf_bf16_profile(fn, calls):
    """One window of ``calls`` calls of ``fn`` under torch.profiler (CUDA
    activity only: the CPU side of a REINFORCE step's 80 000 launches would
    take the profiler longer than the step) → device time, kernel
    launches and busy share per step by the profiler, host ms per step,
    the wrappers' launches per step, and whether the profiler recorded
    every flash forward the wrapper launched (it drops events at times in
    a long process).  The device events are read from the profiler's raw
    results: ``key_averages`` builds an event tree first, about 16 s for
    one REINFORCE step's 85 000 kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cnt = tf_bf16_reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    t1 = time.perf_counter()
    us = n = seen = 0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        us += ev.duration_ns() / 1e3
        n += 1
        seen += "flash_fwd" in ev.name()
    return {"host_ms_per_step": wall / calls,
            "device_ms_per_step": us / 1e3 / calls,
            "launches_per_step": n / calls, "busy_share": us / 1e3 / wall,
            "wrapper_launches_per_step": {k: f.launches / calls
                                          for k, f in cnt.items()},
            "wrapper_bf16_launches_per_step": {
                k: f.bf16_launches / calls for k, f in cnt.items()},
            "profiler_saw_every_flash_forward":
                seen == cnt["flash_fwd"].launches,
            "seconds": {"window": wall / 1e3, "stop": t1 - t0 - wall / 1e3,
                        "read": time.perf_counter() - t1}}


def tf_bf16_timing(setup):
    """The config4 REINFORCE step (1 a turn) and MLE step (2 a turn):
    device time and kernel launches (``tf_bf16_profile``) and host ms,
    float32 against bfloat16 on the same weights, in turns (float32,
    bfloat16, bfloat16, float32); a bfloat16 turn launches no float32
    instantiation, a float32 one no bfloat16."""
    from gan_image_captioning_tpu_torch.train.steps import (make_adv_step,
                                                            make_mle_step)

    config, state, batch = setup
    f32_cfg = config.replace(dtype="float32", bf16_mu=False)
    out = {"f32": [], "bf16": []}
    for dt, cfg in (("f32", f32_cfg), ("bf16", config), ("bf16", config),
                    ("f32", f32_cfg)):
        mle, adv = make_mle_step(cfg), make_adv_step(cfg)
        turn = {"rl": tf_bf16_profile(lambda: adv(state, batch, 1.0), 1),
                "mle": tf_bf16_profile(lambda: mle(state, batch), 2)}
        out[dt].append(turn)
        for kind, row in turn.items():
            want = (row["wrapper_launches_per_step"] if dt == "bf16"
                    else {k: 0 for k in row["wrapper_launches_per_step"]})
            check(row["wrapper_bf16_launches_per_step"] == want,
                  f"tf_bf16 timing: {dt} {kind} launches {row}")
    emit({"phase": "tf_bf16", "timing": out})
    return out


# the long-caption REINFORCE step's rollouts: every 32 positions (3
# prefixes of 128-step decodes; config4's stride of 4 would run 31 of them)
LONG_ROLLOUT_STRIDE = 32


def tf_bf16_long_steps(device):
    """config4 at full width in bfloat16 at ``--max-seq-len 126`` (B = 64
    captions of 3-126 random tokens, batch width 128): one MLE and one
    REINFORCE step (rollouts every LONG_ROLLOUT_STRIDE positions), each
    under torch.profiler after a warm step (device ms, kernel launches and
    busy share a step); the wrappers' launches as the design gives them at
    T = 128, every backward one launch of the tiled kernel (no PyTorch
    delta), every launch bfloat16, the losses finite."""
    from gan_image_captioning_tpu_torch.data.loader import make_batch
    from gan_image_captioning_tpu_torch.kernels import flash_attention as fa
    from gan_image_captioning_tpu_torch.train.state import create_train_state
    from gan_image_captioning_tpu_torch.train.steps import (batch_to,
                                                            make_adv_step,
                                                            make_mle_step)

    config = tf_config(dtype="bfloat16", bf16_mu=True,
                       max_seq_len=LONG_MAX_SEQ_LEN,
                       rollout_stride=LONG_ROLLOUT_STRIDE)
    state = create_train_state(config, 0, device, sweep=False)
    rng = np.random.default_rng(78)
    caps = [rng.integers(4, min(11000, V),
                         size=rng.integers(3, LONG_MAX_SEQ_LEN + 1))
            for _ in range(B_TRAIN)]
    batch = batch_to(make_batch(caps, None, LONG_T), device)
    prefixes = len(range(LONG_ROLLOUT_STRIDE, LONG_T, LONG_ROLLOUT_STRIDE))
    per = {"mle": {"flash_fwd": TF_NL, "flash_bwd": TF_NL,
                   "gumbel_sample": 0},
           "rl": {"gumbel_sample": LONG_T,
                  "flash_fwd": TF_DISC_NL * (2 + prefixes + 1 + 1) + TF_NL,
                  "flash_bwd": 2 * TF_DISC_NL + TF_NL}}
    hd, dd = TF_D // TF_HEADS, TF_DISC_D // TF_DISC_HEADS
    routes = {"generator": fa.flash_bwd_plan(LONG_T + 1, TF_HEADS,
                                             hd)["route"],
              "discriminator": fa.flash_bwd_plan(LONG_T, TF_DISC_HEADS,
                                                 dd)["route"]}
    check(routes == {"generator": "tiled", "discriminator": "tiled"},
          f"tf_bf16 long captions: routes {routes}")
    mle, adv = make_mle_step(config), make_adv_step(config)
    out = {"max_seq_len": LONG_MAX_SEQ_LEN, "rollout_stride":
           LONG_ROLLOUT_STRIDE, "routes": routes}
    for kind, fn in (("mle", lambda: mle(state, batch)),
                     ("rl", lambda: adv(state, batch, 1.0))):
        cnt = tf_bf16_reset()
        _, m = fn()
        torch.cuda.synchronize()
        launches = bf16_launches(cnt, f"tf_bf16 long {kind} step")
        check(launches == per[kind],
              f"tf_bf16 long {kind} launches {launches} != {per[kind]}")
        check(all(math.isfinite(float(x)) for x in m.values()),
              f"tf_bf16 long {kind} metrics {m}")
        out[kind] = {"launches": launches,
                     "metrics": {k: float(x) for k, x in m.items()},
                     **tf_bf16_profile(fn, 1)}
        check(out[kind]["wrapper_launches_per_step"]
              == {k: float(x) for k, x in per[kind].items()},
              f"tf_bf16 long {kind} profiled launches {out[kind]}")
    emit({"phase": "tf_bf16", "long_captions": out})
    return out


def phase_tf_bf16(device, workdir):
    """``--dtype bfloat16`` for the transformer family (the chip_smoke
    docstring's ``tf_bf16``)."""
    marks = [("start", time.perf_counter())]
    flash_rows, flash_times = tf_bf16_flash(device)
    marks.append(("flash", time.perf_counter()))
    g_rows, g_times = tf_bf16_gumbel(device)
    marks.append(("gumbel", time.perf_counter()))
    steps, setup = tf_bf16_steps(device)
    marks.append(("steps", time.perf_counter()))
    loop = tf_bf16_loop(workdir)
    marks.append(("loop", time.perf_counter()))
    timing = tf_bf16_timing(setup)
    marks.append(("timing", time.perf_counter()))
    long_steps = tf_bf16_long_steps(device)
    marks.append(("long_steps", time.perf_counter()))
    emit({"phase": "tf_bf16", "seconds": marks[-1][1] - marks[0][1],
          "seconds_by_part": {name: t - marks[i][1] for i, (name, t)
                              in enumerate(marks[1:])}})
    return {"flash": flash_rows, "flash_times": flash_times,
            "gumbel": g_rows, "gumbel_times": g_times, "steps": steps,
            "loop": loop, "timing": timing, "long_steps": long_steps}


def tf_bf16_entries(smi, row):
    """The transformer family's bfloat16 instantiations on the ``kernels``
    line: times at the generator's MLE shape (flash, every case under
    ``by_case``) and at [64, V] (the sampler); launches from the phase's
    config4 steps (MLE, REINFORCE, Gumbel).  ``_dq_kernel`` and
    ``_dkv_kernel`` are one launch of the backward (fused, or tiled past
    T = 64), as in float32; ``long_steps``: the long-caption steps."""
    steps = row["steps"]
    launches = {k: sum(steps[s]["launches"][k] for s in ("mle", "rl",
                                                          "gumbel"))
                for k in ("flash_fwd", "flash_bwd", "gumbel_sample")}
    out = []
    for name, tpu in TF_BF16_TPU_KERNELS.items():
        if name == "gumbel_sample_bf16":
            t = row["gumbel_times"][V]
            err = max(r["max_abs_soft_diff"] for k, r in
                      row["gumbel"].items() if isinstance(r, dict))
            entry = {"ms": min(t["kernel_ms"]), "plain_ms": min(t["plain_ms"]),
                     "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                     "library_ms": None, "shape": t["shape"]}
        else:
            kind = "fwd" if name == "flash_fwd_bf16" else "bwd"
            keys = (("out",) if kind == "fwd" else
                    ("dq",) if name == "flash_dq_bf16" else ("dk", "dv"))
            err = max(r[f"{k}_max_abs_diff"] for r in row["flash"].values()
                      for k in keys)
            t = row["flash_times"]["gen_mle"]
            entry = {"ms": min(t["ms"][f"kernel_{kind}"]),
                     "plain_ms": min(t["ms"][f"plain_{kind}"]),
                     "bound_ms": t[kind]["bound_ms"],
                     "bound_by": t[kind]["bound_by"],
                     "library_ms": min(t["ms"][f"library_{kind}"]),
                     "shape": row["flash"]["gen_mle"]["shape"],
                     "by_case": {c: {
                         "ms": min(x["ms"][f"kernel_{kind}"]),
                         "plain_ms": min(x["ms"][f"plain_{kind}"]),
                         "library_ms": min(x["ms"][f"library_{kind}"]),
                         "bound_ms": x[kind]["bound_ms"],
                         "kernel": row["flash"][c]["backward_kernel"]
                         if kind == "bwd" else None}
                         for c, x in row["flash_times"].items()}}
        out.append({"name": name, "route": "cuda",
                    "source": "gan_image_captioning_tpu_torch/kernels/csrc/"
                              + ("gumbel_sample.cu" if name.startswith("gumbel")
                                 else "flash_attention.cu"),
                    "replaces": tpu,
                    "launches": launches[TF_BF16_COUNTERS[name]],
                    "max_abs_err": err, **entry, "dtype": "bfloat16",
                    "card": smi})
    return out


# ------------------------------------------------------------ config5
# preset config5 at full width: ViT-B/16 at 256 x 256, the GPT-2-small
# generator (768 / 3072, 12 layers, 12 heads: head dim 64, the fused flash
# kernels' column halves) cross-attending over the patch grid, GPT-2's
# 50257 ids and the 4 specials, bfloat16 compute
C5_V = 50257 + 4
C5_D, C5_NL, C5_HEADS = 768, 12, 12
C5_HD = C5_D // C5_HEADS
C5_ITEMS = 128                    # main.py's synthetic items: 2 batches
C5_SERVE = 8                      # images served and captioned
C5_TPU_KERNELS = {"flash_fwd_config5": f"{FLASH_TPU}:81",
                  "flash_dq_config5": f"{FLASH_TPU}:156",
                  "flash_dkv_config5": f"{FLASH_TPU}:193",
                  "gumbel_sample_config5": "gan_image_captioning_tpu/kernels/"
                                           "gumbel_sample.py:36",
                  "image_norm_config5": NORM_TPU_KERNEL}
C5_COUNTERS = {"flash_fwd_config5": "flash_fwd",
               "flash_dq_config5": "flash_bwd",
               "flash_dkv_config5": "flash_bwd",
               "gumbel_sample_config5": "gumbel_sample",
               "image_norm_config5": "image_norm"}
# launches per config5 step by design: the MLE step's causal pass over
# the 12 layers on the fused kernels (a forward and one backward launch a
# layer), image_norm once; the Gumbel
# step's sampler once a decode step (the cache decode is dense),
# image_norm once, and the CNN discriminator's conv banks forward and
# backward for its three passes
C5_PER_MLE = {"flash_fwd": C5_NL, "flash_bwd": C5_NL,
              "gumbel_sample": 0, "image_norm": 1,
              "disc_conv_fwd": 0, "disc_conv_bwd_dx": 0}
C5_PER_GUMBEL = {"flash_fwd": 0, "flash_bwd": 0,
                 "gumbel_sample": T, "image_norm": 1,
                 "disc_conv_fwd": 3, "disc_conv_bwd_dx": 3}


def c5_reset():
    from gan_image_captioning_tpu_torch.kernels import disc_conv
    from gan_image_captioning_tpu_torch.kernels import image_norm as inorm

    cnt = {**tf_counters(), "image_norm": inorm.normalize_images,
           "disc_conv_fwd": disc_conv.conv_bank_forward,
           "disc_conv_bwd_dx": disc_conv.conv_bank_backward}
    for fn in cnt.values():
        fn.launches = fn.bf16_launches = 0
    return cnt


def c5_config(**overrides):
    from gan_image_captioning_tpu_torch.config import (build_parser,
                                                       config_from_args)

    args = build_parser().parse_args(
        ["--preset", "config5", "--dataset", "synthetic", "--max-seq-len",
         str(MAX_SEQ_LEN), "--device", "cuda"])
    args.vocab_size = C5_V
    return config_from_args(args).replace(**overrides)


def c5_batch(device, config):
    """B = 64 captions of 3-34 random GPT-2 ids (ragged: the MLE pass's
    key masks) and seeded 256 x 256 uint8 images."""
    from gan_image_captioning_tpu_torch.data.loader import make_batch
    from gan_image_captioning_tpu_torch.train.steps import batch_to

    rng = np.random.default_rng(505)
    caps = [rng.integers(4, C5_V, size=rng.integers(3, 35))
            for _ in range(B_TRAIN)]
    imgs = [np.random.default_rng(5000 + i).integers(
        0, 256, (3, IMG_S, IMG_S), dtype=np.uint8) for i in range(B_TRAIN)]
    batch = batch_to(make_batch(caps, imgs, T), device)
    check("images_u8" in batch, "config5: the batch is not uint8")
    return batch


def c5_flash(device):
    """The fused flash kernels at the GPT-2 MLE pass's [64, 37, 12, 64]
    (head dim 64: the column-half forward and backward): causal with the
    captions' lengths + 1 and causal alone, in bfloat16 and float32; one
    forward and one backward launch a call (the fused route, as the
    wrapper reports); against the plain
    versions on the same inputs (float32: out within FLASH_OUT_ATOL, dq,
    dk, dv and lse within FLASH_GRAD_RTOL of their largest; bfloat16: each
    entry within a bfloat16 step plus FLASH_GRAD_RTOL); two calls
    bit-equal; device time beside the plain versions', the bound, SDPA
    (forward, backward alone) and the tiled kernels at the same shape
    (their plans swapped in for the fused ones)."""
    import torch.nn.functional as F

    from gan_image_captioning_tpu_torch.kernels import flash_attention as fa

    rng = np.random.default_rng(561)
    lens = torch.from_numpy(rng.integers(3, T + 1, B_TRAIN).astype(np.int32)
                            + 1).to(device)
    shape = (B_TRAIN, T + 1, C5_HEADS, C5_HD)
    rows, times = {}, {}
    for dt_name, dt in (("bf16", BF16), ("f32", torch.float32)):
        for case, ln in (("mle", lens), ("causal", None)):
            name = f"{case}_{dt_name}"
            q, k, v, g = (seeded(shape, 560 + i, device).to(dt)
                          for i in range(4))
            cnt = c5_reset()
            out, lse = fa.flash_fwd(q, k, v, True, ln)
            dq, dk, dv = fa.flash_bwd(q, k, v, out, g, lse, True, ln)
            torch.cuda.synchronize()
            launches = {n: cnt[n].launches for n in ("flash_fwd",
                                                      "flash_bwd")}
            routes = (fa.flash_fwd.last_kernel, fa.flash_bwd.last_kernel)
            bf16_counted = (cnt["flash_fwd"].bf16_launches,
                            cnt["flash_bwd"].bf16_launches)
            p_out, p_lse = fa.flash_fwd_plain(q, k, v, True, ln)
            p_grads = fa.flash_bwd_plain(q, k, v, out, g, lse, True, ln)
            again = fa.flash_fwd(q, k, v, True, ln)
            row = {"shape": list(shape), "dtype": dt_name,
                   "lengths": ln is not None, "launches": launches,
                   "forward_kernel": routes[0], "backward_kernel": routes[1],
                   "lse_rel": float((lse - p_lse).abs().max())
                   / float(p_lse.abs().max()),
                   "bit_equal_repeat": all(
                       torch.equal(a, b) for a, b in zip(
                           (*again, *fa.flash_bwd(q, k, v, out, g, lse, True,
                                                  ln)),
                           (out, lse, dq, dk, dv)))}
            for n, a, b in zip(("out", "dq", "dk", "dv"), (out, dq, dk, dv),
                               (p_out, *p_grads)):
                if dt == BF16:
                    row[f"{n}_max_abs_diff"], row[f"{n}_step_ratio"] = \
                        bf16_steps(a, b, f"config5 flash {name} {n}",
                                   floor=FLASH_GRAD_RTOL)
                else:
                    row[f"{n}_max_abs_diff"] = float((a - b).abs().max())
                    row[f"{n}_rel"] = (row[f"{n}_max_abs_diff"]
                                       / float(b.abs().max()))
            emit({"phase": "config5", "kernel": "flash", "case": name, **row})
            check(launches == {"flash_fwd": 1, "flash_bwd": 1}
                  and bf16_counted == (int(dt == BF16),) * 2,
                  f"config5 flash {name}: launches {launches}")
            check(row["forward_kernel"] == row["backward_kernel"] == "fused"
                  and row["bit_equal_repeat"],
                  f"config5 flash {name}: not the fused route {row}")
            check(row["lse_rel"] <= FLASH_GRAD_RTOL,
                  f"config5 flash {name} lse {row}")
            if dt == torch.float32:
                check(row["out_max_abs_diff"] <= FLASH_OUT_ATOL
                      and all(row[f"{n}_rel"] <= FLASH_GRAD_RTOL
                              for n in ("dq", "dk", "dv")),
                      f"config5 flash {name} {row}")
            rows[name] = row

            b_, t_, h_, d_ = shape
            mask = torch.tril(torch.ones((1, 1, t_, t_), dtype=torch.bool,
                                         device=device))
            if ln is not None:
                mask = mask & (torch.arange(t_, device=device)[None, :]
                               < ln[:, None])[:, None, None, :]
            qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                          for x in (q, k, v))
            gt = g.transpose(1, 2).contiguous()
            lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
            lib_err = float((lib.detach().transpose(1, 2).float()
                             - p_out.float()).abs().max())

            def lib_bwd():
                torch.autograd.grad(lib, (qt, kt, vt), gt, retain_graph=True)

            def tiled_fwd():    # the tiled forward at this shape
                real = fa.flash_fwd_plan
                fa.flash_fwd_plan = lambda t, h, d: {"route": "tiled"}
                try:
                    fa.flash_fwd(q, k, v, True, ln)
                finally:
                    fa.flash_fwd_plan = real

            def tiled_bwd():    # and the tiled backward
                real = fa.flash_bwd_plan
                fa.flash_bwd_plan = lambda t, h, d: fa._tiled_bwd(t, d)
                try:
                    fa.flash_bwd(q, k, v, out, g, lse, True, ln)
                finally:
                    fa.flash_bwd_plan = real

            with torch.no_grad():
                fns = {
                    "kernel_fwd": lambda: fa.flash_fwd(q, k, v, True, ln),
                    "kernel_bwd": lambda: fa.flash_bwd(q, k, v, out, g, lse,
                                                       True, ln),
                    "plain_fwd": lambda: fa.flash_fwd_plain(q, k, v, True,
                                                            ln),
                    "plain_bwd": lambda: fa.flash_bwd_plain(q, k, v, out, g,
                                                            lse, True, ln),
                    "library_fwd": lambda: F.scaled_dot_product_attention(
                        qt.detach(), kt.detach(), vt.detach(),
                        attn_mask=mask),
                    "tiled_fwd": tiled_fwd, "tiled_bwd": tiled_bwd}
                ms = {n: [device_ms(f)] for n, f in fns.items()}
                for n, f in reversed(list(fns.items())):
                    ms[n].append(device_ms(f))
            lib_bwd()
            ms["library_bwd"] = [device_ms(lib_bwd, 10),
                                 device_ms(lib_bwd, 10)]
            del lib
            pairs = attention_pairs(b_, t_, h_, True, ln)
            t_row = {"ms": ms, "library_max_abs_diff": lib_err,
                     "pairs": pairs}
            for kind in ("fwd", "bwd"):
                if dt == BF16:
                    nbytes, flops = flash_bf16_work(kind, b_, t_, h_, d_,
                                                    pairs)
                else:
                    nbytes, flops = flash_work(
                        "flash_fwd" if kind == "fwd" else "whole_bwd",
                        b_, t_, h_, d_, pairs)
                t_row[kind] = dict(zip(("bound_ms", "bound_by"),
                                       bound(nbytes, flops)),
                                   bytes=nbytes, flop=flops)
            emit({"phase": "config5", "timing": "flash", "case": name,
                  **t_row})
            times[name] = t_row
    return rows, times


def c5_gumbel(device):
    """The sampler at [64, 50261] (the scalar cluster path: V % 4 != 0,
    the last CTA's slice past V), bfloat16 and float32, on fed uniforms
    and on its Philox draw: ids equal or ties within ID_ATOL of the row's
    max score, soft within a bfloat16 step (bfloat16) or GUMBEL_SOFT_ATOL
    (float32) of the plain version's; the Philox uniforms fed back give
    the same sample; equal maxima in the first, the last and the partial
    slice go to the lowest index; one launch a call; device time beside
    the plain version's and the bound."""
    from gan_image_captioning_tpu_torch.kernels import gumbel_sample as gs

    plan = gs.gumbel_plan(B_TRAIN, C5_V)
    check(not plan["vec4"] and plan["cluster"] > 1
          and plan["chunk"] * (plan["cluster"] - 1) < C5_V
          <= plan["chunk"] * plan["cluster"], f"config5 sampler plan {plan}")
    rows, times = {"plan": plan}, {}
    for dt_name, dt in (("bf16", BF16), ("f32", torch.float32)):
        logits = seeded((B_TRAIN, C5_V), 570, device, 3.0).to(dt)
        u = torch.rand((B_TRAIN, C5_V), generator=torch.Generator(
            device=device).manual_seed(571), device=device)
        cnt = c5_reset()
        soft, ids = gs.gumbel_sample(logits, 1.0, uniforms=u)
        torch.cuda.synchronize()
        launches = (cnt["gumbel_sample"].launches,
                    cnt["gumbel_sample"].bf16_launches)
        p_soft, p_ids = gs.gumbel_sample_plain(logits, 1.0, u)
        x = (logits.float() - torch.log(-torch.log(u + gs.EPS) + gs.EPS))
        gap = float((x.max(dim=-1).values
                     - x.gather(1, ids.long()[:, None])[:, 0]).max())
        u_out = torch.empty_like(u)
        s_a, i_a = gs.gumbel_sample(logits, 1.0, seed=57, step=3,
                                    uniforms_out=u_out)
        s_b, i_b = gs.gumbel_sample(logits, 1.0, uniforms=u_out)
        row = {"shape": [B_TRAIN, C5_V], "dtype": dt_name,
               "launches": launches, "ids_equal": bool(torch.equal(ids,
                                                                   p_ids)),
               "id_gap": gap, "philox_fed_back_equal": bool(
                   torch.equal(i_a, i_b) and torch.equal(s_a, s_b))}
        if dt == BF16:
            row["max_abs_soft_diff"], row["soft_step_ratio"] = bf16_steps(
                soft, p_soft, "config5 sampler soft")
        else:
            row["max_abs_soft_diff"] = float((soft - p_soft).abs().max())
            check(row["max_abs_soft_diff"] <= GUMBEL_SOFT_ATOL,
                  f"config5 sampler soft {row}")
        emit({"phase": "config5", "kernel": "gumbel_sample", **row})
        check(launches == (1, int(dt == BF16)),
              f"config5 sampler launches {row}")
        check(gap <= ID_ATOL and row["philox_fed_back_equal"],
              f"config5 sampler {row}")
        rows[dt_name] = row
        n = B_TRAIN * C5_V
        size = 2 if dt == BF16 else 4
        nbytes, flops = 2 * size * n + 4 * B_TRAIN, 7 * n
        kern = lambda: gs.gumbel_sample(logits, 1.0, seed=7)   # noqa: E731
        fed = lambda: gs.gumbel_sample(logits, 1.0, uniforms=u)  # noqa: E731
        plain = lambda: gs.gumbel_sample_plain(logits, 1.0, u)  # noqa: E731
        p_a, k_a, f_a = device_ms(plain), device_ms(kern), device_ms(fed)
        f_b, k_b, p_b = device_ms(fed), device_ms(kern), device_ms(plain)
        b_ms, b_by = bound(nbytes, flops)
        times[dt_name] = {"kernel_ms": [k_a, k_b],
                          "kernel_fed_uniforms_ms": [f_a, f_b],
                          "plain_ms": [p_a, p_b], "bound_ms": b_ms,
                          "bound_by": b_by, "bytes": nbytes, "flop": flops,
                          "shape": [B_TRAIN, C5_V]}
        emit({"phase": "config5", "timing": "gumbel_sample",
              "dtype": dt_name, **times[dt_name]})
    cols = [5, plan["chunk"] * (plan["cluster"] - 1) + 3, C5_V - 1]
    tied = torch.zeros((B_TRAIN, C5_V), device=device)
    tied[:, cols] = 10.0
    tied[1:, cols[0]] = 0.0
    tied[2:, cols[1]] = 0.0
    _, t_ids = gs.gumbel_sample(tied, 1.0, uniforms=torch.full_like(tied,
                                                                    0.5))
    want = torch.full((B_TRAIN,), cols[2], dtype=torch.int32, device=device)
    want[0], want[1] = cols[0], cols[1]
    rows["ties_to_lowest_index"] = bool(torch.equal(t_ids, want))
    check(rows["ties_to_lowest_index"], f"config5 sampler ties {t_ids[:3]}")
    return rows, times


def c5_image_norm(device):
    """``image_norm`` on config5's [64, 3, 256, 256] uint8 batch into
    bfloat16: bit-equal to its plain version, one launch; device time
    beside the plain version's, the bound and ``torch.addcmul``."""
    from gan_image_captioning_tpu_torch.kernels import image_norm as inorm

    u8 = seeded_u8((B_TRAIN, 3, IMG_S, IMG_S), 580, device)
    cnt = c5_reset()
    out_k = inorm.normalize_images(u8, BF16)
    torch.cuda.synchronize()
    out_p = inorm.normalize_images_plain(u8, BF16)
    row = {"shape": list(u8.shape), "launches": cnt["image_norm"].launches,
           "bit_equal": bool(torch.equal(out_k, out_p)),
           "max_abs_diff": float((out_k.float() - out_p.float()).abs().max())}
    check(row["launches"] == 1 and out_k.dtype == BF16 and row["bit_equal"],
          f"config5 image_norm {row}")
    scale, shift = inorm._affine(device)
    lib_out = torch.empty(u8.shape, dtype=BF16, device=device)
    library = lambda: torch.addcmul(shift, u8, scale,      # noqa: E731
                                    out=lib_out)
    kern = lambda: inorm.normalize_images(u8, BF16)       # noqa: E731
    k_a, l_a = (device_ms(f, 50) for f in (kern, library))
    l_b, k_b = (device_ms(f, 50) for f in (library, kern))
    n = u8.numel()
    b_ms, b_by = bf16_bound(3 * n, 2 * n, F32_FLOP_PER_S)
    times = {"kernel_ms": [k_a, k_b], "library_ms": [l_a, l_b],
             "plain_ms": [cuda_ms(lambda: inorm.normalize_images_plain(
                 u8, BF16), reps=20) for _ in range(2)],
             "plain_timer": "cuda_ms", "bound_ms": b_ms, "bound_by": b_by}
    emit({"phase": "config5", "kernel": "image_norm", **row, **times})
    return row, times


def c5_profile(fn, calls):
    """``calls`` calls of ``fn`` under torch.profiler (CUDA activity; the
    raw device events): device ms, kernel launches and busy share per
    call, the device time of the ten longest kernels by name, the host ms
    per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name, n = {}, 0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        key = ev.name()[:300]     # far enough to name the functor
        by_name[key] = by_name.get(key, 0.0) + ev.duration_ns() / 1e6 / calls
        n += 1
    total = sum(by_name.values())
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:10])
    return {"host_ms_per_step": wall / calls, "device_ms_per_step": total,
            "launches_per_step": n / calls, "busy_share": total * calls / wall,
            "top_kernels_ms_per_step": top}


@contextlib.contextmanager
def float32_running_stats(module):
    """Within it, ``module``'s floating buffers (the encoder head's
    BatchNorm statistics, kept in bfloat16 once a bfloat16 train step has
    moved them) read as float32 copies, for a float32 step on the same
    state; the buffers are put back after."""
    bufs = [(m, n, b) for m in module.modules()
            for n, b in m._buffers.items()
            if b is not None and b.is_floating_point()]
    for m, n, b in bufs:
        m._buffers[n] = b.float()
    try:
        yield
    finally:
        for m, n, b in bufs:
            m._buffers[n] = b


def c5_steps(device):
    """config5 at full width in bfloat16 (random weights from seed 0):
    2 MLE and 2 Gumbel adversarial steps through ``train/steps.py`` with
    the launches of the design, every one bfloat16, the frozen ViT
    bit-unchanged after them and its head moved; each step's losses and
    gradients through the kernels against the same step through their
    plain versions (flash, sampler, ``image_norm``, the conv banks with
    the kernel route's argmax rows replayed) on the same state and fed
    noise, as phase ``tf_bf16`` holds them; then each step's device time
    by kernel, launches, busy share and the peak memory."""
    from gan_image_captioning_tpu_torch.kernels import disc_conv
    from gan_image_captioning_tpu_torch.train.state import create_train_state
    from gan_image_captioning_tpu_torch.train.steps import (make_adv_step,
                                                            make_mle_step)

    t0 = time.perf_counter()
    config = c5_config()
    check((config.gen_embed_dim, config.gen_num_layers, config.gen_num_heads,
           config.encoder_arch, config.dtype, config.cgan) == (
               C5_D, C5_NL, C5_HEADS, "vit", "bfloat16", True),
          f"config5 config {config}")
    state = create_train_state(config, 0, device, sweep=False)
    batch = c5_batch(device, config)
    t_init = time.perf_counter() - t0
    vit0 = {k: v.clone() for k, v in state.gen.encoder.vit.state_dict()
            .items()}
    head0 = state.gen.encoder.linear.weight.detach().clone()
    torch.cuda.reset_peak_memory_stats(device)
    mle, adv = make_mle_step(config), make_adv_step(config)
    row, metrics = {"init_seconds": t_init}, []
    for kind, step, per in (("mle", lambda: mle(state, batch), C5_PER_MLE),
                            ("gumbel", lambda: adv(state, batch, TEMP),
                             C5_PER_GUMBEL)):
        cnt = c5_reset()
        for _ in range(2):
            _, m = step()
            metrics.append({"step": kind, **{k: float(v)
                                             for k, v in m.items()}})
        torch.cuda.synchronize()
        launches = bf16_launches(cnt, f"config5 {kind} steps")
        want = {k: 2 * v for k, v in per.items()}
        row[f"{kind}_launches"] = launches
        check(launches == want, f"config5 {kind} launches {launches} != "
              f"{want}")
    row["peak_memory_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    row["metrics"] = metrics
    row["vit_bit_unchanged"] = all(
        torch.equal(v, vit0[k]) for k, v in
        state.gen.encoder.vit.state_dict().items())
    row["head_moved"] = not torch.equal(state.gen.encoder.linear.weight,
                                        head0)
    emit({"phase": "config5", "steps": row})
    check(all(math.isfinite(v) for m in metrics for k, v in m.items()
              if k != "step"), f"config5 non-finite metric {metrics}")
    check(row["vit_bit_unchanged"] and row["head_moved"],
          "config5: the frozen ViT moved, or the head did not")
    check(not any(k.startswith("encoder.vit.") for k in state.gen_opt.mu),
          "config5: the frozen ViT is in the optimizer")

    plain_cfg = config.replace(disc_engine="plain", image_norm_impl="plain")
    for kind in ("mle", "gumbel"):
        noise = None
        if kind == "gumbel":
            from gan_image_captioning_tpu_torch.models.api import (
                disc_keep_shape)

            gen = torch.Generator(device=device).manual_seed(583)
            noise = {"uniforms": torch.rand((T, B_TRAIN, C5_V),
                                            generator=gen, device=device),
                     "keep": [torch.rand(disc_keep_shape(config, B_TRAIN),
                                         generator=gen, device=device) < 0.8
                              for _ in range(3)]}
        with disc_conv.argmax_record() as rec:
            kern = tf_bf16_grads(kind, config, state, batch, noise)
        with disc_conv.argmax_replay(rec) as report, tf_plain_versions():
            plain = tf_bf16_grads(kind, plain_cfg, state, batch, noise)
        with float32_running_stats(state.gen):
            ref32 = tf_bf16_grads(kind, config.replace(dtype="float32"),
                                  state, batch, noise)
        units, misses = tf_bf16_compare(kern, plain, ref32)
        worst = sorted(units.items(), key=lambda kv: -kv[1])[:4]
        tie_scale = max([float(p.abs().max()) for _, p in rec["pool"]]
                        + [float(x.abs().max()) for x in rec["relu"]]
                        + [1e-30])
        cmp = {"g_loss": [float(kern[0]), float(plain[0])],
               "d_loss": [float(kern[1]), float(plain[1])],
               "ids_equal": bool(torch.equal(kern[4]["gen_ids"],
                                             plain[4]["gen_ids"])),
               "argmax_gap_units": max([gp for gp, _ in report] + [0.0])
               / (BF16_UNIT * tie_scale),
               "worst_grad_units": worst, "misses": misses}
        emit({"phase": "config5", "kernels_vs_plain": kind, **cmp})
        for a, b in (cmp["g_loss"], cmp["d_loss"]):
            check(abs(a - b) <= BF16_LOSS_UNITS * BF16_UNIT * max(abs(b),
                                                                  1e-30),
                  f"config5 {kind} losses {cmp}")
        check(cmp["ids_equal"], f"config5 {kind}: the routes sampled apart")
        check(cmp["argmax_gap_units"] <= BF16_ID_UNITS,
              f"config5 {kind} conv ties {cmp}")
        check(not misses, f"config5 {kind} gradients {cmp}")
        row[f"{kind}_vs_plain"] = cmp
        del kern, plain, ref32, noise

    prof = {"mle": c5_profile(lambda: mle(state, batch), 2),
            "gumbel": c5_profile(lambda: adv(state, batch, TEMP), 2)}
    emit({"phase": "config5", "profile": prof})
    row["profile"] = prof
    return row


def c5_cond_config4(device):
    """config4 with ``--conditional-gan 1`` (the ResNet-18 grid of 256 x
    256 uint8 images, 512 channels through ``ctx_proj`` into 256), float32
    at full width: one MLE step's loss and gradients through the kernels
    against the plain route (attention, ``image_norm``) as phase
    ``tf_train`` holds them, and one REINFORCE step with finite metrics,
    the cross-attention in both."""
    from gan_image_captioning_tpu_torch.data.loader import make_batch
    from gan_image_captioning_tpu_torch.train.state import create_train_state
    from gan_image_captioning_tpu_torch.train.steps import (batch_to,
                                                            make_adv_step)

    config = tf_config(conditional_gan=1, image_size=IMG_S)
    state = create_train_state(config, 0, device, sweep=False)
    rng = np.random.default_rng(591)
    caps = [rng.integers(4, min(11000, V), size=rng.integers(3, 35))
            for _ in range(B_TRAIN)]
    imgs = [np.random.default_rng(5900 + i).integers(
        0, 256, (3, IMG_S, IMG_S), dtype=np.uint8) for i in range(B_TRAIN)]
    batch = batch_to(make_batch(caps, imgs, T), device)
    plain_cfg = config.replace(attn_impl="plain", image_norm_impl="plain")
    kern = tf_grads("mle", config, state, batch, None)
    plain = tf_grads("mle", plain_cfg, state, batch, None)
    cmp = compare_grads(kern, plain)
    cnt = c5_reset()
    state, m = make_adv_step(config)(state, batch, 1.0)
    torch.cuda.synchronize()
    row = {"g_loss": cmp["g_loss"], "grad_side_rel_err":
           cmp["grad_side_rel_err"],
           "ctx_proj_grad_max": float(kern[2]["decoder.ctx_proj.w"].abs()
                                      .max()),
           "reinforce_metrics": {k: float(v) for k, v in m.items()},
           "reinforce_launches": {k: f.launches for k, f in cnt.items()}}
    emit({"phase": "config5", "config4_conditional": row})
    a, b = cmp["g_loss"]
    check(abs(a - b) <= LOSS_RTOL * max(abs(b), 1e-30)
          and routes_agree(cmp), f"config5 config4 conditional {row}")
    check(row["ctx_proj_grad_max"] > 0, "config4 conditional: ctx_proj "
          "has no gradient")
    check(all(math.isfinite(v) for v in row["reinforce_metrics"].values())
          and row["reinforce_launches"]["image_norm"] == 1
          and row["reinforce_launches"]["gumbel_sample"] == T,
          f"config4 conditional REINFORCE {row}")
    return row


def c5_main(workdir):
    """``main.py --preset config5 --dataset synthetic`` on C5_ITEMS items
    (full width: synthetic captions keep their own vocabulary), one
    pretrain and one adversarial epoch.  Its adversarial checkpoint
    greedily decodes ``<PAD>`` for every image (two steps of an MLE loss
    that covers the padding positions), which would hide a service that
    dropped the grid; so the checkpoint is written again with its decoder
    drawn afresh from a seed (the projection at N(0, 1) rather than 0.02,
    so that no argmax is a near-tie), its trained encoder kept, and that
    one is served (``{"image"}`` rows through the
    coalescing engine: features and grid) and captioned by ``caption.py``
    on the same C5_SERVE val images: the same ids, text and
    log-probabilities, ids that differ across the images, and the
    control: the same rows decoded without their grid decode apart."""
    import shutil

    from gan_image_captioning_tpu_torch import caption as caption_main
    from gan_image_captioning_tpu_torch import main as train_main
    from gan_image_captioning_tpu_torch import serve
    from gan_image_captioning_tpu_torch.data.synthetic import (
        SyntheticCaptions)
    from gan_image_captioning_tpu_torch.eval import decode as decode_lib
    from gan_image_captioning_tpu_torch.models import api
    from gan_image_captioning_tpu_torch.models.transformer import (
        init_transformer_decoder_params)
    from gan_image_captioning_tpu_torch.train import checkpoint as ckpt_lib

    save = workdir / "config5_loop"
    shutil.rmtree(save, ignore_errors=True)
    flags = ["--preset", "config5", "--dataset", "synthetic",
             "--synthetic-items", str(C5_ITEMS), "--max-seq-len",
             str(MAX_SEQ_LEN)]
    cnt = c5_reset()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        inst = train_main.main([*flags, "--pretrain-epochs", "1",
                                "--adv-epochs", "1", "--save-dir", str(save),
                                "--expt-name", "config5"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = bf16_launches(cnt, "config5 main.py")
    model_dir = Path(inst.config.model_dir)
    gen, disc_sd = ckpt_lib.load_generator_checkpoint(
        str(model_dir / "adv_model.ckpt"), inst.config)
    init_transformer_decoder_params(torch.Generator().manual_seed(7),
                                    gen.decoder)
    with torch.no_grad():
        gen.decoder.linear.w.mul_(50.0)     # N(0, 1): decisive argmaxes
    ckpt = str(model_dir / "served_model.ckpt")
    ckpt_lib.save_generator_checkpoint(ckpt, gen, disc_sd)
    del gen, disc_sd
    val = SyntheticCaptions("val", num_items=max(C5_ITEMS // 4, 16),
                            image_size=IMG_S, conditional=True,
                            seed=inst.config.seed)
    images = np.stack([val.sample(i)[1] for i in range(C5_SERVE)])
    service = serve.CaptionService(serve.parse_args(
        ["--checkpoint", ckpt, *flags, "--serve-batch-size",
         str(C5_SERVE)]))
    try:
        served = service.caption_images(images)
        # the engine's ids of the same rows, past each caption's <E>
        served_ids, _ = service.batcher.submit(
            service.features_from_images(images)).result(timeout=300)
        # the greedy decode of the same rows with their grid and, the
        # control, without it (what a service passing only the features
        # decodes)
        config = service.config
        with torch.no_grad():
            cond, _ = api.generator_condition(
                config, service.generator,
                {"images": torch.from_numpy(images).to(service.device)})
            with_grid, without_grid = (
                [t.cpu().numpy() for t in decode_lib.greedy_with_logprobs(
                    service.generator, cond["features"], config,
                    context=ctx)] for ctx in (cond["context"], None))
    finally:
        service.close()
    out = save / "captions.jsonl"
    with contextlib.redirect_stdout(io.StringIO()):
        caption_ids = np.stack(caption_main.main(
            ["--checkpoint", ckpt, *flags, "--num-samples", str(C5_SERVE),
             "--pre-eval-batch-size", str(C5_SERVE), "--output", str(out)]))
    rows = [json.loads(ln) for ln in open(out)]
    row = {"seconds": seconds, "launches": launches,
           "pretrain_steps": inst.pretrain_steps,
           "gen_steps": inst.state.gen_steps,
           "served": served["captions"],
           "captioned": [r["caption"] for r in rows],
           "ids_equal": bool(np.array_equal(served_ids, caption_ids)),
           "ids": caption_ids[:2].tolist(),
           "distinct_id_rows": len({tuple(r) for r in caption_ids}),
           "non_pad_ids": int((caption_ids != 0).sum()),
           "max_abs_logprob_diff": max(
               abs(a - r["logprob"]) for a, r in zip(served["logprobs"],
                                                     rows)),
           "with_grid_equal_served": bool(np.array_equal(with_grid[0],
                                                         served_ids)),
           "without_grid_rows_differing": int(
               (with_grid[0] != without_grid[0]).any(axis=1).sum()),
           "without_grid_max_abs_logprob_diff": float(
               np.abs(with_grid[1] - without_grid[1]).max())}
    emit({"phase": "config5", "loop": row})
    check(inst.config.gen_embed_dim == C5_D and inst.config.cgan
          and inst.config.dtype == "bfloat16", "config5 main.py: the preset "
          "did not reach the config")
    check(inst.pretrain_steps > 0 and inst.state.gen_steps > 0,
          f"config5 main.py steps {row}")
    check(launches["gumbel_sample"] > 0 and launches["flash_fwd"] > 0,
          f"config5 main.py launches {launches}")
    check(row["served"] == row["captioned"] and row["ids_equal"]
          and row["with_grid_equal_served"]
          and row["max_abs_logprob_diff"] <= 1e-3,
          f"config5: serve.py and caption.py part {row}")
    check(row["distinct_id_rows"] > 1 and row["non_pad_ids"] > 0,
          f"config5: the served ids do not follow the image {row}")
    check(row["without_grid_rows_differing"] > 0
          or row["without_grid_max_abs_logprob_diff"] > 1e-3,
          f"config5: the rows decode alike without their grid {row}")
    return row


def phase_config5(device, workdir):
    """Preset config5 at full width (the chip_smoke docstring's
    ``config5``)."""
    marks = [("start", time.perf_counter())]
    flash_rows, flash_times = c5_flash(device)
    marks.append(("flash", time.perf_counter()))
    g_rows, g_times = c5_gumbel(device)
    marks.append(("gumbel", time.perf_counter()))
    norm_row, norm_times = c5_image_norm(device)
    marks.append(("image_norm", time.perf_counter()))
    steps = c5_steps(device)
    marks.append(("steps", time.perf_counter()))
    torch.cuda.empty_cache()
    cond4 = c5_cond_config4(device)
    marks.append(("config4_conditional", time.perf_counter()))
    torch.cuda.empty_cache()
    loop = c5_main(workdir)
    marks.append(("loop", time.perf_counter()))
    emit({"phase": "config5", "seconds": marks[-1][1] - marks[0][1],
          "seconds_by_part": {name: t - marks[i][1] for i, (name, t)
                              in enumerate(marks[1:])}})
    return {"flash": flash_rows, "flash_times": flash_times,
            "gumbel": g_rows, "gumbel_times": g_times, "norm": norm_row,
            "norm_times": norm_times, "steps": steps, "cond4": cond4,
            "loop": loop}


def config5_entries(smi, row):
    """config5's kernels on the ``kernels`` line, in bfloat16 at its
    shapes (the float32 instantiation's times under ``float32``):
    the fused flash at [64, 37, 12, 64] (the MLE pass's lengths; the
    tiled kernels at the same shape under ``tiled_route_ms``), the
    sampler at [64, 50261] and ``image_norm`` at [64, 3, 256, 256];
    launches from the phase's counted drive (2 MLE and 2 Gumbel steps)."""
    steps = row["steps"]
    out = []
    for name, tpu in C5_TPU_KERNELS.items():
        counter = C5_COUNTERS[name]
        launches = sum(steps[f"{k}_launches"][counter]
                       for k in ("mle", "gumbel"))
        if name == "gumbel_sample_config5":
            t, t32 = row["gumbel_times"]["bf16"], row["gumbel_times"]["f32"]
            entry = {"ms": min(t["kernel_ms"]), "plain_ms": min(t["plain_ms"]),
                     "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                     "library_ms": None, "shape": t["shape"],
                     "max_abs_err": max(row["gumbel"][d]["max_abs_soft_diff"]
                                        for d in ("bf16", "f32")),
                     "float32": {k: (min(t32[k]) if isinstance(t32[k], list)
                                     else t32[k]) for k in
                                 ("kernel_ms", "plain_ms", "bound_ms")}}
            src = "gumbel_sample.cu"
        elif name == "image_norm_config5":
            t = row["norm_times"]
            entry = {"ms": min(t["kernel_ms"]), "plain_ms": min(t["plain_ms"]),
                     "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                     "library_ms": min(t["library_ms"]),
                     "shape": row["norm"]["shape"],
                     "max_abs_err": row["norm"]["max_abs_diff"]}
            src = "image_norm.cu"
        else:
            kind = "fwd" if name == "flash_fwd_config5" else "bwd"
            keys = (("out",) if kind == "fwd" else
                    ("dq",) if name == "flash_dq_config5" else ("dk", "dv"))
            t, t32 = row["flash_times"]["mle_bf16"], row["flash_times"][
                "mle_f32"]
            entry = {"ms": min(t["ms"][f"kernel_{kind}"]),
                     "plain_ms": min(t["ms"][f"plain_{kind}"]),
                     "bound_ms": t[kind]["bound_ms"],
                     "bound_by": t[kind]["bound_by"],
                     "library_ms": min(t["ms"][f"library_{kind}"]),
                     "shape": row["flash"]["mle_bf16"]["shape"],
                     "max_abs_err": max(r[f"{k}_max_abs_diff"] for r in
                                        row["flash"].values() for k in keys),
                     "timed_as": "one launch of flash_bwd_fused64_kernel "
                     "(delta, dQ, dK and dV)" if kind == "bwd" else
                     "flash_fwd_fused64_kernel",
                     "tiled_route_ms": min(t["ms"][f"tiled_{kind}"]),
                     "by_case": {c: {
                         "ms": min(x["ms"][f"kernel_{kind}"]),
                         "plain_ms": min(x["ms"][f"plain_{kind}"]),
                         "library_ms": min(x["ms"][f"library_{kind}"]),
                         "tiled_route_ms": min(x["ms"][f"tiled_{kind}"]),
                         "bound_ms": x[kind]["bound_ms"]}
                         for c, x in row["flash_times"].items()},
                     "float32": {"ms": min(t32["ms"][f"kernel_{kind}"]),
                                 "plain_ms": min(t32["ms"][f"plain_{kind}"]),
                                 "library_ms": min(t32["ms"][
                                     f"library_{kind}"]),
                                 "tiled_route_ms": min(t32["ms"][
                                     f"tiled_{kind}"]),
                                 "bound_ms": t32[kind]["bound_ms"]}}
            src = "flash_attention.cu"
        out.append({"name": name, "route": "cuda",
                    "source": "gan_image_captioning_tpu_torch/kernels/csrc/"
                              + src, "replaces": tpu, "launches": launches,
                    **entry, "dtype": "bfloat16", "card": smi})
    return out


# ----------------------------------------------------------- serving_rest

SR_ROWS = 16                       # config4 feature rows per comparison
SR_REPS = 10                       # requests per latency cell
SR_C5_IMAGES = 8
SR_DRAFT_LEN = 4
SR_C5_FLAGS = ["--preset", "config5", "--dataset", "synthetic",
               "--vocab-multiple", str(C5_V), "--max-seq-len",
               str(MAX_SEQ_LEN)]


def rest_counters():
    """The serving kernels' launch counters: the full-T serve decode, the
    carried chunk (continuous dense) and the quantized serve decode."""
    from gan_image_captioning_tpu_torch.kernels import decode_sample as ds

    return {"decode_serve": ds.decode_sample,
            "decode_serve_carry": ds.decode_sample_carry,
            "decode_qserve_int8": ds.decode_sample_q_serve}


def rest_launches():
    return {k: fn.launches for k, fn in rest_counters().items()}


def tf_ties(dec, config, feats, ctx, a, b):
    """``step_ties`` for a transformer: where the rows of ids ``a`` and
    ``b`` part before their first <E>, the two tokens' log-probabilities
    after the common prefix, by the parallel causal pass over ``a`` (the
    flash kernels on the card: an independent route) → (rows differing,
    max gap)."""
    from gan_image_captioning_tpu_torch.models import transformer as ttf

    diff = [i for i in range(a.shape[0])
            if prefix(a[i].tolist()) != prefix(b[i].tolist())]
    if not diff:
        return 0, 0.0
    rows = torch.tensor(diff, device=feats.device)
    with torch.no_grad():
        logits = ttf.teacher_forced(
            dec, feats[rows], a.to(feats.device)[rows], config,
            context=None if ctx is None else ctx[rows])
    logp = torch.log_softmax(logits.float(), dim=-1)
    gaps = []
    for j, i in enumerate(diff):
        t = int((a[i] != b[i]).nonzero()[0])
        gaps.append(float((logp[j, t, int(a[i, t])]
                           - logp[j, t, int(b[i, t])]).abs()))
    return len(diff), max(gaps)


def engine_latency(service, request, reps=SR_REPS):
    """p50 / p90 of ``request()`` on each engine of a service built with
    ``--serve-continuous`` (the coalescing one by setting its continuous
    engine aside for the calls), in turns."""
    cont = service.continuous
    ms = {"continuous": [], "coalescing": []}
    request()                                        # one warm call each
    service.continuous = None
    request()
    service.continuous = cont
    for _ in range(reps):
        for engine in ("continuous", "coalescing"):
            service.continuous = cont if engine == "continuous" else None
            t0 = time.perf_counter()
            request()
            ms[engine].append((time.perf_counter() - t0) * 1e3)
    service.continuous = cont
    return {k: percentiles(v) for k, v in ms.items()}


def engines_agree(service, rows, what):
    """The same rows through the continuous and the coalescing engine of
    one service → (continuous ids, coalescing ids, lps of both)."""
    ids_c, lp_c = service._continuous(rows, None)
    ids_b, lp_b = service.batcher.submit(rows).result(timeout=600)
    ids_c, ids_b = torch.from_numpy(ids_c), torch.from_numpy(ids_b)
    check(ids_c.shape == ids_b.shape, f"{what}: shapes {ids_c.shape}")
    return ids_c, ids_b, np.asarray(lp_c), np.asarray(lp_b)


def scaled_transformer_checkpoint(flags, path):
    """A seeded transformer generator at a preset's full width, its output
    projection scaled by 50 (N(0, 1): decisive argmaxes, as ``c5_main``
    draws its served decoder), written to ``path``."""
    from gan_image_captioning_tpu_torch import serve
    from gan_image_captioning_tpu_torch.train import checkpoint as ckpt_lib

    service = serve.CaptionService(serve.parse_args(
        ["--init-seed", "0", *flags]))
    try:
        with torch.no_grad():
            service.generator.decoder.linear.w.mul_(50.0)
        ckpt_lib.save_generator_checkpoint(str(path), service.generator)
    finally:
        service.close()


def rest_transformer(device, workdir):
    """config4's continuous engine against its coalescing one, its
    adaptive decode and ``--quantize int8``; config5's slots with their
    grid, the slot pool's memory; latencies on both engines."""
    from gan_image_captioning_tpu_torch import serve
    from gan_image_captioning_tpu_torch.eval import decode as decode_lib
    from gan_image_captioning_tpu_torch.ops.quantize import quantize_generator

    out = {}
    c4 = workdir / "config4_served.ckpt"
    scaled_transformer_checkpoint(TF_MODEL_FLAGS, c4)
    service = serve.CaptionService(serve.parse_args(
        ["--checkpoint", str(c4), *TF_MODEL_FLAGS, "--serve-continuous"]))
    try:
        config = service.config
        E4 = config.gen_embed_dim
        rows = seeded((SR_ROWS, E4), 610, torch.device("cpu")).numpy()
        feats = torch.from_numpy(rows).to(device)
        ids_c, ids_b, lp_c, lp_b = engines_agree(service, rows, "config4")
        dec = service.generator.decoder
        n_diff, gap = tf_ties(dec, config, feats, None, ids_b, ids_c)
        same = [i for i in range(SR_ROWS)
                if prefix(ids_c[i].tolist()) == prefix(ids_b[i].tolist())]
        lp_diff = max((abs(lp_c[i] - lp_b[i]) for i in same), default=0.0)
        # the adaptive decode (coalescing, 8-step chunks)
        service.adaptive_chunk = 8
        ids_a, lp_a = service._run_decode(rows)
        service.adaptive_chunk = 0
        n_diff_a, gap_a = tf_ties(dec, config, feats, None, ids_b, ids_a.cpu())
        row = {"rows": SR_ROWS, "continuous_rows_differing": n_diff,
               "continuous_max_id_gap": gap,
               "continuous_max_abs_seq_lp_diff": float(lp_diff),
               "adaptive_rows_differing": n_diff_a,
               "adaptive_max_id_gap": gap_a,
               "distinct_ids": int(ids_b.unique().numel()),
               "latency": {f"n{n}": engine_latency(
                   service, lambda n=n: service.handle_request({"n": n}))
                   for n in (1, 8)},
               "stats": service.continuous.stats()}
        check(gap <= ID_ATOL and lp_diff <= SEQ_ATOL,
              f"config4: continuous against coalescing {row}")
        check(gap_a <= ID_ATOL, f"config4: adaptive against full {row}")
        check(row["distinct_ids"] > 4, f"config4: degenerate ids {row}")
        unquant = ids_b
    finally:
        service.close()
    # --quantize int8: the fake-quantized twin on both engines
    service = serve.CaptionService(serve.parse_args(
        ["--checkpoint", str(c4), *TF_MODEL_FLAGS, "--serve-continuous",
         "--quantize", "int8"]))
    try:
        twin = quantize_generator(service.generator, service.config)
        ids_r, lp_r = decode_lib.greedy_with_logprobs(twin, feats,
                                                      service.config)
        ids_c, ids_b, _, lp_b = engines_agree(service, rows, "config4 int8")
        changed = sum(int(not torch.equal(a, b)) for a, b in zip(
            twin.state_dict().values(),
            service.generator.state_dict().values()))
        q_diff, q_gap = tf_ties(twin.decoder, service.config, feats, None,
                                ids_r.cpu(), ids_b)
        c_diff, c_gap = tf_ties(twin.decoder, service.config, feats, None,
                                ids_r.cpu(), ids_c)
        row["int8"] = {
            "tensors_quantized": changed,
            "coalescing_rows_differing": q_diff,
            "coalescing_max_id_gap": q_gap,
            "continuous_rows_differing": c_diff,
            "continuous_max_id_gap": c_gap,
            "rows_differing_from_float32": int(sum(
                prefix(a.tolist()) != prefix(b.tolist())
                for a, b in zip(ids_b, unquant)))}
        check(changed > 0 and q_gap <= ID_ATOL and c_gap <= ID_ATOL,
              f"config4 int8: {row['int8']}")
    finally:
        service.close()
    emit({"phase": "serving_rest", "part": "config4", **row})
    out["config4"] = row
    torch.cuda.empty_cache()

    # config5: slots that carry their grid (the projection scaled in
    # place: both engines read the same parameters)
    images = seeded((SR_C5_IMAGES, 3, IMG_S, IMG_S), 620,
                    torch.device("cpu")).numpy()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    service = serve.CaptionService(serve.parse_args(
        ["--init-seed", "0", *SR_C5_FLAGS, "--serve-continuous",
         "--serve-batch-size", str(SR_C5_IMAGES)]))
    try:
        with torch.no_grad():
            service.generator.decoder.linear.w.mul_(50.0)
        config = service.config
        torch.cuda.synchronize()
        built = torch.cuda.memory_allocated()
        rows = service.features_from_images(images)
        torch.cuda.reset_peak_memory_stats()
        ids_c, ids_b, lp_c, lp_b = engines_agree(service, rows, "config5")
        torch.cuda.synchronize()
        request_peak = torch.cuda.max_memory_allocated()
        E5 = config.gen_embed_dim
        x = torch.from_numpy(rows).to(device)
        feats, ctx = x[:, :E5], x[:, E5:].reshape(-1, *service.context_shape)
        n_diff, gap = tf_ties(service.generator.decoder, config, feats, ctx,
                              ids_b, ids_c)
        same = [i for i in range(SR_C5_IMAGES)
                if prefix(ids_c[i].tolist()) == prefix(ids_b[i].tolist())]
        lp_diff = max((abs(lp_c[i] - lp_b[i]) for i in same), default=0.0)
        row5 = {"images": SR_C5_IMAGES, "vocab_size": config.vocab_size,
                "continuous_rows_differing": n_diff,
                "continuous_max_id_gap": gap,
                "continuous_max_abs_seq_lp_diff": float(lp_diff),
                "distinct_id_rows": len({tuple(prefix(r.tolist()))
                                         for r in ids_b}),
                "slot_pool_bytes": service.continuous._slots.buffer_bytes(),
                "allocated_after_build_bytes": built - before,
                "request_peak_bytes": request_peak,
                "request_peak_over_built_bytes": request_peak - built,
                "slots": SR_C5_IMAGES,
                "latency": {f"images{n}": engine_latency(
                    service, lambda n=n: service.caption_images(images[:n]),
                    reps=5) for n in (1, SR_C5_IMAGES)}}
        check(config.gen_embed_dim == C5_D and config.cgan,
              "config5: the preset did not reach the service")
        check(gap <= ID_ATOL and lp_diff <= SEQ_ATOL,
              f"config5: continuous against coalescing {row5}")
        check(row5["distinct_id_rows"] > 1, f"config5: ids {row5}")
    finally:
        service.close()
    emit({"phase": "serving_rest", "part": "config5", **row5})
    out["config5"] = row5
    torch.cuda.empty_cache()
    return out


def rest_speculative(gen, device, workdir):
    """config3's ``--decode-mode speculative`` (the int8 twin drafting
    SR_DRAFT_LEN tokens a block) on both engines against the serve
    kernel's greedy ids; ms a call beside the kernel; the accepted share
    and tokens a block."""
    from gan_image_captioning_tpu_torch import serve
    from gan_image_captioning_tpu_torch.eval import decode as decode_lib
    from gan_image_captioning_tpu_torch.eval.speculative import (
        speculative_greedy)

    ckpt = str(workdir / "gen_full_width.ckpt")
    out = {}
    for B in (8, 64):
        feats = seeded((B, E), 630 + B, device)
        want, _ = decode_lib.greedy_with_logprobs(gen, feats, eval_config())
        services = {}
        try:
            for engine in ("coalescing", "continuous"):
                extra = ["--serve-continuous"] if engine == "continuous" \
                    else []
                services[engine] = serve.CaptionService(serve.parse_args(
                    ["--checkpoint", ckpt, *MODEL_FLAGS, "--decode-mode",
                     "speculative", "--draft-len", str(SR_DRAFT_LEN),
                     "--serve-batch-size", str(B), *extra]))
            coal, cont = services["coalescing"], services["continuous"]
            rows = feats.cpu().numpy()
            ids_b, _ = coal._run_decode(rows)
            ids_c, _ = cont._continuous(rows, None)
            ids_c = torch.from_numpy(ids_c).to(device)
            _, stats = speculative_greedy(
                coal.generator, coal.dec_params, feats, coal.config,
                draft_len=SR_DRAFT_LEN, early_stop=True, return_stats=True)
            d_b, gap_b = step_ties(gen.decoder, feats, ids_b, want)
            d_c, gap_c = step_ties(gen.decoder, feats, ids_c, want)
            cont_stats = cont.continuous.stats()
            calls0 = cont_stats["device_calls"]
            ms = {"speculative_coalescing": host_ms(
                      lambda: coal._run_decode(rows), 5),
                  "speculative_continuous": host_ms(
                      lambda: cont._continuous(rows, None), 5),
                  "greedy_kernel": host_ms(
                      lambda: decode_lib.greedy_with_logprobs(
                          gen, feats, eval_config()), 5)}
            cont_stats = cont.continuous.stats()
        finally:
            for svc in services.values():
                svc.close()
        row = {"B": B, "draft_len": SR_DRAFT_LEN,
               "coalescing_rows_differing": d_b,
               "coalescing_max_id_gap": gap_b,
               "continuous_rows_differing": d_c,
               "continuous_max_id_gap": gap_c,
               "accepted_share": stats["accepted"] / max(1,
                                                         stats["proposed"]),
               "accepted": stats["accepted"], "proposed": stats["proposed"],
               "continuous_tokens_per_slot_chunk": cont_stats.get(
                   "tokens_per_slot_chunk"),
               "continuous_device_calls_per_call": (
                   cont_stats["device_calls"] - calls0) / 6,
               "host_ms": {k: {"min": min(v), "max": max(v), "all": v}
                           for k, v in ms.items()}}
        emit({"phase": "serving_rest", "part": "speculative", **row})
        check(gap_b <= ID_ATOL and gap_c <= ID_ATOL,
              f"speculative ids against the serve kernel: {row}")
        out[B] = row
    return out


def http_post(base, body, stream=False):
    """``POST /`` → (status, parsed body: the JSON object, or the NDJSON
    lines of a stream)."""
    import http.client

    host, port = base.rsplit(":", 1)
    conn = http.client.HTTPConnection(host[len("http://"):], int(port),
                                      timeout=600)
    try:
        conn.request("POST", "/", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        text = resp.read().decode()
    finally:
        conn.close()
    if stream:
        return resp.status, [json.loads(ln) for ln in text.splitlines()]
    return resp.status, json.loads(text)


def http_get(base, path):
    import urllib.request

    with urllib.request.urlopen(base + path, timeout=600) as r:
        return r.status, r.headers["Content-Type"], r.read().decode()


def reference_caption(gen_or_q, feats):
    """The full-T kernel decode's caption and sequence logprob of the
    first row."""
    from gan_image_captioning_tpu_torch.data.synthetic import synthetic_vocab
    from gan_image_captioning_tpu_torch.eval.decode import masked_logprob_sum
    from gan_image_captioning_tpu_torch.eval.metrics import (ids_to_words,
                                                             strip_caption)

    ids, lps = continuous_reference(gen_or_q, feats)
    return (" ".join(ids_to_words(strip_caption(ids[0].tolist()),
                                  synthetic_vocab()[1])),
            float(masked_logprob_sum(ids, lps)[0]))


def rest_http(gen, gen_b, device, workdir):
    """An HTTP front end over config3's continuous engine, dense and
    ``--quantize int8``: ``POST``, ``/stats``, ``/metrics``, a stream and
    ``{"reload"}`` to the second checkpoint, with the carried (dense) or
    quantized serve kernel's launches equal to the engines' device calls;
    ``POST`` latency beside ``handle_request``; a coalescing reload (the
    full-T serve kernel); one ``--serve-watch`` reload; the time of each
    reload."""
    import shutil
    import threading

    from gan_image_captioning_tpu_torch import serve
    from gan_image_captioning_tpu_torch.config import Config
    from gan_image_captioning_tpu_torch.models.generator import (
        start_token_features)
    from gan_image_captioning_tpu_torch.ops.quantize import quantize_generator

    ckpt_a = str(workdir / "gen_full_width.ckpt")
    ckpt_b = str(workdir / "gen_full_width_b.ckpt")
    start = start_token_features(gen.decoder, 1)
    start_b = start_token_features(gen_b.decoder, 1)
    out = {}
    for variant in ("dense", "int8"):
        quant = [] if variant == "dense" else ["--quantize", "int8"]
        qconfig = Config(vocab_size=V, gen_embed_dim=E, gen_hidden_dim=H,
                         gen_num_layers=NL, max_seq_len=MAX_SEQ_LEN,
                         quantize="int8")
        refs = [reference_caption(g if not quant else quantize_generator(
            g, qconfig), s) for g, s in ((gen, start), (gen_b, start_b))]
        check(refs[0][0] != refs[1][0],
              f"{variant}: the two checkpoints caption alike {refs}")
        service = serve.CaptionService(serve.parse_args(
            ["--checkpoint", ckpt_a, *MODEL_FLAGS, "--serve-continuous",
             *quant]))
        srv = serve.make_http_server(service, 0)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        key = "decode_serve_carry" if variant == "dense" \
            else "decode_qserve_int8"
        try:
            calls0 = service.continuous.stats()["device_calls"]
            for fn in rest_counters().values():
                fn.launches = 0
            code, before = http_post(base, {"n": 8})
            code_s, _, stats_text = http_get(base, "/stats")
            code_m, ctype, prom = http_get(base, "/metrics")
            code_st, stream = http_post(base, {"n": 2, "stream": True},
                                        stream=True)
            old_calls = service.continuous.stats()["device_calls"] - calls0
            code_r, reload = http_post(base, {"reload": ckpt_b})
            code_a, after = http_post(base, {"n": 8})
            new_calls = service.continuous.stats()["device_calls"]
            launches = rest_launches()
            post_ms, direct_ms = [], []
            for _ in range(SR_REPS):
                t0 = time.perf_counter()
                http_post(base, {"n": 1})
                post_ms.append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                service.handle_request({"n": 1})
                direct_ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            srv.shutdown()
            srv.server_close()
            thread.join(timeout=30)
            service.close()
        partial = [ln for ln in stream[:-1] if ln["row"] == 0]
        row = {"variant": variant, "codes": [code, code_s, code_m, code_st,
                                             code_r, code_a],
               "caption_before": before["captions"][0],
               "caption_after": after["captions"][0],
               "reload_ms": reload.get("latency_ms"),
               "stream_lines": len(stream) - 1,
               "launches": launches, "old_engine_calls": old_calls,
               "new_engine_calls": new_calls,
               "post_latency": percentiles(post_ms),
               "handle_request_latency": percentiles(direct_ms),
               "metrics_lines": len(prom.splitlines())}
        emit({"phase": "serving_rest", "part": "http", **row})
        check(row["codes"] == [200] * 6, f"{variant} http: codes {row}")
        check(json.loads(stats_text)["continuous"]["device_calls"] > 0
              and ctype.startswith("text/plain")
              and 'gic_serving_device_calls{engine="continuous"}' in prom,
              f"{variant} http: /stats or /metrics {prom}")
        check(all(c == refs[0][0] for c in before["captions"])
              and all(abs(x - refs[0][1]) <= SEQ_ATOL
                      for x in before["logprobs"]),
              f"{variant} http: captions before the reload {row} {refs}")
        check(all(c == refs[1][0] for c in after["captions"])
              and all(abs(x - refs[1][1]) <= SEQ_ATOL
                      for x in after["logprobs"]),
              f"{variant} http: captions after the reload {row} {refs}")
        check(reload.get("reloaded") == ckpt_b and partial
              and partial[-1]["done"]
              and partial[-1]["partial"] == stream[-1]["captions"][0],
              f"{variant} http: reload or stream {row}")
        check(launches[key] > 0 and launches[key]
              == old_calls + new_calls, f"{variant} http: {key} launches "
              f"{launches} != device calls {old_calls} + {new_calls}")
        other = "decode_qserve_int8" if variant == "dense" \
            else "decode_serve_carry"
        check(launches["decode_serve"] == 0 and launches[other] == 0,
              f"{variant} http: another decode kernel ran {launches}")
        out[variant] = row

    # the coalescing engine's reload, and one --serve-watch reload
    watched = str(workdir / "gen_watched.ckpt")
    shutil.copy(ckpt_a, watched)
    service = serve.CaptionService(serve.parse_args(
        ["--checkpoint", watched, *MODEL_FLAGS]))
    try:
        refs = [reference_caption(g, s) for g, s in ((gen, start),
                                                     (gen_b, start_b))]
        calls0 = service.batcher.stats()["device_calls"]
        for fn in rest_counters().values():
            fn.launches = 0
        before = service.handle_request({"n": 8})["captions"]
        reload = service.handle_request({"reload": ckpt_b})
        after = service.handle_request({"n": 8})["captions"]
        back = service.handle_request({"reload": watched})
        launches = rest_launches()
        calls = service.batcher.stats()["device_calls"] - calls0
        service.start_watch(0.1)
        try:
            t0 = time.perf_counter()
            shutil.copy(ckpt_b, watched + ".tmp")
            Path(watched + ".tmp").replace(watched)
            seen = before[0]
            while seen == before[0] and time.perf_counter() - t0 < 120:
                time.sleep(0.05)
                seen = service.handle_request({"n": 1})["captions"][0]
            watch_s = time.perf_counter() - t0
        finally:
            service.stop_watch()
    finally:
        service.close()
    row = {"coalescing_reload_ms": reload["latency_ms"],
           "coalescing_reload_back_ms": back["latency_ms"],
           "launches": launches, "device_calls": calls,
           "watch_reload_seconds": watch_s, "watch_poll_s": 0.1}
    emit({"phase": "serving_rest", "part": "reload", **row})
    check(all(c == refs[0][0] for c in before)
          and all(c == refs[1][0] for c in after),
          f"coalescing reload: captions {before[0]!r} / {after[0]!r} "
          f"against {refs}")
    check(launches["decode_serve"] == calls > 0,
          f"coalescing reload: serve launches {launches} != {calls}")
    check(seen == refs[1][0], f"--serve-watch did not reload: {seen!r}")
    out["reload"] = row
    return out


def serving_rest_launches(entry, row):
    """A kernels-line entry's launches in phase ``serving_rest``'s counted
    drives: the HTTP front ends over the continuous engine (dense: the
    carried chunk; int8: the quantized serve decode) with their reloads,
    and the coalescing reload (the full-T serve decode).  The transformer
    and speculative parts launch none of the repository's kernels (dense
    cache attention and plain LSTM steps, as in the JAX package)."""
    http = row["http"]
    return {"decode_serve": http["reload"]["launches"]["decode_serve"],
            "decode_serve_carry": http["dense"]["launches"][
                "decode_serve_carry"],
            "decode_qserve_int8": http["int8"]["launches"][
                "decode_qserve_int8"]}.get(entry["name"], 0)


def phase_serving_rest(gen, device, workdir):
    """The serving slice at full width (the chip_smoke docstring's
    ``serving_rest``)."""
    from gan_image_captioning_tpu_torch.models.generator import (
        init_generator_params)
    from gan_image_captioning_tpu_torch.train.checkpoint import (
        save_generator_checkpoint)

    t0 = time.perf_counter()
    gen_b = init_generator_params(torch.Generator().manual_seed(1),
                                  eval_config(), device,
                                  sweep=False).requires_grad_(False)
    save_generator_checkpoint(str(workdir / "gen_full_width_b.ckpt"), gen_b)
    marks = [("start", t0)]
    out = {"transformer": rest_transformer(device, workdir)}
    marks.append(("transformer", time.perf_counter()))
    out["speculative"] = rest_speculative(gen, device, workdir)
    marks.append(("speculative", time.perf_counter()))
    out["http"] = rest_http(gen, gen_b, device, workdir)
    marks.append(("http", time.perf_counter()))
    emit({"phase": "serving_rest", "seconds": marks[-1][1] - t0,
          "seconds_by_part": {name: t - marks[i][1] for i, (name, t)
                              in enumerate(marks[1:])}})
    return out


# ------------------------------------------- bfloat16, the rest of it

BF16_REST_TPU_KERNELS = {
    "decode_sample_noise_bf16": f"{DECODE_TPU}:121",     # mode sample
    "decode_sample_embed_bf16": f"{DECODE_TPU}:121",     # mode sample_embed
    "decode_sample_embed_bwd_bf16": f"{DECODE_TPU}:826",
    "disc_conv_bwd_dxs_bf16": f"{DISC_TPU}:496",         # _mxu_bwd_kernel
}
BF16_REST_SOURCES = {"decode_sample_noise_bf16": "decode_serve.cu",
                     "decode_sample_embed_bf16": "decode_serve.cu",
                     "decode_sample_embed_bwd_bf16": "decode_embed_bwd.cu",
                     "disc_conv_bwd_dxs_bf16": "disc_conv.cu"}
# the counter (``counters()``) behind each entry
BF16_REST_COUNTERS = {"decode_sample_noise_bf16": "decode_sample_noise",
                      "decode_sample_embed_bf16": "decode_sample_embed",
                      "decode_sample_embed_bwd_bf16":
                          "decode_sample_embed_bwd",
                      "disc_conv_bwd_dxs_bf16": "disc_conv_bwd_dxs"}
# the routes of this phase's bfloat16 adversarial steps: their Config
# overrides and the launches of one step by design, every one bfloat16
BF16_REST_ROUTES = {
    "kernel_rescore": ({"decode_impl": "kernel_rescore"},
                       {"decode_sample_noise": 1, "lstm_bptt_reverse": NL,
                        **CONV_PER_ADV}),
    "kernel_embed": ({"decode_impl": "kernel_embed"},
                     {"decode_sample_embed": 1, "decode_sample_embed_bwd": 1,
                      "lstm_bptt_chain": 1, **CONV_PER_ADV}),
    "decoupled": ({"decode_impl": "decoupled"},
                  {"lstm_bptt_reverse": NL, **CONV_PER_ADV}),
    "hybrid": ({"disc_engine": "hybrid"},
               {"decode_sample_resid": 1, "lstm_bptt_chain": 1,
                **PER_ENGINE_STEP["hybrid"]}),
    "mxu_dxs": ({"disc_engine": "mxu_dxs"},
                {"decode_sample_resid": 1, "lstm_bptt_chain": 1,
                 **PER_ENGINE_STEP["mxu_dxs"]}),
}


def rest_counts(cnt, what):
    """``bf16_launches`` of the wrappers that launched."""
    return {k: v for k, v in bf16_launches(cnt, what).items() if v}


def rest_reset():
    """``counters()``, every launch count set to 0."""
    cnt = counters()
    for fn in cnt.values():
        fn.launches = fn.bf16_launches = 0
    return cnt


def rest_embed_work(B):
    """Mode sample_embed in bfloat16: the resid decode's bytes, wd in and
    emb out (2 bytes), and the embedding product."""
    nbytes, flops = bf16_decode_work(B, "resid")
    return (nbytes + 2 * (DISC_E * V + T * B * DISC_E),
            flops + 2 * T * B * V * DISC_E)


def rest_embed_bwd_work(B):
    """bfloat16 h_top, soft, d_emb, w_proj and wd in, d_htop out; float32
    dWp and dbp out; the three products of bfloat16 operands."""
    nbytes = (2 * (2 * T * B * H + T * B * V + T * B * DISC_E + V * H
                   + DISC_E * V) + 4 * (V * H + V))
    return nbytes, 2 * T * B * V * (DISC_E + 2 * H)


def rest_dxs_work(B):
    """The DXS backward on bfloat16 emb, w, pooled and d_pooled (idx
    int32): DXS, dW and db float32 out."""
    q, n_all = B * DISC_R, sum(n for n, _ in BANKS)
    emb, w = B * (T + 4) * DISC_E, n_all * max(f for _, f in BANKS)
    dxs = sum(4 * (T - f + 1) * q * f for _, f in BANKS)
    return (2 * (emb + w + 2 * q * n_all) + 4 * q * n_all + dxs
            + 4 * (w + n_all), sum(4 * q * n * f for n, f in BANKS))


@contextlib.contextmanager
def rest_decode_replay(name, check_fn):
    """Within it, the first call of ``generator.<name>`` is recorded
    (``out["kernel"]``); the second (the plain run's) gets the recorded
    outputs after ``check_fn(recorded, args, kwargs)`` holds them to the
    plain computation from its own arguments, so that both runs share the
    sample (as ``bf16_resid_replay``)."""
    from gan_image_captioning_tpu_torch.models import generator as gen_lstm

    orig, out = getattr(gen_lstm, name), {}

    def call(*args, **kwargs):
        if "kernel" not in out:
            out["kernel"] = orig(*args, **kwargs)
            return out["kernel"]
        out["check"] = check_fn(out["kernel"], args, kwargs)
        return out["kernel"]

    setattr(gen_lstm, name, call)
    try:
        yield out
    finally:
        setattr(gen_lstm, name, orig)


@contextlib.contextmanager
def rest_patched(pairs):
    """``(module, name, value)`` attributes set within it."""
    old = [(m, n, getattr(m, n)) for m, n, _ in pairs]
    for m, n, v in pairs:
        setattr(m, n, v)
    try:
        yield
    finally:
        for m, n, v in old:
            setattr(m, n, v)


def rest_noise_check(rec, args, kwargs):
    """Mode sample's recorded (ids, noise) against the plain decode of the
    same arguments: noise entry by entry within a bfloat16 step of the
    plain Gumbel noise of the fed uniforms, ids ties of the plain decode
    fed them."""
    from gan_image_captioning_tpu_torch.ops.gumbel import gumbel_noise

    ids, noise = rec
    feats, layers, w_proj, b_proj, embed, _ = args[:6]
    u = kwargs.get("uniforms", args[7] if len(args) > 7 else None)
    ref = bf16_forced((layers, w_proj, b_proj, embed), feats, ids, u)
    _, ratio = bf16_steps(noise, gumbel_noise(u.shape, u=u).to(noise.dtype),
                          "route noise")
    return {"id_gap_units": bf16_id_gap(ref["scores"], ids),
            "noise_step_ratio": ratio}


def rest_embed_check(rec, args, kwargs):
    """Mode sample_embed's recorded outputs against the plain computation
    from their own inputs: ids ties, the soft sample within a bfloat16
    step of the softmax of the kernel's top h, emb within a step (plus
    the float32 1e-5 of its largest where a sum cancels) of the product
    of that soft sample."""
    from gan_image_captioning_tpu_torch.kernels import decode_sample as ds
    from gan_image_captioning_tpu_torch.ops.gumbel import gumbel_noise

    ids, emb, soft, hs, _, _ = rec
    # (features, layers, w_proj, b_proj, embed, seq_len, disc_embed, seed,
    # temperature, uniforms), as _SampleEmbed passes them
    feats, layers, w_proj, b_proj, embed, _, wd, _, temp, u = args[:10]
    ref = bf16_forced((layers, w_proj, b_proj, embed), feats, ids, u, temp)
    s = ds._logits(hs[:, -1], w_proj, b_proj) + gumbel_noise(u.shape, u=u)
    _, soft_ratio = bf16_steps(soft, torch.softmax(s * temp, dim=-1)
                               .to(soft.dtype), "route soft sample")
    _, emb_ratio = bf16_steps(emb, (soft.float() @ wd.float().T)
                              .to(emb.dtype), "route emb", floor=1e-5)
    return {"id_gap_units": bf16_id_gap(ref["scores"], ids),
            "soft_step_ratio": soft_ratio, "emb_step_ratio": emb_ratio}


def rest_kernels(gen, device):
    """The four new bfloat16 instantiations against their plain versions at
    config3 width (B = 64) on the same bfloat16 inputs, with their device
    times beside the plain versions', the bounds and (the embed backward)
    its three cuBLAS products in bfloat16."""
    from gan_image_captioning_tpu_torch.kernels import decode_sample as ds
    from gan_image_captioning_tpu_torch.kernels import disc_conv
    from gan_image_captioning_tpu_torch.ops.gumbel import gumbel_noise

    B = B_TRAIN
    weights = bf16_decoder(gen.decoder)
    feats = seeded((B, E), 901, device).to(BF16)
    u = torch.rand((T, B, V), generator=torch.Generator(device=device)
                   .manual_seed(902), device=device)
    temp = float(torch.tensor(TEMP, dtype=BF16))
    wd = seeded((DISC_E, V), 903, device, 0.1).to(BF16)
    rows, times = {}, {}

    ids, noise = ds.decode_sample(feats, *weights, T, mode="sample",
                                  uniforms=u)
    check(noise.dtype == BF16, "bf16 sample: the noise is not bfloat16")
    ref = bf16_forced(weights, feats, ids, u)
    err, ratio = bf16_steps(noise, gumbel_noise(u.shape, u=u).to(BF16),
                            "sample noise")
    rows["decode_sample_noise_bf16"] = {
        "id_gap_units": bf16_id_gap(ref["scores"], ids),
        "ids_equal_sample_resid": bool(torch.equal(
            ids, ds.decode_sample_resid(feats, *weights, T,
                                        uniforms=u)[0])),
        "max_abs_noise_diff": err, "noise_step_ratio": ratio}
    check(rows["decode_sample_noise_bf16"]["id_gap_units"] <= BF16_ID_UNITS
          and rows["decode_sample_noise_bf16"]["ids_equal_sample_resid"],
          f"bf16 sample {rows['decode_sample_noise_bf16']}")
    times["decode_sample_noise_bf16"] = bf16_time(
        lambda: ds.decode_sample_noise(feats, *weights, T, seed=3),
        lambda: ds.decode_sample_noise_plain(feats, *weights, T, u),
        bf16_decode_work(B, "pretrain"), k_calls=10, p_calls=2,
        plain_events=True)

    ids, emb, soft, hs, cs, gates = ds.decode_sample(
        feats, *weights, T, mode="sample_embed", temperature=temp,
        uniforms=u, disc_embed=wd)
    check(all(x.dtype == BF16 for x in (emb, soft, hs, cs, gates)),
          "bf16 sample_embed outputs are not bfloat16")
    ref = bf16_forced(weights, feats, ids, u, temp)
    row = {"id_gap_units": bf16_id_gap(ref["scores"], ids)}
    for name, a in (("hs", hs), ("cs", cs), ("gates", gates)):
        row[f"max_abs_{name}_diff"] = bf16_close(a, ref[name],
                                                 BF16_OUT_UNITS,
                                                 f"sample_embed {name}")
    s_own = ds._logits(hs[:, -1], weights[1], weights[2]) + gumbel_noise(
        u.shape, u=u)
    row["max_abs_soft_diff"], row["soft_step_ratio"] = bf16_steps(
        soft, torch.softmax(s_own * temp, dim=-1).to(BF16),
        "sample_embed soft")
    del s_own
    row["max_abs_emb_diff"], row["emb_step_ratio"] = bf16_steps(
        emb, (soft.float() @ wd.float().T).to(BF16), "sample_embed emb",
        floor=1e-5)
    check(row["id_gap_units"] <= BF16_ID_UNITS, f"bf16 sample_embed {row}")
    rows["decode_sample_embed_bf16"] = row
    times["decode_sample_embed_bf16"] = bf16_time(
        lambda: ds.decode_sample_embed(feats, *weights, T, wd, seed=3,
                                       temperature=temp),
        lambda: ds.decode_sample_embed_plain(feats, *weights, T, u, temp,
                                             wd),
        rest_embed_work(B), k_calls=10, p_calls=2, plain_events=True)

    # the embed backward on the decode's own bfloat16 soft sample and top h
    h_top = hs[:, -1].contiguous()
    d_emb = seeded((T, B, DISC_E), 904, device, 1e-2).to(BF16)
    bargs = (h_top, soft, d_emb, weights[1], wd, temp)
    got = ds.decode_sample_embed_bwd(*bargs)
    again = ds.decode_sample_embed_bwd(*bargs)
    want = ds.decode_sample_embed_bwd_plain(*bargs)
    row = {"two_calls_bit_equal": all(torch.equal(a, b)
                                      for a, b in zip(got, again))}
    for name, a, b in (("dwp", got[0], want[0]), ("dbp", got[1], want[1])):
        row[f"max_abs_{name}_diff"] = float((a - b).abs().max())
        row[f"{name}_rel"] = row[f"max_abs_{name}_diff"] / max(
            float(b.abs().max()), 1e-30)
        check(a.dtype == torch.float32 and row[f"{name}_rel"] <= DWP_RTOL,
              f"bf16 embed backward {name} {row}")
    check(got[2].dtype == BF16, "bf16 embed backward d_htop dtype")
    row["max_abs_d_htop_diff"] = bf16_close(got[2], want[2], BF16_OUT_UNITS,
                                            "embed backward d_htop")
    check(row["two_calls_bit_equal"], "bf16 embed backward not "
          "deterministic")
    rows["decode_sample_embed_bwd_bf16"] = row
    t = bf16_time(lambda: ds.decode_sample_embed_bwd(*bargs),
                  lambda: ds.decode_sample_embed_bwd_plain(*bargs),
                  rest_embed_bwd_work(B))
    # the library yardstick: the plain version's three products, in
    # bfloat16 (cuBLAS, float32 accumulation)
    dl = seeded((T * B, V), 905, device, 1e-4).to(BF16)
    products = embed_bwd_products(h_top, d_emb, weights[1], wd, dl)
    t["library_ms"] = [device_ms(lambda: [f() for f in products.values()],
                                 10) for _ in range(2)]
    t["library"] = "three bfloat16 cuBLAS products (d_soft, dWp, d_htop)"
    t["library_by_product_ms"] = {n: device_ms(f, 10)
                                  for n, f in products.items()}
    # its launches, one by one (torch.profiler), against its plan's count
    plan = ds.embed_bwd_plan(T * B, H, V, DISC_E, ds._sm_count(device), True)
    t["split"] = kernel_split(lambda: ds.decode_sample_embed_bwd(*bargs))
    t["plan_launches"] = plan["launches"]
    # the profiler drops events at a window's edges and in a long
    # process: the kernels it saw, by name, are the plan's count
    seen = t["split"]["by_kernel"]
    check(not seen or len(seen) == plan["launches"],
          f"bf16 embed backward: {t['split']} against {plan['launches']} "
          "launches a call")
    times["decode_sample_embed_bwd_bf16"] = t
    del got, again, want, products, dl

    # the DXS backward from the raw bfloat16 gradient
    emb_pad, w_all, b_all, banks = (x.to(BF16) if torch.is_tensor(x) else x
                                    for x in conv_inputs(device))
    pooled, idx = disc_conv.conv_bank_forward(emb_pad, w_all, b_all, banks,
                                              DISC_R, 1)
    d_pooled = seeded(tuple(pooled.shape), 906, device).to(BF16)
    got = disc_conv.conv_bank_dxs_raw(emb_pad, w_all, banks, DISC_R, 1,
                                      pooled, idx, d_pooled)
    want = disc_conv.conv_dxs_raw_plain(emb_pad, w_all, banks, DISC_R, 1,
                                        pooled, idx, d_pooled)
    row = {}
    for name, a, b, rtol in (
            ("dxs", torch.cat([x.flatten() for x in got[0]]),
             torch.cat([x.flatten() for x in want[0]]), DXS_ATOL),
            ("dw", got[1], want[1], DW_RTOL), ("db", got[2], want[2],
                                               DB_ATOL)):
        row[f"max_abs_{name}_diff"] = float((a - b).abs().max())
        check(a.dtype == torch.float32 and row[f"max_abs_{name}_diff"]
              <= rtol * max(1.0, float(b.abs().max())),
              f"bf16 DXS backward {name} {row}")
    rows["disc_conv_bwd_dxs_bf16"] = row
    times["disc_conv_bwd_dxs_bf16"] = bf16_time(
        lambda: disc_conv.conv_bank_dxs_raw(emb_pad, w_all, banks, DISC_R, 1,
                                            pooled, idx, d_pooled),
        lambda: disc_conv.conv_dxs_raw_plain(emb_pad, w_all, banks, DISC_R,
                                             1, pooled, idx, d_pooled),
        rest_dxs_work(B), p_calls=5, plain_events=True)
    for name in BF16_REST_TPU_KERNELS:
        emit({"phase": "bf16_rest", "kernel": name, **rows[name],
              **{k: v for k, v in times[name].items()
                 if k in ("kernel_ms", "plain_ms", "bound_ms", "bound_by",
                          "plain_timer", "library_ms", "library",
                          "library_by_product_ms", "split",
                          "plan_launches")}})
    return rows, times


def rest_plain_run(route, config, state, batch, noise, rec):
    """``adv_grads`` of ``route`` with every kernel of the step swapped for
    its plain version: the decode's recorded outputs replayed after the
    plain computation holds them, the BPTT recurrences and the embed
    backward plain, the conv banks the plain engine at the kernel run's
    argmax rows (the hybrid engine: its own forward, the plain backward)."""
    from gan_image_captioning_tpu_torch.kernels import decode_sample as ds
    from gan_image_captioning_tpu_torch.kernels import disc_conv
    from gan_image_captioning_tpu_torch.kernels.lstm_bptt import (
        lstm_bptt_chain_plain, lstm_bptt_reverse_plain)
    from gan_image_captioning_tpu_torch.models import generator as gen_lstm
    from gan_image_captioning_tpu_torch.models import lstm as lstm_lib
    from gan_image_captioning_tpu_torch.train.steps import adv_grads

    pairs = [(lstm_lib, "lstm_bptt_reverse", lstm_bptt_reverse_plain),
             (gen_lstm, "lstm_bptt_chain", lstm_bptt_chain_plain),
             (gen_lstm, "decode_sample_embed_bwd",
              ds.decode_sample_embed_bwd_plain)]
    cfg = config.replace(disc_engine="plain")
    if route == "hybrid":
        cfg = config
        pairs.append((disc_conv, "conv_rows_backward",
                      disc_conv.conv_rows_backward_plain))
    if route in ("hybrid", "mxu_dxs"):    # the plain decode route, shared
        cfg = cfg.replace(decode_impl="plain")
    with rest_patched(pairs), disc_conv.argmax_replay(rec["pool"]) as report:
        if route in ("hybrid", "mxu_dxs"):
            with bf16_resid_replay(rec["resid"]) as gaps:
                out = adv_grads(cfg, state, batch, TEMP, noise)
            checks = {"id_gap_units": max(g for g, _ in gaps),
                      "soft_step_ratio": max(r for _, r in gaps)}
        else:
            out = adv_grads(cfg, state, batch, TEMP, noise)
            checks = rec["decode"].get("check", {})
    return out, checks, report


def rest_routes(gen, device):
    """One bfloat16 adversarial step (``bf16_mu``) of each route of
    ``BF16_REST_ROUTES`` with its launches, every one bfloat16, and its
    losses and gradients through the kernels against the same step with
    its kernels swapped for their plain versions (``rest_plain_run``) on
    the same state and fed noise, as ``bf16_train`` holds the kernel
    route: losses within 4 units, each gradient tensor within 8 units of
    its own largest entry, the conv ties within 4 units; then a step under
    ``bf16_grads`` against the same step without it."""
    from gan_image_captioning_tpu_torch.kernels import disc_conv
    from gan_image_captioning_tpu_torch.models import api
    from gan_image_captioning_tpu_torch.train.state import create_train_state
    from gan_image_captioning_tpu_torch.train.steps import (adv_grads,
                                                            make_adv_step)

    base = bf16_config()
    disc = api.init_discriminator(torch.Generator().manual_seed(1), base,
                                  device, sweep=False)
    g = copy.deepcopy(gen).requires_grad_(True)
    state = create_train_state(base, 0, device, gen=g, disc=disc)
    batch = train_batch(device)
    noise = fed_noise(base, device)
    out, total = {}, {}
    for route, (over, per) in BF16_REST_ROUTES.items():
        config = base.replace(**over)
        cnt = rest_reset()
        snap = copy.deepcopy((state.gen.state_dict(),
                              state.disc.state_dict()))
        _, m = make_adv_step(config)(state, batch, TEMP, noise)
        torch.cuda.synchronize()
        launches = rest_counts(cnt, f"bf16 {route} step")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        check(launches == per, f"bf16 {route} launches {launches} != {per}")
        check(all(math.isfinite(float(v)) for v in m.values()),
              f"bf16 {route} metrics {m}")
        state.gen.load_state_dict(snap[0])
        state.disc.load_state_dict(snap[1])
        # the kernel run, recorded, then the plain run replaying it
        rec = {}
        name = {"kernel_rescore": ("decode_sample_noise", rest_noise_check),
                "kernel_embed": ("decode_sample_embed",
                                 rest_embed_check)}.get(route)
        ctx = (rest_decode_replay(*name) if name
               else contextlib.nullcontext({}))
        with ctx as dec_rec:
            with disc_conv.argmax_record() as pool, \
                    bf16_resid_record() as resid:
                kern = adv_grads(config, state, batch, TEMP, noise)
            rec = {"pool": pool, "resid": resid, "decode": dec_rec}
            plain, checks, report = rest_plain_run(route, config, state,
                                                   batch, noise, rec)
        tie_scale = max([float(p.abs().max()) for _, p in pool["pool"]]
                        + [float(x.abs().max()) for x in pool["relu"]]
                        + [1e-30])
        cmp = {"metrics": {k: float(v) for k, v in m.items()},
               "launches": launches,
               "g_loss": [float(kern[0]), float(plain[0])],
               "d_loss": [float(kern[1]), float(plain[1])],
               "worst_grad_units": sorted(
                   ((k, v / BF16_UNIT) for k, v in
                    bf16_grad_errs(kern, plain).items()),
                   key=lambda kv: -kv[1])[:4],
               "argmax_gap_units": max([gp for gp, _ in report] + [0.0])
               / (BF16_UNIT * tie_scale), **checks}
        emit({"phase": "bf16_rest", "route": route, **cmp})
        for a, b in (cmp["g_loss"], cmp["d_loss"]):
            check(abs(a - b) <= BF16_LOSS_UNITS * BF16_UNIT * abs(b),
                  f"bf16 {route} losses {cmp}")
        check(cmp["worst_grad_units"][0][1] <= BF16_GRAD_UNITS,
              f"bf16 {route} gradients {cmp}")
        check(cmp["argmax_gap_units"] <= BF16_ID_UNITS
              and cmp.get("id_gap_units", 0.0) <= BF16_ID_UNITS,
              f"bf16 {route} ties {cmp}")
        out[route] = cmp
        del kern, plain

    # bf16_grads: bfloat16 leaves, the same values as the compute cast's
    config = base.replace(bf16_grads=True)
    cnt = rest_reset()
    lv = adv_grads(config, state, batch, TEMP, noise)
    torch.cuda.synchronize()
    launches = rest_counts(cnt, "bf16_grads step")
    ref = adv_grads(base, state, batch, TEMP, noise)
    errs = bf16_grad_errs(lv, ref)
    row = {"g_loss": [float(lv[0]), float(ref[0])],
           "d_loss": [float(lv[1]), float(ref[1])],
           "launches": launches,
           "grads_float32": all(g.dtype == torch.float32 for side in lv[2:4]
                                for g in side.values()),
           "max_grad_units": max(errs.values()) / BF16_UNIT}
    emit({"phase": "bf16_rest", "bf16_grads": row})
    check(row["grads_float32"], "bf16_grads: a gradient is not float32")
    check(row["g_loss"][0] == row["g_loss"][1]
          and row["d_loss"][0] == row["d_loss"][1],
          f"bf16_grads changed the forward {row}")
    check(row["max_grad_units"] <= BF16_GRAD_UNITS, f"bf16_grads {row}")
    out["bf16_grads"] = row
    out["launches"] = total
    return out


def rest_int8_service(gen, workdir):
    """The quantized service at ``--dtype float32`` with ``int8_dtype=
    "bfloat16"`` (the JAX ``GIC_INT8_DTYPE=bfloat16``): ``{"n": 8}``
    twice; captions the plain quantized decode in bfloat16 (or ties), the
    quantized kernel's launches all bfloat16 and equal to the engine's
    ``device_calls``."""
    from gan_image_captioning_tpu_torch import serve
    from gan_image_captioning_tpu_torch.kernels import decode_sample as ds
    from gan_image_captioning_tpu_torch.models.generator import (
        start_token_features)
    from gan_image_captioning_tpu_torch.ops.quantize import (
        quantize_lstm_decoder)
    from gan_image_captioning_tpu_torch.train.checkpoint import (
        save_generator_checkpoint)

    path = workdir / "gen_full_width_int8_dtype.ckpt"
    save_generator_checkpoint(str(path), gen)
    # the counts from before the service's warm-up, which its
    # device_calls count too
    rest_reset()
    ds.decode_sample_q_serve.launches = 0
    ds.decode_sample_q_serve.bf16_launches = 0
    service = serve.CaptionService(serve.parse_args(
        ["--checkpoint", str(path), *MODEL_FLAGS, "--quantize", "int8"]),
        int8_dtype="bfloat16")
    try:
        resps = [service.handle_request({"n": 8}) for _ in range(2)]
        stats = service.handle_request({"stats": True})["coalescing"]
        torch.cuda.synchronize()
        launches = {"q_serve": ds.decode_sample_q_serve.bf16_launches,
                    "q_serve_float32": ds.decode_sample_q_serve.launches
                    - ds.decode_sample_q_serve.bf16_launches,
                    "dense_decode": counters()["decode_serve"].launches}
    finally:
        service.close()
    feats = start_token_features(gen.decoder, 1).to(BF16)
    qdec = quantize_lstm_decoder(gen.decoder, 8)
    ids_p, _ = ds.decode_sample_q_serve_plain(feats, qdec, T, bits=8)
    want = [service._caption(ids_p[0].tolist())] * 8
    same = all(r["captions"] == want for r in resps)
    gap = 0.0
    if not same:
        ids_k, _ = ds.decode_sample_q_serve(feats, qdec, T, bits=8)
        ref = bf16_forced(ds.dequantized_decoder(qdec, 8, BF16), feats,
                          ids_k)
        gap = bf16_id_gap(ref["scores"], ids_k)
    row = {"config_dtype": service.config.dtype,
           "int8_dtype": service.config.int8_dtype,
           "captions_equal_plain": same, "id_gap_units": gap,
           "launches": launches, "device_calls": stats["device_calls"],
           "latency_ms": [r["latency_ms"] for r in resps]}
    emit({"phase": "bf16_rest", "int8_dtype_service": row})
    check(same or gap <= BF16_ID_UNITS, f"int8_dtype service {row}")
    check(launches["q_serve"] > 0 and launches["q_serve_float32"] == 0
          and launches["q_serve"] == stats["device_calls"]
          and launches["dense_decode"] == 0, f"int8_dtype launches {row}")
    return row


def phase_bf16_rest(gen, device, workdir):
    """The rest of ``--dtype bfloat16`` (the chip_smoke docstring's
    ``bf16_rest``)."""
    t0 = time.perf_counter()
    rows, times = rest_kernels(gen, device)
    routes = rest_routes(gen, device)
    service = rest_int8_service(gen, workdir)
    for name, key in BF16_REST_COUNTERS.items():
        check(routes["launches"].get(key, 0) > 0,
              f"{name}: no bfloat16 launch in the route steps")
    seconds = time.perf_counter() - t0
    emit({"phase": "bf16_rest", "seconds": seconds})
    return {"rows": rows, "times": times, "routes": routes,
            "service": service, "seconds": seconds}


def bf16_rest_entries(smi, row):
    """The four new bfloat16 instantiations' entries of the ``kernels``
    line, their launches those of this phase's route steps (the counts set
    to 0 before each step and read after)."""
    out = []
    for name, tpu in BF16_REST_TPU_KERNELS.items():
        t = row["times"][name]
        errs = [v for k, v in row["rows"][name].items()
                if k.startswith("max_abs")]
        out.append({
            "name": name, "route": "cuda",
            "source": "gan_image_captioning_tpu_torch/kernels/csrc/"
                      + BF16_REST_SOURCES[name],
            "replaces": tpu,
            "launches": row["routes"]["launches"][BF16_REST_COUNTERS[name]],
            "max_abs_err": max(errs), "ms": min(t["kernel_ms"]),
            "plain_ms": min(t["plain_ms"]), "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": min(t["library_ms"]) if "library_ms" in t
            else None, "dtype": "bfloat16", "B": B_TRAIN, "card": smi})
    return out


# ------------------------------------------- the data and model extras

EXTRA_PAD = 4                       # --random-crop-pad
BILSTM_PER_ADV = {"decode_sample_resid": 1, "lstm_bptt_chain": 1,
                  # 3 passes x 2 directions x the discriminator's layers
                  "lstm_bptt_reverse": 3 * 2 * 4}


def extras_augment(device):
    """config3 + ``--conditional-gan 1 --random-flip 1 --random-crop-pad
    4`` on 256 x 256 ``images_u8``: one MLE and one adversarial step with
    their launches (``image_norm`` once a step, after the augmentation of
    the uint8 batch), the fed coins and offsets taken (the step's batch
    is ``augment_images`` of them, bit for bit), the metrics finite."""
    from gan_image_captioning_tpu_torch.ops.augment import augment_images
    from gan_image_captioning_tpu_torch.train import steps

    config, state, batch = cond_setup(device, random_flip=1,
                                      random_crop_pad=EXTRA_PAD)
    gen = torch.Generator(device=device).manual_seed(71)
    aug = {"coin": torch.rand(B_TRAIN, generator=gen, device=device) < 0.5,
           "oy": torch.randint(0, 2 * EXTRA_PAD + 1, (B_TRAIN,),
                               generator=gen, device=device),
           "ox": torch.randint(0, 2 * EXTRA_PAD + 1, (B_TRAIN,),
                               generator=gen, device=device)}
    seen = []
    orig = steps.augment_batch

    def spy(*args, **kwargs):
        out = orig(*args, **kwargs)
        seen.append(out.get("images_u8"))
        return out

    from gan_image_captioning_tpu_torch.kernels import image_norm

    steps.augment_batch = spy
    image_norm.normalize_images.launches = 0
    try:
        cnt = rest_reset()
        state, m1 = steps.make_mle_step(config)(state, batch,
                                                noise={"augment": aug})
        noise = {**fed_noise(config, device), "augment": aug}
        state, m2 = steps.make_adv_step(config)(state, batch, TEMP, noise)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in cnt.items() if fn.launches}
    finally:
        steps.augment_batch = orig
    want = augment_images(batch["images_u8"], True, EXTRA_PAD, **aug)
    row = {"metrics": {**{k: float(v) for k, v in m1.items()},
                       **{k: float(v) for k, v in m2.items()}},
           "launches": launches,
           "image_norm_launches": image_norm.normalize_images.launches,
           "augmented_as_fed": all(torch.equal(s, want) for s in seen),
           "augment_calls": len(seen),
           "images_moved": not torch.equal(want, batch["images_u8"])}
    emit({"phase": "extras", "augment": row})
    check(all(math.isfinite(v) for v in row["metrics"].values()),
          f"extras augment metrics {row}")
    check(row["augmented_as_fed"] and row["augment_calls"] == 2
          and row["images_moved"] and row["image_norm_launches"] == 2,
          f"extras augment {row}")
    return row


def extras_bilstm(gen, device):
    """One adversarial step with ``--disc-arch bilstm`` (embed 64, hidden
    128, 4 layers a direction; float32) with its launches, the reverse
    BPTT kernel once a layer a direction in each of the three
    discriminator passes' backward; its losses and gradients through the
    kernels against the plain route (the BiLSTM's plain recurrences, the
    kernel route's sample replayed) within 1e-4 and ``routes_agree``."""
    from gan_image_captioning_tpu_torch.models import api
    from gan_image_captioning_tpu_torch.train.state import create_train_state
    from gan_image_captioning_tpu_torch.train.steps import (adv_grads,
                                                            make_adv_step)

    config = bf16_config(disc_arch="bilstm").replace(dtype="float32",
                                                     bf16_mu=False)
    disc = api.init_discriminator(torch.Generator().manual_seed(1), config,
                                  device, sweep=False)
    state = create_train_state(config, 0, device,
                               gen=copy.deepcopy(gen).requires_grad_(True),
                               disc=disc)
    batch = train_batch(device)
    noise = fed_noise(config, device)
    noise["keep"] = [torch.rand(api.disc_keep_shape(config, B_TRAIN),
                                device=device) < 0.8 for _ in range(3)]
    cnt = rest_reset()
    t0 = time.perf_counter()
    state, m = make_adv_step(config)(state, batch, TEMP, noise)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in cnt.items() if fn.launches}
    with bf16_resid_record() as outs:
        kern = adv_grads(config, state, batch, TEMP, noise)
    with bf16_resid_replay(outs):
        plain = adv_grads(config.replace(decode_impl="plain"), state, batch,
                          TEMP, noise)
    cmp = compare_grads(kern, plain)
    row = {"metrics": {k: float(v) for k, v in m.items()},
           "launches": launches, "step_seconds": step_s,
           "g_loss": cmp["g_loss"], "d_loss": cmp["d_loss"],
           "grad_side_rel_err": cmp["grad_side_rel_err"]}
    emit({"phase": "extras", "bilstm": row})
    check(launches == BILSTM_PER_ADV,
          f"bilstm launches {launches} != {BILSTM_PER_ADV}")
    check(all(math.isfinite(v) for v in row["metrics"].values()),
          f"bilstm metrics {row}")
    for a, b in (cmp["g_loss"], cmp["d_loss"]):
        check(abs(a - b) <= LOSS_RTOL * max(abs(b), 1e-30),
              f"bilstm losses {row}")
    check(routes_agree(cmp), f"bilstm gradients {row}")
    return row


def extras_cache(device, workdir):
    """``main.py --cache-features 1`` on 128 synthetic conditional items at
    config3 width (256 x 256 images), an epoch of each phase: the features
    computed once per image, the loaders carrying them, losses finite, a
    checkpoint written; and the cost it saves: an MLE step on the images
    (the encoder's pass included) against the same step on the cached
    features, and the precompute's time per image."""
    from gan_image_captioning_tpu_torch import main as tmain
    from gan_image_captioning_tpu_torch.data.feature_cache import (
        precompute_backbone_features)
    from gan_image_captioning_tpu_torch.data.synthetic import (
        SyntheticCaptions)
    from gan_image_captioning_tpu_torch.train.steps import batch_to, mle_grads
    from gan_image_captioning_tpu_torch.data.loader import make_batch

    save = workdir / "cache_features"
    out, result, seconds, _ = run_entry(tmain.main, [
        *CONFIG3_FLAGS, "--conditional-gan", "1", "--cache-features", "1",
        "--image-size", str(IMG_S), "--synthetic-items", "128",
        "--pretrain-epochs", "1", "--adv-epochs", "1",
        "--save-dir", str(save)])
    inst = result
    from gan_image_captioning_tpu_torch.data.feature_cache import (
        CachedFeatureDataset)
    batch0 = next(iter(inst.pre_train_loader))
    row = {"seconds": seconds,
           "cached": isinstance(inst.train_dataset, CachedFeatureDataset),
           "features_shape": list(inst.train_dataset.features.shape),
           "loader_keys": sorted(batch0),
           "checkpoint": (Path(inst.config.model_dir)
                          / "adv_model.ckpt").exists()}
    # the step on the images against the step on their cached features
    config, state, batch = cond_setup(device)
    ds = SyntheticCaptions("train", num_items=B_TRAIN, image_size=IMG_S,
                           conditional=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = precompute_backbone_features(ds, state.gen.encoder, 32)
    torch.cuda.synchronize()
    row["precompute_ms_per_image"] = (time.perf_counter() - t0) * 1e3 / len(
        ds)
    caps = [ds.sample(i)[0] for i in range(B_TRAIN)]
    cached = batch_to(make_batch(caps, list(feats), T), device)
    imaged = batch_to(make_batch(caps, [ds.sample(i)[1]
                                        for i in range(B_TRAIN)], T), device)
    step = {"images": lambda: mle_grads(config, state, imaged),
            "cached": lambda: mle_grads(config, state, cached)}
    ms = {k: [] for k in step}
    for k in ("images", "cached", "cached", "images"):
        ms[k].append(step_ms(step[k], 3))
    row["mle_step_ms"] = ms
    emit({"phase": "extras", "cache_features": row})
    check(row["cached"] and row["features_shape"] == [128, 512]
          and "backbone_feats" in row["loader_keys"]
          and "images" not in row["loader_keys"] and row["checkpoint"],
          f"cache_features {row}")
    check("nan" not in out.lower(), "cache_features: a NaN was logged")
    return row


def extras_natural(device):
    """``--encoder-init natural`` on config3's conditional generator: the
    eval-mode features of 8 distinct seeded images part (their spread
    across images, mean over features, above 1e-2 and 1000 times the
    swept encoder's)."""
    from gan_image_captioning_tpu_torch.kernels.image_norm import (
        normalize_images)
    from gan_image_captioning_tpu_torch.models import encoder as enc_lib
    from gan_image_captioning_tpu_torch.models.generator import (
        init_generator_params)

    u8 = torch.stack([seeded_u8((3, IMG_S, IMG_S), 300 + i, device)
                      for i in range(8)])
    images = normalize_images(u8)
    spread = {}
    for init in ("sweep", "natural"):
        config = bf16_config(conditional_gan=1, image_size=IMG_S,
                             encoder_init=init).replace(dtype="float32")
        g = init_generator_params(torch.Generator().manual_seed(0), config,
                                  device)
        with torch.no_grad():
            feats = enc_lib.encode(g.encoder, images, config, train=False)
        spread[init] = float(feats.std(dim=0).mean())
    row = {"feature_spread": spread}
    emit({"phase": "extras", "encoder_init": row})
    check(spread["natural"] > 1e-2
          and spread["natural"] > 1e3 * spread["sweep"],
          f"encoder_init natural {row}")
    return row


def extras_remat(device):
    """config4's MLE step (float32) and config5's (bfloat16) under
    ``tf_remat`` against the same step without it, from the same state:
    the loss and every gradient (the recompute runs the same
    deterministic kernels on the same inputs: expected bit-equal, held to
    1e-6 of each tensor's largest entry, a bfloat16 unit for config5),
    the recompute's extra launches, and each pass's peak memory and device
    time (torch.profiler)."""
    from gan_image_captioning_tpu_torch.train.state import create_train_state

    out = {}
    for name in ("config4", "config5"):
        if name == "config4":
            config, state, batch = tf_setup(device)
        else:
            config = c5_config()
            state = create_train_state(config, 0, device, sweep=False)
            batch = c5_batch(device, config)
        res = {}
        for remat in (False, True):
            cfg = config.replace(tf_remat=remat)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
            loss, _, grads, _, _ = tf_grads("mle", cfg, state, batch, None)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(device) - base
            prof = c5_profile(lambda: tf_grads("mle", cfg, state, batch,
                                               None), 1)
            res[remat] = {"loss": float(loss), "grads": grads,
                          "peak_gib": peak / 2 ** 30,
                          "device_ms": prof["device_ms_per_step"],
                          "launches": prof["launches_per_step"]}
        a, b = res[False], res[True]
        row = {"loss": [a["loss"], b["loss"]],
               "grads_bit_equal": all(torch.equal(a["grads"][k],
                                                  b["grads"][k])
                                      for k in a["grads"]),
               "max_grad_rel_diff": max(
                   float((a["grads"][k] - b["grads"][k]).abs().max())
                   / max(float(a["grads"][k].abs().max()), 1e-30)
                   for k in a["grads"]),
               "peak_gib": [a["peak_gib"], b["peak_gib"]],
               "device_ms": [a["device_ms"], b["device_ms"]],
               "launches": [a["launches"], b["launches"]],
               "dtype": config.dtype}
        emit({"phase": "extras", "tf_remat": name, **row})
        tol = BF16_UNIT if config.dtype == "bfloat16" else 1e-6
        check(abs(row["loss"][0] - row["loss"][1])
              <= tol * abs(row["loss"][0])
              and row["max_grad_rel_diff"] <= tol,
              f"{name} tf_remat changed the step {row}")
        check(row["launches"][1] > row["launches"][0],
              f"{name} tf_remat recomputed nothing {row}")
        out[name] = row
        del state, res, a, b
        torch.cuda.empty_cache()
    return out


def phase_extras(gen, device, workdir):
    """The data and model extras (the chip_smoke docstring's
    ``extras``)."""
    t0 = time.perf_counter()
    row = {"augment": extras_augment(device),
           "bilstm": extras_bilstm(gen, device),
           "cache_features": extras_cache(device, workdir),
           "encoder_init": extras_natural(device),
           "tf_remat": extras_remat(device)}
    row["seconds"] = time.perf_counter() - t0
    emit({"phase": "extras", "seconds": row["seconds"]})
    return row


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", default="",
                        help="comma-separated phases to run (default: all; "
                             "the kernels line and the last line need all)")
    only = set(filter(None, parser.parse_args(argv).only.split(",")))
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on a CUDA card", file=sys.stderr)
        return 1
    # the port must be importable before anything is printed: a copy of
    # this script without the repository fails here
    import gan_image_captioning_tpu_torch  # noqa: F401

    def run(phase):
        return not only or phase in only

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    workdir = ROOT / "build" / "chip_smoke"
    workdir.mkdir(parents=True, exist_ok=True)
    smi = phase_device()
    phase_build()
    if run("persistent"):
        phase_persistent(device)
    gen = full_width_generator(device)
    if run("train_kernels"):
        train_kernel_rows = phase_train_kernels(gen.decoder, device)
    if run("train_timing"):
        train_times = phase_train_kernel_timing(gen.decoder, device)
    if run("train"):
        train_row, setup = phase_train(device)
        if run("train_timing"):
            phase_train_step_timing(device, setup)
        if run("train_profile"):
            phase_train_profile(device, setup)
    if run("kernel"):
        kernel_rows = phase_kernel(gen.decoder, device)
    if any(run(p) for p in ("service", "timing", "continuous_service",
                            "continuous_timing", "continuous_profile",
                            "serving_rest")):
        # the services read this checkpoint
        from gan_image_captioning_tpu_torch.train.checkpoint import (
            save_generator_checkpoint)
        save_generator_checkpoint(str(workdir / "gen_full_width.ckpt"), gen)
    if run("service"):
        service = phase_service(gen, workdir)
    if run("timing"):
        times = phase_timing(gen.decoder, device, workdir)
    if run("profile"):
        phase_profile(gen.decoder, device)
    if run("carry_kernel"):
        carry_rows = phase_carry_kernel(gen.decoder, device)
    if run("qserve_kernel"):
        q_rows = phase_qserve_kernel(gen.decoder, device)
    if run("continuous_service"):
        cont_service = phase_continuous_service(gen, workdir)
    if run("continuous_timing"):
        cont_times = phase_continuous_timing(gen.decoder, device, workdir)
    if run("continuous_profile"):
        phase_continuous_profile(gen.decoder, device, workdir)
    if run("image_norm_kernel"):
        norm = phase_image_norm_kernel(device)
    if run("cond_service"):
        phase_cond_service(device)
    if run("cond_train"):
        cond_train = phase_cond_train(device)
    if run("loop"):
        phase_loop(device, workdir)
    if run("tf_kernels"):
        tfk = phase_tf_kernels(device)
    if run("gumbel_ids"):
        phase_gumbel_ids(device)
    if run("tf_train"):
        tf_train = phase_tf_train(device)
    if run("tf_service"):
        phase_tf_service(device)
    if run("tf_loop"):
        phase_tf_loop(device, workdir)
    if run("disc_engines"):
        engines = phase_disc_engines(device)
    if run("disc_profile"):
        phase_disc_profile(device)
    if run("bptt_reverse"):
        reverse = phase_bptt_reverse(device)
    if run("decode_modes"):
        modes = phase_decode_modes(device)
    if run("decode_impls"):
        impls = phase_decode_impls(device)
    if run("wrappers"):
        phase_wrappers(device)
    if run("eval_decode"):
        eval_row = phase_eval_decode(gen, device, workdir)
    if run("resume"):
        phase_resume(workdir)
    if run("scst"):
        scst_row = phase_scst(device, workdir)
    if run("step_options"):
        so_row = phase_step_options(device, workdir, smi)
    if run("bf16"):
        bf16_row = phase_bf16(gen, device, workdir)
    if run("tf_bf16"):
        tf_bf16_row = phase_tf_bf16(device, workdir)
    if run("config5"):
        config5_row = phase_config5(device, workdir)
    if run("serving_rest"):
        rest_row = phase_serving_rest(gen, device, workdir)
    if run("bf16_rest"):
        bf16_rest_row = phase_bf16_rest(gen, device, workdir)
    if run("extras"):
        phase_extras(gen, device, workdir)
    if only:
        return 0

    t8 = times[8]
    kernels = ([{
        "name": "decode_serve", "route": "cuda",
        "source": "gan_image_captioning_tpu_torch/kernels/csrc/decode_serve.cu",
        "replaces": TPU_KERNEL,
        "launches": service["kernel_launches"],
        "max_abs_err": max(r["max_abs_lp_diff"] for r in kernel_rows),
        "ms": min(t8["kernel_ms"]), "plain_ms": min(t8["plain_ms"]),
        "bound_ms": t8["bound_ms"], "bound_by": t8["bound_by"],
        "library_ms": None,
        "B": 8, "ms_b64": min(times[64]["kernel_ms"]),
        "plain_ms_b64": min(times[64]["plain_ms"]),
        "bound_ms_b64": times[64]["bound_ms"],
        "ids_equal": {str(r["B"]): r["ids_equal"] for r in kernel_rows},
        "max_abs_lp_diff": {str(r["B"]): r["max_abs_lp_diff"]
                            for r in kernel_rows},
        "train_launches": train_row["launches"]["decode_serve"],
        "card": smi}] + kernel_entries(smi, train_kernel_rows, train_times,
                                       train_row["launches"])
        + continuous_entries(smi, carry_rows, q_rows, cont_times,
                             cont_service)
        + [image_norm_entry(smi, norm, cond_train)]
        + tf_entries(smi, tfk, tf_train)
        + engine_entries(smi, engines, reverse)
        + mode_entries(smi, modes, impls)
        + bf16_entries(smi, bf16_row)
        + tf_bf16_entries(smi, tf_bf16_row)
        + config5_entries(smi, config5_row)
        + bf16_rest_entries(smi, bf16_rest_row))
    # the evaluation path's launches (phase eval_decode, counts set to 0
    # before each evaluate.py run): greedy, int8 greedy, beam 4 with the
    # discriminator score; NLL_gen through the pretrain mode in each
    runs = eval_row["evaluate"]
    for entry in kernels:
        if entry["name"] in eval_counters():
            entry["eval_decode_launches"] = sum(
                r["launches"][entry["name"]] for r in runs.values())
    for entry in kernels:
        entry["scst_launches"] = scst_launches(entry, scst_row)
        entry["step_options_launches"] = step_options_launches(entry, so_row)
        entry["serving_rest_launches"] = serving_rest_launches(entry,
                                                               rest_row)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
