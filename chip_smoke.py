#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one H100:

    python3 chip_smoke.py

``python3 chip_smoke.py --pairs-of CHECKOUT WHAT`` times only a part of
another checkout's package with this script's code, for a before/after
pair on one card: ``f32-backward`` its float32 dQ and dK/dV kernels (as
phase 5 times this one's), ``rtc`` its ``relu``, ``scale_add`` and
``split`` user kernels against torch's calls (as phase 7 pairs this
one's), ``fit-loop`` phase 12c's AlexNet runs through its ``fit``.

Phases, each fatal on failure (exit code 1, no result line):

1. card: ``nvidia-smi`` name and power limit, ``torch`` device name;
2. build: every CUDA source under ``mxnet_tpu_torch/csrc`` and the five
   user-kernel sources of ``mxnet_tpu_torch/rtc_examples.py`` (through
   ``rtc.CudaModule``) with ``nvcc``, all started together, with the
   compiler's register and shared-memory report. The three kernels on
   ``wgmma`` + TMA (the bf16 forward, dQ and dK/dV at head dims 64 and
   128) must spill nothing, and their SASS (``cuobjdump -sass``) must
   hold HGMMA and UTMALDG instructions; the three float32 kernels
   (forward, dQ and dK/dV, 3xTF32 on ``mma.sync``) must spill nothing
   and hold HMMA instructions, at every head dim; without
   ``cuobjdump`` the log says so;
3. kernels: the float32 forward (K1 f32, the serving path's) against
   its plain PyTorch version on the card at the shapes that path gives
   it, then, with the float32 dQ and dK/dV kernels (K2 f32, K3 f32),
   over a sweep of head dims 16-256, BH 1 and 16, S in {1, 65, 200,
   1000, 1024}, S != Sk both ways, causal and not, each case fatal;
   then timed at every prompt bucket of the burst (BH 16, D 128, causal)
   as the median of 5 windows of 20 launches with their spread and the
   host's µs per call, and by the profiler's kernel time, beside
   ``scaled_dot_product_attention`` timed alike, its plain version and
   its bound;
4. slice: ``GenerativeServer`` at the full width of the zoo transformer
   LM as ``bench.py`` trains it (12 layers, d_model 2048, 16 heads,
   d_ff 8192, vocab 32000, max_seq 1024), weights drawn from a seed,
   8 slots; 8 greedy prompts of 17 to 900 tokens submitted at once, 32
   new tokens each. The kernel launch counters are zeroed just before
   this cold burst and read just after; every kernel must have run. The
   same burst then runs warm, and once more under ``torch.profiler`` for
   the device's busy share and kernel time by name, and the burst's
   K1 f32 kernel time beside phase 3's bucket times weighted by the
   burst's launches. Last, prefill and
   decode logits are held against an independent plain forward of the
   same weights. The server is closed and its memory freed after this
   phase;
5. training kernels: the forward kernel with bfloat16 input and the dQ
   and dK/dV backward kernels against their plain versions at the shape
   the training step gives them (batch 8 x 16 heads, S 1024, D 128,
   causal; bfloat16 and float32), plus a ragged length and a non-causal
   case; an edge sweep of the bf16 forward, dQ and dK/dV kernels (S 1,
   65, 1000, 1024, S != Sk both ways, causal and not, D 16, 32 and 256
   on ``mma.sync``, 64 and 128 on ``wgmma``, BH 1 and 128), each case
   fatal; a head-dim sweep through ``flash_attention`` and autograd at
   D 48, 80 and 96 (zero-padded) and 256, f32 and bf16, BH 1 and 16, S
   65 and 1024, causal and not, against the plain versions at the real
   D (and D 320 must raise naming ROADMAP B7); then each kernel timed
   as the median of 5 windows of 20 launches, with the windows' spread
   and the host's µs per call, beside its plain version,
   ``scaled_dot_product_attention`` (forward, and backward for the two
   backward kernels together, timed alike), its bound, its TFLOP/s and
   its share of the bound: the bf16 kernels, then K2 f32 and K3 f32 in
   float32 (their bound on 3xTF32 and on FMAs), then the six D 256
   instances at BH 16;
6. train: ``Module`` on the same model at ``bench.py``'s training
   configuration (batch 8, T 1024, ``attention="flash"``, amp bfloat16,
   Xavier weights from a numpy seed, SGD lr 0.01) on one fixed random
   batch: the first step (bind included) timed, two warm steps, ten
   steps between CUDA events, then one step under ``torch.profiler``.
   The counters are zeroed before the first step and read after the
   thirteenth: each attention kernel must have run once per layer per
   step. The step-1 cross-entropy is held against an independent plain
   float32 forward of the same initial weights, and the loss must fall.
   Then the same with amp off (the reference's default; cuBLAS without
   TF32): the first step, one warm, five timed, one profiled; each f32
   attention kernel (K1 f32, K2 f32, K3 f32) must have run once per
   layer per step and no bf16 one;
7. rtc: the user-kernel tier. Each of the five kernels of
   ``rtc_examples`` (``scale_add``, ``relu``, ``split``,
   ``softmax_rows``, ``softmax_ce_grad``) against its plain version on
   the card and timed beside it, one library call and its bound, and
   ``scale_add`` once more from a thread torch never used. Then the
   counted path: ``scale_add`` through ``UserKernel.__call__``,
   ``relu`` through ``nd.<op>`` and ``sym.<op>`` + ``simple_bind`` +
   ``forward``, ``split`` (two outputs) through both, each equal to its
   plain version; and a ``CustomOp`` loss head on ``softmax_rows`` /
   ``softmax_ce_grad`` under ``FullyConnected(num_hidden=32000)`` (the
   zoo LM's output projection) trained by ``Module._fit_step`` on one
   fixed (8192, 2048) float32 batch: 13 steps, the step-1
   cross-entropy held against an independent plain float32 forward, the
   loss falling, and every kernel's launches equal to what the path
   implies;
8. resnet: ``Module`` on the zoo's ResNet-50 (v2, s2d stem, 1000
   classes) at ``bench.py``'s ResNet configuration (batch 128,
   3x224x224, amp bfloat16, Xavier(gaussian, in, 2) from seed 0, SGD lr
   0.05, momentum 0.9, wd 1e-4) on one fixed ``RandomState(0)`` batch:
   the first step, 2 warm, 12 between CUDA events, 1 under
   ``torch.profiler`` (device time by kind: conv forward and backward,
   BatchNorm, elementwise, pooling, optimizer; the idle share). The
   step-1 cross-entropy is held to 2e-2 nats of a plain float32 forward
   (``torch.nn.functional``, the 7x7/2 stem on the same weight, TF32
   off), the moving statistics step 1 commits to that forward's batch
   statistics blended by the momentum, the loss must fall, the module
   must hold the reference's 157 arg and 102 aux arrays, and no
   flash-attention kernel may launch (the counters are zeroed before
   the first step). Then the same in float32 (amp off, the reference's
   default): the first step, 1 warm, 5 timed; cross-entropy within
   1e-3 nats. This slice adds no kernel: convolutions run on cuDNN,
   BatchNorm on torch's kernels;
9. gluon: the imperative API. A HybridBlock calling
   ``F.FlashAttention(q, k, v, causal=True)`` at B 2, H 4, S 512, D 128
   runs under ``autograd.record()`` and ``backward()`` in bf16 and f32:
   K1, K2 and K3 must each launch once, the output and gradients match
   the plain versions. ``nn.Conv2DTranspose`` at a DCGAN generator's
   shape (batch 64, 512 -> 256 channels, kernel 4, stride 2, 8x8 ->
   16x16) against a plain f32 ``conv_transpose2d``, forward and
   backward. Then ``gluon.model_zoo.vision.get_model("resnet50_v1")``,
   hybridized, Xavier(gaussian, in, 2) from ``derive_numpy_rng`` after
   ``mt.random.seed(0)``, trained as the reference's Gluon example does
   (``autograd.record()``, ``backward()``, ``Trainer.step``; SGD lr
   0.05, momentum 0.9, wd 1e-4, ``SoftmaxCrossEntropyLoss``) on the
   ResNet phase's batch: amp bf16 (first step, 2 warm, 10 timed, 1
   profiled, then 11 un-hybridized, 10 of them timed) and f32 (1, 1, 5,
   1, then 1 + 5 un-hybridized). The step-1 loss and running
   statistics are held to ``plain_resnet_v1`` (the ResNet phase's
   limits), the parameter count to resnet50_v1's, the loss must fall,
   no attention kernel may launch, and in f32 one eager step and one
   hybridized step from the initial parameters must agree;
10. rnn: the fused RNN op against a plain per-step recurrence, the
    upstream Gluon word LM (tied 10,000 x 1500, 2 LSTM layers) in f32
    and amp bf16, and the upstream bucketing LM through
    ``BucketingModule`` over six buckets;
11. optimizers and checkpoints: (a) every optimizer of
    ``tests/test_fused_trainer.py`` under its four variants, the grouped
    (foreach) update against the per-parameter one over 3 steps on the
    LM's parameter shapes (2048², 2048 x 8192, 32000 x 2048 and a bias),
    each case fatal; (b) the LM of phase 6 at its full width and 2 of
    its 12 layers (``ADAM_LAYERS``: a 2.81 GB checkpoint, where the full
    depth's 8.85 GB took 24 s to write) in amp bf16 through
    ``Module.fit`` with Adam (lr 1e-4, wd 1e-4, clip 1.0),
    ``FactorScheduler(4, 0.5)``, ``CompositeEvalMetric([CrossEntropy(),
    Perplexity(None)])`` and an async ``CheckpointConfig``: 1 + 2 + 10
    steps + 1 profiled, beside phase 6's SGD step (step ms, tok/s, MFU,
    peak memory, the optimizer's device time), the step-1 loss held to
    the plain forward, each attention kernel once per layer per step,
    the epoch's checkpoint landed; (c) resume at the full width and 1 of
    the 12 layers: an uninterrupted fit of 2 epochs x 2 batches with a
    checkpoint each epoch, the first epoch's checkpoint restored bit for
    bit (parameters, Adam states, count, rate), and a fresh
    ``fit(resume_from=...)`` ending on the uninterrupted run's weights
    (bit for bit, or no further than a second uninterrupted run, naming
    the op that is not deterministic), with the checkpoint's bytes and
    its write, blocking and verified-read seconds; (d) the upstream
    Gluon DCGAN (nz 100, ngf 64, ndf 64, 64x64x3, batch 64, two Adam
    Trainers) for 5 steps with finite losses, then ``save_states`` /
    ``load_states`` into fresh Trainers continuing bit for bit for 2
    steps;
12. the op library and the symbolic zoo nets: (a) every op of the
    port's ``ops`` package but the samplers and FlashAttention (which
    phases 3, 5 and 9 hold) on the card against the port's CPU forward
    and input gradients under a seeded random head, from the same
    inputs, float32 with TF32 off, each case fatal, plus the
    out-of-range and tie cases of the indexing ops; ``pick`` and
    ``Embedding`` with indices outside their axis give the reference's
    NaN without a device assert; (b) each sampler, 10^6 draws: mean and
    variance within 6 standard errors of the distribution's, a KS or
    chi2 test at p >= 1e-6; ``_sample_multinomial`` per row and with
    ``get_prob``; ``shuffle`` a permutation; (c) the zoo's AlexNet
    through ``Module.fit`` (1000 classes, batch 128, 3x224x224,
    ``Xavier(magnitude=2)`` from the seed, SGD lr 0.01, momentum 0.9,
    wd 1e-4) on one fixed batch: amp bf16 1 + 2 + 12 + 1 steps (the
    last profiled), then f32 1 + 1 + 5 + 1; the inference forward of the
    initial weights against a plain f32 forward with LRN from its
    formula (logits within 1e-3 of max|ref| in f32, cross-entropy within
    2e-2 nats in bf16), the loss falling, Dropout keeping half, no
    attention launch; step ms, img/s, MFU, peak memory, device time by
    kind with LRN's on its own line; (d) ``benchmark_score``'s networks
    (AlexNet, VGG-16, Inception-BN, Inception-v3, ResNet-50 with the 7x7
    stem) forward-only at batch 32, f32 and amp bf16, 20 timed forwards
    after 3; at batch 2 each network's f32 logits on the card within
    1e-4 of max|cpu| of the port's CPU forward;
13. the structured op families and the detection / recognition
    examples: (a) the 18 ops of ``ops/{vision,detection,contrib}.py``
    on the card against the port's CPU forward and gradient (phase 12a's
    limits; class targets, masks, class ids and batch indices equal;
    Stochastic Activation Pruning where its draw is forced), and a ROI of
    a batch index outside the batch giving NaN without a device assert;
    (b) ``examples/train_ssd.py`` at its defaults through ``Module``
    (400 seeded 3x64x64 images, batch 32, 30 epochs, SGD 0.1 / 0.9 /
    1e-4) in f32, the first step's outputs against a plain f32 forward,
    the detection module through ``Module.predict`` (equal to
    ``forward`` + ``get_outputs`` batch by batch) to the example's gate
    (mean IoU of the best detection > 0.4), then one seeded epoch in amp
    bf16; step ms, img/s, the idle share of a profiled step, detection
    ms a batch, peak memory; (c) the detection ops at their published
    sizes, forward and backward against the CPU within 1e-4 of max(1,
    max|cpu|), timed between CUDA events with their extra peak memory:
    SSD300's 8732 priors, MultiBoxTarget (batch 32, 21 classes, 42 gt
    rows) and MultiBoxDetection (nms 0.45, top 400), the Faster R-CNN
    RPN's Proposal (38x63, 6000 -> 300), Fast R-CNN's ROIPooling (2 x 512
    x 38 x 63, 256 ROIs, 7x7; extra peak under 4 GB), SAP at (128, 256,
    56, 56) and (128, 2048, 7, 7) by distribution over 64 draws, CTCLoss
    at T 400, N 32, C 29; (d) ``examples/train_rcnn.py`` at its defaults
    (its ``proposal_target`` CustomOp in the graph) to its gate, ROI
    accuracy > 0.85, with the CustomOp's host share of a step; (e)
    ``examples/ctc_ocr.py`` at its defaults through Gluon (Adam,
    ``nd.CTCLoss``) to its gate, sequence accuracy > 0.8;
14. Symbol's surface, the fine-tune, model parallelism and the
    recurrent / symbolic examples: (a) every fluent method of ``Symbol``
    (42) on the card against the CPU through ``eval``; ResNet-50 (s2d
    stem, 224x224) and the LM at full width and one layer's depth:
    ``infer_shape_partial``, ``infer_type``, ``get_internals``, each net
    cut at its feature layer (the first child of the head, by
    ``get_children``), composed over a preprocessing symbol and
    evaluated on both devices from the same seeded weights, within 1e-4
    of max(1, max|cpu|); (b) ResNet-50 at the ResNet phase's
    configuration (amp bf16) fit on two seeded batches,
    ``save_checkpoint``, ``load_checkpoint``, cut at its flatten output
    with a new 10-class head whose weight is ``Variable(lr_mult=10)``,
    and fine-tuned with ``fixed_param_names`` set to every backbone
    argument: the fixed arguments bit for bit, the head's first update
    what SGD at lr x lr_mult gives, the loss falling, every moving
    statistic updated, ms a step; (c) the zoo LM at ``bench.py``'s width
    (12 layers, d_model 2048, T 1024, batch 8, amp bf16), its body built
    in ``AttrScope(ctx_group="body")``, cut at the final LayerNorm by
    ``get_internals``, a new head in ``AttrScope(ctx_group="head")``,
    bound by ``simple_bind(group2ctx={"body": gpu(0), "head": gpu(0)})``:
    three forward, backward and SGD steps bit for bit equal to the same
    symbol bound without ``group2ctx``, each flash-attention kernel (K1
    bf16, K2, K3) once per layer per grouped step by the counters, and
    their names in the profile of a grouped step; (d)
    ``examples/fine_tune.py``, ``model_parallel_lstm.py`` (every group
    on gpu(0), then ``layer0`` on cpu(0): the two within 1e-5 a step),
    ``bi_lstm_sort.py``, ``multi_task.py``, ``lstm_crf.py`` and
    ``tree_lstm.py`` at their defaults to their own gates;
15. the compile levers (queue A7): (a) ``bench.py``'s
    ``resnet_remat_accum`` at its own configuration (ResNet-50 v2, s2d
    stem, batch 256, amp bf16, Xavier(gaussian, in, 2) from the seed,
    SGD 0.05 / 0.9 / 1e-4, ``MXNET_TPU_REMAT=auto``,
    ``set_grad_accum(2)``) through ``Module._fit_step``: the policy
    ``auto`` resolves is the reference's (``LEVERS_RESNET_POLICY``,
    whole-forward, no plan), ``accum_steps`` 2 a step, the step-1
    cross-entropy within 2e-2 nats of the plain f32 forward, the loss
    falling, the weights after 3 steps within ``LEVERS_PARAM_RTOL`` of
    the run with remat off; step ms, img/s, MFU, and peak memory at batch
    256 plain, with grad_accum 2 alone and with both, beside the plain
    batch-128 step; (b) the LM at ``bench.py``'s width (amp bf16, batch
    8, flash attention): the scan plan holds 12 layers and its step is
    bit for bit the unrolled graph's; then ``MXNET_TPU_REMAT=auto`` (per
    block, ``LEVERS_LM_POLICY``) with grad_accum 2 against grad_accum 2
    alone, 3 + 5 steps each from the same weights: K1 bf16 launched 24
    times a microbatch (12 + 12 recomputed), K2 and K3 12, the weights
    after 3 steps within ``LEVERS_PARAM_RTOL``, the measured drop in peak
    memory within 25% of the calibrated ``est_peak_saving`` at the
    microbatch's shapes; step ms beside phase 6's;
16. the data plane and the async fit loop (queue A6): first the host
    probe, logged before anything uses it (cv2, PIL, whether the native
    library builds and loads, the jpeg / png libraries ldconfig knows,
    the cores), then the route fixed in ``DATA_ENCODER`` /
    ``DATA_DECODER`` (cv2: the card's host has no libjpeg / libpng),
    named in the log. (a) 1,280 seeded JPEG records (shorter side 256,
    longer 256-384, quality 95, the label the content's hue bucket)
    packed by ``recordio.pack_img`` into an indexed ``.rec`` and read
    back byte for byte; (b) the pipeline alone: ``ImageRecordIter`` at
    ``examples/train_imagenet.py``'s settings (3x224x224, batch 128,
    ``rand_crop``, ``rand_mirror``, the RGB mean) over 10 batches at 4
    and ``min(nproc, 32)`` threads, its first batch against a numpy
    oracle of the same records (equal); ``DataLoader`` +
    ``ImageTransform`` at 0, 2 and 4 workers over 4 batches, forked while a
    ``PrefetchingIter`` thread copies batches to the card, its first 3
    batches bit-identical across the counts, and the loader's queue
    transport timed alone; (c) ResNet-50 (7x7 stem, 1000 classes,
    Xavier gaussian / in / 2, SGD 0.1 / 0.9 / 1e-4) through
    ``Module.fit`` from the records (window 2, device prefetch 2), one
    epoch of 10 steps in amp bf16 and in f32: ms a step between CUDA
    events after 3 warm, img/s, the idle share of a profiled step, the
    same net fed a device-resident batch in the same call; the step-1
    loss within 2e-2 / 1e-3 of a plain f32 forward of the same decoded
    batch, the loss falling, ``loop_host_sync`` 0, ``loop_prefetch_placed``
    equal to the steps, the device accuracy equal to a host count over
    the fetched outputs; windows 2 and 0 bit for bit over 5 steps under
    ``cudnn.deterministic``; (d) a ``DataLoader`` (2 workers, shuffle,
    seed, batch 32, 12 batches) through ``fit``, checkpointed at batch 6
    and resumed with 4 workers: bit for bit the uninterrupted run, the
    cursor in the manifest; and the run again with
    ``data.worker@5:sigkill``, replayed bit for bit. A hung loader ends
    the run through ``faulthandler`` after ``DATA_DEADLINE_S``;
17. serving (queue A8c), in float32 with TF32 off: (a) ``InferenceServer``
    over a ``Predictor`` of benchmark_score's ResNet-50 (7x7 stem, 1000
    classes, seeded Xavier weights) bound at (1, 3, 224, 224), served
    with ``BucketSpec(32)``: 64 closed-loop client threads, each
    submitting its seeded image 8 times (512 requests), against one
    caller running 64 batch-1 ``Predictor.forward`` back to back —
    req/s both ways, p50 / p95 / p99 latency, mean batch rows,
    occupancy, runners (equal to the buckets touched, and no new one in
    a second pass of 128 requests after the grid is warm), peak memory;
    every served row within 1e-4 of the batch-1 forward of its image,
    padded rows bit for bit the unpadded bucket's under
    ``cudnn.deterministic``, ``_eager`` / ``_fallback`` 0; under
    ``MXNET_TPU_SERVE=0`` 8 eager requests matching the batched rows;
    ``wrap_model`` of a ``Module`` (``for_training=False``) and of Gluon
    ``resnet50_v1``, 16 requests each against their own forward. (b)
    ``Predictor.export`` at batch 32, run by
    ``mxnet_tpu_torch/tools/predict_exported.py`` in a subprocess from a
    scratch directory without ``PYTHONPATH``, running beside (c): its
    output within 1e-4 of ``forward``, the framework never imported
    there. (c)
    ``GenerativeServer(int8=True)`` on phase 4's weights and prompts:
    tok/s, TTFT and TPOT, the cache's bytes beside the allocator's, the
    audit, ``max_slots_for`` at 16 GB f32 against int8 (int8 at least
    2x); K1 f32 launched 8 x 12 times in the burst, bf16 never; teacher
    forced on phase 4's greedy tokens, every decode step's softmax
    within 5e-2 of an f32 cache's; layer 0's int8 codes and scales of
    the longest prompt against the plain quantizer on the CPU (codes at
    most one level apart, the count logged); greedy agreement with phase
    4 logged;
18. the one-process KVStore (queue A9a): (a) ``mt.kv.create("local")``
    on the card: ``init`` of one key and of a list of keys, ``push`` of
    a list of four values and ``pull`` into two arrays, bit for bit a
    numpy sum; ``set_optimizer`` (SGD with momentum) and two pushes
    within 1e-6 of a numpy SGD; the optimizer-state file written and
    read into a second store, whose next step equals the first's bit for
    bit; a small MLP through ``Module.fit`` with
    ``kvstore=mt.kv.create("local")`` and with ``kvstore=None`` from
    the same weights, bit for bit; the same MLP through ``forward`` /
    ``backward`` / ``update()`` with a store (push, pull) and without,
    within 1e-6. (b) the eleven single-card examples of
    ``mxnet_tpu_torch/examples/`` (``A9A_EXAMPLES``), each through its
    ``main`` at its own defaults on ``cuda:0`` (RecordIO decoded by
    ``DATA_DECODER``): each example's own gates are the check, its
    scores and seconds are logged, and each must have allocated memory
    on the card beyond what was held before it. A hang ends the run
    through ``faulthandler`` after ``KV_DEADLINE_S``;
19. observability and config (queue A10a), a-c under
    ``MXNET_TPU_LOCKCHECK=warn``: (a) ``GenerativeServer`` on phase 4's
    weights and prompts with ``MXNET_TPU_OBS=1`` and ``metrics_port=0``:
    an HTTP scrape of ``/metrics`` parsed by ``parse_prometheus``, its
    token counter and TTFT / TPOT histogram counts equal to
    ``stats()``, the greedy tokens phase 4's bit for bit, K1 f32 8 x 12
    launches; (b) ``InferenceServer`` over phase 17a's ResNet-50
    ``Predictor`` with spans on and ``metrics_port=0``, 64 requests from
    16 client threads: in the dumped trace each request's one flow runs
    from ``serve_submit`` on its client's lane through a
    ``serve_launch`` to a ``serve_resolve`` on the batcher's lane
    (``request_flows``), the scrape's latency count 64, no host sync
    under a witnessed lock; (c) ``fit`` of phase 6's LM (amp bf16, batch
    8 x T 1024) over 2 + 10 batches with obs on, ``mt.obs.report()``
    after the 2nd and the 12th step: ``flops_per_step`` within 5% of
    the PaLM count (35.4 TFLOP), ``steps_per_sec`` within 10% of the
    rate timed independently over the same steps, ``obs_mfu`` equal to
    ``flops_per_sec`` / 989e12, the trace's ``train``, ``place``,
    ``metric`` and ``prefetch/*`` lanes crossed by every batch's flow
    (``batch_flows``); the same fit with obs off from the same weights:
    parameters bit for bit, no span; the step time both ways logged;
    (d) every compile record since 19a names its scope, and
    ``obs_compile_count`` moved once per record; (f) no lock-order
    inversion and no held-lock sync in a-c, and a deliberate
    ``asnumpy`` of a card tensor under a plain witnessed lock counts
    one ``lockcheck_held_sync``; (e) a child process training the MLP
    of phase 18 on the card with ``MXNET_TPU_OBS_BLACKBOX`` and a 0.5 s
    heartbeat, killed by SIGKILL after its third heartbeat: ``python -m
    mxnet_tpu_torch.obs blackbox`` names rank 0 dead and its merged
    timeline loads as a chrome trace. A hang ends the run through
    ``faulthandler`` after ``OBS_DEADLINE_S``;
20. the rest of ``analysis/`` (queue A10b), on the LM at ``bench.py``'s
    width (flash, amp bf16) and ResNet-50 at phase 8's configuration
    (amp bf16): (a) each bound under ``MXNET_TPU_ANALYZE=strict`` with
    an 80 GB budget, no ERROR finding, the bind's seconds with the
    analyzer off and on, the ``hbm-budget`` estimate beside
    ``torch.cuda.max_memory_allocated()`` over one real training step;
    at a budget of half the estimate the bind raises ``MXNetError``
    naming the largest offender, ``torch.cuda.memory_allocated()``
    unchanged; (b) ``roofline.analyze_executable`` over one training
    step of each: the counted FLOPs within 25% of the cost model's
    training count (no ``flop-model-drift``), the flash kernels' share
    equal to their launches x their per-launch FLOPs (``attention_bound``)
    and their launches to the wrappers' counts, the classification on
    the H100's row (989 TFLOP/s, 3,350 GB/s); after a short ``fit`` of
    the LM, ``mt.obs.report()``'s record carries a ``roofline`` block
    whose ``measured_mfu`` is the report's ``obs_mfu``; (c) the program
    passes over the LM executor's training graph traced on fake tensors:
    no ERROR, each flash kernel one node per layer each way; a 64 MiB
    closure constant fires ``baked-const`` (ERROR) and an ``.item()``
    ``host-callback``; (d) ``python -m mxnet_tpu_torch.analysis`` ``lint
    --baseline`` over the port, ``self-check`` and ``audit mlp resnet8
    transformer``, three processes started together, each exit 0, the
    audit's roofline lines naming the card. A hang ends the run through
    ``faulthandler`` after ``ANALYSIS_DEADLINE_S``;
21. the legacy surface, the tools and the serving fleet (queue A10c and
    A10d's ``fleet/``), TF32 off: (a) an MLP of upstream MXNet's
    ``example/numpy-ops`` shape (784-128-64-10, batch 100, 1,000
    synthetic examples from the seed) with a ``NumpyOp`` softmax head,
    and the same MLP with an ``NDArrayOp`` scale layer and
    ``SoftmaxOutput``, each through ``Module.fit`` (3 epochs, SGD 0.1)
    on the card and on the host from the same numpy weights: each
    epoch's cross-entropy (a float64 numpy forward of its weights)
    within ``LEGACY_CE_ATOL`` card to host, the loss falling, the
    ``NDArrayOp``'s inputs on the card; (b) ``test_utils.check_consistency``
    over ``[mt.cpu(), mt.gpu(0)]`` for ResNet-50's first bottleneck unit
    (batch 8, 64 x 56 x 56) and the LM's first block with
    ``attention="flash"`` at full width (2 x 1024 tokens; K1 f32 on the
    card against its plain version on the host), and
    ``check_numeric_gradient`` on the card of a small symbol (passes) and
    of a custom op with twice its gradient (refused); (c) the LeNet
    prototxt and a ``.caffemodel`` encoded here through
    ``tools.caffe_converter``: the forward on the card within
    ``CAFFE_ATOL`` of the host's and within 1e-4 of numpy; the
    converter's reference-format ``.params`` through
    ``tools.convert_params`` into a ``Module`` bound on the card, equal
    to the predictor's forward; ``tools.parse_log`` over 21a's fit logs;
    (d) the fleet drill (its replicas started before (a), coming up
    while (a)-(c) run): a ``Gateway`` over three replica processes of
    phase 4's LM (4 of its 12 layers at full width, f32, ``init.Uniform(0.05)``
    from seed 11, 4 slots, page 16) on the card, rank 1 armed with
    ``FLEET_FAULT`` (SIGKILL after its 6th token frame), against one
    ``GenerativeServer`` built here from the same spec: two waves of
    phase 4's eight prompts (32 greedy tokens), each stream equal to the
    single server's token for token (or a near-tie: top-2 logit gap
    within ``LOGITS_ATOL`` at
    the first differing token and every emitted token within
    ``LOGITS_ATOL`` of its row's maximum, teacher-forced through
    ``plain_logits``), at least one fail-over and no duplicate frame,
    rank 1 respawned once with no native build, each replica's K1 f32
    launches equal to its prefills x layers, ``/metrics`` federating
    replica labels 0-2, every replica process reaped; the replicas'
    start times, the respawn time, tok/s and TTFT p50 beside the single
    server's, and the card's memory peak (``nvidia-smi``). A hang ends
    the run through ``faulthandler`` after ``FLEET_DEADLINE_S``;
22. the single-host supervisor, the rest of ``faults.py`` and the tuner
    (A10d), on the LM at full width as ``bench.py`` trains it (amp bf16,
    batch 8, T 1024) cut to ``ELASTIC_LAYERS`` of its 12 layers, the
    card freed first. (a) The supervised preemption drill
    (``tools.elastic_smoke``): the baseline and the drill each under
    ``python -m mxnet_tpu_torch.elastic``, both started before phase 21
    and run beside it and the rest of this phase (a CUDA process takes
    ~10 s to reach its ``fit`` on the card's host), the drill's attempt
    0 SIGTERMed at
    batch ``ELASTIC_FAULT_AT`` of ``ELASTIC_STEPS`` (``fit.batch``),
    restarted once and resumed from its checkpoint: every parameter's
    sha256 equal to the baseline's, the supervisors never creating a
    CUDA context, every attempt launching K1 bf16, K2 and K3 once per
    layer per step, the fault marker holding one fire. (b)
    ``fit(tune="auto")`` in this process (``tools.tune_smoke``) with a
    store in a temporary directory, one ranked candidate
    (``TUNE_MAX_PROBES``) and ``TUNE_PROBE_STEPS`` measured steps a probe
    under ``TUNE_PROBE_SECS``: the default and one candidate probed on
    the card, both ok with ``obs_mfu`` > 0 on the H100's peak row, the
    winner's score >= the default's, ``tune_applied`` 1, the fit trained
    under the winner's knobs, its cross-entropy finite and falling, the
    knobs gone after it; and the same program in a child process,
    started with the search and waiting for the stored record: a store
    hit (``tune_store_hit`` 1, no probe), the same knobs, no native
    build. (c) Beside that child, in this process: LayerNorm at
    d_model 2048 on rows offset by ``LN_OFFSET``, the two-pass variance
    closer to a float64 reference than the one-pass form, the one-pass
    form (the knob off) bit for bit the formula it had before the knob;
    under ``MXNET_ENGINE_TYPE=NaiveEngine`` the stream idle after each
    of a few imperative ops, whose results equal ``ThreadedEngine``'s
    bit for bit. A hang ends the run through ``faulthandler`` after
    ``ELASTIC_DEADLINE_S``.
23. the compiled step (A4d-b) and the compiled update (A4d-a):
    ``Module._fit_step``'s forward and backward as one ``torch.compile``d
    step program per structure (``_fused.StepProgram``, its backward by
    AOT autograd, K1 bf16, K2 and K3 custom-op nodes inside it), then
    ``Trainer.step``, ``Module.update`` and the fit step's update as one
    compiled program (``_fused.FusedUpdater``), inductor on the card.
    Phases 1-22 run with ``MXNET_TPU_FUSED_TRAINER=0`` (their eager step
    and update, as before): a cold inductor build of one large program
    takes minutes. Two child processes (``--phase23``, started after the
    build phase, beside phases 3-22): the ``lm`` child runs (a) whole,
    its fit's first step, where both programs build cold, beside the
    phases, the rest once this process writes ``go`` after phase 22; the
    ``resnet`` child builds (b)'s update into the checkout's
    ``build/inductor``, which (b) then loads, and runs the Convolution
    check. The compiler's facts first: torch's version, and ``triton``
    and ``torch._inductor``, which must import (the phase fails, it does
    not fall back). (a) The LM at the full width and depth of
    ``bench.py`` (12 layers, amp bf16, batch 8, T 1024, flash attention)
    through ``Module.fit`` with Adam, ``FUSED_WARM`` + ``FUSED_TIMED``
    steps: one ``fused_step_compile`` and one ``trainer_step_compile``, a
    cache hit of each for every later step, no recompile
    (``loop_recompile``, ``fused_step_recompile``,
    ``trainer_step_recompile``) and no fallback to an eager route, K1
    bf16, K2 and K3 launched once per layer per step (their counts zeroed
    just before the fit, read just after), finite losses that fall from
    the plain forward's step-1 cross-entropy; then one update from one
    set of gradients through the compiled program and through the eager
    ``Updater.update_multi``: every weight and state within the
    reference's bound (rtol 1e-4, atol 1e-6); the update's ms compiled
    against the eager ``_foreach_`` route and the whole step's ms
    compiled against eager, each the median of alternating windows
    between CUDA events, with the host's ms of every call and a
    ``torch.profiler`` trace of the first compiled call after an eager
    window; the builds' seconds (the compile ring's ``fused_step`` and
    ``trainer_step`` records); step 1's cross-entropy and gradients at the
    initial weights, compiled and eager, against a plain f32 step: the
    compiled route's relative L2 distance at most twice the eager
    route's. The Convolution check: train_imagenet's ResNet-50 through
    ``Module``'s compiled step at ``CONV_CHECK_BATCH`` (amp bf16): its
    gradients' distance from the eager f32 step's at most twice the eager
    bf16 step's, none zero where eager's is not (torch 2.11's capture
    zeroed every gradient through LayerNorm's autograd Function; before
    torch 2.13 the compiled step takes only the Functions a card run
    holds). (b) Gluon's ``resnet50_v1`` at phase 9's configuration (SGD,
    momentum, wd, batch 128, 224x224) through ``Trainer.step``: one step
    compiled and the same step with ``MXNET_TPU_FUSED_TRAINER=0``, from
    the same weights, states and gradients, within that bound; a new
    learning rate between steps compiles nothing. Amp bf16 for both.

The second-to-last line is the kernel table as one JSON object; the
last is ``{"ok": true, "device": {...}}``. Without a GPU, or run from a
directory that holds nothing else of the repository, it exits non-zero.
"""
from __future__ import annotations

import faulthandler
import gc
import json
import math
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense), for the bound of each kernel
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# the zoo transformer at bench.py's training width
VOCAB, LAYERS, D_MODEL, HEADS, D_FF, MAX_SEQ = 32000, 12, 2048, 16, 8192, 1024
SLOTS, PAGE, NEW_TOKENS = 8, 16, 32
PROMPT_LENS = (17, 64, 130, 250, 400, 555, 700, 900)
SEED = 0
DEVICE = "cuda:0"

KERNEL_ATOL = 1e-4     # f32 kernel vs f32 plain version: rounding only
                       # (3xTF32 drops ~2^-21 of each term)
LOGITS_ATOL = 1e-3     # f32 served logits vs a plain forward: 12 layers
                       # of f32 sums in another order; logits are O(1)
# bf16 kernel outputs vs the plain version of the same bf16 inputs. The
# kernels round P (and dS) to bf16 as tensor-core operands, as the TPU
# kernels do; the plain versions keep them in f32 (the plain forward
# rounds P too); both round the result to bf16, whose step is 2^-8 to
# 2^-7 of a value. Three limits, all enforced:
# - each element: |err| <= 2^-6 |ref| + 0.1 rms(ref): two to four
#   bf16 steps of the value, plus room for the rounding of P and dS
#   (about 2^-9 of each term of a sum). Measured on the H100 at the
#   training shape: up to 0.055 rms(ref) beyond 2^-6 |ref|; 0.1
#   rms(ref) is about 0.012 there, where the median |ref| is 0.03-0.05;
# - the whole tensor: ||err|| / ||ref|| <= 1e-2 (measured 2.5e-3 to
#   2.9e-3), which an output wrong over most of its elements fails;
# - the largest error: <= 2e-2 max|ref| (measured: one bf16 step).
BF16_ELEM_RTOL = 2.0 ** -6
BF16_ELEM_RMS = 0.1
BF16_NORM_RTOL = 1e-2
BF16_MAX_RTOL = 2e-2

# the training phase: bench.py's transformer configuration
TRAIN_BATCH, TRAIN_LR = 8, 0.01
TRAIN_WARM, TRAIN_TIMED = 2, 10
# the f32 training phase (amp off): ~1 s a step, so fewer steps
TRAIN_F32_WARM, TRAIN_F32_TIMED = 1, 5
# step-1 loss (amp bf16) vs a plain f32 forward of the same weights:
# measured 1.9e-6 apart on the H100; a near-uniform output would read
# ln 32000 = 10.373, 0.059 from the expected 10.432
CE_TOL = 1e-3

# the rtc phase: the training step's hidden state (batch 8 x T 1024 rows
# of d_model), its d_ff activation, and the LM head at full vocabulary
RTC_STEPS_WARM, RTC_STEPS_TIMED = 3, 10
# scale_add, relu, split and softmax_ce_grad round once in f32, as their
# plain versions do: equal, or within 1e-6 max|ref|
RTC_EXACT_RTOL = 1e-6
# softmax_rows sums 32000 exponentials in another order than its plain
# version (per-thread running sums merged by shuffles, against torch's
# reduction) and rescales them: a few f32 roundings of each value
RTC_SOFTMAX_RTOL = 1e-5

# the ResNet phases: bench.py's ResNet section (ResNet-50 v2, s2d stem,
# 1000 classes, batch 128, 3x224x224, Xavier(gaussian, in, 2), SGD lr
# 0.05, momentum 0.9, wd 1e-4); 24.534 GFLOP per image per training
# step by bench.py's accounting (3 x 2 x 4.089 GMAC forward)
RESNET_LAYERS, RESNET_CLASSES, RESNET_BATCH, RESNET_IMAGE = 50, 1000, 128, 224
RESNET_LR, RESNET_MOMENTUM, RESNET_WD = 0.05, 0.9, 1e-4
RESNET_FLOPS_PER_IMG = 2 * 4.089e9 * 3
RESNET_EPS = 2e-5
RESNET_WARM, RESNET_TIMED = 2, 12
RESNET_F32_WARM, RESNET_F32_TIMED = 1, 5
# step-1 cross-entropy against the plain f32 forward: amp rounds every
# conv's operands and output to bf16 (53 layers); f32 sums in another
# order (and the s2d stem against the 7x7 one)
RESNET_CE_TOL = 2e-2
RESNET_F32_CE_TOL = 1e-3
# each BatchNorm's batch statistics as the committed moving ones imply
# them, (new - momentum*old) / (1 - momentum), against the plain f32
# forward's: the mean within STATS_RTOL*std + STATS_ATOL, the variance
# within STATS_RTOL*var + STATS_ATOL (STATS_ATOL covers the f32 blend's
# own rounding, ~2e-6 once divided by 1 - momentum). Under amp every
# conv rounds its operands and output to bf16 (2^-8), so the port's
# activations part from the f32 forward's by a few percent in the last
# stage, and their statistics with them (a ResNet-18 at 64x64, batch 4,
# on the CPU: up to 9% of a variance); f32 only sums in another order.
# A wrong blend fails either by far: left uncommitted, the implied
# statistics are the initial 0 and 1; with torch's momentum (the weight
# of the new value) they are 9·batch − 8·old.
RESNET_STATS_RTOL = 0.25
RESNET_F32_STATS_RTOL = 1e-3
RESNET_STATS_ATOL = 1e-5

# the Gluon phase: resnet50_v1 from the zoo at the ResNet phase's batch,
# learning rate, momentum and weight decay (the reference's Gluon
# example); the same cross-entropy and statistics limits as the ResNet
# phase. Gluon's BatchNorm eps is 1e-5.
GLUON_TIMED = 10
GLUON_EPS = 1e-5
# resnet50_v1's parameter values: 25,575,912 with a gradient (its
# bottlenecks' 1x1 convolutions carry biases) and 53,120 running
# statistics
GLUON_RESNET50_V1_VALUES = 25575912 + 53120
# one eager step against one hybridized step, f32, from the same
# parameters: the same ops on the same inputs. cuDNN's default f32
# weight gradients sum with atomics (two calls measured 8.8e-5 of a
# weight gradient's max apart), so both steps take its deterministic
# algorithms. A convolution bias that a BatchNorm follows has no
# gradient in exact arithmetic (two calls measured 2.02 of its own max
# |value| apart): its difference is scaled by its weight's gradient
GLUON_EAGER_RTOL = 1e-5
# the tape check of the attention kernels, and the DCGAN generator's
# Conv2DTranspose (batch, in channels, out channels, input side)
TAPE_ATTENTION_SHAPE = (2, 4, 512, 128)
DECONV_SHAPE = (64, 512, 256, 8)
# a plain f32 conv_transpose2d against cuDNN's f32 one (TF32 off): sums
# of 512 x 4 products (d data: 256 x 4) in another order
DECONV_RTOL = 1e-5
# phase 10, the recurrent family. The word LM: the upstream Gluon example
# (example/gluon/word_language_model) at its README's largest run: a tied
# 10,000 x 1500 embedding and decoder, 2 LSTM layers of 1500, dropout
# 0.65, batch 32 x bptt 35, gradients clipped to 0.2 x bptt x batch, SGD
# lr 1.0 (momentum 0, wd 0); tokens drawn from RandomState(0)
WORD_VOCAB, WORD_WIDTH, WORD_LAYERS = 10000, 1500, 2
WORD_BATCH, WORD_BPTT, WORD_DROPOUT = 32, 35, 0.65
WORD_LR, WORD_CLIP = 1.0, 0.2
WORD_WARM, WORD_TIMED = 2, 10
# step-1 cross-entropy (dropout off) against a plain f32 forward of the
# same weights: two LSTM layers and a 1500-wide decoder in f32, summed in
# another order
WORD_CE_TOL = 1e-3
# the same under amp bf16: every product's operands and result rounded
# to bf16 (2^-8), the logits' cross-entropy taken in f32
WORD_BF16_CE_TOL = 1e-2
# the step-1 logits and final LSTM states (dropout off) held elementwise
# to the plain f32 forward's, each within a share of max|ref|: RNN_RTOL
# in f32, as the fused op's check; under amp bf16, where the operands of
# every product and the states are rounded to bf16, WORD_BF16_RTOL, 3x
# the largest reading on an H100 (5.84e-3, the logits)
WORD_BF16_RTOL = 2e-2
# the bucketing LM: upstream example/rnn/lstm_bucketing.py's defaults (2
# LSTM layers of 200, embedding 200, batch 32, buckets 10-60, SGD lr 0.01,
# momentum 0, wd 1e-5, Xavier(in, 2.34)); sentences over 10,000 words,
# BUCKET_BATCHES batches a bucket in the epoch
BUCKET_VOCAB, BUCKET_WIDTH, BUCKET_LAYERS, BUCKET_BATCH = 10000, 200, 2, 32
BUCKETS = (10, 20, 30, 40, 50, 60)
BUCKET_BATCHES = 2
BUCKET_LR, BUCKET_WD = 0.01, 1e-5
BUCKET_TIMED = 2
# the fused op (cuDNN's RNN, f32, TF32 off) against a plain per-step
# recurrence, and the fused cell against the unrolled one: output,
# states and gradients within RNN_RTOL * max(1, max|ref|). f32 sums of
# up to 3000 products per gate and 35 steps of recurrence, in another
# order
RNN_RTOL = 1e-4
RNN_CASES = ((1500, ("lstm", "gru", "rnn_tanh")), (200, ("lstm", "gru")))
# the aten ops cuDNN's RNN runs under; the op must reach one on the card
RNN_DEVICE_OPS = ("aten::_cudnn_rnn",)
# phase 11, optimizers and checkpoints. (a) every optimizer of
# tests/test_fused_trainer.py under its four variants: the grouped
# (foreach) update against the per-parameter one over 3 steps, each
# weight and state within OPT_RTOL * max(1, max|ref|) (the same f32
# formulas in another order; 1e-5 is that of the CPU parity tests)
OPT_CASES = (("sgd", {}), ("sgd", {"momentum": 0.9}),
             ("nag", {"momentum": 0.9}), ("adam", {}), ("adagrad", {}),
             ("rmsprop", {}), ("rmsprop", {"centered": True}),
             ("adadelta", {}), ("ftrl", {}), ("adamax", {}), ("nadam", {}),
             ("dcasgd", {"momentum": 0.9}), ("test", {}))
OPT_VARIANTS = ({}, {"clip_gradient": 0.05}, {"clip_gradient": -1.0},
                {"wd": 0.01})
OPT_STEPS = 3
OPT_RTOL = 1e-5
# (b) the LM through Module.fit with Adam: lr 1e-4, wd 1e-4, clip 1.0,
# FactorScheduler(step=4, factor=0.5), 1 + 2 + 10 steps + 1 profiled, at
# the full width and 2 of the 12 layers (cut from the depth only: its
# epoch checkpoint is 2.81 GB, against the full depth's 8.85 GB and 24 s
# of writing; every check of (b) holds at any depth)
ADAM_LAYERS = 2
ADAM_PARAMS = {"learning_rate": 1e-4, "wd": 1e-4, "clip_gradient": 1.0}
ADAM_SCHED = (4, 0.5)
ADAM_WARM, ADAM_TIMED = 2, 10
# (c) resume at the full width and 1 of the 12 layers: 2 epochs of 2
# batches, a checkpoint each epoch
RESUME_LAYERS, RESUME_EPOCHS, RESUME_BATCHES = 1, 2, 2
# (d) the upstream Gluon DCGAN (example/gluon/dcgan.py) at its widths
DCGAN_NZ, DCGAN_NGF, DCGAN_NDF, DCGAN_SIZE, DCGAN_BATCH = 100, 64, 64, 64, 64
DCGAN_LR, DCGAN_BETA1 = 2e-4, 0.5
DCGAN_STEPS, DCGAN_CONTINUE = 5, 2
# phase 12, the op library and the symbolic zoo nets. (a) every op on the
# card against the port's own CPU forward and gradient under a random
# head, f32 with TF32 off: the same formulas, summed in another order by
# another library (cuBLAS, cuDNN, cuSOLVER against the CPU's), on inputs
# of a few elements
OPS_FWD_RTOL = 1e-5
OPS_GRAD_RTOL = 1e-4
# (b) each sampler: 10^6 draws, mean and variance within 6 standard
# errors of the distribution's own, a KS (continuous) or chi2 (discrete)
# test against it at p >= 1e-6
SAMPLER_DRAWS = 1000000
SAMPLER_SIGMAS = 6.0
SAMPLER_MIN_P = 1e-6
# (c) AlexNet (models/alexnet.py) at examples/train_imagenet.py's batch
# and benchmark_score.py's initializer: 1000 classes, batch 128,
# 3x224x224, Xavier(magnitude=2), SGD lr 0.01, momentum 0.9, wd 1e-4;
# 50,844,008 parameters
ALEX_CLASSES, ALEX_BATCH, ALEX_IMAGE = 1000, 128, 224
ALEX_LR, ALEX_MOMENTUM, ALEX_WD = 0.01, 0.9, 1e-4
ALEX_PARAMS = 50844008
ALEX_WARM, ALEX_TIMED = 2, 12
ALEX_F32_WARM, ALEX_F32_TIMED = 1, 5
# the inference forward of the initial weights against a plain f32 one:
# eight layers of f32 sums in another order (logits, f32), or every
# product's operands and output rounded to bf16 (cross-entropy, amp)
ALEX_LOGITS_RTOL = 1e-3
ALEX_CE_TOL = 2e-2
# (d) examples/benchmark_score.py's networks, forward-only at batch 32
# (3 warm, 20 timed forwards), f32 and amp bf16; at batch 2 the card's
# f32 logits against the port's CPU forward: the same f32 formulas, cuDNN
# and cuBLAS against the CPU's kernels, over up to 16 layers
SCORE_NETS = ("alexnet", "vgg-16", "inception-bn", "inception-v3",
              "resnet-50")
SCORE_BATCH, SCORE_WARM, SCORE_TIMED = 32, 3, 20
SCORE_CHECK_BATCH, SCORE_RTOL = 2, 1e-4

# phase 13, the structured op families and the detection / recognition
# examples. (a) the 18 ops of ops/{vision,detection,contrib}.py on the
# card against the port's CPU forward and gradient, phase 12a's limits
# (b) examples/train_ssd.py at its defaults: 400 seeded 3x64x64 images,
# batch 32, 30 epochs, SGD 0.1 / 0.9 / 1e-4, Xavier(magnitude=2), seed
# 42; two scales of 4 anchors a cell; the example's gate, mean IoU of the
# best detection > 0.4; the first step's outputs against a plain f32
# forward: the same f32 formulas, cuDNN against torch's functional
# convolutions on the card
SSD_IMAGES, SSD_SIZE, SSD_BATCH, SSD_EPOCHS = 400, 64, 32, 30
SSD_LR, SSD_MOMENTUM, SSD_WD, SSD_SEED = 0.1, 0.9, 1e-4, 42
SSD_CLASSES, SSD_ANCHORS = 3, 4
SSD_SIZES = ((0.25, 0.35), (0.45, 0.6))
SSD_RATIOS = (1.0, 0.7, 1.4)
SSD_MIN_IOU = 0.4
SSD_STEP1_RTOL = 1e-4
SSD_WARM = 3
# (c) the detection ops at their published sizes, card against CPU
# (forward and gradient) within DET_RTOL of max(1, max|cpu|): SSD300
# (vgg16_reduced at 300, upstream example/ssd symbol_factory.py: maps,
# sizes, ratios; 8732 anchors) at batch 32, 21 classes, 42 padded gt rows;
# the Faster R-CNN RPN on VGG-16 conv5 of a 600x1000 image (38x63, 12
# anchors); Fast R-CNN's ROIPooling (VGG-16 conv5, 128 ROIs an image);
# SAP at the ResNet-50 phase's widths; CTC at a speech alphabet's
DET_RTOL = 1e-4
SSD300_LAYERS = ((38, (0.1, 0.141), (1.0, 2.0, 0.5)),
                 (19, (0.2, 0.272), (1.0, 2.0, 0.5, 3.0, 1.0 / 3)),
                 (10, (0.37, 0.447), (1.0, 2.0, 0.5, 3.0, 1.0 / 3)),
                 (5, (0.54, 0.619), (1.0, 2.0, 0.5, 3.0, 1.0 / 3)),
                 (3, (0.71, 0.79), (1.0, 2.0, 0.5)),
                 (1, (0.88, 0.961), (1.0, 2.0, 0.5)))
SSD300_ANCHORS, SSD300_BATCH, SSD300_CLASSES, SSD300_GT = 8732, 32, 21, 42
RPN_MAP, RPN_IMAGE, RPN_PRE, RPN_POST = (38, 63), (600, 1000), 6000, 300
ROI_DATA, ROI_PER_IMAGE, ROI_PEAK_GB = (2, 512, 38, 63), 128, 4.0
SAP_SHAPES = ((128, 256, 56, 56), (128, 2048, 7, 7))
SAP_DRAWS, SAP_SIGMAS = 64, 6.0
CTC_SHAPE = (400, 32, 29, 100)
# (d) examples/train_rcnn.py at its defaults: 200 seeded images, batch
# 16, 8 ROIs an image, 25 epochs, SGD 0.05 / 0.9; gate ROI accuracy > 0.85
RCNN_IMAGES, RCNN_SIZE, RCNN_BATCH, RCNN_R = 200, 64, 16, 8
RCNN_EPOCHS, RCNN_LR, RCNN_CLASSES, RCNN_MIN_ACC = 25, 0.05, 3, 0.85
# (e) examples/ctc_ocr.py at its defaults: 100 strips of 2 digits (5
# classes and the blank), 150 epochs of Adam 5e-3, hidden 64; gate:
# sequence accuracy > 0.8 on 200 held-out strips
CTC_EXAMPLES, CTC_EPOCHS, CTC_HIDDEN, CTC_LR = 100, 150, 64, 5e-3
CTC_DIGITS, CTC_DIGIT_W, CTC_H, CTC_CLASSES = 2, 8, 12, 5
CTC_MIN_ACC = 0.8

# phase 14, Symbol's surface, the fine-tune, the grouped LM and the
# recurrent / symbolic examples. (a) the surface on the card against the
# CPU, phase 12d's limit (1e-4 of max(1, max|cpu|), float32, TF32 off):
# ResNet-50 cut at its feature layer at batch 2, the LM at one layer's
# depth (full width) cut at its final LayerNorm at batch 1, and every
# fluent method on a (4, 6) input
SURFACE_RTOL = 1e-4
SURFACE_LM_LAYERS, SURFACE_RESNET_BATCH = 1, 2
# (b) the fine-tune at the ResNet phase's configuration: fit on
# FT_PRE_BATCHES seeded batches, checkpoint, load, a new 10-class head
# whose weight has lr_mult 10, FT_STEPS steps of plain SGD (lr FT_LR,
# the head's 10x that: the 2048 pooled features move the logits by
# about lr x 2048 a step, so 0.5 diverged) with every backbone argument
# fixed (the first step by hand, to read the head's gradient), then
# FT_TIMED timed ones
FT_PRE_BATCHES, FT_STEPS, FT_TIMED = 2, 6, 5
FT_CLASSES, FT_LR_MULT, FT_LR = 10, 10.0, 1e-4
FT_RATE_RTOL = 1e-5
# (c) the LM at bench.py's width under group2ctx: GROUP_STEPS SGD steps
# in lock step with the ungrouped bind (bit for bit), then GROUP_TIMED
# timed steps of each and one profiled grouped step
GROUP_STEPS, GROUP_TIMED = 3, 5
# (d) the examples at their defaults (argparse defaults of each file);
# the model-parallel LSTM's two placements agree within MP_ATOL a step
FINE_TUNE = {"pretrain_epochs": 6, "tune_epochs": 3, "n_pre": 1000,
             "n_tune": 150, "min_acc": 0.9}
MP_LSTM = {"layers": 2, "hidden": 48, "seq": 8, "batch": 16, "vocab": 50,
           "steps": 25, "lr": 5.0, "momentum": 0.9, "max_ratio": 0.7}
MP_ATOL = 1e-5
SORT = {"epochs": 10, "examples": 1500, "batch": 50, "lr": 0.05,
        "seed": 11, "min_acc": 0.6}
SORT_VOCAB, SORT_SEQ = 12, 6
MULTI = {"epochs": 5, "examples": 1200, "batch": 100, "lr": 0.05,
         "seed": 0, "min_acc": 0.9}
CRF = {"epochs": 12, "examples": 300, "hidden": 32, "lr": 0.01, "seed": 7,
       "min_acc": 0.9}
CRF_VOCAB, CRF_TAGS, CRF_T = 20, 3, 12
TREE = {"epochs": 8, "trees": 800, "batch": 50, "hidden": 48, "lr": 0.02,
        "seed": 0, "min_acc": 0.85}


# phase 15, the compile levers (queue A7): bench.py's resnet_remat_accum
# run (twice the ResNet batch, MXNET_TPU_REMAT=auto, set_grad_accum(2))
# and the LM at bench.py's width under the scan plan, per-block remat and
# grad_accum 2
LEVERS_ACCUM = 2
LEVERS_RESNET_BATCH = 2 * RESNET_BATCH
# the name MXNET_TPU_REMAT=auto resolves to at each configuration, the
# reference's pick (tests/test_torch_remat.py derives both from the
# reference's analyzer under amp bf16)
LEVERS_RESNET_POLICY = "auto:dots_with_no_batch_dims_saveable"
LEVERS_LM_POLICY = "auto:dots_with_no_batch_dims_saveable"
LEVERS_STEPS, LEVERS_TIMED = 3, 5
# the parameters after LEVERS_STEPS steps with remat on against off, each
# from the same weights on the same batch: within this share of the
# largest change those steps made to a weight (max |w3 - w0|). A
# recompute runs the forward's kernels on the forward's inputs; what may
# part the runs is the order of atomic sums in a weight gradient (cuDNN's
# f32 wgrad: 8.8e-5 of the gradient between two calls, phase 9), which a
# bf16 cast of a weight can turn into one bf16 step (2^-8) of a term
LEVERS_PARAM_RTOL = 1e-2
# the LM's measured drop in peak memory (remat off - on, grad_accum 2)
# against the calibrated est_peak_saving at the microbatch's shapes: the
# reference's round-trip criterion (tests/test_compile_time.py)
LEVERS_SAVING_RTOL = 0.25

# phase 16, the data plane (queue A6): examples/train_imagenet.py's input
# path (examples/common/data.py: ImageRecordIter, 3x224x224, batch 128,
# rand_crop, rand_mirror, the RGB mean, --data-nthreads 4) into
# Module.fit's async loop. The card's host was probed before this phase
# was written: cv2 4.13.0 and PIL 12.2.0 import, g++ 13.3, 8 cores, and
# neither jpeglib.h / png.h nor a libjpeg / libpng in ldconfig, so the
# native library cannot build there. The route is fixed here and named in
# the log, never chosen at run time:
DATA_ENCODER = "cv2"   # recordio.pack_img, as the reference's im2rec packs
DATA_DECODER = "cv2"   # MXNET_USE_NATIVE_IO=0: ImageRecordIter's and
                       # ImageTransform's Python/cv2 path; the native
                       # pipeline is held on the CPU (tests/test_torch_image)
DATA_RECORDS = 1280    # one epoch of 16c: 10 batches of 128
DATA_SHORT, DATA_LONG = 256, (256, 384)   # im2rec --resize 256's output
DATA_QUALITY = 95      # pack_img's default
DATA_NOISE = 12.0      # std of the noise on smooth content, in levels:
                       # 39-56 KB a record (47 mean) at 256 x 256-384
DATA_CLASSES = 10      # hue buckets: the label is the content's hue
DATA_MEAN = (123.68, 116.779, 103.939)    # examples/common/data.py
DATA_SHAPE = (3, 224, 224)
DATA_BATCH = 128
DATA_THREADS = 4       # --data-nthreads' default
DATA_MAX_THREADS = 32  # 16b's second reading: min(nproc, this) threads
DATA_PIPE_BATCHES = 10
DATA_WORKERS = (2, 4)
DATA_LOADER_BATCHES = 4     # timed per worker count; the first 3 compared
DATA_LOADER_SAME = 3
# the Python path's batch against a numpy oracle of the same records:
# cv2 decodes both and nothing is resized here, so they are equal
DATA_ORACLE_ATOL = 0.0
# train_imagenet's fit: ResNet-50 (7x7 stem), 1000 classes, Xavier
# gaussian / in / 2, SGD 0.1 / 0.9 / 1e-4 (examples/train_imagenet.py,
# examples/common/fit.py); window 2 and device prefetch 2 (the defaults)
IMAGENET_LR, IMAGENET_MOM, IMAGENET_WD = 0.1, 0.9, 1e-4
IMAGENET_WARM = 3      # steps before the timed window of an epoch
IMAGENET_PROFILED = 8   # the step profiled for the idle share
DATA_PARITY_STEPS = 5  # window 2 against window 0, bit for bit
# 16d: a DataLoader through fit, checkpointed at batch 6 of 12, resumed
# with another worker count (tests/test_data.py:335-351's drill)
DATA_RESUME_BATCH, DATA_RESUME_BATCHES, DATA_RESUME_AT = 32, 12, 6
DATA_FAULT = "data.worker@5:sigkill"
# phase 16 on the card takes 73-100 s: a hung loader or decode thread
# ends the run (faulthandler, armed by main) instead of the call's limit
DATA_DEADLINE_S = 600


# phase 17: serving (A8c). 17a: benchmark_score's ResNet-50 behind a
# Predictor, served at BucketSpec(SERVE_MAX_BATCH) (MXNET_TPU_SERVE_MAX_BATCH's
# default, benchmark_score's batch); traffic as tools/perf/serve_bench.py
# drives it: closed-loop clients, each resubmitting its own image
SERVE_LAYERS, SERVE_CLASSES, SERVE_IMAGE = 50, 1000, 224
SERVE_GLUON = "resnet50_v1"
SERVE_MAX_BATCH = 32
SERVE_CLIENTS, SERVE_REPEATS = 64, 8
SERVE_SECOND = 128         # the second pass, after the grid is warm
SERVE_KILL = 8             # requests under MXNET_TPU_SERVE=0
SERVE_ADAPTER = 16         # requests through each wrap_model adapter
SERVE_ATOL = 1e-4          # of max(1, max|ref|): cuDNN may choose other
                           # algorithms at other batch sizes
SERVE_EXPORT_BATCH = 32
# 17b: the artifact against forward, both float32 in one bucket geometry:
# above the f32 readings (1e-8 across buckets), below a TF32 run's (1e-5)
SERVE_EXPORT_ATOL = 1e-6
SERVE_INT8_SOFTMAX_TOL = 5e-2   # tests/test_serve_decode.py:146-149
SERVE_BUDGET = 16e9        # max_slots_for's budget, f32 against int8
SERVE_DEADLINE_S = 600
# what phase 4 leaves for 17c: its weights (host numpy) and its greedy
# tokens, so 17c serves the same model and compares with that burst
PHASE4 = {}


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*args) -> None:
    print(*args, flush=True)


# each phase's wall seconds in this run, by phase, logged before the end
PHASE_SECONDS = {}


def timed(name, fn, *args):
    t = time.perf_counter()
    try:
        return fn(*args)
    finally:
        PHASE_SECONDS[name] = round(time.perf_counter() - t, 1)


# ------------------------------------------------------------- phases

def card_phase(torch):
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, "nvidia-smi failed: %s" % smi.stderr)
    log(smi.stdout.strip())
    log("torch %s cuda %s device %s" % (torch.__version__, torch.version.cuda,
                                        torch.cuda.get_device_name(0)))
    full_f32(torch)


def full_f32(torch):
    """Full float32 everywhere, the port's path and the plain versions:
    TF32 off for cuBLAS and cuDNN. Inductor keys its on-disk cache by
    these switches too, so phase 23's warm-up processes set them alike."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def build_phase():
    """Every nvcc started together: the csrc libraries, and the user
    kernels through rtc.CudaModule (one thread each; a later CudaModule
    of the same source finds its cubin built)."""
    from concurrent.futures import ThreadPoolExecutor
    from mxnet_tpu_torch import _build, rtc, rtc_examples
    sources = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(rtc_examples.SOURCES)) as pool:
        futures = {name: pool.submit(rtc.CudaModule, src)
                   for name, src in rtc_examples.SOURCES.items()}
        _build.build(sources)
        modules = {name: f.result() for name, f in futures.items()}
    log("build: %d source(s) %s and %d rtc module(s) %s in %.2f s"
        % (len(sources), sources, len(modules), sorted(modules),
           time.perf_counter() - t0))
    for s in sources:
        log(_build.build_log(s).strip())
    for name, module in modules.items():
        log("rtc %s (%s): %s" % (name, module.cubin.name,
                                 module.build_log.strip()))
    wgmma_report(_build)


# the kernels on wgmma + TMA: record name -> (source, mangled-name part);
# their SASS must hold HGMMA (wgmma) and UTMALDG (TMA load) instructions
WGMMA_KERNELS = {
    "flash_attention_fwd_bf16": ("flash_attention_fwd.cu",
                                 "fa_fwd_bf16_wgmma"),
    "flash_attention_bwd_dq": ("flash_attention_bwd.cu",
                               "fa_bwd_dq_bf16_wgmma"),
    "flash_attention_bwd_dkv": ("flash_attention_bwd.cu",
                                "fa_bwd_dkv_bf16_wgmma"),
}
# the kernels on mma.sync tensor cores: their SASS must hold HMMA
MMA_KERNELS = {
    "flash_attention_fwd": ("flash_attention_fwd.cu", "fa_fwd_f32_tf32x3"),
    "flash_attention_bwd_dq_f32": ("flash_attention_bwd.cu",
                                   "fa_bwd_dq_f32_tf32x3"),
    "flash_attention_bwd_dkv_f32": ("flash_attention_bwd.cu",
                                    "fa_bwd_dkv_f32_tf32x3"),
}
BUILD_REPORT = {}


def wgmma_report(_build):
    """ptxas registers and spills of the tensor-core kernels, and the
    count of the instructions each must hold in its SASS (HGMMA and
    UTMALDG for the wgmma kernels, HMMA for the mma.sync ones); fatal if
    one spills or lacks one of them."""
    from concurrent.futures import ThreadPoolExecutor
    groups = [(WGMMA_KERNELS, ("HGMMA", "UTMALDG")), (MMA_KERNELS, ("HMMA",))]
    dumps = None
    if _build.cuobjdump() is not None:
        # one cuobjdump per library, all at once: each takes seconds
        sources = sorted({source for table, _ in groups
                          for source, _ in table.values()})
        every = sorted({op for _, opcodes in groups for op in opcodes})
        with ThreadPoolExecutor(max(1, len(sources))) as pool:
            # a failing cuobjdump raises here
            dumps = dict(zip(sources, pool.map(
                lambda source: _build.sass_counts(source, every), sources)))
    for table, opcodes in groups:
        for record, (source, part) in table.items():
            tensor_core_report(_build, dumps and dumps[source], record,
                               source, part, opcodes)


def tensor_core_report(_build, dump, record, source, part, opcodes):
    """``dump``: the library's SASS counts by kernel, None where the
    toolkit has no cuobjdump."""
    res = {n: r for n, r in _build.ptxas_resources(
        _build.build_log(source)).items() if part in n}
    check(res, "no ptxas report for %s in %s" % (part, source))
    if dump is None:             # the toolkit may lack cuobjdump
        log("sass %s: not counted (no cuobjdump in the toolkit)" % part)
        sass = None
    else:
        sass = {n: {op: c.get(op, 0) for op in opcodes}
                for n, c in dump.items() if part in n}
    build_log = _build.build_log(source).splitlines()
    for name, r in sorted(res.items()):
        spills = r.get("spill_stores", 0) + r.get("spill_loads", 0)
        counts = None if sass is None else sass.get(name)
        # ptxas C7514: it serialised the kernel's wgmma instructions
        r["serialized"] = any("C7514" in ln and name in ln
                              for ln in build_log)
        log("ptxas %s: %s registers, %s bytes stack, %d bytes spilled%s; "
            "sass %s" % (name, r.get("registers"), r.get("stack"),
                         spills, ", wgmma SERIALIZED (C7514)"
                         if r["serialized"] else "", counts))
        check(spills == 0, "%s spills %d bytes" % (name, spills))
        if sass is not None:
            check(counts and all(counts[op] > 0 for op in opcodes),
                  "%s: SASS counts %s (%s expected)"
                  % (name, counts, " and ".join(opcodes)))
    BUILD_REPORT[record] = {
        "ptxas": {n: res[n] for n in sorted(res)},
        "sass": sass}


def timing(torch, fn, iters: int = 20, windows: int = 5,
           warm: int = 3) -> dict:
    """Device ms per call as the median of ``windows`` windows of
    ``iters`` calls between CUDA events (after ``warm`` calls), with the
    windows' spread, and the host's µs per call over the same windows
    (the time the calls took to return). Where the host's time per call
    comes within 10% of the device's, the device waited on the host and
    the windows timed the host: ``host_bound`` says so."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    dev, host = [], []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        t1 = time.perf_counter()
        end.record()
        torch.cuda.synchronize()
        dev.append(start.elapsed_time(end) / iters)
        host.append((t1 - t0) / iters * 1e6)
    dev.sort()
    host.sort()
    ms = dev[len(dev) // 2]
    host_us = host[len(host) // 2]
    return {"ms": ms, "lo": dev[0], "hi": dev[-1], "host_us": host_us,
            "host_bound": host_us / 1e3 >= 0.9 * ms}


def time_ms(torch, fn, iters: int = 20) -> float:
    return timing(torch, fn, iters)["ms"]


def kernel_ms(torch, fn, iters: int = 20, attempts: int = 3) -> float:
    """Device ms per call from a torch.profiler trace of ``iters``
    calls: each kernel's mean duration times its launches per call, so
    the card's time on the call whatever the host's gaps between
    launches.

    CUPTI's traces lose kernel records now and then: on the H100 a
    trace late in the run held 18 records of a one-kernel call's 20 (so
    summing the records read the call up to a tenth short), and one
    held none at all. Means per kernel do not depend on how many
    records came through; launches per call are the records over
    ``iters``, rounded (a kernel seen less than once per two calls adds
    its recorded time over ``iters``). A trace with no device time is
    taken again, up to ``attempts`` times; if every one is empty, the
    time is read between CUDA events around ``iters`` back-to-back calls
    instead (an upper bound: it holds the host's gaps too), and the log
    says so. The result is never 0."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.count and e.self_device_time_total > 0]
        if not rows:
            log("kernel_ms: a trace of %d calls held no device time; taken "
                "again" % iters)
            continue
        us = 0.0
        for e in rows:
            per_call = round(e.count / iters)
            us += (e.self_device_time_total / e.count * per_call if per_call
                   else e.self_device_time_total / iters)
        n = sum(e.count for e in rows)
        if n % iters:
            log("kernel_ms: %d kernel records for %d calls; means per "
                "kernel used" % (n, iters))
        return us / 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    log("kernel_ms: %d profiler traces held no device time; CUDA events "
        "instead: %.4f ms per call" % (attempts, ms))
    check(ms > 0, "CUDA events timed %d calls at 0 ms" % iters)
    return ms


def spread(t: dict) -> str:
    return "%.4f ms (%.4f-%.4f over 5 windows; host %.1f us/call%s)" % (
        t["ms"], t["lo"], t["hi"], t["host_us"],
        ", HOST-BOUND" if t["host_bound"] else "")


def prompt_buckets():
    """The prefill bucket of each prompt of the burst: the server's
    ladder (powers of two from the page up to MAX_SEQ), first rung that
    holds the prompt."""
    from mxnet_tpu_torch.serve.bucketing import decode_buckets
    ladder = decode_buckets(MAX_SEQ, PAGE)
    return [next(b for b in ladder if n <= b) for n in PROMPT_LENS]


# the float32 sweep of K1 f32, K2 f32 and K3 f32: (S, Sk) pairs, ragged
# and crossed
F32_SWEEP_LENGTHS = ((1, 1), (65, 65), (200, 200), (1000, 1000),
                     (1024, 1024), (512, 1024), (1024, 512))
F32_SWEEP_HEADS = (1, HEADS)
F32_SWEEP_DIMS = (16, 32, 64, 128, 256)


def f32_sweep(torch):
    """K1 f32, K2 f32 and K3 f32 against their plain versions over every
    head dim (16-256), BH 1 and 16, S in {1, 65, 200, 1000, 1024}, S !=
    Sk both ways, causal and not: o, lse, dq, dk and dv each within
    KERNEL_ATOL max(1, max|ref|). Where dQ and dK are zero in exact
    arithmetic (S = 1 causal, Sk = 1) both sides are held to
    ZERO_GRAD_ATOL instead. Each case is fatal on failure. Returns the
    largest error of each kernel, {"fwd": .., "dq": .., "dkv": ..}."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    n = 0
    t0 = time.perf_counter()
    for d in F32_SWEEP_DIMS:
        for bh in F32_SWEEP_HEADS:
            for s, sk in F32_SWEEP_LENGTHS:
                for causal in (True, False):
                    q, do = (torch.randn((bh, s, d), generator=gen,
                                         device=dev) for _ in range(2))
                    k, v = (torch.randn((bh, sk, d), generator=gen,
                                        device=dev) for _ in range(2))
                    scale = d ** -0.5
                    o, lse = fa.flash_attention_fwd(q, k, v, scale, causal)
                    delta = (do * o).sum(-1)
                    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                   scale, causal)
                    dk, dv = fa.flash_attention_bwd_dkv(
                        q, k, v, do, lse, delta, scale, causal)
                    o_r, lse_r = fa.flash_attention_reference(
                        q, k, v, scale, causal)
                    dq_r, dk_r, dv_r = fa.flash_attention_backward_reference(
                        q, k, v, o, lse, do, scale, causal)
                    torch.cuda.synchronize()
                    zero = sk == 1 or (causal and s == 1)
                    errs = {}
                    for nm, got, want in (("o", o, o_r), ("lse", lse, lse_r),
                                          ("dq", dq, dq_r), ("dk", dk, dk_r),
                                          ("dv", dv, dv_r)):
                        if zero and nm in ("dq", "dk"):
                            # both sides hold only rounding: each near 0
                            errs[nm] = (max(got.abs().max().item(),
                                            want.abs().max().item()),
                                        ZERO_GRAD_ATOL)
                        else:
                            errs[nm] = ((got - want).abs().max().item(),
                                        KERNEL_ATOL * max(
                                            1.0, want.abs().max().item()))
                    case = "d=%d bh=%d s=%d sk=%d causal=%s" % (
                        d, bh, s, sk, causal)
                    log("  f32 sweep %s: %s%s" % (case, "; ".join(
                        "%s %.3g (limit %.3g)" % (nm, e, lim)
                        for nm, (e, lim) in errs.items()),
                        "; dq and dk zero in exact arithmetic" if zero
                        else ""))
                    bad = [nm for nm, (e, lim) in errs.items() if e > lim]
                    check(not bad, "f32 sweep %s: %s disagree with the plain "
                          "versions: %s" % (case, bad, errs))
                    for what, names in (("fwd", ("o", "lse")), ("dq", ("dq",)),
                                        ("dkv", ("dk", "dv"))):
                        worst[what] = max([worst[what]] + [
                            errs[nm][0] for nm in names
                            if not (zero and nm in ("dq", "dk"))])
                    n += 1
                    del q, k, v, do, o, lse, delta, dq, dk, dv, o_r, lse_r
                    del dq_r, dk_r, dv_r
    log("f32 sweep: %d cases of K1 f32, K2 f32 and K3 f32 within %g max(1, "
        "max|ref|) in %.1f s" % (n, KERNEL_ATOL, time.perf_counter() - t0))
    return worst


def kernel_phase(torch):
    """K1 f32 against its plain version at the prefill shapes (16 heads,
    d 128, every prompt bucket the slice phase uses plus a length that
    is no tile multiple), then over the f32 sweep; then timed at every
    bucket of the burst beside scaled_dot_product_attention, each side
    as window medians (timing) and kernel time (kernel_ms)."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.flash_attention import (
        flash_attention_fwd, flash_attention_reference)
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bh, d = HEADS, D_MODEL // HEADS
    scale = d ** -0.5
    worst = 0.0
    for s, causal in ((16, True), (128, True), (200, True), (512, True),
                      (1024, True), (512, False)):
        q, k, v = (torch.randn((bh, s, d), generator=gen, device=dev)
                   for _ in range(3))
        o, lse = flash_attention_fwd(q, k, v, scale, causal)
        o_r, lse_r = flash_attention_reference(q, k, v, scale, causal)
        torch.cuda.synchronize()
        err = max((o - o_r).abs().max().item(),
                  (lse - lse_r).abs().max().item())
        log("flash_attention_fwd bh=%d s=%d d=%d causal=%s max_abs_err=%.3g"
            % (bh, s, d, causal, err))
        check(err <= KERNEL_ATOL, "flash_attention_fwd disagrees with its "
              "plain version at s=%d: %g" % (s, err))
        worst = max(worst, err)
    swept = f32_sweep(torch)
    worst = max(worst, swept["fwd"])

    # every bucket of the burst, K1 f32 and SDPA f32 alike
    buckets = prompt_buckets()
    timed = {}
    for s in sorted(set(buckets)):
        q, k, v = (torch.randn((bh, s, d), generator=gen, device=dev)
                   for _ in range(3))
        calls = {"kernel": lambda: flash_attention_fwd(q, k, v, scale, True),
                 "library": lambda: F.scaled_dot_product_attention(
                     q[None], k[None], v[None], is_causal=True,
                     scale=scale)}
        timed[s] = {w: dict(timing(torch, fn), device_ms=kernel_ms(torch, fn))
                    for w, fn in calls.items()}
        bound_ms, bound_by, fma_ms, flops, _ = f32_attention_bounds(
            "fwd", bh, s, s, d, True)
        timed[s]["bound_ms"], timed[s]["bound_by"] = bound_ms, bound_by
        timed[s]["fma_bound_ms"] = fma_ms
        kt, lt = timed[s]["kernel"], timed[s]["library"]
        log("flash_attention_fwd f32 bh=%d s=%d d=%d causal (3xTF32 "
            "mma.sync): kernel %s, kernel time %.4f ms = %.1f TFLOP/s; "
            "library (sdpa f32) %s, kernel time %.4f ms; bound_ms=%.4f (%s, "
            "3 x flops at 495 TFLOP/s TF32 against bytes at 3.35 TB/s); "
            "f32 FMA bound %.4f ms" % (
                bh, s, d, spread(kt), kt["device_ms"],
                flops / kt["device_ms"] / 1e9, spread(lt), lt["device_ms"],
                bound_ms, bound_by, timed[s]["fma_bound_ms"]))
        del q, k, v
    # the burst's K1 f32 time by these readings: each prompt's bucket,
    # once per layer
    weighted = {w: LAYERS * sum(timed[b][w]["device_ms"] for b in buckets)
                for w in ("kernel", "library")}
    log("flash_attention_fwd f32 over the burst's buckets %s x %d layers: "
        "kernel time %.4f ms (sdpa f32 %.4f ms)"
        % (buckets, LAYERS, weighted["kernel"], weighted["library"]))

    s = MAX_SEQ
    q, k, v = (torch.randn((bh, s, d), generator=gen, device=dev)
               for _ in range(3))
    plain_ms = time_ms(
        torch, lambda: flash_attention_reference(q, k, v, scale, True))
    kt, lt = timed[s]["kernel"], timed[s]["library"]
    bound_ms, bound_by, _, flops, _ = f32_attention_bounds("fwd", bh, s, s, d,
                                                           True)
    log("flash_attention_fwd bh=%d s=%d d=%d causal: kernel_ms=%.4f "
        "reference_ms=%.4f library_ms=%.4f (sdpa) bound_ms=%.4f (%s at "
        "3xTF32; f32 FMA bound %.4f ms), %.1f%% of the bound"
        % (bh, s, d, kt["ms"], plain_ms, lt["ms"], bound_ms, bound_by,
           timed[s]["fma_bound_ms"], 100 * bound_ms / kt["device_ms"]))
    del q, k, v
    return {"flash_attention_fwd": {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "mxnet_tpu/ops/pallas/flash_attention.py:45",
        "tpu_kernel": "ops/pallas/flash_attention.py:_fa_kernel",
        "design": "3xTF32 on mma.sync",
        "max_abs_err": worst, "ms": kt["ms"],
        "ms_spread": [kt["lo"], kt["hi"]], "device_ms": kt["device_ms"],
        "host_us": kt["host_us"], "host_bound": kt["host_bound"],
        "tflops": flops / kt["device_ms"] / 1e9,
        "bound_share": bound_ms / kt["device_ms"],
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_peak": "3 x flops at 495 TFLOP/s TF32; bytes at 3.35 TB/s",
        "fma_bound_ms": timed[s]["fma_bound_ms"],
        "library_ms": lt["ms"], "library_spread": [lt["lo"], lt["hi"]],
        "library_device_ms": lt["device_ms"],
        "library_host_us": lt["host_us"],
        "library_host_bound": lt["host_bound"],
        "buckets": {str(b): {"device_ms": timed[b]["kernel"]["device_ms"],
                             "ms": timed[b]["kernel"]["ms"],
                             "library_device_ms":
                                 timed[b]["library"]["device_ms"],
                             "bound_ms": timed[b]["bound_ms"]}
                    for b in sorted(timed)},
        "burst_buckets": buckets,
        "burst_weighted_device_ms": weighted["kernel"],
        "burst_weighted_library_device_ms": weighted["library"]},
        # the sweep's K2 f32 and K3 f32 errors, completed by
        # train_kernel_phase
        "flash_attention_bwd_dq_f32": {"max_abs_err": swept["dq"]},
        "flash_attention_bwd_dkv_f32": {"max_abs_err": swept["dkv"]}}


def seeded_params(np, seed: int):
    """The served LM's weights as numpy arrays: gammas 1, betas and
    biases 0, every other weight N(0, 0.02) drawn on DEVICE by torch's
    generator seeded with ``seed`` (a numpy draw of the 737.5M values
    held the host 14-17 s)."""
    import torch
    from mxnet_tpu_torch.models.transformer import param_shapes
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    params = {}
    for name, shape in param_shapes(VOCAB, LAYERS, D_MODEL, HEADS, D_FF,
                                    MAX_SEQ).items():
        if name.endswith("_gamma"):
            params[name] = np.ones(shape, np.float32)
        elif name.endswith(("_beta", "_bias")):
            params[name] = np.zeros(shape, np.float32)
        else:
            params[name] = (torch.randn(shape, generator=gen, device=DEVICE)
                            * 0.02).cpu().numpy()
    return params


def plain_logits(torch, params, tokens, layers=None):
    """Last-position logits of the zoo transformer's training graph
    (dense attention with its -1e9 causal bias), written from the
    Symbol and independent of the served path; ``layers`` deep (default
    LAYERS)."""
    import torch.nn.functional as F
    p = params
    t = len(tokens)
    d = D_MODEL // HEADS
    x = p["tok_embed_weight"][torch.tensor(tokens, device=DEVICE)] \
        + p["pos_embed_weight"][:t]
    bias = torch.triu(torch.full((t, t), -1e9, device=DEVICE), 1)
    for i in range(LAYERS if layers is None else layers):
        pf = "layer%d_" % i
        h = F.layer_norm(x, (D_MODEL,), p[pf + "ln1_gamma"],
                         p[pf + "ln1_beta"], 1e-5)
        qkv = F.linear(h, p[pf + "att_qkv_weight"], p[pf + "att_qkv_bias"])
        q, k, v = qkv.view(t, 3, HEADS, d).permute(1, 2, 0, 3)
        att = torch.softmax(q @ k.transpose(-1, -2) * d ** -0.5 + bias, -1)
        ctx = (att @ v).transpose(0, 1).reshape(t, D_MODEL)
        x = x + F.linear(ctx, p[pf + "att_proj_weight"],
                         p[pf + "att_proj_bias"])
        h = F.layer_norm(x, (D_MODEL,), p[pf + "ln2_gamma"],
                         p[pf + "ln2_beta"], 1e-5)
        h = torch.relu(F.linear(h, p[pf + "ff1_weight"], p[pf + "ff1_bias"]))
        x = x + F.linear(h, p[pf + "ff2_weight"], p[pf + "ff2_bias"])
    x = F.layer_norm(x[-1:], (D_MODEL,), p["final_ln_gamma"],
                     p["final_ln_beta"], 1e-5)
    return F.linear(x, p["lm_head_weight"], p["lm_head_bias"])[0]


def burst(srv, prompts):
    """Submit every prompt at once (greedy) and wait for all of them;
    the latency histograms are reset first, so stats() describe this
    burst alone."""
    srv.latency.reset()
    t0 = time.perf_counter()
    handles = [srv.submit_generate(pr, max_new_tokens=NEW_TOKENS)
               for pr in prompts]
    outs = [h.result(timeout=600) for h in handles]
    return outs, time.perf_counter() - t0


def report(what, srv, outs, wall):
    st = srv.stats()
    tokens = sum(len(t) for t in outs)
    log("slice %s: %d requests, %d tokens in %.3f s = %.1f tok/s; ttft p50 "
        "%.3f ms p95 %.3f ms; tpot p50 %.3f ms p95 %.3f ms"
        % (what, len(outs), tokens, wall, tokens / wall, st["ttft"]["p50_ms"],
           st["ttft"]["p95_ms"], st["tpot"]["p50_ms"], st["tpot"]["p95_ms"]))


def device_breakdown(torch, prof, wall, what="slice"):
    """Kernel time by name from a torch.profiler trace, and the device's
    busy share of the window's wall time; returns the CUDA rows and the
    busy time in ms. A scheduled trace's ProfilerStep span lies on the
    device's timeline too, over the kernels it holds: it is left out."""
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("ProfilerStep")]
    busy_us = sum(e.self_device_time_total for e in rows)
    log("%s profiled: device busy %.3f ms of %.3f ms wall (%.1f%%), "
        "idle share %.3f" % (what, busy_us / 1e3, wall * 1e3,
                             100 * busy_us / 1e3 / (wall * 1e3),
                             1 - busy_us / 1e3 / (wall * 1e3)))
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        log("  %8.3f ms %5d x %s" % (e.self_device_time_total / 1e3,
                                     e.count, e.key[:90]))
    return rows, busy_us / 1e3


def slice_phase(torch, np, kernels):
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch.ops.flash_attention import flash_attention_fwd
    from mxnet_tpu_torch.serve import GenerativeServer
    t0 = time.perf_counter()
    params = seeded_params(np, SEED)
    log("weights: %d params drawn in %.1f s"
        % (sum(a.size for a in params.values()), time.perf_counter() - t0))
    torch.cuda.reset_peak_memory_stats()
    srv = GenerativeServer(params, n_heads=HEADS, max_sequences=SLOTS,
                           page=PAGE, name="smoke", device=DEVICE)
    PHASE4["params"] = params       # phase 17c serves them from int8 KV
    del params
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, VOCAB, n) for n in PROMPT_LENS]
    try:
        # the main path, once, from a cold server: the counted run
        flash_attention_fwd.launches = {"f32": 0, "bf16": 0}
        outs, wall = burst(srv, prompts)
        counts = dict(flash_attention_fwd.launches)
        launches = {"flash_attention_fwd": counts["f32"]}
        PHASE4["outs"] = outs
        torch.cuda.synchronize()
        st = srv.stats()
        report("cold", srv, outs, wall)
        # the same burst again, every runner and library handle warm,
        # then once more under the profiler for the device breakdown
        warm, wall = burst(srv, prompts)
        report("warm", srv, warm, wall)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, wall = burst(srv, prompts)
            torch.cuda.synchronize()
        rows, _ = device_breakdown(torch, prof, wall)
        served = [srv.engine.prompt_bucket(len(pr)) for pr in prompts]
    finally:
        srv.close()
    # K1 f32 in the profiled burst against phase 3's bucket times
    k1 = [e for e in rows if "fa_fwd_f32" in e.key]
    k1_ms = sum(e.self_device_time_total for e in k1) / 1e3
    entry = kernels["flash_attention_fwd"]
    check(served == entry["burst_buckets"], "the server's prompt buckets %s "
          "are not the timed ones %s" % (served, entry["burst_buckets"]))
    entry["burst_device_ms"] = k1_ms
    log("slice: K1 f32 in the profiled burst: %.4f ms of kernel time in %d "
        "launches; phase 3's bucket times x the burst's launches: %.4f ms "
        "(sdpa f32 there: %.4f ms)" % (
            k1_ms, sum(e.count for e in k1),
            entry["burst_weighted_device_ms"],
            entry["burst_weighted_library_device_ms"]))
    for pr, toks in zip(prompts, outs):
        check(len(toks) == NEW_TOKENS and all(0 <= t < VOCAB for t in toks),
              "prompt of %d tokens gave %r" % (len(pr), toks))
    prefills = len(prompts)
    check(counts["bf16"] == 0, "the f32 serving path launched the bf16 "
          "forward kernel %d times" % counts["bf16"])
    check(launches["flash_attention_fwd"] == prefills * LAYERS,
          "flash kernel launched %d times for %d prefills x %d layers"
          % (launches["flash_attention_fwd"], prefills, LAYERS))
    check(st["decode_steps"] > 0, "no decode step ran")
    check(st["compiles"] + st["cache_hits"] == prefills + st["decode_steps"],
          "runner dispatches %d != prefills %d + decode steps %d"
          % (st["compiles"] + st["cache_hits"], prefills,
             st["decode_steps"]))
    check(st["compiles"] <= st["executable_bound"], "runner set unbounded")
    for name, n in launches.items():
        check(n > 0, "kernel %s never ran on the main path" % name)
        kernels[name]["launches"] = n
    log("slice: decode steps %d; runners %d (bound %d); peak memory %.3f GB;"
        " kv cache %.3f GB; warm burst repeats the cold tokens for %d of %d "
        "prompts" % (st["decode_steps"], st["compiles"],
                     st["executable_bound"],
                     torch.cuda.max_memory_allocated() / 1e9,
                     st["kv"]["hbm_bytes"] / 1e9,
                     sum(a == b for a, b in zip(outs, warm)), len(outs)))

    # the served logits against an independent plain forward, for a
    # short and a long prompt: prefill, then one decode step
    eng, cache = srv.engine, srv.cache
    worst = 0.0
    for pr in (prompts[0], prompts[-1]):
        pr = [int(t) for t in pr]
        slot = cache.acquire(len(pr))
        got = torch.from_numpy(eng.prefill(np.array(pr), slot)).to(DEVICE)
        want = plain_logits(torch, eng.params, pr)
        err_p = (got - want).abs().max().item()
        tok = int(want.argmax())
        tokens_ = np.zeros(SLOTS, np.int64)
        pos = np.zeros(SLOTS, np.int64)
        active = np.zeros(SLOTS, bool)
        tokens_[slot], pos[slot], active[slot] = tok, len(pr), True
        got = torch.from_numpy(
            eng.decode_step(tokens_, pos, active)[slot]).to(DEVICE)
        want = plain_logits(torch, eng.params, pr + [tok])
        err_d = (got - want).abs().max().item()
        cache.release(slot)
        log("slice: prompt %d tokens: prefill logits max_abs_err %.3g, "
            "decode logits max_abs_err %.3g" % (len(pr), err_p, err_d))
        worst = max(worst, err_p, err_d)
    torch.cuda.synchronize()
    check(worst <= LOGITS_ATOL,
          "served logits disagree with the plain forward: %g" % worst)
    # free the server's weights and cache before the training phase
    del eng, cache, srv
    gc.collect()
    torch.cuda.empty_cache()


def live_pairs(s: int, sk: int, causal: bool) -> int:
    """(q, k) pairs a causal (top-aligned) or full attention computes."""
    if not causal:
        return s * sk
    return sum(min(i + 1, sk) for i in range(s))


def attention_bound(what, bh, s, sk, d, causal, itemsize):
    """Least time for one flash-attention kernel over these shapes: the
    larger of its operations at the bf16 tensor-core peak (f32 inputs:
    the f32 FMA peak) and its bytes (each input read once, each output
    written once) at the memory rate. Returns (ms, bound_by, flops,
    bytes)."""
    pairs = bh * live_pairs(s, sk, causal)
    q_rows, k_rows = bh * s * d, bh * sk * d
    if what == "fwd":        # S = QK^T, O = PV; reads q k v, writes o lse
        flops = 4.0 * d * pairs
        nbytes = itemsize * (2 * q_rows + 2 * k_rows) + 4.0 * bh * s
    elif what == "dq":       # S, dP, dQ; reads q k v do lse delta, writes dq
        flops = 6.0 * d * pairs
        nbytes = itemsize * (3 * q_rows + 2 * k_rows) + 8.0 * bh * s
    else:                    # S, dP, dV, dK; writes dk dv
        flops = 8.0 * d * pairs
        nbytes = itemsize * (2 * q_rows + 4 * k_rows) + 8.0 * bh * s
    peak = PEAK_BF16_FLOPS if itemsize == 2 else PEAK_FP32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def f32_attention_bounds(what, bh, s, sk, d, causal):
    """The f32 kernel's bounds: on its 3xTF32 route (three tf32 products
    per product, so 3 x flops at 495 TFLOP/s) and on float32 FMAs (flops
    at 67 TFLOP/s), each against the bytes at 3.35 TB/s. Returns
    (ms, bound_by, fma_ms, flops, bytes)."""
    fma_ms, _, flops, nbytes = attention_bound(what, bh, s, sk, d, causal, 4)
    t_ops, t_bytes = 3 * flops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", fma_ms, flops,
            nbytes)


def f32_backward_timing(torch):
    """K2 f32 and K3 f32 at the training step's attention shape (batch 8
    x 16 heads, S 1024, D 128, causal, float32), each as window medians
    (timing) and kernel time (kernel_ms), beside SDPA f32's backward (dQ,
    dK and dV together, timed alike), the plain backward and both
    bounds. Returns {"dq": ..., "dkv": ..., "library": ...,
    "plain_ms": ...}."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import flash_attention as fa
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    bh, s, d = TRAIN_BATCH * HEADS, MAX_SEQ, D_MODEL // HEADS
    scale = d ** -0.5
    q, k, v, do = (torch.randn((bh, s, d), generator=gen, device=dev)
                   for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, scale, True)
    delta = (do * o).sum(-1)
    calls = {
        "dq": lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                scale, True),
        "dkv": lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                  scale, True)}
    t = {w: dict(timing(torch, fn), device_ms=kernel_ms(torch, fn))
         for w, fn in calls.items()}
    shape4 = (TRAIN_BATCH, HEADS, s, d)
    q4, k4, v4 = (x.view(shape4).detach().requires_grad_(True)
                  for x in (q, k, v))
    out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                          scale=scale)
    do4 = do.view(shape4)

    def library():
        return torch.autograd.grad(out4, (q4, k4, v4), do4,
                                   retain_graph=True)
    t["library"] = dict(timing(torch, library),
                        device_ms=kernel_ms(torch, library))
    t["plain_ms"] = time_ms(torch, lambda: fa.flash_attention_backward_reference(
        q, k, v, o, lse, do, scale, True), iters=5)
    lt = t["library"]
    for what in ("dq", "dkv"):
        bound_ms, bound_by, fma_ms, flops, nbytes = f32_attention_bounds(
            what, bh, s, s, d, True)
        t[what].update(bound_ms=bound_ms, bound_by=bound_by, fma_ms=fma_ms,
                       flops=flops, bytes=nbytes)
        kt = t[what]
        log("%s f32 bh=%d s=%d d=%d causal: kernel %s, kernel time %.4f ms "
            "= %.1f TFLOP/s, %.1f%% of the bound; plain_ms=%.4f (plain "
            "backward, dQ dK dV); library (sdpa f32 backward, dQ dK dV) %s, "
            "kernel time %.4f ms; bound_ms=%.4f (%s: 3 x %.1f GFLOP at 495 "
            "TFLOP/s TF32 = %.4f ms, %.1f MB at 3.35 TB/s = %.4f ms); f32 FMA "
            "bound %.4f ms" % (
                "flash_attention_bwd_" + what, bh, s, d, spread(kt),
                kt["device_ms"], flops / kt["device_ms"] / 1e9,
                100 * bound_ms / kt["device_ms"], t["plain_ms"], spread(lt),
                lt["device_ms"], bound_ms, bound_by, flops / 1e9,
                3 * flops / PEAK_TF32_FLOPS * 1e3, nbytes / 1e6,
                nbytes / PEAK_BYTES_PER_S * 1e3, fma_ms))
    del q, k, v, do, o, lse, delta, q4, k4, v4, out4, do4
    gc.collect()
    torch.cuda.empty_cache()
    return t


def bf16_compare(got, want):
    """A bf16 kernel output against its plain version by the three
    limits above: returns the readings and whether all three hold."""
    want = want.float()
    diff = (got.float() - want).abs()
    err = diff.max().item()
    top = want.abs().max().item()
    rms = want.pow(2).mean().sqrt().item()
    # the share of rms(ref) by which an element's error passes 2^-6 |ref|,
    # and the error's norm against the output's
    excess = (diff - BF16_ELEM_RTOL * want.abs()).flatten()
    at = int(excess.argmax())
    r = {"err": err, "top": top, "rms": rms,
         "over": excess[at].item() / max(rms, 1e-30),
         "rel": diff.norm().item() / max(want.norm().item(), 1e-30),
         "at_ref": want.flatten()[at].abs().item(),
         "at_err": diff.flatten()[at].item()}
    r["ok"] = (err <= BF16_MAX_RTOL * top and r["rel"] <= BF16_NORM_RTOL
               and r["over"] <= BF16_ELEM_RMS)
    return r


# the edge sweep of the bf16 forward, dQ and dK/dV kernels: (S, Sk)
# pairs, ragged and crossed; D 16, 32 and 256 take the mma.sync kernels,
# D 64 and 128 the wgmma ones
SWEEP_LENGTHS = ((1, 1), (65, 65), (1000, 1000), (1024, 1024), (512, 1024),
                 (1024, 512))
SWEEP_HEADS = (1, TRAIN_BATCH * HEADS)
SWEEP_DIMS = (16, 32, 64, 128, 256)
# dK and dQ are zero in exact arithmetic where every live q row sees a
# single key (S = 1 causal, or Sk = 1): softmax has no gradient with
# respect to its only key, so that key's dP - delta vanishes. Both sides
# then hold only the rounding of dP - delta, two f32 sums of the same
# products (readings on the H100: 0 to 1.3e-6, either side), so the
# relative limits have no scale there: both are held to zero within this
# bound instead
ZERO_GRAD_ATOL = 1e-5


def edge_sweep(torch):
    """K1 bf16, K2 and K3 against their plain versions under the bf16
    limits (and lse within 1e-4 max(1, max|ref|)) over S in {1, 65,
    1000, 1024}, S != Sk both ways (top-aligned), causal and not, D 16,
    32 and 256 (the mma.sync kernels), 64 and 128 (the wgmma kernels),
    BH 1 and 128: the ragged and crossed edges that TMA's zero fill
    meets. Each case is fatal on failure."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    n = 0
    t0 = time.perf_counter()
    for d in SWEEP_DIMS:
        for bh in SWEEP_HEADS:
            for s, sk in SWEEP_LENGTHS:
                for causal in (True, False):
                    q, do = (torch.randn((bh, s, d), generator=gen,
                                         device=dev).bfloat16()
                             for _ in range(2))
                    k, v = (torch.randn((bh, sk, d), generator=gen,
                                        device=dev).bfloat16()
                            for _ in range(2))
                    scale = d ** -0.5
                    o, lse = fa.flash_attention_fwd(q, k, v, scale, causal)
                    delta = (do.float() * o.float()).sum(-1)
                    dq = fa.flash_attention_bwd_dq(
                        q, k, v, do, lse, delta, scale, causal)
                    dk, dv = fa.flash_attention_bwd_dkv(
                        q, k, v, do, lse, delta, scale, causal)
                    o_r, lse_r = fa.flash_attention_reference(q, k, v, scale,
                                                              causal)
                    dq_r, dk_r, dv_r = fa.flash_attention_backward_reference(
                        q, k, v, o, lse, do, scale, causal)
                    torch.cuda.synchronize()
                    res = {name: bf16_compare(got, want) for name, got, want
                           in (("o", o, o_r), ("dq", dq, dq_r),
                               ("dk", dk, dk_r), ("dv", dv, dv_r))}
                    case = "d=%d bh=%d s=%d sk=%d causal=%s" % (
                        d, bh, s, sk, causal)
                    if sk == 1 or (causal and s == 1):
                        tops = {nm: (got.float().abs().max().item(),
                                     res.pop(nm)["top"])
                                for nm, got in (("dq", dq), ("dk", dk))}
                        log("  sweep %s: dq and dk are zero in exact "
                            "arithmetic: %s (limit %g)" % (case, "; ".join(
                                "%s kernel max %.3g, plain max %.3g"
                                % (nm, a, b) for nm, (a, b) in tops.items()),
                                ZERO_GRAD_ATOL))
                        check(max(max(ab) for ab in tops.values())
                              <= ZERO_GRAD_ATOL,
                              "edge sweep %s: dq or dk not zero" % case)
                    lse_err = (lse - lse_r).abs().max().item()
                    lse_lim = KERNEL_ATOL * max(1.0, lse_r.abs().max().item())
                    log("  sweep %s: %s; lse %.3g (limit %.3g)" % (
                        case, "; ".join(
                            "%s max %.3g/%.3g norm %.2e elem %.3f" % (
                                nm, r["err"], r["top"], r["rel"], r["over"])
                            for nm, r in res.items()), lse_err, lse_lim))
                    bad = [nm for nm, r in res.items() if not r["ok"]]
                    check(not bad and lse_err <= lse_lim,
                          "edge sweep %s: %s disagree with the plain versions"
                          " (lse err %g)" % (case, bad or "none", lse_err))
                    worst["fwd"] = max(worst["fwd"], res["o"]["err"], lse_err)
                    if "dq" in res:
                        worst["dq"] = max(worst["dq"], res["dq"]["err"])
                    worst["dkv"] = max(worst["dkv"], res["dv"]["err"],
                                       res.get("dk", res["dv"])["err"])
                    n += 1
                    del q, k, v, do, o, lse, delta, dq, dk, dv, o_r, lse_r
                    del dq_r, dk_r, dv_r
    log("edge sweep: %d cases of K1 bf16, K2 and K3 within the bf16 limits "
        "in %.1f s" % (n, time.perf_counter() - t0))
    gc.collect()
    torch.cuda.empty_cache()
    return worst


# the head-dim sweep: dims that flash_attention pads (48 -> 64, 80 and 96
# -> 128) and D 256, through the public function and autograd
HEAD_DIM_SWEEP_DIMS = (48, 80, 96, 256)
HEAD_DIM_SWEEP_HEADS = (1, HEADS)
HEAD_DIM_SWEEP_LENGTHS = (65, 1024)


def head_dim_sweep(torch):
    """flash_attention and its autograd backward at head dims 48, 80 and
    96 (zero-padded to 64 and 128 by the wrapper) and 256, BH 1 and 16, S
    65 and 1024, causal and not, float32 and bfloat16, against the plain
    versions at the real D: f32 within KERNEL_ATOL max(1, max|ref|),
    bf16 under the three bf16 limits. A head dim above 256 must raise
    ValueError naming ROADMAP B7. Each case is fatal on failure. Returns
    the largest errors, {"f32": {...}, "bf16": {...}} by kernel."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    worst = {dt: {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
             for dt in ("f32", "bf16")}
    n = 0
    t0 = time.perf_counter()
    for d in HEAD_DIM_SWEEP_DIMS:
        for bh in HEAD_DIM_SWEEP_HEADS:
            for s in HEAD_DIM_SWEEP_LENGTHS:
                for causal in (True, False):
                    for dtype in (torch.float32, torch.bfloat16):
                        q, k, v, do = (torch.randn(
                            (1, bh, s, d), generator=gen, device=dev).to(dtype)
                            for _ in range(4))
                        leaves = [t.clone().requires_grad_(True)
                                  for t in (q, k, v)]
                        o = fa.flash_attention(*leaves, causal=causal)
                        dq, dk, dv = torch.autograd.grad(o, leaves, do)
                        scale = d ** -0.5
                        q3, k3, v3, do3 = (t[0] for t in (q, k, v, do))
                        o_r, lse_r = fa.flash_attention_reference(
                            q3, k3, v3, scale, causal)
                        refs = fa.flash_attention_backward_reference(
                            q3, k3, v3, o[0].detach(), lse_r, do3, scale,
                            causal)
                        torch.cuda.synchronize()
                        case = "d=%d bh=%d s=%d causal=%s %s" % (
                            d, bh, s, causal, str(dtype).split(".")[-1])
                        outs = (("o", o[0].detach(), o_r), ("dq", dq[0], refs[0]),
                                ("dk", dk[0], refs[1]), ("dv", dv[0], refs[2]))
                        if dtype == torch.float32:
                            errs = {nm: ((got - want).abs().max().item(),
                                         KERNEL_ATOL * max(
                                             1.0, want.abs().max().item()))
                                    for nm, got, want in outs}
                            log("  head-dim sweep %s: %s" % (case, "; ".join(
                                "%s %.3g (limit %.3g)" % (nm, e, lim)
                                for nm, (e, lim) in errs.items())))
                            bad = [nm for nm, (e, lim) in errs.items()
                                   if e > lim]
                            err = {nm: e for nm, (e, _) in errs.items()}
                        else:
                            res = {nm: bf16_compare(got, want)
                                   for nm, got, want in outs}
                            log("  head-dim sweep %s: %s" % (case, "; ".join(
                                "%s max %.3g/%.3g norm %.2e elem %.3f" % (
                                    nm, r["err"], r["top"], r["rel"],
                                    r["over"]) for nm, r in res.items())))
                            bad = [nm for nm, r in res.items() if not r["ok"]]
                            err = {nm: r["err"] for nm, r in res.items()}
                        check(not bad, "head-dim sweep %s: %s disagree with "
                              "the plain versions at the real head dim"
                              % (case, bad))
                        w = worst["f32" if dtype == torch.float32 else "bf16"]
                        w["fwd"] = max(w["fwd"], err["o"])
                        w["dq"] = max(w["dq"], err["dq"])
                        w["dkv"] = max(w["dkv"], err["dk"], err["dv"])
                        n += 1
                        del q, k, v, do, leaves, o, dq, dk, dv, o_r, lse_r
                        del refs, q3, k3, v3, do3
    big = torch.zeros((1, 1, 8, 320), device=dev)
    try:
        fa.flash_attention(big, big, big)
    except ValueError as exc:
        check("B7" in str(exc), "D 320 raised without naming ROADMAP B7: "
              "%s" % exc)
        log("head-dim sweep: D 320 raises ValueError: %s" % exc)
    else:
        raise SmokeFailure("flash_attention took head dim 320")
    log("head-dim sweep: %d cases through flash_attention and autograd at D "
        "%s in %.1f s" % (n, HEAD_DIM_SWEEP_DIMS, time.perf_counter() - t0))
    gc.collect()
    torch.cuda.empty_cache()
    return worst


def d256_timing(torch):
    """The six D 256 instances (forward, dQ, dK/dV in float32 on 3xTF32
    and in bfloat16 on mma.sync) timed at BH 16, S 1024, causal, as
    window medians and kernel time, beside their bounds. Returns
    {"f32": {what: ms}, "bf16": {what: ms}} of kernel times."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    bh, s, d = HEADS, MAX_SEQ, 256
    scale = d ** -0.5
    out = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        q, k, v, do = (torch.randn((bh, s, d), generator=gen,
                                   device=dev).to(dtype) for _ in range(4))
        o, lse = fa.flash_attention_fwd(q, k, v, scale, True)
        delta = (do.float() * o.float()).sum(-1)
        calls = {
            "fwd": lambda: fa.flash_attention_fwd(q, k, v, scale, True),
            "dq": lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                    scale, True),
            "dkv": lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse,
                                                      delta, scale, True)}
        out[tag] = {}
        for what, fn in calls.items():
            t = timing(torch, fn)
            dev_ms = kernel_ms(torch, fn)
            if tag == "f32":
                bound_ms, bound_by, _, flops, _ = f32_attention_bounds(
                    what, bh, s, s, d, True)
            else:
                bound_ms, bound_by, flops, _ = attention_bound(
                    what, bh, s, s, d, True, 2)
            log("d256 %s %s bh=%d s=%d causal (%s): %s, kernel time %.4f ms "
                "= %.1f TFLOP/s; bound_ms=%.4f (%s)" % (
                    what, tag, bh, s, "3xTF32 mma.sync" if tag == "f32"
                    else "mma.sync", spread(t), dev_ms,
                    flops / dev_ms / 1e9, bound_ms, bound_by))
            out[tag][what] = dev_ms
        del q, k, v, do, o, lse, delta
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_kernel_phase(torch, kernels):
    """K1 (bf16 input), K2 and K3 against their plain versions at the
    training step's attention shape (batch 8 x 16 heads, S 1024, D 128,
    causal) in bf16 and f32, a ragged length and a non-causal case; the
    edge sweep of the bf16 kernels (K1 bf16, K2, K3); the head-dim sweep
    through flash_attention; then each kernel timed at that shape beside
    its plain version, scaled_dot_product_attention and its bound (the
    bf16 kernels, then K2 f32 and K3 f32), and the D 256 instances."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import flash_attention as fa
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    bh, d = TRAIN_BATCH * HEADS, D_MODEL // HEADS
    scale = d ** -0.5
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    f32_worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}

    def draw(s, dtype):
        return [torch.randn((bh, s, d), generator=gen, device=dev).to(dtype)
                for _ in range(4)]

    for s, causal, dtype in ((MAX_SEQ, True, torch.bfloat16),
                             (MAX_SEQ, True, torch.float32),
                             (MAX_SEQ - 24, True, torch.bfloat16),
                             (MAX_SEQ, False, torch.bfloat16)):
        q, k, v, do = draw(s, dtype)
        o, lse = fa.flash_attention_fwd(q, k, v, scale, causal)
        delta = (do.float() * o.float()).sum(-1)
        dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale,
                                       causal)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale,
                                            causal)
        o_r, lse_r = fa.flash_attention_reference(q, k, v, scale, causal)
        refs = fa.flash_attention_backward_reference(q, k, v, o, lse, do,
                                                     scale, causal)
        torch.cuda.synchronize()
        bf16 = dtype == torch.bfloat16
        errs, bad = {}, []
        for name, got, want in (("o", o, o_r), ("dq", dq, refs[0]),
                                ("dk", dk, refs[1]), ("dv", dv, refs[2])):
            if not bf16:
                err = (got - want).abs().max().item()
                errs[name] = err
                if err > KERNEL_ATOL * max(1.0, want.abs().max().item()):
                    bad.append("%s max %g" % (name, err))
                continue
            r = bf16_compare(got, want)
            errs[name] = r["err"]
            log("  %s bf16 s=%d causal=%s: max_abs_err %.4g of max|ref| "
                "%.4g (limit %.4g); ||err||/||ref|| %.4g (limit %g); "
                "element excess %.4g rms(ref) (limit %g) at |ref| %.4g "
                "|err| %.4g; rms(ref) %.4g" % (
                    name, s, causal, r["err"], r["top"],
                    BF16_MAX_RTOL * r["top"], r["rel"], BF16_NORM_RTOL,
                    r["over"], BF16_ELEM_RMS, r["at_ref"], r["at_err"],
                    r["rms"]))
            if not r["ok"]:
                bad.append("%s max %g norm %g element %g" % (
                    name, r["err"], r["rel"], r["over"]))
        check(not bad, "kernel outputs disagree with their plain versions at "
              "s=%d causal=%s %s: %s" % (s, causal, dtype, "; ".join(bad)))
        lse_err = (lse - lse_r).abs().max().item()
        check(lse_err <= KERNEL_ATOL * max(1.0, lse_r.abs().max().item()),
              "lse disagrees at s=%d causal=%s %s: %g" % (s, causal, dtype,
                                                         lse_err))
        log("train kernels bh=%d s=%d d=%d causal=%s %s: max_abs_err o %.3g "
            "lse %.3g dq %.3g dk %.3g dv %.3g" % (
                bh, s, d, causal, str(dtype).split(".")[-1], errs["o"],
                lse_err, errs["dq"], errs["dk"], errs["dv"]))
        w = worst if bf16 else f32_worst
        w["fwd"] = max(w["fwd"], errs["o"], lse_err)
        w["dq"] = max(w["dq"], errs["dq"])
        w["dkv"] = max(w["dkv"], errs["dk"], errs["dv"])
        del q, k, v, do, o, lse, delta, dq, dk, dv, o_r, lse_r, refs

    swept = edge_sweep(torch)
    dims = head_dim_sweep(torch)
    for what in worst:
        worst[what] = max(worst[what], swept[what], dims["bf16"][what])
        f32_worst[what] = max(f32_worst[what], dims["f32"][what])

    # times at the training shape, bf16, causal
    s = MAX_SEQ
    q, k, v, do = draw(s, torch.bfloat16)
    o, lse = fa.flash_attention_fwd(q, k, v, scale, True)
    delta = (do.float() * o.float()).sum(-1)
    kernel_calls = {
        "fwd": lambda: fa.flash_attention_fwd(q, k, v, scale, True),
        "dq": lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                scale, True),
        "dkv": lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                  scale, True),
    }
    t = {w: timing(torch, fn) for w, fn in kernel_calls.items()}
    plain_fwd = time_ms(torch, lambda: fa.flash_attention_reference(
        q, k, v, scale, True), iters=5)
    plain_bwd = time_ms(torch, lambda: fa.flash_attention_backward_reference(
        q, k, v, o, lse, do, scale, True), iters=5)
    shape4 = (TRAIN_BATCH, HEADS, s, d)
    q4, k4, v4 = (t_.view(shape4).detach().requires_grad_(True)
                  for t_ in (q, k, v))
    out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                          scale=scale)
    do4 = do.view(shape4)
    calls = {
        "fwd": lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, scale=scale),
        "bwd": lambda: torch.autograd.grad(out4, (q4, k4, v4), do4,
                                           retain_graph=True)}
    # ms and library_ms are both window medians (CUDA events); the
    # library's windows may time the host (autograd's backward), so both
    # sides also get their kernels' own durations (device_ms and
    # library_device_ms, from the profiler), which rank them
    lib = {w: dict(timing(torch, fn), device_ms=kernel_ms(torch, fn))
           for w, fn in calls.items()}
    for w in t:
        t[w]["device_ms"] = kernel_ms(torch, kernel_calls[w])
    plain = {"fwd": plain_fwd, "dq": plain_bwd, "dkv": plain_bwd}
    library = {"fwd": lib["fwd"], "dq": lib["bwd"], "dkv": lib["bwd"]}
    meta = {
        "fwd": ("flash_attention_fwd_bf16", "flash_attention_fwd.cu", 45,
                "_fa_kernel", "wgmma + TMA"),
        "dq": ("flash_attention_bwd_dq", "flash_attention_bwd.cu", 136,
               "_fa_bwd_dq_kernel", "wgmma + TMA"),
        "dkv": ("flash_attention_bwd_dkv", "flash_attention_bwd.cu", 186,
                "_fa_bwd_dkv_kernel", "wgmma + TMA"),
    }
    for what, (name, source, line, tpu, design) in meta.items():
        bound_ms, bound_by, flops, nbytes = attention_bound(
            what, bh, s, s, d, True, 2)
        ms = t[what]["ms"]
        lib_ms = library[what]["device_ms"]   # the library's kernel time
        log("%s bh=%d s=%d d=%d causal bf16 (%s): kernel %s, kernel time "
            "%.4f ms = %.1f TFLOP/s, %.1f%% of the bound; plain_ms=%.4f%s; "
            "library (sdpa %s) %s, kernel time %.4f ms; bound_ms=%.4f (%s: "
            "%.1f GFLOP at 989 TFLOP/s bf16 = %.4f ms, %.1f MB at 3.35 TB/s "
            "= %.4f ms)" % (
                name, bh, s, d, design, spread(t[what]),
                t[what]["device_ms"], flops / ms / 1e9, 100 * bound_ms / ms,
                plain[what],
                "" if what == "fwd" else " (plain backward, dQ dK dV)",
                "forward" if what == "fwd" else "backward, dQ dK dV",
                spread(library[what]), lib_ms, bound_ms, bound_by,
                flops / 1e9, flops / PEAK_BF16_FLOPS * 1e3, nbytes / 1e6,
                nbytes / PEAK_BYTES_PER_S * 1e3))
        kernels[name] = {
            "name": name, "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/" + source,
            "replaces": "mxnet_tpu/ops/pallas/flash_attention.py:%d" % line,
            "tpu_kernel": "ops/pallas/flash_attention.py:" + tpu,
            "design": design,
            "max_abs_err": worst[what], "ms": ms,
            "ms_spread": [t[what]["lo"], t[what]["hi"]],
            "device_ms": t[what]["device_ms"],
            "host_us": t[what]["host_us"],
            "host_bound": t[what]["host_bound"],
            "tflops": flops / ms / 1e9, "bound_share": bound_ms / ms,
            "plain_ms": plain[what], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library[what]["ms"],
            "library_spread": [library[what]["lo"], library[what]["hi"]],
            "library_device_ms": lib_ms,
            "library_host_us": library[what]["host_us"],
            "library_host_bound": library[what]["host_bound"]}
        if name in BUILD_REPORT:
            kernels[name]["build"] = BUILD_REPORT[name]
    del q, k, v, do, o, lse, delta, q4, k4, v4, out4, do4
    gc.collect()
    torch.cuda.empty_cache()

    # K2 f32 and K3 f32 (3xTF32 on mma.sync) at the same shape in float32
    ft = f32_backward_timing(torch)
    d256 = d256_timing(torch)
    kernels["flash_attention_fwd"]["max_abs_err"] = max(
        kernels["flash_attention_fwd"]["max_abs_err"], f32_worst["fwd"])
    kernels["flash_attention_fwd"]["d256_device_ms"] = d256["f32"]["fwd"]
    kernels["flash_attention_fwd_bf16"]["d256_device_ms"] = d256["bf16"]["fwd"]
    lt = ft["library"]
    for what, line in (("dq", 136), ("dkv", 186)):
        name = "flash_attention_bwd_%s_f32" % what
        kt = ft[what]
        kernels["flash_attention_bwd_" + what]["d256_device_ms"] = \
            d256["bf16"][what]
        kernels[name].update({
            "name": name, "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": "mxnet_tpu/ops/pallas/flash_attention.py:%d" % line,
            "tpu_kernel": "ops/pallas/flash_attention.py:" + (
                "_fa_bwd_dq_kernel" if what == "dq" else
                "_fa_bwd_dkv_kernel"),
            "design": "3xTF32 on mma.sync",
            "max_abs_err": max(kernels[name]["max_abs_err"],
                               f32_worst[what]),
            "ms": kt["ms"], "ms_spread": [kt["lo"], kt["hi"]],
            "device_ms": kt["device_ms"], "host_us": kt["host_us"],
            "host_bound": kt["host_bound"],
            "tflops": kt["flops"] / kt["device_ms"] / 1e9,
            "bound_share": kt["bound_ms"] / kt["device_ms"],
            "plain_ms": ft["plain_ms"], "bound_ms": kt["bound_ms"],
            "bound_by": kt["bound_by"],
            "bound_peak": "3 x flops at 495 TFLOP/s TF32; bytes at 3.35 TB/s",
            "fma_bound_ms": kt["fma_ms"],
            "library_ms": lt["ms"], "library_spread": [lt["lo"], lt["hi"]],
            "library_device_ms": lt["device_ms"],
            "library_host_us": lt["host_us"],
            "library_host_bound": lt["host_bound"],
            "d256_device_ms": d256["f32"][what]})
        if name in BUILD_REPORT:
            kernels[name]["build"] = BUILD_REPORT[name]


def plain_train_loss(torch, p, x, y):
    """Mean cross-entropy of the zoo transformer's training graph on one
    batch, in plain float32 PyTorch (dense attention with its -1e9
    causal bias), written from the Symbol and independent of the port's
    Module, ops and kernels."""
    import torch.nn.functional as F
    n, t = x.shape
    d = D_MODEL // HEADS
    h = p["tok_embed_weight"][x.long()] + p["pos_embed_weight"][:t]
    bias = torch.triu(torch.full((t, t), -1e9, device=x.device), 1)
    for i in range(sum(k.endswith("_ln1_gamma") for k in p)):
        pf = "layer%d_" % i
        a = F.layer_norm(h, (D_MODEL,), p[pf + "ln1_gamma"],
                         p[pf + "ln1_beta"], 1e-5)
        qkv = F.linear(a, p[pf + "att_qkv_weight"], p[pf + "att_qkv_bias"])
        q, k, v = qkv.view(n, t, 3, HEADS, d).permute(2, 0, 3, 1, 4)
        att = torch.softmax(q @ k.transpose(-1, -2) * d ** -0.5 + bias, -1)
        ctx = (att @ v).transpose(1, 2).reshape(n, t, D_MODEL)
        del q, k, v, att, qkv
        h = h + F.linear(ctx, p[pf + "att_proj_weight"],
                         p[pf + "att_proj_bias"])
        a = F.layer_norm(h, (D_MODEL,), p[pf + "ln2_gamma"],
                         p[pf + "ln2_beta"], 1e-5)
        a = torch.relu(F.linear(a, p[pf + "ff1_weight"], p[pf + "ff1_bias"]))
        h = h + F.linear(a, p[pf + "ff2_weight"], p[pf + "ff2_bias"])
    h = F.layer_norm(h, (D_MODEL,), p["final_ln_gamma"], p["final_ln_beta"],
                     1e-5)
    logits = F.linear(h, p["lm_head_weight"], p["lm_head_bias"])
    return F.cross_entropy(logits.view(-1, VOCAB), y.view(-1).long())


def kernel_kind(name: str) -> str:
    """A coarse class of a CUDA kernel, by its name."""
    if "fa_fwd" in name or "fa_bwd" in name:
        return "attention kernels"
    low = name.lower()
    if any(w in low for w in ("gemm", "nvjet", "xmma", "cutlass")):
        return "matmul (cuBLAS)"
    if "reduce" in low:
        return "reductions"
    if "softmax" in low:
        return "softmax"
    if any(w in low for w in ("foreach", "multi_tensor")):
        return "optimizer (foreach)"
    if any(w in low for w in ("elementwise", "copy", "fill")):
        return "elementwise / copy"
    if any(w in low for w in ("index", "scatter", "gather", "embedding")):
        return "gather / scatter"
    return "other"


# the LM's Xavier(SEED) initial weights, drawn once a process and kept on
# the host: phases 6, 6 f32, 15b and 19c start from them (each drew the
# same values anew: ~11 s of numpy on the host a time). Keyed by widths.
LM_XAVIER = {}


def lm_xavier(torch, np):
    """``{name: host tensor}``: exactly what ``Module.init_params``
    draws with ``Xavier`` seeded by SEED on the LM at this width, drawn
    once (``initial_weights``) and then handed out again."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.models import transformer
    key = (VOCAB, LAYERS, D_MODEL, HEADS, D_FF, MAX_SEQ)
    if key not in LM_XAVIER:
        sym = transformer.get_symbol(VOCAB, LAYERS, D_MODEL, HEADS, D_FF,
                                     MAX_SEQ, attention="flash")
        args, _ = initial_weights(torch, np, sym, ((1, MAX_SEQ),) * 2,
                                  mt.init.Xavier().set_rng(
                                      np.random.default_rng(SEED)))
        LM_XAVIER.clear()
        LM_XAVIER[key] = {n: t.cpu() for n, t in args.items()}
        del args
        torch.cuda.empty_cache()
    return LM_XAVIER[key]


def train_lm(torch, np, counters, warm, timed):
    """Module on the zoo LM at bench.py's training configuration (batch
    8, T 1024, attention="flash", Xavier weights from numpy seed 0, SGD
    lr 0.01) on one fixed random batch, under whatever amp state the
    caller set: the first step (bind included) timed, ``warm`` steps,
    ``timed`` steps between CUDA events, then one step under
    torch.profiler. The kernel wrappers' ``counters`` are zeroed just
    before the first step and read after the last timed one. Returns the
    readings, the step-1 cross-entropy of an independent plain float32
    forward of the same initial weights among them."""
    from torch.profiler import ProfilerActivity, profile
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.models import transformer
    B, T = TRAIN_BATCH, MAX_SEQ
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sym = transformer.get_symbol(VOCAB, LAYERS, D_MODEL, HEADS, D_FF, T,
                                 attention="flash")
    mod = mt.mod.Module(sym, context=mt.gpu(0))
    mod.bind(data_shapes=[("data", (B, T))],
             label_shapes=[("softmax_label", (B, T))])
    mod.init_params(arg_params=lm_xavier(torch, np))
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": TRAIN_LR})
    torch.cuda.synchronize()
    bind_s = time.perf_counter() - t0
    # bench.py's batch: one fixed random batch, ids as float32
    rng = np.random.RandomState(0)
    x = rng.randint(0, VOCAB, (B, T)).astype(np.float32)
    y = rng.randint(0, VOCAB, (B, T)).astype(np.float32)
    dev = torch.device(DEVICE)
    db = mt.io.DataBatch(data=[mt.nd.array(x, ctx=dev)],
                         label=[mt.nd.array(y, ctx=dev)])
    y_flat = torch.from_numpy(y).to(dev).long().view(-1, 1)
    with torch.no_grad():
        params = {n: a.data for n, a in mod.get_params()[0].items()}
        want = plain_train_loss(torch, params, torch.from_numpy(x).to(dev),
                                torch.from_numpy(y).to(dev)).item()
        del params
    torch.cuda.empty_cache()

    def step():
        mod._fit_step(db)
        out = mod.get_outputs()[0].data
        # this step's cross-entropy, on the card: read after the run
        return -(out.gather(1, y_flat) + 1e-12).log().mean()

    # the main path: counters zeroed just before, read just after
    for fn in counters.values():
        fn.launches = {"f32": 0, "bf16": 0}
    t0 = time.perf_counter()
    losses = [step()]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    for _ in range(warm):
        losses.append(step())
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(timed):
        losses.append(step())
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / timed
    launches = {n: dict(fn.launches) for n, fn in counters.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rows, busy_ms = device_breakdown(torch, prof, wall, "train step")
    by_kind = {}
    for e in rows:
        kind = kernel_kind(e.key)
        by_kind[kind] = by_kind.get(kind, 0.0) + \
            e.self_device_time_total / 1e3
    log("train step device time by kind: " + ", ".join(
        "%s %.3f ms" % kv for kv in sorted(by_kind.items(),
                                           key=lambda kv: -kv[1])))
    attention = {e.key: (e.self_device_time_total / 1e3, e.count)
                 for e in rows if kernel_kind(e.key) == "attention kernels"}
    log("train step attention kernels: " + ", ".join(
        "%s %.3f ms in %d launches" % (name[:60], ms, n)
        for name, (ms, n) in sorted(attention.items(),
                                    key=lambda kv: -kv[1][0])))
    losses = [float(v) for v in torch.stack(losses).cpu()]
    torch.cuda.synchronize()
    del mod, db
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "want": want, "step_ms": step_ms,
            "bind_s": bind_s, "first_s": first_s, "timed": timed,
            "launches": launches,
            "peak_gb": peak_gb, "busy_ms": busy_ms,
            "att_ms": by_kind.get("attention kernels", 0.0),
            "by_kind": by_kind}


def check_training(what, run, dtype, peak_flops, peak_name, layers=None):
    """Log a training run's readings and hold it to the path: finite
    losses that fall, the step-1 cross-entropy within CE_TOL of the
    plain forward's, and each kernel launched once per layer per step
    with inputs of ``dtype`` ("f32" or "bf16") only. ``layers``: the
    LM's depth (LAYERS unless the run cut it)."""
    from mxnet_tpu_torch.models import transformer
    B, T = TRAIN_BATCH, MAX_SEQ
    layers = LAYERS if layers is None else layers
    losses, want, launches = run["losses"], run["want"], run["launches"]
    n_steps = len(losses)
    n_params = transformer.param_count(VOCAB, layers, D_MODEL, HEADS, D_FF,
                                       T)
    n_embed = VOCAB * D_MODEL + T * D_MODEL
    flops_per_tok = 6 * (n_params - n_embed) + 12 * layers * D_MODEL * T
    tok_s = B * T / (run["step_ms"] / 1e3)
    log("%s: bind %.3f s, first step %.3f s; step %.3f ms (%d steps between "
        "CUDA events) = %.1f tok/s; MFU %.4f of %.0f TFLOP/s %s (%.4g TFLOP "
        "per step by bench.py's accounting); peak memory %.3f GB; attention "
        "kernels %.3f ms of %.3f ms device time (%.1f%%)"
        % (what, run["bind_s"], run["first_s"], run["step_ms"], run["timed"],
           tok_s, tok_s * flops_per_tok / peak_flops, peak_flops / 1e12,
           peak_name, flops_per_tok * B * T / 1e12, run["peak_gb"],
           run["att_ms"], run["busy_ms"],
           100 * run["att_ms"] / max(run["busy_ms"], 1e-9)))
    log("%s: loss per step %s" % (what, " ".join("%.6f" % v for v in losses)))
    log("%s: step-1 cross-entropy %.6f, plain f32 forward %.6f (|diff| %.3g, "
        "tolerance %g); launches %s over %d steps x %d layers"
        % (what, losses[0], want, abs(losses[0] - want), CE_TOL, launches,
           n_steps, layers))
    check(all(math.isfinite(v) for v in losses), "%s: non-finite loss %s"
          % (what, losses))
    check(losses[-1] < losses[0], "%s: loss did not fall: %s"
          % (what, losses))
    check(abs(losses[0] - want) <= CE_TOL, "%s: step-1 loss %g vs plain "
          "forward %g" % (what, losses[0], want))
    other = "bf16" if dtype == "f32" else "f32"
    for name, n in launches.items():
        check(n[dtype] == n_steps * layers and n[other] == 0,
              "%s: kernel %s launched %s times in %d steps x %d layers (%s "
              "only expected)" % (what, name, n, n_steps, layers, dtype))


def train_phase(torch, np, kernels):
    """Training in amp bf16: the bf16 forward, dQ and dK/dV kernels.
    Returns the run's readings (phase 11 sets its Adam step beside
    them)."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import flash_attention as fa
    counters = {"flash_attention_fwd_bf16": fa.flash_attention_fwd,
                "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
                "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv}
    mt.amp.init("bfloat16")
    try:
        run = train_lm(torch, np, counters, TRAIN_WARM, TRAIN_TIMED)
    finally:
        mt.amp.off()
    # amp bf16 reaches attention: the bf16 kernels ran, the f32 ones not
    check_training("train", run, "bf16", PEAK_BF16_FLOPS, "bf16")
    for name, n in run["launches"].items():
        kernels[name]["launches"] = n["bf16"]
    return run


def train_f32_phase(torch, np, kernels):
    """Training with amp off (the reference's default): the f32 forward,
    dQ and dK/dV kernels (3xTF32), cuBLAS in full float32 (TF32 off, as
    card_phase set it)."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    counters = {"flash_attention_fwd": fa.flash_attention_fwd,
                "flash_attention_bwd_dq_f32": fa.flash_attention_bwd_dq,
                "flash_attention_bwd_dkv_f32": fa.flash_attention_bwd_dkv}
    check(not torch.backends.cuda.matmul.allow_tf32,
          "cuBLAS may use TF32: the f32 step would not be float32")
    run = train_lm(torch, np, counters, TRAIN_F32_WARM, TRAIN_F32_TIMED)
    check_training("train f32", run, "f32", PEAK_FP32_FLOPS, "f32")
    kernels["flash_attention_fwd"]["train_f32_launches"] = \
        run["launches"]["flash_attention_fwd"]["f32"]
    for name in ("flash_attention_bwd_dq_f32", "flash_attention_bwd_dkv_f32"):
        kernels[name]["launches"] = run["launches"][name]["f32"]
    kernels["flash_attention_fwd"]["train_f32_step_ms"] = run["step_ms"]


def rtc_kernels():
    """The five user kernels at the main path's shapes."""
    from mxnet_tpu_torch import rtc_examples as ex
    rows = TRAIN_BATCH * MAX_SEQ
    return {
        "scale_add": ex.scale_add((rows, D_MODEL)),
        "relu": ex.relu((rows, D_FF)),
        "split": ex.split((rows, D_MODEL)),
        "softmax_rows": ex.softmax_rows(rows, VOCAB),
        "softmax_ce_grad": ex.softmax_ce_grad(rows, VOCAB),
    }


def rtc_check_and_time(torch, kerns):
    """Each kernel against its plain version on the same inputs, then
    timed beside it, one library call and its bound (the bytes of each
    input read once and each output written once, or its operations at
    the f32 peak). These launches are not the counted path."""
    import torch.nn.functional as F
    from mxnet_tpu_torch import rtc_examples as ex
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    rows = TRAIN_BATCH * MAX_SEQ

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    h, a = randn(rows, D_MODEL), randn(rows, D_MODEL)
    act = randn(rows, D_FF)
    logits = randn(rows, VOCAB)
    p = ex.softmax_rows_plain(logits)
    labels = torch.randint(0, VOCAB, (rows,), generator=gen,
                           device=dev).float()
    cases = {
        # name: (inputs, plain, library call, its description, flop/elem)
        "scale_add": ((h, a), ex.scale_add_plain,
                      lambda: torch.add(a, h, alpha=2),
                      "torch.add(y, x, alpha=2)", 2),
        "relu": ((act,), ex.relu_plain, lambda: torch.relu(act),
                 "torch.relu", 1),
        "split": ((h,), ex.split_plain,
                  lambda: (torch.mul(h, 2), torch.add(h, 1)),
                  "torch.mul + torch.add (two calls)", 2),
        "softmax_rows": ((logits,), ex.softmax_rows_plain,
                         lambda: torch.softmax(logits, dim=1),
                         "torch.softmax(dim=1)", 5),
        "softmax_ce_grad": ((p, labels), ex.softmax_ce_grad_plain,
                            lambda: p - F.one_hot(labels.long(), VOCAB),
                            "p - F.one_hot (two calls)", 1),
    }
    table = {}
    for name, (ins, plain, library, lib_desc, flop_per) in cases.items():
        kern = kerns[name]
        got = kern.run(ins)
        want = plain(*ins)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        top = max(w.abs().max().item() for w in want)
        rtol = RTC_SOFTMAX_RTOL if name == "softmax_rows" else RTC_EXACT_RTOL
        log("rtc %s %s: max_abs_err %.4g of max|ref| %.4g (limit %.3g)"
            % (name, "x".join(map(str, ins[0].shape)), err, top, rtol * top))
        check(err <= rtol * top, "rtc kernel %s disagrees with its plain "
              "version: %g > %g" % (name, err, rtol * top))
        nbytes = sum(t.numel() * t.element_size() for t in ins + got)
        flops = flop_per * got[0].numel()
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS
        del got, want
        ms = time_ms(torch, lambda: kern.run(ins))
        plain_ms = time_ms(torch, lambda: plain(*ins))
        library_ms = time_ms(torch, library)
        bound_ms = max(t_bytes, t_ops) * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        log("rtc %s: kernel_ms=%.4f plain_ms=%.4f library_ms=%.4f (%s) "
            "bound_ms=%.4f (%s: %.1f MB at 3.35 TB/s; %.2f GFLOP at 67 "
            "TFLOP/s f32 = %.4f ms); %.0f GB/s, %.1f%% of the bound"
            % (name, ms, plain_ms, library_ms, lib_desc, bound_ms, bound_by,
               nbytes / 1e6, flops / 1e9, t_ops * 1e3, nbytes / ms / 1e6,
               100 * bound_ms / ms))
        table[name] = {
            "name": "rtc_" + name, "route": "cuda",
            "source": "mxnet_tpu_torch/rtc_examples.py",
            "replaces": "mxnet_tpu/rtc.py:96",
            "tpu_kernel": "rtc.py:PallasKernel._build",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "library": lib_desc}
    # a thread torch never used (a server's worker): the launch must make
    # torch's context current there first (_cuda_driver.make_current)
    box = {}
    worker = threading.Thread(target=lambda: box.update(
        out=kerns["scale_add"].run((h, a))))
    worker.start()
    worker.join()
    check("out" in box, "rtc scale_add failed on a new thread")
    log("rtc scale_add on a thread torch never used: max_abs_err %.3g"
        % rtc_equal("scale_add on a new thread", box["out"],
                    ex.scale_add_plain(h, a)))
    del h, a, act, logits, p, labels, box
    gc.collect()
    torch.cuda.empty_cache()
    return table


RTC_PAIRS = 10         # alternating kernel / library windows (ROADMAP B6f)
# ROADMAP B6f's first design for relu / scale_add, a second arm of
# ``--pairs-of CHECKOUT rtc`` beside the checkout's kernels: a loop over
# the blocks the card holds at once (its SMs x 8 blocks of 256 threads,
# which __launch_bounds__(256, 8) makes fit in 32 registers), four
# float4 loads in flight per thread before its stores (relu four of x,
# scale_add two of x and two of y), all loads and stores streaming
B6F_STREAM_SOURCE = r"""
#define UNROLL 4
#define UNROLL2 2
__device__ __forceinline__ float relu1(float v) { return v < 0.f ? 0.f : v; }
__device__ __forceinline__ float4 relu4(float4 a) {
  return make_float4(relu1(a.x), relu1(a.y), relu1(a.z), relu1(a.w));
}
__device__ __forceinline__ float4 scale_add4(float4 a, float4 b) {
  return make_float4(2.f * a.x + b.x, 2.f * a.y + b.y, 2.f * a.z + b.z,
                     2.f * a.w + b.w);
}
// n a multiple of 4, pointers 16-byte aligned (the pairs' inputs)
extern "C" __global__ void __launch_bounds__(256, 8)
relu_stream(const float* __restrict__ x, float* __restrict__ o,
            long long n) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* o4 = reinterpret_cast<float4*>(o);
  const long long n4 = n >> 2, stride = (long long)gridDim.x * blockDim.x;
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  for (; i + (UNROLL - 1) * stride < n4; i += UNROLL * stride) {
    float4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = __ldcs(x4 + i + u * stride);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) __stcs(o4 + i + u * stride, relu4(v[u]));
  }
  for (; i < n4; i += stride) __stcs(o4 + i, relu4(__ldcs(x4 + i)));
}
extern "C" __global__ void __launch_bounds__(256, 8)
scale_add_stream(const float* __restrict__ x, const float* __restrict__ y,
                 float* __restrict__ o, long long n) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* y4 = reinterpret_cast<const float4*>(y);
  float4* o4 = reinterpret_cast<float4*>(o);
  const long long n4 = n >> 2, stride = (long long)gridDim.x * blockDim.x;
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  for (; i + (UNROLL2 - 1) * stride < n4; i += UNROLL2 * stride) {
    float4 a[UNROLL2], b[UNROLL2];
#pragma unroll
    for (int u = 0; u < UNROLL2; ++u) {
      a[u] = __ldcs(x4 + i + u * stride);
      b[u] = __ldcs(y4 + i + u * stride);
    }
#pragma unroll
    for (int u = 0; u < UNROLL2; ++u)
      __stcs(o4 + i + u * stride, scale_add4(a[u], b[u]));
  }
  for (; i < n4; i += stride)
    __stcs(o4 + i, scale_add4(__ldcs(x4 + i), __ldcs(y4 + i)));
}
"""


def rtc_pairs(torch, kerns):
    """Each kernel of ``kerns`` (``relu`` at 8192 x 8192, ``scale_add``
    or ``split`` at 8192 x 2048, by its name up to a comma) against
    ``torch.relu`` / ``torch.add`` / ``torch.mul`` + ``torch.add`` in
    RTC_PAIRS rounds, each a window of 20 launches of
    every kernel of the op and then one of the library call, between
    CUDA events: the medians, each round's difference and its range.
    A kernel loses to the library call beyond the spread when every
    round's difference is positive. These launches are not the counted
    path."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    rows = TRAIN_BATCH * MAX_SEQ
    act = torch.randn((rows, D_FF), generator=gen, device=dev)
    h = torch.randn((rows, D_MODEL), generator=gen, device=dev)
    a = torch.randn((rows, D_MODEL), generator=gen, device=dev)
    ops = {"relu": ((act,), lambda: torch.relu(act), "torch.relu"),
           "scale_add": ((h, a), lambda: torch.add(a, h, alpha=2),
                         "torch.add(y, x, alpha=2)"),
           "split": ((h,), lambda: (torch.mul(h, 2), torch.add(h, 1)),
                     "torch.mul + torch.add")}
    out = {}
    for op, (ins, lib, lib_desc) in ops.items():
        arms = {name: kern for name, kern in kerns.items()
                if name.split(",")[0] == op}
        ks = {name: [] for name in arms}
        ls = []
        for _ in range(RTC_PAIRS):
            for name, kern in arms.items():
                ks[name].append(timing(torch, lambda: kern.run(ins),
                                       windows=1)["ms"])
            ls.append(timing(torch, lib, windows=1)["ms"])
        l_med = sorted(ls)[len(ls) // 2]
        for name, times in ks.items():
            diffs = sorted(k - v for k, v in zip(times, ls))
            k_med = sorted(times)[len(times) // 2]
            loses = diffs[0] > 0
            log("rtc pairs %s: kernel median %.4f ms (%.4f-%.4f), %s %.4f "
                "ms (%.4f-%.4f) over %d alternating windows of 20; kernel - "
                "library per pair: median %+.4f ms, range %+.4f..%+.4f; %s"
                % (name, k_med, min(times), max(times), lib_desc, l_med,
                   min(ls), max(ls), RTC_PAIRS, diffs[len(diffs) // 2],
                   diffs[0], diffs[-1], "the kernel loses in every pair"
                   if loses else "within the pairs' spread or faster"))
            out[name] = {"ms": k_med, "library_ms": l_med,
                         "diff_ms": diffs[len(diffs) // 2],
                         "diff_lo": diffs[0], "diff_hi": diffs[-1],
                         "loses": loses}
    del act, h, a
    return out


def b6f_stream_kernels(torch):
    """:data:`B6F_STREAM_SOURCE`'s two kernels at the pairs' shapes, each
    first held to its plain version, with the compiler's report."""
    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch import rtc_examples as ex
    dev = torch.device(DEVICE)
    grid = (torch.cuda.get_device_properties(dev).multi_processor_count
            * 8,)
    rows = TRAIN_BATCH * MAX_SEQ
    kerns = {}
    for op, width, sig, plain in (
            ("relu", D_FF, "const float* x, float* o, long long n",
             ex.relu_plain),
            ("scale_add", D_MODEL,
             "const float* x, const float* y, float* o, long long n",
             ex.scale_add_plain)):
        shape = (rows, width)
        kern = rtc.UserKernel(
            B6F_STREAM_SOURCE, op + "_stream", sig,
            (shape, torch.float32), grid=grid, block=(256,),
            scalars=(rows * width,), plain=plain)
        ins = [torch.randn(shape, device=dev)
               for _ in range(2 if op == "scale_add" else 1)]
        rtc_equal(op + " (B6f streaming design)", kern.run(ins),
                  plain(*ins))
        kerns[op + ", B6f streaming design"] = kern
    log("B6f streaming design: grid %d x 256; %s" % (grid[0], " ".join(
        ln.strip() for ln in kern.kernel.module.build_log.splitlines()
        if "registers" in ln or "spill" in ln)))
    return kerns


def rtc_equal(name, got, want):
    err = (got - want).abs().max().item()
    top = want.abs().max().item()
    check(err <= RTC_EXACT_RTOL * top, "%s: max_abs_err %g > %g"
          % (name, err, RTC_EXACT_RTOL * top))
    return err


def rtc_paths(torch, kerns):
    """The counted path's first part: each kernel through the entry
    points a user calls, each result held against its plain version."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import rtc_examples as ex
    dev = torch.device(DEVICE)
    rng = torch.Generator(device=dev).manual_seed(SEED + 4)
    rows = TRAIN_BATCH * MAX_SEQ
    x = torch.randn((rows, D_MODEL), generator=rng, device=dev)
    y = torch.randn((rows, D_MODEL), generator=rng, device=dev)
    act = torch.randn((rows, D_FF), generator=rng, device=dev)
    errs = {}
    out = kerns["scale_add"](mt.nd.NDArray(x), mt.nd.NDArray(y))
    errs["scale_add UserKernel()"] = rtc_equal(
        "scale_add", out.data, ex.scale_add_plain(x, y))
    want = ex.relu_plain(act)
    out = mt.nd.smoke_rtc_relu(mt.nd.array(act, ctx=dev))
    errs["relu nd"] = rtc_equal("relu via nd", out.data, want)
    s = mt.sym.smoke_rtc_relu(mt.sym.Variable("data"))
    exe = s.simple_bind(ctx=dev, grad_req="null", data=(rows, D_FF))
    exe.arg_dict["data"][:] = act
    errs["relu sym"] = rtc_equal("relu via sym", exe.forward()[0].data,
                                 want)
    del exe, out, want
    wa, wb = ex.split_plain(x)
    a, b = mt.nd.smoke_rtc_split(mt.nd.NDArray(x))
    errs["split nd"] = max(rtc_equal("split[0] via nd", a.data, wa),
                           rtc_equal("split[1] via nd", b.data, wb))
    s = mt.sym.smoke_rtc_split(mt.sym.Variable("data"))
    check(len(s.list_outputs()) == 2, "split symbol lists %s"
          % s.list_outputs())
    exe = s.simple_bind(ctx=dev, grad_req="null", data=(rows, D_MODEL))
    exe.arg_dict["data"][:] = x
    outs = exe.forward()
    check(len(outs) == 2, "split executor returned %d outputs" % len(outs))
    errs["split sym"] = max(rtc_equal("split[0] via sym", outs[0].data, wa),
                            rtc_equal("split[1] via sym", outs[1].data, wb))
    torch.cuda.synchronize()
    log("rtc paths: max_abs_err %s; split symbol outputs %s"
        % (", ".join("%s %.3g" % kv for kv in errs.items()),
           s.list_outputs()))
    del x, y, act, a, b, wa, wb, exe, outs


def rtc_train(torch, np, kerns):
    """The counted path's second part: the CustomOp head on the two row
    kernels under a 32000-wide FullyConnected, trained by Module for
    13 steps. The launch counters are read after the 13th step; two more
    steps then run under the profiler, the second traced. Returns the
    readings."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    import mxnet_tpu_torch as mt
    rows = TRAIN_BATCH * MAX_SEQ
    dev = torch.device(DEVICE)
    data, label = mt.sym.Variable("data"), mt.sym.Variable("label")
    head = mt.sym.FullyConnected(data, num_hidden=VOCAB, name="head")
    net = mt.sym.Custom(head, label, op_type="smoke_rtc_softmax_loss",
                        name="loss")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mod = mt.mod.Module(net, context=dev, data_names=["data"],
                        label_names=["label"])
    mod.bind(data_shapes=[("data", (rows, D_MODEL))],
             label_shapes=[("label", (rows,))])
    mod.init_params(mt.init.Xavier().set_rng(np.random.default_rng(SEED)))
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": TRAIN_LR})
    torch.cuda.synchronize()
    bind_s = time.perf_counter() - t0
    rng = np.random.RandomState(0)
    x = rng.randn(rows, D_MODEL).astype(np.float32)
    y = rng.randint(0, VOCAB, rows).astype(np.float32)
    db = mt.io.DataBatch(data=[mt.nd.array(x, ctx=dev)],
                         label=[mt.nd.array(y, ctx=dev)])
    y_idx = torch.from_numpy(y).to(dev).long().view(-1, 1)
    with torch.no_grad():
        params = {n: a.data for n, a in mod.get_params()[0].items()}
        logits = F.linear(torch.from_numpy(x).to(dev), params["head_weight"],
                          params["head_bias"])
        want = F.cross_entropy(logits, y_idx.view(-1)).item()
        del params, logits

    def step():
        mod._fit_step(db)
        p = mod.get_outputs()[0].data
        return -(p.gather(1, y_idx) + 1e-12).log().mean()

    t0 = time.perf_counter()
    losses = [step()]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    for _ in range(RTC_STEPS_WARM - 1):
        losses.append(step())
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(RTC_STEPS_TIMED):
        losses.append(step())
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / RTC_STEPS_TIMED
    launches = {name: kern.launches for name, kern in kerns.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # a warm-up step under the profiler first: traced alone, the step
    # lost its first ~20 ms of device activity (one of its two GEMMs),
    # which the step's CUDA events counted
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                                  repeat=1)) as prof:
        step()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof.step()
    device_breakdown(torch, prof, wall, "rtc head step")
    return {"losses": [float(v) for v in torch.stack(losses).cpu()],
            "want": want, "step_ms": step_ms, "bind_s": bind_s,
            "first_s": first_s, "launches": launches, "peak_gb": peak_gb}


def rtc_phase(torch, np, kernels):
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import rtc_examples as ex
    gc.collect()
    torch.cuda.empty_cache()
    kerns = rtc_kernels()
    kerns["relu"].register("smoke_rtc_relu")
    kerns["split"].register("smoke_rtc_split")
    mt.operator.register("smoke_rtc_softmax_loss")(ex.softmax_loss_prop(
        kerns["softmax_rows"], kerns["softmax_ce_grad"]))
    table = rtc_check_and_time(torch, kerns)
    for name, pair in rtc_pairs(torch, {k: kerns[k] for k in (
            "relu", "scale_add", "split")}).items():
        table[name].update(pair_ms=pair["ms"],
                           pair_library_ms=pair["library_ms"],
                           pair_diff_ms=[pair["diff_lo"], pair["diff_hi"]])

    # the main path: counters zeroed just before, read just after
    for kern in kerns.values():
        kern.launches = 0
    rtc_paths(torch, kerns)
    run = rtc_train(torch, np, kerns)
    gc.collect()
    torch.cuda.empty_cache()
    losses, want, launches = run["losses"], run["want"], run["launches"]
    n_steps = len(losses)
    rows = TRAIN_BATCH * MAX_SEQ
    # the forward and the weight-gradient GEMMs: the data takes no
    # gradient (Module binds its inputs with grad_req "null")
    flops = 4.0 * rows * D_MODEL * VOCAB
    log("rtc train: head FullyConnected(%d) + CustomOp on softmax_rows / "
        "softmax_ce_grad, batch (%d, %d) f32: bind %.3f s, first step %.3f "
        "s, step %.3f ms (%d steps between CUDA events; %.1f TFLOP/s of "
        "the head's two f32 GEMMs, %.4g TFLOP); peak memory %.3f GB"
        % (VOCAB, rows, D_MODEL, run["bind_s"], run["first_s"],
           run["step_ms"], RTC_STEPS_TIMED,
           flops / (run["step_ms"] / 1e3) / 1e12, flops / 1e12,
           run["peak_gb"]))
    log("rtc train: loss per step %s" % " ".join("%.6f" % v for v in losses))
    log("rtc train: step-1 cross-entropy %.6f, plain f32 forward %.6f "
        "(|diff| %.3g, tolerance %g); launches %s over %d steps"
        % (losses[0], want, abs(losses[0] - want), CE_TOL, launches,
           n_steps))
    check(all(math.isfinite(v) for v in losses), "non-finite loss %s"
          % losses)
    check(losses[-1] < losses[0], "rtc head loss did not fall: %s" % losses)
    check(abs(losses[0] - want) <= CE_TOL, "rtc head step-1 loss %g vs "
          "plain forward %g" % (losses[0], want))
    # scale_add once through UserKernel(); relu and split once through
    # nd and once through sym; the head's two kernels once per step
    expected = {"scale_add": 1, "relu": 2, "split": 2,
                "softmax_rows": n_steps, "softmax_ce_grad": n_steps}
    check(launches == expected, "rtc launches %s, the path implies %s"
          % (launches, expected))
    for name, entry in table.items():
        entry["launches"] = launches[name]
        kernels[entry["name"]] = entry


def resnet_units(layers):
    """Units per stage and whether they are bottlenecks, as the zoo's
    imagenet ResNet builds them (50 layers on the card, 18 in the CPU
    rehearsal)."""
    return {18: ([2, 2, 2, 2], False), 50: ([3, 4, 6, 3], True)}[layers]


def plain_resnet(torch, p, x, y):
    """The zoo's ResNet v2 training forward (imagenet stem) in plain
    float32 torch.nn.functional, written from models/resnet.py and
    independent of the port's ops and Module: the 7x7/2 stem convolves
    ``conv0_weight`` directly (the port runs its s2d rewrite), and every
    BatchNorm normalises with the batch statistics (biased variance).
    Returns the mean cross-entropy and each BatchNorm's (mean, var)."""
    import torch.nn.functional as F
    stats = {}

    def bn(h, name, fix_gamma=False):
        var, mean = torch.var_mean(h, dim=(0, 2, 3), unbiased=False)
        stats[name] = (mean, var)
        g = torch.ones_like(mean) if fix_gamma else p[name + "_gamma"]
        scale = (g * torch.rsqrt(var + RESNET_EPS)).view(1, -1, 1, 1)
        return (h - mean.view(1, -1, 1, 1)) * scale + \
            p[name + "_beta"].view(1, -1, 1, 1)

    def conv(h, name, stride=1, pad=0):
        return F.conv2d(h, p[name + "_weight"], stride=stride, padding=pad)

    units, bottleneck = resnet_units(RESNET_LAYERS)
    h = bn(x, "bn_data", fix_gamma=True)
    h = conv(h, "conv0", 2, 3)
    h = F.max_pool2d(torch.relu(bn(h, "bn0")), 3, 2, 1)
    for i, n in enumerate(units):
        for j in range(n):
            name = "stage%d_unit%d" % (i + 1, j + 1)
            stride = 2 if i > 0 and j == 0 else 1
            act = torch.relu(bn(h, name + "_bn1"))
            if bottleneck:
                b = torch.relu(bn(conv(act, name + "_conv1"), name + "_bn2"))
                b = torch.relu(bn(conv(b, name + "_conv2", stride, 1),
                                  name + "_bn3"))
                b = conv(b, name + "_conv3")
            else:
                b = torch.relu(bn(conv(act, name + "_conv1", stride, 1),
                                  name + "_bn2"))
                b = conv(b, name + "_conv2", 1, 1)
            h = b + (h if j > 0 else conv(act, name + "_sc", stride))
    h = torch.relu(bn(h, "bn1")).mean(dim=(2, 3))
    logits = F.linear(h, p["fc1_weight"], p["fc1_bias"])
    return F.cross_entropy(logits, y.long()), stats


def resnet_kind(op: str) -> str:
    """The class of an operator's device time in the ResNet step, by the
    name of the (innermost) aten op that launched the kernels."""
    low = op.lower()
    if "convolution_backward" in low or "conv_backward" in low:
        return "conv backward"
    if "conv" in low:
        return "conv forward"
    if "batch_norm" in low:
        return "BatchNorm"
    if "pool" in low:
        return "pooling"
    if "_foreach" in low:
        return "optimizer"
    if any(w in low for w in ("::mm", "addmm", "matmul", "linear")):
        return "fc (cuBLAS)"
    return "elementwise"


def resnet_breakdown(torch, prof, wall, what, kind_of=resnet_kind):
    """Device time by kind (``kind_of``; for ResNet conv forward, conv
    backward, BatchNorm, elementwise, pooling, optimizer, fc): each
    kernel counted under the innermost aten op that launched it; and the
    idle share."""
    rows, busy_ms = device_breakdown(torch, prof, wall, what)
    by_kind = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CPU and \
                e.key.startswith("aten::") and e.self_device_time_total:
            kind = kind_of(e.key)
            by_kind[kind] = by_kind.get(kind, 0.0) + \
                e.self_device_time_total / 1e3
    unattributed = busy_ms - sum(by_kind.values())
    log("%s device time by kind: %s; not under an aten op %.3f ms"
        % (what, ", ".join("%s %.3f ms (%.1f%%)"
                           % (k, v, 100 * v / max(busy_ms, 1e-9))
                           for k, v in sorted(by_kind.items(),
                                              key=lambda kv: -kv[1])),
           unattributed))
    return by_kind, busy_ms


def train_resnet(torch, np, counters, warm, timed, what):
    """Module on the zoo's ResNet at bench.py's configuration, under
    whatever amp state the caller set, on one fixed RandomState(0)
    batch: the first step (bind included) timed, ``warm`` steps,
    ``timed`` steps between CUDA events, then one under torch.profiler.
    The flash-attention ``counters`` are zeroed just before the first
    step and read after the last timed one. Returns the readings, with
    the plain f32 forward's step-1 cross-entropy and batch statistics,
    the initial and the step-1 moving statistics."""
    from torch.profiler import ProfilerActivity, profile
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.models import resnet
    B, S = RESNET_BATCH, RESNET_IMAGE
    dev = torch.device(DEVICE)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sym = resnet.get_symbol(num_classes=RESNET_CLASSES,
                            num_layers=RESNET_LAYERS, stem="s2d",
                            image_shape="3,%d,%d" % (S, S))
    mod = mt.mod.Module(sym, context=mt.gpu(0))
    mod.bind(data_shapes=[("data", (B, 3, S, S))],
             label_shapes=[("softmax_label", (B,))])
    mod.init_params(mt.init.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2).set_rng(
                                       np.random.default_rng(SEED)))
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": RESNET_LR, "momentum": RESNET_MOMENTUM,
        "wd": RESNET_WD})
    torch.cuda.synchronize()
    bind_s = time.perf_counter() - t0
    args, aux = mod.get_params()
    n_args, n_aux = len(args), len(aux)
    aux0 = {n: a.data.clone() for n, a in aux.items()}
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (B, 3, S, S)).astype(np.float32)
    y = rng.randint(0, RESNET_CLASSES, (B,)).astype(np.float32)
    db = mt.io.DataBatch(data=[mt.nd.array(x, ctx=dev)],
                         label=[mt.nd.array(y, ctx=dev)])
    y_col = torch.from_numpy(y).to(dev).long().view(-1, 1)
    with torch.no_grad():
        ce, stats = plain_resnet(torch, {n: a.data for n, a in args.items()},
                                 torch.from_numpy(x).to(dev),
                                 torch.from_numpy(y).to(dev))
        want = ce.item()
        stats = {n: (m.double().cpu().numpy(), v.double().cpu().numpy())
                 for n, (m, v) in stats.items()}
    del args
    torch.cuda.empty_cache()

    def step():
        mod._fit_step(db)
        out = mod.get_outputs()[0].data
        return -(out.gather(1, y_col) + 1e-12).log().mean()

    # the main path: counters zeroed just before, read just after
    for fn in counters.values():
        fn.launches = {"f32": 0, "bf16": 0}
    t0 = time.perf_counter()
    losses = [step()]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    aux1 = {n: a.data.double().cpu().numpy()
            for n, a in mod.get_params()[1].items()}
    for _ in range(warm):
        losses.append(step())
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(timed):
        losses.append(step())
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / timed
    launches = {n: dict(fn.launches) for n, fn in counters.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    by_kind, busy_ms = resnet_breakdown(torch, prof, wall, what)
    losses = [float(v) for v in torch.stack(losses).cpu()]
    del mod, db
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "want": want, "stats": stats,
            "aux0": {n: a.double().cpu().numpy() for n, a in aux0.items()},
            "aux1": aux1, "n_args": n_args, "n_aux": n_aux,
            "step_ms": step_ms, "bind_s": bind_s, "first_s": first_s,
            "timed": timed, "launches": launches, "peak_gb": peak_gb,
            "busy_ms": busy_ms, "wall_ms": wall * 1e3, "by_kind": by_kind}


def check_resnet_stats(np, what, run, rtol):
    """The moving statistics committed by step 1 against the plain
    forward's batch statistics blended by the momentum, every channel
    of every BatchNorm: the mean within ``rtol`` of the batch's standard
    deviation, the variance within ``rtol`` of itself, each plus
    RESNET_STATS_ATOL."""
    m = RESNET_MOMENTUM
    worst, worst_rel, where = 0.0, 0.0, None
    for name, (mean, var) in run["stats"].items():
        implied = {}
        for stat in ("moving_mean", "moving_var"):
            key = "%s_%s" % (name, stat)
            check(key in run["aux1"], "%s: no aux state %s" % (what, key))
            implied[stat] = (run["aux1"][key] -
                             m * run["aux0"][key]) / (1 - m)
        for got, want, scale in ((implied["moving_mean"], mean,
                                  np.sqrt(var)),
                                 (implied["moving_var"], var, var)):
            err = np.abs(got - want)
            ratio = float((err / (rtol * scale + RESNET_STATS_ATOL)).max())
            if ratio > worst:
                worst, where = ratio, name
            worst_rel = max(worst_rel, float((err / (scale + 1e-12)).max()))
    log("%s: step-1 moving statistics of %d BatchNorms against the plain "
        "forward's batch statistics blended by momentum %g: largest error "
        "%.3g of the batch std / var; %.3g of the tolerance (rtol %g, atol "
        "%g; at %s)" % (what, len(run["stats"]), m, worst_rel, worst, rtol,
                        RESNET_STATS_ATOL, where))
    check(worst <= 1.0, "%s: moving statistics of %s off by %.3g of the "
          "tolerance (rtol %g of the batch std / var, atol %g)"
          % (what, where, worst, rtol, RESNET_STATS_ATOL))


def check_resnet(np, what, run, ce_tol, stats_rtol, peak_flops,
                 peak_name):
    """Log a ResNet run's readings and hold it to the path: finite
    losses that fall, the step-1 cross-entropy within ``ce_tol`` of the
    plain forward's, the moving statistics, the reference's parameter
    count, and no flash-attention launch."""
    losses, want = run["losses"], run["want"]
    img_s = RESNET_BATCH / (run["step_ms"] / 1e3)
    log("%s: ResNet-%d v2 s2d, batch %d, %dx%d: bind %.3f s, first step "
        "%.3f s; step %.3f ms (%d steps between CUDA events) = %.1f img/s; "
        "MFU %.4f of %.0f TFLOP/s %s (%.3f GFLOP per image by bench.py's "
        "accounting); peak memory %.3f GB; device busy %.3f of %.3f ms "
        "profiled (idle share %.3f); %d arg and %d aux arrays"
        % (what, RESNET_LAYERS, RESNET_BATCH, RESNET_IMAGE, RESNET_IMAGE,
           run["bind_s"], run["first_s"], run["step_ms"], run["timed"],
           img_s, img_s * RESNET_FLOPS_PER_IMG / peak_flops,
           peak_flops / 1e12, peak_name, RESNET_FLOPS_PER_IMG / 1e9,
           run["peak_gb"], run["busy_ms"], run["wall_ms"],
           1 - run["busy_ms"] / max(run["wall_ms"], 1e-9), run["n_args"],
           run["n_aux"]))
    log("%s: loss per step %s" % (what, " ".join("%.6f" % v for v in losses)))
    log("%s: step-1 cross-entropy %.6f, plain f32 forward (7x7 stem) %.6f "
        "(|diff| %.3g, tolerance %g); flash-attention launches %s"
        % (what, losses[0], want, abs(losses[0] - want), ce_tol,
           run["launches"]))
    check(all(math.isfinite(v) for v in losses), "%s: non-finite loss %s"
          % (what, losses))
    check(losses[-1] < losses[0], "%s: loss did not fall: %s"
          % (what, losses))
    check(abs(losses[0] - want) <= ce_tol, "%s: step-1 loss %g vs plain "
          "forward %g" % (what, losses[0], want))
    check_resnet_stats(np, what, run, stats_rtol)
    if RESNET_LAYERS == 50:
        check((run["n_args"], run["n_aux"]) == (157, 102),
              "%s: %d arg and %d aux arrays, the reference has 157 and 102"
              % (what, run["n_args"], run["n_aux"]))
    for name, n in run["launches"].items():
        check(n == {"f32": 0, "bf16": 0}, "%s: flash-attention kernel %s "
              "launched %s times in a ResNet step" % (what, name, n))


def resnet_phase(torch, np):
    """ResNet-50 through Module at bench.py's configuration: amp bf16,
    then amp off (the reference's default) with f32 convolutions in full
    float32 (TF32 off in cuDNN and cuBLAS)."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import flash_attention as fa
    counters = {"flash_attention_fwd": fa.flash_attention_fwd,
                "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
                "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv}
    check(not torch.backends.cudnn.allow_tf32 and
          not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is allowed: the plain forward would not be float32")
    mt.amp.init("bfloat16")
    try:
        run = train_resnet(torch, np, counters, RESNET_WARM, RESNET_TIMED,
                           "resnet")
    finally:
        mt.amp.off()
    check_resnet(np, "resnet", run, RESNET_CE_TOL, RESNET_STATS_RTOL,
                 PEAK_BF16_FLOPS, "bf16")
    run = train_resnet(torch, np, counters, RESNET_F32_WARM,
                       RESNET_F32_TIMED, "resnet f32")
    check_resnet(np, "resnet f32", run, RESNET_F32_CE_TOL,
                 RESNET_F32_STATS_RTOL, PEAK_FP32_FLOPS, "f32")


# ----------------------------------------------------- the Gluon slice

def tape_attention_check(torch, np):
    """The imperative tape drives the attention kernels: a HybridBlock
    calling ``F.FlashAttention(q, k, v, causal=True)`` at B 2, H 4, S
    512, D 128, under ``autograd.record()`` and ``backward()``, in bf16
    and f32. K1, K2 and K3 must each launch once per pass (in the input
    dtype), the output must match ``flash_attention_reference`` and the
    gradients ``flash_attention_backward_reference`` (bf16: the BF16_*
    limits; f32: KERNEL_ATOL max(1, max|ref|))."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.ops import flash_attention as fa
    counters = {"flash_attention_fwd": fa.flash_attention_fwd,
                "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
                "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv}

    class Attention(gluon.HybridBlock):
        def hybrid_forward(self, F, q, k, v):
            return F.FlashAttention(q, k, v, causal=True)

    block = Attention(prefix="tape_attention_")
    block.hybridize()
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    B, H, S, D = TAPE_ATTENTION_SHAPE
    for dtype, key in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        q, k, v, do = (torch.randn((B, H, S, D), generator=gen, device=dev)
                       .to(dtype) for _ in range(4))
        arrays = [mt.nd.NDArray(t.clone()) for t in (q, k, v)]
        for a in arrays:
            a.attach_grad()
        before = {n: dict(fn.launches) for n, fn in counters.items()}
        with autograd.record():
            out = block(*arrays)
        out.backward(mt.nd.NDArray(do))
        torch.cuda.synchronize()
        rose = {n: {s: fn.launches[s] - before[n][s] for s in fn.launches}
                for n, fn in counters.items()}
        want_rose = {s: int(s == key) for s in ("f32", "bf16")}
        check(all(r == want_rose for r in rose.values()),
              "tape attention %s: launches rose by %s, one of each kernel "
              "expected" % (key, rose))
        flat = [t.reshape(B * H, S, D) for t in (q, k, v, do)]
        scale = D ** -0.5
        o_r, lse_r = fa.flash_attention_reference(*flat[:3], scale, True)
        grads_r = fa.flash_attention_backward_reference(
            *flat[:3], o_r, lse_r, flat[3], scale, True)
        pairs = [("o", out.data, o_r)] + [
            (nm, a.grad.data, g) for nm, a, g in zip(("dq", "dk", "dv"),
                                                     arrays, grads_r)]
        for nm, got, want in pairs:
            got = got.reshape(want.shape)
            if key == "bf16":
                r = bf16_compare(got, want)
                log("tape attention bf16 %s: max err %.3g (max|ref| %.3g), "
                    "norm ratio %.3g, element excess %.3g rms"
                    % (nm, r["err"], r["top"], r["rel"], r["over"]))
                check(r["ok"], "tape attention bf16 %s disagrees with the "
                      "plain version: %s" % (nm, r))
            else:
                err = (got - want).abs().max().item()
                lim = KERNEL_ATOL * max(1.0, want.abs().max().item())
                log("tape attention f32 %s: max err %.3g (limit %.3g)"
                    % (nm, err, lim))
                check(err <= lim, "tape attention f32 %s: error %.3g over "
                      "%.3g" % (nm, err, lim))
        log("tape attention %s: B %d H %d S %d D %d causal under "
            "autograd.record(): launches %s" % (key, B, H, S, D, rose))
        del q, k, v, do, arrays, out, flat, o_r, lse_r, grads_r, pairs
    torch.cuda.empty_cache()


def deconvolution_check(torch, np):
    """``nn.Conv2DTranspose`` at a DCGAN generator's shape (batch 64,
    512 -> 256 channels, kernel 4, stride 2, pad 1, 8x8 -> 16x16), one
    forward and backward on the card (cuDNN, through ``Deconvolution``),
    against a plain f32 ``conv_transpose2d`` of the same weight with
    TF32 off: output and input / weight / bias gradients within
    DECONV_RTOL of each one's largest magnitude."""
    import torch.nn.functional as F
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import autograd, gluon
    dev = torch.device(DEVICE)
    N, CIN, COUT, HW = DECONV_SHAPE
    layer = gluon.nn.Conv2DTranspose(COUT, 4, strides=2, padding=1,
                                     in_channels=CIN, prefix="dcgan_g_")
    layer.initialize(mt.init.Normal(0.02).set_rng(
        np.random.default_rng(SEED + 12)), ctx=mt.gpu(0))
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    x, head = (torch.randn(s, generator=gen, device=dev)
               for s in ((N, CIN, HW, HW), (N, COUT, 2 * HW, 2 * HW)))
    xa = mt.nd.NDArray(x.clone())
    xa.attach_grad()
    with autograd.record():
        out = layer(xa)
    out.backward(mt.nd.NDArray(head))
    w = layer.weight.data().data.detach().clone().requires_grad_(True)
    b = layer.bias.data().data.detach().clone().requires_grad_(True)
    xr = x.clone().requires_grad_(True)
    ref = F.conv_transpose2d(xr, w, b, stride=2, padding=1)
    ref.backward(head)
    torch.cuda.synchronize()
    for nm, got, want in (("output", out.data, ref),
                          ("d data", xa.grad.data, xr.grad),
                          ("d weight", layer.weight.grad().data, w.grad),
                          ("d bias", layer.bias.grad().data, b.grad)):
        err = (got - want).abs().max().item()
        lim = DECONV_RTOL * want.abs().max().item()
        log("deconvolution %s: max err %.3g (limit %.3g)" % (nm, err, lim))
        check(tuple(got.shape) == tuple(want.shape) and err <= lim,
              "Conv2DTranspose %s %s vs plain %s: error %.3g over %.3g"
              % (nm, tuple(got.shape), tuple(want.shape), err, lim))
    t = timing(torch, lambda: layer(xa))
    log("deconvolution: Conv2DTranspose(%d -> %d, 4, 2, 1) on %dx%dx%dx%d "
        "forward %.4f ms (window medians, spread %s)"
        % (CIN, COUT, N, CIN, HW, HW, t["ms"], spread(t)))
    del layer, x, head, xa, out, w, b, xr, ref
    torch.cuda.empty_cache()


def plain_resnet_v1(torch, net, x, y):
    """The zoo's ResNet v1 training forward (``BottleneckV1`` at 50
    layers, ``BasicBlockV1`` at 18; 7x7/2 stem and 3x3/2 max pool) in plain float32 torch.nn.functional,
    written from ``gluon/model_zoo/vision/resnet.py`` and independent of
    the port's ops and dispatch: it reads only the parameter tensors,
    walking the blocks in the order the zoo builds them. Every BatchNorm
    normalises with the batch statistics (biased variance). Returns the
    mean cross-entropy, each BatchNorm's (mean, var) by block name, and
    the multiply-adds per image of the convolutions and the dense
    layer."""
    import torch.nn.functional as F
    stats = {}
    macs = [0]

    def val(p):
        return None if p is None else p.data().data

    def bn(h, blk):
        var, mean = torch.var_mean(h, dim=(0, 2, 3), unbiased=False)
        stats[blk.name] = (mean, var)
        scale = (val(blk.gamma) * torch.rsqrt(var + GLUON_EPS)).view(
            1, -1, 1, 1)
        return (h - mean.view(1, -1, 1, 1)) * scale + \
            val(blk.beta).view(1, -1, 1, 1)

    def conv(h, blk, stride, pad):
        w = val(blk.weight)
        out = F.conv2d(h, w, val(blk.bias), stride=stride, padding=pad)
        macs[0] += out[0].numel() * w[0].numel()
        return out

    feats = net.features._children
    h = torch.relu(bn(conv(x, feats[0], 2, 3), feats[1]))
    h = F.max_pool2d(h, 3, 2, 1)
    for i, stage in enumerate(feats[4:8]):
        for j, unit in enumerate(stage._children):
            stride = 2 if i > 0 and j == 0 else 1
            body = unit.body._children
            if len(body) == 8:      # BottleneckV1: 1x1/s, 3x3, 1x1
                b = torch.relu(bn(conv(h, body[0], stride, 0), body[1]))
                b = torch.relu(bn(conv(b, body[3], 1, 1), body[4]))
                b = bn(conv(b, body[6], 1, 0), body[7])
            else:                   # BasicBlockV1: 3x3/s, 3x3
                b = torch.relu(bn(conv(h, body[0], stride, 1), body[1]))
                b = bn(conv(b, body[3], 1, 1), body[4])
            if unit.downsample is not None:
                ds = unit.downsample._children
                h = bn(conv(h, ds[0], stride, 0), ds[1])
            h = torch.relu(b + h)
    h = h.mean(dim=(2, 3))
    w = val(net.output.weight)
    macs[0] += w.numel()
    logits = F.linear(h, w, val(net.output.bias))
    return F.cross_entropy(logits, y.long()), stats, macs[0]


def train_gluon(torch, np, counters, warm, timed, what, eager_check):
    """Gluon's ResNet-50 v1 (``vision.get_model("resnet50_v1")``,
    hybridized) on one fixed RandomState(0) batch, as the reference's
    Gluon example trains it: ``autograd.record()`` around the loss,
    ``backward()``, ``Trainer.step``. Setup (construction, the seeded
    initializer, deferred init by ``infer_shape``) is timed, then the
    first step, ``warm`` steps, ``timed`` steps between CUDA events, one
    under torch.profiler, then one and ``timed`` more un-hybridized.
    The flash-attention ``counters`` are zeroed just before the first
    step and read after the last timed one. With ``eager_check``, one
    step hybridized and one un-hybridized, each from the initial
    parameters with cuDNN's deterministic algorithms (its default f32
    weight gradients sum with atomics, in another order each call), are
    held against each other: the loss and every gradient."""
    from torch.profiler import ProfilerActivity, profile
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import autograd, gluon
    B, S = RESNET_BATCH, RESNET_IMAGE
    dev = torch.device(DEVICE)
    rng = np.random.RandomState(0)
    x_np = rng.uniform(-1, 1, (B, 3, S, S)).astype(np.float32)
    y_np = rng.randint(0, RESNET_CLASSES, (B,)).astype(np.float32)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mt.random.seed(SEED)
    net = gluon.model_zoo.vision.get_model("resnet%d_v1" % RESNET_LAYERS,
                                           classes=RESNET_CLASSES)
    net.initialize(mt.init.Xavier(rnd_type="gaussian", factor_type="in",
                                  magnitude=2).set_rng(
                                      mt.random.derive_numpy_rng(
                                          "gluon_resnet50_v1")),
                   ctx=mt.gpu(0))
    net.hybridize()
    x = mt.nd.array(x_np, ctx=dev)
    y = mt.nd.array(y_np, ctx=dev)
    net.infer_shape(x)
    trainer = gluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": RESNET_LR, "momentum": RESNET_MOMENTUM,
        "wd": RESNET_WD})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    params = net.collect_params()
    n_values = sum(p.data().size for p in params.values())
    n_trained = sum(p.data().size for p in params.values()
                    if p.grad_req != "null")
    init = {n: p.data().data.detach().clone() for n, p in params.items()}
    with torch.no_grad():
        ce, stats, macs = plain_resnet_v1(torch, net, x.data, y.data)
        want = ce.item()
        stats = {n: (m.double().cpu().numpy(), v.double().cpu().numpy())
                 for n, (m, v) in stats.items()}
    bns = [b for b in _blocks(net) if isinstance(b, gluon.nn.BatchNorm)]

    def aux(p_of):
        out = {}
        for blk in bns:
            out[blk.name + "_moving_mean"] = p_of(blk.running_mean)
            out[blk.name + "_moving_var"] = p_of(blk.running_var)
        return out

    aux0 = aux(lambda p: p.data().data.double().cpu().numpy())

    def step():
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(B)
        return loss.data.detach().mean()

    for fn in counters.values():
        fn.launches = {"f32": 0, "bf16": 0}
    t0 = time.perf_counter()
    losses = [step()]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    aux1 = aux(lambda p: p.data().data.double().cpu().numpy())

    def timed_steps():
        """``timed`` steps between CUDA events: (ms a step, each step's
        ms)."""
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(timed + 1)]
        events[0].record()
        for ev in events[1:]:
            losses.append(step())
            ev.record()
        torch.cuda.synchronize()
        return (events[0].elapsed_time(events[-1]) / timed,
                [a.elapsed_time(b) for a, b in zip(events, events[1:])])

    for _ in range(warm):
        losses.append(step())
    torch.cuda.synchronize()
    step_ms, per_step = timed_steps()
    launches = {n: dict(fn.launches) for n, fn in counters.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    by_kind, busy_ms = resnet_breakdown(torch, prof, wall, what)
    # the same steps with the net un-hybridized (training goes on)
    net.hybridize(False)
    losses.append(step())
    eager_ms, eager_per_step = timed_steps()
    net.hybridize()
    losses = [float(v) for v in torch.stack(losses).cpu()]
    eager = None
    if eager_check:
        runs = []
        prev = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            for hybrid in (True, False):
                for n, p in params.items():
                    p.set_data(mt.nd.NDArray(init[n]))
                net.hybridize(hybrid)
                with autograd.record():
                    loss = loss_fn(net(x), y)
                loss.backward()
                runs.append((loss.data.mean().item(),
                             {n: p.grad().data.detach().clone()
                              for n, p in params.items()
                              if p.grad_req != "null"}))
        finally:
            torch.backends.cudnn.deterministic = prev
        torch.cuda.synchronize()
        (h_loss, hyb), (e_loss, eag) = runs
        worst, where = 0.0, None
        for n, g in hyb.items():
            e = eag[n]
            top = g.abs().max()
            if n.endswith("_bias") and "conv" in n:
                # a BatchNorm follows every v1 convolution: its bias has
                # no gradient in exact arithmetic, both sides hold only
                # rounding; scaled by its weight's gradient instead
                top = hyb[n[:-len("bias")] + "weight"].abs().max()
            r = ((e - g).abs().max() / top.clamp(min=1e-30)).item()
            if r > worst:
                worst, where = r, n
        eager = {"loss": e_loss, "hybrid_loss": h_loss, "worst": worst,
                 "where": where}
        del runs, hyb, eag
    del net, trainer, x, y, init, params
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "want": want, "stats": stats, "aux0": aux0,
            "aux1": aux1, "n_values": n_values, "n_trained": n_trained,
            "macs": macs,
            "step_ms": step_ms, "per_step": per_step, "eager_ms": eager_ms,
            "eager_per_step": eager_per_step, "setup_s": setup_s,
            "first_s": first_s, "timed": timed, "launches": launches,
            "peak_gb": peak_gb, "busy_ms": busy_ms, "wall_ms": wall * 1e3,
            "by_kind": by_kind, "eager": eager}


def _blocks(block):
    """Every block under ``block``, itself first, in construction
    order."""
    out = [block]
    for child in block._children:
        out.extend(_blocks(child))
    return out


def check_gluon(np, what, run, ce_tol, stats_rtol, peak_flops, peak_name):
    """Log a Gluon ResNet-50 v1 run's readings and hold it to the path:
    finite losses that fall, the step-1 cross-entropy within ``ce_tol``
    of the plain forward's, the running statistics, the eager step
    (when taken) within GLUON_EAGER_RTOL, and no flash-attention
    launch."""
    losses, want = run["losses"], run["want"]
    img_s = RESNET_BATCH / (run["step_ms"] / 1e3)
    flops = 3 * 2 * run["macs"]
    per = sorted(run["per_step"])
    log("%s: Gluon resnet%d_v1 (hybridized), batch %d, %dx%d, %d parameter "
        "values (%d with a gradient): setup %.3f s (construction, initializer, deferred init), "
        "first step %.3f s; step %.3f ms (%d steps between CUDA events; "
        "per step min %.3f median %.3f max %.3f) = %.1f img/s; MFU %.4f of "
        "%.0f TFLOP/s %s (%.3f GFLOP per image: 3 x 2 x %.4g multiply-adds "
        "counted from the layer shapes); peak memory %.3f GB; device busy "
        "%.3f of %.3f ms profiled (idle share %.3f)"
        % (what, RESNET_LAYERS, RESNET_BATCH, RESNET_IMAGE, RESNET_IMAGE,
           run["n_values"], run["n_trained"], run["setup_s"], run["first_s"], run["step_ms"], run["timed"],
           per[0], per[len(per) // 2], per[-1], img_s,
           img_s * flops / peak_flops, peak_flops / 1e12, peak_name,
           flops / 1e9, run["macs"], run["peak_gb"], run["busy_ms"],
           run["wall_ms"], 1 - run["busy_ms"] / max(run["wall_ms"], 1e-9)))
    eper = sorted(run["eager_per_step"])
    log("%s: the same net un-hybridized: step %.3f ms (%d steps between "
        "CUDA events; per step min %.3f median %.3f max %.3f) = %.1f img/s; "
        "hybridized / eager %.4f"
        % (what, run["eager_ms"], run["timed"], eper[0],
           eper[len(eper) // 2], eper[-1],
           RESNET_BATCH / (run["eager_ms"] / 1e3),
           run["step_ms"] / run["eager_ms"]))
    log("%s: loss per step %s" % (what, " ".join("%.6f" % v for v in losses)))
    log("%s: step-1 cross-entropy %.6f, plain f32 forward %.6f (|diff| "
        "%.3g, tolerance %g); flash-attention launches %s"
        % (what, losses[0], want, abs(losses[0] - want), ce_tol,
           run["launches"]))
    check(all(math.isfinite(v) for v in losses), "%s: non-finite loss %s"
          % (what, losses))
    check(losses[-1] < losses[0], "%s: loss did not fall: %s"
          % (what, losses))
    check(abs(losses[0] - want) <= ce_tol, "%s: step-1 loss %g vs plain "
          "forward %g" % (what, losses[0], want))
    check_resnet_stats(np, what, run, stats_rtol)
    if RESNET_LAYERS == 50:
        check(run["n_values"] == GLUON_RESNET50_V1_VALUES,
              "%s: %d parameter values, resnet50_v1 has %d"
              % (what, run["n_values"], GLUON_RESNET50_V1_VALUES))
    for name, n in run["launches"].items():
        check(n == {"f32": 0, "bf16": 0}, "%s: flash-attention kernel %s "
              "launched %s times in a ResNet step" % (what, name, n))
    eager = run["eager"]
    if eager is not None:
        dl = abs(eager["loss"] - eager["hybrid_loss"])
        log("%s: from the initial parameters, cuDNN deterministic: one "
            "eager step loss %.6f, one hybridized %.6f (|diff| %.3g; the "
            "timed run's step 1 %.6f); largest gradient difference %.3g "
            "of that gradient's max |value| (of its weight gradient's for "
            "a conv bias, zero in exact arithmetic; at %s; limit %g)"
            % (what, eager["loss"], eager["hybrid_loss"], dl, losses[0],
               eager["worst"], eager["where"], GLUON_EAGER_RTOL))
        check(dl <= GLUON_EAGER_RTOL * max(1.0, abs(eager["loss"])) and
              eager["worst"] <= GLUON_EAGER_RTOL,
              "%s: the eager step differs from the hybridized one: loss "
              "%.6f vs %.6f, gradient %.3g at %s"
              % (what, eager["loss"], eager["hybrid_loss"], eager["worst"],
                 eager["where"]))


def gluon_phase(torch, np):
    """The imperative API on the card: the tape drives the attention
    kernels, Conv2DTranspose at a DCGAN shape, then Gluon's ResNet-50
    v1 at the reference Gluon example's configuration, amp bf16 and then
    f32 (TF32 off) with the eager-vs-hybridized check."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import flash_attention as fa
    t0 = time.perf_counter()
    tape_attention_check(torch, np)
    deconvolution_check(torch, np)
    counters = {"flash_attention_fwd": fa.flash_attention_fwd,
                "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
                "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv}
    check(not torch.backends.cudnn.allow_tf32 and
          not torch.backends.cuda.matmul.allow_tf32 and
          not torch.backends.cudnn.benchmark,
          "TF32 or cudnn.benchmark is on: the checks need f32 convolutions "
          "and the same algorithms in both steps")
    mt.amp.init("bfloat16")
    try:
        run = train_gluon(torch, np, counters, RESNET_WARM, GLUON_TIMED,
                          "gluon", False)
    finally:
        mt.amp.off()
    check_gluon(np, "gluon", run, RESNET_CE_TOL, RESNET_STATS_RTOL,
                PEAK_BF16_FLOPS, "bf16")
    run = train_gluon(torch, np, counters, RESNET_F32_WARM,
                      RESNET_F32_TIMED, "gluon f32", True)
    check_gluon(np, "gluon f32", run, RESNET_F32_CE_TOL,
                RESNET_F32_STATS_RTOL, PEAK_FP32_FLOPS, "f32")
    log("gluon phase: %.1f s" % (time.perf_counter() - t0))


# ------------------------------------------------------------ phase 10

def plain_rnn(torch, mode, x, weights, h0, c0, bidir):
    """An independent per-step recurrence with the fused op's semantics,
    f32: ``weights`` holds (W_x, W_h, b_x, b_h) per layer and direction;
    gate orders LSTM i, f, g, o and GRU r, z, n with n = tanh(x_n + r *
    (W_hn h + b_hn)); the reverse direction runs from the last step.
    Returns (output, h_N, c_N or None)."""
    dirs = 2 if bidir else 1
    layers = len(weights) // dirs
    T = x.shape[0]
    inp, hs, cs = x, [], []
    for layer in range(layers):
        outs = []
        for d in range(dirs):
            k = layer * dirs + d
            wx, wh, bx, bh = weights[k]
            h, c = h0[k], (c0[k] if mode == "lstm" else None)
            gxs = inp @ wx.t() + bx          # every step's input term
            ys = [None] * T
            for t in (range(T) if d == 0 else reversed(range(T))):
                gx = gxs[t]
                gh = h @ wh.t() + bh
                if mode == "lstm":
                    i, f, g, o = (gx + gh).chunk(4, dim=1)
                    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                    h = torch.sigmoid(o) * torch.tanh(c)
                elif mode == "gru":
                    xr, xz, xn = gx.chunk(3, dim=1)
                    hr, hz, hn = gh.chunk(3, dim=1)
                    r = torch.sigmoid(xr + hr)
                    z = torch.sigmoid(xz + hz)
                    h = (1 - z) * torch.tanh(xn + r * hn) + z * h
                else:
                    pre = gx + gh
                    h = torch.tanh(pre) if mode == "rnn_tanh" \
                        else torch.relu(pre)
                ys[t] = h
            outs.append(torch.stack(ys))
            hs.append(h)
            cs.append(c)
        inp = torch.cat(outs, dim=2)
    return (inp, torch.stack(hs),
            torch.stack(cs) if mode == "lstm" else None)


def packed_weights(params, mode, layers, width, hidden, bidir):
    """The packed vector sliced in its documented order: every layer's
    and direction's W_x (G*H, in) and W_h (G*H, H), then every b_x, b_h
    (G*H): a list of (W_x, W_h, b_x, b_h) per layer and direction."""
    G = {"lstm": 4, "gru": 3, "rnn_tanh": 1, "rnn_relu": 1}[mode] * hidden
    dirs = 2 if bidir else 1
    off, mats = 0, []
    for layer in range(layers):
        cols = width if layer == 0 else hidden * dirs
        for _ in range(dirs):
            wx = params[off:off + G * cols].view(G, cols)
            off += G * cols
            wh = params[off:off + G * hidden].view(G, hidden)
            off += G * hidden
            mats.append((wx, wh))
    out = []
    for wx, wh in mats:
        out.append((wx, wh, params[off:off + G], params[off + G:off + 2 * G]))
        off += 2 * G
    check(off == params.numel(), "packed vector of %d values, layout needs "
          "%d" % (params.numel(), off))
    return out


def rnn_err(got, want):
    """max |got - want| over max(1, max |want|)."""
    return ((got.double() - want.double()).abs().max() /
            max(1.0, want.double().abs().max().item())).item()


def rel_err(got, want):
    """max |got - want| over max |want|: for values far below 1 (logits,
    states), where :func:`rnn_err`'s floor of 1 would hide a wrong
    model."""
    return ((got.double() - want.double()).abs().max() /
            want.double().abs().max().clamp_min(1e-30)).item()


def ran_under(prof):
    """Whether one of RNN_DEVICE_OPS appears among the profiled ops."""
    return any(e.key in RNN_DEVICE_OPS for e in prof.key_averages())


def fused_op_check(torch):
    """The fused RNN op (``ops/rnn_op.py``: cuDNN's RNN, f32; cuDNN's
    TF32 switch is on, torch's default, so the op's own guard must keep
    its forward and backward in f32) against :func:`plain_rnn` at the
    path's shapes: T 35, N 32, 2 layers,
    input = hidden = 1500 (LSTM, GRU, rnn_tanh) and 200 (LSTM, GRU), one
    and two directions: the output, h_N, c_N and the gradients of the
    data, the packed vector and the initial states, each within RNN_RTOL
    of the plain version's largest value. The op must run under
    one of RNN_DEVICE_OPS. Then, logged only, one LSTM case with the
    guard around the forward alone (autograd's backward outside it, as
    the op ran before the guard covered its backward): what TF32 in
    cuDNN's backward gives at this shape. Then, under amp bf16, whether
    cuDNN takes the op in bf16 (logged: it decides the word LM's bf16
    run)."""
    from torch.profiler import ProfilerActivity, profile
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops.rnn_op import rnn, rnn_param_size
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    T, N, L = WORD_BPTT, WORD_BATCH, WORD_LAYERS
    t0 = time.perf_counter()
    worst = 0.0
    n_cases = 0
    unguarded_case = None       # the first one-direction LSTM case
    for hidden, modes in RNN_CASES:
        for mode in modes:
            for bidir in (False, True):
                t_case = time.perf_counter()
                dirs = 2 if bidir else 1
                size = rnn_param_size(L, hidden, hidden, mode, bidir)
                scale = 1.0 / math.sqrt(hidden)
                x = torch.rand((T, N, hidden), generator=gen, device=dev) \
                    * 2 - 1
                params = (torch.rand((size,), generator=gen, device=dev)
                          * 2 - 1) * scale
                h0 = torch.randn((L * dirs, N, hidden), generator=gen,
                                 device=dev) * 0.5
                c0 = torch.randn((L * dirs, N, hidden), generator=gen,
                                 device=dev) * 0.5
                ins = [x, params, h0] + ([c0] if mode == "lstm" else [])
                leaves = [t.clone().requires_grad_(True) for t in ins]
                with profile(activities=[ProfilerActivity.CPU]) as prof:
                    outs = rnn.fn(*leaves, state_size=hidden, num_layers=L,
                                  mode=mode, bidirectional=bidir,
                                  state_outputs=True, _is_train=True)
                check(ran_under(prof), "RNN %s %d bidir=%s did not run "
                      "under %s" % (mode, hidden, bidir, RNN_DEVICE_OPS))
                heads = [torch.randn(o.shape, generator=gen, device=dev)
                         for o in outs]
                grads = torch.autograd.grad(outs, leaves, heads)
                pleaves = [t.clone().requires_grad_(True) for t in ins]
                weights = packed_weights(pleaves[1], mode, L, hidden,
                                         hidden, bidir)
                pout, ph, pc = plain_rnn(
                    torch, mode, pleaves[0], weights, pleaves[2],
                    pleaves[3] if mode == "lstm" else None, bidir)
                pouts = [pout, ph] + ([pc] if mode == "lstm" else [])
                pgrads = torch.autograd.grad(pouts, pleaves, heads)
                errs = {}
                for name, g, w in zip(("output", "h_N", "c_N"), outs, pouts):
                    errs[name] = rnn_err(g.detach(), w.detach())
                for name, g, w in zip(("d data", "d parameters", "d h0",
                                       "d c0"), grads, pgrads):
                    errs[name] = rnn_err(g, w)
                bad = {k: v for k, v in errs.items() if v > RNN_RTOL}
                log("rnn op %s H %d %s: %s (%.2f s)" % (
                    mode, hidden, "bidirectional" if bidir else
                    "one direction", " ".join("%s %.2e" % kv
                                              for kv in errs.items()),
                    time.perf_counter() - t_case))
                check(not bad, "the fused RNN op (%s, H %d, bidirectional "
                      "%s) disagrees with the plain recurrence: %s (limit "
                      "%g of max(1, max|ref|))" % (mode, hidden, bidir, bad,
                                                   RNN_RTOL))
                worst = max(worst, max(errs.values()))
                n_cases += 1
                if (mode, bidir) == ("lstm", False) and \
                        unguarded_case is None:
                    unguarded_case = (ins, heads, pouts, pgrads)
                del leaves, pleaves, outs, grads, pouts, pgrads, weights
    unguarded_backward(torch, *unguarded_case)
    del unguarded_case
    # bf16: does cuDNN take it? (amp casts data, parameters and states)
    H = WORD_WIDTH
    size = rnn_param_size(L, H, H, "lstm")
    x = torch.rand((T, N, H), generator=gen, device=dev) * 2 - 1
    params = (torch.rand((size,), generator=gen, device=dev) * 2 - 1) / \
        math.sqrt(H)
    zeros = torch.zeros((L, N, H), device=dev)
    mt.amp.init("bfloat16")
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = rnn.fn(x, params, zeros, zeros, state_size=H,
                         num_layers=L, mode="lstm")
            torch.cuda.synchronize()
    finally:
        mt.amp.off()
    bf16_cudnn = ran_under(prof) and out.dtype == torch.bfloat16
    want, _, _ = plain_rnn(torch, "lstm", x, packed_weights(
        params, "lstm", L, H, H, False), zeros, zeros, False)
    log("rnn op: %d cases within %g (worst %.2e) in %.1f s; amp bf16 LSTM "
        "H %d: output %s, under %s: %s, %.3g from the f32 plain recurrence"
        % (n_cases, RNN_RTOL, worst, time.perf_counter() - t0, H, out.dtype,
           RNN_DEVICE_OPS, ran_under(prof),
           rnn_err(out.float(), want)))
    del x, params, zeros, out, want
    gc.collect()
    torch.cuda.empty_cache()
    return bf16_cudnn


def unguarded_backward(torch, ins, heads, pouts, pgrads):
    """The 2-layer LSTM case of :func:`fused_op_check` with the precision
    guard around the forward only, autograd's backward (cuDNN's) run
    outside it with the global TF32 switch as it stands: its errors
    against the plain recurrence, logged."""
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch.ops import rnn_op
    x, params, h0, c0 = [t.clone().requires_grad_(True) for t in ins]
    T, N, H = x.shape
    L = h0.shape[0]
    weights, biases = rnn_op.rnn_unpack_params(params, L, H, H, "lstm")
    inp, hs, cs = x, [], []
    with amp.conv_precision(torch.float32):
        for k in range(L):
            inp, h, c = rnn_op._fused("lstm", inp, h0[k:k + 1], c0[k:k + 1],
                                      [*weights[k], *biases[k]], False, True)
            hs.append(h)
            cs.append(c)
    outs = [inp, torch.cat(hs), torch.cat(cs)]
    grads = torch.autograd.grad(outs, [x, params, h0, c0], heads)
    errs = {"output": rnn_err(outs[0].detach(), pouts[0].detach()),
            "d data": rnn_err(grads[0], pgrads[0]),
            "d parameters": rnn_err(grads[1], pgrads[1])}
    log("rnn op lstm H %d without the guard around its backward (cuDNN's "
        "TF32 switch %s): %s (the check's limit %g; logged only)"
        % (H, torch.backends.cudnn.allow_tf32,
           " ".join("%s %.2e" % kv for kv in errs.items()), RNN_RTOL))


def rnn_kind(op: str) -> str:
    """The class of an operator's device time in the recurrent steps, by
    the innermost aten op that launched the kernels."""
    low = op.lower()
    if "_cudnn_rnn_backward" in low:
        return "RNN backward"
    if "_cudnn_rnn" in low or any(m in low for m in (
            "::lstm", "::gru", "::rnn_tanh", "::rnn_relu")):
        return "RNN forward"
    if "_foreach" in low:
        return "optimizer"
    if any(w in low for w in ("::mm", "addmm", "matmul", "linear", "bmm")):
        return "GEMM (cuBLAS)"
    if "embedding" in low:
        return "embedding"
    return "elementwise"


def word_lm(mt, gluon):
    """The upstream example's model: embedding, dropout, a 2-layer LSTM
    with dropout between its layers, dropout, and a decoder that holds
    the embedding's weight (``params=encoder.params``)."""

    class RNNModel(gluon.Block):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.drop = gluon.nn.Dropout(WORD_DROPOUT)
                self.encoder = gluon.nn.Embedding(
                    WORD_VOCAB, WORD_WIDTH,
                    weight_initializer=mt.init.Uniform(0.1).set_rng(
                        mt.random.derive_numpy_rng("word_lm_encoder")))
                self.rnn = gluon.rnn.LSTM(WORD_WIDTH, WORD_LAYERS,
                                          dropout=WORD_DROPOUT,
                                          input_size=WORD_WIDTH)
                self.decoder = gluon.nn.Dense(WORD_VOCAB,
                                              in_units=WORD_WIDTH,
                                              params=self.encoder.params)

        def forward(self, inputs, hidden):
            emb = self.drop(self.encoder(inputs))
            output, hidden = self.rnn(emb, hidden)
            output = self.drop(output)
            return self.decoder(output.reshape((-1, WORD_WIDTH))), hidden

    return RNNModel(prefix="wordlm_")


def plain_word_lm(torch, model, x):
    """An independent f32 forward of the word LM's weights with dropout
    off and zero initial states: the embedding rows, :func:`plain_rnn`
    per layer, the tied decoder. Returns the logits and the final h and
    c of every layer."""
    p = {n[len("wordlm_"):]: q.data().data.detach().float()
         for n, q in model.collect_params().items()}
    weight = p["embedding0_weight"]
    emb = weight[x.long()]
    layers = [tuple(p["lstm0_l%d_%s" % (k, part)] for part in (
        "i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias"))
        for k in range(WORD_LAYERS)]
    zeros = torch.zeros((WORD_LAYERS, x.shape[1], WORD_WIDTH),
                        device=x.device)
    out, h, c = plain_rnn(torch, "lstm", emb, layers, zeros, zeros, False)
    logits = out.reshape(-1, WORD_WIDTH) @ weight.t() + \
        p["embedding0_bias"]
    return logits, h, c


def train_word_lm(torch, np, counters, warm, timed, what):
    """The word LM as the repo's twin (``examples/word_language_model.py``)
    trains it: truncated BPTT over consecutive segments of one token
    stream, ``detach`` of the carried states, ``autograd.record()``,
    ``backward()``, ``clip_global_norm(grads, clip x bptt x batch)`` and
    ``Trainer.step(bptt x batch)``. Step 1 runs with dropout off (its
    loss is held to :func:`plain_word_lm`), the others in training mode:
    ``warm`` steps, ``timed`` between CUDA events, one under
    torch.profiler. After them the first segment's dropout-off loss
    from zero states must be lower than step 1's."""
    from torch.profiler import ProfilerActivity, profile
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import autograd, gluon
    dev = torch.device(DEVICE)
    B, T = WORD_BATCH, WORD_BPTT
    n_steps = 1 + warm + timed + 1
    tokens = np.random.RandomState(0).randint(
        0, WORD_VOCAB, (T * n_steps + 1, B)).astype(np.float32)
    stream = mt.nd.array(tokens, ctx=dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mt.random.seed(SEED)
    model = word_lm(mt, gluon)
    model.initialize(mt.init.Xavier().set_rng(
        mt.random.derive_numpy_rng("word_lm")), ctx=mt.gpu(0))
    params = model.collect_params()
    trainer = gluon.Trainer(params, "sgd", {"learning_rate": WORD_LR,
                                            "momentum": 0, "wd": 0})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check(model.decoder.weight is model.encoder.weight,
          "%s: the decoder does not hold the embedding's weight" % what)
    n_values = sum(q.data().size for q in params.values())
    seg = [(stream[i * T:(i + 1) * T], stream[i * T + 1:(i + 1) * T + 1])
           for i in range(n_steps)]
    with torch.no_grad():
        ref = plain_word_lm(torch, model, seg[0][0].data)
        want = torch.nn.functional.cross_entropy(
            ref[0], seg[0][1].data.reshape(-1).long()).item()
    state = {"hidden": model.rnn.begin_state(batch_size=B, ctx=dev)}

    def f32_ce(out, y):
        # the cross-entropy of the model's logits taken in f32: under amp
        # the loss itself is bf16 (as in the reference), 2^-4 apart at 9
        return torch.nn.functional.cross_entropy(
            out.data.detach().float(), y.data.reshape(-1).long()).item()

    def step(i, train=True):
        x, y = seg[i]
        hidden = [h.detach() for h in state["hidden"]]
        with autograd.record(train_mode=train):
            out, state["hidden"] = model(x, hidden)
            loss = loss_fn(out, y.reshape((-1,)))
        loss.backward()
        grads = [q.grad() for q in params.values() if q.grad_req != "null"]
        gluon.utils.clip_global_norm(grads, WORD_CLIP * T * B)
        trainer.step(T * B)
        state["out"] = out
        return loss.data.detach().float().mean()

    for fn in counters.values():
        fn.launches = {"f32": 0, "bf16": 0}
    t0 = time.perf_counter()
    losses = [step(0, train=False)]
    out = state.pop("out")
    first = f32_ce(out, seg[0][1])
    step1 = {name: rel_err(got.data.detach().float(), want_t)
             for name, got, want_t in zip(("logits", "h_N", "c_N"),
                                          [out, *state["hidden"]], ref)}
    del out, ref
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    for i in range(warm):
        losses.append(step(1 + i))
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(timed + 1)]
    events[0].record()
    for i, ev in enumerate(events[1:]):
        losses.append(step(1 + warm + i))
        ev.record()
    torch.cuda.synchronize()
    per_step = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    launches = {n: dict(fn.launches) for n, fn in counters.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        losses.append(step(n_steps - 1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _, busy_ms = resnet_breakdown(torch, prof, wall, what, rnn_kind)
    with autograd.predict_mode():
        out, _ = model(seg[0][0], model.rnn.begin_state(batch_size=B,
                                                        ctx=dev))
    after = f32_ce(out, seg[0][1])
    losses = [float(v) for v in torch.stack(losses).cpu()]
    del model, trainer, params, seg, stream, state
    gc.collect()
    torch.cuda.empty_cache()
    # per token: each LSTM layer 2 x 4H(I + H), the decoder 2 x H x V;
    # forward and backward 3x
    flops = 3 * B * T * (WORD_LAYERS * 2 * 4 * WORD_WIDTH * 2 * WORD_WIDTH
                         + 2 * WORD_WIDTH * WORD_VOCAB)
    return {"losses": losses, "want": want, "first": first, "after": after,
            "step1": step1, "per_step": per_step, "setup_s": setup_s, "first_s": first_s,
            "launches": launches, "peak_gb": peak_gb, "busy_ms": busy_ms,
            "wall_ms": wall * 1e3, "flops": flops,
            "n_values": n_values, "timed": timed}


def check_word_lm(what, run, ce_tol, rtol, peak_flops, peak_name):
    losses, per = run["losses"], sorted(run["per_step"])
    step_ms = per[len(per) // 2]
    tok_s = WORD_BATCH * WORD_BPTT / (step_ms / 1e3)
    log("%s: word LM (tied %dx%d, %d LSTM layers, dropout %g), batch %d x "
        "bptt %d, %d parameter values: setup %.3f s, first step %.3f s; "
        "step %.3f ms (median of %d steps between CUDA events; min %.3f "
        "max %.3f) = %.0f tok/s; MFU %.4f of %.0f TFLOP/s %s (%.1f GFLOP "
        "a step counted from the shapes); peak memory %.3f GB; device busy "
        "%.3f of %.3f ms profiled (idle share %.3f)"
        % (what, WORD_VOCAB, WORD_WIDTH, WORD_LAYERS, WORD_DROPOUT,
           WORD_BATCH, WORD_BPTT, run["n_values"], run["setup_s"],
           run["first_s"], step_ms, run["timed"], per[0], per[-1], tok_s,
           tok_s / (WORD_BATCH * WORD_BPTT) * run["flops"] / peak_flops,
           peak_flops / 1e12, peak_name, run["flops"] / 1e9, run["peak_gb"],
           run["busy_ms"], run["wall_ms"],
           1 - run["busy_ms"] / max(run["wall_ms"], 1e-9)))
    log("%s: loss per step %s" % (what, " ".join("%.6f" % v
                                                 for v in losses)))
    first = run["first"]
    log("%s: step-1 cross-entropy (dropout off, the logits' in f32) %.6f, "
        "plain f32 forward %.6f (|diff| %.3g, tolerance %g); the first "
        "segment after the steps %.6f; flash-attention launches %s"
        % (what, first, run["want"], abs(first - run["want"]), ce_tol,
           run["after"], run["launches"]))
    check(all(math.isfinite(v) for v in losses), "%s: non-finite loss %s"
          % (what, losses))
    log("%s: step-1 logits and final states (dropout off) against the "
        "plain f32 forward: %s of max|ref| (limit %g)"
        % (what, " ".join("%s %.2e" % kv for kv in run["step1"].items()),
           rtol))
    check(abs(first - run["want"]) <= ce_tol, "%s: step-1 loss %g vs "
          "plain forward %g" % (what, first, run["want"]))
    bad = {k: v for k, v in run["step1"].items() if not v <= rtol}
    check(not bad, "%s: the step-1 forward disagrees with the plain f32 "
          "forward: %s (limit %g of max|ref|)" % (what, bad, rtol))
    check(run["after"] < first, "%s: the loss did not fall: %g after the "
          "steps, %g at step 1" % (what, run["after"], first))
    for name, n in run["launches"].items():
        check(n == {"f32": 0, "bf16": 0}, "%s: flash-attention kernel %s "
              "launched %s times in a recurrent step" % (what, name, n))


def bucket_sentences(np):
    """Sentences over BUCKET_VOCAB words (ids 1.., 0 is padding) at
    lengths that fill every bucket with BUCKET_BATCHES batches: for each
    bucket, lengths from just above the one below up to its own."""
    rng = np.random.RandomState(SEED)
    out, lo = [], 1
    for b in BUCKETS:
        for _ in range(BUCKET_BATCHES * BUCKET_BATCH):
            n = int(rng.randint(lo, b + 1))
            out.append([int(t) for t in rng.randint(1, BUCKET_VOCAB, n)])
        lo = b + 1
    return out


def bucket_sym_gen(mt, fused=False, head=True):
    """The upstream lstm_bucketing.py graph per bucket length: embedding,
    a stack of LSTMCells unrolled (or one FusedRNNCell with the same
    parameters), the decoder, SoftmaxOutput ignoring padding (with
    ``head`` off, the graph ends at the decoder's logits)."""
    if fused:
        cell = mt.rnn.FusedRNNCell(BUCKET_WIDTH, num_layers=BUCKET_LAYERS,
                                   mode="lstm", prefix="lstm_")
    else:
        cell = mt.rnn.SequentialRNNCell()
        for i in range(BUCKET_LAYERS):
            cell.add(mt.rnn.LSTMCell(num_hidden=BUCKET_WIDTH,
                                     prefix="lstm_l%d_" % i))

    def sym_gen(seq_len):
        data = mt.sym.Variable("data")
        label = mt.sym.Variable("softmax_label")
        embed = mt.sym.Embedding(data, input_dim=BUCKET_VOCAB,
                                 output_dim=BUCKET_WIDTH, name="embed")
        cell.reset()
        outputs, _ = cell.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = mt.sym.Reshape(outputs, shape=(-1, BUCKET_WIDTH))
        pred = mt.sym.FullyConnected(pred, num_hidden=BUCKET_VOCAB,
                                     name="pred")
        if not head:
            return pred, ("data",), ()
        lab = mt.sym.Reshape(label, shape=(-1,))
        pred = mt.sym.SoftmaxOutput(pred, lab, use_ignore=True,
                                    ignore_label=0, normalization="valid",
                                    name="softmax")
        return pred, ("data",), ("softmax_label",)

    return cell, sym_gen


def bucket_phase(torch, np, counters):
    """The bucketing LM: ``BucketingModule.fit`` for one epoch over a
    seeded ``BucketSentenceIter`` (BUCKET_BATCHES batches in each of the
    six buckets, the unrolled LSTMCell stack), then per bucket
    BUCKET_TIMED steps between CUDA events and the host's time per step,
    one profiled step at the largest bucket, and the same weights
    through FusedRNNCell (``unpack_weights`` / ``pack_weights``),
    forward only, against the unrolled graph. Every bucket's module must
    hold the default bucket's parameter tensors (by identity and
    ``data_ptr``); the perplexity over the epoch's batches after the
    epoch must be finite and below what they gave before it (the first
    batch's too)."""
    from torch.profiler import ProfilerActivity, profile
    import mxnet_tpu_torch as mt
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    ctx = mt.gpu(0)
    it = mt.rnn.BucketSentenceIter(bucket_sentences(np), BUCKET_BATCH,
                                   buckets=list(BUCKETS), invalid_label=0,
                                   seed=SEED)
    stack, sym_gen = bucket_sym_gen(mt)
    mod = mt.mod.BucketingModule(sym_gen,
                                 default_bucket_key=it.default_bucket_key,
                                 context=ctx)
    mt.random.seed(SEED)
    init = mt.init.Xavier(factor_type="in", magnitude=2.34).set_rng(
        mt.random.derive_numpy_rng("lstm_bucketing"))
    batches = list(it)
    it.reset()

    def perplexity(mod, some):
        metric = mt.metric.Perplexity(ignore_label=0)
        for b in some:
            mod.forward(b, is_train=False)
            mod.update_metric(metric, b.label)
        return metric.get()[1]

    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(init)
    first_before = perplexity(mod, batches[:1])
    before = perplexity(mod, batches)
    for fn in counters.values():
        fn.launches = {"f32": 0, "bf16": 0}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mod.fit(it, eval_metric=mt.metric.Perplexity(ignore_label=0),
            optimizer="sgd", optimizer_params={
                "learning_rate": BUCKET_LR, "momentum": 0.0,
                "wd": BUCKET_WD},
            num_epoch=1)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    after = perplexity(mod, batches)
    first_after = perplexity(mod, batches[:1])
    launches = {n: dict(fn.launches) for n, fn in counters.items()}
    default = mod._buckets[it.default_bucket_key]
    names = default._param_names
    shared = {k: all(m._exec.arg_dict[n] is default._exec.arg_dict[n] and
                     m._exec.arg_dict[n].data.data_ptr() ==
                     default._exec.arg_dict[n].data.data_ptr()
                     for n in names)
              for k, m in mod._buckets.items()}
    n_ops = {k: sum(n["op"] != "null" for n in json.loads(
        m.symbol.tojson())["nodes"]) for k, m in mod._buckets.items()}
    log("bucket: lstm_bucketing LM (%d LSTMCell layers of %d, embedding "
        "%d, vocab %d), batch %d, buckets %s: one fit epoch of %d batches "
        "in %.3f s (binds included); perplexity over the epoch's batches "
        "%.3f before, %.3f after; the first batch %.3f before, %.3f after; "
        "parameters shared by identity and data_ptr in buckets %s"
        % (BUCKET_LAYERS, BUCKET_WIDTH, BUCKET_WIDTH, BUCKET_VOCAB,
           BUCKET_BATCH, list(BUCKETS), len(batches), epoch_s, before,
           after, first_before, first_after, shared))
    check(sorted(mod._buckets) == sorted(BUCKETS), "bucket: modules for "
          "%s, the epoch has %s" % (sorted(mod._buckets), list(BUCKETS)))
    check(all(shared.values()), "bucket: a bucket's module does not hold "
          "the default bucket's parameter tensors: %s" % shared)
    check(all(m._updater is default._updater
              for m in mod._buckets.values()),
          "bucket: the buckets do not share one optimizer state")
    check(math.isfinite(after) and after < before and
          first_after < first_before,
          "bucket: perplexity %g (first batch %g) after the epoch, %g (%g) "
          "before it" % (after, first_after, before, first_before))
    for name, n in launches.items():
        check(n == {"f32": 0, "bf16": 0}, "bucket: flash-attention kernel "
              "%s launched %s times" % (name, n))
    # per bucket: device ms a step between CUDA events, host µs to issue
    # it (the unrolled graph runs op by op from Python)
    by_key = {b.bucket_key: b for b in batches}
    # per token: each LSTM layer 2 x 4H(in + H), the decoder 2 x H x V;
    # forward and backward 3x (padding tokens counted)
    flops_token = 3 * (BUCKET_LAYERS * 2 * 4 * BUCKET_WIDTH * 2 *
                       BUCKET_WIDTH + 2 * BUCKET_WIDTH * BUCKET_VOCAB)
    for key in BUCKETS:      # every bucket ran in the epoch: warm
        t = timing(torch, lambda: mod._fit_step(by_key[key]),
                   iters=BUCKET_TIMED, windows=1, warm=0)
        tok_s = BUCKET_BATCH * key / (t["ms"] / 1e3)
        log("bucket %d: %.3f ms a step (%d steps between CUDA events) = "
            "%.0f tok/s, MFU %.5f of 67 TFLOP/s f32 (%.2f GFLOP a step); "
            "host %.1f ms to issue one (%.0f%% of it; %d graph nodes)"
            % (key, t["ms"], BUCKET_TIMED, tok_s,
               tok_s * flops_token / PEAK_FP32_FLOPS,
               BUCKET_BATCH * key * flops_token / 1e9, t["host_us"] / 1e3,
               100 * t["host_us"] / 1e3 / t["ms"], n_ops[key]))
    big = by_key[max(BUCKETS)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mod._fit_step(big)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    resnet_breakdown(torch, prof, wall, "bucket %d" % max(BUCKETS),
                     rnn_kind)
    # the same weights through FusedRNNCell, forward only, to the
    # decoder's logits (the softmax's 1e-4 probabilities would hide a
    # wrong cell)
    args, _ = mod.get_params()
    args = {k: v for k, v in args.items() if "begin_state" not in k}
    _, logits_gen = bucket_sym_gen(mt, head=False)
    fused, fused_gen = bucket_sym_gen(mt, fused=True, head=False)
    packed = fused.pack_weights(stack.unpack_weights(args))
    outs = {}
    for name, gen, values in (("unrolled", logits_gen, args),
                              ("fused", fused_gen, packed)):
        sym, data_names, label_names = gen(big.bucket_key)
        m = mt.mod.Module(sym, data_names, label_names, context=ctx)
        m.bind(data_shapes=big.provide_data, for_training=False)
        m.init_params(mt.init.Zero())
        m.set_params(values, {}, allow_missing=True)
        m.forward(big, is_train=False)
        outs[name] = m.get_outputs()[0].data
        torch.cuda.synchronize()
        t = timing(torch, lambda: m.forward(big, is_train=False),
                   iters=BUCKET_TIMED, windows=1, warm=0)
        log("bucket %d %s forward: %.3f ms (host %.1f ms)"
            % (big.bucket_key, name, t["ms"], t["host_us"] / 1e3))
    err = rel_err(outs["fused"], outs["unrolled"])
    log("bucket %d: FusedRNNCell forward against the unrolled LSTMCells, "
        "the same weights (zero begin states): logits within %.2e of "
        "max|ref| %.4g (limit %g)" % (big.bucket_key, err,
                                     outs["unrolled"].abs().max().item(),
                                     RNN_RTOL))
    check(err <= RNN_RTOL, "bucket: the fused cell's forward differs from "
          "the unrolled one by %g" % err)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del mod, outs, args, packed, batches, by_key, big
    gc.collect()
    torch.cuda.empty_cache()
    log("bucket phase: %.1f s; peak memory %.3f GB"
        % (time.perf_counter() - t_phase, peak_gb))


def rnn_phase(torch, np):
    """The recurrent family on the card: the fused op against its plain
    recurrence, the word LM through Gluon (f32; amp bf16 too when cuDNN
    takes the op in bf16) and the bucketing LM through BucketingModule,
    with cuDNN's TF32 switch as torch leaves it (on)."""
    t0 = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32,
          "cuBLAS TF32 is on: the plain recurrences need f32 products")
    # cuDNN's TF32 switch at torch's default (on), as a user has it: the
    # op's own guard must keep the f32 recurrence f32
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        rnn_checks(torch, np)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    log("rnn phase: %.1f s" % (time.perf_counter() - t0))


def rnn_checks(torch, np):
    """The checks and runs of :func:`rnn_phase`."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import flash_attention as fa
    bf16_cudnn = fused_op_check(torch)
    counters = {"flash_attention_fwd": fa.flash_attention_fwd,
                "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
                "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv}
    run = train_word_lm(torch, np, counters, WORD_WARM, WORD_TIMED,
                        "word lm f32")
    check_word_lm("word lm f32", run, WORD_CE_TOL, RNN_RTOL,
                  PEAK_FP32_FLOPS, "f32")
    log("word lm: amp bf16 %s" % ("not run: cuDNN did not take the op in "
                                  "bf16" if not bf16_cudnn else "runs"))
    if bf16_cudnn:
        mt.amp.init("bfloat16")
        try:
            run = train_word_lm(torch, np, counters, 1, 5, "word lm bf16")
        finally:
            mt.amp.off()
        check_word_lm("word lm bf16", run, WORD_BF16_CE_TOL,
                      WORD_BF16_RTOL, PEAK_BF16_FLOPS, "bf16")
    bucket_phase(torch, np, counters)


# ------------------------------------------------ phase 11: optimizers

def opt_shapes():
    """(a)'s parameter shapes: the LM's d_model², d_model x d_ff, its
    embedding and a bias."""
    return ((D_MODEL, D_MODEL), (D_MODEL, D_FF), (VOCAB, D_MODEL),
            (D_MODEL,))


def optimizer_check(torch):
    """(a) Every optimizer of ``tests/test_fused_trainer.py`` under its
    four variants, on the card: the grouped ``update_multi`` (foreach)
    against the per-parameter ``update`` over OPT_STEPS steps from the
    same weights and gradients, every weight and state leaf within
    OPT_RTOL * max(1, max|ref|). Each case is fatal."""
    import mxnet_tpu_torch as mt
    t0 = time.perf_counter()
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    shapes = opt_shapes()
    names = {i: "p%d_%s" % (i, "bias" if len(s) == 1 else "weight")
             for i, s in enumerate(shapes)}
    w0 = [torch.randn(s, generator=gen, device=dev) for s in shapes]
    grads = [[torch.randn(s, generator=gen, device=dev) for s in shapes]
             for _ in range(OPT_STEPS)]

    def leaves(state):
        if state is None:
            return []
        if isinstance(state, tuple):
            return [x for s in state for x in leaves(s)]
        return [state.data]

    worst = {}
    for name, kw in OPT_CASES:
        for variant in OPT_VARIANTS:
            args = dict(kw, learning_rate=0.1, rescale_grad=0.5,
                        param_idx2name=names, **variant)
            updaters = []
            for _ in range(2):
                o = mt.optimizer.create(name, **args)
                o.set_wd_mult({})
                updaters.append(mt.optimizer.get_updater(o))
            per = [mt.nd.NDArray(w.clone()) for w in w0]
            grouped = [mt.nd.NDArray(w.clone()) for w in w0]
            for gs in grads:
                for i, g in enumerate(gs):
                    updaters[0](i, mt.nd.NDArray(g), per[i])
                updaters[1].update_multi(list(range(len(gs))), grouped, gs)
            torch.cuda.synchronize()
            case = "%s %s %s" % (name, kw or "", variant or "plain")
            err = 0.0
            for i in range(len(shapes)):
                pairs = [(per[i].data, grouped[i].data)] + list(zip(
                    leaves(updaters[0].states[i]),
                    leaves(updaters[1].states[i])))
                for a, b in pairs:
                    top = max(1.0, a.abs().max().item())
                    err = max(err, (a - b).abs().max().item() / top)
            check(err <= OPT_RTOL, "optimizer %s: grouped update %.3g of "
                  "max(1, max|ref|) from the per-parameter one (limit %g)"
                  % (case, err, OPT_RTOL))
            worst[case] = err
            del per, grouped, updaters
    del w0, grads
    gc.collect()
    torch.cuda.empty_cache()
    log("optimizers: %d cases (%d optimizers x %d variants) on %s, %d "
        "steps each: grouped (foreach) = per-parameter within %g of "
        "max(1, max|ref|); worst %.3g (%s); %.1f s"
        % (len(worst), len(OPT_CASES), len(OPT_VARIANTS),
           " + ".join("x".join(map(str, s)) for s in shapes), OPT_STEPS,
           OPT_RTOL, max(worst.values()), max(worst, key=worst.get),
           time.perf_counter() - t0))


class RepeatIter(object):
    """One batch ``n`` times an epoch, as a DataIter for ``fit``."""

    def __init__(self, batch, n, data_shape, label_shape):
        self.batch, self.n, self.i = batch, n, 0
        self.provide_data = [("data", data_shape)]
        self.provide_label = [("softmax_label", label_shape)]

    def __iter__(self):
        return self

    def __next__(self):
        if self.i >= self.n:
            raise StopIteration
        self.i += 1
        return self.batch

    next = __next__

    def reset(self):
        self.i = 0


def check_disk(path, need: int, what: str) -> None:
    import shutil
    free = shutil.disk_usage(path).free
    log("%s: %.2f GB free beside %s, %.2f GB needed"
        % (what, free / 1e9, path, need / 1e9))
    check(free >= need, "%s needs %d bytes of disk, %d free under %s"
          % (what, need, free, path))


def ckpt_counters():
    from mxnet_tpu_torch import profiler as mprof
    return {k: mprof.get_counter(k) for k in (
        "ckpt_block_us", "ckpt_write_us", "ckpt_bytes", "ckpt_saved")}


def ckpt_delta(before):
    after = ckpt_counters()
    return {k: after[k] - before[k] for k in after}


def adam_fit_args(mt):
    """fit's optimizer, schedule and metric of phase 11."""
    return dict(
        optimizer="adam",
        optimizer_params=dict(ADAM_PARAMS,
                              lr_scheduler=mt.lr_scheduler.FactorScheduler(
                                  *ADAM_SCHED)),
        eval_metric=mt.metric.CompositeEvalMetric(
            [mt.metric.CrossEntropy(), mt.metric.Perplexity(None)]))


def adam_lm(torch, np, counters):
    """(b) The LM at bench.py's width and ADAM_LAYERS deep (amp bf16 set
    by the caller) through ``Module.fit`` with Adam, the FactorScheduler,
    the composite metric and an async ``CheckpointConfig``, on one fixed
    batch: 1 + ADAM_WARM + ADAM_TIMED steps and one under
    torch.profiler, read from the batch-end callback; then the epoch's
    checkpoint. Returns train_lm's readings."""
    import shutil
    from torch.profiler import ProfilerActivity, profile
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.models import transformer
    B, T = TRAIN_BATCH, MAX_SEQ
    steps = 1 + ADAM_WARM + ADAM_TIMED + 1
    n_params = transformer.param_count(VOCAB, ADAM_LAYERS, D_MODEL, HEADS,
                                       D_FF, T)
    ckpt_dir = ROOT / "build" / "phase11_lm_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt_dir.mkdir(parents=True)
    check_disk(ckpt_dir, int(1.1 * 3 * 4 * n_params), "LM Adam checkpoint")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sym = transformer.get_symbol(VOCAB, ADAM_LAYERS, D_MODEL, HEADS, D_FF, T,
                                 attention="flash")
    mod = mt.mod.Module(sym, context=mt.gpu(0))
    mod.bind(data_shapes=[("data", (B, T))],
             label_shapes=[("softmax_label", (B, T))])
    mod.init_params(mt.init.Xavier().set_rng(np.random.default_rng(SEED)))
    torch.cuda.synchronize()
    bind_s = time.perf_counter() - t0
    rng = np.random.RandomState(0)
    x = rng.randint(0, VOCAB, (B, T)).astype(np.float32)
    y = rng.randint(0, VOCAB, (B, T)).astype(np.float32)
    dev = torch.device(DEVICE)
    db = mt.io.DataBatch(data=[mt.nd.array(x, ctx=dev)],
                         label=[mt.nd.array(y, ctx=dev)])
    y_flat = torch.from_numpy(y).to(dev).long().view(-1, 1)
    with torch.no_grad():
        params = {n: a.data for n, a in mod.get_params()[0].items()}
        want = plain_train_loss(torch, params, torch.from_numpy(x).to(dev),
                                torch.from_numpy(y).to(dev)).item()
        del params
    torch.cuda.empty_cache()
    losses = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    st = {}

    def on_batch(param):
        out = mod.get_outputs()[0].data
        losses.append(-(out.gather(1, y_flat) + 1e-12).log().mean())
        done = param.nbatch + 1
        if done == 1:
            torch.cuda.synchronize()
            st["first_s"] = time.perf_counter() - st["t0"]
        if done == 1 + ADAM_WARM:
            start.record()
        if done == steps - 1:
            end.record()
            torch.cuda.synchronize()
            prof.start()
            st["t_prof"] = time.perf_counter()
        if done == steps:
            torch.cuda.synchronize()
            st["wall"] = time.perf_counter() - st["t_prof"]
            prof.stop()

    fit_args = adam_fit_args(mt)
    # the main path: counters zeroed just before, read just after
    for fn in counters.values():
        fn.launches = {"f32": 0, "bf16": 0}
    c0 = ckpt_counters()
    st["t0"] = time.perf_counter()
    mod.fit(RepeatIter(db, steps, (B, T), (B, T)), num_epoch=1,
            batch_end_callback=on_batch,
            checkpoint=mt.checkpoint.CheckpointConfig(
                str(ckpt_dir), period_epochs=1, async_save=True,
                keep_last=0), **fit_args)
    fit_s = time.perf_counter() - st["t0"]
    launches = {n: dict(fn.launches) for n, fn in counters.items()}
    ck = ckpt_delta(c0)
    step_ms = start.elapsed_time(end) / ADAM_TIMED
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rows, busy_ms = device_breakdown(torch, prof, st["wall"], "adam step")
    by_kind = {}
    for e in rows:
        kind = kernel_kind(e.key)
        by_kind[kind] = by_kind.get(kind, 0.0) + \
            e.self_device_time_total / 1e3
    log("adam step device time by kind: " + ", ".join(
        "%s %.3f ms" % kv for kv in sorted(by_kind.items(),
                                           key=lambda kv: -kv[1])))
    names, values = fit_args["eval_metric"].get()
    log("adam fit: %d steps in %.3f s, metrics %s" % (
        steps, fit_s, dict(zip(names, values))))
    check(all(math.isfinite(v) for v in values), "non-finite metric %s"
          % values)
    check(abs(math.log(values[1]) - values[0]) <= 1e-3, "perplexity %g is "
          "not exp of the cross-entropy %g" % (values[1], values[0]))
    ckpts = mt.checkpoint.list_checkpoints(str(ckpt_dir))
    check([s for s, _ in ckpts] == [steps] and
          mt.checkpoint.probe_valid(ckpts[0][1]),
          "the epoch's checkpoint did not land: %s" % ckpts)
    log("adam fit checkpoint (%d layers, weights + mean + var): %d bytes; "
        "fit blocked %.3f s on it, the writer took %.3f s"
        % (ADAM_LAYERS, ck["ckpt_bytes"], ck["ckpt_block_us"] / 1e6,
           ck["ckpt_write_us"] / 1e6))
    check(ck["ckpt_saved"] == 1, "checkpoints written: %d" % ck["ckpt_saved"])
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    losses = [float(v) for v in torch.stack(losses).cpu()]
    del mod, db
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "want": want, "step_ms": step_ms,
            "bind_s": bind_s, "first_s": st["first_s"], "timed": ADAM_TIMED,
            "launches": launches, "peak_gb": peak_gb, "busy_ms": busy_ms,
            "att_ms": by_kind.get("attention kernels", 0.0),
            "opt_ms": by_kind.get("optimizer (foreach)", 0.0),
            "by_kind": by_kind, "ckpt": ck}


def param_dist(a, b) -> float:
    return max((a[n] - b[n]).abs().max().item() for n in a)


def resume_check(torch, np):
    """(c) Resume at the full width and RESUME_LAYERS of the 12 layers
    (amp bf16 set by the caller): an uninterrupted fit of RESUME_EPOCHS
    epochs of RESUME_BATCHES batches with an async checkpoint each
    epoch; the first epoch's checkpoint restored into a fresh module
    must hold the saved parameters, Adam states, count and rate bit for
    bit, and a fresh ``fit(resume_from=...)`` must end on the
    uninterrupted run's weights (bit for bit, or, where an op on the
    path is not deterministic, no further than a second uninterrupted
    run)."""
    import shutil
    import warnings
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.models import transformer
    t_phase = time.perf_counter()
    B, T = TRAIN_BATCH, MAX_SEQ
    n_params = transformer.param_count(VOCAB, RESUME_LAYERS, D_MODEL, HEADS,
                                       D_FF, T)
    full = transformer.param_count(VOCAB, LAYERS, D_MODEL, HEADS, D_FF, T)
    log("resume: full width, %d of %d layers (cut from the depth only): "
        "%.1fM parameters, an Adam checkpoint %.2f GB (weights, mean, var; "
        "the full depth would be %.2f GB a save)"
        % (RESUME_LAYERS, LAYERS, n_params / 1e6, 12 * n_params / 1e9,
           12 * full / 1e9))
    base = ROOT / "build" / "phase11_resume"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    check_disk(base, int(1.1 * 12 * n_params * RESUME_EPOCHS), "resume")
    rng = np.random.RandomState(1)
    x = rng.randint(0, VOCAB, (RESUME_BATCHES * B, T)).astype(np.float32)
    y = rng.randint(0, VOCAB, (RESUME_BATCHES * B, T)).astype(np.float32)
    sym = transformer.get_symbol(VOCAB, RESUME_LAYERS, D_MODEL, HEADS, D_FF,
                                 T, attention="flash")
    probe = mt.mod.Module(sym, context=mt.gpu(0))
    probe.bind(data_shapes=[("data", (B, T))],
               label_shapes=[("softmax_label", (B, T))])
    probe.init_params(mt.init.Xavier().set_rng(
        np.random.default_rng(SEED + 1)))
    init = {n: mt.nd.NDArray(a.data.clone())
            for n, a in probe.get_params()[0].items()}
    del probe
    saved = {}

    def run(ckpt=None, resume=None, keep=None):
        mt.random.seed(SEED)
        mod = mt.mod.Module(sym, context=mt.gpu(0))
        cbs = []
        if keep is not None:
            def remember(param):
                o = mod._optimizer
                keep.setdefault("lr", {})[o.num_update] = \
                    o.lr_scheduler(o.num_update)
                if param.epoch == 0 and param.nbatch == RESUME_BATCHES - 1:
                    keep["params"] = {n: a.data.clone() for n, a in
                                      mod.get_params()[0].items()}
                    keep["states"] = {n: tuple(s.data.clone() for s in st)
                                      for n, st in
                                      mod._named_states().items()}
                    keep["num_update"] = o.num_update
            cbs.append(remember)
        mod.fit(mt.io.NDArrayIter(x, y, batch_size=B),
                num_epoch=RESUME_EPOCHS, batch_end_callback=cbs,
                arg_params=None if resume else init, checkpoint=ckpt,
                resume_from=resume, **adam_fit_args(mt))
        return mod, {n: a.data.clone() for n, a in
                     mod.get_params()[0].items()}

    c0 = ckpt_counters()
    t0 = time.perf_counter()
    mod_a, final_a = run(ckpt=mt.checkpoint.CheckpointConfig(
        str(base), period_epochs=1, async_save=True, keep_last=0),
        keep=saved)
    fit_s = time.perf_counter() - t0
    ck = ckpt_delta(c0)
    ckpts = mt.checkpoint.list_checkpoints(str(base))
    check([s for s, _ in ckpts] ==
          [RESUME_BATCHES * (e + 1) for e in range(RESUME_EPOCHS)],
          "resume: checkpoints %s" % ckpts)
    del mod_a
    gc.collect()
    torch.cuda.empty_cache()
    # resume from the first epoch's checkpoint: the later ones go
    for _, path in ckpts[1:]:
        shutil.rmtree(path)
    first = ckpts[0][1]
    nbytes = sum(f.stat().st_size for f in Path(first).iterdir())
    t0 = time.perf_counter()
    ckpt = mt.checkpoint.restore_latest(str(base))
    read_s = time.perf_counter() - t0
    log("resume checkpoint: %d bytes (%d saves); fit blocked %.3f s a save, "
        "the writer took %.3f s a save (fit %.3f s in all); the verified "
        "read (crc32 of every array) %.3f s"
        % (nbytes, ck["ckpt_saved"], ck["ckpt_block_us"] / 1e6 /
           ck["ckpt_saved"], ck["ckpt_write_us"] / 1e6 / ck["ckpt_saved"],
           fit_s, read_s))
    # the restored state against the saved one, bit for bit
    mod_r = mt.mod.Module(sym, context=mt.gpu(0))
    mod_r.bind(data_shapes=[("data", (B, T))],
               label_shapes=[("softmax_label", (B, T))])
    mod_r.init_params(arg_params=ckpt.arg_params_nd())
    fit_args = adam_fit_args(mt)
    mod_r.init_optimizer(optimizer=fit_args["optimizer"],
                         optimizer_params=fit_args["optimizer_params"])
    mod_r._checkpoint_restore(ckpt)
    o = mod_r._optimizer
    bad = [n for n, a in mod_r.get_params()[0].items()
           if not torch.equal(a.data, saved["params"][n])]
    bad += [n for n, st in mod_r._named_states().items()
            for a, b in zip(st, saved["states"][n])
            if not torch.equal(a.data, b)]
    next_lr = o.lr_scheduler(o.num_update + 1)
    check(not bad, "resume: restored arrays differ from the saved: %s"
          % bad[:5])
    check(o.num_update == saved["num_update"] == RESUME_BATCHES,
          "resume: num_update %d, saved %d" % (o.num_update,
                                               saved["num_update"]))
    check(next_lr == saved["lr"][o.num_update + 1], "resume: rate %r, the "
          "uninterrupted run's %r" % (next_lr, saved["lr"][o.num_update + 1]))
    log("resume: %d parameters and %d Adam states restored bit for bit, "
        "num_update %d, next rate %g as the uninterrupted run's"
        % (len(saved["params"]), 2 * len(saved["states"]), o.num_update,
           next_lr))
    del mod_r, ckpt, saved
    gc.collect()
    torch.cuda.empty_cache()
    mod_c, final_c = run(resume=str(base))
    check(mod_c._optimizer.num_update == RESUME_BATCHES * RESUME_EPOCHS,
          "resumed run ended at count %d" % mod_c._optimizer.num_update)
    del mod_c
    d_resume = param_dist(final_c, final_a)
    if d_resume == 0.0:
        log("resume: the resumed run's final weights equal the "
            "uninterrupted run's bit for bit")
    else:
        _, final_d = run()
        d_second = param_dist(final_d, final_a)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                run()
            finally:
                torch.use_deterministic_algorithms(False)
        ops = sorted({str(w.message).split("\n")[0][:160] for w in caught
                      if "deterministic" in str(w.message)})
        log("resume: final weights %.3g (max |diff|) from the uninterrupted "
            "run's; a second uninterrupted run %.3g; not deterministic on "
            "this path: %s" % (d_resume, d_second, ops or "none named"))
        check(d_second > 0 and d_resume <= d_second, "resume: the resumed "
              "run is %.3g from the uninterrupted one, a second "
              "uninterrupted run %.3g" % (d_resume, d_second))
    shutil.rmtree(base, ignore_errors=True)
    del final_a, final_c, init
    gc.collect()
    torch.cuda.empty_cache()
    log("resume phase: %.1f s" % (time.perf_counter() - t_phase))


def dcgan_nets(mt):
    """The upstream Gluon DCGAN's generator and discriminator
    (example/gluon/dcgan.py) at DCGAN_NGF / DCGAN_NDF."""
    nn = mt.gluon.nn
    ngf, ndf = DCGAN_NGF, DCGAN_NDF
    g = nn.HybridSequential(prefix="smoke_g_")
    with g.name_scope():
        for i, (ch, k, s, p) in enumerate([(ngf * 8, 4, 1, 0),
                                           (ngf * 4, 4, 2, 1),
                                           (ngf * 2, 4, 2, 1),
                                           (ngf, 4, 2, 1)]):
            g.add(nn.Conv2DTranspose(ch, k, s, p, use_bias=False))
            g.add(nn.BatchNorm())
            g.add(nn.Activation("relu"))
        g.add(nn.Conv2DTranspose(3, 4, 2, 1, use_bias=False))
        g.add(nn.Activation("tanh"))
    d = nn.HybridSequential(prefix="smoke_d_")
    with d.name_scope():
        d.add(nn.Conv2D(ndf, 4, 2, 1, use_bias=False))
        d.add(nn.LeakyReLU(0.2))
        for ch in (ndf * 2, ndf * 4, ndf * 8):
            d.add(nn.Conv2D(ch, 4, 2, 1, use_bias=False))
            d.add(nn.BatchNorm())
            d.add(nn.LeakyReLU(0.2))
        d.add(nn.Conv2D(1, 4, 1, 0, use_bias=False))
    return g, d


def dcgan_check(torch, np):
    """(d) The upstream Gluon DCGAN at its widths (nz 100, ngf 64, ndf
    64, 64x64x3, batch 64) on seeded uniform images in [-1, 1] (the
    dataset is not in the repository), two ``Trainer("adam", lr 2e-4,
    beta1 0.5)``: DCGAN_STEPS alternating D/G steps with finite losses,
    the ms a step; then both Trainers' ``save_states``, DCGAN_CONTINUE
    more steps, and the same steps again from the saved parameters with
    fresh Trainers that ``load_states`` (``begin_num_update`` at the
    saved count: the file holds no counts): equal bit for bit (cuDNN's
    deterministic algorithms for these steps)."""
    import shutil
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import autograd, gluon
    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    B, nz, S = DCGAN_BATCH, DCGAN_NZ, DCGAN_SIZE
    rng = np.random.RandomState(SEED + 5)
    images = mt.nd.array(rng.uniform(-1, 1, (B, 3, S, S)).astype(np.float32),
                         ctx=dev)
    steps = DCGAN_STEPS + DCGAN_CONTINUE
    noise = [mt.nd.array(rng.normal(0, 1, (B, nz, 1, 1)).astype(np.float32),
                         ctx=dev) for _ in range(steps)]
    real = mt.nd.array(np.ones((B,), np.float32), ctx=dev)
    fake_label = mt.nd.array(np.zeros((B,), np.float32), ctx=dev)
    net_g, net_d = dcgan_nets(mt)
    init = mt.init.Normal(0.02).set_rng(np.random.default_rng(SEED + 6))
    net_g.initialize(init, ctx=mt.gpu(0))
    net_d.initialize(init, ctx=mt.gpu(0))
    opt = {"learning_rate": DCGAN_LR, "beta1": DCGAN_BETA1}
    trainers = [gluon.Trainer(net_d.collect_params(), "adam", dict(opt)),
                gluon.Trainer(net_g.collect_params(), "adam", dict(opt))]
    loss_fn = gluon.loss.SigmoidBinaryCrossEntropyLoss()

    def step(k, tr_d, tr_g):
        with autograd.record():
            out = net_d(images).reshape((-1, 1))
            err_real = loss_fn(out, real)
            fake = net_g(noise[k])
            out = net_d(fake.detach()).reshape((-1, 1))
            err_d = err_real + loss_fn(out, fake_label)
        err_d.backward()
        tr_d.step(B)
        with autograd.record():
            fake = net_g(noise[k])
            out = net_d(fake).reshape((-1, 1))
            err_g = loss_fn(out, real)
        err_g.backward()
        tr_g.step(B)
        return err_d.data.detach().mean(), err_g.data.detach().mean()

    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(DCGAN_STEPS + 1)]
    losses = []
    events[0].record()
    for k in range(DCGAN_STEPS):
        losses.append(step(k, *trainers))
        events[k + 1].record()
    torch.cuda.synchronize()
    per_step = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    losses = [(float(d), float(g)) for d, g in losses]
    log("dcgan (nz %d, ngf %d, ndf %d, %dx%dx3, batch %d, Adam lr %g beta1 "
        "%g): ms a step (D then G) %s (the first holds deferred init); "
        "losses D/G %s" % (nz, DCGAN_NGF, DCGAN_NDF, S, S, B, DCGAN_LR,
                           DCGAN_BETA1, " ".join("%.3f" % t for t in per_step),
                           " ".join("%.4f/%.4f" % dg for dg in losses)))
    check(all(math.isfinite(v) for dg in losses for v in dg),
          "dcgan: non-finite loss %s" % losses)
    params = list(net_d.collect_params().values()) + \
        list(net_g.collect_params().values())
    base = ROOT / "build" / "phase11_dcgan"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    files = [str(base / "d.states"), str(base / "g.states")]
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        snap = [p.data().data.clone() for p in params]
        for tr, f in zip(trainers, files):
            tr.save_states(f)
        for k in range(DCGAN_STEPS, steps):
            step(k, *trainers)
        want = [p.data().data.clone() for p in params]
        for p, v in zip(params, snap):
            p.set_data(mt.nd.NDArray(v.clone()))
        fresh = [gluon.Trainer(net.collect_params(), "adam", dict(
            opt, begin_num_update=DCGAN_STEPS)) for net in (net_d, net_g)]
        for tr, f in zip(fresh, files):
            tr.load_states(f)
        for k in range(DCGAN_STEPS, steps):
            step(k, *fresh)
        bad = [p.name for p, w in zip(params, want)
               if not torch.equal(p.data().data, w)]
    finally:
        torch.backends.cudnn.deterministic = prev
    nbytes = sum(Path(f).stat().st_size for f in files)
    check(not bad, "dcgan: %d arrays differ after load_states: %s"
          % (len(bad), bad[:5]))
    log("dcgan: save_states of both Trainers (%d bytes), then %d steps: "
        "fresh Trainers after load_states end on the same %d arrays bit "
        "for bit; %.1f s" % (nbytes, DCGAN_CONTINUE, len(params),
                             time.perf_counter() - t_phase))
    shutil.rmtree(base, ignore_errors=True)
    del net_g, net_d, trainers, params, snap, want
    gc.collect()
    torch.cuda.empty_cache()


def optim_phase(torch, np, sgd):
    """Phase 11: (a) every optimizer on the card, (b) the LM with Adam
    through fit beside phase 6's SGD step ``sgd``, (c) resume, (d) the
    Gluon DCGAN."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.ops import flash_attention as fa
    t0 = time.perf_counter()
    optimizer_check(torch)
    counters = {"flash_attention_fwd_bf16": fa.flash_attention_fwd,
                "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
                "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv}
    mt.amp.init("bfloat16")
    try:
        run = adam_lm(torch, np, counters)
        check_training("adam", run, "bf16", PEAK_BF16_FLOPS, "bf16",
                       layers=ADAM_LAYERS)
        n_embed = VOCAB * D_MODEL + MAX_SEQ * D_MODEL
        for what, r, layers in (("sgd (phase 6)", sgd, LAYERS),
                                ("adam", run, ADAM_LAYERS)):
            n_params = transformer.param_count(VOCAB, layers, D_MODEL, HEADS,
                                               D_FF, MAX_SEQ)
            flops = (6 * (n_params - n_embed)
                     + 12 * layers * D_MODEL * MAX_SEQ) \
                * TRAIN_BATCH * MAX_SEQ
            tok_s = TRAIN_BATCH * MAX_SEQ / (r["step_ms"] / 1e3)
            log("%s (%d layers): step %.3f ms, %.1f tok/s, MFU %.4f of 989 "
                "TFLOP/s bf16, peak memory %.3f GB, optimizer (foreach) %.3f "
                "ms of %.3f ms device time in the profiled step"
                % (what, layers, r["step_ms"], tok_s,
                   flops / (r["step_ms"] / 1e3) / PEAK_BF16_FLOPS,
                   r["peak_gb"], r["by_kind"].get("optimizer (foreach)", 0.0),
                   r["busy_ms"]))
        resume_check(torch, np)
    finally:
        mt.amp.off()
    dcgan_check(torch, np)
    log("optimizer phase: %.1f s" % (time.perf_counter() - t0))

# --------------------------------------------- the op library and zoo nets

def op_cases(np):
    """Phase 12a's cases: every canonical op of the port's ``ops``
    package but the samplers (12b), FlashAttention (held to its plain
    versions at KERNEL_ATOL by phases 3, 5 and 9) and the structured
    families (phase 13a), at small seeded shapes, plus the out-of-range
    and tie cases of the indexing ops.
    Returns ``[(label, op name, [numpy inputs], attrs)]``."""
    from mxnet_tpu_torch.ops import OP_REGISTRY
    from mxnet_tpu_torch.ops.rnn_op import rnn_param_size
    rng = np.random.RandomState(SEED)

    def r(*shape, lo=-1.0, hi=1.0):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    def pos(*shape):
        return r(*shape, lo=0.3, hi=2.0)

    def f(*values):
        return np.array(values, np.float32)

    a = r(3, 3)
    spd = (a @ a.T + 3 * np.eye(3)).astype(np.float32)
    low = (np.tril(pos(3, 3)) + np.eye(3)).astype(np.float32)
    ties = f(3, 1, 3, 2, 1, 3, 0, 0, 5, 0, 5, 0).reshape(2, 6)
    special = {
        "Activation": ([r(2, 3)], {"act_type": "tanh"}),
        "BatchNorm": ([r(2, 3, 4, 4), pos(3), r(3), r(3), pos(3)], {}),
        "Concat": ([r(2, 3), r(2, 3)], {"dim": 1}),
        "Convolution": ([r(2, 3, 6, 6), r(4, 3, 3, 3), r(4)],
                        {"kernel": (3, 3), "num_filter": 4, "pad": (1, 1)}),
        "Crop": ([r(1, 2, 6, 6), r(1, 2, 4, 4)], {"offset": (1, 1)}),
        "Deconvolution": ([r(1, 2, 5, 5), r(2, 4, 3, 3), r(4)],
                          {"kernel": (3, 3), "num_filter": 4,
                           "stride": (2, 2)}),
        "Dropout": ([r(2, 3)], {"p": 0.0}),
        "Embedding": ([f(0, 2, 1, 0).reshape(2, 2), r(4, 3)],
                      {"input_dim": 4, "output_dim": 3}),
        "Flatten": ([r(2, 3, 4)], {}),
        "FullyConnected": ([r(2, 3), r(4, 3), r(4)], {"num_hidden": 4}),
        "IdentityAttachKLSparseReg": ([pos(2, 3) / 4, pos(3) / 4], {}),
        "InstanceNorm": ([r(2, 3, 4, 4), pos(3), r(3)], {}),
        "LayerNorm": ([r(2, 3, 8), pos(8), r(8)], {}),
        "LRN": ([r(2, 6, 5, 5)], {"nsize": 5}),
        "LeakyReLU": ([r(2, 3)], {"act_type": "leaky"}),
        "LinearRegressionOutput": ([r(2, 3), r(2, 3)], {}),
        "LogisticRegressionOutput": ([r(2, 3), r(2, 3)], {}),
        "MAERegressionOutput": ([r(2, 3), r(2, 3)], {}),
        "Pad": ([r(1, 2, 3, 3)], {"mode": "reflect",
                                  "pad_width": (0, 0, 0, 0, 1, 2, 2, 1)}),
        "Pooling": ([r(1, 2, 5, 5)], {"kernel": (3, 3), "pool_type": "max",
                                      "stride": (2, 2)}),
        "RNN": ([r(3, 2, 4), r(rnn_param_size(1, 4, 4, "lstm")),
                 r(1, 2, 4), r(1, 2, 4)],
                {"state_size": 4, "num_layers": 1, "mode": "lstm"}),
        "Reshape": ([r(2, 6)], {"shape": (3, -1)}),
        "SVMOutput": ([r(2, 3), f(0, 2)], {}),
        "SequenceLast": ([r(3, 2, 4)], {}),
        "SequenceMask": ([r(3, 2, 4)], {}),
        "SequenceReverse": ([r(3, 2, 4)], {}),
        "SliceChannel": ([r(2, 4)], {"num_outputs": 2}),
        "SoftmaxOutput": ([r(2, 3), f(0, 2)], {}),
        "SwapAxis": ([r(2, 3)], {"dim1": 0, "dim2": 1}),
        "UpSampling": ([r(1, 2, 3, 3)], {"scale": 2,
                                         "sample_type": "bilinear"}),
        "_arange": ([], {"start": 0, "stop": 6}),
        "_eye": ([], {"N": 3, "k": 1}),
        "_full": ([], {"shape": (2, 3), "value": 1.5}),
        "_ones": ([], {"shape": (2, 3)}),
        "_zeros": ([], {"shape": (2, 3)}),
        "_power_scalar": ([pos(2, 3)], {"scalar": 2.0}),
        "_rpower_scalar": ([r(2, 3)], {"scalar": 2.0}),
        "_mod_scalar": ([r(2, 3, lo=-3, hi=3)], {"scalar": 1.3}),
        "add_n": ([r(2, 3), r(2, 3), r(2, 3)], {}),
        "batch_dot": ([r(2, 3, 4), r(2, 4, 3)], {}),
        "batch_take": ([r(2, 3), f(0, 2)], {}),
        "broadcast_axis": ([r(1, 3)], {"axis": 0, "size": 2}),
        "broadcast_to": ([r(1, 3)], {"shape": (2, 0)}),
        "clip": ([r(2, 3)], {"a_min": -0.5, "a_max": 0.5}),
        "dot": ([r(2, 3, 4), r(3, 2)], {"transpose_a": True}),
        "expand_dims": ([r(2, 3)], {"axis": 1}),
        "gather_nd": ([r(3, 4), f(0, 2, 1, 3).reshape(2, 2)], {}),
        "khatri_rao": ([r(2, 3), r(4, 3)], {}),
        "linalg_gemm": ([r(2, 3), r(3, 2), r(2, 2)], {"alpha": 0.5}),
        "linalg_gemm2": ([r(2, 3), r(2, 2)], {"transpose_a": True}),
        "linalg_potrf": ([spd], {}),
        "linalg_potri": ([spd], {}),
        "linalg_sumlogdiag": ([spd], {}),
        "linalg_trmm": ([low, r(3, 3)], {"rightside": True}),
        "linalg_trsm": ([low, r(3, 3)], {"transpose": True}),
        "one_hot": ([f(0, 2, 1)], {"depth": 3}),
        "pick": ([r(2, 3), f(0, 2)], {}),
        "repeat": ([r(2, 3)], {"repeats": 2, "axis": 1}),
        "reverse": ([r(2, 3)], {"axis": 1}),
        "slice": ([r(3, 4)], {"begin": (None, 3), "end": (2, 0),
                              "step": (1, -1)}),
        "slice_axis": ([r(3, 4)], {"axis": 1, "begin": 1, "end": 3}),
        "sort": ([ties], {"is_ascend": False}),
        "argsort": ([ties], {"is_ascend": False}),
        "topk": ([ties], {"k": 3, "ret_typ": "both"}),
        "stack": ([r(2, 3), r(2, 3)], {"axis": 1}),
        "take": ([r(4, 3), f(0, 2)], {}),
        "tile": ([r(2, 3)], {"reps": (2, 1)}),
        "where": ([f(1, 0, 1, 0, 1, 0).reshape(2, 3), r(2, 3), r(2, 3)], {}),
    }
    domain = {"arccos": (-0.8, 0.8), "arcsin": (-0.8, 0.8),
              "arctanh": (-0.8, 0.8), "erfinv": (-0.8, 0.8),
              "arccosh": (1.2, 3.0), "log": (0.3, 3.0), "log10": (0.3, 3.0),
              "log2": (0.3, 3.0), "log1p": (-0.5, 3.0), "sqrt": (0.3, 3.0),
              "rsqrt": (0.3, 3.0), "cbrt": (0.3, 3.0), "rcbrt": (0.3, 3.0),
              "gamma": (0.5, 3.0), "gammaln": (0.5, 3.0),
              "reciprocal": (0.3, 3.0), "norm": (0.3, 3.0),
              "_rdiv_scalar": (0.3, 2.0), "elemwise_div": (0.3, 2.0)}
    canonical = {}
    for op in OP_REGISTRY.values():
        if op.__module__.startswith("mxnet_tpu_torch.ops.") and \
                op.__module__.rsplit(".", 1)[-1] not in STRUCTURED and \
                not op.is_random and op.name != "FlashAttention":
            canonical[op.name] = op
    cases = []
    for name in sorted(canonical):
        op = canonical[name]
        if name in special:
            ins, attrs = special[name]
        elif name.endswith("_scalar"):
            ins, attrs = [r(2, 3, lo=domain.get(name, (-1, 1))[0],
                            hi=domain.get(name, (-1, 1))[1])], \
                {"scalar": 1.5}
        elif name.startswith("broadcast_") or name == "elemwise_div":
            ins, attrs = [pos(2, 3), pos(1, 3)], {}
        else:
            lo, hi = domain.get(name, (-1.0, 1.0))
            ins, attrs = [r(2, 3, lo=lo, hi=hi)
                          for _ in range(op.num_inputs)], {}
        cases.append((name, name, ins, attrs))
    # out of range (the reference's values without a device assert) and
    # ties
    cases += [
        ("pick out of range (C9)", "pick",
         [np.arange(12, dtype=np.float32).reshape(3, 4), f(0, 5, -1)], {}),
        ("Embedding out of range (C11)", "Embedding",
         [f(-1, 5, 1), np.arange(6, dtype=np.float32).reshape(3, 2)],
         {"input_dim": 3, "output_dim": 2}),
        ("take wrap", "take", [r(4, 3), f(-7, -1, 5, 11)], {"mode": "wrap"}),
        ("take clip", "take", [r(4, 3), f(-7, -1, 5, 11)], {"axis": 1}),
        ("batch_take out of range", "batch_take", [r(3, 4), f(-1, 4, -9)],
         {}),
        ("one_hot out of range", "one_hot", [f(-1, 3, 7)], {"depth": 3}),
        ("gather_nd out of range", "gather_nd",
         [r(4, 3), f(-5, -1, 5, 2, 0, -1, 7, -4).reshape(2, 4)], {}),
        ("topk mask", "topk", [ties], {"k": 2, "ret_typ": "mask"}),
        ("topk ascending", "topk", [ties], {"k": 4, "is_ascend": True,
                                            "ret_typ": "value"}),
        ("argsort ascending", "argsort", [ties], {"axis": 0}),
    ]
    return cases


def op_run(torch, op, inputs, attrs, device, seed):
    """One case on ``device``: the outputs, and the gradient of every
    floating input but the aux states under a seeded random head over
    the visible floating outputs (None where no output is
    differentiable)."""
    ts = [torch.from_numpy(a.copy()).to(device) for a in inputs]
    wrt = [t for t in ts[:len(ts) - op.num_aux] if t.is_floating_point()]
    for t in wrt:
        t.requires_grad_(True)
    kw = dict(attrs)
    if op.num_inputs == 0:
        kw["_device"] = torch.device(device)
    outs = op.fn(*ts, **kw)
    outs = outs if isinstance(outs, tuple) else (outs,)
    vis = [o for o in outs[:len(outs) - op.num_aux - op.num_hidden_outputs]
           if o.requires_grad]
    grads = None
    if vis and wrt:
        gen = torch.Generator().manual_seed(seed)
        heads = [torch.randn(o.shape, generator=gen).to(device, o.dtype)
                 for o in vis]
        grads = torch.autograd.grad(vis, wrt, heads, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(wrt, grads)]
    host = lambda t: t.detach().double().cpu()  # noqa: E731
    return [host(o) for o in outs], \
        None if grads is None else [host(g) for g in grads]


def op_err(torch, got, want):
    """The largest difference over max(1, max|want|); inf where NaN does
    not stand where ``want`` has NaN."""
    if got.shape != want.shape or not torch.equal(torch.isnan(got),
                                                  torch.isnan(want)):
        return math.inf
    fin = ~torch.isnan(want)
    if not fin.any():
        return 0.0
    scale = max(1.0, float(want[fin].abs().max()))
    return float((got[fin] - want[fin]).abs().max()) / scale


def op_sweep(torch, np, device=None):
    """12a. Every case of :func:`op_cases` on ``device`` (the card) and
    on the CPU from the same seeded inputs, float32 with TF32 off:
    outputs within OPS_FWD_RTOL and gradients within OPS_GRAD_RTOL of
    max(1, max|cpu|), each case fatal. Returns the readings."""
    from mxnet_tpu_torch.ops import get_op
    device = device or DEVICE
    cases = op_cases(np)
    worst = {"fwd": (0.0, None), "grad": (0.0, None)}
    n_grad = 0
    for i, (label, name, inputs, attrs) in enumerate(cases):
        op = get_op(name)
        outs, grads = op_run(torch, op, inputs, attrs, device, SEED + i)
        c_outs, c_grads = op_run(torch, op, inputs, attrs, "cpu", SEED + i)
        check(len(outs) == len(c_outs), "op sweep %s: %d outputs on %s, %d "
              "on the CPU" % (label, len(outs), device, len(c_outs)))
        for j, (g, w) in enumerate(zip(outs, c_outs)):
            err = op_err(torch, g, w)
            if err > worst["fwd"][0]:
                worst["fwd"] = (err, "%s output %d" % (label, j))
            check(err <= OPS_FWD_RTOL, "op sweep %s: output %d differs from "
                  "the CPU's by %.3g of max(1, max|cpu|) (limit %g)"
                  % (label, j, err, OPS_FWD_RTOL))
        check((grads is None) == (c_grads is None), "op sweep %s: a "
              "gradient on one device only" % label)
        if grads is None:
            continue
        n_grad += 1
        for j, (g, w) in enumerate(zip(grads, c_grads)):
            err = op_err(torch, g, w)
            if err > worst["grad"][0]:
                worst["grad"] = (err, "%s gradient %d" % (label, j))
            check(err <= OPS_GRAD_RTOL, "op sweep %s: gradient of input %d "
                  "differs from the CPU's by %.3g of max(1, max|cpu|) "
                  "(limit %g)" % (label, j, err, OPS_GRAD_RTOL))
    n_ops = len({name for _, name, _, _ in cases})
    log("op sweep: %d ops in %d cases on %s against the CPU (%d with "
        "gradients); worst forward %.3g (%s), worst gradient %.3g (%s); "
        "limits %g / %g of max(1, max|cpu|)"
        % (n_ops, len(cases), device, n_grad, worst["fwd"][0],
           worst["fwd"][1], worst["grad"][0], worst["grad"][1],
           OPS_FWD_RTOL, OPS_GRAD_RTOL))
    return {"ops": n_ops, "cases": len(cases), "worst": worst}


def out_of_range_check(torch, device=None):
    """12a. C9 and C11 on the card: the reference's values (``jnp``'s
    wrap and NaN fill), and the device still works after them (an index
    outside an axis reaching a gather would be a device-side assert)."""
    from mxnet_tpu_torch.ops import get_op
    dev = torch.device(device or DEVICE)
    nan = float("nan")
    x = torch.arange(12.0, device=dev).reshape(3, 4)
    got = get_op("pick").fn(x, torch.tensor([0.0, 5.0, -1.0], device=dev))
    w = torch.arange(6.0, device=dev).reshape(3, 2)
    emb = get_op("Embedding").fn(torch.tensor([-1.0, 5.0, 1.0], device=dev),
                                 w)
    torch.cuda.synchronize()
    for what, t, want in (("pick", got, [0.0, nan, 11.0]),
                          ("Embedding", emb, [[4.0, 5.0], [nan, nan],
                                              [2.0, 3.0]])):
        want = torch.tensor(want, dtype=torch.float64)
        check(op_err(torch, t.double().cpu(), want) == 0.0,
              "%s out of range on %s: %s, the reference gives %s"
              % (what, dev, t.cpu().tolist(), want.tolist()))
    check(float((x + 1).sum()) == 78.0, "the device failed after the "
          "out-of-range gathers")
    log("out of range on %s: pick [0, 5, -1] -> %s, Embedding [-1, 5, 1] "
        "-> %s (the reference's), the device still runs"
        % (dev, got.cpu().tolist(), emb.cpu().tolist()))


def sampler_cases():
    """12b. ``(op, attrs, scipy distribution, discrete)`` per sampler."""
    from scipy import stats
    return (
        ("_random_uniform", {"low": -1.0, "high": 3.0},
         stats.uniform(loc=-1.0, scale=4.0), False),
        ("_random_normal", {"loc": 0.5, "scale": 2.0},
         stats.norm(loc=0.5, scale=2.0), False),
        ("_random_gamma", {"alpha": 2.5, "beta": 0.8},
         stats.gamma(2.5, scale=0.8), False),
        ("_random_exponential", {"lam": 1.5},
         stats.expon(scale=1 / 1.5), False),
        ("_random_poisson", {"lam": 4.0}, stats.poisson(4.0), True),
        ("_random_negative_binomial", {"k": 3, "p": 0.4},
         stats.nbinom(3, 0.4), True),
        # mean mu, variance mu + alpha mu^2: NB(1/alpha, 1/(1 + alpha mu))
        ("_random_generalized_negative_binomial", {"mu": 2.0, "alpha": 0.5},
         stats.nbinom(1 / 0.5, 1 / (1 + 0.5 * 2.0)), True),
    )


def chi2_p(np, counts, probs, n):
    """The χ² goodness-of-fit p-value of ``counts`` against ``probs``
    (both over the same categories), merging categories expected fewer
    than 5 times into their neighbour."""
    from scipy import stats
    obs, exp = [], []
    o_acc = e_acc = 0.0
    for o, p in zip(counts, probs):
        o_acc += o
        e_acc += p * n
        if e_acc >= 5:
            obs.append(o_acc)
            exp.append(e_acc)
            o_acc = e_acc = 0.0
    if e_acc or o_acc:
        obs[-1] += o_acc
        exp[-1] += e_acc
    obs, exp = np.array(obs), np.array(exp)
    return float(stats.chisquare(obs, exp * obs.sum() / exp.sum()).pvalue)


def sampler_check(torch, np, name, attrs, dist, discrete, n, device=None):
    """12b. ``n`` draws of one sampler on ``device``: mean and variance
    within SAMPLER_SIGMAS standard errors of the distribution's own (the
    variance's from its kurtosis), and a KS test (continuous) or a χ²
    test (discrete) against it, failing below SAMPLER_MIN_P."""
    from scipy import stats
    from mxnet_tpu_torch.ops import get_op
    x = get_op(name).fn(shape=(n,), _device=torch.device(device or DEVICE),
                        **attrs)
    check(x.shape == (n,) and x.dtype == torch.float32,
          "%s: drew %s %s" % (name, tuple(x.shape), x.dtype))
    x = x.double().cpu().numpy()
    mean, var, kurt = (float(v) for v in dist.stats(moments="mvk"))
    se_mean = math.sqrt(var / n)
    se_var = var * math.sqrt((kurt + 2) / n)
    z_mean = (x.mean() - mean) / se_mean
    z_var = (x.var() - var) / se_var
    if discrete:
        k = int(x.max()) + 1
        counts = np.bincount(x.astype(np.int64), minlength=k)
        probs = dist.pmf(np.arange(k))
        probs[-1] += dist.sf(k - 1)
        p = chi2_p(np, counts, probs, n)
        test = "chi2"
    else:
        p = float(stats.kstest(x, dist.cdf).pvalue)
        test = "KS"
    log("sampler %s %s: %d draws, mean %.6f (%+.2f SE), variance %.6f "
        "(%+.2f SE), %s p %.3g" % (name, attrs, n, x.mean(), z_mean,
                                   x.var(), z_var, test, p))
    check(abs(z_mean) <= SAMPLER_SIGMAS and abs(z_var) <= SAMPLER_SIGMAS,
          "%s: mean %.6g / variance %.6g are %.2f / %.2f standard errors "
          "from %.6g / %.6g" % (name, x.mean(), x.var(), z_mean, z_var, mean,
                                var))
    check(p >= SAMPLER_MIN_P, "%s: %s p-value %.3g below %g"
          % (name, test, p, SAMPLER_MIN_P))
    return p


def multinomial_check(torch, np, n, device=None):
    """12b. ``_sample_multinomial``: ``n`` draws from each of two rows of
    probabilities, a χ² test per row, and ``get_prob``'s log-probability
    of each draw; ``shuffle``: a permutation of ``arange(n)``."""
    from mxnet_tpu_torch.ops import get_op
    dev = torch.device(device or DEVICE)
    probs = np.array([[0.1, 0.2, 0.3, 0.4], [0.5, 0.05, 0.05, 0.4]],
                     np.float32)
    ids, logp = get_op("_sample_multinomial").fn(
        torch.from_numpy(probs).to(dev), shape=(n,), get_prob=True)
    check(tuple(ids.shape) == (2, n) and ids.dtype == torch.int32,
          "multinomial: drew %s %s" % (tuple(ids.shape), ids.dtype))
    want = torch.log(torch.from_numpy(probs).to(dev).gather(
        1, ids.long()))
    check(torch.equal(logp, want), "multinomial: get_prob is not the log "
          "of the drawn class's probability")
    ids = ids.cpu().numpy()
    for row in range(2):
        counts = np.bincount(ids[row], minlength=4)
        p = chi2_p(np, counts, probs[row].astype(np.float64), n)
        log("sampler _sample_multinomial row %d %s: %d draws, shares %s, "
            "chi2 p %.3g" % (row, probs[row].tolist(), n,
                             (counts / n).round(5).tolist(), p))
        check(p >= SAMPLER_MIN_P, "multinomial row %d: chi2 p-value %.3g "
              "below %g" % (row, p, SAMPLER_MIN_P))
    x = torch.arange(n, dtype=torch.float32, device=dev)
    y = get_op("shuffle").fn(x)
    check(torch.equal(torch.sort(y).values, x) and not torch.equal(y, x),
          "shuffle did not permute arange(%d)" % n)
    log("shuffle: arange(%d) permuted (%d elements moved)"
        % (n, int((y != x).sum())))


def sampler_phase(torch, np, n=None, device=None):
    """12b: every sampler on the card from ``mt.random.seed(SEED)``."""
    import mxnet_tpu_torch as mt
    n = n or SAMPLER_DRAWS
    mt.random.seed(SEED)
    for name, attrs, dist, discrete in sampler_cases():
        sampler_check(torch, np, name, attrs, dist, discrete, n, device)
    multinomial_check(torch, np, n, device)


def logits_symbol(mt, sym):
    """The graph of ``sym`` up to its loss head's input (the logits), as
    a Symbol: the JSON with that node as the only head."""
    g = json.loads(sym.tojson())
    head = g["nodes"][g["heads"][0][0]]
    g["heads"] = [head["inputs"][0]]
    return mt.sym.load_json(json.dumps(g))


def net_macs(mt, sym, data_shape):
    """Multiply-accumulates of one forward image: every Convolution's
    output elements times its window (C/groups x kernel) and every
    FullyConnected's weight, from the layer shapes ``infer_shape``
    propagates."""
    from mxnet_tpu_torch.symbol import symbol as symmod
    shapes, derived = symmod._propagate_shapes(sym, {"data": data_shape})
    total = 0
    for node in symmod._topo_order(sym._entries):
        if node.is_variable or node.op.name not in ("Convolution",
                                                    "FullyConnected"):
            continue
        w = derived.get(node.inputs[1][0].name)
        if node.op.name == "FullyConnected":
            total += math.prod(w)
        else:
            out = shapes[(id(node), 0)]
            total += math.prod(out[1:]) * math.prod(w[1:])
    return total


def plain_alexnet(torch, p, x):
    """The zoo's AlexNet inference forward in plain float32
    torch.nn.functional, written from models/alexnet.py and independent
    of the port's ops: LRN from its formula (the squares summed over the
    5 channels around each one, zero beyond the edges), no dropout.
    Returns the logits."""
    import torch.nn.functional as F

    def conv(h, name, stride=1, pad=0):
        return torch.relu(F.conv2d(h, p[name + "_weight"], p[name + "_bias"],
                                   stride=stride, padding=pad))

    def lrn(h, nsize=5, alpha=1e-4, beta=0.75, knorm=2.0):
        sq = F.pad(h * h, (0, 0, 0, 0, nsize // 2, nsize // 2))
        c = h.shape[1]
        s = sum(sq[:, i:i + c] for i in range(nsize))
        return h / (knorm + alpha * s / nsize) ** beta

    def fc(h, name):
        return F.linear(h, p[name + "_weight"], p[name + "_bias"])

    h = F.max_pool2d(lrn(conv(x, "conv1", 4)), 3, 2)
    h = F.max_pool2d(lrn(conv(h, "conv2", 1, 2)), 3, 2)
    h = conv(conv(conv(h, "conv3", 1, 1), "conv4", 1, 1), "conv5", 1, 1)
    h = F.max_pool2d(h, 3, 2).flatten(1)
    h = torch.relu(fc(torch.relu(fc(h, "fc1")), "fc2"))
    return fc(h, "fc3")


def alexnet_kind(op: str) -> str:
    """The AlexNet step's device time by kind: ResNet's kinds, with LRN's
    window sum (AlexNet's only average pooling) on its own line."""
    if "avg_pool2d" in op.lower():
        return "LRN window sum (avg_pool2d)"
    return resnet_kind(op)


def lrn_ms(torch, dtype):
    """LRN's forward and backward at AlexNet's two shapes (batch x 96 x
    55 x 55, batch x 256 x 27 x 27) between CUDA events: its share of a
    step."""
    from mxnet_tpu_torch.ops import get_op
    dev = torch.device(DEVICE)
    side = (ALEX_IMAGE - 11) // 4 + 1
    side2 = (side - 3) // 2 + 1
    xs = [torch.randn((ALEX_BATCH, c, s, s), device=dev, dtype=dtype,
                      requires_grad=True)
          for c, s in ((96, side), (256, side2))]

    def run():
        for x in xs:
            out = get_op("LRN").fn(x, nsize=5, alpha=1e-4, beta=0.75,
                                   knorm=2.0)
            torch.autograd.grad(out, x, torch.ones_like(out))
    run()
    return time_ms(torch, run, 5)


def train_alexnet(torch, np, counters, warm, timed, what):
    """12c. The zoo's AlexNet through ``Module.fit`` under whatever amp
    state the caller set: SGD lr ALEX_LR, momentum, wd,
    ``Xavier(magnitude=2)`` from the seed, one fixed RandomState(0)
    batch repeated for 1 + ``warm`` + ``timed`` + 1 steps (the last under
    torch.profiler), read from the batch-end callback. Before it, the
    inference forward (``is_train=False``) of the initial weights,
    through a module bound on the graph up to the logits, against
    :func:`plain_alexnet`. Returns the readings."""
    from torch.profiler import ProfilerActivity, profile
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.models import alexnet
    B, S = ALEX_BATCH, ALEX_IMAGE
    dev = torch.device(DEVICE)
    steps = 1 + warm + timed + 1
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sym = alexnet.get_symbol(num_classes=ALEX_CLASSES)
    mod = mt.mod.Module(sym, context=mt.gpu(0))
    mod.bind(data_shapes=[("data", (B, 3, S, S))],
             label_shapes=[("softmax_label", (B,))])
    mod.init_params(mt.init.Xavier(magnitude=2).set_rng(
        np.random.default_rng(SEED)))
    torch.cuda.synchronize()
    bind_s = time.perf_counter() - t0
    args = mod.get_params()[0]
    n_params = sum(a.size for a in args.values())
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (B, 3, S, S)).astype(np.float32)
    y = rng.randint(0, ALEX_CLASSES, (B,)).astype(np.float32)
    db = mt.io.DataBatch(data=[mt.nd.array(x, ctx=dev)],
                         label=[mt.nd.array(y, ctx=dev)])
    xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev).long()
    # the inference forward of the initial weights, to the logits
    infer = mt.mod.Module(logits_symbol(mt, sym), label_names=None,
                          context=mt.gpu(0))
    infer.bind(data_shapes=[("data", (B, 3, S, S))], for_training=False)
    infer.init_params(arg_params=args)
    infer.forward(mt.io.DataBatch(data=[db.data[0]]), is_train=False)
    logits = infer.get_outputs()[0].data.float()
    with torch.no_grad():
        ref = plain_alexnet(torch, {n: a.data for n, a in args.items()}, xt)
        ref_ce = float(torch.nn.functional.cross_entropy(ref, yt))
        got_ce = float(torch.nn.functional.cross_entropy(logits, yt))
        logits_err = float((logits - ref).abs().max() / ref.abs().max())
    del infer, args
    torch.cuda.empty_cache()
    # Dropout's kept share at the path's shape (fc1's activation)
    from mxnet_tpu_torch.ops import get_op
    ones = torch.ones((B, 4096), device=dev)
    kept = float((get_op("Dropout").fn(ones, p=0.5, _is_train=True) != 0)
                 .float().mean())
    losses = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    st = {}

    def on_batch(param):
        out = mod.get_outputs()[0].data
        losses.append(-(out.gather(1, yt.view(-1, 1)) + 1e-12).log().mean())
        done = param.nbatch + 1
        if done == 1:
            torch.cuda.synchronize()
            st["first_s"] = time.perf_counter() - st["t0"]
        if done == 1 + warm:
            start.record()
        if done == steps - 1:
            end.record()
            torch.cuda.synchronize()
            prof.start()
            st["t_prof"] = time.perf_counter()
        if done == steps:
            torch.cuda.synchronize()
            st["wall"] = time.perf_counter() - st["t_prof"]
            prof.stop()

    # the main path: counters zeroed just before, read just after
    for fn in counters.values():
        fn.launches = {"f32": 0, "bf16": 0}
    st["t0"] = time.perf_counter()
    mod.fit(RepeatIter(db, steps, (B, 3, S, S), (B,)), num_epoch=1,
            optimizer="sgd", optimizer_params={
                "learning_rate": ALEX_LR, "momentum": ALEX_MOMENTUM,
                "wd": ALEX_WD}, batch_end_callback=on_batch)
    launches = {n: dict(fn.launches) for n, fn in counters.items()}
    step_ms = start.elapsed_time(end) / timed
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    by_kind, busy_ms = resnet_breakdown(torch, prof, st["wall"], what,
                                        kind_of=alexnet_kind)
    losses = [float(v) for v in torch.stack(losses).cpu()]
    lrn = lrn_ms(torch, torch.bfloat16 if mt.amp.active()
                 else torch.float32)
    del mod, db
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "ref_ce": ref_ce, "got_ce": got_ce,
            "logits_err": logits_err, "kept": kept, "n_params": n_params,
            "macs": net_macs(mt, sym, (1, 3, S, S)), "step_ms": step_ms,
            "bind_s": bind_s, "first_s": st["first_s"], "timed": timed,
            "launches": launches, "peak_gb": peak_gb, "busy_ms": busy_ms,
            "wall_ms": st["wall"] * 1e3, "by_kind": by_kind, "lrn_ms": lrn}


def check_alexnet(what, run, dtype, peak_flops, peak_name):
    """Log an AlexNet run and hold it to the path: the inference
    forward's logits (f32) or cross-entropy (bf16) against the plain
    forward, finite losses that fall, Dropout's kept share, and no
    flash-attention launch."""
    losses = run["losses"]
    img_s = ALEX_BATCH / (run["step_ms"] / 1e3)
    flops = 3 * 2 * run["macs"]
    keep_se = math.sqrt(0.25 / (ALEX_BATCH * 4096))
    log("%s: AlexNet, batch %d, %dx%d, %d parameters: bind %.3f s, first "
        "step %.3f s; step %.3f ms (%d steps between CUDA events) = %.1f "
        "img/s; MFU %.4f of %.0f TFLOP/s %s (%.3f GFLOP per image: 3 x 2 x "
        "%.4f GMAC); peak memory %.3f GB; device busy %.3f of %.3f ms "
        "profiled (idle share %.3f); LRN forward + backward (both layers) "
        "%.3f ms a step"
        % (what, ALEX_BATCH, ALEX_IMAGE, ALEX_IMAGE, run["n_params"],
           run["bind_s"], run["first_s"], run["step_ms"], run["timed"],
           img_s, img_s * flops / peak_flops, peak_flops / 1e12, peak_name,
           flops / 1e9, run["macs"] / 1e9, run["peak_gb"], run["busy_ms"],
           run["wall_ms"], 1 - run["busy_ms"] / max(run["wall_ms"], 1e-9),
           run["lrn_ms"]))
    log("%s: loss per step %s" % (what, " ".join("%.6f" % v for v in losses)))
    log("%s: inference forward of the initial weights: logits within %.3g "
        "of max|ref| of the plain f32 forward (limit %g in f32); "
        "cross-entropy %.6f against %.6f (|diff| %.3g, limit %g in bf16); "
        "Dropout kept %.5f (%.2f SE from 0.5); flash-attention launches %s"
        % (what, run["logits_err"], ALEX_LOGITS_RTOL, run["got_ce"],
           run["ref_ce"], abs(run["got_ce"] - run["ref_ce"]), ALEX_CE_TOL,
           run["kept"], (run["kept"] - 0.5) / keep_se, run["launches"]))
    check(all(math.isfinite(v) for v in losses), "%s: non-finite loss %s"
          % (what, losses))
    check(losses[-1] < losses[0], "%s: loss did not fall: %s"
          % (what, losses))
    if dtype == "f32":
        check(run["logits_err"] <= ALEX_LOGITS_RTOL, "%s: logits %.3g of "
              "max|ref| from the plain forward" % (what, run["logits_err"]))
    else:
        check(abs(run["got_ce"] - run["ref_ce"]) <= ALEX_CE_TOL,
              "%s: inference cross-entropy %g vs plain forward %g"
              % (what, run["got_ce"], run["ref_ce"]))
    check(abs(run["kept"] - 0.5) <= SAMPLER_SIGMAS * keep_se,
          "%s: Dropout kept %.5f, not 0.5 within %g SE"
          % (what, run["kept"], SAMPLER_SIGMAS))
    if ALEX_CLASSES == 1000:
        check(run["n_params"] == ALEX_PARAMS, "%s: %d parameters, AlexNet "
              "has %d" % (what, run["n_params"], ALEX_PARAMS))
    for name, n in run["launches"].items():
        check(n == {"f32": 0, "bf16": 0}, "%s: flash-attention kernel %s "
              "launched %s times in an AlexNet step" % (what, name, n))


def score_symbol(mt, network):
    """benchmark_score's networks: (symbol, image side)."""
    from mxnet_tpu_torch.models import alexnet, inception, resnet, vgg
    if network == "alexnet":
        return alexnet.get_symbol(num_classes=1000), 224
    if network.startswith("vgg-"):
        return vgg.get_symbol(num_classes=1000,
                              num_layers=int(network[4:])), 224
    if network == "inception-bn":
        return inception.get_symbol(num_classes=1000, version="bn"), 224
    if network == "inception-v3":
        return inception.get_symbol(num_classes=1000, version="v3"), 299
    return resnet.get_symbol(num_classes=1000,
                             num_layers=int(network[7:])), 224


def score_net(torch, np, mt, network, batch, ctx, arg_params=None,
              aux_params=None, timed=0, warm=0):
    """One benchmark_score run: a forward-only Module on the graph up to
    the logits, bound at ``batch``, ``Xavier(magnitude=2)`` from the seed
    (or the given parameters), on a RandomState(0) batch; ``timed``
    forwards between CUDA events after ``warm``. Returns (logits, img/s
    or None, arg params, aux params)."""
    sym, side = score_symbol(mt, network)
    mod = mt.mod.Module(logits_symbol(mt, sym), label_names=None,
                        context=ctx)
    mod.bind(data_shapes=[("data", (batch, 3, side, side))],
             for_training=False)
    mod.init_params(mt.init.Xavier(magnitude=2).set_rng(
        np.random.default_rng(SEED)), arg_params=arg_params,
        aux_params=aux_params)
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (batch, 3, side, side)).astype(np.float32)
    db = mt.io.DataBatch(data=[mt.nd.array(x, ctx=ctx)])
    for _ in range(warm):
        mod.forward(db, is_train=False)
    img_s = None
    if timed:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(timed):
            mod.forward(db, is_train=False)
        end.record()
        torch.cuda.synchronize()
        img_s = batch * timed / (start.elapsed_time(end) / 1e3)
    mod.forward(db, is_train=False)
    out = mod.get_outputs()[0].data.float()
    args, aux = mod.get_params()
    return out, img_s, args, aux


def score_phase(torch, np):
    """12d. benchmark_score on the card: each network forward-only at
    SCORE_BATCH, f32 (TF32 off) and amp bf16, SCORE_TIMED forwards after
    SCORE_WARM; first, at SCORE_CHECK_BATCH, its f32 forward on the card
    against the port's own on the CPU from the same parameters."""
    import mxnet_tpu_torch as mt
    readings = {}
    for network in SCORE_NETS:
        sym, side = score_symbol(mt, network)
        macs = net_macs(mt, sym, (1, 3, side, side))
        out, _, args, aux = score_net(torch, np, mt, network,
                                      SCORE_CHECK_BATCH, mt.gpu(0))
        host = lambda d: {n: a.asnumpy() for n, a in d.items()}  # noqa
        cpu, _, _, _ = score_net(torch, np, mt, network, SCORE_CHECK_BATCH,
                                 mt.cpu(), host(args), host(aux))
        err = float((out.cpu() - cpu).abs().max() / cpu.abs().max())
        check(err <= SCORE_RTOL, "score %s: the card's f32 forward is %.3g "
              "of max|cpu| from the CPU's (limit %g)"
              % (network, err, SCORE_RTOL))
        row = {"gmac": macs / 1e9, "cpu_err": err}
        for dtype in ("f32", "bf16"):
            if dtype == "bf16":
                mt.amp.init("bfloat16")
            try:
                _, img_s, _, _ = score_net(torch, np, mt, network,
                                           SCORE_BATCH, mt.gpu(0),
                                           timed=SCORE_TIMED,
                                           warm=SCORE_WARM)
            finally:
                mt.amp.off()
            row[dtype] = img_s
        readings[network] = row
        log("score %s: %.4f GMAC an image; batch %d, %d forwards after %d: "
            "f32 %.1f img/s, amp bf16 %.1f img/s; batch %d f32 forward "
            "within %.3g of max|cpu| of the CPU's (limit %g)"
            % (network, macs / 1e9, SCORE_BATCH, SCORE_TIMED, SCORE_WARM,
               row["f32"], row["bf16"], SCORE_CHECK_BATCH, err, SCORE_RTOL))
        gc.collect()
        torch.cuda.empty_cache()
    return readings


def zoo_phase(torch, np):
    """Phase 12: the op library (a: the sweep on the card, out-of-range
    indices; b: the samplers) and the symbolic zoo nets (c: AlexNet
    through Module.fit; d: benchmark_score's five networks)."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import flash_attention as fa
    check(not torch.backends.cudnn.allow_tf32 and
          not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is allowed: the op sweep and the plain forward would not "
          "be float32")
    t0 = time.perf_counter()
    op_sweep(torch, np)
    out_of_range_check(torch)
    sampler_phase(torch, np)
    counters = {"flash_attention_fwd": fa.flash_attention_fwd,
                "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
                "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv}
    mt.amp.init("bfloat16")
    try:
        run = train_alexnet(torch, np, counters, ALEX_WARM, ALEX_TIMED,
                            "alexnet")
    finally:
        mt.amp.off()
    check_alexnet("alexnet", run, "bf16", PEAK_BF16_FLOPS, "bf16")
    run = train_alexnet(torch, np, counters, ALEX_F32_WARM, ALEX_F32_TIMED,
                        "alexnet f32")
    check_alexnet("alexnet f32", run, "f32", PEAK_FP32_FLOPS, "f32")
    score_phase(torch, np)
    log("op library and zoo phase: %.1f s" % (time.perf_counter() - t0))


# ------------------------- phase 13: structured ops and detection examples

# the structured families of the op library (vision, detection, contrib)
STRUCTURED = ("vision", "detection", "contrib")


def structured_op_cases(np):
    """13a's cases: the 18 ops of the port's ``ops/{vision,detection,
    contrib}.py`` (``MoE`` raises: A9) at the shapes of
    ``tests/test_vision_ops.py`` and ``tests/test_op_sweep.py``, seeded,
    with ReLU'd (tied) ROI inputs, ``-inf`` ties in Proposal and in the
    hard-negative ranks, and SAP where the draw is forced (one-hot
    ``prob`` rows; ``frac`` giving k = 1). Returns ``[(label, op name,
    [numpy inputs], attrs, {output index: column or None that must be
    equal})]``."""
    rng = np.random.RandomState(SEED + 13)

    def r(*shape, lo=-1.0, hi=1.0):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    def boxes(*lead):
        c = np.sort(rng.uniform(0, 1, lead + (2, 2)), axis=-2)
        return np.swapaxes(c, -1, -2).reshape(lead + (4,)).astype(np.float32)

    A = 24
    anchors = boxes(1, A)
    label = np.concatenate([rng.randint(0, 3, (2, 3, 1)).astype(np.float32),
                            boxes(2, 3)], -1)
    label[1, 2] = -1.0
    relu = np.maximum(r(2, 3, 8, 8), 0.0)
    rois = np.array([[0, 0, 0, 7, 7], [1, 2, 2, 6, 6], [0, 4, 4, 4, 4],
                     [1, 1.5, 0.5, 5.5, 3.5], [0, 2.5, 2.5, 6.5, 7.5]],
                    np.float32)
    onehot = np.zeros((3, 8), np.float32)
    onehot[np.arange(3), [1, 5, 7]] = 1.0
    rpn = dict(feature_stride=16, scales=(2.0,), ratios=(0.5, 1.0, 2.0),
               rpn_pre_nms_top_n=30, rpn_post_nms_top_n=12, rpn_min_size=12)
    return [
        ("MultiBoxPrior", "MultiBoxPrior", [r(1, 3, 4, 5)],
         {"sizes": (0.5, 0.25), "ratios": (1.0, 2.0, 0.5), "clip": True},
         {}),
        ("MultiBoxTarget", "MultiBoxTarget", [anchors, label, r(2, 4, A)],
         {"negative_mining_ratio": 3.0}, {1: None, 2: None}),
        ("MultiBoxDetection", "MultiBoxDetection",
         [r(2, 4, A, lo=0, hi=1), r(2, A * 4, lo=-0.1, hi=0.1), anchors],
         {"nms_threshold": 0.3, "nms_topk": 10}, {0: 0}),
        ("Proposal", "Proposal",
         [r(1, 6, 4, 4, lo=0, hi=1), r(1, 12, 4, 4, lo=-0.1, hi=0.1),
          np.array([[64, 64, 1.0]], np.float32)],
         dict(rpn, output_score=True), {0: 0}),
        ("CTCLoss", "CTCLoss", [r(6, 3, 5), np.array(
            [[1, 2, 2], [3, 0, 0], [4, 4, 4]], np.float32)], {}, {}),
        ("ROIPooling", "ROIPooling", [relu, rois],
         {"pooled_size": (3, 3), "spatial_scale": 1.0}, {}),
        ("PSROIPooling", "PSROIPooling", [r(1, 8, 6, 6), rois[:3] * 0.7],
         {"spatial_scale": 1.0, "output_dim": 2, "pooled_size": 2,
          "group_size": 2}, {}),
        ("BilinearSampler", "BilinearSampler",
         [r(2, 3, 5, 6), r(2, 2, 4, 5, lo=-1.1, hi=1.1)], {}, {}),
        ("GridGenerator", "GridGenerator", [r(2, 6)],
         {"target_shape": (4, 5)}, {}),
        ("GridGenerator warp", "GridGenerator", [r(2, 2, 4, 5)],
         {"transform_type": "warp"}, {}),
        ("SpatialTransformer", "SpatialTransformer",
         [r(2, 3, 6, 6), (np.tile([1, 0, 0, 0, 1, 0], (2, 1))
                          + r(2, 6) * 0.1).astype(np.float32)],
         {"target_shape": (5, 5)}, {}),
        ("Correlation", "Correlation", [r(1, 4, 8, 8), r(1, 4, 8, 8)],
         {"kernel_size": 3, "max_displacement": 2, "stride2": 2,
          "pad_size": 3}, {}),
        ("DeformableConvolution", "DeformableConvolution",
         [r(1, 4, 7, 7), r(1, 36, 5, 5), r(6, 2, 3, 3), r(6)],
         {"kernel": (3, 3), "num_filter": 6, "num_group": 2,
          "num_deformable_group": 2}, {}),
        ("stochastic_activation_pruning (one-hot prob)",
         "stochastic_activation_pruning", [r(3, 8), onehot],
         {"frac": 0.5}, {}),
        ("stochastic_activation_pruning (k = 1)",
         "stochastic_activation_pruning", [r(3, 8), onehot], {"frac": 0.1},
         {}),
        ("quantize", "quantize", [r(2, 3), np.float32([-1.0]),
                                  np.float32([1.0])], {}, {0: None}),
        ("dequantize", "dequantize",
         [(r(2, 3, lo=0, hi=1) * 100).astype(np.uint8), np.float32([0.0]),
          np.float32([255.0])], {}, {}),
        ("count_sketch", "count_sketch",
         [r(2, 8), np.array([0, 1, 2, 3, 0, 1, 5, -1], np.float32),
          np.sign(r(8)) + (r(8) == 0)], {"out_dim": 4}, {}),
        ("fft", "fft", [r(2, 8)], {}, {}),
        ("ifft", "ifft", [r(2, 16)], {}, {}),
    ]


def structured_op_sweep(torch, np, device=None):
    """13a. Every case of :func:`structured_op_cases` on the card and on
    the CPU, phase 12a's limits (OPS_FWD_RTOL / OPS_GRAD_RTOL of max(1,
    max|cpu|)), the listed discrete outputs (columns) equal; then a ROI
    of a batch index outside the batch gives NaN on the card and the
    device runs on. Returns the readings."""
    from mxnet_tpu_torch.ops import get_op
    device = device or DEVICE
    cases = structured_op_cases(np)
    worst = {"fwd": (0.0, None), "grad": (0.0, None)}
    for i, (label, name, inputs, attrs, exact) in enumerate(cases):
        op = get_op(name)
        outs, grads = op_run(torch, op, inputs, attrs, device, SEED + i)
        c_outs, c_grads = op_run(torch, op, inputs, attrs, "cpu", SEED + i)
        check(len(outs) == len(c_outs), "13a %s: %d outputs on %s, %d on "
              "the CPU" % (label, len(outs), device, len(c_outs)))
        for j, (g, w) in enumerate(zip(outs, c_outs)):
            err = op_err(torch, g, w)
            if err > worst["fwd"][0]:
                worst["fwd"] = (err, "%s output %d" % (label, j))
            check(err <= OPS_FWD_RTOL, "13a %s: output %d differs from the "
                  "CPU's by %.3g of max(1, max|cpu|) (limit %g)"
                  % (label, j, err, OPS_FWD_RTOL))
            if j in exact:
                col = exact[j]
                gd, wd = (g, w) if col is None else (g[..., col], w[..., col])
                check(torch.equal(gd, wd), "13a %s: discrete output %d "
                      "differs from the CPU's: %s vs %s"
                      % (label, j, gd.tolist(), wd.tolist()))
        check((grads is None) == (c_grads is None), "13a %s: a gradient on "
              "one device only" % label)
        for j, (g, w) in enumerate(zip(grads or [], c_grads or [])):
            err = op_err(torch, g, w)
            if err > worst["grad"][0]:
                worst["grad"] = (err, "%s gradient %d" % (label, j))
            check(err <= OPS_GRAD_RTOL, "13a %s: gradient of input %d "
                  "differs from the CPU's by %.3g (limit %g)"
                  % (label, j, err, OPS_GRAD_RTOL))
    n_ops = len({name for _, name, _, _, _ in cases})
    log("13a structured ops: %d ops in %d cases on %s against the CPU; "
        "worst forward %.3g (%s), worst gradient %.3g (%s)"
        % (n_ops, len(cases), device, worst["fwd"][0], worst["fwd"][1],
           worst["grad"][0], worst["grad"][1]))
    dev = torch.device(device)
    data = torch.arange(32.0, device=dev).reshape(2, 1, 4, 4)
    rois = torch.tensor([[1, 0, 0, 3, 3], [2, 0, 0, 3, 3],
                         [-1, 0, 0, 1, 1], [-3, 0, 0, 1, 1]],
                        dtype=torch.float32, device=dev)
    got = get_op("ROIPooling").fn(data, rois, pooled_size=(1, 1))
    got = got.reshape(-1).cpu().tolist()
    want = [31.0, float("nan"), 21.0, float("nan")]
    check(op_err(torch, torch.tensor(got, dtype=torch.float64),
                 torch.tensor(want, dtype=torch.float64)) == 0.0,
          "13a ROIPooling batch index out of range on %s: %s, the "
          "reference gives %s" % (dev, got, want))
    check(float((data + 1).sum()) == 528.0, "the device failed after an "
          "out-of-range ROI batch index")
    log("13a ROIPooling batch index [1, 2, -1, -3] on %s -> %s (the "
        "reference's), the device still runs" % (dev, got))
    return {"ops": n_ops, "cases": len(cases), "worst": worst}


# ------------------------------------------------------- 13b: SSD

def ssd_data(np, n, size, seed):
    """``examples/train_ssd.py``'s images: one axis-aligned rectangle of
    one of three colours on noise; label rows [cls, x1, y1, x2, y2] in
    normalized corners."""
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 3, size, size).astype(np.float32) * 0.25
    labels = np.zeros((n, 1, 5), np.float32)
    for i in range(n):
        cls = rng.randint(0, SSD_CLASSES)
        w = rng.randint(size // 4, size // 2)
        h = rng.randint(size // 4, size // 2)
        x0 = rng.randint(0, size - w)
        y0 = rng.randint(0, size - h)
        x[i, cls, y0:y0 + h, x0:x0 + w] = 0.9
        labels[i, 0] = [cls, x0 / size, y0 / size,
                        (x0 + w) / size, (y0 + h) / size]
    return x, labels


def ssd_symbol(mt, for_training=True):
    """``examples/train_ssd.py``'s two-scale SSD (``build_ssd``): a
    three-convolution backbone, per-scale class and box heads and
    anchors, one MultiBoxTarget in training (SoftmaxOutput over the
    classes with ignore, MakeLoss of smooth L1 with ``valid``
    normalization), one MultiBoxDetection at inference."""
    sym = mt.sym
    C = SSD_CLASSES

    def head(feat, sizes, name):
        cls = sym.Convolution(feat, kernel=(3, 3), pad=(1, 1),
                              num_filter=(C + 1) * SSD_ANCHORS,
                              name="%s_cls" % name)
        loc = sym.Convolution(feat, kernel=(3, 3), pad=(1, 1),
                              num_filter=4 * SSD_ANCHORS,
                              name="%s_loc" % name)
        anchors = sym.MultiBoxPrior(feat, sizes=sizes, ratios=SSD_RATIOS,
                                    clip=True)
        cls = sym.reshape(sym.transpose(cls, axes=(0, 2, 3, 1)),
                          shape=(0, -1, C + 1))
        loc = sym.reshape(sym.transpose(loc, axes=(0, 2, 3, 1)),
                          shape=(0, -1))
        return cls, loc, anchors

    body = sym.Variable("data")
    feats = []
    for name, nf in (("c1", 16), ("c2", 32), ("c3", 32)):
        body = sym.Convolution(body, kernel=(3, 3), pad=(1, 1),
                               num_filter=nf, name=name)
        body = sym.Activation(body, act_type="relu")
        body = sym.Pooling(body, kernel=(2, 2), stride=(2, 2),
                           pool_type="max")
        feats.append(body)
    cls1, loc1, a1 = head(feats[1], SSD_SIZES[0], "s1")
    cls2, loc2, a2 = head(feats[2], SSD_SIZES[1], "s2")
    cls_pred = sym.transpose(sym.Concat(cls1, cls2, dim=1), axes=(0, 2, 1))
    loc_pred = sym.Concat(loc1, loc2, dim=1)
    anchors = sym.Concat(a1, a2, dim=1)
    if not for_training:
        cls_prob = sym.SoftmaxActivation(cls_pred, mode="channel")
        return sym.MultiBoxDetection(cls_prob, loc_pred, anchors,
                                     nms_threshold=0.5, force_suppress=True,
                                     nms_topk=50, name="detection")
    box_t, box_m, cls_t = sym.MultiBoxTarget(
        anchors, sym.Variable("label"), cls_pred, overlap_threshold=0.5,
        negative_mining_ratio=3.0, name="target")
    cls_loss = sym.SoftmaxOutput(cls_pred, cls_t, multi_output=True,
                                 use_ignore=True, ignore_label=-1,
                                 normalization="valid", name="cls_prob")
    loc_loss = sym.MakeLoss(sym.smooth_l1((loc_pred - box_t) * box_m,
                                          scalar=1.0),
                            grad_scale=1.0, normalization="valid",
                            name="loc_loss")
    return sym.Group([cls_loss, loc_loss])


def plain_priors(np, side, sizes, ratios):
    """MultiBoxPrior's anchors of a ``side`` x ``side`` map from its
    formula, in numpy: per cell one box per size at ratio 1, one per
    further ratio at the first size, clipped to [0, 1]."""
    wh = [(s / 2, s / 2) for s in sizes] + \
        [(sizes[0] * np.sqrt(r) / 2, sizes[0] / np.sqrt(r) / 2)
         for r in ratios[1:]]
    c = (np.arange(side) + 0.5) / side
    out = [[cx - w, cy - h, cx + w, cy + h]
           for cy in c for cx in c for w, h in wh]
    return np.clip(np.array(out, np.float32), 0.0, 1.0)


def plain_ssd(torch, np, p, x, label):
    """An independent f32 forward of the SSD's training graph: the
    backbone and heads in ``torch.nn.functional``, the anchors from
    :func:`plain_priors`, the targets from the port's MultiBoxTarget on
    the CPU (held to the reference's by ``tests/
    test_torch_ops_detection.py``), then the class softmax and the
    masked smooth L1. Returns (class probabilities (N, C+1, A), smooth
    L1 (N, A*4))."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import get_op
    C = SSD_CLASSES
    h = x
    feats = []
    for name in ("c1", "c2", "c3"):
        h = F.max_pool2d(F.relu(F.conv2d(h, p[name + "_weight"],
                                         p[name + "_bias"], padding=1)), 2)
        feats.append(h)
    cls, loc, anchors = [], [], []
    for feat, name, sizes in ((feats[1], "s1", SSD_SIZES[0]),
                              (feats[2], "s2", SSD_SIZES[1])):
        c = F.conv2d(feat, p[name + "_cls_weight"], p[name + "_cls_bias"],
                     padding=1)
        b = F.conv2d(feat, p[name + "_loc_weight"], p[name + "_loc_bias"],
                     padding=1)
        cls.append(c.permute(0, 2, 3, 1).reshape(x.shape[0], -1, C + 1))
        loc.append(b.permute(0, 2, 3, 1).reshape(x.shape[0], -1))
        anchors.append(plain_priors(np, feat.shape[2], sizes, SSD_RATIOS))
    cls_pred = torch.cat(cls, 1).permute(0, 2, 1)
    loc_pred = torch.cat(loc, 1)
    anchor = torch.from_numpy(np.concatenate(anchors)[None])
    box_t, box_m, _ = get_op("MultiBoxTarget").fn(
        anchor, label.cpu(), cls_pred.cpu(), overlap_threshold=0.5,
        negative_mining_ratio=3.0)
    diff = (loc_pred - box_t.to(x.device)) * box_m.to(x.device)
    ad = diff.abs()
    smooth = torch.where(ad < 1.0, 0.5 * diff * diff, ad - 0.5)
    return torch.softmax(cls_pred, dim=1), smooth


def ssd_kind(op: str) -> str:
    """The class of an operator's device time in the SSD step."""
    low = op.lower()
    if "pool" not in low and any(w in low for w in (
            "sort", "cumsum", "argmax", "amax", "gather", "scatter",
            "index")):
        return "targets (sort, gather, scatter)"
    return resnet_kind(op)


def ssd_module(mt, for_training, batch, ctx):
    mod = mt.mod.Module(ssd_symbol(mt, for_training), context=ctx,
                        data_names=("data",),
                        label_names=("label",) if for_training else ())
    if for_training:
        mod.bind(data_shapes=[("data", (batch, 3, SSD_SIZE, SSD_SIZE))],
                 label_shapes=[("label", (batch, 1, 5))])
    else:
        mod.bind(data_shapes=[("data", (batch, 3, SSD_SIZE, SSD_SIZE))],
                 for_training=False)
    return mod


def train_ssd(torch, np, x, labels, init, epochs, what):
    """``examples/train_ssd.py``'s loop under whatever amp state the
    caller set: ``Module.forward_backward`` and ``update`` over a
    shuffled ``NDArrayIter`` (after ``np.random.seed(SSD_SEED)``), SGD
    SSD_LR / SSD_MOMENTUM / SSD_WD from ``init``. The first step's
    outputs are checked by the caller (returned before any update);
    the steps after the first SSD_WARM are timed between CUDA events
    and the last step runs under torch.profiler. Returns the readings
    and the module."""
    from torch.profiler import ProfilerActivity, profile
    import mxnet_tpu_torch as mt
    np.random.seed(SSD_SEED)
    train = mt.io.NDArrayIter({"data": x}, {"label": labels}, SSD_BATCH,
                              shuffle=True)
    mod = ssd_module(mt, True, SSD_BATCH, mt.gpu(0))
    mod.init_params(arg_params=init)
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": SSD_LR, "momentum": SSD_MOMENTUM, "wd": SSD_WD})
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    run = {"first": None, "steps": 0, "timed": 0, "loc": []}
    for epoch in range(epochs):
        train.reset()
        batches = list(train)
        for k, batch in enumerate(batches):
            last = epoch == epochs - 1 and k == len(batches) - 1
            if run["steps"] == SSD_WARM:
                start.record()
            if last:
                end.record()
                torch.cuda.synchronize()
                prof.start()
                t_prof = time.perf_counter()
            mod.forward_backward(batch)
            if run["first"] is None:
                run["first"] = ([o.data.detach().clone()
                                 for o in mod.get_outputs()], batch)
            mod.update()
            if last:
                torch.cuda.synchronize()
                run["wall"] = time.perf_counter() - t_prof
                prof.stop()
            elif run["steps"] >= SSD_WARM:
                run["timed"] += 1
            run["steps"] += 1
        run["loc"].append(float(mod.get_outputs()[1].data.float().sum()))
    run["step_ms"] = start.elapsed_time(end) / max(run["timed"], 1)
    run["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    run["by_kind"], run["busy_ms"] = resnet_breakdown(
        torch, prof, run["wall"], what, kind_of=ssd_kind)
    return run, mod


def ssd_detect(torch, np, mod_params, x, labels):
    """``examples/train_ssd.py``'s ``evaluate`` through
    ``Module.predict``: the forward-only detection module over the
    example's whole batches (``predict`` equal to ``forward`` +
    ``get_outputs`` batch by batch), the mean IoU of each image's best
    detection with its box, and the class-hit share. Returns the
    readings."""
    import mxnet_tpu_torch as mt
    n = (len(x) // SSD_BATCH) * SSD_BATCH
    det = ssd_module(mt, False, SSD_BATCH, mt.gpu(0))
    det.set_params(*mod_params, allow_missing=False)
    it = mt.io.NDArrayIter(x[:n], batch_size=SSD_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = det.predict(it)
    end.record()
    torch.cuda.synchronize()
    det_ms = start.elapsed_time(end) / (n // SSD_BATCH)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    out = out.data
    check(tuple(out.shape)[0] == n and out.shape[2] == 6,
          "13b predict returned %s for %d images" % (tuple(out.shape), n))
    for s in range(0, n, SSD_BATCH):
        batch = mt.io.DataBatch(data=[mt.nd.array(x[s:s + SSD_BATCH],
                                                  ctx=mt.cpu())])
        det.forward(batch, is_train=False)
        check(torch.equal(det.get_outputs()[0].data, out[s:s + SSD_BATCH]),
              "13b predict differs from forward + get_outputs at batch %d"
              % (s // SSD_BATCH))
    out = out.cpu().numpy()
    ious, hits = [], 0
    for i in range(n):
        gt = labels[i, 0]
        valid = out[i][out[i, :, 0] >= 0]
        if not len(valid):
            ious.append(0.0)
            continue
        best = valid[np.argmax(valid[:, 1])]
        ix0, iy0 = max(best[2], gt[1]), max(best[3], gt[2])
        ix1, iy1 = min(best[4], gt[3]), min(best[5], gt[4])
        inter = max(0.0, ix1 - ix0) * max(0.0, iy1 - iy0)
        a1 = (best[4] - best[2]) * (best[5] - best[3])
        a2 = (gt[3] - gt[1]) * (gt[4] - gt[2])
        iou = inter / max(a1 + a2 - inter, 1e-9)
        ious.append(iou)
        hits += int(best[0] == gt[0] and iou > 0.4)
    return {"miou": float(np.mean(ious)), "hit": hits / n, "det_ms": det_ms,
            "det_peak_gb": peak_gb, "images": n}


def ssd_phase(torch, np):
    """13b. ``examples/train_ssd.py`` at its defaults through ``Module``
    in f32 (the first step's outputs held to :func:`plain_ssd`), the
    detection module through ``predict`` to the example's gate, then one
    seeded epoch in amp bf16 from the same initial weights."""
    import mxnet_tpu_torch as mt
    mt.random.seed(SSD_SEED)
    x, labels = ssd_data(np, SSD_IMAGES, SSD_SIZE, seed=5)
    probe = ssd_module(mt, True, SSD_BATCH, mt.gpu(0))
    probe.init_params(mt.init.Xavier(magnitude=2).set_rng(
        mt.random.derive_numpy_rng("train_ssd")))
    init = {k: v.asnumpy() for k, v in probe.get_params()[0].items()}
    del probe
    run, mod = train_ssd(torch, np, x, labels, init, SSD_EPOCHS, "ssd f32")
    outs, batch = run["first"]
    dev = outs[0].device
    p = {k: torch.from_numpy(v).to(dev) for k, v in init.items()}
    with torch.no_grad():
        ref_prob, ref_loc = plain_ssd(torch, np, p, batch.data[0].data.to(dev),
                                      batch.label[0].data)
    errs = [float((g.float() - w).abs().max()) / max(1.0, float(w.abs().max()))
            for g, w in zip(outs, (ref_prob, ref_loc))]
    log("13b ssd f32: step 1 class probabilities within %.3g and smooth L1 "
        "within %.3g of the plain f32 forward (limit %g of max(1, max|ref|))"
        % (errs[0], errs[1], SSD_STEP1_RTOL))
    check(max(errs) <= SSD_STEP1_RTOL, "13b ssd f32: step 1 outputs off the "
          "plain forward by %s" % errs)
    check(all(math.isfinite(v) for v in run["loc"]), "13b ssd f32: a "
          "loss is not finite: %s" % run["loc"])
    det = ssd_detect(torch, np, mod.get_params(), x, labels)
    imgs = SSD_BATCH / (run["step_ms"] / 1e3)
    log("13b ssd f32: %d epochs x %d steps (batch %d, 3x%dx%d), %.3f ms a "
        "step = %.1f img/s, peak %.3f GB, idle share of one profiled step "
        "%.3f; box loss sum per epoch first %.3f last %.3f; detection "
        "(predict) %.3f ms a batch of %d, peak %.3f GB; mean IoU of the "
        "best detection %.4f over %d images (gate > %g), class-hit share "
        "%.4f" % (SSD_EPOCHS, run["steps"] // SSD_EPOCHS, SSD_BATCH,
                  SSD_SIZE, SSD_SIZE, run["step_ms"], imgs, run["peak_gb"],
                  1 - run["busy_ms"] / (run["wall"] * 1e3), run["loc"][0],
                  run["loc"][-1], det["det_ms"], SSD_BATCH,
                  det["det_peak_gb"], det["miou"], det["images"],
                  SSD_MIN_IOU, det["hit"]))
    check(det["miou"] > SSD_MIN_IOU, "13b ssd: mean IoU %.4f, the example's "
          "gate is > %g" % (det["miou"], SSD_MIN_IOU))
    del mod
    mt.amp.init("bfloat16")
    try:
        brun, _ = train_ssd(torch, np, x, labels, init, 1, "ssd bf16")
    finally:
        mt.amp.off()
    check(all(math.isfinite(v) for v in brun["loc"]), "13b ssd bf16: a "
          "loss is not finite")
    log("13b ssd amp bf16: one epoch, %.3f ms a step = %.1f img/s, peak "
        "%.3f GB, idle share of one profiled step %.3f"
        % (brun["step_ms"], SSD_BATCH / (brun["step_ms"] / 1e3),
           brun["peak_gb"], 1 - brun["busy_ms"] / (brun["wall"] * 1e3)))
    gc.collect()
    torch.cuda.empty_cache()
    return {"f32": run, "bf16": brun, "det": det}


# ---------------------------------------- 13c: the published sizes

def timed_call(torch, fn):
    """(result, ms between CUDA events, extra peak GB over the memory
    allocated before the call)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end), \
        (torch.cuda.max_memory_allocated() - base) / 1e9


def published_case(torch, np, label, name, inputs, attrs, exact, device):
    """One op at a published size: the forward and the gradient of every
    floating input under a seeded head on the card, timed between CUDA
    events with its extra peak memory, against the same on the CPU
    (within DET_RTOL of max(1, max|cpu|); the ``exact`` outputs'
    columns equal). Returns (card outputs, readings)."""
    from mxnet_tpu_torch.ops import get_op
    op = get_op(name)
    (outs, grads), ms, peak = timed_call(
        torch, lambda: op_run(torch, op, inputs, attrs, device, SEED))
    c_outs, c_grads = op_run(torch, op, inputs, attrs, "cpu", SEED)
    errs = []
    for j, (g, w) in enumerate(zip(outs, c_outs)):
        errs.append(op_err(torch, g, w))
        if j in exact:
            col = exact[j]
            gd, wd = (g, w) if col is None else (g[..., col], w[..., col])
            check(torch.equal(gd, wd), "13c %s: discrete output %d differs "
                  "from the CPU's in %d places" % (label, j,
                                                   int((gd != wd).sum())))
    for g, w in zip(grads or [], c_grads or []):
        errs.append(op_err(torch, g, w))
    worst = max(errs) if errs else 0.0
    log("13c %s: forward%s %.3f ms on the card, extra peak %.3f GB, within "
        "%.3g of the CPU (limit %g)" % (label, " + backward" if grads
                                        else "", ms, peak, worst, DET_RTOL))
    check(worst <= DET_RTOL, "13c %s: off the CPU by %.3g" % (label, worst))
    return outs, {"ms": ms, "peak_gb": peak, "err": worst}


def ssd300_anchors(torch, np, device):
    """SSD300's 8732 anchors (``vgg16_reduced`` at 300): MultiBoxPrior
    on each feature map with its sizes and ratios, concatenated."""
    from mxnet_tpu_torch.ops import get_op
    parts = []
    for side, sizes, ratios in SSD300_LAYERS:
        data = torch.zeros((1, 1, side, side), device=device)
        parts.append(get_op("MultiBoxPrior").fn(data, sizes=sizes,
                                                ratios=ratios))
    return torch.cat(parts, 1)


def sap_check(torch, np, shape, device):
    """SAP at ``shape`` with ``prob = |a| / sum|a|`` per row and frac 1
    (k = cols), over SAP_DRAWS draws on the card: each column's kept
    count (over the rows and draws) within SAP_SIGMAS binomial
    deviations (+1) of the sum of its ``1 - (1 - p)^k``, p the share of
    the row's f32 CDF the column spans (what an inverse-CDF draw
    realizes); every kept value ``act / (1 - (1 - p)^k)`` (the f32
    formula by repeated squaring) within 1e-6 of itself; the gradient is
    the mask. Where ``1 - p`` rounds to 1 in float32 (p < 2^-25) the
    reference's rescale is ``1 / 0 = inf`` and so is the port's (ROADMAP
    C14): such drawn elements are counted, and each row's mean sum over
    the elements of finite rescale that the CDF can draw lies within
    SAP_SIGMAS standard errors of their activations' sum (SAP is
    unbiased). The forward is timed against its
    bytes bound (act and prob read, the output written)."""
    from mxnet_tpu_torch.ops import get_op
    op = get_op("stochastic_activation_pruning")
    g = torch.Generator(device=device).manual_seed(SEED)
    act = torch.randn(shape, generator=g, device=device).abs_()
    rows = shape[0]
    a2 = act.reshape(rows, -1)
    prob = (a2 / a2.sum(1, keepdim=True)).reshape(shape)
    p2 = prob.reshape(rows, -1)
    cols = k = a2.shape[1]
    cdf = torch.cumsum(p2, dim=1).double()
    p_eff = torch.diff(cdf, dim=1, prepend=torch.zeros_like(cdf[:, :1])) \
        / cdf[:, -1:]
    q = -torch.expm1(k * torch.log1p(-p_eff.clamp(max=1 - 1e-16)))
    drawable = p_eff > 0
    acc, x, e = None, 1.0 - p2, k
    while e > 0:
        if e & 1:
            acc = x if acc is None else acc * x
        e >>= 1
        if e > 0:
            x = x * x
    weight = 1.0 / (1.0 - acc)
    finite = torch.isfinite(weight)
    counted = finite & drawable
    del acc, x, cdf, p_eff, drawable
    kept = torch.zeros(cols, dtype=torch.float64, device=device)
    total = torch.zeros(rows, dtype=torch.float64, device=device)
    n_inf = 0
    worst, ms, bwd_ms = 0.0, [], None
    for d in range(SAP_DRAWS):
        a = act.clone().requires_grad_(True)
        (out, ), t, _ = timed_call(torch, lambda: (op.fn(a, prob, frac=1.0),))
        ms.append(t)
        o2 = out.detach().reshape(rows, -1)
        m = o2 != 0
        kept += m.sum(0, dtype=torch.float64)
        n_inf += int((m & ~finite).sum())
        total += torch.where(counted, o2, 0.0).sum(1, dtype=torch.float64)
        want = a2 * weight
        sel = m & finite
        rel = ((o2 - want).abs() / want)[sel]
        worst = max(worst, float(rel.max()) if rel.numel() else 0.0)
        check(bool(torch.isinf(o2[m & ~finite]).all()), "13c SAP %s: a "
              "kept element of infinite rescale is finite" % (shape,))
        if d == 0:
            (gr, ), bwd_ms, _ = timed_call(torch, lambda: torch.autograd.grad(
                out, [a], torch.ones_like(out)))
            mask = torch.where(m, weight, torch.zeros_like(weight))
            check(torch.equal(gr.reshape(rows, -1), mask),
                  "13c SAP %s: the gradient is not the mask" % (shape,))
        del a, out, o2, m, want, rel, sel
    mean_q = q.sum(0) * SAP_DRAWS
    sd_q = (SAP_DRAWS * (q * (1 - q)).sum(0)).sqrt()
    dev_kept = float(((kept - mean_q).abs() / (sd_q + 1.0)).max())
    a64 = torch.where(counted, a2.double(), 0.0)
    se = ((a64 ** 2 * torch.where(counted, (1 - q) / q, 0.0)).sum(1)
          / SAP_DRAWS).sqrt()
    dev_mean = float(((total / SAP_DRAWS - a64.sum(1)).abs() / se).max())
    bound = 3 * act.numel() * 4 / PEAK_BYTES_PER_S * 1e3
    fwd = sorted(ms)[len(ms) // 2]
    n_tiny = int((~finite).sum())
    log("13c SAP %s (k %d): forward %.3f ms, the median of %d draws (bound "
        "%.3f ms by bytes, %.1f%% of it), backward %.3f ms; kept counts "
        "within %.2f binomial deviations (+1) of their expectation, kept "
        "values within %.3g of act / (1 - (1 - p)^k), row means within "
        "%.2f standard errors of the activations' sums (limit %g); %d of "
        "%d elements have 1 - p == 1 in float32 (rescale inf, C14), drawn "
        "%.1f times a draw"
        % (shape, k, fwd, SAP_DRAWS, bound, 100 * bound / fwd, bwd_ms,
           dev_kept, worst, dev_mean, SAP_SIGMAS, n_tiny, act.numel(),
           n_inf / SAP_DRAWS))
    check(dev_kept <= SAP_SIGMAS, "13c SAP %s: kept counts off by %.2f "
          "deviations" % (shape, dev_kept))
    check(worst <= 1e-6, "13c SAP %s: a kept value off its rescale by %.3g"
          % (shape, worst))
    check(dev_mean <= SAP_SIGMAS, "13c SAP %s: biased, %.2f standard errors"
          % (shape, dev_mean))
    del act, prob, weight, q
    torch.cuda.empty_cache()
    return {"ms": fwd, "bwd_ms": bwd_ms, "bound_ms": bound,
            "inf_per_draw": n_inf / SAP_DRAWS}


def published_phase(torch, np):
    """13c. The detection ops at their published sizes on the card
    against the CPU: SSD300's priors, MultiBoxTarget and
    MultiBoxDetection, the Faster R-CNN RPN's Proposal, Fast R-CNN's
    ROIPooling (extra peak under ROI_PEAK_GB), SAP at the ResNet-50
    phase's widths and CTCLoss at a speech alphabet's. Returns the
    readings."""
    dev = DEVICE
    rng = np.random.RandomState(SEED + 130)
    out = {}
    anchors = ssd300_anchors(torch, np, dev)
    c_anchors = ssd300_anchors(torch, np, "cpu")
    A = anchors.shape[1]
    check(A == SSD300_ANCHORS and torch.equal(anchors.cpu(), c_anchors),
          "13c SSD300 priors: %d anchors, the card's equal the CPU's: %s"
          % (A, torch.equal(anchors.cpu(), c_anchors)))
    log("13c SSD300 MultiBoxPrior: %d anchors over maps %s, equal to the "
        "CPU's" % (A, [s for s, _, _ in SSD300_LAYERS]))
    anc = anchors.cpu().numpy()
    N, C, O = SSD300_BATCH, SSD300_CLASSES, SSD300_GT
    label = -np.ones((N, O, 5), np.float32)
    for i in range(N):
        n_obj = rng.randint(1, O + 1)
        c = np.sort(rng.uniform(0, 1, (n_obj, 2, 2)), axis=1)
        label[i, :n_obj, 0] = rng.randint(0, C - 1, n_obj)
        label[i, :n_obj, 1:] = np.swapaxes(c, 1, 2).reshape(n_obj, 4)
    cls_pred = rng.standard_normal((N, C, A)).astype(np.float32)
    _, out["target"] = published_case(
        torch, np, "SSD300 MultiBoxTarget (batch %d, %d classes, %d gt rows)"
        % (N, C, O), "MultiBoxTarget", [anc, label, cls_pred],
        {"negative_mining_ratio": 3.0}, {1: None, 2: None}, dev)
    logits = rng.standard_normal((N, C, A)).astype(np.float32) * 2
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    loc = (rng.standard_normal((N, A * 4)) * 0.1).astype(np.float32)
    _, out["detection"] = published_case(
        torch, np, "SSD300 MultiBoxDetection (nms 0.45, top 400)",
        "MultiBoxDetection", [prob.astype(np.float32), loc, anc],
        {"nms_threshold": 0.45, "nms_topk": 400, "threshold": 0.01},
        {0: 0}, dev)
    H, W = RPN_MAP
    Aa = 12
    rpn_cls = rng.uniform(0, 1, (1, 2 * Aa, H, W)).astype(np.float32)
    rpn_box = (rng.standard_normal((1, 4 * Aa, H, W)) * 0.1).astype(
        np.float32)
    info = np.array([[RPN_IMAGE[0], RPN_IMAGE[1], 1.0]], np.float32)
    _, out["proposal"] = published_case(
        torch, np, "RPN Proposal (%dx%d map, %d anchors, pre %d, post %d)"
        % (H, W, Aa, RPN_PRE, RPN_POST), "Proposal", [rpn_cls, rpn_box, info],
        {"rpn_pre_nms_top_n": RPN_PRE, "rpn_post_nms_top_n": RPN_POST,
         "threshold": 0.7, "output_score": True}, {0: 0}, dev)
    n_img, ch, fh, fw = ROI_DATA
    data = np.maximum(rng.standard_normal(ROI_DATA), 0).astype(np.float32)
    rois = []
    for b in range(n_img):
        for _ in range(ROI_PER_IMAGE):
            x1, y1 = rng.uniform(0, fw * 16 - 32), rng.uniform(0, fh * 16 - 32)
            w, h = rng.uniform(16, fw * 16 - x1), rng.uniform(16, fh * 16 - y1)
            rois.append([b, x1, y1, x1 + w, y1 + h])
    rois = np.array(rois, np.float32)
    _, out["roi"] = published_case(
        torch, np, "Fast R-CNN ROIPooling (%s, %d ROIs, 7x7, 1/16)"
        % (ROI_DATA, len(rois)), "ROIPooling", [data, rois],
        {"pooled_size": (7, 7), "spatial_scale": 1.0 / 16}, {}, dev)
    check(out["roi"]["peak_gb"] < ROI_PEAK_GB, "13c ROIPooling's extra "
          "peak %.3f GB is not under %g GB" % (out["roi"]["peak_gb"],
                                               ROI_PEAK_GB))
    for shape in SAP_SHAPES:
        out["sap %s" % (shape,)] = sap_check(torch, np, shape, dev)
    T, Nc, Cc, L = CTC_SHAPE
    lab = np.zeros((Nc, L), np.float32)
    for i in range(Nc):
        n = rng.randint(L // 2, L + 1)
        lab[i, :n] = rng.randint(1, Cc, n)
    _, out["ctc"] = published_case(
        torch, np, "CTCLoss (T %d, N %d, C %d, labels up to %d)" % CTC_SHAPE,
        "CTCLoss", [rng.standard_normal((T, Nc, Cc)).astype(np.float32),
                    lab], {}, {}, dev)
    return out


# ---------------------------------------- 13d: Fast R-CNN

def rcnn_data(np, n, seed):
    """``examples/train_rcnn.py``'s data: one rectangle an image and
    RCNN_R proposals, half jittered copies of its box, half random."""
    rng = np.random.RandomState(seed)
    S, R = RCNN_SIZE, RCNN_R
    x = rng.rand(n, 3, S, S).astype(np.float32) * 0.25
    rois = np.zeros((n, R, 4), np.float32)
    gt = np.zeros((n, 5), np.float32)
    for i in range(n):
        cls = rng.randint(0, RCNN_CLASSES)
        w = rng.randint(S // 4, S // 2)
        h = rng.randint(S // 4, S // 2)
        x0 = rng.randint(0, S - w)
        y0 = rng.randint(0, S - h)
        x[i, cls, y0:y0 + h, x0:x0 + w] = 0.9
        gt[i] = [cls + 1, x0, y0, x0 + w, y0 + h]
        for r in range(R):
            if r < R // 2:
                jx, jy = rng.randint(-3, 4), rng.randint(-3, 4)
                rois[i, r] = [np.clip(x0 + jx, 0, S - 2),
                              np.clip(y0 + jy, 0, S - 2),
                              np.clip(x0 + w + jx, 1, S - 1),
                              np.clip(y0 + h + jy, 1, S - 1)]
            else:
                bw, bh = rng.randint(8, 24), rng.randint(8, 24)
                bx, by = rng.randint(0, S - bw), rng.randint(0, S - bh)
                rois[i, r] = [bx, by, bx + bw, by + bh]
    return x, rois, gt


def register_proposal_target(mt, np, timer=None):
    """The example's ``proposal_target`` CustomOp (each ROI's class by
    IoU > 0.5 with the image's box, on the host), registered as
    ``proposal_target``; ``timer`` (a dict) accumulates the seconds its
    forward takes, the host round trip included."""

    class ProposalTarget(mt.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            t0 = time.perf_counter()
            rois = in_data[0].asnumpy()
            gt = in_data[1].asnumpy()
            n, r, _ = rois.shape
            labels = np.zeros((n, r), np.float32)
            for i in range(n):
                g = gt[i, 1:]
                ix0 = np.maximum(rois[i, :, 0], g[0])
                iy0 = np.maximum(rois[i, :, 1], g[1])
                ix1 = np.minimum(rois[i, :, 2], g[2])
                iy1 = np.minimum(rois[i, :, 3], g[3])
                inter = np.clip(ix1 - ix0, 0, None) * \
                    np.clip(iy1 - iy0, 0, None)
                area_r = (rois[i, :, 2] - rois[i, :, 0]) * \
                    (rois[i, :, 3] - rois[i, :, 1])
                area_g = (g[2] - g[0]) * (g[3] - g[1])
                iou = inter / np.maximum(area_r + area_g - inter, 1e-9)
                labels[i] = np.where(iou > 0.5, gt[i, 0], 0.0)
            self.assign(out_data[0], req[0], mt.nd.array(
                labels, ctx=in_data[0].context))
            if timer is not None:
                timer["s"] = timer.get("s", 0.0) + time.perf_counter() - t0
                timer["calls"] = timer.get("calls", 0) + 1

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            for k in range(2):
                self.assign(in_grad[k], req[k], mt.nd.zeros(
                    in_data[k].shape, ctx=in_data[k].context))

    @mt.operator.register("proposal_target")
    class ProposalTargetProp(mt.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["rois", "gt"]

        def list_outputs(self):
            return ["label"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0][:2]], []

        def create_operator(self, ctx, shapes, dtypes):
            return ProposalTarget()

    return ProposalTargetProp


def rcnn_symbol(mt):
    """``examples/train_rcnn.py``'s ``build_net``: a two-convolution
    backbone at stride 4, ROIPooling (4x4, 1/4) of the given proposals,
    two dense layers, and SoftmaxOutput against the ``proposal_target``
    CustomOp's labels."""
    sym = mt.sym
    body = sym.Variable("data")
    for name, nf in (("c1", 16), ("c2", 32)):
        body = sym.Convolution(body, kernel=(3, 3), pad=(1, 1),
                               num_filter=nf, name=name)
        body = sym.Activation(body, act_type="relu")
        body = sym.Pooling(body, kernel=(2, 2), stride=(2, 2),
                           pool_type="max")
    rois = sym.Variable("rois")
    flat = sym.reshape(rois, (-1, 4))
    bidx = sym.reshape(sym.Variable("roi_batch_idx"), (-1, 1))
    pooled = sym.ROIPooling(body, sym.Concat(bidx, flat, dim=1),
                            pooled_size=(4, 4), spatial_scale=0.25,
                            name="roipool")
    h = sym.Activation(sym.FullyConnected(sym.Flatten(pooled), num_hidden=64,
                                          name="fc1"), act_type="relu")
    cls = sym.FullyConnected(h, num_hidden=RCNN_CLASSES + 1, name="cls")
    label = sym.reshape(sym.Custom(rois, sym.Variable("gt"),
                                   op_type="proposal_target"), (-1,))
    return sym.SoftmaxOutput(cls, label, normalization="valid",
                             name="softmax")


def rcnn_phase(torch, np):
    """13d. ``examples/train_rcnn.py`` at its defaults on the card:
    ``Module`` with the CustomOp in the graph, per-epoch permutations,
    ``forward_backward`` + ``update``; then the example's ROI accuracy
    on the training set against its gate, the step time and the share of
    it the CustomOp's host round trip takes."""
    import mxnet_tpu_torch as mt
    timer = {}
    register_proposal_target(mt, np, timer)
    x, rois, gt = rcnn_data(np, RCNN_IMAGES, seed=9)
    B, R = RCNN_BATCH, RCNN_R
    bidx = np.repeat(np.arange(B, dtype=np.float32), R).reshape(B, R, 1)
    mod = mt.mod.Module(rcnn_symbol(mt), context=mt.gpu(0),
                        data_names=("data", "rois", "roi_batch_idx"),
                        label_names=("gt",))
    mod.bind(data_shapes=[("data", (B, 3, RCNN_SIZE, RCNN_SIZE)),
                          ("rois", (B, R, 4)), ("roi_batch_idx", (B, R, 1))],
             label_shapes=[("gt", (B, 5))])
    mod.init_params(mt.init.Xavier(magnitude=2).set_rng(
        mt.random.derive_numpy_rng("train_rcnn")))
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": RCNN_LR, "momentum": 0.9})
    cpu = mt.cpu()

    def batch(idx):
        return mt.io.DataBatch(
            data=[mt.nd.array(x[idx], ctx=cpu), mt.nd.array(rois[idx],
                                                            ctx=cpu),
                  mt.nd.array(bidx, ctx=cpu)],
            label=[mt.nd.array(gt[idx], ctx=cpu)])

    n = (len(x) // B) * B
    steps = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for epoch in range(RCNN_EPOCHS):
        perm = np.random.RandomState(epoch).permutation(n)
        if epoch == min(1, RCNN_EPOCHS - 1):
            torch.cuda.synchronize()
            start.record()
            timer.clear()
            t0 = time.perf_counter()
            steps = 0
        for s in range(0, n, B):
            mod.forward_backward(batch(perm[s:s + B]))
            mod.update()
            steps += 1
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_ms = start.elapsed_time(end) / steps
    custom_ms = timer.get("s", 0.0) * 1e3 / max(timer.get("calls", 1), 1)
    correct = total = 0
    for s in range(0, n, B):
        idx = np.arange(s, s + B)
        mod.forward(batch(idx), is_train=False)
        probs = mod.get_outputs()[0].asnumpy()
        lab = mt.nd.Custom(mt.nd.array(rois[idx], ctx=cpu),
                           mt.nd.array(gt[idx], ctx=cpu),
                           op_type="proposal_target").asnumpy().ravel()
        correct += int((probs.argmax(1) == lab).sum())
        total += lab.size
    acc = correct / total
    log("13d fast r-cnn: %d epochs x %d steps (batch %d, %d ROIs an image), "
        "%.3f ms a step (%.3f s wall for %d steps); the proposal_target "
        "CustomOp's forward %.3f ms a call, host round trip included "
        "(%.1f%% of the step); ROI accuracy %.4f (gate > %g)"
        % (RCNN_EPOCHS, n // B, B, R, step_ms, wall, steps, custom_ms,
           100 * custom_ms / step_ms, acc, RCNN_MIN_ACC))
    check(acc > RCNN_MIN_ACC, "13d fast r-cnn: ROI accuracy %.4f, the "
          "example's gate is > %g" % (acc, RCNN_MIN_ACC))
    return {"step_ms": step_ms, "custom_ms": custom_ms, "acc": acc}


# ---------------------------------------- 13e: CTC OCR

def ctc_data(np, n, seed):
    """``examples/ctc_ocr.py``'s strips: CTC_DIGITS digits of 0..4 each
    a two-row bar whose height codes its class, with position jitter."""
    rng = np.random.RandomState(seed)
    T = CTC_DIGITS * CTC_DIGIT_W + 6
    ys = rng.randint(0, CTC_CLASSES, (n, CTC_DIGITS))
    xs = []
    for y in ys:
        strip = rng.rand(CTC_H, T).astype(np.float32) * 0.2
        pos = 1
        for d in y:
            pos += rng.randint(0, 3)
            r0 = 1 + 2 * int(d)
            strip[r0:r0 + 2, pos:pos + 4] += 0.8
            pos += CTC_DIGIT_W - 2
        xs.append(np.clip(strip, 0, 1))
    return np.stack(xs).astype(np.float32), ys.astype(np.float32)


def ctc_net(mt, hidden):
    """``examples/ctc_ocr.py``'s Gluon ``Net``: a (H, 5) convolution over
    the strip, a (1, 5) one, and a 1x1 to per-frame class scores
    (B, T, C + 1)."""
    nd, nn = mt.nd, mt.gluon.nn

    class Net(mt.gluon.Block):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.c1 = nn.Conv2D(hidden, kernel_size=(CTC_H, 5),
                                    padding=(0, 2))
                self.c2 = nn.Conv2D(hidden, kernel_size=(1, 5),
                                    padding=(0, 2), activation="relu")
                self.c3 = nn.Conv2D(CTC_CLASSES + 1, kernel_size=(1, 1))

        def forward(self, x):
            h = nd.expand_dims(x, axis=1)
            h = nd.Activation(self.c1(h), act_type="relu")
            h = nd.squeeze(self.c3(self.c2(h)), axis=2)
            return nd.transpose(h, axes=(0, 2, 1))

    return Net(prefix="ctc_")


def greedy_decode(probs):
    """Best path: (T, B, C+1) -> collapsed sequences (blank 0; class k
    is digit k - 1)."""
    ids = probs.argmax(axis=2)
    out = []
    for b in range(ids.shape[1]):
        seq, prev = [], -1
        for t in range(ids.shape[0]):
            k = int(ids[t, b])
            if k != prev and k != 0:
                seq.append(k - 1)
            prev = k
        out.append(seq)
    return out


def ctc_phase(torch, np):
    """13e. ``examples/ctc_ocr.py`` at its defaults through Gluon on the
    card: ``Trainer("adam")``, ``autograd.record()``, ``nd.CTCLoss`` over
    the unsegmented labels, then greedy decoding of the held-out strips
    against the example's gate."""
    import mxnet_tpu_torch as mt
    mt.random.seed(SEED)
    dev = mt.gpu(0)
    X, Y = ctc_data(np, CTC_EXAMPLES, seed=1)
    Xv, Yv = ctc_data(np, 200, seed=2)
    net = ctc_net(mt, CTC_HIDDEN)
    net.initialize(mt.init.Xavier().set_rng(
        mt.random.derive_numpy_rng("ctc_ocr")), ctx=dev)
    trainer = mt.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": CTC_LR})
    bs = min(CTC_EXAMPLES, 100)
    losses = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    steps = 0
    for epoch in range(CTC_EPOCHS):
        if epoch == min(1, CTC_EPOCHS - 1):
            torch.cuda.synchronize()
            start.record()
            steps = 0
        tot = 0.0
        for i in range(0, len(X), bs):
            xb = mt.nd.array(X[i:i + bs], ctx=dev)
            yb = mt.nd.array(Y[i:i + bs], ctx=dev)
            with mt.autograd.record():
                act = mt.nd.transpose(net(xb), axes=(1, 0, 2))
                loss = mt.nd.mean(mt.nd.CTCLoss(act, yb + 1))
            loss.backward()
            trainer.step(1)
            tot += float(loss.asnumpy().ravel()[0])
            steps += 1
        losses.append(tot / (len(X) / bs))
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / steps
    probs = np.transpose(net(mt.nd.array(Xv, ctx=dev)).asnumpy(), (1, 0, 2))
    dec = greedy_decode(probs)
    acc = sum(1 for d, y in zip(dec, Yv) if d == [int(v) for v in y]) / len(Yv)
    log("13e ctc ocr: %d epochs of %d strips (T %d, %d classes + blank), "
        "%.3f ms a step (loss read each step); ctc loss first %.4f last "
        "%.4f; sequence accuracy on 200 held-out strips %.3f (gate > %g)"
        % (CTC_EPOCHS, len(X), CTC_DIGITS * CTC_DIGIT_W + 6, CTC_CLASSES,
           step_ms, losses[0], losses[-1], acc, CTC_MIN_ACC))
    check(all(math.isfinite(v) for v in losses), "13e ctc: a loss is not "
          "finite")
    check(acc > CTC_MIN_ACC, "13e ctc: sequence accuracy %.3f, the "
          "example's gate is > %g" % (acc, CTC_MIN_ACC))
    return {"step_ms": step_ms, "acc": acc, "losses": losses}


def structured_phase(torch, np):
    """Phase 13: the structured op families on the card (a), the SSD
    example (b), the detection ops at their published sizes (c), the
    Fast R-CNN example (d) and the CTC OCR example (e)."""
    check(not torch.backends.cudnn.allow_tf32 and
          not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is allowed: phase 13's checks would not be float32")
    t0 = time.perf_counter()
    readings = {"ops": structured_op_sweep(torch, np)}
    readings["ssd"] = ssd_phase(torch, np)
    readings["published"] = published_phase(torch, np)
    readings["rcnn"] = rcnn_phase(torch, np)
    readings["ctc"] = ctc_phase(torch, np)
    log("structured ops and detection phase: %.1f s"
        % (time.perf_counter() - t0))
    return readings


# ------------------------------------------------------------------ phase 14

def fluent_cases(sym):
    """Every fluent method of ``Symbol`` on the variable ``x`` (4, 6),
    with its attributes given positionally where the method takes one;
    ``y`` (6, 3) and ``idx`` (3,) are further inputs where a method
    takes a symbol. ``sym`` is a package's symbol namespace."""
    x = sym.Variable("x")
    return {
        "sum": x.sum(1), "mean": x.mean(axis=0), "max": x.max(1, True),
        "min": x.min(), "prod": x.prod(axis=1), "argmax": x.argmax(1),
        "argmin": x.argmin(axis=0), "clip": x.clip(0.6, 1.2),
        "abs": (x - 1).abs(), "sign": (x - 1).sign(),
        "round": (x * 3).round(), "floor": (x * 3).floor(),
        "ceil": (x * 3).ceil(), "sqrt": x.sqrt(), "square": x.square(),
        "exp": x.exp(), "log": x.log(), "sigmoid": x.sigmoid(),
        "tanh": x.tanh(), "relu": (x - 1).relu(), "softmax": x.softmax(0),
        "log_softmax": x.log_softmax(axis=1), "transpose": x.transpose(),
        "swapaxes": x.swapaxes(0, 1), "flatten": x.flatten(),
        "expand_dims": x.expand_dims(1), "repeat": x.repeat(2, 1),
        "tile": x.tile((2, 1)), "flip": x.flip(1), "sort": x.sort(1),
        "argsort": x.argsort(0), "topk": x.topk(1, 2),
        "take": x.take(sym.Variable("idx")),
        "one_hot": (x * 3).floor().one_hot(5),
        "broadcast_to": x.expand_dims(0).broadcast_to((2, 4, 6)),
        "slice_axis": x.slice_axis(1, 0, 2),
        "squeeze": x.expand_dims(0).squeeze(),
        "norm": x.norm(), "split": x.split(2, 1),
        "slice": x.slice((0, 1), (3, 5)), "reshape": x.reshape((3, 8)),
        "dot": x.dot(sym.Variable("y")),
    }


def fluent_inputs(np):
    rng = np.random.RandomState(SEED)
    return {"x": rng.uniform(0.1, 1.9, (4, 6)).astype(np.float32),
            "y": rng.uniform(-1, 1, (6, 3)).astype(np.float32),
            "idx": np.array([3, 0, 2], np.float32)}


def eval_symbol(mt, s, inputs, ctx):
    """``s.eval`` on ``ctx`` with the inputs it lists, as float64 numpy."""
    kw = {n: mt.nd.array(inputs[n], ctx=ctx) for n in s.list_arguments()}
    return [o.asnumpy().astype("float64") for o in s.eval(ctx=ctx, **kw)]


def surface_close(np, what, got, want):
    check(len(got) == len(want), "14a %s: %d outputs on the card, %d on the "
          "CPU" % (what, len(got), len(want)))
    worst = 0.0
    for g, w in zip(got, want):
        check(g.shape == w.shape, "14a %s: shape %s on the card, %s on the "
              "CPU" % (what, g.shape, w.shape))
        scale = max(1.0, float(np.abs(w).max(initial=0.0)))
        err = float(np.abs(g - w).max(initial=0.0)) / scale
        check(err <= SURFACE_RTOL, "14a %s: card %.3g of max(1, max|cpu|) "
              "off the CPU (limit %g)" % (what, err, SURFACE_RTOL))
        worst = max(worst, err)
    return worst


def seeded_args(mt, np, s, shapes, seed):
    """Seeded values for every argument of ``s`` but the given inputs
    (Xavier(gaussian, in, 2), the initializer's rules by name) and its
    aux states, as numpy."""
    arg_shapes, _, aux_shapes = s.infer_shape(**shapes)
    init = mt.init.Xavier(rnd_type="gaussian", factor_type="in",
                          magnitude=2).set_rng(np.random.default_rng(seed))
    out = []
    for names, shps in ((s.list_arguments(), arg_shapes),
                        (s.list_auxiliary_states(), aux_shapes)):
        vals = {}
        for n, sh in zip(names, shps):
            if n not in shapes:
                arr = mt.nd.zeros(sh, ctx=mt.cpu())
                init(mt.init.InitDesc(n), arr)
                vals[n] = arr.asnumpy()
        out.append(vals)
    return out


def surface_eval(mt, np, s, inputs, args, aux, ctx):
    kw = {n: mt.nd.array(v, ctx=ctx) for n, v in {**args, **inputs}.items()}
    aux_nd = {n: mt.nd.array(v, ctx=ctx) for n, v in aux.items()}
    return [o.asnumpy().astype("float64")
            for o in s.eval(ctx=ctx, aux_states=aux_nd, **kw)]


def feature_cut(s, head):
    """The input of op node ``head`` in ``s`` (a net cut at its feature
    layer): the first child of ``get_internals()[head + "_output"]``."""
    internals = s.get_internals()
    name = internals[head + "_output"].get_children().list_outputs()[0]
    return name, internals[name]


def surface_phase(torch, np):
    """14a. The Symbol surface on the card against the CPU: every fluent
    method; ResNet-50's and the LM's internals, partial shapes and
    types; each net cut at its feature layer through ``get_internals``,
    composed with a preprocessing symbol and evaluated on both devices
    from the same seeded weights."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.models import resnet, transformer
    card, host = mt.gpu(0), mt.cpu()
    t0 = time.perf_counter()
    inputs = fluent_inputs(np)
    worst = 0.0
    cases = fluent_cases(mt.sym)
    for name, s in cases.items():
        worst = max(worst, surface_close(
            np, "fluent " + name, eval_symbol(mt, s, inputs, card),
            eval_symbol(mt, s, inputs, host)))
    log("14a fluent methods: %d on the card within %.3g of max(1, "
        "max|cpu|) of the CPU" % (len(cases), worst))
    readings = {"fluent": len(cases), "fluent_err": worst}
    S = RESNET_IMAGE
    nets = {
        "resnet": (resnet.get_symbol(num_classes=RESNET_CLASSES,
                                     num_layers=RESNET_LAYERS, stem="s2d",
                                     image_shape="3,%d,%d" % (S, S)),
                   "fc1", {"data": (SURFACE_RESNET_BATCH, 3, S, S)},
                   lambda raw: (raw - 0.5) * 2.0),
        "lm": (transformer.get_symbol(VOCAB, SURFACE_LM_LAYERS, D_MODEL,
                                      HEADS, D_FF, MAX_SEQ,
                                      attention="flash"),
               "lm_head", {"data": (1, MAX_SEQ)},
               lambda raw: raw.clip(0, VOCAB - 1)),
    }
    for what, (net, head, shapes, prep) in nets.items():
        check(net.infer_shape_partial() == (None, None, None),
              "14a %s: infer_shape_partial without the data shape "
              "inferred something" % what)
        arg_shapes, _, _ = net.infer_shape_partial(
            softmax_label=shapes["data"][:1] if what == "resnet"
            else shapes["data"], **shapes)
        check(arg_shapes is not None and None not in arg_shapes,
              "14a %s: infer_shape_partial with the data and label shapes "
              "left shapes unknown" % what)
        arg_types, out_types, aux_types = net.infer_type()
        check(all(t == np.float32 for t in arg_types + out_types +
                  aux_types), "14a %s: infer_type is not float32" % what)
        internals = net.get_internals()
        name, feat = feature_cut(net, head)
        # composition: the cut net over a preprocessing symbol
        pre = feat(data=prep(mt.sym.Variable("raw")))
        args, aux = seeded_args(mt, np, feat, shapes, SEED)
        rng = np.random.RandomState(SEED + 1)
        raw = rng.uniform(0, 1, shapes["data"]).astype(np.float32) \
            if what == "resnet" else \
            rng.randint(0, VOCAB, shapes["data"]).astype(np.float32)
        want = surface_eval(mt, np, pre, {"raw": raw}, args, aux, host)
        got = surface_eval(mt, np, pre, {"raw": raw}, args, aux, card)
        err = surface_close(np, what + " " + name, got, want)
        check(pre.list_arguments()[0] == "raw" and
              "data" not in pre.list_arguments(),
              "14a %s: composition left %s" % (what, pre.list_arguments()))
        log("14a %s: %d internals, %d arguments (%d shapes inferred from "
            "the data's), cut at %s -> %s, composed, evaluated on the card "
            "within %.3g of the CPU" % (
                what, len(internals.list_outputs()),
                len(net.list_arguments()), len(arg_shapes), name,
                "x".join(map(str, got[0].shape)), err))
        readings[what] = {"internals": len(internals.list_outputs()),
                          "cut": name, "err": err}
    readings["s"] = time.perf_counter() - t0
    return readings


def resnet_batches(np, n, classes, seed):
    rng = np.random.RandomState(seed)
    B, S = RESNET_BATCH, RESNET_IMAGE
    x = rng.uniform(-1, 1, (n * B, 3, S, S)).astype(np.float32)
    y = rng.randint(0, classes, (n * B,)).astype(np.float32)
    return x, y


def fine_tune_symbol(mt, net, head_classes):
    """``net`` cut at its feature layer (the input of ``fc1``) with a new
    ``FullyConnected`` head whose weight has ``lr_mult`` FT_LR_MULT."""
    name, feat = feature_cut(net, "fc1")
    w = mt.sym.Variable("head_weight", lr_mult=FT_LR_MULT)
    out = mt.sym.FullyConnected(feat, weight=w, num_hidden=head_classes,
                                name="head")
    return name, mt.sym.SoftmaxOutput(out, name="softmax")


def fine_tune_resnet(torch, np):
    """14b. ResNet-50 (the ResNet phase's configuration, amp bf16) fit on
    seeded images, checkpointed, loaded back, cut at its feature layer
    with a new head (``lr_mult`` 10) and fine-tuned with every backbone
    argument fixed. Gates: the fixed arguments bit for bit, the head's
    first update what SGD at lr x lr_mult gives, the loss falling, and
    the moving statistics updated (the reference's rule: a fixed
    parameter takes no gradient, its BatchNorm still runs in training
    mode)."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.models import resnet
    B, S = RESNET_BATCH, RESNET_IMAGE
    dev = mt.gpu(0)
    prefix = str(ROOT / "build" / "phase14_ft" / "resnet")
    Path(prefix).parent.mkdir(parents=True, exist_ok=True)
    mt.amp.init("bfloat16")
    try:
        net = resnet.get_symbol(num_classes=RESNET_CLASSES,
                                num_layers=RESNET_LAYERS, stem="s2d",
                                image_shape="3,%d,%d" % (S, S))
        x, y = resnet_batches(np, FT_PRE_BATCHES, RESNET_CLASSES, SEED)
        it = mt.io.NDArrayIter(x, y, B, label_name="softmax_label")
        mod = mt.mod.Module(net, context=dev)
        t0 = time.perf_counter()
        mod.fit(it, num_epoch=1, optimizer="sgd", optimizer_params={
            "learning_rate": RESNET_LR, "momentum": RESNET_MOMENTUM,
            "wd": RESNET_WD}, initializer=mt.init.Xavier(
                rnd_type="gaussian", factor_type="in", magnitude=2).set_rng(
                    np.random.default_rng(SEED)))
        mod.save_checkpoint(prefix, 1)
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t0
        del mod, it
        gc.collect()
        torch.cuda.empty_cache()
        loaded, arg_params, aux_params = mt.model.load_checkpoint(prefix, 1)
        cut, tuned = fine_tune_symbol(mt, loaded, FT_CLASSES)
        fixed = [n for n in tuned.list_arguments() if n in arg_params]
        check(sorted(fixed) == sorted(n for n in arg_params
                                      if not n.startswith("fc1_")),
              "14b: the cut net's backbone arguments are not the "
              "checkpoint's")
        xt, yt = resnet_batches(np, 1, FT_CLASSES, SEED + 1)
        it = mt.io.NDArrayIter(xt, yt, B, label_name="softmax_label")
        mod = mt.mod.Module(tuned, context=dev, fixed_param_names=fixed)
        mod.bind(data_shapes=it.provide_data,
                 label_shapes=it.provide_label)
        mod.init_params(mt.init.Xavier().set_rng(
            np.random.default_rng(SEED + 2)), arg_params=arg_params,
            aux_params=aux_params, allow_missing=True)
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": FT_LR, "wd": RESNET_WD})
        opt = mod._optimizer
        check(opt.lr_mult.get("head_weight") == FT_LR_MULT,
              "14b: the optimizer reads lr_mult %s for head_weight, the "
              "Variable asks for %g" % (opt.lr_mult.get("head_weight"),
                                        FT_LR_MULT))
        batch = next(iter(it))
        db = mt.io.DataBatch(data=[batch.data[0].as_in_context(dev)],
                             label=[batch.label[0].as_in_context(dev)])
        y_col = batch.label[0].data.to(dev.device).long().view(-1, 1)
        w0 = mod._exec.arg_dict["head_weight"].data.clone()
        aux0 = {n: a.data.clone() for n, a in mod._exec.aux_dict.items()}

        def loss():
            out = mod.get_outputs()[0].data.float()
            return -(out.gather(1, y_col) + 1e-12).log().mean()

        mod.forward_backward(db)
        g = mod._exec.grad_dict["head_weight"].data.clone()
        losses = [loss()]
        mod.update()
        dw = mod._exec.arg_dict["head_weight"].data - w0
        want = -FT_LR * FT_LR_MULT * (g * opt.rescale_grad + RESNET_WD * w0)
        rate_err = float((dw - want).abs().max() / want.abs().max())
        # w0 + update is rounded to f32 and dw = w1 - w0 once more: two
        # roundings of |w| (2^-24 each) beside an update ~1e-3 of |w|
        rate_tol = FT_RATE_RTOL + 2.0 ** -23 * float(
            w0.abs().max() / want.abs().max())
        for _ in range(FT_STEPS - 1):
            mod._fit_step(db)
            losses.append(loss())
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(FT_TIMED):
            mod._fit_step(db)
        end.record()
        torch.cuda.synchronize()
        step_ms = start.elapsed_time(end) / FT_TIMED
        args_now, aux_now = mod.get_params()
        moved = [n for n in fixed
                 if not torch.equal(args_now[n].data.cpu(),
                                    arg_params[n].data.cpu())]
        aux_moved = sum(not torch.equal(aux_now[n].data, aux0[n])
                        for n in aux0)
        losses = [float(v) for v in torch.stack(losses).cpu()]
    finally:
        mt.amp.off()
        for f in Path(prefix).parent.glob("*"):
            f.unlink()
    log("14b fine-tune: ResNet-%d fit %d batches of %d and checkpointed "
        "in %.1f s; cut at %s, new %d-class head (head_weight lr_mult %g), "
        "%d fixed arguments; first head update within %.3g of SGD at lr x "
        "lr_mult (limit %.3g); loss %s; %.3f ms a step (%d timed, amp "
        "bf16); %d of %d moving statistics "
        "updated" % (RESNET_LAYERS, FT_PRE_BATCHES, B, pre_s, cut,
                     FT_CLASSES, FT_LR_MULT, len(fixed), rate_err, rate_tol,
                     " ".join("%.4f" % v for v in losses), step_ms,
                     FT_TIMED, aux_moved, len(aux0)))
    check(not moved, "14b: fixed arguments changed: %s" % moved[:5])
    check(rate_err <= rate_tol, "14b: the head's first update is %.3g of "
          "itself off lr x lr_mult (limit %.3g: %g and two f32 roundings of "
          "the weight)" % (rate_err, rate_tol, FT_RATE_RTOL))
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          "14b: the fine-tune loss did not fall: %s" % losses)
    check(aux_moved == len(aux0), "14b: %d of %d moving statistics "
          "updated; the reference updates them all" % (aux_moved, len(aux0)))
    del mod
    gc.collect()
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "losses": losses, "rate_err": rate_err,
            "cut": cut, "fixed": len(fixed)}


def grouped_lm_symbol(mt, layers):
    """The zoo LM at the phase's width: the body built inside
    ``AttrScope(ctx_group="body")``, cut at the final LayerNorm with
    ``get_internals``, the head (``FullyConnected(VOCAB)`` +
    ``SoftmaxOutput``) put on it inside ``AttrScope(ctx_group="head")``."""
    from mxnet_tpu_torch.models import transformer
    with mt.AttrScope(ctx_group="body"):
        full = transformer.get_symbol(VOCAB, layers, D_MODEL, HEADS, D_FF,
                                      MAX_SEQ, attention="flash")
    cut, feat = feature_cut(full, "lm_head")
    with mt.AttrScope(ctx_group="head"):
        logits = mt.sym.FullyConnected(feat, num_hidden=VOCAB,
                                       flatten=False, name="lm_head")
        logits = mt.sym.reshape(logits, (-1, VOCAB))
        label = mt.sym.reshape(mt.sym.Variable("softmax_label"), (-1,))
        out = mt.sym.SoftmaxOutput(logits, label, name="softmax",
                                   normalization="batch")
    return cut, out


def device_kernel_names(prof):
    """The names of the kernels that took device time in a profile."""
    return {e.key for e in prof.key_averages()
            if e.self_device_time_total > 0}


def grouped_step(ex, lr):
    """One forward, backward and plain SGD step through an executor;
    returns the outputs and the gradients (tensors)."""
    import torch
    out = ex.forward(is_train=True)[0].data
    ex.backward()
    grads = {n: g.data for n, g in ex.grad_dict.items()}
    with torch.no_grad():
        for n, g in grads.items():
            if n not in ("data", "softmax_label"):
                ex.arg_dict[n].data.sub_(g, alpha=lr)
    return out, grads


def grouped_lm_phase(torch, np, layers=None):
    """14c. The zoo LM at bench.py's width in amp bf16, bound with
    ``simple_bind(group2ctx={"body": gpu(0), "head": gpu(0)})`` and
    without, from the same seeded weights: GROUP_STEPS forward, backward
    and SGD steps in lock step must be bit for bit equal (outputs,
    every gradient, the weights after), then each timed and one grouped
    step profiled, whose trace must name the three flash-attention
    kernels; the kernel counters, zeroed before the grouped steps, must
    read one launch of each kernel per layer per step."""
    from torch.profiler import ProfilerActivity, profile
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import flash_attention as fa
    layers = layers or LAYERS
    B, T = TRAIN_BATCH, MAX_SEQ
    dev = mt.gpu(0)
    counters = {"flash_attention_fwd_bf16": fa.flash_attention_fwd,
                "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
                "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv}
    mt.amp.init("bfloat16")
    try:
        cut, net = grouped_lm_symbol(mt, layers)
        groups = {"body": dev, "head": dev}
        t0 = time.perf_counter()
        grouped = net.simple_bind(dev, group2ctx=groups, data=(B, T),
                                  softmax_label=(B, T))
        bind_s = time.perf_counter() - t0
        plain = net.simple_bind(dev, data=(B, T), softmax_label=(B, T))
        init = mt.init.Xavier().set_rng(np.random.default_rng(SEED))
        # at the full depth, phase 6's Xavier weights by name (drawn once)
        drawn = lm_xavier(torch, np) if layers == LAYERS else {}
        rng = np.random.RandomState(0)
        x = rng.randint(0, VOCAB, (B, T)).astype(np.float32)
        y = rng.randint(0, VOCAB, (B, T)).astype(np.float32)
        for n, arr in grouped.arg_dict.items():
            if n == "data":
                arr[:] = x
            elif n == "softmax_label":
                arr[:] = y
            elif n in drawn:
                arr.data.copy_(drawn[n])
            else:
                init(mt.init.InitDesc(n), arr)
            plain.arg_dict[n][:] = arr
        attrs = net.attr_dict()
        n_body = sum(1 for n in grouped.arg_dict
                     if attrs.get(n, {}).get("ctx_group") == "body")
        launches = {n: {"f32": 0, "bf16": 0} for n in counters}
        for step in range(GROUP_STEPS):
            # the grouped path: counters zeroed just before, read after
            for fn in counters.values():
                fn.launches = {"f32": 0, "bf16": 0}
            out_g, grads_g = grouped_step(grouped, TRAIN_LR)
            for n, fn in counters.items():
                for k, v in fn.launches.items():
                    launches[n][k] += v
            out_p, grads_p = grouped_step(plain, TRAIN_LR)
            check(torch.equal(out_g, out_p), "14c step %d: the grouped "
                  "outputs differ from the ungrouped bind's" % (step + 1))
            differ = [n for n in grads_p
                      if not torch.equal(grads_g[n], grads_p[n])]
            check(not differ, "14c step %d: gradients differ: %s"
                  % (step + 1, differ[:5]))
        torch.cuda.synchronize()
        differ = [n for n in plain.arg_dict
                  if not torch.equal(grouped.arg_dict[n].data,
                                     plain.arg_dict[n].data)]
        check(not differ, "14c: weights after %d steps differ: %s"
              % (GROUP_STEPS, differ[:5]))
        for name, n in launches.items():
            check(n["bf16"] == layers * GROUP_STEPS and n["f32"] == 0,
                  "14c: %s launched %s times in %d grouped steps of %d "
                  "layers" % (name, n, GROUP_STEPS, layers))
        times = {}
        for what, ex in (("grouped", grouped), ("ungrouped", plain)):
            grouped_step(ex, TRAIN_LR)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(GROUP_TIMED):
                grouped_step(ex, TRAIN_LR)
            end.record()
            torch.cuda.synchronize()
            times[what] = start.elapsed_time(end) / GROUP_TIMED
        del plain
        gc.collect()
        torch.cuda.empty_cache()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            grouped_step(grouped, TRAIN_LR)
            torch.cuda.synchronize()
        attention = sorted(n for n in device_kernel_names(prof)
                           if kernel_kind(n) == "attention kernels")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finally:
        mt.amp.off()
    log("14c grouped LM: %d layers, d_model %d, T %d, batch %d, amp bf16; "
        "body cut at %s, head in its own group; %d of %d arguments in "
        "'body'; bind %.1f s; %d steps bit for bit equal to the ungrouped "
        "bind (outputs, %d gradients, weights); launches %s; step (forward, "
        "backward, SGD through the executor) %.3f ms grouped, %.3f ms "
        "ungrouped (%d timed); attention kernels in the profile: %s; peak "
        "%.1f GB"
        % (layers, D_MODEL, T, B, cut, n_body, len(grouped.arg_dict),
           bind_s, GROUP_STEPS, len(grads_p), launches, times["grouped"],
           times["ungrouped"], GROUP_TIMED, ", ".join(
               n[:40] for n in attention), peak_gb))
    for kind in ("fa_fwd", "fa_bwd_dq", "fa_bwd_dkv"):
        check(any(kind in n for n in attention), "14c: no %s kernel in the "
              "grouped step's profile (%s)" % (kind, attention))
    del grouped
    gc.collect()
    torch.cuda.empty_cache()
    return {"step_ms": times["grouped"], "ungrouped_ms": times["ungrouped"],
            "launches": launches, "attention": attention}


# ---- examples/fine_tune.py

def ft_shapes(np, n, num_classes, seed):
    """Class = which quadrant holds a bright blob (num_classes <= 4)."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, num_classes, n)
    x = rng.rand(n, 1, 28, 28).astype(np.float32) * 0.3
    for i in range(n):
        qy, qx = divmod(int(y[i]), 2)
        x[i, 0, 14 * qy:14 * qy + 12, 14 * qx:14 * qx + 12] += 0.6
    return x, y.astype(np.float32)


def ft_features(mt):
    """``fine_tune.py``'s ``feature_net``."""
    sym = mt.sym
    net = sym.Convolution(sym.Variable("data"), kernel=(5, 5), num_filter=8,
                          name="c1")
    net = sym.Activation(net, act_type="relu")
    net = sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max")
    net = sym.Convolution(net, kernel=(3, 3), num_filter=16, name="c2")
    net = sym.Activation(net, act_type="relu")
    net = sym.Flatten(net)
    net = sym.FullyConnected(net, num_hidden=32, name="feat")
    return sym.Activation(net, act_type="relu")


def ft_head(mt, features, num_classes, head_name):
    out = mt.sym.FullyConnected(features, num_hidden=num_classes,
                                name=head_name)
    return mt.sym.SoftmaxOutput(out, name="softmax")


def ft_train(mt, np, sym, x, y, epochs, lr, ctx, init_seed, arg_params=None,
             batch=50, fixed_param_names=None):
    """``fine_tune.py``'s ``train``: Module, Xavier (seeded), the
    checkpoint's backbone over it (``allow_missing``), SGD 0.9."""
    it = mt.io.NDArrayIter(x, y, batch, shuffle=True,
                           label_name="softmax_label")
    mod = mt.mod.Module(sym, context=ctx,
                        fixed_param_names=fixed_param_names)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(mt.init.Xavier().set_rng(
        np.random.default_rng(init_seed)))
    if arg_params:
        mod.set_params(arg_params, {}, allow_missing=True)
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": lr, "momentum": 0.9})
    for _ in range(epochs):
        it.reset()
        for b in it:
            mod.forward_backward(b)
            mod.update()
    it.reset()
    return mod, dict(mod.score(it, "acc"))["accuracy"]


def fine_tune_example(torch, np, a=None):
    """``examples/fine_tune.py`` at its defaults: pretrain on 4 classes,
    checkpoint, load, a 3-class head over the frozen backbone; gates:
    the backbone carries the checkpoint's weights, accuracy > 0.9."""
    import mxnet_tpu_torch as mt
    a = a or FINE_TUNE
    mt.random.seed(42)
    np.random.seed(42)
    prefix = str(ROOT / "build" / "phase14_fine_tune" / "pre")
    Path(prefix).parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with mt.gpu(0):
        ctx = mt.context.current_context()
        feats = ft_features(mt)
        xp, yp = ft_shapes(np, a["n_pre"], 4, seed=1)
        pre, pre_acc = ft_train(mt, np, ft_head(mt, feats, 4, "fc_pre"), xp,
                                yp, a["pretrain_epochs"], 0.05, ctx, 1)
        pre.save_checkpoint(prefix, a["pretrain_epochs"])
        xt, yt = ft_shapes(np, a["n_tune"], 3, seed=2)
        _, arg_params, _ = mt.model.load_checkpoint(prefix,
                                                    a["pretrain_epochs"])
        arg_params = {k: v for k, v in arg_params.items()
                      if not k.startswith("fc_pre")}
        tuned, tuned_acc = ft_train(
            mt, np, ft_head(mt, feats, 3, "fc_new"), xt, yt,
            a["tune_epochs"], 0.05, ctx, 2, arg_params=arg_params,
            fixed_param_names=list(arg_params))
        same = np.array_equal(tuned.get_params()[0]["c1_weight"].asnumpy(),
                              arg_params["c1_weight"].asnumpy())
        _, scratch_acc = ft_train(mt, np, ft_head(mt, feats, 3, "fc_new"),
                                  xt, yt, a["tune_epochs"], 0.05, ctx, 2)
    for f in Path(prefix).parent.glob("*"):
        f.unlink()
    secs = time.perf_counter() - t0
    log("14d fine_tune: context %s; pretrain accuracy %.3f; fine-tuned %.3f "
        "(gate > %g), from scratch %.3f; backbone kept the checkpoint's "
        "weights: %s; %.1f s" % (ctx, pre_acc, tuned_acc, a["min_acc"],
                                 scratch_acc, same, secs))
    check(same, "14d fine_tune: the backbone did not transfer from the "
          "checkpoint")
    check(tuned_acc > a["min_acc"], "14d fine_tune: accuracy %.3f, the "
          "example's gate is > %g" % (tuned_acc, a["min_acc"]))
    return {"acc": tuned_acc, "scratch_acc": scratch_acc, "s": secs}


# ---- examples/model_parallel_lstm.py

def mp_lstm_symbol(mt, num_layers, num_hidden, seq_len, vocab):
    """``model_parallel_lstm.py``'s ``build_symbol``: a stacked LSTM LM,
    the embedding, each layer and the head in their own ctx group."""
    sym = mt.sym
    with mt.AttrScope(ctx_group="embed"):
        data = sym.Variable("data")
        weight = sym.Variable("embed_weight")
        emb = sym.Embedding(data, weight, input_dim=vocab,
                            output_dim=num_hidden, name="embed")
    hidden = sym.SwapAxis(emb, dim1=0, dim2=1)
    for i in range(num_layers):
        with mt.AttrScope(ctx_group="layer%d" % i):
            cell = mt.rnn.LSTMCell(num_hidden, prefix="lstm%d_" % i)
            hidden, _ = cell.unroll(seq_len, inputs=hidden, layout="TNC",
                                    merge_outputs=True)
    with mt.AttrScope(ctx_group="head"):
        flat = sym.Reshape(hidden, shape=(-1, num_hidden))
        logits = sym.FullyConnected(flat, num_hidden=vocab, name="cls")
        label = sym.Reshape(sym.SwapAxis(sym.Variable("label"), dim1=0,
                                         dim2=1), shape=(-1,))
        return sym.SoftmaxOutput(logits, label, normalization="valid",
                                 name="softmax")


def mp_lstm_data(np, a):
    """The example's task: the next token is (current + 1) % vocab."""
    rng = np.random.RandomState(0)
    x = rng.randint(1, a["vocab"], (a["batch"], a["seq"]))
    return x.astype(np.float32), ((x + 1) % a["vocab"]).astype(np.float32)


def mp_lstm_bind(mt, sym, a, ctx, group2ctx):
    states = {n: (a["batch"], a["hidden"]) for n in sym.list_arguments()
              if "begin_state" in n}
    return sym.simple_bind(ctx=ctx, grad_req="write", group2ctx=group2ctx,
                           data=(a["batch"], a["seq"]),
                           label=(a["batch"], a["seq"]), **states)


def mp_lstm_train(mt, np, ex, params, a):
    """The example's loop from ``params`` (numpy): forward, the nll of
    the outputs, backward, momentum SGD on NDArrays; returns the nlls."""
    x, y = mp_lstm_data(np, a)
    for n, arr in ex.arg_dict.items():
        arr[:] = x if n == "data" else y if n == "label" else params[n]
    vel, nlls = {}, []
    flat = y.T.reshape(-1).astype(int)
    for _ in range(a["steps"]):
        probs = ex.forward(is_train=True)[0].asnumpy()
        p = probs.reshape(-1, a["vocab"])[np.arange(flat.size), flat]
        nlls.append(float(-np.log(np.maximum(p, 1e-12)).mean()))
        ex.backward()
        for n, g in ex.grad_dict.items():
            if n in ("data", "label"):
                continue
            v = vel.get(n)
            v = a["momentum"] * v - a["lr"] * g if v is not None \
                else -a["lr"] * g
            vel[n] = v
            ex.arg_dict[n][:] = ex.arg_dict[n] + v
    return nlls


def mp_lstm_params(mt, np, ex, seed):
    """Xavier for the weights (the example's ``mx.init.Xavier()``,
    seeded), zeros for the begin states."""
    init = mt.init.Xavier().set_rng(np.random.default_rng(seed))
    out = {}
    for n, arr in ex.arg_dict.items():
        if n in ("data", "label"):
            continue
        if "begin_state" in n:
            out[n] = np.zeros(arr.shape, np.float32)
        else:
            init(mt.init.InitDesc(n), arr)
            out[n] = arr.asnumpy()
    return out


def mp_lstm_example(torch, np, a=None):
    """``examples/model_parallel_lstm.py`` at its defaults, twice from the
    same weights: every group on gpu(0), then ``layer0`` on cpu(0) (both
    directions of the boundary copy); each run to the example's gate
    (the nll falls below 0.7 of its first), the two within MP_ATOL at
    every step."""
    import mxnet_tpu_torch as mt
    a = a or MP_LSTM
    t0 = time.perf_counter()
    sym = mp_lstm_symbol(mt, a["layers"], a["hidden"], a["seq"], a["vocab"])
    groups = ["embed"] + ["layer%d" % i for i in range(a["layers"])] + \
        ["head"]
    runs, params = {}, None
    for what, place in (("gpu", {}), ("layer0 on cpu", {"layer0":
                                                         mt.cpu(0)})):
        group2ctx = {g: place.get(g, mt.gpu(0)) for g in groups}
        ex = mp_lstm_bind(mt, sym, a, mt.gpu(0), group2ctx)
        if params is None:
            params = mp_lstm_params(mt, np, ex, 7)
        where = {n: str(arr.context) for n, arr in ex.arg_dict.items()}
        runs[what] = mp_lstm_train(mt, np, ex, params, a)
    secs = time.perf_counter() - t0
    gap = max(abs(u - v) for u, v in zip(runs["gpu"],
                                         runs["layer0 on cpu"]))
    log("14d model_parallel_lstm: %d layers x %d, %d steps; nll %.4f -> "
        "%.4f on gpu(0), %.4f -> %.4f with layer0 on cpu(0) (lstm0 "
        "weights on %s, cls on %s); the placements %.3g apart at most "
        "(limit %g); %.1f s" % (
            a["layers"], a["hidden"], a["steps"], runs["gpu"][0],
            runs["gpu"][-1], runs["layer0 on cpu"][0],
            runs["layer0 on cpu"][-1], where["lstm0_i2h_weight"],
            where["cls_weight"], gap, MP_ATOL, secs))
    check(where["lstm0_i2h_weight"] == str(mt.cpu(0)) and
          where["cls_weight"] == str(mt.gpu(0)), "14d model_parallel_lstm: "
          "arguments not on their groups' devices: %s" % where)
    for what, nlls in runs.items():
        check(nlls[-1] < nlls[0] * a["max_ratio"], "14d model_parallel_lstm "
              "(%s): nll %.4f -> %.4f, the example's gate is < %g of the "
              "first" % (what, nlls[0], nlls[-1], a["max_ratio"]))
    check(gap <= MP_ATOL, "14d model_parallel_lstm: the placements part by "
          "%.3g (limit %g)" % (gap, MP_ATOL))
    return {"nll": runs, "gap": gap, "s": secs}


# ---- examples/bi_lstm_sort.py

def sort_data(np, n, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, SORT_VOCAB, (n, SORT_SEQ))
    return x.astype(np.float32), np.sort(x, axis=1).astype(np.float32)


def sort_symbol(mt, num_hidden=48, num_embed=16):
    """``bi_lstm_sort.py``'s ``get_symbol``."""
    sym = mt.sym
    embed = sym.Embedding(sym.Variable("data"), sym.Variable("embed_weight"),
                          input_dim=SORT_VOCAB, output_dim=num_embed,
                          name="embed")
    bi = mt.rnn.BidirectionalCell(mt.rnn.LSTMCell(num_hidden, prefix="fw_"),
                                  mt.rnn.LSTMCell(num_hidden, prefix="bw_"),
                                  output_prefix="bi_")
    inputs = [sym.reshape(sym.slice_axis(embed, axis=1, begin=t, end=t + 1),
                          (-1, num_embed)) for t in range(SORT_SEQ)]
    outputs, _ = bi.unroll(SORT_SEQ, inputs=inputs, merge_outputs=True)
    logits = sym.FullyConnected(outputs, num_hidden=SORT_VOCAB,
                                flatten=False, name="proj")
    logits = sym.reshape(logits, (-1, SORT_VOCAB))
    label = sym.reshape(sym.Variable("softmax_label"), (-1,))
    return sym.SoftmaxOutput(logits, label, name="softmax",
                             normalization="batch")


def sort_example(torch, np, a=None):
    """``examples/bi_lstm_sort.py`` at its defaults through ``Module.fit``
    (Adam, Perplexity); gate: per-position accuracy > 0.6."""
    import mxnet_tpu_torch as mt
    a = a or SORT
    np.random.seed(a["seed"])
    mt.random.seed(a["seed"])
    t0 = time.perf_counter()
    x, y = sort_data(np, a["examples"])
    n_val = a["examples"] // 6
    train = mt.io.NDArrayIter(x[n_val:], y[n_val:],
                              batch_size=a["batch"], shuffle=True)
    val = mt.io.NDArrayIter(x[:n_val], y[:n_val], batch_size=a["batch"])
    mod = mt.mod.Module(sort_symbol(mt), context=mt.gpu(0))
    mod.fit(train, optimizer="adam",
            optimizer_params={"learning_rate": a["lr"]},
            initializer=mt.init.Xavier().set_rng(
                mt.random.derive_numpy_rng("bi_lstm_sort")),
            num_epoch=a["epochs"],
            eval_metric=mt.metric.Perplexity(ignore_label=None))
    correct = total = 0
    for batch in val:
        mod.forward(batch, is_train=False)
        p = mod.get_outputs()[0].asnumpy().reshape(-1, SORT_SEQ, SORT_VOCAB)
        lbl = batch.label[0].asnumpy()
        keep = lbl.shape[0] - batch.pad
        correct += (p.argmax(-1)[:keep] == lbl[:keep]).sum()
        total += lbl[:keep].size
    acc = float(correct / total)
    secs = time.perf_counter() - t0
    log("14d bi_lstm_sort: %d epochs of %d sequences, per-position "
        "accuracy %.4f (gate > %g, chance %.3f); %.1f s"
        % (a["epochs"], len(x) - n_val, acc, a["min_acc"],
           1.0 / SORT_VOCAB, secs))
    check(acc > a["min_acc"], "14d bi_lstm_sort: accuracy %.4f, the "
          "example's gate is > %g" % (acc, a["min_acc"]))
    return {"acc": acc, "s": secs}


# ---- examples/multi_task.py

def multi_data(np, n, seed=0):
    rng = np.random.RandomState(seed)
    y1 = rng.randint(0, 10, n)
    x = rng.rand(n, 1, 16, 16).astype(np.float32) * 0.3
    for c in range(10):
        r, co = divmod(c, 4)
        x[y1 == c, 0, 4 * r:4 * r + 4, 4 * co:4 * co + 4] += 0.55
    return (np.clip(x, 0, 1), y1.astype(np.float32),
            (y1 % 2).astype(np.float32))


def multi_symbol(mt, heads=("digit", "parity")):
    """``multi_task.py``'s ``build``: a shared backbone, a SoftmaxOutput
    a head, grouped."""
    sym = mt.sym
    h = sym.Convolution(sym.Variable("data"), num_filter=16, kernel=(3, 3),
                        pad=(1, 1), name="c1")
    h = sym.Activation(h, act_type="relu")
    h = sym.Pooling(h, kernel=(2, 2), stride=(2, 2), pool_type="max")
    h = sym.Flatten(h)
    h = sym.FullyConnected(h, num_hidden=64, name="shared")
    h = sym.Activation(h, act_type="tanh")
    outs = []
    for head, k in (("digit", 10), ("parity", 2)):
        if head in heads:
            fc = sym.FullyConnected(h, num_hidden=k, name=head + "_fc")
            outs.append(sym.SoftmaxOutput(fc, sym.Variable(head + "_label"),
                                          name=head))
    return sym.Group(outs) if len(outs) > 1 else outs[0]


def multi_train(mt, np, heads, X, Y1, Y2, a, epochs, ctx, init_seed):
    labels = [(h + "_label", Y) for h, Y in (("digit", Y1), ("parity", Y2))
              if h in heads]
    mod = mt.mod.Module(multi_symbol(mt, heads), context=ctx,
                        label_names=[n for n, _ in labels])
    mod.bind(data_shapes=[("data", (a["batch"], 1, 16, 16))],
             label_shapes=[(n, (a["batch"],)) for n, _ in labels])
    mod.init_params(mt.init.Xavier().set_rng(
        np.random.default_rng(init_seed)))
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": a["lr"], "momentum": 0.9})
    it = mt.io.NDArrayIter({"data": X}, dict(labels), a["batch"],
                           shuffle=True)
    for _ in range(epochs):
        it.reset()
        for batch in it:
            mod.forward_backward(batch)
            mod.update()
    return mod


def multi_eval(mt, np, mod, heads, Xv, Y1v, Y2v, a):
    n = (len(Xv) // a["batch"]) * a["batch"]
    outs = []
    for batch in mt.io.NDArrayIter({"data": Xv[:n]}, None, a["batch"]):
        mod.forward(batch, is_train=False)
        outs.append([o.asnumpy() for o in mod.get_outputs()])
    stacked = [np.concatenate([b[i] for b in outs])
               for i in range(len(outs[0]))]
    truth = [Y for h, Y in (("digit", Y1v), ("parity", Y2v)) if h in heads]
    return {h: float((s.argmax(1) == Y[:n]).mean())
            for h, s, Y in zip([h for h in ("digit", "parity")
                                if h in heads], stacked, truth)}


def multi_example(torch, np, a=None):
    """``examples/multi_task.py`` at its defaults: two heads trained
    jointly, then each alone on half the epochs; gates: both heads > 0.9
    and no loss against the split budget."""
    import mxnet_tpu_torch as mt
    a = a or MULTI
    np.random.seed(a["seed"])
    t0 = time.perf_counter()
    ctx = mt.gpu(0)
    X, Y1, Y2 = multi_data(np, a["examples"], seed=1)
    Xv, Y1v, Y2v = multi_data(np, 400, seed=2)
    both = ("digit", "parity")
    mod = multi_train(mt, np, both, X, Y1, Y2, a, a["epochs"], ctx, 0)
    acc = multi_eval(mt, np, mod, both, Xv, Y1v, Y2v, a)
    half = max(a["epochs"] // 2, 1)
    a1 = multi_eval(mt, np, multi_train(mt, np, ("digit",), X, Y1, Y2, a,
                                        half, ctx, 1),
                    ("digit",), Xv, Y1v, Y2v, a)["digit"]
    a2 = multi_eval(mt, np, multi_train(mt, np, ("parity",), X, Y1, Y2, a,
                                        half, ctx, 2),
                    ("parity",), Xv, Y1v, Y2v, a)["parity"]
    secs = time.perf_counter() - t0
    log("14d multi_task: digit %.4f parity %.4f (gates > %g); single-task "
        "on %d epochs: digit %.4f parity %.4f; %.1f s"
        % (acc["digit"], acc["parity"], a["min_acc"], half, a1, a2, secs))
    check(acc["digit"] > a["min_acc"] and acc["parity"] > a["min_acc"],
          "14d multi_task: %s, the example's gate is > %g a head"
          % (acc, a["min_acc"]))
    check(acc["digit"] + acc["parity"] >= a1 + a2 - 0.02, "14d multi_task: "
          "no transfer benefit at equal budget (%s vs %.4f, %.4f)"
          % (acc, a1, a2))
    return {"acc": acc, "single": (a1, a2), "s": secs}


# ---- examples/lstm_crf.py

def crf_data(np, n, seed=0):
    """``lstm_crf.py``'s ``synth_tagging``: O / B / I tags over tokens."""
    rng = np.random.RandomState(seed)
    X = np.zeros((n, CRF_T), np.float32)
    Y = np.zeros((n, CRF_T), np.int64)
    for i in range(n):
        t = 0
        while t < CRF_T:
            if rng.rand() < 0.3 and t < CRF_T - 2:
                L = rng.randint(2, min(4, CRF_T - t))
                X[i, t] = rng.randint(10, 15)
                Y[i, t] = 1
                for k in range(1, L):
                    X[i, t + k] = rng.randint(15, 20)
                    Y[i, t + k] = 2
                t += L
            else:
                X[i, t] = rng.randint(0, 10)
                t += 1
    return X, Y


def crf_tagger(pkg, hidden, prefix=None):
    """``lstm_crf.py``'s Gluon ``Tagger`` in package ``pkg``: embedding,
    bidirectional LSTM, per-token projection and the CRF's transition
    matrix (``params.get`` after the children)."""
    gluon, nn = pkg.gluon, pkg.gluon.nn

    class Tagger(gluon.Block):
        def __init__(self, **kw):
            super(Tagger, self).__init__(**kw)
            with self.name_scope():
                self.embed = nn.Embedding(CRF_VOCAB, hidden)
                self.lstm = gluon.rnn.LSTM(hidden // 2, num_layers=1,
                                           bidirectional=True, layout="NTC")
                self.proj = nn.Dense(CRF_TAGS, flatten=False)
                self.transitions = self.params.get(
                    "transitions", shape=(CRF_TAGS, CRF_TAGS),
                    init=pkg.init.Zero())

        def emissions(self, x):
            return self.proj(self.lstm(self.embed(x)))

    return Tagger(prefix=prefix)


def crf_nll(pkg, np, emissions, transitions, tags):
    """``lstm_crf.py``'s ``crf_log_likelihood``: the gold path's score
    against the forward algorithm's partition (logsumexp over T)."""
    nd = pkg.nd
    gold = prev = None
    ctx = emissions[0].context
    for t in range(CRF_T):
        tag_t = tags[:, t]
        s = nd.pick(emissions[t], nd.array(tag_t, ctx=ctx), axis=1)
        if prev is not None:
            idx = np.stack([prev, tag_t], axis=0)
            s = s + nd.gather_nd(transitions, nd.array(idx, ctx=ctx))
        gold = s if gold is None else gold + s
        prev = tag_t
    alpha = emissions[0]
    trans = nd.expand_dims(transitions, 0)
    for t in range(1, CRF_T):
        scores = nd.broadcast_add(nd.broadcast_add(
            nd.expand_dims(alpha, 2), trans), nd.expand_dims(emissions[t], 1))
        m = nd.max(scores, axis=1, keepdims=True)
        alpha = nd.squeeze(m, axis=1) + nd.log(
            nd.sum(nd.exp(nd.broadcast_sub(scores, m)), axis=1))
    m = nd.max(alpha, axis=1, keepdims=True)
    log_z = nd.squeeze(m, axis=1) + nd.log(
        nd.sum(nd.exp(nd.broadcast_sub(alpha, m)), axis=1))
    return nd.mean(log_z - gold)


def crf_viterbi(np, emissions, transitions):
    """Max-sum decode; emissions: list of CRF_T (B, K) numpy."""
    B = emissions[0].shape[0]
    score, back = emissions[0], []
    for t in range(1, CRF_T):
        cand = score[:, :, None] + transitions[None] + emissions[t][:, None]
        back.append(cand.argmax(axis=1))
        score = cand.max(axis=1)
    path = [score.argmax(axis=1)]
    for bp in reversed(back):
        path.append(bp[np.arange(B), path[-1]])
    return np.stack(path[::-1], axis=1)


def crf_emission_list(pkg, em):
    return [pkg.nd.squeeze(pkg.nd.slice_axis(em, axis=1, begin=t,
                                             end=t + 1), axis=1)
            for t in range(CRF_T)]


def crf_example(torch, np, a=None, steps=None):
    """``examples/lstm_crf.py`` at its defaults through Gluon on the card
    (``Trainer("adam")``, the CRF loss from ``nd`` ops under
    ``autograd.record()``, Viterbi on the host); gates: tag accuracy >
    0.9 and the transitions forbidding O -> I. ``steps`` cuts the run
    (the gates then do not apply); the losses are returned."""
    import mxnet_tpu_torch as mt
    a = a or CRF
    np.random.seed(a["seed"])
    mt.random.seed(a["seed"])
    t0 = time.perf_counter()
    X, Y = crf_data(np, a["examples"], seed=1)
    Xv, Yv = crf_data(np, 80, seed=2)
    losses = []
    with mt.gpu(0):
        net = crf_tagger(mt, a["hidden"], prefix="tagger_")
        net.initialize(mt.init.Xavier().set_rng(
            mt.random.derive_numpy_rng("lstm_crf")))
        trainer = mt.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": a["lr"]})
        bs = 50
        for _ in range(a["epochs"]):
            for i in range(0, len(X), bs):
                with mt.autograd.record():
                    ems = crf_emission_list(mt, net.emissions(
                        mt.nd.array(X[i:i + bs])))
                    loss = crf_nll(mt, np, ems, net.transitions.data(),
                                   Y[i:i + bs])
                loss.backward()
                trainer.step(1)
                losses.append(float(loss.asnumpy()))
                if steps is not None and len(losses) == steps:
                    return {"losses": losses}
        em = net.emissions(mt.nd.array(Xv)).asnumpy()
        trans = net.transitions.data().asnumpy()
    pred = crf_viterbi(np, [em[:, t] for t in range(CRF_T)], trans)
    acc = float((pred == Yv).mean())
    secs = time.perf_counter() - t0
    log("14d lstm_crf: %d epochs, %d steps, crf-nll %.4f -> %.4f; tag "
        "accuracy %.4f (gate > %g), O->I %.2f vs O->B %.2f; %.1f s"
        % (a["epochs"], len(losses), losses[0], losses[-1], acc,
           a["min_acc"], trans[0, 2], trans[0, 1], secs))
    check(acc > a["min_acc"], "14d lstm_crf: tag accuracy %.4f, the "
          "example's gate is > %g" % (acc, a["min_acc"]))
    check(trans[0, 2] < trans[0, 1], "14d lstm_crf: the transitions did "
          "not learn the tag grammar")
    return {"acc": acc, "losses": losses, "s": secs}


# ---- examples/tree_lstm.py

TREE_AND, TREE_OR, TREE_NOT, TREE_LIT0, TREE_LIT1 = range(5)


def tree_data(np, rng, depth, n):
    """``tree_lstm.py``'s ``gen_heap_trees``: full binary expression
    trees over {AND, OR, NOT, 0, 1} in heap layout, and their values."""
    size, first_leaf = 2 ** (depth + 1) - 1, 2 ** depth - 1
    toks = np.zeros((n, size), np.int64)
    toks[:, first_leaf:] = rng.randint(TREE_LIT0, TREE_LIT1 + 1,
                                       (n, size - first_leaf))
    toks[:, :first_leaf] = rng.randint(TREE_AND, TREE_NOT + 1,
                                       (n, first_leaf))
    vals = np.zeros((n, size), bool)
    vals[:, first_leaf:] = toks[:, first_leaf:] == TREE_LIT1
    for i in range(first_leaf - 1, -1, -1):
        l, r = vals[:, 2 * i + 1], vals[:, 2 * i + 2]
        vals[:, i] = np.where(toks[:, i] == TREE_AND, l & r,
                              np.where(toks[:, i] == TREE_OR, l | r, ~l))
    return toks, vals[:, 0]


def tree_net(pkg, H, prefix=None):
    """``tree_lstm.py``'s ``ChildSumTreeLSTM`` in package ``pkg``: the
    cell recurses over the heap's child indices inside
    ``autograd.record``."""
    gluon, nn, nd = pkg.gluon, pkg.gluon.nn, pkg.nd

    class ChildSumTreeLSTM(gluon.Block):
        def __init__(self, **kw):
            super(ChildSumTreeLSTM, self).__init__(**kw)
            with self.name_scope():
                self.embed = nn.Embedding(5, H)
                self.W_iou = nn.Dense(3 * H, use_bias=True)
                self.U_iou = nn.Dense(3 * H, use_bias=False)
                self.W_f = nn.Dense(H, use_bias=True)
                self.U_f = nn.Dense(H, use_bias=False)
                self.out = nn.Dense(2)

        def node(self, toks, i, size):
            x = nd.reshape(self.embed(nd.slice_axis(toks, axis=1, begin=i,
                                                    end=i + 1)), (0, -1))
            states = [self.node(toks, k, size)
                      for k in (2 * i + 1, 2 * i + 2) if k < size]
            if states:
                h_sum = states[0][0]
                for h, _ in states[1:]:
                    h_sum = h_sum + h
                iou = self.W_iou(x) + self.U_iou(h_sum)
            else:
                iou = self.W_iou(x)
            i_g = nd.sigmoid(nd.slice_axis(iou, axis=1, begin=0, end=H))
            o_g = nd.sigmoid(nd.slice_axis(iou, axis=1, begin=H, end=2 * H))
            u_g = nd.tanh(nd.slice_axis(iou, axis=1, begin=2 * H,
                                        end=3 * H))
            c_new = i_g * u_g
            if states:
                wfx = self.W_f(x)
                for h_k, c_k in states:
                    c_new = c_new + nd.sigmoid(wfx + self.U_f(h_k)) * c_k
            return o_g * nd.tanh(c_new), c_new

        def forward(self, toks, size):
            return self.out(self.node(toks, 0, size)[0])

    return ChildSumTreeLSTM(prefix=prefix)


def tree_example(torch, np, a=None, steps=None):
    """``examples/tree_lstm.py`` at its defaults through Gluon on the card:
    two topology buckets (depths 2 and 3), Adam; gates: accuracy > 0.85
    and 0.05 above the leaf-majority baseline. ``steps`` cuts the run
    (the gates then do not apply); the losses are returned."""
    import mxnet_tpu_torch as mt
    a = a or TREE
    np.random.seed(a["seed"])
    mt.random.seed(a["seed"])
    t0 = time.perf_counter()
    rng = np.random.RandomState(1)
    buckets = {}
    for depth in (2, 3):
        X, Y = tree_data(np, rng, depth, a["trees"] // 2)
        Xv, Yv = tree_data(np, rng, depth, 100)
        buckets[depth] = (X, Y, Xv, Yv)
    losses = []
    with mt.gpu(0):
        net = tree_net(mt, a["hidden"], prefix="tree_")
        net.initialize(mt.init.Xavier().set_rng(
            mt.random.derive_numpy_rng("tree_lstm")))
        net(mt.nd.array(buckets[2][0][:2].astype(np.float32)), 7)
        trainer = mt.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": a["lr"]})
        sce = mt.gluon.loss.SoftmaxCrossEntropyLoss()
        bs = a["batch"]
        for _ in range(a["epochs"]):
            for depth, (X, Y, _, _) in buckets.items():
                size = 2 ** (depth + 1) - 1
                perm = rng.permutation(len(Y))
                for s in range(0, len(Y), bs):
                    idx = perm[s:s + bs]
                    xb = mt.nd.array(X[idx].astype(np.float32))
                    yb = mt.nd.array(Y[idx].astype(np.float32))
                    with mt.autograd.record():
                        loss = mt.nd.mean(sce(net(xb, size), yb))
                    loss.backward()
                    trainer.step(1)
                    losses.append(float(loss.asnumpy().ravel()[0]))
                    if steps is not None and len(losses) == steps:
                        return {"losses": losses}
        accs, bases = [], []
        for depth, (_, _, Xv, Yv) in buckets.items():
            size = 2 ** (depth + 1) - 1
            pred = net(mt.nd.array(Xv.astype(np.float32)),
                       size).asnumpy().argmax(axis=1)
            accs.append(float((pred == Yv).mean()))
            first_leaf = 2 ** depth - 1
            guess = (Xv[:, first_leaf:] == TREE_LIT1).mean(axis=1) >= 0.5
            bases.append(float((guess == Yv).mean()))
    acc, base = float(np.mean(accs)), float(np.mean(bases))
    secs = time.perf_counter() - t0
    log("14d tree_lstm: %d epochs, %d steps, loss %.4f -> %.4f; accuracy "
        "%.3f (gate > %g; per depth %s), leaf-majority baseline %.3f; "
        "%.1f s" % (a["epochs"], len(losses), losses[0], losses[-1], acc,
                    a["min_acc"], ["%.3f" % v for v in accs], base, secs))
    check(acc > a["min_acc"], "14d tree_lstm: accuracy %.3f, the example's "
          "gate is > %g" % (acc, a["min_acc"]))
    check(acc > base + 0.05, "14d tree_lstm: no structural advantage over "
          "the leaf-majority baseline (%.3f vs %.3f)" % (acc, base))
    return {"acc": acc, "losses": losses, "s": secs}


def symbol_phase(torch, np):
    """Phase 14: the Symbol surface on the card (a), the ResNet-50
    fine-tune (b), the LM under group2ctx (c) and the recurrent and
    symbolic examples (d)."""
    check(not torch.backends.cudnn.allow_tf32 and
          not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is allowed: phase 14's checks would not be float32")
    t0 = time.perf_counter()
    readings = {"surface": surface_phase(torch, np),
                "fine_tune": fine_tune_resnet(torch, np),
                "grouped": grouped_lm_phase(torch, np)}
    for name, fn in (("fine_tune_example", fine_tune_example),
                     ("model_parallel_lstm", mp_lstm_example),
                     ("bi_lstm_sort", sort_example),
                     ("multi_task", multi_example),
                     ("lstm_crf", crf_example),
                     ("tree_lstm", tree_example)):
        readings[name] = fn(torch, np)
    log("symbol surface and examples phase: %.1f s"
        % (time.perf_counter() - t0))
    return readings


# ----------------------------------------------- phase 15: compile levers

def peak_memory(torch) -> int:
    """Bytes the caching allocator held at most since the last reset."""
    return torch.cuda.max_memory_allocated()


def initial_weights(torch, np, sym, shapes, initializer):
    """``(arg, aux)`` tensors on the card: ``initializer`` over a module
    bound at ``shapes`` (inference only), its arrays cloned."""
    import mxnet_tpu_torch as mt
    mod = mt.mod.Module(sym, context=mt.gpu(0))
    mod.bind(data_shapes=[("data", shapes[0])],
             label_shapes=[("softmax_label", shapes[1])],
             for_training=False)
    mod.init_params(initializer)
    args, aux = mod.get_params()
    init = ({n: a.data.clone() for n, a in args.items()},
            {n: a.data.clone() for n, a in aux.items()})
    del mod, args, aux
    gc.collect()
    return init


def lever_run(torch, np, sym, init, x, y, opt_params, steps, timed,
              accum=1, remat="off", scan="auto", counters=None,
              want_params=False, profiled=None):
    """One ``Module`` on ``sym`` bound under the compile levers
    (``MXNET_TPU_SCAN_LAYERS`` ``scan``, ``MXNET_TPU_REMAT`` ``remat``,
    ``set_grad_accum(accum)``, as bench.py sets them: bind,
    ``init_params``, ``set_grad_accum``, ``init_optimizer``), its
    weights set to ``init``, SGD ``opt_params``, trained on the batch
    ``x``, ``y`` through ``_fit_step``: ``steps`` steps, then ``timed``
    between CUDA events. The kernel wrappers' ``counters`` are zeroed
    just before the first step and read after the ``steps``-th; peak
    memory is reset before the first step and read there too. Returns
    the readings: losses, the port's counter deltas of the bind and of
    the steps, the ``scan_layers`` gauge, the remat name, step ms and,
    with ``want_params``, the weights after ``steps`` steps (copies on
    the host);
    with ``profiled`` (a name), one more step under torch.profiler: its
    device busy time and wall time."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import config, profiler
    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device(DEVICE)
    config.set("MXNET_TPU_SCAN_LAYERS", scan)
    config.set("MXNET_TPU_REMAT", remat)
    profiler.set_gauge("scan_layers", 0)
    try:
        t0 = time.perf_counter()
        with profiler.counter_delta() as bind_delta:
            mod = mt.mod.Module(sym, context=mt.gpu(0))
            mod.bind(data_shapes=[("data", x.shape)],
                     label_shapes=[("softmax_label", y.shape)])
            mod.init_params(arg_params=init[0], aux_params=init[1])
            mod.set_grad_accum(accum)
            mod.init_optimizer(optimizer="sgd",
                               optimizer_params=opt_params)
        bind_s = time.perf_counter() - t0
        bind_counters = bind_delta.all()
    finally:
        config.reset("MXNET_TPU_SCAN_LAYERS")
        config.reset("MXNET_TPU_REMAT")
    db = mt.io.DataBatch(data=[mt.nd.array(x, ctx=dev)],
                         label=[mt.nd.array(y, ctx=dev)])
    y_col = torch.from_numpy(y).to(dev).long().view(-1, 1)

    def step():
        mod._fit_step(db)
        out = mod.get_outputs()[0].data
        return -(out.gather(1, y_col) + 1e-12).log().mean()

    for fn in (counters or {}).values():
        fn.launches = {"f32": 0, "bf16": 0}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profiler.counter_delta() as step_delta:
        losses = [step() for _ in range(steps)]
        torch.cuda.synchronize()
        step_counters = step_delta.all()
    peak = peak_memory(torch)
    launches = {n: dict(fn.launches) for n, fn in (counters or {}).items()}
    # on the host: a copy on the card would count in the next run's peak
    params = {n: a.data.detach().to("cpu", copy=True)
              for n, a in mod.get_params()[0].items()} \
        if want_params else None
    step_ms = None
    if timed:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(timed):
            losses.append(step())
        end.record()
        torch.cuda.synchronize()
        step_ms = start.elapsed_time(end) / timed
    busy_ms = wall_ms = None
    if profiled:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            losses.append(step())
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy_ms = device_breakdown(torch, prof, wall_ms / 1e3, profiled)[1]
    losses = [float(v) for v in torch.stack(losses).cpu()]
    run = {"losses": losses, "step_ms": step_ms, "peak": peak,
           "busy_ms": busy_ms, "wall_ms": wall_ms,
           "bind_s": bind_s, "launches": launches, "params": params,
           "remat_name": mod._remat_name,
           "scan_layers": profiler.get_gauge("scan_layers"),
           "bind_counters": bind_counters, "step_counters": step_counters}
    del mod, db
    gc.collect()
    torch.cuda.empty_cache()
    return run


def param_gap(torch, got, want, start):
    """The largest |got - want| over every weight (host copies), and the
    largest change ``want`` made from ``start``."""
    gap = max(float((got[n].float() - want[n].float()).abs().max())
              for n in want)
    moved = max(float((want[n].float() - start[n].float().cpu()).abs().max())
                for n in want)
    return gap, moved


def check_levers(what, run, policy, accum, steps):
    """The levers engaged: ``policy`` resolved (one ``remat_applied``
    count at bind) and ``accum`` microbatches a step."""
    applied = run["bind_counters"].get("remat_applied", 0)
    accum_steps = run["step_counters"].get("accum_steps", 0)
    log("%s: remat %s (remat_applied %d at bind), accum_steps %d over %d "
        "steps, scan_layers %s" % (what, run["remat_name"], applied,
                                   accum_steps, steps, run["scan_layers"]))
    check(run["remat_name"] == policy, "%s: MXNET_TPU_REMAT resolved to %r, "
          "the reference picks %r" % (what, run["remat_name"], policy))
    check(applied == (policy != "off"), "%s: remat_applied %d at bind"
          % (what, applied))
    expected = steps * accum if accum > 1 else 0
    check(accum_steps == expected, "%s: accum_steps %d over %d steps of "
          "grad_accum %d" % (what, accum_steps, steps, accum))
    losses = run["losses"]
    check(all(math.isfinite(v) for v in losses), "%s: non-finite loss %s"
          % (what, losses))


def levers_resnet(torch, np):
    """Phase 15a: bench.py's ``resnet_remat_accum`` at its own
    configuration: ResNet-50 v2, s2d stem, batch 256, amp bf16,
    Xavier(gaussian, in, 2) from the seed, SGD 0.05 / 0.9 / 1e-4,
    ``MXNET_TPU_REMAT=auto`` and ``set_grad_accum(2)``, through
    ``Module._fit_step``; beside it the same batch with grad_accum 2
    alone and plain, and the plain batch-128 step."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.models import resnet
    B, S = LEVERS_RESNET_BATCH, RESNET_IMAGE
    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    sym = resnet.get_symbol(num_classes=RESNET_CLASSES,
                            num_layers=RESNET_LAYERS, stem="s2d",
                            image_shape="3,%d,%d" % (S, S))
    init = initial_weights(torch, np, sym, ((B, 3, S, S), (B,)),
                           mt.init.Xavier(rnd_type="gaussian",
                                          factor_type="in", magnitude=2)
                           .set_rng(np.random.default_rng(SEED)))
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (B, 3, S, S)).astype(np.float32)
    y = rng.randint(0, RESNET_CLASSES, (B,)).astype(np.float32)
    # the plain forward of the accumulated step: each microbatch's
    # BatchNorms normalise with that microbatch's statistics
    with torch.no_grad():
        want = sum(plain_resnet(torch, init[0], torch.from_numpy(xm).to(dev),
                                torch.from_numpy(ym).to(dev))[0].item()
                   for xm, ym in zip(np.split(x, LEVERS_ACCUM),
                                     np.split(y, LEVERS_ACCUM))) / LEVERS_ACCUM
    torch.cuda.empty_cache()
    opt = {"learning_rate": RESNET_LR, "momentum": RESNET_MOMENTUM,
           "wd": RESNET_WD}
    half = RESNET_BATCH
    mt.amp.init("bfloat16")
    try:
        levers = lever_run(torch, np, sym, init, x, y, opt, LEVERS_STEPS,
                           LEVERS_TIMED, accum=LEVERS_ACCUM, remat="auto",
                           want_params=True)
        accum = lever_run(torch, np, sym, init, x, y, opt, LEVERS_STEPS,
                          LEVERS_TIMED, accum=LEVERS_ACCUM, want_params=True)
        plain = lever_run(torch, np, sym, init, x, y, opt, 1, 0)
        small = lever_run(torch, np, sym, init, x[:half], y[:half], opt, 2,
                          LEVERS_TIMED)
    finally:
        mt.amp.off()
    check_levers("15a resnet_remat_accum", levers, LEVERS_RESNET_POLICY,
                 LEVERS_ACCUM, LEVERS_STEPS)
    check_levers("15a grad_accum only", accum, "off", LEVERS_ACCUM,
                 LEVERS_STEPS)
    gap, moved = param_gap(torch, levers["params"], accum["params"], init[0])
    losses = levers["losses"]
    img_s = B / (levers["step_ms"] / 1e3)
    img_s_small = half / (small["step_ms"] / 1e3)
    log("15a resnet_remat_accum: ResNet-%d v2 s2d, batch %d (%d microbatches"
        " of %d), %dx%d, amp bf16: bind %.3f s; step %.3f ms (%d between "
        "CUDA events) = %.1f img/s, MFU %.4f of %.0f TFLOP/s bf16 (%.3f GFLOP"
        " an image by bench.py's accounting); grad_accum %d alone %.3f ms; "
        "beside them the plain batch-%d step %.3f ms = %.1f img/s, MFU %.4f"
        % (RESNET_LAYERS, B, LEVERS_ACCUM, B // LEVERS_ACCUM, S, S,
           levers["bind_s"], levers["step_ms"], LEVERS_TIMED, img_s,
           img_s * RESNET_FLOPS_PER_IMG / PEAK_BF16_FLOPS,
           PEAK_BF16_FLOPS / 1e12, RESNET_FLOPS_PER_IMG / 1e9, LEVERS_ACCUM,
           accum["step_ms"], half, small["step_ms"], img_s_small,
           img_s_small * RESNET_FLOPS_PER_IMG / PEAK_BF16_FLOPS))
    log("15a peak memory: batch %d plain %.3f GB, grad_accum %d %.3f GB, "
        "grad_accum %d + remat %.3f GB; plain batch %d %.3f GB"
        % (B, plain["peak"] / 1e9, LEVERS_ACCUM, accum["peak"] / 1e9,
           LEVERS_ACCUM, levers["peak"] / 1e9, half, small["peak"] / 1e9))
    log("15a loss per step %s; step-1 cross-entropy %.6f, plain f32 forward "
        "(7x7 stem, per microbatch) %.6f (|diff| %.3g, tolerance %g); "
        "weights after %d steps"
        " with remat on and off %.3g apart, %.3g of the largest change %.3g "
        "(limit %g)" % (" ".join("%.6f" % v for v in losses), losses[0],
                        want, abs(losses[0] - want), RESNET_CE_TOL,
                        LEVERS_STEPS, gap, gap / max(moved, 1e-30), moved,
                        LEVERS_PARAM_RTOL))
    check(abs(losses[0] - want) <= RESNET_CE_TOL, "15a: step-1 loss %g vs "
          "plain forward %g" % (losses[0], want))
    check(losses[-1] < losses[0], "15a: loss did not fall: %s" % losses)
    check(gap <= LEVERS_PARAM_RTOL * moved, "15a: weights after %d steps "
          "with remat on and off %.3g apart, more than %g of their largest "
          "change %.3g" % (LEVERS_STEPS, gap, LEVERS_PARAM_RTOL, moved))
    return {"step_ms": levers["step_ms"], "img_s": img_s,
            "accum_step_ms": accum["step_ms"],
            "peak_gb": {"plain": plain["peak"] / 1e9,
                        "accum": accum["peak"] / 1e9,
                        "accum_remat": levers["peak"] / 1e9,
                        "plain_%d" % half: small["peak"] / 1e9},
            "small_step_ms": small["step_ms"]}


def levers_lm(torch, np, kernels, sgd):
    """Phase 15b: the LM at bench.py's width (12 x 2048, 16 heads, T
    1024, V 32000, B 8, flash attention, amp bf16, SGD lr 0.01). With
    ``MXNET_TPU_SCAN_LAYERS=auto`` the plan holds 12 layers and its step
    is bit for bit the unrolled one; then ``MXNET_TPU_REMAT=auto`` (per
    block) with grad_accum 2 against grad_accum 2 alone: the attention
    kernels' launches, the weights after 3 steps, and the drop in peak
    memory against the calibrated ``est_peak_saving``."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.analysis import analyze_symbol
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.ops import flash_attention as fa
    counters = {"flash_attention_fwd_bf16": fa.flash_attention_fwd,
                "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
                "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv}
    B, T = TRAIN_BATCH, MAX_SEQ
    sym = transformer.get_symbol(VOCAB, LAYERS, D_MODEL, HEADS, D_FF, T,
                                 attention="flash")
    init = ({n: t.to(DEVICE) for n, t in lm_xavier(torch, np).items()}, {})
    rng = np.random.RandomState(0)
    x = rng.randint(0, VOCAB, (B, T)).astype(np.float32)
    y = rng.randint(0, VOCAB, (B, T)).astype(np.float32)
    opt = {"learning_rate": TRAIN_LR}
    micro = B // LEVERS_ACCUM
    mt.amp.init("bfloat16")
    try:
        unrolled = lever_run(torch, np, sym, init, x, y, opt, 1, 0,
                             scan="off", want_params=True)
        planned = lever_run(torch, np, sym, init, x, y, opt, 1, 0,
                            want_params=True)
        same = [n for n in planned["params"] if not torch.equal(
            planned["params"][n], unrolled["params"][n])]
        unrolled["params"] = planned["params"] = None
        report = analyze_symbol(
            sym, input_shapes={"data": (micro, T),
                               "softmax_label": (micro, T)},
            calibrate_remat=True, device=torch.device(DEVICE))
        suggestion = report.extras["remat"]["suggestion"]
        remat = lever_run(torch, np, sym, init, x, y, opt, LEVERS_STEPS,
                          LEVERS_TIMED, accum=LEVERS_ACCUM, remat="auto",
                          counters=counters, want_params=True,
                          profiled="15b remat + grad_accum step")
        accum = lever_run(torch, np, sym, init, x, y, opt, LEVERS_STEPS,
                          LEVERS_TIMED, accum=LEVERS_ACCUM,
                          counters=counters, want_params=True)
        # per block with no selective policy (no dispatch mode)
        nothing = lever_run(torch, np, sym, init, x, y, opt, 1, LEVERS_TIMED,
                            accum=LEVERS_ACCUM, remat="nothing_saveable",
                            profiled="15b nothing_saveable step")
    finally:
        mt.amp.off()
    log("15b scan plan: scan_layers %s (unrolled bind: %s); step 1 of the "
        "plan and of the unrolled graph: loss %.9f / %.9f, %d of %d weights "
        "differ" % (planned["scan_layers"], unrolled["scan_layers"],
                    planned["losses"][0], unrolled["losses"][0], len(same),
                    len(init[0])))
    check(planned["scan_layers"] == LAYERS and
          planned["bind_counters"].get("scan_applied") == 1,
          "15b: scan_layers %s, scan_applied %s (the plan should hold %d "
          "layers)" % (planned["scan_layers"],
                       planned["bind_counters"].get("scan_applied"), LAYERS))
    check(not unrolled["bind_counters"].get("scan_applied"),
          "15b: MXNET_TPU_SCAN_LAYERS=off bound a plan")
    check(not same and planned["losses"] == unrolled["losses"],
          "15b: the plan's step is not the unrolled one bit for bit: %s"
          % same[:5])
    check_levers("15b remat + grad_accum", remat, LEVERS_LM_POLICY,
                 LEVERS_ACCUM, LEVERS_STEPS)
    check_levers("15b grad_accum only", accum, "off", LEVERS_ACCUM,
                 LEVERS_STEPS)
    per_step = LEVERS_STEPS * LEVERS_ACCUM * LAYERS
    for run, fwd in ((remat, 2 * per_step), (accum, per_step)):
        want = {"flash_attention_fwd_bf16": fwd,
                "flash_attention_bwd_dq": per_step,
                "flash_attention_bwd_dkv": per_step}
        got = {n: v["bf16"] for n, v in run["launches"].items()}
        f32 = sum(v["f32"] for v in run["launches"].values())
        log("15b %s: launches %s over %d steps x %d microbatches x %d "
            "layers" % ("remat" if run is remat else "no remat", got,
                        LEVERS_STEPS, LEVERS_ACCUM, LAYERS))
        check(got == want and not f32, "15b: launches %s, the path implies "
              "%s (bf16 only)" % (run["launches"], want))
    for name in counters:
        kernels[name]["remat_accum_launches"] = \
            remat["launches"][name]["bf16"]
    gap, moved = param_gap(torch, remat["params"], accum["params"], init[0])
    est = suggestion.get("est_peak_saving")
    drop = accum["peak"] - remat["peak"]
    log("15b remat + grad_accum %d: policy %s; step %.3f ms, grad_accum "
        "alone %.3f ms, phase 6's _fit_step (batch %d, no levers) %.3f ms; "
        "peak memory %.3f GB against %.3f GB: a drop of %.3f GB, the "
        "calibrated est_peak_saving at the microbatch (%d x %d) %.3f GB "
        "(%.1f%% off, limit %.0f%%); weights after %d steps %.3g apart, %.3g"
        " of the largest change %.3g (limit %g); loss per step %s"
        % (LEVERS_ACCUM, remat["remat_name"], remat["step_ms"],
           accum["step_ms"], B, sgd["step_ms"], remat["peak"] / 1e9,
           accum["peak"] / 1e9, drop / 1e9, micro, T,
           (est or 0) / 1e9, 100 * abs(drop - (est or 0)) / max(est or 1, 1),
           100 * LEVERS_SAVING_RTOL, LEVERS_STEPS, gap,
           gap / max(moved, 1e-30), moved, LEVERS_PARAM_RTOL,
           " ".join("%.6f" % v for v in remat["losses"])))
    log("15b per block under nothing_saveable (a plain checkpoint, no "
        "selective policy), grad_accum %d: step %.3f ms, peak %.3f GB; device"
        " busy in a profiled step: %.3f of %.3f ms (%s), %.3f of %.3f ms "
        "(nothing_saveable)" % (LEVERS_ACCUM, nothing["step_ms"],
                                nothing["peak"] / 1e9, remat["busy_ms"],
                                remat["wall_ms"], LEVERS_LM_POLICY,
                                nothing["busy_ms"], nothing["wall_ms"]))
    check(suggestion.get("policy") == LEVERS_LM_POLICY.split(":", 1)[1],
          "15b: the calibration's suggestion %r" % suggestion.get("policy"))
    check(est is not None and est > 0, "15b: no calibrated est_peak_saving")
    check(abs(drop - est) <= LEVERS_SAVING_RTOL * est,
          "15b: peak memory dropped %d bytes, the calibrated estimate is %d"
          % (drop, est))
    check(remat["losses"][-1] < remat["losses"][0],
          "15b: loss did not fall: %s" % remat["losses"])
    check(gap <= LEVERS_PARAM_RTOL * moved, "15b: weights after %d steps "
          "with remat on and off %.3g apart, more than %g of their largest "
          "change %.3g" % (LEVERS_STEPS, gap, LEVERS_PARAM_RTOL, moved))
    return {"step_ms": remat["step_ms"], "accum_step_ms": accum["step_ms"],
            "peak_gb": remat["peak"] / 1e9,
            "accum_peak_gb": accum["peak"] / 1e9,
            "nothing_step_ms": nothing["step_ms"],
            "est_peak_saving_gb": est / 1e9}


def levers_phase(torch, np, kernels, sgd):
    """Phase 15: the compile levers of queue A7 (15a ResNet, 15b LM)."""
    t0 = time.perf_counter()
    readings = {"resnet": levers_resnet(torch, np),
                "lm": levers_lm(torch, np, kernels, sgd)}
    log("compile levers phase: %.1f s" % (time.perf_counter() - t0))
    return readings


# ------------------------------------------------- the data plane (phase 16)

def host_probe(scratch):
    """What this host offers the data plane, read and logged before the
    fixed route runs: cv2 and PIL, whether the native library builds and
    loads (it needs libjpeg and libpng; built afresh in ``scratch``), the
    jpeg / png libraries ldconfig knows, and the cores."""
    import ctypes
    import os
    from mxnet_tpu_torch import native
    from mxnet_tpu_torch.base import MXNetError
    found = {}
    for name in ("cv2", "PIL"):
        try:
            found[name] = __import__(name).__version__
        except ImportError:
            found[name] = None
    try:
        ctypes.CDLL(str(native.build(out_dir=scratch)))
        found["native"] = "builds and loads"
    except OSError as exc:
        found["native"] = "builds, does not load: %s" % exc
    except MXNetError as exc:
        errs = [ln.strip() for ln in str(exc).splitlines()
                if "error" in ln.lower()]
        found["native"] = "does not build: %s" % (errs[0] if errs else
                                                  str(exc).splitlines()[0])
    try:
        ld = subprocess.run(["ldconfig", "-p"], capture_output=True,
                            text=True, timeout=60).stdout
        found["ldconfig"] = sorted({ln.split()[0] for ln in ld.splitlines()
                                    if "=>" in ln and ("jpeg" in ln or
                                                       "png" in ln)})
    except OSError as exc:
        found["ldconfig"] = "not run: %s" % exc
    found["nproc"] = os.cpu_count()
    log("16 host probe: %s" % json.dumps(found))
    log("16 route (fixed in chip_smoke.py, not chosen at run time): records "
        "encoded by %s through recordio.pack_img (JPEG quality %d), decoded "
        "by %s (MXNET_USE_NATIVE_IO=%d)"
        % (DATA_ENCODER, DATA_QUALITY, DATA_DECODER,
           DATA_DECODER == "native"))
    for name in {DATA_ENCODER, DATA_DECODER} - {"native"}:
        check(found.get(name) is not None, "16: the route's %s does not "
              "import on this host" % name)
    return found


def data_shape():
    return (3, RESNET_IMAGE, RESNET_IMAGE)


def data_image(np, cv2, label, h, w, seed):
    """One seeded BGR image of class ``label``: smooth low-frequency
    colour (a 4x5 grid of HSV cells, cubic-upsampled) whose hue lies in
    the label's bucket, plus mild noise, so the JPEG sizes look like a
    photo's and the label is a function of the content."""
    r = np.random.RandomState(seed)
    width = 180.0 / DATA_CLASSES
    hue = (label + r.uniform(0.3, 0.7) +
           r.uniform(-0.2, 0.2, (4, 5))) * width
    hsv = np.stack([hue, r.uniform(120, 255, (4, 5)),
                    r.uniform(90, 255, (4, 5))], -1).astype(np.uint8)
    bgr = cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)
    img = cv2.resize(bgr, (w, h), interpolation=cv2.INTER_CUBIC)
    img = img.astype(np.float32) + r.normal(0.0, DATA_NOISE, img.shape)
    return np.clip(img + 0.5, 0, 255).astype(np.uint8)


def records_phase(np, out):
    """16a: DATA_RECORDS seeded images (shorter side DATA_SHORT, longer
    DATA_LONG) packed into an indexed .rec / .idx, then read back byte for
    byte; and an index of the first DATA_RESUME_BATCHES x
    DATA_RESUME_BATCH records for 16d."""
    import hashlib
    import os
    from concurrent.futures import ThreadPoolExecutor
    import cv2
    from mxnet_tpu_torch import recordio
    path, idx = str(out / "train.rec"), str(out / "train.idx")
    rng = np.random.RandomState(SEED)
    specs = []
    for i in range(DATA_RECORDS):
        long_side = int(rng.randint(DATA_LONG[0], DATA_LONG[1] + 1))
        hw = (long_side, DATA_SHORT) if rng.rand() < 0.5 else \
            (DATA_SHORT, long_side)
        specs.append((int(rng.randint(DATA_CLASSES)),) + hw +
                     (int(rng.randint(2 ** 31)),))

    def pack(i):
        label, h, w, seed = specs[i]
        img = data_image(np, cv2, label, h, w, seed)
        return recordio.pack_img(recordio.IRHeader(0, float(label), i, 0),
                                 img, quality=DATA_QUALITY, img_fmt=".jpg")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(min(os.cpu_count() or 1,
                                DATA_MAX_THREADS)) as pool:
        packed = list(pool.map(pack, range(DATA_RECORDS)))
    rec = recordio.MXIndexedRecordIO(idx, path, "w")
    for i, buf in enumerate(packed):
        rec.write_idx(i, buf)
    rec.close()
    write_s = time.perf_counter() - t0
    digests = [hashlib.sha256(b).digest() for b in packed]
    sizes = np.array([len(b) for b in packed])
    del packed
    t0 = time.perf_counter()
    back = recordio.MXIndexedRecordIO(idx, path, "r")
    check(back.keys == list(range(DATA_RECORDS)), "16a: the index holds %d "
          "keys, %d were written" % (len(back.keys), DATA_RECORDS))
    bad = [k for k in back.keys
           if hashlib.sha256(back.read_idx(k)).digest() != digests[k]]
    back.close()
    read_s = time.perf_counter() - t0
    labels = np.array([s[0] for s in specs])
    log("16a records: %d JPEG records (quality %d, shorter side %d, longer "
        "%d-%d) in %.3f s, %.1f MB; a record %.1f KB mean (%.1f-%.1f); "
        "labels by hue bucket %s; read back byte for byte in %.3f s, %d "
        "differ" % (DATA_RECORDS, DATA_QUALITY, DATA_SHORT, DATA_LONG[0],
                    DATA_LONG[1], write_s, sizes.sum() / 1e6,
                    sizes.mean() / 1e3, sizes.min() / 1e3,
                    sizes.max() / 1e3,
                    np.bincount(labels, minlength=DATA_CLASSES).tolist(),
                    read_s, len(bad)))
    check(not bad, "16a: records %s do not read back as written" % bad[:5])
    n_resume = DATA_RESUME_BATCHES * DATA_RESUME_BATCH
    resume_idx = str(out / "resume.idx")
    with open(idx) as fin, open(resume_idx, "w") as fout:
        fout.writelines(fin.readlines()[:n_resume])
    return {"rec": path, "idx": idx, "resume_idx": resume_idx,
            "kb": float(sizes.mean() / 1e3)}


def record_iter(mt, path, threads, **kw):
    """ImageRecordIter at examples/common/data.py's training settings."""
    args = dict(path_imgrec=path, data_shape=data_shape(),
                batch_size=DATA_BATCH, shuffle=True, rand_crop=True,
                rand_mirror=True, mean_r=DATA_MEAN[0], mean_g=DATA_MEAN[1],
                mean_b=DATA_MEAN[2], preprocess_threads=threads, seed=SEED)
    args.update(kw)
    return mt.io.ImageRecordIter(**args)


def pipeline_rate(mt, path, threads, batches):
    """The iterator alone: seconds to its first batch, and img/s over
    ``batches`` from its construction (its prefetch buffer fills ahead
    of the consumer, so a rate after the first batch would count buffered
    batches as free)."""
    t0 = time.perf_counter()
    it = record_iter(mt, path, threads)
    check(it._native is None if DATA_DECODER == "cv2" else
          it._native is not None, "16b: ImageRecordIter is not on the %s "
          "route" % DATA_DECODER)
    next(it)
    t1 = time.perf_counter()
    for _ in range(batches - 1):
        next(it)
    t2 = time.perf_counter()
    check(it.close(), "16b: ImageRecordIter's threads did not stop")
    return {"first_s": t1 - t0, "img_s": batches * DATA_BATCH / (t2 - t0)}


def oracle_batch(np, path, n):
    """The first ``n`` images of the iterator's first epoch in plain numpy
    from the same records: cv2 decode, the crop corner and mirror coin
    drawn from RandomState(SEED) after the epoch's shuffle (record by
    record, the reference's order), BGR -> RGB, minus the mean."""
    import cv2
    from mxnet_tpu_torch import recordio
    rec = recordio.MXRecordIO(path, "r")
    bufs = []
    while True:
        buf = rec.read()
        if buf is None:
            break
        bufs.append(buf)
    rec.close()
    rng = np.random.RandomState(SEED)
    order = np.arange(len(bufs))
    rng.shuffle(order)
    _, th, tw = data_shape()
    data, labels = [], []
    for i in order[:n]:
        header, payload = recordio.unpack(bufs[i])
        img = cv2.imdecode(np.frombuffer(payload, np.uint8),
                           cv2.IMREAD_COLOR)
        h, w = img.shape[:2]
        y = rng.randint(0, h - th + 1)
        x = rng.randint(0, w - tw + 1)
        img = img[y:y + th, x:x + tw]
        if rng.rand() < 0.5:
            img = img[:, ::-1]
        img = img[:, :, ::-1].astype(np.float32) - \
            np.asarray(DATA_MEAN, np.float32)
        data.append(img.transpose(2, 0, 1))
        labels.append(header.label)
    return np.stack(data), np.asarray(labels, np.float32)


def loader_run(mt, rec, workers, batches):
    """``data.DataLoader`` + ``ImageTransform`` over the records: img/s
    over ``batches`` from its construction, and its first
    DATA_LOADER_SAME batches."""
    from mxnet_tpu_torch.data import DataLoader, ImageTransform
    t0 = time.perf_counter()
    dl = DataLoader(rec["rec"], idx_path=rec["idx"], batch_size=DATA_BATCH,
                    transform=ImageTransform(data_shape(),
                                             mean=sum(DATA_MEAN) / 3),
                    shuffle=True, seed=SEED, num_workers=workers,
                    part=(0, 1))
    kept = []
    for k in range(batches):
        b = next(dl)
        if k == 0:
            t1 = time.perf_counter()
        if k < DATA_LOADER_SAME:
            kept.append((b.data[0].copy(), b.label[0].copy()))
    t2 = time.perf_counter()
    dl.close()
    return {"first_s": t1 - t0, "img_s": batches * DATA_BATCH / (t2 - t0),
            "kept": kept}


def _queue_producer(q, shape, n):
    import numpy as np
    batch = np.ones(shape, np.float32)
    for i in range(n):
        q.put(("data", i, batch, None))


def queue_transfer_s(n):
    """Seconds one decoded batch (DATA_BATCH x data_shape() float32)
    takes through the DataLoader's transport, a multiprocessing queue fed
    by a forked process, over ``n`` batches after the first."""
    import multiprocessing as mp
    ctx = mp.get_context("fork")
    q = ctx.Queue(4)
    proc = ctx.Process(target=_queue_producer, daemon=True,
                       args=(q, (DATA_BATCH,) + data_shape(), n + 1))
    proc.start()
    try:
        q.get(timeout=300)
        t0 = time.perf_counter()
        for _ in range(n):
            q.get(timeout=300)
        return (time.perf_counter() - t0) / n
    finally:
        proc.join(timeout=10)
        if proc.is_alive():
            proc.kill()


def pipeline_phase(torch, np, mt, rec):
    """16b: the input pipeline alone, no training: ImageRecordIter with
    the example's DATA_THREADS and with min(nproc, 32) threads; its first
    batch against the numpy oracle; DataLoader + ImageTransform with each
    of DATA_WORKERS workers, forked while a PrefetchingIter's thread
    copies batches to the card, its first batches bit-identical across
    worker counts."""
    import os
    rates = {}
    for threads in sorted({DATA_THREADS,
                           min(os.cpu_count() or 1, DATA_MAX_THREADS)}):
        rates[threads] = pipeline_rate(mt, rec["rec"], threads,
                                       DATA_PIPE_BATCHES)
        log("16b ImageRecordIter (%s route), %d threads, batch %d, %s: "
            "first batch after %.3f s, %.1f img/s over %d batches"
            % (DATA_DECODER, threads, DATA_BATCH, "x".join(
                map(str, data_shape())), rates[threads]["first_s"],
               rates[threads]["img_s"], DATA_PIPE_BATCHES))
    it = record_iter(mt, rec["rec"], DATA_THREADS)
    first = next(it)
    it.close()
    want_x, want_y = oracle_batch(np, rec["rec"], DATA_BATCH)
    got_x = first.data[0].asnumpy()
    err = float(np.abs(got_x - want_x).max())
    log("16b first batch against the numpy oracle (cv2 decode, the seeded "
        "crop and mirror, the mean): max |diff| %.3g (limit %g), labels %s"
        % (err, DATA_ORACLE_ATOL, "equal" if np.array_equal(
            first.label[0].asnumpy(), want_y) else "DIFFER"))
    check(err <= DATA_ORACLE_ATOL and
          np.array_equal(first.label[0].asnumpy(), want_y),
          "16b: the first batch is not the oracle's (max |diff| %g)" % err)
    dev = torch.device(DEVICE)

    def to_card(batch):
        batch._mx_placed = {"data": batch.data[0].data.to(
            dev, non_blocking=True)}
        return batch

    # the loader forks its workers while this thread copies to the card
    busy = mt.io.PrefetchingIter(record_iter(mt, rec["rec"], DATA_THREADS),
                                 device_placer=to_card, device_prefetch=2)
    next(busy)
    runs = {}
    try:
        for workers in (0,) + tuple(DATA_WORKERS):
            runs[workers] = loader_run(mt, rec, workers,
                                       DATA_LOADER_BATCHES)
            log("16b DataLoader + ImageTransform (%s), %d worker processes "
                "(0: inline; fork, a PrefetchingIter thread copying to the "
                "card): "
                "first batch after %.3f s, %.1f img/s over %d batches"
                % (DATA_DECODER, workers, runs[workers]["first_s"],
                   runs[workers]["img_s"], DATA_LOADER_BATCHES))
    finally:
        check(busy.close(), "16b: the PrefetchingIter's thread did not stop")
        busy.iters[0].close()
    per_batch = queue_transfer_s(DATA_LOADER_SAME)
    mb = DATA_BATCH * 4 * math.prod(data_shape()) / 1e6
    log("16b the loader's transport alone: a %.1f MB batch through a "
        "multiprocessing queue from a forked process in %.3f s (%.1f MB/s),"
        " at most %.1f img/s whatever the worker count"
        % (mb, per_batch, mb / per_batch, DATA_BATCH / per_batch))
    base = runs[DATA_WORKERS[0]]["kept"]
    for workers in (0,) + tuple(DATA_WORKERS[1:]):
        same = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                   for a, b in zip(base, runs[workers]["kept"]))
        log("16b DataLoader's first %d batches, %d workers against %d: %s"
            % (DATA_LOADER_SAME, workers, DATA_WORKERS[0],
               "bit-identical" if same else "DIFFER"))
        check(same, "16b: DataLoader batches differ between %d and %d "
              "workers" % (DATA_WORKERS[0], workers))
    return {"iter": rates, "loader": {w: r["img_s"] for w, r in
                                      runs.items()},
            "queue_s": per_batch}


def imagenet_module(mt):
    """train_imagenet's ResNet (7x7 stem), unbound: ``fit`` binds it."""
    from mxnet_tpu_torch.models import resnet
    sym = resnet.get_symbol(num_classes=RESNET_CLASSES,
                            num_layers=RESNET_LAYERS, stem="7x7",
                            image_shape="%d,%d,%d" % data_shape())
    return mt.mod.Module(sym, context=mt.gpu(0))


def imagenet_init(mt, np):
    """train_imagenet's initializer, Xavier(gaussian, in, 2), drawing
    from the seed: every run starts from the same weights."""
    return mt.init.Xavier(rnd_type="gaussian", factor_type="in",
                          magnitude=2).set_rng(np.random.default_rng(SEED))


def imagenet_opt():
    return {"learning_rate": IMAGENET_LR, "momentum": IMAGENET_MOM,
            "wd": IMAGENET_WD}


LOOP_COUNTERS = ("loop_host_sync", "loop_metric_sync", "loop_prefetch_stall",
                 "loop_prefetch_placed", "loop_window_wait",
                 "loop_window_drain", "loop_nonfinite")


class ResidentIter:
    """The same device-resident batch ``n`` times: fit's loop without the
    data plane."""

    def __init__(self, mt, x, y, n):
        self.batch = mt.io.DataBatch(data=[x], label=[y], pad=0)
        self.provide_data = [mt.io.DataDesc("data", tuple(x.shape))]
        self.provide_label = [mt.io.DataDesc("softmax_label",
                                             tuple(y.shape))]
        self.batch_size = x.shape[0]
        self.n, self.i = n, 0

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def next(self):
        if self.i >= self.n:
            raise StopIteration
        self.i += 1
        return self.batch

    def reset(self):
        self.i = 0


def imagenet_fit(torch, np, mt, make_iter, what, profile_step=None):
    """One epoch of ``Module.fit`` at train_imagenet's settings (the async
    window and device prefetch at their defaults) from ``make_iter()``:
    per batch a CUDA event at its end, and its outputs, label and
    cross-entropy kept on the device; one step optionally profiled."""
    from mxnet_tpu_torch import profiler
    from torch.profiler import ProfilerActivity, profile
    mod = imagenet_module(mt)
    it = make_iter()
    events, ces, outs, prof = [], [], [], {}

    def on_batch(param):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        out = mod.get_outputs()[0].data
        lab = mod._exec.arg_dict["softmax_label"].data
        ces.append(-(out.float().gather(1, lab.long().view(-1, 1)) +
                     1e-12).log().mean())
        outs.append((out.detach().clone(), lab.clone()))
        if profile_step is None:
            return
        if param.nbatch == profile_step - 1:
            torch.cuda.synchronize()
            prof["p"] = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            prof["p"].__enter__()
            prof["t0"] = time.perf_counter()
        elif param.nbatch == profile_step:
            torch.cuda.synchronize()
            prof["wall"] = time.perf_counter() - prof["t0"]
            prof["p"].__exit__(None, None, None)

    metric = mt.metric.Accuracy()
    before = {c: profiler.get_counter(c) for c in LOOP_COUNTERS}
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=1, eval_metric=metric, optimizer="sgd",
            optimizer_params=imagenet_opt(), batch_end_callback=on_batch,
            initializer=imagenet_init(mt, np))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counters = {c: profiler.get_counter(c) - before[c] for c in
                LOOP_COUNTERS}
    if hasattr(it, "close"):
        it.close()
    steps = len(events)
    end = profile_step - 1 if profile_step is not None else steps - 1
    step_ms = events[IMAGENET_WARM].elapsed_time(events[end]) / \
        (end - IMAGENET_WARM)
    busy_ms = None
    if "p" in prof:
        _, busy_ms = device_breakdown(torch, prof["p"], prof["wall"], what)
    hits = sum(int((o.float().cpu().argmax(1) == lab.cpu().long()).sum())
               for o, lab in outs)
    losses = [float(v) for v in torch.stack(ces).cpu()]
    result = {"steps": steps, "step_ms": step_ms, "wall_s": wall,
              "img_s": DATA_BATCH / (step_ms / 1e3), "counters": counters,
              "losses": losses, "metric": (metric.sum_metric,
                                           metric.num_inst),
              "hits": hits, "busy_ms": busy_ms,
              "prof_wall_ms": prof.get("wall", 0.0) * 1e3}
    del mod, outs
    gc.collect()
    torch.cuda.empty_cache()
    return result


def imagenet_params(torch, np, mt, make_iter):
    """The parameters after one fit epoch of ``make_iter()`` from the
    seeded weights, on the host."""
    mod = imagenet_module(mt)
    mod.fit(make_iter(), num_epoch=1, optimizer="sgd",
            optimizer_params=imagenet_opt(), initializer=imagenet_init(mt, np))
    arg, aux = mod.get_params()
    out = {k: v.asnumpy() for k, v in list(arg.items()) + list(aux.items())}
    del mod
    torch.cuda.empty_cache()
    return out


def plain_first_loss(torch, np, mt, rec):
    """The step-1 cross-entropy of a plain f32 forward (``plain_resnet``,
    the 7x7 stem) of the seeded weights on the iterator's first batch."""
    it = record_iter(mt, rec["rec"], DATA_THREADS)
    first = next(it)
    it.close()
    mod = imagenet_module(mt)
    mod.bind(data_shapes=[("data", (DATA_BATCH,) + data_shape())],
             label_shapes=[("softmax_label", (DATA_BATCH,))])
    mod.init_params(imagenet_init(mt, np))
    dev = torch.device(DEVICE)
    args = {n: a.data for n, a in mod.get_params()[0].items()}
    x = torch.from_numpy(first.data[0].asnumpy()).to(dev)
    y = torch.from_numpy(first.label[0].asnumpy()).to(dev)
    with torch.no_grad():
        ce, _ = plain_resnet(torch, args, x, y)
    del mod, args
    torch.cuda.empty_cache()
    return float(ce), x, y


def check_imagenet(what, run, want, ce_tol, resident):
    """16c's checks of one fit epoch from records, and its readings beside
    the same net fed device-resident batches."""
    c = run["counters"]
    idle = None if run["busy_ms"] is None else \
        1 - run["busy_ms"] / max(run["prof_wall_ms"], 1e-9)
    log("16c %s: ResNet-%d (7x7 stem) through Module.fit from "
        "ImageRecordIter (%s route, %d threads), batch %d, %d steps: %.3f ms "
        "a step between CUDA events after %d warm (%.1f img/s); fed "
        "device-resident batches %.3f ms (%.1f img/s); epoch %.3f s; idle "
        "share of profiled step %d: %s (busy %s of %.3f ms); counters %s"
        % (what, RESNET_LAYERS, DATA_DECODER, DATA_THREADS, DATA_BATCH,
           run["steps"], run["step_ms"], IMAGENET_WARM, run["img_s"],
           resident["step_ms"], resident["img_s"], run["wall_s"],
           IMAGENET_PROFILED, "%.3f" % idle if idle is not None else "n/a",
           "%.3f" % run["busy_ms"] if run["busy_ms"] is not None else "n/a",
           run["prof_wall_ms"], json.dumps(c)))
    losses = run["losses"]
    log("16c %s: loss per step %s" % (what, " ".join("%.4f" % v
                                                     for v in losses)))
    log("16c %s: step-1 cross-entropy %.6f, plain f32 forward of the same "
        "decoded batch %.6f (|diff| %.3g, tolerance %g); device accuracy "
        "%d / %d, host count over the fetched outputs %d"
        % (what, losses[0], want, abs(losses[0] - want), ce_tol,
           run["metric"][0], run["metric"][1], run["hits"]))
    check(all(math.isfinite(v) for v in losses), "16c %s: non-finite loss"
          % what)
    check(abs(losses[0] - want) <= ce_tol, "16c %s: step-1 loss %g vs plain "
          "forward %g" % (what, losses[0], want))
    tail = losses[-max(1, len(losses) // 4):]
    check(sum(tail) / len(tail) < losses[0], "16c %s: loss did not fall "
          "(the last quarter's mean against step 1)" % what)
    check(run["metric"] == (run["hits"], run["steps"] * DATA_BATCH),
          "16c %s: device accuracy %s, host count %d of %d" % (
              what, run["metric"], run["hits"], run["steps"] * DATA_BATCH))
    check(c["loop_host_sync"] == 0, "16c %s: loop_host_sync %d (a per-batch "
          "host sync)" % (what, c["loop_host_sync"]))
    check(c["loop_prefetch_placed"] == run["steps"], "16c %s: %d batches "
          "placed by the prefetch stage for %d steps"
          % (what, c["loop_prefetch_placed"], run["steps"]))
    check(run["steps"] == DATA_RECORDS // DATA_BATCH, "16c %s: %d steps, "
          "the epoch has %d" % (what, run["steps"],
                                DATA_RECORDS // DATA_BATCH))


def imagenet_phase(torch, np, mt, rec):
    """16c: train_imagenet's path at full width, in amp bf16 and in f32:
    one epoch from the records, the same from device-resident batches,
    then windows 2 and 0 over DATA_PARITY_STEPS steps."""
    from mxnet_tpu_torch.io import ResizeIter
    check(not torch.backends.cudnn.allow_tf32 and
          not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is allowed: the plain forward would not be float32")
    want, x, y = plain_first_loss(torch, np, mt, rec)
    dev_x, dev_y = mt.nd.array(x, ctx=x.device), mt.nd.array(y, ctx=y.device)
    steps = DATA_RECORDS // DATA_BATCH
    readings = {}
    for what, amp_on, tol in (("bf16", True, RESNET_CE_TOL),
                              ("f32", False, RESNET_F32_CE_TOL)):
        if amp_on:
            mt.amp.init("bfloat16")
        try:
            run = imagenet_fit(
                torch, np, mt, lambda: record_iter(mt, rec["rec"],
                                                   DATA_THREADS),
                "16c " + what, profile_step=IMAGENET_PROFILED)
            resident = imagenet_fit(
                torch, np, mt, lambda: ResidentIter(mt, dev_x, dev_y, steps),
                "16c %s resident" % what)
        finally:
            if amp_on:
                mt.amp.off()
        check_imagenet(what, run, want, tol, resident)
        readings[what] = {"step_ms": run["step_ms"], "img_s": run["img_s"],
                          "resident_ms": resident["step_ms"],
                          "idle": None if run["busy_ms"] is None else
                          1 - run["busy_ms"] / max(run["prof_wall_ms"],
                                                   1e-9),
                          "stall": run["counters"]["loop_prefetch_stall"]}
    del dev_x, dev_y, x, y
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    mt.amp.init("bfloat16")
    params = {}
    inner = []

    def parity_iter():
        inner.append(record_iter(mt, rec["rec"], DATA_THREADS))
        return ResizeIter(inner[-1], DATA_PARITY_STEPS)

    try:
        for window in (2, 0):
            mt.config.set("MXNET_TPU_ASYNC_WINDOW", window)
            params[window] = imagenet_params(torch, np, mt, parity_iter)
            inner[-1].close()
    finally:
        mt.config.reset("MXNET_TPU_ASYNC_WINDOW")
        mt.amp.off()
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = flags
    differ = [k for k in params[2]
              if not np.array_equal(params[2][k], params[0][k])]
    log("16c windows 2 and 0 over %d steps (amp bf16, cudnn.deterministic):"
        " %d of %d arrays differ%s" % (DATA_PARITY_STEPS, len(differ),
                                       len(params[2]),
                                       " (%s)" % differ[:3] if differ
                                       else ", bit for bit"))
    check(not differ, "16c: window 2 and window 0 end on other weights: %s"
          % differ[:5])
    return readings


class _Stop(Exception):
    """Ends a fit from its batch-end callback: the interrupted run."""


def loader_fit(torch, np, mt, rec, workers, ckpt=None, resume=None,
               stop_after=None):
    """16d's fit: DataLoader + ImageTransform over the resume index, one
    epoch of DATA_RESUME_BATCHES batches of DATA_RESUME_BATCH, amp bf16,
    from the seeded weights (or a checkpoint); the parameters after it."""
    from mxnet_tpu_torch.data import DataLoader, ImageTransform
    mt.random.seed(SEED)
    dl = DataLoader(rec["rec"], idx_path=rec["resume_idx"],
                    batch_size=DATA_RESUME_BATCH,
                    transform=ImageTransform(data_shape(),
                                             mean=sum(DATA_MEAN) / 3),
                    shuffle=True, seed=SEED, num_workers=workers,
                    part=(0, 1), label_name="softmax_label")
    mod = imagenet_module(mt)
    calls = [0]

    def stopper(_param):
        calls[0] += 1
        if stop_after is not None and calls[0] >= stop_after:
            raise _Stop()

    try:
        mod.fit(dl, num_epoch=1, optimizer="sgd",
                optimizer_params=imagenet_opt(), checkpoint=ckpt,
                resume_from=resume, batch_end_callback=stopper,
                initializer=imagenet_init(mt, np))
    except _Stop:
        pass
    finally:
        dl.close()
    arg, aux = mod.get_params()
    out = {k: v.asnumpy() for k, v in list(arg.items()) + list(aux.items())}
    del mod
    torch.cuda.empty_cache()
    return out, calls[0]


def resume_phase(torch, np, mt, rec, out):
    """16d: the DataLoader through fit, checkpointed at batch
    DATA_RESUME_AT of DATA_RESUME_BATCHES with 2 workers and resumed with
    4: bit for bit the uninterrupted run, the manifest carrying the
    cursor; and the uninterrupted run again with DATA_FAULT killing
    workers, which the loader respawns over their ranges."""
    import shutil
    from mxnet_tpu_torch import faults, profiler
    from mxnet_tpu_torch.checkpoint import CheckpointConfig, restore_latest
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    mt.amp.init("bfloat16")
    ckdir = out / "ckpt"
    try:
        t0 = time.perf_counter()
        ref, n_ref = loader_fit(torch, np, mt, rec, 2)
        ref_s = time.perf_counter() - t0
        ck = CheckpointConfig(str(ckdir), every_n_batches=DATA_RESUME_AT)
        loader_fit(torch, np, mt, rec, 2, ckpt=ck,
                   stop_after=DATA_RESUME_AT + 1)
        saved = restore_latest(str(ckdir))
        cursor = saved.data_cursor
        t0 = time.perf_counter()
        res, n_res = loader_fit(torch, np, mt, rec, 4, resume=str(ckdir))
        res_s = time.perf_counter() - t0
        respawn0 = profiler.get_counter("data_worker_respawn")
        faults.install(DATA_FAULT)
        try:
            hit, _ = loader_fit(torch, np, mt, rec, 2)
        finally:
            faults.clear()
        respawns = profiler.get_counter("data_worker_respawn") - respawn0
    finally:
        mt.amp.off()
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = flags
        shutil.rmtree(ckdir, ignore_errors=True)
    differ = [k for k in ref if not np.array_equal(ref[k], res[k])]
    differ_f = [k for k in ref if not np.array_equal(ref[k], hit[k])]
    log("16d DataLoader resume: ResNet-%d batch %d, %d batches an epoch, "
        "amp bf16; uninterrupted (2 workers) %d steps in %.3f s; checkpoint "
        "at batch %d (mid-epoch %s), cursor %s; resumed with 4 workers: %d "
        "steps in %.3f s, %d of %d arrays differ from the uninterrupted run"
        % (RESNET_LAYERS, DATA_RESUME_BATCH, DATA_RESUME_BATCHES, n_ref,
           ref_s, saved.batches_done, saved.mid_epoch, json.dumps(cursor),
           n_res, res_s, len(differ), len(ref)))
    log("16d %s: %d worker respawns; %d of %d arrays differ from the "
        "uninterrupted run" % (DATA_FAULT, respawns, len(differ_f),
                               len(ref)))
    check(n_ref == DATA_RESUME_BATCHES, "16d: the epoch ran %d batches, not "
          "%d" % (n_ref, DATA_RESUME_BATCHES))
    check(saved.mid_epoch and saved.batches_done == DATA_RESUME_AT,
          "16d: the checkpoint is at batch %s" % saved.batches_done)
    check(cursor is not None and cursor.get("batches_done") ==
          DATA_RESUME_AT and cursor.get("num_workers") == 2 and
          cursor.get("seed") == SEED and cursor.get("batch_size") ==
          DATA_RESUME_BATCH, "16d: the manifest's cursor is %s" % cursor)
    check(n_res == DATA_RESUME_BATCHES - DATA_RESUME_AT, "16d: the resumed "
          "run trained %d batches, not %d" % (
              n_res, DATA_RESUME_BATCHES - DATA_RESUME_AT))
    check(not differ, "16d: the resumed weights differ: %s" % differ[:5])
    check(respawns > 0, "16d: %s killed no worker" % DATA_FAULT)
    check(not differ_f, "16d: the run with killed workers differs: %s"
          % differ_f[:5])


def data_phase(torch, np):
    """Phase 16: the data plane and the async fit loop (16a-16d)."""
    import shutil
    import mxnet_tpu_torch as mt
    t0 = time.perf_counter()
    out = ROOT / "build" / "phase16"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    host_probe(out / "native")
    mt.config.set("MXNET_USE_NATIVE_IO", DATA_DECODER == "native")
    try:
        rec = records_phase(np, out)
        pipe = pipeline_phase(torch, np, mt, rec)
        fit = imagenet_phase(torch, np, mt, rec)
        resume_phase(torch, np, mt, rec, out)
    finally:
        mt.config.reset("MXNET_USE_NATIVE_IO")
        shutil.rmtree(out, ignore_errors=True)
    log("16 data plane: %.1f s; %s" % (time.perf_counter() - t0,
                                       json.dumps({"pipeline": pipe,
                                                   "fit": fit})))
    return {"pipeline": pipe, "fit": fit}


# ------------------------------------------------ phase 17: serving (A8c)

def serve_close(np, got, want):
    """max |got - want| / max(1, max |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() /
                 max(1.0, float(np.abs(want).max())))


def serve_model(torch, np, mt):
    """benchmark_score's ResNet-50 up to its logits and seeded weights
    (Xavier magnitude 2, as phase 12d draws them): the symbol, and the
    ``arg:`` / ``aux:`` parameter dict on the host."""
    from mxnet_tpu_torch.models import resnet
    sym = logits_symbol(mt, resnet.get_symbol(num_classes=SERVE_CLASSES,
                                              num_layers=SERVE_LAYERS))
    mod = mt.mod.Module(sym, label_names=None, context=mt.gpu(0))
    mod.bind(data_shapes=[("data", (1, 3, SERVE_IMAGE, SERVE_IMAGE))],
             for_training=False)
    mod.init_params(mt.init.Xavier(magnitude=2).set_rng(
        np.random.default_rng(SEED)))
    arg, aux = mod.get_params()
    params = {"arg:" + k: v.asnumpy() for k, v in arg.items()}
    params.update({"aux:" + k: v.asnumpy() for k, v in aux.items()})
    del mod
    return sym, params


def closed_loop(srv, images, repeats, timeout=600):
    """One client thread per image: submit it, wait for the row, repeat.
    Returns every row (client by client) and the wall seconds."""
    rows = [[None] * repeats for _ in images]
    errors = []

    def client(i):
        try:
            for r in range(repeats):
                rows[i][r] = srv.submit(images[i]).result(timeout=timeout)
        except Exception as exc:                           # noqa: BLE001
            errors.append((i, repr(exc)))

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(images))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    wall = time.perf_counter() - t0
    check(not errors and not any(t.is_alive() for t in threads),
          "17a: clients failed or hung: %s" % errors[:3])
    return rows, wall


def serve_batcher(torch, np, mt, sym, params, images):
    """17a: InferenceServer over a Predictor at full width, one client
    thread per image."""
    from mxnet_tpu_torch import profiler, serve
    check(mt.config.get("MXNET_TPU_SERVE_MAX_BATCH") == SERVE_MAX_BATCH,
          "MXNET_TPU_SERVE_MAX_BATCH's default is not %d" % SERVE_MAX_BATCH)
    shape = images[0].shape
    pred = mt.Predictor(sym.tojson(), params, {"data": (1,) + shape},
                        ctx=mt.gpu(0))
    pred.forward(data=images[0][None])[0].asnumpy()     # warm cuDNN
    # one caller, one batch-1 forward of each image back to back: the
    # rate to beat, and each image's reference row
    t0 = time.perf_counter()
    ref = [pred.forward(data=x[None])[0].asnumpy()[0] for x in images]
    seq_s = time.perf_counter() - t0
    seq_rate = len(images) / seq_s
    name = "phase17"
    torch.cuda.reset_peak_memory_stats()
    spec = serve.BucketSpec(SERVE_MAX_BATCH)
    srv = serve.InferenceServer(pred, buckets=spec, name=name,
                                ctx=mt.gpu(0))
    # the batcher thread's host time in the first pass, by part
    spent = dict.fromkeys(("batch", "assemble", "model"), 0.0)

    def timed(part, fn):
        def run(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                spent[part] += time.perf_counter() - t0
        return run

    plain = {k: getattr(srv, k) for k in ("_run_batch", "_assemble",
                                          "_call_model")}
    srv._run_batch = timed("batch", plain["_run_batch"])
    srv._assemble = timed("assemble", plain["_assemble"])
    srv._call_model = timed("model", plain["_call_model"])
    try:
        with profiler.counter_delta() as first:
            rows, wall = closed_loop(srv, images, SERVE_REPEATS)
            st = srv.stats()
        used = dict(spent)      # the cached runners keep the wrapper
        for k, fn in plain.items():
            setattr(srv, k, fn)
        touched = sorted({sig[1] for sig in srv.cache._entries})
        compiles = first.get(name + "_compile")
        went = (first.get(name + "_eager"), first.get(name + "_fallback"))
        check(went == (0, 0), "17a: the batched run went eager (%d) or fell "
              "back (%d)" % went)
        # warm the rest of the grid, then the second pass adds no runner
        for b in spec.batch_buckets:
            if b not in touched:
                srv.submit(np.stack(images[:b]), batched=True).result(600)
        warm = len(srv.cache)
        with profiler.counter_delta() as later:
            rows2, wall2 = closed_loop(
                srv, images[:SERVE_SECOND // 2], 2)
        second = later.get(name + "_compile")
        second_hits = later.get(name + "_cache_hit")
    finally:
        srv.close(timeout=600)
    peak = torch.cuda.max_memory_allocated()
    rate = len(images) * SERVE_REPEATS / wall
    err = max(serve_close(np, rows[i][r], ref[i])
              for i in range(len(images)) for r in range(SERVE_REPEATS))
    err2 = max(serve_close(np, rows2[i][r], ref[i])
               for i in range(len(rows2)) for r in range(2))
    lat = st["latency"]
    eager = went[0] + later.get(name + "_eager")
    fallback = went[1] + later.get(name + "_fallback")
    log("17a InferenceServer over a Predictor (ResNet-%d, %d classes, "
        "%dx%d, f32): %d clients x %d = %d requests in %.3f s = %.1f req/s; "
        "one caller, %d batch-1 forwards: %.3f s = %.1f req/s; ratio %.2f; "
        "latency p50 %.3f ms p95 %.3f ms p99 %.3f ms (mean %.3f, max %.3f); "
        "%d batches, mean %.3f rows, occupancy %.4f; buckets touched %s, "
        "runners %d; peak memory %.3f GB; max row error %.3g of max(1, "
        "max|ref|) (limit %g)"
        % (SERVE_LAYERS, SERVE_CLASSES, SERVE_IMAGE, SERVE_IMAGE,
           len(images), SERVE_REPEATS, len(images) * SERVE_REPEATS,
           wall, rate, len(images), seq_s, seq_rate, rate / seq_rate,
           lat["p50_ms"], lat["p95_ms"], lat["p99_ms"], lat["mean_ms"],
           lat["max_ms"], st["batches"], st["avg_batch_rows"],
           st["occupancy"], touched, compiles, peak / 1e9, err,
           SERVE_ATOL))
    nb = max(1, st["batches"])
    log("17a the batcher thread in the first pass, ms a batch: assembling "
        "the padded batch on the host %.3f, the model and its fetch (the "
        "sync) %.3f, the rest (H2D copy, splitting, futures) %.3f; busy "
        "%.3f of the pass's %.3f s" % (
            used["assemble"] * 1e3 / nb, used["model"] * 1e3 / nb,
            (used["batch"] - used["assemble"] - used["model"]) * 1e3 / nb,
            used["batch"], wall))
    log("17a second pass (grid warm, %d runners): %d requests in %.3f s = "
        "%.1f req/s, %d new runners, %d runner hits; max row error %.3g; "
        "_eager %d, _fallback %d" % (
            warm, len(rows2) * 2, wall2, len(rows2) * 2 / wall2, second,
            second_hits, err2, eager, fallback))
    check(eager == 0 and fallback == 0, "17a: the batched run went eager "
          "(%d) or fell back (%d)" % (eager, fallback))
    check(err <= SERVE_ATOL and err2 <= SERVE_ATOL, "17a: served rows "
          "%.3g / %.3g of max|ref| from the batch-1 forward" % (err, err2))
    check(compiles == len(touched), "17a: %d runners for the buckets %s"
          % (compiles, touched))
    check(second == 0, "17a: the warm second pass added %d runners"
          % second)
    padded_check(torch, np, pred, images)
    kill_switch_check(np, mt, pred, images, ref)
    adapter_checks(torch, np, mt, sym, params, images)
    del pred
    gc.collect()
    torch.cuda.empty_cache()
    return {"req_s": rate, "seq_req_s": seq_rate, "ratio": rate / seq_rate,
            "latency": lat, "avg_batch_rows": st["avg_batch_rows"],
            "occupancy": st["occupancy"], "runners": compiles,
            "buckets": touched, "peak_gb": peak / 1e9}


def padded_check(torch, np, pred, images):
    """3 requests served at bucket 4 are the bits of the model on the
    zero-padded 4-row buffer (cuDNN's deterministic algorithms)."""
    from mxnet_tpu_torch import serve
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        with serve.InferenceServer(pred, max_batch_size=4,
                                   max_delay_us=300_000, ctx=pred._ctx,
                                   name="phase17_pad") as srv:
            futs = [srv.submit(x) for x in images[:3]]
            got = [f.result(timeout=600) for f in futs]
            batches = srv.stats()["batches"]
        buf = np.zeros((4,) + images[0].shape, np.float32)
        buf[:3] = np.stack(images[:3])
        dev = pred._exec.arg_dict["data"].data.device
        direct = pred._exec.forward_inputs(
            False, {"data": torch.from_numpy(buf).to(dev)})[0].asnumpy()
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = flags
    same = [bool(np.array_equal(got[i], direct[i])) for i in range(3)]
    log("17a padded rows: 3 requests in %d batch of bucket 4, bit for bit "
        "the padded buffer's rows: %s" % (batches, same))
    check(batches == 1 and all(same), "17a: padding changed a served row")


def kill_switch_check(np, mt, pred, images, ref):
    """MXNET_TPU_SERVE=0: requests run eagerly in the caller, each
    counted, with the batched path's rows."""
    from mxnet_tpu_torch import profiler, serve
    mt.config.set("MXNET_TPU_SERVE", False)
    try:
        with profiler.counter_delta() as d, \
                serve.InferenceServer(pred, name="phase17_kill",
                                      ctx=pred._ctx) as srv:
            got = [srv.submit(images[i]).result(timeout=600)
                   for i in range(SERVE_KILL)]
            batches = srv.stats()["batches"]
    finally:
        mt.config.reset("MXNET_TPU_SERVE")
    eager = d.get("phase17_kill_eager")
    err = max(serve_close(np, got[i], ref[i]) for i in range(SERVE_KILL))
    log("17a MXNET_TPU_SERVE=0: %d requests, %d eager forwards, %d batches,"
        " max error against the batch-1 rows %.3g" % (SERVE_KILL, eager,
                                                     batches, err))
    check(eager == SERVE_KILL and batches == 0 and err <= SERVE_ATOL,
          "17a: the kill switch served %d eager, %d batches, error %.3g"
          % (eager, batches, err))


def adapter_checks(torch, np, mt, sym, params, images):
    """wrap_model of a Module bound for_training=False and of Gluon's
    zoo net: concurrent requests against each model's own forward."""
    from mxnet_tpu_torch import gluon, serve
    shape = images[0].shape
    mod = mt.mod.Module(sym, label_names=None, context=mt.gpu(0))
    mod.bind(data_shapes=[("data", (1,) + shape)], for_training=False)
    mod.set_params({k[4:]: v for k, v in params.items()
                    if k.startswith("arg:")},
                   {k[4:]: v for k, v in params.items()
                    if k.startswith("aux:")})
    mt.random.seed(SEED)
    net = gluon.model_zoo.vision.get_model(SERVE_GLUON,
                                           classes=SERVE_CLASSES)
    net.initialize(mt.init.Xavier(magnitude=2).set_rng(
        np.random.default_rng(SEED)), ctx=mt.gpu(0))
    net.hybridize()
    dev = torch.device(DEVICE)
    xs = images[:SERVE_ADAPTER]

    def module_ref(x):
        mod.forward(mt.io.DataBatch(data=[mt.nd.array(x[None], ctx=dev)]),
                    is_train=False)
        return mod.get_outputs()[0].asnumpy()[0]

    def gluon_ref(x):
        return net(mt.nd.array(x[None], ctx=dev)).asnumpy()[0]

    for what, model, direct in (("Module", mod, module_ref),
                                ("Gluon " + SERVE_GLUON, net, gluon_ref)):
        want = [direct(x) for x in xs]
        with serve.InferenceServer(model, max_batch_size=SERVE_MAX_BATCH,
                                   name="phase17_" + what.split()[0],
                                   ctx=mt.gpu(0)) as srv:
            futs = [srv.submit(x) for x in xs]
            got = [f.result(timeout=600) for f in futs]
            st = srv.stats()
        err = max(serve_close(np, g, w) for g, w in zip(got, want))
        log("17a wrap_model(%s): %d requests in %d batches, max error "
            "against its own forward %.3g" % (what, len(xs), st["batches"],
                                              err))
        check(err <= SERVE_ATOL, "17a: %s served rows %.3g from its "
              "forward" % (what, err))
    del mod, net


def serve_export_start(torch, np, mt, sym, params, images):
    """17b, started: Predictor.export at batch 32, and the standalone
    loader in a subprocess without the framework on its path, left
    running (17c goes beside it). Returns its state for
    :func:`serve_export_finish`."""
    import os
    import shutil
    out = ROOT / "build" / "phase17"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    try:
        shape = (SERVE_EXPORT_BATCH,) + images[0].shape
        pred = mt.Predictor(sym.tojson(), params, {"data": shape},
                            ctx=mt.gpu(0))
        x = np.stack([images[i % len(images)]
                      for i in range(SERVE_EXPORT_BATCH)])
        want = pred.forward(data=x)[0].asnumpy()
        art = out / "resnet.mxprog"
        t0 = time.perf_counter()
        pred.export(str(art))
        export_s = time.perf_counter() - t0
        del pred
        gc.collect()
        torch.cuda.empty_cache()
        np.save(out / "x.npy", x)
        tool = Path(mt.__file__).resolve().parent / "tools" / \
            "predict_exported.py"
        code = ("import runpy, sys\n"
                "sys.argv = %r\n"
                "try:\n"
                "    runpy.run_path(%r, run_name='__main__')\n"
                "except SystemExit as e:\n"
                "    assert not e.code, e.code\n"
                "print('framework modules:', sorted(\n"
                "    m for m in sys.modules\n"
                "    if m.split('.')[0] in ('mxnet_tpu_torch', 'mxnet_tpu',"
                " 'jax')))\n"
                % ([str(tool), str(art), "--input",
                    "data=%s" % (out / "x.npy"), "--save",
                    str(out / "y.npz")], str(tool)))
        env = dict(os.environ)
        env.pop("PYTHONPATH", None)
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                                cwd=str(out), stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    except BaseException:
        shutil.rmtree(out, ignore_errors=True)
        raise
    return {"proc": proc, "t0": t0, "out": out, "want": want,
            "export_s": export_s, "size": art.stat().st_size}


def serve_export_finish(torch, np, state):
    """17b, finished: the loader's output against ``forward``'s."""
    import shutil
    out, want = state["out"], state["want"]
    try:
        stdout, stderr = state["proc"].communicate(timeout=600)
        run_s = time.perf_counter() - state["t0"]
        check(state["proc"].returncode == 0, "17b: predict_exported.py "
              "failed: %s" % stderr[-2000:])
        with np.load(out / "y.npz") as z:
            got = z["output_0"]
        err = serve_close(np, got, want)
    finally:
        if state["proc"].poll() is None:
            state["proc"].kill()
            state["proc"].wait()
        shutil.rmtree(out, ignore_errors=True)
    size, export_s = state["size"], state["export_s"]
    for line in stdout.strip().splitlines():
        log("17b loader: " + line)
    log("17b Predictor.export (batch %d): %.1f MB artifact in %.3f s; the "
        "loader's subprocess %.3f s (beside 17c); output max error %.3g of "
        "max(1, max|ref|) (limit %g)" % (SERVE_EXPORT_BATCH, size / 1e6,
                                         export_s, run_s, err,
                                         SERVE_EXPORT_ATOL))
    check("framework modules: []" in stdout, "17b: the loader imported "
          "the framework: %s" % stdout[-500:])
    check("device %s" % torch.device(DEVICE) in stdout, "17b: the "
          "loader did not run on the card: %s" % stdout[-500:])
    check("tf32 matmul off cudnn off" in stdout, "17b: the loader did "
          "not run in float32: %s" % stdout[-500:])
    check(err <= SERVE_EXPORT_ATOL, "17b: the artifact's output is %.3g "
          "from forward's" % err)
    return {"mb": size / 1e6, "export_s": export_s, "load_run_s": run_s,
            "err": err}


def serve_int8(torch, np, mt):
    """17c: GenerativeServer with an int8 KV cache on phase 4's model."""
    from mxnet_tpu_torch._fused import CompileCache
    from mxnet_tpu_torch.ops.flash_attention import flash_attention_fwd
    from mxnet_tpu_torch.serve import GenerativeServer
    from mxnet_tpu_torch.serve.decode import DecodeEngine, _quantize_pages
    from mxnet_tpu_torch.serve.kv_cache import KVCache, max_slots_for
    params = PHASE4.get("params")
    if params is None:
        t0 = time.perf_counter()
        params = seeded_params(np, SEED)
        log("17c weights drawn again in %.1f s" % (time.perf_counter() - t0))
    phase4 = PHASE4["outs"]
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, VOCAB, n) for n in PROMPT_LENS]
    srv = GenerativeServer(params, n_heads=HEADS, max_sequences=SLOTS,
                           page=PAGE, int8=True, name="phase17_gen",
                           device=DEVICE)
    try:
        flash_attention_fwd.launches = {"f32": 0, "bf16": 0}
        outs, wall = burst(srv, prompts)
        counts = dict(flash_attention_fwd.launches)
        torch.cuda.synchronize()
        st = srv.stats()
        report("17c int8 cold", srv, outs, wall)
        # again, every runner warm (phase 4 reads its f32 burst so too)
        warm, warm_wall = burst(srv, prompts)
        report("17c int8 warm", srv, warm, warm_wall)
        warm_st = srv.stats()
    finally:
        srv.close(timeout=600)
    cache, eng = srv.cache, srv.engine
    scale_bytes = 2 * cache.k_scale.numel() * cache.k_scale.element_size()
    slots32 = max_slots_for(SERVE_BUDGET, LAYERS, HEADS, D_MODEL // HEADS,
                            MAX_SEQ, PAGE, int8=False)
    slots8 = max_slots_for(SERVE_BUDGET, LAYERS, HEADS, D_MODEL // HEADS,
                           MAX_SEQ, PAGE, int8=True)
    agree = sum(a == b for o, p in zip(outs, phase4) for a, b in zip(o, p))
    log("17c int8 KV cache: hbm_bytes %d (scales %d), the allocator's "
        "blocks %d; audit %s; max_slots_for(%g GB): f32 %d, int8 %d; "
        "K1 launches %s in the burst; greedy tokens equal to phase 4's f32 "
        "burst at %d of %d positions" % (
            st["kv"]["hbm_bytes"], scale_bytes, cache.device_bytes(),
            json.dumps(srv.hbm_audit), SERVE_BUDGET / 1e9, slots32, slots8,
            counts, agree, sum(len(o) for o in outs)))
    check(counts["f32"] == len(prompts) * LAYERS and counts["bf16"] == 0,
          "17c: flash kernel launches %s for %d prefills x %d layers"
          % (counts, len(prompts), LAYERS))
    check(st["kv"]["int8"] and st["kv"]["slots_in_use"] == 0,
          "17c: the cache is not int8 or leaked slots: %s" % st["kv"])
    check(all(len(o) == NEW_TOKENS and all(0 <= t < VOCAB for t in o)
              for o in outs), "17c: a sequence came back short or out of "
          "the vocabulary")
    check(slots8 >= 2 * slots32, "17c: int8 admits %d slots against %d"
          % (slots8, slots32))
    check(srv.hbm_audit["reserved_bytes"] == cache.device_bytes() >=
          cache.hbm_bytes(), "17c: the audit's bytes %s" % srv.hbm_audit)
    # teacher forcing on phase 4's greedy tokens: an f32 cache beside the
    # server's int8 one, over the same weights
    cache32 = KVCache(LAYERS, HEADS, D_MODEL // HEADS, SLOTS, MAX_SEQ,
                      page=PAGE, int8=False, name="phase17_f32",
                      device=DEVICE)
    eng32 = DecodeEngine(eng.params, HEADS, cache32,
                         CompileCache("phase17_f32"))
    worst, argmax_same, steps = 0.0, 0, 0
    # prompt i sits in slot slots[e][i] of engine e; rows in prompt order
    engines = (eng, eng32)
    slots = ([cache.acquire(len(pr)) for pr in prompts],
             [cache32.acquire(len(pr)) for pr in prompts])
    for i, pr in enumerate(prompts):
        p8, p32 = (torch.softmax(torch.from_numpy(e.prefill(pr, sl[i])), -1)
                   for e, sl in zip(engines, slots))
        worst = max(worst, float((p8 - p32).abs().max()))
    longest = int(np.argmax(PROMPT_LENS))
    codes_diff = int_codes_check(
        torch, cache, cache32, slots[0][longest], slots[1][longest],
        eng.prompt_bucket(len(prompts[longest])), _quantize_pages)
    # decode's requantize-on-write, write for write: each write the int8
    # engine makes below is recorded with the card's own new K/V rows,
    # to be replayed on the host from the state after the prefills
    state0 = [t.cpu().numpy().copy()
              for t in (cache.k, cache.k_scale, cache.v, cache.v_scale)]
    where = {}
    for li in range(LAYERS):
        where[cache.k[li].data_ptr()] = (0, li)
        where[cache.v[li].data_ptr()] = (2, li)
    writes = []
    write = eng._write_token_i8

    def recorded(codes, scales, new, p):
        writes.append(where[codes.data_ptr()] + (
            new.cpu().numpy().copy(), p.cpu().numpy().copy()))
        write(codes, scales, new, p)

    eng._write_token_i8 = recorded
    pos = np.array([len(pr) for pr in prompts], np.int64)
    for step in range(NEW_TOKENS - 1):
        logits = []
        for e, sl in zip(engines, slots):
            tok = np.zeros(SLOTS, np.int64)
            p = np.zeros(SLOTS, np.int64)
            act = np.zeros(SLOTS, bool)
            for i, slot in enumerate(sl):
                tok[slot], p[slot], act[slot] = phase4[i][step], \
                    pos[i] + step, True
            logits.append(torch.from_numpy(e.decode_step(tok, p, act))[sl])
        l8, l32 = logits
        worst = max(worst, float((torch.softmax(l8, -1) -
                                  torch.softmax(l32, -1)).abs().max()))
        argmax_same += int((l8.argmax(-1) == l32.argmax(-1)).sum())
        steps += 1
    del eng._write_token_i8
    decode_diff = decode_writes_check(torch, np, eng, state0, writes)
    # one more step of each engine under the profiler: the device's busy
    # share of a decode step, int8 against f32
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.device(DEVICE).type == "cuda"
        else [])
    idle = {}
    for what, e, sl in zip(("int8", "f32"), engines, slots):
        tok = np.zeros(SLOTS, np.int64)
        p = np.zeros(SLOTS, np.int64)
        act = np.zeros(SLOTS, bool)
        for i, slot in enumerate(sl):
            tok[slot], p[slot], act[slot] = phase4[i][NEW_TOKENS - 1], \
                pos[i] + NEW_TOKENS - 1, True
        with profile(activities=acts) as prof:
            t1 = time.perf_counter()
            e.decode_step(tok, p, act)
            step_wall = time.perf_counter() - t1
        _, busy = device_breakdown(torch, prof, step_wall,
                                   "17c %s decode step" % what)
        idle[what] = 1 - busy / (step_wall * 1e3)
    for c, sl in zip((cache, cache32), slots):
        for slot in sl:
            c.release(slot)
    log("17c teacher-forced on phase 4's tokens: %d prefills and %d decode "
        "steps x %d slots, worst softmax difference int8 - f32 %.3g (limit "
        "%g); argmax equal at %d of %d steps; layer 0 codes of the %d-token "
        "prompt against the plain quantizer on the CPU: %d differ (by one "
        "level at most)" % (len(prompts), steps, len(prompts), worst,
                            SERVE_INT8_SOFTMAX_TOL, argmax_same,
                            steps * len(prompts), len(prompts[longest]),
                            codes_diff))
    log("17c decode's %d int8 writes replayed by the plain requantizer on "
        "the host from the state "
        "after the prefills: scales equal, %d codes differ (by one level "
        "at most) in %d layers; _read_bucket at %d positions equal to "
        "codes x page scales" % (len(writes), decode_diff, LAYERS, MAX_SEQ))
    check(worst <= SERVE_INT8_SOFTMAX_TOL, "17c: int8 softmax %.3g from the "
          "f32 cache's" % worst)
    del eng32, cache32, srv, eng, cache
    gc.collect()
    torch.cuda.empty_cache()
    return {"tok_s": sum(len(o) for o in outs) / wall,
            "warm_tok_s": sum(len(o) for o in warm) / warm_wall,
            "ttft": warm_st["ttft"], "tpot": warm_st["tpot"],
            "hbm_bytes": st["kv"]["hbm_bytes"], "slots_f32": slots32,
            "slots_int8": slots8, "softmax_worst": worst,
            "codes_diff": codes_diff, "decode_codes_diff": decode_diff,
            "decode_writes": len(writes), "decode_idle": idle,
            "phase4_agree": agree}


def int_codes_check(torch, cache, cache32, slot, slot32, t_b, quantize):
    """Layer 0's int8 block and scales of one prefill (``slot`` of the
    int8 cache, ``slot32`` of the f32 one, bucket ``t_b``) against the
    port's plain quantizer on the CPU over the f32 cache's K and V of the
    same prompt: scales equal, codes at most one level apart. Returns how
    many codes differ."""
    differ = 0
    for codes, scales, kv in ((cache.k, cache.k_scale, cache32.k),
                              (cache.v, cache.v_scale, cache32.v)):
        q, sc = quantize(kv[0, slot32, :, :t_b].cpu(), PAGE)
        got = codes[0, slot, :, :t_b].cpu().to(torch.int16)
        gap = (got - q.to(torch.int16)).abs()
        check(torch.equal(scales[0, slot, :, :t_b // PAGE].cpu(), sc),
              "17c: the card's page scales differ from the CPU's")
        check(int(gap.max()) <= 1, "17c: an int8 code is %d levels from "
              "the CPU's" % int(gap.max()))
        differ += int((gap > 0).sum())
    return differ


def requantize_plain(np, codes, scales, new, pos, page):
    """The int8 cache's decode write in numpy, in place, one slot at a
    time: the token ``new[s]`` (H, d) goes to position ``pos[s]`` of
    ``codes`` (slots, H, S, d) int8 with ``scales`` (slots, H, S // page)
    f32. Entering a page resets its scale and empties it; within a page
    the scale grows to cover the token and the page is requantized."""
    f32 = np.float32
    for s, p in enumerate(pos):
        pi, off = divmod(int(p), page)
        rows = slice(pi * page, (pi + 1) * page)
        needed = np.maximum(np.abs(new[s]).max(-1) / f32(127), f32(1e-8))
        if off == 0:
            deq = np.zeros(codes[s, :, rows].shape, f32)
            scale = needed
        else:
            old = scales[s, :, pi]
            deq = codes[s, :, rows].astype(f32) * old[:, None, None]
            scale = np.maximum(old, needed)
        deq[:, off] = new[s]
        codes[s, :, rows] = np.clip(np.round(deq / scale[:, None, None]),
                                    -127, 127).astype(np.int8)
        scales[s, :, pi] = scale


def decode_writes_check(torch, np, eng, state0, writes):
    """17c: decode's int8 path on the card against a plain version on
    the host. Every write (``state0``'s index, layer, the card's new
    rows, positions) is replayed by :func:`requantize_plain` from
    ``state0`` (K codes, K scales, V codes, V scales after the
    prefills): then every layer's scales equal the card's, and its codes
    are at most one level apart. ``_read_bucket``'s dequantize over the
    whole cache then equals codes x page scales computed on the host.
    Returns how many codes differ."""
    cache = eng.cache
    for i, li, new, pos in writes:
        requantize_plain(np, state0[i][li], state0[i + 1][li], new, pos,
                         cache.page)
    differ = 0
    for i, (codes, scales) in enumerate(((cache.k, cache.k_scale),
                                         (cache.v, cache.v_scale))):
        for li in range(LAYERS):
            gap = np.abs(codes[li].cpu().numpy().astype(np.int16) -
                         state0[2 * i][li].astype(np.int16))
            check(np.array_equal(scales[li].cpu().numpy(),
                                 state0[2 * i + 1][li]),
                  "17c: layer %d's page scales after decode differ from "
                  "the plain replay's" % li)
            check(int(gap.max()) <= 1, "17c: a code decode wrote in layer "
                  "%d is %d levels from the plain replay's"
                  % (li, int(gap.max())))
            differ += int((gap > 0).sum())
    for li in range(LAYERS):
        deq = eng._read_bucket(li, cache.max_seq)
        for got, codes, scales in zip(deq, (cache.k, cache.v),
                                      (cache.k_scale, cache.v_scale)):
            want = codes[li].cpu().numpy().astype(np.float32) * np.repeat(
                scales[li].cpu().numpy(), cache.page, -1)[..., None]
            check(np.array_equal(got.cpu().numpy(), want), "17c: "
                  "_read_bucket's dequantize of layer %d differs from "
                  "codes x page scales" % li)
    return differ


def serve_phase(torch, np):
    """Phase 17: serving (A8c): a-c, float32 with TF32 off."""
    import mxnet_tpu_torch as mt
    check(not torch.backends.cudnn.allow_tf32 and
          not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is allowed: the served rows would not be float32")
    t0 = time.perf_counter()
    sym, params = serve_model(torch, np, mt)
    rng = np.random.RandomState(SEED + 17)
    shape = (3, SERVE_IMAGE, SERVE_IMAGE)
    images = [rng.uniform(-1, 1, shape).astype(np.float32)
              for _ in range(SERVE_CLIENTS)]
    batcher = serve_batcher(torch, np, mt, sym, params, images)
    # the export's loader (a process of its own) runs beside 17c
    state = serve_export_start(torch, np, mt, sym, params, images)
    try:
        gen = serve_int8(torch, np, mt)
    except BaseException:
        import shutil
        state["proc"].kill()
        state["proc"].wait()
        shutil.rmtree(state["out"], ignore_errors=True)
        raise
    export = serve_export_finish(torch, np, state)
    log("17 serving: %.1f s; %s" % (time.perf_counter() - t0, json.dumps(
        {"batcher": batcher, "export": export, "int8": gen})))
    return {"batcher": batcher, "export": export, "int8": gen}


# ------------------------------------------- phase 18: the KVStore (A9a)

# 18a: the store's arithmetic on the card; the MLP that fit trains with
# a store and without (batch, features, hidden, classes, examples)
KV_SHAPE = (64, 257)
KV_SGD = dict(learning_rate=0.1, momentum=0.9, rescale_grad=0.25)
KV_ATOL = 1e-6          # of max(1, max|want|): a fused multiply-add
KV_MLP = dict(batch=32, feat=64, hidden=128, classes=10, examples=256,
              epochs=2)
# 18b: the single-card examples, each at its own defaults (``main([])``);
# A9A_ARGV may give one other arguments
A9A_EXAMPLES = ("train_mnist", "train_cifar10", "svm_mnist",
                "cnn_text_classification", "gluon_mnist", "autoencoder",
                "adversary_fgsm", "super_resolution", "neural_style",
                "actor_critic", "dqn")
A9A_ARGV = {}
KV_DEADLINE_S = 600


def kv_close(np, what, got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max()) / max(1.0, float(
        np.abs(want).max()))
    check(err <= KV_ATOL, "18a %s: %.3g from numpy (limit %g)"
          % (what, err, KV_ATOL))
    return err


def kv_sgd(np, w, mom, grads):
    """numpy's SGD with momentum over ``grads``, one push each (no
    weight decay): ``(w, mom)``."""
    for g in grads:
        mom = KV_SGD["momentum"] * mom - KV_SGD["learning_rate"] * (
            KV_SGD["rescale_grad"] * g)
        w = w + mom
    return w, mom


def kvstore_arith(torch, np, mt, out):
    """18a: init, push of a list, pull, the store's optimizer and its
    state file on the card, against numpy."""
    ctx = mt.gpu(0)
    rng = np.random.RandomState(SEED + 18)
    w0 = rng.randn(*KV_SHAPE).astype(np.float32)
    grads = [rng.randn(*KV_SHAPE).astype(np.float32) for _ in range(4)]
    kv = mt.kv.create("local")
    check((kv.type, kv.rank, kv.num_workers) == ("local", 0, 1),
          "18a: the local store reads %s" % ((kv.type, kv.rank,
                                               kv.num_workers),))
    kv.init(3, mt.nd.array(w0, ctx=ctx))
    kv.init(["a", "b"], [mt.nd.array(w0[:1], ctx=ctx),
                         mt.nd.array(w0[1:4], ctx=ctx)])
    kv.push(3, [mt.nd.array(g, ctx=ctx) for g in grads])
    outs = [mt.nd.zeros(KV_SHAPE, ctx=ctx) for _ in range(2)]
    kv.pull(3, out=outs)
    acc = grads[0]
    for g in grads[1:]:
        acc = acc + g
    for o in outs:
        check(o.data.device == torch.device(DEVICE),
              "18a: a pulled array is on %s" % o.data.device)
        check(np.array_equal(o.asnumpy(), w0 + acc),
              "18a: push of four values and pull differ from numpy's sum")
    ab = [mt.nd.zeros((1, KV_SHAPE[1]), ctx=ctx),
          mt.nd.zeros((3, KV_SHAPE[1]), ctx=ctx)]
    kv.pull(["a", "b"], out=ab)
    check(np.array_equal(ab[0].asnumpy(), w0[:1]) and
          np.array_equal(ab[1].asnumpy(), w0[1:4]),
          "18a: a pull of a list of keys differs from their init")

    kv = mt.kv.create("local")
    kv.init(3, mt.nd.array(w0, ctx=ctx))
    kv.set_optimizer(mt.optimizer.SGD(**KV_SGD))
    for g in grads[:2]:
        kv.push(3, mt.nd.array(g, ctx=ctx))
    w = mt.nd.zeros(KV_SHAPE, ctx=ctx)
    kv.pull(3, out=w)
    want_w, want_mom = kv_sgd(np, w0, np.zeros_like(w0), grads[:2])
    err = kv_close(np, "the store's SGD", w.asnumpy(), want_w)
    path = out / "kv.states"
    kv.save_optimizer_states(str(path))
    kv2 = mt.kv.create("local")
    kv2.init(3, w)
    kv2.set_optimizer(mt.optimizer.SGD(**KV_SGD))
    kv2.load_optimizer_states(str(path))
    kv_close(np, "the momentum read back",
             kv2._updater_obj.states[3].asnumpy(), want_mom)
    got = []
    for store in (kv, kv2):
        store.push(3, mt.nd.array(grads[2], ctx=ctx))
        store.pull(3, out=w)
        got.append(w.asnumpy())
    check(np.array_equal(got[0], got[1]),
          "18a: the store that read the state file steps unlike its "
          "writer")
    return {"sgd_err": err, "states_bytes": path.stat().st_size}


def kv_mlp(mt):
    a = KV_MLP
    data = mt.sym.Variable("data")
    h = mt.sym.FullyConnected(data, num_hidden=a["hidden"], name="fc1")
    h = mt.sym.Activation(h, act_type="relu")
    h = mt.sym.FullyConnected(h, num_hidden=a["classes"], name="fc2")
    return mt.sym.SoftmaxOutput(h, name="softmax")


def kvstore_module(torch, np, mt):
    """18a: a Module with a local store against one without: ``fit``
    bit for bit, ``update()`` within KV_ATOL."""
    a, ctx = KV_MLP, mt.gpu(0)
    rng = np.random.RandomState(SEED + 180)
    x = rng.randn(a["examples"], a["feat"]).astype(np.float32)
    y = rng.randint(0, a["classes"], a["examples"]).astype(np.float32)
    params = {"fc1_weight": (a["hidden"], a["feat"]),
              "fc1_bias": (a["hidden"],),
              "fc2_weight": (a["classes"], a["hidden"]),
              "fc2_bias": (a["classes"],)}
    params = {n: (rng.randn(*s) * 0.1).astype(np.float32)
              for n, s in params.items()}
    opt = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
    fitted = []
    for kv in (mt.kv.create("local"), None):
        mod = mt.mod.Module(kv_mlp(mt), context=ctx)
        mod.fit(mt.io.NDArrayIter(x, y, a["batch"]), num_epoch=a["epochs"],
                arg_params={n: mt.nd.array(v, ctx=ctx)
                            for n, v in params.items()},
                optimizer="sgd", optimizer_params=opt, kvstore=kv)
        check((mod._kvstore is kv) and mod._update_on_kvstore == (kv is
                                                                   not None),
              "18a: fit(kvstore=%r) left the module with store %r"
              % (kv, mod._kvstore))
        fitted.append(mod.get_params()[0])
    for n in params:
        check(torch.equal(fitted[0][n].data, fitted[1][n].data),
              "18a: fit with a local store and without differ at %s" % n)
    stepped = []
    for kv in (mt.kv.create("local"), None):
        mod = mt.mod.Module(kv_mlp(mt), context=ctx)
        mod.bind(data_shapes=[("data", (a["batch"], a["feat"]))],
                 label_shapes=[("softmax_label", (a["batch"],))])
        mod.init_params(arg_params={n: mt.nd.array(v, ctx=ctx)
                                    for n, v in params.items()})
        mod.init_optimizer(kvstore=kv, optimizer="sgd",
                           optimizer_params=opt)
        for i in range(3):
            sl = slice(i * a["batch"], (i + 1) * a["batch"])
            mod.forward_backward(mt.io.DataBatch(
                [mt.nd.array(x[sl], ctx=ctx)], [mt.nd.array(y[sl], ctx=ctx)]))
            mod.update()
        stepped.append(mod.get_params()[0])
    check(stepped[0]["fc1_weight"].data.device == torch.device(DEVICE),
          "18a: the update loop's weights are not on the card")
    err = max(kv_close(np, "update() of %s with a store" % n,
                       stepped[0][n].asnumpy(), stepped[1][n].asnumpy())
              for n in params)
    return {"update_err": err}


def a9a_examples(torch, np, mt):
    """18b: each example's main on the card; its gates are the check."""
    import importlib
    from mxnet_tpu_torch.examples import common
    readings = {}
    for name in A9A_EXAMPLES:
        example = importlib.import_module("mxnet_tpu_torch.examples." + name)
        # the last example's cyclic garbage freed now, not while this one
        # runs: freed then, it lowered the allocated bytes under the
        # baseline the peak is read against (dqn's 0.2 MB read as none)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t = time.perf_counter()
        try:
            scores = example.main(list(A9A_ARGV.get(name, [])))
        except common.GateFailure as exc:
            raise SmokeFailure("18b %s: its gate failed: %s" % (name, exc))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() - before
        check(all(math.isfinite(v) for v in scores.values()),
              "18b %s: a score is not finite: %s" % (name, scores))
        check(peak > 0, "18b %s: nothing was allocated on the card" % name)
        log("18b %s: %.2f s, peak %.1f MB over the %.1f MB held before; %s"
            % (name, secs, peak / 1e6, before / 1e6, json.dumps(scores)))
        readings[name] = dict(scores, seconds=secs)
    return readings


def kvstore_phase(torch, np):
    """Phase 18: the one-process KVStore (A9a): a, b."""
    import shutil
    import mxnet_tpu_torch as mt
    t0 = time.perf_counter()
    out = ROOT / "build" / "phase18"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    mt.config.set("MXNET_USE_NATIVE_IO", DATA_DECODER == "native")
    try:
        store = dict(kvstore_arith(torch, np, mt, out),
                     **kvstore_module(torch, np, mt))
        log("18a store: %s" % json.dumps(store))
        examples = a9a_examples(torch, np, mt)
    finally:
        mt.config.reset("MXNET_USE_NATIVE_IO")
        shutil.rmtree(out, ignore_errors=True)
    log("18 kvstore and examples: %.1f s" % (time.perf_counter() - t0))
    return {"store": store, "examples": examples}


# ----------------------------------- phase 19: observability (A10a)

# 19b: requests through InferenceServer from concurrent client threads
OBS_SERVE_CLIENTS, OBS_SERVE_EACH = 16, 4
# 19c: fit of phase 6's LM, obs on then off: warm steps before the first
# report(), timed steps before the second
OBS_WARM, OBS_TIMED = 2, 10
# the cost model's FLOPs a step against the independent PaLM count: the
# reference's test_transformer_flops_model_matches_palm_accounting
OBS_FLOPS_RTOL = 0.05
# obs's steps/s against the rate timed independently over the same
# region: the reference's test_obs_mfu_matches_independent_throughput_math
OBS_RATE_RTOL = 0.10
# 19e: the flight recorder's heartbeat, and the heartbeats that land
# before the child is killed
OBS_BB_FLUSH_S, OBS_BB_BEATS = 0.5, 3
OBS_BB_WAIT_S = 180
# a hung client, scrape, batcher or child ends the run here
OBS_DEADLINE_S = 400


def scrape(port: int):
    """The parsed samples of one HTTP scrape of ``/metrics``."""
    import urllib.request
    from mxnet_tpu_torch import obs
    body = urllib.request.urlopen("http://127.0.0.1:%d/metrics" % port,
                                  timeout=60).read().decode()
    return obs.parse_prometheus(body)


def load_trace(path):
    """A dumped chrome trace: (events, {lane name: tid})."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    lanes = {e["args"]["name"]: e["tid"] for e in events
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    return events, lanes


def request_flows(events, lanes, batcher_lane):
    """Each request flow of an InferenceServer trace checked to run from
    ``serve_submit`` on a client's lane (its one flow start) through a
    ``serve_launch`` to a ``serve_resolve`` on the batcher's lane.
    Returns ``{flow id: client lane name}``; raises SmokeFailure."""
    names = {tid: name for name, tid in lanes.items()}
    batcher = lanes.get(batcher_lane)
    check(batcher is not None, "no %s lane in the trace: %s"
          % (batcher_lane, sorted(lanes)))
    spans = {}
    for e in events:
        if e.get("ph") == "X":
            spans.setdefault((e["name"], e["tid"]), []).append(e)
    flows = {}
    for e in events:
        if e.get("cat") == "flow":
            flows.setdefault(e["id"], []).append(e)

    def within(kind, ev):
        return any(s["ts"] - 1e-3 <= ev["ts"] <= s["ts"] + s["dur"] + 1e-3
                   for s in spans.get((kind, ev["tid"]), ()))

    submits = {ev["args"]["flow"]: ev
               for (kind, _), evs in spans.items()
               if kind == "serve_submit" for ev in evs if "args" in ev}
    out = {}
    for fid, sub in submits.items():
        evs = flows.get(fid, [])
        starts = [e for e in evs if e["ph"] == "s"]
        check(len(starts) == 1 and starts[0]["tid"] == sub["tid"],
              "request flow %d: %d flow starts, not one on its submit's "
              "lane" % (fid, len(starts)))
        client = names.get(sub["tid"], "?")
        check(sub["tid"] != batcher, "request flow %d submitted on the "
              "batcher's lane" % fid)
        steps = [e for e in evs if e["ph"] == "t" and e["tid"] == batcher]
        check(any(within("serve_launch", e) for e in steps),
              "request flow %d never reaches a serve_launch on %s"
              % (fid, batcher_lane))
        check(any(within("serve_resolve", e) for e in steps),
              "request flow %d never reaches a serve_resolve on %s"
              % (fid, batcher_lane))
        out[fid] = client
    return out


def batch_flows(events, lanes, want=("train", "metric", "place")):
    """Each batch flow of a traced ``fit`` (the flow of each
    ``fused_step_dispatch``) checked to cross a ``prefetch/*`` lane and
    the ``want`` lanes. Returns the number of batches."""
    check(all(w in lanes for w in want) and
          any(n.startswith("prefetch/") for n in lanes),
          "fit's trace lacks a lane of %s + prefetch/*: %s"
          % (list(want), sorted(lanes)))
    prefetch = {tid for n, tid in lanes.items() if n.startswith("prefetch/")}
    tids = {}
    for e in events:
        if e.get("cat") == "flow":
            tids.setdefault(e["id"], set()).add(e["tid"])
    steps = [e for e in events
             if e.get("ph") == "X" and e["name"] == "fused_step_dispatch"]
    for e in steps:
        fid = (e.get("args") or {}).get("flow")
        check(fid is not None, "a fused_step_dispatch span carries no flow")
        seen = tids.get(fid, set())
        check(seen & prefetch and all(lanes[w] in seen for w in want),
              "batch flow %d crosses lanes %s, not prefetch/* + %s"
              % (fid, sorted(seen), list(want)))
    return len(steps)


def obs_generative(torch, np, mt, phase4):
    """19a: GenerativeServer on phase 4's model and prompts with spans on
    and a /metrics endpoint: the scrape against stats(), the tokens
    against phase 4's, K1 f32 once per prefill per layer."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.obs.prometheus import sample
    params = phase4.get("params")
    if params is None:
        params = seeded_params(np, SEED)
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, VOCAB, n) for n in PROMPT_LENS]
    name = "phase19_gen"
    srv = mt.serve.GenerativeServer(params, n_heads=HEADS,
                                    max_sequences=SLOTS, page=PAGE,
                                    name=name, device=DEVICE,
                                    metrics_port=0)
    try:
        port = srv.metrics_port
        check(port is not None and port > 0, "19a: no /metrics endpoint "
              "(metrics_port %r)" % port)
        fa.flash_attention_fwd.launches = {"f32": 0, "bf16": 0}
        outs, wall = burst(srv, prompts)
        counts = dict(fa.flash_attention_fwd.launches)
        st = srv.stats()
        samples = scrape(port)
    finally:
        srv.close(timeout=600)
    check(srv._metrics is None, "19a: the endpoint outlived close()")
    got = {"tokens": sample(samples, "mxnet_tpu_%s_tokens_total" % name),
           "ttft": sample(samples, "mxnet_tpu_%s_ttft_seconds_count" % name),
           "tpot": sample(samples, "mxnet_tpu_%s_tpot_seconds_count" % name)}
    want = {"tokens": st["tokens"], "ttft": st["ttft"]["window"],
            "tpot": st["tpot"]["window"]}
    same = sum(a == b for a, b in zip(outs, phase4["outs"]))
    log("19a GenerativeServer with /metrics on port %d: %d requests, %d "
        "tokens in %.3f s; the scrape %s against stats() %s; %d samples; "
        "K1 launches %s; greedy tokens equal to phase 4's for %d of %d "
        "prompts" % (port, len(prompts), st["tokens"], wall,
                     json.dumps(got), json.dumps(want), len(samples),
                     counts, same, len(prompts)))
    check(got == want, "19a: the scrape %s disagrees with stats() %s"
          % (got, want))
    check(outs == phase4["outs"], "19a: the greedy tokens differ from "
          "phase 4's (%d of %d prompts equal)" % (same, len(prompts)))
    check(counts["f32"] == len(prompts) * LAYERS and counts["bf16"] == 0,
          "19a: K1 launches %s for %d prefills x %d layers"
          % (counts, len(prompts), LAYERS))
    return {"tokens": st["tokens"], "wall_s": wall, "scrape": got}


def obs_inference(torch, np, mt, out):
    """19b: InferenceServer over phase 17a's ResNet-50 Predictor with
    spans on and a /metrics endpoint, under requests from concurrent
    client threads: every request's flow in the dumped trace, the
    scrape's latency count, and no held-lock sync under the model
    lock."""
    from mxnet_tpu_torch import lockcheck, profiler, serve
    from mxnet_tpu_torch.obs.prometheus import sample
    sym, params = serve_model(torch, np, mt)
    shape = (3, SERVE_IMAGE, SERVE_IMAGE)
    pred = mt.Predictor(sym.tojson(), params, {"data": (1,) + shape},
                        ctx=mt.gpu(0))
    rng = np.random.RandomState(SEED + 19)
    images = [rng.uniform(-1, 1, shape).astype(np.float32)
              for _ in range(OBS_SERVE_CLIENTS)]
    name = "phase19"
    n = OBS_SERVE_CLIENTS * OBS_SERVE_EACH
    profiler.set_config(filename=str(out / "serve_trace.json"))
    profiler.dump()          # a clean buffer: this pass's events alone
    srv = serve.InferenceServer(pred, buckets=serve.BucketSpec(
        SERVE_MAX_BATCH), name=name, ctx=mt.gpu(0), metrics_port=0)
    errors = []

    def client(i):
        try:
            for _ in range(OBS_SERVE_EACH):
                srv.submit(images[i]).result(timeout=600)
        except Exception as exc:                           # noqa: BLE001
            errors.append((i, repr(exc)))

    try:
        check(isinstance(srv._model_lock, lockcheck._WitnessLock) ==
              (lockcheck.mode() != "off") and
              getattr(srv._model_lock, "_allow_sync", True),
              "19b: the model lock is not a witnessed allow_sync lock")
        with profiler.counter_delta() as d:
            threads = [threading.Thread(target=client, args=(i,),
                                        name="client-%d" % i, daemon=True)
                       for i in range(OBS_SERVE_CLIENTS)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
            wall = time.perf_counter() - t0
            check(not errors and not any(t.is_alive() for t in threads),
                  "19b: clients failed or hung: %s" % errors[:3])
            samples = scrape(srv.metrics_port)
            st = srv.stats()
        held = d.get("lockcheck_held_sync")
    finally:
        srv.close(timeout=600)
    events, lanes = load_trace(profiler.dump())
    flows = request_flows(events, lanes, "mxnet_tpu_torch.serve[%s]" % name)
    count = sample(samples, "mxnet_tpu_%s_latency_seconds_count" % name)
    clients = sorted(set(flows.values()))
    log("19b InferenceServer over a Predictor (ResNet-%d) with spans on: %d "
        "requests from %d client threads in %.3f s, %d batches (mean %.3f "
        "rows); the scrape's latency count %s; %d request flows from %d "
        "client lanes through serve_launch to serve_resolve; %d trace "
        "events; held-lock syncs %d" % (
            SERVE_LAYERS, n, OBS_SERVE_CLIENTS, wall, st["batches"],
            st["avg_batch_rows"], count, len(flows), len(clients),
            len(events), held))
    check(count == n, "19b: the scrape counts %s latencies for %d requests"
          % (count, n))
    check(len(flows) == n and len(clients) == OBS_SERVE_CLIENTS,
          "19b: %d request flows on %d client lanes for %d requests from %d "
          "clients" % (len(flows), len(clients), n, OBS_SERVE_CLIENTS))
    check(held == 0, "19b: %d host syncs under a witnessed lock (the model "
          "lock allows them)" % held)
    del pred, srv
    gc.collect()
    return {"requests": n, "wall_s": wall, "flows": len(flows),
            "batches": st["batches"]}


def obs_fit_once(torch, np, mt, init, x, y, obs_on):
    """One fit of the LM over OBS_WARM + OBS_TIMED batches from the
    weights ``init``; with ``obs_on`` spans record and report() opens
    the rate window after the warm steps and closes it after the timed
    ones. The step time is timed independently over the same steps
    (CUDA events waited on at both ends)."""
    from mxnet_tpu_torch import config, profiler
    from mxnet_tpu_torch.models import transformer
    B, T = TRAIN_BATCH, MAX_SEQ
    config.set("MXNET_TPU_OBS", 1 if obs_on else 0)
    sym = transformer.get_symbol(VOCAB, LAYERS, D_MODEL, HEADS, D_FF, T,
                                 attention="flash")
    mod = mt.mod.Module(sym, context=mt.gpu(0))
    marks, reports = {}, []

    def at_batch(p):
        if p.nbatch not in (OBS_WARM - 1, OBS_WARM + OBS_TIMED - 1):
            return
        token = mod._step_token()
        if token is not None:
            token.synchronize()
        if p.nbatch == OBS_WARM - 1:
            if obs_on:
                reports.append(mt.obs.report())
            marks["t0"] = time.perf_counter()
        else:
            marks["t1"] = time.perf_counter()
            if obs_on:
                reports.append(mt.obs.report())

    it = mt.io.NDArrayIter(x, y, batch_size=B)
    try:
        with profiler.counter_delta() as d:
            mod.fit(it, num_epoch=1, arg_params=init, force_init=True,
                    eval_metric=mt.metric.CrossEntropy(),
                    optimizer="sgd",
                    optimizer_params={"learning_rate": TRAIN_LR},
                    batch_end_callback=at_batch)
        spans = d.get("obs_spans")
    finally:
        config.reset("MXNET_TPU_OBS")
    params = {n: a.data.clone() for n, a in mod.get_params()[0].items()}
    step_ms = (marks["t1"] - marks["t0"]) * 1e3 / OBS_TIMED
    return mod, params, step_ms, reports, spans


def obs_fit(torch, np, mt, out, kernels_counted):
    """19c: fit of phase 6's LM (amp bf16) with obs on and off from the
    same weights: MFU against the independent count and rate, the
    trace's lanes and batch flows, bit-for-bit parameters, no span with
    obs off."""
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.obs import mfu
    B, T = TRAIN_BATCH, MAX_SEQ
    n = OBS_WARM + OBS_TIMED
    rng = np.random.RandomState(SEED + 190)
    x = rng.randint(0, VOCAB, (n * B, T)).astype(np.float32)
    y = rng.randint(0, VOCAB, (n * B, T)).astype(np.float32)
    init = {k: mt.nd.NDArray(v.to(DEVICE))
            for k, v in lm_xavier(torch, np).items()}
    profiler.set_config(filename=str(out / "fit_trace.json"))
    profiler.dump()
    mt.amp.init("bfloat16")
    try:
        for fn in kernels_counted.values():
            fn.launches = {"f32": 0, "bf16": 0}
        mod, on_params, on_ms, reports, on_spans = obs_fit_once(
            torch, np, mt, init, x, y, obs_on=True)
        launches = {k: dict(fn.launches)
                    for k, fn in kernels_counted.items()}
        events, lanes = load_trace(profiler.dump())
        _, off_params, off_ms, _, off_spans = obs_fit_once(
            torch, np, mt, init, x, y, obs_on=False)
    finally:
        mt.amp.off()
    rec = [r for r in reports[-1]["executors"]
           if r["name"] == mod._obs_label]
    check(len(reports) == 2 and len(rec) == 1, "19c: report() did not "
          "list the module: %s" % [r["name"] for r in
                                   reports[-1]["executors"]])
    rec = rec[0]
    n_params = transformer.param_count(VOCAB, LAYERS, D_MODEL, HEADS, D_FF,
                                       T)
    n_embed = VOCAB * D_MODEL + T * D_MODEL
    palm = (6 * (n_params - n_embed) + 12 * LAYERS * D_MODEL * T) * B * T
    independent = 1e3 / on_ms
    flops_err = abs(rec["flops_per_step"] / palm - 1.0)
    rate_err = abs(rec["steps_per_sec"] / independent - 1.0)
    mfu_want = rec["flops_per_sec"] / PEAK_BF16_FLOPS
    gauge = reports[-1]["gauges"].get("obs_mfu")
    n_batches = batch_flows(events, lanes)
    differ = [k for k in on_params
              if not torch.equal(on_params[k], off_params[k])]
    log("19c fit of the LM (amp bf16, batch %d x T %d) with obs on: %d "
        "steps; report(): %.6g steps/s against %.6g timed independently "
        "(%.4f apart, limit %g); %.6g FLOP a step by the cost model against "
        "%.6g by the PaLM count (%.5f apart, limit %g); %.6g FLOP/s, "
        "obs_mfu %.6g (peak %.4g for %r); lanes %s; %d batch flows cross "
        "prefetch/* -> place -> train -> metric; %d spans; launches %s"
        % (B, T, n, rec["steps_per_sec"], independent, rate_err,
           OBS_RATE_RTOL, rec["flops_per_step"], palm, flops_err,
           OBS_FLOPS_RTOL, rec["flops_per_sec"], rec["mfu"] or 0.0,
           rec["peak_flops"] or 0.0, mfu._device_kind(), sorted(lanes),
           n_batches, on_spans, launches))
    log("19c step time over the %d timed steps (CUDA events): obs on %.3f "
        "ms, obs off %.3f ms (%+.2f%%), one call; obs off recorded %d "
        "spans; parameters after the steps equal bit for bit: %s"
        % (OBS_TIMED, on_ms, off_ms, 100 * (on_ms / off_ms - 1), off_spans,
           not differ))
    check(flops_err <= OBS_FLOPS_RTOL, "19c: the cost model's %.6g FLOP a "
          "step is %.4f from the PaLM count %.6g" % (
              rec["flops_per_step"], flops_err, palm))
    check(rate_err <= OBS_RATE_RTOL, "19c: obs reads %.6g steps/s against "
          "%.6g timed independently" % (rec["steps_per_sec"], independent))
    if DEVICE.startswith("cuda"):
        check(rec["peak_flops"] == PEAK_BF16_FLOPS,
              "19c: obs resolves the peak %s for %r, not %g" % (
                  rec["peak_flops"], torch.cuda.get_device_name(0),
                  PEAK_BF16_FLOPS))
    if rec["peak_flops"]:
        check(rec["mfu"] == rec["flops_per_sec"] / rec["peak_flops"] and
              gauge == rec["mfu"] and
              abs(rec["mfu"] / mfu_want - 1.0) < 1e-12,
              "19c: obs_mfu %s (gauge %s) is not flops_per_sec / %g"
              % (rec["mfu"], gauge, PEAK_BF16_FLOPS))
    check(n_batches == n, "19c: %d batch flows for %d steps"
          % (n_batches, n))
    check(off_spans == 0, "19c: %d spans recorded with obs off" % off_spans)
    check(on_spans > 0, "19c: no span recorded with obs on")
    check(not differ, "19c: obs on and off trained other parameters: %s"
          % differ[:5])
    for name, c in launches.items():
        check(c["bf16"] == n * LAYERS and c["f32"] == 0,
              "19c: kernel %s launched %s times in %d steps x %d layers"
              % (name, c, n, LAYERS))
    del mod
    gc.collect()
    torch.cuda.empty_cache()
    return {"steps_per_sec": rec["steps_per_sec"],
            "independent_steps_per_sec": independent,
            "flops_per_step": rec["flops_per_step"], "palm_flops": palm,
            "flops_per_sec": rec["flops_per_sec"], "mfu": rec["mfu"],
            "step_ms_obs_on": on_ms, "step_ms_obs_off": off_ms}


def obs_compiles(mt, t_start, count_before):
    """19d: every compile record since ``t_start`` names its scope, and
    the counter moved once per record."""
    from mxnet_tpu_torch import profiler
    recs = [r for r in mt.obs.compiles.snapshot()
            if r["t_offset_s"] >= t_start]
    moved = profiler.get_counter("obs_compile_count") - count_before
    by = {}
    for r in recs:
        key = "%s/%s" % (r["scope"], r["source"])
        n, ms = by.get(key, (0, 0.0))
        by[key] = (n + 1, ms + r["bind_ms"])
    log("19d compile ring: %d records since 19a, obs_compile_count moved "
        "%d; by scope/source: %s" % (len(recs), moved, ", ".join(
            "%s %d (%.1f ms)" % (k, n, ms) for k, (n, ms) in sorted(
                by.items()))))
    check(recs and len(recs) < mt.obs.compiles.RING_CAPACITY,
          "19d: %d compile records (ring %d)" % (
              len(recs), mt.obs.compiles.RING_CAPACITY))
    check(all(r["scope"] is not None for r in recs),
          "19d: records without a scope: %s"
          % [r for r in recs if r["scope"] is None][:3])
    check(moved == len(recs), "19d: obs_compile_count moved %d for %d "
          "records" % (moved, len(recs)))
    return {"records": len(recs), "by_scope": {k: n for k, (n, _)
                                               in by.items()}}


# the child of 19e: the MLP of phase 18 through fit until it is killed
BLACKBOX_CHILD = """
import sys
sys.path.insert(0, %(root)r)
import numpy as np
import mxnet_tpu_torch as mt
ctx = mt.gpu(0) if %(cuda)r else mt.cpu()
rng = np.random.RandomState(0)
x = rng.randn(256, 64).astype(np.float32)
y = rng.randint(0, 10, 256).astype(np.float32)
data = mt.sym.Variable("data")
h = mt.sym.Activation(mt.sym.FullyConnected(data, num_hidden=128,
                                            name="fc1"), act_type="relu")
net = mt.sym.SoftmaxOutput(mt.sym.FullyConnected(h, num_hidden=10,
                                                 name="fc2"),
                           name="softmax")
mod = mt.mod.Module(net, context=ctx)
print("CHILD-READY", flush=True)
mod.fit(mt.io.NDArrayIter(x, y, 32), num_epoch=1000000, optimizer="sgd",
        optimizer_params={"learning_rate": 0.1})
"""


def obs_blackbox(out):
    """19e: a fit in a child process with the flight recorder armed,
    killed by SIGKILL after its third heartbeat; the CLI names rank 0
    dead and its merged timeline loads as a chrome trace."""
    import os
    import signal
    bbdir = out / "blackbox"
    bbdir.mkdir()
    # the checkout that holds this script and the package
    src = str(Path(__file__).resolve().parent)
    env = dict(os.environ, MXNET_TPU_OBS_BLACKBOX=str(bbdir),
               MXNET_TPU_OBS_BLACKBOX_FLUSH_SECS=str(OBS_BB_FLUSH_S),
               PYTHONPATH=src)
    env.pop("MXNET_TPU_FAULTS", None)
    code = BLACKBOX_CHILD % {"root": src, "cuda": DEVICE.startswith("cuda")}
    path = bbdir / "blackbox-p0.jsonl"
    child_log = out / "blackbox_child.log"
    with open(child_log, "w") as logf:
        proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                                cwd=str(out), stdout=logf,
                                stderr=subprocess.STDOUT)
    beats, header = 0, None
    try:
        deadline = time.monotonic() + OBS_BB_WAIT_S
        while time.monotonic() < deadline and proc.poll() is None:
            time.sleep(0.05)
            try:
                with open(path) as f:
                    header = json.loads(f.readline())
            except (OSError, ValueError):
                continue
            # the header counts the flushes before its own
            beats = int(header.get("counters", {}).get(
                "obs_blackbox_flush", 0)) + 1
            if beats >= OBS_BB_BEATS and \
                    header.get("flush_reason") == "periodic":
                break
    finally:
        alive = proc.poll() is None
        if alive:
            os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=60)
    check(alive and proc.returncode == -signal.SIGKILL,
          "19e: the child was not alive to kill (exit %s): %s"
          % (proc.returncode, child_log.read_text()[-2000:]))
    check(beats >= OBS_BB_BEATS, "19e: %d heartbeats in %d s" % (
        beats, OBS_BB_WAIT_S))
    cli = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.obs", "blackbox",
         str(bbdir)], cwd=src, env=env, capture_output=True, text=True,
        timeout=120)
    lines = [ln for ln in cli.stdout.splitlines()
             if ln.startswith("POD-BLACKBOX-VERDICT ")]
    check(cli.returncode == 0 and len(lines) == 1, "19e: the CLI exited %d:"
          " %s %s" % (cli.returncode, cli.stdout[-1000:],
                      cli.stderr[-1000:]))
    verdict = json.loads(lines[0].split(" ", 1)[1])
    with open(bbdir / "pod-timeline.json") as f:
        merged = json.load(f)["traceEvents"]
    with open(path) as f:
        ring = [json.loads(ln) for ln in f.read().splitlines()[1:]
                if ln.strip()]
    kinds = sorted({e.get("kind") for e in ring})
    log("19e flight recorder: the child killed after %d heartbeats (every "
        "%g s); its last window holds %d events of kinds %s; the CLI: "
        "dead %s, first dead %s, last event %s; merged timeline %d events"
        % (beats, OBS_BB_FLUSH_S, len(ring), kinds, verdict["dead"],
           verdict["first_dead"], json.dumps(verdict.get("last_event")),
           len(merged)))
    check(verdict["first_dead"] == 0 and verdict["dead"] == [0],
          "19e: the verdict %s does not name rank 0 dead" % verdict)
    check(isinstance(merged, list) and merged and all(
        isinstance(e, dict) and "ph" in e for e in merged),
          "19e: the merged timeline is not a chrome trace")
    check("span" in kinds, "19e: no span close in the window: %s" % kinds)
    return {"beats": beats, "events": len(ring), "merged": len(merged)}


def obs_phase(torch, np):
    """Phase 19: observability (A10a): a-f, 19a-c under
    MXNET_TPU_LOCKCHECK=warn."""
    import shutil
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import config, lockcheck, profiler
    from mxnet_tpu_torch.ops import flash_attention as fa
    t0 = time.perf_counter()
    out = ROOT / "build" / "phase19"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    counted = {"flash_attention_fwd_bf16": fa.flash_attention_fwd,
               "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
               "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv}
    snap = config.snapshot_overrides(["MXNET_TPU_LOCKCHECK",
                                      "MXNET_TPU_OBS"])
    config.set("MXNET_TPU_LOCKCHECK", "warn")
    lockcheck.reset_order_graph()
    readings = {}
    try:
        # 19f: the locks 19a-c create are witnessed from here on
        mt.obs.report()
        t_start = time.perf_counter() - profiler._t0
        count0 = profiler.get_counter("obs_compile_count")
        with profiler.counter_delta() as d:
            config.set("MXNET_TPU_OBS", 1)
            readings["19a"] = obs_generative(torch, np, mt, PHASE4)
            readings["19b"] = obs_inference(torch, np, mt, out)
            config.reset("MXNET_TPU_OBS")
            readings["19c"] = obs_fit(torch, np, mt, out, counted)
        readings["19d"] = obs_compiles(mt, t_start, count0)
        inversions = d.get("lockcheck_inversion")
        held = d.get("lockcheck_held_sync")
        # a deliberate fetch of a card tensor under a plain witnessed lock
        plain = lockcheck.Lock(name="phase19.plain")
        allowed = lockcheck.Lock(name="phase19.allow_sync", allow_sync=True)
        arr = mt.nd.array(np.arange(8, dtype=np.float32), ctx=mt.gpu(0))
        with profiler.counter_delta() as d2:
            with allowed:
                arr.asnumpy()
            with plain:
                arr.asnumpy()
        deliberate = d2.get("lockcheck_held_sync")
    finally:
        config.restore_overrides(snap)
        lockcheck.reset_order_graph()
    log("19f lockcheck (warn) over 19a-c: %d inversions, %d host syncs "
        "under a witnessed lock; a deliberate asnumpy under a plain "
        "witnessed lock (and one under an allow_sync lock): %d"
        % (inversions, held, deliberate))
    check(inversions == 0, "19f: %d lock-order inversions" % inversions)
    check(held == 0, "19f: %d host syncs under witnessed locks in 19a-c"
          % held)
    check(deliberate == 1, "19f: the deliberate held sync counted %d"
          % deliberate)
    readings["19e"] = obs_blackbox(out)
    shutil.rmtree(out, ignore_errors=True)
    log("19 observability: %.1f s; %s" % (time.perf_counter() - t0,
                                          json.dumps(readings)))
    return readings


# ------------------------------------- phase 20: the rest of analysis/

# phase 20, the analyzer (A10b), on the LM at bench.py's width (flash,
# amp bf16) and ResNet-50 at phase 8's configuration (amp bf16). (a)
# each bound under MXNET_TPU_ANALYZE=strict with the card's 80 GB as the
# budget, one real step beside the hbm-budget estimate, then a budget of
# half the estimate, which must refuse the bind before it allocates; (b)
# the counted cost of one training step of each against the cost model
# (within the roofline's FLOP_MODEL_DRIFT_TOL, the flash kernels counted
# by their launches), and the report's roofline block after a short fit;
# (c) the program passes over the LM's traced training graph; (d) the
# CLI in three processes on the card's host
ANALYSIS_BUDGET = "80G"
ANALYSIS_FIT_WARM, ANALYSIS_FIT_TIMED = 2, 3
ANALYSIS_CONST = (4096, 4096)    # 64 MiB of f32: baked-const's ERROR bound
ANALYSIS_CLI = (
    ("lint", "--baseline", "mxnet_tpu_torch/tools/analysis_baseline.json",
     "mxnet_tpu_torch"),
    ("self-check",),
    ("audit", "mlp", "resnet8", "transformer"))
ANALYSIS_CLI_TIMEOUT_S = 300
ANALYSIS_DEADLINE_S = 600
# each flash op of the trace and the counting mode -> attention_bound's
FLASH_OPS = {"flash_attention_fwd": "fwd", "flash_attention_bwd_dq": "dq",
             "flash_attention_bwd_dkv": "dkv"}


def analysis_lm(mt):
    """The LM's symbol, its input shapes and one seeded batch on the
    card (ids as float32, bench.py's)."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.models import transformer
    B, T = TRAIN_BATCH, MAX_SEQ
    sym = transformer.get_symbol(VOCAB, LAYERS, D_MODEL, HEADS, D_FF, T,
                                 attention="flash")
    rng = np.random.RandomState(SEED + 200)
    dev = torch.device(DEVICE)
    db = mt.io.DataBatch(
        data=[mt.nd.array(rng.randint(0, VOCAB, (B, T)).astype(np.float32),
                          ctx=dev)],
        label=[mt.nd.array(rng.randint(0, VOCAB, (B, T)).astype(np.float32),
                           ctx=dev)])
    return sym, {"data": (B, T), "softmax_label": (B, T)}, db


def analysis_resnet(mt):
    """ResNet-50 at phase 8's configuration, its input shapes and one
    seeded batch on the card."""
    import torch
    from mxnet_tpu_torch.models import resnet
    B, S = RESNET_BATCH, RESNET_IMAGE
    sym = resnet.get_symbol(num_classes=RESNET_CLASSES,
                            num_layers=RESNET_LAYERS, stem="s2d",
                            image_shape="3,%d,%d" % (S, S))
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(SEED + 201)
    x = torch.randn(B, 3, S, S, generator=g, device=dev)
    y = torch.randint(0, RESNET_CLASSES, (B,), generator=g,
                      device=dev).float()
    db = mt.io.DataBatch(data=[mt.nd.NDArray(x)], label=[mt.nd.NDArray(y)])
    return sym, {"data": (B, 3, S, S), "softmax_label": (B,)}, db


def analysis_bind(torch, mt, what, sym, shapes, db, lr):
    """20a for one net (amp set by the caller): the bind's seconds with
    the analyzer off and under strict, the strict bind's findings (none
    may be an ERROR), the hbm-budget estimate beside the peak of one real
    training step, then the refusal at half the estimate with the card's
    allocated bytes unchanged. Returns the strictly bound module (its
    parameters constant, its SGD optimizer set) and the readings."""
    from mxnet_tpu_torch import analysis, config, profiler
    from mxnet_tpu_torch.base import MXNetError

    def bind():
        mod = mt.mod.Module(sym, context=mt.gpu(0))
        mod.bind(data_shapes=[("data", shapes["data"])],
                 label_shapes=[("softmax_label", shapes["softmax_label"])])
        return mod

    def settle():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    config.set("MXNET_TPU_ANALYZE", "off")
    for _ in range(2):      # the first bind of a symbol pays one-time costs
        settle()
        t0 = time.perf_counter()
        mod = bind()
        torch.cuda.synchronize()
        off_s = time.perf_counter() - t0
        del mod
    settle()
    config.set("MXNET_TPU_ANALYZE", "strict")
    config.set("MXNET_TPU_ANALYZE_HBM_BUDGET", ANALYSIS_BUDGET)
    with profiler.counter_delta() as d:
        t0 = time.perf_counter()
        mod = bind()
        torch.cuda.synchronize()
        on_s = time.perf_counter() - t0
    fired = {k: v for k, v in d.all().items() if k.startswith("analysis_")}
    # the report the strict bind enforced, again, for its numbers
    b_shapes, b_dtypes = mod._exec._bound_shapes_dtypes()
    rep = analysis.check_bind(sym, b_shapes, b_dtypes, mode="strict")
    est = int(rep.extras["cost"]["peak_bytes"])
    fits = rep.extras["hbm_budget"]["fits"]
    mod.init_params(mt.init.Constant(0.01))
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": lr})
    settle()
    torch.cuda.reset_peak_memory_stats()
    mod._fit_step(db)
    torch.cuda.synchronize()
    step_peak = int(torch.cuda.max_memory_allocated())
    # half the estimate: the bind is refused before it allocates
    config.set("MXNET_TPU_ANALYZE_HBM_BUDGET", str(est // 2))
    half = analysis.analyze_symbol(sym, input_shapes=b_shapes,
                                   input_dtypes=b_dtypes,
                                   calibrate_remat=False)
    offenders = [o["name"] for o in half.extras["hbm_budget"]["offenders"]]
    settle()
    before = int(torch.cuda.memory_allocated())
    refused = None
    try:
        bind()
    except MXNetError as exc:
        refused = str(exc)
    after = int(torch.cuda.memory_allocated())
    config.set("MXNET_TPU_ANALYZE_HBM_BUDGET", ANALYSIS_BUDGET)
    log("20a %s: bind %.3f s with the analyzer off, %.3f s under strict "
        "(findings by code %s; %d ERROR); the hbm-budget estimate %.3f GB "
        "(%s budget: fits %s), the peak of one real training step %.3f GB "
        "(torch.cuda.max_memory_allocated); at half the estimate (%.3f GB) "
        "the bind is refused: %s; largest offenders %s; allocated %d bytes "
        "before, %d after"
        % (what, off_s, on_s, fired, len(rep.errors), est / 1e9,
           ANALYSIS_BUDGET, fits, step_peak / 1e9, est / 2e9,
           refused is not None, offenders[:3], before, after))
    check(not rep.errors and fits, "20a %s: the strict bind's analysis has "
          "%d ERROR findings: %s" % (what, len(rep.errors),
                                     [f.format() for f in rep.errors]))
    check(refused is not None and "hbm-budget" in refused
          and offenders and offenders[0] in refused,
          "20a %s: half the estimate did not refuse the bind naming %s: %s"
          % (what, offenders[:1], refused))
    check(before == after, "20a %s: the refused bind left %d bytes "
          "allocated, %d before" % (what, after, before))
    return mod, {"bind_off_s": off_s, "bind_strict_s": on_s,
                 "estimate_bytes": est, "step_peak_bytes": step_peak,
                 "findings": fired, "refused": refused is not None}


def analysis_roofline(torch, mt, what, mod, db, counted):
    """20b for one net: the counted cost of one training step
    (``roofline.analyze_executable`` over ``Module._fit_step``) against
    the cost model's training count, the flash kernels' share held to
    their launches x their own per-launch FLOPs (attention_bound's
    formula), and the classification on the card's row."""
    from mxnet_tpu_torch.analysis import roofline
    from mxnet_tpu_torch.obs import mfu
    model = mfu.TRAIN_FLOP_MULTIPLIER * \
        float(mod.analyze().extras["cost"]["flops"])
    before = {k: dict(fn.launches) for k, fn in counted.items()}
    t0 = time.perf_counter()
    rep = roofline.analyze_executable(mod._fit_step, db, model_flops=model,
                                      context=what)
    torch.cuda.synchronize()
    count_s = time.perf_counter() - t0
    roof = rep.extras["roofline"]
    bh, d = TRAIN_BATCH * HEADS, D_MODEL // HEADS
    share = 0
    for op, rec in roof["flash"].items():
        per = attention_bound(FLASH_OPS[op], bh, MAX_SEQ, MAX_SEQ, d, True,
                              2)[2]
        launched = counted[op].launches["bf16"] - before[op]["bf16"]
        check(rec["flops"] == rec["launches"] * per
              and rec["launches"] == launched,
              "20b %s: %s counted %d FLOP over %d launches (the wrapper "
              "counted %d), not %d a launch" % (what, op, rec["flops"],
                                                rec["launches"], launched,
                                                per))
        share += rec["flops"]
    drift = [f for f in rep if f.code == "flop-model-drift"]
    log("20b %s: one training step counted in %.2f s: %.6g FLOP over %d "
        "ops against the cost model's %.6g (ratio %.4f, limit 1 +- %g); "
        "%.6g bytes; the flash kernels %s = %.6g FLOP (%.2f%%); %s-bound, "
        "intensity %s FLOP/byte against the balance %s, attainable MFU %s "
        "(peak %s, HBM %s GB/s)"
        % (what, count_s, roof["compiled_flops"], roof["ops"], model,
           roof["model_ratio"], roofline.FLOP_MODEL_DRIFT_TOL,
           roof["compiled_bytes_accessed"], roof["flash"], share,
           100 * share / roof["compiled_flops"], roof.get("bound"),
           roof.get("intensity_flops_per_byte"),
           roof.get("balance_flops_per_byte"), roof.get("attainable_mfu"),
           roof.get("peak_flops"), roof.get("hbm_gbps")))
    check(abs(roof["model_ratio"] - 1.0) <= roofline.FLOP_MODEL_DRIFT_TOL
          and not drift, "20b %s: counted %.6g FLOP against the model's "
          "%.6g" % (what, roof["compiled_flops"], model))
    if DEVICE.startswith("cuda"):
        check(roof.get("hbm_gbps") == 3350.0
              and roof.get("peak_flops") == PEAK_BF16_FLOPS,
              "20b %s: classify read peak %s, HBM %s for %r" % (
                  what, roof.get("peak_flops"), roof.get("hbm_gbps"),
                  torch.cuda.get_device_name(0)))
    return {"counted_flops": roof["compiled_flops"], "model_flops": model,
            "ratio": roof["model_ratio"], "flash_flops": share,
            "flash": roof["flash"], "bytes": roof["compiled_bytes_accessed"],
            "bound": roof.get("bound"),
            "attainable_mfu": roof.get("attainable_mfu"), "count_s": count_s}


def analysis_report(torch, mt, mod, db):
    """20b: a short fit of the LM module; the second ``mt.obs.report()``
    carries its roofline block, ``measured_mfu`` the report's MFU."""
    B, T = TRAIN_BATCH, MAX_SEQ
    n = ANALYSIS_FIT_WARM + ANALYSIS_FIT_TIMED
    reports = []

    def at_batch(p):
        if p.nbatch in (ANALYSIS_FIT_WARM - 1, n - 1):
            token = mod._step_token()
            if token is not None:
                token.synchronize()
            reports.append(mt.obs.report())

    mod.fit(RepeatIter(db, n, (B, T), (B, T)), num_epoch=1,
            batch_end_callback=at_batch,
            eval_metric=mt.metric.CrossEntropy(), optimizer="sgd",
            optimizer_params={"learning_rate": TRAIN_LR})
    recs = [r for r in reports[-1]["executors"]
            if r["name"] == mod._obs_label]
    check(len(reports) == 2 and len(recs) == 1, "20b: report() did not "
          "list the module")
    rec = recs[0]
    roof = rec.get("roofline") or {}
    gauge = reports[-1]["gauges"].get("obs_mfu")
    log("20b report() after a fit of %d steps: mfu %s (obs_mfu %s), "
        "roofline %s" % (n, rec["mfu"], gauge, json.dumps(roof)))
    want = ("bound", "attainable_mfu", "measured_mfu", "why")
    check(all(k in roof for k in want), "20b: the roofline block lacks %s"
          % [k for k in want if k not in roof])
    check(roof["measured_mfu"] == round(rec["mfu"], 4) and gauge == rec["mfu"],
          "20b: measured_mfu %s is not obs_mfu %s" % (roof["measured_mfu"],
                                                      gauge))
    return roof


def analysis_program(torch, mod):
    """20c: the program passes over the LM executor's training graph (the
    forward and its gradients), traced on fake tensors: no ERROR, each
    flash kernel a node, once per layer in each direction; then a
    deliberate 64 MiB closure constant and a deliberate ``.item()``,
    each of which must fire its finding."""
    from mxnet_tpu_torch.analysis import (analyze_graph, analyze_program,
                                          analyze_program_memory,
                                          program_passes)
    ex = mod._exec
    dev = torch.device(DEVICE)
    wrt = list(ex._wrt)
    args = {n: a.data.detach().requires_grad_(n in wrt)
            for n, a in ex.arg_dict.items()}
    aux = {n: a.data for n, a in ex.aux_dict.items()}

    def step(a, x):
        outs, _ = ex._fn(a, x, True, dev)
        return torch.autograd.grad(outs, [a[n] for n in wrt],
                                   [torch.ones_like(o) for o in outs])

    t0 = time.perf_counter()
    gm, n_args = program_passes.trace(step, args, aux)
    trace_s = time.perf_counter() - t0
    rep = analyze_graph(gm, n_args=n_args, context="lm-train")
    mem = analyze_program_memory(gm).extras["program_memory"]
    ops = rep.extras["program"]["ops"]
    flash = {op: ops.get("mxnet_tpu_torch.%s.default" % op, 0)
             for op in FLASH_OPS}
    big = torch.ones(ANALYSIS_CONST, device=dev)
    x = torch.ones(8, ANALYSIS_CONST[0], device=dev)
    baked = [f for f in analyze_program(lambda v: v @ big, x)
             if f.code == "baked-const"]
    synced = [f for f in analyze_program(lambda v: v * v.sum().item(), x)
              if f.code == "host-callback"]
    del big, x
    log("20c program passes over the LM's training graph (traced in %.2f s "
        "on fake tensors): %d nodes, findings %s; flash kernels as nodes "
        "%s; activation high-water %.3f GB (+%.3f GB arguments); a 64 MiB "
        "closure constant: %s; an .item(): %s"
        % (trace_s, rep.extras["program"]["nodes"],
           [(f.code, f.severity.name) for f in rep], flash,
           mem["activation_peak_bytes"] / 1e9, mem["arg_bytes"] / 1e9,
           [(f.code, f.severity.name, f.detail["nbytes"]) for f in baked],
           [(f.code, f.detail["primitive"]) for f in synced]))
    check(not rep.errors, "20c: ERROR findings on the LM's graph: %s"
          % [f.format() for f in rep.errors])
    check(all(v == LAYERS for v in flash.values()), "20c: flash kernels as "
          "nodes %s, %d layers" % (flash, LAYERS))
    check(len(baked) == 1 and baked[0].severity.name == "ERROR"
          and baked[0].detail["nbytes"] == 4 * ANALYSIS_CONST[0]
          * ANALYSIS_CONST[1], "20c: the 64 MiB constant: %s" % baked)
    check(len(synced) == 1 and synced[0].detail["primitive"]
          == "aten._local_scalar_dense.default",
          "20c: the .item(): %s" % synced)
    return {"trace_s": trace_s, "nodes": rep.extras["program"]["nodes"],
            "flash_nodes": flash,
            "activation_peak_bytes": mem["activation_peak_bytes"]}


def analysis_cli_start():
    """20d, started: ``lint --baseline`` over the port, ``self-check``
    and ``audit mlp resnet8 transformer`` as processes of their own,
    all at once (they run beside 20a-c: small nets, their own
    allocators). Returns the start time and the processes."""
    on_card = DEVICE.startswith("cuda")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    procs = []
    for cmd in ANALYSIS_CLI:
        argv = list(cmd)
        if not on_card and cmd[0] in ("self-check", "audit"):
            argv.append("--cpu")
        procs.append((argv, subprocess.Popen(
            [sys.executable, "-m", "mxnet_tpu_torch.analysis"] + argv,
            cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    return t0, procs


def analysis_cli(torch, started):
    """20d, finished: each command must exit 0, and each audit's
    roofline line must name this device and not be unknown."""
    on_card = DEVICE.startswith("cuda")
    t0, procs = started
    out = {}
    for argv, proc in procs:
        try:
            text, _ = proc.communicate(timeout=ANALYSIS_CLI_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        out[argv[0]] = (proc.returncode, text)
    wall = time.perf_counter() - t0
    for name, (rc, text) in out.items():
        log("20d python -m mxnet_tpu_torch.analysis %s: exit %d\n%s"
            % (name, rc, "\n".join("    " + ln
                                    for ln in text.strip().splitlines()
                                    if not ln.startswith("WARNING"))))
        check(rc == 0, "20d: %s exited %d" % (name, rc))
    roof_lines = [ln for ln in out["audit"][1].splitlines()
                  if ln.strip().startswith("roofline:")]
    where = torch.cuda.get_device_name(0) if on_card else "the host CPU"
    check(len(roof_lines) == 3 and all(
        where in ln and "unknown" not in ln for ln in roof_lines)
          if on_card else len(roof_lines) == 3,
          "20d: the audit's roofline lines do not read %s: %s"
          % (where, roof_lines))
    log("20d: three commands in %.1f s (started together, beside 20a-c)"
        % wall)
    return {"wall_s": wall, "exit": {k: v[0] for k, v in out.items()}}


def analysis_phase(torch, np):
    """Phase 20: the rest of analysis/ (A10b): 20a-20d."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import config
    from mxnet_tpu_torch.ops import flash_attention as fa
    t0 = time.perf_counter()
    counted = {"flash_attention_fwd": fa.flash_attention_fwd,
               "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
               "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv}
    snap = config.snapshot_overrides(["MXNET_TPU_ANALYZE",
                                      "MXNET_TPU_ANALYZE_HBM_BUDGET"])
    readings = {}
    cli = analysis_cli_start()
    try:
        mt.amp.init("bfloat16")
        try:
            sym, shapes, db = analysis_lm(mt)
            mod, readings["20a lm"] = analysis_bind(torch, mt, "LM", sym,
                                                    shapes, db, TRAIN_LR)
            config.set("MXNET_TPU_ANALYZE", "off")
            readings["20b lm"] = analysis_roofline(torch, mt, "LM", mod, db,
                                                   counted)
            readings["20b report"] = analysis_report(torch, mt, mod, db)
            readings["20c"] = analysis_program(torch, mod)
            del mod, db
            gc.collect()
            torch.cuda.empty_cache()
            sym, shapes, db = analysis_resnet(mt)
            mod, readings["20a resnet"] = analysis_bind(
                torch, mt, "ResNet-50", sym, shapes, db, RESNET_LR)
            config.set("MXNET_TPU_ANALYZE", "off")
            readings["20b resnet"] = analysis_roofline(
                torch, mt, "ResNet-50", mod, db, counted)
            check(not readings["20b resnet"]["flash"], "20b ResNet-50: "
                  "flash kernels counted %s"
                  % readings["20b resnet"]["flash"])
            del mod, db
            gc.collect()
            torch.cuda.empty_cache()
        finally:
            mt.amp.off()
            config.restore_overrides(snap)
        readings["20d"] = analysis_cli(torch, cli)
    finally:
        for _, proc in cli[1]:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    log("20 analysis: %.1f s; %s" % (time.perf_counter() - t0,
                                     json.dumps(readings, default=str)))
    return readings


# ------------------------- phase 21: the legacy surface, the tools, fleet

# phase 21 (A10c and the serving fleet of A10d). (a) two MLPs of upstream
# MXNet's example/numpy-ops shape through Module.fit on the card and on
# the host from the same numpy weights: one with a NumpyOp softmax head,
# one with an NDArrayOp scale layer; (b) test_utils.check_consistency
# over the host and the card for a ResNet-50 unit and the LM's attention
# block (K1 f32 on the card against its plain version on the host), and
# check_numeric_gradient of a small symbol on the card; (c) the tools:
# the LeNet prototxt and a .caffemodel encoded here through
# caffe_converter, the converter's reference-format .params through
# convert_params into a Module on the card, parse_log over 21a's log;
# (d) the fleet drill: a Gateway over three GenerativeServer replica
# processes on the card, rank 1 killed mid-stream, against one server
LEGACY_MLP = (784, 128, 64, 10)
LEGACY_BATCH, LEGACY_EXAMPLES, LEGACY_EPOCHS, LEGACY_LR = 100, 1000, 3, 0.1
LEGACY_SCALE = 0.5       # the NDArrayOp layer's factor
# each epoch's cross-entropy (a float64 numpy forward of the epoch's
# weights), card against host: 30 SGD steps of f32 sums in another order
LEGACY_CE_ATOL = 1e-4
# check_consistency, card against host (TF32 off): f32 sums in another
# order over a 2304-term convolution and a 8192-wide MLP
CONSISTENCY_RTOL, CONSISTENCY_ATOL = 1e-4, 1e-4
UNIT_SHAPE = (8, 64, 56, 56)    # ResNet-50's stage-1 first unit input
BLOCK_BATCH = 2                 # the LM block at (2, MAX_SEQ, D_MODEL)
CAFFE_ATOL = 1e-5               # the LeNet forward, card against host
# the fleet: phase 4's LM cut to 4 of its 12 layers, to make room for
# phase 22 (each process draws its weights with numpy, as the
# reference's replicas do: ~15 s at 12 layers)
FLEET_LAYERS, FLEET_SLOTS, FLEET_SEED, FLEET_REPLICAS = 4, 4, 11, 3
FLEET_FAULT = "1:replica.die@6:hostkill"
FLEET_BACKOFF = 0.2
FLEET_STATS_PERIOD = 0.2
FLEET_SPAWN_WAIT_S = 300
# a hung replica, gateway or client ends the run through faulthandler
FLEET_DEADLINE_S = 600

LENET_PROTOTXT = """
name: "LeNet"
layer { name: "data" type: "Input" top: "data"
  input_param { shape { dim: 2 dim: 1 dim: 28 dim: 28 } } }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 8 kernel_size: 5 stride: 1 } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "relu1" }
layer { name: "pool1" type: "Pooling" bottom: "relu1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layer { name: "ip1" type: "InnerProduct" bottom: "pool1" top: "ip1"
  inner_product_param { num_output: 32 } }
layer { name: "relu2" type: "ReLU" bottom: "ip1" top: "relu2" }
layer { name: "ip2" type: "InnerProduct" bottom: "relu2" top: "ip2"
  inner_product_param { num_output: 10 } }
layer { name: "prob" type: "Softmax" bottom: "ip2" top: "prob" }
"""


def legacy_ops(np, mt, seen):
    """The two legacy ops: upstream's numpy-ops softmax head (a
    ``NumpyOp``) and a scale layer (an ``NDArrayOp``) that records the
    devices its inputs arrive on in ``seen``."""
    class NumpySoftmax(mt.operator.NumpyOp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]]

        def forward(self, in_data, out_data):
            x, y = in_data[0], out_data[0]
            y[:] = np.exp(x - x.max(axis=1, keepdims=True))
            y /= y.sum(axis=1, keepdims=True)

        def backward(self, out_grad, in_data, out_data, in_grad):
            lab = in_data[1].astype(int)
            dx = in_grad[0]
            dx[:] = out_data[0]
            dx[np.arange(lab.shape[0]), lab] -= 1.0

    class Scale(mt.operator.NDArrayOp):
        def forward(self, in_data, out_data):
            seen.update(str(a.data.device) for a in in_data)
            out_data[0][:] = in_data[0] * LEGACY_SCALE

        def backward(self, out_grad, in_data, out_data, in_grad):
            in_grad[0][:] = out_grad[0] * LEGACY_SCALE

    return NumpySoftmax(), Scale()


def legacy_net(mt, head, scale=None):
    """The MLP 784-128-64-10: a NumpyOp softmax ``head``, or
    ``SoftmaxOutput`` with the NDArrayOp ``scale`` after the first
    ReLU."""
    h = mt.sym.Variable("data")
    for i, n in enumerate(LEGACY_MLP[1:], 1):
        h = mt.sym.FullyConnected(h, num_hidden=n, name="fc%d" % i)
        if i < len(LEGACY_MLP) - 1:
            h = mt.sym.Activation(h, act_type="relu", name="relu%d" % i)
        if i == 1 and scale is not None:
            h = scale.get_symbol(h, name="scale")
    if head is not None:
        return head.get_symbol(h, mt.sym.Variable("softmax_label"),
                               name="softmax")
    return mt.sym.SoftmaxOutput(h, name="softmax")


def legacy_data(np):
    """Synthetic data from the seed (labels from a random linear
    teacher) and He-scaled initial weights."""
    rng = np.random.RandomState(SEED + 21)
    x = rng.randn(LEGACY_EXAMPLES, LEGACY_MLP[0]).astype(np.float32)
    teacher = rng.randn(LEGACY_MLP[0], LEGACY_MLP[-1]).astype(np.float32)
    y = (x @ teacher).argmax(1).astype(np.float32)
    w = {}
    for i, (a, b) in enumerate(zip(LEGACY_MLP[:-1], LEGACY_MLP[1:]), 1):
        w["fc%d_weight" % i] = (rng.randn(b, a) *
                                np.sqrt(2.0 / a)).astype(np.float32)
        w["fc%d_bias" % i] = np.zeros(b, np.float32)
    return x, y, w


def plain_mlp_ce(np, w, x, y, scale):
    """The MLP's mean cross-entropy in float64 numpy."""
    h = x.astype(np.float64)
    n = len(LEGACY_MLP) - 1
    for i in range(1, n + 1):
        h = h @ w["fc%d_weight" % i].T.astype(np.float64) + \
            w["fc%d_bias" % i]
        if i < n:
            h = np.maximum(h, 0.0)
        if i == 1 and scale:
            h = h * LEGACY_SCALE
    h = h - h.max(1, keepdims=True)
    logp = h - np.log(np.exp(h).sum(1, keepdims=True))
    return float(-logp[np.arange(len(y)), y.astype(int)].mean())


def legacy_fit(np, mt, net, ctx, x, y, w, scale, logger):
    """``Module.fit`` of ``net`` on ``ctx`` from ``w``: the cross-entropy
    after each epoch and the final weights."""
    curve = []

    def epoch_ce(epoch, sym, args, aux):
        curve.append(plain_mlp_ce(np, {k: v.asnumpy()
                                       for k, v in args.items()},
                                  x, y, scale))

    with ctx:
        it = mt.io.NDArrayIter(x, y, batch_size=LEGACY_BATCH,
                               label_name="softmax_label")
        mod = mt.mod.Module(net, context=ctx, logger=logger)
        mod.fit(it, optimizer="sgd",
                optimizer_params={"learning_rate": LEGACY_LR},
                arg_params={k: mt.nd.array(v, ctx=ctx)
                            for k, v in w.items()},
                num_epoch=LEGACY_EPOCHS, epoch_end_callback=epoch_ce,
                batch_end_callback=mt.callback.Speedometer(LEGACY_BATCH, 5))
        args, _ = mod.get_params()
    return curve, {k: v.asnumpy() for k, v in args.items()}


def legacy_phase(torch, np, mt, out):
    """21a: the NumpyOp and NDArrayOp nets through fit on the card and
    on the host; each card run's log goes to ``out/fit-<net>.log`` for
    21c."""
    import logging
    x, y, w = legacy_data(np)
    readings = {}
    for what in ("numpy-op head", "ndarray-op scale"):
        seen_host, seen_card = set(), set()
        scale = what == "ndarray-op scale"
        host_head, host_scale = legacy_ops(np, mt, seen_host)
        card_head, card_scale = legacy_ops(np, mt, seen_card)
        host_net = legacy_net(mt, None if scale else host_head,
                              host_scale if scale else None)
        card_net = legacy_net(mt, None if scale else card_head,
                              card_scale if scale else None)
        ce0 = plain_mlp_ce(np, w, x, y, scale)
        host, _ = legacy_fit(np, mt, host_net, mt.cpu(), x, y, w, scale,
                             logging.getLogger("phase21.host"))
        # the card's fit logs through the root logger, as Speedometer
        # does, into the file 21c reads back
        root = logging.getLogger()
        level = root.level
        handler = logging.FileHandler(out / ("fit-%s.log" % what[:5]))
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        t0 = time.perf_counter()
        try:
            card, _ = legacy_fit(np, mt, card_net, mt.gpu(0), x, y, w, scale,
                                 root)
        finally:
            root.removeHandler(handler)
            root.setLevel(level)
            handler.close()
        secs = time.perf_counter() - t0
        gap = max(abs(a - b) for a, b in zip(card, host))
        log("21a %s: cross-entropy %.6f at start, by epoch on the card %s, "
            "on the host %s; largest gap %.3g (limit %g); %.2f s on the "
            "card; scale inputs on %s" % (
                what, ce0, ["%.6f" % c for c in card],
                ["%.6f" % c for c in host], gap, LEGACY_CE_ATOL, secs,
                sorted(seen_card) or "-"))
        check(len(card) == len(host) == LEGACY_EPOCHS,
              "21a %s: %d / %d epochs" % (what, len(card), len(host)))
        check(gap <= LEGACY_CE_ATOL, "21a %s: the card's loss curve %s "
              "parts from the host's %s by %g" % (what, card, host, gap))
        check(card[-1] < ce0, "21a %s: the loss did not fall (%g -> %g)"
              % (what, ce0, card[-1]))
        if scale:
            check(seen_card == {str(torch.device(DEVICE))},
                  "21a: the NDArrayOp's inputs arrived on %s, not %s"
                  % (sorted(seen_card), DEVICE))
            check(seen_host == {"cpu"}, "21a: host inputs on %s"
                  % sorted(seen_host))
        readings[what] = {"ce0": ce0, "card": card, "gap": gap,
                          "card_s": secs}
    return readings


def consistency_phase(torch, np, mt):
    """21b: check_consistency over the host and the card for a ResNet-50
    unit and the LM's attention block; check_numeric_gradient of a small
    symbol on the card."""
    from mxnet_tpu_torch.models import resnet, transformer
    from mxnet_tpu_torch.ops import flash_attention as fa
    tu = mt.test_utils
    rng = np.random.RandomState(SEED + 22)
    ctxs = [mt.cpu(), mt.gpu(0)]
    readings = {}

    def draw(s, shapes, aux_shapes, data_shape):
        loc = {"data": rng.randn(*data_shape).astype(np.float32)}
        for n, shp in list(shapes.items()) + list(aux_shapes.items()):
            if n == "data":
                continue
            if n.endswith("_gamma"):
                v = 1.0 + 0.1 * rng.randn(*shp)
            elif n.endswith("_moving_var"):
                v = 0.5 + rng.rand(*shp)
            elif n.endswith(("_beta", "_bias", "_moving_mean")):
                v = 0.1 * rng.randn(*shp)
            else:
                fan_in = int(np.prod(shp[1:]))
                v = rng.randn(*shp) * np.sqrt(2.0 / fan_in)
            loc[n] = v.astype(np.float32)
        return loc

    def run(s, aux_names):
        def fn(**kw):
            aux = {n: kw.pop(n) for n in aux_names}
            return s.eval(aux_states=aux, **kw)[0]
        return fn

    with mt.name.NameManager():
        unit = resnet._unit_v2(mt.sym.Variable("data"), 256, (1, 1), False,
                               "stage1_unit1", True)
        block = transformer._block(mt.sym.Variable("data"), HEADS, D_MODEL,
                                   D_FF, MAX_SEQ, "layer0",
                                   attention="flash")
    cases = (("ResNet-50 unit", unit, UNIT_SHAPE),
             ("LM attention block", block,
              (BLOCK_BATCH, MAX_SEQ, D_MODEL)))
    for what, s, data_shape in cases:
        arg_s, _, aux_s = s.infer_shape(data=data_shape)
        loc = draw(s, dict(zip(s.list_arguments(), arg_s)),
                   dict(zip(s.list_auxiliary_states(), aux_s)), data_shape)
        fa.flash_attention_fwd.launches = {"f32": 0, "bf16": 0}
        t0 = time.perf_counter()
        outs = tu.check_consistency(run(s, s.list_auxiliary_states()), loc,
                                    ctx_list=ctxs, rtol=CONSISTENCY_RTOL,
                                    atol=CONSISTENCY_ATOL)
        secs = time.perf_counter() - t0
        counts = dict(fa.flash_attention_fwd.launches)
        err = float(np.abs(outs[1] - outs[0]).max())
        log("21b check_consistency %s: output %s, max_abs_err host / card "
            "%.3g (rtol %g, atol %g); K1 launches %s; %.2f s" % (
                what, outs[0].shape, err, CONSISTENCY_RTOL,
                CONSISTENCY_ATOL, counts, secs))
        if what == "LM attention block":
            check(counts["f32"] >= 1 and counts["bf16"] == 0,
                  "21b: K1 f32 did not run for the block: %s" % counts)
        else:
            check(counts == {"f32": 0, "bf16": 0}, "21b: the ResNet unit "
                  "launched attention %s" % counts)
        readings[what] = {"max_abs_err": err, "k1": counts}
    x = mt.sym.Variable("x")
    small = mt.sym.Activation(mt.sym.FullyConnected(x, num_hidden=3,
                                                    name="fc"),
                              act_type="tanh", name="act")
    loc = {"x": rng.randn(2, 4).astype(np.float32),
           "fc_weight": (rng.randn(3, 4) * 0.5).astype(np.float32),
           "fc_bias": (rng.randn(3) * 0.1).astype(np.float32)}
    tu.check_numeric_gradient(small, loc, ctx=mt.gpu(0))
    # and it must refuse a wrong gradient there
    wrong = mt.sym.Custom(mt.sym.Variable("x"), op_type="phase21_wrong")
    try:
        tu.check_numeric_gradient(wrong, {"x": loc["x"]}, ctx=mt.gpu(0))
    except AssertionError:
        refused = True
    else:
        refused = False
    log("21b check_numeric_gradient on %s: FullyConnected + tanh passes; "
        "a custom op with twice the gradient refused: %s"
        % (DEVICE, refused))
    check(refused, "21b: check_numeric_gradient passed a wrong gradient")
    return readings


def register_wrong_square(mt):
    """``phase21_wrong``: x * x with twice its gradient, for 21b."""
    @mt.operator.register("phase21_wrong")
    class Prop(mt.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            class Op(mt.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0], in_data[0] * in_data[0])

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0],
                                out_grad[0] * in_data[0] * 4.0)
            return Op()
    return Prop


def pb_varint(n: int) -> bytes:
    out = b""
    while True:
        b7, n = n & 0x7F, n >> 7
        out += bytes([b7 | (0x80 if n else 0)])
        if not n:
            return out


def pb_field(fno: int, wt: int, payload) -> bytes:
    key = pb_varint((fno << 3) | wt)
    if wt == 0:
        return key + pb_varint(payload)
    return key + pb_varint(len(payload)) + payload


def caffemodel_bytes(np, blobs) -> bytes:
    """A NetParameter of new-style layers (field 100: name 1, blobs 7),
    each BlobProto with its BlobShape (field 7) and packed floats
    (field 5): ``blobs`` maps a layer name to its arrays."""
    out = b""
    for name, arrays in blobs.items():
        msg = pb_field(1, 2, name.encode())
        for a in arrays:
            shape = pb_field(1, 2, b"".join(pb_varint(d) for d in a.shape))
            blob = pb_field(7, 2, shape) + pb_field(
                5, 2, np.asarray(a, "<f4").ravel().tobytes())
            msg += pb_field(7, 2, blob)
        out += pb_field(100, 2, msg)
    return out


def plain_lenet(np, w, x):
    """The LeNet deploy net in numpy (conv, ReLU, 2x2 max pool, two
    inner products, softmax)."""
    from numpy.lib.stride_tricks import sliding_window_view
    win = sliding_window_view(x, (5, 5), axis=(2, 3))[:, 0]
    conv = np.einsum("nhwij,ocij->nohw", win, w["conv1_weight"]) + \
        w["conv1_bias"][None, :, None, None]
    relu = np.maximum(conv, 0)
    n, c = relu.shape[:2]
    pool = relu.reshape(n, c, 12, 2, 12, 2).max((3, 5))
    h = np.maximum(pool.reshape(n, -1) @ w["ip1_weight"].T + w["ip1_bias"], 0)
    logits = h @ w["ip2_weight"].T + w["ip2_bias"]
    p = np.exp(logits - logits.max(1, keepdims=True))
    return p / p.sum(1, keepdims=True)


def tools_phase(torch, np, mt, out, fit_epochs):
    """21c: caffe_converter (LeNet, a .caffemodel encoded here) on the
    card against the host and numpy; convert_params of its
    reference-format .params into a Module on the card; parse_log of
    21a's fit log."""
    import io
    import contextlib
    from mxnet_tpu_torch.tools import caffe_converter, convert_params
    from mxnet_tpu_torch.tools import parse_log
    rng = np.random.RandomState(SEED + 23)
    w = {"conv1_weight": rng.randn(8, 1, 5, 5).astype(np.float32) * 0.1,
         "conv1_bias": rng.randn(8).astype(np.float32) * 0.1,
         "ip1_weight": rng.randn(32, 8 * 12 * 12).astype(np.float32) * 0.01,
         "ip1_bias": rng.randn(32).astype(np.float32) * 0.1,
         "ip2_weight": rng.randn(10, 32).astype(np.float32) * 0.1,
         "ip2_bias": rng.randn(10).astype(np.float32) * 0.1}
    proto = out / "lenet.prototxt"
    proto.write_text(LENET_PROTOTXT)
    model = out / "lenet.caffemodel"
    model.write_bytes(caffemodel_bytes(np, {
        "conv1": [w["conv1_weight"], w["conv1_bias"]],
        "ip1": [w["ip1_weight"], w["ip1_bias"]],
        "ip2": [w["ip2_weight"], w["ip2_bias"]]}))
    prefix = str(out / "lenet")
    said = io.StringIO()
    with contextlib.redirect_stdout(said), mt.name.NameManager():
        rc = caffe_converter.main([str(proto), prefix, "--caffemodel",
                                   str(model)])
    check(rc == 0 and "parsed 6 parameter tensors" in said.getvalue(),
          "21c: caffe_converter said %r" % said.getvalue())
    x = rng.rand(2, 1, 28, 28).astype(np.float32)
    shapes = {"data": (2, 1, 28, 28)}
    files = (prefix + "-symbol.json", prefix + "-0000.params")
    card = mt.Predictor(*files, shapes, ctx=mt.gpu(0)).forward(data=x)[0]
    check(card.data.device == torch.device(DEVICE), "21c: the predictor "
          "ran on %s" % card.data.device)
    card = card.asnumpy()
    host = mt.Predictor(*files, shapes, ctx=mt.cpu()).forward(
        data=x)[0].asnumpy()
    want = plain_lenet(np, w, x)
    err_host = float(np.abs(card - host).max())
    err_np = float(np.abs(card - want).max())
    log("21c caffe_converter: LeNet prototxt + a .caffemodel of %d bytes; "
        "the forward on the card against the host %.3g (limit %g), "
        "against numpy %.3g" % (model.stat().st_size, err_host, CAFFE_ATOL,
                                err_np))
    check(err_host <= CAFFE_ATOL, "21c: card and host forwards part by %g"
          % err_host)
    check(err_np <= 1e-4, "21c: the forward parts from numpy by %g" % err_np)
    # the converter's reference-format .params through convert_params
    npz = str(out / "lenet.npz")
    with contextlib.redirect_stdout(said):
        rc = convert_params.main([files[1], npz, "--strip-prefix"])
    check(rc == 0, "21c: convert_params exited %d" % rc)
    loaded = mt.nd.load(npz, ctx=mt.gpu(0))
    mod = mt.mod.Module(mt.sym.load(files[0]), context=mt.gpu(0))
    mod.bind(data_shapes=[("data", shapes["data"])],
             label_shapes=[("softmax_label", (2,))], for_training=False)
    mod.set_params({k: v for k, v in loaded.items()
                    if k in mod._param_names}, {})
    mod.forward(mt.io.DataBatch(data=[mt.nd.array(x, ctx=mt.gpu(0))]),
                is_train=False)
    got = mod.get_outputs()[0].asnumpy()
    err_mod = float(np.abs(got - card).max())
    log("21c convert_params: %d arrays into a Module on %s; its forward "
        "against the predictor's %.3g" % (len(loaded), DEVICE, err_mod))
    check(sorted(loaded) == sorted(w), "21c: converted names %s"
          % sorted(loaded))
    check(err_mod <= CAFFE_ATOL, "21c: the Module's forward parts by %g"
          % err_mod)
    epochs = []
    for path in sorted(out.glob("fit-*.log")):
        rows = parse_log.parse(path.read_text().splitlines())
        log("21c parse_log of 21a's %s: %s" % (path.name, json.dumps(rows)))
        check(sorted(rows) == list(range(fit_epochs)) and all(
            {"train-accuracy", "time", "speed"} <= set(r)
            for r in rows.values()), "21c: parse_log read %s" % rows)
        epochs.append(len(rows))
    check(len(epochs) == 2, "21c: %d fit logs" % len(epochs))
    return {"card_vs_host": err_host, "card_vs_numpy": err_np,
            "module": err_mod, "epochs": epochs}


class FleetWatch:
    """Polls a gateway's replica states from a thread and stamps each
    change: ``events`` lists ``(seconds, rank, generation, state)``."""

    def __init__(self, gw, t0):
        self.gw, self.t0, self.events = gw, t0, []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        last = {}
        while not self._stop.is_set():
            for r in self.gw.stats()["replicas"]:
                key = (r["generation"], r["state"])
                if last.get(r["rank"]) != key:
                    last[r["rank"]] = key
                    self.events.append((time.perf_counter() - self.t0,
                                        r["rank"]) + key)
            time.sleep(0.05)

    def first(self, rank, generation, state):
        for t, r, g, s in self.events:
            if (r, g, s) == (rank, generation, state):
                return t
        return None

    def stop(self):
        self._stop.set()
        self._thread.join(10)


def gpu_memory_used_mib():
    """The card's memory in use, all processes, from ``nvidia-smi``."""
    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=memory.used",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=30)
    return int(smi.stdout.strip().splitlines()[0])


class MemorySampler:
    """The largest ``gpu_memory_used_mib`` over a window, sampled every
    half second from a thread."""

    def __init__(self):
        self.peak = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            self.peak = max(self.peak, gpu_memory_used_mib())
            self._stop.wait(0.5)

    def stop(self):
        self._stop.set()
        self._thread.join(30)
        return self.peak


def fleet_wave(gw, prompts):
    gw.latency.reset()
    t0 = time.perf_counter()
    handles = [gw.submit_generate(p, max_new_tokens=NEW_TOKENS)
               for p in prompts]
    outs = [h.result(timeout=600) for h in handles]
    return outs, time.perf_counter() - t0


def fleet_streams(torch, what, params, prompts, got, want):
    """Each fleet stream against the single server's. A stream that
    differs is teacher-forced through a plain forward: the top-2 logit
    gap at its first differing token must lie within LOGITS_ATOL (a
    near-tie; above it, the fail-over is at fault), and then every token
    it emitted must lie within LOGITS_ATOL of its row's maximum. Returns
    the near-ties found."""
    ties = []
    for p, g, w in zip(prompts, got, want):
        if g == w:
            continue
        check(len(g) == len(w) == NEW_TOKENS, "21d %s: stream lengths %d "
              "and %d" % (what, len(g), len(w)))
        i = next(j for j in range(NEW_TOKENS) if g[j] != w[j])
        p = [int(t) for t in p]
        top = plain_logits(torch, params, p + w[:i], FLEET_LAYERS).topk(2)
        gap = float(top.values[0] - top.values[1])
        worst = 0.0
        for j, tok in enumerate(g):
            row = plain_logits(torch, params, p + g[:j], FLEET_LAYERS)
            worst = max(worst, float(row.max() - row[tok]))
        tie = {"prompt": len(p), "token": i, "fleet": g[i], "single": w[i],
               "top2_gap": gap, "worst_emitted_gap": worst}
        log("21d %s: the prompt of %d tokens parts at token %d (%d against "
            "%d): top-2 logit gap %.3g there, worst emitted token %.3g "
            "below its row's maximum" % (what, len(p), i, g[i], w[i], gap,
                                         worst))
        check(gap <= LOGITS_ATOL, "21d %s: a stream parts from the single "
              "server's with a top-2 gap of %g > %g: %s"
              % (what, gap, LOGITS_ATOL, tie))
        check(worst <= LOGITS_ATOL, "21d %s: an emitted token lies %g below "
              "its row's maximum: %s" % (what, worst, tie))
        ties.append(tie)
    return ties


def check_replica_k1(rank, k1, requests):
    """A replica process launched K1 f32 once per prefill per layer (its
    requests, redispatches included), and never K1 bf16."""
    check(k1["f32"] == requests * FLEET_LAYERS and k1["bf16"] == 0,
          "21d: rank %d launched K1 %s for %d prefills x %d layers"
          % (rank, k1, requests, FLEET_LAYERS))


def fleet_spec():
    geo = {"vocab_size": VOCAB, "num_layers": FLEET_LAYERS,
           "d_model": D_MODEL, "n_heads": HEADS, "d_ff": D_FF,
           "seq_len": MAX_SEQ}
    spec = {"kind": "transformer", "geo": geo, "seed": FLEET_SEED,
            "slots": FLEET_SLOTS, "page": PAGE, "name": "fleet_replica"}
    if DEVICE == "cpu":             # the CPU rehearsal's replicas
        spec["device"] = "cpu"
    return spec


def fleet_start(np, mt):
    """21d, started: the gateway spawns its replicas (they come up while
    21a-c run). Returns what :func:`fleet_phase` goes on with."""
    from mxnet_tpu_torch import config
    from mxnet_tpu_torch.fleet import Gateway
    rng = np.random.default_rng(SEED + 1)
    prompts = [[int(t) for t in rng.integers(0, VOCAB, n)]
               for n in PROMPT_LENS]
    spec = fleet_spec()
    snap = config.snapshot_overrides(["MXNET_TPU_FLEET",
                                      "MXNET_TPU_ELASTIC_BACKOFF"])
    config.set("MXNET_TPU_FLEET", True)
    config.set("MXNET_TPU_ELASTIC_BACKOFF", FLEET_BACKOFF)
    os.environ["MXNET_TPU_FLEET_FAULT_REPLICA"] = FLEET_FAULT
    memory = MemorySampler()
    t0 = time.perf_counter()
    gw = Gateway(spec=spec, replicas=FLEET_REPLICAS, port=None,
                 stats_period=FLEET_STATS_PERIOD, name="fleet21")
    return prompts, spec, snap, memory, t0, gw, FleetWatch(gw, t0)


def fleet_abort(started):
    """Close a started fleet whose drill never ran."""
    from mxnet_tpu_torch import config
    _p, _s, snap, memory, _t0, gw, watch = started
    gw.close(drain=False, timeout=60.0)
    watch.stop()
    os.environ.pop("MXNET_TPU_FLEET_FAULT_REPLICA", None)
    config.restore_overrides(snap)
    memory.stop()


def fleet_phase(torch, np, mt, started=None):
    """21d: the fleet drill (the port's tools/fleet_smoke.py), on the
    fleet :func:`fleet_start` started (here when None)."""
    from mxnet_tpu_torch import config
    from mxnet_tpu_torch.fleet import build_from_spec, wire
    from mxnet_tpu_torch.obs.prometheus import parse_prometheus
    prompts, spec, snap, memory, t0, gw, watch = \
        started or fleet_start(np, mt)
    r = {"tf32": gw._replicas[0].spec["tf32"]}
    try:
        # the single server, built here while the replicas start
        t_single = time.perf_counter()
        truth = build_from_spec(dict(spec, name="fleet_single"))
        r["single_build_s"] = time.perf_counter() - t_single
        try:
            want, wall = burst(truth, prompts)
            st = truth.stats()
            r["single"] = {"tok_s": sum(map(len, want)) / wall,
                           "ttft_p50_ms": st["ttft"]["p50_ms"],
                           "wall_s": wall}
            params = truth.engine.params
            live = gw.wait_ready(FLEET_REPLICAS, timeout=FLEET_SPAWN_WAIT_S)
            check(live == FLEET_REPLICAS, "21d: %d of %d replicas came up "
                  "in %d s" % (live, FLEET_REPLICAS, FLEET_SPAWN_WAIT_S))
            got, wall = fleet_wave(gw, prompts)
            st = gw.stats()
            r["wave1"] = {"tok_s": sum(map(len, got)) / wall,
                          "ttft_p50_ms": st["ttft"]["p50_ms"],
                          "wall_s": wall}
            r["ties"] = fleet_streams(torch, "wave 1", params, prompts, got,
                                      want)
            check(st["failover"] >= 1, "21d: the armed kill never failed "
                  "over: %s" % {k: v for k, v in st.items()
                                if k != "replicas"})
            check(st["dup_dropped"] == 0, "21d: %d duplicate frames"
                  % st["dup_dropped"])
            r["failover"] = st["failover"]
            # the supervisor notices the death on its own clock, then
            # respawns rank 1 after the backoff
            deadline = time.monotonic() + FLEET_SPAWN_WAIT_S
            while time.monotonic() < deadline:
                st = gw.stats()
                r1 = st["replicas"][1]
                if r1["state"] == "live" and r1["generation"] == 2 and \
                        r1["stats"].get("pid"):
                    break
                time.sleep(0.1)
            check(st["replica_dead"] >= 1 and r1["restarts"] == 1 and
                  r1["state"] == "live", "21d: rank 1 did not respawn once: "
                  "replica_dead %d, %s" % (st["replica_dead"], r1))
            fresh = wire.request_value(tuple(r1["addr"]), "STATS")
            check(fresh["native_builds"] == 0, "21d: the respawned replica "
                  "built %d native libraries" % fresh["native_builds"])
            r["respawn_compiles"] = {"native_builds": fresh["native_builds"],
                                     "backend_compiles":
                                         fresh["backend_compiles"]}
            got2, wall = fleet_wave(gw, prompts)
            st = gw.stats()
            r["wave2"] = {"tok_s": sum(map(len, got2)) / wall,
                          "ttft_p50_ms": st["ttft"]["p50_ms"],
                          "wall_s": wall}
            r["ties"] += fleet_streams(torch, "wave 2", params, prompts,
                                       got2, want)
            reps = {}
            for rep in st["replicas"]:
                check(rep["state"] == "live", "21d: rank %d is %s after "
                      "wave 2" % (rep["rank"], rep["state"]))
                s = wire.request_value(tuple(rep["addr"]), "STATS")
                k1 = s["kernel_launches"]["flash_attention_fwd"]
                reps[rep["rank"]] = {"requests": s["requests"],
                                     "tokens": s["tokens"], "k1": k1,
                                     "generation": rep["generation"]}
                check(s["tokens"] > 0, "21d: rank %d decoded nothing"
                      % rep["rank"])
                check_replica_k1(rep["rank"], k1, s["requests"])
            r["replicas"] = reps
            samples = parse_prometheus(gw.metrics_text())
            labels = {dict(lbls).get("replica") for _n, lbls in samples}
            check({"0", "1", "2"} <= labels, "21d: /metrics carries the "
                  "replica labels %s" % sorted(map(str, labels)))
            r["metrics_samples"] = len(samples)
        finally:
            truth.close()
            del truth
    finally:
        procs = [rep.proc for rep in gw._replicas]
        gw.close(drain=False, timeout=60.0)
        watch.stop()
        # read after the watch has stopped: it lags the gateway a poll
        r["start_s"] = [watch.first(k, 1, "live")
                        for k in range(FLEET_REPLICAS)]
        dead, back = watch.first(1, 1, "dead"), watch.first(1, 2, "live")
        r["respawn_s"] = None if dead is None or back is None \
            else back - dead
        os.environ.pop("MXNET_TPU_FLEET_FAULT_REPLICA", None)
        config.restore_overrides(snap)
        r["peak_mib"] = memory.stop()
    alive = [p.pid for p in procs if p is not None and p.poll() is None]
    check(not alive, "21d: replica processes %s outlived close()" % alive)
    log("21d fleet of %d replicas (the LM at full width, %d layers, f32, %d "
        "slots each, TF32 %s): replicas live at %s s, the single server "
        "built in %.1f s; wave 1 with rank 1 killed after its 6th token "
        "frame: %.1f tok/s, TTFT p50 %.3f ms (single server: %.1f tok/s, "
        "TTFT p50 %.3f ms); failovers %d; rank 1 back %.2f s after its "
        "death, compiles %s; wave 2 %.1f tok/s, TTFT p50 %.3f ms; "
        "replicas %s; near-ties %d; %d federated samples; card memory "
        "peak %d MiB" % (
            FLEET_REPLICAS, FLEET_LAYERS, FLEET_SLOTS, r["tf32"],
            ["%.1f" % t if t is not None else "?" for t in r["start_s"]],
            r["single_build_s"], r["wave1"]["tok_s"],
            r["wave1"]["ttft_p50_ms"], r["single"]["tok_s"],
            r["single"]["ttft_p50_ms"], r["failover"],
            r["respawn_s"] if r["respawn_s"] is not None else float("nan"),
            r["respawn_compiles"], r["wave2"]["tok_s"],
            r["wave2"]["ttft_p50_ms"], json.dumps(r["replicas"]),
            len(r["ties"]), r["metrics_samples"], r["peak_mib"]))
    gc.collect()
    torch.cuda.empty_cache()
    return r


def legacy_tools_fleet_phase(torch, np):
    """Phase 21: the legacy surface, test_utils and the tools (A10c) and
    the serving fleet (A10d's fleet/): 21a-21d."""
    import shutil
    import mxnet_tpu_torch as mt
    t0 = time.perf_counter()
    out = ROOT / "build" / "phase21"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    register_wrong_square(mt)
    readings = {}
    try:
        t = time.perf_counter()
        # 21d's replicas come up (~30 s) while 21a-c run
        fleet = fleet_start(np, mt)
        try:
            readings["21a"] = legacy_phase(torch, np, mt, out)
            readings["21b"] = consistency_phase(torch, np, mt)
            readings["21c"] = tools_phase(torch, np, mt, out,
                                          LEGACY_EPOCHS)
        except BaseException:
            fleet_abort(fleet)
            raise
        readings["21abc_s"] = time.perf_counter() - t
        t = time.perf_counter()
        readings["21d"] = fleet_phase(torch, np, mt, fleet)
        readings["21d_s"] = time.perf_counter() - t
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
        shutil.rmtree(out, ignore_errors=True)
    log("21 legacy, tools and fleet: %.1f s; %s"
        % (time.perf_counter() - t0, json.dumps(readings, default=str)))
    return readings


# phase 22: the supervisor, faults and the tuner (A10d) on the LM at full
# width, cut to 2 of its 12 layers so its six CUDA processes fit
ELASTIC_LAYERS = 2
ELASTIC_STEPS, ELASTIC_FAULT_AT = 6, 3
TUNE_STEPS, TUNE_PROBE_STEPS, TUNE_MAX_PROBES = 6, 4, 1
TUNE_PROBE_SECS = 150.0
LN_OFFSET = 1e3
LN_ROWS = 64
NAIVE_SHAPE = (4096, 4096)
# a hung supervisor, child or probe ends the run through faulthandler
ELASTIC_DEADLINE_S = 600


def phase22_opts(steps):
    """The drills' options: the LM at this script's width, cut to
    ``ELASTIC_LAYERS`` layers, amp bf16, on this script's device."""
    import argparse
    return argparse.Namespace(
        device="cpu" if DEVICE == "cpu" else "cuda", net="transformer",
        layers=ELASTIC_LAYERS, d_model=D_MODEL, heads=HEADS, d_ff=D_FF,
        seq=MAX_SEQ, vocab=VOCAB, batch=TRAIN_BATCH, steps=steps,
        lr=TRAIN_LR, amp="bfloat16", fault_at=ELASTIC_FAULT_AT,
        probe_steps=TUNE_PROBE_STEPS, max_probes=TUNE_MAX_PROBES,
        probe_secs=TUNE_PROBE_SECS, tune="auto", wait_store=0.0)


def check_attempt_launches(name, rec):
    """An attempt launched K1 bf16, K2 and K3 once per layer per step it
    trained."""
    want = rec["steps"] * ELASTIC_LAYERS
    check(rec["steps"] > 0 and all(v == want
                                   for v in rec["launches"].values()),
          "22a %s attempt %d: launches %s for %d steps x %d layers"
          % (name, rec["attempt"], rec["launches"], rec["steps"],
             ELASTIC_LAYERS))


def check_probe_launches(score):
    """A probe on the card launched K1 bf16, K2 and K3."""
    k = score["kernel_launches"]
    check(k["flash_attention_fwd"]["bf16"] > 0 and
          sum(k["flash_attention_bwd_dq"].values()) > 0 and
          sum(k["flash_attention_bwd_dkv"].values()) > 0,
          "22b: a probe launched %s" % k)


def stream_idle(torch):
    return torch.cuda.current_stream().query()


def tune_checks(torch, cold, warm):
    """22b: the search, the tuned fit and its restart."""
    from mxnet_tpu_torch.obs.mfu import peak_flops
    from mxnet_tpu_torch.tools import tune_smoke
    from mxnet_tpu_torch.tune.search import _score_key
    c, w = cold["counters"], warm["counters"]
    check(c.get("tune_probe") == 1 + TUNE_MAX_PROBES and
          c.get("tune_applied") == 1 and c.get("tune_store_write") == 1 and
          not c.get("tune_probe_fail"), "22b: the tuned fit counted %s" % c)
    st = cold["stored"]
    check(st is not None and st["source"] == "probe" and
          st["n_probed"] == 1 + TUNE_MAX_PROBES,
          "22b: the stored record %s" % (st and {
              k: st[k] for k in ("source", "n_probed", "n_pruned")}))
    probes = [a for a in st["audit"] if a["fate"] == "probed"]
    check(len(probes) == 1 + TUNE_MAX_PROBES and probes[0]["remat"] == "off"
          and probes[0]["grad_accum"] == 1 and probes[0]["async_window"] == 2,
          "22b: probed %s" % [{k: v for k, v in a.items() if k != "score"}
                              for a in probes])
    peak = None if DEVICE == "cpu" else peak_flops(
        torch.cuda.get_device_name(0))
    for a in probes:
        sc = a["score"]
        check(sc["ok"] and sc["device"] == str(torch.device(DEVICE))
              and sc["mfu"] is not None and sc["mfu"] > 0,
              "22b: probe %s scored %s" % (a, sc))
        if peak is not None:
            check(abs(sc["flops_per_sec"] / sc["mfu"] - peak) <= 1e-6 * peak,
                  "22b: obs_mfu not on the card's peak row %g" % peak)
        check_probe_launches(sc)
    check(_score_key(st["score"]) >= _score_key(st["baseline"]),
          "22b: the winner %s scored below the default %s"
          % (st["score"], st["baseline"]))
    losses = cold["losses"]
    check(len(losses) == TUNE_STEPS and all(map(math.isfinite, losses))
          and losses[-1] < losses[0], "22b: the tuned fit's losses %s"
          % losses)
    # the restart: a store hit, the same knobs, no native build (the
    # tool's own gate), and no store write
    bad = tune_smoke.check_warm_restart({"cold": cold, "warm": warm})
    check(not bad and not w.get("tune_store_write"),
          "22b: %s; the restart counted %s" % ("; ".join(bad), w))
    from mxnet_tpu_torch.tune.space import Candidate
    winner = Candidate.from_dict(st["candidate"])
    check(cold["applied"] == winner.knobs() and
          cold["grad_accum"] == winner.grad_accum,
          "22b: the tuned fit trained under %s / %d, the winner is %s"
          % (cold["applied"], cold["grad_accum"], winner.to_dict()))
    return [{"candidate": {k: a[k] for k in ("remat", "grad_accum",
                                              "scan_layers", "group_update",
                                              "async_window")},
             "wall_s": a["score"]["wall_s"],
             "steps_per_sec": a["score"]["steps_per_sec"],
             "obs_mfu": a["score"]["mfu"],
             "launches": a["score"]["kernel_launches"]} for a in probes]


def layernorm_check(torch, np, mt):
    """22c: the two-pass variance against the one-pass form on offset
    rows, and the knob-off form bit for bit the formula it had."""
    from mxnet_tpu_torch import config
    g = torch.Generator(device="cpu").manual_seed(SEED)
    x64 = torch.randn(LN_ROWS, D_MODEL, generator=g, dtype=torch.float64) \
        + LN_OFFSET
    gamma = torch.rand(D_MODEL, generator=g, dtype=torch.float64) + 0.5
    beta = torch.randn(D_MODEL, generator=g, dtype=torch.float64)
    mean = x64.mean(-1, keepdim=True)
    want = (x64 - mean) / torch.sqrt(
        ((x64 - mean) ** 2).mean(-1, keepdim=True) + 1e-5) * gamma + beta
    dev = torch.device(DEVICE)
    x, ga, be = (t.float().to(dev) for t in (x64, gamma, beta))
    args = [mt.nd.NDArray(t) for t in (x, ga, be)]
    got = {}
    snap = config.snapshot_overrides(["MXNET_TPU_LAYERNORM_TWO_PASS"])
    try:
        for two in (False, True):
            config.set("MXNET_TPU_LAYERNORM_TWO_PASS", two)
            got[two] = mt.nd.LayerNorm(*args, axis=-1).data
    finally:
        config.restore_overrides(snap)
    err = {k: float((v.double().cpu() - want).abs().max())
           for k, v in got.items()}
    check(err[True] < err[False], "22c: two-pass LayerNorm %.3g is not "
          "closer than one-pass %.3g" % (err[True], err[False]))
    # the parent's one-pass form, at the LM's shape
    rows = torch.randn(TRAIN_BATCH * 16, D_MODEL, device=dev)
    m = rows.mean(dim=-1, keepdim=True)
    var = torch.clamp((rows * rows).mean(dim=-1, keepdim=True) - m * m,
                      min=0.0)
    ref = (rows - m) * torch.rsqrt(var + 1e-5) * ga + be
    out = mt.nd.LayerNorm(*[mt.nd.NDArray(t) for t in (rows, ga, be)],
                          axis=-1).data
    check(torch.equal(out, ref), "22c: the knob-off LayerNorm parts from "
          "the one-pass formula by %g" % float((out - ref).abs().max()))
    return {"one_pass_err": err[False], "two_pass_err": err[True]}


def naive_engine_check(torch, np, mt):
    """22c: NaiveEngine waits for the stream after each imperative op;
    the results equal ThreadedEngine's bit for bit."""
    from mxnet_tpu_torch import config
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(SEED)
    a = mt.nd.NDArray(torch.randn(NAIVE_SHAPE, generator=g, device=dev))
    b = mt.nd.NDArray(torch.randn(NAIVE_SHAPE, generator=g, device=dev))
    ops = (("dot", lambda: mt.nd.dot(a, b)),
           ("exp", lambda: mt.nd.exp(a * 0.01)),
           ("softmax", lambda: mt.nd.softmax(a, axis=-1)),
           ("sum", lambda: mt.nd.sum(b, axis=0)))
    runs, idle = {}, {}
    snap = config.snapshot_overrides(["MXNET_ENGINE_TYPE"])
    try:
        for engine in ("NaiveEngine", "ThreadedEngine"):
            config.set("MXNET_ENGINE_TYPE", engine)
            outs, flags = [], []
            for _name, fn in ops:
                outs.append(fn())
                flags.append(bool(stream_idle(torch)))
            runs[engine], idle[engine] = outs, flags
            if DEVICE != "cpu":
                torch.cuda.synchronize()
    finally:
        config.restore_overrides(snap)
    check(all(idle["NaiveEngine"]), "22c: NaiveEngine returned with work "
          "on the stream: %s" % dict(zip([n for n, _ in ops],
                                         idle["NaiveEngine"])))
    for (name, _fn), x, y in zip(ops, runs["NaiveEngine"],
                                 runs["ThreadedEngine"]):
        check(torch.equal(x.data, y.data), "22c: %s under NaiveEngine "
              "parts from ThreadedEngine" % name)
    return {"naive_idle": idle["NaiveEngine"],
            "threaded_idle": idle["ThreadedEngine"]}


def tuned_fit_here(torch, mt, tune_smoke, store):
    """22b's ``fit(tune="auto")`` in this process, under the phase's
    tuner knobs and the drills' arithmetic, each restored after."""
    from mxnet_tpu_torch import config
    knobs = {"MXNET_TPU_TUNE_STORE": store,
             "MXNET_TPU_TUNE_MAX_PROBES": TUNE_MAX_PROBES,
             "MXNET_TPU_TUNE_PROBE_STEPS": TUNE_PROBE_STEPS,
             "MXNET_TPU_TUNE_PROBE_SECS": TUNE_PROBE_SECS}
    snap = config.snapshot_overrides(knobs)
    switches = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32,
                torch.backends.cudnn.deterministic)
    try:
        for k, v in knobs.items():
            config.set(k, v)
        return tune_smoke.fit_record(phase22_opts(TUNE_STEPS))
    finally:
        mt.amp.off()
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32, \
            torch.backends.cudnn.deterministic = switches
        config.restore_overrides(snap)


def start_drill():
    """22a's two supervised runs, started: ``(work directory, runs)``.
    ``main`` starts them before phase 21, so that their chains of
    processes (each ~10 s from its start to its ``fit`` on the card's
    host) run beside phase 21 and 22b."""
    import tempfile
    from mxnet_tpu_torch.tools import elastic_smoke
    (ROOT / "build").mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="phase22_", dir=ROOT / "build"))
    opts = phase22_opts(ELASTIC_STEPS)
    return work, [elastic_smoke.SupervisedRun(opts, str(work / "22a"), name)
                  for name in ("baseline", "drill")]


def elastic_tune_phase(torch, np, drill=None):
    """Phase 22: the supervisor, the rest of faults and the tuner (A10d)
    on one card. 22a's two supervised runs (``drill``, from
    :func:`start_drill`; started here when None) go beside 22b's search
    and tuned fit in this process and its restart in a child, which
    comes up while the search runs and waits for the stored record;
    then 22c in this process."""
    import shutil
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.tools import elastic_smoke, tune_smoke
    gc.collect()
    if DEVICE != "cpu":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    work, runs = drill if drill is not None else start_drill()
    opts = phase22_opts(ELASTIC_STEPS)
    r = {}
    restart = None
    try:
        store = str(work / "store")
        restart = tune_smoke.FitProcess(
            phase22_opts(TUNE_STEPS), store,
            wait_store=TUNE_PROBE_SECS * (1 + TUNE_MAX_PROBES) + 300)
        t = time.perf_counter()
        cold = tuned_fit_here(torch, mt, tune_smoke, store)
        r["22b_search_and_fit_s"] = time.perf_counter() - t
        t = time.perf_counter()
        r["22c"] = layernorm_check(torch, np, mt)
        r["22c"].update(naive_engine_check(torch, np, mt))
        warm = restart.result(ELASTIC_DEADLINE_S)
        r["22b_restart_after_fit_s"] = time.perf_counter() - t
        res = {name: run.result(ELASTIC_DEADLINE_S)
               for name, run in zip(("baseline", "drill"), runs)}
        res["marker"] = res["drill"]["marker"]
    finally:
        for proc in runs + [restart]:
            if proc is not None:
                proc.kill()
        shutil.rmtree(work, ignore_errors=True)
    bad = elastic_smoke.check(res, opts)
    check(not bad, "22a: %s" % "; ".join(bad))
    for name in ("baseline", "drill"):
        for rec in res[name]["attempts"]:
            check_attempt_launches(name, rec)
            check(rec["device"] == str(torch.device(DEVICE)),
                  "22a: %s ran on %s" % (name, rec["device"]))
    first, last = res["drill"]["attempts"]
    r["22a"] = {
        "baseline_s": res["baseline"]["wall_s"],
        "drill_s": res["drill"]["wall_s"],
        "restart_s": last["t_first_step"] - first["t_end"],
        "supervisor_gap_s": last["t_start"] - first["t_end"],
        "attempt_fit_s": [a["t_end"] - a["t_fit"]
                          for a in res["drill"]["attempts"]],
        "process_start_to_fit_s": [a["t_fit"] - a["t_start"]
                                   for a in res["drill"]["attempts"]],
        "launches": [a["launches"] for a in res["drill"]["attempts"]],
        "baseline_launches": res["baseline"]["attempts"][0]["launches"],
        "supervisors": {k: res[k]["supervisor"]
                        for k in ("baseline", "drill")},
        "marker": res["marker"],
        "parameters": len(last["digests"])}
    r["22b"] = {"probes": tune_checks(torch, cold, warm),
                "winner": cold["stored"]["candidate"],
                "searched_s": cold["stored"]["searched_s"],
                "fit_s": cold["t_end"] - cold["t_fit"],
                "restart_process_s": warm["process_wall_s"],
                "restart_start_to_store_s": warm["t_store_seen"] -
                warm["t_start"],
                "restart_store_to_end_s": warm["t_end"] -
                warm["t_store_seen"],
                "losses": cold["losses"],
                "fit_launches": cold["launches"]}
    # CUDA processes started: 22b's probes (the default and the ranked
    # ones) and its restart; 22a's three attempts
    r["cuda_processes"] = (1 + TUNE_MAX_PROBES) + 1 + 3
    r["phase_s"] = time.perf_counter() - t0
    log("22a supervised preemption (%d layers, full width, amp bf16, %d "
        "steps, SIGTERM at batch %d): the drill's %d parameters bit for bit "
        "the baseline's; supervisors %s; the restart resumed %.2f s after "
        "attempt 0 ended (its process started %.2f s after); launches per "
        "attempt %s (baseline %s); marker %s; "
        "baseline %.1f s, drill %.1f s from their start (beside phase 21 "
        "and 22b)"
        % (ELASTIC_LAYERS, ELASTIC_STEPS, ELASTIC_FAULT_AT,
           r["22a"]["parameters"], json.dumps(r["22a"]["supervisors"]),
           r["22a"]["restart_s"], r["22a"]["supervisor_gap_s"],
           r["22a"]["launches"],
           r["22a"]["baseline_launches"], r["22a"]["marker"],
           r["22a"]["baseline_s"], r["22a"]["drill_s"]))
    log("22b fit(tune=\"auto\") in this process: winner %s after %.1f s "
        "of search, inside a fit of %.1f s; probes %s; losses %s; the "
        "restart's process (started with the search) waited %.1f s for "
        "the record, then its fit took %.1f s: a store hit, no probe, no "
        "native build"
        % (json.dumps(r["22b"]["winner"]), r["22b"]["searched_s"],
           r["22b"]["fit_s"], json.dumps(r["22b"]["probes"]),
           ["%.4f" % v for v in r["22b"]["losses"]],
           r["22b"]["restart_start_to_store_s"],
           r["22b"]["restart_store_to_end_s"]))
    log("22c LayerNorm on rows offset by %g: max error one-pass %.3g, "
        "two-pass %.3g; NaiveEngine stream idle after each op %s "
        "(ThreadedEngine %s), results equal"
        % (LN_OFFSET, r["22c"]["one_pass_err"], r["22c"]["two_pass_err"],
           r["22c"]["naive_idle"], r["22c"]["threaded_idle"]))
    log("22 supervisor, faults and tuner: %.1f s, %d CUDA processes; %s"
        % (r["phase_s"], r["cuda_processes"], json.dumps(r, default=str)))
    return r


PAIRS_OF = ("f32-backward", "rtc", "fit-loop", "steps")


def fit_loop_timing(torch, np):
    """Phase 12c's AlexNet runs (amp bf16, then f32) through the imported
    package's own ``Module.fit``: run once under another checkout's
    package (the parent commit's, say) and once under this one's, a
    before/after pair of the fit loop in one call. Returns each run's
    step ms and the idle share of its profiled step."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import flash_attention as fa
    counters = {"flash_attention_fwd": fa.flash_attention_fwd,
                "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
                "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv}
    runs = {}
    mt.amp.init("bfloat16")
    try:
        runs["bf16"] = train_alexnet(torch, np, counters, ALEX_WARM,
                                     ALEX_TIMED, "alexnet")
    finally:
        mt.amp.off()
    runs["f32"] = train_alexnet(torch, np, counters, ALEX_F32_WARM,
                                ALEX_F32_TIMED, "alexnet f32")
    return {k: {"step_ms": r["step_ms"],
                "idle": 1.0 - r["busy_ms"] / r["wall_ms"]}
            for k, r in runs.items()}


def step_digests(torch, np):
    """Phase 6's LM (3 steps) and phase 8's ResNet-50 (2 steps) in amp
    bf16 through the imported package's ``Module._fit_step``, from
    weights drawn on the card from a seed, under
    ``cudnn.deterministic``: a sha256 of every parameter (and aux state)
    after the steps. Equal digests from two checkouts' packages mean
    their kernels and steps computed the same bits."""
    import hashlib
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.models import resnet, transformer
    dev = torch.device(DEVICE)
    torch.backends.cudnn.deterministic = True
    g = torch.Generator(device=dev).manual_seed(SEED)

    def run(sym, shapes, x, y, lr, steps, extra=None):
        mod = mt.mod.Module(sym, context=mt.gpu(0))
        mod.bind(data_shapes=[("data", shapes[0])],
                 label_shapes=[("softmax_label", shapes[1])])
        mod.init_params(mt.init.Constant(0.0))
        for n in mod._param_names:
            a = mod._exec.arg_dict[n]
            a.data.copy_(torch.randn(a.shape, generator=g, device=dev)
                         * 0.02)
        mod.init_optimizer(optimizer="sgd", optimizer_params=dict(
            {"learning_rate": lr}, **(extra or {})))
        db = mt.io.DataBatch(data=[mt.nd.NDArray(x)],
                             label=[mt.nd.NDArray(y)])
        for _ in range(steps):
            mod._fit_step(db)
        torch.cuda.synchronize()
        h = hashlib.sha256()
        args, aux = mod.get_params()
        params = dict(args, **aux)
        for n in sorted(params):
            h.update(params[n].data.float().cpu().numpy().tobytes())
        del mod
        gc.collect()
        torch.cuda.empty_cache()
        return h.hexdigest()

    B, T, S = TRAIN_BATCH, MAX_SEQ, RESNET_IMAGE
    mt.amp.init("bfloat16")
    try:
        ids = lambda: torch.randint(0, VOCAB, (B, T), generator=g,
                                    device=dev).float()
        lm = run(transformer.get_symbol(VOCAB, LAYERS, D_MODEL, HEADS, D_FF,
                                        T, attention="flash"),
                 ((B, T), (B, T)), ids(), ids(), TRAIN_LR, 3)
        x = torch.randn(RESNET_BATCH, 3, S, S, generator=g, device=dev)
        y = torch.randint(0, RESNET_CLASSES, (RESNET_BATCH,), generator=g,
                          device=dev).float()
        rn = run(resnet.get_symbol(num_classes=RESNET_CLASSES,
                                   num_layers=RESNET_LAYERS, stem="s2d",
                                   image_shape="3,%d,%d" % (S, S)),
                 ((RESNET_BATCH, 3, S, S), (RESNET_BATCH,)), x, y,
                 RESNET_LR, 2, {"momentum": RESNET_MOMENTUM,
                                "wd": RESNET_WD})
    finally:
        mt.amp.off()
        torch.backends.cudnn.deterministic = False
    return {"lm": lm, "resnet": rn}


def pairs_of(checkout: str, what: str) -> int:
    """``--pairs-of CHECKOUT WHAT``: one timing of another checkout's
    package (the parent commit's, say), built here and run by this
    script's code on this card, for a before/after pair in one call.
    ``f32-backward`` times the f32 dQ and dK/dV kernels
    (:func:`f32_backward_timing`); ``rtc`` pairs ``relu``,
    ``scale_add`` and ``split``, and :data:`B6F_STREAM_SOURCE`'s
    versions of the first two, with torch's calls (:func:`rtc_pairs`);
    ``fit-loop`` times AlexNet through that package's ``fit``
    (:func:`fit_loop_timing`); ``steps`` digests the parameters after a
    few LM and ResNet-50 steps (:func:`step_digests`). Prints the
    readings as one JSON line."""
    if what not in PAIRS_OF:
        print("chip_smoke: --pairs-of CHECKOUT WHAT, WHAT one of %s"
              % (PAIRS_OF,), file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(checkout).resolve()))
    import torch
    import mxnet_tpu_torch
    log("package %s" % mxnet_tpu_torch.__file__)
    try:
        card_phase(torch)
        if what == "f32-backward":
            readings = f32_backward_timing(torch)
        elif what == "fit-loop":
            import numpy as np
            readings = fit_loop_timing(torch, np)
        elif what == "steps":
            import numpy as np
            readings = step_digests(torch, np)
        else:
            from mxnet_tpu_torch import rtc_examples as ex
            rows = TRAIN_BATCH * MAX_SEQ
            readings = rtc_pairs(torch, {
                "relu": ex.relu((rows, D_FF)),
                "scale_add": ex.scale_add((rows, D_MODEL)),
                "split": ex.split((rows, D_MODEL)),
                **b6f_stream_kernels(torch)})
    except SmokeFailure as exc:
        print("chip_smoke: FAILED: %s" % exc, file=sys.stderr)
        return 1
    log(json.dumps(readings))
    return 0


# phase 23: the compiled update (A4d-a). (a) The LM at bench.py's full
# width and depth, Adam through fit: FUSED_WARM + FUSED_TIMED steps (the
# compile is the first step's); Adam's rate, decay and clipping as phase
# 11's fit takes them (no schedule: one rate for the whole fit)
FUSED_WARM, FUSED_TIMED = 2, 10
FUSED_ADAM = {"learning_rate": 1e-4, "wd": 1e-4, "clip_gradient": 1.0}
# the reference's own bound between its fused and eager updates
# (tests/test_fused_trainer.py:106): a compiled program rounds in its
# own order (inductor fuses each parameter's formula into one kernel)
FUSED_RTOL, FUSED_ATOL = 1e-4, 1e-6
# the update timed alone, compiled against the eager foreach route:
# alternating windows of FUSED_UPDATE_CALLS calls each
FUSED_UPDATE_WINDOWS, FUSED_UPDATE_CALLS = 5, 3
# the fit step compiled (the forward/backward program before the
# update) against the eager step (MXNET_TPU_FUSED_TRAINER=0: eager
# forward, backward and update): alternating windows, each one untimed
# step after the switch (its host ms logged apart), then FUSED_STEP_CALLS
# steps between CUDA events
FUSED_STEP_WINDOWS, FUSED_STEP_CALLS = 3, 3
# Convolution's autograd Function inside the compiled step's capture on
# the card: train_imagenet's ResNet-50 (7x7 stem) through Module at this
# batch, amp bf16, captured against eager (conv_step_check): the same
# kernels, so the same gradients (0 apart on the card, PR 24)
CONV_CHECK_BATCH, CONV_CHECK_IMAGE = 16, 224
CONV_CHECK_RTOL = 1e-6
# phase 23's child processes (child_main), started after the build
# phase beside phases 3-22, each to end within WARM_DEADLINE_S of the
# phase's wait: "lm" runs 23a, its fit's first step (the step program's
# and the update's cold builds) beside the phases and the rest once this
# process sends "go" after phase 22; "resnet" builds 23b's update into
# inductor's cache and runs conv_step_check
PHASE23_CHILDREN = ("lm", "resnet")
WARM_DEADLINE_S = 900
WARM_COMPILE_THREADS = 2
FUSED_COUNTERS = ("trainer_step_compile", "trainer_step_cache_hit",
                  "trainer_step_recompile", "loop_recompile",
                  "trainer_step_fallback", "trainer_step_compile_failed",
                  "fused_step_compile", "fused_step_cache_hit",
                  "fused_step_recompile", "fused_step_fallback",
                  "fused_step_compile_failed")


def compiler_facts(torch):
    """Phase 23's first reading: torch's version, and whether triton and
    inductor import on this machine (the compiled update needs both;
    their absence fails the phase)."""
    import importlib
    facts = {"torch": torch.__version__, "cuda": torch.version.cuda}
    for name, mod in (("triton", "triton"),
                      ("inductor", "torch._inductor.compile_fx")):
        try:
            m = importlib.import_module(mod)
        except Exception as exc:                           # noqa: BLE001
            raise SmokeFailure("%s does not import: %r" % (mod, exc))
        facts[name] = getattr(m, "__version__", torch.__version__)
    from mxnet_tpu_torch import _fused
    from mxnet_tpu_torch.symbol import scan
    facts["backend"] = _fused._GPU_BACKEND
    facts["regions"] = scan._regions_work()
    log("compiler: torch %(torch)s (CUDA %(cuda)s), triton %(triton)s, "
        "inductor of torch %(inductor)s; the compiled programs' backend "
        "%(backend)s; a scan plan's layers one nested compile region: "
        "%(regions)s" % facts)
    return facts


def _counter_snapshot():
    from mxnet_tpu_torch import profiler
    return {n: profiler.get_counter(n) for n in FUSED_COUNTERS}


def _counter_delta(snap):
    from mxnet_tpu_torch import profiler
    return {n: profiler.get_counter(n) - v for n, v in snap.items()}


def _within(torch, got, want):
    """The worst ``|got - want| - (atol + rtol |want|)`` (<= 0 holds, as
    numpy's assert_allclose does) and the worst |got - want|."""
    got, want = got.double(), want.double()
    diff = (got - want).abs()
    return ((diff - (FUSED_ATOL + FUSED_RTOL * want.abs())).max().item(),
            diff.max().item())


def _leaves(state):
    if state is None:
        return []
    if isinstance(state, tuple):
        return [x for s in state for x in _leaves(s)]
    return [state]


def fused_lm(torch, np, counters, gate=None):
    """(a) The LM through ``Module.fit`` with Adam on the compiled step
    (the forward/backward program, then the compiled update), then one
    update held against the eager route and both timed, the whole step
    compiled and eager timed in alternating windows, and the step's
    loss and gradients at the initial weights held against a plain f32
    step (:func:`step_parity`). ``gate()``, when given, runs after the
    fit's first step (the programs' builds), which the fit's seconds
    leave out (:func:`lm_child`)."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.obs import compiles
    B, T = TRAIN_BATCH, MAX_SEQ
    steps = FUSED_WARM + FUSED_TIMED
    sym = transformer.get_symbol(VOCAB, LAYERS, D_MODEL, HEADS, D_FF, T,
                                 attention="flash")
    mod = mt.mod.Module(sym, context=mt.gpu(0))
    mod.bind(data_shapes=[("data", (B, T))],
             label_shapes=[("softmax_label", (B, T))])
    mod.init_params(arg_params=lm_xavier(torch, np))
    rng = np.random.RandomState(0)
    x = rng.randint(0, VOCAB, (B, T)).astype(np.float32)
    y = rng.randint(0, VOCAB, (B, T)).astype(np.float32)
    dev = torch.device(DEVICE)
    db = mt.io.DataBatch(data=[mt.nd.array(x, ctx=dev)],
                         label=[mt.nd.array(y, ctx=dev)])
    y_flat = torch.from_numpy(y).to(dev).long().view(-1, 1)
    with torch.no_grad():
        params = {n: a.data for n, a in mod.get_params()[0].items()}
        want = plain_train_loss(torch, params, torch.from_numpy(x).to(dev),
                                torch.from_numpy(y).to(dev)).item()
        del params
    torch.cuda.empty_cache()
    losses, events = [], []

    waited = []

    def on_batch(param):
        out = mod.get_outputs()[0].data
        losses.append(-(out.gather(1, y_flat) + 1e-12).log().mean())
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        if gate is not None and len(events) == 1:
            t = time.perf_counter()
            waited.append(t - t0)
            gate()
            waited.append(time.perf_counter() - t)

    n_ring = len(compiles.snapshot())
    snap = _counter_snapshot()
    # the main path: counters zeroed just before, read just after
    for fn in counters.values():
        fn.launches = {"f32": 0, "bf16": 0}
    t0 = time.perf_counter()
    mod.fit(RepeatIter(db, steps, (B, T), (B, T)), num_epoch=1,
            batch_end_callback=on_batch, optimizer="adam",
            optimizer_params=dict(FUSED_ADAM),
            eval_metric=mt.metric.CrossEntropy())
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0 - (waited[1] if waited else 0.0)
    launches = {n: dict(fn.launches) for n, fn in counters.items()}
    delta = _counter_delta(snap)
    ring = [r for r in compiles.snapshot()[n_ring:]
            if r["scope"] == "trainer_step"]
    step_ring = [r for r in compiles.snapshot()[n_ring:]
                 if r["scope"] == "fused_step"]
    per_step = [a.elapsed_time(b) for a, b in
                zip(events[FUSED_WARM:], events[FUSED_WARM + 1:])]
    step_ms = float(np.median(per_step))
    losses = [float(v) for v in torch.stack(losses).cpu()]
    log("23a fit: %d steps in %.3f s%s; step %.3f ms (median of %d steps "
        "between CUDA events, %.3f-%.3f); counters %s; compile ring: the "
        "update %s, the step program %s; launches %s; loss per step %s; "
        "step-1 cross-entropy %.6f, plain f32 forward %.6f" % (
            steps, fit_s, " (step 1, both programs' builds, %.3f s, then "
            "%.3f s waiting for phase 23)" % tuple(waited) if waited else "",
            step_ms, len(per_step), min(per_step), max(per_step), delta,
            [(r["source"], r["compile_ms"]) for r in ring],
            [(r["source"], r["compile_ms"]) for r in step_ring], launches,
            " ".join("%.6f" % v for v in losses), losses[0], want))
    check(delta["trainer_step_compile"] == 1 and
          delta["trainer_step_cache_hit"] == steps - 1,
          "23a: the fit compiled %d update programs and reused them %d "
          "times (1 and %d expected)" % (
              delta["trainer_step_compile"],
              delta["trainer_step_cache_hit"], steps - 1))
    check(delta["fused_step_compile"] == 1 and
          delta["fused_step_cache_hit"] == steps - 1,
          "23a: the fit built %d step programs and reused them %d times "
          "(1 and %d expected)" % (delta["fused_step_compile"],
                                   delta["fused_step_cache_hit"], steps - 1))
    for name in ("loop_recompile", "trainer_step_recompile",
                 "trainer_step_fallback", "trainer_step_compile_failed",
                 "fused_step_recompile", "fused_step_fallback",
                 "fused_step_compile_failed"):
        check(delta[name] == 0, "23a: %s %d in the fit" % (name,
                                                           delta[name]))
    from mxnet_tpu_torch import _fused
    backend = _fused._GPU_BACKEND if dev.type == "cuda" \
        else _fused.CPU_BACKEND
    check(len(ring) == 1 and ring[0]["source"] == backend,
          "23a: the compile ring holds %s for the update (one %s record "
          "expected)" % (ring, backend))
    check(len(step_ring) == 1 and step_ring[0]["source"] == backend,
          "23a: the compile ring holds %s for the step program (one %s "
          "record expected)" % (step_ring, backend))
    for name, n in launches.items():
        check(n["bf16"] == steps * LAYERS and n["f32"] == 0,
              "23a: kernel %s launched %s times in %d steps x %d layers "
              "(bf16 only expected)" % (name, n, steps, LAYERS))
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          "23a: losses %s" % losses)
    check(abs(losses[0] - want) <= CE_TOL, "23a: step-1 loss %g vs plain "
          "forward %g" % (losses[0], want))

    # one update from one set of gradients, both routes
    ex, opt = mod._exec, mod._optimizer
    mod._load_batch(db)
    ex.forward(is_train=True)
    names, grads = ex.gradients()
    pairs = [(n, g) for n, g in zip(names, grads)
             if n not in mod._data_names]
    idx = mod._param_index
    items = [(idx[n], ex.arg_dict[n], g) for n, g in pairs]
    updater = mod._updater
    eager = mt.optimizer.get_updater(opt)
    eager_w = []
    for i, w, _g in items:
        eager_w.append(mt.nd.NDArray(w.data.clone()))
        st = updater.states[i]
        eager.states[i] = tuple(mt.nd.NDArray(s.data.clone()) for s in st)
    t = opt.num_update + 1
    snap = _counter_snapshot()
    check(mod._fused_updater.try_step(updater, items, lr=opt.lr, t=t),
          "23a: the compiled update declined the parity step")
    eager.update_multi([i for i, _w, _g in items], eager_w,
                       [g for _i, _w, g in items], lr=opt.lr, t=t)
    torch.cuda.synchronize()
    check(_counter_delta(snap)["trainer_step_cache_hit"] == 1,
          "23a: the parity step did not reuse the fit's program")
    worst, worst_abs, where = -math.inf, 0.0, None
    for (i, w, _g), ew in zip(items, eager_w):
        for got, ref in [(w, ew)] + list(zip(_leaves(updater.states[i]),
                                            _leaves(eager.states[i]))):
            excess, err = _within(torch, got.data, ref.data)
            worst_abs = max(worst_abs, err)
            if excess > worst:
                worst, where = excess, mod._param_names[i]
    log("23a parity: one Adam update of %d parameters, compiled against "
        "the eager foreach route from the same gradients: worst |diff| "
        "%.3g, worst excess over atol %g + rtol %g |ref| %.3g (%s)"
        % (len(items), worst_abs, FUSED_ATOL, FUSED_RTOL, worst, where))
    check(worst <= 0, "23a: compiled update outside rtol %g atol %g of "
          "the eager one at %s (excess %g)" % (FUSED_RTOL, FUSED_ATOL, where,
                                               worst))
    del eager_w, eager
    gc.collect()
    torch.cuda.empty_cache()

    # the update alone, compiled and eager, in alternating windows
    idxs = [i for i, _w, _g in items]
    ws = [w for _i, w, _g in items]
    gs = [g for _i, _w, g in items]

    host = {"compiled": [], "foreach": []}

    def window(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t = time.perf_counter()
        for _ in range(FUSED_UPDATE_CALLS):
            fn()
        host[fn.__name__].append((time.perf_counter() - t) * 1e3
                                 / FUSED_UPDATE_CALLS)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / FUSED_UPDATE_CALLS

    def compiled():
        check(mod._fused_updater.try_step(updater, items, lr=opt.lr,
                                          t=opt.num_update + 1),
              "23a: the compiled update declined a timed call")

    def foreach():
        updater.update_multi(idxs, ws, gs, lr=opt.lr, t=opt.num_update + 1)

    snap = _counter_snapshot()
    comp_ms, eager_ms = [], []
    for _ in range(FUSED_UPDATE_WINDOWS):
        comp_ms.append(window(compiled))
        eager_ms.append(window(foreach))
    d = _counter_delta(snap)
    check(d["trainer_step_compile"] == 0 and d["loop_recompile"] == 0,
          "23a: the timed updates compiled: %s" % d)
    n_values = sum(w.data.numel() for w in ws)
    bound_ms = 7 * 4 * n_values / PEAK_BYTES_PER_S * 1e3
    readings = {
        "fit_s": fit_s, "step_ms": step_ms, "losses": losses, "want": want,
        "compile_s": ring[0]["compile_ms"] / 1e3, "launches": launches,
        "step_compile_s": step_ring[0]["compile_ms"] / 1e3,
        "step1_s": waited[0] if waited else None,
        "counters": delta,
        "update_ms": float(np.median(comp_ms)),
        "update_foreach_ms": float(np.median(eager_ms)),
        "update_ms_windows": comp_ms, "update_foreach_ms_windows": eager_ms,
        "update_host_ms": float(np.median(host["compiled"])),
        "update_foreach_host_ms": float(np.median(host["foreach"])),
        "update_bound_ms": bound_ms, "parity_worst_abs": worst_abs,
        "n_params": len(items), "n_values": n_values}
    log("23a update: compiled %.3f ms, eager foreach %.3f ms (medians of "
        "%d windows of %d calls between CUDA events: %s / %s; the host's "
        "ms a call %.3f / %.3f); %d values, its bound (w, g, m, v read, w, "
        "m, v written, f32) %.3f ms; compile %.3f s"
        % (readings["update_ms"], readings["update_foreach_ms"],
           FUSED_UPDATE_WINDOWS, FUSED_UPDATE_CALLS,
           " ".join("%.3f" % v for v in comp_ms),
           " ".join("%.3f" % v for v in eager_ms),
           readings["update_host_ms"], readings["update_foreach_host_ms"],
           n_values, bound_ms, readings["compile_s"]))
    del items, ws, gs, grads, pairs, ex
    gc.collect()
    torch.cuda.empty_cache()
    readings.update(step_windows(torch, np, mod, db))
    del mod
    gc.collect()
    torch.cuda.empty_cache()
    readings.update(step_parity(torch, np, sym, db, x, y))
    del db
    gc.collect()
    torch.cuda.empty_cache()
    return readings


def step_windows(torch, np, mod, db):
    """The whole fit step compiled (the step program and the compiled
    update) against the eager step (``MXNET_TPU_FUSED_TRAINER`` off:
    the graph function op by op, ``torch.autograd.grad``, the foreach
    update), ``_fit_step`` on one batch in alternating windows: in each,
    one untimed step after the switch, then FUSED_STEP_CALLS steps between
    CUDA events, with the host's ms of every call (the time ``_fit_step``
    takes to return: the host's work, the card's queue running behind
    it). Then the first compiled step after an eager window once more
    under ``torch.profiler``: its host operations by self time, which say
    what a switch costs that call."""
    import mxnet_tpu_torch as mt
    from torch.profiler import ProfilerActivity, profile
    calls = {"compiled": [], "eager": []}
    first = {"compiled": [], "eager": []}
    dev_ms = {"compiled": [], "eager": []}

    def host_ms():
        t = time.perf_counter()
        mod._fit_step(db)
        return (time.perf_counter() - t) * 1e3

    def window(kind):
        mt.config.set("MXNET_TPU_FUSED_TRAINER", kind == "compiled")
        torch.cuda.synchronize()
        first[kind].append(host_ms())
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(FUSED_STEP_CALLS):
            calls[kind].append(host_ms())
        end.record()
        torch.cuda.synchronize()
        dev_ms[kind].append(start.elapsed_time(end) / FUSED_STEP_CALLS)

    acts = [ProfilerActivity.CPU]
    if torch.device(DEVICE).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    snap = _counter_snapshot()
    try:
        for _ in range(FUSED_STEP_WINDOWS):
            window("compiled")
            window("eager")
        mt.config.set("MXNET_TPU_FUSED_TRAINER", True)
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            traced_ms = host_ms()
            torch.cuda.synchronize()
    finally:
        mt.config.set("MXNET_TPU_FUSED_TRAINER", True)
    d = _counter_delta(snap)
    n = FUSED_STEP_WINDOWS * (FUSED_STEP_CALLS + 1) + 1
    check(d["fused_step_compile"] == 0 and d["loop_recompile"] == 0 and
          d["fused_step_cache_hit"] == n,
          "23a: the timed compiled steps built or missed: %s" % d)
    top = [(e.key, e.count, e.self_cpu_time_total / 1e3) for e in sorted(
        prof.key_averages(), key=lambda e: e.self_cpu_time_total,
        reverse=True)[:8]]
    out = {"step_compiled_ms": float(np.median(dev_ms["compiled"])),
           "step_eager_ms": float(np.median(dev_ms["eager"])),
           "step_compiled_ms_windows": dev_ms["compiled"],
           "step_eager_ms_windows": dev_ms["eager"],
           "step_host_ms": float(np.median(calls["compiled"])),
           "step_eager_host_ms": float(np.median(calls["eager"])),
           "step_host_ms_calls": calls["compiled"],
           "step_eager_host_ms_calls": calls["eager"],
           "step_first_host_ms": first["compiled"],
           "step_eager_first_host_ms": first["eager"],
           "step_traced_host_ms": traced_ms, "step_traced_top": top}
    log("23a step: compiled %.3f ms, eager %.3f ms (medians of %d windows "
        "of %d steps between CUDA events, each after one untimed step: "
        "%s / %s); the host's ms a call compiled %s, eager %s; the "
        "untimed first call after each switch compiled %s, eager %s (no "
        "gain is claimed)" % (
            out["step_compiled_ms"], out["step_eager_ms"],
            FUSED_STEP_WINDOWS, FUSED_STEP_CALLS,
            " ".join("%.3f" % v for v in dev_ms["compiled"]),
            " ".join("%.3f" % v for v in dev_ms["eager"]),
            " ".join("%.3f" % v for v in calls["compiled"]),
            " ".join("%.3f" % v for v in calls["eager"]),
            " ".join("%.3f" % v for v in first["compiled"]),
            " ".join("%.3f" % v for v in first["eager"])))
    log("23a step: the first compiled call after an eager window, traced: "
        "%.3f ms of host; its host operations by self time: %s" % (
            traced_ms, "; ".join("%s x%d %.3f ms" % r for r in top)))
    return out


def _rel_l2(torch, got, want):
    """The relative L2 distance over every gradient: ||got - want|| /
    ||want||, in float64."""
    num = sum(float((g.double() - w.double()).pow(2).sum())
              for g, w in zip(got, want))
    den = sum(float(w.double().pow(2).sum()) for w in want)
    return (num / den) ** 0.5


def step_parity(torch, np, sym, db, x, y):
    """Step 1's loss and gradients at the LM's initial weights (the
    fit's), through the compiled step program and through the eager
    route (amp bf16 both), each against a plain f32 step (``plain_train_
    loss`` under autograd, TF32 off): the compiled route's relative L2
    distance over all gradients at most twice the eager route's. The
    port's head (``normalization="batch"`` over the flattened tokens)
    differentiates the mean cross-entropy over every token, as the plain
    step does. ``sym`` is the fit's symbol object (another symbol from
    ``transformer.get_symbol`` gets other generated names, and so another
    program key)."""
    import mxnet_tpu_torch as mt
    B, T = TRAIN_BATCH, MAX_SEQ
    dev = torch.device(DEVICE)
    pm = mt.mod.Module(sym, context=mt.gpu(0))
    pm.bind(data_shapes=[("data", (B, T))],
            label_shapes=[("softmax_label", (B, T))])
    pm.init_params(arg_params=lm_xavier(torch, np))
    pm.init_optimizer(optimizer="adam", optimizer_params=dict(FUSED_ADAM))
    y_flat = torch.from_numpy(y).to(dev).long().view(-1, 1)

    def loss_of():
        out = pm.get_outputs()[0].data
        return float(-(out.gather(1, y_flat) + 1e-12).log().mean())

    snap = _counter_snapshot()
    pm._load_batch(db)
    names, g_comp = pm._compiled_gradients()
    check(names is not None, "23a parity: the compiled step declined")
    loss_comp = loss_of()
    d = _counter_delta(snap)
    check(d["fused_step_cache_hit"] == 1 and d["fused_step_compile"] == 0,
          "23a parity: the step did not reuse the fit's program: %s" % d)
    keep = [i for i, n in enumerate(names) if n not in pm._data_names]
    names = [names[i] for i in keep]
    g_comp = [g_comp[i].float() for i in keep]
    e_names, g_eager = pm._step_gradients(None)
    loss_eager = loss_of()
    pos = {n: i for i, n in enumerate(e_names)}
    g_eager = [g_eager[pos[n]].float() for n in names]
    init = lm_xavier(torch, np)
    params = {n: init[n].to(dev).float().requires_grad_(n in names)
              for n in init}
    full_f32(torch)
    loss = plain_train_loss(torch, params, torch.from_numpy(x).to(dev),
                            torch.from_numpy(y).to(dev))
    g_plain = torch.autograd.grad(loss, [params[n] for n in names])
    loss_plain = float(loss)
    del params, loss, pm
    gc.collect()
    dist_comp = _rel_l2(torch, g_comp, g_plain)
    dist_eager = _rel_l2(torch, g_eager, g_plain)
    dist_pair = _rel_l2(torch, g_comp, g_eager)
    del g_comp, g_eager, g_plain
    gc.collect()
    torch.cuda.empty_cache()
    out = {"parity_loss_compiled": loss_comp, "parity_loss_eager": loss_eager,
           "parity_loss_plain": loss_plain, "parity_grad_compiled": dist_comp,
           "parity_grad_eager": dist_eager, "parity_grad_pair": dist_pair,
           "parity_n_grads": len(names)}
    log("23a parity: step 1 at the initial weights, cross-entropy %.6f "
        "compiled, %.6f eager, %.6f plain f32; relative L2 over %d "
        "gradients from the plain f32 step: compiled %.4g, eager %.4g "
        "(compiled from eager %.4g)" % (
            loss_comp, loss_eager, loss_plain, len(names), dist_comp,
            dist_eager, dist_pair))
    check(abs(loss_comp - loss_plain) <= CE_TOL,
          "23a parity: compiled step-1 loss %g vs plain %g" % (loss_comp,
                                                              loss_plain))
    check(dist_comp <= 2 * dist_eager,
          "23a parity: the compiled step's gradients are %.4g from the "
          "plain f32 step's, more than twice the eager step's %.4g"
          % (dist_comp, dist_eager))
    return out


def fused_resnet(torch, np):
    """(b) Gluon's resnet50_v1 through ``Trainer.step``: the compiled step
    against the knob-off step from the same weights, states and
    gradients; then a new learning rate compiles nothing."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import autograd, gluon
    B, S = RESNET_BATCH, RESNET_IMAGE
    dev = torch.device(DEVICE)
    rng = np.random.RandomState(0)
    x = mt.nd.array(rng.uniform(-1, 1, (B, 3, S, S)).astype(np.float32),
                    ctx=dev)
    y = mt.nd.array(rng.randint(0, RESNET_CLASSES, (B,)).astype(np.float32),
                    ctx=dev)
    mt.random.seed(SEED)
    net = gluon.model_zoo.vision.get_model("resnet%d_v1" % RESNET_LAYERS,
                                           classes=RESNET_CLASSES)
    net.initialize(mt.init.Xavier(rnd_type="gaussian", factor_type="in",
                                  magnitude=2).set_rng(
                                      mt.random.derive_numpy_rng(
                                          "gluon_resnet50_v1")),
                   ctx=mt.gpu(0))
    net.hybridize()
    net.infer_shape(x)
    trainer = gluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": RESNET_LR, "momentum": RESNET_MOMENTUM,
        "wd": RESNET_WD})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    params = [p for p in net.collect_params().values()
              if p.grad_req != "null"]

    def backward():
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        return loss.data.detach().mean()

    snap = _counter_snapshot()
    losses = []
    for _ in range(2):
        losses.append(backward())
        trainer.step(B)
    losses.append(backward())
    torch.cuda.synchronize()
    d = _counter_delta(snap)
    check(d["trainer_step_compile"] == 1 and
          d["trainer_step_cache_hit"] == 1 and d["trainer_step_fallback"] == 0,
          "23b: two steps made %s" % d)
    states = trainer._updaters.states
    keep_w = [p.data().data.clone() for p in params]
    keep_s = {i: [s.data.clone() for s in _leaves(st)]
              for i, st in states.items()}

    def restore():
        with torch.no_grad():
            for p, w in zip(params, keep_w):
                p.data().data.copy_(w)
            for i, st in states.items():
                for s, v in zip(_leaves(st), keep_s[i]):
                    s.data.copy_(v)

    trainer.step(B)
    got_w = [p.data().data.clone() for p in params]
    got_s = {i: [s.data.clone() for s in _leaves(st)]
             for i, st in states.items()}
    restore()
    from mxnet_tpu_torch import config
    knob = config.snapshot_overrides(["MXNET_TPU_FUSED_TRAINER"])
    config.set("MXNET_TPU_FUSED_TRAINER", False)
    try:
        trainer.step(B)
    finally:
        config.restore_overrides(knob)
    torch.cuda.synchronize()
    worst, worst_abs, where = -math.inf, 0.0, None
    for p, g in zip(params, got_w):
        excess, err = _within(torch, g, p.data().data)
        worst_abs = max(worst_abs, err)
        if excess > worst:
            worst, where = excess, p.name
    for i, st in states.items():
        for s, g in zip(_leaves(st), got_s[i]):
            excess, err = _within(torch, g, s.data)
            worst_abs = max(worst_abs, err)
            if excess > worst:
                worst, where = excess, "state %s" % i
    d = _counter_delta(snap)
    log("23b: resnet50_v1 (%d trained parameters), Trainer.step compiled "
        "against MXNET_TPU_FUSED_TRAINER=0 from the same weights, momenta "
        "and gradients: worst |diff| %.3g, worst excess over atol %g + "
        "rtol %g |ref| %.3g (%s); counters %s"
        % (len(params), worst_abs, FUSED_ATOL, FUSED_RTOL, worst, where, d))
    check(worst <= 0, "23b: compiled step outside rtol %g atol %g of the "
          "knob-off step at %s (excess %g)" % (FUSED_RTOL, FUSED_ATOL, where,
                                               worst))
    check(d["trainer_step_fallback"] == 1,
          "23b: the knob-off step was not the counted fallback: %s" % d)
    snap = _counter_snapshot()
    for lr in (RESNET_LR * 0.5, RESNET_LR * 0.1):
        trainer.set_learning_rate(lr)
        losses.append(backward())
        trainer.step(B)
    torch.cuda.synchronize()
    d = _counter_delta(snap)
    losses = [float(v) for v in torch.stack(losses).cpu()]
    log("23b: two steps at new learning rates: counters %s; losses %s"
        % (d, " ".join("%.6f" % v for v in losses)))
    check(d["trainer_step_compile"] == 0 and d["loop_recompile"] == 0 and
          d["trainer_step_cache_hit"] == 2 and
          d["trainer_step_fallback"] == 0,
          "23b: a new learning rate recompiled: %s" % d)
    check(all(math.isfinite(v) for v in losses), "23b: losses %s" % losses)
    readings = {"worst_abs": worst_abs, "n_params": len(params),
                "losses": losses}
    del net, trainer, params, keep_w, keep_s, got_w, got_s, x, y
    gc.collect()
    torch.cuda.empty_cache()
    return readings


def compile_cache_counters():
    """Inductor's FX graph cache and AOT autograd's cache counters of
    this process, and inductor's cache directory."""
    from torch._dynamo.utils import counters
    out = {k: v for part in ("inductor", "aot_autograd")
           for k, v in counters[part].items()
           if "cache" in k or "bypass" in k}
    out["dir"] = os.environ.get("TORCHINDUCTOR_CACHE_DIR")
    return out


def conv_step_check(torch, np):
    """Convolution's autograd Function inside the compiled step's capture
    on the card: train_imagenet's ResNet-50 (7x7 stem) through
    ``Module`` at CONV_CHECK_BATCH (amp bf16, cuDNN's deterministic
    algorithms), step 1's gradients at seeded weights through the step
    program and through the eager route: every gradient within
    CONV_CHECK_RTOL of its eager counterpart's largest value, none zero
    where eager's is not. The program is the capture alone (dynamo and
    AOT autograd, the ``aot_eager`` backend), where torch 2.11 lost
    LayerNorm's backward (every gradient through its Function zero; PR 24,
    ``PERF.md``): without inductor's code generation, which rounds in its
    own order, the captured graph runs the eager route's kernels, and a
    ResNet's step-1 gradients part by O(1) under any other rounding (the
    eager bf16 and f32 steps' relative L2 distance read 1.19 on the card).
    Before torch 2.13 the compiled step takes only the Functions a card
    run holds (``module._CARD_CHECKED``): this is Convolution's run, 23a's
    LM SoftmaxOutput's and FlashAttention's."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import _fused
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.obs import compiles
    B, S = CONV_CHECK_BATCH, CONV_CHECK_IMAGE
    dev = torch.device(DEVICE)
    sym = resnet.get_symbol(num_classes=RESNET_CLASSES,
                            num_layers=RESNET_LAYERS, stem="7x7",
                            image_shape="3,%d,%d" % (S, S))
    mod = mt.mod.Module(sym, context=mt.gpu(0))
    mod.bind(data_shapes=[("data", (B, 3, S, S))],
             label_shapes=[("softmax_label", (B,))])
    mod.init_params(imagenet_init(mt, np))
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": RESNET_LR, "momentum": RESNET_MOMENTUM,
        "wd": RESNET_WD})
    rng = np.random.RandomState(1)
    db = mt.io.DataBatch(
        data=[mt.nd.array(rng.uniform(-1, 1, (B, 3, S, S)).astype(
            np.float32), ctx=dev)],
        label=[mt.nd.array(rng.randint(0, RESNET_CLASSES, (B,)).astype(
            np.float32), ctx=dev)])
    mod._load_batch(db)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    backend = _fused._GPU_BACKEND
    _fused._GPU_BACKEND = _fused.CPU_BACKEND
    snap = _counter_snapshot()
    try:
        t = time.perf_counter()
        # the compile ring's scope _fit_step opens around a step
        with compiles.scope("fused_step", mod._obs_sig):
            names, got = mod._compiled_gradients()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        d = _counter_delta(snap)
        check(names is not None and d["fused_step_compile"] == 1 and
              d["fused_step_fallback"] == 0,
              "23 conv: the ResNet's step did not build its program: %s"
              % d)
        keep = [n for n in names if n not in mod._data_names]

        def pick(names, grads):
            pos = {n: i for i, n in enumerate(names)}
            return [grads[pos[n]].float().clone() for n in keep]

        g_comp = pick(names, got)
        g_eager = pick(*mod._step_gradients(None))
    finally:
        _fused._GPU_BACKEND = backend
        torch.backends.cudnn.deterministic = deterministic
    zeroed = [n for n, c, e in zip(keep, g_comp, g_eager)
              if float(c.abs().max()) == 0 and float(e.abs().max()) > 0]
    worst, where = 0.0, None
    for n, c, e in zip(keep, g_comp, g_eager):
        err = float((c - e).abs().max()) / max(float(e.abs().max()), 1e-30)
        if err > worst:
            worst, where = err, n
    n_conv = sum(1 for n in keep if "conv" in n)
    out = {"build_s": build_s, "n_grads": len(keep), "n_conv": n_conv,
           "worst": worst, "worst_name": where, "zeroed": zeroed}
    log("23 conv: ResNet-%d (7x7 stem, batch %d, %dx%d, amp bf16) through "
        "Module's compiled step, captured (%s): built in %.3f s; %d "
        "gradients (%d of convolutions) against the eager step's: worst "
        "|diff| / max|eager| %.3g (%s, limit %g); zero where eager is "
        "not: %s" % (RESNET_LAYERS, B, S, S, _fused.CPU_BACKEND, build_s,
                     len(keep), n_conv, worst, where, CONV_CHECK_RTOL,
                     zeroed))
    check(not zeroed, "23 conv: compiled gradients zero where the eager "
          "ones are not: %s" % zeroed)
    check(worst <= CONV_CHECK_RTOL,
          "23 conv: the captured step's gradient %s is %.3g of its largest "
          "eager value from the eager one (limit %g)"
          % (where, worst, CONV_CHECK_RTOL))
    del mod, g_comp, g_eager, got, db
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _flash_counters():
    """The flash kernels' wrappers, whose ``launches`` 23a reads."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    return {"flash_attention_fwd_bf16": fa.flash_attention_fwd,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv}


def lm_child(torch, np):
    """23a in a process of its own (:func:`child_main`): its fit's first
    step, whose two programs build cold there, runs beside phases 3-22;
    the rest waits until the smoke's process writes ``go`` to this
    process's standard input once phase 22 is done, so that nothing else
    runs on the card or the host's cores beside 23a's timings."""
    import mxnet_tpu_torch as mt

    def gate():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        log("23a: step 1 done, waiting for phase 23")
        if sys.stdin.readline().strip() != "go":
            raise SmokeFailure("23a: the smoke's process ended before "
                               "phase 23")

    mt.config.set("MXNET_TPU_FUSED_TRAINER", True)
    mt.amp.init("bfloat16")
    try:
        return fused_lm(torch, np, _flash_counters(), gate=gate)
    finally:
        mt.amp.off()


def resnet_child(torch, np):
    """23b's update built ahead (resnet50_v1's SGD ``Trainer.step`` at
    batch 2: an update's shapes do not depend on the batch, so this is
    23b's program, and inductor's code for it lands in
    ``build/inductor``, which every process of the checkout shares), then
    :func:`conv_step_check`; amp bf16 as in phase 23. Returns the builds'
    seconds (the compile ring's ``trainer_step`` and ``fused_step``
    records) and the check's readings."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.obs import compiles
    mt.config.set("MXNET_TPU_FUSED_TRAINER", True)
    mt.amp.init("bfloat16")
    try:
        warm_resnet(torch, np, mt, autograd, gluon, torch.device(DEVICE))
        conv = conv_step_check(torch, np)
    finally:
        mt.amp.off()
    return {"builds_s": [r["compile_ms"] / 1e3 for r in compiles.snapshot()
                         if r["scope"] in ("trainer_step", "fused_step")],
            "conv": conv}


def warm_resnet(torch, np, mt, autograd, gluon, dev):
    """One ``Trainer.step`` of resnet50_v1 at batch 2
    (:func:`resnet_child`)."""
    mt.random.seed(SEED)
    net = gluon.model_zoo.vision.get_model(
        "resnet%d_v1" % RESNET_LAYERS, classes=RESNET_CLASSES)
    net.initialize(mt.init.Xavier(rnd_type="gaussian", factor_type="in",
                                  magnitude=2), ctx=mt.gpu(0))
    net.hybridize()
    x = mt.nd.array(np.zeros((2, 3, RESNET_IMAGE, RESNET_IMAGE),
                             np.float32), ctx=dev)
    y = mt.nd.array(np.zeros((2,), np.float32), ctx=dev)
    net.infer_shape(x)
    trainer = gluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": RESNET_LR, "momentum": RESNET_MOMENTUM,
        "wd": RESNET_WD})
    with autograd.record():
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(net(x), y)
    loss.backward()
    trainer.step(2)
    torch.cuda.synchronize()
    del net, trainer, x, y, loss
    gc.collect()
    torch.cuda.empty_cache()


def child_main(out: str, which: str) -> int:
    """``--phase23 OUT WHICH``: :func:`lm_child` or :func:`resnet_child`;
    its readings, its seconds and the compile caches' counters written to
    OUT as JSON, or the failed check as ``failed``."""
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    parent = os.getppid()

    def watch_parent():
        # a run ended by faulthandler leaves no child behind
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(1)

    threading.Thread(target=watch_parent, daemon=True).start()
    # the host's cores go to the phases first
    os.nice(10)
    # the card phase's switches: inductor's cache key holds them, and
    # phase 23 loads 23b's update under them
    full_f32(torch)
    t0 = time.perf_counter()
    try:
        result = {"lm": lm_child, "resnet": resnet_child}[which](torch, np)
    except SmokeFailure as exc:
        Path(out).write_text(json.dumps({"which": which,
                                         "failed": str(exc)}))
        return 1
    Path(out).write_text(json.dumps({
        "which": which, "result": result,
        "wall_s": time.perf_counter() - t0,
        "caches": compile_cache_counters()}, default=str))
    return 0


def start_children():
    """Phase 23's child processes (:func:`child_main`), started:
    ``{which: (process, its JSON path, its log path)}``; the ``lm``
    child's standard input a pipe (:func:`lm_child`)."""
    (ROOT / "build").mkdir(parents=True, exist_ok=True)
    # inductor's compile workers, one per core by default in each
    # process, took the host from phases 3-22 (which ran ~1.5x slower
    # beside them): WARM_COMPILE_THREADS each
    env = dict(os.environ,
               TORCHINDUCTOR_COMPILE_THREADS=str(WARM_COMPILE_THREADS))
    runs = {}
    for which in PHASE23_CHILDREN:
        out = ROOT / "build" / ("phase23_%s.json" % which)
        log_path = ROOT / "build" / ("phase23_%s.log" % which)
        out.unlink(missing_ok=True)
        with open(log_path, "w") as log_file:
            runs[which] = (subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--phase23", str(out), which], cwd=str(ROOT), env=env,
                stdin=subprocess.PIPE if which == "lm" else
                subprocess.DEVNULL, stdout=log_file,
                stderr=subprocess.STDOUT), out, log_path)
    return runs


def join_child(run, go=False):
    """Wait for one :func:`child_main` process (after writing ``go`` to
    its standard input when asked) and log its phase-23 lines; its JSON."""
    proc, out, log_path = run
    if go:
        try:
            proc.stdin.write(b"go\n")
            proc.stdin.close()
        except BrokenPipeError:
            pass
    try:
        rc = proc.wait(timeout=WARM_DEADLINE_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise SmokeFailure("phase 23's %s process ran past %d s"
                           % (out.stem, WARM_DEADLINE_S))
    text = log_path.read_text()
    for line in text.splitlines():
        if line.startswith("23"):
            log(line)
    data = json.loads(out.read_text()) if out.exists() else {}
    check(rc == 0 and "result" in data, "phase 23's %s process exited %d: "
          "%s" % (out.stem, rc, data.get("failed") or text[-3000:]))
    return data


def fused_update_phase(torch, np, children=None):
    """Phase 23: the compiled step (A4d-b) and the compiled update
    (A4d-a). ``children`` the :func:`start_children` processes: 23a and
    the Convolution check ran there, and 23b's update is in inductor's
    cache; None: all of it here, cold."""
    import mxnet_tpu_torch as mt
    # card_phase's switches, whatever an earlier phase left: the child
    # processes built under them, and inductor's cache key holds them
    full_f32(torch)
    facts = compiler_facts(torch)
    if children is not None:
        t = time.perf_counter()
        rn = join_child(children["resnet"])
        waited = time.perf_counter() - t
        lm_run = join_child(children["lm"], go=True)
        facts["children"] = {r["which"]: {
            "wall_s": r["wall_s"], "caches": r["caches"]}
            for r in (rn, lm_run)}
        log("23: waited %.1f s for the resnet child, then %.1f s for 23a's; "
            "the resnet child built %s s (%.1f s of process; caches %s); "
            "23a's process %.1f s (caches %s)" % (
                waited, time.perf_counter() - t - waited,
                " ".join("%.3f" % v for v in rn["result"]["builds_s"]),
                rn["wall_s"], rn["caches"], lm_run["wall_s"],
                lm_run["caches"]))
        lm, conv = lm_run["result"], rn["result"]["conv"]
    # the compiled step and update on, whatever the environment says
    # (main turns them off for the earlier phases)
    mt.config.set("MXNET_TPU_FUSED_TRAINER", True)
    mt.amp.init("bfloat16")
    try:
        if children is None:
            lm = fused_lm(torch, np, _flash_counters())
            conv = conv_step_check(torch, np)
        log("23a: compile caches %s" % compile_cache_counters())
        res = fused_resnet(torch, np)
        log("23b: compile caches %s" % compile_cache_counters())
    finally:
        mt.amp.off()
        mt.config.reset("MXNET_TPU_FUSED_TRAINER")
    return {"facts": facts, "lm": lm, "conv": conv, "resnet": res}


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--pairs-of":
        return pairs_of(sys.argv[2], sys.argv[3])
    if len(sys.argv) == 4 and sys.argv[1] == "--phase23":
        return child_main(sys.argv[2], sys.argv[3])
    if not (ROOT / "mxnet_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(mxnet_tpu_torch/ not found beside this script)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    # phases 1-22 hold the earlier slices' paths on their eager update:
    # compiled, each Module's and Trainer's update would pay a cold
    # inductor compile per structure (phase 23 reads the LM's), past the
    # script's time limit. Phase 23 holds the compiled update at full
    # width; the environment carries the switch into every child process
    os.environ["MXNET_TPU_FUSED_TRAINER"] = "0"
    # inductor's and triton's caches in the checkout, for this process and
    # phase 23's warm-up processes alike: inductor settles its directory
    # at its first use, which an earlier phase may make
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                          str(ROOT / "build" / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(ROOT / "build" / "inductor" / "triton"))
    import numpy as np
    import torch
    children = None
    try:
        timed("card", card_phase, torch)
        timed("build", build_phase)
        # phase 23's programs compile beside phases 3-22 (start_children)
        children = start_children()
        kernels = timed("kernel", kernel_phase, torch)
        timed("slice", slice_phase, torch, np, kernels)
        timed("train_kernel", train_kernel_phase, torch, kernels)
        sgd = timed("train", train_phase, torch, np, kernels)
        timed("train_f32", train_f32_phase, torch, np, kernels)
        timed("rtc", rtc_phase, torch, np, kernels)
        timed("resnet", resnet_phase, torch, np)
        timed("gluon", gluon_phase, torch, np)
        timed("rnn", rnn_phase, torch, np)
        timed("optim", optim_phase, torch, np, sgd)
        timed("zoo", zoo_phase, torch, np)
        timed("structured", structured_phase, torch, np)
        timed("symbol", symbol_phase, torch, np)
        timed("levers", levers_phase, torch, np, kernels, sgd)
        # a hung loader worker or decode thread ends the run here, with
        # every thread's stack, rather than at the call's time limit
        faulthandler.dump_traceback_later(DATA_DEADLINE_S, exit=True)
        timed("data", data_phase, torch, np)
        faulthandler.cancel_dump_traceback_later()
        # a client or batcher thread that hangs ends the run here too
        faulthandler.dump_traceback_later(SERVE_DEADLINE_S, exit=True)
        timed("serve", serve_phase, torch, np)
        faulthandler.cancel_dump_traceback_later()
        # an example that hangs ends the run here too
        faulthandler.dump_traceback_later(KV_DEADLINE_S, exit=True)
        timed("kvstore", kvstore_phase, torch, np)
        faulthandler.cancel_dump_traceback_later()
        # so does a hung client, scrape, batcher or recorder child
        faulthandler.dump_traceback_later(OBS_DEADLINE_S, exit=True)
        timed("obs", obs_phase, torch, np)
        faulthandler.cancel_dump_traceback_later()
        # so does a hung trace, fit or CLI process
        faulthandler.dump_traceback_later(ANALYSIS_DEADLINE_S, exit=True)
        timed("analysis", analysis_phase, torch, np)
        faulthandler.cancel_dump_traceback_later()
        # phase 22's supervised runs go beside phase 21 (see start_drill)
        drill = start_drill()
        try:
            # so does a hung replica, gateway or client
            faulthandler.dump_traceback_later(FLEET_DEADLINE_S, exit=True)
            timed("legacy_tools_fleet", legacy_tools_fleet_phase, torch, np)
            faulthandler.cancel_dump_traceback_later()
            # so does a hung supervisor, training child or probe
            faulthandler.dump_traceback_later(ELASTIC_DEADLINE_S, exit=True)
            timed("elastic_tune", elastic_tune_phase, torch, np, drill)
            faulthandler.cancel_dump_traceback_later()
        finally:
            for run in drill[1]:
                run.kill()
            import shutil
            shutil.rmtree(drill[0], ignore_errors=True)
        timed("fused_update", fused_update_phase, torch, np, children)
        torch.cuda.synchronize()
    except SmokeFailure as exc:
        print("chip_smoke: FAILED: %s (phase seconds: %s)"
              % (exc, json.dumps(PHASE_SECONDS)), file=sys.stderr)
        return 1
    finally:
        for proc, _out, _log in (children or {}).values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    log("phase seconds: %s" % json.dumps(PHASE_SECONDS))
    log(json.dumps({"kernels": list(kernels.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
