#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA card.

Drives ``mxnet_tpu_torch``'s main paths at full width, with seeded random
weights, and holds each hand-written CUDA kernel against its plain version
on the card:

* serving — ``GenerationServer.submit_async`` -> scheduler ->
  ``GenerationEngine`` -> ``TransformerLM.prefill`` / ``decode_step`` — on
  the flagship TransformerLM (vocab 32000, d_model 2048, 16 heads of 128,
  4 layers, d_ff 8192, bf16), and around it the serving plane on the same
  model: QoS preemption, live KV migration, load replay, tenancy and
  operations (``swap_params``, the SIGTERM drain);
* training — ``make_train_step`` -> ``TransformerLM.loss`` -> ``apply`` and
  its backward, SGD with momentum — on the flagship at batch 8 x 1024
  (bench.py's training configuration: dense attention, no remat) and on
  the long-context configuration (d_model 1024, 16 heads of 64, 4 layers,
  d_ff 4096, bf16, remat, batch 1 x 8192: bench.py's long-context leg),
  which crosses the dense->flash gate and so runs the flash forward, dQ
  and dK/dV kernels, and on that configuration in f32, whose flash
  forward, dQ and dK/dV run the tensor-core tf32x3 kernels' narrow plans
  (split-TF32 products at head_dim 64), and on the same configuration
  with 4 heads of 256
  (Gemma-style head_dim), whose flash forward, dQ and dK/dV run the
  tensor-core wgmma_wide kernels, and on that configuration in f32, whose
  flash forward, dQ and dK/dV run the tensor-core tf32x3 kernels
  (split-TF32 products), and with 2 heads of 512 at batch 2 x 8192,
  whose flash forward, dQ and dK/dV run the tensor-core wgmma_xwide
  kernels, and that in f32, whose flash forward, dQ and dK/dV run the
  tensor-core tf32x3_xwide kernels (2-CTA clusters that split D), and
  with one head of 1024 at batch 4 x 8192, whose flash forward, dQ and
  dK/dV run the tensor-core wgmma_xxwide kernels (2-CTA clusters);
* INT8 inference — the symbolic ResNet-50 (``models/resnet_symbol.py``,
  1000 classes, 3x224x224) is calibrated, quantized, BN-folded and
  int8-fused by ``contrib.quantization.quantize_model``, bound, and run at
  batch 128, with the int8 matmul kernel in its classifier; and
  ``nd.contrib.quantized_dense`` on the classifier's int8 inputs, with the
  int8 matmul's fused-dequant kernel; and bench.py's interleaved bf16 vs
  int8 VGG16 pair: the Gluon ``vgg16`` exported (``HybridBlock.export``),
  read back (``model.load_checkpoint``), quantized, saved
  (``save_checkpoint``) and served through ``gluon.SymbolBlock.imports``,
  with the int8 matmul kernel in its three fully connected layers, against
  the bf16 Gluon net, each a CUDA graph of chained forwards;
* detection — MXNet example/ssd's SSD-300 on VGG16-reduced (8732
  anchors, 20 classes, f32, batch 8) trained five steps through
  ``autograd`` and ``gluon.Trainer`` (``MultiBoxTarget``, softmax
  cross-entropy plus smooth L1) and decoded (``MultiBoxDetection``), whose
  per-class NMS is the hand-written greedy-NMS kernel; Faster R-CNN's
  ``Proposal`` and ``ROIPooling`` at a 600x800 image's conv5 size;
* the vision model zoo — one fp32 forward of each family ported (VGG,
  AlexNet, SqueezeNet, MobileNet V1 and V2, DenseNet, Inception V3) at its
  published input size, held to the same weights in float64 on the CPU,
  and each one's export served through ``predict.Predictor``;
* symbolic training — ``Module.fit`` of the same ResNet-50 at
  train_imagenet.py's settings (batch 32, SGD with momentum and weight
  decay, a MultiFactorScheduler, accuracy, ``Uniform(0.01)``), f32, and
  its checkpoint (``save_checkpoint`` with the optimizer's states,
  ``Module.load``) resumed for one step;
* user kernels — CUDA source compiled at runtime by ``mx.rtc`` (NVRTC)
  and launched from a ``CustomOp`` (``rtc_softmax``) on that path: in
  ``example/numpy-ops/custom_softmax.py``'s training and as ResNet-50's
  head;
* recurrent models — the LSTM language model (example/rnn/word_lm.py and
  bucketing.py, through ``Module`` and ``BucketingModule``) and Gluon's
  recurrent layers (example/bi-lstm-sort), on cuDNN's fused RNN; and
  BASELINE.json's LeNet MNIST config through ``Module.fit``;
* imperative training — ``autograd`` and Gluon: bench.py's train leg
  (``gluon.model_zoo.vision.resnet50_v1``, batch 128, bf16 with f32
  master weights, hybridized, ``gluon.contrib.FusedTrainStep``) and
  BASELINE.json's Gluon ResNet-18 CIFAR-10 config (record -> backward ->
  ``Trainer.step``); no hand-written kernel is on this path;
* inference, model serving and numerical health — bench.py's inference,
  latency_b1, serving and sentinel legs: the same ResNet-50 through
  ``benchmark.compiled_throughput`` (a CUDA graph) and
  ``percall_throughput``; bench.py's serving MLP through ``predict.
  Predictor`` and ``serving.ModelServer``; the bf16 step under
  ``FusedTrainStep(numeric_guard="skip")`` with ``chaos`` faults.

Run from the root of the repository, with no arguments::

    python3 chip_smoke.py

``--profile`` adds, after the detection phase, a traced SSD-300 training
step and decode, and a last phase that traces one long prefill, a few decode
iterations, one training step of each training configuration, one fp32
and one int8 ResNet-50 forward, one int8 and one bf16 VGG16 forward (the
pair's nets at batch 128), one ResNet-50 Module training step, one
Gluon ``FusedTrainStep`` at the gluon_train settings and one word_lm step
(with and without its Perplexity update) with ``torch.profiler`` (where
the device time goes).

Phases, in order; any failure raises and exits non-zero:

1. device  — the card's name and ``nvidia-smi`` name / power limit;
2. build   — ``nvcc`` builds every kernel from ``mxnet_tpu_torch/ops/
   kernels/csrc`` (in parallel), with the ptxas register/spill report and
   one line per instantiation of the tensor-core flash kernels (forward,
   dQ and dK/dV at head_dim 64 and 128; wgmma_wide at 192 and 256; the
   f32 tf32x3 forward, dQ and dK/dV at 192 and 256; the wgmma_xwide
   forward at 320, 384, 448 and 512 and the wgmma_xxwide forward (the
   same kernel in 2-CTA clusters) at 640, 768, 896 and 1024, all eight of
   them, and wgmma_xwide's dQ and dK/dV at 320-512 and wgmma_xxwide's
   (the same kernels in 2-CTA clusters) at 640-1024, all sixteen; the f32
   tf32x3_xwide forward, dQ and dK/dV at 384 and 512, the six cluster
   instantiations beside tf32x3's six; tf32x3's narrow dQ and dK/dV at 64
   and 128, all four), of the wide flash kernels,
   of
   the int8 matmul and of the RMSNorm variants; none but the int8 ``mma``
   kernel may spill;
3. kernels — each kernel against its plain version at the flagship's
   shapes: max error and tolerance; the device time of the kernel, of the
   plain version and of one PyTorch library call (for the record only),
   each from a CUDA graph of repeated calls replayed between CUDA events;
   and the card's bound for the same work (for f32 flash, both the bound
   at three TF32 products, the least time for f32-accurate products on
   the tensor cores, and the CUDA-core bound).  RMSNorm at the main
   paths' five bf16 shapes and two f32 ones: the planned variant and the others
   (warp, block, simt) held against the plain version, two calls of each
   bit-identical, timed in turns beside ``F.rms_norm``; and the plain
   RMSNorm backward's device time at the training steps' shapes.  At the
   two main flash shapes
   ([1, 4096, 16, 128] and [1, 8192, 16, 64], causal bf16) the forward's
   and the backward's tensor-core (wgmma) and CUDA-core (simt) variants
   are all held against the plain version and timed in turns; the
   backward is also held against autograd through the dense forward and
   two of its calls must agree bit for bit; head_dim 96 runs padded to
   128; in bf16, head dims 160, 192 and 256 run the tensor-core
   wgmma_wide forward and backward (at [1, 4096, 16, 256] both held
   against the plain version beside their CUDA-core twin, wide, and
   timed in turns with it; also at the head_dim-256 leg's [1, 8192, 4,
   256] and with Tq != Tk), and in f32 the tensor-core tf32x3 forward,
   dQ and dK/dV (at [1, 4096, 16, 256] the forward held against the
   plain version and the backward against the plain backward and dense
   autograd, each beside its wide twin and timed in turns with it; the
   forward also in turns at the f32 leg's [1, 8192, 4, 256]; both also
   at [1, 8192, 4, 256], [1, 4096, 16, 192], Tq 1000 x Tk 3000 not
   causal, and head_dim 160, the backward with an lse cotangent), and f32
   at head_dim 33-128 the tensor-core tf32x3 forward, dQ and dK/dV (the
   narrow plans), the forward held against the plain version, the
   backward against the plain backward and dense autograd, each timed in
   turns with simt, the CUDA-core kernels they replaced, at
   [2, 1024, 8, 64] (the backward with an lse cotangent), the f32
   long-context leg's [1, 8192, 16, 64] and [1, 4096, 16, 128], and also
   at head_dim 40 and 96 (padded to 64 and 128; the backward with dlse),
   Tq 1000 x Tk 3000 not causal and, the forward, kv_len below Tk; the
   widths simt still serves (head_dim 16 and 32, bf16 and f32) beside
   SDPA at [1, 4096, 16, 32] and [1, 4096, 16, 16]; and f32
   above 256 the forward, dQ and dK/dV on the tensor-core tf32x3_xwide
   kernels (2-CTA clusters that split D), the forward held against the
   plain version, the backward against the plain backward and dense
   autograd (1e-4 of each gradient's largest entry), each timed in turns
   with wide at [2, 8192, 2, 512] (the f32 hd512 leg's shape), [1, 4096,
   16, 512] and [2, 1000, 4, 320] not causal (run at 384, wide at 320),
   the backward also at [1, 4096, 16, 384] causal with an lse cotangent;
   bf16 at head_dim 576 (run at 640) on the tensor-core wgmma_xxwide
   forward, dQ and dK/dV (2-CTA clusters that split D) at [2, 1000, 4,
   576] not causal and [1, 4096, 16, 576] causal, and at 1024 at the
   head_dim-1024 leg's [4, 8192, 1, 1024], each in turns with wide and
   beside SDPA (the backward also against dense autograd within 6.5e-3 of
   each gradient's largest entry); bf16 above 256 runs the tensor-core
   wgmma_xwide forward, dQ and dK/dV, the forward held against the plain
   version, the backward against the plain backward and dense autograd
   (within 6.5e-3 of each gradient's largest entry), each beside its wide
   twin and timed in turns with it at [1, 4096, 16, 512] and [1, 4096,
   16, 384] causal, at the head_dim-512 leg's [2, 8192, 2, 512] and at
   [2, 1000, 4, 320] not causal; every tensor-core forward held in the
   kernels phase gives the same bits in two calls.  The widths wide still
   serves, forward and backward beside SDPA: f32 at [2, 1000, 4, 576] not
   causal, bf16 at [1, 1024, 2, 1152] causal.  Every backward's library
   figure is SDPA's backward on inputs cycled past the L2 cache, replayed
   from a CUDA graph as the kernels are.  The int8
   matmul's planned variant and, where that is wgmma, its mma variant are
   held bit for bit to the plain version and timed in turns beside
   ``torch._int_mm`` at 2048^3, VGG16's fc6 / fc7 / fc8 (batch 128),
   ResNet-50's classifier and a ragged shape;
4. serve   — a flagship ``GenerationServer`` answers 7 concurrent greedy
   requests (one ~4000-token prompt crosses the flash gate), a solo
   resubmission must reproduce its batched stream, the kernel counters
   must show the CUDA kernels on the path (every flash forward, one per
   layer of the long prompt's prefill, through the tensor-core variant;
   every RMSNorm through the vector variants, warp for each prefill bucket
   the planner gives it, block for the rest),
   and the prefill logits through
   the kernels must match those through the plain versions;
4b. the serving plane, on the serve phase's model (one decode slot bucket
   of 8, page_size 16; each path's kernel counters zeroed just before it
   and read just after, with no plain version, every RMSNorm through warp
   or block and every flash forward through wgmma):
   serve_qos — six rank-0 streams (1024-token prompts, 64 new) fill 408
   pages, two ``gold=5`` requests preempt (at least one preemption,
   nothing shed, every stream complete, each gold's first token before
   the first rank-0 completion), then a ``page_pressure`` chaos run in
   which every stream completes;
   serve_migrate — two servers over one model; at 256, 1024 and 4000
   tokens a greedy stream parked after 4 tokens is exported, imported
   and attached on the other (bit for bit the unparked stream, no
   prefill on the receiver), 3 times, against the ``resume_from``
   re-prefill (park-to-next-token ms of each, blob bytes); the resume
   path's first-token logits within ``LOGITS_ATOL`` of the unmigrated
   decode's; a corrupt blob refused and the stream resumed; ``defrag``
   with holes, streams bit for bit; no page held and the leak ledger
   quiescent after drain;
   serve_loadreplay — bench.py's loadreplay leg: capacity from an
   as-fast-as-possible burst, a ``loadgen`` trace at twice it for 8 s
   (prompts 128 tokens mean, 1024 max; outputs 32 mean, 64 max; queue 8;
   deadline 8 s): typed outcomes only, ok and Overloaded both, no
   recompile, goodput, TTFT p50 / p99 (``gen.ttft_ms``), shed rate, knee;
   serve_tenant — bench.py's tenant leg: gold / free / bulk (4 / 2 / 1,
   bulk's quota rate 2 burst 2), 12 req/s for 6 s replayed at speed 2,
   clean and with ``tenant_flood`` on three bulk requests: QuotaExceeded
   for bulk only, the victims' TTFT p99 ratio;
   serve_ops — ``swap_params`` to a perturbed copy mid-stream (no
   recompile; afterwards a stream equals a fresh server's on the new
   weights), then ``install_preemption_drain`` and SIGTERM to itself (a
   new submit raises Draining, the streams in flight complete);
5. train   — for each training configuration, one warm step and then
   ``TRAIN_STEPS`` timed steps on one fixed batch: losses must be finite
   and fall, the kernel counters must show exactly the expected launches
   per step (RMSNorm's all through the warp variant) and no plain
   version; then, on each long-context
   configuration, the loss and every parameter gradient through the
   kernels must match those through the plain versions;
5b. mesh_nccl — the device mesh at world size 1: a child rank process
   (``tools/launch.py -n 1``, NCCL: a real communicator, every collective
   of the step runs) takes the flagship step with
   ``make_train_step(rules=default_rules())`` under ``make_mesh(dp=1)``
   against the meshless step on the same numpy weights (loss within
   ``MESH_LOSS_REL``, every parameter after the step bit for bit, the
   expected launches, no plain version), and a
   ``dist_sync`` KVStore push / pull that must return the pushed bits;
5c. multirank — two rank processes on the one card over gloo (NCCL
   refuses two ranks on one device), started by ``tools/launch.py``:
   first each collective on CUDA tensors against its exact result (which
   gloo takes on the card, which it copies through host memory); then each
   leg's single-rank gradient and two steps on the same weights, then the
   leg's gradient held to it (``MULTIRANK_GRAD_REL``) and two steps, each
   loss held to its own by ``tools/dryrun.py``'s loss parity, the second
   timed (see ``MULTIRANK_LEGS``): tp=2, fsdp=2 (with the ZeRO bytes check) and ep=2
   (MoE, 8 experts) on the flagship, pp=2 (its block as two stages, 4
   microbatches of 2; gradients against the sequential stages), sp=2
   (ring attention) and tp=2 (flash on 8 local heads) on the long-context
   configuration, and ``ring_attention(use_pallas=True)`` at [1, 8192,
   16, 64] bf16 split two ways against the one-card flash kernel (o, dq,
   dk, dv); per leg and rank: wall ms, peak memory, the ops gloo copied
   through host memory (``parallel.host_staged.*``), loss and its
   difference from the single-rank step; gates: every rank launched the
   kernels its leg reaches (RMSNorm, cross-entropy, and the flash
   forward, dQ and dK/dV through ``.wgmma``), no plain version ran; then
   flash at the tp=2 local shape [1, 8192, 8, 64] against its plain
   version and SDPA.  Two ranks on one card share its SMs: their times
   are not scaling figures;
6. module_train — ``Module.fit`` of ResNet-50 on 256 seeded images in
   batches of 32 (one warm step, then 7 timed, each ending in a
   synchronize): losses finite, 8 updates, the data BatchNorm's moving
   statistics equal to 8 EMA steps of the batches' moments (each step
   updates them exactly once), every moving statistic moved; then one
   ``forward_backward`` and ``update`` at batch 4 on the card against the
   same on the CPU: in float64 every gradient, moving statistic and update
   within ``MODULE_CHECK_REL_F64``; in f32 every moving statistic within
   ``MODULE_CHECK_REL``, and each device's f32 gradients reported against
   the float64 step; then the checkpoint round trip: after the fit,
   ``save_checkpoint(save_optimizer_states=True)``, ``Module.load(
   load_optimizer_states=True)`` on the card and one more step on the next
   batch, which must equal the fitted module's own next step bit for bit
   (parameters, moving statistics and momenta; cuDNN deterministic for the
   two steps);
7. rtc — (a) the reference's templated ``axpy<float>`` / ``axpy<double>``
   and tests/test_rtc.py's kernels in CUDA, equal to torch; a second
   module of the same source and a second launch compile nothing; the host
   cost of one launch; (b) the custom-softmax example through
   ``rtc_softmax`` and through ``numpy_softmax`` from the same parameters:
   accuracy at least 0.9, parameters within ``RTC_FIT_REL``, exactly the
   expected launches; (c) one ResNet-50 step at batch 32 with the head
   swapped for each: every gradient within ``RTC_STEP_REL``, one launch of
   each kernel; and the two kernels against numpy_softmax at [32, 1000]
   and [64, 4], timed.

8. gluon_train — bench.py's train leg at its settings (see GLUON_*): 3
   warm ``FusedTrainStep`` calls, then ``GLUON_TIMED`` timed ones, each
   ending in a synchronize: ms per step, img/s, peak memory, the losses;
   gates: finite losses, one update per step, bf16 weights beside f32
   BatchNorm Parameters, one f32 master per bf16 weight, a bf16 loss of
   shape (128,); the step accountant's
   ``train.fused.*`` gauges (mfu, hbm_util, items_per_sec) present;
9. gluon_infer — bench.py's inference and latency_b1 legs on
   gluon_train's net and batch (see INFER_*): ``benchmark.
   compiled_throughput`` (one CUDA graph of 30 chained forwards, one
   replay per draw, 5 draws), ``percall_throughput`` (30 x 5) and batch 1
   (100 x 3): img/s median / min / max, ms at batch 1, peak memory; gates:
   the graph's chain equals the eager chain bit for bit (the same
   kernels on the same inputs), one replay per draw, the probe leaves the
   input unchanged;
10. serving_front — bench.py's serving leg (see SERVE_*): the bare
   ``Predictor`` against ``serving.ModelServer`` on the card, 400
   requests: p50 / p99 of each (the served ones from the
   ``serving.latency_ms`` histogram), the p99 overhead, a burst of 4 x
   max_queue (shed rate, burst p99, queue peak, batch counts); gates:
   every served output equals the bare Predictor's at its batch's shape
   bit for bit, every outcome typed, the queue bounded, nothing pending
   after drain; then two replicas under ``replica_crash`` /
   ``slow_replica``: every request typed, failovers and hedges above 0;
11. sentinel — bench.py's sentinel leg (see SENTINEL_*): gluon_train's
   step against ``FusedTrainStep(numeric_guard="skip")`` in 9 interleaved
   pairs of 15-step windows: the median per-pair overhead, the guard's
   img/s, and each step's host time from an idle card;
   gates: a ``nan_grad`` step leaves every parameter, BatchNorm statistic
   and optimizer-state buffer bitwise unchanged, records ``skip``, and the
   steps after it stay finite; a finite guarded step equals the unguarded
   one bit for bit (cuDNN deterministic, two unguarded steps agreeing
   first); ``flip_param_bit`` flips one bit of one f32 element;
12. int8   — the fp32 ResNet-50 graph at batch 128 (one warm forward, then
   ``INT8_TIMED`` timed), ``quantize_model`` (naive calibration on 32
   images in batches of 16, fold_bn, fuse_int8), the int8 graph (one warm
   forward, then ``INT8_TIMED`` timed): the op counts must equal the JAX
   package's, the int8 outputs must keep a cosine above 0.99 with the
   fp32 ones, the int8 forward through the kernels must equal the one
   through the plain versions bit for bit, the int8 matmul must launch
   exactly once per forward, through its wgmma variant, and
   ``quantized_dense`` on the classifier's int8 inputs must equal
   ``dequantize(quantized_fully_connected(...))`` and launch the
   fused-dequant kernel's wgmma variant once, and
   ``int8_vs_bf16``: the int8 forwards' img/s over gluon_infer's per-call
   bf16 figure (both per-dispatch timings);
12b. int8_vgg16 — bench.py's pair at its settings (see VGG_*): the
   exported fp32 ``SymbolBlock``'s logits must equal the Gluon net's
   (``VGG_EXPORT_REL``), the int8 ``SymbolBlock``'s outputs through the
   kernels must equal those through the plain versions bit for bit (on a
   difference, each fully connected layer's largest int32 difference is
   named), one forward must launch the int8 matmul once per fully
   connected layer by the variant ``plan_int8_matmul`` names (and
   split-K's adding kernel), no plain version, and the pair's draws that
   many times a forward; ``interleaved_throughput``'s alternating draws
   (steps=20, reps=3) give ``int8_vgg16_img_per_sec``,
   ``int8_vgg16_bf16_img_per_sec`` and ``int8_vgg16_vs_bf16`` with their
   spreads, and the peak memory;
12c. zoo — ``vgg16``, ``alexnet``, ``squeezenet1.0``, ``mobilenet1.0``,
   ``mobilenetv2_1.0``, ``densenet121`` (224^2) and ``inceptionv3``
   (299^2), seeded Xavier weights, batch 8, fp32 on the card (TF32 off):
   the logits within ``ZOO_REL`` of the same net's in float64 on the CPU,
   the export served through ``predict.Predictor`` on the card within
   ``ZOO_EXPORT_REL`` of the Gluon logits, and each forward's ms;
12d. detection — SSD-300 (see SSD_*): five steps on one seeded batch of
   8 synthetic scenes (the loss must fall), ms a step, img/s, peak
   memory, then the decode (nms 0.45, nms_topk 400) five times, its ms and
   the greedy-NMS kernel's launches (one a decode; no plain version);
   MultiBoxTarget and MultiBoxDetection on the last step's tensors, card
   against CPU (positives, their classes, negative counts and decoded ids
   exact, at most ``SSD_MINING_SWAPS`` mining swaps an image, loc targets
   and boxes within ``SSD_CARD_CPU_TOL``); the NMS kernel against its
   plain version bit for bit on the decode's sorted boxes at nms_topk 400
   and -1, each timed beside the plain version, with the bound from the
   bytes and the IoU evaluations those boxes need; Proposal (see RPN_*:
   ``RPN_MATCH`` of its ROIs among the CPU's) and ROIPooling 7x7 over its
   300 ROIs (bit for bit), card against CPU;
13. gluon_cifar — resnet18_v1 thumbnail, f32, hybridized, 20 steps of
   record -> backward -> ``Trainer.step`` on one seeded batch of 128: the
   loss must fall below ``CIFAR_FALL`` times the first;
14. gluon_step_card_vs_cpu — one Gluon step at batch 4: float64 on the
   card against the CPU within ``MODULE_CHECK_REL_F64``, f32 hybridized
   against not on the card within ``GLUON_HYBRID_REL``;
14b. the recurrent phases and the MNIST config (no hand-written kernel
   is on them; each gates that none launched): word_lm —
   example/rnn/word_lm.py's graph through ``Module`` at MXNet's word_lm
   medium width (vocab 10000, 650 / 650, 2 layers, bptt 35, batch 32;
   see LM_*): ms a step, tokens/s, peak memory, perplexity; gates: cuDNN's
   RNN (``CudnnRnnBackward0``, and no plain loop) in the graph's backward,
   ``rnn_cudnn`` against ``rnn_reference`` at the phase's shapes (f32,
   TF32 off; forward, hy / cy and every gradient), timed beside
   ``torch.nn.LSTM`` on the same weights in one buffer, one float64
   ``Module`` step at full width on the card against the CPU;
   bucketing — bucketing.py's sym_gen under ``BucketingModule`` over its
   four buckets at word_lm's width: each bucket bound once, every switch
   carrying the updated parameters, one shared optimizer, a float64 batch
   per bucket on the card against the CPU; gluon_rnn —
   bi-lstm-sort's SortNet (a bidirectional ``gluon.rnn.LSTM``) trained
   with Adam: accuracy per epoch rising, cuDNN in the backward, the
   hybridized layer equal to eager; mnist — train_mnist.py's mlp and
   lenet through ``Module.fit`` for one epoch: img/s, held-out accuracy
   above chance, a float64 step on the card against the CPU;
15. racecheck — bench.py's racecheck leg (see RACECHECK_*): a tracked
   counter bumped under a held lock, 100 000 ops, 5 interleaved off/on
   pairs, the field seeded into shared-modified from a second thread:
   checked ops/s and the median per-pair overhead; gates: no race, and
   ``threading.Lock`` the stdlib factory again afterwards;
16. kernels_leg — bench.py's kernels leg through the kernel library's
   front door (the JAX-form ``select_impl`` and ``kernel_unit``): flash
   forward + backward of ``(o.float() ** 2).sum()`` at [1, 2048, 4, 64]
   bf16 causal against materialized-scores attention (tokens/s, 10 steps
   x 3 reps), and the int8 matmul with per-channel dequant at 2048^3
   against a bf16 product (GFLOP/s, interleaved draws); first the leg's
   flash shape against the plain versions (forward, dQ, dK/dV ms, bounds)
   and SDPA's forward + backward; gates: ``pallas_mode() == "auto"``, both
   impls ``'cuda'``, each of the four wgmma kernels launched once per step,
   no plain version, the flash gradients within 2^-6 of each gradient's
   largest entry of the plain version's and of dense autograd's;
17. tenant_scaleup — bench.py's tenant leg, its scale-up A/B: SimFleet on
   the seed-33 burst trace (3 s at 2 rps, then 6 s at 60), 2 to 12
   replicas, reactive and predictive: mean lags and scale-up counts; gate:
   a second run of each gives the same lags (host only, deterministic);
18. gateway — bench.py's gateway leg: the demo model's direct p99 (200
   requests); two spawned ``python -m mxnet_tpu_torch.fleet_worker``
   processes serving it behind a ``Gateway``: 200 sequential requests
   (``gateway_p99_ms``, ``gateway_route_p99_ms``), a burst of 64 clean and
   with one worker SIGKILLed at request 16; then the generation kill
   burst with two workers serving the flagship at full width
   (``flagship_generation_worker``, the serve phase's configuration): 8
   streams (two past the flash gate), 12 new tokens each, clean and with
   the worker holding the most streams SIGKILLed once every stream has
   streamed a token; gates: typed outcomes only, the clean bursts all ok,
   at least one stream resumed on the sibling and each resumed stream that
   ended ok delivering all 12 tokens (the leading tokens agreeing with the
   clean run are reported: a resume re-prefills, and bf16 prefill and
   decode can part at a near-tie), and in the generation workers (their
   counters written at their drain) RMSNorm's warp and block and the flash
   forward's wgmma variant launched, no plain version.

Each main path (serve, each serving-plane path, each training
configuration, the mesh_nccl step, each rank's multirank leg, the timed int8
forwards, the ``quantized_dense`` call, the int8 VGG16's counted forward
and the pair's draws, the SSD-300 steps and decodes, ``Module.fit``, the
example's
training through ``rtc_softmax`` and the ResNet-50 step through it, the
kernels leg, and each generation worker's served streams) runs
with the counters zeroed
just before it and read just after.  The line before the
last is the ``{"kernels": [...]}`` summary (launches summed over those
runs; each kernel with several variants lists them, with their sources,
launches and times), before it the ``nvidia-smi`` name and power limit,
and before that the script's total wall time; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits non-zero and prints no result.
"""
import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import time

# published dense peaks of one H100 SXM (NVIDIA data sheet); roofline
# bounds below are against these, with the card's power limit printed beside
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12,
              "tf32": 495e12}

FLAGSHIP = dict(vocab_size=32000, d_model=2048, n_heads=16, n_layers=4,
                d_ff=8192, max_len=8192, dtype="bfloat16")
PROMPT_LENS = (16, 40, 100, 256, 384, 512, 4000)
MAX_NEW = 32
SOLO_INDEX = 1
# flash forward launches of the serve phase: only the ~4000-token prompt
# crosses the dense->flash gate, once in each of the flagship's 4 layers,
# and each must go through the tensor-core variant (bf16, head_dim 128)
SERVE_FLASH_LAUNCHES = 4
# kernel-vs-plain prefill logits (bf16 model, logits of order 1): the two
# paths round activations to bf16 at other points (flash keeps p in f32,
# dense rounds it), and one-ulp flips (2^-8 relative) compound over 4 layers
LOGITS_ATOL = 5e-2

# the serving plane's phases run the serve phase's flagship model unchanged
# (greedy, page_size 16, one decode slot bucket of 8).  One KV page holds
# 4 layers x 16 tokens x 16 heads x 128 x 2 B x 2 (K and V) = 0.5 MB.
# serve_qos: six rank-0 streams of a 1024-token prompt and 64 new tokens
# (68 pages each) fill 408 pages; then two gold=5 requests of that shape
QOS_PROMPT, QOS_NEW, QOS_LOW, QOS_GOLD = 1024, 64, 6, 2
QOS_PAGES = QOS_LOW * ((QOS_PROMPT + QOS_NEW) // 16) + 1
# serve_migrate: a greedy stream at each context parked after 4 tokens and
# carried to a second server over the same weights, 3 times each
MIGRATE_CONTEXTS = (256, 1024, 4000)
MIGRATE_NEW = 24
MIGRATE_PARK_AFTER = 4
MIGRATE_REPS = 3
# defrag: three streams; the middle one ends early and leaves holes
DEFRAG_PROMPTS = (512, 256, 1024)
# serve_loadreplay (bench.py's loadreplay leg at full width) and
# serve_tenant (its tenant leg's isolation half): the trace's lengths
TRACE_LENGTHS = dict(prompt_len_mean=128.0, prompt_len_max=1024,
                     output_len_mean=32.0, output_len_max=64)
TRACE_DEADLINE = [{"name": "std", "deadline_ms": 8000.0, "weight": 1.0}]
LOADREPLAY_S = 8.0
LOADREPLAY_QUEUE = 8
TENANTS = [{"name": "gold", "weight": 4}, {"name": "free", "weight": 2},
           {"name": "bulk", "weight": 1}]
TENANT_RPS, TENANT_S, TENANT_SPEED = 12.0, 6.0, 2.0
# the tenant phase's queue: deep enough that gold and free never reach
# their weighted-fair share at this offered load (the gate is the quota)
TENANT_QUEUE = 64

# RMSNorm at the main paths' shapes, bf16 (N, E): decode at 7-8 streams
# (the slot bucket of 8), the 4000-token prompt (which prefills at its 4096
# bucket), 4096 rows, the flagship step (8 x 1024 rows), the long-context
# step (8192 rows of 1024); then the two f32 shapes timed since the first
# port, and the plain backward at the two training steps' shapes
RMSNORM_SHAPES = ((8, 2048), (4000, 2048), (4096, 2048), (8192, 2048),
                  (8192, 1024))
RMSNORM_F32_SHAPES = ((4096, 2048), (8, 2048))
RMSNORM_BWD_SHAPES = ((8192, 2048), (8192, 1024))

# the training configurations: (name, config, batch, sequence length)
LONGCTX = dict(vocab_size=32000, d_model=1024, n_heads=16, n_layers=4,
               d_ff=4096, max_len=8192, dtype="bfloat16", remat=True)
# the same in f32 (TF32 off, torch's default for matmuls): its flash
# forward, dQ and dK/dV on the tensor-core tf32x3 kernels' narrow plans
# (head_dim 64)
LONGCTX_F32 = dict(LONGCTX, dtype="float32")
LONGCTX_HD256 = dict(LONGCTX, n_heads=4)
# the same in f32 (TF32 off, torch's default for matmuls): its flash
# forward and backward on the tensor-core tf32x3 kernels
LONGCTX_HD256_F32 = dict(LONGCTX_HD256, dtype="float32")
# 2 heads of 512 at batch 2 (at batch 1 the dense scores, 537 MB, would
# stay under the flash gate): the flash forward and backward on the
# tensor-core wgmma_xwide kernels
LONGCTX_HD512 = dict(LONGCTX, n_heads=2)
# the same in f32: its forward, dQ and dK/dV on the tensor-core tf32x3_xwide
# kernels (2-CTA clusters that split D)
LONGCTX_HD512_F32 = dict(LONGCTX_HD512, dtype="float32")
# one head of 1024 at batch 4 (at batch 3 the dense scores, 768 MiB, would
# stay at the flash gate): the flash forward, dQ and dK/dV on the
# tensor-core wgmma_xxwide kernels (2-CTA clusters that split D)
LONGCTX_HD1024 = dict(LONGCTX, n_heads=1)
TRAIN_CELLS = (
    ("flagship_b8_t1024", dict(FLAGSHIP, max_len=1024, remat=False), 8,
     1024),
    ("longctx_b1_t8192", LONGCTX, 1, 8192),
    ("longctx_f32_b1_t8192", LONGCTX_F32, 1, 8192),
    # the long-context configuration with 4 heads of 256 (Gemma-style
    # head_dim): the flash forward and backward on the tensor-core
    # wgmma_wide kernels
    ("longctx_hd256_b1_t8192", LONGCTX_HD256, 1, 8192),
    ("longctx_hd256_f32_b1_t8192", LONGCTX_HD256_F32, 1, 8192),
    ("longctx_hd512_b2_t8192", LONGCTX_HD512, 2, 8192),
    ("longctx_hd512_f32_b2_t8192", LONGCTX_HD512_F32, 2, 8192),
    ("longctx_hd1024_b4_t8192", LONGCTX_HD1024, 4, 8192),
)
TRAIN_STEPS = 3
# kernel launches per training step, from the code: RMSNorm twice per block
# and once before the logits, and with remat once more per block for the
# recomputed forward, every one through the warp variant (8192 rows, 16384
# at batch 2, 32768 at batch 4); flash forward per block (twice with
# remat), every one through the tensor-core variant (bf16: wgmma at
# head_dim 64, wgmma_wide at 256, wgmma_xwide at 512, wgmma_xxwide at 1024;
# f32: tf32x3 at 64 and 256, tf32x3_xwide at 512); dQ and dK/dV once per
# block, through the same variant; the softmax cross-entropy once each
# way
EXPECTED_LAUNCHES = {
    "flagship_b8_t1024": {"fused_rmsnorm": 9, "fused_rmsnorm.warp": 9,
                          "fused_softmax_xent": 1,
                          "fused_softmax_xent_bwd": 1},
    "longctx_b1_t8192": {"fused_rmsnorm": 17, "fused_rmsnorm.warp": 17,
                         "flash_attention": 8,
                         "flash_attention.wgmma": 8,
                         "flash_attention_dq": 4, "flash_attention_dkv": 4,
                         "flash_attention_dq.wgmma": 4,
                         "flash_attention_dkv.wgmma": 4,
                         "fused_softmax_xent": 1,
                         "fused_softmax_xent_bwd": 1},
    "longctx_f32_b1_t8192": {"fused_rmsnorm": 17, "fused_rmsnorm.warp": 17,
                             "flash_attention": 8,
                             "flash_attention.tf32x3": 8,
                             "flash_attention_dq": 4,
                             "flash_attention_dkv": 4,
                             "flash_attention_dq.tf32x3": 4,
                             "flash_attention_dkv.tf32x3": 4,
                             "fused_softmax_xent": 1,
                             "fused_softmax_xent_bwd": 1},
    "longctx_hd256_b1_t8192": {"fused_rmsnorm": 17, "fused_rmsnorm.warp": 17,
                               "flash_attention": 8,
                               "flash_attention.wgmma_wide": 8,
                               "flash_attention_dq": 4,
                               "flash_attention_dkv": 4,
                               "flash_attention_dq.wgmma_wide": 4,
                               "flash_attention_dkv.wgmma_wide": 4,
                               "fused_softmax_xent": 1,
                               "fused_softmax_xent_bwd": 1},
    "longctx_hd256_f32_b1_t8192": {"fused_rmsnorm": 17,
                                   "fused_rmsnorm.warp": 17,
                                   "flash_attention": 8,
                                   "flash_attention.tf32x3": 8,
                                   "flash_attention_dq": 4,
                                   "flash_attention_dkv": 4,
                                   "flash_attention_dq.tf32x3": 4,
                                   "flash_attention_dkv.tf32x3": 4,
                                   "fused_softmax_xent": 1,
                                   "fused_softmax_xent_bwd": 1},
    "longctx_hd512_b2_t8192": {"fused_rmsnorm": 17, "fused_rmsnorm.warp": 17,
                               "flash_attention": 8,
                               "flash_attention.wgmma_xwide": 8,
                               "flash_attention_dq": 4,
                               "flash_attention_dkv": 4,
                               "flash_attention_dq.wgmma_xwide": 4,
                               "flash_attention_dkv.wgmma_xwide": 4,
                               "fused_softmax_xent": 1,
                               "fused_softmax_xent_bwd": 1},
    "longctx_hd512_f32_b2_t8192": {"fused_rmsnorm": 17,
                                   "fused_rmsnorm.warp": 17,
                                   "flash_attention": 8,
                                   "flash_attention.tf32x3_xwide": 8,
                                   "flash_attention_dq": 4,
                                   "flash_attention_dkv": 4,
                                   "flash_attention_dq.tf32x3_xwide": 4,
                                   "flash_attention_dkv.tf32x3_xwide": 4,
                                   "fused_softmax_xent": 1,
                                   "fused_softmax_xent_bwd": 1},
    "longctx_hd1024_b4_t8192": {"fused_rmsnorm": 17,
                                "fused_rmsnorm.warp": 17,
                                "flash_attention": 8,
                                "flash_attention.wgmma_xxwide": 8,
                                "flash_attention_dq": 4,
                                "flash_attention_dkv": 4,
                                "flash_attention_dq.wgmma_xxwide": 4,
                                "flash_attention_dkv.wgmma_xxwide": 4,
                                "fused_softmax_xent": 1,
                                "fused_softmax_xent_bwd": 1},
}
# the device mesh (mxnet_tpu_torch/parallel over torch.distributed).
# mesh_nccl: one rank over NCCL (a real communicator: every collective of
# the step runs), the flagship step with make_train_step(rules=
# default_rules()) under make_mesh(dp=1) against the meshless step on the
# same weights: the loss within 1e-5 relative (the mean is an all-reduced
# sum over the token count), every parameter after the step bit for bit
# the meshless step's (one rank: the same kernels on the same operands)
MESH_LOSS_REL = 1e-5
MESH_TIMEOUT_S = 180
# multirank: two rank processes on the one card over gloo (NCCL refuses
# two ranks on one device), started by tools/launch.py; each leg two steps
# against two single-rank steps (tools/dryrun.py's loss parity, 1e-3 ·
# max(1, |ref|), on each step's loss; the second step is the timed one),
# and the gradients at the initial weights gathered whole, each within
# MULTIRANK_GRAD_REL of its largest entry of the single-rank gradient
# (bf16 gradients summed in another order across ranks: the legs' worst
# leaves read 0.0075-0.0132 on an H100 80GB HBM3, 2-3.4 bf16 ulps of the
# largest entry; 2^-5 leaves room for other reduction orders, while a
# reduction dropped or doubled puts a leaf off by about half its size).  (leg, config, batch,
# sequence, mesh axes, rules, the kernels the leg reaches)
MULTIRANK_TIMEOUT_S = 400
MULTIRANK_GRAD_REL = 2.0 ** -5
_DENSE_KERNELS = ("fused_rmsnorm", "fused_softmax_xent",
                  "fused_softmax_xent_bwd")
_FLASH_KERNELS = ("flash_attention.wgmma", "flash_attention_dq.wgmma",
                  "flash_attention_dkv.wgmma")
FLAGSHIP_TRAIN = dict(FLAGSHIP, max_len=1024, remat=False)
MULTIRANK_LEGS = (
    ("tp2_flagship", FLAGSHIP_TRAIN, 8, 1024, {"tp": 2}, False,
     _DENSE_KERNELS),
    ("fsdp2_flagship", FLAGSHIP_TRAIN, 8, 1024, {"fsdp": 2}, True,
     _DENSE_KERNELS),
    ("ep2_flagship_moe", dict(FLAGSHIP_TRAIN, use_moe=True, n_experts=8), 8,
     1024, {"ep": 2}, False, _DENSE_KERNELS),
    ("sp2_longctx", LONGCTX, 1, 8192, {"sp": 2}, False, _DENSE_KERNELS),
    ("tp2_longctx", LONGCTX, 1, 8192, {"tp": 2}, False,
     _DENSE_KERNELS + _FLASH_KERNELS),
)
# pp=2: the flagship's block as two stages, M = 4 microbatches of 2; loss
# by the parity above, each gradient within 2^-6 of its largest entry of
# the sequential stages' (bf16 gradients summed per microbatch in bf16)
PP_MICROBATCHES, PP_MB = 4, 2
PP_GRAD_REL = 2.0 ** -6
# the kernel form of ring attention at [1, 8192, 16, 64] bf16, causal,
# split over the ranks, against the one-card flash kernel: o, dq, dk and
# dv each within 2^-6 of its largest entry (the flash backward's tolerance
# against an independent formula).  Each block's output is rounded to
# bf16 before the merge and each rank's gradient adds the blocks' bf16
# partials: n roundings where the one-card kernel has one, relative to
# the partials, not to a merged entry that cancels
RING_SHAPE = (1, 8192, 16, 64)
RING_REL = 2.0 ** -6

# kernel-vs-plain training step (bf16 model, loss of order 10): loss within
# 1e-3 absolute, every parameter gradient within 2e-2 relative L2 error.
# The kernels and the plain versions round to bf16 at the same points, so
# they differ only in f32 summation order (the flash forward's online
# softmax above all); but one-ulp bf16 flips (2^-8 relative) of
# activations compound over 4 layers forward and back.  Measured on an
# H100 80GB HBM3 at 700 W, the same in two runs: loss 4.3e-5, largest
# gradient error 8.0e-3 (embed)
STEP_LOSS_ATOL = 1e-3
STEP_GRAD_REL_L2 = 2e-2
# the wgmma_xwide backward and its 2-CTA-cluster twin wgmma_xxwide against
# autograd through the dense forward: within 6.5e-3 of each gradient's
# largest entry (the other bf16 variants: 2^-6); the dense formula takes
# delta from the unrounded O, the kernels from the bf16 O, as the TPU's do
XWIDE_AUTOGRAD_REL = 6.5e-3

# the INT8 phase: resnet.py's ImageNet ResNet-50 (train_imagenet.py's
# default network) and bench.py's int8 leg (int8_bench: batch 128, 224^2,
# 32 naive-calibration images in batches of 16, fold_bn and fuse_int8)
INT8_NET = dict(num_classes=1000, num_layers=50, image_shape="3,224,224")
INT8_BATCH = 128
INT8_CALIB = 32
INT8_CALIB_BATCH = 16
INT8_TIMED = 3
# the quantized graph's op counts under fold_bn + fuse_int8, as the JAX
# package's quantize_model writes them for this network
INT8_OPS = {"_contrib_quantized_conv": 53,
            "_contrib_quantized_fully_connected": 1,
            "_contrib_requantize": 32, "_contrib_quantized_act": 32,
            "_contrib_quantize_v2": 18, "_contrib_dequantize": 22,
            "BatchNorm": 18, "Activation": 18, "broadcast_add": 16,
            "Pooling": 2, "Flatten": 1, "SoftmaxOutput": 1}
INT8_MIN_COSINE = 0.99          # the bar of tests/test_quantization.py
# quantized_dense vs dequantize(quantized_fully_connected): both are
# f32(acc) times the same f32 scale, so they agree bit for bit; held to
# the oracle's stated 1e-6 relative
DENSE_RTOL = 1e-6
# bench.py's interleaved bf16 vs int8 VGG16 pair (_int8_vs_bf16_pair at
# int8_bench's settings): vgg16(classes=1000), Xavier, batch 128 at
# 224^2, 16 naive-calibration images in batches of 8, fold_bn, fuse_int8,
# interleaved_throughput(steps=20, reps=3).  Its classifier (fc6, fc7,
# fc8) is three quantized_fully_connected: the int8 matmul, [128, K] x
# [N, K]
VGG_BATCH = 128
VGG_SIZE = 224
VGG_CALIB = 16
VGG_STEPS = 20
VGG_REPS = 3
VGG_FC = ((25088, 4096), (4096, 4096), (4096, 1000))      # (K, N)
# the exported fp32 SymbolBlock against the hybridized Gluon net on the
# same 8 images: the executor runs the same ops on the same arrays as the
# CachedOp, so the logits agree to the last bit; gated at 1e-6 of the
# largest logit
VGG_EXPORT_REL = 1e-6
VGG_EXPORT_BATCH = 8
# the zoo phase: one model of each family ported for the Gluon model zoo,
# at its published input size, batch 8, seeded Xavier weights, fp32 on the
# card (TF32 off) against the same weights in float64 on the CPU: f32
# rounding through 8-121 layers, within ZOO_REL of the largest logit; the
# export served by predict.Predictor on the card runs the same ops on the
# same arrays as the Gluon net, within ZOO_EXPORT_REL
ZOO = (("vgg16", 224), ("alexnet", 224), ("squeezenet1.0", 224),
       ("mobilenet1.0", 224), ("mobilenetv2_1.0", 224),
       ("densenet121", 224), ("inceptionv3", 299))
ZOO_BATCH = 8
ZOO_TIMED = 3
ZOO_REL = 1e-4
ZOO_EXPORT_REL = 1e-6
# the detection phase: MXNet example/ssd's SSD-300 on VGG16-reduced
# (models/ssd.py: symbol_factory.get_config('vgg16_reduced', 300); 8732
# anchors, 20 classes + background) at its published widths, f32, seeded
# Xavier weights (no pretrained file), batch 8 of seeded synthetic 300x300
# scenes with up to 6 boxes; 5 steps of record -> multibox_loss
# (MultiBoxTarget at overlap 0.5, mining ratio 3 and threshold 0.5) ->
# backward -> Trainer.step on that one batch, then the decode
# (MultiBoxDetection at nms 0.45, nms_topk 400)
SSD_BATCH = 8
SSD_SIZE = 300
SSD_CLASSES = 20
SSD_MAX_OBJ = 6
SSD_STEPS = 5
SSD_SGD = {"learning_rate": 1e-3, "momentum": 0.9, "wd": 5e-4}
SSD_NMS = dict(nms_threshold=0.45, nms_topk=400)
SSD_DECODE_REPS = 5
# card against CPU on the same tensors: loc targets and decoded boxes
# within 1e-5 (exp / log within 2 ulp on either device); the positives,
# their classes, each image's negative count and the decoded ids exact.
# The hard-negative ranking sorts background probabilities made through
# exp, so two candidates a few ulp apart at an image's mining cut may
# trade places between the devices: at most SSD_MINING_SWAPS such swaps an
# image (each moves one anchor from negative to ignored and one back)
SSD_CARD_CPU_TOL = 1e-5
SSD_MINING_SWAPS = 2
# Faster R-CNN's RPN on a VGG16 conv5 map of a 600x800 image: Proposal on
# [1, 2A, 38, 50] / [1, 4A, 38, 50] (A = 3 scales x 3 ratios), pre-NMS
# 6000, post-NMS 300, threshold 0.7; then ROIPooling 7x7 at 1/16 over the
# 300 ROIs on a [1, 512, 38, 50] map.  Proposal's ROIs card vs CPU: the
# boxes come through exp, which the devices round within 2 ulp of each
# other, so an IoU within an ulp of 0.7 may fall on either side and move
# the survivors after it; at least RPN_MATCH of the card's ROIs must be
# among the CPU's within RPN_ATOL pixels.  ROIPooling on the card's ROIs,
# card vs CPU: its maxima bit for bit
RPN_SHAPE = (1, 9, 38, 50)
RPN_KW = dict(rpn_pre_nms_top_n=6000, rpn_post_nms_top_n=300, threshold=0.7,
              rpn_min_size=16, scales=(8, 16, 32), ratios=(0.5, 1, 2),
              feature_stride=16)
RPN_ATOL = 1e-3
RPN_MATCH = 0.98
ROI_MAP = (1, 512, 38, 50)
ROI_POOLED = (7, 7)
# operations a greedy-NMS IoU evaluation takes (min / max / sub / mul /
# add / div / the comparisons of _pair_iou and the threshold), for the
# kernel's bound
NMS_IOU_OPS = 20


# the module_train phase: train_imagenet.py's defaults (resnet-50,
# 3x224x224, 1000 classes, batch 32; fit.py: sgd, lr 0.1, momentum 0.9, wd
# 1e-4, the lr divided by 10 at epochs 30 and 60, metric accuracy, and
# Module.fit's default initializer Uniform(0.01)), f32 with TF32 off
MODULE_BATCH = 32
MODULE_IMAGES = 256                  # 8 steps: one warm, 7 timed
MODULE_EPOCH_SIZE = 1281167 // MODULE_BATCH
MODULE_SGD = dict(learning_rate=0.1, momentum=0.9, wd=1e-4)
# card vs CPU, one forward_backward and update at batch 4 from the fit's
# parameters.  At those parameters the f32 gradients are ill-conditioned:
# each device's f32 step stands up to 1e-2 (relative L2) from a float64 one
# on its worst tensor, the CPU's as well as the card's, and on which tensor
# changes with the state that the fit (nondeterministic on the card)
# leaves.  So the same step is taken in float64 on both devices, where
# that amplification leaves ~1e-11: every gradient, moving statistic and
# update w_new - w_old within MODULE_CHECK_REL_F64, far below one f32
# rounding, so an op that dropped to f32 on one device shows too.  In f32
# the moving statistics (the forward, well conditioned) stay within
# MODULE_CHECK_REL; the f32 gradients of both devices are reported against
# the float64 step.  See _compare_tensors for sums that cancel.
MODULE_CHECK_BATCH = 4
MODULE_CHECK_REL = 1e-3
MODULE_CHECK_REL_F64 = 1e-8
# the data BatchNorm's moving statistics after k steps against k EMA
# applications of the batches' moments, computed on the host in f64
MODULE_STATS_REL = 1e-5

# the rtc phase: example/numpy-ops/custom_softmax.py's network and training
# (16 -> 16 -> 4, 512 examples, batch 64, adam 5e-3, Xavier, 10 epochs),
# through the user op rtc_softmax (CUDA kernels compiled by mx.rtc) and
# through the example's numpy_softmax, from the same parameters
RTC_EPOCHS = 10
RTC_MIN_ACC = 0.9                    # the example's bar
RTC_FIT_REL = 1e-4
RTC_STEP_REL = 1e-4                  # ResNet-50 gradients, rtc vs numpy head
RTC_THREADS = 128
# rtc_softmax's forward against numpy's: expf and numpy's exp within 2 ulp,
# the row sum in another order; the backward on the same p is bit-exact
# ((p - onehot) / batch: one f32 subtraction and one f32 division)
RTC_FWD_ATOL, RTC_FWD_RTOL = 1e-7, 1e-5
# tensors whose norm is below this share of their group's joint norm are
# reported, not gated, by the step comparisons (see _compare_tensors)
CANCELLED_SHARE = 1e-3

# the Gluon phases.  gluon_train is bench.py's train leg (bench.py:392-470)
# at its settings: resnet50_v1(classes=1000), Xavier, RandomState(0)'s
# rand(128, 3, 224, 224) and randint(0, 1000, 128), deferred init in f32
# under autograd.pause(), net.cast("bfloat16"), hybridize(static_alloc,
# static_shape), SoftmaxCrossEntropyLoss, SGD lr 0.05 / momentum 0.9 with
# multi_precision, gluon.contrib.FusedTrainStep: 3 warm steps, then
# GLUON_TIMED timed ones, each ending in a synchronize
GLUON_BATCH = 128
GLUON_SIZE = 224
GLUON_WARM = 3
GLUON_TIMED = 10
GLUON_SGD = {"learning_rate": 0.05, "momentum": 0.9,
             "multi_precision": True}
# gluon_cifar: BASELINE.json's "Gluon HybridBlock ResNet-18 CIFAR-10":
# resnet18_v1(classes=10, thumbnail=True), f32, hybridized, one seeded
# batch of 128 3x32x32 images, record -> backward -> Trainer.step(128),
# SGD 0.1 / 0.9 / wd 1e-4; the loss of the last step must be below
# CIFAR_FALL times the first's
CIFAR_BATCH = 128
CIFAR_STEPS = 20
CIFAR_SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
CIFAR_FALL = 0.5
# gluon_step_card_vs_cpu: one Gluon step (record, backward, Trainer.step)
# of resnet18_v1 thumbnail at batch 4 from the same seeded weights, in
# float64 on the card and on the CPU (gradients, running statistics and
# updates w_new - w_old within MODULE_CHECK_REL_F64), and in f32 on the
# card hybridized against not (within GLUON_HYBRID_REL)
GLUON_CHECK_BATCH = 4
GLUON_HYBRID_REL = 1e-5

# gluon_infer: bench.py's inference and latency_b1 legs (bench.py:543-580)
# on gluon_train's net and batch: compiled_throughput (one CUDA graph of
# INFER_STEPS chained forwards, one replay per draw) and
# percall_throughput at INFER_STEPS x INFER_DRAWS, and at batch 1
# compiled_throughput with B1_STEPS x B1_DRAWS.  The graph's last output
# must equal the same chain run eagerly bit for bit
INFER_STEPS = 30
INFER_DRAWS = 5
B1_STEPS = 100
B1_DRAWS = 3
# serving_front: bench.py's serving leg (bench.py:705-805, not cut): the
# 64 -> 256 -> 8 MLP symbol, SERVE_REQUESTS sequential requests through
# the bare Predictor and through ModelServer(max_queue SERVE_QUEUE,
# max_batch 8, max_wait_ms 0, deadline_ms 30000), then a burst of
# 4 x SERVE_QUEUE; then a two-replica chaos run (SERVE_CHAOS_SPEC over
# SERVE_CHAOS_REQUESTS requests in waves, hedge_ms SERVE_HEDGE_MS)
SERVE_REQUESTS = 400
SERVE_QUEUE = 32
SERVE_D_IN, SERVE_D_H = 64, 256
# the two stalls (0.25 s each) fall far enough apart that the first job's
# hedge time comes while the other replica is still free: a hedge goes only
# to a free replica that has not tried the job, in both packages
# (tests/test_torch_port_model_server.py::
# test_no_hedge_while_every_replica_is_stalled), and at executions 6 and 8
# both replicas were often stalled by then, so that a hedge fired only if
# the scheduler saw one replica free before the other's job settled
SERVE_CHAOS_SPEC = ("replica_crash@1,replica_crash@4,slow_replica@6,"
                    "slow_replica@12")
SERVE_CHAOS_REQUESTS = 48
SERVE_HEDGE_MS = 50
# sentinel: bench.py's sentinel leg (bench.py:508-541): gluon_train's step
# beside a FusedTrainStep(numeric_guard="skip") over the same net and
# trainer, SENTINEL_PAIRS interleaved base/guard windows of SENTINEL_WIN
# steps each ending in a host fetch of the loss; the overhead is the
# median per-pair ratio
SENTINEL_WIN = 15
SENTINEL_PAIRS = 9

# The recurrent phases: BASELINE.json's "LSTM language model (example/rnn,
# cuDNN RNN op replacement)".  The fused RNN op runs cuDNN's RNN through
# PyTorch (mxnet_tpu_torch/ops/rnn.py); no hand-written kernel is on these
# paths, and each phase checks that none launched.
# word_lm: example/rnn/word_lm.py's graph (Embedding -> 2-layer sym.RNN lstm
# -> reshape -> FullyConnected -> SoftmaxOutput) at MXNet's word_lm medium
# PTB setting: vocab 10000, emsize 650, nhid 650, 2 layers, bptt 35, batch
# 32; the example's SGD (lr 1.0, momentum 0.9), Xavier with the graph's own
# Normal(0.05) / Zero variable inits, seeded uniform tokens.  The
# reference's dropout 0.5 and weight tying are not in the repo's graph and
# stay out.  LM_WARM steps, then LM_TIMED timed ones, each ending in a
# synchronize (Perplexity's host copy timed apart).
LM = dict(vocab=10000, emsize=650, nhid=650, nlayers=2)
LM_BPTT, LM_BATCH = 35, 32
LM_SGD = {"learning_rate": 1.0, "momentum": 0.9}
LM_WARM, LM_TIMED = 2, 10
# cuDNN (rnn_cudnn) against the plain time loop (rnn_reference) on the card
# at word_lm's RNN shapes, f32 with TF32 off: outputs, hy and cy within
# RNN_FWD_REL of each tensor's largest entry, the gradients of the data,
# the packed parameters and both states within RNN_GRAD_REL of theirs (the
# same f32 function, its products summed in another order)
RNN_FWD_REL = 1e-5
RNN_GRAD_REL = 1e-4
# bucketing: example/rnn/bucketing.py's sym_gen (a 1-layer LSTM) over its
# buckets 8 / 16 / 24 / 32 (sequence keys 7 / 15 / 23 / 31, default 31) at
# word_lm's width and batch, its SGD (lr 0.2, momentum 0.9) and
# Perplexity(ignore_label=0), over BUCKET_PLAN's keys (each bucket twice)
BUCKET_KEYS = (7, 15, 23, 31)
BUCKET_PLAN = (15, 7, 31, 23, 7, 23, 15, 31)
BUCKET_SGD = {"learning_rate": 0.2, "momentum": 0.9}
# gluon_rnn: example/bi-lstm-sort/sort_io.py's SortNet (Embedding(10, 32)
# -> bidirectional gluon.rnn.LSTM(64), NTC -> Dense(10, flatten=False)),
# its make_data (6 digits to sort; 256 validation sequences from seed 1),
# 2048 examples in batches of 64, Adam lr 3e-3, SoftmaxCrossEntropyLoss,
# Xavier, for SORT_EPOCHS epochs (the example runs 12): the per-position
# validation accuracy after each epoch must rise
SORT_VOCAB, SORT_SEQ = 10, 6
SORT_EXAMPLES, SORT_BATCH, SORT_LR = 2048, 64, 3e-3
SORT_EPOCHS = 4
# mnist: train_mnist.py (BASELINE.json's "LeNet MNIST via Module"):
# symbols/mlp.py (its default network) and symbols/lenet.py through
# Module.fit, batch 64, fit.py's SGD (lr 0.05, momentum 0.9, wd 1e-4) and
# Module.fit's Uniform(0.01), on common/data.py's seeded synthetic 1x28x28
# set of 2048 (256 held out, as its get_iters holds out an eighth), for
# MNIST_EPOCHS epochs (train_mnist.py runs 20): from Uniform(0.01) the
# JAX package's own train_mnist.py is still at chance after one epoch
# (held-out 0.152 mlp, 0.078 lenet on the CPU) and leaves it in the
# second or third, so the best held-out accuracy of the epochs must exceed
# MNIST_MIN_ACC (chance is 0.1)
MNIST_BATCH = 64
MNIST_EXAMPLES = 2048
MNIST_EPOCHS = 4
MNIST_SGD = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
MNIST_MIN_ACC = 0.3

# User code: the kernels a user of mx.rtc writes, and the CustomOps over
# them.  One CTA per row; max and sum in f32 by warp shuffles.
RTC_SOFTMAX_SRC = r"""
__device__ float warp_reduce(float v, bool take_max) {
    for (int o = 16; o > 0; o >>= 1) {
        float w = __shfl_xor_sync(0xffffffffu, v, o);
        v = take_max ? fmaxf(v, w) : v + w;
    }
    return v;
}

__device__ float block_reduce(float v, bool take_max) {
    __shared__ float part[32];
    int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    v = warp_reduce(v, take_max);
    __syncthreads();                      // part[] may hold the last call's
    if (lane == 0) part[warp] = v;
    __syncthreads();
    int warps = (blockDim.x + 31) >> 5;
    float idle = take_max ? __int_as_float(0xff800000) : 0.0f;
    return warp_reduce(lane < warps ? part[lane] : idle, take_max);
}

extern "C" __global__ void softmax_forward(const float *x, float *y,
                                           int cols) {
    const float *row = x + (size_t)blockIdx.x * cols;
    float *out = y + (size_t)blockIdx.x * cols;
    float m = __int_as_float(0xff800000);
    for (int j = threadIdx.x; j < cols; j += blockDim.x)
        m = fmaxf(m, row[j]);
    m = block_reduce(m, true);
    float s = 0.0f;
    for (int j = threadIdx.x; j < cols; j += blockDim.x)
        s += expf(row[j] - m);
    s = block_reduce(s, false);
    for (int j = threadIdx.x; j < cols; j += blockDim.x)
        out[j] = expf(row[j] - m) / s;
}

extern "C" __global__ void softmax_backward(const float *p,
                                            const float *label, float *dx,
                                            int cols, float batch) {
    size_t base = (size_t)blockIdx.x * cols;
    int y = (int)label[blockIdx.x];
    for (int j = threadIdx.x; j < cols; j += blockDim.x)
        dx[base + j] = (p[base + j] - (j == y ? 1.0f : 0.0f)) / batch;
}
"""
# the reference rtc docstring's templated kernel, and tests/test_rtc.py's
# two Pallas kernels written in CUDA; --fmad=false keeps a*x + y two
# roundings, as the torch expressions they are held to exactly
RTC_AXPY_TEMPLATE_SRC = r"""
template<typename DType>
__global__ void axpy(const DType *x, DType *y, DType alpha) {
    int i = threadIdx.x + blockIdx.x * blockDim.x;
    y[i] += alpha * x[i];
}
"""
RTC_TEST_SRC = r"""
extern "C" __global__ void axpy(const float *x, const float *y, float *o,
                                int n) {
    int i = threadIdx.x + blockIdx.x * blockDim.x;
    if (i < n) o[i] = 2.5f * x[i] + y[i];
}

extern "C" __global__ void scale(const float *x, float *o, int n) {
    int i = threadIdx.x + blockIdx.x * blockDim.x;
    if (i < n) o[i] = x[i] * 3.0f;
}
"""


def register_user_ops(mx):
    """Register the user ops ``numpy_softmax`` (the example's, its class
    body as it is) and ``rtc_softmax`` (the same arguments, outputs and
    shapes, its forward and backward launching ``RTC_SOFTMAX_SRC``'s
    kernels through ``mx.rtc``) over package ``mx``.  The CUDA module is
    compiled at the first ``rtc_softmax`` operator and kept."""
    import numpy as np

    class NumpySoftmax(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            e = np.exp(x - x.max(axis=1, keepdims=True))
            self.assign(out_data[0], req[0], mx.nd.array(
                e / e.sum(axis=1, keepdims=True)))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            # fused softmax+CE gradient: (p - onehot(y)) / batch
            p = out_data[0].asnumpy()
            y = in_data[1].asnumpy().astype(int)
            g = p.copy()
            g[np.arange(len(y)), y] -= 1.0
            self.assign(in_grad[0], req[0], mx.nd.array(g / len(y)))
            self.assign(in_grad[1], req[1], mx.nd.zeros_like(in_data[1]))

    class RtcSoftmax(mx.operator.CustomOp):
        def __init__(self, kernels):
            self.fwd, self.bwd = kernels

        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0]
            n, c = x.shape
            out = out_data[0] if req[0] == "write" else \
                mx.nd.zeros_like(out_data[0])
            self.fwd.launch([x, out, c], x.context, (n, 1, 1),
                            (RTC_THREADS, 1, 1))
            if out is not out_data[0]:
                self.assign(out_data[0], req[0], out)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            p, y = out_data[0], in_data[1]
            n, c = p.shape
            dx = in_grad[0] if req[0] == "write" else \
                mx.nd.zeros_like(in_grad[0])
            self.bwd.launch([p, y, dx, c, float(n)], p.context, (n, 1, 1),
                            (RTC_THREADS, 1, 1))
            if dx is not in_grad[0]:
                self.assign(in_grad[0], req[0], dx)
            self.assign(in_grad[1], req[1], mx.nd.zeros_like(in_data[1]))

    compiled = {}

    def kernels():
        if not compiled:
            mod = mx.rtc.CudaModule(RTC_SOFTMAX_SRC)
            compiled["module"] = mod
            compiled["kernels"] = (
                mod.get_kernel("softmax_forward",
                               "const float *x, float *y, int cols"),
                mod.get_kernel("softmax_backward",
                               "const float *p, const float *label, "
                               "float *dx, int cols, float batch"))
        return compiled["kernels"]

    class _SoftmaxProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

    @mx.operator.register("numpy_softmax")
    class NumpySoftmaxProp(_SoftmaxProp):
        def create_operator(self, ctx, shapes, dtypes):
            return NumpySoftmax()

    @mx.operator.register("rtc_softmax")
    class RtcSoftmaxProp(_SoftmaxProp):
        def create_operator(self, ctx, shapes, dtypes):
            return RtcSoftmax(kernels())

    return {"numpy": NumpySoftmax, "rtc": RtcSoftmax, "kernels": kernels,
            "compiled": compiled}


def _check(cond, msg):
    if not cond:
        raise RuntimeError("chip_smoke: " + msg)


def _emit(obj):
    print(json.dumps(obj), flush=True)


def phase_device():
    import torch

    _check(torch.cuda.is_available(), "no CUDA device is available")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print("device: %s  (count %d)" % (name, torch.cuda.device_count()))
    print("nvidia-smi: %s" % smi, flush=True)
    return {"name": name, "smi": smi}


def phase_build():
    from mxnet_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    built = _build.build()
    wall = time.perf_counter() - t0
    for name, info in built.items():
        report = [ln.strip() for ln in info["log"].splitlines()
                  if "registers" in ln or "spill" in ln]
        print("build %s: %s in %.1f s%s" % (
            name, "cached" if info["cached"] else "compiled",
            info["seconds"], "".join("\n  " + ln for ln in report)))
    print("build: %d kernel source(s) in %.1f s" % (len(built), wall),
          flush=True)
    # each instantiation's registers and spills: the tensor-core flash
    # kernels, the wide flash kernels, the int8 matmul and the RMSNorm
    # variants, none of which may spill but the int8 mma kernel
    for src in ("flash_attention_wgmma", "flash_attention_wgmma_wide",
                "flash_attention_wgmma_xwide",
                "flash_attention_bwd_wgmma", "flash_attention_bwd_wgmma_wide",
                "flash_attention_bwd_wgmma_xwide",
                "flash_attention_tf32x3", "flash_attention_bwd_tf32x3",
                "flash_attention_wide",
                "int8_matmul", "rmsnorm"):
        summary = _ptxas_summary(built[src]["log"])
        for kernel, line in summary:
            print("build %s %s" % (src, line), flush=True)
            if kernel != "int8_mm_kernel":
                _check(" 0 bytes spill stores" in line,
                       "%s spills: %s" % (src, line))
        # the wgmma_xwide forward, dQ and dK/dV at each of their 4 widths
        # alone and in 2-CTA clusters (wgmma_xxwide)
        want = {"flash_attention_wgmma_xwide": 8,
                "flash_attention_bwd_wgmma_xwide": 16}.get(src)
        if want is not None:
            _check(len(summary) == want, "%s: %d instantiations in the "
                   "ptxas report, expected %d" % (src, len(summary), want))
        # the tf32x3 forward (<D, CL>) and dQ and dK/dV (<D, CL>), alone
        # (CL 1) and in 2-CTA clusters (CL 2: tf32x3_xwide), at 192 and
        # 256 columns a CTA
        per_cl = {"flash_attention_tf32x3": 2,
                  "flash_attention_bwd_tf32x3": 4}.get(src)
        for cl in (1, 2) if per_cl else ():
            n = sum(1 for _, line in summary
                    if re.search(r"<(192|256),%d>" % cl, line))
            _check(n == per_cl, "%s: %d instantiations of cluster size %d "
                   "in the ptxas report, expected %d" % (src, n, cl, per_cl))
        # and tf32x3's forward, dQ and dK/dV at 64 and 128 (the narrow
        # plans)
        per_narrow = {"flash_attention_tf32x3": 2,
                      "flash_attention_bwd_tf32x3": 4}.get(src)
        if per_narrow:
            n = sum(1 for kernel, line in summary
                    if kernel.endswith("_narrow_kernel")
                    and re.search(r"<(64|128)>", line))
            _check(n == per_narrow, "%s: %d narrow instantiations in the "
                   "ptxas report, expected %d" % (src, n, per_narrow))
    return wall


def _ptxas_summary(log):
    """``(kernel, line)`` per kernel instantiation of a ptxas ``-v`` log:
    the kernel, its template arguments (a head_dim; a column tile and the
    dequant flag; a dtype, vectors a thread and warps a row), registers,
    spills and stack."""
    out, name, props = [], None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif "spill stores" in ln:
            props = ln.strip()
        elif "Used" in ln and "registers" in ln and name is not None:
            # the last length-prefixed name before the template arguments
            m = re.search(
                r".*\d((?:flash|int8|rmsnorm)_\w*?_kernel)I(.*?)E+v", name)
            kernel, args = (m.group(1), m.group(2)) if m else ("?", "?")
            args = args.replace("13__nv_bfloat16", "bf16,")
            if args.startswith("f"):                        # float
                args = "f32," + args[1:]
            args = (args.replace("Li", "").replace("Lb", "b")
                    .replace("E", ",").rstrip(","))
            out.append((kernel, "%s<%s>: %s; %s" % (
                kernel, args, ln.split(":", 1)[1].strip(), props)))
            name = None
    return out


def _time_ms(fn, args_list, rounds=2, replays=5):
    """Device milliseconds of one call of ``fn``.

    ``rounds`` passes over ``args_list`` (each entry one set of arguments:
    several copies of the inputs whose total exceeds the 50 MB L2 cache,
    so each call finds its inputs cold, as a call in the model does) are
    captured into one CUDA graph.  Replaying it keeps the Python wrapper's
    host time out of the measurement.  Returns the median over ``replays``
    replays, each between two CUDA events, divided by the calls in it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):           # warm up off the default stream
        for args in args_list:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(rounds):
            for args in args_list:
                fn(*args)
    calls = rounds * len(args_list)
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del graph
    return statistics.median(times)


def _copies(tensors, l2_bytes=50e6):
    """Enough copies of ``tensors`` that together they exceed twice the
    L2 cache (at most 8): the argument sets for :func:`_time_ms`."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    n = max(1, min(8, int(2 * l2_bytes // max(nbytes, 1)) + 1))
    return [tuple(tensors)] + [tuple(t.clone() for t in tensors)
                               for _ in range(n - 1)]


def _err(got, ref, atol, rtol):
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    ok = bool((diff <= atol + rtol * ref.abs()).all()) \
        and bool(got.isfinite().all())
    return float(diff.max()), ok


def _bound(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def _flash_bounds(flops, nbytes, dtype_name):
    """A flash record's bound keys.  For f32, ``bound_ms`` counts each
    product as three TF32 products at 495 TFLOP/s (the least time for
    f32-accurate products on the tensor cores: the tf32x3 kernels' split)
    and ``bound_f32_cuda_core_ms`` the CUDA-core figure at 67 TFLOP/s."""
    if dtype_name != "float32":
        bound, by = _bound(flops, nbytes, dtype_name)
        return {"bound_ms": bound, "bound_by": by}
    bound, by = _bound(3 * flops, nbytes, "tf32")
    return {"bound_ms": bound, "bound_by": by,
            "bound_f32_cuda_core_ms": _bound(flops, nbytes, "float32")[0]}


def _rmsnorm_case(shape, dtype_name, gen):
    """RMSNorm at ``shape``: the variant ``plan_rmsnorm`` takes, and each
    other variant forced, held against the plain version (and two calls of
    each bit-identical; the routed call bit-identical to its variant), then
    timed in turns, the planned variant first and last (p, a, b, b, a, p),
    beside ``F.rms_norm``.  ``ms`` is the planned variant's mean of its two
    turns."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.kernels import common, layers

    dt = getattr(torch, dtype_name)
    N, E = shape
    x = torch.randn(shape, generator=gen, device="cuda").to(dt)
    scale = (1 + 0.1 * torch.randn(E, generator=gen, device="cuda")).to(dt)
    plan = layers.plan_rmsnorm(N, E, dt, E, 16, common.sm_count(x.device))
    fns = {"warp": layers._rmsnorm_warp_cuda,
           "block": layers._rmsnorm_block_cuda,
           "simt": layers._rmsnorm_simt_cuda}
    order = [plan.variant] + [v for v in fns if v != plan.variant]
    # f32: rsqrtf (<= 2 ulp) and another summation order; bf16: each of
    # the two roundings to bf16 may flip one ulp (2^-8 relative)
    atol, rtol = (1e-5, 1e-5) if dtype_name == "float32" else (1e-6, 2**-6)
    ref = layers.fused_rmsnorm_reference(x, scale)
    bits = torch.int32 if dtype_name == "float32" else torch.int16
    routed = layers._rmsnorm_cuda(x, scale)
    errs, oks, repeat = {}, {}, {}
    for v in order:
        a, b = fns[v](x, scale), fns[v](x, scale)
        torch.cuda.synchronize()
        errs[v], oks[v] = _err(a, ref, atol, rtol)
        repeat[v] = bool(torch.equal(a.view(bits), b.view(bits)))
        if v == plan.variant:
            repeat["routed"] = bool(torch.equal(a.view(bits),
                                                routed.view(bits)))
        del a, b
    del routed
    isz = x.element_size()
    bound, by = _bound(4.0 * N * E, (2 * N * E + E) * isz, dtype_name)
    args = _copies((x, scale))
    turns = {}
    for v in order + order[::-1]:
        turns.setdefault(v, []).append(_time_ms(fns[v], args))
    lib_ms = _time_ms(
        lambda x, s: F.rms_norm(x, (E,), weight=s, eps=1e-6), args)
    # a copy of x into a new tensor: the same bytes through the same
    # timing, so the rate the card reaches for them
    copy_ms = _time_ms(lambda x, s: torch.empty_like(x).copy_(x), args)
    ms = statistics.mean(turns[plan.variant])
    rec = {
        "kernel": "fused_rmsnorm", "shape": list(shape), "dtype": dtype_name,
        "variant": plan.variant, "plan": plan._asdict(),
        "max_abs_err": errs[plan.variant], "variant_max_abs_err": errs,
        "atol": atol, "rtol": rtol, "bit_identical": repeat,
        "ok": all(oks.values()) and all(repeat.values()),
        "ms": ms, "ms_turns": turns,
        **{"%s_ms" % v: statistics.mean(t) for v, t in turns.items()},
        "plain_ms": _time_ms(layers.fused_rmsnorm_reference, args),
        "library_ms": lib_ms, "library": "F.rms_norm",
        "bound_ms": bound, "bound_by": by, "ms_over_bound": ms / bound,
        "ms_over_library": ms / lib_ms, "copy_ms": copy_ms,
        "ms_over_copy": ms / copy_ms,
    }
    _emit(rec)
    _check(rec["ok"], "fused_rmsnorm %s %s disagrees with its plain version "
           "or repeats differ (max abs err %s, bit-identical %s)"
           % (shape, dtype_name, errs, repeat))
    return rec


def _rmsnorm_bwd_plain_case(shape, gen):
    """The device time of the plain RMSNorm backward
    (``rmsnorm_bwd_reference``, the port's backward on every device) at a
    training step's shape, bf16, beside its byte bound: x and g read, dx
    written, scale read and dscale written once.  For the record: the
    backward has no kernel."""
    import torch
    from mxnet_tpu_torch.ops.kernels import layers

    N, E = shape
    x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    g = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    scale = (1 + 0.1 * torch.randn(E, generator=gen, device="cuda")).to(
        torch.bfloat16)
    bound, by = _bound(10.0 * N * E, (3 * N * E + 2 * E) * 2, "bfloat16")
    ms = _time_ms(lambda x, s, g: layers.rmsnorm_bwd_reference(x, s, g),
                  _copies((x, scale, g)))
    rec = {"kernel": "rmsnorm_bwd_reference (plain torch, no kernel)",
           "shape": list(shape), "dtype": "bfloat16", "ms": ms,
           "bound_ms": bound, "bound_by": by, "ms_over_bound": ms / bound}
    _emit(rec)
    return rec


# the CUDA-core variant each tensor-core variant of the forward and of the
# backward is timed against in turns (``variants=True``); tf32x3 at 64 and
# 128 has simt instead (_cuda_core_twin)
CUDA_CORE_TWIN = {"wgmma": "simt", "wgmma_wide": "wide", "tf32x3": "wide",
                  "wgmma_xwide": "wide", "tf32x3_xwide": "wide",
                  "wgmma_xxwide": "wide"}


def _cuda_core_twin(variant, width):
    """The CUDA-core kernel ``variant`` replaced at the kernel width
    ``width``: ``CUDA_CORE_TWIN``, but simt for tf32x3 at 64 and 128 (its
    narrow plans; wide runs above 128 only)."""
    if variant == "tf32x3" and width <= 128:
        return "simt"
    return CUDA_CORE_TWIN.get(variant)


def _flash_case(B, Tq, Tk, H, D, causal, dtype_name, gen,
                variants=False, kv_len=None):
    """The flash forward of the variant ``_variant`` names against its
    plain version; a tensor-core variant must also give the same bits in
    two calls (no atomics).  ``kv_len`` (default Tk): keys at and past it
    are masked, against the plain version over the first kv_len keys.
    ``variants``: that variant is a tensor-core one; also hold its
    CUDA-core twin (``_cuda_core_twin``: simt for wgmma and for tf32x3 at
    64 and 128, wide for the others) against the plain version, and time the
    two in turns (tensor-core, CUDA-core, CUDA-core, tensor-core); ``ms``
    is then the tensor-core variant's mean of its two turns.  A head dim
    the kernels lack is then timed at its padded width (each variant's
    own, ``_kernel_width``: tf32x3_xwide runs 320 at 384, wgmma_xxwide 576
    at 640, wide at 320 and 576), on inputs padded once; the bounds count
    the real head_dim's work."""
    import torch
    import torch.nn.functional as F
    # (the package exports a function under this module's name)
    from mxnet_tpu_torch.ops.kernels.flash_attention import (
        _flash_cuda, _flash_simt_cuda, _flash_tf32x3_cuda,
        _flash_tf32x3_xwide_cuda, _flash_wgmma_cuda, _flash_wgmma_wide_cuda,
        _flash_wgmma_xwide_cuda, _flash_wgmma_xxwide_cuda, _flash_wide_cuda,
        _kernel_width, _pad_d, _variant, flash_attention_reference)

    dt = getattr(torch, dtype_name)
    scale = 1.0 / D ** 0.5
    launchers = {"wgmma": _flash_wgmma_cuda,
                 "wgmma_wide": _flash_wgmma_wide_cuda,
                 "wgmma_xwide": _flash_wgmma_xwide_cuda,
                 "wgmma_xxwide": _flash_wgmma_xxwide_cuda,
                 "tf32x3": _flash_tf32x3_cuda,
                 "tf32x3_xwide": _flash_tf32x3_xwide_cuda,
                 "simt": _flash_simt_cuda, "wide": _flash_wide_cuda}

    def rnd(T):
        return torch.randn((B, T, H, D), generator=gen, device="cuda").to(dt)

    q, k, v = rnd(Tq), rnd(Tk), rnd(Tk)
    n = Tk if kv_len is None else kv_len
    o, lse = _flash_cuda(q, k, v, causal, None, kv_len)
    variant = _variant(q.dtype, D)
    repeat_ok = True
    if variant in CUDA_CORE_TWIN:
        o2, lse2 = _flash_cuda(q, k, v, causal, None, kv_len)
        repeat_ok = torch.equal(o, o2) and torch.equal(lse, lse2)
        del o2, lse2
    o_ref, lse_ref = flash_attention_reference(q, k[:, :n], v[:, :n], causal,
                                               return_lse=True)
    torch.cuda.synchronize()
    # f32: the same f32 arithmetic in another summation order; bf16: the
    # f32 result may round to the neighbouring bf16 value (2^-8 relative)
    atol, rtol = (1e-5, 1e-4) if dtype_name == "float32" else (1e-4, 2**-7)
    err, ok_o = _err(o, o_ref, atol, rtol)
    lse_err, ok_l = _err(lse, lse_ref, 1e-4, 1e-5)
    if causal:
        pairs = sum(min(i + 1, n) for i in range(Tq))
    else:
        pairs = Tq * n
    isz = q.element_size()
    nbytes = isz * B * H * D * (2 * Tq + 2 * n) + 4 * B * H * Tq
    bounds = _flash_bounds(4.0 * D * B * H * pairs, nbytes, dtype_name)
    args = _copies((q, k, v))
    width = _kernel_width(variant, D)
    twin = _cuda_core_twin(variant, width)
    turns = {}
    if variants:
        _check(twin is not None, "flash_attention %s %s takes the %s "
               "variant" % ([B, Tq, H, D], dtype_name, variant))
        run_args = {}
        for name in (variant, twin):
            w = _kernel_width(name, D)
            run_args[name] = args if w == D else _copies(
                tuple(_pad_d(t, w) for t in (q, k, v)))
        to, tlse = launchers[twin](*run_args[twin][0], causal, scale, kv_len)
        torch.cuda.synchronize()
        twin_err, ok_to = _err(to[..., :D], o_ref, atol, rtol)
        twin_lse_err, ok_tl = _err(tlse, lse_ref, 1e-4, 1e-5)
        del to, tlse
        for name in (variant, twin, twin, variant):
            fn = launchers[name]
            turns.setdefault(name, []).append(_time_ms(
                lambda q, k, v, fn=fn: fn(q, k, v, causal, scale, kv_len),
                run_args[name]))
    rec = {
        "kernel": "flash_attention", "variant": variant,
        "q": [B, Tq, H, D], "k": [B, Tk, H, D], "padded_head_dim": width,
        "causal": causal, "kv_len": n, "dtype": dtype_name,
        "max_abs_err": err,
        "atol": atol, "rtol": rtol, "lse_max_abs_err": lse_err,
        "repeat_bit_identical": repeat_ok, "ok": ok_o and ok_l and repeat_ok,
        "ms": (statistics.mean(turns[variant]) if turns else _time_ms(
            lambda q, k, v: _flash_cuda(q, k, v, causal, None, kv_len),
            args)),
        "plain_ms": _time_ms(lambda q, k, v: flash_attention_reference(
            q, k[:, :n], v[:, :n], causal, return_lse=True), args,
            rounds=1),
        # the same [B, T, H, D] views the kernel reads, no copies
        "library_ms": _time_ms(
            lambda q, k, v: F.scaled_dot_product_attention(
                q.transpose(1, 2), k[:, :n].transpose(1, 2),
                v[:, :n].transpose(1, 2), is_causal=causal), args),
        **bounds,
    }
    rec["ms_over_bound"] = rec["ms"] / rec["bound_ms"]
    if turns:
        twin_ms = statistics.mean(turns[twin])
        rec.update({
            "%s_ms_turns" % variant: turns[variant],
            "%s_ms_turns" % twin: turns[twin],
            "%s_ms" % twin: twin_ms,
            "%s_over_%s" % (twin, variant): twin_ms / rec["ms"],
            "%s_max_abs_err" % twin: twin_err,
            "%s_lse_max_abs_err" % twin: twin_lse_err,
            "%s_padded_head_dim" % twin: _kernel_width(twin, D)})
        rec["ok"] = rec["ok"] and ok_to and ok_tl
    _emit(rec)
    _check(rec["ok"], "flash_attention %s %s disagrees with its plain "
           "version or repeats differ (o err %g, lse err %g, repeat "
           "bit-identical %s%s)" % (
               rec["q"], variant, err, lse_err, repeat_ok,
               "; %s o err %g, lse err %g" % (twin, twin_err, twin_lse_err)
               if turns else ""))
    return rec


def _time_eager_ms(fn, reps=20):
    """Device milliseconds of one call of ``fn``, called ``reps`` times
    between two CUDA events after a warm call (no graph: for the library
    yardsticks that run autograd)."""
    import torch

    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _sdpa_bwd_ms(q, k, v, do, causal, rounds=2, replays=5):
    """Device milliseconds of SDPA's backward alone at the shape of ``q``,
    ``k``, ``v`` ([B, T, H, D]), on the terms of :func:`_time_ms`: copies
    of the inputs past twice the L2 cache (:func:`_copies`), each with its
    own retained SDPA forward, their backwards (``torch.autograd.grad``)
    ``rounds`` times over captured into one CUDA graph on the forwards'
    stream (a backward runs on its forward's stream), so that each call
    finds its inputs cold and no host time enters; the median over
    ``replays`` replays, divided by the calls in one."""
    import torch
    import torch.nn.functional as F

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    sets = []
    with torch.cuda.stream(side):
        for q_, k_, v_, do_ in _copies((q, k, v, do)):
            leaves = tuple(t.transpose(1, 2).detach().requires_grad_(True)
                           for t in (q_, k_, v_))
            out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
            sets.append((out, leaves, do_.transpose(1, 2)))
        for out, leaves, g in sets:                       # warm up
            torch.autograd.grad(out, leaves, g, retain_graph=True)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(rounds):
            for out, leaves, g in sets:
                torch.autograd.grad(out, leaves, g, retain_graph=True)
    torch.cuda.current_stream().wait_stream(side)
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / (rounds * len(sets)))
    del graph
    return statistics.median(times)


def _xent_case(N, V, dtype_name, gen):
    """Both softmax cross-entropy kernels on logits [N, V]: two records."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.kernels import layers

    dt = getattr(torch, dtype_name)
    logits = (3 * torch.randn((N, V), generator=gen, device="cuda")).to(dt)
    labels = torch.randint(0, V, (N,), generator=gen, device="cuda")
    g = torch.randn(N, generator=gen, device="cuda")
    loss, lse = layers._xent_fwd_cuda(logits, labels)
    rloss, rlse = layers.softmax_xent_reference(logits, labels,
                                                return_lse=True)
    d = layers._xent_bwd_cuda(logits, labels, lse, g)
    rd = layers.softmax_xent_bwd_reference(logits, labels, lse, g)
    torch.cuda.synchronize()
    # loss and lse: f32 sums of V exponentials in another order, with expf
    # and logf within 2 ulp; dlogits: f32 within 2 ulp of exp, bf16 one
    # rounding of it (2^-8 relative)
    err_l, ok_l = _err(loss, rloss, 1e-4, 1e-5)
    err_s, ok_s = _err(lse, rlse, 1e-4, 1e-5)
    d_atol, d_rtol = (1e-6, 1e-5) if dtype_name == "float32" \
        else (1e-6, 2**-7)
    err_d, ok_d = _err(d, rd, d_atol, d_rtol)
    isz = logits.element_size()
    fwd_bound, fwd_by = _bound(4.0 * N * V, N * V * isz + 16 * N, "float32")
    bwd_bound, bwd_by = _bound(4.0 * N * V, 2 * N * V * isz + 16 * N,
                               "float32")
    fargs = _copies((logits, labels))
    bargs = _copies((logits, labels, lse, g))
    fwd = {
        "kernel": "fused_softmax_xent", "shape": [N, V], "dtype": dtype_name,
        "max_abs_err": max(err_l, err_s), "atol": 1e-4, "rtol": 1e-5,
        "ok": ok_l and ok_s,
        "ms": _time_ms(layers._xent_fwd_cuda, fargs),
        "plain_ms": _time_ms(lambda l, y: layers.softmax_xent_reference(
            l, y, return_lse=True), fargs),
        "library_ms": _time_ms(lambda l, y: F.cross_entropy(
            l, y, reduction="none"), fargs),
        "library": "F.cross_entropy(reduction='none')",
        "bound_ms": fwd_bound, "bound_by": fwd_by,
    }
    bwd = {
        "kernel": "fused_softmax_xent_bwd", "shape": [N, V],
        "dtype": dtype_name, "max_abs_err": err_d, "atol": d_atol,
        "rtol": d_rtol, "ok": ok_d,
        "ms": _time_ms(layers._xent_bwd_cuda, bargs),
        "plain_ms": _time_ms(layers.softmax_xent_bwd_reference, bargs),
        # one softmax reads and writes the same bytes as the backward
        "library_ms": _time_ms(lambda l, y, s, g: torch.softmax(l, -1),
                               bargs),
        "library": "torch.softmax (same bytes read and written)",
        "bound_ms": bwd_bound, "bound_by": bwd_by,
    }
    for rec in (fwd, bwd):
        _emit(rec)
        _check(rec["ok"], "%s %s %s disagrees with its plain version (max "
               "abs err %g)" % (rec["kernel"], [N, V], dtype_name,
                                rec["max_abs_err"]))
    return fwd, bwd


def _flash_bwd_case(B, Tq, Tk, H, D, causal, dtype_name, gen,
                    with_dlse=False, variants=False):
    """The dQ and the dK/dV kernel of the variant ``_variant`` names for
    the backward against the plain backward and autograd through the dense
    forward, and two calls bit for bit (no atomics): two records.
    ``variants``: the variant is a tensor-core one; also hold its CUDA-core
    twin (``_cuda_core_twin``: simt for wgmma and for tf32x3 at 64 and
    128, wide for the others) against the plain backward and time the two
    in turns (tensor-core, CUDA-core, CUDA-core, tensor-core); ``ms`` is
    then the tensor-core kernel's mean of its two turns.  A head dim the
    kernels lack is timed at its padded width (each variant's own,
    ``_kernel_width``: tf32x3_xwide runs 320 at 384, wgmma_xxwide 576 at
    640, wide at 320 and 576), on inputs padded once, as the backward runs
    it; the bounds count the real head_dim's work.  ``library_ms`` is
    SDPA's backward on inputs cycled past the L2 cache
    (:func:`_sdpa_bwd_ms`)."""
    import torch
    from mxnet_tpu_torch.ops.kernels.flash_attention import (
        _delta, _flash_bwd_cuda, _flash_cuda,
        _flash_dkv_simt_cuda, _flash_dkv_tf32x3_cuda,
        _flash_dkv_tf32x3_xwide_cuda, _flash_dkv_wgmma_cuda,
        _flash_dkv_wgmma_wide_cuda, _flash_dkv_wgmma_xwide_cuda,
        _flash_dkv_wide_cuda, _flash_dq_simt_cuda, _flash_dq_tf32x3_cuda,
        _flash_dq_tf32x3_xwide_cuda, _flash_dq_wgmma_cuda,
        _flash_dq_wgmma_wide_cuda, _flash_dq_wgmma_xwide_cuda,
        _flash_dq_wgmma_xxwide_cuda, _flash_dkv_wgmma_xxwide_cuda,
        _flash_dq_wide_cuda, _kernel_width, _pad_d, _variant,
        flash_attention_bwd_reference, flash_attention_reference)

    dt = getattr(torch, dtype_name)
    scale = 1.0 / D ** 0.5
    launchers = {
        "wgmma": (_flash_dq_wgmma_cuda, _flash_dkv_wgmma_cuda),
        "wgmma_wide": (_flash_dq_wgmma_wide_cuda, _flash_dkv_wgmma_wide_cuda),
        "tf32x3": (_flash_dq_tf32x3_cuda, _flash_dkv_tf32x3_cuda),
        "wgmma_xwide": (_flash_dq_wgmma_xwide_cuda,
                        _flash_dkv_wgmma_xwide_cuda),
        "tf32x3_xwide": (_flash_dq_tf32x3_xwide_cuda,
                         _flash_dkv_tf32x3_xwide_cuda),
        "wgmma_xxwide": (_flash_dq_wgmma_xxwide_cuda,
                         _flash_dkv_wgmma_xxwide_cuda),
        "simt": (_flash_dq_simt_cuda, _flash_dkv_simt_cuda),
        "wide": (_flash_dq_wide_cuda, _flash_dkv_wide_cuda)}

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    q, k, v = rnd(B, Tq, H, D), rnd(B, Tk, H, D), rnd(B, Tk, H, D)
    o, lse = _flash_cuda(q, k, v, causal)
    do = rnd(B, Tq, H, D)
    dlse = (torch.randn((B, H, Tq), generator=gen, device="cuda")
            if with_dlse else None)
    got = _flash_bwd_cuda(q, k, v, o, lse, do, dlse, causal)
    again = _flash_bwd_cuda(q, k, v, o, lse, do, dlse, causal)
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, dlse, causal)
    torch.cuda.synchronize()
    repeat_ok = all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    # f32 sums over every key (dQ) or query (dK, dV) in another order;
    # bf16 adds one rounding of that sum (2^-8 relative)
    atol, rtol = (1e-4, 1e-4) if dtype_name == "float32" \
        else (1e-3, 2**-7)
    errs = [_err(a, b, atol, rtol) for a, b in zip(got, want)]
    # the plain backward repeats the kernels' arithmetic (same lse, same
    # delta) and may agree bit for bit, so the kernels are also held
    # against an independent formula: autograd through the dense forward.
    # In bf16 that formula takes delta = sum(p * dp) in f32 where the
    # kernels, as the TPU's do, take rowsum(dO * O) of the bf16-rounded O;
    # held to 2^-6 of each gradient's largest entry (wgmma_xwide and its
    # cluster twin wgmma_xxwide: 6.5e-3)
    qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
    o_r, lse_r = flash_attention_reference(qr, kr, vr, causal,
                                           return_lse=True)
    outs, cts = (o_r, lse_r), (do, dlse)
    if dlse is None:
        outs, cts = (o_r,), (do,)
    auto = torch.autograd.grad(outs, (qr, kr, vr), cts)
    del o_r, lse_r, outs
    variant = _variant(q.dtype, D, backward=True)
    auto_rel = 1e-4 if dtype_name == "float32" else (
        XWIDE_AUTOGRAD_REL if variant in ("wgmma_xwide", "wgmma_xxwide")
        else 2**-6)
    auto_errs = [float((a.float() - b.float()).abs().max())
                 / float(b.float().abs().max()) for a, b in zip(got, auto)]
    del auto
    auto_ok = max(auto_errs) <= auto_rel
    zero_ok = True
    if causal and Tq < Tk:        # keys no query sees: dK = dV = 0
        zero_ok = not got[1][:, Tq:].any() and not got[2][:, Tq:].any()
    if causal:
        pairs = sum(min(i + 1, Tk) for i in range(Tq))
    else:
        pairs = Tq * Tk
    isz = q.element_size()
    rows = 8 * B * H * Tq                           # lse and delta, f32
    dq_bounds = _flash_bounds(6.0 * D * B * H * pairs,
                              isz * B * H * D * (3 * Tq + 2 * Tk) + rows,
                              dtype_name)
    dkv_bounds = _flash_bounds(8.0 * D * B * H * pairs,
                               isz * B * H * D * (2 * Tq + 4 * Tk) + rows,
                               dtype_name)
    delta = _delta(o, do, dlse)
    plain_ms = _time_ms(
        lambda q, k, v, do, lse, delta: flash_attention_bwd_reference(
            q, k, v, o, lse, do, dlse, causal),
        _copies((q, k, v, do, lse, delta)), rounds=1)
    width = _kernel_width(variant, D, backward=True)
    args = _copies(tuple(_pad_d(t, width) for t in (q, k, v, do))
                   + (lse, delta))
    twin = _cuda_core_twin(variant, width)
    twin_errs = {}
    run_args = {variant: args}
    if variants:
        _check(twin is not None, "flash backward %s %s takes the %s "
               "variant" % ([B, Tq, H, D], dtype_name, variant))
        twin_width = _kernel_width(twin, D, backward=True)
        run_args[twin] = args if twin_width == width else _copies(
            tuple(_pad_d(t, twin_width) for t in (q, k, v, do))
            + (lse, delta))
        qp, kp, vp, dop = run_args[twin][0][:4]
        tdq = launchers[twin][0](qp, kp, vp, dop, lse, delta, causal, scale)
        tdk, tdv = launchers[twin][1](qp, kp, vp, dop, lse, delta, causal,
                                      scale)
        torch.cuda.synchronize()
        errs_t = [_err(a[..., :D], b, atol, rtol)
                  for a, b in zip((tdq, tdk, tdv), want)]
        twin_errs = {"dq": errs_t[:1], "dkv": errs_t[1:]}
        del tdq, tdk, tdv
    turns = {}
    for kind, which in (("dq", 0), ("dkv", 1)):
        order = (variant, twin, twin, variant) if variants else (variant,)
        for name in order:
            fn = launchers[name][which]
            turns.setdefault((kind, name), []).append(_time_ms(
                lambda q, k, v, do, lse, delta, fn=fn: fn(
                    q, k, v, do, lse, delta, causal, scale),
                run_args[name]))
    # SDPA's backward alone at the same shape, on inputs cycled past the
    # L2 cache as the kernels' are
    lib_ms = _sdpa_bwd_ms(q, k, v, do, causal)
    shared = {"q": [B, Tq, H, D], "k": [B, Tk, H, D], "causal": causal,
              "dtype": dtype_name, "dlse": with_dlse, "variant": variant,
              "padded_head_dim": width, "atol": atol, "rtol": rtol,
              "err_vs_dense_autograd_rel_to_max": auto_errs,
              "dense_autograd_rel_tol": auto_rel,
              "repeat_bit_identical": repeat_ok,
              # the plain version computes dQ, dK and dV in one call, and
              # SDPA's backward all three too: both rows carry that time
              "plain_ms": plain_ms, "library_ms": lib_ms,
              "library": "SDPA backward (torch.autograd.grad over a "
                         "retained SDPA forward)"}
    dq = dict(shared, kernel="flash_attention_dq", max_abs_err=errs[0][0],
              ok=errs[0][1] and auto_ok and repeat_ok, **dq_bounds)
    dkv = dict(shared, kernel="flash_attention_dkv",
               max_abs_err=max(errs[1][0], errs[2][0]),
               ok=(errs[1][1] and errs[2][1] and zero_ok and auto_ok
                   and repeat_ok), **dkv_bounds)
    for rec, kind in ((dq, "dq"), (dkv, "dkv")):
        rec["ms"] = statistics.mean(turns[(kind, variant)])
        if variants:
            terr = twin_errs[kind]
            twin_ms = statistics.mean(turns[(kind, twin)])
            rec.update({
                "%s_ms_turns" % variant: turns[(kind, variant)],
                "%s_ms_turns" % twin: turns[(kind, twin)],
                "%s_ms" % twin: twin_ms,
                "%s_over_%s" % (twin, variant): twin_ms / rec["ms"],
                "%s_max_abs_err" % twin: max(e[0] for e in terr),
                "%s_padded_head_dim" % twin: _kernel_width(twin, D,
                                                           backward=True)})
            rec["ok"] = rec["ok"] and all(e[1] for e in terr)
        rec["ms_over_bound"] = rec["ms"] / rec["bound_ms"]
    for rec in (dq, dkv):
        _emit(rec)
        _check(rec["ok"], "%s q %s k %s %s disagrees with its plain version "
               "or with dense autograd, or repeats differ (max abs err %g, "
               "autograd %s, repeat bit-identical %s)"
               % (rec["kernel"], rec["q"], rec["k"], dtype_name,
                  rec["max_abs_err"], auto_errs, repeat_ok))
    return dq, dkv


def _twin_record(rec):
    """A ``_flash_case`` or ``_flash_bwd_case`` record made with
    ``variants=True`` as its CUDA-core twin's: the twin's time and error at
    the same shape, the same bound."""
    twin = _cuda_core_twin(rec["variant"], rec["padded_head_dim"])
    out = dict(rec, variant=twin, ms=rec["%s_ms" % twin],
               max_abs_err=rec["%s_max_abs_err" % twin])
    out["ms_over_bound"] = out["ms"] / out["bound_ms"]
    return out


def _int8_case(M, K, N, gen):
    """Both int8 matmul kernels on a [M, K] x [N, K]: int32 out, and the
    fused dequant with a scalar ``scale_a`` and a per-channel ``scale_b``
    (bench.py's kernel leg).  The variant the planner picks and, where it
    is wgmma, the mma variant too must equal the plain version bit for bit;
    the two are timed in turns (wgmma, mma, mma, wgmma) beside
    ``torch._int_mm``.  ``ms`` is the planned variant's.  Two records."""
    import torch
    from mxnet_tpu_torch.ops.kernels.int8_matmul import (
        _int8_matmul_cuda, _int8_mm_mma_cuda, _int8_mm_wgmma_cuda,
        _tma_aligned, int8_matmul_reference, plan_int8_matmul)

    a = torch.randint(-127, 128, (M, K), generator=gen, device="cuda",
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (N, K), generator=gen, device="cuda",
                      dtype=torch.int8)
    sa = torch.tensor([0.05], device="cuda")
    sb = torch.rand(N, generator=gen, device="cuda") * 0.1 + 0.01
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = plan_int8_matmul(M, N, K, sms, _tma_aligned(a, b))
    fns = {"wgmma": _int8_mm_wgmma_cuda, "mma": _int8_mm_mma_cuda}
    variants = ("wgmma", "mma") if plan.variant == "wgmma" else ("mma",)

    def lib(a, b):
        return torch._int_mm(a, b.t())

    try:                         # cuBLASLt's shape rules: M > 16, K, N % 8
        lib(a, b)
        torch.cuda.synchronize()
    except RuntimeError:
        lib = None
    ops = 2.0 * M * N * K
    args = _copies((a, b))
    dargs = _copies((a, b, sa, sb))
    lib_ms = _time_ms(lib, args) if lib else None
    recs = []
    for name, scales, nbytes, fargs in (
            ("int8_matmul", (), M * K + N * K + 4 * M * N, args),
            ("int8_matmul_dequant", (sa, sb),
             M * K + N * K + 4 * M * N + 4 * N, dargs)):
        ref = int8_matmul_reference(a, b, *scales)
        got = _int8_matmul_cuda(a, b, *scales)
        outs = {v: fns[v](a, b, *scales) for v in variants}
        torch.cuda.synchronize()
        # bitwise: the f32 outputs compared as their int32 bit patterns
        exact = {v: bool(torch.equal(o.view(torch.int32),
                                     ref.view(torch.int32)))
                 for v, o in dict(outs, routed=got).items()}
        err = max(float((o.double() - ref.double()).abs().max())
                  for o in dict(outs, routed=got).values())
        del outs, got
        turns = {}
        order = ("wgmma", "mma", "mma", "wgmma") if len(variants) == 2 \
            else ("mma",)
        for v in order:
            turns.setdefault(v, []).append(_time_ms(fns[v], fargs))
        bound, by = _bound(ops, nbytes, "int8")
        ok = all(exact.values())
        rec = {"kernel": name, "M": M, "K": K, "N": N,
               "variant": plan.variant, "plan": plan._asdict(),
               "bit_exact": exact, "max_abs_err": err, "ok": ok,
               "ms": statistics.mean(turns[plan.variant]),
               "ms_turns": turns,
               "mma_ms": statistics.mean(turns["mma"]),
               "plain_ms": _time_ms(int8_matmul_reference, fargs),
               "library_ms": lib_ms,
               "library": "torch._int_mm (cuBLASLt int8; the int32 "
                          "accumulator only)" if lib else
                          "none: torch._int_mm refuses this shape",
               "bound_ms": bound, "bound_by": by}
        rec["ms_over_library"] = rec["ms"] / lib_ms if lib_ms else None
        rec["mma_over_ms"] = rec["mma_ms"] / rec["ms"]
        _emit(rec)
        _check(ok, "%s [%d, %d] x [%d, %d] is not bit-exact against its "
               "plain version: %s (max abs err %g)" % (name, M, K, N, K,
                                                      exact, err))
        recs.append(rec)
    return recs


def phase_kernels():
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    main = {}
    for shape in RMSNORM_SHAPES:
        rec = _rmsnorm_case(shape, "bfloat16", gen)
        if shape == (4096, 2048):
            main["fused_rmsnorm"] = rec
        elif shape == (8, 2048):                     # decode
            main["fused_rmsnorm.block"] = rec
    for shape in RMSNORM_F32_SHAPES:
        _rmsnorm_case(shape, "float32", gen)
    for shape in RMSNORM_BWD_SHAPES:
        _rmsnorm_bwd_plain_case(shape, gen)
    main["flash_attention"] = _flash_case(1, 4096, 4096, 16, 128, True,
                                          "bfloat16", gen, variants=True)
    _flash_case(1, 4000, 4000, 16, 128, True, "bfloat16", gen)
    _flash_case(1, 1000, 3000, 16, 128, False, "bfloat16", gen)
    # the training path: the long-context configuration's attention and
    # both configurations' logits
    _flash_case(1, 8192, 8192, 16, 64, True, "bfloat16", gen, variants=True)
    main["flash_attention_dq"], main["flash_attention_dkv"] = \
        _flash_bwd_case(1, 8192, 8192, 16, 64, True, "bfloat16", gen,
                        variants=True)
    # the flagship's head_dim, and a head_dim the kernels pad (96 -> 128)
    _flash_bwd_case(1, 4096, 4096, 16, 128, True, "bfloat16", gen,
                    variants=True)
    _flash_case(1, 4096, 4096, 16, 96, True, "bfloat16", gen)
    _flash_bwd_case(1, 4096, 4096, 16, 96, True, "bfloat16", gen,
                    with_dlse=True)
    # f32 at head_dim 33-128: the forward, dQ and dK/dV on tf32x3's
    # narrow plans, each in turns with simt (the CUDA-core kernels they
    # replaced there) beside SDPA f32: [2, 1024, 8, 64] (the backward with
    # an lse cotangent), the f32 long-context leg's [1, 8192, 16, 64]
    # (whose records the kernels line carries), head_dim 128, 40 and 96
    # (padded to 64 and 128; the backward with dlse), Tq 1000 x Tk 3000 not
    # causal and, the forward, kv_len below Tk
    _flash_case(2, 1024, 1024, 8, 64, True, "float32", gen, variants=True)
    main["flash_attention.tf32x3.narrow"] = _flash_case(
        1, 8192, 8192, 16, 64, True, "float32", gen, variants=True)
    _flash_case(1, 4096, 4096, 16, 128, True, "float32", gen, variants=True)
    _flash_case(1, 777, 777, 4, 40, True, "float32", gen, variants=True)
    _flash_case(1, 777, 777, 4, 96, True, "float32", gen, variants=True)
    _flash_case(1, 1000, 3000, 16, 64, False, "float32", gen, variants=True)
    _flash_case(2, 1000, 3000, 8, 64, True, "float32", gen, variants=True,
                kv_len=2345)
    _flash_case(1, 1000, 3000, 8, 128, False, "float32", gen, variants=True,
                kv_len=1111)
    _flash_bwd_case(2, 1024, 1024, 8, 64, True, "float32", gen,
                    with_dlse=True, variants=True)
    main["flash_attention_dq.tf32x3.narrow"], \
        main["flash_attention_dkv.tf32x3.narrow"] = _flash_bwd_case(
            1, 8192, 8192, 16, 64, True, "float32", gen, variants=True)
    _flash_bwd_case(1, 4096, 4096, 16, 128, True, "float32", gen,
                    variants=True)
    _flash_bwd_case(1, 777, 777, 4, 40, True, "float32", gen,
                    with_dlse=True)
    _flash_bwd_case(1, 777, 777, 4, 96, True, "float32", gen,
                    with_dlse=True)
    _flash_bwd_case(1, 1000, 3000, 16, 64, False, "float32", gen)
    # the widths simt still serves, both ways (head_dim 16 and 32, bf16 and
    # f32; no main path runs there) beside SDPA
    for D in (32, 16):
        for dt in ("bfloat16", "float32"):
            _flash_case(1, 4096, 4096, 16, D, True, dt, gen)
            _flash_bwd_case(1, 4096, 4096, 16, D, True, dt, gen)
    # head dims above 128 (160 pads to 192; 320 is three column chunks of
    # at most 128): at padded 192 and 256 the tensor-core forward and
    # backward, wgmma_wide in bf16 and tf32x3 in f32, timed in turns with
    # their wide twins; at 320 f32 on tf32x3_xwide, bf16 on wgmma_xwide
    # (below).  The wide backward records are f32's: the kernels tf32x3
    # replaced on the f32 leg
    for dt in ("bfloat16", "float32"):
        fwd = _flash_case(1, 4096, 4096, 16, 256, True, dt, gen,
                          variants=True)
        dq, dkv = _flash_bwd_case(1, 4096, 4096, 16, 256, True, dt, gen,
                                  with_dlse=dt == "float32", variants=True)
        if dt == "bfloat16":
            main["flash_attention.wgmma_wide"] = fwd
            main["flash_attention_dq.wgmma_wide"] = dq
            main["flash_attention_dkv.wgmma_wide"] = dkv
        else:
            main["flash_attention.tf32x3"] = fwd
            main["flash_attention_dq.tf32x3"] = dq
            main["flash_attention_dkv.tf32x3"] = dkv
            main["flash_attention_dq.wide"] = _twin_record(dq)
            main["flash_attention_dkv.wide"] = _twin_record(dkv)
    # the head_dim-256 training leg's attention ([1, 8192, 4, 256]), D 192,
    # Tq != Tk, and head_dim 160 (padded to 192)
    _flash_case(1, 8192, 8192, 4, 256, True, "bfloat16", gen)
    _flash_bwd_case(1, 8192, 8192, 4, 256, True, "bfloat16", gen)
    _flash_case(1, 4096, 4096, 16, 192, True, "bfloat16", gen)
    _flash_bwd_case(1, 4096, 4096, 16, 192, True, "bfloat16", gen)
    _flash_case(1, 1000, 3000, 16, 256, False, "bfloat16", gen)
    _flash_bwd_case(1, 1000, 3000, 16, 256, False, "bfloat16", gen)
    # bf16 at 320: the forward and the backward on wgmma_xwide (in turns
    # with wide)
    _flash_case(2, 1000, 1000, 4, 320, False, "bfloat16", gen, variants=True)
    _flash_bwd_case(2, 1000, 1000, 4, 320, False, "bfloat16", gen,
                    variants=True)
    _flash_case(1, 777, 777, 4, 160, True, "float32", gen)
    _flash_case(1, 777, 777, 4, 160, True, "bfloat16", gen)
    _flash_bwd_case(1, 777, 777, 4, 160, True, "bfloat16", gen,
                    with_dlse=True)
    # f32 on tf32x3: the f32 leg's [1, 8192, 4, 256] (the forward in turns
    # with wide), D 192, Tq != Tk not causal, and head_dim 160 (padded to
    # 192; the backward with an lse cotangent)
    _flash_case(1, 8192, 8192, 4, 256, True, "float32", gen, variants=True)
    _flash_case(1, 4096, 4096, 16, 192, True, "float32", gen)
    _flash_case(1, 1000, 3000, 16, 256, False, "float32", gen)
    _flash_bwd_case(1, 8192, 8192, 4, 256, True, "float32", gen)
    _flash_bwd_case(1, 4096, 4096, 16, 192, True, "float32", gen)
    _flash_bwd_case(1, 1000, 3000, 16, 256, False, "float32", gen)
    _flash_bwd_case(1, 777, 777, 4, 160, True, "float32", gen,
                    with_dlse=True)
    _flash_bwd_case(1, 1000, 3000, 16, 64, False, "bfloat16", gen)
    _flash_bwd_case(1, 1000, 3000, 16, 64, True, "bfloat16", gen)
    # bf16 above 256 on wgmma_xwide, forward and backward, in turns with
    # wide: the head_dim-512 leg's [2, 8192, 2, 512], [1, 4096, 16, 512]
    # and [1, 4096, 16, 384]
    main["flash_attention.wgmma_xwide"] = _flash_case(
        2, 8192, 8192, 2, 512, True, "bfloat16", gen, variants=True)
    _flash_case(1, 4096, 4096, 16, 512, True, "bfloat16", gen, variants=True)
    _flash_case(1, 4096, 4096, 16, 384, True, "bfloat16", gen, variants=True)
    main["flash_attention_dq.wgmma_xwide"], \
        main["flash_attention_dkv.wgmma_xwide"] = _flash_bwd_case(
            2, 8192, 8192, 2, 512, True, "bfloat16", gen, variants=True)
    _flash_bwd_case(1, 4096, 4096, 16, 512, True, "bfloat16", gen,
                    variants=True)
    _flash_bwd_case(1, 4096, 4096, 16, 384, True, "bfloat16", gen,
                    with_dlse=True, variants=True)
    # f32 above 256: the forward, dQ and dK/dV on tf32x3_xwide (2-CTA
    # clusters that split D), in turns with wide: the f32 hd512 leg's [2,
    # 8192, 2, 512] (the shape its 8 forwards and 4 + 4 backward kernels a
    # step run at), [1, 4096, 16, 512], [2, 1000, 4, 320] (run at 384; wide
    # at 320) and, the backward, [1, 4096, 16, 384] with an lse cotangent.
    # The wide forward's record is its turns at the leg's shape: the
    # kernel tf32x3_xwide replaced on the leg
    fwd = _flash_case(2, 8192, 8192, 2, 512, True, "float32", gen,
                      variants=True)
    main["flash_attention.tf32x3_xwide"] = fwd
    main["flash_attention.wide"] = _twin_record(fwd)
    _flash_case(1, 4096, 4096, 16, 512, True, "float32", gen, variants=True)
    _flash_case(2, 1000, 1000, 4, 320, False, "float32", gen, variants=True)
    main["flash_attention_dq.tf32x3_xwide"], \
        main["flash_attention_dkv.tf32x3_xwide"] = _flash_bwd_case(
            2, 8192, 8192, 2, 512, True, "float32", gen, variants=True)
    _flash_bwd_case(1, 4096, 4096, 16, 512, True, "float32", gen,
                    variants=True)
    _flash_bwd_case(1, 4096, 4096, 16, 384, True, "float32", gen,
                    with_dlse=True, variants=True)
    _flash_bwd_case(2, 1000, 1000, 4, 320, False, "float32", gen,
                    variants=True)
    # bf16 above 512: the forward, dQ and dK/dV on wgmma_xxwide (2-CTA
    # clusters that split D; 576 runs at 640) in turns with wide (at 576),
    # beside SDPA, at [2, 1000, 4, 576], [1, 4096, 16, 576] and the
    # head_dim-1024 leg's [4, 8192, 1, 1024]
    for args in ((2, 1000, 1000, 4, 576, False), (1, 4096, 4096, 16, 576,
                                                  True)):
        main["flash_attention.wgmma_xxwide"] = _flash_case(
            *args, "bfloat16", gen, variants=True)
        main["flash_attention_dq.wgmma_xxwide"], \
            main["flash_attention_dkv.wgmma_xxwide"] = _flash_bwd_case(
                *args, "bfloat16", gen, variants=True)
    _flash_case(4, 8192, 8192, 1, 1024, True, "bfloat16", gen, variants=True)
    _flash_bwd_case(4, 8192, 8192, 1, 1024, True, "bfloat16", gen,
                    variants=True)
    # the widths wide still serves (f32 above 512, bf16 above 1024), the
    # forward, dQ and dK/dV beside SDPA: f32 at [2, 1000, 4, 576] not
    # causal and bf16 at [1, 1024, 2, 1152] causal
    _flash_case(2, 1000, 1000, 4, 576, False, "float32", gen)
    _flash_bwd_case(2, 1000, 1000, 4, 576, False, "float32", gen)
    _flash_case(1, 1024, 1024, 2, 1152, True, "bfloat16", gen)
    _flash_bwd_case(1, 1024, 1024, 2, 1152, True, "bfloat16", gen)
    main["fused_softmax_xent"], main["fused_softmax_xent_bwd"] = \
        _xent_case(8192, 32000, "float32", gen)
    _xent_case(8192, 32000, "bfloat16", gen)
    _xent_case(777, 30001, "float32", gen)
    # the INT8 path: bench.py's 2048^3 kernel leg, VGG16's fc6, fc7 and
    # fc8 at batch 128 (the int8_vgg16 pair's classifier), ResNet-50's
    # classifier (the shape the int8 phase runs) and a ragged case (no
    # dimension a multiple of the tiles, K odd)
    _int8_case(2048, 2048, 2048, gen)
    for K, N in VGG_FC:
        _int8_case(VGG_BATCH, K, N, gen)
    main["int8_matmul"], main["int8_matmul_dequant"] = \
        _int8_case(INT8_BATCH, 2048, INT8_NET["num_classes"], gen)
    _int8_case(777, 301, 1001, gen)
    return main


@contextlib.contextmanager
def _plain_versions():
    """Route every kernel of the registry to its plain version on CUDA
    tensors too, for the kernel-vs-plain checks; restored on exit."""
    from mxnet_tpu_torch.ops.kernels import common

    saved = {n: dict(e) for n, e in common._REGISTRY.items()}
    try:
        for name, entry in saved.items():
            common.register_impl(name, cuda=entry["reference"],
                                 reference=entry["reference"])
        yield
    finally:
        common._REGISTRY.update(saved)


def phase_serve(dev):
    import numpy as np
    import torch
    from mxnet_tpu_torch import (GenerationConfig, GenerationServer,
                                 TransformerConfig, TransformerLM)
    from mxnet_tpu_torch.generation import _pick_bucket
    from mxnet_tpu_torch.ops.kernels import common
    from mxnet_tpu_torch.ops.kernels.layers import plan_rmsnorm

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = TransformerLM(TransformerConfig(**FLAGSHIP), device="cuda",
                          generator=gen)
    n_params = sum(p.numel() for p in model.parameters())
    # one decode slot bucket: a solo stream then runs the same GEMM shapes
    # as a batched one, so its rows reduce in the same order (with pow2
    # buckets an M=1 GEMM may reduce in another order than M=8, and bf16
    # greedy streams can part at a near-tie)
    gcfg = GenerationConfig(page_size=16, max_pages=1024, max_slots=8,
                            max_new_tokens=MAX_NEW, slot_buckets="8",
                            temperature=0.0, top_k=0, seed=0)
    srv = GenerationServer(model, gcfg, device="cuda")
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, FLAGSHIP["vocab_size"], n)
               for n in PROMPT_LENS]

    # -- the main path: counters zeroed just before, read just after ----
    common.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    futs = [srv.submit_async(p, max_new_tokens=MAX_NEW) for p in prompts]
    outs = [f.result(timeout=600) for f in futs]
    solo = srv.submit(prompts[SOLO_INDEX], max_new_tokens=MAX_NEW,
                      timeout=600)
    torch.cuda.synchronize()
    selects = common.selection_counts()
    launches = common.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    snap = srv.snapshot()
    _check(srv.drain(timeout=60), "drain did not complete")

    _check(all(len(o) == MAX_NEW for o in outs),
           "not every request resolved with %d tokens: %s"
           % (MAX_NEW, [len(o) for o in outs]))
    _check(all(0 <= t < FLAGSHIP["vocab_size"] for o in outs for t in o),
           "token id out of range")
    _check(solo == outs[SOLO_INDEX], "solo stream %s != batched %s"
           % (solo, outs[SOLO_INDEX]))
    for name in ("fused_rmsnorm", "flash_attention"):
        _check(selects.get("kernels.select.%s.cuda" % name, 0) > 0
               and launches.get("kernels.launch.%s" % name, 0) > 0,
               "%s never ran its CUDA kernel on the main path" % name)
    _check(not any(k.endswith(".reference") for k in selects),
           "a plain version ran on the main path: %s" % selects)
    # RMSNorm, twice per layer at each prefill's bucket and once on its
    # last row, and twice per layer and once more per decode iteration at
    # the slot bucket: only the vector variants, warp exactly for the
    # prefill buckets the planner gives it
    eng = srv.engine
    n_layers, E = FLAGSHIP["n_layers"], FLAGSHIP["d_model"]
    sms = common.sm_count(torch.device("cuda", 0))
    warp = 2 * n_layers * sum(
        plan_rmsnorm(_pick_bucket(eng.prefill_chain, len(p)), E,
                     torch.bfloat16, E, 16, sms).variant == "warp"
        for p in prompts + [prompts[SOLO_INDEX]])
    rms = {k: v for k, v in launches.items()
           if k.startswith("kernels.launch.fused_rmsnorm")}
    total = rms.get("kernels.launch.fused_rmsnorm", 0)
    _check(rms == {"kernels.launch.fused_rmsnorm": total,
                   "kernels.launch.fused_rmsnorm.warp": warp,
                   "kernels.launch.fused_rmsnorm.block": total - warp}
           and total > warp,
           "RMSNorm launches on the serve path %s, expected %d through the "
           "warp variant and the rest through block" % (rms, warp))
    flash = {k: v for k, v in launches.items()
             if k.startswith("kernels.launch.flash_attention")}
    _check(flash == {"kernels.launch.flash_attention": SERVE_FLASH_LAUNCHES,
                     "kernels.launch.flash_attention.wgmma":
                         SERVE_FLASH_LAUNCHES},
           "flash forward launches on the serve path %s, expected %d, all "
           "through the tensor-core variant" % (flash, SERVE_FLASH_LAUNCHES))

    ttft_ms = [(f.t_first_token - f.t_admit) * 1e3 for f in futs]
    # every prompt is queued before the first prefill ends, and the
    # scheduler prefills while requests wait: decoding starts after the
    # last first token, and each stream then decodes MAX_NEW - 1 tokens
    t_dec0 = max(f.t_first_token for f in futs)
    t_end = max(f.t_done for f in futs)
    dec_tokens = sum(len(o) - 1 for o in outs)
    _emit({
        "phase": "serve", "device": dev["name"], "nvidia_smi": dev["smi"],
        "params": n_params, "setup_s": t_setup, "requests": len(prompts),
        "prompt_lens": list(PROMPT_LENS), "max_new_tokens": MAX_NEW,
        "ttft_ms": ttft_ms, "ttft_ms_of_4000": ttft_ms[-1],
        "decode_window_s": t_end - t_dec0, "decode_tokens": dec_tokens,
        "decode_tokens_per_s": dec_tokens / (t_end - t_dec0),
        "decode_ms_per_iteration": (t_end - t_dec0) * 1e3 / (MAX_NEW - 1),
        "peak_mem_gb": peak_gb, "selection_counts": selects,
        "launch_counts": launches, "server": snap,
        "solo_equals_batched": True,
    })

    # -- prefill logits through the kernels vs through the plain versions
    # (after the main path: these launches are not counted).  The page
    # table is all zeros, so every K/V write lands in the garbage page.
    eng = srv.engine
    table = np.zeros(eng.pages_per_seq, np.int64)
    long_prompt = prompts[-1]
    logits_k = eng.prefill(long_prompt, table)
    with _plain_versions():
        logits_p = eng.prefill(long_prompt, table)
    diff = float(np.abs(logits_k - logits_p).max())
    ok = (logits_k.shape == (FLAGSHIP["vocab_size"],)
          and bool(np.isfinite(logits_k).all()) and diff <= LOGITS_ATOL)
    _emit({"phase": "prefill_logits_kernels_vs_plain",
           "prompt_len": int(long_prompt.size), "max_abs_err": diff,
           "atol": LOGITS_ATOL, "argmax_equal":
           int(np.argmax(logits_k)) == int(np.argmax(logits_p)), "ok": ok})
    _check(ok, "prefill logits through the kernels differ from the plain "
           "versions by %g (atol %g)" % (diff, LOGITS_ATOL))
    return launches, model


# ---------------------------------------------------------------------------
# the serving plane: QoS, migration, load replay, tenancy, operations
# ---------------------------------------------------------------------------
def _flagship_server(model, max_queue=None, **kw):
    """A GenerationServer over the serve phase's flagship model: greedy,
    page_size 16, 8 slots in one decode bucket."""
    from mxnet_tpu_torch import GenerationConfig, GenerationServer

    cfg = dict(page_size=16, max_slots=8, slot_buckets="8",
               temperature=0.0, top_k=0, seed=0)
    cfg.update(kw)
    return GenerationServer(model, GenerationConfig(**cfg),
                            device=model.device, max_queue=max_queue)


def _wait_for(cond, timeout, what):
    t0 = time.monotonic()
    while not cond():
        _check(time.monotonic() - t0 < timeout, "timed out waiting for "
               + what)
        time.sleep(0.001)


def _outcomes(futs, timeout=300):
    """(outcome name, tokens) of each future: ``ok`` or the typed error."""
    out = []
    for f in futs:
        try:
            out.append(("ok", f.result(timeout=timeout)))
        except Exception as e:         # typed outcomes, reported by name
            out.append((type(e).__name__, f.stream_tokens))
    return out


@contextlib.contextmanager
def _counted(name, out):
    """The counted window of a serving-plane path: the kernel counters
    zeroed just before, read just after, and held to the path's contract:
    no plain version, every RMSNorm through the warp or block variant,
    every flash forward through the tensor-core variant."""
    import torch
    from mxnet_tpu_torch.ops.kernels import common

    common.reset_counts()
    yield
    torch.cuda.synchronize()
    selects = common.selection_counts()
    launches = common.launch_counts()
    out["selects"], out["launches"] = selects, launches
    _check(not any(k.endswith(".reference") for k in selects),
           "%s: a plain version ran: %s" % (name, selects))
    rms = launches.get("kernels.launch.fused_rmsnorm", 0)
    vec = sum(launches.get("kernels.launch.fused_rmsnorm.%s" % v, 0)
              for v in ("warp", "block"))
    _check(rms > 0 and vec == rms,
           "%s: RMSNorm launches %s, expected all through warp / block"
           % (name, {k: v for k, v in launches.items() if "rmsnorm" in k}))
    flash = launches.get("kernels.launch.flash_attention", 0)
    _check(launches.get("kernels.launch.flash_attention.wgmma", 0) == flash,
           "%s: flash launches %s, expected all through wgmma"
           % (name, {k: v for k, v in launches.items() if "flash" in k}))


def phase_serve_qos(dev, model):
    """QoS preemption at full width: six rank-0 streams fill the pool, two
    gold=5 requests preempt; then a page_pressure chaos run."""
    import numpy as np
    from mxnet_tpu_torch import chaos, profiler

    t_phase = time.perf_counter()
    srv = _flagship_server(model, max_pages=QOS_PAGES,
                           max_new_tokens=QOS_NEW)
    V = FLAGSHIP["vocab_size"]
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, V, QOS_PROMPT)
               for _ in range(QOS_LOW + QOS_GOLD)]
    stats0 = dict(srv.stats)
    profiler.start()                  # gen.preempt events carry the tokens
    win = {}
    with _counted("serve_qos", win):
        lows = [srv.submit_async(p, priority="batch=0")
                for p in prompts[:QOS_LOW]]
        _wait_for(lambda: all(len(f.stream_tokens) >= 2 for f in lows), 120,
                  "the rank-0 streams to fill the pool")
        used_full = srv.engine.allocator.used
        golds = [srv.submit_async(p, priority="gold=5")
                 for p in prompts[QOS_LOW:]]
        outs = _outcomes(lows + golds)
    profiler.stop()
    stats = {k: srv.stats[k] - stats0[k] for k in stats0}
    preempt_evts = [e for e in profiler.recent_events(100000)
                    if e.get("name") == "gen.preempt"]
    reprefilled = sum(QOS_PROMPT + e["args"]["tokens"]
                      for e in preempt_evts)
    ttft = {"batch": [(f.t_first_token - f.t_admit) * 1e3 for f in lows],
            "gold": [(f.t_first_token - f.t_admit) * 1e3 for f in golds]}
    t_gold_first = max(f.t_first_token for f in golds)
    t_low_done = min(f.t_done for f in lows)
    _check(all(k == "ok" and len(t) == QOS_NEW for k, t in outs),
           "serve_qos: not every stream resolved with %d tokens: %s"
           % (QOS_NEW, [(k, len(t)) for k, t in outs]))
    _check(stats["preempted"] >= 1, "serve_qos: nothing was preempted")
    _check(stats["shed_pages"] == stats["shed_queue"] == 0,
           "serve_qos: requests were shed: %s" % stats)
    _check(t_gold_first < t_low_done,
           "serve_qos: a gold first token came after the first rank-0 "
           "completion")

    # -- page_pressure: most of the free list impounded mid-decode ------
    win2 = {}
    stats1 = dict(srv.stats)
    with _counted("serve_qos_chaos", win2):
        lows2 = [srv.submit_async(p, priority="batch=0")
                 for p in prompts[:2]]
        _wait_for(lambda: all(len(f.stream_tokens) >= 2 for f in lows2),
                  120, "the chaos run's rank-0 streams")
        with chaos.inject("page_pressure@%d" % (srv._loop_turn + 5)) as plan:
            _wait_for(lambda: srv.engine.allocator.held > 0, 60,
                      "page_pressure to impound the free list")
            held = srv.engine.allocator.held
            gold2 = srv.submit_async(prompts[QOS_LOW], priority="gold=5")
            outs2 = _outcomes(lows2 + [gold2])
    stats2 = {k: srv.stats[k] - stats1[k] for k in stats1}
    _check(plan.pending() == [], "serve_qos: page_pressure never fired")
    _check(all(k == "ok" and len(t) == QOS_NEW for k, t in outs2),
           "serve_qos chaos: not every stream resolved: %s"
           % [(k, len(t)) for k, t in outs2])
    _check(stats2["preempted"] >= 1 and stats2["shed_pages"] == 0,
           "serve_qos chaos: %s" % stats2)
    _wait_for(lambda: srv.engine.allocator.held == 0, 60,
              "the pressure window to end")
    _check(srv.drain(timeout=60), "serve_qos: drain did not complete")
    _check(srv.engine.allocator.used == 0, "serve_qos: pages held")
    rec = {"phase": "serve_qos", "device": dev["name"],
           "nvidia_smi": dev["smi"], "pages_capacity": QOS_PAGES - 1,
           "pages_used_before_gold": used_full,
           "ttft_ms": ttft, "gold_first_token_before_first_rank0_done_ms":
           (t_low_done - t_gold_first) * 1e3,
           "preempted": stats["preempted"],
           "reprefilled_tokens": reprefilled, "stats": stats,
           "chaos": {"impounded_pages": held, "stats": stats2},
           "launch_counts": win["launches"],
           "chaos_launch_counts": win2["launches"],
           "wall_s": time.perf_counter() - t_phase}
    _emit(rec)
    return [win["launches"], win2["launches"]]


def _park_after(srv, prompt, n_tokens, on_token=None):
    """Submit ``prompt``, park the stream once it streamed ``n_tokens``;
    returns (delivered tokens, handle)."""
    from mxnet_tpu_torch.serving import StreamMigrated

    fut = srv.submit_async(prompt, on_token=on_token)
    _wait_for(lambda: len(fut.stream_tokens) >= n_tokens, 120,
              "%d tokens before the park" % n_tokens)
    handles = srv.park_streams(1)
    _check(len(handles) == 1, "park_streams parked %d" % len(handles))
    try:
        fut.result(timeout=60)
        _check(False, "a parked stream resolved")
    except StreamMigrated as e:
        _check(e.handle == handles[0], "StreamMigrated carries another "
               "handle")
    return fut.stream_tokens, handles[0]


def _first_token_ms(submit):
    """ms from this call to the first token of ``submit(on_token)``'s
    future, and its result."""
    import threading

    evt = threading.Event()
    t0 = time.perf_counter()
    fut = submit(lambda t: evt.set())
    _check(evt.wait(120), "no continuation token within 120 s")
    dt = (time.perf_counter() - t0) * 1e3
    return dt, fut.result(timeout=120)


def _decode_logits(srv, prompt, fed):
    """On ``srv``'s scheduler thread: prefill ``prompt`` into fresh pages,
    feed ``fed`` through decode one token at a time (the slot bucket the
    stream decodes in), return the logits after the last (np [V]).  With
    ``fed`` empty, the prefill's logits."""
    import types

    import numpy as np

    eng = srv.engine

    def run():
        n = len(prompt) + len(fed)
        need = -(-n // eng.page_size)
        pages = eng.allocator.alloc(need)
        _check(pages is not None, "no pages for the logits check")
        try:
            table = np.zeros(eng.pages_per_seq, np.int64)
            table[:need] = pages
            logits = eng.prefill(np.asarray(prompt), table)
            s = types.SimpleNamespace(table=table, length=len(prompt),
                                      last_token=None)
            for t in fed:
                s.last_token = int(t)
                logits = eng.decode([s])[0]
                s.length += 1
            return logits
        finally:
            eng.allocator.free(pages)

    return srv._run_on_scheduler(run, timeout=120)


def phase_serve_migrate(dev, model):
    """Live KV migration at full width between two servers over one model
    (shared weights, two KV pools): park -> export -> import -> attach at
    256, 1024 and 4000 tokens, against the re-prefill path; a corrupt
    blob; defrag; quiescence after drain."""
    import numpy as np
    from mxnet_tpu_torch import leakcheck

    t_phase = time.perf_counter()
    leakcheck.install("raise")
    max_pages = 2 * ((max(MIGRATE_CONTEXTS) + MIGRATE_NEW) // 16 + 1) + 64
    a = _flagship_server(model, max_pages=max_pages,
                         max_new_tokens=MIGRATE_NEW)
    b = _flagship_server(model, max_pages=max_pages,
                         max_new_tokens=MIGRATE_NEW)
    V = FLAGSHIP["vocab_size"]
    rng = np.random.default_rng(11)
    prompts = {ctx: rng.integers(0, V, ctx) for ctx in MIGRATE_CONTEXTS}
    per_ctx = {}
    win = {}
    with _counted("serve_migrate", win):
        for ctx in MIGRATE_CONTEXTS:
            prompt = prompts[ctx]
            ref = a.submit(prompt, timeout=120)        # the unparked stream
            mig, rep, agree, blob_bytes, legs = [], [], [], [], []
            for _ in range(MIGRATE_REPS):
                delivered, h = _park_after(a, prompt, MIGRATE_PARK_AFTER)
                p0 = b.engine.stats["prefills"]

                def migrate(cb, h=h, delivered=delivered):
                    t0 = time.perf_counter()
                    blob = a.export_stream(h)
                    t1 = time.perf_counter()
                    h2 = b.import_stream(blob)
                    legs.append(((t1 - t0) * 1e3,
                                 (time.perf_counter() - t1) * 1e3))
                    blob_bytes.append(len(blob))
                    return b.submit_async(prompt, resume_from=delivered,
                                          migrate_handle=h2, on_token=cb)

                ms, cont = _first_token_ms(migrate)
                _check(b.engine.stats["prefills"] == p0,
                       "ctx %d: the attach ran a prefill" % ctx)
                _check(delivered + cont == ref,
                       "ctx %d: the migrated stream parted from the "
                       "unparked one" % ctx)
                mig.append(ms)
                ms, cont = _first_token_ms(
                    lambda cb, d=delivered: b.submit_async(
                        prompt, resume_from=d, on_token=cb))
                _check(len(delivered) + len(cont) == MIGRATE_NEW,
                       "ctx %d: the resume path returned %d tokens"
                       % (ctx, len(cont)))
                rep.append(ms)
                tail = ref[len(delivered):]
                n = 0
                while n < len(cont) and cont[n] == tail[n]:
                    n += 1
                agree.append(n)
            per_ctx[ctx] = {"migrate_ms": mig, "reprefill_ms": rep,
                            "migrate_ms_min": min(mig),
                            "reprefill_ms_min": min(rep),
                            "blob_bytes": blob_bytes[-1],
                            "export_ms": [e for e, _ in legs],
                            "import_ms": [i for _, i in legs],
                            "delivered": len(delivered),
                            "reprefill_tokens_agreeing": agree,
                            "continuation_tokens": len(tail)}
    # the resume path's first-token logits against the unmigrated decode's
    for ctx in MIGRATE_CONTEXTS:
        prompt = prompts[ctx]
        delivered = a.submit(prompt, max_new_tokens=MIGRATE_PARK_AFTER,
                             timeout=120)
        dec = _decode_logits(a, prompt, delivered)
        re_ = _decode_logits(b, np.concatenate([prompt, delivered]), [])
        diff = float(np.abs(dec - re_).max())
        per_ctx[ctx]["resume_logits_max_abs_err"] = diff
        per_ctx[ctx]["resume_logits_argmax_equal"] = \
            int(np.argmax(dec)) == int(np.argmax(re_))
        _check(np.isfinite(re_).all() and diff <= LOGITS_ATOL,
               "ctx %d: resume logits differ from decode's by %g (atol %g)"
               % (ctx, diff, LOGITS_ATOL))

    # a corrupt blob is refused and the stream falls back to re-prefill
    prompt = prompts[MIGRATE_CONTEXTS[0]]
    ref = a.submit(prompt, timeout=120)
    delivered, h = _park_after(a, prompt, MIGRATE_PARK_AFTER)
    blob = bytearray(a.export_stream(h))
    blob[len(blob) // 2] ^= 0x01
    used = b.engine.allocator.used
    try:
        b.import_stream(bytes(blob))
        _check(False, "a corrupt blob was imported")
    except ValueError:
        pass
    _check(b.engine.allocator.used == used, "the refused import held pages")
    fallback = b.submit(prompt, resume_from=delivered, timeout=120)
    _check(len(delivered) + len(fallback) == MIGRATE_NEW,
           "the fallback resume did not complete")

    # defrag with holes in the pool: the streams continue bit for bit
    dprompts = [rng.integers(0, V, n) for n in DEFRAG_PROMPTS]
    dnew = (MIGRATE_NEW, 6, MIGRATE_NEW)
    drefs = [a.submit(p, max_new_tokens=n, timeout=120)
             for p, n in zip(dprompts, dnew)]
    futs = [a.submit_async(p, max_new_tokens=n,
                           on_token=lambda t: time.sleep(0.003))
            for p, n in zip(dprompts, dnew)]
    futs[1].result(timeout=120)             # its pages become holes
    _wait_for(lambda: len(futs[2].stream_tokens) >= 10, 120,
              "the defrag streams mid-decode")
    holes = a.engine.allocator.min_free()
    moved = a.defrag()
    douts = [f.result(timeout=120) for f in futs]
    _check(moved >= 1, "defrag moved no stream")
    _check(douts == drefs, "a stream parted from its reference across "
           "defrag")
    _check(a.drain(timeout=60) and b.drain(timeout=60),
           "serve_migrate: drain did not complete")
    _check(a.engine.allocator.used == 0 and b.engine.allocator.used == 0,
           "serve_migrate: pages held after drain")
    leakcheck.assert_quiescent()
    leakcheck.uninstall()
    last = MIGRATE_CONTEXTS[-1]
    rec = {"phase": "serve_migrate", "device": dev["name"],
           "nvidia_smi": dev["smi"], "contexts": per_ctx,
           "migrate_vs_reprefill_ratio_at_%d" % last:
           per_ctx[last]["migrate_ms_min"]
           / per_ctx[last]["reprefill_ms_min"],
           "corrupt_blob_refused": True, "defrag_moved": moved,
           "defrag_lowest_hole": holes, "launch_counts": win["launches"],
           "wall_s": time.perf_counter() - t_phase}
    _emit(rec)
    return [win["launches"]]


def phase_serve_loadreplay(dev, model):
    """bench.py's loadreplay leg at full width: capacity from an
    as-fast-as-possible burst, then a loadgen trace offered at twice that
    for 8 s."""
    from mxnet_tpu_torch import loadgen, profiler, telemetry

    t_phase = time.perf_counter()
    srv = _flagship_server(model, max_queue=LOADREPLAY_QUEUE,
                           max_pages=8 * ((1024 + 64) // 16 + 1) + 16,
                           max_new_tokens=64)
    V = FLAGSHIP["vocab_size"]
    target = loadgen.generation_target(srv, vocab=V)
    cal_spec = loadgen.TraceSpec(
        seed=11, segments=[{"duration_s": 1.0, "rate_rps": 16.0}],
        deadline_classes=[{"name": "cal", "deadline_ms": 60000.0,
                           "weight": 1.0}], **TRACE_LENGTHS)
    cal = loadgen.replay(loadgen.generate_trace(cal_spec), target,
                         speed=float("inf"), name="calibrate")
    n_ok = cal.outcome_counts().get("ok", 0)
    _check(n_ok > 0, "calibration completed nothing: %s"
           % cal.outcome_counts())
    capacity = n_ok / max(cal.wall_s, 1e-6)
    spec = loadgen.TraceSpec(
        seed=12, segments=[{"duration_s": LOADREPLAY_S,
                            "rate_rps": 2.0 * capacity}],
        deadline_classes=TRACE_DEADLINE, **TRACE_LENGTHS)
    trace = loadgen.generate_trace(spec)
    ttft = telemetry.registry().histogram("gen.ttft_ms")
    ttft.reset()
    r0 = profiler.dispatch_value("recompile")
    win = {}
    with _counted("serve_loadreplay", win):
        report = loadgen.replay(trace, target, speed=1.0)
    recompiles = profiler.dispatch_value("recompile") - r0
    counts = report.outcome_counts()
    summary = report.summary()
    hist = ttft.snapshot()
    _check(not any(k.startswith("UNTYPED") for k in counts),
           "serve_loadreplay: untyped outcomes %s" % counts)
    _check(counts.get("ok", 0) >= 1 and counts.get("Overloaded", 0) >= 1,
           "serve_loadreplay: expected ok and Overloaded, got %s" % counts)
    _check(recompiles == 0, "serve_loadreplay: %d recompile(s) in the "
           "window" % recompiles)
    _check(srv.drain(timeout=60), "serve_loadreplay: drain did not complete")
    _check(srv.engine.allocator.used == 0,
           "serve_loadreplay: pages held after drain")
    rec = {"phase": "serve_loadreplay", "device": dev["name"],
           "nvidia_smi": dev["smi"], "capacity_rps": capacity,
           "calibration": cal.outcome_counts(),
           "offered_rps": 2.0 * capacity, "requests": len(trace),
           "outcomes": counts,
           "goodput_per_s": summary["loadreplay_goodput_per_sec"],
           "shed_rate": summary["loadreplay_shed_rate"],
           "knee_rps": loadgen.shed_knee(report.curve()),
           "ttft_ms_p50": hist["p50"], "ttft_ms_p99": hist["p99"],
           "ttft_count": hist["count"], "recompiles": recompiles,
           "summary": summary, "launch_counts": win["launches"],
           "wall_s": time.perf_counter() - t_phase}
    _emit(rec)
    return [win["launches"]]


def phase_serve_tenant(dev, model):
    """bench.py's tenant leg, isolation half, at full width: a gold /
    free / bulk trace replayed clean, then with tenant_flood on three bulk
    requests; bulk's quota (rate 2, burst 2) contains the flood."""
    from mxnet_tpu_torch import chaos, loadgen, serving, tenancy

    t_phase = time.perf_counter()
    srv = _flagship_server(model, max_queue=TENANT_QUEUE,
                           max_pages=8 * ((1024 + 64) // 16 + 1) + 16,
                           max_new_tokens=64)
    spec = loadgen.TraceSpec(
        seed=31, segments=[{"duration_s": TENANT_S,
                            "rate_rps": TENANT_RPS}],
        tenants=TENANTS, deadline_classes=TRACE_DEADLINE, **TRACE_LENGTHS)
    trace = loadgen.generate_trace(spec)
    target = loadgen.generation_target(srv, vocab=FLAGSHIP["vocab_size"])
    bulk_idx = [i for i, r in enumerate(trace) if r["tenant"] == "bulk"]
    steps = bulk_idx[len(bulk_idx) // 2:len(bulk_idx) // 2 + 3]

    def run(chaos_spec):
        tenancy.reset_governor(tenancy.TenantGovernor(quotas={
            "gold": tenancy.TenantSpec("gold", weight=4.0),
            "free": tenancy.TenantSpec("free", weight=2.0),
            "bulk": tenancy.TenantSpec("bulk", rate=2.0, burst=2.0,
                                       weight=1.0)}))
        serving.brownout().reset()
        try:
            if chaos_spec:
                with chaos.inject(chaos_spec) as plan:
                    rep = loadgen.replay(trace, target, speed=TENANT_SPEED,
                                         name="tenant")
                _check(plan.pending() == [], "tenant_flood never fired")
                return rep
            return loadgen.replay(trace, target, speed=TENANT_SPEED,
                                  name="tenant")
        finally:
            tenancy.reset_governor()
            serving.brownout().reset()

    def victim_p99(report):
        ttfts = [r["ttft_ms"] for r in report.records
                 if r["tenant"] in ("gold", "free") and r["outcome"] == "ok"
                 and r["ttft_ms"] is not None]
        return loadgen._pctl(ttfts, 99) if ttfts else None

    win = {}
    with _counted("serve_tenant", win):
        base = run(None)
        flood = run(",".join("tenant_flood@%d" % s for s in steps))
    by = {"clean": base.tenant_summary(), "flood": flood.tenant_summary()}
    for name, t in by.items():
        for victim in ("gold", "free"):
            _check(t.get(victim, {}).get("shed_quota", 0) == 0,
                   "serve_tenant %s: %s got QuotaExceeded" % (name, victim))
            _check(t.get(victim, {}).get("ok", 0) >= 1,
                   "serve_tenant %s: %s completed nothing" % (name, victim))
    bulk = by["flood"].get("bulk", {})
    _check(bulk.get("shed_quota", 0) >= 1,
           "serve_tenant: bulk got no QuotaExceeded")
    for rep in (base, flood):
        _check(not any(k.startswith("UNTYPED")
                       for k in rep.outcome_counts()),
               "serve_tenant: untyped outcomes %s" % rep.outcome_counts())
    p99_base, p99_flood = victim_p99(base), victim_p99(flood)
    _check(srv.drain(timeout=60), "serve_tenant: drain did not complete")
    _check(srv.engine.allocator.used == 0, "serve_tenant: pages held")
    rec = {"phase": "serve_tenant", "device": dev["name"],
           "nvidia_smi": dev["smi"], "requests": len(trace),
           "flood_steps": steps,
           "victim_ttft_p99_ms": {"clean": p99_base, "flood": p99_flood},
           "isolation_ratio": (p99_flood / p99_base
                               if p99_base and p99_flood else None),
           "bulk_flood_shed_rate": bulk.get("shed_quota", 0)
           / max(1, bulk.get("requests", 1)),
           "outcomes": {"clean": base.outcome_counts(),
                        "flood": flood.outcome_counts()},
           "tenants": by, "launch_counts": win["launches"],
           "wall_s": time.perf_counter() - t_phase}
    _emit(rec)
    return [win["launches"]]


def phase_serve_ops(dev, model):
    """Operations at full width: swap_params to a perturbed copy of the
    weights mid-stream (no recompile; afterwards a stream equals a fresh
    server's on the new weights), then the SIGTERM drain."""
    import os
    import signal

    import numpy as np
    import torch
    from mxnet_tpu_torch import TransformerLM, profiler
    from mxnet_tpu_torch.serving import Draining

    t_phase = time.perf_counter()
    srv = _flagship_server(model, max_pages=512, max_new_tokens=32)
    gen = torch.Generator(device=model.device).manual_seed(5)
    new = {k: (p.float() + 0.02 * torch.randn(p.shape, generator=gen,
                                               device=p.device)).to(p.dtype)
           for k, p in srv.engine.params.items()}
    V = FLAGSHIP["vocab_size"]
    rng = np.random.default_rng(12)
    p_mid, p_after = rng.integers(0, V, 256), rng.integers(0, V, 384)
    win = {}
    r0 = profiler.dispatch_value("recompile")
    with _counted("serve_ops", win):
        before = srv.submit(p_after, timeout=120)
        mid = srv.submit_async(p_mid, on_token=lambda t: time.sleep(0.003))
        _wait_for(lambda: len(mid.stream_tokens) >= 8, 120,
                  "the stream the swap lands in")
        srv.swap_params(new)
        n_mid = len(mid.result(timeout=120))
        after = srv.submit(p_after, timeout=120)
    recompiles = profiler.dispatch_value("recompile") - r0
    _check(recompiles == 0, "swap_params: %d recompile(s)" % recompiles)
    _check(n_mid == 32, "the stream across the swap returned %d tokens"
           % n_mid)
    fresh_model = TransformerLM(model.cfg, device=model.device,
                                generator=gen)
    with torch.no_grad():
        for k, p in fresh_model.named_parameters():
            p.copy_(new[k])
    fresh = _flagship_server(fresh_model, max_pages=64, max_new_tokens=32)
    want = fresh.submit(p_after, timeout=120)
    _check(fresh.drain(timeout=60), "the fresh server did not drain")
    del fresh, fresh_model
    _check(after == want, "after swap_params the stream differs from a "
           "fresh server's on the new weights")
    _check(after != before, "swap_params left the stream unchanged")

    # -- the SIGTERM drain: admission closes, admitted streams complete --
    prev = signal.getsignal(signal.SIGTERM)
    handler = srv.install_preemption_drain()
    try:
        futs = [srv.submit_async(rng.integers(0, V, n),
                                 on_token=lambda t: time.sleep(0.002))
                for n in (64, 200, 400)]
        os.kill(os.getpid(), signal.SIGTERM)
        _wait_for(lambda: handler.requested, 30, "the SIGTERM handler")
        try:
            srv.submit_async(rng.integers(0, V, 32))
            rejected = False
        except Draining:
            rejected = True
        drain_outs = _outcomes(futs, timeout=120)
    finally:
        handler.uninstall()
    restored = signal.getsignal(signal.SIGTERM) == prev
    _check(rejected, "a submit after SIGTERM was admitted")
    _check(all(k == "ok" and len(t) == 32 for k, t in drain_outs),
           "in-flight streams did not resolve after SIGTERM: %s"
           % [(k, len(t)) for k, t in drain_outs])
    _check(restored, "the previous SIGTERM handler was not restored")
    _check(srv.drain(timeout=60), "serve_ops: drain did not complete")
    _check(srv.engine.allocator.used == 0, "serve_ops: pages held")
    torch.cuda.empty_cache()
    rec = {"phase": "serve_ops", "device": dev["name"],
           "nvidia_smi": dev["smi"], "swap_recompiles": recompiles,
           "after_swap_equals_fresh_server": True,
           "tokens_changed_by_swap": sum(x != y for x, y in
                                         zip(before, after)),
           "sigterm_submit_rejected": rejected,
           "sigterm_streams_resolved": [len(t) for _, t in drain_outs],
           "handler_restored": restored, "launch_counts": win["launches"],
           "wall_s": time.perf_counter() - t_phase}
    _emit(rec)
    return [win["launches"]]


def _train_cell(name, cfg_kw, B, T, dev):
    """One training configuration: seeded weights, one fixed batch, one
    warm step, then ``TRAIN_STEPS`` timed steps with the counters zeroed
    just before and read just after.  Returns the record and the state the
    later checks and ``--profile`` reuse."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import (TransformerConfig, TransformerLM,
                                 make_train_step)
    from mxnet_tpu_torch.ops.kernels import common

    gen = torch.Generator(device="cuda").manual_seed(0)
    model = TransformerLM(TransformerConfig(**cfg_kw), device="cuda",
                          generator=gen)
    V = cfg_kw["vocab_size"]
    toks = np.random.default_rng(1).integers(0, V, (B, T + 1))
    x = torch.from_numpy(toks[:, :-1].copy()).cuda()
    y = torch.from_numpy(toks[:, 1:].copy()).cuda()
    params = dict(model.named_parameters())
    velocity = {k: torch.zeros_like(p) for k, p in params.items()}
    step = make_train_step(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [float(step(params, velocity, x, y)[2])]          # warm
    warm_s = time.perf_counter() - t0

    # -- the main path: counters zeroed just before, read just after ----
    common.reset_counts()
    step_ms = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = step(params, velocity, x, y)[2]
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    selects = common.selection_counts()
    launches = common.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    per_step = {k.split(".", 2)[2]: v / TRAIN_STEPS
                for k, v in launches.items()}
    rec = {
        "phase": "train", "config": name, "device": dev["name"],
        "nvidia_smi": dev["smi"], "batch": B, "seq": T,
        "params": sum(p.numel() for p in params.values()),
        "remat": cfg_kw["remat"], "losses": losses, "warm_s": warm_s,
        "step_ms": step_ms, "tokens_per_s": [B * T * 1e3 / m
                                             for m in step_ms],
        "peak_mem_gb": peak_gb, "launches_per_step": per_step,
        "selections_per_step": {k: v / TRAIN_STEPS
                                for k, v in selects.items()},
    }
    _emit(rec)
    _check(all(np.isfinite(losses)), "%s: a loss is not finite: %s"
           % (name, losses))
    _check(losses[-1] < losses[0], "%s: the loss did not fall: %s"
           % (name, losses))
    _check(not any(k.endswith(".reference") for k in selects),
           "%s: a plain version ran on the main path: %s" % (name, selects))
    _check(per_step == EXPECTED_LAUNCHES[name],
           "%s: launches per step %s, expected %s"
           % (name, per_step, EXPECTED_LAUNCHES[name]))
    state = {"model": model, "params": params, "velocity": velocity,
             "step": step, "x": x, "y": y}
    return rec, launches, state


def _step_kernels_vs_plain(name, st):
    """The loss and every parameter gradient of one step through the
    kernels against the same step through the plain versions."""
    import torch

    model, x, y = st["model"], st["x"], st["y"]
    loss_k, g_k = model.value_and_grad(None, x, y)
    with _plain_versions():
        loss_p, g_p = model.value_and_grad(None, x, y)
    rel = {n: float((g_k[n].float() - g_p[n].float()).norm()
                    / g_p[n].float().norm().clamp_min(1e-30))
           for n in g_p}
    loss_err = abs(float(loss_k) - float(loss_p))
    finite = all(bool(torch.isfinite(g).all()) for g in g_k.values())
    ok = (finite and loss_err <= STEP_LOSS_ATOL
          and max(rel.values()) <= STEP_GRAD_REL_L2)
    _emit({"phase": "train_step_kernels_vs_plain", "config": name,
           "loss_kernels": float(loss_k), "loss_plain": float(loss_p),
           "loss_abs_err": loss_err, "loss_atol": STEP_LOSS_ATOL,
           "grad_rel_l2": rel, "grad_rel_l2_max": max(rel.values()),
           "grad_rel_l2_tol": STEP_GRAD_REL_L2, "ok": ok})
    _check(ok, "%s: the training step through the kernels differs from the "
           "plain versions (loss err %g, grad rel L2 %g)"
           % (name, loss_err, max(rel.values())))


def phase_train(dev):
    """Every training configuration; the long-context ones carry the
    kernel-vs-plain step check.  Returns the launches of each run and the
    state of each configuration."""
    import torch

    launches, states = {}, {}
    for name, cfg_kw, B, T in TRAIN_CELLS:
        _, launches[name], states[name] = _train_cell(name, cfg_kw, B, T,
                                                      dev)
        if name.startswith("longctx"):
            _step_kernels_vs_plain(name, states[name])
        torch.cuda.empty_cache()
    return launches, states


# ---------------------------------------------------------------------------
# the device mesh: one NCCL rank, then two gloo ranks on the one card
# ---------------------------------------------------------------------------
def _leg_tokens(V, B, T, seed=1):
    import numpy as np

    toks = np.random.default_rng(seed).integers(0, V, (B, T + 1))
    return toks[:, :-1].copy(), toks[:, 1:].copy()


def _leave_group():
    """The end of a rank process: wait for every rank, then close the
    process group (rank 0 hosts the group's store and must not exit
    first)."""
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


def _launch_workers(n, entry, out_dir, timeout, backend=None):
    """``n`` rank processes through the port's launcher, each running
    ``chip_smoke.<entry>(out_dir)``; every process ends within
    ``timeout``."""
    from mxnet_tpu_torch.tools.launch import launch_local

    return launch_local(
        n, [sys.executable, "-c",
            "import sys, chip_smoke; chip_smoke.%s(sys.argv[1])" % entry,
            out_dir], backend=backend, timeout=timeout)


def mesh_nccl_worker(out_dir):
    """The one rank of mesh_nccl (NCCL, world size 1): the flagship step
    through the mesh and rules against the meshless step, then a
    ``dist_sync`` KVStore round."""
    import os

    import numpy as np
    import torch
    import torch.distributed as dist

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _dist
    from mxnet_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM, default_rules, make_train_step,
        params_from_numpy)
    from mxnet_tpu_torch.ops.kernels import common
    from mxnet_tpu_torch.parallel import make_mesh
    from mxnet_tpu_torch.parallel.sharding import (auto_shard, local_tensor,
                                                   zeros_like)
    from mxnet_tpu_torch.tools import dryrun

    _check(dist.get_backend() == "nccl" and _dist.world_size() == 1,
           "mesh_nccl: backend %s, world %d" % (dist.get_backend(),
                                                _dist.world_size()))
    dev = _dist.device()
    model = TransformerLM(TransformerConfig(**FLAGSHIP_TRAIN), device=dev)
    np_params = dryrun.numpy_params(model, 0)
    x, y = (torch.from_numpy(a).to(dev) for a in
            _leg_tokens(FLAGSHIP_TRAIN["vocab_size"], 8, 1024))
    ref_p = params_from_numpy(np_params, dev, model.dtype)
    ref_v = {k: torch.zeros_like(p) for k, p in ref_p.items()}
    ref_loss = float(make_train_step(model)(ref_p, ref_v, x, y)[2])
    rules = default_rules()
    with make_mesh(dp=1) as mesh:
        params = auto_shard(params_from_numpy(np_params, dev, model.dtype),
                            rules, mesh)
        velocity = {k: zeros_like(v) for k, v in params.items()}
        step = make_train_step(model, rules=rules)
        losses, step_ms, launches, peaks = [], [], [], []
        for _ in range(2):
            common.reset_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss = step(params, velocity, x, y)[2]
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            peaks.append(torch.cuda.max_memory_allocated())
            losses.append(float(loss))
            launches.append(common.launch_counts())
            if len(losses) == 1:
                selects = common.selection_counts()
                rel = {k: dryrun.rel_to_max(local_tensor(params[k]),
                                            ref_p[k])
                       for k in ref_p}
                equal = sum(bool(torch.equal(local_tensor(params[k]),
                                             ref_p[k])) for k in ref_p)
    # a dist_sync KVStore round over the same communicator
    kv = mx.kv.create("dist_sync")
    g = np.random.default_rng(3).standard_normal((4096, 256), np.float32)
    kv.init("w", mx.nd.zeros(g.shape, ctx=mx.gpu(0)))
    kv.push("w", mx.nd.array(g, ctx=mx.gpu(0)))
    out = mx.nd.zeros(g.shape, ctx=mx.gpu(0))
    kv.pull("w", out=out)
    rec = {"ref_loss": ref_loss, "losses": losses,
           "loss_rel_err": abs(losses[0] - ref_loss) / abs(ref_loss),
           "param_rel_to_max": max(rel.values()),
           "params_bitwise_equal": equal, "params": len(ref_p),
           "step_ms": step_ms, "peak_bytes": peaks, "launches": launches,
           "selects": selects,
           "kv_round_exact": bool(np.array_equal(out.asnumpy(), g)),
           "backend": dist.get_backend(), "world": _dist.world_size()}
    with open(os.path.join(out_dir, "mesh_nccl.json"), "w") as f:
        json.dump(rec, f)
    _leave_group()


def phase_mesh_nccl(dev):
    """The sharded flagship step at world size 1 over NCCL, in a child
    process, against the meshless step; a dist_sync KVStore round."""
    import os
    import tempfile

    import torch

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out_dir = tempfile.mkdtemp(prefix="mesh_nccl_")
    codes = _launch_workers(1, "mesh_nccl_worker", out_dir, MESH_TIMEOUT_S)
    _check(codes == [0], "mesh_nccl: the rank exited %s" % codes)
    with open(os.path.join(out_dir, "mesh_nccl.json")) as f:
        rec = json.load(f)
    want = {k: 2 * v for k, v in EXPECTED_LAUNCHES["flagship_b8_t1024"]
            .items()}
    launched = {}
    for run in rec["launches"]:
        for k, v in run.items():
            launched[k] = launched.get(k, 0) + v
    per_step = {k.split(".", 2)[2]: v for k, v in launched.items()}
    rec.update({"phase": "mesh_nccl", "device": dev["name"],
                "nvidia_smi": dev["smi"], "loss_rel_tol": MESH_LOSS_REL,
                "wall_s": time.perf_counter() - t0})
    _emit(rec)
    _check(rec["loss_rel_err"] <= MESH_LOSS_REL,
           "mesh_nccl: loss %r against the meshless %r"
           % (rec["losses"][0], rec["ref_loss"]))
    _check(rec["params_bitwise_equal"] == rec["params"],
           "mesh_nccl: %d of %d parameters after the step differ from the "
           "meshless step's (by up to %g of the largest entry)"
           % (rec["params"] - rec["params_bitwise_equal"], rec["params"],
              rec["param_rel_to_max"]))
    _check(rec["kv_round_exact"], "mesh_nccl: the dist_sync round differs")
    _check(not any(k.endswith(".reference") for k in rec["selects"]),
           "mesh_nccl: a plain version ran: %s" % rec["selects"])
    _check(per_step == want, "mesh_nccl: launches over two steps %s, "
           "expected %s" % (per_step, want))
    return launched


def _ring_leg(dev):
    """The kernel form of ring attention split over sp = every rank
    against the one-card flash kernel on the whole sequence."""
    import numpy as np
    import torch

    from mxnet_tpu_torch import _dist
    from mxnet_tpu_torch.ops.kernels import common
    from mxnet_tpu_torch.ops.kernels.flash_attention import flash_attention
    from mxnet_tpu_torch.parallel import collectives as C
    from mxnet_tpu_torch.parallel import make_mesh, ring_attention
    from mxnet_tpu_torch.tools.dryrun import rel_to_max

    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(RING_SHAPE, np.float32))
               .to(dev, torch.bfloat16).requires_grad_(True)
               for _ in range(3))
    w = torch.from_numpy(rng.standard_normal(RING_SHAPE, np.float32)).to(dev)
    o_ref = flash_attention(q, k, v, causal=True)
    g_ref = torch.autograd.grad((o_ref.float() * w).sum(), (q, k, v))
    n = _dist.world_size()
    with make_mesh(sp=n) as mesh:
        T = RING_SHAPE[1] // n
        sl = slice(mesh.index("sp") * T, (mesh.index("sp") + 1) * T)
        lq, lk, lv = (t.detach()[:, sl].clone().requires_grad_(True)
                      for t in (q, k, v))
        C.reset_host_staged()
        common.reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        o = ring_attention(lq, lk, lv, "sp", causal=True, use_pallas=True)
        g = torch.autograd.grad((o.float() * w[:, sl]).sum(), (lq, lk, lv))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = common.launch_counts()
        selects = common.selection_counts()
    rel = {n: rel_to_max(a.detach(), b.detach()[:, sl])
           for n, a, b in zip("oqkv", (o,) + g, (o_ref,) + g_ref)}
    return {"leg": "ring_kernel_sp%d" % n, "shape": list(RING_SHAPE),
            "o_max_abs_err": float((o.detach().float()
                                    - o_ref.detach()[:, sl].float())
                                   .abs().max()),
            "rel_to_max": rel,
            "grad_max_abs_err": {n: float((a.float() - b[:, sl].float())
                                          .abs().max())
                                 for n, a, b in zip("qkv", g, g_ref)},
            "ok": max(rel.values()) <= RING_REL, "ms": ms,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "host_staged": C.host_staged_counts(), "launches": launches,
            "selects": selects}


def _collectives_leg(dev):
    """Each collective of ``parallel.collectives`` on CUDA tensors over
    every rank against its exact result, and which of them the backend
    took on the card (gloo's others are copied through host memory,
    counted)."""
    import torch

    from mxnet_tpu_torch import _dist
    from mxnet_tpu_torch.parallel import collectives as C
    from mxnet_tpu_torch.parallel import make_mesh

    n = _dist.world_size()
    xs = [torch.arange(8.0) + 10 * s for s in range(n)]
    total = sum(xs)
    with make_mesh(tp=n):
        r = C.axis_index("tp")
        x = xs[r].to(dev)
        c = 8 // n
        want = {
            "allreduce": total, "allreduce_bf16": total,
            "allgather": torch.cat(xs),
            "reduce_scatter": total[c * r:c * (r + 1)],
            "ppermute": xs[(r - 1) % n],
            "all_to_all": torch.cat([xs[s][c * r:c * (r + 1)]
                                     for s in range(n)]),
            "broadcast": xs[n - 1],
        }
        C.reset_host_staged()
        got = {
            "allreduce": C.allreduce(x, "tp"),
            "allreduce_bf16": C.allreduce(x.to(torch.bfloat16), "tp"),
            "allgather": C.allgather(x, "tp"),
            "reduce_scatter": C.reduce_scatter(x, "tp"),
            "ppermute": C.ppermute_shift(x, "tp", 1),
            "all_to_all": C.all_to_all(x.view(n, c), "tp", 0, 1).view(-1),
            "broadcast": C.broadcast(x, "tp", src=n - 1),
        }
        exact = {k: bool(torch.equal(got[k].float().cpu(), want[k]))
                 for k in want}
        staged = C.host_staged_counts()
    return {"leg": "collectives", "exact": exact, "host_staged": staged,
            "ok": all(exact.values()), "launches": {}, "selects": {}}


def mesh_legs(out_dir, legs, pp_stages):
    """This rank's part of the multi-rank legs (the multirank phase's and
    mesh_probe.py's): the collectives check; each train leg of ``legs``
    after its single-rank step on this rank; the flagship's first
    ``pp_stages`` blocks as a pipeline against its sequential stages; the
    kernel ring.  Writes ``rank<r>.json``: each leg's record and its
    counters."""
    import os

    import torch

    import mxnet_tpu_torch  # noqa: F401  (joins the launcher's group)
    from mxnet_tpu_torch import _dist
    from mxnet_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM, default_rules)
    from mxnet_tpu_torch.ops.kernels import common
    from mxnet_tpu_torch.tools import dryrun

    dev = _dist.device()
    recs = [_collectives_leg(dev)]

    def finish(rec, t0):
        rec.update(launches=common.launch_counts(),
                   selects=common.selection_counts(),
                   wall_s=time.perf_counter() - t0)
        recs.append(rec)
        torch.cuda.empty_cache()

    for leg, cfg, B, T, axes, rules, _ in legs:
        t0 = time.perf_counter()
        model = TransformerLM(TransformerConfig(**cfg), device=dev)
        np_params = dryrun.numpy_params(model, 0)
        x, y = _leg_tokens(cfg["vocab_size"], B, T)
        ref = dryrun.single_step(model, np_params, x, y, lr=1e-2, steps=2,
                                 grads=True)
        torch.cuda.empty_cache()
        common.reset_counts()
        rec = dryrun.train_leg(leg, model, np_params, x, y, axes,
                               rules=default_rules() if rules else None,
                               lr=1e-2, ref=ref["loss"], steps=2,
                               zero_factor=axes.get("fsdp") if rules
                               else None, ref_losses=ref["losses"],
                               ref_grads=ref["grads"],
                               grad_rel=MULTIRANK_GRAD_REL)
        rec["ref_ms"] = ref["ms"]
        del model, np_params, ref
        finish(rec, t0)
    t0 = time.perf_counter()
    ppm = TransformerLM(TransformerConfig(**dict(
        FLAGSHIP_TRAIN, n_layers=pp_stages)), device=dev)
    np_params = dryrun.numpy_params(ppm, 0)
    x, y = _leg_tokens(FLAGSHIP_TRAIN["vocab_size"], PP_MICROBATCHES * PP_MB,
                       1024)
    rec = dryrun.pp_leg(ppm, np_params, x, y, PP_MICROBATCHES, PP_MB,
                        {"pp": pp_stages}, grad_rel=PP_GRAD_REL)
    rec["leg"] = "pp%d_flagship" % pp_stages
    del ppm, np_params
    finish(rec, t0)
    t0 = time.perf_counter()
    recs.append(dict(_ring_leg(dev), wall_s=time.perf_counter() - t0))
    with open(os.path.join(out_dir, "rank%d.json" % _dist.rank()), "w") as f:
        json.dump(recs, f)
    _leave_group()


def multirank_worker(out_dir):
    """One of the two gloo ranks of the multirank phase."""
    mesh_legs(out_dir, MULTIRANK_LEGS, 2)


def read_mesh_legs(out_dir, n, legs, dev, note=None):
    """Every rank's records of :func:`mesh_legs`: one line a leg (each key
    a list over the ranks; ``note`` beside), gated: each result as
    expected, the kernels a leg reaches launched on every rank, no plain
    version.  Returns each rank's launches of each leg."""
    import os

    ranks = []
    for r in range(n):
        with open(os.path.join(out_dir, "rank%d.json" % r)) as f:
            ranks.append(json.load(f))
    reaches = {leg: kern for leg, *_, kern in legs}
    reaches["collectives"] = ()
    runs = []
    for i, rec0 in enumerate(ranks[0]):
        per_rank = [rk[i] for rk in ranks]
        leg = rec0["leg"]
        kern = reaches.get(leg, _FLASH_KERNELS if leg.startswith("ring")
                           else _DENSE_KERNELS)
        out = {"phase": "multirank", "leg": leg, "ranks": n,
               "device": dev["name"], "nvidia_smi": dev["smi"],
               **({"note": note} if note else {})}
        for key in ("axes", "losses", "ref_loss", "ref_losses", "ref_ms",
                    "loss_diff", "loss_diffs", "ms", "peak_bytes",
                    "host_staged", "zero", "wall_s", "grad_max_abs_err",
                    "grad_max_rel_to_max", "grad_rel_to_max", "grad_rel_tol",
                    "o_max_abs_err", "rel_to_max", "ok", "shape",
                    "exact"):
            if key in rec0:
                out[key] = [p.get(key) for p in per_rank]
        out["launches"] = [{k.split(".", 2)[2]: v for k, v in
                            p["launches"].items()} for p in per_rank]
        _emit(out)
        for p in per_rank:
            _check(p.get("ok", True), "%s: a result is not the expected "
                   "one: %s" % (leg, {k: p.get(k) for k in (
                       "rel_to_max", "exact")}))
            _check(not any(k.endswith(".reference") for k in p["selects"]),
                   "%s: a plain version ran: %s" % (leg, p["selects"]))
            for k in kern:
                _check(p["launches"].get("kernels.launch." + k, 0) > 0,
                       "%s: %s never launched: %s"
                       % (leg, k, p["launches"]))
            runs.append(p["launches"])
    return runs


def phase_multirank(dev, gen):
    """Two rank processes on the one card over gloo: the collectives check
    and the multi-rank legs (tp, fsdp with the ZeRO check, ep with MoE,
    pp, sp with the ring, tp on the long-context configuration, the
    kernel ring), each against the single-rank step (:func:`mesh_legs`);
    then flash at the tp=2 local shape against its plain version and
    SDPA.  Two ranks share one card's SMs and copy through host memory
    over gloo: their times are not scaling figures.  Returns each rank's
    launches of each leg."""
    import tempfile

    import torch

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out_dir = tempfile.mkdtemp(prefix="multirank_")
    codes = _launch_workers(2, "multirank_worker", out_dir,
                            MULTIRANK_TIMEOUT_S, backend="gloo")
    _check(codes == [0, 0], "multirank: the ranks exited %s" % codes)
    runs = read_mesh_legs(out_dir, 2, MULTIRANK_LEGS, dev, note=(
        "two ranks share one card's SMs and copy through host memory over "
        "gloo: not a scaling figure"))
    flash = _flash_case(1, 8192, 8192, 8, 64, True, "bfloat16", gen)
    _emit({"phase": "multirank_flash_local_shape",
           "q": flash["q"], "ms": flash["ms"], "bound_ms": flash["bound_ms"],
           "library_ms": flash["library_ms"], "plain_ms": flash["plain_ms"],
           "wall_s": time.perf_counter() - t0})
    return runs

def _xavier_params(sym, ctx, seed=0):
    """Seeded weights for ``sym``: Xavier-uniform convolution and FC
    weights (magnitude 3, fan average: MXNet's ``Xavier()``), zero biases,
    BatchNorm gamma 1, beta 0, moving mean 0, moving var 1."""
    import numpy as np
    from mxnet_tpu_torch.model import params_from_numpy

    arg_shapes, _, aux_shapes = sym.infer_shape(
        data=(1,) + tuple(int(x) for x in
                          INT8_NET["image_shape"].split(",")))
    rng = np.random.default_rng(seed)
    args, auxs = {}, {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("_weight"):
            rf = int(np.prod(shape[2:]))
            scale = np.sqrt(3.0 / ((shape[1] * rf + shape[0] * rf) / 2.0))
            args[name] = rng.uniform(-scale, scale, shape).astype(np.float32)
        elif name.endswith("_gamma"):
            args[name] = np.ones(shape, np.float32)
        else:                                        # beta, bias
            args[name] = np.zeros(shape, np.float32)
    for name, shape in zip(sym.list_auxiliary_states(), aux_shapes):
        fill = np.ones if name.endswith("_var") else np.zeros
        auxs[name] = fill(shape, np.float32)
    return params_from_numpy(args, auxs, ctx=ctx)


def _timed_forwards(exe, n):
    """``n`` forwards, each timed on the host clock and ending in a
    synchronize.  Returns the ms and the last outputs."""
    import torch

    ms = []
    for _ in range(n):
        t0 = time.perf_counter()
        outs = exe.forward(is_train=False)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms, outs


def phase_int8(dev, bf16_img_s=None):
    """The INT8 path on the symbolic ResNet-50.  Returns the launches of
    its two counted runs (the timed int8 forwards, the quantized_dense
    call) and the fp32 and int8 executors, for ``--profile``.
    ``bf16_img_s`` is gluon_infer's per-call img/s of the bf16 Gluon
    ResNet-50 at the same batch: the record's ``int8_vs_bf16`` is the
    median timed int8 forward's img/s over it (bench.py:582-584)."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.contrib.quantization import quantize_model
    from mxnet_tpu_torch.models.resnet_symbol import get_symbol
    from mxnet_tpu_torch.ops.kernels import common

    ctx = mx.gpu(0)
    net = get_symbol(**INT8_NET)
    args, auxs = _xavier_params(net, ctx)
    rng = np.random.default_rng(2)
    shape = (INT8_BATCH,) + tuple(int(x) for x in
                                  INT8_NET["image_shape"].split(","))
    x = rng.random(shape, dtype=np.float32)
    calib_x = rng.random((INT8_CALIB,) + shape[1:], dtype=np.float32)
    label = mx.nd.zeros((INT8_BATCH,), ctx=ctx)

    # -- the fp32 graph, the reference of the int8 one -------------------
    # each graph is bound with its classifier's logits as a second output
    # (fc1, and fc1_dequantize in the int8 graph): with random weights the
    # 1000-way softmax is nearly flat, so int8 and fp32 are compared on the
    # logits, whose cosine does not saturate
    torch.cuda.reset_peak_memory_stats()
    exe = mx.sym.Group([net, net.get_internals()["fc1_output"]]).simple_bind(
        ctx=ctx, grad_req="null", data=shape)
    exe.copy_params_from(args, auxs)
    exe.forward(is_train=False, data=mx.nd.array(x, ctx=ctx))    # warm
    torch.cuda.synchronize()
    fp32_ms, outs = _timed_forwards(exe, INT8_TIMED)
    want, want_logits = (o.asnumpy() for o in outs)
    fp32_peak = torch.cuda.max_memory_allocated() / 1e9
    del outs

    # -- quantize: calibrate, fold, rewrite, fuse -------------------------
    t0 = time.perf_counter()
    calib = mx.io.NDArrayIter(calib_x, np.zeros(INT8_CALIB),
                              INT8_CALIB_BATCH)
    qsym, qargs, qauxs = quantize_model(
        net, args, auxs, ctx=ctx, calib_mode="naive", calib_data=calib,
        num_calib_examples=INT8_CALIB, fold_bn=True, fuse_int8=True)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    ops = {}
    for n in qsym._topo():
        if not n.is_var:
            ops[n.op.name] = ops.get(n.op.name, 0) + 1
    _check(ops == INT8_OPS, "int8 op counts %s differ from the JAX "
           "package's %s" % (ops, INT8_OPS))

    # -- the main path: the timed int8 forwards ---------------------------
    qgraph = mx.sym.Group([qsym,
                           qsym.get_internals()["fc1_dequantize_output"]])
    qexe = qgraph.bind(ctx=ctx, args=dict(qargs,
                                          data=mx.nd.array(x, ctx=ctx),
                                          softmax_label=label),
                       aux_states=qauxs, grad_req="null")
    qexe.forward(is_train=False)                   # warm, uncounted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    common.reset_counts()
    int8_ms, outs = _timed_forwards(qexe, INT8_TIMED)
    selects = common.selection_counts()
    fwd_launches = common.launch_counts()
    int8_peak = torch.cuda.max_memory_allocated() / 1e9
    got, logits = (o.asnumpy() for o in outs)
    # the classifier's plan: with a split of K, the kernel that adds the
    # splits launches beside each wgmma launch
    from mxnet_tpu_torch.ops.kernels.int8_matmul import plan_int8_matmul
    fc1_plan = plan_int8_matmul(
        INT8_BATCH, INT8_NET["num_classes"], 2048,
        torch.cuda.get_device_properties(0).multi_processor_count)
    want_launches = {"kernels.launch.int8_matmul": INT8_TIMED,
                     "kernels.launch.int8_matmul.wgmma": INT8_TIMED}
    if fc1_plan.splits > 1:
        want_launches["kernels.launch.int8_matmul.reduce"] = INT8_TIMED
    _check(fwd_launches == want_launches,
           "int8 forwards launched %s, expected %s: int8_matmul's wgmma "
           "variant once per forward" % (fwd_launches, want_launches))
    _check(not any(k.endswith(".reference") for k in selects),
           "a plain version ran on the int8 path: %s" % selects)
    with _plain_versions():
        plain = [o.asnumpy() for o in qexe.forward(is_train=False)]

    def cosine(a, b):
        a, b = a.astype(np.float64).ravel(), b.astype(np.float64).ravel()
        return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))

    cos = cosine(logits, want_logits)
    top1 = float((logits.argmax(1) == want_logits.argmax(1)).mean())
    same_as_plain = bool(np.array_equal(got, plain[0])
                         and np.array_equal(logits, plain[1]))

    # -- quantized_dense on the classifier's int8 inputs ------------------
    qi = qsym.get_internals()
    fc_in = mx.sym.Group([qi["fc1_data_quantize_output%d" % i]
                          for i in range(3)])
    q, qmin, qmax = fc_in.bind(ctx=ctx, args=qexe.arg_dict,
                               aux_states=qexe.aux_dict,
                               grad_req="null").forward()
    w, wmin, wmax = (qargs[k] for k in ("fc1_weight_quantize", "fc1_wmin",
                                        "fc1_wmax"))
    nh = INT8_NET["num_classes"]
    common.reset_counts()
    dense = mx.nd.contrib.quantized_dense(q, w, qmin, qmax, wmin, wmax,
                                          num_hidden=nh, no_bias=True)
    torch.cuda.synchronize()
    dense_launches = common.launch_counts()
    fc, fmn, fmx = mx.nd.contrib.quantized_fully_connected(
        q, w, qmin, qmax, wmin, wmax, num_hidden=nh, no_bias=True)
    oracle = mx.nd.contrib.dequantize(fc, fmn, fmx).asnumpy()
    dense = dense.asnumpy()
    dense_err = float(np.abs(dense - oracle).max())
    dense_ok = bool((np.abs(dense - oracle)
                     <= DENSE_RTOL * np.abs(oracle)).all())

    rec = {
        "phase": "int8", "device": dev["name"], "nvidia_smi": dev["smi"],
        "net": INT8_NET, "batch": INT8_BATCH,
        "fp32_ms": fp32_ms,
        "fp32_img_per_s": [INT8_BATCH * 1e3 / m for m in fp32_ms],
        "fp32_peak_mem_gb": fp32_peak,
        "quantize_model_s": quantize_s, "calib_images": INT8_CALIB,
        "int8_ms": int8_ms,
        "int8_img_per_s": [INT8_BATCH * 1e3 / m for m in int8_ms],
        "int8_peak_mem_gb": int8_peak, "op_counts": ops,
        "logits_cosine_int8_vs_fp32": cos, "min_cosine": INT8_MIN_COSINE,
        "softmax_cosine_int8_vs_fp32": cosine(got, want),
        "logits_std_fp32": float(want_logits.std()),
        "top1_agreement": top1, "kernels_equal_plain_bitwise":
        same_as_plain, "forward_launches": fwd_launches,
        "forward_selections": selects,
        "quantized_dense_launches": dense_launches,
        "quantized_dense_max_abs_err_vs_oracle": dense_err,
        "quantized_dense_rtol": DENSE_RTOL,
    }
    if bf16_img_s:
        rec["int8_vs_bf16"] = (statistics.median(rec["int8_img_per_s"])
                               / bf16_img_s)
        rec["int8_vs_bf16_basis"] = (
            "median img/s of the timed int8 forwards (each ending in a "
            "synchronize) over gluon_infer's per-call bf16 img/s "
            "(percall_throughput: chained calls ending in a host fetch); "
            "both per-dispatch timings")
    _emit(rec)
    _check(np.isfinite(got).all() and got.shape == (INT8_BATCH, nh),
           "int8 outputs: shape %s, finite %s" % (got.shape,
                                                  np.isfinite(got).all()))
    _check(cos > INT8_MIN_COSINE, "int8 vs fp32 logits cosine %g <= %g"
           % (cos, INT8_MIN_COSINE))
    _check(same_as_plain, "the int8 forward through the kernels differs "
           "from the one through the plain versions")
    want_dense = {k.replace("int8_matmul", "int8_matmul_dequant"): 1
                  for k in want_launches}
    _check(dense_launches == want_dense,
           "quantized_dense launched %s, expected %s: the dequant form's "
           "wgmma variant once" % (dense_launches, want_dense))
    _check(dense_ok, "quantized_dense differs from dequantize("
           "quantized_fully_connected) by %g" % dense_err)
    return [fwd_launches, dense_launches], {"fp32": exe, "int8": qexe}


def _vgg16_int8_net(mx, ctx):
    """bench.py's ``_build_int8_net("vgg16")`` on the card: the seeded
    Xavier ``vgg16(classes=1000)``, hybridized, exported, read back with
    ``load_checkpoint``, quantized (naive calibration, fold_bn, fuse_int8),
    saved with ``save_checkpoint`` and imported with
    ``SymbolBlock.imports``, in a temporary directory.  Returns the int8
    SymbolBlock, its symbol, the batch and the export gate's numbers (the
    Gluon net's and the exported fp32 SymbolBlock's logits on
    ``VGG_EXPORT_BATCH`` of its images)."""
    import tempfile

    import numpy as np
    import torch
    from mxnet_tpu_torch.contrib.quantization import quantize_model
    from mxnet_tpu_torch.gluon import SymbolBlock
    from mxnet_tpu_torch.gluon.model_zoo import vision

    rng = np.random.RandomState(0)
    net = vision.vgg16(classes=1000)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    net.hybridize()
    x32 = mx.nd.array(rng.rand(VGG_BATCH, 3, VGG_SIZE, VGG_SIZE)
                      .astype(np.float32), ctx=ctx)
    with mx.autograd.pause():
        net(x32[0:1])                   # deferred init only
    xs = x32[0:VGG_EXPORT_BATCH]
    with tempfile.TemporaryDirectory() as d:
        prefix = os.path.join(d, "m")
        net.export(prefix, 0)
        fp32 = SymbolBlock.imports(prefix + "-symbol.json", ["data"],
                                   prefix + "-0000.params", ctx=ctx)
        with mx.autograd.pause():
            gluon_logits = net(xs).asnumpy()
            export_logits = fp32(xs).asnumpy()
        del fp32, net
        sym, args, auxs = mx.model.load_checkpoint(prefix, 0)
        calib = mx.io.NDArrayIter(
            rng.rand(VGG_CALIB, 3, VGG_SIZE, VGG_SIZE).astype(np.float32),
            np.zeros((VGG_CALIB,)), max(1, VGG_CALIB // 2))
        t0 = time.perf_counter()
        qsym, qargs, qauxs = quantize_model(
            sym, args, auxs, ctx=ctx, calib_mode="naive", calib_data=calib,
            num_calib_examples=VGG_CALIB, fold_bn=True, fuse_int8=True)
        torch.cuda.synchronize()
        quantize_s = time.perf_counter() - t0
        mx.model.save_checkpoint(os.path.join(d, "q"), 0, qsym, qargs,
                                 qauxs)
        del sym, args, auxs, qargs, qauxs
        qnet = SymbolBlock.imports(os.path.join(d, "q-symbol.json"),
                                   ["data"], os.path.join(d, "q-0000.params"),
                                   ctx=ctx)
    torch.cuda.empty_cache()
    return qnet, qsym, x32, gluon_logits, export_logits, quantize_s


def _int8_divergence(mx, qnet, qsym, x):
    """Where the int8 graph through the kernels leaves the one through the
    plain versions: each quantized_fully_connected node's largest int32
    difference (the only ops whose route the plain versions change)."""
    from mxnet_tpu_torch.gluon import SymbolBlock

    fcs = [n.name for n in qsym._topo() if not n.is_var
           and n.op.name == "_contrib_quantized_fully_connected"]
    inner = qsym.get_internals()
    probe = SymbolBlock(mx.sym.Group([inner[n + "_output0"] for n in fcs]),
                        [mx.sym.var("data")], params=qnet.collect_params())
    with mx.autograd.pause():
        got = [o.asnumpy() for o in probe(x)]
        with _plain_versions():
            want = [o.asnumpy() for o in probe(x)]
    return {n: int(abs(g.astype("int64") - w).max())
            for n, g, w in zip(fcs, got, want)}


def phase_int8_vgg16(dev):
    """bench.py's interleaved bf16 vs int8 VGG16 pair (int8_bench ->
    _int8_vs_bf16_pair) at its settings.  Gates: the exported fp32
    SymbolBlock's logits are the Gluon net's; the int8 SymbolBlock's
    outputs through the kernels are those through the plain versions, bit
    for bit; one forward launches the int8 matmul once per classifier
    layer, as plan_int8_matmul names the variant (and split-K's adding
    kernel), with no plain version; the pair's draws launched it as many
    times a forward.  Returns the counted runs' launches and the two nets,
    for ``--profile``."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.benchmark import (_summarize, compiled_loop,
                                           graph_replays)
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.ops.kernels import common
    from mxnet_tpu_torch.ops.kernels.int8_matmul import plan_int8_matmul

    ctx = mx.gpu(0)
    qnet, qsym, x32, gluon_logits, export_logits, quantize_s = \
        _vgg16_int8_net(mx, ctx)
    export_err = float(np.abs(export_logits - gluon_logits).max())
    export_scale = float(np.abs(gluon_logits).max())
    ops = {}
    for n in qsym._topo():
        if not n.is_var:
            ops[n.op.name] = ops.get(n.op.name, 0) + 1

    # one forward through the kernels, counted, and through the plain
    # versions
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    want = {}
    for K, N in VGG_FC:
        plan = plan_int8_matmul(VGG_BATCH, N, K, sms)
        keys = ["int8_matmul", "int8_matmul." + plan.variant]
        if plan.variant == "wgmma" and plan.splits > 1:
            keys.append("int8_matmul.reduce")
        for k in keys:
            want["kernels.launch." + k] = want.get("kernels.launch." + k,
                                                   0) + 1
    with mx.autograd.pause():
        qnet(x32)                                  # warm, uncounted
        torch.cuda.synchronize()
        common.reset_counts()
        logits = qnet(x32).asnumpy()
        fwd_launches = common.launch_counts()
        fwd_selects = common.selection_counts()
        with _plain_versions():
            plain = qnet(x32).asnumpy()
    same_as_plain = bool(np.array_equal(logits, plain))
    divergence = None if same_as_plain else \
        _int8_divergence(mx, qnet, qsym, x32)

    # the bf16 side: the same seeded batch, the net cast after its
    # deferred init in f32
    rng = np.random.RandomState(0)
    net16 = vision.vgg16(classes=1000)
    net16.initialize(mx.init.Xavier(), ctx=ctx)
    x_host = rng.rand(VGG_BATCH, 3, VGG_SIZE, VGG_SIZE).astype(np.float32)
    with mx.autograd.pause():
        net16(mx.nd.array(x_host[0:1], ctx=ctx))
    net16.cast("bfloat16")
    net16.hybridize()
    x16 = mx.nd.array(x_host, ctx=ctx).astype("bfloat16")
    del x_host

    # the main path: the interleaved draws (one CUDA graph of VGG_STEPS
    # chained forwards a loop, replayed once a draw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    common.reset_counts()
    replays0 = graph_replays()
    t0 = time.perf_counter()
    # interleaved_throughput's draws, A, B, A, B, kept whole for the spread
    pairs = [(net16, x16), (qnet, x32)]
    loops = [compiled_loop(net, x, VGG_STEPS) for net, x in pairs]
    times = [[], []]
    for _ in range(VGG_REPS):
        for t, loop in zip(times, loops):
            t.append(loop.draw())
    bf16, int8 = [_summarize(t, x.shape[0] * VGG_STEPS)
                  for t, (_, x) in zip(times, pairs)]
    pair_s = time.perf_counter() - t0
    pair_launches = common.launch_counts()
    pair_selects = common.selection_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_fwd = pair_launches.get("kernels.launch.int8_matmul", 0) // len(VGG_FC)
    ratio = int8["median"] / bf16["median"]
    rec = {
        "phase": "int8_vgg16", "device": dev["name"],
        "nvidia_smi": dev["smi"], "batch": VGG_BATCH, "size": VGG_SIZE,
        "calib_images": VGG_CALIB, "steps": VGG_STEPS, "reps": VGG_REPS,
        "quantize_model_s": quantize_s, "op_counts": ops,
        "int8_vgg16_img_per_sec": int8["median"],
        "int8_vgg16_img_per_sec_spread": [int8["min"], int8["max"]],
        "int8_vgg16_bf16_img_per_sec": bf16["median"],
        "int8_vgg16_bf16_img_per_sec_spread": [bf16["min"], bf16["max"]],
        "int8_vgg16_vs_bf16": ratio,
        "int8_vgg16_vs_bf16_spread": [int8["min"] / bf16["max"],
                                      int8["max"] / bf16["min"]],
        "int8_ms_a_batch": 1e3 * VGG_BATCH / int8["median"],
        "bf16_ms_a_batch": 1e3 * VGG_BATCH / bf16["median"],
        "pair_s": pair_s, "graph_replays": graph_replays() - replays0,
        "peak_mem_gb": peak_gb,
        "export_max_abs_err": export_err, "export_logit_scale": export_scale,
        "export_bitwise": bool(np.array_equal(export_logits, gluon_logits)),
        "export_rel_tol": VGG_EXPORT_REL,
        "kernels_equal_plain_bitwise": same_as_plain,
        "divergence_by_fc": divergence,
        "forward_launches": fwd_launches, "expected_launches": want,
        "forward_selections": fwd_selects,
        "pair_launches": pair_launches, "pair_forwards": n_fwd,
        "pair_selections": pair_selects,
    }
    _emit(rec)
    _check(export_err <= VGG_EXPORT_REL * export_scale,
           "the exported VGG16 SymbolBlock's logits are %g from the Gluon "
           "net's (largest %g)" % (export_err, export_scale))
    _check(np.isfinite(logits).all() and logits.shape == (VGG_BATCH, 1000),
           "int8 VGG16 logits: shape %s, finite %s"
           % (logits.shape, np.isfinite(logits).all()))
    _check(ops.get("_contrib_quantized_fully_connected") == len(VGG_FC),
           "int8 VGG16: %s quantized_fully_connected nodes, expected %d"
           % (ops.get("_contrib_quantized_fully_connected"), len(VGG_FC)))
    _check(same_as_plain, "the int8 VGG16 through the kernels differs from "
           "the one through the plain versions; largest int32 difference "
           "by layer: %s" % divergence)
    _check(fwd_launches == want, "an int8 VGG16 forward launched %s, "
           "expected %s" % (fwd_launches, want))
    for sel in (fwd_selects, pair_selects):
        _check(not any(k.endswith(".reference") for k in sel),
               "a plain version ran on the int8 VGG16 path: %s" % sel)
    _check(n_fwd >= VGG_STEPS and pair_launches ==
           {k: v * n_fwd for k, v in want.items()},
           "the pair's draws launched %s: not %d forwards of %s"
           % (pair_launches, n_fwd, want))
    return [fwd_launches, pair_launches], {"int8": qnet, "bf16": net16,
                                           "x32": x32, "x16": x16}


def phase_zoo(dev):
    """One fp32 forward of each family in ``ZOO`` on the card against the
    same weights in float64 on the CPU, and its export served through
    ``predict.Predictor`` on the card."""
    import tempfile

    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision

    card, host = mx.gpu(0), mx.cpu()
    recs = []
    for i, (name, size) in enumerate(ZOO):
        np.random.seed(i)
        x = np.random.RandomState(100 + i).rand(
            ZOO_BATCH, 3, size, size).astype(np.float32)
        net = vision.get_model(name, prefix="zoo_")
        net.initialize(mx.init.Xavier(), ctx=card)
        net.hybridize()
        xc = mx.nd.array(x, ctx=card)
        with mx.autograd.pause():
            out = net(xc)                          # deferred init, warm
            torch.cuda.synchronize()
            ms = []
            for _ in range(ZOO_TIMED):
                t0 = time.perf_counter()
                out = net(xc)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
        on_card = out.data.is_cuda
        logits = out.asnumpy()
        weights = {k: v.data().asnumpy()
                   for k, v in net.collect_params().items()}
        with tempfile.TemporaryDirectory() as d:
            prefix = os.path.join(d, name)
            net.export(prefix)
            pred = mx.predict.Predictor(
                prefix + "-symbol.json", prefix + "-0000.params", ctx=card,
                input_shapes={"data": x.shape})
            served = pred.forward(data=xc)[0].asnumpy()
        del pred, net, out
        torch.cuda.empty_cache()
        ref = vision.get_model(name, prefix="zoo_")
        ref.load_dict(weights, ctx=host)
        ref.cast("float64")
        t0 = time.perf_counter()
        with mx.autograd.pause():
            want = ref(mx.nd.NDArray(torch.from_numpy(
                x.astype(np.float64)))).asnumpy()
        host_s = time.perf_counter() - t0
        del ref, weights
        scale = float(np.abs(want).max())
        err = float(np.abs(logits - want).max())
        export_err = float(np.abs(served - logits).max())
        rec = {"phase": "zoo", "model": name, "device": dev["name"],
               "nvidia_smi": dev["smi"], "batch": ZOO_BATCH, "size": size,
               "forward_ms": ms, "img_per_s": [ZOO_BATCH * 1e3 / m
                                               for m in ms],
               "max_abs_err_vs_cpu_f64": err, "logit_scale": scale,
               "tol": ZOO_REL, "export_max_abs_err": export_err,
               "export_bitwise": bool(np.array_equal(served, logits)),
               "export_tol": ZOO_EXPORT_REL, "cpu_f64_s": host_s}
        _emit(rec)
        recs.append(rec)
        _check(on_card and logits.shape == (ZOO_BATCH, 1000)
               and np.isfinite(logits).all(),
               "zoo %s: logits %s on the card %s" % (name, logits.shape,
                                                     on_card))
        _check(err <= ZOO_REL * scale, "zoo %s: the card's fp32 logits are "
               "%g from the CPU's float64 ones (largest %g)"
               % (name, err, scale))
        _check(export_err <= ZOO_EXPORT_REL * scale, "zoo %s: the export "
               "through predict.Predictor is %g from the Gluon logits"
               % (name, export_err))
    return recs


def _ssd_scenes(n, seed=0):
    """``n`` seeded synthetic 300x300 scenes: noise plus up to
    ``SSD_MAX_OBJ`` rectangles, each tinted by its class.  Labels
    [n, SSD_MAX_OBJ, 5] rows (class, x1, y1, x2, y2) in [0, 1], -1
    padded."""
    import numpy as np

    rng = np.random.RandomState(seed)
    S = SSD_SIZE
    palette = rng.uniform(-1, 1, (SSD_CLASSES, 3)).astype(np.float32)
    imgs = rng.normal(0, 0.1, (n, 3, S, S)).astype(np.float32)
    labels = np.full((n, SSD_MAX_OBJ, 5), -1.0, np.float32)
    for i in range(n):
        for j in range(rng.randint(1, SSD_MAX_OBJ + 1)):
            cls = rng.randint(0, SSD_CLASSES)
            w, h = rng.randint(30, 160, 2)
            x0, y0 = rng.randint(0, S - w), rng.randint(0, S - h)
            imgs[i, :, y0:y0 + h, x0:x0 + w] += palette[cls][:, None, None]
            labels[i, j] = (cls, x0 / S, y0 / S, (x0 + w) / S, (y0 + h) / S)
    return imgs, labels


@contextlib.contextmanager
def _nms_calls(record):
    """Record the arguments of every ``greedy_nms`` call the detection ops
    make (for the kernel-vs-plain check on the decode's own boxes)."""
    from mxnet_tpu_torch.ops import detection

    real = detection.greedy_nms

    def recorder(*args, **kw):
        record.append((args, kw))
        return real(*args, **kw)

    detection.greedy_nms = recorder
    try:
        yield
    finally:
        detection.greedy_nms = real


def _nms_pairs(keep, valid, ids):
    """The IoU evaluations greedy NMS needs on these inputs: for each kept
    box, the later valid boxes (of its class, with ``ids``)."""
    import torch

    keep, valid = keep.cpu(), valid.cpu()
    total = 0
    for b in range(valid.shape[0]):
        groups = [valid[b]] if ids is None else [
            valid[b] & (ids[b].cpu() == c)
            for c in torch.unique(ids[b].cpu()[valid[b]])]
        for m in groups:
            later = m.long().flip(0).cumsum(0).flip(0) - m.long()
            total += int(later[keep[b] & m].sum())
    return total


def _nms_case(args, kw, topk):
    """The NMS kernel against its plain version on one decode's sorted
    boxes: bit for bit, each timed; the bound from the bytes and the IoU
    evaluations these boxes need."""
    import torch
    from mxnet_tpu_torch.ops.kernels.nms import (_greedy_nms_cuda,
                                                 greedy_nms_reference)

    boxes, valid, ids, thresh = args[:4]
    call = (boxes, valid, ids, thresh, kw["iou"], kw["cmp"])
    got = _greedy_nms_cuda(*call)
    want = greedy_nms_reference(*call)
    torch.cuda.synchronize()
    B, N = valid.shape
    tensors = [boxes, valid] + ([ids] if ids is not None else [])
    ms = _time_ms(_greedy_nms_cuda, [
        (c[0], c[1], c[2] if ids is not None else None) + call[3:]
        for c in _copies(tensors)])
    plain_ms = _time_eager_ms(lambda: greedy_nms_reference(*call), reps=2)
    pairs = _nms_pairs(got, valid, ids)
    nbytes = B * N * (16 + 1 + 4 + 1)           # boxes, valid, ids; keep
    bound, by = _bound(NMS_IOU_OPS * pairs, nbytes, "float32")
    return {"name": "greedy_nms", "nms_topk": topk, "shape": [B, N],
            "valid": int(valid.sum()), "kept": int(got.sum()),
            "iou_evaluations": pairs, "bitwise": bool(torch.equal(got,
                                                                  want)),
            "max_abs_err": float((got.int() - want.int()).abs().max()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": None}


def phase_detection(dev):
    """SSD-300 (see SSD_*) trained five steps and decoded on the card, with
    the NMS kernel's main-path count; MultiBoxTarget and MultiBoxDetection
    card against CPU on the step's own tensors; the NMS kernel against its
    plain version at nms_topk 400 and -1; Proposal and ROIPooling at
    Faster R-CNN's size (see RPN_*, ROI_*) card against CPU."""
    import importlib.util

    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import ssd
    from mxnet_tpu_torch.ops import registry
    from mxnet_tpu_torch.ops.kernels import common

    card, host = mx.gpu(0), mx.cpu()
    mx.random.seed(0)
    np.random.seed(0)                   # the initializers draw from numpy
    net = ssd.ssd_300_vgg16_reduced(classes=SSD_CLASSES)
    net.initialize(mx.init.Xavier(), ctx=card)
    imgs, labels = _ssd_scenes(SSD_BATCH)
    x = mx.nd.array(imgs, ctx=card)
    y = mx.nd.array(labels, ctx=card)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", dict(SSD_SGD))
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, calls = [], [], []
    common.reset_counts()
    for _ in range(SSD_STEPS):
        t0 = time.perf_counter()
        with mx.autograd.record():
            anchors, cls_preds, box_preds = net(x)
            loss = ssd.multibox_loss(anchors, cls_preds, box_preds, y)
        loss.backward()
        trainer.step(SSD_BATCH)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss.asnumpy()))
    decode_ms = []
    with mx.autograd.pause(), _nms_calls(calls):
        for _ in range(SSD_DECODE_REPS):
            t0 = time.perf_counter()
            dets = ssd.detect(anchors, cls_preds, box_preds, **SSD_NMS)
            torch.cuda.synchronize()
            decode_ms.append((time.perf_counter() - t0) * 1e3)
    launches = common.launch_counts()
    selects = common.selection_counts()
    peak = torch.cuda.max_memory_allocated()
    det = dets.asnumpy()
    med = statistics.median(step_ms[1:])
    rec = {"phase": "detection", "device": dev["name"],
           "nvidia_smi": dev["smi"], "net": "ssd_300_vgg16_reduced",
           "anchors": int(anchors.shape[1]), "classes": SSD_CLASSES,
           "batch": SSD_BATCH, "losses": losses, "step_ms": step_ms,
           "median_step_ms": med, "img_per_s": SSD_BATCH * 1e3 / med,
           "decode_ms": decode_ms,
           "median_decode_ms": statistics.median(decode_ms[1:]),
           "detections": int((det[..., 0] >= 0).sum()),
           "peak_mem_gb": peak / 1e9, "launches": launches,
           "selects": selects,
           "torchvision_installed":
               importlib.util.find_spec("torchvision") is not None}
    _check(anchors.shape == (1, 8732, 4) and det.shape == (SSD_BATCH, 8732, 6)
           and np.isfinite(det).all(), "detection: anchors %s, detections "
           "%s" % (tuple(anchors.shape), det.shape))
    _check(all(np.isfinite(losses)) and losses[-1] < losses[0],
           "detection: the SSD-300 loss did not fall: %s" % losses)
    _check(launches.get("kernels.launch.greedy_nms", 0) == SSD_DECODE_REPS
           and not any(k.endswith(".reference") for k in selects),
           "detection: the decode's NMS launches %s, selections %s"
           % (launches, selects))
    # MultiBoxTarget and MultiBoxDetection, card against CPU, on the last
    # step's own tensors (the class probabilities computed once, on the
    # card)
    a, cp, bp = (t.data.detach() for t in (anchors, cls_preds, box_preds))
    tgt = registry.get_op("_contrib_MultiBoxTarget").fn
    kw = dict(overlap_threshold=0.5, negative_mining_ratio=3,
              negative_mining_thresh=0.5)
    got = tgt(a, y.data, cp.transpose(1, 2), **kw)
    want = tgt(a.cpu(), y.data.cpu(), cp.transpose(1, 2).cpu(), **kw)
    prob = torch.softmax(cp, -1).transpose(1, 2)
    mbd = registry.get_op("_contrib_MultiBoxDetection").fn
    d_got = mbd(prob, bp, a, **SSD_NMS).cpu()
    d_want = mbd(prob.cpu(), bp.cpu(), a.cpu(), **SSD_NMS)
    pos = want[1].reshape(SSD_BATCH, -1, 4)[..., 0] > 0
    cls_got = got[2].cpu()
    rec["target_card_vs_cpu"] = {
        "loc_target_max_abs_err": float((got[0].cpu() - want[0]).abs().max()),
        "loc_mask_equal": bool(torch.equal(got[1].cpu(), want[1])),
        "positive_classes_equal": bool(torch.equal(cls_got[pos],
                                                   want[2][pos])),
        "negatives_per_image_equal": bool(torch.equal(
            (cls_got == 0).sum(1), (want[2] == 0).sum(1))),
        "mining_swaps_per_image": ((cls_got != want[2]).sum(1) // 2).tolist(),
        "positives": int(pos.sum()), "negatives": int((want[2] == 0).sum())}
    rec["detection_card_vs_cpu"] = {
        "ids_equal": bool(torch.equal(d_got[..., 0], d_want[..., 0])),
        "max_abs_err": float((d_got - d_want).abs().max()),
        "kept": int((d_want[..., 0] >= 0).sum())}
    # the NMS kernel against its plain version on the decode's boxes
    cases = [_nms_case(*calls[-1], SSD_NMS["nms_topk"])]
    calls.clear()
    with mx.autograd.pause(), _nms_calls(calls):
        ssd.detect(anchors, cls_preds, box_preds,
                   nms_threshold=SSD_NMS["nms_threshold"], nms_topk=-1)
    cases.append(_nms_case(*calls[-1], -1))
    rec["nms"] = cases
    # Proposal and ROIPooling at Faster R-CNN's size
    rng = np.random.RandomState(5)
    B, A, H, W = RPN_SHAPE
    cls = torch.from_numpy(rng.uniform(0, 1, (B, 2 * A, H, W))
                           .astype(np.float32))
    bbox = torch.from_numpy(rng.normal(0, 0.2, (B, 4 * A, H, W))
                            .astype(np.float32))
    info = torch.tensor([[H * 16.0, W * 16.0, 1.0]])
    prop = registry.get_op("_contrib_Proposal").fn
    common.reset_counts()
    t0 = time.perf_counter()
    rois = prop(cls.cuda(), bbox.cuda(), info.cuda(), **RPN_KW)
    torch.cuda.synchronize()
    prop_ms = (time.perf_counter() - t0) * 1e3
    prop_launches = common.launch_counts()
    rois_cpu = prop(cls, bbox, info, **RPN_KW)
    fmap = torch.from_numpy(rng.standard_normal(ROI_MAP).astype(np.float32))
    pool = registry.get_op("ROIPooling").fn
    roi_in = rois.cpu()
    t0 = time.perf_counter()
    pooled = pool(fmap.cuda(), roi_in.cuda(), pooled_size=ROI_POOLED,
                  spatial_scale=1 / 16)
    torch.cuda.synchronize()
    pool_ms = (time.perf_counter() - t0) * 1e3
    pooled_cpu = pool(fmap, roi_in, pooled_size=ROI_POOLED,
                      spatial_scale=1 / 16)
    near = (roi_in[:, None, 1:] - rois_cpu[None, :, 1:]).abs().amax(-1)
    rec["proposal"] = {"shape": list(RPN_SHAPE), **RPN_KW,
                       "rois": list(rois.shape), "ms": prop_ms,
                       "launches": prop_launches,
                       "max_abs_err_vs_cpu": float(
                           (roi_in - rois_cpu).abs().max()),
                       "matched_share": float(
                           (near.amin(1) <= RPN_ATOL).float().mean())}
    rec["roi_pooling"] = {"map": list(ROI_MAP), "rois": int(roi_in.shape[0]),
                          "pooled": list(ROI_POOLED), "ms": pool_ms,
                          "bitwise_vs_cpu": bool(torch.equal(pooled.cpu(),
                                                             pooled_cpu))}
    _emit(rec)
    tc, dc = rec["target_card_vs_cpu"], rec["detection_card_vs_cpu"]
    _check(tc["loc_mask_equal"] and tc["positive_classes_equal"]
           and tc["negatives_per_image_equal"]
           and max(tc["mining_swaps_per_image"]) <= SSD_MINING_SWAPS
           and tc["loc_target_max_abs_err"] <= SSD_CARD_CPU_TOL,
           "detection: MultiBoxTarget card vs CPU: %s" % tc)
    _check(dc["ids_equal"] and dc["max_abs_err"] <= SSD_CARD_CPU_TOL,
           "detection: MultiBoxDetection card vs CPU: %s" % dc)
    for c in cases:
        _check(c["bitwise"], "detection: the NMS kernel differs from its "
               "plain version at nms_topk %d" % c["nms_topk"])
    _check(prop_launches == {"kernels.launch.greedy_nms": 1}
           and rois.shape == (RPN_KW["rpn_post_nms_top_n"], 5)
           and rec["proposal"]["matched_share"] >= RPN_MATCH,
           "detection: Proposal: %s" % rec["proposal"])
    _check(rec["roi_pooling"]["bitwise_vs_cpu"],
           "detection: ROIPooling on the card differs from the CPU's")
    if "--profile" in sys.argv[1:]:
        def step():
            with mx.autograd.record():
                loss = ssd.multibox_loss(*net(x), y)
            loss.backward()
            trainer.step(SSD_BATCH)

        _profile_window("ssd300_train_step_b%d" % SSD_BATCH, step)
        with mx.autograd.pause():
            _profile_window("ssd300_decode_b%d" % SSD_BATCH,
                            lambda: ssd.detect(anchors, cls_preds, box_preds,
                                               **SSD_NMS))
    return launches, cases[0]


def _rel_l2(a, b):
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _compare_tensors(got, want, tol):
    """Hold ``{name: array}`` ``got`` to ``want``: the relative L2 error of
    all of them together, and of each whose norm is at least
    ``CANCELLED_SHARE`` of their joint norm, within ``tol``.  A smaller
    tensor is a sum that cancels, whose relative error a one-ulp change
    anywhere upstream inflates: in a CPU rehearsal (ResNet-18, batch 4),
    swapping the head's softmax for one a few ulp away moved bn0's gamma
    gradient (4e-5 of the whole's norm of 12) by 2.7% and its beta gradient
    (7e-4 of it) by 7e-5, all the rest by at most 3e-5.  Such a tensor's
    error is reported, not gated.  Returns ``(ok, report)``."""
    import numpy as np

    names = sorted(want)
    total = float(np.sqrt(sum(np.square(np.asarray(want[n], np.float64))
                              .sum() for n in names)))
    diff = float(np.sqrt(sum(np.square(np.asarray(got[n], np.float64)
                                       - want[n]).sum() for n in names)))
    errs = {n: _rel_l2(got[n], want[n]) for n in names}
    small = {n for n in names
             if np.linalg.norm(want[n]) < CANCELLED_SHARE * total}
    gated = {n: e for n, e in errs.items() if n not in small}
    worst = max(gated.items(), key=lambda kv: kv[1]) if gated else None
    joint = diff / max(total, 1e-30)
    ok = (joint <= tol and (worst is None or worst[1] <= tol)
          and all(np.isfinite(got[n]).all() for n in names))
    return ok, {"joint_rel_l2": joint, "worst": worst, "tensors": len(names),
                "cancelled": {n: errs[n] for n in sorted(small)}}


def _module_step(mx, net, ctx, args, auxs, x, y, dtype="float32",
                 optimizer_params=None):
    """One ``forward_backward`` and ``update`` of a fresh Module on ``ctx``
    from numpy ``args`` / ``auxs``: the gradients, the moving statistics
    after the step and the update ``w_new - w_old``, as numpy.  With
    ``dtype="float64"`` every array of the bound executor, the inputs and
    so the optimizer's state are float64.  The SGD is module_train's
    unless ``optimizer_params`` are given."""
    import torch
    from mxnet_tpu_torch.model import params_from_numpy

    mod = mx.mod.Module(net, context=ctx)
    mod.bind(data_shapes=[("data", x.shape)],
             label_shapes=[("softmax_label", y.shape)])
    if dtype == "float64":          # nd.array makes f32 of f64 input
        ex = mod._exec
        for arr in ex.arg_arrays + ex.aux_arrays + ex.grad_arrays:
            if arr is not None:
                arr._set_data(arr.data.double())
    a, b = params_from_numpy(args, auxs, ctx=ctx)
    mod.init_params(arg_params=a, aux_params=b)      # cast into the bound
    if optimizer_params is None:
        optimizer_params = dict(
            MODULE_SGD, lr_scheduler=mx.lr_scheduler.MultiFactorScheduler(
                [30 * MODULE_EPOCH_SIZE, 60 * MODULE_EPOCH_SIZE], 0.1))
    mod.init_optimizer(optimizer="sgd", optimizer_params=optimizer_params)
    x, y = (mx.nd.NDArray(torch.from_numpy(v.astype(dtype)).to(
        ctx.torch_device())) for v in (x, y))
    mod.forward_backward(mx.io.DataBatch([x], [y]))
    grads = {n: g.asnumpy() for n, g in mod._exec.grad_dict.items()
             if g is not None}
    mod.update()
    new_args, new_auxs = mod.get_params()
    return (grads, {n: v.asnumpy() for n, v in new_auxs.items()},
            {n: new_args[n].asnumpy() - args[n] for n in args})


def _module_gate(mx, net, args, auxs, images, labels):
    """The module_train gate at the parameters ``args`` / ``auxs``: the
    step at ``MODULE_CHECK_BATCH`` on the card and on the CPU, in float64
    (gradients, moving statistics and updates within
    ``MODULE_CHECK_REL_F64``) and in f32 (moving statistics within
    ``MODULE_CHECK_REL``; gradients of each device against the CPU's
    float64 step, reported).  Returns ``(ok, report)``."""
    x = images[:MODULE_CHECK_BATCH]
    y = labels[:MODULE_CHECK_BATCH]
    step = {(where, dt): _module_step(mx, net, ctx, args, auxs, x, y, dt)
            for where, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu()))
            for dt in ("float64", "float32")}
    report, ok = {"float64": {}, "float32": {}}, True
    for i, what in enumerate(("grad", "aux", "update")):
        good, report["float64"][what] = _compare_tensors(
            step["card", "float64"][i], step["cpu", "float64"][i],
            MODULE_CHECK_REL_F64)
        ok = ok and good
    good, report["float32"]["aux"] = _compare_tensors(
        step["card", "float32"][1], step["cpu", "float32"][1],
        MODULE_CHECK_REL)
    ok = ok and good
    for where in ("card", "cpu"):
        _, rep = _compare_tensors(step[where, "float32"][0],
                                  step["cpu", "float64"][0], MODULE_CHECK_REL)
        report["float32"]["grad_%s_vs_float64" % where] = {
            k: rep[k] for k in ("joint_rel_l2", "worst")}
    return ok, report


def phase_module_train(dev):
    """``Module.fit`` of the symbolic ResNet-50 at train_imagenet.py's
    settings on 256 seeded images, then the card-vs-CPU step gate.
    Returns the trained parameters (numpy) and the module, for the rtc
    phase and ``--profile``."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models.resnet_symbol import get_symbol
    from mxnet_tpu_torch.ops.kernels import common

    ctx = mx.gpu(0)
    net = get_symbol(**INT8_NET)
    shape = tuple(int(v) for v in INT8_NET["image_shape"].split(","))
    rng = np.random.default_rng(3)
    images = rng.random((MODULE_IMAGES,) + shape, dtype=np.float32)
    labels = rng.integers(0, INT8_NET["num_classes"],
                          MODULE_IMAGES).astype(np.float32)
    it = mx.io.NDArrayIter(images, labels, MODULE_BATCH, shuffle=False)
    ends, losses = [], []

    def step_end(param):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        p = mod.get_outputs()[0].asnumpy()
        y = param.locals["data_batch"].label[0].asnumpy().astype(int)
        losses.append(float(-np.log(p[np.arange(len(y)), y]).mean()))

    mx.random.seed(0)
    mod = mx.mod.Module(net, context=ctx)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    common.reset_counts()
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=1, optimizer="sgd",
            optimizer_params=dict(
                MODULE_SGD, lr_scheduler=mx.lr_scheduler.MultiFactorScheduler(
                    [30 * MODULE_EPOCH_SIZE, 60 * MODULE_EPOCH_SIZE], 0.1)),
            eval_metric=["accuracy"],
            batch_end_callback=[step_end,
                                mx.callback.Speedometer(MODULE_BATCH, 2)])
    fit_s = time.perf_counter() - t0
    launches = common.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = [(b - a) * 1e3 for a, b in zip(ends, ends[1:])]
    steps = MODULE_IMAGES // MODULE_BATCH
    opt = mod._optimizer

    # the data BatchNorm sees the images themselves: after k steps its
    # moving statistics are k EMA applications of the batches' moments
    mean, var = np.zeros(3), np.ones(3)
    for k in range(steps):
        xb = images[k * MODULE_BATCH:(k + 1) * MODULE_BATCH].astype(
            np.float64)
        mean = 0.9 * mean + 0.1 * xb.mean(axis=(0, 2, 3))
        var = 0.9 * var + 0.1 * xb.var(axis=(0, 2, 3))
    args, auxs = mod.get_params()
    args = {n: v.asnumpy() for n, v in args.items()}
    auxs = {n: v.asnumpy() for n, v in auxs.items()}
    stats_err = max(_rel_l2(auxs["bn_data_moving_mean"], mean),
                    _rel_l2(auxs["bn_data_moving_var"], var))
    moved = sum(not (np.all(v == 0) or np.all(v == 1))
                for v in auxs.values())
    rec = {
        "phase": "module_train", "device": dev["name"],
        "nvidia_smi": dev["smi"], "net": INT8_NET, "batch": MODULE_BATCH,
        "images": MODULE_IMAGES, "steps": steps, "fit_s": fit_s,
        "step_ms": step_ms, "img_per_s": [MODULE_BATCH * 1e3 / m
                                          for m in step_ms],
        "median_step_ms": statistics.median(step_ms),
        "peak_mem_gb": peak_gb, "losses": losses,
        "num_update": opt.num_update, "lr": opt._get_lr(0),
        "bn_data_stats_rel_err_vs_k_ema": stats_err,
        "moving_stats_moved": moved, "moving_stats": len(auxs),
        "launch_counts": launches,
    }
    _emit(rec)
    _check(len(losses) == steps and all(np.isfinite(losses)),
           "module_train: losses %s" % losses)
    _check(opt.num_update == steps, "module_train: %d updates for %d steps"
           % (opt.num_update, steps))
    _check(stats_err <= MODULE_STATS_REL, "module_train: the data "
           "BatchNorm's moving statistics are %g from %d EMA steps"
           % (stats_err, steps))
    _check(moved == len(auxs), "module_train: %d of %d moving statistics "
           "moved" % (moved, len(auxs)))

    # -- the gate: one step on the card against the same step on the CPU
    t0 = time.perf_counter()
    ok, report = _module_gate(mx, net, args, auxs, images, labels)
    _emit({"phase": "module_step_card_vs_cpu", "batch": MODULE_CHECK_BATCH,
           "tol": MODULE_CHECK_REL, "tol_f64": MODULE_CHECK_REL_F64,
           "cancelled_share": CANCELLED_SHARE, "report": report,
           "seconds": time.perf_counter() - t0, "ok": ok})
    _check(ok, "module_train: the step on the card differs from the CPU's: "
           "%s" % report)
    _module_resume(mx, mod, images, labels, ctx, dev)
    return {"args": args, "auxs": auxs, "module": mod, "images": images,
            "labels": labels}


def _module_resume(mx, mod, images, labels, ctx, dev):
    """The fitted module's checkpoint round trip: ``save_checkpoint`` with
    the optimizer's states, ``Module.load(load_optimizer_states=True)`` on
    the card, then one more step of each on the next batch (the first of
    the next epoch), cuDNN deterministic: the resumed module's parameters,
    moving statistics and momenta must equal the fitted one's bit for
    bit."""
    import tempfile

    import numpy as np
    import torch

    shape = (MODULE_BATCH,) + images.shape[1:]
    batch = mx.io.DataBatch(
        [mx.nd.array(images[:MODULE_BATCH], ctx=ctx)],
        [mx.nd.array(labels[:MODULE_BATCH], ctx=ctx)])
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        prefix = os.path.join(d, "resnet50")
        mod.save_checkpoint(prefix, 1, save_optimizer_states=True)
        sizes = {f: os.path.getsize(os.path.join(d, f))
                 for f in sorted(os.listdir(d))}
        resumed = mx.mod.Module.load(prefix, 1, load_optimizer_states=True,
                                     context=ctx)
        resumed.bind(data_shapes=[("data", shape)],
                     label_shapes=[("softmax_label", (MODULE_BATCH,))])
        resumed.init_optimizer(optimizer="sgd", optimizer_params=dict(
            MODULE_SGD, lr_scheduler=mx.lr_scheduler.MultiFactorScheduler(
                [30 * MODULE_EPOCH_SIZE, 60 * MODULE_EPOCH_SIZE], 0.1)))
    round_trip_s = time.perf_counter() - t0

    def state(m):
        args, auxs = m.get_params()
        out = {k: v.asnumpy() for k, v in list(args.items())
               + list(auxs.items())}
        out.update(("state%d" % i, np.asarray(
            s.asnumpy() if hasattr(s, "asnumpy") else s))
            for i, s in m._updater.states.items())
        return out

    before = (state(mod), state(resumed))
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for m in (mod, resumed):
            m.forward_backward(batch)
            m.update()
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = saved
    got, want = state(resumed), state(mod)
    loaded_same = sorted(before[0]) == sorted(before[1]) and all(
        np.array_equal(before[0][k], before[1][k]) for k in before[0])
    differ = sorted(k for k in want if k not in got
                    or not np.array_equal(got[k], want[k]))
    moved = sum(not np.array_equal(want[k], before[0][k]) for k in want)
    _emit({"phase": "module_checkpoint_resume", "device": dev["name"],
           "files_bytes": sizes, "round_trip_s": round_trip_s,
           "tensors": len(want), "moved_by_the_step": moved,
           "loaded_equal_saved": loaded_same,
           "differing_after_the_step": differ})
    _check(loaded_same, "module_train: the loaded module's parameters or "
           "optimizer states differ from the saved module's")
    _check(not differ and moved > 0, "module_train: the resumed module's "
           "step differs from the fitted module's in %s (%d tensors moved)"
           % (differ[:8], moved))


def _rtc_kernel_case(kernels, numpy_op, n, c, seed):
    """The rtc softmax kernels at [n, c] against numpy_softmax (their plain
    version) on the same inputs: forward within RTC_FWD_*, backward on the
    same p bit for bit; kernel times as the other kernels', the plain
    version's on the host clock.  Two records."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx

    fwd, bwd = kernels
    ctx = mx.gpu(0)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = mx.nd.NDArray(3 * torch.randn((n, c), generator=gen,
                                      device="cuda"))
    y = mx.nd.NDArray(torch.randint(0, c, (n,), generator=gen,
                                    device="cuda").float())
    p_k, p_n = mx.nd.zeros((n, c), ctx=ctx), mx.nd.zeros((n, c), ctx=ctx)
    fwd.launch([x, p_k, c], ctx, (n, 1, 1), (RTC_THREADS, 1, 1))
    op = numpy_op()
    op.forward(True, ["write"], [x, y], [p_n], [])
    dx_k = mx.nd.zeros((n, c), ctx=ctx)
    dx_n = [mx.nd.zeros((n, c), ctx=ctx), mx.nd.zeros((n,), ctx=ctx)]
    bwd.launch([p_n, y, dx_k, c, float(n)], ctx, (n, 1, 1),
               (RTC_THREADS, 1, 1))
    op.backward(["write", "write"], [None], [x, y], [p_n], dx_n, [])
    torch.cuda.synchronize()
    fk, fn_ = p_k.data, p_n.data
    f_err = float((fk - fn_).abs().max())
    f_ok = bool(((fk - fn_).abs() <= RTC_FWD_ATOL
                 + RTC_FWD_RTOL * fn_.abs()).all())
    b_exact = bool(torch.equal(dx_k.data.view(torch.int32),
                               dx_n[0].data.view(torch.int32)))
    b_err = float((dx_k.data - dx_n[0].data).abs().max())

    def host_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    nb = 4.0 * n * c
    fwd_bound, fwd_by = _bound(5.0 * n * c, 2 * nb, "float32")
    bwd_bound, bwd_by = _bound(2.0 * n * c, 2 * nb + 4 * n, "float32")
    fargs = _copies((x.data, p_k.data))
    bargs = _copies((p_n.data, y.data, dx_k.data))

    def launch_fwd(xt, pt):
        fwd.launch([mx.nd.NDArray(xt), mx.nd.NDArray(pt), c], ctx,
                   (n, 1, 1), (RTC_THREADS, 1, 1))

    def launch_bwd(pt, yt, dt):
        bwd.launch([mx.nd.NDArray(pt), mx.nd.NDArray(yt), mx.nd.NDArray(dt),
                    c, float(n)], ctx, (n, 1, 1), (RTC_THREADS, 1, 1))

    shared = {"shape": [n, c], "dtype": "float32",
              "plain": "numpy_softmax (host numpy; host clock, with its "
                       "device-host copies)"}
    f_rec = dict(shared, kernel="rtc.softmax_forward", max_abs_err=f_err,
                 atol=RTC_FWD_ATOL, rtol=RTC_FWD_RTOL, ok=f_ok,
                 ms=_time_ms(launch_fwd, fargs),
                 plain_ms=host_ms(lambda: op.forward(
                     True, ["write"], [x, y], [p_n], [])),
                 library_ms=_time_ms(lambda xt, pt: torch.softmax(xt, -1),
                                     fargs),
                 library="torch.softmax", bound_ms=fwd_bound,
                 bound_by=fwd_by)
    b_rec = dict(shared, kernel="rtc.softmax_backward", max_abs_err=b_err,
                 bit_exact=b_exact, ok=b_exact,
                 ms=_time_ms(launch_bwd, bargs),
                 plain_ms=host_ms(lambda: op.backward(
                     ["write", "write"], [None], [x, y], [p_n], dx_n, [])),
                 library_ms=None,
                 library="none: no one PyTorch call computes (p - onehot)/n",
                 bound_ms=bwd_bound, bound_by=bwd_by)
    for rec in (f_rec, b_rec):
        _emit(rec)
        _check(rec["ok"], "%s %s disagrees with numpy_softmax (max abs err "
               "%g)" % (rec["kernel"], [n, c], rec["max_abs_err"]))
    return f_rec, b_rec


def _rtc_basics():
    """(a): the reference's templated axpy and tests/test_rtc.py's kernels,
    held exactly against torch; compile ms; no compile on a second module
    of the same source or a second launch; the host cost of a launch."""
    import torch
    import mxnet_tpu_torch as mx

    ctx = mx.gpu(0)
    tmpl = mx.rtc.CudaModule(RTC_AXPY_TEMPLATE_SRC, options=["--fmad=false"],
                             exports=["axpy<float>", "axpy<double>"])
    test = mx.rtc.CudaModule(RTC_TEST_SRC, options=["--fmad=false"])
    rec = {"phase": "rtc_basics",
           "compile_ms": {"axpy_template": tmpl.compile_ms,
                          "test_rtc": test.compile_ms}}
    compiles = mx.rtc.compile_count()
    exact = {}
    for dt, ctype in ((torch.float32, "float"), (torch.float64, "double")):
        k = tmpl.get_kernel("axpy<%s>" % ctype, "const %s *x, %s *y, %s "
                            "alpha" % (ctype, ctype, ctype))
        x = mx.nd.NDArray(torch.arange(1024, dtype=dt, device="cuda"))
        y = mx.nd.NDArray(torch.full((1024,), 0.5, dtype=dt, device="cuda"))
        want = y.data + 3.0 * x.data
        k.launch([x, y, 3.0], ctx, (4, 1, 1), (256, 1, 1))
        exact["axpy<%s>" % ctype] = bool(torch.equal(y.data, want))
    n = 1000
    x = mx.nd.NDArray(torch.randn(n, device="cuda"))
    y = mx.nd.NDArray(torch.randn(n, device="cuda"))
    out = mx.nd.zeros((n,), ctx=ctx)
    axpy = test.get_kernel("axpy", "const float *x, const float *y, "
                                   "float *o, int n")
    scale = test.get_kernel("scale", "const float *x, float *o, int n")
    for _ in range(2):
        axpy.launch([x, y, out, n], ctx, ((n + 255) // 256, 1, 1),
                    (256, 1, 1))
    exact["axpy"] = bool(torch.equal(out.data, 2.5 * x.data + y.data))
    scale.launch([x, out, n], ctx, ((n + 255) // 256, 1, 1), (256, 1, 1))
    exact["scale"] = bool(torch.equal(out.data, x.data * 3.0))
    again = mx.rtc.CudaModule(RTC_TEST_SRC, options=["--fmad=false"])
    rec["second_module_compile_ms"] = again.compile_ms
    rec["compiles_after_second_module_and_launches"] = \
        mx.rtc.compile_count() - compiles
    rec["functions_loaded_after_two_launches"] = len(axpy._functions)
    # the host cost of one launch through ctypes (the device work of one
    # 1000-element launch is far shorter, so this is the host's)
    reps = 2000
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        scale.launch([x, out, n], ctx, ((n + 255) // 256, 1, 1),
                     (256, 1, 1))
    host_us = (time.perf_counter() - t0) * 1e6 / reps
    torch.cuda.synchronize()
    rec.update(exact=exact, launch_host_us=host_us,
               launch_host_us_reps=reps)
    _emit(rec)
    _check(all(exact.values()), "rtc kernels differ from torch: %s" % exact)
    _check(rec["compiles_after_second_module_and_launches"] == 0
           and again.compile_ms is None, "rtc compiled again")
    _check(rec["functions_loaded_after_two_launches"] == 1,
           "rtc loaded the kernel twice")
    return rec


def _fit_custom_softmax(mx, op_type, params, X, Y):
    """The example's network and training through ``op_type``."""
    ctx = mx.gpu(0)
    data = mx.sym.Variable("data")
    label = mx.sym.Variable("softmax_label")
    net = mx.sym.FullyConnected(data, num_hidden=16, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=4, name="fc2")
    net = mx.sym.Custom(net, label, op_type=op_type, name="softmax")
    it = mx.io.NDArrayIter(X, Y, batch_size=64, shuffle=False)
    mod = mx.mod.Module(net, context=ctx)
    mod.fit(it, num_epoch=RTC_EPOCHS, optimizer="adam",
            optimizer_params={"learning_rate": 5e-3}, eval_metric="acc",
            arg_params={k: mx.nd.array(v, ctx=ctx)
                        for k, v in params.items()})
    it.reset()
    metric = mx.metric.Accuracy()
    mod.score(it, metric)
    acc = dict(metric.get_name_value())["accuracy"]
    return acc, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def phase_rtc(dev, trained):
    """User CUDA kernels through mx.rtc inside a Custom op: (a) the basics,
    (b) the custom-softmax example trained through rtc_softmax and through
    numpy_softmax, (c) ResNet-50 at batch 32 with its head swapped for
    rtc_softmax against numpy_softmax, and the kernels against their plain
    version.  Returns the launches of the counted runs and the kernel
    records."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models.resnet_symbol import get_symbol
    from mxnet_tpu_torch.ops.kernels import common

    basics = _rtc_basics()
    user = register_user_ops(mx)
    t0 = time.perf_counter()
    kernels = user["kernels"]()
    softmax_compile_ms = user["compiled"]["module"].compile_ms
    setup_ms = (time.perf_counter() - t0) * 1e3

    # -- (b) the example: 512 separable examples, 10 epochs --------------
    rng = np.random.RandomState(0)
    X = rng.uniform(0, 1, (512, 16)).astype(np.float32)
    Y = rng.randint(0, 4, (512,)).astype(np.float32)
    X[np.arange(512), Y.astype(int)] += 2.0
    mx.random.seed(0)
    probe = mx.mod.Module(mx.sym.FullyConnected(mx.sym.FullyConnected(
        mx.sym.Variable("data"), num_hidden=16, name="fc1"), num_hidden=4,
        name="fc2"), label_names=(), context=mx.gpu(0))
    probe.bind(data_shapes=[("data", (64, 16))])
    probe.init_params(initializer=mx.init.Xavier())
    params = {k: v.asnumpy() for k, v in probe.get_params()[0].items()}
    common.reset_counts()
    acc_rtc, p_rtc = _fit_custom_softmax(mx, "rtc_softmax", params, X, Y)
    fit_launches = common.launch_counts()
    acc_np, p_np = _fit_custom_softmax(mx, "numpy_softmax", params, X, Y)
    fit_err = max(_rel_l2(p_rtc[k], p_np[k]) for k in p_np)
    batches = 512 // 64
    want_fit = {"kernels.launch.rtc.softmax_forward":
                RTC_EPOCHS * batches + batches,       # + the scoring pass
                "kernels.launch.rtc.softmax_backward": RTC_EPOCHS * batches}

    # -- (c) ResNet-50 at batch 32, the head swapped ---------------------
    net = get_symbol(**INT8_NET)
    fc1 = net.get_internals()["fc1_output"]
    x = trained["images"][:MODULE_BATCH]
    y = trained["labels"][:MODULE_BATCH]
    heads = {}
    for op_type in ("rtc_softmax", "numpy_softmax"):
        head = mx.sym.Custom(fc1, mx.sym.Variable("softmax_label"),
                             op_type=op_type, name="softmax")
        common.reset_counts()
        heads[op_type] = _module_step(mx, head, mx.gpu(0), trained["args"],
                                      trained["auxs"], x, y)
        torch.cuda.synchronize()
        heads[op_type + "_launches"] = common.launch_counts()
    step_ok, step_report = _compare_tensors(heads["rtc_softmax"][0],
                                            heads["numpy_softmax"][0],
                                            RTC_STEP_REL)
    want_step = {"kernels.launch.rtc.softmax_forward": 1,
                 "kernels.launch.rtc.softmax_backward": 1}

    # -- the kernels against their plain version --------------------------
    main = dict(zip(("rtc.softmax_forward", "rtc.softmax_backward"),
                    _rtc_kernel_case(kernels, user["numpy"], MODULE_BATCH,
                                     INT8_NET["num_classes"], 5)))
    _rtc_kernel_case(kernels, user["numpy"], 64, 4, 6)

    _emit({"phase": "rtc", "device": dev["name"], "nvidia_smi": dev["smi"],
           "softmax_module_compile_ms": softmax_compile_ms,
           "softmax_setup_ms": setup_ms, "basics_compile_ms":
           basics["compile_ms"], "launch_host_us": basics["launch_host_us"],
           "example_accuracy": {"rtc_softmax": acc_rtc,
                                "numpy_softmax": acc_np},
           "example_params_rel_l2": fit_err, "example_tol": RTC_FIT_REL,
           "example_launches": fit_launches,
           "resnet50_step_grads": step_report,
           "resnet50_step_tol": RTC_STEP_REL,
           "resnet50_step_launches": heads["rtc_softmax_launches"],
           "numpy_head_launches": heads["numpy_softmax_launches"]})
    _check(min(acc_rtc, acc_np) >= RTC_MIN_ACC, "rtc: the example's accuracy "
           "%g / %g is below %g" % (acc_rtc, acc_np, RTC_MIN_ACC))
    _check(fit_err <= RTC_FIT_REL, "rtc: the example's parameters through "
           "rtc_softmax differ from numpy_softmax's by %g" % fit_err)
    _check(fit_launches == want_fit, "rtc: the example launched %s, "
           "expected %s" % (fit_launches, want_fit))
    _check(step_ok, "rtc: ResNet-50 gradients through rtc_softmax differ "
           "from numpy_softmax's: %s" % (step_report,))
    _check(heads["rtc_softmax_launches"] == want_step, "rtc: the ResNet-50 "
           "step launched %s, expected %s"
           % (heads["rtc_softmax_launches"], want_step))
    _check(heads["numpy_softmax_launches"] == {}, "rtc: the numpy head "
           "launched %s" % heads["numpy_softmax_launches"])
    return [fit_launches, heads["rtc_softmax_launches"]], main


def _gluon_weights(mx, vision, prefix, seed):
    """Xavier-initialized resnet18_v1 thumbnail weights, made on the CPU
    from ``seed``, as numpy."""
    import numpy as np

    mx.random.seed(seed)
    net = vision.resnet18_v1(classes=10, thumbnail=True, prefix=prefix)
    net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    with mx.autograd.pause():
        net(mx.nd.zeros((1, 3, 32, 32), ctx=mx.cpu()))
    return {n: v.astype(np.float32)
            for n, v in net.collect_params().save_dict().items()}


def _gluon_step(mx, ctx, weights, x, y, dtype, hybridize, prefix):
    """One record -> backward -> Trainer.step of resnet18_v1 thumbnail on
    ``ctx`` in ``dtype`` from numpy ``weights``: the gradients, the running
    statistics after the step and the updates ``w_new - w_old``, as
    numpy."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.model_zoo import vision

    net = vision.resnet18_v1(classes=10, thumbnail=True, prefix=prefix)
    net.load_dict(weights, ctx=ctx)
    if dtype != "float32":
        net.cast(dtype)
    if hybridize:
        net.hybridize(static_alloc=True, static_shape=True)
    params = net.collect_params()
    tr = gluon.Trainer(params, "sgd", dict(CIFAR_SGD))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    xd = mx.nd.NDArray(torch.from_numpy(x.astype(dtype)).to(
        ctx.torch_device()))
    with mx.autograd.record():
        loss = loss_fn(net(xd), mx.nd.array(y, ctx=ctx))
    loss.backward()
    grads = {n: p.grad().asnumpy() for n, p in params.items()
             if p.grad_req != "null"}
    tr.step(x.shape[0])
    after = {n: p.data().asnumpy().astype(np.float64)
             for n, p in params.items()}
    stats = {n: v for n, v in after.items() if "running" in n}
    updates = {n: after[n] - weights[n].astype(np.float64)
               for n in grads}
    return grads, stats, updates


def phase_gluon_train(dev):
    """bench.py's train leg on the card (see GLUON_*): ms per step, img/s,
    peak memory, the losses.  Returns what ``--profile`` traces."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.contrib import FusedTrainStep
    from mxnet_tpu_torch.gluon.model_zoo import vision

    ctx = mx.gpu(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mx.random.seed(0)
    net = vision.resnet50_v1(classes=1000)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    net.hybridize(static_alloc=True, static_shape=True)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    rng = np.random.RandomState(0)
    x32 = mx.nd.array(rng.rand(GLUON_BATCH, 3, GLUON_SIZE, GLUON_SIZE)
                      .astype(np.float32), ctx=ctx)
    y = mx.nd.array(rng.randint(0, 1000, (GLUON_BATCH,)), ctx=ctx)
    with mx.autograd.pause():
        net(x32)
    net.cast("bfloat16")
    x = x32.astype("bfloat16")
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(GLUON_SGD))
    step = FusedTrainStep(net, loss_fn, trainer)
    losses = []
    for _ in range(GLUON_WARM):
        losses.append(step(x, y))
    losses = [float(np.asarray(l.asnumpy(), np.float32).mean())
              for l in losses]
    setup_s = time.perf_counter() - t0
    step_ms = []
    for _ in range(GLUON_TIMED):
        t1 = time.perf_counter()
        loss = step(x, y)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(np.asarray(loss.asnumpy(), np.float32).mean()))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    params = net.collect_params()
    dtypes = {}
    for n, p in params.items():
        dtypes.setdefault(str(p.data().dtype), []).append(n)
    upd = trainer._updaters[0]
    masters = [s[1] for s in upd.states.values() if isinstance(s, tuple)]
    med = statistics.median(step_ms)
    # the step accountant's live gauges (bench.py:497-505), from the
    # shapes-counted cost and the host clock between steps
    from mxnet_tpu_torch import telemetry
    gauges = {k: v for k, v in telemetry.registry().snapshot()[
        "gauges"].items() if k.startswith("train.fused.")}
    rec = {
        "phase": "gluon_train", "device": dev["name"],
        "nvidia_smi": dev["smi"], "net": "resnet50_v1", "batch":
        GLUON_BATCH, "image": [3, GLUON_SIZE, GLUON_SIZE],
        "dtype": "bfloat16", "multi_precision": True,
        "hybridize": net._flags, "warm_steps": GLUON_WARM,
        "setup_s": setup_s, "step_ms": step_ms, "median_step_ms": med,
        "img_per_s": GLUON_BATCH * 1e3 / med, "peak_mem_gb": peak_gb,
        "losses": losses, "num_update": trainer._optimizer.num_update,
        "params_by_dtype": {k: len(v) for k, v in dtypes.items()},
        "f32_masters": len(masters), "last_scalars_head":
        step.last_scalars[:5].tolist(), "gauges": gauges,
        "step_cost": step._accountant.cost,
        "seconds": time.perf_counter() - t0,
    }
    _emit(rec)
    _check(all(np.isfinite(losses)), "gluon_train: losses %s" % losses)
    _check(trainer._optimizer.num_update == GLUON_WARM + GLUON_TIMED,
           "gluon_train: %d updates" % trainer._optimizer.num_update)
    _check(all("batchnorm" in n for n in dtypes.get("float32", []))
           and sorted(dtypes) == ["bfloat16", "float32"],
           "gluon_train: parameter dtypes %s" % {
               k: v[:3] for k, v in dtypes.items()})
    _check(len(masters) == len(dtypes["bfloat16"])
           and all(m.dtype == np.float32 for m in masters),
           "gluon_train: %d f32 masters for %d bf16 weights"
           % (len(masters), len(dtypes["bfloat16"])))
    _check(str(loss.dtype) == "bfloat16" and loss.shape == (GLUON_BATCH,),
           "gluon_train: loss %s %s" % (loss.dtype, loss.shape))
    _check(all(k in gauges for k in ("train.fused.mfu",
                                     "train.fused.hbm_util",
                                     "train.fused.items_per_sec")),
           "gluon_train: train.fused gauges %s" % sorted(gauges))
    return {"step": step, "x": x, "y": y, "net": net, "loss_fn": loss_fn,
            "trainer": trainer}


def phase_gluon_cifar(dev):
    """BASELINE.json's Gluon ResNet-18 CIFAR-10 config (see CIFAR_*): the
    loss must fall."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.model_zoo import vision

    ctx = mx.gpu(0)
    mx.random.seed(0)
    net = vision.resnet18_v1(classes=10, thumbnail=True)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    net.hybridize()
    rng = np.random.RandomState(0)
    x = mx.nd.array(rng.rand(CIFAR_BATCH, 3, 32, 32).astype(np.float32),
                    ctx=ctx)
    y = mx.nd.array(rng.randint(0, 10, (CIFAR_BATCH,)), ctx=ctx)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(CIFAR_SGD))
    losses, step_ms = [], []
    for _ in range(CIFAR_STEPS):
        t0 = time.perf_counter()
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(CIFAR_BATCH)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss.asnumpy().mean()))
    med = statistics.median(step_ms[1:])
    _emit({"phase": "gluon_cifar", "device": dev["name"],
           "nvidia_smi": dev["smi"], "net": "resnet18_v1 thumbnail",
           "batch": CIFAR_BATCH, "steps": CIFAR_STEPS, "losses": losses,
           "median_step_ms": med, "img_per_s": CIFAR_BATCH * 1e3 / med})
    _check(all(np.isfinite(losses)) and losses[-1] < CIFAR_FALL * losses[0],
           "gluon_cifar: the loss did not fall: %s" % losses)


def phase_gluon_step_card_vs_cpu(dev):
    """One Gluon step of resnet18_v1 thumbnail at batch 4: float64 on the
    card against the CPU within MODULE_CHECK_REL_F64, and f32 on the card
    hybridized against not within GLUON_HYBRID_REL."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision

    t0 = time.perf_counter()
    weights = _gluon_weights(mx, vision, "gate_", seed=1)
    rng = np.random.RandomState(1)
    x = rng.rand(GLUON_CHECK_BATCH, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 10, GLUON_CHECK_BATCH).astype(np.float32)
    runs = {
        ("card", "float64"): (mx.gpu(0), "float64", False),
        ("cpu", "float64"): (mx.cpu(), "float64", False),
        ("card", "float32"): (mx.gpu(0), "float32", False),
        ("card_hybridized", "float32"): (mx.gpu(0), "float32", True)}
    step = {k: _gluon_step(mx, ctx, weights, x, y, dt, hyb, "gate_")
            for k, (ctx, dt, hyb) in runs.items()}
    report, ok = {"float64_card_vs_cpu": {}, "float32_hybrid": {}}, True
    for i, what in enumerate(("grad", "stats", "update")):
        good, report["float64_card_vs_cpu"][what] = _compare_tensors(
            step["card", "float64"][i], step["cpu", "float64"][i],
            MODULE_CHECK_REL_F64)
        ok = ok and good
        good, report["float32_hybrid"][what] = _compare_tensors(
            step["card_hybridized", "float32"][i],
            step["card", "float32"][i], GLUON_HYBRID_REL)
        ok = ok and good
    _emit({"phase": "gluon_step_card_vs_cpu", "batch": GLUON_CHECK_BATCH,
           "tol_f64": MODULE_CHECK_REL_F64, "tol_hybrid": GLUON_HYBRID_REL,
           "report": report, "seconds": time.perf_counter() - t0,
           "ok": ok})
    _check(ok, "gluon_step_card_vs_cpu: %s" % report)


def phase_gluon_infer(dev, gluon):
    """bench.py's inference and latency_b1 legs on gluon_train's net (see
    INFER_*): img/s of one CUDA-graph replay of the chained forwards per
    draw, of the per-call path, and at batch 1; gates on the graph against
    the eager chain.  Returns the per-call figure the int8 phase divides
    by."""
    import torch
    from mxnet_tpu_torch import autograd, benchmark

    t0 = time.perf_counter()
    net, x = gluon["net"], gluon["x"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the gates, on a loop built here: one replay per draw, the probe
    # leaves the input unchanged, the graph's chain equals the eager one
    loop = benchmark.compiled_loop(net, x, INFER_STEPS)
    before = benchmark.graph_replays()
    loop.draw()
    one_replay = benchmark.graph_replays() - before == 1
    carry_is_x = bool(torch.equal(loop.carry, x.data))
    graph_out = loop.out.float().clone()
    del loop
    torch.cuda.empty_cache()
    zero = torch.zeros((), dtype=x.data.dtype, device=x.data.device)
    with autograd.pause(train_mode=False):
        _, eager_out = benchmark.chained_forward(net, x.data, zero,
                                                 INFER_STEPS)
    eager_out = eager_out.float()
    err = float((graph_out - eager_out).abs().max())
    scale = float(eager_out.abs().max())
    bitwise = bool(torch.equal(graph_out, eager_out))
    # bench.py's figures (each compiled_throughput builds its own graph)
    before = benchmark.graph_replays()
    compiled = benchmark.compiled_throughput(net, x, steps=INFER_STEPS,
                                             draws=INFER_DRAWS)
    replays = benchmark.graph_replays() - before
    torch.cuda.empty_cache()
    percall = benchmark.percall_throughput(net, x, steps=INFER_STEPS,
                                           draws=INFER_DRAWS)
    b1 = benchmark.compiled_throughput(net, x[0:1], steps=B1_STEPS,
                                       draws=B1_DRAWS)
    torch.cuda.empty_cache()
    rec = {
        "phase": "gluon_infer", "device": dev["name"],
        "nvidia_smi": dev["smi"], "net": "resnet50_v1",
        "batch": GLUON_BATCH, "dtype": "bfloat16", "steps": INFER_STEPS,
        "draws": INFER_DRAWS,
        "compiled_img_per_s": compiled, "percall_img_per_s": percall,
        "latency_b1": {"img_per_s": b1, "ms": 1e3 / b1["median"],
                       "steps": B1_STEPS, "draws": B1_DRAWS},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "graph_vs_eager_max_abs_err": err, "eager_max_abs": scale,
        "graph_vs_eager_bitwise": bitwise, "one_replay_per_draw":
        one_replay, "probe_leaves_input": carry_is_x,
        "replays_in_compiled_throughput": replays,
        "seconds": time.perf_counter() - t0,
    }
    _emit(rec)
    _check(bitwise, "gluon_infer: graph vs eager chain differ, max abs "
           "err %g of %g" % (err, scale))
    _check(one_replay, "gluon_infer: a draw launched %d replays"
           % (benchmark.graph_replays() - before))
    # one replay when the loop is built (the first, uncounted draw) and
    # one per timed draw
    _check(replays == INFER_DRAWS + 1,
           "gluon_infer: %d replays for %d draws" % (replays, INFER_DRAWS))
    _check(carry_is_x, "gluon_infer: the probe changed the input")
    return percall["median"]


def _serving_mlp(mx, ctx, seed=0):
    """bench.py's serving MLP (64 -> 256 -> relu -> 8) and its params,
    made from ``seed`` as bench.py makes them, and its 16 request rows."""
    import numpy as np

    rng = np.random.RandomState(seed)
    data = mx.sym.var("data")
    w1, b1 = mx.sym.var("fc1_weight"), mx.sym.var("fc1_bias")
    w2, b2 = mx.sym.var("fc2_weight"), mx.sym.var("fc2_bias")
    h = mx.sym.Activation(
        mx.sym.FullyConnected(data, w1, b1, num_hidden=SERVE_D_H,
                              name="fc1"), act_type="relu")
    sym = mx.sym.FullyConnected(h, w2, b2, num_hidden=8, name="fc2")
    params = {
        "arg:fc1_weight": mx.nd.array(
            (rng.rand(SERVE_D_H, SERVE_D_IN) * 0.1).astype(np.float32),
            ctx=ctx),
        "arg:fc1_bias": mx.nd.zeros((SERVE_D_H,), ctx=ctx),
        "arg:fc2_weight": mx.nd.array(
            (rng.rand(8, SERVE_D_H) * 0.1).astype(np.float32), ctx=ctx),
        "arg:fc2_bias": mx.nd.zeros((8,), ctx=ctx),
    }
    xs = [rng.rand(1, SERVE_D_IN).astype(np.float32) for _ in range(16)]
    return sym, params, xs


def phase_serving_front(dev):
    """bench.py's serving leg (see SERVE_*): the bare Predictor against
    ModelServer on the card, the burst, then a two-replica chaos run."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import chaos, serving, telemetry
    from mxnet_tpu_torch.predict import Predictor

    t0 = time.perf_counter()
    ctx = mx.gpu(0)
    sym, params, xs = _serving_mlp(mx, ctx)
    shapes = {"data": (1, SERVE_D_IN)}

    def pctl(lat_s, q):
        return float(np.percentile(np.asarray(lat_s), q)) * 1e3

    bare = Predictor(sym, dict(params), ctx=ctx, input_shapes=shapes)
    want = [bare.forward(data=mx.nd.array(x, ctx=ctx))[0].asnumpy()
            for x in xs]
    bare_lat = []
    for i in range(SERVE_REQUESTS):
        t1 = time.perf_counter()
        bare.forward(data=mx.nd.array(xs[i % len(xs)], ctx=ctx))[0] \
            .asnumpy()
        bare_lat.append(time.perf_counter() - t1)
    rec = {"phase": "serving_front", "device": dev["name"],
           "nvidia_smi": dev["smi"], "requests": SERVE_REQUESTS,
           "max_queue": SERVE_QUEUE, "bare_p50_ms": pctl(bare_lat, 50),
           "bare_p99_ms": pctl(bare_lat, 99)}
    # bit-for-bit against the bare Predictor at the batch's own padded
    # shape (a Predictor reshaped to it, over the same parameters)
    refs = {1: bare}

    def same_as_bare(fut, got):
        job = fut.job
        p = refs.get(job.padded_rows)
        if p is None:
            p = refs[job.padded_rows] = bare.reshape(
                {"data": (job.padded_rows, SERVE_D_IN)})
        off = job.offsets[job.requests.index(fut)]
        ref = p.forward(data=mx.nd.array(job.feed["data"], ctx=ctx))[0] \
            .asnumpy()[off:off + fut.rows]
        return np.array_equal(got[0], ref)

    hist = telemetry.registry().histogram("serving.latency_ms")
    srv = serving.ModelServer(sym, dict(params), input_shapes=shapes,
                              ctx=ctx, max_queue=SERVE_QUEUE, max_batch=8,
                              max_wait_ms=0, deadline_ms=30_000)
    mismatched, untyped = 0, 0
    try:
        for x in xs:
            srv.submit({"data": x})  # settle the EWMA + caches
        hist.reset()
        for i in range(SERVE_REQUESTS):
            got = srv.submit({"data": xs[i % len(xs)]})
            mismatched += not np.array_equal(got[0], want[i % len(xs)])
        hs = hist.snapshot()
        rec.update(served_p50_ms=hs["p50"], served_p99_ms=hs["p99"],
                   served_count=hs["count"])
        rec["overhead_p99_pct"] = (hs["p99"] / max(rec["bare_p99_ms"],
                                                   1e-9) - 1.0) * 100.0
        # the burst at 4x the admission cap: shedding, not collapse
        hist.reset()
        futs, shed = [], 0
        offered = 4 * SERVE_QUEUE
        for i in range(offered):
            try:
                futs.append(srv.submit_async({"data": xs[i % len(xs)]},
                                             deadline_ms=30_000))
            except serving.Overloaded:
                shed += 1
        for f in futs:
            try:
                got = f.result(timeout=60)
            except serving.ServingError:
                continue
            except Exception:                 # noqa: BLE001 — counted
                untyped += 1
                continue
            mismatched += not same_as_bare(f, got)
        snap = srv.snapshot()
        rec.update(burst_offered=offered, shed=shed,
                   shed_rate=shed / offered,
                   burst_p99_ms=hist.snapshot()["p99"] or 0.0,
                   queue_depth_peak=snap["queue_depth_peak"],
                   batches={k: snap[k] for k in ("batches_full",
                                                 "batches_timer",
                                                 "batches_deadline")})
    finally:
        drained = srv.drain(timeout=30)
    pending = len(srv._pending) + len(srv._jobs)
    rec.update(mismatched_vs_bare=mismatched, untyped=untyped,
               drained=drained, pending_after_drain=pending,
               state_after_drain=srv.state)

    # two replicas under chaos: crashes fail over, stragglers are hedged
    srv = serving.ModelServer(sym, dict(params), input_shapes=shapes,
                              ctx=ctx, num_replicas=2,
                              max_queue=SERVE_QUEUE, max_batch=8,
                              max_wait_ms=1, deadline_ms=30_000,
                              hedge_ms=SERVE_HEDGE_MS,
                              breaker_threshold=2, breaker_backoff=0.05,
                              breaker_backoff_cap=0.1)
    outcomes = []
    try:
        with chaos.inject(SERVE_CHAOS_SPEC, seed=11) as plan:
            futs = []
            for wave in range(SERVE_CHAOS_REQUESTS // 4):
                for j in range(4):
                    x = xs[(4 * wave + j) % len(xs)]
                    try:
                        futs.append(srv.submit_async({"data": x}))
                    except serving.ServingError as e:
                        outcomes.append(type(e).__name__)
                time.sleep(0.01)
            for f in futs:
                try:
                    f.result(timeout=60)
                    outcomes.append("ok")
                except serving.ServingError as e:
                    outcomes.append(type(e).__name__)
                except Exception as e:        # noqa: BLE001 — counted
                    outcomes.append("untyped:" + type(e).__name__)
            fired = plan.pending() == []
        snap = srv.snapshot()
    finally:
        srv.drain(timeout=30)
    rec["chaos"] = {
        "spec": SERVE_CHAOS_SPEC, "outcomes": {
            k: outcomes.count(k) for k in sorted(set(outcomes))},
        "all_fired": fired, "failovers": snap["failovers"],
        "hedges_fired": snap["hedges_fired"],
        "hedge_wins": snap["hedge_wins"],
        "breaker_trips": sum(r["trips"] for r in snap["replicas"])}
    rec["seconds"] = time.perf_counter() - t0
    _emit(rec)
    _check(mismatched == 0, "serving_front: %d served outputs differ from "
           "the bare Predictor's" % mismatched)
    _check(untyped == 0, "serving_front: %d untyped outcomes" % untyped)
    _check(rec["queue_depth_peak"] <= SERVE_QUEUE,
           "serving_front: queue depth %d > %d"
           % (rec["queue_depth_peak"], SERVE_QUEUE))
    _check(drained and pending == 0 and rec["state_after_drain"] ==
           serving.STOPPED, "serving_front: after drain %d pending, "
           "state %s" % (pending, rec["state_after_drain"]))
    _check(len(outcomes) == SERVE_CHAOS_REQUESTS
           and not any(o.startswith("untyped") for o in outcomes),
           "serving_front: chaos outcomes %s" % rec["chaos"]["outcomes"])
    _check(snap["failovers"] > 0 and snap["hedges_fired"] > 0 and fired,
           "serving_front: chaos run %s" % rec["chaos"])


def _train_digest(trainer):
    """CRC32 over every Parameter (BatchNorm statistics included) and every
    optimizer-state buffer (momenta, f32 masters) of ``trainer``."""
    from mxnet_tpu_torch import sentinel

    states = []

    def flat(s):
        if isinstance(s, (tuple, list)):
            for t in s:
                flat(t)
        elif s is not None:
            states.append(s)

    for i in sorted(trainer._updaters[0].states):
        flat(trainer._updaters[0].states[i])
    return (sentinel.params_digest(trainer._params),
            sentinel.params_digest(states))


def phase_sentinel(dev, gluon):
    """bench.py's sentinel leg (see SENTINEL_*) and the guard's gates:
    containment of a nan_grad step, a finite guarded step bitwise the
    unguarded one, and flip_param_bit."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import chaos, sentinel
    from mxnet_tpu_torch.gluon.contrib import FusedTrainStep

    t0 = time.perf_counter()
    step, x, y = gluon["step"], gluon["x"], gluon["y"]
    trainer = gluon["trainer"]
    guard = FusedTrainStep(gluon["net"], gluon["loss_fn"], trainer,
                           numeric_guard="skip")
    for _ in range(GLUON_WARM):
        loss = guard(x, y)
    loss.asnumpy()
    guard_img_s, ratios = 0.0, []
    for _ in range(SENTINEL_PAIRS):
        dts = {}
        for tag, s in (("base", step), ("guard", guard)):
            t1 = time.perf_counter()
            for _ in range(SENTINEL_WIN):
                loss = s(x, y)
            loss.asnumpy()
            dts[tag] = time.perf_counter() - t1
        guard_img_s = max(guard_img_s, GLUON_BATCH * SENTINEL_WIN
                          / dts["guard"])
        ratios.append(dts["guard"] / dts["base"] - 1.0)
    guard.check_health()
    overhead = statistics.median(ratios)
    # each step's host time from an idle card (the call returns when its
    # last launch is queued): where the guard's cost lies
    host_ms = {}
    for tag, s in (("base", step), ("guard", guard)):
        ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            s(x, y)
            ms.append((time.perf_counter() - t1) * 1e3)
        host_ms[tag] = statistics.median(ms)
    torch.cuda.synchronize()
    guard.check_health()

    # containment: the nan_grad step leaves every buffer bitwise unchanged
    k = guard._step_idx
    before = _train_digest(trainer)
    with chaos.inject("nan_grad@%d" % k, seed=7) as plan:
        bad_loss = guard(x, y)
        guard.check_health()
    after = _train_digest(trainer)
    event = guard._sentinel.events[-1] if guard._sentinel.events else None
    later = [float(np.asarray(guard(x, y).asnumpy(), np.float32).mean())
             for _ in range(2)]
    guard.check_health()
    finite_after = bool(np.isfinite(later).all()) and all(
        bool(torch.isfinite(p.data().data.float()).all())
        for p in trainer._params)

    # a finite guarded step is bitwise the unguarded one from one state
    # (cuDNN's deterministic algorithms, so that two runs can agree)
    ring = sentinel.RollbackRing(1, trainer._params, trainer._updaters)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        digests = {}
        for tag, s in (("base", step), ("base_again", step),
                       ("guard", guard)):
            ring.snapshot(0)
            s(x, y).asnumpy()
            guard.check_health()
            digests[tag] = _train_digest(trainer)
            ring.restore()
    finally:
        torch.backends.cudnn.deterministic = det

    # flip_param_bit flips one bit of one element (of the f32 Parameters:
    # a bf16 one is left alone, as the JAX package leaves it)
    f32 = [p for p in trainer._params if p.grad_req != "null"
           and p.data().dtype == np.float32]
    host = {p.name: p.data().asnumpy().copy() for p in f32}
    with chaos.inject("bitflip_param@0", seed=3):
        flipped = chaos.flip_param_bit(0, f32)
    changed = {}
    for p in f32:
        a = host[p.name].reshape(-1).view(np.uint32)
        b = p.data().asnumpy().reshape(-1).view(np.uint32)
        d = np.flatnonzero(a != b)
        if d.size:
            changed[p.name] = [int(d.size),
                               bin(int(a[d[0]] ^ b[d[0]])).count("1")]
    for p in f32:                                  # undo the flip
        p.data()[:] = host[p.name]
    rec = {
        "phase": "sentinel", "device": dev["name"],
        "nvidia_smi": dev["smi"], "net": "resnet50_v1",
        "batch": GLUON_BATCH, "window": SENTINEL_WIN,
        "pairs": SENTINEL_PAIRS, "overhead_pct": overhead * 100.0,
        "pair_overheads_pct": [r * 100.0 for r in ratios],
        "guard_img_per_s": guard_img_s, "host_ms_from_idle": host_ms,
        "nan_grad_step": k, "fired": plan.pending() == [],
        "event": list(event[:2]) if event else None,
        "bad_step_loss_finite": bool(np.isfinite(np.asarray(
            bad_loss.asnumpy(), np.float32)).all()),
        "digest_unchanged": before == after, "later_losses": later,
        "finite_after": finite_after,
        "digests": {k2: ["%08x" % d for d in v]
                    for k2, v in digests.items()},
        "guard_bitwise_unguarded": digests["guard"] == digests["base"],
        "base_deterministic": digests["base_again"] == digests["base"],
        "flipped": flipped, "changed": changed,
        "seconds": time.perf_counter() - t0,
    }
    _emit(rec)
    _check(rec["fired"] and before == after,
           "sentinel: the nan_grad step changed the state %s -> %s"
           % (before, after))
    _check(event is not None and event[:2] == (k, "skip"),
           "sentinel: events %s" % guard._sentinel.events)
    _check(finite_after, "sentinel: non-finite after the skipped step")
    _check(rec["base_deterministic"], "sentinel: two unguarded steps from "
           "one state differ: %s" % rec["digests"])
    _check(rec["guard_bitwise_unguarded"], "sentinel: the guarded finite "
           "step differs from the unguarded one: %s" % rec["digests"])
    _check(flipped is not None and list(changed) == [flipped]
           and changed[flipped] == [1, 1],
           "sentinel: flip_param_bit flipped %s, changed %s"
           % (flipped, changed))
    return guard


def _profile_window(name, fn):
    """Trace ``fn`` (after one warm call) with ``torch.profiler``; print
    the wall time, the device busy time and share, and the kernels that
    took most."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()                                             # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    kern.sort(key=lambda e: -e.self_device_time_total)
    _emit({"phase": "profile", "window": name, "wall_ms": wall_ms,
           "device_busy_ms": busy_ms if kern else "not measured",
           "device_busy_share": busy_ms / wall_ms if kern
           else "not measured",
           "top_kernels": [
               {"name": e.key[:96], "ms": e.self_device_time_total / 1e3,
                "calls": e.count,
                "share_of_busy": e.self_device_time_total / 1e3 / busy_ms}
               for e in kern[:12]]})


def _profile_guard_windows(gluon, guard):
    """``--profile``: one Gluon FusedTrainStep at the gluon_train settings,
    unguarded and under ``numeric_guard="skip"``."""
    x, y = gluon["x"], gluon["y"]
    _profile_window("resnet50_gluon_fused_train_step_b%d_bf16"
                    % GLUON_BATCH, lambda: gluon["step"](x, y))
    _profile_window("resnet50_gluon_guarded_train_step_b%d_bf16"
                    % GLUON_BATCH, lambda: guard(x, y))
    guard.check_health()


def phase_profile_train(states):
    """``--profile`` only: one training step of each configuration."""
    for name, st in states.items():
        _profile_window("train_step_" + name, lambda st=st: st["step"](
            st["params"], st["velocity"], st["x"], st["y"]))


def phase_profile(model):
    """``--profile`` only: where the device time of the serving path goes.

    A second engine over the same model holds the 7 prompts of the serve
    phase; ``torch.profiler`` then traces one prefill of the ~4000-token
    prompt and 8 decode iterations over the 7 sequences (lengths unchanged,
    so each iteration does the same work).  Prints, per window, the wall
    time, the device busy time and share, and the kernels that took most."""
    import types

    import numpy as np
    from mxnet_tpu_torch import GenerationConfig, GenerationEngine

    eng = GenerationEngine(model, GenerationConfig(
        page_size=16, max_pages=1024, max_slots=8, slot_buckets="8"),
        device="cuda")
    rng = np.random.default_rng(1)
    seqs = []
    for n in PROMPT_LENS:
        need = -(-n // eng.page_size) + 1
        table = np.zeros(eng.pages_per_seq, np.int64)
        table[:need] = eng.allocator.alloc(need)
        prompt = rng.integers(0, FLAGSHIP["vocab_size"], n)
        logits = eng.prefill(prompt, table)
        seqs.append(types.SimpleNamespace(
            prompt=prompt, table=table, length=n,
            last_token=int(np.argmax(logits))))
    windows = {
        "prefill_%d" % PROMPT_LENS[-1]:
            lambda: eng.prefill(seqs[-1].prompt, seqs[-1].table),
        "decode_8_iterations_%d_slots" % len(seqs):
            lambda: [eng.decode(seqs) for _ in range(8)],
    }
    for name, fn in windows.items():
        _profile_window(name, fn)


def phase_profile_word_lm(lm):
    """``--profile`` only: one word_lm step (forward_backward and update)
    at its batch, and the same step with the example's per-step
    ``update_metric`` (Perplexity's host copy of the softmax)."""
    mod, batch, metric = lm["module"], lm["batch"], lm["metric"]

    def step():
        mod.forward_backward(batch)
        mod.update()

    def step_and_metric():
        step()
        mod.update_metric(metric, batch.label)

    _profile_window("word_lm_step_b%d_t%d" % (LM_BATCH, LM_BPTT), step)
    _profile_window("word_lm_step_and_perplexity", step_and_metric)


def phase_profile_module(trained):
    """``--profile`` only: one ResNet-50 training step (forward_backward
    and update) of the module_train phase's Module at batch 32: where the
    device time goes, and how much of the step the node-by-node executor
    leaves the device idle."""
    import mxnet_tpu_torch as mx

    mod = trained["module"]
    ctx = mx.gpu(0)
    batch = mx.io.DataBatch(
        [mx.nd.array(trained["images"][:MODULE_BATCH], ctx=ctx)],
        [mx.nd.array(trained["labels"][:MODULE_BATCH], ctx=ctx)])

    def step():
        mod.forward_backward(batch)
        mod.update()

    _profile_window("resnet50_module_train_step_b%d" % MODULE_BATCH, step)


# ---------------------------------------------------------------------------
# bench.py's remaining single-card legs: racecheck, kernels, the tenant
# leg's scale-up A/B, and the gateway (fleet workers in their own processes)
# ---------------------------------------------------------------------------
RACECHECK_OPS = 100_000              # bench.py's racecheck leg, uncut
RACECHECK_PAIRS = 5
KLEG_SHAPE = (1, 2048, 4, 64)        # bench.py's kernels leg: B, T, H, D
KLEG_STEPS = 10
KLEG_REPS = 3
KLEG_MNK = 2048
KLEG_GRAD_REL = 2.0 ** -6            # the wgmma backward vs dense autograd
SCALEUP_SEGMENTS = [{"duration_s": 3.0, "rate_rps": 2.0},
                    {"duration_s": 6.0, "rate_rps": 60.0}]
SCALEUP_KW = dict(initial_replicas=2, max_replicas=12, seed=5,
                  predict_horizon_s=4.0, predict_depth_up=6)
GATEWAY_REQUESTS = 200
GATEWAY_BURST = 64
GATEWAY_KILL_AT = GATEWAY_BURST // 4
GATEWAY_BUILDER = "mxnet_tpu_torch.fleet_worker:demo_model"
GEN_STREAMS = 8
GEN_MAX_NEW = 12
# two of the eight prompts cross the flagship's dense->flash gate
GEN_PROMPT_LENS = (16, 40, 100, 256, 384, 512, 4000, 4000)
GEN_BUILDER = "chip_smoke:flagship_generation_worker"
GEN_COUNTS_ENV = "CHIP_SMOKE_COUNTS_DIR"
WORKER_START_S = 300


def phase_racecheck():
    """bench.py's racecheck leg: a tracked counter bumped under a held
    lock, off against on in interleaved pairs; the field seeded into
    shared-modified from a second thread, so every access pays the full
    lockset intersection."""
    import threading
    from mxnet_tpu_torch import racecheck

    _check(not racecheck.installed(), "racecheck armed from the "
           "environment: the leg has no off window")

    @racecheck.track("ctr")
    class _Counter:
        def __init__(self):
            self.ctr = 0

    def window(box, lk):
        t0 = time.perf_counter()
        for _ in range(RACECHECK_OPS):
            with lk:
                box.ctr += 1
        return time.perf_counter() - t0

    rates, ratios, races = [], [], []
    for _ in range(RACECHECK_PAIRS):
        box, lk = _Counter(), threading.Lock()
        dt_off = window(box, lk)
        racecheck.install("record")
        try:
            box = _Counter()
            lk = racecheck._LockToken(threading._allocate_lock(),
                                      "chip_smoke.py:0", "Lock")

            def seed(box=box, lk=lk):
                with lk:
                    box.ctr = 0       # a second thread: leave exclusive

            t = threading.Thread(target=seed)
            t.start()
            t.join()
            dt_on = window(box, lk)
            races.append(racecheck.snapshot()["counters"]["races"])
        finally:
            racecheck.uninstall()
            racecheck.reset()
        rates.append(RACECHECK_OPS / dt_on)
        ratios.append(dt_on / dt_off - 1.0)
    restored = threading.Lock is racecheck._real_Lock
    rec = {"phase": "racecheck", "ops": RACECHECK_OPS,
           "pairs": RACECHECK_PAIRS,
           "racecheck_checked_ops_per_sec": max(rates),
           "racecheck_overhead_pct": statistics.median(ratios) * 100.0,
           "overhead_pct_pairs": [r * 100.0 for r in ratios],
           "races": races, "factories_restored": restored}
    _emit(rec)
    _check(not any(races), "racecheck reported races in a lock-disciplined "
           "loop: %s" % races)
    _check(restored, "racecheck left threading.Lock wrapped")
    return rec


def _naive_attention_loss(q, k, v):
    """Materialized-scores causal attention in f32, the kernels leg's
    yardstick: (o ** 2).sum()."""
    import torch

    T, D = q.shape[1], q.shape[3]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * D ** -0.5
    mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, -1e30), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return (o ** 2).sum()


def phase_kernels_leg(gen):
    """bench.py's kernels leg through the kernel library's front door: the
    JAX-form ``select_impl`` and ``kernel_unit``.  The flash forward +
    backward of ``(o.float() ** 2).sum()`` at [1, 2048, 4, 64] bf16 causal
    against materialized-scores attention of the same loss (tokens/s, 10
    steps x 3 reps), and the int8 matmul with per-channel dequant at 2048^3
    against a bf16 product in interleaved draws.  Returns the leg's kernel
    launches and the flash records at the leg's shape."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.dispatch import pallas_mode
    from mxnet_tpu_torch.ops.kernels import (common, flash_attention,
                                             int8_matmul, kernel_unit,
                                             select_impl)

    B, T, H, D = KLEG_SHAPE
    # the leg's shape against the plain versions, timed beside SDPA (these
    # launches are not the leg's)
    fwd = _flash_case(B, T, T, H, D, True, "bfloat16", gen)
    dq, dkv = _flash_bwd_case(B, T, T, H, D, True, "bfloat16", gen)
    qs, ks, vs = (torch.randn((B, T, H, D), generator=gen, device="cuda")
                  .to(torch.bfloat16).transpose(1, 2).requires_grad_(True)
                  for _ in range(3))
    sdpa_ms = _time_eager_ms(lambda: torch.autograd.grad(
        (F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
         .float() ** 2).sum(), (qs, ks, vs)))
    del qs, ks, vs

    mode = pallas_mode()
    attn_fn, attn_impl = select_impl("flash_attention")
    int8_fn, int8_impl = select_impl("int8_matmul")
    _check(mode == "auto" and attn_impl == "cuda" and int8_impl == "cuda"
           and attn_fn is flash_attention and int8_fn is int8_matmul,
           "front door: mode %r, flash %r, int8 %r" % (mode, attn_impl,
                                                       int8_impl))
    q, k, v = (torch.randn((B, T, H, D), generator=gen, device="cuda")
               .to(torch.bfloat16).requires_grad_(True) for _ in range(3))

    def flash_loss(q, k, v):
        o = attn_fn(q, k, v, causal=True)
        return (o.float() ** 2).sum()

    def fwd_bwd(loss_fn):
        def step(q, k, v):
            loss = loss_fn(q, k, v)
            return (loss,) + torch.autograd.grad(loss, (q, k, v))
        return step

    flash_step = kernel_unit("bench_flash_fwd_bwd", fwd_bwd(flash_loss))
    naive_step = fwd_bwd(_naive_attention_loss)

    M = N = K = KLEG_MNK
    rng = np.random.RandomState(0)
    a8 = torch.from_numpy(rng.randint(-127, 128, (M, K)).astype(
        np.int8)).cuda()
    w8 = torch.from_numpy(rng.randint(-127, 128, (N, K)).astype(
        np.int8)).cuda()
    sa = torch.tensor([0.05], device="cuda")
    sw = torch.from_numpy(rng.rand(N).astype(np.float32) * 0.1
                          + 0.01).cuda()
    int8_step = kernel_unit("bench_int8_matmul",
                            lambda a, b, s_a, s_b: int8_fn(a, b, s_a, s_b))
    a16 = (a8.float() * sa).to(torch.bfloat16)
    w16 = (w8.float() * sw[:, None]).to(torch.bfloat16)

    def bf16_step(a, b):
        return torch.matmul(a, b.t()).float()

    def tput(fn):
        out = fn(q, k, v)                    # warm, outside the timing
        torch.cuda.synchronize()
        best = 0.0
        for _ in range(KLEG_REPS):
            t0 = time.perf_counter()
            for _ in range(KLEG_STEPS):
                fn(q, k, v)
            torch.cuda.synchronize()
            best = max(best, B * T * KLEG_STEPS
                       / (time.perf_counter() - t0))
        return best, out

    # -- the leg: counters zeroed just before, read just after ----------
    common.reset_counts()
    flash_tps, flash_out = tput(flash_step)
    int8_step(a8, w8, sa, sw)
    bf16_step(a16, w16)
    torch.cuda.synchronize()
    best_i = best_b = 0.0
    for _ in range(KLEG_REPS):
        t0 = time.perf_counter()
        for _ in range(KLEG_STEPS):
            int8_step(a8, w8, sa, sw)
        torch.cuda.synchronize()
        best_i = max(best_i, KLEG_STEPS / (time.perf_counter() - t0))
        t0 = time.perf_counter()
        for _ in range(KLEG_STEPS):
            bf16_step(a16, w16)
        torch.cuda.synchronize()
        best_b = max(best_b, KLEG_STEPS / (time.perf_counter() - t0))
    selects = common.selection_counts()
    launches = common.launch_counts()
    naive_tps, naive_out = tput(naive_step)

    # the flash gradients against the plain version's and dense autograd
    with _plain_versions():
        plain_out = flash_step(q, k, v)
    torch.cuda.synchronize()
    grad_rel = {}
    for name, got, plain, naive in zip(("dq", "dk", "dv"), flash_out[1:],
                                       plain_out[1:], naive_out[1:]):
        for ref_name, ref in (("plain", plain), ("dense_autograd", naive)):
            grad_rel["%s_vs_%s" % (name, ref_name)] = float(
                (got.float() - ref.float()).abs().max()
                / ref.float().abs().max())
    finite = all(bool(torch.isfinite(g).all()) for g in flash_out)
    loss_rel = abs(float(flash_out[0].detach()) - float(plain_out[0].detach())) \
        / abs(float(plain_out[0].detach()))
    calls = 1 + KLEG_REPS * KLEG_STEPS
    want = {"kernels.launch.flash_attention": calls,
            "kernels.launch.flash_attention.wgmma": calls,
            "kernels.launch.flash_attention_dq": calls,
            "kernels.launch.flash_attention_dq.wgmma": calls,
            "kernels.launch.flash_attention_dkv": calls,
            "kernels.launch.flash_attention_dkv.wgmma": calls,
            "kernels.launch.int8_matmul_dequant": calls,
            "kernels.launch.int8_matmul_dequant.wgmma": calls}
    got_launches = {k: launches.get(k, 0) for k in want}
    gflop = 2.0 * M * N * K / 1e9
    rec = {
        "phase": "kernels_leg", "pallas_mode": mode,
        "kernels_flash_impl": attn_impl, "kernels_int8_impl": int8_impl,
        "shape": list(KLEG_SHAPE), "steps": KLEG_STEPS, "reps": KLEG_REPS,
        "kernels_flash_fwd_bwd_tokens_per_sec": flash_tps,
        "kernels_naive_fwd_bwd_tokens_per_sec": naive_tps,
        "kernels_flash_vs_naive": flash_tps / naive_tps,
        "kernels_int8_matmul_gflops_per_sec": best_i * gflop,
        "kernels_bf16_matmul_gflops_per_sec": best_b * gflop,
        "kernels_int8_matmul_vs_bf16": best_i / best_b,
        "flash_fwd_ms": fwd["ms"], "flash_dq_ms": dq["ms"],
        "flash_dkv_ms": dkv["ms"],
        "flash_fwd_bound_ms": fwd["bound_ms"],
        "flash_dq_bound_ms": dq["bound_ms"],
        "flash_dkv_bound_ms": dkv["bound_ms"],
        "flash_plain_fwd_ms": fwd["plain_ms"],
        "flash_plain_bwd_ms": dq["plain_ms"],
        "sdpa_fwd_ms": fwd["library_ms"], "sdpa_fwd_bwd_ms": sdpa_ms,
        "grad_rel_to_max": grad_rel, "grad_rel_tol": KLEG_GRAD_REL,
        "loss_rel_vs_plain": loss_rel,
        "unit_signatures": flash_step.tracker.signatures,
        "selection_counts": selects, "launch_counts": launches}
    _emit(rec)
    _check(got_launches == want, "kernels leg launches %s, expected %s"
           % (got_launches, want))
    _check(not any(k.endswith(".reference") for k in selects),
           "kernels leg: a plain version ran: %s" % selects)
    _check(finite and max(grad_rel.values()) <= KLEG_GRAD_REL
           and loss_rel <= 2 ** -7,
           "kernels leg: flash gradients off the plain version / dense "
           "autograd: %s, loss %g" % (grad_rel, loss_rel))
    return launches, {"flash_attention.kleg": fwd,
                      "flash_attention_dq.kleg": dq,
                      "flash_attention_dkv.kleg": dkv}


def phase_tenant_scaleup():
    """bench.py's tenant leg, its scale-up half: SimFleet (the real
    supervisor, gateway policy, brownout and governor in simulated time)
    on the seed-33 burst trace, reactive then predictive, each run twice."""
    from mxnet_tpu_torch import loadgen, serving, simfleet, tenancy

    burst = loadgen.generate_trace(loadgen.TraceSpec(
        seed=33, segments=SCALEUP_SEGMENTS))

    def lags(predict):
        tenancy.reset_governor(tenancy.TenantGovernor(quotas={}))
        serving.brownout().reset()
        try:
            with simfleet.SimFleet(burst, predict=predict,
                                   **SCALEUP_KW) as fleet:
                res = fleet.run()
        finally:
            tenancy.reset_governor()
            serving.brownout().reset()
        return res["supervisor"]["scaleup_lags_ms"], res["outcomes"]

    t0 = time.perf_counter()
    (r_lags, r_out), (p_lags, p_out) = lags(False), lags(True)
    wall = time.perf_counter() - t0
    (r2, _), (p2, _) = lags(False), lags(True)
    rec = {"phase": "tenant_scaleup", "requests": len(burst),
           "tenant_scaleup_lag_reactive_ms":
               sum(r_lags) / len(r_lags) if r_lags else None,
           "tenant_scaleup_lag_predictive_ms":
               sum(p_lags) / len(p_lags) if p_lags else None,
           "tenant_scaleups_reactive": len(r_lags),
           "tenant_scaleups_predictive": len(p_lags),
           "lags_reactive_ms": r_lags, "lags_predictive_ms": p_lags,
           "outcomes_reactive": r_out, "outcomes_predictive": p_out,
           "host_wall_s_of_both": wall,
           "repeat_identical": r2 == r_lags and p2 == p_lags}
    _emit(rec)
    _check(rec["repeat_identical"], "SimFleet lags differ across two runs: "
           "%s / %s, %s / %s" % (r_lags, r2, p_lags, p2))
    _check(r_lags and p_lags, "no scale-up in the A/B")
    return rec


def flagship_generation_worker(device="cuda"):
    """The ``--builder`` of the gateway phase's generation workers (called
    with no argument: on the card): the flagship TransformerLM (seeded
    random bf16 weights) behind the serve phase's GenerationServer
    configuration, warmed.  The kernel counters are zeroed once the server
    is warm, and written to a file in ``$CHIP_SMOKE_COUNTS_DIR`` when the
    worker process exits (its rc-76 drain), so the parent can read what
    the served streams launched."""
    import atexit
    import os
    import torch
    from mxnet_tpu_torch import (GenerationConfig, GenerationServer,
                                 TransformerConfig, TransformerLM)
    from mxnet_tpu_torch.ops.kernels import common

    gen = torch.Generator(device=device).manual_seed(0)
    model = TransformerLM(TransformerConfig(**FLAGSHIP), device=device,
                          generator=gen)
    srv = GenerationServer(model, GenerationConfig(
        page_size=16, max_pages=1024, max_slots=8, max_new_tokens=MAX_NEW,
        slot_buckets="8", temperature=0.0, top_k=0, seed=0), device=device)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    common.reset_counts()
    out_dir = os.environ.get(GEN_COUNTS_ENV)

    def dump():
        if out_dir:
            with open(os.path.join(out_dir, "%d.json" % os.getpid()),
                      "w") as f:
                json.dump({"launches": common.launch_counts(),
                           "selects": common.selection_counts()}, f)

    atexit.register(dump)
    return srv


def _http_predict(addr, obj, timeout=90):
    import http.client

    host, _, port = addr.rpartition(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    try:
        conn.request("POST", "/v1/predict", body=json.dumps(obj).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read() or b"{}")
        return "ok" if resp.status == 200 else body.get(
            "error", "UNTYPED:HTTP%d" % resp.status)
    except OSError as e:
        return "UNTYPED:%s" % type(e).__name__
    finally:
        conn.close()


def _http_stream(addr, prompt, max_new, timeout=300, on_token=None):
    """One streamed generation through the gateway: (outcome, tokens,
    resumed), ``resumed`` the number of times the gateway resumed it on a
    sibling (its terminal line's ``resumed``).  ``on_token`` is called
    after each streamed token."""
    import http.client

    host, _, port = addr.rpartition(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    toks, outcome, resumed = [], "UNTYPED:TruncatedStream", 0
    try:
        conn.request("POST", "/v1/generate", body=json.dumps(
            {"prompt": [int(t) for t in prompt], "max_new_tokens": max_new,
             "deadline_ms": 120000}).encode(),
            headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            return "UNTYPED:HTTP%d" % resp.status, toks, resumed
        while True:
            raw = resp.readline()
            if not raw:
                break
            line = json.loads(raw)
            if "token" in line:
                toks.append(line["token"])
                if on_token is not None:
                    on_token()
            elif "done" in line:
                outcome = "ok"
                resumed = int(line.get("resumed", 0))
                break
            elif "error" in line:
                outcome = line["error"]
                break
    except OSError as e:
        outcome = "UNTYPED:%s" % type(e).__name__
    finally:
        conn.close()
    return outcome, toks, resumed


def _worker_fleet(service, builder, env, reg):
    """Two ``python -m mxnet_tpu_torch.fleet_worker`` processes (started
    by subprocess: fork and exec, no CUDA context inherited) and a gateway
    that sees both."""
    from mxnet_tpu_torch.fleet import WorkerSupervisor
    from mxnet_tpu_torch.gateway import Gateway

    sup = WorkerSupervisor(
        {rid: [sys.executable, "-m", "mxnet_tpu_torch.fleet_worker",
               "--registry", reg.addr, "--service", service, "--rid", rid,
               "--heartbeat-s", "0.1", "--builder", builder]
         for rid in ("w0", "w1")},
        registry=reg, service=service, max_restarts=3, backoff=0.05,
        poll_s=0.05, env=env)
    gw = Gateway(registry=reg, service=service, refresh_s=0.1,
                 suspect_s=0.5, retries=2)
    try:
        sup.wait_registered(2, timeout=WORKER_START_S)
        _wait_for(lambda: gw._view is not None
                  and len(gw._view.replicas) >= 2, 30,
                  "the gateway to see both workers")
    except Exception:
        gw.stop()
        sup.stop(timeout=20.0)
        raise
    return sup, gw


def phase_gateway(dev):
    """bench.py's gateway leg: the direct demo-model p99; two spawned fleet
    workers serving it behind the gateway (200 sequential requests, then a
    burst of 64 clean and with a worker SIGKILLed at request 16); and the
    generation kill burst, with the two workers serving the flagship at
    full width: 8 streams, and once every stream has streamed a token, the
    worker holding the most of them SIGKILLed, so each stream it held is
    resumed on the sibling.  Returns the generation workers' summed kernel
    launches."""
    import os
    import tempfile
    import threading
    import numpy as np
    import torch
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.fleet import ServiceRegistry
    from mxnet_tpu_torch.fleet_worker import _resolve_builder

    def p99(lat_s):
        return float(np.percentile(np.asarray(lat_s), 99)) * 1e3

    x = {"inputs": {"data": [[1.0, 2.0, 3.0, 4.0]]}}
    rec = {"phase": "gateway"}
    # -- the direct ModelServer baseline (the model the workers build) ---
    direct = _resolve_builder(GATEWAY_BUILDER)()
    try:
        arr = np.asarray(x["inputs"]["data"], np.float32)
        for _ in range(8):
            direct.submit({"data": arr})
        lat = []
        for _ in range(GATEWAY_REQUESTS):
            t0 = time.perf_counter()
            direct.submit({"data": arr})
            lat.append(time.perf_counter() - t0)
        rec["gateway_direct_p99_ms"] = p99(lat)
    finally:
        _check(direct.drain(timeout=30), "direct server did not drain")
    torch.cuda.empty_cache()

    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": root + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    # -- two spawned predict workers behind the gateway -------------------
    reg = ServiceRegistry(service="smoke-gw", ttl_s=1.0)
    t_start = time.perf_counter()
    sup, gw = _worker_fleet("smoke-gw", GATEWAY_BUILDER, env, reg)
    rec["workers_up_s"] = time.perf_counter() - t_start
    try:
        for _ in range(8):
            _http_predict(gw.addr, x)
        route_ms = telemetry.registry().histogram("gateway.route_ms")
        route_ms.reset()            # the 200 sequential requests alone
        lat, outs = [], []
        for _ in range(GATEWAY_REQUESTS):
            t0 = time.perf_counter()
            outs.append(_http_predict(gw.addr, x))
            lat.append(time.perf_counter() - t0)
        rec["gateway_p99_ms"] = p99(lat)
        hs = route_ms.snapshot()
        rec["gateway_route_p99_ms"] = hs["p99"] if hs["count"] else None
        rec["sequential_outcomes"] = {o: outs.count(o) for o in set(outs)}

        def burst(kill_at=None):
            outcomes, lock = [], threading.Lock()

            def one():
                o = _http_predict(gw.addr, x)
                with lock:
                    outcomes.append(o)

            ts = [threading.Thread(target=one) for _ in range(GATEWAY_BURST)]
            for i, t in enumerate(ts):
                t.start()
                if kill_at is not None and i == kill_at:
                    sup.kill_worker()
            for t in ts:
                t.join(timeout=180)
            return {o: outcomes.count(o) for o in set(outcomes)}

        rec["burst_baseline"] = burst()
        rec["burst_killed"] = burst(GATEWAY_KILL_AT)
        rec["gateway_burst_ok_baseline"] = rec["burst_baseline"].get("ok", 0)
        rec["gateway_burst_ok_killed"] = rec["burst_killed"].get("ok", 0)
        rec["gateway_retries"] = gw.retried
        rec["gateway_worker_restarts"] = sup.restarts
    finally:
        gw.stop()
        sup.stop(timeout=30.0)
        reg.close()
    typed = ("ok", "Overloaded", "Draining", "DeadlineExceeded",
             "Unavailable")
    for key in ("sequential_outcomes", "burst_baseline", "burst_killed"):
        _check(set(rec[key]) <= set(typed), "gateway %s: untyped outcomes "
               "%s" % (key, rec[key]))
    _check(rec["sequential_outcomes"].get("ok", 0) == GATEWAY_REQUESTS,
           "gateway: not every sequential request ok: %s"
           % rec["sequential_outcomes"])

    # -- the generation kill burst, flagship workers -----------------------
    counts_dir = tempfile.mkdtemp(prefix="chip_smoke_counts_")
    reg = ServiceRegistry(service="smoke-gen", ttl_s=2.0)
    t_start = time.perf_counter()
    sup, gw = _worker_fleet("smoke-gen", GEN_BUILDER,
                            dict(env, **{GEN_COUNTS_ENV: counts_dir}), reg)
    rec["gen_workers_up_s"] = time.perf_counter() - t_start
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, FLAGSHIP["vocab_size"], n)
               for n in GEN_PROMPT_LENS[:GEN_STREAMS]]
    try:
        def gen_burst(kill=False):
            results, lock = [None] * len(prompts), threading.Lock()
            seen = [0] * len(prompts)

            def one(i):
                def tick():
                    seen[i] += 1
                r = _http_stream(gw.addr, prompts[i], GEN_MAX_NEW,
                                 on_token=tick)
                with lock:
                    results[i] = r

            ts = [threading.Thread(target=one, args=(i,))
                  for i in range(len(prompts))]
            t0 = time.perf_counter()
            for t in ts:
                t.start()
            killed = None
            if kill:
                # mid-decode by construction: every stream has a token
                # delivered (bench.py waits for one fleet-wide), and the
                # victim is the worker holding the most streams, so each
                # it held is resumed on the sibling, not retried
                _wait_for(lambda: min(seen) >= 1, 120,
                          "a streamed token on every stream")
                with gw._lock:
                    held = dict(gw._inflight)
                killed = sup.kill_worker(max(sorted(held), key=held.get))
            for t in ts:
                t.join(timeout=600)
            return results, killed, time.perf_counter() - t0

        base, _, base_s = gen_burst()
        resumed0 = gw.streams_resumed
        killed_res, killed, killed_s = gen_burst(kill=True)
        resumed = [(t, bt) for (o, t, n), (_, bt, _) in zip(killed_res, base)
                   if o == "ok" and n]
        rec.update({
            "gen_streams": len(prompts), "gen_max_new_tokens": GEN_MAX_NEW,
            "gen_prompt_lens": list(GEN_PROMPT_LENS[:GEN_STREAMS]),
            "gen_outcomes_baseline": [r[0] for r in base],
            "gen_outcomes_killed": [r[0] for r in killed_res],
            "gen_killed_worker": killed,
            "gateway_gen_ok_baseline": sum(r[0] == "ok" for r in base),
            "gateway_gen_ok_killed": sum(r[0] == "ok" for r in killed_res),
            "gateway_gen_replica_lost": sum(r[0] == "ReplicaLost"
                                            for r in killed_res),
            "gateway_streams_resumed": gw.streams_resumed - resumed0,
            "gen_resumed_ok_token_counts": [len(t) for t, _ in resumed],
            # a resume re-prefills prompt + delivered tokens, and bf16
            # prefill and decode can part at a near-tie (serve_migrate's
            # reprefill_tokens_agreeing), so token equality is reported
            # as the leading tokens agreeing with the clean run, not gated
            "gen_resumed_tokens_agreeing": [
                next((j for j, (a, b) in enumerate(zip(t, bt)) if a != b),
                     min(len(t), len(bt))) for t, bt in resumed],
            "gen_burst_s_baseline": base_s, "gen_burst_s_killed": killed_s})
        rec["gateway_kill_goodput_vs_baseline"] = (
            rec["gateway_gen_ok_killed"]
            / max(rec["gateway_gen_ok_baseline"], 1))
    finally:
        gw.stop()
        sup.stop(timeout=60.0)
        reg.close()
    launches, selects, files = {}, {}, 0
    for name in sorted(os.listdir(counts_dir)):
        with open(os.path.join(counts_dir, name)) as f:
            got = json.load(f)
        files += 1
        for dst, src in ((launches, got["launches"]),
                         (selects, got["selects"])):
            for k, v in src.items():
                dst[k] = dst.get(k, 0) + v
    rec.update({"gen_worker_count_files": files,
                "gen_worker_launch_counts": launches,
                "gen_worker_selection_counts": selects})
    _emit(rec)
    outcomes = rec["gen_outcomes_baseline"] + rec["gen_outcomes_killed"]
    _check(not any(o.startswith("UNTYPED") for o in outcomes),
           "generation burst: untyped outcomes %s" % outcomes)
    _check(set(outcomes) <= {"ok", "ReplicaLost"},
           "generation burst: outcomes %s" % outcomes)
    _check(rec["gateway_gen_ok_baseline"] == len(prompts),
           "generation baseline burst not all ok: %s"
           % rec["gen_outcomes_baseline"])
    _check(rec["gateway_streams_resumed"] >= 1 and resumed,
           "generation kill burst: no stream resumed on the sibling "
           "(%d resumes, outcomes %s)" % (rec["gateway_streams_resumed"],
                                         rec["gen_outcomes_killed"]))
    # the durable-stream contract: each position delivered exactly once
    _check(all(n == GEN_MAX_NEW for n in rec["gen_resumed_ok_token_counts"]),
           "generation kill burst: a resumed stream delivered %s tokens, "
           "not %d" % (rec["gen_resumed_ok_token_counts"], GEN_MAX_NEW))
    _check(files >= 1, "no generation worker wrote its kernel counters")
    for counter in ("fused_rmsnorm.warp", "fused_rmsnorm.block",
                    "flash_attention.wgmma"):
        _check(launches.get("kernels.launch." + counter, 0) > 0,
               "generation workers: %s never launched: %s"
               % (counter, launches))
    _check(not any(k.endswith(".reference") for k in selects),
           "generation workers: a plain version ran: %s" % selects)
    return launches


# ---------------------------------------------------------------------------
# the recurrent phases and BASELINE.json's LeNet MNIST config
# ---------------------------------------------------------------------------
def _word_lm_symbol(mx, vocab, emsize, nhid, nlayers):
    """example/rnn/word_lm.py's graph as its main() builds it (with one
    layer, bucketing.py's sym_gen), through the port's ``mx.sym``."""
    data = mx.sym.Variable("data")        # (bptt, batch)
    label = mx.sym.Variable("softmax_label")
    embed = mx.sym.Embedding(data, input_dim=vocab, output_dim=emsize,
                             name="embed")
    rnn_params = mx.sym.Variable("lstm_parameters",
                                 init=mx.init.Normal(0.05))
    state = mx.sym.Variable("lstm_state", init=mx.init.Zero())
    state_cell = mx.sym.Variable("lstm_state_cell", init=mx.init.Zero())
    rnn = mx.sym.RNN(embed, parameters=rnn_params, state=state,
                     state_cell=state_cell, state_size=nhid,
                     num_layers=nlayers, mode="lstm", name="lstm")
    pred = mx.sym.reshape(rnn, shape=(-1, nhid))
    pred = mx.sym.FullyConnected(pred, num_hidden=vocab, name="decoder")
    return mx.sym.SoftmaxOutput(pred, mx.sym.reshape(label, shape=(-1,)),
                                name="softmax")


def _lm_tokens(n, seq, seed, low=0):
    """``n`` (data, label) pairs of seeded uniform tokens, (seq, batch)
    each, the label the next token."""
    import numpy as np

    rng = np.random.default_rng(seed)
    toks = rng.integers(low, LM["vocab"], (n, seq + 1, LM_BATCH)).astype(
        np.float32)
    return [(t[:-1], t[1:]) for t in toks]


def _lm_batch(mx, ctx, x, y, key=None):
    kw = {}
    if key is not None:
        kw = dict(bucket_key=key,
                  provide_data=[mx.io.DataDesc("data", x.shape)],
                  provide_label=[mx.io.DataDesc("softmax_label", y.shape)])
    return mx.io.DataBatch([mx.nd.array(x, ctx=ctx)],
                           [mx.nd.array(y, ctx=ctx)], **kw)


def _autograd_names(tensors):
    """The type names of every autograd node reachable from ``tensors``."""
    seen, keep, names = set(), [], set()
    stack = [t.grad_fn for t in tensors if t.grad_fn is not None]
    while stack:
        fn = stack.pop()
        if fn is None or id(fn) in seen:
            continue
        seen.add(id(fn))
        keep.append(fn)                   # ids stay unique while kept
        names.add(type(fn).__name__)
        stack.extend(f for f, _ in fn.next_functions)
    return names


def _held_bytes():
    """Device bytes earlier phases still hold, their cyclic garbage
    collected first: a phase's own peak is the peak above this."""
    import gc
    import torch

    gc.collect()
    return torch.cuda.memory_allocated()


def _no_kernel_launched(phase, launches):
    _check(not any(launches.values()), "%s: a hand-written kernel launched "
           "on a path that has none: %s" % (phase, launches))


def _rnn_cudnn_case(gen, T, N, I, H, layers):
    """``ops.rnn.rnn_cudnn`` (cuDNN through PyTorch, the packed vector's
    views copied into cuDNN's buffer each call) against ``rnn_reference``
    (the plain time loop) on the card at one LSTM shape, f32 with TF32
    off: each tensor's error over its largest entry, forward and backward;
    the device ms of a forward + backward of each, of the forward alone,
    and of ``torch.nn.LSTM`` holding the same weights in its flat buffer
    (the library call: the difference is the weight copy); the autograd
    node names of the cuDNN output; the f32 bound of the fused RNN."""
    import torch
    from mxnet_tpu_torch.ops import rnn as trnn

    dev = gen.device
    size = trnn.rnn_param_size("lstm", I, H, layers, False)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    inputs = [rnd(T, N, I), rnd(size, scale=H ** -0.5),
              rnd(layers, N, H, scale=0.5), rnd(layers, N, H, scale=0.5)]
    inputs = [t.requires_grad_() for t in inputs]
    kw = dict(mode="lstm", state_size=H, num_layers=layers)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = trnn.rnn_cudnn(*inputs, **kw)
        cts = [rnd(*o.shape) for o in got]
        g_got = torch.autograd.grad(got, inputs, cts)
        ref = trnn.rnn_reference(*inputs, **kw)
        g_ref = torch.autograd.grad(ref, inputs, cts)

        def rel(a, b):
            return float((a.detach() - b.detach()).abs().max()
                         / b.detach().abs().max().clamp_min(1e-30))

        fwd = {n: rel(a, b) for n, a, b in zip(("out", "hy", "cy"), got,
                                                ref)}
        grad = {n: rel(a, b) for n, a, b in zip(
            ("data", "parameters", "state", "state_cell"), g_got, g_ref)}
        names = sorted(_autograd_names([got[0]]))
        lib = torch.nn.LSTM(I, H, layers).to(dev)
        w, b = trnn._unpack(inputs[1].detach(), "lstm", I, H, layers, False)
        with torch.no_grad():
            for layer in range(layers):
                for attr, val in zip(("weight_ih", "weight_hh", "bias_ih",
                                      "bias_hh"), (*w[layer], *b[layer])):
                    getattr(lib, "%s_l%d" % (attr, layer)).copy_(val)
        x, h0, c0 = inputs[0], inputs[2], inputs[3]
        lib_out = lib(x, (h0, c0))
        lib_diff = float((lib_out[0] - got[0]).detach().abs().max())
        lib_leaves = [x, h0, c0] + list(lib.parameters())

        def cudnn_fb():
            torch.autograd.grad(trnn.rnn_cudnn(*inputs, **kw), inputs, cts)

        def plain_fb():
            torch.autograd.grad(trnn.rnn_reference(*inputs, **kw), inputs,
                                cts)

        def lib_fb():
            out, (hy, cy) = lib(x, (h0, c0))
            torch.autograd.grad([out, hy, cy], lib_leaves, cts)

        detached = [t.detach() for t in inputs]

        def cudnn_fwd():
            with torch.no_grad():
                trnn.rnn_cudnn(*detached, **kw)

        def lib_fwd():
            with torch.no_grad():
                lib(detached[0], (detached[2], detached[3]))

        ms = _time_eager_ms(cudnn_fb, reps=10)
        plain_ms = _time_eager_ms(plain_fb, reps=3)
        library_ms = _time_eager_ms(lib_fb, reps=10)
        fwd_ms = _time_eager_ms(cudnn_fwd, reps=10)
        lib_fwd_ms = _time_eager_ms(lib_fwd, reps=10)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    flops = 0
    for layer in range(layers):
        flops += 2 * T * N * 4 * H * ((I if layer == 0 else H) + H)
    flops *= 3                       # the backward's two products per one
    nbytes = 4 * 2 * sum(t.numel() for t in inputs + list(got))
    bound_ms, bound_by = _bound(flops, nbytes, "float32")
    return {"shape": [T, N, I, H, layers], "dtype": "float32", "tf32": False,
            "fwd_rel_err": fwd, "grad_rel_err": grad,
            "fwd_ok": max(fwd.values()) <= RNN_FWD_REL,
            "grad_ok": max(grad.values()) <= RNN_GRAD_REL,
            "autograd_nodes": names, "nn_lstm_max_abs_diff": lib_diff,
            "fwd_bwd_ms": ms, "plain_fwd_bwd_ms": plain_ms,
            "library_fwd_bwd_ms": library_ms, "fwd_ms": fwd_ms,
            "library_fwd_ms": lib_fwd_ms,
            "weight_copy_ms": fwd_ms - lib_fwd_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def _f64_card_vs_cpu(mx, sym, args, x, y, optimizer_params):
    """One ``forward_backward`` and ``update`` in float64 on the card and on
    the CPU from the same parameters: gradients and updates within
    ``MODULE_CHECK_REL_F64``.  Returns ``(ok, report)``."""
    step = {where: _module_step(mx, sym, ctx, args, {}, x, y, "float64",
                                dict(optimizer_params))
            for where, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu()))}
    ok, report = True, {}
    for i, what in ((0, "grad"), (2, "update")):
        good, report[what] = _compare_tensors(step["card"][i],
                                              step["cpu"][i],
                                              MODULE_CHECK_REL_F64)
        ok = ok and good
    return ok, report


def phase_word_lm(dev):
    """example/rnn/word_lm.py's LSTM language model on the card at word_lm
    medium width (see LM_*): ms a step, tokens/s, peak memory, perplexity;
    gates: cuDNN's RNN in the backward, cuDNN against the plain loop,
    float64 card against CPU.  Returns the record with the module, a batch
    and the metric, for ``--profile``."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops.kernels import common

    t0 = time.perf_counter()
    held = _held_bytes()
    ctx = mx.gpu(0)
    sym = _word_lm_symbol(mx, **LM)
    mod = mx.mod.Module(sym, data_names=["data"],
                        label_names=["softmax_label"], context=ctx)
    mod.bind(data_shapes=[("data", (LM_BPTT, LM_BATCH))],
             label_shapes=[("softmax_label", (LM_BPTT, LM_BATCH))],
             for_training=True)
    mx.random.seed(0)
    mod.init_params(mx.init.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(LM_SGD))
    init_args = {n: v.asnumpy() for n, v in mod.get_params()[0].items()}
    tokens = _lm_tokens(LM_WARM + LM_TIMED, LM_BPTT, seed=0)
    batches = [_lm_batch(mx, ctx, x, y) for x, y in tokens]
    metric = mx.metric.Perplexity(ignore_label=None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    common.reset_counts()
    step_ms, metric_ms = [], []
    for b in batches:
        t1 = time.perf_counter()
        mod.forward_backward(b)
        mod.update()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        mod.update_metric(metric, b.label)
        step_ms.append((t2 - t1) * 1e3)
        metric_ms.append((time.perf_counter() - t2) * 1e3)
    launches = common.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    own_gb = peak_gb - held / 1e9
    tf32 = {"cudnn": torch.backends.cudnn.allow_tf32,
            "matmul": torch.backends.cuda.matmul.allow_tf32}
    ppl = metric.get()[1]
    # (i) the RNN node's backward is cuDNN's: the graph of a training
    # forward through the executor, read before its backward
    mod.forward(batches[0], is_train=True)
    names = _autograd_names(mod._exec._pending[0])
    mod.backward()
    # (ii) cuDNN against the plain loop at the phase's shapes
    case = _rnn_cudnn_case(torch.Generator(device="cuda").manual_seed(14),
                           LM_BPTT, LM_BATCH, LM["emsize"], LM["nhid"],
                           LM["nlayers"])
    # (iii) one Module step in float64, card against CPU, at full width
    t1 = time.perf_counter()
    f64_ok, f64_report = _f64_card_vs_cpu(mx, sym, init_args, *tokens[0],
                                          LM_SGD)
    f64_s = time.perf_counter() - t1
    timed = step_ms[LM_WARM:]
    med = statistics.median(timed)
    rec = {
        "phase": "word_lm", "device": dev["name"], "nvidia_smi": dev["smi"],
        "config": dict(LM, bptt=LM_BPTT, batch=LM_BATCH), "sgd": LM_SGD,
        "params": int(sum(v.size for v in init_args.values())),
        "tf32_during_steps": tf32, "warm_steps": LM_WARM,
        "step_ms": timed, "median_step_ms": med,
        "tokens_per_s": LM_BPTT * LM_BATCH * 1e3 / med,
        "metric_ms_median": statistics.median(metric_ms),
        "peak_mem_gb": peak_gb, "peak_above_start_gb": own_gb,
        "perplexity": ppl,
        "rnn_backward_nodes": sorted(n for n in names if "Rnn" in n),
        "launch_counts": launches, "cudnn_vs_plain": case,
        "float64_card_vs_cpu": {"tol": MODULE_CHECK_REL_F64, "ok": f64_ok,
                                "report": f64_report, "seconds": f64_s},
        "seconds": time.perf_counter() - t0}
    _emit(rec)
    _no_kernel_launched("word_lm", launches)
    _check("CudnnRnnBackward0" in names and not names & {
        "SigmoidBackward0", "TanhBackward0"}, "word_lm: the RNN's backward "
        "is not cuDNN's alone: %s" % sorted(names))
    _check("CudnnRnnBackward0" in case["autograd_nodes"],
           "word_lm: rnn_cudnn's graph %s" % case["autograd_nodes"])
    _check(case["fwd_ok"] and case["grad_ok"], "word_lm: cuDNN differs "
           "from the plain loop: %s %s (limits %g, %g)" % (
               case["fwd_rel_err"], case["grad_rel_err"], RNN_FWD_REL,
               RNN_GRAD_REL))
    _check(f64_ok, "word_lm: the float64 step on the card differs from "
           "the CPU's: %s" % f64_report)
    _check(np.isfinite(ppl) and ppl > 1.0, "word_lm: perplexity %s" % ppl)
    return dict(rec, module=mod, batch=batches[0], metric=metric)


def phase_bucketing(dev):
    """example/rnn/bucketing.py's sym_gen under BucketingModule on the
    card at word_lm's width (see BUCKET_*): each bucket binds once, a
    switch carries the updated parameters, and one float64 batch per
    bucket on the card matches the CPU."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops.kernels import common

    t0 = time.perf_counter()
    held = _held_bytes()
    ctx = mx.gpu(0)
    width = dict(LM, nlayers=1)

    def sym_gen(bucket_key):
        return _word_lm_symbol(mx, **width), ("data",), ("softmax_label",)

    binds = []
    bind = mx.mod.Module.bind

    def counted_bind(self, data_shapes, *a, **kw):
        binds.append(tuple(dict(data_shapes)["data"]))
        return bind(self, data_shapes, *a, **kw)

    default = max(BUCKET_KEYS)
    mod = mx.mod.BucketingModule(sym_gen, default_bucket_key=default,
                                 context=ctx)
    mx.mod.Module.bind = counted_bind
    try:
        mod.bind(data_shapes=[mx.io.DataDesc("data", (default, LM_BATCH))],
                 label_shapes=[mx.io.DataDesc("softmax_label",
                                              (default, LM_BATCH))])
        mx.random.seed(0)
        mod.init_params(mx.init.Xavier())
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params=dict(BUCKET_SGD))
        metric = mx.metric.Perplexity(ignore_label=0)
        plan = [(key, _lm_batch(mx, ctx, x, y, key=key)) for i, key in
                enumerate(BUCKET_PLAN)
                for x, y in _lm_tokens(1, key, seed=20 + i, low=1)]
        carried, step_ms, execs = [], [], {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        common.reset_counts()
        for key, b in plan:
            if key != mod._curr_bucket_key:
                before = {n: v.asnumpy()
                          for n, v in mod.get_params()[0].items()}
                mod.switch_bucket(key, b.provide_data, b.provide_label)
                after = mod.get_params()[0]
                carried.append(all(np.array_equal(after[n].asnumpy(), v)
                                   for n, v in before.items()))
            t1 = time.perf_counter()
            mod.forward_backward(b)
            mod.update()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            mod.update_metric(metric, b.label)
            execs.setdefault(key, set()).add(id(mod._curr_module._exec))
        launches = common.launch_counts()
    finally:
        mx.mod.Module.bind = bind
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    own_gb = peak_gb - held / 1e9
    ppl = metric.get()[1]
    shared = all(m._updater is mod._curr_module._updater
                 for m in mod._buckets.values())
    # one float64 batch per bucket, card against CPU, from the first
    # bucket's parameters after the run
    args = {n: v.asnumpy() for n, v in mod.get_params()[0].items()}
    t1 = time.perf_counter()
    f64 = {}
    for key in BUCKET_KEYS:
        x, y = _lm_tokens(1, key, seed=40 + key, low=1)[0]
        f64[key] = _f64_card_vs_cpu(mx, sym_gen(key)[0], args, x, y,
                                    BUCKET_SGD)
    f64_s = time.perf_counter() - t1
    rec = {
        "phase": "bucketing", "device": dev["name"],
        "nvidia_smi": dev["smi"],
        "config": dict(width, batch=LM_BATCH, buckets=list(BUCKET_KEYS)),
        "plan": list(BUCKET_PLAN), "step_ms": step_ms,
        "binds": [list(s) for s in binds], "switches": len(carried),
        "params_carried_on_switch": carried,
        "optimizer_shared": shared,
        "num_update": mod._curr_module._optimizer.num_update,
        "peak_mem_gb": peak_gb, "peak_above_start_gb": own_gb,
        "perplexity": ppl,
        "launch_counts": launches,
        "float64_card_vs_cpu": {"tol": MODULE_CHECK_REL_F64,
                                "ok": {k: v[0] for k, v in f64.items()},
                                "report": {k: v[1] for k, v in f64.items()},
                                "seconds": f64_s},
        "seconds": time.perf_counter() - t0}
    _emit(rec)
    _no_kernel_launched("bucketing", launches)
    _check(sorted(binds) == sorted((k, LM_BATCH) for k in BUCKET_KEYS)
           and all(len(v) == 1 for v in execs.values()),
           "bucketing: binds %s, executors %s" % (binds, execs))
    _check(len(carried) >= len(BUCKET_KEYS) and all(carried),
           "bucketing: a switch lost the updated parameters: %s" % carried)
    _check(shared and rec["num_update"] == len(BUCKET_PLAN),
           "bucketing: optimizer shared %s, %d updates"
           % (shared, rec["num_update"]))
    _check(all(v[0] for v in f64.values()), "bucketing: float64 card vs "
           "CPU: %s" % {k: v[1] for k, v in f64.items()})
    _check(np.isfinite(ppl), "bucketing: perplexity %s" % ppl)
    return rec


def _sort_data(n, seed):
    """bi-lstm-sort's make_data: ``n`` sequences of SORT_SEQ digits and
    the same digits sorted."""
    import numpy as np

    rng = np.random.RandomState(seed)
    x = rng.randint(0, SORT_VOCAB, (n, SORT_SEQ)).astype(np.float32)
    return x, np.sort(x, axis=1)


def _sort_net(mx):
    """bi-lstm-sort's SortNet (sort_io.py:34-47) over the port's Gluon."""
    from mxnet_tpu_torch import gluon

    class SortNet(gluon.nn.Block):
        def __init__(self, hidden=64, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.embed = gluon.nn.Embedding(SORT_VOCAB, 32)
                self.rnn = gluon.rnn.LSTM(hidden, bidirectional=True,
                                          layout="NTC")
                self.head = gluon.nn.Dense(SORT_VOCAB, flatten=False)

        def forward(self, x):
            return self.head(self.rnn(self.embed(x)))

    return SortNet()


def phase_gluon_rnn(dev):
    """bi-lstm-sort's training on the card (see SORT_*): accuracy per
    epoch, ms a step, peak memory; gates: cuDNN's RNN in the backward,
    the accuracy rising, and the LSTM layer hybridized equal to eager."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.ops.kernels import common

    t0 = time.perf_counter()
    held = _held_bytes()
    ctx = mx.gpu(0)
    X, Y = _sort_data(SORT_EXAMPLES, 0)
    Xv, Yv = _sort_data(256, 1)
    mx.random.seed(0)
    net = _sort_net(mx)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": SORT_LR})
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    batches = [(mx.nd.array(X[s:s + SORT_BATCH], ctx=ctx),
                mx.nd.array(Y[s:s + SORT_BATCH], ctx=ctx))
               for s in range(0, SORT_EXAMPLES, SORT_BATCH)]
    xv = mx.nd.array(Xv, ctx=ctx)
    accs, step_ms, names = [], [], None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    common.reset_counts()
    for _ in range(SORT_EPOCHS):
        for xb, yb in batches:
            t1 = time.perf_counter()
            with autograd.record():
                logits = net(xb)
                loss = ce(logits.reshape((-1, SORT_VOCAB)),
                          yb.reshape((-1,))).mean()
            if names is None:
                names = _autograd_names([loss.data])
            loss.backward()
            trainer.step(xb.shape[0])
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
        pred = net(xv).asnumpy().argmax(-1)
        accs.append(float((pred == Yv).mean()))
    launches = common.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    own_gb = peak_gb - held / 1e9
    exact = float((pred == Yv).all(axis=1).mean())
    # the trained LSTM layer alone, hybridized against eager, on the
    # validation embeddings with begin_state's zeros
    emb = net.embed(xv)
    eager = net.rnn(emb).asnumpy()
    net.rnn.hybridize()
    hybrid = net.rnn(emb).asnumpy()
    hybrid_err = float(np.abs(hybrid - eager).max()
                       / max(np.abs(eager).max(), 1e-30))
    med = statistics.median(step_ms[len(batches):])
    rec = {
        "phase": "gluon_rnn", "device": dev["name"],
        "nvidia_smi": dev["smi"], "net": "SortNet (bi-lstm-sort)",
        "examples": SORT_EXAMPLES, "batch": SORT_BATCH, "lr": SORT_LR,
        "epochs": SORT_EPOCHS, "accuracy_per_epoch": accs,
        "exact_sequence": exact, "median_step_ms": med,
        "examples_per_s": SORT_BATCH * 1e3 / med, "peak_mem_gb": peak_gb,
        "peak_above_start_gb": own_gb,
        "rnn_backward_nodes": sorted(n for n in names if "Rnn" in n),
        "hybrid_vs_eager_rel": hybrid_err, "launch_counts": launches,
        "seconds": time.perf_counter() - t0}
    _emit(rec)
    _no_kernel_launched("gluon_rnn", launches)
    _check("CudnnRnnBackward0" in names, "gluon_rnn: no cuDNN RNN in the "
           "backward: %s" % sorted(names))
    _check(accs[-1] > accs[0] and all(np.isfinite(accs)),
           "gluon_rnn: the accuracy did not rise: %s" % accs)
    _check(hybrid_err <= GLUON_HYBRID_REL, "gluon_rnn: hybridized LSTM "
           "%g from eager" % hybrid_err)
    return rec


def _example_symbol(mx, path, **kwargs):
    """The example's ``get_symbol`` (``path`` from the repository's root),
    its import lines dropped, run with the port as its ``mx``."""
    import ast
    import pathlib

    src = (pathlib.Path(__file__).resolve().parent / path).read_text()
    tree = ast.parse(src, path)
    tree.body = [n for n in tree.body
                 if not isinstance(n, (ast.Import, ast.ImportFrom))]
    ns = {"mx": mx}
    exec(compile(tree, path, "exec"), ns)   # noqa: S102 (the repo's file)
    return ns["get_symbol"](**kwargs)


def _mnist_data(n, seed=0):
    """common/data.py's _synthetic at train_mnist.py's shape: class-
    coloured noisy 1x28x28 images and their labels."""
    import numpy as np

    rng = np.random.RandomState(seed)
    y = rng.randint(0, 10, (n,)).astype(np.float32)
    palette = np.linspace(-1.0, 1.0, 10)
    X = rng.normal(0, 0.15, (n, 1, 28, 28)).astype(np.float32)
    X += palette[y.astype(int)][:, None, None, None]
    return X, y


def phase_mnist(dev):
    """train_mnist.py's two networks through Module.fit on the card (see
    MNIST_*): img/s, held-out accuracy after each epoch; gates: it leaves
    chance, and a float64 step on the card matches the CPU."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops.kernels import common

    ctx = mx.gpu(0)
    X, y = _mnist_data(MNIST_EXAMPLES)
    n_val = min(max(len(X) // 8, MNIST_BATCH), len(X) - MNIST_BATCH)
    recs = {}
    for network in ("mlp", "lenet"):
        t0 = time.perf_counter()
        held = _held_bytes()
        sym = _example_symbol(
            mx, "example/image-classification/symbols/%s.py" % network,
            num_classes=10)
        train = mx.io.NDArrayIter(X[n_val:], y[n_val:], MNIST_BATCH,
                                  shuffle=True)
        val = mx.io.NDArrayIter(X[:n_val], y[:n_val], MNIST_BATCH)
        ends = []

        def step_end(param):
            torch.cuda.synchronize()
            ends.append(time.perf_counter())

        accs = []

        def epoch_end(param):
            accs.append(dict(param.eval_metric.get_name_value())[
                "accuracy"])

        mx.random.seed(0)
        mod = mx.mod.Module(sym, context=ctx)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        common.reset_counts()
        mod.fit(train, eval_data=val, num_epoch=MNIST_EPOCHS,
                optimizer="sgd", optimizer_params=dict(MNIST_SGD),
                eval_metric=["accuracy"], batch_end_callback=step_end,
                eval_end_callback=epoch_end)
        launches = common.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        own_gb = peak_gb - held / 1e9
        steps = len(ends) // MNIST_EPOCHS
        step_ms = [(b - a) * 1e3 for a, b in zip(ends[:steps],
                                                  ends[1:steps])]
        med = statistics.median(step_ms)
        args = {n: v.asnumpy() for n, v in mod.get_params()[0].items()}
        f64_ok, f64_report = _f64_card_vs_cpu(
            mx, sym, args, X[:MNIST_BATCH], y[:MNIST_BATCH], MNIST_SGD)
        recs[network] = rec = {
            "phase": "mnist", "network": network, "device": dev["name"],
            "nvidia_smi": dev["smi"], "batch": MNIST_BATCH,
            "train_examples": len(X) - n_val, "epochs": MNIST_EPOCHS,
            "steps": len(ends), "median_step_ms_epoch0": med,
            "img_per_s": MNIST_BATCH * 1e3 / med, "peak_mem_gb": peak_gb,
            "peak_above_start_gb": own_gb,
            "val_accuracy_per_epoch": accs,
            "launch_counts": launches,
            "float64_card_vs_cpu": {"tol": MODULE_CHECK_REL_F64,
                                    "ok": f64_ok, "report": f64_report},
            "seconds": time.perf_counter() - t0}
        _emit(rec)
        _no_kernel_launched("mnist", launches)
        _check(max(accs) > MNIST_MIN_ACC, "mnist %s: held-out accuracy "
               "%s" % (network, accs))
        _check(f64_ok, "mnist %s: the float64 step on the card differs "
               "from the CPU's: %s" % (network, f64_report))
    return recs


_CSRC = "mxnet_tpu_torch/ops/kernels/csrc/"
# the variants of each kernel, by source
VARIANT_SOURCES = {
    "fused_rmsnorm": {"warp": _CSRC + "rmsnorm.cu",
                      "block": _CSRC + "rmsnorm.cu",
                      "simt": _CSRC + "rmsnorm.cu"},
    "flash_attention": {"wgmma": _CSRC + "flash_attention_wgmma.cu",
                        "wgmma_wide":
                            _CSRC + "flash_attention_wgmma_wide.cu",
                        "wgmma_xwide":
                            _CSRC + "flash_attention_wgmma_xwide.cu",
                        "wgmma_xxwide":
                            _CSRC + "flash_attention_wgmma_xwide.cu",
                        "tf32x3": _CSRC + "flash_attention_tf32x3.cu",
                        "tf32x3_xwide": _CSRC + "flash_attention_tf32x3.cu",
                        "simt": _CSRC + "flash_attention.cu",
                        "wide": _CSRC + "flash_attention_wide.cu"},
    "flash_attention_dq": {"wgmma": _CSRC + "flash_attention_bwd_wgmma.cu",
                           "wgmma_wide":
                               _CSRC + "flash_attention_bwd_wgmma_wide.cu",
                           "tf32x3": _CSRC + "flash_attention_bwd_tf32x3.cu",
                           "wgmma_xwide":
                               _CSRC + "flash_attention_bwd_wgmma_xwide.cu",
                           "tf32x3_xwide":
                               _CSRC + "flash_attention_bwd_tf32x3.cu",
                           "wgmma_xxwide":
                               _CSRC + "flash_attention_bwd_wgmma_xwide.cu",
                           "simt": _CSRC + "flash_attention_bwd.cu",
                           "wide": _CSRC + "flash_attention_wide.cu"},
    "flash_attention_dkv": {"wgmma": _CSRC + "flash_attention_bwd_wgmma.cu",
                            "wgmma_wide":
                                _CSRC + "flash_attention_bwd_wgmma_wide.cu",
                            "tf32x3":
                                _CSRC + "flash_attention_bwd_tf32x3.cu",
                            "wgmma_xwide":
                                _CSRC + "flash_attention_bwd_wgmma_xwide.cu",
                            "tf32x3_xwide":
                                _CSRC + "flash_attention_bwd_tf32x3.cu",
                            "wgmma_xxwide":
                                _CSRC + "flash_attention_bwd_wgmma_xwide.cu",
                            "simt": _CSRC + "flash_attention_bwd.cu",
                            "wide": _CSRC + "flash_attention_wide.cu"},
    "int8_matmul": {"wgmma": _CSRC + "int8_matmul.cu",
                    "mma": _CSRC + "int8_matmul.cu"},
    "int8_matmul_dequant": {"wgmma": _CSRC + "int8_matmul.cu",
                            "mma": _CSRC + "int8_matmul.cu"},
}


def _case_shape(rec):
    """A kernel record's shape: [N, E], q's [B, T, H, D], or [M, K, N]."""
    if "shape" in rec:
        return rec["shape"]
    return rec["q"] if "q" in rec else [rec["M"], rec["K"], rec["N"]]


def _timed_phase(name, fn, *args):
    """``fn(*args)``, then a line with the phase's wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    _emit({"phase_wall_s": {name: time.perf_counter() - t0}})
    return out


RECURRENT = (("word_lm", phase_word_lm), ("bucketing", phase_bucketing),
             ("gluon_rnn", phase_gluon_rnn), ("mnist", phase_mnist))
SERVING_PLANE = (phase_serve_qos, phase_serve_migrate, phase_serve_loadreplay,
                 phase_serve_tenant, phase_serve_ops)


def main():
    import torch

    t_start = time.perf_counter()
    dev = phase_device()
    phase_build()
    main_cases = phase_kernels()
    serve_launches, model = phase_serve(dev)
    t0 = time.perf_counter()
    plane_launches = []
    for phase in SERVING_PLANE:
        plane_launches += phase(dev, model)
    torch.cuda.empty_cache()
    plane_s = time.perf_counter() - t0
    train_launches, states = phase_train(dev)
    mesh_launches = [_timed_phase("mesh_nccl", phase_mesh_nccl, dev)]
    mesh_launches += _timed_phase(
        "multirank", phase_multirank, dev,
        torch.Generator(device="cuda").manual_seed(13))
    trained = phase_module_train(dev)
    rtc_launches, rtc_main = phase_rtc(dev, trained)
    main_cases.update(rtc_main)
    gluon = _timed_phase("gluon_train", phase_gluon_train, dev)
    bf16_img_s = _timed_phase("gluon_infer", phase_gluon_infer, dev, gluon)
    _timed_phase("serving_front", phase_serving_front, dev)
    guard = _timed_phase("sentinel", phase_sentinel, dev, gluon)
    int8_launches, int8_exes = _timed_phase("int8", phase_int8, dev,
                                            bf16_img_s)
    vgg_launches, vgg = _timed_phase("int8_vgg16", phase_int8_vgg16, dev)
    int8_launches += vgg_launches
    _timed_phase("zoo", phase_zoo, dev)
    det_launches, main_cases["greedy_nms"] = _timed_phase(
        "detection", phase_detection, dev)
    torch.cuda.empty_cache()
    phase_gluon_cifar(dev)
    phase_gluon_step_card_vs_cpu(dev)
    recurrent = {name: _timed_phase(name, phase, dev)
                 for name, phase in RECURRENT}
    _timed_phase("racecheck", phase_racecheck)
    kleg_launches, _ = _timed_phase(
        "kernels_leg", phase_kernels_leg,
        torch.Generator(device="cuda").manual_seed(12))
    _timed_phase("tenant_scaleup", phase_tenant_scaleup)
    torch.cuda.empty_cache()
    gen_launches = _timed_phase("gateway", phase_gateway, dev)
    if "--profile" in sys.argv[1:]:
        phase_profile(model)
        phase_profile_train(states)
        for name, exe in int8_exes.items():
            _profile_window("resnet50_%s_forward_b%d" % (name, INT8_BATCH),
                            lambda exe=exe: exe.forward(is_train=False))
        for name, x in (("int8", vgg["x32"]), ("bf16", vgg["x16"])):
            _profile_window("vgg16_%s_forward_b%d" % (name, VGG_BATCH),
                            lambda net=vgg[name], x=x: net(x))
        phase_profile_module(trained)
        _profile_guard_windows(gluon, guard)
        phase_profile_word_lm(recurrent["word_lm"])
    sources = {
        # the warp variant, which the prefills and training steps take;
        # decode takes block (VARIANT_SOURCES)
        "fused_rmsnorm": ("mxnet_tpu_torch/ops/kernels/csrc/rmsnorm.cu",
                          "mxnet_tpu/ops/pallas/layers.py:31"),
        # the tensor-core variant, which every main path's forward takes
        "flash_attention": (
            "mxnet_tpu_torch/ops/kernels/csrc/flash_attention_wgmma.cu",
            "mxnet_tpu/ops/pallas/flash_attention.py:55"),
        # the tensor-core variants, which the long-context step takes
        "flash_attention_dq": (
            "mxnet_tpu_torch/ops/kernels/csrc/flash_attention_bwd_wgmma.cu",
            "mxnet_tpu/ops/pallas/flash_attention.py:142"),
        "flash_attention_dkv": (
            "mxnet_tpu_torch/ops/kernels/csrc/flash_attention_bwd_wgmma.cu",
            "mxnet_tpu/ops/pallas/flash_attention.py:179"),
        # the head_dim-256 training leg's: the forward, dQ and dK/dV on the
        # tensor-core wgmma_wide kernels
        "flash_attention.wgmma_wide": (
            "mxnet_tpu_torch/ops/kernels/csrc/flash_attention_wgmma_wide.cu",
            "mxnet_tpu/ops/pallas/flash_attention.py:55"),
        "flash_attention_dq.wgmma_wide": (
            "mxnet_tpu_torch/ops/kernels/csrc/"
            "flash_attention_bwd_wgmma_wide.cu",
            "mxnet_tpu/ops/pallas/flash_attention.py:142"),
        "flash_attention_dkv.wgmma_wide": (
            "mxnet_tpu_torch/ops/kernels/csrc/"
            "flash_attention_bwd_wgmma_wide.cu",
            "mxnet_tpu/ops/pallas/flash_attention.py:179"),
        # the f32 head_dim-256 leg's: the forward, dQ and dK/dV on the
        # tensor-core tf32x3 kernels
        "flash_attention.tf32x3": (
            "mxnet_tpu_torch/ops/kernels/csrc/flash_attention_tf32x3.cu",
            "mxnet_tpu/ops/pallas/flash_attention.py:55"),
        "flash_attention_dq.tf32x3": (
            "mxnet_tpu_torch/ops/kernels/csrc/flash_attention_bwd_tf32x3.cu",
            "mxnet_tpu/ops/pallas/flash_attention.py:142"),
        "flash_attention_dkv.tf32x3": (
            "mxnet_tpu_torch/ops/kernels/csrc/flash_attention_bwd_tf32x3.cu",
            "mxnet_tpu/ops/pallas/flash_attention.py:179"),
        # the head_dim-512 leg's: the forward, dQ and dK/dV on the
        # tensor-core wgmma_xwide kernels
        "flash_attention.wgmma_xwide": (
            "mxnet_tpu_torch/ops/kernels/csrc/flash_attention_wgmma_xwide.cu",
            "mxnet_tpu/ops/pallas/flash_attention.py:55"),
        "flash_attention_dq.wgmma_xwide": (
            "mxnet_tpu_torch/ops/kernels/csrc/"
            "flash_attention_bwd_wgmma_xwide.cu",
            "mxnet_tpu/ops/pallas/flash_attention.py:142"),
        "flash_attention_dkv.wgmma_xwide": (
            "mxnet_tpu_torch/ops/kernels/csrc/"
            "flash_attention_bwd_wgmma_xwide.cu",
            "mxnet_tpu/ops/pallas/flash_attention.py:179"),
        # the f32 head_dim-512 leg's: the forward, dQ and dK/dV on the
        # tensor-core tf32x3_xwide kernels (2-CTA clusters)
        "flash_attention.tf32x3_xwide": (
            "mxnet_tpu_torch/ops/kernels/csrc/flash_attention_tf32x3.cu",
            "mxnet_tpu/ops/pallas/flash_attention.py:55"),
        "flash_attention_dq.tf32x3_xwide": (
            "mxnet_tpu_torch/ops/kernels/csrc/flash_attention_bwd_tf32x3.cu",
            "mxnet_tpu/ops/pallas/flash_attention.py:142"),
        "flash_attention_dkv.tf32x3_xwide": (
            "mxnet_tpu_torch/ops/kernels/csrc/flash_attention_bwd_tf32x3.cu",
            "mxnet_tpu/ops/pallas/flash_attention.py:179"),
        # the head_dim-1024 leg's: the forward, dQ and dK/dV on the
        # tensor-core wgmma_xxwide kernels (2-CTA clusters)
        "flash_attention.wgmma_xxwide": (
            "mxnet_tpu_torch/ops/kernels/csrc/flash_attention_wgmma_xwide.cu",
            "mxnet_tpu/ops/pallas/flash_attention.py:55"),
        "flash_attention_dq.wgmma_xxwide": (
            "mxnet_tpu_torch/ops/kernels/csrc/"
            "flash_attention_bwd_wgmma_xwide.cu",
            "mxnet_tpu/ops/pallas/flash_attention.py:142"),
        "flash_attention_dkv.wgmma_xxwide": (
            "mxnet_tpu_torch/ops/kernels/csrc/"
            "flash_attention_bwd_wgmma_xwide.cu",
            "mxnet_tpu/ops/pallas/flash_attention.py:179"),
        "fused_softmax_xent": (
            "mxnet_tpu_torch/ops/kernels/csrc/softmax_xent.cu",
            "mxnet_tpu/ops/pallas/layers.py:116"),
        "fused_softmax_xent_bwd": (
            "mxnet_tpu_torch/ops/kernels/csrc/softmax_xent.cu",
            "mxnet_tpu/ops/pallas/layers.py:151"),
        "int8_matmul": (
            "mxnet_tpu_torch/ops/kernels/csrc/int8_matmul.cu",
            "mxnet_tpu/ops/pallas/int8_matmul.py:46"),
        "int8_matmul_dequant": (
            "mxnet_tpu_torch/ops/kernels/csrc/int8_matmul.cu",
            "mxnet_tpu/ops/pallas/int8_matmul.py:54"),
        # user kernels (this script's RTC_SOFTMAX_SRC) compiled at runtime
        # by mxnet_tpu_torch/rtc.py, the counterpart of PallasKernel.launch
        "rtc.softmax_forward": ("chip_smoke.py", "mxnet_tpu/rtc.py:87"),
        "rtc.softmax_backward": ("chip_smoke.py", "mxnet_tpu/rtc.py:87"),
        # the SSD-300 decode's greedy NMS: no TPU kernel; the JAX package's
        # lax.fori_loop over every box (MultiBoxDetection's)
        "greedy_nms": ("mxnet_tpu_torch/ops/kernels/csrc/nms.cu",
                       "mxnet_tpu/ops/detection.py:292"),
    }
    runs = ([serve_launches] + plane_launches + list(train_launches.values())
            + mesh_launches + int8_launches + rtc_launches
            + [det_launches, kleg_launches, gen_launches])

    def launched(counter):
        return sum(r.get("kernels.launch.%s" % counter, 0) for r in runs)

    kernels = []
    for name, (src, replaces) in sources.items():
        rec = main_cases[name]
        counter = name
        if "." not in name and rec.get("variant") == "wgmma":
            counter += ".wgmma"
        launches = launched(counter)
        _check(launches > 0, "%s never launched on the main paths" % counter)
        entry = {
            "name": name, "route": "cuda", "source": src,
            **({"variant": rec["variant"]} if "variant" in rec else {}),
            "replaces": replaces, "launches": launches,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            **{k: rec[k] for k in ("bound_f32_cuda_core_ms",) if k in rec},
        }
        if name.startswith("int8_matmul"):      # split-K's second kernel
            entry["reduce_launches"] = launched(name + ".reduce")
        # tf32x3's forward, dQ and dK/dV at 64 and 128 (the narrow plans):
        # the f32 long-context leg's shape, beside the simt kernels they
        # replaced
        narrow = main_cases.get(name + ".narrow")
        if narrow is not None:
            entry["narrow"] = {k: narrow[k] for k in (
                "q", "padded_head_dim", "ms", "simt_ms", "max_abs_err",
                "plain_ms", "bound_ms", "bound_by", "bound_f32_cuda_core_ms",
                "library_ms")}
        # every variant of the kernel: its source, its launches on the main
        # paths and its time (the main shape's, or its own case's)
        if name in VARIANT_SOURCES:
            entry["variants"] = []
            for variant, vsrc in VARIANT_SOURCES[name].items():
                vrec = main_cases.get("%s.%s" % (name, variant), rec)
                own = vrec is not rec or variant == rec["variant"]
                entry["variants"].append({
                    "variant": variant, "source": vsrc,
                    "launches": launched("%s.%s" % (name, variant)),
                    "ms": vrec["ms"] if own else rec["%s_ms" % variant],
                    "max_abs_err": (vrec["max_abs_err"] if own else rec.get(
                        "%s_max_abs_err" % variant,
                        rec.get("variant_max_abs_err", {}).get(variant))),
                    "shape": _case_shape(vrec),
                    "dtype": vrec.get("dtype", "int8"),
                    "plain_ms": vrec["plain_ms"],
                    "library_ms": vrec["library_ms"],
                    "bound_ms": vrec["bound_ms"],
                    "bound_by": vrec["bound_by"],
                    **{k: vrec[k] for k in ("bound_f32_cuda_core_ms",)
                       if k in vrec}})
        kernels.append(entry)
    _emit({"phase": "total", "wall_s": time.perf_counter() - t_start,
           "serving_plane_s": plane_s})
    print(dev["smi"])                   # name, power limit as nvidia-smi has it
    _emit({"kernels": kernels})
    _emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                  "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    try:
        main()
    except Exception as e:          # the entry point: report, exit non-zero
        print("chip_smoke: FAILED: %s: %s" % (type(e).__name__, e),
              file=sys.stderr, flush=True)
        raise
