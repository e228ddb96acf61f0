#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``mxnet_tpu_torch``).

    python3 chip_smoke.py [--seed N]

Needs one CUDA card (NVIDIA H100), ``nvcc`` and numpy; never imports JAX
or ``mxnet_tpu``.  Phases, each printed as one JSON line:

1. device  -- card name and count, and ``nvidia-smi`` name + power limit.
2. build   -- nvcc time for ``mxnet_tpu_torch/csrc/*.cu`` (sm_90a, one
   nvcc per source, in parallel) and every kernel instance's registers,
   stack and spills from ``-Xptxas -v``.
3. kernels -- the three flash-attention kernels against their plain
   PyTorch versions on the card, over shapes x {f32, bf16} x {causal, not}
   x dropout p in {0, 0.1}, the dropout seed an int64 tensor on the card
   (the kernels read it from device memory; an int seed, a tensor and a
   seed drawn on the card give the masks they should, and a C entry point
   refuses dropout with no seed address): the forward (O, LSE) and the
   backward (dq, dk,
   dv against ``flash_attention_backward_reference``, within
   1e-4*max(1, max|ref|) in f32 and 2e-2*max(1, max|ref|) in bf16), each
   with its device time (a ``torch.cuda._sleep`` ahead of the window keeps
   the host's enqueue out of it; the forward also prints its host time a
   call), the plain version's, PyTorch's ``F.scaled_dot_product_attention``
   under the fastest backend that accepts the case (``library_backend``; a
   yardstick only, the port never calls it; for the backward its fwd+bwd
   minus its fwd) and the card's bound (f32 cases also give the bound on
   the TF32 tensor cores with the three products of 3xTF32 the kernels do:
   ``bound_3xtf32_ms`` for the forward, ``dq_bound_3xtf32_ms`` and
   ``dkv_bound_3xtf32_ms`` for the backward).  A contiguous view off a
   16-byte boundary is refused by the three kernels' wrappers and C entry
   points.
4. serve   -- full-width BERT-base (12 x 768, 12 heads, vocab 30522,
   max_length 512) in f32 with random weights from ``--seed``, served
   through ``serve.Server(...).submit()`` on the card: 32 concurrent
   requests of 64..512 tokens.  Every output is finite and shaped; the
   forward kernel's launch count is exactly 12 x the batches dispatched;
   two requests match the same model run on the CPU.
5. train   -- full-width BERT-base pretraining (``BERTForPretraining``,
   dropout 0.1 on hidden states and attention) with Adam at lr 1e-4, fp32
   with TF32 off: 10 steps of ``autograd.record()``, ``backward()`` and
   ``trainer.step(1)`` on one synthetic batch (B=8, T=512, 76 masked
   positions).  Every loss is finite and the last is below the first; the
   forward, dq and dk/dv kernels each launch exactly 12 x 10 times; one
   step's parameter gradients at B=1 with dropout off match the same model
   on the CPU within 1e-3*max(1, max|g|).
5b. ops_planes -- the operational planes around BERT-base (below), and
   after ``decode`` its part e, ``profiler_trap``.
5c. resilience -- fault handling and the SLO engine around BERT-base
   (below).
6. train_bf16 -- the JAX package's BERT recipe (``bench.py``
   ``_bench_bert``): full-width BERT-base pretraining through
   ``parallel.FusedTrainer(dtype='bfloat16')`` with Adam at lr 1e-4, B=16,
   T=512, dropout 0.1: 3 warm-up and 10 timed steps.  The three kernels
   see bf16 and launch exactly 12 x 10 times, the loss falls, the masters
   stay float32; prints tokens/s, MFU, the foreach update's device time
   against its bytes bound, a ``torch.profiler`` split of two steps with
   the device's idle share, peak memory, and three fp16 steps of a
   2-layer model.
7. train_resnet -- the JAX package's ResNet recipe (``bench.py``
   ``_bench_resnet``): full-width ResNet-50 v1 (1000 classes, 3x224x224)
   through ``parallel.FusedTrainer(dtype='bfloat16')`` with SGD at lr 0.05
   and momentum 0.9, B=128, one synthetic batch: 3 warm-up and 20 timed
   steps.  Every loss is finite and the last below the first, the
   running means and variances move and stay finite, the flash kernels
   launch 0 times; prints img/s, the step median and range, the first
   (cuDNN tuning) step, MFU from the FLOPs counted off the port's conv
   and dense shapes (7.72 GFLOP an image forward, x3 for training) against
   989 TFLOP/s, peak memory, the SGD update's device time against its
   bytes bound, a ``torch.profiler`` split of two steps (conv forward,
   conv backward, batch norm, element-wise, foreach update, the rest) with
   the idle share, the step in NCHW and in channels-last memory format,
   the fp32 recipe (TF32 off, 3 + 10 steps), and one fp32 step's
   gradients and new running statistics at B=2 against the same model on
   the CPU within 1e-3*max(1, max|g|).

8. train_captured -- the ``train`` recipe (BERT-base pretraining, fp32,
   TF32 off, dropout 0.1, Adam at lr 1e-4, B=8, T=512) through
   ``gluon.Trainer.capture`` (``mx.step``): the first step runs eagerly,
   the second captures the step into one CUDA graph and replays it, the
   rest replay it, 10 in all.  ``report()`` must show every step captured
   and no fallback; the three kernels' wrappers record 12 launches each
   into the graph and count none on a replay; two replays draw different
   attention-dropout seeds (a spy keeps each drawn seed in the graph's
   memory); the loss falls; one captured step equals one stitched grouped
   step from the same weights and generator seed within
   1e-5*max(1, max|w|) (bitwise or not is printed).  Prints the step
   median captured against stitched (timed in turns, 5 steps a turn, two
   turns each), tokens/s, peak memory and the graph's pool, a
   ``torch.profiler`` split of each with the idle share and kernels a
   step, and the grouped Adam's device and wall time against the
   per-parameter path's on one step's gradients.  The launch counts in the summary
   below include the 12 recorded at capture per kernel; each replay runs
   the recorded launches without counting them.
9. train_captured_resnet -- ``bench.py``'s captured-step recipe
   (``_bench_captured_step``): ResNet-50 v1 cast to bf16 with SGD at lr
   0.05, momentum 0.9 and f32 masters (``multi_precision``), B=64,
   through ``trainer.capture`` for 10 steps: no fallback, every step
   captured, falling loss, running statistics moved and finite, no flash
   launch; img/s and MFU (7.72 GFLOP an image forward) captured against
   stitched, timed in turns, peak memory, the profiler split and idle
   share of each, and ``PARITY_STEPS = 3`` captured steps on a fresh
   model against as many stitched ones (bitwise, worst relative
   difference).

10. nd_imperative -- ``mx.nd`` on the card.  ``BASELINE.json`` config 1,
   ``examples/mnist_mlp.py``'s MLP (784 -> 128 -> 64 -> 10, ReLU) with
   Adam at lr 1e-3, B=256, 50 steps on a fixed synthetic set (10 class
   prototypes plus noise, from numpy), every array an NDArray:
   ``nd.array(batch)`` -> ``net(x)`` -> ``SoftmaxCrossEntropyLoss`` ->
   ``.mean()`` -> ``backward()`` -> ``trainer.step(1)`` -> ``asnumpy()``;
   the same loop on raw tensors in turns (the NDArray layer's own cost is
   the difference of the step medians).  The loss falls and the first
   step's gradients match the CPU within 1e-3*max(1, max|g|).  Then
   ``nd.multi_head_attention`` on NDArrays under ``autograd.record()`` at
   (8, 512, 768), 12 heads, ``impl='auto'``, p=0.1 with the seed drawn on
   the card, in f32 and bf16, then ``backward()``: the forward, dq and
   dk/dv kernels launch exactly once each, and out and the q/k/v
   gradients equal a direct ``ops.nn.multi_head_attention`` call on the
   same tensors and seed (bitwise, or within the kernel gates, the worst
   difference printed).  Last, opperf's dispatch cases (``add``,
   ``multiply``, ``dot``, ``exp``, ``softmax`` at 4x4): raw torch,
   unrecorded and recorded ``nd``, microseconds a call beside the budget
   (recorded <= 3x unrecorded or <= 150 us; printed, not gated); and the
   host microseconds of ``autograd.backward``'s ``grad_req`` pass over the
   live leaves, with no gradient held and with every MLP parameter
   holding one (printed).

11. train_lstm -- ``BASELINE.json`` config 5, the JAX package's LSTM LM
   recipe (``bench.py`` ``_bench_lstm_lm``): ``StandardRNNLM(10000, 650,
   650, 2 layers, dropout 0)`` through ``parallel.FusedTrainer(loss=
   'softmax_ce', optimizer='sgd')`` at lr 1.0, fp32 with TF32 off, B=32,
   T=64, one synthetic batch: 3 warm-up and 10 timed steps.  The loss
   falls and is finite, no flash kernel launches, the encoder's weights
   stay views of cuDNN's flat buffer through the updates; prints the step
   median, tokens/s, the FLOPs a step (decoder and LSTM products, x3),
   peak memory, a ``torch.profiler`` split (cuDNN's RNN kernels, GEMMs,
   softmax/CE, SGD, the rest) with the idle share and the cuDNN RNN
   kernels a step (``cudnn_rnn_kernels``, which must be above 0), and the
   decoder's three GEMMs timed alone.  The encoder's cuDNN call holds
   against the plain per-step version on the card at the recipe's shapes
   (outputs and final states within 1e-4, gradients within
   1e-3*max(1, max|ref|), its autograd node ``CudnnRnnBackward0``), with
   the device times of the fused call on flat weights, on copies cuDNN
   must gather, as one two-layer call and as a call a layer, and of the
   per-step version.  One step's gradients at B=2 match the CPU within
   1e-3*max(1, max|g|).  Then ``standard_lstm_lm_650`` (vocab 33278,
   dropout 0.5: a cuDNN call a layer with the port's masks between them)
   trained the imperative way for 10 steps of B=32, T=35 of one synthetic
   Zipf stream: ``autograd.record()``, ``backward()``,
   ``gluon.utils.clip_global_norm`` (0.25) and ``gluon.Trainer`` SGD, the
   states carried and detached; its step median and falling loss.
12. train_gpt_lm -- ``gpt_lm()`` at its own sizes (vocab 50257, 256 wide,
   8 heads of D=32, 4 layers, 1024 positions, dropout 0.1, no attention
   dropout) through ``parallel.FusedTrainer(adam, lr 1e-4,
   dtype='bfloat16')``, B=8, T=1024, a synthetic Zipf stream: 3 warm-up
   and 5 timed steps.  The kernels see bf16, causal, (8, 8, 1024, 32), and
   each launches exactly 4 times a step; the loss falls.  Prints the step
   median, tokens/s, MFU against 989 TFLOP/s (FLOPs counted off the layer
   shapes, x3), peak memory, the profiler split with the idle share, and
   one causal (8, 8, 1024, 1024, 32) bf16 forward and backward against
   the kernels' plain versions at the kernel phase's gates, with SDPA's
   time and the bounds.
13. rnn_parts -- ``nd.RNN`` in every mode (two bidirectional layers),
   every cell unrolled (the bidirectional one with lengths), ``foreach``
   over an LSTM cell and ``while_loop``, and ``ctc_loss`` (with an
   alignment that cannot fit: ~1e30), each with its gradients, on the
   card against the CPU within 1e-4*max(1, max|ref|); a bf16 LSTM, which
   cuDNN refuses, raises.

14. data_pipeline -- the input pipeline (``BASELINE.json`` configs 1 and
   2 fed as their users feed them): 1,280 synthetic 256x256 RGB images
   (smooth, with class-dependent shapes; 100 classes) packed with
   ``recordio.pack_img`` into a ``.rec``/``.idx`` pair and 4 shards, JPEG
   q95 where the host library has libjpeg, else raw u8 npy payloads (the
   phase prints which and why); ``io.ImageRecordIter`` (3x224x224, B=128,
   random crop and mirror, shuffle, min(cores, 16) threads, route
   ``native``) alone, img/s onto the card and on the host; ResNet-50 v1
   (``train_resnet``'s bf16 recipe, B=128) fed from the pack through
   ``data.PrefetchRing`` (page-locked slots, side stream): 3 + 7 steps,
   the step median against the same trainer's synthetic-tensor median,
   the H2D copy ms a batch, the ring's occupancy before each step and its
   stalls; the losses are finite and fall and the first staged batch is
   bit-identical to the host batch; ``examples/mnist_mlp.py``'s loop
   (``vision.MNIST(...).transform_first(ToTensor())``,
   ``gluon.data.DataLoader(batch_size=256, shuffle=True)``, the MLP, Adam
   1e-3) for 2 epochs on the card, img/s and test accuracy above 0.9; and
   one ``StreamLoader`` epoch over the 4 shards in a world of one that
   sees every record once.  No flash kernel launches.

15. train_vision -- MobileNetV2-1.0 (``vision.get_model(
   'mobilenet_v2_1_0', classes=1000)``, 3x224x224, B=128, 3 + 10 steps)
   and Inception-v3 (3x299x299, B=64, 3 + 5 steps) through
   ``parallel.FusedTrainer(softmax_ce, sgd 0.05 m 0.9, dtype='bfloat16')``
   on one synthetic batch each, channels-last: falling losses, f32
   masters, no flash launch; the step median, img/s, MFU against 989
   TFLOP/s from the FLOPs counted off the layers' shapes (x3), peak
   memory, a ``torch.profiler`` split (conv forward, backward, ATen's
   depthwise kernels apart, batch norm, element-wise, update) with the
   idle share and kernels a step, and which library ran the convs
   (``conv_route``: cuDNN's kernels by name, or ATen's
   ``conv_depthwise2d``).
16. vision_zoo -- ``vgg16``, ``vgg16_bn``, ``alexnet``, ``mobilenet1_0``,
   ``squeezenet1_1``, ``densenet121`` (224x224) and ``inception_v3``
   (299x299), 1000 classes, random weights from ``--seed``: a B=8
   forward on the card (f32, TF32 off) against the same weights on the
   CPU within 1e-3 x max(1, max|ref|), each with its forward time; then
   ``MoE(num_experts=8, hidden_size=3072, units=768, top_k=2)`` on 8 x 512
   tokens (routed far from any tie), forward and backward on the card
   against the CPU, outputs and every gradient within the same 1e-3.
17. train_amp_fp16 -- the ``train`` recipe (BERT-base pretraining through
   ``gluon.Trainer``, Adam 1e-4, B=8, T=512, dropout 0.1, 10 steps) the
   Gluon amp way: ``amp.init('float16')``, ``amp.init_trainer(trainer)``,
   and each step ``scaler.scale(loss)``, ``autograd.backward``,
   ``has_overflow``, ``unscale`` and ``trainer.step(1)`` unless it
   overflowed, ``update_scale``.  The three kernels see float16 and each
   launches exactly 12 times a step; the forward's matrix products are
   float16 (a dispatch-mode count) and the profile splits the GEMMs by
   the type their names carry; parameters and gradients stay float32; the
   loss falls; an inf put into step 5's first gradient halves the loss
   scale and leaves the weights as they were.  Prints the step median and
   its forward / backward (with the overflow check) / update split.
18. checkpoint_resume -- persistence at full width (BERT-base, random
   weights from ``--seed``, checkpoints under a temporary directory,
   removed after).  fp32: the ``train`` recipe (``gluon.Trainer``, Adam
   1e-4, B=8, T=512, dropout 0.1, TF32 off) run 6 steps twice (run A,
   ``mx.random`` seeded before steps 1 and 4), and run B: 3 steps,
   ``trainer.save_checkpoint``, a fresh net and trainer,
   ``load_checkpoint``, 3 steps; steps 4-6's losses and every final
   weight bit-identical to A's (if the two A runs differ, the phase prints
   by how much and where they part, and holds B to that spread); 12
   launches of each kernel a step; bytes written, save, ``validate()`` and
   restore seconds and GB/s, leaf and file counts.  Serving:
   ``serve.Server(factory, root)`` (root positional, as in JAX) serves the
   step-3 encoder to 32 concurrent requests of 64..512 tokens, each within
   1e-4 x max(1, max|ref|) of that block's own forward; then
   ``swap(step=6)`` while 32 clients keep requests in flight: none fails,
   every answer matches step 3 or 6, every request submitted after
   ``swap`` returned matches step 6; the swap's seconds (build, restore,
   warm) and answers a second during it.  bf16: the ``train_bf16`` recipe
   (``FusedTrainer``, B=16) saved with ``block=False`` after step 5 (the
   snapshot's seconds on the calling thread, step medians with the save in
   flight and without), restored into a fresh ``FusedTrainer``, twice: the
   restored tree equals the saved state and each resumed step's loss the
   uninterrupted run's step 6, bit for bit, and the weights after it too
   (if the two restores differ, held to their spread).  Captured: the
   ``train_captured`` recipe run 6 steps, and again with two steps off the
   path after step 3, ``load_checkpoint`` of step 3 under the live
   program (which recaptures) and steps 4-6, within 1e-5 of the
   uninterrupted run.  Every leaf restored without ``ctx`` is a CUDA
   tensor of its saved dtype.  Tied: a net holding one ``Dense(1024)``'s
   parameters under two names, 3 Adam steps through ``gluon.Trainer`` on
   the card, stitched and captured, within 1e-5 of the CPU run.  Lookups:
   one backward of every lookup a main path runs with a gradient (BERT's
   tables and masked-position gather in f32 at B=8 and bf16 at B=16,
   ``gpt_lm``'s and the LSTM LMs' tables, and an f16 BERT case), the
   port's fixed-order sums against PyTorch's own: device ms of each and
   the difference a step, the same bits twice, and a 16-bit gradient
   within one unit in its last place (at the largest value) of the f32
   path on the same values.

19. decode -- autoregressive serving at GPT-2 small's published widths
   (Radford et al. 2019, the 124M config: vocab 50257, 12 layers, 12 heads
   x 64, hidden 3072, context 1024): ``serve.TinyDecoder`` in f32 (TF32
   off), random weights from ``--seed`` (N(0, 0.25 / fan_in) dense
   weights), through ``serve.Server(decode=DecodeRunner(...))`` on the
   card with ``DecodeConfig(page_size=16, max_context=1024, max_live=16,
   max_new_tokens=64)`` and a pool of 16 full contexts.  32 concurrent
   ``submit_decode`` clients (prompts uniform in 16..512 tokens, 64 new
   tokens each, no EOS): every request returns 64 tokens and every token
   equals the argmax of a dense recomputation of its sequence (the
   prefill path, no pages) or sits at a near-tie there (top-2 gap <=
   1e-4 x max|logit|; counted).  Then a ``serve_poison@<id>`` drill (the
   poisoned sequence fails alone), ``POST /decode`` over ``start_http``
   collected and streamed (equal), one decode step at B=16 over 1,022-token
   contexts (host ms, ``torch.profiler`` busy ms, kernels a step, idle
   share) and its page gather's ms against its bytes bound; an 8-session
   prefix drill on one 768-token system prompt through a prefix-cache
   runner (streams equal to the same prompts served cold, or parting at a
   near-tie); a speculative runner with a same-weight draft at k=4
   (streams equal to single-step); every pool ends with 0 pages in use,
   no program is built after warm-up, the flash kernels launch 0 times;
   and two streams decoded by the port on the CPU equal the card's (or
   part at a near-tie).  Prints tokens/s, TTFT and per-token p50/p99
   (``telemetry.histogram_quantiles``), decode steps, the pool's high
   water and capacity, the cache and speculation counters and the
   phase's seconds.

20. np_front -- MXNet 2.0's numpy front door (``mx.np``, ``mx.npx``).
   (a) The ``train`` recipe (BERT-base pretraining, f32, TF32 off, B=8,
   T=512, 76 masks) written as an MXNet 2.0 script: ``npx.set_np()``,
   inputs from ``mx.np.array``, the loss through ``npx.log_softmax``,
   ``npx.pick`` and ``mx.np.mean``, ``autograd.record()`` and
   ``backward()``; with dropout off its loss is within 1e-5 (relative) of
   the ``train`` phase's step on the same weights and batch and every
   gradient within 1e-3*max(1, max|g|); then 3 ``gluon.Trainer`` steps
   (dropout 0.1), the three kernels launching 12 times a step, each loss
   within 1e-6 (relative) of the ``mx.nd`` route's over the same steps
   from the same weights, seed and dropout stream.  (b) GluonNLP's attention at BERT width:
   ``npx.interleaved_matmul_selfatt_qk`` -> ``npx.softmax`` ->
   ``_valatt`` on (512, 8, 3*768), 12 heads, against
   ``npx.multi_head_attention`` (the flash kernels) on the same
   projections: O within 1e-4, d(qkv) within 1e-3*max(1, max|g|); each
   route's forward and forward+backward ms.  (c) Every case of the CPU
   tests' ``mx.np`` tables (``tests/np_cases.py``) and one case of each
   ``ops/np_tail.py`` op, on the card against the port's CPU result (the
   same shapes and dtypes, integers exact, floats within 1e-4 relative +
   1e-5), the reference surface resolving on the device and no host
   fallback used; µs a call of ``np.add``/``np.matmul``/``np.sum`` beside
   ``nd``'s at 4x4.  (d) ``potrf``, ``potri``, ``trsm``, ``syevd``,
   ``svd``, ``inverse`` and ``slogdet`` on (32, 512, 512) f32 SPD
   matrices against torch on the CPU in f64 (``TOL_LINALG``; torch's own
   f32 ``eigh`` and ``svd`` on the card recorded beside ``syevd`` and
   ``svd`` as controls), and, over
   BERT-base's parameter shapes, ``nd.adam_update`` and
   ``lamb_update_phase1/2`` against the port's ``optimizer.Adam``/``LAMB``
   step (1e-6*max(1, max|w|)), ``multi_sum_sq``/``multi_lars`` against
   f64, and ``all_finite``/``multi_all_finite`` under CUDA sync debugging
   set to error (no read-back).
21. nd_tail -- the rest of the ``nd`` front door, synthetic data at
   published sizes from ``--seed``, one JSON line a part.  (a) Matrix
   factorization at MovieLens-20M's tables (138,493 users, 27,278
   movies): two ``Embedding(..., 128, sparse_grad=True)``, a dot product,
   ``L2Loss``, B=8,192 Zipf ids, ``gluon.Trainer`` with lazy Adam, then
   lazy SGD (momentum 0.9), 3 + 10 steps each: step and update ms (CUDA
   events), rows touched, peak memory, and the update's ms with
   ``lazy_update=False`` from the same weights and batches as the
   control; on the first timed step the rows no id touched, and their
   state, are unchanged bit for bit and the touched rows equal the
   per-row rule on the CPU within 1e-6 relative; the first batch's loss
   falls.  (b) ``io.LibSVMIter`` over a libsvm file in ``$TMPDIR`` at
   Avazu-app's 1,000,000 features (15 a row, 4 x 8,192 rows), a linear
   model ``nd.sparse.dot(csr, W)`` with ``W`` a row_sparse-gradient
   ``Parameter`` under lazy SGD: CSR batches/s, the dot's ms against a
   dense matmul over the batch's columns, the cuSPARSE kernels in the
   profile of the forward (the run fails without one) and the backward,
   the product within 1e-5 of the CPU's.  (c) SSD-300: ``MultiBoxPrior`` over 38² ..
   1² maps (8,732 anchors), ``MultiBoxTarget`` (negative mining 3, on the
   host) and ``MultiBoxDetection`` (NMS 0.45, top 400, anchors in center
   form) at B=32, 21 classes, 20 boxes; ``ROIAlign`` and ``ROIPooling``
   at Faster R-CNN C4 shapes (2 x 1,024 x 38 x 63, 512 RoIs each, 14²,
   ratio 2): each op's ms, each output against the CPU (keep-sets and
   matches identical, values within 1e-5; 32 RoIs for the ROI ops).  (d)
   A graph of ogbn-arxiv's size (169,343 nodes, 1,166,243 edges): uniform
   and weighted 2-hop sampling (25, 10) from 1,024 seeds, host ms a
   batch, H2D ms of the sampled 128-wide features, every sampled edge in
   the graph.  (e) ``tests/parity_cases.py`` on the card against the CPU
   (count, worst error) and ``mx.config.check_unknown()``.  No flash
   kernel launches.

After ``train``, phase ``ops_planes`` (the operational planes around
BERT-base, files under ``$TMPDIR``; before ``checkpoint_resume`` and
``decode``, after either of which torch's profiler records no kernel in
this process): (a)
``autotune.tune("flash_attention", key)`` at BERT's f32 key, its bf16
B=16 key and the GPT LM's causal D=32 key on a fresh store, each tile's
ms (10 launches between two CUDA events, a sleep ahead holding the card
while the host enqueues them), verdict and the winner,
which must be the tile phase ``kernels``' CUDA-event times rank first
wherever the two differ by more than 5 % (the GPT key's case runs
here); (b)
BERT-base fp32 serving the serve recipe's 32 requests in full batches of
8 in a child process with ``MXNET_AUTOTUNE=1`` on that store: every
lookup ``tuned``, the launches a tile, every answer bit-identical to the
untuned pass; (c) three ``train`` steps (fp32, B=8, T=512, Adam) with the
monitor's JSONL stream, a watchdog, ``mx.profiler`` and the tuned store
on: the profile holds the three flash kernels and ``device_op_stats``
ranks them, a line a step; a poisoned gradient fires one divergence dump
naming its group, a step held up on the host one slow_step dump, a 2 s
watch around a blocked wait one watchdog fire with stacks; (d) a burst of
deadline misses on a Server, one deadline_burst dump.  After ``decode``,
part (e), ``phase_profiler_trap``: ``mx.profiler`` once more in this
process, either recording the flash kernels or refused (torch's profiler
records no device activity here, a fresh process does), with the
evidence (no session open, the threads alive, a probe from a new thread).
Every compiled forward tile is held against the plain version in phase
``kernels`` (``case["tiles"]``), and each phase prints its seconds.

After ``ops_planes``, phase ``resilience`` (files under ``$TMPDIR``):
every drill runs the ``train`` recipe (BERT-base pretraining, fp32,
dropout 0.1, Adam 1e-4, B=8, T=512) through ``resilience.GluonStepLoop``
with ``batches(step)`` seeding the port's generators from the step.  (a)
six uninterrupted steps, stitched and through ``trainer.capture``: losses
and a SHA-256 over every parameter and Adam state; (b) ``Supervisor``
(``checkpoint_every=3``) with ``trainer_step@4:transient``, the obs plane
and attribution on: one restart from step 2, one ``restart`` dump, the
losses and digest of (a), a record a step executed with its shares; (c)
the same captured with ``step_capture@4:transient``: the fault re-raised
(no fallback, no stitched step), the digest of (a)'s captured run, records
with ``flops`` and ``mfu`` (against 989 TFLOP/s, counted without the
flash kernels; the figure with them beside it); (d) the monitor's
``skip_step`` sentinel and one gradient poisoned at step 3: one divergence
dump naming the group, one restore at the next boundary, no nonfinite
checkpoint on disk, the digest of (a); (e) child A arms the SIGTERM
handler, serves BERT-base to a client thread and runs the supervised loop
(``exit_on_preempt``); a real SIGTERM after its step-1 line: the
emergency checkpoint of step 1, every accepted request answered, exit
``MXNET_PREEMPT_EXIT_CODE``; child B resumes to (a)'s digest; (f) 32
served requests with a 10 ms and a 10 s p99 objective: PAGE and OK,
``/healthz`` "degraded", ``/statz``'s ``slo`` block, ``obs_slo_state`` in
the log line; (g) ``dist.run_with_deadline`` around a wait that never
returns (``DistTimeout`` in 1-3 s, one ``dist_timeout`` dump, counted) and
``resilience.health_check`` (``{"cuda:0": "ok"}``; a blocked probe
reports a timeout within its bound).

Then the ``{"kernels": [...]}`` summary (gpt_lm's causal D=32 bf16 route
as ``routes["bfloat16_causal_d32"]``; ``checkpoint_resume``'s,
``ops_planes``' and ``resilience``'s launches in the routes and
``launches_by_path``), the ``nvidia-smi``
line, and as
the last line ``{"ok": true, "device": {...}}``.  Any failed check raises,
so the script exits non-zero and prints no result line.  Without a card,
or without the package beside it, it exits non-zero.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# H100 SXM published peaks (dense), the rates ``bound_ms`` divides by
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12,     # fp32 outside the tensor cores
              "bfloat16": 989e12,   # bf16 tensor cores
              "float16": 989e12}    # fp16 tensor cores
TF32_FLOPS = 495e12                 # TF32 tensor cores (3xTF32: 3 products)
SLEEP_CYCLES_PER_S = 2.0e9  # above the H100's 1.98 GHz boost clock, so a
                            # ``torch.cuda._sleep`` lasts at least as asked
SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH")
# kernel against plain version: O (absolute) and dq/dk/dv (x max(1,
# max|ref|)).  fp16 keeps 11 significant bits to bf16's 8: its gate is
# 10x its rounding of values near 1 (4.9e-4), a quarter of bf16's.
TOL_O = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 5e-3}
TOL_LSE = 1e-3
TOL_SERVE = 1e-3
TOL_GRAD = 1e-3      # card vs CPU parameter gradients, x max(1, max|g|)
DROPOUT_P = 0.1
SEED_DROP = 0x5EED_0F_D120   # the kernel phase's dropout seed
KERNELS = {  # name: (source, the Pallas kernel it replaces)
    "flash_fwd": ("mxnet_tpu_torch/csrc/flash_fwd.cu",
                  "mxnet_tpu/ops/pallas_attention.py:203"),
    "flash_bwd_dq": ("mxnet_tpu_torch/csrc/flash_bwd.cu",
                     "mxnet_tpu/ops/pallas_attention.py:256"),
    "flash_bwd_dkv": ("mxnet_tpu_torch/csrc/flash_bwd.cu",
                      "mxnet_tpu/ops/pallas_attention.py:301"),
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    raise SystemExit("chip_smoke: FAILED: " + msg)


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_time(fn, iters):
    """(device ms, host ms, covered) per call of ``fn`` over ``iters`` calls.

    A ``torch.cuda._sleep`` enqueued ahead of the timed window holds the
    card while the host enqueues every call, so the CUDA events time the
    launches back to back and not the host's Python work between them
    (shape checks, allocation, the ctypes call).  ``covered`` says the
    sleep outlasted the host's enqueue; the sleep is lengthened and the
    window retaken once if it did not."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    sleep_ms = 2.0 + 1.5e3 * (time.perf_counter() - t0) * iters
    torch.cuda.synchronize()
    for _ in range(2):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(int(sleep_ms * 1e-3 * SLEEP_CYCLES_PER_S))
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        covered = host_ms < ev[0].elapsed_time(ev[1])
        if covered:
            break
        sleep_ms = 2.0 * host_ms + 2.0
    return ev[1].elapsed_time(ev[2]) / iters, host_ms / iters, covered


def cuda_ms(fn, iters):
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    return cuda_time(fn, iters)[0]


def sdpa_fastest(torch, fn, iters, minus=None):
    """``fn`` (a call of PyTorch's SDPA) under each backend that accepts
    the case -> (name, ms) of the fastest, and the names of the backends
    that refused it (inside ``sdpa_kernel([backend])`` a backend that does
    not take the inputs raises RuntimeError at the call).  With ``minus``,
    each backend's time of ``minus`` is taken off its time of ``fn``."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    best, refused = None, []
    for name in SDPA_BACKENDS:
        with sdpa_kernel([getattr(SDPBackend, name)]):
            try:
                fn()
            except RuntimeError:
                refused.append(name.lower())
                continue
            ms = cuda_ms(fn, iters)
            if minus is not None:
                ms -= cuda_ms(minus, iters)
        if best is None or ms < best[1]:
            best = (name.lower(), ms)
    if best is None:
        fail("no SDPA backend accepted the case")
    return best[0], best[1], refused


def ptxas_report(log):
    """Registers, stack and spills of every kernel instance from nvcc's
    ``-Xptxas -v`` output, names demangled with ``cu++filt`` or
    ``c++filt`` where the machine has one."""
    import re

    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
            out.append({"function": name})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and out:
            out[-1].update(stack=int(m.group(1)),
                           spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and out:
            out[-1]["registers"] = int(m.group(1))
    cand = os.path.join(os.environ.get("CUDA_HOME") or "/usr/local/cuda",
                        "bin", "cu++filt")
    filt = cand if os.path.exists(cand) else shutil.which("c++filt")
    if filt and out:
        names = subprocess.run([filt], input="\n".join(
            e["function"] for e in out), capture_output=True, text=True,
            check=True, timeout=60).stdout.splitlines()
        for e, n in zip(out, names):   # "void ns::kernel<...>(args)"
            m = re.search(r"(\w+<[^()]*>|\w+)\(", n)
            e["function"] = m.group(1) if m else n
    return out


def _pairs(Tq, Tk, causal):
    """(query, key) pairs a query may see (top-left causal mask)."""
    return sum(min(i + 1, Tk) for i in range(Tq)) if causal else Tq * Tk


def _bound(nbytes, ops, dtype):
    """(ms, "bytes"|"operations"): the larger of bytes over the memory
    rate and operations over the dtype's peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_bound(B, H, Tq, Tk, D, dtype, causal):
    """Forward: Q/K/V read once, O and LSE written once; 4*D operations
    per (query, visible key) pair."""
    itemsize = 4 if dtype == "float32" else 2
    nbytes = B * H * (2 * Tq * D + 2 * Tk * D) * itemsize + B * H * Tq * 4
    return _bound(nbytes, 4.0 * B * H * D * _pairs(Tq, Tk, causal), dtype)


def _bound_3xtf32(nbytes, ops):
    """An fp32 function's bound on the TF32 tensor cores with the 3xTF32
    split the kernels use: the same bytes, three times the products at
    495 TFLOP/s."""
    return max(nbytes / HBM_BYTES_PER_S * 1e3, 3 * ops / TF32_FLOPS * 1e3)


def attention_bound_3xtf32(B, H, Tq, Tk, D, causal):
    """The fp32 forward's bound at 3xTF32 (bytes as ``attention_bound``)."""
    nbytes = B * H * (2 * Tq * D + 2 * Tk * D) * 4 + B * H * Tq * 4
    return _bound_3xtf32(nbytes, 4.0 * B * H * D * _pairs(Tq, Tk, causal))


def _backward_work(B, H, Tq, Tk, D, dtype, causal):
    """{"bwd", "dq", "dkv"}: (bytes, operations).  The whole backward
    reads Q, K, V, O, dO, LSE and delta once and writes dQ, dK, dV once,
    and does 10*D operations per visible pair (recomputing S, then dP, dV,
    dK, dQ).  The dq function alone reads Q, K, V, dO, LSE, delta and
    writes dQ (6*D: S, dP, dQ); the dk/dv function writes dK, dV (8*D: S,
    dP, dV, dK)."""
    itemsize = 4 if dtype == "float32" else 2
    bh, pairs, rows = B * H, _pairs(Tq, Tk, causal), 2 * B * H * Tq * 4
    tq, tk = Tq * D * itemsize, Tk * D * itemsize
    return {"bwd": (bh * (4 * tq + 4 * tk) + rows, 10.0 * bh * D * pairs),
            "dq": (bh * (3 * tq + 2 * tk) + rows, 6.0 * bh * D * pairs),
            "dkv": (bh * (2 * tq + 4 * tk) + rows, 8.0 * bh * D * pairs)}


def backward_bounds(B, H, Tq, Tk, D, dtype, causal):
    """{"bwd", "dq", "dkv"}: (ms, by) of ``_backward_work``."""
    return {name: _bound(nbytes, ops, dtype) for name, (nbytes, ops)
            in _backward_work(B, H, Tq, Tk, D, dtype, causal).items()}


def backward_bounds_3xtf32(B, H, Tq, Tk, D, causal):
    """{"dq", "dkv"}: the fp32 backward kernels' bounds at 3xTF32."""
    work = _backward_work(B, H, Tq, Tk, D, "float32", causal)
    return {name: _bound_3xtf32(*work[name]) for name in ("dq", "dkv")}


def _rel_err(got, ref):
    ref = ref.float()
    return ((got.float() - ref).abs().max().item()
            / max(1.0, ref.abs().max().item()))


def _sdpa_backward(torch, F, q, k, v, do, causal, p, iters):
    """The backward half of PyTorch's SDPA under its fastest backend:
    fwd+bwd through ``torch.autograd.grad`` minus fwd -> (backend, ms,
    refused)."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]

    def fwd():
        return F.scaled_dot_product_attention(*leaves, dropout_p=p,
                                              is_causal=causal)

    def fwd_bwd():
        torch.autograd.grad(fwd(), leaves, do)

    return sdpa_fastest(torch, fwd_bwd, iters, minus=fwd)


def phase_kernels(torch, fa, seed):
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed)
    # the serving and training shapes (B=16: the bf16 recipe's), then
    # ragged ones and the head dims that take the other tiles (D=40: 2
    # columns a lane; D=256: the 32-row tiles of the backward; D=36: no
    # multiple of 8, padded by the wrappers)
    shapes = [(8, 12, 512, 512, 64), (16, 12, 512, 512, 64),
              (4, 12, 512, 512, 64), (2, 12, 512, 512, 64),
              (1, 12, 512, 512, 64),
              (2, 4, 200, 200, 64), (1, 2, 384, 512, 128),
              (1, 3, 100, 100, 40), (1, 2, 130, 70, 256),
              (2, 12, 512, 512, 36)]
    fwd_cases, bwd_cases = [], []
    for B, H, Tq, Tk, D in shapes:
        serve_shape = (H, Tq, Tk, D) == (12, 512, 512, 64)
        for dname in ("float32", "bfloat16", "float16"):
            if B == 16 and dname != "bfloat16":
                continue  # B=16: the bf16 training step's shape only
            for causal in (False, True):
                if serve_shape and B not in (8, 16) and \
                        (dname != "float32" or causal):
                    continue  # the other serving batches: f32, not causal
                dt = getattr(torch, dname)
                q, k, v = (torch.randn(B, H, T, D, device="cuda",
                                       generator=gen, dtype=dt)
                           for T in (Tq, Tk, Tk))
                do = torch.randn(B, H, Tq, D, device="cuda", generator=gen,
                                 dtype=dt)
                # timed windows of 10 (large) or 25 (small) calls: the
                # script's time limit, the events resolve either
                iters = 10 if B * H * Tq * Tk > 1 << 22 else 25
                for p in (0.0, DROPOUT_P):
                    if serve_shape and B not in (8, 16) and p:
                        continue
                    t0 = time.perf_counter()
                    fwd_cases.append(_fwd_case(torch, F, fa, q, k, v, causal,
                                               p, dname, iters))
                    t1 = time.perf_counter()
                    bwd_cases.append(_bwd_case(torch, F, fa, q, k, v, do,
                                               causal, p, dname, iters))
                    fwd_cases[-1]["case_s"] = t1 - t0
                    bwd_cases[-1]["case_s"] = time.perf_counter() - t1
    emit({"phase": "kernels", "kernel": "flash_fwd", "cases": fwd_cases})
    emit({"phase": "kernels", "kernel": "flash_bwd_dq+flash_bwd_dkv",
          "cases": bwd_cases})
    emit({"phase": "kernels", "kernel": "flash_attention_lse",
          "cases": [_lse_grad_case(torch, fa, gen, shape, dname)
                    for shape in ((2, 12, 512, 512, 64),
                                  (1, 3, 200, 200, 36))
                    for dname in ("float32", "bfloat16", "float16")]})
    _auto_routes(torch, fa)
    _misaligned_refused(torch, fa)
    _seed_routes(torch, fa, gen)
    return fwd_cases, bwd_cases


def _seed_routes(torch, fa, gen):
    """The seed's two ways into device memory give one mask: the three
    kernels with an int seed (copied to the card by the wrappers) and
    with the same seed as an int64 tensor on the card agree bit for bit;
    a seed the card draws (``random.draw_seed``) reaches the kernels with
    no host read (each kernel is held against its plain version with it);
    and the C entry points refuse dropout without a seed address."""
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.ops import _ext

    q, k, v, do = (torch.randn(2, 12, 512, 64, device="cuda", generator=gen)
                   for _ in range(4))
    drawn = mxrandom.draw_seed(q.device)
    out = {}
    for name, seed in (("int", SEED_DROP),
                       ("tensor", fa._seed_tensor(SEED_DROP, q.device)),
                       ("drawn", drawn)):
        o, lse = fa._flash_forward(q, k, v, False, 0.125, DROPOUT_P, seed)
        delta = fa._delta(do, o)
        args = (q, k, v, do, lse, delta, False, None, DROPOUT_P, seed)
        out[name] = (o, lse, fa.flash_bwd_dq(*args)) + \
            fa.flash_bwd_dkv(*args)
    same = all(torch.equal(a, b) for a, b in zip(out["int"], out["tensor"]))
    ref_o, ref_l = fa.flash_attention_reference(q, k, v, False, 0.125,
                                                DROPOUT_P, drawn)
    ref_g = fa.flash_attention_backward_reference(
        q, k, v, out["drawn"][0], out["drawn"][1], do, False, 0.125,
        DROPOUT_P, drawn)
    errs = {"o": (out["drawn"][0] - ref_o).abs().max().item(),
            "lse": (out["drawn"][1] - ref_l).abs().max().item()}
    errs.update({n: _rel_err(g, r) for n, g, r in
                 zip(("dq", "dk", "dv"), out["drawn"][2:], ref_g)})
    lib = _ext.load()
    p = q.data_ptr()
    stream = torch.cuda.current_stream().cuda_stream
    null_seed = lib.mx_flash_fwd(p, p, p, do.data_ptr(),
                                 out["int"][1].data_ptr(), 24, 512, 512, 64,
                                 ctypes.c_float(0.125), 0, 0, 128, 1, None,
                                 fa._keep_threshold(DROPOUT_P),
                                 ctypes.c_float(1.0 / (1 - DROPOUT_P)), 0,
                                 stream)
    case = {"int_equals_tensor_bitwise": same, "drawn_seed_err": errs,
            "tol_o": TOL_O["float32"], "tol_lse": TOL_LSE,
            "null_seed_error": null_seed}
    emit({"phase": "kernels", "seed_routes": case})
    if not same or null_seed == 0 or errs["lse"] > TOL_LSE or max(
            errs[n] for n in ("o", "dq", "dk", "dv")) > TOL_O["float32"]:
        fail("the dropout seed's routes disagree: %s" % case)


def _auto_routes(torch, fa):
    """``multi_head_attention(impl='auto')`` with float16 or a head dim
    that is no multiple of 8 (T=512, so ``use_flash`` holds) launches the
    three kernels and agrees, forward and backward, with the dense path
    in f32 on the same inputs (the dtype's gate x max(1, max|ref|))."""
    from mxnet_tpu_torch.ops import nn as ops_nn

    gen = torch.Generator(device="cuda").manual_seed(7)
    out = []
    for dname, D in (("float16", 64), ("float32", 36), ("bfloat16", 36),
                     ("float16", 36)):
        dt = getattr(torch, dname)
        q, k, v, do = (torch.randn(2, 512, 4 * D, device="cuda", dtype=dt,
                                   generator=gen) for _ in range(4))
        counters = (fa.flash_attention, fa.flash_bwd_dq, fa.flash_bwd_dkv)
        before = [c.launches for c in counters]
        res = []
        for impl, cast in (("auto", dt), ("dense", torch.float32)):
            leaves = [t.detach().to(cast).requires_grad_()
                      for t in (q, k, v)]
            o = ops_nn.multi_head_attention(*leaves, num_heads=4, impl=impl)
            o.backward(do.to(cast))
            res.append([o.detach()] + [t.grad for t in leaves])
        torch.cuda.synchronize()
        launched = [c.launches - b for c, b in zip(counters, before)]
        errs = [_rel_err(g, r) for g, r in zip(*res)]
        case = {"dtype": dname, "D": D, "launched": launched,
                "rel_err": errs, "tol": TOL_O[dname]}
        out.append(case)
        if launched != [1, 1, 1] or max(errs) > TOL_O[dname]:
            emit({"phase": "kernels", "failed_case": case})
            fail("impl='auto' at %s D=%d did not run the kernels right"
                 % (dname, D))
    emit({"phase": "kernels", "auto_routes": out})


def _lse_grad_case(torch, fa, gen, shape, dname):
    """The LSE's gradient: d(out.sum() + lse.sum()) through
    ``flash_attention_lse`` (the kernels, with Δ − dlse) against autograd
    through the dense plain version, causal, within the dtype's gate x
    max(1, max|ref|)."""
    B, H, Tq, Tk, D = shape
    dt = getattr(torch, dname)
    qkv = [torch.randn(B, H, T, D, device="cuda", generator=gen, dtype=dt)
           for T in (Tq, Tk, Tk)]
    grads = []
    for fn in (fa.flash_attention_lse, fa.flash_attention_reference):
        leaves = [t.clone().requires_grad_() for t in qkv]
        out, lse = fn(*leaves, True)
        (out.float().sum() + lse.sum()).backward()
        grads.append([t.grad for t in leaves])
    torch.cuda.synchronize()
    errs = {n: _rel_err(g, r) for n, g, r in zip(("dq", "dk", "dv"),
                                                   *grads)}
    case = {"shape": list(shape), "dtype": dname, "causal": True,
            "rel_err": errs, "tol": TOL_O[dname],
            "ok": all(e <= TOL_O[dname] for e in errs.values())}
    if not case["ok"]:
        emit({"phase": "kernels", "failed_case": case})
        fail("the LSE gradient disagrees with its plain version at %s %s"
             % (shape, dname))
    return case


def _misaligned_refused(torch, fa):
    """A contiguous view 4 bytes past a 16-byte boundary: the forward's,
    the dq and the dk/dv kernels' wrappers and C entry points all refuse
    it, and the card stays usable."""
    from mxnet_tpu_torch.ops import _ext

    bad = torch.zeros(2 * 64 * 64 + 1, device="cuda")[1:].view(1, 2, 64, 64)
    good = torch.zeros(1, 2, 64, 64, device="cuda")
    rows = torch.zeros(1, 2, 64, device="cuda")
    calls = {"flash_attention": lambda: fa.flash_attention(bad, bad, bad),
             "flash_bwd_dq": lambda: fa.flash_bwd_dq(
                 good, good, good, bad, rows, rows),
             "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(
                 bad, good, good, good, rows, rows)}
    for name, call in calls.items():
        try:
            call()
        except fa.MXNetError:
            continue
        fail("%s took a misaligned input" % name)
    lib = _ext.load()
    p = [t.data_ptr() for t in (bad, good, rows)]
    tail = [ctypes.c_float(0.125), 0, 0,
            *fa._dropout_args(0.0, 0, good.device)[0], 0,
            torch.cuda.current_stream().cuda_stream]
    errs = {"mx_flash_fwd": lib.mx_flash_fwd(   # rows: the f32 default
                p[0], p[0], p[0], p[1], p[2], 2, 64, 64, 64, *tail[:3], 128,
                *tail[3:]),
            "mx_flash_bwd_dq": lib.mx_flash_bwd_dq(
                p[1], p[1], p[1], p[0], p[2], p[2], p[1], 2, 64, 64, 64,
                *tail),
            "mx_flash_bwd_dkv": lib.mx_flash_bwd_dkv(
                p[0], p[1], p[1], p[1], p[2], p[2], p[1], p[1], 2, 64, 64,
                64, *tail)}
    for name, err in errs.items():
        if err == 0:
            fail("%s launched on a misaligned input" % name)
    torch.cuda.synchronize()
    good.add_(1.0)   # the context still runs kernels
    torch.cuda.synchronize()
    emit({"phase": "kernels", "misaligned_input_refused": sorted(calls),
          "entry_point_errors": errs})


def _fwd_case(torch, F, fa, q, k, v, causal, p, dname, iters):
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    # the dropout seed in device memory, where the kernels read it; the
    # plain version takes the same tensor
    seed = fa._seed_tensor(SEED_DROP, q.device)
    out, lse = fa._flash_forward(q, k, v, causal, fa._scale(q, None), p,
                                 seed)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, causal,
                                                    dropout_p=p, seed=seed)
    err_o = (out.float() - ref_out.float()).abs().max().item()
    err_l = (lse - ref_lse).abs().max().item()
    ok = err_o <= TOL_O[dname] and err_l <= TOL_LSE
    bound, by = attention_bound(B, H, Tq, Tk, D, dname, causal)
    ms, host_ms, covered = cuda_time(lambda: fa.flash_attention(
        q, k, v, causal, dropout_p=p, seed=seed), iters)
    backend, lib_ms, refused = sdpa_fastest(
        torch, lambda: F.scaled_dot_product_attention(
            q, k, v, dropout_p=p, is_causal=causal), iters)
    case = {
        "shape": [B, H, Tq, Tk, D], "dtype": dname, "causal": causal,
        "dropout_p": p, "seed": "device", "max_abs_err_o": err_o,
        "max_abs_err_lse": err_l,
        "tol_o": TOL_O[dname], "tol_lse": TOL_LSE, "ok": ok,
        "ms": ms, "host_ms": host_ms, "sleep_covered": covered,
        "plain_ms": cuda_ms(lambda: fa.flash_attention_reference(
            q, k, v, causal, dropout_p=p, seed=seed), iters),
        "library_ms": lib_ms, "library_backend": backend,
        "library_refused": refused,
        "bound_ms": bound, "bound_by": by}
    if dname == "float32":
        case["bound_3xtf32_ms"] = attention_bound_3xtf32(B, H, Tq, Tk, D,
                                                         causal)
    if D % 8:   # the wrapper's zero-padding of q, k, v to the next 8
        case["pad_ms"] = cuda_ms(lambda: fa._pad_head_dim(q, k, v), iters)
    if not ok:
        emit({"phase": "kernels", "failed_case": case})
        fail("flash_fwd disagrees with its plain version at %s"
             % case["shape"])
    case["tiles"] = _tile_cases(torch, fa, q, k, v, causal, p, dname, out,
                                lse, ref_out, ref_lse, seed, iters)
    if not p:   # the tiles' device times, for the autotune check
        TILE_MS[(B, H, Tq, Tk, D, dname, causal)] = {
            t: (ms if c.get("default") else c["ms"])
            for t, c in case["tiles"].items()}
    return case


# (B, H, Tq, Tk, D, dtype, causal) -> {"128x64": device ms} without
# dropout, from ``_tile_cases``' CUDA events
TILE_MS = {}


def _bits(torch, t):
    """A tensor's bytes as integers (so -0.0 and NaN payloads count)."""
    t = t.contiguous().reshape(-1)
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


def _tile_cases(torch, fa, q, k, v, causal, p, dname, out, lse, ref_out,
                ref_lse, seed, iters):
    """Every compiled forward tile (``fa.compiled_tiles``) at this case,
    each held against the plain version at the same gates, with its ms
    and whether its O and LSE equal the default tile's bit for bit."""
    tiles = {}
    for i, (bq, bk) in enumerate(fa.compiled_tiles(dname, q.shape[-1],
                                                   p > 0.0)):
        if i == 0:    # the default tile: the case itself
            tiles["%dx%d" % (bq, bk)] = {"default": True}
            continue
        o_t, l_t = fa._flash_forward(q, k, v, causal, fa._scale(q, None), p,
                                     seed, bq, bk)
        torch.cuda.synchronize()
        err_o = (o_t.float() - ref_out.float()).abs().max().item()
        err_l = (l_t - ref_lse).abs().max().item()
        t = {"max_abs_err_o": err_o, "max_abs_err_lse": err_l,
             "bit_identical_to_default":
                 bool(torch.equal(_bits(torch, o_t), _bits(torch, out))
                      and torch.equal(_bits(torch, l_t), _bits(torch, lse))),
             "ms": cuda_ms(lambda: fa.flash_attention(
                 q, k, v, causal, block_q=bq, block_k=bk, dropout_p=p,
                 seed=seed), iters)}
        tiles["%dx%d" % (bq, bk)] = t
        if err_o > TOL_O[dname] or err_l > TOL_LSE:
            emit({"phase": "kernels", "failed_tile": t, "tile": [bq, bk],
                  "shape": list(q.shape), "dtype": dname, "causal": causal})
            fail("flash_fwd tile %dx%d disagrees with its plain version at "
                 "%s %s" % (bq, bk, list(q.shape), dname))
    return tiles


def _bwd_case(torch, F, fa, q, k, v, do, causal, p, dname, iters):
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    seed = fa._seed_tensor(SEED_DROP, q.device)
    out, lse = fa._flash_forward(q, k, v, causal, fa._scale(q, None), p,
                                 seed)
    delta = fa._delta(do, out)
    args = (q, k, v, do, lse, delta, causal, None, p, seed)

    def kernels():
        fa.flash_bwd_dq(*args)
        fa.flash_bwd_dkv(*args)

    dq = fa.flash_bwd_dq(*args)
    dk, dv = fa.flash_bwd_dkv(*args)
    torch.cuda.synchronize()
    ref = fa.flash_attention_backward_reference(q, k, v, out, lse, do,
                                                causal, None, p, seed)
    names = ("dq", "dk", "dv")
    errs = {n: _rel_err(g, r) for n, g, r in zip(names, (dq, dk, dv), ref)}
    abs_errs = {n: (g.float() - r.float()).abs().max().item()
                for n, g, r in zip(names, (dq, dk, dv), ref)}
    tol = TOL_O[dname]
    ok = all(e <= tol for e in errs.values())
    bounds = backward_bounds(B, H, Tq, Tk, D, dname, causal)
    backend, lib_ms, refused = _sdpa_backward(torch, F, q, k, v, do, causal,
                                              p, iters)
    case = {
        "shape": [B, H, Tq, Tk, D], "dtype": dname, "causal": causal,
        "dropout_p": p, "seed": "device", "rel_err": errs,
        "max_abs_err": abs_errs,
        "tol": tol, "ok": ok,
        "ms": cuda_ms(lambda: (fa._delta(do, out), kernels()), iters),
        "dq_ms": cuda_ms(lambda: fa.flash_bwd_dq(*args), iters),
        "dkv_ms": cuda_ms(lambda: fa.flash_bwd_dkv(*args), iters),
        "plain_ms": cuda_ms(lambda: fa.flash_attention_backward_reference(
            q, k, v, out, lse, do, causal, None, p, seed), iters),
        "plain_dq_ms": cuda_ms(lambda: fa.flash_bwd_dq_reference(*args),
                               iters),
        "plain_dkv_ms": cuda_ms(lambda: fa.flash_bwd_dkv_reference(*args),
                                iters),
        "library_ms": lib_ms, "library_backend": backend,
        "library_refused": refused,
        "bound_ms": bounds["bwd"][0], "bound_by": bounds["bwd"][1],
        "dq_bound_ms": bounds["dq"][0], "dq_bound_by": bounds["dq"][1],
        "dkv_bound_ms": bounds["dkv"][0], "dkv_bound_by": bounds["dkv"][1]}
    if dname == "float32":
        for name, ms in backward_bounds_3xtf32(B, H, Tq, Tk, D,
                                               causal).items():
            case[name + "_bound_3xtf32_ms"] = ms
    if D % 8:   # each backward kernel's wrapper pads q, k, v and dO
        case["pad_ms"] = 2 * cuda_ms(lambda: fa._pad_head_dim(q, k, v, do),
                                     iters)
    if not ok:
        emit({"phase": "kernels", "failed_case": case})
        fail("flash backward disagrees with its plain version at %s"
             % case["shape"])
    return case


def bert_params(block, seed):
    """BERT init from numpy: normal(0, 0.02) weights and embeddings,
    zero biases, LayerNorm gamma 1 and beta 0."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, p in block.collect_params().items():
        shape = tuple(p.shape)
        if name.endswith(".gamma"):
            out[name] = np.ones(shape, np.float32)
        elif name.endswith(".beta") or name.endswith(".bias"):
            out[name] = np.zeros(shape, np.float32)
        else:
            out[name] = rng.standard_normal(shape, dtype=np.float32) * 0.02
    return out


def phase_serve(torch, mx, fa, seed, smi):
    from mxnet_tpu_torch.gluon.model_zoo import bert

    T, units, vocab, n_req = 512, 768, 30522, 32
    t0 = time.perf_counter()
    gpu_block = bert.bert_12_768_12(vocab_size=vocab, max_length=T)
    params = bert_params(gpu_block, seed)
    mx.convert.load_jax_params(gpu_block, params)
    cpu_block = bert.bert_12_768_12(vocab_size=vocab, max_length=T)
    mx.convert.load_jax_params(cpu_block, params)
    del params
    t_build = time.perf_counter() - t0

    cfg = mx.serve.ServeConfig(max_batch_size=8,
                               sample_shapes=[((T,), (T,))], dtype="int32")
    t0 = time.perf_counter()
    srv = mx.serve.Server(gpu_block, config=cfg)    # no ctx: the card
    t_warm = time.perf_counter() - t0
    if srv.runner.device.type != "cuda":
        fail("the server did not land on the card: %s" % srv.runner.device)

    rng = np.random.default_rng(seed + 1)
    lengths = rng.integers(64, T + 1, n_req)
    reqs = []
    for L in lengths:
        ids = rng.integers(0, vocab, L).astype(np.int32)
        types = (np.arange(L) >= L // 2).astype(np.int32)
        reqs.append((ids, types))

    def submit(x):
        t = time.perf_counter()
        out = srv.submit(x)
        return out, time.perf_counter() - t

    try:
        mx.telemetry.reset()
        fa.flash_attention.launches = 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=n_req) as pool:
            results = list(pool.map(submit, reqs))
        wall = time.perf_counter() - t0
        launches = fa.flash_attention.launches
        batches = int(mx.telemetry.value("serve_batches_total"))
        pad_elems = mx.telemetry.value("serve_pad_elements_total")
    finally:
        srv.shutdown()

    for i, ((seq, pooled), _) in enumerate(results):
        L = int(lengths[i])
        if seq.shape != (L, units) or pooled.shape != (units,):
            fail("request %d: shapes %s/%s" % (i, seq.shape, pooled.shape))
        if not (np.isfinite(seq).all() and np.isfinite(pooled).all()):
            fail("request %d: nonfinite output" % i)
    if launches <= 0 or launches != 12 * batches:
        fail("flash_fwd launched %d times over %d batches (want 12 per "
             "batch)" % (launches, batches))

    # where a full batch's time goes: one B=8 forward against its 12
    # flash launches at the same shape
    x8 = torch.zeros((8, T), dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: gpu_block(x8, x8), 5)
        q = torch.randn(8, 12, T, units // 12, device="cuda")
        flash_ms = 12 * cuda_ms(lambda: fa.flash_attention(q, q, q), 20)

    # two requests against the same model on the CPU, padded as served
    cpu_err = 0.0
    for i in (0, 1):
        L = int(lengths[i])
        ids = np.zeros((1, T), np.int32)
        types = np.zeros((1, T), np.int32)
        ids[0, :L], types[0, :L] = reqs[i]
        with torch.inference_mode():
            seq, pooled = cpu_block(torch.from_numpy(ids),
                                    torch.from_numpy(types))
        got_seq, got_pooled = results[i][0]
        cpu_err = max(cpu_err,
                      float(np.abs(got_seq - seq[0, :L].numpy()).max()),
                      float(np.abs(got_pooled - pooled[0].numpy()).max()))
    if cpu_err > TOL_SERVE:
        fail("served outputs differ from the CPU run by %g" % cpu_err)

    lat = np.array([r[1] for r in results]) * 1e3
    real = int(lengths.sum())
    emit({"phase": "serve", "model": "bert_12_768_12", "dtype": "float32",
          "tf32": False, "requests": n_req, "batches": batches,
          "flash_launches": launches,
          "real_tokens": real,
          # both inputs (ids, token types) are padded alike
          "padded_tokens": real + int(pad_elems) // 2,
          "wall_s": wall, "requests_per_s": n_req / wall,
          "tokens_per_s": real / wall,
          "latency_ms_p50": float(np.percentile(lat, 50)),
          "latency_ms_p99": float(np.percentile(lat, 99)),
          "cpu_max_abs_err": cpu_err, "tol": TOL_SERVE,
          "forward_ms_b8": fwd_ms, "flash_ms_b8": flash_ms,
          "flash_share_b8": flash_ms / fwd_ms,
          "model_build_s": t_build, "warm_up_s": t_warm,
          "card": smi})
    return launches


def _train_batch(rng, B, T, M, vocab):
    ids = rng.integers(0, vocab, (B, T)).astype(np.int64)
    types = (np.arange(T)[None, :] >= T // 2).repeat(B, 0).astype(np.int64)
    pos = np.stack([rng.choice(T, M, replace=False) for _ in range(B)])
    return dict(ids=ids, types=types, pos=pos.astype(np.int64),
                labels=rng.integers(0, vocab, (B, M)).astype(np.int64),
                weights=np.ones((B, M), np.float32),
                nsp=rng.integers(0, 2, (B,)).astype(np.int64))


def _train_step(mx, bert, net, batch, train_mode=True):
    """record -> forward + loss -> backward; returns the loss tensor."""
    with mx.autograd.record(train_mode=train_mode):
        mlm, nsp = net(batch["ids"], batch["types"], None, batch["pos"])
        loss = bert.pretraining_loss(mlm, nsp, batch["labels"],
                                     batch["weights"], batch["nsp"])
    loss.backward()
    return loss


def phase_train(torch, mx, fa, seed, smi):
    from mxnet_tpu_torch.gluon.model_zoo import bert

    B, T, M, vocab, steps = 8, 512, 76, 30522, 10
    H, D = 12, 64
    t0 = time.perf_counter()
    net = bert.bert_12_768_12(pretraining=True, vocab_size=vocab,
                              max_length=T, dropout=DROPOUT_P)
    net.initialize()                    # no ctx: the card
    mx.convert.load_jax_params(net, bert_params(net, seed))
    params = net.collect_params()
    if any(p.device.type != "cuda" for p in params.values()):
        fail("initialize() did not place the parameters on the card")
    trainer = mx.gluon.Trainer(params, "adam", {"learning_rate": 1e-4})
    rng = np.random.default_rng(seed + 2)
    host = _train_batch(rng, B, T, M, vocab)
    batch = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
    t_build = time.perf_counter() - t0
    mx.random.seed(seed)

    counters = (fa.flash_attention, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, fwd_ms, bwd_ms, upd_ms = [], [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        with mx.autograd.record():
            mlm, nsp = net(batch["ids"], batch["types"], None, batch["pos"])
            loss = bert.pretraining_loss(mlm, nsp, batch["labels"],
                                         batch["weights"], batch["nsp"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        trainer.step(1)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        losses.append(loss.item())
        fwd_ms.append((t1 - t0) * 1e3)
        bwd_ms.append((t2 - t1) * 1e3)
        upd_ms.append((t3 - t2) * 1e3)
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated()

    if not all(np.isfinite(losses)):
        fail("nonfinite training loss: %s" % losses)
    if not losses[-1] < losses[0]:
        fail("training loss did not fall: %s" % losses)
    for name, n in launches.items():
        if n != 12 * steps:
            fail("%s launched %d times in %d steps (want 12 per step)"
                 % (name, n, steps))

    step_ms = [f + b + u for f, b, u in zip(fwd_ms, bwd_ms, upd_ms)]
    med = float(np.median(step_ms))
    # the 36 kernel launches of one step, timed alone at the step's shapes
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(B, H, T, D, device="cuda", generator=gen)
                   for _ in range(4))
    with torch.no_grad():
        seed1 = fa._seed_tensor(1, q.device)
        out, lse = fa._flash_forward(q, k, v, False, fa._scale(q, None),
                                     DROPOUT_P, seed1)
        delta = fa._delta(do, out)
        args = (q, k, v, do, lse, delta, False, None, DROPOUT_P, seed1)
        kern_ms = 12 * (cuda_ms(lambda: fa.flash_attention(
            q, k, v, dropout_p=DROPOUT_P, seed=seed1), 20)
            + cuda_ms(lambda: fa.flash_bwd_dq(*args), 20)
            + cuda_ms(lambda: fa.flash_bwd_dkv(*args), 20))
    del q, k, v, do, out, lse, delta

    grad_err = _train_grad_parity(torch, mx, bert, net, host, vocab, T)
    emit({"phase": "train", "model": "bert_12_768_12", "head":
          "BERTForPretraining", "dtype": "float32", "tf32": False,
          "batch": B, "seq_len": T, "masked_positions": M,
          "dropout": DROPOUT_P, "optimizer": "adam", "lr": 1e-4,
          "steps": steps, "losses": losses, "launches": launches,
          "step_ms": step_ms, "step_ms_median": med,
          "forward_ms_median": float(np.median(fwd_ms)),
          "backward_ms_median": float(np.median(bwd_ms)),
          "update_ms_median": float(np.median(upd_ms)),
          "tokens_per_s": B * T / (med / 1e3),
          "kernels_ms_per_step": kern_ms, "kernels_share": kern_ms / med,
          "max_memory_allocated_bytes": peak,
          "grad_parity_b1_max_rel_err": grad_err, "grad_tol": TOL_GRAD,
          "model_build_s": t_build, "card": smi})
    figures = {"step_ms_median": med,
               "forward_ms_median": float(np.median(fwd_ms)),
               "backward_ms_median": float(np.median(bwd_ms)),
               "update_ms_median": float(np.median(upd_ms))}
    return launches, figures


def _train_grad_parity(torch, mx, bert, net, host, vocab, T):
    """One step's gradients at B=1 with dropout off (``record(train_mode=
    False)``), card against the same weights on the CPU: the largest
    |g_card - g_cpu| / max(1, max|g_cpu|) over the parameters."""
    one = {k: v[:1] for k, v in host.items()}
    net.zero_grad(set_to_none=True)
    _train_step(mx, bert, net, {k: torch.from_numpy(v).cuda()
                                for k, v in one.items()}, train_mode=False)
    cpu = bert.bert_12_768_12(pretraining=True, vocab_size=vocab,
                              max_length=T, dropout=DROPOUT_P)
    mx.convert.load_jax_params(cpu, {k: p.detach().cpu().numpy()
                                     for k, p in net.collect_params().items()})
    _train_step(mx, bert, cpu, {k: torch.from_numpy(v)
                                for k, v in one.items()}, train_mode=False)
    worst = 0.0
    card = net.collect_params()
    for name, p in cpu.collect_params().items():
        g = p.grad
        err = ((card[name].grad.cpu() - g).abs().max().item()
               / max(1.0, g.abs().max().item()))
        worst = max(worst, err)
        if err > TOL_GRAD:
            fail("gradient of %s differs from the CPU run by %g (x max(1, "
                 "max|g|))" % (name, err))
    net.zero_grad(set_to_none=True)
    return worst


def bert_train_flops_per_step(batch, seq, n_mask, layers=12, units=768,
                              ffn=3072, vocab=30522):
    """BERT pretraining flops a step, the JAX package's own count
    (``bench.py`` ``bert_train_flops_per_step``): multiply-adds x 2, the
    forward x 3 for forward, backward and weight gradients."""
    c, ff = units, ffn
    per_tok = layers * (8 * c * c + 4 * seq * c + 4 * c * ff)
    # MLM transform + vocab decoder run on the masked slots only
    per_masked = 2 * c * c + 2 * c * vocab
    fwd = per_tok * batch * seq + per_masked * batch * n_mask
    return 3 * fwd


def _pretrain_loss(outs, masked_labels, nsp_labels):
    """The bf16 recipe's loss (``bench.py`` ``pretrain_loss``): masked-LM
    and NSP cross entropy, in f32."""
    import torch

    mlm, nsp = outs
    logp = torch.log_softmax(mlm.float(), dim=-1)
    ll = torch.gather(logp, -1, masked_labels.long()[..., None])[..., 0]
    nlogp = torch.log_softmax(nsp.float(), dim=-1)
    nll = torch.gather(nlogp, -1, nsp_labels.long()[:, None])[..., 0]
    return -ll.mean() - nll.mean()


_GEMM_NAMES = ("gemm", "cutlass", "xmma", "nvjet", "cublas", "wgmma",
               "s16816", "sm90_", "sm80_", "splitk")


def _kernel_class(name):
    low = name.lower()
    for k in ("flash_fwd_kernel", "flash_bwd_dq_kernel",
              "flash_bwd_dkv_kernel"):
        if k in name:
            return k.replace("_kernel", "")
    if any(g in low for g in _GEMM_NAMES):
        return "gemm"
    if "multi_tensor_apply" in low or "foreach" in low:
        return "foreach_update"
    return "other"


def profile_split(torch, fn, steps, classify=_kernel_class,
                  named=("other", "rest", "elementwise", "cudnn_rnn")):
    """Device time of ``steps`` calls of ``fn`` (each ending in a
    synchronize) under ``torch.profiler`` tracing the card only, split by
    kernel class (``classify``: by default GEMMs, each flash kernel, the
    foreach update, the rest; kernels a step by class; the largest kernels
    of the classes in ``named`` by name: by default the catch-all,
    element-wise and cuDNN RNN ones), and the
    device's idle share: 1 - the union of device activity over the calls'
    wall time (host clock).  Tracing the host too would stretch
    the wall time with the profiler's own work.  None where the profiler
    sees no device activity."""
    from torch.profiler import ProfilerActivity, profile

    wall = 0.0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall += time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    dev = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                 if e.get("ph") == "X" and e.get("cat") in
                 ("kernel", "gpu_memcpy", "gpu_memset"))
    out = {"device_events": len(dev), "wall_ms": wall * 1e3 / steps}
    if not dev:
        return dict(out, split_ms=None, idle_share=None)
    split, other, counts = {}, {}, {}
    for t0, t1, name in dev:
        cls = classify(name)
        split[cls] = split.get(cls, 0.0) + (t1 - t0) / 1e3 / steps
        counts[cls] = counts.get(cls, 0) + 1.0 / steps
        if cls in named:
            other[name] = other.get(name, 0.0) + (t1 - t0) / 1e3 / steps
    busy, end = 0.0, dev[0][0]
    for t0, t1, _ in dev:          # the union of the device intervals
        t0 = max(t0, end)
        if t1 > t0:
            busy += t1 - t0
            end = t1
    busy_ms = busy / 1e3 / steps
    top = sorted(other.items(), key=lambda kv: -kv[1])[:12]
    return dict(out, split_ms=split, device_busy_ms=busy_ms,
                idle_share=1.0 - busy_ms / out["wall_ms"],
                kernels_per_step=len(dev) / steps,
                kernels_per_step_by_class=counts,
                top_other_ms=[[n[:90], ms] for n, ms in top])


def pretrain_step(mx, bert, seed, **cfg):
    """The bf16 recipe's block (``bench.py`` ``PretrainStep``): BERT-base
    pretraining (``cfg`` overrides) called with ``valid_length=None`` and
    the masked positions, on the card with ``bert_params`` weights."""
    class PretrainStep(mx.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.model = bert.bert_12_768_12(pretraining=True, **cfg)

        def forward(self, tokens, types, positions):
            return self.model(tokens, types, valid_length=None,
                              masked_positions=positions)

    net = PretrainStep()
    net.initialize()                    # no ctx: the card
    mx.convert.load_jax_params(net, bert_params(net, seed))
    return net


def phase_train_bf16(torch, mx, fa, seed, smi):
    """The JAX package's BERT recipe (``bench.py`` ``_bench_bert``) through
    the port's ``parallel.FusedTrainer`` in bf16 at full width."""
    from mxnet_tpu_torch.gluon.model_zoo import bert

    B, T, vocab, warm, steps, prof_steps = 16, 512, 30522, 3, 10, 2
    M = max(1, int(T * 0.15))
    H, D = 12, 64

    t0 = time.perf_counter()
    net = pretrain_step(mx, bert, seed, vocab_size=vocab, max_length=T,
                        dropout=DROPOUT_P)
    trainer = mx.parallel.FusedTrainer(
        net, loss_fn=_pretrain_loss, optimizer="adam",
        optimizer_params={"learning_rate": 1e-4}, dtype="bfloat16")
    rng = np.random.default_rng(seed + 3)
    host_x = (rng.integers(0, vocab, (B, T)), rng.integers(0, 2, (B, T)),
              np.sort(rng.choice(T, (B, M)), axis=1))
    host_y = (rng.integers(0, vocab, (B, M)), rng.integers(0, 2, B))
    x = tuple(torch.from_numpy(v).cuda() for v in host_x)
    y = tuple(torch.from_numpy(v).cuda() for v in host_y)
    t_build = time.perf_counter() - t0
    mx.random.seed(seed)

    # the first warm-up step, with the dtype each kernel wrapper checks
    # before its launch
    seen = {}
    check = fa._check_cuda

    def spy(name, ts, shapes):
        seen.setdefault(name, set()).add(str(ts[0].dtype))
        return check(name, ts, shapes)

    names = ("flash_attention", "flash_bwd_dq", "flash_bwd_dkv")
    fa._check_cuda = spy
    try:
        losses = [trainer.step(x, y).item()]
    finally:
        fa._check_cuda = check
    if seen != {n: {"torch.bfloat16"} for n in names}:
        fail("the bf16 step handed the kernels %s" % seen)
    for _ in range(warm - 1):
        losses.append(trainer.step(x, y).item())

    counters = [getattr(fa, n) for n in names]
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(trainer.step(x, y).item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated()

    if not all(np.isfinite(losses)):
        fail("nonfinite bf16 training loss: %s" % losses)
    if not losses[-1] < losses[0]:
        fail("bf16 training loss did not fall: %s" % losses)
    for name, n in launches.items():
        if n != 12 * steps:
            fail("%s launched %d times in %d bf16 steps (want 12 per step)"
                 % (name, n, steps))
    masters = {p.dtype for p in net.collect_params().values()}
    if masters != {torch.float32}:
        fail("master weights are not float32: %s" % masters)

    med = float(np.median(step_ms))
    flops = bert_train_flops_per_step(B, T, M)
    split = profile_split(torch, lambda: trainer.step(x, y), prof_steps)
    # the update alone, on one step's gradients (this moves the weights
    # five more updates; every check above is done)
    _, grads = trainer._loss_and_grads(x, y)
    params = trainer._masters()
    update_ms = cuda_ms(lambda: trainer._opt_update(
        trainer._step_count, params, grads, trainer._opt_state, 1e-4), 5)
    n_params = sum(p.numel() for p in params)
    # the 36 launches of a step, timed alone at the step's shapes in bf16
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(B, H, T, D, device="cuda", generator=gen,
                               dtype=torch.bfloat16) for _ in range(4))
    with torch.no_grad():
        seed1 = fa._seed_tensor(1, q.device)
        out, lse = fa._flash_forward(q, k, v, False, fa._scale(q, None),
                                     DROPOUT_P, seed1)
        delta = fa._delta(do, out)
        args = (q, k, v, do, lse, delta, False, None, DROPOUT_P, seed1)
        kern_ms = 12 * (cuda_ms(lambda: fa.flash_attention(
            q, k, v, dropout_p=DROPOUT_P, seed=seed1), 20)
            + cuda_ms(lambda: fa.flash_bwd_dq(*args), 20)
            + cuda_ms(lambda: fa.flash_bwd_dkv(*args), 20))
    fp16_losses = _fused_fp16_steps(torch, mx, bert, seed)
    emit({"phase": "train_bf16", "model": "bert_12_768_12",
          "head": "BERTForPretraining", "trainer": "parallel.FusedTrainer",
          "dtype": "bfloat16", "batch": B, "seq_len": T,
          "masked_positions": M, "dropout": DROPOUT_P, "optimizer": "adam",
          "lr": 1e-4, "warm_up_steps": warm, "steps": steps,
          "losses": losses, "launches": launches,
          "kernel_dtypes": {n: sorted(v) for n, v in seen.items()},
          "step_ms": step_ms, "step_ms_median": med,
          "tokens_per_s": B * T / (med / 1e3),
          "flops_per_step": flops,
          "mfu": flops / (med / 1e3) / PEAK_FLOPS["bfloat16"],
          "update_ms": update_ms, "update_params": n_params,
          "update_bound_ms": 7 * 4 * n_params / HBM_BYTES_PER_S * 1e3,
          "kernels_ms_per_step": kern_ms, "kernels_share": kern_ms / med,
          "profile": split,
          # the unprofiled median step against the profiled device time
          "idle_share_at_median": (None if split.get("device_busy_ms") is None
                                   else 1.0 - split["device_busy_ms"] / med),
          "max_memory_allocated_bytes": peak,
          "fp16_2_layer_losses": fp16_losses,
          "model_build_s": t_build, "card": smi})
    return launches


def _fused_fp16_steps(torch, mx, bert, seed):
    """``FusedTrainer(dtype='float16')`` runs on the card: three steps of
    a 2-layer BERT-base-wide model at T=512 (its dense layers, as in the
    JAX package, promote to f32, so attention runs in f32); the losses are
    finite and fall."""
    net = pretrain_step(mx, bert, seed, vocab_size=30522, num_layers=2,
                        max_length=512, dropout=0.0)
    trainer = mx.parallel.FusedTrainer(
        net, loss_fn=_pretrain_loss, optimizer="adam",
        optimizer_params={"learning_rate": 1e-4}, dtype="float16")
    rng = np.random.default_rng(seed + 4)
    x = tuple(torch.from_numpy(v).cuda() for v in (
        rng.integers(0, 30522, (2, 512)), rng.integers(0, 2, (2, 512)),
        np.sort(rng.choice(512, (2, 76)), 1)))
    y = tuple(torch.from_numpy(v).cuda() for v in (
        rng.integers(0, 30522, (2, 76)), rng.integers(0, 2, 2)))
    losses = [trainer.step(x, y).item() for _ in range(3)]
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail("FusedTrainer(dtype='float16') losses: %s" % losses)
    return losses


def _resnet_kernel_class(name):
    """The ResNet step's kernel classes: cuDNN's conv forward (fprop) and
    backward (dgrad, wgrad), batch norm, the foreach update, element-wise
    kernels, and the rest (the dense layer's GEMM, reductions, layout
    transforms)."""
    low = name.lower()
    if "dgrad" in low or "wgrad" in low or ("conv" in low and "bwd" in low):
        return "conv_backward"
    if "fprop" in low or "conv" in low or "implicit" in low:
        return "conv_forward"
    if "batch_norm" in low or "bn_fw" in low or "bn_bw" in low:
        return "batch_norm"
    if "multi_tensor_apply" in low or "foreach" in low:
        return "foreach_update"
    if "elementwise" in low:
        return "elementwise"
    return "rest"


def resnet_params(block, seed):
    """ResNet init from numpy: He-normal conv weights, a normal(0, 0.01)
    dense weight, zero biases and beta, running mean 0, running variance
    and gamma 1, except the gamma of each bottleneck's last BatchNorm: 0,
    so every block starts as its shortcut (Goyal et al. 2017) and the
    recipe's lr 0.05 does not blow the residual stream up in the first
    steps."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, p in block.collect_params().items():
        shape = tuple(p.shape)
        leaf = name.rsplit(".", 1)[-1]
        if name.endswith("body.7.gamma"):
            out[name] = np.zeros(shape, np.float32)
        elif leaf in ("gamma", "running_var"):
            out[name] = np.ones(shape, np.float32)
        elif leaf in ("beta", "bias", "running_mean"):
            out[name] = np.zeros(shape, np.float32)
        else:
            std = (0.01 if len(shape) == 2
                   else np.sqrt(2.0 / np.prod(shape[1:])))
            out[name] = rng.standard_normal(shape, dtype=np.float32) * std
    return out


def resnet_fwd_counts(torch, mx, net, hw, device):
    """(forward FLOPs, BatchNorm input elements) of one hw x hw image: 2 x
    the multiply-adds of every conv and dense layer, and the elements
    every BatchNorm normalises, read off the shapes each layer sees."""
    from mxnet_tpu_torch.gluon.nn.basic_layers import BatchNorm, Dense
    from mxnet_tpu_torch.gluon.nn.conv_layers import _Conv

    flops, bn = [0], [0]

    def mac_hook(mod, inputs, out):
        flops[0] += 2 * out.numel() * int(np.prod(mod.weight.shape[1:]))

    def bn_hook(mod, inputs, out):
        bn[0] += out.numel()

    hooks = [m.register_forward_hook(bn_hook if isinstance(m, BatchNorm)
                                     else mac_hook)
             for m in net.modules() if isinstance(m, (_Conv, Dense,
                                                      BatchNorm))]
    try:
        with mx.autograd.pause():
            net(torch.zeros(1, 3, hw, hw, device=device))
    finally:
        for h in hooks:
            h.remove()
    return flops[0], bn[0]


def _resnet50(torch, mx, vision, seed, ctx=None):
    """Full ResNet-50 v1 built with deferred shapes, initialized on ``ctx``
    (the card by default), shaped by one 32x32 probe outside autograd, and
    given ``resnet_params`` weights by name."""
    net = vision.resnet50_v1()
    net.initialize(ctx=ctx)
    with mx.autograd.pause():
        net(torch.zeros(1, 3, 32, 32, device=mx.context.device_of(ctx)))
    mx.convert.load_jax_params(net, resnet_params(net, seed))
    return net


def _timed_steps(torch, trainer, x, y, warm, steps):
    """(first step ms, warm-up losses, timed losses, step ms): each step
    on the host clock, ending in the loss's ``.item()``."""
    def one():
        t0 = time.perf_counter()
        loss = trainer.step(x, y).item()
        return loss, (time.perf_counter() - t0) * 1e3

    first_loss, first_ms = one()
    warm_losses = [first_loss] + [one()[0] for _ in range(warm - 1)]
    timed = [one() for _ in range(steps)]
    return first_ms, warm_losses, [l for l, _ in timed], [ms for _, ms in timed]


def phase_train_resnet(torch, mx, fa, seed, smi):
    """The JAX package's ResNet recipe (``bench.py`` ``_bench_resnet``):
    full-width ResNet-50 v1 through ``parallel.FusedTrainer`` in bf16 at
    B=128, then the fp32 recipe, the NCHW / channels-last comparison, and
    one fp32 step at B=2 against the CPU."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.ops import nn as ops_nn

    B, hw, classes, warm, steps, prof_steps = 128, 224, 1000, 3, 20, 2
    opt = {"learning_rate": 0.05, "momentum": 0.9}
    t0 = time.perf_counter()
    net = _resnet50(torch, mx, vision, seed)
    flops_img, bn_img = resnet_fwd_counts(torch, mx, net, hw, "cuda")
    flops = 3 * flops_img * B
    rng = np.random.default_rng(seed + 5)
    x = torch.from_numpy(rng.random((B, 3, hw, hw), np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, classes, B)).cuda()
    trainer = mx.parallel.FusedTrainer(
        net, loss="softmax_ce", optimizer="sgd", optimizer_params=opt,
        dtype="bfloat16")
    t_build = time.perf_counter() - t0

    counters = [getattr(fa, n) for n in ("flash_attention", "flash_bwd_dq",
                                         "flash_bwd_dkv")]
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    first_ms, losses, timed, step_ms = _timed_steps(
        torch, trainer, x, y, warm, steps)
    losses += timed
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)):
        fail("nonfinite ResNet-50 bf16 loss: %s" % losses)
    if not losses[-1] < losses[0]:
        fail("ResNet-50 bf16 loss did not fall: %s" % losses)
    if any(launches.values()):
        fail("the ResNet step launched flash kernels: %s" % launches)
    params = net.collect_params()
    means = [p for n, p in params.items() if n.endswith("running_mean")]
    variances = [p for n, p in params.items() if n.endswith("running_var")]
    moved_mean = float(min(m.abs().max() for m in means))
    moved_var = float(min((v - 1).abs().max() for v in variances))
    if not (moved_mean > 0 and moved_var > 0 and all(
            torch.isfinite(t).all() for t in means + variances)):
        fail("running statistics did not move or are not finite")
    masters = {p.dtype for p in params.values()}
    if masters != {torch.float32}:
        fail("master weights are not float32: %s" % masters)

    med = float(np.median(step_ms))
    split = profile_split(torch, lambda: trainer.step(x, y), prof_steps,
                          _resnet_kernel_class)
    _, grads = trainer._loss_and_grads((x,), (y,))
    masters = trainer._masters()
    update_ms = cuda_ms(lambda: trainer._opt_update(
        trainer._step_count, masters, grads, trainer._opt_state, 0.05), 5)
    n_params = sum(p.numel() for p in masters)

    # the two memory formats of the conv path, in one process: each
    # format's first step (cuDNN tunes its algorithms there) apart
    layouts, adopted = {}, ops_nn._CUDA_CONV_FORMAT
    for name, fmt in (("nchw", None), ("channels_last", torch.channels_last),
                      ("nchw_again", None)):
        ops_nn._CUDA_CONV_FORMAT = fmt
        try:
            f_ms, _, l_timed, l_ms = _timed_steps(torch, trainer, x, y, 3, 10)
        finally:
            ops_nn._CUDA_CONV_FORMAT = adopted
        layouts[name] = {"first_step_ms": f_ms, "step_ms": l_ms,
                         "step_ms_median": float(np.median(l_ms)),
                         "img_per_s": B / (float(np.median(l_ms)) / 1e3),
                         "losses_finite": bool(np.all(np.isfinite(l_timed)))}
    del trainer, grads, masters
    torch.cuda.empty_cache()

    # the fp32 recipe (bench.py:1375), TF32 off as the other fp32 phases
    net32 = _resnet50(torch, mx, vision, seed)
    tr32 = mx.parallel.FusedTrainer(net32, loss="softmax_ce",
                                    optimizer="sgd", optimizer_params=opt)
    f32_first, f32_warm, f32_timed, f32_ms = _timed_steps(
        torch, tr32, x, y, 3, 10)
    f32_losses = f32_warm + f32_timed
    if not (all(np.isfinite(f32_losses)) and f32_losses[-1] < f32_losses[0]):
        fail("ResNet-50 fp32 losses: %s" % f32_losses)
    del tr32, net32
    torch.cuda.empty_cache()
    grad_err = _resnet_grad_parity(torch, mx, vision, seed, x, y)

    emit({"phase": "train_resnet", "model": "resnet50_v1",
          "trainer": "parallel.FusedTrainer", "dtype": "bfloat16",
          "batch": B, "image": [3, hw, hw], "classes": classes,
          "optimizer": "sgd", "lr": 0.05, "momentum": 0.9,
          "warm_up_steps": warm, "steps": steps, "losses": losses,
          "launches": launches, "first_step_ms": first_ms,
          "step_ms": step_ms, "step_ms_median": med,
          "step_ms_range": [min(step_ms), max(step_ms)],
          "img_per_s": B / (med / 1e3),
          "fwd_flops_per_image": flops_img, "flops_per_step": flops,
          "mfu": flops / (med / 1e3) / PEAK_FLOPS["bfloat16"],
          "update_ms": update_ms, "update_params": n_params,
          "update_bound_ms": 5 * 4 * n_params / HBM_BYTES_PER_S * 1e3,
          "profile": split,
          # BatchNorm forward and backward in bf16: x read and y written,
          # then x and dy read and dx written, once each
          "batch_norm_bytes_bound_ms": 5 * 2 * bn_img * B
          / HBM_BYTES_PER_S * 1e3,
          "idle_share_at_median": (None if split.get("device_busy_ms") is None
                                   else 1.0 - split["device_busy_ms"] / med),
          "max_memory_allocated_bytes": peak,
          "running_stats_moved": {"min_max_abs_mean": moved_mean,
                                  "min_max_abs_var_minus_1": moved_var},
          "conv_memory_format": layouts,
          "fp32": {"batch": B, "first_step_ms": f32_first, "step_ms": f32_ms,
                   "step_ms_median": float(np.median(f32_ms)),
                   "img_per_s": B / (float(np.median(f32_ms)) / 1e3),
                   "losses": f32_losses},
          "b2_fp32_grad_max_rel_err": grad_err,
          "model_build_s": t_build, "card": smi})
    return launches


def _resnet_grad_parity(torch, mx, vision, seed, x, y):
    """One fp32 step's master gradients and new running statistics at B=2
    on the card against the same model on the CPU, within
    TOL_GRAD * max(1, max|g|); returns the largest error so scaled."""
    out = {}
    for ctx in (None, mx.cpu()):
        net = _resnet50(torch, mx, vision, seed, ctx)
        tr = mx.parallel.FusedTrainer(net, loss="softmax_ce",
                                      optimizer="sgd")
        dev = net.collect_params()["output.weight"].device
        xs, ys = (x[:2].to(dev),), (y[:2].to(dev),)
        tr._setup(xs)
        _, grads = tr._loss_and_grads(xs, ys)
        vals = dict(zip(tr._trainable, grads))
        vals.update({n: p for n, p in net.collect_params().items()
                     if "running_" in n})
        out["card" if ctx is None else "cpu"] = {
            n: v.detach().double().cpu() for n, v in vals.items()}
    worst = 0.0
    for name, ref in out["cpu"].items():
        err = float((out["card"][name] - ref).abs().max()) / max(
            1.0, float(ref.abs().max()))
        worst = max(worst, err)
        if err > TOL_GRAD:
            fail("B=2 fp32 %s: card vs CPU %.3g" % (name, err))
    return worst


def _state_leaves(state):
    """The tensors of an optimizer state (None, a tensor or tuples)."""
    if state is None:
        return []
    if isinstance(state, tuple):
        return [t for x in state for t in _state_leaves(x)]
    return [state]


def _step_state(torch, trainer, net):
    """A copy of everything a training step changes: parameters, optimizer
    states, update counts and the step count."""
    opt = trainer._optimizer
    return {"params": [p.detach().clone()
                       for p in net.collect_params().values()],
            "states": {i: [t.clone() for t in _state_leaves(st)]
                       for i, st in trainer._states.items()},
            "counts": dict(opt._index_update_count),
            "num_update": opt.num_update, "step": trainer._step_count}


def _restore_state(torch, trainer, net, snap):
    opt = trainer._optimizer
    with torch.no_grad():
        for p, v in zip(net.collect_params().values(), snap["params"]):
            p.copy_(v)
        for i, ts in snap["states"].items():
            for t, v in zip(_state_leaves(trainer._states[i]), ts):
                t.copy_(v)
    opt._index_update_count = dict(snap["counts"])
    opt.num_update = snap["num_update"]
    trainer._step_count = snap["step"]


def _captured_vs_stitched_step(torch, mx, trainer, net, program, x, y, bs):
    """One captured step and one stitched grouped step from the same
    weights, states and generator seed: -> (worst |w_c - w_s| /
    max(1, max|w_s|) over the parameters, bitwise)."""
    gen = mx.random.generator(torch.device("cuda", 0))
    snap = _step_state(torch, trainer, net)
    gen.manual_seed(4242)
    program(x, y, batch_size=bs)
    torch.cuda.synchronize()
    captured = [p.detach().clone() for p in net.collect_params().values()]
    _restore_state(torch, trainer, net, snap)
    gen.manual_seed(4242)
    program._stitched(x, y, bs)
    torch.cuda.synchronize()
    worst, bitwise = 0.0, True
    for c, p in zip(captured, net.collect_params().values()):
        s_ = p.detach().float()
        bitwise &= torch.equal(c, p.detach())
        worst = max(worst, (c.float() - s_).abs().max().item()
                    / max(1.0, s_.abs().max().item()))
    return worst, bitwise


def _wall_ms(torch, fn, iters):
    """Host-clock ms a call of ``fn`` takes with the card drained after
    each: its host work and its device work, whichever is longer."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def _turns(torch, fns, steps, rounds):
    """Each of ``fns`` (name: step) timed in turns, ``steps`` steps a
    turn, ``rounds`` turns each, on the host clock with the loss's
    ``.item()`` ending each step -> {name: [ms, ...]}."""
    out = {n: [] for n in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            for _ in range(steps):
                t0 = time.perf_counter()
                fn().sum().item()
                out[name].append((time.perf_counter() - t0) * 1e3)
    return out


def _program_report(program, steps):
    """The program's report, failing on any fallback or a captured count
    short of ``steps``."""
    rep = program.report()
    if rep["fallbacks"] or rep["paths"]["captured"] < steps or \
            not all(p["graph"] for p in rep["programs"]):
        fail("captured step fell back or was not captured: %s"
             % json.dumps(rep, default=str)[:2000])
    return rep


def phase_train_captured(torch, mx, fa, seed, smi):
    """The ``train`` recipe (BERT-base pretraining, fp32 with TF32 off,
    dropout 0.1, Adam at lr 1e-4, B=8, T=512, 76 masked positions) through
    ``trainer.capture``: one CUDA graph a step."""
    from mxnet_tpu_torch.gluon.model_zoo import bert
    from mxnet_tpu_torch.optimizer import multi_tensor

    B, T, M, vocab, steps = 8, 512, 76, 30522, 10
    t0 = time.perf_counter()
    net = pretrain_step(mx, bert, seed, vocab_size=vocab, max_length=T,
                        dropout=DROPOUT_P)
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 1e-4})

    def loss_fn(out, labels, weights, nsp):
        return bert.pretraining_loss(out[0], out[1], labels, weights, nsp)

    program = trainer.capture(net, loss_fn)
    host = _train_batch(np.random.default_rng(seed + 2), B, T, M, vocab)
    x = tuple(torch.from_numpy(host[k]).cuda() for k in ("ids", "types",
                                                          "pos"))
    y = tuple(torch.from_numpy(host[k]).cuda() for k in ("labels",
                                                          "weights", "nsp"))
    t_build = time.perf_counter() - t0
    mx.random.seed(seed)
    counters = (fa.flash_attention, fa.flash_bwd_dq, fa.flash_bwd_dkv)

    # step 1: the eager warm-up on a side stream
    losses = [program(x, y, batch_size=1).item()]
    # step 2: capture, then replay; the wrappers count the launches they
    # record into the graph.  A spy keeps each drawn attention seed in
    # memory of the graph's own, read after a replay.
    for c in counters:
        c.launches = 0
    seeds, draw_seed = [], mx.random.draw_seed

    def spy(device=None):
        s_ = draw_seed(device)
        seeds.append(s_.clone())
        return s_

    torch.cuda.empty_cache()   # the graph's pool, apart from the cache
    reserved0 = torch.cuda.memory_reserved()
    mx.random.draw_seed = spy
    try:
        t1 = time.perf_counter()
        losses.append(program(x, y, batch_size=1).item())
        capture_s = time.perf_counter() - t1
    finally:
        mx.random.draw_seed = draw_seed
    graph_pool = torch.cuda.memory_reserved() - reserved0
    recorded = {c.__name__: c.launches for c in counters}
    seeds_a = [int(s_) for s_ in seeds]
    losses.append(program(x, y, batch_size=1).item())
    seeds_b = [int(s_) for s_ in seeds]
    for _ in range(steps - 3):
        losses.append(program(x, y, batch_size=1).item())
    replay_ticks = {c.__name__: c.launches - recorded[c.__name__]
                    for c in counters}
    rep = _program_report(program, steps)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail("captured BERT losses: %s" % losses)
    if recorded != {c.__name__: 12 for c in counters} or \
            any(replay_ticks.values()):
        fail("flash launches recorded at capture %s, on replays %s (want "
             "12 each, then none)" % (recorded, replay_ticks))
    if len(seeds_a) != 12 or len(set(seeds_a)) != 12 or \
            any(a == b for a, b in zip(seeds_a, seeds_b)):
        fail("replays did not draw fresh attention seeds: %s %s"
             % (seeds_a, seeds_b))

    worst, bitwise = _captured_vs_stitched_step(torch, mx, trainer, net,
                                                program, x, y, 1)
    if worst > 1e-5:
        fail("captured step differs from the stitched one by %g" % worst)

    def captured():
        return program(x, y, batch_size=1)

    def stitched():
        return program._stitched(x, y, 1)

    times = _turns(torch, {"captured": captured, "stitched": stitched}, 5, 2)
    med = {n: float(np.median(v)) for n, v in times.items()}
    torch.cuda.reset_peak_memory_stats()
    captured().item()
    peak_c = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    stitched().item()
    peak_s = torch.cuda.max_memory_allocated()
    split_c = profile_split(torch, captured, 2)
    split_s = profile_split(torch, stitched, 2)

    # the grouped Adam against the per-parameter path, on one step's
    # gradients (this moves the weights further; every check is done)
    items = trainer._items()
    grads = [torch.randn_like(p) * 1e-3 for _, p, _ in items]
    groups, _ = multi_tensor.partition(trainer, items)
    (key, members), = groups.items()
    group = trainer._mt_groups[key]

    def grouped():
        plan = multi_tensor.prepare(trainer, group, members)
        multi_tensor.run(trainer, group, members, grads, plan)

    def per_param():
        for (i, p, _), g in zip(items, grads):
            trainer._eager_update(i, p, g)

    g_ms, e_ms = cuda_ms(grouped, 5), cuda_ms(per_param, 3)
    g_wall, e_wall = _wall_ms(torch, grouped, 5), _wall_ms(torch, per_param, 3)
    n_params = sum(p.numel() for _, p, _ in items)
    emit({"phase": "train_captured", "model": "bert_12_768_12",
          "head": "BERTForPretraining", "trainer": "gluon.Trainer.capture",
          "dtype": "float32", "tf32": False, "batch": B, "seq_len": T,
          "masked_positions": M, "dropout": DROPOUT_P, "optimizer": "adam",
          "lr": 1e-4, "steps": steps, "losses": losses,
          "report": {"paths": rep["paths"], "fallbacks": rep["fallbacks"],
                     "segments": [g["segment"] for g in
                                  rep["programs"][0]["segments"]],
                     "buckets": len(rep["programs"][0]["bucket_plan"]),
                     "slots": rep["programs"][0]["host_scalar_slots"]},
          "launches_recorded_at_capture": recorded,
          "launches_counted_on_replays": replay_ticks,
          "attention_seeds_replay_a": seeds_a,
          "attention_seeds_replay_b": seeds_b,
          "capture_s": capture_s, "graph_pool_bytes": graph_pool,
          "captured_vs_stitched_max_rel_err": worst,
          "captured_vs_stitched_bitwise": bitwise, "tol": 1e-5,
          "step_ms": times, "step_ms_median": med,
          "tokens_per_s": {n: B * T / (v / 1e3) for n, v in med.items()},
          # a replay allocates nothing: the captured step's activations
          # live in the graph's pool, outside max_memory_allocated
          "max_memory_allocated_bytes": {"captured": peak_c,
                                         "stitched": peak_s},
          "captured_peak_bytes": peak_c + graph_pool,
          "profile": {"captured": split_c, "stitched": split_s},
          "idle_share_at_median": {
              n: (None if sp.get("device_busy_ms") is None
                  else 1.0 - sp["device_busy_ms"] / med[n])
              for n, sp in (("captured", split_c), ("stitched", split_s))},
          "update": {"params": n_params, "tensors": len(items),
                     "grouped_ms": g_ms, "grouped_wall_ms": g_wall,
                     "per_parameter_ms": e_ms,
                     "per_parameter_wall_ms": e_wall,
                     "bound_ms": 7 * 4 * n_params / HBM_BYTES_PER_S * 1e3},
          "model_build_s": t_build, "card": smi})
    return recorded


def phase_train_captured_resnet(torch, mx, fa, seed, smi):
    """``bench.py``'s captured-step recipe (``_bench_captured_step``):
    ResNet-50 v1 cast to bf16, SGD at lr 0.05 with momentum 0.9 and f32
    masters (``multi_precision``), B=64, 3x224x224, SoftmaxCrossEntropyLoss,
    through ``trainer.capture`` against the stitched step."""
    from mxnet_tpu_torch.gluon.model_zoo import vision

    B, hw, classes, steps, parity_steps = 64, 224, 1000, 10, 3
    opt = {"learning_rate": 0.05, "momentum": 0.9, "multi_precision": True}
    t0 = time.perf_counter()

    def build(count=False):
        net = _resnet50(torch, mx, vision, seed)
        flops = resnet_fwd_counts(torch, mx, net, hw, "cuda")[0] \
            if count else None
        net.cast("bfloat16")
        return net, mx.gluon.Trainer(net.collect_params(), "sgd",
                                     dict(opt)), flops

    net, trainer, flops_img = build(count=True)
    rng = np.random.default_rng(seed + 6)
    x = torch.from_numpy(rng.random((B, 3, hw, hw), np.float32)).cuda() \
        .to(torch.bfloat16)
    y = torch.from_numpy(rng.integers(0, classes, B)).cuda()
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    program = trainer.capture(net, loss_fn)
    t_build = time.perf_counter() - t0
    counters = [getattr(fa, n) for n in ("flash_attention", "flash_bwd_dq",
                                         "flash_bwd_dkv")]
    for c in counters:
        c.launches = 0
    t1 = time.perf_counter()
    losses = [program(x, y).mean().item()]
    first_s = time.perf_counter() - t1
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    t1 = time.perf_counter()
    losses.append(program(x, y).mean().item())
    capture_s = time.perf_counter() - t1
    graph_pool = torch.cuda.memory_reserved() - reserved0
    for _ in range(steps - 2):
        losses.append(program(x, y).mean().item())
    launches = {c.__name__: c.launches for c in counters}
    _program_report(program, steps)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail("captured ResNet-50 losses: %s" % losses)
    if any(launches.values()):
        fail("the ResNet step launched flash kernels: %s" % launches)
    params = net.collect_params()
    means = [p for n, p in params.items() if n.endswith("running_mean")]
    variances = [p for n, p in params.items() if n.endswith("running_var")]
    moved_mean = float(min(m.float().abs().max() for m in means))
    moved_var = float(min((v.float() - 1).abs().max() for v in variances))
    if not (moved_mean > 0 and moved_var > 0 and all(
            torch.isfinite(t).all() for t in means + variances)):
        fail("running statistics did not move or are not finite")
    masters = {trainer._states[i][0].dtype for i in trainer._states}
    if masters != {torch.float32}:
        fail("multi_precision masters are not float32: %s" % masters)

    def captured():
        return program(x, y)

    def stitched():
        return program._stitched((x,), (y,), B)

    stitched().sum().item()   # the stitched path's own first step
    times = _turns(torch, {"captured": captured, "stitched": stitched}, 5, 2)
    med = {n: float(np.median(v)) for n, v in times.items()}
    flops = 3 * flops_img * B
    torch.cuda.reset_peak_memory_stats()
    captured().sum().item()
    peak_c = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    stitched().sum().item()
    peak_s = torch.cuda.max_memory_allocated()
    split_c = profile_split(torch, captured, 2, _resnet_kernel_class)
    split_s = profile_split(torch, stitched, 2, _resnet_kernel_class)
    del program, trainer, net
    torch.cuda.empty_cache()

    # bench.py's parity: fresh models, PARITY_STEPS captured steps against
    # as many stitched ones
    net_p, tr_p, _ = build()
    prog_p = tr_p.capture(net_p, loss_fn)
    net_q, tr_q, _ = build()
    for _ in range(parity_steps):
        prog_p(x, y)
        with mx.autograd.record():
            loss = loss_fn(net_q(x), y)
        mx.autograd.backward(loss)
        tr_q.step(B)
    worst, bitwise = 0.0, True
    qp = net_q.collect_params()
    for k, p in net_p.collect_params().items():
        a, b = qp[k].detach().float(), p.detach().float()
        if not torch.equal(a, b):
            bitwise = False
            worst = max(worst, ((a - b).abs() / (a.abs() + 1e-8))
                        .max().item())
    _program_report(prog_p, parity_steps)
    del prog_p, tr_p, net_p, tr_q, net_q
    torch.cuda.empty_cache()
    emit({"phase": "train_captured_resnet", "model": "resnet50_v1",
          "trainer": "gluon.Trainer.capture", "dtype": "bfloat16",
          "multi_precision": True, "batch": B, "image": [3, hw, hw],
          "classes": classes, "optimizer": "sgd", "lr": 0.05,
          "momentum": 0.9, "steps": steps, "losses": losses,
          "launches": launches, "first_step_s": first_s,
          "capture_s": capture_s, "graph_pool_bytes": graph_pool,
          "step_ms": times, "step_ms_median": med,
          "img_per_s": {n: B / (v / 1e3) for n, v in med.items()},
          "fwd_flops_per_image": flops_img, "flops_per_step": flops,
          "mfu": {n: flops / (v / 1e3) / PEAK_FLOPS["bfloat16"]
                  for n, v in med.items()},
          "max_memory_allocated_bytes": {"captured": peak_c,
                                         "stitched": peak_s},
          "captured_peak_bytes": peak_c + graph_pool,
          "profile": {"captured": split_c, "stitched": split_s},
          "idle_share_at_median": {
              n: (None if sp.get("device_busy_ms") is None
                  else 1.0 - sp["device_busy_ms"] / med[n])
              for n, sp in (("captured", split_c), ("stitched", split_s))},
          "running_stats_moved": {"min_max_abs_mean": moved_mean,
                                  "min_max_abs_var_minus_1": moved_var},
          "parity": {"steps": parity_steps, "bitwise": bitwise,
                     "worst_rel_diff": worst},
          "model_build_s": t_build, "card": smi})
    return launches


# ---- phase nd_imperative: mx.nd on the card ---------------------------------

ND_MLP_B, ND_MLP_STEPS = 256, 50       # BASELINE.json config 1
ND_MHA_SHAPE, ND_MHA_HEADS = (8, 512, 768), 12   # BERT-base width
DISPATCH_US = 150.0   # opperf's absolute budget for a recorded call


def _nd_mlp(mx):
    """``examples/mnist_mlp.py``'s MLP: 784 -> 128 -> 64 -> 10, ReLU."""
    nn = mx.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Dense(128, activation="relu", in_units=784),
            nn.Dense(64, activation="relu", in_units=128),
            nn.Dense(10, in_units=64))
    return net


def _nd_step(mx, net, loss_fn, trainer, x, y, step=True):
    """One step of config 1's loop: ``net(x)`` -> softmax CE -> mean ->
    backward -> ``trainer.step(1)``; NDArrays or tensors alike."""
    with mx.autograd.record():
        loss = loss_fn(net(x), y).mean()
    mx.autograd.backward(loss)
    if step:
        trainer.step(1)
    return loss


def _nd_dispatch(torch, mx, iters=300, warmup=25):
    """opperf's dispatch cases (``benchmark/opperf/opperf.py``
    ``bench_dispatch``) at 4x4 on the card: raw torch, unrecorded ``nd``
    and recorded ``nd``, microseconds a call (host wall time, synchronized
    at the ends)."""
    nd = mx.nd
    small = np.random.RandomState(0).rand(4, 4).astype(np.float32)
    t = torch.from_numpy(small).cuda()
    xa, ya = nd.array(small), nd.array(small)
    xa.attach_grad()

    def timeit(f):
        for _ in range(warmup):
            f()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            f()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters * 1e6

    cases = {
        "add": (lambda: torch.add(t, t), lambda: nd.add(xa, ya)),
        "multiply": (lambda: torch.mul(t, t), lambda: nd.multiply(xa, ya)),
        "dot": (lambda: t @ t, lambda: nd.dot(xa, ya)),
        "exp": (lambda: torch.exp(t), lambda: nd.exp(xa)),
        "softmax": (lambda: torch.softmax(t, -1),
                    lambda: nd.softmax(xa, axis=-1)),
    }
    rows = {}
    for name, (raw_fn, nd_fn) in cases.items():
        def rec_fn(_f=nd_fn):
            with mx.autograd.record():
                return _f()

        raw, unrec, rec = timeit(raw_fn), timeit(nd_fn), timeit(rec_fn)
        rows[name] = {"raw_torch_us": raw, "unrecorded_us": unrec,
                      "recorded_us": rec,
                      "recorded_over_unrecorded": rec / unrec,
                      "unrecorded_over_raw": unrec / raw,
                      "within_budget": rec / unrec <= 3.0
                      or rec <= DISPATCH_US}
    return rows


def _grad_req_bookkeeping(torch, mx, params, iters=1000):
    """Host microseconds of ``autograd.backward``'s ``grad_req`` pass over
    the leaves alive now: with no gradient held (a training loop, where
    ``Trainer.step`` cleared them) and with every one of ``params``
    holding one (each taken off, then given back)."""
    ag = mx.autograd

    def per_call():
        t0 = time.perf_counter()
        for _ in range(iters):
            ag._restore_unreached(ag._take_write_grads())
        return (time.perf_counter() - t0) / iters * 1e6

    none_us = per_call()
    for p in params:
        p.grad = torch.zeros_like(p)
    held_us = per_call()
    for p in params:
        p.grad = None
    return {"live_leaves": len(ag._LEAVES), "held": len(params),
            "none_held_us": none_us, "all_held_us": held_us}


def _nd_mha_case(torch, mx, fa, counters, dname, seed):
    """``nd.multi_head_attention`` at BERT-base width on NDArrays under
    ``autograd.record()``, p=0.1 with the seed on the card, then
    ``backward()``: the launches it makes (counted alone), and out and the
    q/k/v gradients against a direct ``ops.nn.multi_head_attention`` call
    on the same tensors and seed."""
    nd = mx.nd
    dt = getattr(torch, dname)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(ND_MHA_SHAPE, device="cuda", generator=gen)
                   .to(dt) for _ in range(4))
    seed_t = mx.random.draw_seed(torch.device("cuda"))
    kw = {"num_heads": ND_MHA_HEADS, "impl": "auto",
          "attn_dropout": DROPOUT_P, "dropout_seed": seed_t}
    arrs = [nd.array(t) for t in (q, k, v)]
    for a in arrs:
        a.attach_grad()
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    with mx.autograd.record():
        out = nd.multi_head_attention(*arrs, **kw)
    out.backward(nd.array(do))
    torch.cuda.synchronize()
    launched = {c.__name__: c.launches for c in counters}
    if list(launched.values()) != [1, 1, 1]:
        fail("nd.multi_head_attention (%s) launched %s, want one of each "
             "flash kernel" % (dname, launched))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = mx.ops.nn.multi_head_attention(*leaves, **kw)
    ref.backward(do)
    torch.cuda.synchronize()
    tol = TOL_O[dname]
    errs, bitwise = {}, True
    for name, got, want in zip(("out", "dq", "dk", "dv"),
                               [out._data] + [a.grad._data for a in arrs],
                               [ref] + [t.grad for t in leaves]):
        got, want = got.detach().float(), want.detach().float()
        bitwise = bitwise and torch.equal(got, want)
        errs[name] = ((got - want).abs().max().item()
                      / (1.0 if name == "out"
                         else max(1.0, want.abs().max().item())))
        if not torch.isfinite(got).all() or errs[name] > (
                tol if name == "out" else max(tol, TOL_GRAD)):
            fail("nd.multi_head_attention (%s) %s differs from the direct "
                 "call by %g" % (dname, name, errs[name]))

    def nd_call():
        with mx.autograd.record():
            o = nd.multi_head_attention(*arrs, **kw)
        o.backward(nd.array(do))

    def direct_call():
        o = mx.ops.nn.multi_head_attention(*leaves, **kw)
        o.backward(do)

    nd_dev, nd_host, _ = cuda_time(nd_call, 5)
    dir_dev, dir_host, _ = cuda_time(direct_call, 5)
    return launched, {"dtype": dname, "shape": list(ND_MHA_SHAPE),
                      "heads": ND_MHA_HEADS, "dropout_p": DROPOUT_P,
                      "launches": launched, "bitwise": bitwise,
                      "max_err": errs, "tol_o": tol, "tol_grad": TOL_GRAD,
                      "nd_fwd_bwd_ms": nd_dev, "nd_host_ms": nd_host,
                      "direct_fwd_bwd_ms": dir_dev,
                      "direct_host_ms": dir_host}


def phase_nd_imperative(torch, mx, fa, seed, smi):
    """``mx.nd`` on the card: config 1's MLP loop on NDArrays (and the same
    loop on raw tensors), ``nd.multi_head_attention`` at BERT-base width
    through the registry in f32 and bf16, and opperf's dispatch cases."""
    nd = mx.nd
    rng = np.random.default_rng(seed + 9)
    protos = rng.random((10, 784), dtype=np.float32)
    labels = rng.integers(0, 10, (ND_MLP_STEPS, ND_MLP_B))
    data = np.clip(protos[labels] + 0.3 * rng.standard_normal(
        (ND_MLP_STEPS, ND_MLP_B, 784)), 0, 1).astype(np.float32)
    labels = labels.astype(np.float32)

    mx.random.seed(seed)
    nets = {}
    for kind in ("nd", "raw", "cpu"):
        net = _nd_mlp(mx)
        net.initialize(ctx=mx.cpu() if kind == "cpu" else None)
        nets[kind] = net
    init = {k: p.detach().cpu().numpy()
            for k, p in nets["nd"].collect_params().items()}
    for kind in ("raw", "cpu"):
        mx.convert.load_jax_params(nets[kind], init)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainers = {k: mx.gluon.Trainer(n.collect_params(), "adam",
                                    {"learning_rate": 1e-3})
                for k, n in nets.items()}

    # the first step's gradients: the card's NDArray loop against the CPU
    with mx.cpu():
        _nd_step(mx, nets["cpu"], loss_fn, None, nd.array(data[0]),
                 nd.array(labels[0]), step=False)
    _nd_step(mx, nets["nd"], loss_fn, None, nd.array(data[0]),
             nd.array(labels[0]), step=False)
    grad_err = 0.0
    card = nets["nd"].collect_params()
    for name, p in nets["cpu"].collect_params().items():
        err = ((card[name].grad.cpu() - p.grad).abs().max().item()
               / max(1.0, p.grad.abs().max().item()))
        grad_err = max(grad_err, err)
        if err > TOL_GRAD:
            fail("nd MLP: gradient of %s differs from the CPU by %g"
                 % (name, err))
    for net in nets.values():
        net.zero_grad(set_to_none=True)

    # config 1's loop, NDArray and raw-tensor steps in turns
    losses, nd_ms, raw_ms = [], [], []
    for i in range(ND_MLP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = _nd_step(mx, nets["nd"], loss_fn, trainers["nd"],
                        nd.array(data[i]), nd.array(labels[i]))
        losses.append(float(loss.asnumpy()))
        nd_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        loss = _nd_step(mx, nets["raw"], loss_fn, trainers["raw"],
                        torch.from_numpy(data[i]).cuda(),
                        torch.from_numpy(labels[i]).cuda())
        loss.item()
        raw_ms.append((time.perf_counter() - t0) * 1e3)
    if not isinstance(loss_fn(nets["nd"](nd.array(data[0])),
                              nd.array(labels[0])), nd.NDArray):
        fail("a block called with NDArrays did not return NDArrays")
    if not all(np.isfinite(losses)):
        fail("nd MLP: nonfinite loss %s" % losses)
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        fail("nd MLP: the loss did not fall: %s" % losses)

    counters = (fa.flash_attention, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    launches = {c.__name__: {} for c in counters}
    mha = []
    for j, dname in enumerate(("float32", "bfloat16")):
        launched, case = _nd_mha_case(torch, mx, fa, counters, dname,
                                      seed + 20 + j)
        for name, n in launched.items():
            launches[name][dname] = n
        mha.append(case)

    dispatch = _nd_dispatch(torch, mx)
    bookkeeping = _grad_req_bookkeeping(
        torch, mx, [p for n in nets.values()
                    for p in n.collect_params().values()])
    emit({"phase": "nd_imperative", "nvidia_smi": smi,
          "mlp": {"batch": ND_MLP_B, "steps": ND_MLP_STEPS,
                  "optimizer": "adam", "lr": 1e-3,
                  "losses_first_last": [losses[0], losses[-1]],
                  "nd_step_ms_median": float(np.median(nd_ms)),
                  "nd_step_ms_range": [min(nd_ms), max(nd_ms)],
                  "raw_step_ms_median": float(np.median(raw_ms)),
                  "raw_step_ms_range": [min(raw_ms), max(raw_ms)],
                  "nd_over_raw": float(np.median(nd_ms) / np.median(raw_ms)),
                  "grad_vs_cpu_max_rel_err": grad_err,
                  "grad_tol": TOL_GRAD},
          "multi_head_attention": mha,
          "grad_req_bookkeeping": bookkeeping,
          "dispatch_us": dispatch,
          "dispatch_budget": "recorded <= 3x unrecorded or <= %.0f us "
                             "(printed, not gated)" % DISPATCH_US})
    return launches



# ---- recurrent models (BASELINE.json config 5) and the GPT-style LM ---------

TOL_RNN = 1e-4      # cuDNN's RNN vs the per-step version (outputs, states)
LSTM_CFG = dict(vocab=10000, hidden=650, layers=2, B=32, T=64, warm=3,
                steps=10, lr=1.0)                     # bench.py _bench_lstm_lm
# gluon-nlp's word LM loop for standard_lstm_lm_650 (SGD, global-norm clip
# 0.25, bptt 35) at lr 1.0: its lr 20 overshoots on this synthetic stream
LSTM_650_CFG = dict(vocab=33278, B=32, T=35, steps=10, lr=1.0, clip=0.25)
GPT_CFG = dict(B=8, T=1024, warm=3, steps=5, lr=1e-4)


def _cudnn_rnn_class(name):
    """Profile classes of an LSTM LM step: cuDNN's recurrent kernels (its
    persistent and element-wise RNN kernels, not ATen's ``at::native``
    loop), matrix products (the decoder's and cuDNN's input GEMMs),
    softmax/CE, the foreach SGD and the rest."""
    low = name.lower()
    if ("rnn" in low or "lstm" in low) and "at::native" not in name:
        return "cudnn_rnn"
    if any(g in low for g in _GEMM_NAMES):
        return "gemm"
    if "softmax" in low or "nll" in low or "gather" in low:
        return "softmax_ce"
    if "multi_tensor_apply" in low or "foreach" in low:
        return "sgd"
    return "rest"


def lm_params(block, seed, scale=0.07):
    """LM weights from numpy: uniform(-scale, scale) matrices (the JAX
    package's default initializer), zero biases, LayerNorm gamma 1."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, p in block.collect_params().items():
        shape = tuple(p.shape)
        if name.endswith(".gamma"):
            out[name] = np.ones(shape, np.float32)
        elif name.endswith(("bias", ".beta")):
            out[name] = np.zeros(shape, np.float32)
        else:
            out[name] = rng.uniform(-scale, scale, shape).astype(np.float32)
    return out


def _lstm_lm(torch, mx, seed, ctx=None):
    """``bench.py``'s config-5 model on ``ctx`` (default the card), its
    deferred sizes shaped by a call, weights from ``lm_params``."""
    from mxnet_tpu_torch.gluon.model_zoo import language_model as lm

    c = LSTM_CFG
    net = lm.StandardRNNLM(c["vocab"], embed_size=c["hidden"],
                           hidden_size=c["hidden"], num_layers=c["layers"],
                           dropout=0.0)
    net.initialize(ctx=ctx)
    with mx.autograd.pause():
        net(torch.zeros(1, 2, dtype=torch.int64,
                        device=net.embedding.weight.device))
    mx.convert.load_jax_params(net, lm_params(net, seed))
    return net


def _grad_fn_names(t, depth=4):
    """The autograd node names within ``depth`` steps of ``t``."""
    names, frontier = [], [t.grad_fn]
    for _ in range(depth):
        nxt = []
        for fn in frontier:
            if fn is None:
                continue
            names.append(fn.name())
            nxt += [f for f, _ in fn.next_functions]
        frontier = nxt
    return names


def _lm_grads(torch, mx, net, x, y):
    """(loss, [gradient of each parameter]) of the mean token CE."""
    params = list(net.collect_params().values())
    with mx.autograd.record():
        logits = net(x)
        loss = -torch.log_softmax(logits, -1).gather(
            -1, y.long().unsqueeze(-1)).mean()
    return loss.item(), torch.autograd.grad(loss, params)


def _rnn_layer_vs_plain(torch, rl, enc, B, T, seed):
    """The encoder's cuDNN call against the per-step version on the card at
    the recipe's shapes: outputs and final states, and the gradients of a
    probe of all three.  Also the device time of the fused call (flat
    weights, then copies that cuDNN must gather each call; one two-layer
    call, then a call a layer) and of the per-step version."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    H = enc._hidden_size
    x = torch.randn(T, B, H, device="cuda", generator=gen)
    h0, c0 = (torch.randn(enc._num_layers, B, H, device="cuda",
                          generator=gen) * 0.5 for _ in range(2))
    weights = enc._weights()
    enc._flatten(weights)
    leaves = [t.detach().requires_grad_() for t in [x, h0, c0] + weights]
    probes = [torch.randn(s, device="cuda", generator=gen)
              for s in ((T, B, H), (enc._num_layers, B, H),
                        (enc._num_layers, B, H))]

    def grads(fn):
        outs = fn(*leaves)
        loss = sum((o * p).sum() for o, p in zip(outs, probes))
        return outs, torch.autograd.grad(loss, leaves)

    fused, g_fused = grads(lambda x_, h_, c_, *w: rl.rnn_forward(
        "lstm", x_, h_, c_, list(w), enc._num_layers, False))
    ref, g_ref = grads(lambda x_, h_, c_, *w: rl.rnn_reference(
        "lstm", x_, h_, c_, list(w), enc._num_layers, False))
    err = {n: (a - b).abs().max().item()
           for n, a, b in zip(("out", "hT", "cT"), fused, ref)}
    gerr = max(_rel_err(a, b) for a, b in zip(g_fused, g_ref))
    if max(err.values()) > TOL_RNN or gerr > TOL_GRAD:
        fail("cuDNN's LSTM disagrees with the per-step version: %s, "
             "gradients %g" % (err, gerr))
    with torch.no_grad():
        flat = [w.detach() for w in weights]
        copies = [w.clone() for w in flat]

        def call(ws, per_layer=False):
            return rl.rnn_forward("lstm", x, h0, c0, ws, enc._num_layers,
                                  False, per_layer=per_layer)

        times = {"fused_flat_ms": cuda_ms(lambda: call(flat), 20),
                 "fused_copied_weights_ms": cuda_ms(lambda: call(copies),
                                                    20),
                 "fused_per_layer_calls_ms": cuda_ms(
                     lambda: call(flat, per_layer=True), 20),
                 "plain_per_step_ms": cuda_ms(lambda: rl.rnn_reference(
                     "lstm", x, h0, c0, flat, enc._num_layers, False), 3)}

    def fwd_bwd(ws):
        outs = rl.rnn_forward("lstm", *leaves[:3], ws, enc._num_layers,
                              False)
        torch.autograd.grad(sum((o * p).sum() for o, p in
                                zip(outs, probes)), leaves[:3])

    lw = leaves[3:]
    cw = [w.detach().clone().requires_grad_() for w in lw]
    times["fused_fwd_bwd_flat_ms"] = cuda_ms(lambda: fwd_bwd(lw), 10)
    times["fused_fwd_bwd_copied_weights_ms"] = cuda_ms(lambda: fwd_bwd(cw),
                                                       10)
    return {"max_abs_err": err, "grad_max_rel_err": gerr, "tol": TOL_RNN,
            "grad_tol": TOL_GRAD, "shape_TBH": [T, B, H],
            "grad_fn": _grad_fn_names(fused[0])[:3], **times}


def phase_train_lstm(torch, mx, fa, seed, smi):
    """``BASELINE.json`` config 5 (``bench.py`` ``_bench_lstm_lm``): the
    LSTM LM trained through ``parallel.FusedTrainer`` in fp32, the encoder
    on cuDNN's RNN; then ``standard_lstm_lm_650``'s imperative loop."""
    from mxnet_tpu_torch.gluon.rnn import rnn_layer as rl

    c = LSTM_CFG
    B, T, V, H = c["B"], c["T"], c["vocab"], c["hidden"]
    t0 = time.perf_counter()
    net = _lstm_lm(torch, mx, seed)
    enc = net.encoder
    init = {k: p.detach().cpu().numpy()
            for k, p in net.collect_params().items()}
    trainer = mx.parallel.FusedTrainer(
        net, loss="softmax_ce", optimizer="sgd",
        optimizer_params={"learning_rate": c["lr"]})
    rs = np.random.RandomState(0)        # bench.py's data
    x = torch.from_numpy(rs.randint(0, V, (B, T)).astype(np.int32)).cuda()
    y = torch.from_numpy(rs.randint(0, V, (B, T)).astype(np.int32)).cuda()
    t_build = time.perf_counter() - t0

    # the encoder's parameters are views of cuDNN's flat buffer
    ptrs = [w.data_ptr() for w in enc._weights()]
    counters = (fa.flash_attention, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    for cnt in counters:
        cnt.launches = 0
    first_ms, warm_losses, losses, step_ms = _timed_steps(
        torch, trainer, x, y, c["warm"], 0)
    if [w.data_ptr() for w in enc._weights()] != ptrs or \
            enc._flat_ptrs != tuple(ptrs):
        fail("an SGD step moved the LSTM weights out of cuDNN's buffer")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(c["steps"]):
        t1 = time.perf_counter()
        losses.append(trainer.step(x, y).item())
        step_ms.append((time.perf_counter() - t1) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    launches = {cnt.__name__: cnt.launches for cnt in counters}
    if any(launches.values()):
        fail("the LSTM LM launched flash kernels: %s" % launches)
    all_losses = warm_losses + losses
    if not all(np.isfinite(all_losses)):
        fail("nonfinite LSTM LM loss: %s" % all_losses)
    if not losses[-1] < all_losses[0]:
        fail("LSTM LM loss did not fall: %s" % all_losses)

    med = float(np.median(step_ms))
    # 2 x multiply-adds: the decoder (B*T, H) x (H, V) and each layer's
    # input and hidden products (B*T, H) x (H, 4H); x3 for training
    flops = 3 * 2 * B * T * (H * V + c["layers"] * 2 * H * 4 * H)
    split = profile_split(torch, lambda: trainer.step(x, y), 2,
                          classify=_cudnn_rnn_class)
    n_cudnn = (split.get("kernels_per_step_by_class") or {}).get(
        "cudnn_rnn", 0)
    if not n_cudnn:
        emit({"phase": "train_lstm", "failed_profile": split})
        fail("no cuDNN RNN kernel in the LSTM step's profile")
    # the decoder's three GEMMs alone, at the step's shapes
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn(B * T, H, device="cuda", generator=gen)
    w = torch.randn(V, H, device="cuda", generator=gen)
    g = torch.randn(B * T, V, device="cuda", generator=gen)
    decoder_ms = cuda_ms(lambda: (a @ w.t(), g @ w, g.t() @ a), 10)
    layer = _rnn_layer_vs_plain(torch, rl, enc, B, T, seed + 1)
    if "CudnnRnnBackward0" not in layer["grad_fn"]:
        fail("the fused LSTM call did not run cuDNN: %s" % layer["grad_fn"])

    # the first step's gradients at B=2 against the CPU, fresh weights
    net_gpu = _lstm_lm(torch, mx, seed)
    net_cpu = _lstm_lm(torch, mx, seed, ctx=mx.cpu())
    for n in (net_gpu, net_cpu):
        mx.convert.load_jax_params(n, init)
    l_gpu, g_gpu = _lm_grads(torch, mx, net_gpu, x[:2], y[:2])
    l_cpu, g_cpu = _lm_grads(torch, mx, net_cpu, x[:2].cpu(), y[:2].cpu())
    names = list(net_cpu.collect_params())
    grad_err = {n: _rel_err(a.cpu(), b) for n, a, b in
                zip(names, g_gpu, g_cpu)}
    if max(grad_err.values()) > TOL_GRAD:
        fail("LSTM LM gradients differ from the CPU: %s" % grad_err)
    del net_gpu, net_cpu

    imperative = _lstm_650_loop(torch, mx, seed)
    emit({"phase": "train_lstm", "recipe": "bench.py _bench_lstm_lm",
          "model": "StandardRNNLM(10000, 650, 650, 2 layers, dropout 0)",
          "trainer": "parallel.FusedTrainer(loss='softmax_ce', sgd)",
          "dtype": "float32", "tf32": False, "batch": B, "seq_len": T,
          "lr": c["lr"], "warm_up_steps": c["warm"], "steps": c["steps"],
          "losses": all_losses, "first_step_ms": first_ms,
          "step_ms": step_ms, "step_ms_median": med,
          "tokens_per_s": B * T / (med / 1e3), "flops_per_step": flops,
          "mfu_fp32": flops / (med / 1e3) / PEAK_FLOPS["float32"],
          "bound_ms_fp32": flops / PEAK_FLOPS["float32"] * 1e3,
          "max_memory_allocated_bytes": peak, "profile": split,
          "cudnn_rnn_kernels": n_cudnn,
          "cudnn_rnn_kernel_names": [
              n for n, _ in split["top_other_ms"]
              if _cudnn_rnn_class(n) == "cudnn_rnn"],
          "decoder_gemms_ms": decoder_ms,
          "idle_share_at_median": (
              None if split.get("device_busy_ms") is None
              else 1.0 - split["device_busy_ms"] / med),
          "encoder_vs_per_step": layer,
          "grad_vs_cpu_b2": {"loss_card": l_gpu, "loss_cpu": l_cpu,
                             "max_rel_err": max(grad_err.values()),
                             "tol": TOL_GRAD},
          "weights_stay_flat": True,
          "lstm_650_imperative": imperative, "launches": launches,
          "model_build_s": t_build, "card": smi})
    return launches


def _zipf_stream(seed, vocab, n):
    """A token stream with a Zipf-like unigram law (what a word LM learns
    first), from numpy."""
    rng = np.random.default_rng(seed)
    return ((rng.zipf(1.2, n) - 1) % vocab).astype(np.int64)


def _lstm_650_loop(torch, mx, seed):
    """``standard_lstm_lm_650`` (vocab 33278, dropout 0.5) trained the
    imperative way: ``autograd.record()``, ``backward()``,
    ``clip_global_norm`` and ``gluon.Trainer`` SGD, the states carried and
    detached across consecutive batches of one stream."""
    from mxnet_tpu_torch.gluon.model_zoo import language_model as lm

    c = LSTM_650_CFG
    B, T, V = c["B"], c["T"], c["vocab"]
    mx.random.seed(seed)
    net = lm.standard_lstm_lm_650(vocab_size=V)
    net.initialize()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": c["lr"]})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    stream = torch.from_numpy(_zipf_stream(seed, V, B * (T * c["steps"]
                                                          + 1))).cuda()
    data = stream.reshape(B, -1)
    states = net.begin_state(B)
    params = list(net.collect_params().values())
    losses, step_ms = [], []
    enc = net.encoder
    for i in range(c["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = data[:, i * T:(i + 1) * T]
        y = data[:, i * T + 1:(i + 1) * T + 1]
        states = [s.detach() for s in states]
        with mx.autograd.record():
            logits, states = net(x, states)
            loss = loss_fn(logits.reshape(-1, V), y.reshape(-1)).mean()
        mx.autograd.backward(loss)
        mx.gluon.utils.clip_global_norm([p.grad for p in params],
                                        c["clip"])
        trainer.step(1)
        losses.append(loss.item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if tuple(w.data_ptr() for w in enc._weights()) != enc._flat_ptrs:
            fail("gluon.Trainer's update moved the LSTM weights out of "
                 "cuDNN's buffers")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail("standard_lstm_lm_650's loss did not fall: %s" % losses)
    return {"model": "standard_lstm_lm_650", "vocab": V, "batch": B,
            "bptt": T, "dropout": 0.5, "optimizer": "sgd", "lr": c["lr"],
            "clip_global_norm": c["clip"], "losses": losses,
            "step_ms": step_ms, "step_ms_median": float(np.median(step_ms)),
            "per_layer_calls": net.encoder._dropout > 0}


def gpt_train_flops_per_step(B, T, units=256, hidden=1024, layers=4,
                             heads=8, vocab=50257):
    """3 x the forward's 2 x multiply-adds: per token and layer the four
    projections (4 u^2) and the FFN (2 u h); the causal attention's
    4 * D * H FLOPs per visible pair and layer; the tied (u x vocab)
    projection."""
    dense = 2 * B * T * layers * (4 * units * units + 2 * units * hidden)
    attn = layers * 4.0 * B * heads * (units // heads) * _pairs(T, T, True)
    proj = 2 * B * T * units * vocab
    return 3 * (dense + attn + proj)


def phase_train_gpt_lm(torch, mx, fa, seed, smi):
    """``gpt_lm()`` at its own sizes (vocab 50257, 256 wide, 8 heads of
    D=32, 4 layers, 1024 positions, dropout 0.1) trained through
    ``parallel.FusedTrainer`` in bf16 with Adam: every attention call goes
    to the causal flash kernels at D=32."""
    from mxnet_tpu_torch.gluon.model_zoo import language_model as lm
    import torch.nn.functional as F

    c = GPT_CFG
    B, T = c["B"], c["T"]
    t0 = time.perf_counter()
    net = lm.gpt_lm()
    net.initialize()
    mx.convert.load_jax_params(net, bert_params(net, seed))
    trainer = mx.parallel.FusedTrainer(
        net, loss="softmax_ce", optimizer="adam",
        optimizer_params={"learning_rate": c["lr"]}, dtype="bfloat16")
    tokens = torch.from_numpy(_zipf_stream(seed + 5, 50257,
                                           B * (T + 1))).cuda()
    tokens = tokens.reshape(B, T + 1)
    x, y = tokens[:, :-1].contiguous(), tokens[:, 1:].contiguous()
    t_build = time.perf_counter() - t0
    mx.random.seed(seed)

    # what the kernels were handed in the first step
    seen = set()
    check, fwd = fa._check_cuda, fa._flash_forward

    def spy_check(name, ts, shapes):
        seen.add((name, str(ts[0].dtype), tuple(ts[0].shape)))
        return check(name, ts, shapes)

    def spy_fwd(q, k, v, causal, *args):
        seen.add(("causal", bool(causal)))
        return fwd(q, k, v, causal, *args)

    fa._check_cuda, fa._flash_forward = spy_check, spy_fwd
    try:
        losses = [trainer.step(x, y).item()]
    finally:
        fa._check_cuda, fa._flash_forward = check, fwd
    want = {(n, "torch.bfloat16", (B, 8, T, 32)) for n in
            ("flash_attention", "flash_bwd_dq", "flash_bwd_dkv")} \
        | {("causal", True)}
    if seen != want:
        fail("gpt_lm handed the kernels %s, want %s" % (sorted(seen),
                                                        sorted(want)))
    for _ in range(c["warm"] - 1):
        losses.append(trainer.step(x, y).item())
    counters = (fa.flash_attention, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    for cnt in counters:
        cnt.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(c["steps"]):
        t1 = time.perf_counter()
        losses.append(trainer.step(x, y).item())
        step_ms.append((time.perf_counter() - t1) * 1e3)
    launches = {cnt.__name__: cnt.launches for cnt in counters}
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail("gpt_lm loss did not fall: %s" % losses)
    for name, n in launches.items():
        if n != 4 * c["steps"]:
            fail("%s launched %d times in %d gpt_lm steps (want 4 a step)"
                 % (name, n, c["steps"]))
    med = float(np.median(step_ms))
    flops = gpt_train_flops_per_step(B, T)
    split = profile_split(torch, lambda: trainer.step(x, y), 2)

    # the main path's attention alone: one causal (8, 8, 1024, 1024, 32)
    # bf16 forward and backward against the plain versions
    gen = torch.Generator(device="cuda").manual_seed(seed + 6)
    q, k, v, do = (torch.randn(B, 8, T, 32, device="cuda", generator=gen,
                               dtype=torch.bfloat16) for _ in range(4))
    fwd_case = _fwd_case(torch, F, fa, q, k, v, True, 0.0, "bfloat16", 20)
    bwd_case = _bwd_case(torch, F, fa, q, k, v, do, True, 0.0, "bfloat16",
                         20)
    emit({"phase": "train_gpt_lm", "model": "gpt_lm()",
          "config": {"vocab": 50257, "units": 256, "hidden_size": 1024,
                     "layers": 4, "heads": 8, "head_dim": 32,
                     "max_length": 1024, "dropout": 0.1,
                     "attention_dropout": 0.0},
          "trainer": "parallel.FusedTrainer(adam, dtype='bfloat16')",
          "batch": B, "seq_len": T, "lr": c["lr"],
          "warm_up_steps": c["warm"], "steps": c["steps"],
          "losses": losses, "launches": launches,
          "launches_per_step": {n: l / c["steps"]
                                for n, l in launches.items()},
          "kernel_inputs": sorted(map(str, seen)),
          "step_ms": step_ms, "step_ms_median": med,
          "tokens_per_s": B * T / (med / 1e3), "flops_per_step": flops,
          "mfu": flops / (med / 1e3) / PEAK_FLOPS["bfloat16"],
          "max_memory_allocated_bytes": peak, "profile": split,
          "idle_share_at_median": (
              None if split.get("device_busy_ms") is None
              else 1.0 - split["device_busy_ms"] / med),
          "causal_d32_fwd": fwd_case, "causal_d32_bwd": bwd_case,
          "model_build_s": t_build, "card": smi})
    return launches, fwd_case, bwd_case


def _on(dev, obj):
    """Tensors (nested in lists) moved to ``dev``."""
    if isinstance(obj, (list, tuple)):
        return type(obj)(_on(dev, o) for o in obj)
    return obj.to(dev)


def _compare(where, got, want, tol=TOL_RNN):
    """Fail unless each tensor of ``got`` is within ``tol`` x max(1,
    max|ref|) of ``want``; return the worst relative error."""
    worst = 0.0
    for a, b in zip(got, want):
        if a.shape != b.shape:
            fail("%s: shape %s against %s" % (where, tuple(a.shape),
                                               tuple(b.shape)))
        worst = max(worst, _rel_err(a.detach().cpu(), b.detach().cpu()))
    if worst > tol:
        fail("%s: the card differs from the CPU by %g" % (where, worst))
    return worst


def _flat_tensors(obj):
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _flat_tensors(o)]
    return [obj]


def _control_flow_case(mx, contrib, name, cell, x, w, B):
    """``foreach``: an LSTM cell over the steps of ``x`` scaled by ``w``;
    ``while_loop``: nine steps of a decaying state -> the outputs and
    final states as one list."""
    if name == "foreach":
        outs, st = contrib.foreach(lambda xt, s: cell(xt * w, s), x,
                                   cell.begin_state(B))
        return [outs] + st
    outs, st = contrib.while_loop(
        lambda i, s: bool((i < 9).all()),
        lambda i, s: ((s * w).sum(-1), [i + 1, s * 0.9 + 0.1]),
        [x.new_zeros(1), x[0]], max_iterations=12)
    return [outs] + st


def phase_rnn_parts(torch, mx, fa, seed, smi):
    """The recurrent pieces off the main paths, on the card against the
    CPU: ``nd.RNN`` in every mode, every cell unrolled, ``foreach`` and
    ``while_loop``, and ``ctc_loss`` with its gradient; and a bf16 LSTM,
    which cuDNN refuses, raises."""
    from mxnet_tpu_torch.gluon import rnn
    from mxnet_tpu_torch.gluon.rnn import rnn_layer as rl
    from mxnet_tpu_torch.gluon.rnn.rnn_layer import _GATES
    from mxnet_tpu_torch.ndarray import contrib
    from mxnet_tpu_torch.ops import nn as ops_nn

    rng = np.random.default_rng(seed + 7)
    T, B, I, H = 12, 4, 16, 32
    out = {}

    def leaf(a, dev):
        return torch.from_numpy(a).to(dev).requires_grad_()

    # nd.RNN, every mode, 2 layers, both directions: outputs and gradients
    rnn_op = {}
    for mode in ("lstm", "gru", "rnn_tanh", "rnn_relu"):
        G, n = _GATES[mode], 0
        for layer in range(2):
            n += 2 * G * H * ((I if layer == 0 else 2 * H) + H + 2)
        arrays = [rng.standard_normal(s).astype(np.float32) * sc
                  for s, sc in (((T, B, I), 1.0), ((n,), 0.2),
                                ((4, B, H), 0.5), ((4, B, H), 0.5))]
        res = {}
        for dev in ("cuda", "cpu"):
            x, p, h0, c0 = (leaf(a, dev) for a in arrays)
            with mx.autograd.record():
                outs = mx.nd.RNN(x, p, h0, c0 if mode == "lstm" else None,
                                 state_size=H, num_layers=2, mode=mode,
                                 bidirectional=True, state_outputs=True)
            outs = [o._data for o in outs]
            grads = torch.autograd.grad(
                sum((o * 0.5).sum() for o in outs),
                [x, p, h0] + ([c0] if mode == "lstm" else []))
            res[dev] = outs + list(grads)
        rnn_op[mode] = _compare("nd.RNN(%s)" % mode, res["cuda"],
                                res["cpu"])
    out["nd_RNN_max_rel_err"] = rnn_op

    # every cell, unrolled (NTC; the bidirectional one with lengths)
    def cells():
        seq = rnn.SequentialRNNCell()
        seq.add(rnn.LSTMCell(H))
        seq.add(rnn.DropoutCell(0.5))
        seq.add(rnn.GRUCell(H))
        return {"rnn_tanh": rnn.RNNCell(H),
                "rnn_relu": rnn.RNNCell(H, activation="relu"),
                "lstm": rnn.LSTMCell(H), "gru": rnn.GRUCell(H),
                "sequential": seq, "residual": rnn.ResidualCell(
                    rnn.GRUCell(I)),
                "bidirectional": rnn.BidirectionalCell(rnn.LSTMCell(H),
                                                       rnn.GRUCell(H)),
                "zoneout": rnn.ZoneoutCell(rnn.LSTMCell(H), 0.2, 0.2),
                "variational": rnn.VariationalDropoutCell(
                    rnn.GRUCell(H), 0.2, 0.2, 0.2)}

    xs = rng.standard_normal((B, T, I)).astype(np.float32)
    lengths = np.array([T, 3, 7, 10], np.float32)
    cell_err = {}
    card_cells, cpu_cells = cells(), cells()
    for name in card_cells:
        res = {}
        for dev, cell in (("cuda", card_cells[name]),
                          ("cpu", cpu_cells[name])):
            cell.initialize(ctx=None if dev == "cuda" else mx.cpu())
            with mx.autograd.pause():
                cell.unroll(1, torch.zeros(B, 1, I, device=dev))
            if dev == "cuda":
                params = lm_params(cell, seed + 8, scale=0.3)
            mx.convert.load_jax_params(cell, params)
            x = leaf(xs, dev)
            vl = (torch.from_numpy(lengths).to(dev)
                  if name == "bidirectional" else None)
            with mx.autograd.record(train_mode=False):
                o, st = cell.unroll(T, x, valid_length=vl)
                loss = (o * o).sum()
            g = torch.autograd.grad(loss, [x] + list(cell.parameters()))
            res[dev] = [o] + _flat_tensors(st) + list(g)
        cell_err[name] = _compare("cell %s" % name, res["cuda"], res["cpu"])
    out["cells_max_rel_err"] = cell_err

    # foreach (an LSTM cell over the steps) and while_loop
    cf = {}
    w = rng.standard_normal((I,)).astype(np.float32)
    for name in ("foreach", "while_loop"):
        res = {}
        for dev in ("cuda", "cpu"):
            cell = card_cells["lstm"] if dev == "cuda" else \
                cpu_cells["lstm"]
            x = leaf(xs.transpose(1, 0, 2).copy(), dev)
            wt = leaf(w, dev)
            with mx.autograd.record(train_mode=False):
                got = _control_flow_case(mx, contrib, name, cell, x, wt, B)
            grads = torch.autograd.grad(sum((t * t).sum() for t in got),
                                        [x, wt], allow_unused=True)
            res[dev] = got + [g for g in grads if g is not None]
        cf[name] = _compare(name, res["cuda"], res["cpu"])
    out["control_flow_max_rel_err"] = cf


    # ctc_loss (blank first, -1 padding, one infeasible alignment)
    acts = rng.standard_normal((30, B, 20)).astype(np.float32) * 2
    labels = np.array([[3, 4, 4, 5, -1], [1, 2, -1, -1, -1],
                       [7] * 5, [9, 8, 7, 6, 5]], np.float32)
    dlen = np.array([30, 20, 6, 25], np.int32)   # 7x5 needs 9 frames
    res = {}
    for dev in ("cuda", "cpu"):
        a = leaf(acts, dev)
        loss = ops_nn.ctc_loss(a, torch.from_numpy(labels).to(dev),
                               torch.from_numpy(dlen).to(dev))
        res[dev] = [loss, torch.autograd.grad(
            (loss * torch.linspace(0.5, 1.5, B, device=dev)).sum(), a)[0]]
    out["ctc_max_rel_err"] = _compare("ctc_loss", res["cuda"], res["cpu"])
    out["ctc_losses"] = res["cuda"][0].tolist()
    if not 1e29 < out["ctc_losses"][2] < 1e31:
        fail("the infeasible CTC alignment gave %g, want ~1e30"
             % out["ctc_losses"][2])

    # a backward after record(train_mode=False) (cuDNN's backward needs a
    # forward in its training form); the grouped SGD keeps the weights
    # views of cuDNN's buffers (one a layer: dropout 0.3), and the next
    # forward reads the update
    layer = rnn.LSTM(H, num_layers=2, dropout=0.3, input_size=I)
    layer.initialize()
    trainer = mx.gluon.Trainer(layer.collect_params(), "sgd",
                               {"learning_rate": 0.5})
    x = torch.from_numpy(xs.transpose(1, 0, 2).copy()).cuda()
    with mx.autograd.record(train_mode=False):
        loss = (layer(x) ** 2).sum()
    mx.autograd.backward(loss)
    before = layer._flat_ptrs
    trainer.step(1)
    weights = [w.detach() for w in layer._weights()]
    if tuple(w.data_ptr() for w in weights) != before:
        fail("gluon.Trainer's update moved the LSTM weights out of "
             "cuDNN's buffers")
    with torch.no_grad():
        got = layer(x)
        zeros = torch.zeros(2, B, H, device="cuda")
        want = rl.rnn_reference("lstm", x, zeros, zeros, weights, 2, False)[0]
    out["update_seen_max_rel_err"] = _compare("LSTM after an update",
                                              [got], [want])

    # cuDNN refuses bf16: the layer raises instead of falling back
    layer = rnn.LSTM(H)
    layer.initialize()
    layer.cast("bfloat16")
    try:
        layer(torch.zeros(T, B, I, device="cuda", dtype=torch.bfloat16))
    except mx.MXNetError as e:
        out["bf16_lstm_refused"] = str(e)[:120]
    else:
        fail("a bf16 LSTM on the card did not raise")
    emit(dict({"phase": "rnn_parts", "tol": TOL_RNN, "card": smi}, **out))


# ---- phase 14: the input pipeline -------------------------------------------

DATA_CFG = dict(images=1280, side=256, crop=224, classes=100, batch=128,
                warm=3, steps=7, shards=4, mnist_batch=256, mnist_epochs=2,
                jpeg_quality=95)


def synthetic_images(rng, n, side, classes):
    """``n`` smooth RGB uint8 images (side x side) with their labels: a
    two-colour gradient, a class-dependent shape (a disc, a square or a
    ring, at a class-dependent place and size, in a class-dependent
    colour) and mild noise, so JPEG sizes are those of photographs, not of
    noise."""
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float32) / side
    labels = rng.integers(0, classes, n)
    for i in range(n):
        c = int(labels[i])
        base = rng.uniform(40, 200, 3).astype(np.float32)
        tilt = rng.uniform(-60, 60, 3).astype(np.float32)
        img = base + tilt * (xx[..., None] * np.cos(c)
                             + yy[..., None] * np.sin(c))
        cy = 0.25 + 0.05 * ((7 * c) % 11)
        cx = 0.25 + 0.05 * ((3 * c) % 11)
        size = 0.08 + 0.02 * (c % 5)
        r = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
        shape = [r < size,
                 np.maximum(abs(yy - cy), abs(xx - cx)) < size,
                 abs(r - size) < 0.03][c % 3]
        img[shape] = np.array([(37 * c) % 256, (91 * c) % 256,
                               (53 * c) % 256], np.float32)
        img += rng.normal(0, 4, img.shape).astype(np.float32)
        yield np.clip(img, 0, 255).astype(np.uint8), float(c)


def pack_images(mx, tmp, cfg, seed):
    """The pack the phase reads: ``images.rec``/``.idx`` and the same
    records split into ``cfg['shards']`` shards round robin.  JPEG at
    ``cfg['jpeg_quality']`` where the host library has libjpeg, else raw
    u8 npy payloads (``native.route()``)."""
    from mxnet_tpu_torch import native, recordio

    route = native.route()
    fmt = ".jpg" if route == "jpeg" else ".npy"
    rng = np.random.default_rng(seed + 14)
    t0 = time.perf_counter()
    whole = recordio.MXIndexedRecordIO(os.path.join(tmp, "images.idx"),
                                       os.path.join(tmp, "images.rec"), "w")
    shards = [recordio.MXIndexedRecordIO(
        os.path.join(tmp, "shard-%d.idx" % s),
        os.path.join(tmp, "shard-%d.rec" % s), "w")
        for s in range(cfg["shards"])]
    nbytes = 0
    for i, (img, label) in enumerate(synthetic_images(
            rng, cfg["images"], cfg["side"], cfg["classes"])):
        rec = recordio.pack_img(recordio.IRHeader(0, label, i, 0), img,
                                quality=cfg["jpeg_quality"], img_fmt=fmt)
        nbytes += len(rec)
        whole.write_idx(i, rec)
        shards[i % len(shards)].write_idx(i // len(shards), rec)
    for w in [whole] + shards:
        w.close()
    return {"host_library": route, "payload": fmt.lstrip("."),
            "jpeg_skipped_reason": None if route == "jpeg" else
            "the host has no <jpeglib.h>: raw u8 npy payloads",
            "records": cfg["images"], "bytes": nbytes,
            "bytes_per_record": nbytes / cfg["images"],
            "pack_s": time.perf_counter() - t0}


def _record_iter(mx, rec, cfg, seed):
    return mx.io.ImageRecordIter(
        path_imgrec=rec, data_shape=(3, cfg["crop"], cfg["crop"]),
        batch_size=cfg["batch"], rand_crop=True, rand_mirror=True,
        shuffle=True, preprocess_threads=min(os.cpu_count(), 16),
        seed=seed)


def _loader_epoch(torch, it):
    """One epoch of ``it``: (images, seconds), the last batch on the
    card when the clock stops."""
    t0 = time.perf_counter()
    n, last = 0, None
    for batch in it:
        last = batch.data[0]
        n += batch.data[0].shape[0] - batch.pad
    if last is not None and last.context.device_type == "gpu":
        torch.cuda.synchronize()
    it.reset()
    return n, time.perf_counter() - t0


def _fed_resnet(torch, mx, rec, cfg, seed):
    """ResNet-50 v1 (``train_resnet``'s recipe) fed from the pack through
    ``data.PrefetchRing``: the stager thread reads host batches from an
    ``ImageRecordIter`` and stages them onto the card through page-locked
    slots on a side stream."""
    from mxnet_tpu_torch.gluon.model_zoo import vision

    it = _record_iter(mx, rec, cfg, seed)
    first = {}
    count = [0]

    def source():
        with mx.cpu():
            try:
                b = it.next()
            except StopIteration:
                it.reset()
                b = it.next()
        host = (b.data[0]._data, b.label[0]._data)
        if count[0] == 0:
            first["x"], first["y"] = (t.clone() for t in host)
        count[0] += 1
        return count[0] - 1, host, None

    placer = mx.data.make_placer(slots=3, timing=True)
    ring = mx.data.PrefetchRing(source, placer, depth=2, name="resnet")
    net = _resnet50(torch, mx, vision, seed)
    trainer = mx.parallel.FusedTrainer(
        net, loss="softmax_ce", optimizer="sgd",
        optimizer_params={"learning_rate": 0.05, "momentum": 0.9},
        dtype="bfloat16")
    losses, step_ms, occupancy, identical = [], [], [], None
    for i in range(cfg["warm"] + cfg["steps"]):
        t0 = time.perf_counter()
        occupancy.append(ring.occupancy())
        idx, (x, y), _ = ring.next()
        if i == 0:
            identical = bool(torch.equal(x._data.cpu(), first["x"])
                             and torch.equal(y._data.cpu(), first["y"]))
        losses.append(trainer.step(x, y).item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    stalls = ring.stalls
    ring.stop()
    copy_ms = placer.copy_ms()
    # the same trainer on one synthetic batch already on the card
    rng = np.random.default_rng(seed + 5)
    B, hw = cfg["batch"], cfg["crop"]
    xs = torch.from_numpy(rng.random((B, 3, hw, hw), np.float32)).cuda()
    ys = torch.from_numpy(rng.integers(0, cfg["classes"], B)).cuda()
    _, _, _, synth_ms = _timed_steps(torch, trainer, xs, ys, cfg["warm"],
                                     cfg["steps"])
    timed = step_ms[cfg["warm"]:]
    return {"losses": losses, "step_ms": step_ms,
            "step_ms_median": float(np.median(timed)),
            "img_per_s": B / (float(np.median(timed)) / 1e3),
            "synthetic_step_ms": synth_ms,
            "synthetic_step_ms_median": float(np.median(synth_ms)),
            "h2d_ms_per_batch": copy_ms,
            "h2d_ms_median": float(np.median(copy_ms)),
            "h2d_bytes_per_batch": 4 * B * (3 * hw * hw + 1),
            "ring_depth": ring.depth,
            "ring_occupancy_before_each_step": occupancy,
            "ring_stalls": stalls,
            "first_batch_bit_identical": identical}


def _mnist_loop(torch, mx, root, cfg, seed):
    """``examples/mnist_mlp.py``'s loop on the card, as the example
    writes it (deferred input sizes, ``hybridize``, Adam at lr 1e-3)."""
    from mxnet_tpu_torch.gluon.data.vision import datasets, transforms

    mx.random.seed(seed)
    to_tensor = transforms.ToTensor()
    train = datasets.MNIST(root=root, train=True).transform_first(to_tensor)
    test = datasets.MNIST(root=root, train=False).transform_first(to_tensor)
    train_loader = mx.gluon.data.DataLoader(
        train, batch_size=cfg["mnist_batch"], shuffle=True)
    test_loader = mx.gluon.data.DataLoader(test,
                                           batch_size=cfg["mnist_batch"])
    nn = mx.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Dense(128, activation="relu"), nn.Dense(64, activation="relu"),
            nn.Dense(10))
    net.initialize()
    net.hybridize()
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 1e-3})
    epochs, where = [], set()
    for _ in range(cfg["mnist_epochs"]):
        t0 = time.perf_counter()
        total = seen = 0.0
        for x, y in train_loader:
            with mx.autograd.record():
                loss = loss_fn(net(x), y).mean()
            loss.backward()
            trainer.step(1)
            total += float(loss.asnumpy()) * x.shape[0]
            seen += x.shape[0]
            where.add(str(x.context))
        train_s = time.perf_counter() - t0
        correct = n = 0
        for x, y in test_loader:
            pred = net(x).asnumpy().argmax(axis=1)
            correct += int((pred == y.asnumpy()).sum())
            n += x.shape[0]
        epochs.append({"loss": total / seen, "test_acc": correct / n,
                       "train_s": train_s, "img_per_s": seen / train_s})
    return {"epochs": epochs, "batch_contexts": sorted(where),
            "route": train_loader.route}


def _stream_epoch(torch, mx, tmp, cfg, seed):
    """One ``StreamLoader`` epoch over the shards, in a world of one."""
    shards = [os.path.join(tmp, "shard-%d.rec" % s)
              for s in range(cfg["shards"])]
    loader = mx.data.StreamLoader(shards, cfg["batch"], seed=seed,
                                  num_workers=min(os.cpu_count(), 8),
                                  prefetch=2)
    ids, shapes = [], set()
    t0 = time.perf_counter()
    for data, label in loader:
        shapes.add((tuple(data.shape), str(data.context), str(data.dtype)))
        ids.append(loader.last_ids.copy())
        del data, label
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    stats = loader.stats()
    loader.close()
    ids = np.concatenate(ids)
    return {"world": [loader.num_hosts, loader.host],
            "assignment": loader.assignment_mode,
            "batches": len(ids) // cfg["batch"], "records": len(ids),
            "distinct": int(len(set(ids.tolist()))),
            "batch_shapes": sorted(map(str, shapes)), "seconds": secs,
            "img_per_s": len(ids) / secs,
            "ring_stalls": stats["ring_stalls"],
            "records_total": stats["records_total"]}


def phase_data_pipeline(torch, mx, fa, seed, smi, cfg=DATA_CFG):
    """The input pipeline on the card: a RecordIO pack of synthetic
    images, the native ``ImageRecordIter`` alone, ResNet-50 fed through
    ``data.PrefetchRing``, config 1's MNIST loop through
    ``gluon.data.DataLoader`` and a ``StreamLoader`` epoch over shards."""
    counters = [getattr(fa, n) for n in ("flash_attention", "flash_bwd_dq",
                                         "flash_bwd_dkv")]
    for c in counters:
        c.launches = 0
    tmp = tempfile.mkdtemp(prefix="mx_data_pipeline_")
    try:
        pack = pack_images(mx, tmp, cfg, seed)
        rec = os.path.join(tmp, "images.rec")
        it = _record_iter(mx, rec, cfg, seed)
        route = it.route
        if route != "native":
            fail("ImageRecordIter took the %r route" % route)
        loader = {}
        for name, scope in (("card", None), ("host", mx.cpu())):
            runs = []
            for _ in range(2):
                if scope is None:
                    runs.append(_loader_epoch(torch, it))
                else:
                    with scope:
                        runs.append(_loader_epoch(torch, it))
            n, secs = runs[-1]
            if n != cfg["images"]:
                fail("an ImageRecordIter epoch gave %d images of %d"
                     % (n, cfg["images"]))
            loader[name] = {"img_per_s": n / secs, "epoch_s": secs,
                            "first_epoch_s": runs[0][1]}
        del it
        fed = _fed_resnet(torch, mx, rec, cfg, seed)
        losses = fed["losses"]
        if not all(np.isfinite(losses)):
            fail("nonfinite fed ResNet-50 loss: %s" % losses)
        if not (losses[-1] < losses[0] and np.mean(losses[-3:])
                < np.mean(losses[:3])):
            fail("fed ResNet-50 loss did not fall: %s" % losses)
        if not fed["first_batch_bit_identical"]:
            fail("the first staged batch differs from the host batch")
        torch.cuda.empty_cache()
        mnist = _mnist_loop(torch, mx, os.path.join(tmp, "mnist"), cfg,
                            seed)
        if mnist["batch_contexts"] != ["gpu(0)"]:
            fail("MNIST batches landed on %s" % mnist["batch_contexts"])
        if not mnist["epochs"][-1]["test_acc"] > 0.9:
            fail("MNIST test accuracy %.4f <= 0.9"
                 % mnist["epochs"][-1]["test_acc"])
        stream = _stream_epoch(torch, mx, tmp, cfg, seed)
        if not (stream["records"] == stream["distinct"] == cfg["images"]
                == stream["records_total"]):
            fail("the StreamLoader epoch did not see every record once: %s"
                 % stream)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {c.__name__: c.launches for c in counters}
    if any(launches.values()):
        fail("the data pipeline launched flash kernels: %s" % launches)
    emit({"phase": "data_pipeline", "pack": pack, "host_cores":
          os.cpu_count(), "record_iter": {
              "route": route, "batch": cfg["batch"],
              "data_shape": [3, cfg["crop"], cfg["crop"]],
              "preprocess_threads": min(os.cpu_count(), 16),
              "rand_crop": True, "rand_mirror": True, "shuffle": True,
              "to_card": loader["card"], "host_only": loader["host"]},
          "fed_resnet50": dict(fed, model="resnet50_v1",
                               trainer="parallel.FusedTrainer",
                               dtype="bfloat16", optimizer="sgd", lr=0.05,
                               momentum=0.9, batch=cfg["batch"]),
          "mnist_mlp": mnist, "stream_loader": stream,
          "launches": launches, "card": smi})
    return launches


# ---- the vision families, MoE, and fp16 BERT under amp ---------------------

VISION_CFG = {  # model: (batch, side, warm-up steps, timed steps)
    "mobilenet_v2_1_0": (128, 224, 3, 10),
    "inception_v3": (64, 299, 3, 5)}
ZOO_MODELS = (("vgg16", 224), ("vgg16_bn", 224), ("alexnet", 224),
              ("mobilenet1_0", 224), ("squeezenet1_1", 224),
              ("densenet121", 224), ("inception_v3", 299))
TOL_ZOO = 1e-3       # card vs CPU, x max(1, max|ref|)


def _vision_kernel_class(name):
    """``_resnet_kernel_class``, with the depthwise conv kernels apart:
    ATen's (``conv_depthwise2d_*``) and cuDNN's (``*_c1_k1_*``: one input
    channel a group, one output)."""
    low = name.lower()
    if "depthwise" in low or "_c1_k1" in low:
        return "conv_depthwise"
    return _resnet_kernel_class(name)


def _vision_net(torch, mx, vision, name, hw, seed, ctx=None):
    """``vision.get_model(name, classes=1000)`` on ``ctx`` (the card by
    default), shaped by one hw x hw probe outside autograd, with
    ``resnet_params`` weights by name (He-normal convs, unit gamma)."""
    net = vision.get_model(name, classes=1000)
    net.initialize(ctx=ctx)
    with mx.autograd.pause():
        net(torch.zeros(1, 3, hw, hw, device=mx.context.device_of(ctx)))
    mx.convert.load_jax_params(net, resnet_params(net, seed))
    return net


def _depthwise_route(split):
    """Which library ran the depthwise convs, by the kernels the profile
    names: ATen's ``conv_depthwise2d_*`` or cuDNN's ``*_c1_k1_*``; "none"
    for a net without depthwise convs."""
    names = [n for n, _ in split.get("top_other_ms", [])]
    dw = [n for n in names if _vision_kernel_class(n) == "conv_depthwise"]
    aten = any("depthwise" in n.lower() for n in dw)
    return {"depthwise_route": ("aten conv_depthwise2d" if aten else
                                "cudnn" if dw else "none"),
            "depthwise_kernels": dw,
            "conv_kernels": [n for n in names if n not in dw
                             and "conv" in _vision_kernel_class(n)][:6],
            "depthwise_ms": (split.get("split_ms") or {}).get(
                "conv_depthwise", 0.0)}


def phase_train_vision(torch, mx, fa, seed, smi):
    """MobileNetV2-1.0 (B=128, 224x224) and Inception-v3 (B=64, 299x299),
    1000 classes, through ``parallel.FusedTrainer(softmax_ce, sgd 0.05
    m 0.9, dtype='bfloat16')``, channels-last on the card."""
    from mxnet_tpu_torch.gluon.model_zoo import vision

    counters = [getattr(fa, n) for n in ("flash_attention", "flash_bwd_dq",
                                         "flash_bwd_dkv")]
    out = {"phase": "train_vision", "trainer": "parallel.FusedTrainer",
           "dtype": "bfloat16", "optimizer": "sgd", "lr": 0.05,
           "momentum": 0.9, "classes": 1000, "card": smi, "models": {}}
    launches = {c.__name__: 0 for c in counters}
    for name, (B, hw, warm, steps) in VISION_CFG.items():
        t0 = time.perf_counter()
        net = _vision_net(torch, mx, vision, name, hw, seed)
        flops_img, bn_img = resnet_fwd_counts(torch, mx, net, hw, "cuda")
        flops = 3 * flops_img * B
        rng = np.random.default_rng(seed + 11)
        x = torch.from_numpy(rng.random((B, 3, hw, hw), np.float32)).cuda()
        y = torch.from_numpy(rng.integers(0, 1000, B)).cuda()
        trainer = mx.parallel.FusedTrainer(
            net, loss="softmax_ce", optimizer="sgd",
            optimizer_params={"learning_rate": 0.05, "momentum": 0.9},
            dtype="bfloat16")
        t_build = time.perf_counter() - t0
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        first_ms, losses, timed, step_ms = _timed_steps(
            torch, trainer, x, y, warm, steps)
        losses += timed
        for c in counters:
            launches[c.__name__] += c.launches
        peak = torch.cuda.max_memory_allocated()
        if not all(np.isfinite(losses)):
            fail("nonfinite %s loss: %s" % (name, losses))
        if not losses[-1] < losses[0]:
            fail("%s loss did not fall: %s" % (name, losses))
        masters = {p.dtype for p in net.collect_params().values()}
        if masters != {torch.float32}:
            fail("%s master weights are not float32: %s" % (name, masters))
        med = float(np.median(step_ms))
        split = profile_split(
            torch, lambda: trainer.step(x, y), 2, _vision_kernel_class,
            named=("conv_forward", "conv_backward", "conv_depthwise",
                   "rest"))
        out["models"][name] = {
            "batch": B, "image": [3, hw, hw], "warm_up_steps": warm,
            "steps": steps, "losses": losses, "first_step_ms": first_ms,
            "step_ms": step_ms, "step_ms_median": med,
            "step_ms_range": [min(step_ms), max(step_ms)],
            "img_per_s": B / (med / 1e3),
            "fwd_flops_per_image": flops_img, "flops_per_step": flops,
            "mfu": flops / (med / 1e3) / PEAK_FLOPS["bfloat16"],
            "batch_norm_elements_per_image": bn_img,
            "max_memory_allocated_bytes": peak, "profile": split,
            "kernels_per_step": split.get("kernels_per_step"),
            "idle_share_at_median": (
                None if split.get("device_busy_ms") is None
                else 1.0 - split["device_busy_ms"] / med),
            "conv_route": _depthwise_route(split),
            "model_build_s": t_build}
        del trainer, net, x, y
        torch.cuda.empty_cache()
    if any(launches.values()):
        fail("the vision steps launched flash kernels: %s" % launches)
    out["launches"] = launches
    emit(out)
    return launches


def _moe_inputs(rng, E, d, T):
    """Tokens with a clear top-2 routing: each token is 4x one gate row
    plus 2x another plus small noise, so the top-k boundary of every
    token's gate logits is far from a tie (``jax.lax.top_k`` and
    ``torch.topk`` break ties differently, and so could the card and the
    CPU on near-equal logits)."""
    gate = rng.standard_normal((E, d)).astype(np.float32) / np.sqrt(d)
    a = rng.integers(0, E, T)
    b = (a + rng.integers(1, E, T)) % E
    x = (4.0 * gate[a] + 2.0 * gate[b]
         + 0.1 * rng.standard_normal((T, d))).astype(np.float32)
    logits = np.sort(x @ gate.T, axis=1)[:, ::-1]
    return x, gate, float((logits[:, 1] - logits[:, 2]).min())


def _moe_case(torch, mx, seed, activation):
    """``MoE(num_experts=8, hidden_size=3072, units=768, top_k=2,
    activation=...)`` on 8 x 512 tokens, forward and backward on the card
    against the CPU with the same weights.  Returns the largest error of
    the output and each gradient, elementwise (/ max(1, max|ref|)) and
    in norm (||card - cpu|| / ||cpu||), and the card's fwd+bwd time."""
    from mxnet_tpu_torch.gluon import nn

    E, hidden, units, B, T = 8, 3072, 768, 8, 512
    rng = np.random.default_rng(seed + 13)
    x, gate, gap = _moe_inputs(rng, E, units, B * T)
    if gap < 0.1:
        fail("MoE inputs come within %g of a routing tie" % gap)
    w = {"w1": rng.standard_normal((E, units, hidden)) / np.sqrt(units),
         "b1": 0.1 * rng.standard_normal((E, hidden)),
         "w2": rng.standard_normal((E, hidden, units)) / np.sqrt(hidden),
         "b2": 0.1 * rng.standard_normal((E, units)), "gate": gate}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    ct = rng.standard_normal((B, T, units)).astype(np.float32)
    res = {}
    for where, ctx in (("card", None), ("cpu", mx.cpu())):
        blk = nn.MoE(E, hidden, units, top_k=2, activation=activation)
        blk.initialize(ctx=ctx)
        mx.convert.load_jax_params(blk, w)
        dev = mx.context.device_of(ctx)
        xt = torch.from_numpy(x.reshape(B, T, units)).to(dev)
        xt.requires_grad_()
        ctt = torch.from_numpy(ct).to(dev)

        def run():
            with mx.autograd.record():
                out = blk(xt)
            (out * ctt).sum().backward()
            return out

        out = run()
        res[where] = [out.detach()] + [xt.grad] + [
            p.grad for p in blk.collect_params().values()]
        if where == "card":
            def again():
                xt.grad = None
                blk.zero_grad(set_to_none=True)
                run()
            fwd_bwd_ms = cuda_ms(again, 5)
    names = ["out", "x_grad"] + ["%s_grad" % n for n in w]
    elem, norm = {}, {}
    for n, got, ref in zip(names, res["card"], res["cpu"]):
        diff = got.cpu().double() - ref.double()
        elem[n] = float(diff.abs().max()) / max(1.0, float(ref.abs().max()))
        norm[n] = float(diff.norm() / ref.double().norm())
    flops = 3 * 2 * E * B * T * 2 * units * hidden
    return {"num_experts": E, "hidden_size": hidden, "units": units,
            "top_k": 2, "activation": activation, "tokens": [B, T],
            "min_routing_gap": gap, "max_rel_err": elem,
            "norm_rel_err": norm, "fwd_bwd_ms": fwd_bwd_ms,
            "fwd_bwd_flops": flops,
            "fwd_bwd_bound_ms": flops / PEAK_FLOPS["float32"] * 1e3}


def phase_vision_zoo(torch, mx, fa, seed, smi):
    """One full-width member of each family: a B=8 forward on the card (f32,
    TF32 off) and on the CPU with the same weights, within TOL_ZOO; then
    ``_moe_case``."""
    from mxnet_tpu_torch.gluon.model_zoo import vision

    counters = [getattr(fa, n) for n in ("flash_attention", "flash_bwd_dq",
                                         "flash_bwd_dkv")]
    for c in counters:
        c.launches = 0
    rng = np.random.default_rng(seed + 12)
    models = {}
    for name, hw in ZOO_MODELS:
        x = rng.random((8, 3, hw, hw), np.float32)
        net = _vision_net(torch, mx, vision, name, hw, seed)
        xc = torch.from_numpy(x).cuda()
        got = net(xc)
        torch.cuda.synchronize()
        fwd_ms = cuda_ms(lambda: net(xc), 3)
        got = got.cpu()
        cpu = vision.get_model(name, classes=1000)
        cpu.initialize(ctx=mx.cpu())
        mx.convert.load_jax_params(cpu, {k: p.detach().cpu().numpy()
                                         for k, p in
                                         net.collect_params().items()})
        want = cpu(torch.from_numpy(x))
        err = float((got - want).abs().max()) / max(
            1.0, float(want.abs().max()))
        if got.shape != (8, 1000) or not torch.isfinite(got).all():
            fail("%s: card output %s" % (name, tuple(got.shape)))
        if err > TOL_ZOO:
            fail("%s: card vs CPU %.3g" % (name, err))
        models[name] = {"image": [3, hw, hw], "max_rel_err": err,
                        "params": sum(p.numel() for p in
                                      net.collect_params().values()),
                        "fwd_ms_b8": fwd_ms}
        del net, cpu, xc
        torch.cuda.empty_cache()
    moe = [_moe_case(torch, mx, seed, act) for act in ("relu", "gelu")]
    launches = {c.__name__: c.launches for c in counters}
    emit({"phase": "vision_zoo", "batch": 8, "dtype": "float32",
          "tf32": False, "tol": TOL_ZOO, "models": models, "moe": moe,
          "launches": launches, "card": smi})
    if any(launches.values()):
        fail("the zoo forwards launched flash kernels: %s" % launches)
    # the output elementwise; the gradients elementwise for the smooth
    # gelu experts and in norm for relu ones: there a few hidden units
    # whose pre-activation is within rounding of 0 take the other branch
    # on the card, and each moves its token's input gradient by a w1 row
    for case in moe:
        checks = {n: case["max_rel_err"][n] for n in case["max_rel_err"]}
        if case["activation"] == "relu":
            checks = {n: (case["norm_rel_err"][n] if n != "out" else e)
                      for n, e in checks.items()}
        bad = {n: e for n, e in checks.items() if e > TOL_ZOO}
        if bad:
            fail("MoE (%s) card vs CPU: %s" % (case["activation"], bad))
    return launches


_GEMM_OPS = ("mm", "addmm", "bmm", "baddbmm", "matmul", "linear",
             "addmv", "mv", "dot")


def _gemm_dtypes(torch, fn):
    """{dtype: count} of the matrix-product ops ``fn`` dispatches (aten
    ``mm``, ``addmm``, ``bmm``, ...), read by a ``TorchDispatchMode``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = {}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ in _GEMM_OPS:
                dt = str(args[0].dtype).replace("torch.", "")
                seen[dt] = seen.get(dt, 0) + 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return seen


def _gemm_dtype_class(name):
    """``_kernel_class`` with the GEMMs split by the type their cuBLAS or
    CUTLASS name carries: ``gemm_f16`` (f16/h16/hgemm/``_hsh``/``_hss``),
    ``gemm_f32`` (f32/sgemm/``_sss``), else ``gemm``."""
    cls = _kernel_class(name)
    if cls != "gemm":
        return cls
    low = name.lower()
    if any(t in low for t in ("f16", "h16", "hgemm", "_hsh", "_hss", "fp16",
                              "half")):
        return "gemm_f16"
    if any(t in low for t in ("f32f32", "sgemm", "_sss", "fp32")):
        return "gemm_f32"
    return "gemm"


def phase_train_amp_fp16(torch, mx, fa, seed, smi, fp32=None):
    """``phase_train``'s BERT-base pretraining (``gluon.Trainer``, Adam
    1e-4, B=8, T=512, dropout 0.1, 10 steps) the Gluon amp way:
    ``amp.init('float16')``, ``amp.init_trainer``, and each step
    ``scale(loss)``, backward, ``has_overflow``, ``unscale``, the update
    unless it overflowed, ``update_scale``; step 5's first gradient gets an
    inf, which must halve the scale and skip that update.  ``fp32``:
    ``phase_train``'s medians, printed beside this phase's."""
    from mxnet_tpu_torch.contrib import amp
    from mxnet_tpu_torch.gluon.model_zoo import bert

    B, T, M, vocab, steps, inject = 8, 512, 76, 30522, 10, 5
    net = bert.bert_12_768_12(pretraining=True, vocab_size=vocab,
                              max_length=T, dropout=DROPOUT_P)
    net.initialize()
    mx.convert.load_jax_params(net, bert_params(net, seed))
    params = net.collect_params()
    trainable = [p for p in params.values() if p.grad_req != "null"]
    trainer = mx.gluon.Trainer(params, "adam", {"learning_rate": 1e-4})
    rng = np.random.default_rng(seed + 2)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in _train_batch(rng, B, T, M, vocab).items()}
    amp.init("float16")
    try:
        amp.init_trainer(trainer)
        scaler = trainer._amp_loss_scaler
        mx.random.seed(seed)

        def forward():
            with mx.autograd.record():
                mlm, nsp = net(batch["ids"], batch["types"], None,
                               batch["pos"])
                loss = bert.pretraining_loss(mlm, nsp, batch["labels"],
                                             batch["weights"], batch["nsp"])
                scaled = scaler.scale(loss)
            return loss, scaled

        names = ("flash_attention", "flash_bwd_dq", "flash_bwd_dkv")
        counters = [getattr(fa, n) for n in names]
        seen, check = {}, fa._check_cuda

        def spy(name, ts, shapes):
            seen.setdefault(name, set()).add(str(ts[0].dtype))
            return check(name, ts, shapes)

        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, scales, skipped, rows = [], [], [], []
        fa._check_cuda = spy
        try:
            for i in range(steps):
                t0 = time.perf_counter()
                loss, scaled = forward()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                mx.autograd.backward(scaled)
                grads = [p.grad for p in trainable]
                if i == inject:
                    grads[0].view(-1)[0] = float("inf")
                    snap = trainable[0].detach().clone()
                    scale_before = scaler.loss_scale
                overflow = scaler.has_overflow(grads)
                t2 = time.perf_counter()
                if not overflow:
                    scaler.unscale(grads)
                    trainer.step(1)
                scaler.update_scale(overflow)
                torch.cuda.synchronize()
                t3 = time.perf_counter()
                if i == inject:
                    if not overflow:
                        fail("the injected inf gradient was not seen")
                    if scaler.loss_scale != scale_before / 2:
                        fail("loss scale %g -> %g on the overflow"
                             % (scale_before, scaler.loss_scale))
                    if not torch.equal(trainable[0].detach(), snap):
                        fail("the overflowed step updated the weights")
                    dtypes = {(str(p.dtype), str(p.grad.dtype))
                              for p in trainable}
                    if dtypes != {("torch.float32", "torch.float32")}:
                        fail("parameters and gradients: %s" % dtypes)
                losses.append(loss.item())
                scales.append(scaler.loss_scale)
                skipped.append(bool(overflow))
                rows.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3,
                             (t3 - t2) * 1e3))
        finally:
            fa._check_cuda = check
        launches = {c.__name__: c.launches for c in counters}
        peak = torch.cuda.max_memory_allocated()
        gemms = _gemm_dtypes(torch, forward)
        split = profile_split(
            torch, lambda: mx.autograd.backward(forward()[1]), 2,
            _gemm_dtype_class, named=("gemm", "gemm_f16", "gemm_f32",
                                      "other"))
    finally:
        amp.disable()

    if seen != {n: {"torch.float16"} for n in names}:
        fail("the amp step handed the kernels %s" % seen)
    for name, n in launches.items():
        if n != 12 * steps:
            fail("%s launched %d times in %d amp steps (want 12 per step)"
                 % (name, n, steps))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail("amp fp16 losses: %s" % losses)
    if set(gemms) != {"float16"}:
        fail("the amp forward's matrix products ran in %s" % gemms)
    step_ms = [sum(r) for r in rows]
    med = float(np.median(step_ms))
    emit({"phase": "train_amp_fp16", "model": "bert_12_768_12",
          "head": "BERTForPretraining", "trainer": "gluon.Trainer",
          "amp": "float16", "batch": B, "seq_len": T, "masked_positions": M,
          "dropout": DROPOUT_P, "optimizer": "adam", "lr": 1e-4,
          "steps": steps, "losses": losses, "loss_scales": scales,
          "skipped": skipped, "injected_overflow_step": inject,
          "launches": launches,
          "kernel_dtypes": {n: sorted(v) for n, v in seen.items()},
          "forward_gemm_dtypes": gemms, "profile": split,
          "step_ms": step_ms, "step_ms_median": med,
          "forward_ms_median": float(np.median([r[0] for r in rows])),
          "backward_ms_median": float(np.median([r[1] for r in rows])),
          "update_ms_median": float(np.median([r[2] for r in rows])),
          "tokens_per_s": B * T / (med / 1e3),
          "train_fp32_same_run": fp32,
          "max_memory_allocated_bytes": peak, "card": smi})
    return launches


CKPT_CFG = dict(B=8, T=512, M=76, vocab=30522, bf16_B=16, bf16_steps=10,
                save_at=5, n_req=32, layers=12)
CKPT_SEEDS = (1001, 1002)   # mx.random.seed before step 1 and step 4


def _flash_counts(fa):
    return {c.__name__: c.launches for c in (
        fa.flash_attention, fa.flash_bwd_dq, fa.flash_bwd_dkv)}


def _reset_flash(fa):
    for c in (fa.flash_attention, fa.flash_bwd_dq, fa.flash_bwd_dkv):
        c.launches = 0


def _want_launches(fa, per_step, steps, what):
    got = _flash_counts(fa)
    if got != {n: per_step * steps for n in got}:
        fail("%s: flash launches %s in %d steps (want %d a step each)"
             % (what, got, steps, per_step))
    return got


def _spread(torch, a, b):
    """(worst |a - b| / max(1, max|b|) over paired tensors, bitwise)."""
    worst, same = 0.0, True
    for x, y in zip(a, b):
        same &= bool(torch.equal(x, y))
        worst = max(worst, (x.float() - y.float()).abs().max().item()
                    / max(1.0, y.float().abs().max().item()))
    return worst, same


def _loss_spread(a, b):
    return max(abs(x - y) / max(1.0, abs(y)) for x, y in zip(a, b))


def _first_divergence(torch, make, step_fn):
    """Where two identical steps of fresh ``make()`` nets first part: the
    first module (in call order) whose output differs, else the first
    parameter whose gradient differs, else None."""
    runs = []
    for _ in range(2):
        net = make()
        outs = []

        def hook(block, args, out, outs=outs):
            t = out[0] if isinstance(out, (tuple, list)) else out
            if hasattr(t, "detach"):
                outs.append((type(block).__name__, t.detach().clone()))

        handles = [m.register_forward_hook(hook) for m in net.modules()]
        step_fn(net)
        for h in handles:
            h.remove()
        grads = [(n, p.grad.clone() if p.grad is not None else None)
                 for n, p in net.collect_params().items()]
        runs.append((outs, grads))
        del net
    (o1, g1), (o2, g2) = runs
    for i, ((kind, x), (_, y)) in enumerate(zip(o1, o2)):
        if x.shape != y.shape or not torch.equal(x, y):
            return "forward: module %d (%s)" % (i, kind)
    for (n, x), (_, y) in zip(g1, g2):
        if x is not None and not torch.equal(x, y):
            return "backward: gradient of %s" % n
    return None


def _lookup_paths(rng):
    """The lookups each main path runs with a gradient on the card, at
    its shapes, indices and dtype: ``[(path, phases, dtype, lookups)]``,
    a lookup ``(name, table rows, width, indices)``, rows None for the
    gather of the masked positions ((B, T, width) by (B, M))."""
    c, lstm, lstm650, gpt = CKPT_CFG, LSTM_CFG, LSTM_650_CFG, GPT_CFG
    V, T, M = c["vocab"], c["T"], c["M"]

    def bert(B, replace, types):
        pos = rng.choice(T, (B, M)) if replace else np.stack(
            [rng.choice(T, M, replace=False) for _ in range(B)])
        return [("word", V, 768, rng.integers(0, V, (B, T))),
                ("token_type", 2, 768, types), ("gather", None, 768, pos)]

    half = (np.arange(T)[None, :] >= T // 2).repeat(c["B"], 0)
    zipf = _zipf_stream(int(rng.integers(1 << 30)), 50257,
                        gpt["B"] * gpt["T"]).reshape(gpt["B"], gpt["T"])
    zipf650 = _zipf_stream(int(rng.integers(1 << 30)), lstm650["vocab"],
                           lstm650["B"] * lstm650["T"])
    return [
        ("bert B=8", "train, train_captured, train_amp_fp16 (the lookups "
         "run in float32 there), checkpoint_resume", "float32",
         bert(c["B"], False, half)),
        ("bert B=16", "train_bf16, checkpoint_resume", "bfloat16",
         bert(c["bf16_B"], True,
              rng.integers(0, 2, (c["bf16_B"], T)))),
        ("gpt_lm B=8 T=1024", "train_gpt_lm", "bfloat16",
         [("word", 50257, 256, zipf)]),
        ("lstm B=32 T=64", "train_lstm", "float32",
         [("word", lstm["vocab"], lstm["hidden"],
           rng.integers(0, lstm["vocab"], (lstm["B"], lstm["T"])))]),
        ("lstm_650 B=32 T=35", "train_lstm (standard_lstm_lm_650)",
         "float32", [("word", lstm650["vocab"], 650,
                      zipf650.reshape(lstm650["B"], lstm650["T"]))]),
        ("bert B=8 float16", "none (a net cast to float16)", "float16",
         bert(c["B"], True, half)),
    ]


def _lookup_backward(torch, seed):
    """One backward of each lookup of ``_lookup_paths``: the port's
    fixed-order sums (``ops.nn.embedding``, ``take_along_axis``) against
    PyTorch's own backward, which adds a row's repeats in no fixed order
    on the card.  Device ms of each and their difference a step; the
    fixed-order gradient twice, which must give the same bits; a 16-bit
    one against the float32 path on the same values, which it must meet
    within one unit in the last place of its type at the largest value
    (``torch.finfo(dtype).eps`` x max(1, max|want|))."""
    import torch.nn.functional as tf

    from mxnet_tpu_torch.ops import nn as ops_nn

    rows = []
    for path, phases, dname, lookups in _lookup_paths(
            np.random.default_rng(seed + 9)):
        dt = getattr(torch, dname)
        row = {"path": path, "phases": phases, "dtype": dname}
        step_fixed = step_pytorch = 0.0
        for name, table, units, idx in lookups:
            i = torch.from_numpy(np.asarray(idx, np.int64)).cuda()
            # indices that repeat one before them: over the batch for a
            # table, within a row for the gather
            runs = [idx] if table is not None else list(idx)
            repeats = int(sum(np.size(r) - np.unique(r).size for r in runs))
            if table is None:
                B, M = i.shape
                i = i.unsqueeze(-1).expand(B, M, units)
                shape, out_shape = (B, CKPT_CFG["T"], units), (B, M, units)

                def fixed(t, i=i):
                    return ops_nn.take_along_axis(t, i, 1)

                def plain(t, i=i):
                    return torch.gather(t, 1, i)
            else:
                shape, out_shape = (table, units), (*i.shape, units)

                def fixed(t, i=i):
                    return ops_nn.embedding(i, t)

                def plain(t, i=i):
                    return tf.embedding(i, t)
            x = torch.randn(shape, device="cuda").to(dt).requires_grad_()
            g = torch.randn(out_shape, device="cuda").to(dt)
            ys = {"fixed_order": fixed(x), "pytorch": plain(x)}

            def grad(route, ys=ys, x=x, g=g):
                return torch.autograd.grad(ys[route], x, g,
                                           retain_graph=True)[0]

            got = grad("fixed_order")
            if not torch.equal(got, grad("fixed_order")):
                fail("%s %s: the fixed-order gradient differs run to run"
                     % (path, name))
            ms = {r: cuda_ms(lambda r=r: grad(r), 10) for r in ys}
            row[name] = {"repeats": repeats,
                         "fixed_order_ms": ms["fixed_order"],
                         "pytorch_ms": ms["pytorch"],
                         "pytorch_bitwise_run_to_run": bool(torch.equal(
                             grad("pytorch"), grad("pytorch")))}
            if dt != torch.float32:
                x32 = x.detach().float().requires_grad_()
                want = torch.autograd.grad(fixed(x32), x32, g.float())[0]
                err = ((got.float() - want).abs().max().item()
                       / max(1.0, want.abs().max().item()))
                tol = torch.finfo(dt).eps
                row[name].update(vs_float32_err=err, tol=tol)
                if err > tol:
                    fail("%s %s: %s gradient off the float32 path by %g "
                         "(tol %g)" % (path, name, dname, err, tol))
            step_fixed += ms["fixed_order"]
            step_pytorch += ms["pytorch"]
            del x, g, ys, got
        row.update(step_fixed_order_ms=step_fixed,
                   step_pytorch_ms=step_pytorch,
                   step_delta_ms=step_fixed - step_pytorch)
        rows.append(row)
    return rows


def _tied_trainer(torch, mx, seed, U=1024, B=64, steps=3):
    """A net holding one ``Dense(U)``'s parameters under two names
    (``share_parameters``), trained ``steps`` steps by ``gluon.Trainer``
    with Adam (wd 1e-2) on the card, stitched and through
    ``trainer.capture``, against the same on the CPU: the trainer gives
    the shared weight one update a name, the second in a later group, so
    no multi-tensor launch updates one buffer from two list entries.
    Adam's epsilon is 1: near |g| ~ epsilon Adam passes a gradient's
    rounding (which the CPU and the card take apart) on to the weight
    times lr / epsilon, here 1e-2; one update a step lands ~1e-2 away."""
    nn = mx.gluon.nn
    rng = np.random.default_rng(seed + 11)
    w = rng.standard_normal((U, U)).astype(np.float32) / np.sqrt(U)
    b = rng.standard_normal(U).astype(np.float32) * 0.1
    xs = [rng.standard_normal((B, U)).astype(np.float32)
          for _ in range(steps)]
    opts = {"learning_rate": 1e-2, "wd": 1e-2, "epsilon": 1.0}

    def loss_fn(out, _):
        return (out ** 2).sum()

    def build(ctx):
        net = nn.HybridSequential()
        first, second = nn.Dense(U, in_units=U), nn.Dense(U, in_units=U)
        net.add(first, second)
        net.initialize(ctx=ctx)
        second.share_parameters(first.collect_params())
        with torch.no_grad():
            first.weight.copy_(torch.from_numpy(w))
            first.bias.copy_(torch.from_numpy(b))
        return net, mx.gluon.Trainer(net.collect_params(), "adam",
                                     dict(opts))

    def run(ctx, captured):
        net, tr = build(ctx)
        dev = "cpu" if ctx is not None else "cuda"
        program = tr.capture(net, loss_fn) if captured else None
        for x in xs:
            x = torch.from_numpy(x).to(dev)
            if captured:
                program(x, torch.zeros(B, device=dev), batch_size=B)
            else:
                with mx.autograd.record():
                    loss = loss_fn(net(x), None)
                loss.backward()
                tr.step(B)
        names = list(net.collect_params())
        if names != ["0.weight", "0.bias", "1.weight", "1.bias"]:
            fail("tied net lists %s" % names)
        out = [p.detach().cpu().clone() for p in (net[0].weight,
                                                   net[0].bias)]
        if captured:
            rep = program.report()
            if rep["fallbacks"] or rep["paths"]["stitched"]:
                fail("tied captured step ran %s (fallbacks %s)"
                     % (rep["paths"], rep["fallbacks"]))
        return out

    want = run(mx.cpu(), False)
    net, _ = build(mx.cpu())                  # one update a step, for scale
    params = net.collect_params()
    tr = mx.gluon.Trainer({k: params[k] for k in ("0.weight", "0.bias")},
                          "adam", dict(opts))
    for x in xs:
        with mx.autograd.record():
            loss = loss_fn(net(torch.from_numpy(x)), None)
        loss.backward()
        tr.step(B)
    once = [p.detach().clone() for p in (net[0].weight, net[0].bias)]
    out = {"units": U, "batch": B, "steps": steps, "optimizer": "adam",
           "opts": opts, "tol": 1e-5,
           "one_update_a_step_off_by": _spread(torch, once, want)[0]}
    for route in ("stitched", "captured"):
        err, _ = _spread(torch, run(None, route == "captured"), want)
        out["%s_vs_cpu" % route] = err
        if err > 1e-5:
            fail("tied %s Adam on the card off the CPU run by %g"
                 % (route, err))
    if out["one_update_a_step_off_by"] <= 1e-3:
        fail("tied check cannot tell one update a step from two (%g)"
             % out["one_update_a_step_off_by"])
    return out


def _restored_leaves_on_card(torch, root):
    """Every leaf of ``root``'s latest step, restored without ``ctx``, is a
    CUDA tensor of the dtype its manifest names."""
    from mxnet_tpu_torch import checkpoint as ckpt
    from mxnet_tpu_torch.checkpoint import layout

    mgr = ckpt.CheckpointManager(root, recover=False)
    manifest = mgr.manifest()
    _, tree = mgr.restore()
    bad = []
    for e, t in zip(manifest["leaves"], layout.tree_leaves(tree)):
        want = e["dtype"]
        got = "bfloat16" if t.dtype == torch.bfloat16 else str(
            torch.empty(0, dtype=t.dtype).numpy().dtype)
        if not t.is_cuda or got != want:
            bad.append((e["name"], str(t.device), got, want))
    if bad:
        fail("restored leaves off the card or of another dtype: %s"
             % bad[:5])
    return len(manifest["leaves"])


def _ckpt_stats(root, step):
    from mxnet_tpu_torch import checkpoint as ckpt

    m = ckpt.CheckpointManager(root, recover=False).manifest(step)
    return {"leaves": m["n_leaves"], "files": len(m["files"]) + 2,
            "bytes": sum(f["nbytes"] for f in m["files"].values())}


def phase_checkpoint_resume(torch, mx, fa, seed, smi, cfg=CKPT_CFG):
    """Persistence on the card: a BERT-base ``gluon.Trainer`` run saved at
    step 3 and resumed in a fresh net and trainer, the bf16
    ``FusedTrainer`` saved asynchronously and restored, a captured step
    restored under its program, and ``serve.Server(factory, root)`` serving
    the checkpoints with a hot ``swap`` under load."""
    from mxnet_tpu_torch.gluon.model_zoo import bert

    B, T, M, vocab, L = (cfg[k] for k in ("B", "T", "M", "vocab", "layers"))
    s0, s1 = CKPT_SEEDS
    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="mx-checkpoint-smoke-")
    out = {}
    launches = {"float32": {}, "bfloat16": {}}

    def add(route, counts):
        for k, v in counts.items():
            launches[route][k] = launches[route].get(k, 0) + v

    weights = {}

    def fp32_net():
        net = bert.bert_12_768_12(pretraining=True, vocab_size=vocab,
                                  max_length=T, dropout=DROPOUT_P,
                                  num_layers=L)
        net.initialize()                    # no ctx: the card
        if not weights:
            weights.update(bert_params(net, seed))
        mx.convert.load_jax_params(net, weights)
        return net

    host = _train_batch(np.random.default_rng(seed + 2), B, T, M, vocab)
    batch = {k: torch.from_numpy(v).cuda() for k, v in host.items()}

    def train(net, trainer, n):
        losses = []
        for _ in range(n):
            losses.append(_train_step(mx, bert, net, batch).item())
            trainer.step(1)
        return losses

    def params_of(net):
        return [p.detach().clone() for p in net.collect_params().values()]

    try:
        # ---- 1. fp32 resume through gluon.Trainer ----------------------
        runs = []
        for _ in range(2):                  # run A, twice
            net = fp32_net()
            tr = mx.gluon.Trainer(net.collect_params(), "adam",
                                  {"learning_rate": 1e-4})
            _reset_flash(fa)
            mx.random.seed(s0)
            la = train(net, tr, 3)
            mx.random.seed(s1)
            la += train(net, tr, 3)
            add("float32", _want_launches(fa, 12, 6, "fp32 run A"))
            runs.append((la, params_of(net)))
            del net, tr
        (la, wa), (la2, wa2) = runs
        spread_w, a_bitwise = _spread(torch, wa2, wa)
        spread_l = _loss_spread(la2, la)
        diverges = None
        if not a_bitwise or la != la2:
            def one_step(net):
                mx.random.seed(s0)
                _train_step(mx, bert, net, batch)

            diverges = _first_divergence(torch, fp32_net, one_step)

        fp32_root = os.path.join(work, "fp32")
        serve_root = os.path.join(work, "serve")
        net = fp32_net()
        tr = mx.gluon.Trainer(net.collect_params(), "adam",
                              {"learning_rate": 1e-4})
        _reset_flash(fa)
        mx.random.seed(s0)
        lb = train(net, tr, 3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.save_checkpoint(fp32_root)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        report = mx.checkpoint.CheckpointManager(
            fp32_root, recover=False).validate()
        validate_s = time.perf_counter() - t0
        if not all(r["ok"] for r in report.values()):
            fail("validate() after the fp32 save: %s" % report)
        net.bert.save_checkpoint(serve_root, step=3)   # the served model
        served3 = net.bert
        del tr
        net2 = fp32_net()
        tr2 = mx.gluon.Trainer(net2.collect_params(), "adam",
                               {"learning_rate": 1e-4})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step = tr2.load_checkpoint(fp32_root)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if step != 3 or tr2.step_count != 3:
            fail("fp32 restore gave step %s / %s" % (step, tr2.step_count))
        mx.random.seed(s1)
        lb += train(net2, tr2, 3)
        add("float32", _want_launches(fa, 12, 6, "fp32 run B"))
        wb = params_of(net2)
        err_w, b_bitwise = _spread(torch, wb, wa)
        err_l = _loss_spread(lb[3:], la[3:])
        if a_bitwise and la == la2:
            if not (b_bitwise and lb[3:] == la[3:]):
                fail("fp32 resume is not bit-identical: losses %s vs %s, "
                     "weights off by %g" % (lb[3:], la[3:], err_w))
        elif err_w > spread_w or err_l > spread_l:
            fail("fp32 resume off by %g (weights) / %g (losses), beyond "
                 "the run-to-run spread %g / %g (%s)"
                 % (err_w, err_l, spread_w, spread_l, diverges))
        stats = _ckpt_stats(fp32_root, 3)
        leaves_fp32 = _restored_leaves_on_card(torch, fp32_root)
        out["fp32"] = {
            "model": "bert_12_768_12", "layers": L, "card": smi,
            "trainer": "gluon.Trainer", "optimizer": "adam", "lr": 1e-4,
            "batch": B, "seq_len": T, "dropout": DROPOUT_P, "tf32": False,
            "losses_a": la, "losses_a_repeat": la2, "losses_b": lb,
            "run_to_run_bitwise": a_bitwise and la == la2,
            "run_to_run_weights": spread_w, "run_to_run_losses": spread_l,
            "first_divergence": diverges,
            "resume_bitwise": b_bitwise and lb[3:] == la[3:],
            "resume_weights_max_rel_err": err_w,
            "resume_losses_max_rel_err": err_l,
            "bytes_written": stats["bytes"], "leaves": stats["leaves"],
            "files": stats["files"], "save_s": save_s,
            "save_gb_per_s": stats["bytes"] / save_s / 1e9,
            "validate_s": validate_s,
            "validate_gb_per_s": stats["bytes"] / validate_s / 1e9,
            "restore_s": restore_s,
            "restore_gb_per_s": stats["bytes"] / restore_s / 1e9,
            "restored_leaves_on_card": leaves_fp32}
        emit(dict(out["fp32"], phase="checkpoint_resume", part="fp32"))
        shutil.rmtree(fp32_root)
        del wa2, runs

        # ---- 4. serving the checkpoints, and the hot swap under load --
        out["serve"] = _serve_from_checkpoint(
            torch, mx, fa, bert, cfg, seed, serve_root, served3, net2.bert,
            add)
        emit(dict(out["serve"], phase="checkpoint_resume", part="serve"))
        del net, net2, served3, wa, wb
        torch.cuda.empty_cache()

        # ---- 2. bf16 FusedTrainer: async save, restore ------------------
        out["bf16"] = _fused_resume(torch, mx, fa, bert, cfg, seed,
                                    os.path.join(work, "bf16"), add)
        emit(dict(out["bf16"], phase="checkpoint_resume", part="bf16"))
        torch.cuda.empty_cache()

        # ---- 3. captured: restore under the program ---------------------
        out["captured"] = _captured_resume(torch, mx, fa, bert, cfg, seed,
                                           os.path.join(work, "captured"),
                                           add)
        emit(dict(out["captured"], phase="checkpoint_resume",
                  part="captured"))
        torch.cuda.empty_cache()

        # ---- the Trainer over a shared parameter, and the lookups' sums
        out["tied"] = _tied_trainer(torch, mx, seed)
        emit(dict(out["tied"], phase="checkpoint_resume", part="tied"))
        for row in _lookup_backward(torch, seed):
            emit(dict(row, phase="checkpoint_resume", part="lookups",
                      card=smi))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "checkpoint_resume", "part": "summary", "model":
          "bert_12_768_12", "layers": L, "launches": launches,
          "seconds": time.perf_counter() - t_phase, "card": smi})
    return launches


def _serve_requests(rng, n, T, vocab):
    reqs = []
    for L in rng.integers(64, T + 1, n):
        ids = rng.integers(0, vocab, L).astype(np.int32)
        types = (np.arange(L) >= L // 2).astype(np.int32)
        reqs.append((ids, types))
    return reqs


def _served_refs(torch, block, reqs, T):
    """Each request through ``block`` on the card, zero-padded to T as the
    server pads it, 8 a batch: [(seq (L, C), pooled (C,)) on the host]."""
    refs = []
    for i in range(0, len(reqs), 8):
        part = reqs[i:i + 8]
        ids = np.zeros((len(part), T), np.int32)
        types = np.zeros((len(part), T), np.int32)
        for j, (a, b) in enumerate(part):
            ids[j, :len(a)], types[j, :len(b)] = a, b
        with torch.inference_mode():
            seq, pooled = block(torch.from_numpy(ids).cuda(),
                                torch.from_numpy(types).cuda())
        for j, (a, _) in enumerate(part):
            refs.append((seq[j, :len(a)].cpu().numpy(),
                         pooled[j].cpu().numpy()))
    return refs


def _served_err(got, ref):
    """|got - ref| / max(1, max|ref|) over both outputs."""
    return max(float(np.abs(g - r).max()) / max(1.0, float(np.abs(r).max()))
               for g, r in zip(got, ref))


def _serve_from_checkpoint(torch, mx, fa, bert, cfg, seed, root, block3,
                           block6, add):
    """``serve.Server(factory, root)`` serving step 3, then ``swap(step=6)``
    while requests are in flight."""
    T, vocab, n_req, L = cfg["T"], cfg["vocab"], cfg["n_req"], cfg["layers"]
    gate = 1e-4
    reqs = _serve_requests(np.random.default_rng(seed + 7), n_req, T, vocab)
    _reset_flash(fa)
    ref3 = _served_refs(torch, block3, reqs, T)
    ref6 = _served_refs(torch, block6, reqs, T)
    ref_launches = _flash_counts(fa)["flash_attention"]
    apart = min(_served_err(a, b) for a, b in zip(ref3, ref6))
    if apart <= 10 * gate:
        fail("steps 3 and 6 serve alike (%g apart): the swap would be "
             "unseen" % apart)
    built = []

    def factory():
        t0 = time.perf_counter()
        blk = bert.bert_12_768_12(vocab_size=vocab, max_length=T,
                                  num_layers=L)
        built.append(time.perf_counter() - t0)
        return blk

    conf = mx.serve.ServeConfig(max_batch_size=8,
                                sample_shapes=[((T,), (T,))], dtype="int32")
    _reset_flash(fa)
    mx.telemetry.reset()
    t0 = time.perf_counter()
    srv = mx.serve.Server(factory, root, config=conf)   # JAX's order
    start_s = time.perf_counter() - t0
    try:
        if srv.runner.step != 3 or srv.runner.device.type != "cuda":
            fail("Server(factory, root) serves step %s on %s"
                 % (srv.runner.step, srv.runner.device))
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=n_req) as pool:
            got = list(pool.map(srv.submit, reqs))
        wall = time.perf_counter() - t0
        err3 = max(_served_err(g, r) for g, r in zip(got, ref3))
        if err3 > gate:
            fail("served step 3 differs from its block by %g" % err3)
        block6.save_checkpoint(root, step=6)

        # the swap under load: clients keep 32 requests in flight
        stop = threading.Event()
        done = []            # (request index, submitted at, answer)
        errors = []

        def client(k):
            i = k
            while not stop.is_set():
                t_sub = time.perf_counter()
                try:
                    ans = srv.submit(reqs[i % n_req])
                except Exception as exc:          # counted, then failed
                    errors.append(repr(exc))
                    return
                done.append((i % n_req, t_sub, time.perf_counter(), ans))
                i += n_req

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(n_req)]
        for t in threads:
            t.start()
        time.sleep(0.5)
        t0 = time.perf_counter()
        swapped = srv.swap(step=6)
        t1 = time.perf_counter()
        time.sleep(0.5)
        stop.set()
        for t in threads:
            t.join()
        if errors:
            fail("requests failed during the swap: %s" % errors[:3])
        if swapped != 6 or srv.runner.step != 6:
            fail("swap published step %s" % swapped)
        old = new = 0
        for i, t_sub, t_done, ans in done:
            e3, e6 = _served_err(ans, ref3[i]), _served_err(ans, ref6[i])
            if min(e3, e6) > gate:
                fail("answer %d matches neither step (%g / %g)"
                     % (i, e3, e6))
            if t_sub > t1 and e6 > gate:
                fail("a request submitted after swap() returned was "
                     "served by step 3 (%g off step 6)" % e6)
            old += e3 <= gate
            new += e6 <= gate and e3 > gate
        during = [d for d in done if t0 <= d[2] <= t1]
        with ThreadPoolExecutor(max_workers=n_req) as pool:
            after = list(pool.map(srv.submit, reqs))
        err6 = max(_served_err(g, r) for g, r in zip(after, ref6))
        if err6 > gate:
            fail("served step 6 differs from its block by %g" % err6)
        batches = int(mx.telemetry.value("serve_batches_total"))
        swaps = int(mx.telemetry.value("serve_model_swaps_total"))
        timings = srv.runner.timings
    finally:
        srv.shutdown()
    counts = _flash_counts(fa)
    warm = 2 * len(conf.batch_sizes)
    if counts["flash_attention"] != 12 * (batches + warm) or swaps != 1:
        fail("serving: %d flash launches over %d batches and %d warm-up "
             "calls, %d swaps" % (counts["flash_attention"], batches, warm,
                                  swaps))
    counts["flash_attention"] += ref_launches
    add("float32", counts)
    return {"server": "serve.Server(factory, root)", "requests": n_req,
            "gate": gate, "steps_apart_min": apart,
            "start_s": start_s, "requests_per_s": n_req / wall,
            "step3_max_rel_err": err3, "step6_max_rel_err": err6,
            "swap_s": t1 - t0, "swap_build_s": built[-1],
            "swap_restore_s": timings["restore_s"],
            "swap_warm_s": timings["warm_s"],
            "answers_during_swap": len(during),
            "requests_per_s_during_swap": len(during) / (t1 - t0),
            "answers_in_load": len(done), "answers_old": int(old),
            "answers_new": int(new), "failed": len(errors),
            "batches": batches}


def _fused_resume(torch, mx, fa, bert, cfg, seed, root, add):
    """The ``train_bf16`` recipe saved asynchronously at step ``save_at``
    and restored into a fresh ``FusedTrainer``.

    The restored tree must equal the saved state bit for bit, and the
    resumed step's loss and weights the uninterrupted run's.  The recipe's
    masked positions are drawn with replacement, so a row can gather one
    position twice; ``take_along_axis`` sums the two in a fixed order on
    the card, so two restores give the same bits.  Were they to differ,
    the resumed weights are held to the spread of the two instead, as the
    fp32 part does."""
    from mxnet_tpu_torch import checkpoint as ckpt
    from mxnet_tpu_torch.checkpoint import layout

    B, T, vocab, L = cfg["bf16_B"], cfg["T"], cfg["vocab"], cfg["layers"]
    steps, at = cfg["bf16_steps"], cfg["save_at"]
    M = max(1, int(T * 0.15))
    s0, s1 = CKPT_SEEDS
    rng = np.random.default_rng(seed + 3)
    pos = np.sort(rng.choice(T, (B, M)), axis=1)
    repeats = int(sum(M - len(np.unique(r)) for r in pos))
    x = tuple(torch.from_numpy(v).cuda() for v in (
        rng.integers(0, vocab, (B, T)), rng.integers(0, 2, (B, T)), pos))
    y = tuple(torch.from_numpy(v).cuda() for v in (
        rng.integers(0, vocab, (B, M)), rng.integers(0, 2, B)))

    def fused():
        net = pretrain_step(mx, bert, seed, vocab_size=vocab, max_length=T,
                            dropout=DROPOUT_P, num_layers=L)
        return net, mx.parallel.FusedTrainer(
            net, loss_fn=_pretrain_loss, optimizer="adam",
            optimizer_params={"learning_rate": 1e-4}, dtype="bfloat16")

    def timed_step(trainer):
        t0 = time.perf_counter()
        loss = trainer.step(x, y).item()
        return loss, (time.perf_counter() - t0) * 1e3

    net, tr = fused()
    _reset_flash(fa)
    mx.random.seed(s0)
    losses, ms = [], []
    for _ in range(at):
        l_, t_ = timed_step(tr)
        losses.append(l_)
        ms.append(t_)
    saved = [t.clone() for t in layout.tree_leaves(tr.state_dict())
             if isinstance(t, torch.Tensor)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fut = tr.save_checkpoint(root, block=False)
    snapshot_s = time.perf_counter() - t0
    mx.random.seed(s1)
    in_flight = []
    l_, t_ = timed_step(tr)
    losses.append(l_)
    in_flight.append(t_)
    want = [p.detach().clone() for p in net.collect_params().values()]
    while not fut.done() and len(losses) < steps:
        l_, t_ = timed_step(tr)
        losses.append(l_)
        in_flight.append(t_)
    t_commit = time.perf_counter()
    fut.result()
    wait_s = time.perf_counter() - t_commit
    after = []
    while len(losses) < steps:
        l_, t_ = timed_step(tr)
        losses.append(l_)
        after.append(t_)
    n_steps = len(losses)
    add("bfloat16", _want_launches(fa, 12, n_steps, "bf16 run"))
    if not all(np.isfinite(losses)):
        fail("nonfinite bf16 losses: %s" % losses)
    del net, tr
    torch.cuda.empty_cache()

    # the restored tree is the saved state, bit for bit
    _, tree = ckpt.CheckpointManager(root, recover=False).restore()
    got_tree = [t for t in layout.tree_leaves(tree)
                if isinstance(t, torch.Tensor) and t.dim() > 0]
    if len(got_tree) != len(saved) or not all(
            torch.equal(a, b) for a, b in zip(got_tree, saved)):
        fail("the bf16 checkpoint does not hold the saved state")
    del tree, got_tree, saved

    def resumed():
        net, tr = fused()
        t0 = time.perf_counter()
        step = tr.load_checkpoint(root)
        mx.random.seed(s1)
        loss = tr.step(x, y).item()
        restore_s = time.perf_counter() - t0
        if step != at or tr._step_count != at + 1:
            fail("bf16 restore gave step %s" % step)
        got = [p.detach().clone() for p in net.collect_params().values()]
        return loss, got, restore_s

    _reset_flash(fa)
    loss, got, restore_s = resumed()
    loss2, got2, _ = resumed()
    add("bfloat16", _want_launches(fa, 12, 2, "bf16 resumed steps"))
    err_w, bitwise = _spread(torch, got, want)
    spread_w, spread_bitwise = _spread(torch, got2, got)
    if loss != losses[at] or loss2 != losses[at]:
        fail("bf16 resumed loss %r / %r, the uninterrupted run's %r"
             % (loss, loss2, losses[at]))
    if spread_bitwise and not bitwise:
        fail("bf16 resumed weights are not bit-identical: off by %g"
             % err_w)
    if not spread_bitwise and err_w > spread_w:
        fail("bf16 resumed weights off by %g, beyond the spread %g of two "
             "restores" % (err_w, spread_w))
    masters = {t.dtype for t in got}
    if masters != {torch.float32}:
        fail("restored masters are %s" % masters)
    stats = _ckpt_stats(root, at)
    leaves = _restored_leaves_on_card(torch, root)
    return {"trainer": "parallel.FusedTrainer", "dtype": "bfloat16",
            "batch": B, "seq_len": T, "steps": n_steps, "saved_at": at,
            "repeated_masked_positions": repeats,
            "losses": losses, "resumed_losses": [loss, loss2],
            "restored_state_bitwise": True,
            "resumed_loss_bitwise": True,
            "resumed_weights_bitwise": bitwise,
            "resumed_weights_max_rel_err": err_w,
            "two_restores_weights_bitwise": spread_bitwise,
            "two_restores_weights_max_rel_err": spread_w,
            "snapshot_s": snapshot_s, "commit_wait_s": wait_s,
            "step_ms_without_save": ms[1:],
            "step_ms_median_without_save": float(np.median(ms[1:])),
            "step_ms_with_save_in_flight": in_flight,
            "step_ms_median_with_save_in_flight": float(np.median(in_flight)),
            "step_ms_after_commit": after,
            "restore_and_step_s": restore_s,
            "bytes_written": stats["bytes"], "leaves": stats["leaves"],
            "files": stats["files"],
            "snapshot_gb_per_s": stats["bytes"] / snapshot_s / 1e9,
            "restored_leaves_on_card": leaves}


def _captured_resume(torch, mx, fa, bert, cfg, seed, root, add):
    """The ``train_captured`` recipe: an uninterrupted captured run of six
    steps, and one that diverges after step 3, restores the step-3
    checkpoint under its live program and takes steps 4-6 again."""
    B, T, M, vocab, L = (cfg[k] for k in ("B", "T", "M", "vocab", "layers"))
    s0, s1 = CKPT_SEEDS
    host = _train_batch(np.random.default_rng(seed + 2), B, T, M, vocab)
    x = tuple(torch.from_numpy(host[k]).cuda() for k in ("ids", "types",
                                                          "pos"))
    y = tuple(torch.from_numpy(host[k]).cuda() for k in ("labels",
                                                          "weights", "nsp"))

    def loss_fn(out, labels, weights, nsp):
        return bert.pretraining_loss(out[0], out[1], labels, weights, nsp)

    def captured():
        net = pretrain_step(mx, bert, seed, vocab_size=vocab, max_length=T,
                            dropout=DROPOUT_P, num_layers=L)
        tr = mx.gluon.Trainer(net.collect_params(), "adam",
                              {"learning_rate": 1e-4})
        return net, tr, tr.capture(net, loss_fn)

    def run(program, n):
        return [program(x, y, batch_size=1).item() for _ in range(n)]

    _reset_flash(fa)
    net, tr, prog = captured()
    mx.random.seed(s0)
    la = run(prog, 3)
    tr.save_checkpoint(root)
    mx.random.seed(s1)
    la += run(prog, 3)
    want = [p.detach().clone() for p in net.collect_params().values()]
    rep_a = prog.report()
    counts_a = _flash_counts(fa)
    del net, tr, prog
    torch.cuda.empty_cache()

    _reset_flash(fa)
    net, tr, prog = captured()
    mx.random.seed(s0)
    lb = run(prog, 3)
    mx.random.seed(s0 + 7)          # two steps off the path...
    run(prog, 2)
    step = tr.load_checkpoint(root)  # ...then back to step 3
    mx.random.seed(s1)
    lb += run(prog, 3)
    got = [p.detach().clone() for p in net.collect_params().values()]
    rep_b = prog.report()
    counts_b = _flash_counts(fa)
    err_w, bitwise = _spread(torch, got, want)
    err_l = _loss_spread(lb[3:], la[3:])
    if step != 3 or err_w > 1e-5 or err_l > 1e-5:
        fail("captured resume: step %s, losses %s vs %s, weights off by %g"
             % (step, lb[3:], la[3:], err_w))
    for rep in (rep_a, rep_b):
        if rep["fallbacks"]:
            fail("captured step fell back: %s" % rep["fallbacks"])
    if rep_b["paths"]["stitched"] or rep_b["paths"]["captured"] != 8:
        fail("the restored program ran %s" % rep_b["paths"])
    # run A: one eager warm-up and one capture record 12 launches each;
    # run B captures again after the restore
    if counts_a != {n: 24 for n in counts_a} or \
            counts_b != {n: 48 for n in counts_b}:
        fail("captured flash launches %s / %s (want 24 / 48 each)"
             % (counts_a, counts_b))
    add("float32", counts_a)
    add("float32", counts_b)
    leaves = _restored_leaves_on_card(torch, root)
    return {"trainer": "gluon.Trainer.capture", "losses": la,
            "losses_resumed": lb, "resume_bitwise": bitwise
            and lb[3:] == la[3:], "resume_weights_max_rel_err": err_w,
            "resume_losses_max_rel_err": err_l, "tol": 1e-5,
            "paths": rep_b["paths"], "launches_uninterrupted": counts_a,
            "launches_resumed": counts_b,
            "restored_leaves_on_card": leaves}


DECODE_CFG = dict(vocab=50257, layers=12, heads=12, head_dim=64,
                  hidden=3072, page_size=16, max_context=1024, max_live=16,
                  max_new=64, clients=32, prompt_lo=16, prompt_hi=512,
                  system=768, sessions=8, spec_seqs=4, spec_k=4,
                  profile_steps=5)
# a served token may differ from its reference only where the reference's
# top-2 logit gap is at most this share of max|logit| (a near-tie, where
# the last bits of two summation orders decide)
TOL_TIE = 1e-4


def decoder_params(cfg, seed):
    """TinyDecoder weights at ``cfg``'s widths from numpy: N(0, 1)
    embeddings, dense weights N(0, 0.25 / fan_in) and biases N(0, 0.01), so
    the twelve norm-free layers keep the residual stream and the logits at
    O(1)."""
    rng = np.random.default_rng(seed)
    C, V, F = cfg["heads"] * cfg["head_dim"], cfg["vocab"], cfg["hidden"]
    shapes = {"embed.weight": (V, C), "unembed.weight": (V, C),
              "unembed.bias": (V,)}
    for i in range(cfg["layers"]):
        for n in "qkvo":
            shapes["%s%d.weight" % (n, i)] = (C, C)
            shapes["%s%d.bias" % (n, i)] = (C,)
        shapes["up%d.weight" % i] = (F, C)
        shapes["up%d.bias" % i] = (F,)
        shapes["down%d.weight" % i] = (C, F)
        shapes["down%d.bias" % i] = (C,)
    out = {}
    for name in sorted(shapes):
        shp = shapes[name]
        v = rng.standard_normal(shp, dtype=np.float32)
        if name.endswith("bias"):
            v *= 0.1
        elif not name.startswith("embed"):
            v *= 0.5 / np.sqrt(shp[1])
        out[name] = v
    return out


def _dense_reference(torch, blk, prompt, toks):
    """Each token of a stream recomputed by the prefill (S=0) path over the
    whole sequence, no pages: per position the argmax, the top-2 gap and
    max|logit|."""
    dev = blk.unembed.weight.device
    zero = torch.zeros((1, blk.num_layers, 0, blk.num_kv_heads,
                        blk.head_dim), device=dev)
    seq = list(prompt) + list(toks[:-1])
    with torch.no_grad():
        x, _, _ = blk.trunk(torch.tensor([seq], dtype=torch.int32,
                                         device=dev), zero, zero,
                            torch.zeros(1, dtype=torch.int32, device=dev))
        logits = blk.unembed(x[:, len(prompt) - 1:])[0]
        top = torch.topk(logits, 2, dim=-1).values
        ref = torch.stack([logits.argmax(-1).float(), top[:, 0] - top[:, 1],
                           logits.abs().amax(-1)]).cpu().numpy()
    return ref[0].astype(np.int64), ref[1], ref[2]


def _tie_count(what, toks, ref):
    """Near-ties where ``toks`` leaves its dense reference; any other
    difference fails.  Returns (ties, smallest gap / max|logit|)."""
    arg, gap, top = ref
    ties = 0
    for i, t in enumerate(toks):
        if t != arg[i]:
            if gap[i] > TOL_TIE * top[i]:
                fail("%s: token %d is %d where the dense reference gives %d "
                     "(top-2 gap %.4g of max|logit| %.4g)"
                     % (what, i, t, arg[i], gap[i], top[i]))
            ties += 1
    return ties, float(np.min(gap / top))


def _same_or_tie(what, got, want, ref_of_want):
    """``got`` equal to ``want``, or parting from it first at a near-tie
    of ``want``'s dense reference (the histories agree up to there).
    Returns the position they part at, or None."""
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            _, gap, top = ref_of_want
            if gap[i] > TOL_TIE * top[i]:
                fail("%s: token %d is %d, not %d (top-2 gap %.4g of "
                     "max|logit| %.4g)" % (what, i, g, w, gap[i], top[i]))
            return i
    if len(got) != len(want):
        fail("%s: %d tokens, not %d" % (what, len(got), len(want)))
    return None


def phase_decode(torch, mx, fa, seed, smi, cfg=DECODE_CFG):
    """Autoregressive serving at GPT-2 small's widths: the decode plane
    (``serve.Server(decode=...)``) under 32 clients, the prefix cache, a
    speculative run, a poison drill and ``/decode`` over HTTP."""
    import urllib.request
    from types import SimpleNamespace

    from mxnet_tpu_torch import serve, telemetry
    from mxnet_tpu_torch.resilience import inject
    from mxnet_tpu_torch.resilience.inject import InjectedFault
    from mxnet_tpu_torch.serve.kvcache import gather_pages

    c = cfg
    t_phase = time.perf_counter()
    flash0 = _flash_counts(fa)
    params = decoder_params(c, seed)

    def block(ctx):
        blk = serve.TinyDecoder(vocab_size=c["vocab"],
                                num_layers=c["layers"],
                                num_heads=c["heads"],
                                head_dim=c["head_dim"], hidden=c["hidden"])
        blk.initialize(ctx=ctx)
        mx.convert.load_jax_params(blk, params)
        return blk

    def dcfg(**kw):
        base = dict(page_size=c["page_size"], max_context=c["max_context"],
                    max_live=c["max_live"], max_new_tokens=c["max_new"])
        base.update(kw)
        return serve.DecodeConfig(**base)

    per_ctx = c["max_context"] // c["page_size"]
    blk = block(mx.gpu(0))
    telemetry.reset()
    t0 = time.perf_counter()
    main = serve.DecodeRunner(blk, config=dcfg(
        pool_pages=c["max_live"] * per_ctx))
    warm_s = time.perf_counter() - t0
    prefix = serve.DecodeRunner(blk, config=dcfg(
        pool_pages=c["sessions"] * per_ctx, max_live=c["sessions"],
        prefix_cache=True))
    spec = serve.DecodeRunner(blk, config=dcfg(
        pool_pages=c["spec_seqs"] * per_ctx, max_live=c["spec_seqs"],
        spec_k=c["spec_k"]), draft=blk)
    builds = telemetry.value("serve_decode_compile_total")
    out = {"phase": "decode", "nvidia_smi": smi,
           "model": {k: c[k] for k in ("vocab", "layers", "heads",
                                       "head_dim", "hidden")},
           "config": main.config.as_dict(), "warm_s": warm_s,
           "builds": builds, "provenance": sorted(set(
               main.provenance().values()))}
    rng = np.random.default_rng(seed + 14)
    prompts = [rng.integers(0, c["vocab"], n).tolist() for n in
               rng.integers(c["prompt_lo"], c["prompt_hi"] + 1,
                            c["clients"])]
    srv = serve.Server(decode=main)

    # -- 32 concurrent clients ---------------------------------------------
    telemetry.reset()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(c["clients"]) as ex:
        res = list(ex.map(lambda p: srv.submit_decode(p).result(600),
                          prompts))
    wall = time.perf_counter() - t0
    streams = [r["tokens"] for r in res]
    if any(len(s) != c["max_new"] for s in streams):
        fail("decode: a request returned %s tokens, not %d"
             % (sorted({len(s) for s in streams}), c["max_new"]))
    q = {n: telemetry.histogram_quantiles(n, (0.5, 0.99)) for n in
         ("serve_decode_ttft_seconds", "serve_decode_token_seconds")}
    out["load"] = {
        "requests": len(prompts), "new_tokens_each": c["max_new"],
        "prompt_tokens": [min(map(len, prompts)), max(map(len, prompts))],
        "wall_s": wall, "tokens_per_s": len(prompts) * c["max_new"] / wall,
        "ttft_s": {"p50": q["serve_decode_ttft_seconds"].get(0.5),
                   "p99": q["serve_decode_ttft_seconds"].get(0.99)},
        "token_s": {"p50": q["serve_decode_token_seconds"].get(0.5),
                    "p99": q["serve_decode_token_seconds"].get(0.99)},
        "decode_steps": telemetry.value("serve_decode_steps_total"),
        "pool_high_water_pages": main.pool.high_water,
        "pool_capacity_pages": main.pool.capacity}
    refs = [_dense_reference(torch, blk, p, s)
            for p, s in zip(prompts, streams)]
    ties = [_tie_count("decode stream %d" % i, s, r)
            for i, (s, r) in enumerate(zip(streams, refs))]
    out["dense_reference"] = {
        "near_ties": sum(t for t, _ in ties),
        "min_gap_share": min(g for _, g in ties), "tol": TOL_TIE}

    # -- the poison drill ----------------------------------------------------
    inject.plan("serve_poison@decode-poison")
    try:
        futs = [srv.submit_decode(prompts[i], request_id=rid)
                for i, rid in ((5, "decode-ok-1"), (6, "decode-poison"),
                               (7, "decode-ok-2"))]
        try:
            futs[1].result(600)
            fail("decode: the poisoned sequence was served")
        except InjectedFault:
            pass
        if any(len(futs[i].result(600)["tokens"]) != c["max_new"]
               for i in (0, 2)):
            fail("decode: a batch-mate of the poisoned sequence failed")
    finally:
        inject.clear()
    out["poison"] = {"isolated": True, "poisoned": telemetry.value(
        "serve_requests_total", {"result": "poisoned"})}

    # -- /decode over HTTP, collected then streamed, each alone ---------------
    host, port = srv.start_http()
    url = "http://%s:%d/decode" % (host, port)

    def post(body):
        req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                     headers={"X-Request-Id": "smoke"})
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.read()

    collected = json.loads(post({"tokens": prompts[8]}))["tokens"]
    events = [json.loads(x) for x in
              post({"tokens": prompts[8], "stream": True}).splitlines()]
    streamed = [e["token"] for e in events if "token" in e]
    if streamed != collected or events[-1].get("tokens") != collected:
        fail("decode: /decode streamed %s, collected %s"
             % (streamed[:8], collected[:8]))
    out["http"] = {"tokens": len(collected), "stream_events": len(events),
                   "streamed_equals_collected": True}

    # -- one decode step at B=16 over long contexts: host, device, gather ----
    B = c["max_live"]
    stands = []
    for i in range(B):
        pages = main.pool.alloc(("probe", i), per_ctx)
        stands.append(SimpleNamespace(pages=pages, last_token=i + 1,
                                      length=c["max_context"] - 2))
    try:
        main.decode_step(stands)
        torch.cuda.synchronize()
        host = []
        for _ in range(10):
            t1 = time.perf_counter()
            main.decode_step(stands)
            host.append((time.perf_counter() - t1) * 1e3)
        split = profile_split(torch, lambda: main.decode_step(stands),
                              c["profile_steps"])
        tables = torch.from_numpy(main._table(B, [s.pages for s in stands])
                                  ).cuda()
        gather_ms = 2 * cuda_ms(lambda: gather_pages(main.pool.k, tables),
                                10)
    finally:
        for i in range(B):
            main.pool.release(("probe", i))
    ctx_elems = B * c["layers"] * per_ctx * c["page_size"] * c["heads"] \
        * c["head_dim"]
    gather_bytes = 2 * 2 * 4 * ctx_elems       # K and V, read and write
    out["step"] = {"batch": B, "context": c["max_context"],
                   "host_ms": float(np.median(host)),
                   "host_ms_range": [min(host), max(host)],
                   "device_busy_ms": split.get("device_busy_ms"),
                   "wall_ms": split["wall_ms"],
                   "kernels_per_step": split.get("kernels_per_step"),
                   "idle_share": split.get("idle_share"),
                   "split_ms": split.get("split_ms"),
                   "top_other_ms": split.get("top_other_ms")}
    out["gather"] = {"bytes_per_step": gather_bytes, "ms": gather_ms,
                     "bound_ms": gather_bytes / HBM_BYTES_PER_S * 1e3,
                     "bound_by": "bytes"}

    # -- the prefix drill: 8 sessions on one 768-token system prompt ---------
    system = rng.integers(0, c["vocab"], c["system"]).tolist()
    sessions = [system + rng.integers(0, c["vocab"], n).tolist()
                for n in rng.integers(16, 33, c["sessions"])]
    cold = [srv.submit_decode(p) for p in sessions]
    cold = [f.result(600)["tokens"] for f in cold]
    psched = serve.DecodeScheduler(prefix)
    try:
        cached = [psched.submit(p) for p in sessions]
        cached = [f.result(600)["tokens"] for f in cached]
    finally:
        psched.stop()
    parted = []
    for i, (p, got, want) in enumerate(zip(sessions, cached, cold)):
        ref = _dense_reference(torch, blk, p, want)
        _tie_count("cold session %d" % i, want, ref)
        parted.append(_same_or_tie("cached session %d" % i, got, want, ref))
    out["prefix"] = dict(prefix.cache.stats(), parted_at_near_tie=parted,
                         ttft_by_class={k: telemetry.value(
                             "serve_decode_ttft_seconds", {"cache": k})
                             for k in ("miss", "partial", "hit")})
    prefix.cache.clear()

    # -- speculative decoding, same-weight draft, k=4 ------------------------
    ssched = serve.DecodeScheduler(spec)
    try:
        sp = [ssched.submit(prompts[i]) for i in range(c["spec_seqs"])]
        sp = [f.result(600)["tokens"] for f in sp]
    finally:
        ssched.stop()
    out["spec"] = dict(
        {k: v for k, v in spec.spec.stats().items() if k != "draft_pool"},
        parted_at_near_tie=[
            _same_or_tie("speculative stream %d" % i, sp[i], streams[i],
                         refs[i]) for i in range(c["spec_seqs"])])

    # -- shutdown: every page home, no build after warm-up ------------------
    srv.shutdown()
    for name, r in (("main", main), ("prefix", prefix), ("spec", spec),
                    ("draft", spec.spec.draft)):
        if r.pool.in_use != 0 or not r.pool.check():
            fail("decode: the %s pool ends with %d pages in use"
                 % (name, r.pool.in_use))
    # the load's reset zeroed the counter: every build since is a miss
    if telemetry.value("serve_decode_compile_total") != 0:
        fail("decode: %s builds after warm-up" % telemetry.value(
            "serve_decode_compile_total"))
    if _flash_counts(fa) != flash0:
        fail("decode: the flash kernels launched (%s -> %s)"
             % (flash0, _flash_counts(fa)))

    # -- two streams against the port's CPU run -----------------------------
    short = sorted(range(len(prompts)), key=lambda i: len(prompts[i]))[:2]
    t0 = time.perf_counter()
    cpu = serve.DecodeRunner(block(mx.cpu()), ctx=mx.cpu(), config=dcfg(
        pool_pages=2 * per_ctx, max_live=2, batch_sizes=(1, 2),
        prefill_lengths=sorted({main.prefill_bucket(len(prompts[i]))
                                for i in short})))
    csched = serve.DecodeScheduler(cpu)
    try:
        cs = [csched.submit(prompts[i]) for i in short]
        cs = [f.result(600)["tokens"] for f in cs]
    finally:
        csched.stop()
    out["cpu"] = {"streams": short, "seconds": time.perf_counter() - t0,
                  "parted_at_near_tie": [
                      _same_or_tie("CPU stream %d" % i, got, streams[i],
                                   refs[i]) for i, got in zip(short, cs)]}
    out["flash_launches"] = {k: v - flash0[k]
                             for k, v in _flash_counts(fa).items()}
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    del main, prefix, spec, cpu, blk
    torch.cuda.empty_cache()


NP_FRONT_CFG = dict(B=8, T=512, M=76, vocab=30522, steps=3, lr=1e-4,
                    heads=12, units=768, linalg_batch=32, linalg_n=512)
TOL_NP_LOSS = 1e-5   # np-front loss against the nd step's, relative
TOL_NP_STEPS = 1e-6  # np-front Trainer losses against the nd steps', relative
TOL_NP_CASE = (1e-4, 1e-5)   # card vs CPU on the mx.np cases (rtol, atol)
# card f32 against the CPU in f64 on (32, 512, 512) SPD matrices with
# eigenvalues in [1, ~5]: relative Frobenius errors.  LAPACK's f32 on the
# CPU gives 5e-8..2e-7 (syevd: eigenvalues 1.1e-7, reconstruction
# 1.6e-6); torch's f32 eigh on the card, the control the phase records,
# 2.2e-4 and 4.5e-4, near TF32's unit roundoff
TOL_LINALG = {"potrf": 1e-5, "potri": 1e-5, "trsm": 1e-5,
              "syevd_eigenvalues": 1e-5, "syevd_reconstruction": 1e-5,
              "svd_values": 1e-5, "svd_reconstruction": 1e-5,
              "inverse": 1e-5, "slogdet": 1e-5}
TOL_UPDATE = 1e-6    # nd update ops vs the optimizer step, x max(1, |w|)


def _np_cases():
    """``tests/np_cases.py`` (the tables of ``tests/test_torch_numpy.py``
    and ``tests/test_torch_np_tail.py``), loaded by path: plain numpy
    data, it imports numpy only."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "np_cases.py")
    spec = importlib.util.spec_from_file_location("np_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np_loss(mx, mlm, nsp, labels, nsp_labels):
    """BERT's pretraining loss written with mx.np/mx.npx, as an MXNet 2.0
    script writes it (the masked weights are all ones here)."""
    np_, npx = mx.np, mx.npx
    mlm_ll = npx.pick(npx.log_softmax(mlm, axis=-1), labels, axis=-1)
    nsp_ll = npx.pick(npx.log_softmax(nsp, axis=-1), nsp_labels, axis=-1)
    return -np_.mean(mlm_ll) - np_.mean(nsp_ll)


def _np_front_bert(torch, mx, fa, seed, cfg):
    """Part a: BERT-base through the np front against the ``train``
    phase's step on the same weights and batch (dropout off), then
    ``cfg['steps']`` Trainer steps."""
    from mxnet_tpu_torch.gluon.model_zoo import bert

    B, T, M, vocab = cfg["B"], cfg["T"], cfg["M"], cfg["vocab"]
    mx.npx.set_np()
    net = bert.bert_12_768_12(pretraining=True, vocab_size=vocab,
                              max_length=T, dropout=DROPOUT_P)
    net.initialize()
    weights = bert_params(net, seed)
    mx.convert.load_jax_params(net, weights)
    host = _train_batch(np.random.default_rng(seed + 2), B, T, M, vocab)
    x = {k: mx.np.array(v) for k, v in host.items()}
    if not all(v._data.is_cuda for v in x.values()):
        fail("np_front: mx.np.array did not land on the card")
    params = net.collect_params()

    def np_step(train_mode):
        with mx.autograd.record(train_mode=train_mode):
            mlm, nsp = net(x["ids"], x["types"], None, x["pos"])
            loss = _np_loss(mx, mlm, nsp, x["labels"], x["nsp"])
        loss.backward()
        return loss

    loss_np = float(np_step(False).item())
    g_np = {n: p.grad.detach().clone() for n, p in params.items()}
    net.zero_grad(set_to_none=True)
    batch = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
    loss_nd = float(_train_step(mx, bert, net, batch,
                                train_mode=False).item())
    rel = abs(loss_np - loss_nd) / abs(loss_nd)
    if not rel <= TOL_NP_LOSS:
        fail("np_front: the np-front loss %r differs from the nd step's %r "
             "by %g (relative)" % (loss_np, loss_nd, rel))
    worst = 0.0
    for n, p in params.items():
        g = p.grad
        err = ((g_np[n] - g).abs().max().item()
               / max(1.0, g.abs().max().item()))
        worst = max(worst, err)
        if err > TOL_GRAD:
            fail("np_front: gradient of %s differs from the nd step's by "
                 "%g" % (n, err))
    del g_np
    net.zero_grad(set_to_none=True)

    def steps(step):
        # the same weights, Adam state and dropout stream on either route
        mx.convert.load_jax_params(net, weights)
        trainer = mx.gluon.Trainer(params, "adam",
                                   {"learning_rate": cfg["lr"]})
        mx.random.seed(seed)
        losses, step_ms = [], []
        for _ in range(cfg["steps"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step()
            trainer.step(1)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss.item()))
        return losses, step_ms

    _reset_flash(fa)
    losses, step_ms = steps(lambda: np_step(True))
    launches = _want_launches(fa, 12, cfg["steps"], "np_front BERT")
    nd_losses, _ = steps(lambda: _train_step(mx, bert, net, batch))
    step_err = max(abs(a - b) / abs(b) for a, b in zip(losses, nd_losses))
    if not (all(np.isfinite(losses)) and step_err <= TOL_NP_STEPS):
        fail("np_front: the np-front Trainer losses %s differ from the nd "
             "steps' %s by %g (relative)" % (losses, nd_losses, step_err))
    del net, params, x, batch, weights
    torch.cuda.empty_cache()
    return {"loss_np": loss_np, "loss_nd": loss_nd, "loss_rel_err": rel,
            "loss_tol": TOL_NP_LOSS, "grad_max_rel_err": worst,
            "grad_tol": TOL_GRAD, "losses": losses, "nd_losses": nd_losses,
            "steps_rel_err": step_err, "steps_tol": TOL_NP_STEPS,
            "step_ms": step_ms, "launches": launches}


def _np_front_interleaved(torch, mx, fa, seed, cfg):
    """Part b: GluonNLP's interleaved attention route at BERT width
    against ``npx.multi_head_attention`` (the flash kernels) on the same
    projections, forward and backward."""
    npx = mx.npx
    T, B, H, E = cfg["T"], cfg["B"], cfg["heads"], cfg["units"]
    D = E // H
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    qkv0 = torch.randn(T, B, 3 * E, device="cuda", generator=gen) * 0.5
    dout = torch.randn(T, B, E, device="cuda", generator=gen)

    def interleaved(qkv):
        s = npx.interleaved_matmul_selfatt_qk(qkv, heads=H)
        return npx.interleaved_matmul_selfatt_valatt(
            qkv, npx.softmax(s, axis=-1), heads=H)

    def flash(qkv):
        x = qkv.reshape((T, B, H, 3, D))
        q, k, v = (x[:, :, :, i, :].reshape((T, B, E)).transpose((1, 0, 2))
                   for i in range(3))
        return npx.multi_head_attention(q, k, v, num_heads=H).transpose(
            (1, 0, 2))

    res, ms = {}, {}
    for name, route in (("interleaved", interleaved), ("flash", flash)):
        qkv = mx.np.array(qkv0)
        qkv.attach_grad()
        with mx.autograd.record():
            out = route(qkv)
        out.backward(mx.nd.from_torch(dout))
        res[name] = (out._data.detach(), qkv.grad._data.clone())
        x = mx.nd.from_torch(qkv0)
        ms[name + "_fwd_ms"] = cuda_ms(lambda: route(x), 10)
        xg = mx.np.array(qkv0)
        xg.attach_grad()

        def fwd_bwd():
            with mx.autograd.record():
                o = route(xg)
            o.backward(mx.nd.from_torch(dout))

        ms[name + "_fwd_bwd_ms"] = cuda_ms(fwd_bwd, 10)
    err_o = (res["interleaved"][0] - res["flash"][0]).abs().max().item()
    g_ref = res["flash"][1]
    err_g = ((res["interleaved"][1] - g_ref).abs().max().item()
             / max(1.0, g_ref.abs().max().item()))
    if err_o > TOL_O["float32"] or err_g > TOL_GRAD:
        fail("np_front: the interleaved route differs from "
             "multi_head_attention: O %g, d(qkv) %g" % (err_o, err_g))
    return dict(ms, shape=[T, B, 3 * E], heads=H, max_abs_err_o=err_o,
                tol_o=TOL_O["float32"], grad_max_rel_err=err_g,
                grad_tol=TOL_GRAD)


def _host(x):
    out = x if isinstance(x, (list, tuple)) else [x]
    flat = []
    for o in out:
        if isinstance(o, (list, tuple)):
            flat.extend(_host(o))
        else:
            flat.append(o.asnumpy() if hasattr(o, "asnumpy")
                        else np.asarray(o))
    return flat


def _to_nd(mx, v, ctx):
    if isinstance(v, np.ndarray):
        return mx.np.array(v, dtype=v.dtype, ctx=ctx)
    if isinstance(v, list):
        return [_to_nd(mx, a, ctx) for a in v]
    if isinstance(v, tuple):
        return tuple(_to_nd(mx, a, ctx) for a in v)
    return v


def _np_front_case(mx, ns, name, args, kwargs, cpu, gpu):
    """One ``mx.np`` (or ``mx.nd`` np-tail) case on the card against the
    CPU; returns its largest error as a share of the tolerance."""
    rtol, atol = TOL_NP_CASE
    worst = 0.0
    outs = {}
    for ctx in (cpu, gpu):
        with ctx:
            fn = getattr(mx.np if ns == "np" else mx.nd, name)
            if ns == "np":
                outs[ctx] = fn(*_to_nd(mx, args, ctx), **kwargs)
            else:
                outs[ctx] = fn(*[mx.nd.array(a, ctx=ctx)
                                 if isinstance(a, np.ndarray) else a
                                 for a in args], **kwargs)
    for o in (outs[gpu] if isinstance(outs[gpu], (list, tuple))
              else [outs[gpu]]):
        if hasattr(o, "_data") and not o._data.is_cuda:
            fail("np_front: %s.%s left the card" % (ns, name))
    got, ref = _host(outs[gpu]), _host(outs[cpu])
    if len(got) != len(ref):
        fail("np_front: %s.%s gave %d outputs, %d on the CPU"
             % (ns, name, len(got), len(ref)))
    for g, r in zip(got, ref):
        if g.shape != r.shape or g.dtype != r.dtype:
            fail("np_front: %s.%s %s %s on the card, %s %s on the CPU"
                 % (ns, name, g.shape, g.dtype, r.shape, r.dtype))
        if r.dtype.kind in "fc":
            err = float(np.max(np.abs(g - r) / (atol + rtol * np.abs(r)),
                               initial=0.0))
            worst = max(worst, err)
            if err > 1.0:
                fail("np_front: %s.%s differs from the CPU (%g of the "
                     "tolerance)" % (ns, name, err))
        elif not np.array_equal(g, r):
            fail("np_front: %s.%s differs from the CPU" % (ns, name))
    return worst


def _np_front_table(torch, mx, cfg):
    """Part c: every case of the CPU tests' mx.np and np-tail tables on
    the card against the port's CPU result; the host fallback must stay
    unused; dispatch µs of three np calls beside nd's."""
    import mxnet_tpu_torch.numpy as mnp

    tables = _np_cases()
    rtol, atol = TOL_NP_CASE
    cases = ([("np", n, a, k) for n, a, k in
              tables.CASES + tables.EXTRA + tables.KEYWORDS]
             + [("nd", n, tuple(tables.NP_TAIL[n][0]), tables.NP_TAIL[n][1])
                for n in sorted(tables.NP_TAIL)])
    names, worst, bad = set(), 0.0, []
    gpu, cpu = mx.gpu(0), mx.cpu()
    for ns, name, args, kwargs in cases:
        try:
            worst = max(worst, _np_front_case(mx, ns, name, args, kwargs,
                                              cpu, gpu))
        except (Exception, SystemExit) as e:       # every case reported
            bad.append("%s.%s: %s" % (ns, name, str(e).splitlines()[0]))
        names.add("%s.%s" % (ns, name))
    if bad:
        fail("np_front: %d of %d cases: %s" % (len(bad), len(cases), bad))
    surface = [n for n in tables.REFERENCE_NP_SURFACE
               if mnp.resolve_source(n) != "torch"]
    if surface or mnp.fallback_names():
        fail("np_front: host fallbacks %s %s"
             % (surface, mnp.fallback_names()))

    small = np.random.RandomState(0).rand(4, 4).astype(np.float32)
    a = mx.np.array(small)

    def timeit(f, iters=300, warmup=25):
        for _ in range(warmup):
            f()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            f()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters * 1e6

    us = {"add": {"np_us": timeit(lambda: mx.np.add(a, a)),
                  "nd_us": timeit(lambda: mx.nd.add(a, a))},
          "matmul": {"np_us": timeit(lambda: mx.np.matmul(a, a)),
                     "nd_us": timeit(lambda: mx.nd.dot(a, a))},
          "sum": {"np_us": timeit(lambda: mx.np.sum(a)),
                  "nd_us": timeit(lambda: mx.nd.sum(a))}}
    return {"cases": len(cases), "names_checked": len(names),
            "worst_of_tolerance": worst, "rtol": rtol, "atol": atol,
            "fallback_names": mnp.fallback_names(), "dispatch_4x4": us}


def _np_front_linalg(torch, mx, seed, cfg):
    """Part d, linear algebra: the la_op family on batched f32 SPD
    matrices on the card against torch.linalg on the CPU in f64."""
    nb, n = cfg["linalg_batch"], cfg["linalg_n"]
    nd = mx.nd
    rng = np.random.default_rng(seed + 7)
    x = rng.standard_normal((nb, n, n)).astype(np.float32) / np.sqrt(n)
    spd = (x @ x.transpose(0, 2, 1) + np.eye(n, dtype=np.float32))
    spd = ((spd + spd.transpose(0, 2, 1)) / 2).astype(np.float32)
    b = rng.standard_normal((nb, n, 64)).astype(np.float32)
    A64 = torch.from_numpy(spd).double()
    L64 = torch.linalg.cholesky(A64)
    ref = {"potrf": L64, "potri": torch.cholesky_inverse(L64),
           "trsm": torch.linalg.solve_triangular(
               L64, torch.from_numpy(b).double(), upper=False),
           "inverse": torch.linalg.inv(A64)}
    w64 = torch.linalg.eigvalsh(A64)
    s64, ld64 = torch.linalg.slogdet(A64)
    A = nd.array(spd)
    L = nd.linalg.potrf(A)
    calls = {"potrf": lambda: nd.linalg.potrf(A),
             "potri": lambda: nd.linalg.potri(L),
             "trsm": lambda: nd.linalg.trsm(L, nd.array(b)),
             "syevd": lambda: nd.linalg.syevd(A),
             "svd": lambda: nd.linalg.svd(A),
             "inverse": lambda: nd.linalg.inverse(A),
             "slogdet": lambda: nd.linalg.slogdet(A)}
    # the decompositions' errors are taken on the card in f64 (the
    # reconstructions are 2 x 17 GFLOP each)
    A64c, w64c = A64.cuda(), w64.cuda()

    def eig_errs(u, w):
        """(eigenvalue, reconstruction) errors of rows ``u``, values
        ``w``, against f64."""
        u, w = u.double(), w.double()
        rec = u.transpose(-1, -2) @ (w[..., None] * u)
        return (((w - w64c).norm() / w64c.norm()).item(),
                ((rec - A64c).norm() / A64c.norm()).item())

    def svd_errs(u, s, vt):
        """(singular value, reconstruction) errors against f64 (an SPD
        matrix's singular values are its eigenvalues)."""
        u, s, vt = (t.double() for t in (u, s, vt))
        rec = (u * s[..., None, :]) @ vt
        return (((s - w64c.flip(-1)).norm() / w64c.norm()).item(),
                ((rec - A64c).norm() / A64c.norm()).item())

    errs, ms = {}, {}
    for name, call in calls.items():
        out = call()
        if name in ref:
            got = out._data.double().cpu()
            errs[name] = ((got - ref[name]).norm() / ref[name].norm()).item()
        elif name == "syevd":
            errs["syevd_eigenvalues"], errs["syevd_reconstruction"] = \
                eig_errs(out[0]._data, out[1]._data)
        elif name == "svd":
            errs["svd_values"], errs["svd_reconstruction"] = svd_errs(
                *(o._data for o in out))
        else:
            sign, ld = (o._data.double().cpu() for o in out)
            if not torch.equal(sign, s64):
                fail("np_front: slogdet's signs differ from the CPU's")
            errs[name] = ((ld - ld64).abs().max() / ld64.abs().max()).item()
        ms[name] = cuda_ms(call, 1 if name in ("syevd", "svd") else 3)
    # the controls: torch's f32 eigh and SVD on the card, which the port's
    # syevd and svd do not take (they decompose in f64 and round back)
    w32, v32 = torch.linalg.eigh(A._data)
    control = dict(zip(("syevd_eigenvalues", "syevd_reconstruction"),
                       eig_errs(v32.transpose(-1, -2), w32)))
    control.update(zip(("svd_values", "svd_reconstruction"), svd_errs(
        *torch.linalg.svd(A._data, full_matrices=False))))
    ms["syevd_f32_control"] = cuda_ms(lambda: torch.linalg.eigh(A._data), 1)
    ms["svd_f32_control"] = cuda_ms(
        lambda: torch.linalg.svd(A._data, full_matrices=False), 1)
    over = {k: v for k, v in errs.items() if v > TOL_LINALG[k]}
    if over:
        fail("np_front: linalg differs from the CPU in f64: %s (tolerances "
             "%s)" % (over, TOL_LINALG))
    return {"shape": [nb, n, n], "rel_err": errs, "tol": TOL_LINALG,
            "f32_control_rel_err": control,
            "control_over_gate": {k: v > TOL_LINALG[k]
                                  for k, v in control.items()}, "ms": ms}


def _np_front_updates(torch, mx, seed, cfg):
    """Part d, update ops over BERT-base's parameter shapes: nd.adam_update
    and lamb_update_phase1/2 against the port's Adam/LAMB step, and
    multi_sum_sq, multi_lars and all_finite against plain torch; all_finite
    with CUDA sync debugging set to error (no read-back)."""
    from mxnet_tpu_torch.gluon.model_zoo import bert

    nd = mx.nd
    shapes = [tuple(p.shape) for p in bert.bert_12_768_12(
        pretraining=True, vocab_size=cfg["vocab"],
        max_length=cfg["T"]).collect_params().values()]
    gen = torch.Generator(device="cuda").manual_seed(seed + 9)
    ws = [torch.randn(s, device="cuda", generator=gen) * 0.02
          for s in shapes]
    gs = [torch.randn(s, device="cuda", generator=gen) * 1e-3
          for s in shapes]
    lr, b1, b2, wd = 1e-4, 0.9, 0.999, 0.01
    worst = {}

    def check(name, got, want):
        err = max(((a - b).abs().max() / max(1.0, b.abs().max().item()))
                  .item() for a, b in zip(got, want))
        worst[name] = err
        if err > TOL_UPDATE:
            fail("np_front: %s differs from the optimizer step by %g"
                 % (name, err))

    adam = mx.optimizer.Adam(learning_rate=lr, beta1=b1, beta2=b2,
                             epsilon=1e-8, wd=wd)
    want = [w.clone() for w in ws]
    for i, (w, g) in enumerate(zip(want, gs)):
        adam.update(i, w, g, adam.create_state(i, w))
    # the optimizer's lr * (m/c1) / (sqrt(v/c2) + eps) is adam_update's
    # lr_t * m / (sqrt(v) + eps_t) with lr_t = lr sqrt(c2)/c1 and eps_t =
    # eps sqrt(c2) (c1, c2 = 1 - beta1, 1 - beta2 at step 1)
    lr_t = lr * np.sqrt(1 - b2) / (1 - b1)
    eps_t = 1e-8 * np.sqrt(1 - b2)
    got = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for w, g in zip(ws, gs):
        wn = nd.from_torch(w.clone())
        m, v = nd.from_torch(torch.zeros_like(w)), \
            nd.from_torch(torch.zeros_like(w))
        nd.adam_update(wn, nd.from_torch(g), m, v, lr=lr_t, beta1=b1,
                       beta2=b2, epsilon=eps_t, wd=wd, out=wn)
        got.append(wn._data)
    torch.cuda.synchronize()
    adam_ms = (time.perf_counter() - t0) * 1e3
    check("adam_update", got, want)

    lamb = mx.optimizer.LAMB(learning_rate=lr, beta1=b1, beta2=b2,
                             epsilon=1e-6, wd=wd)
    want = [w.clone() for w in ws]
    for i, (w, g) in enumerate(zip(want, gs)):
        lamb.update(i, w, g, lamb.create_state(i, w))
    got = []
    for w, g in zip(ws, gs):
        wn = nd.from_torch(w.clone())
        m, v = nd.from_torch(torch.zeros_like(w)), \
            nd.from_torch(torch.zeros_like(w))
        d = nd.lamb_update_phase1(wn, nd.from_torch(g), m, v, beta1=b1,
                                  beta2=b2, epsilon=1e-6, t=1, wd=wd)
        r1, r2 = nd.norm(wn).reshape((1,)), nd.norm(d).reshape((1,))
        nd.lamb_update_phase2(wn, d, r1, r2, lr=lr, out=wn)
        got.append(wn._data)
    check("lamb_update_phase1/2", got, want)

    w_nd, g_nd = [nd.from_torch(w) for w in ws], [nd.from_torch(g)
                                                  for g in gs]
    sq_w = nd.multi_sum_sq(*w_nd, num_arrays=len(ws))._data
    sq_g = nd.multi_sum_sq(*g_nd, num_arrays=len(gs))._data
    ref_w = torch.stack([w.double().square().sum() for w in ws])
    ref_g = torch.stack([g.double().square().sum() for g in gs])
    worst["multi_sum_sq"] = max(
        ((sq_w.double() - ref_w).abs() / ref_w).max().item(),
        ((sq_g.double() - ref_g).abs() / ref_g).max().item())
    if worst["multi_sum_sq"] > 1e-5:
        fail("np_front: multi_sum_sq differs from f64 by %g"
             % worst["multi_sum_sq"])
    lrs = torch.full((len(ws),), lr, device="cuda")
    wds = torch.full((len(ws),), wd, device="cuda")
    lars = nd.multi_lars(nd.from_torch(lrs), nd.from_torch(sq_w),
                         nd.from_torch(sq_g), nd.from_torch(wds),
                         eta=0.001, eps=1e-8)._data
    wn, gn = ref_w.sqrt(), ref_g.sqrt()
    want_lars = lr * 0.001 * wn / (gn + wd * wn + 1e-8)
    worst["multi_lars"] = ((lars.double() - want_lars).abs()
                           / want_lars).max().item()
    if worst["multi_lars"] > 1e-5:
        fail("np_front: multi_lars differs by %g" % worst["multi_lars"])
    bad = gs[3].clone()
    bad.view(-1)[7] = float("inf")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ok = nd.multi_all_finite(*g_nd, num_arrays=len(gs))._data
        one = nd.all_finite(g_nd[0])._data
        nope = nd.all_finite(nd.from_torch(bad))._data
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not (ok.is_cuda and float(ok) == 1.0 and float(one) == 1.0
            and float(nope) == 0.0):
        fail("np_front: all_finite gave %s %s %s" % (ok, one, nope))
    return {"tensors": len(ws), "elements": int(sum(w.numel() for w in ws)),
            "max_rel_err": worst, "tol": TOL_UPDATE,
            "adam_update_loop_ms": adam_ms,
            "all_finite_no_sync": True}


def phase_np_front(torch, mx, fa, seed, smi, cfg=NP_FRONT_CFG):
    """MXNet 2.0's numpy front door on the card (see the module doc)."""
    t0 = time.perf_counter()
    part_s = {}

    def part(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        part_s[name] = time.perf_counter() - t
        return out

    part_a = part("a", _np_front_bert, torch, mx, fa, seed, cfg)
    part_b = part("b", _np_front_interleaved, torch, mx, fa, seed, cfg)
    part_c = part("c", _np_front_table, torch, mx, cfg)
    part_d = {"linalg": part("d_linalg", _np_front_linalg, torch, mx, seed,
                             cfg),
              "updates": part("d_updates", _np_front_updates, torch, mx,
                              seed, cfg)}
    emit({"phase": "np_front", "bert": part_a, "interleaved": part_b,
          "np_table": part_c, "real_size": part_d, "part_s": part_s,
          "phase_s": time.perf_counter() - t0, "card": smi})
    return part_a["launches"]


# ---- nd_tail: sparse storage, detection, DGL, parity ops, mx.config -------

MF_CFG = dict(users=138493, items=27278, dim=128, B=8192, warm=3, steps=10,
              zipf=1.2, adam_lr=0.01, sgd_lr=0.5, momentum=0.9)
CSR_CFG = dict(features=1000000, B=8192, batches=4, nnz=15, lr=0.1)
SSD_MAPS = ((38, (0.1, 0.141), (1.0, 2.0, 0.5)),
            (19, (0.2, 0.272), (1.0, 2.0, 0.5, 3.0, 1.0 / 3)),
            (10, (0.37, 0.447), (1.0, 2.0, 0.5, 3.0, 1.0 / 3)),
            (5, (0.54, 0.619), (1.0, 2.0, 0.5, 3.0, 1.0 / 3)),
            (3, (0.71, 0.79), (1.0, 2.0, 0.5)),
            (1, (0.88, 0.961), (1.0, 2.0, 0.5)))
SSD_CFG = dict(B=32, classes=21, max_gt=20, nms_threshold=0.45, nms_topk=400,
               neg_ratio=3.0)
ROI_CFG = dict(images=2, channels=1024, H=38, W=63, rois=512, pooled=14,
               sample_ratio=2, stride=16, img_h=600, img_w=1000,
               cpu_rois=32)
DGL_CFG = dict(nodes=169343, edges=1166243, seeds=1024, fanouts=(25, 10),
               feat=128)
TOL_LAZY = 1e-6      # touched rows vs the per-row formula on the CPU, rel.
TOL_ND_TAIL = 1e-5   # card vs CPU: dot, detection values, ROI ops
ROW_TOL = 1e-6


def _zipf_ids(rng, a, n, size):
    return ((rng.zipf(a, size) - 1) % n).astype(np.int32)


def _mf_net(mx, torch, cfg, seed):
    rng = np.random.RandomState(seed + 160)
    nets = []
    for n in (cfg["users"], cfg["items"]):
        e = mx.gluon.nn.Embedding(n, cfg["dim"], sparse_grad=True)
        e.initialize(ctx=mx.gpu(0))
        with torch.no_grad():
            e.weight.copy_(torch.from_numpy(
                rng.normal(0, 0.1, (n, cfg["dim"])).astype(np.float32)))
        nets.append(e)
    return nets


def _mf_batches(cfg, seed, count):
    rng = np.random.RandomState(seed + 161)
    return [(_zipf_ids(rng, cfg["zipf"], cfg["users"], cfg["B"]),
             _zipf_ids(rng, cfg["zipf"], cfg["items"], cfg["B"]),
             (rng.randint(1, 11, cfg["B"]) / 2.0).astype(np.float32))
            for _ in range(count)]


def _lazy_rows_cpu(opt_name, cfg, w, st, g, t, lr):
    """The per-row lazy rule on the CPU, in float32: (weight rows, state
    rows) after one step from rows ``w``/``st`` and gradient rows ``g``."""
    import torch

    if opt_name == "adam":
        b1, b2, eps = 0.9, 0.999, 1e-8
        m, v = st
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        mhat = m / (1 - b1 ** t)
        vhat = v / (1 - b2 ** t)
        return w - lr * mhat / (torch.sqrt(vhat) + eps), (m, v)
    mom = st[0] * cfg["momentum"] - lr * g
    return w + mom, (mom,)


def _mf_run(torch, mx, cfg, seed, opt_name, lazy=True):
    """Train the two sparse tables; returns the numbers of part a."""
    users, items = _mf_net(mx, torch, cfg, seed)
    params = users.collect_params()
    params.update({"item_" + k: v
                   for k, v in items.collect_params().items()})
    kw = ({"learning_rate": cfg["adam_lr"]} if opt_name == "adam" else
          {"learning_rate": cfg["sgd_lr"], "momentum": cfg["momentum"]})
    tr = mx.gluon.Trainer(params, opt_name, dict(kw, lazy_update=lazy))
    loss_fn = mx.gluon.loss.L2Loss()
    batches = _mf_batches(cfg, seed, cfg["warm"] + cfg["steps"])
    losses, step_ms, upd_ms, rows = [], [], [], []
    check = None

    def held_loss():               # on the first batch, outside autograd
        u, i, r = batches[0]
        pred = (users(mx.nd.array(u, ctx=mx.gpu(0), dtype="int32"))
                * items(mx.nd.array(i, ctx=mx.gpu(0), dtype="int32"))
                ).sum(axis=1)
        return float(loss_fn(pred, mx.nd.array(r, ctx=mx.gpu(0)))
                     .mean().asnumpy())

    held = [held_loss()]
    for k, (u, i, r) in enumerate(batches):
        uid = mx.nd.array(u, ctx=mx.gpu(0), dtype="int32")
        iid = mx.nd.array(i, ctx=mx.gpu(0), dtype="int32")
        lab = mx.nd.array(r, ctx=mx.gpu(0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mx.autograd.record():
            pred = (users(uid) * items(iid)).sum(axis=1)
            loss = loss_fn(pred, lab)
        loss.backward()
        if k == cfg["warm"]:       # the rule's check, on the first timed step
            check = _mf_snapshot(torch, tr, users.weight, u)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        tr.step(cfg["B"])
        ev[1].record()
        losses.append(float(loss.mean().asnumpy()))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        upd_ms.append(ev[0].elapsed_time(ev[1]))
        rows.append(len(np.unique(u)) + len(np.unique(i)))
        if k == cfg["warm"] and lazy:
            _mf_check(torch, tr, users.weight, opt_name, cfg, check)
    held.append(held_loss())
    if not held[1] < held[0]:
        fail("nd_tail: %s loss on the first batch did not fall: %s"
             % (opt_name, held))
    timed = slice(cfg["warm"], None)
    return {"optimizer": opt_name, "lazy_update": lazy,
            "loss_first": losses[0], "loss_last": losses[-1],
            "first_batch_loss_before_after": held,
            "step_ms_median": float(np.median(step_ms[timed])),
            "update_ms_median": float(np.median(upd_ms[timed])),
            "rows_touched_median": float(np.median(rows[timed])),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def _mf_snapshot(torch, tr, w, ids):
    i = next(j for j, p in enumerate(tr._params) if p is w)
    touched = torch.from_numpy(np.unique(ids)).long().cuda()
    st = tr._states.get(i)
    st = () if st is None else (st if isinstance(st, tuple) else (st,))
    return {"index": i, "touched": touched, "w": w.detach().clone(),
            "st": tuple(s.clone() for s in st),
            "g": w.grad[touched].detach().clone(),
            "t": tr._optimizer._index_update_count.get(i, 0) + 1}


def _mf_check(torch, tr, w, opt_name, cfg, snap):
    """Untouched rows (and their state) bit for bit; touched rows against
    the per-row rule on the CPU."""
    i, touched = snap["index"], snap["touched"]
    keep = torch.ones(w.shape[0], dtype=torch.bool, device=w.device)
    keep[touched] = False
    st = tr._states[i]
    st = st if isinstance(st, tuple) else (st,)
    for new, old in zip((w.detach(),) + st, (snap["w"],) + snap["st"]):
        if not torch.equal(new[keep], old[keep]):
            fail("nd_tail: %s moved an untouched row" % opt_name)
    lr = tr._optimizer._get_lr(i)
    g = snap["g"].cpu() * tr._optimizer.rescale_grad
    if tr._optimizer.clip_gradient is not None:
        g = g.clamp(-tr._optimizer.clip_gradient,
                    tr._optimizer.clip_gradient)
    want_w, want_st = _lazy_rows_cpu(
        opt_name, cfg, snap["w"][touched].cpu(),
        tuple(s[touched].cpu() for s in snap["st"]), g, snap["t"], lr)
    for got, want in zip((w.detach()[touched],) + tuple(
            s[touched] for s in st), (want_w,) + want_st):
        err = ((got.cpu() - want).abs().max()
               / max(1e-30, want.abs().max().item())).item()
        if err > TOL_LAZY:
            fail("nd_tail: %s touched rows differ from the per-row rule "
                 "by %g" % (opt_name, err))


def _nd_tail_sparse_embedding(torch, mx, seed):
    """Part a: matrix factorization at MovieLens-20M's table sizes."""
    cfg = MF_CFG
    out = {"users": cfg["users"], "items": cfg["items"], "dim": cfg["dim"],
           "B": cfg["B"]}
    for opt_name in ("adam", "sgd"):
        torch.cuda.reset_peak_memory_stats()
        lazy = _mf_run(torch, mx, cfg, seed, opt_name, lazy=True)
        dense = _mf_run(torch, mx, dict(cfg, warm=1, steps=3), seed,
                        opt_name, lazy=False)
        lazy["dense_update_ms_median"] = dense["update_ms_median"]
        lazy["lazy_over_dense_update"] = (lazy["update_ms_median"]
                                          / dense["update_ms_median"])
        out[opt_name] = lazy
        torch.cuda.empty_cache()
    return out


def _write_libsvm(path, cfg, rng):
    rows = cfg["B"] * cfg["batches"]
    cols = rng.randint(0, cfg["features"], (rows, cfg["nnz"]))
    vals = rng.rand(rows, cfg["nnz"]).astype(np.float32)
    labels = rng.randint(0, 2, rows)
    with open(path, "w") as f:
        for r in range(rows):
            feats = " ".join("%d:%.4f" % (c, v) for c, v in
                             zip(np.unique(cols[r]), vals[r]))
            f.write("%d %s\n" % (labels[r], feats))


def _sparse_kernel_names(torch, fn, calls=3):
    """The names of the sparse kernels the card ran in ``calls`` calls of
    ``fn``, read off the profiler's trace as ``profile_split`` reads it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events
             if e.get("ph") == "X" and e.get("cat") == "kernel"}
    return sorted(n for n in names if "sparse" in n.lower()
                  or "csr" in n.lower() or "spmm" in n.lower())


_SPARSE_PROFILE = r"""
import json, sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke
import mxnet_tpu_torch as mx
z = np.load(sys.argv[2])
x = mx.nd.sparse.csr_matrix((z["data"], z["indices"], z["indptr"]),
                            shape=tuple(z["shape"]), ctx=mx.gpu(0))
w = torch.from_numpy(z["w"]).cuda().requires_grad_()
fwd = chip_smoke._sparse_kernel_names(torch, lambda: mx.nd.sparse.dot(x, w))
bwd = chip_smoke._sparse_kernel_names(
    torch, lambda: mx.nd.sparse.dot(x, w)._data.sum().backward())
print(json.dumps({"forward": fwd, "backward": bwd}))
"""


def _cusparse_kernels(x, w):
    """(forward, backward) sparse kernel names of ``nd.sparse.dot`` on this
    CSR batch and weight, profiled in a fresh process: in this one, once
    the decode phase has profiled its scheduler's steps, the profiler
    records no kernel at all."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "batch.npz")
        np.savez(path, data=x.data.asnumpy(), indices=x.indices.asnumpy(),
                 indptr=x.indptr.asnumpy(), shape=np.asarray(x.shape),
                 w=w.detach().cpu().numpy())
        here = os.path.dirname(os.path.abspath(__file__))
        out = subprocess.run([sys.executable, "-c", _SPARSE_PROFILE, here,
                              path], capture_output=True, text=True,
                             timeout=300)
    if out.returncode:
        fail("nd_tail: the sparse profile exited %d: %s"
             % (out.returncode, out.stderr[-500:]))
    names = json.loads(out.stdout.strip().splitlines()[-1])
    if not names["forward"]:
        fail("nd_tail: no cuSPARSE kernel in the CSR dot's profile")
    return names["forward"], names["backward"]


def _nd_tail_csr(torch, mx, seed):
    """Part b: LibSVMIter CSR batches at Avazu-app's feature width through
    a linear model, W row_sparse under lazy SGD."""
    cfg = CSR_CFG
    rng = np.random.RandomState(seed + 162)
    tmp = tempfile.mkdtemp(prefix="nd_tail_")
    try:
        path = os.path.join(tmp, "avazu_synth.libsvm")
        _write_libsvm(path, cfg, rng)
        t0 = time.perf_counter()
        with mx.gpu(0):
            it = mx.io.LibSVMIter(data_libsvm=path,
                                  data_shape=(cfg["features"],),
                                  batch_size=cfg["B"])
            parse_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            batches = list(it)
            torch.cuda.synchronize()
            iter_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    w0 = rng.normal(0, 0.01, (cfg["features"], 1)).astype(np.float32)
    W = mx.gluon.Parameter("weight", shape=w0.shape,
                           grad_stype="row_sparse")
    W.initialize(ctx=mx.gpu(0))
    with torch.no_grad():
        W.copy_(torch.from_numpy(w0))
    tr = mx.gluon.Trainer({"weight": W}, "sgd",
                          {"learning_rate": cfg["lr"]})
    losses = []
    for b in batches:
        x, y = b.data[0], b.label[0]
        if x.stype != "csr" or not x._data.is_cuda:
            fail("nd_tail: LibSVMIter gave %s on %s" % (x.stype,
                                                       x._data.device))
        with mx.autograd.record():
            z = mx.nd.sparse.dot(x, W).reshape((-1,))
            loss = mx.nd.log(1 + mx.nd.exp(-(2 * y - 1) * z))
        loss.backward()
        tr.step(cfg["B"])
        losses.append(float(loss.mean().asnumpy()))
    x = batches[0].data[0]
    got = mx.nd.sparse.dot(x, W)._data
    xc = mx.nd.sparse.csr_matrix((x.data.asnumpy(), x.indices.asnumpy(),
                                  x.indptr.asnumpy()), shape=x.shape,
                                 ctx=mx.cpu())
    want = mx.nd.sparse.dot(xc, W.detach().cpu())._data
    err = ((got.cpu() - want).abs().max()
           / max(1.0, want.abs().max().item())).item()
    if err > TOL_ND_TAIL:
        fail("nd_tail: CSR dot differs from the CPU by %g" % err)
    dot_ms = cuda_ms(lambda: mx.nd.sparse.dot(x, W), 20)
    # the control: the same product dense over the batch's columns alone
    cols = torch.unique(x.indices_.long())
    remap = torch.zeros(cfg["features"], dtype=torch.long, device="cuda")
    remap[cols] = torch.arange(cols.numel(), device="cuda")
    dense = torch.zeros(cfg["B"], cols.numel(), device="cuda")
    dense.index_put_((x._rows(), remap[x.indices_.long()]), x._data,
                     accumulate=True)
    wc = W.detach()[cols]
    matmul_ms = cuda_ms(lambda: dense @ wc, 20)
    kernels, bwd_kernels = _cusparse_kernels(x, W)
    return {"features": cfg["features"], "B": cfg["B"],
            "nnz_per_row": cfg["nnz"], "batches": len(batches),
            "parse_s": parse_s,
            "csr_batches_per_s": len(batches) / iter_s,
            "loss_first": losses[0], "loss_last": losses[-1],
            "dot_ms": dot_ms, "dense_matmul_ms": matmul_ms,
            "dense_columns": int(cols.numel()), "max_rel_err": err,
            "cusparse_kernels": kernels,
            "cusparse_kernels_backward": bwd_kernels}


def _ssd_anchors(torch, mx, ctx):
    parts = []
    for side, sizes, ratios in SSD_MAPS:
        fmap = mx.nd.zeros((1, 1, side, side), ctx=ctx)
        parts.append(mx.nd.contrib.MultiBoxPrior(fmap, sizes=sizes,
                                                 ratios=ratios)._data)
    return torch.cat(parts, dim=1)


def _ssd_inputs(cfg, n, seed):
    rng = np.random.RandomState(seed + 163)
    B, M = cfg["B"], cfg["max_gt"]
    label = -np.ones((B, M, 5), np.float32)
    for b in range(B):
        k = rng.randint(1, M + 1)
        xy = rng.uniform(0.0, 0.7, (k, 2))
        wh = rng.uniform(0.05, 0.3, (k, 2))
        label[b, :k, 0] = rng.randint(0, cfg["classes"] - 1, k)
        label[b, :k, 1:3] = xy
        label[b, :k, 3:5] = np.minimum(xy + wh, 1.0)
    logits = rng.randn(B, cfg["classes"], n).astype(np.float32)
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    prob = (e / e.sum(axis=1, keepdims=True)).astype(np.float32)
    loc = (rng.randn(B, n * 4) * 0.1).astype(np.float32)
    return label, logits, prob, loc


def _timed(torch, fn, iters=3):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3 / iters


def _same_outputs(torch, what, got, want, tol=TOL_ND_TAIL, exact=False):
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    worst = 0.0
    for g, w in zip(got, want):
        g = getattr(g, "_data", g).cpu()
        w = getattr(w, "_data", w).cpu()
        if g.shape != w.shape or g.dtype != w.dtype:
            fail("nd_tail: %s gives %s %s on the card, %s %s on the CPU"
                 % (what, tuple(g.shape), g.dtype, tuple(w.shape), w.dtype))
        if exact or not g.is_floating_point():
            if not torch.equal(g, w):
                fail("nd_tail: %s differs from the CPU" % what)
            continue
        err = ((g - w).abs().max() / max(1.0, w.abs().max().item())).item()
        worst = max(worst, err)
        if err > tol:
            fail("nd_tail: %s differs from the CPU by %g" % (what, err))
    return worst


def _nd_tail_detection(torch, mx, seed):
    """Part c: the SSD-300 chain and Faster R-CNN's ROI ops."""
    cfg = SSD_CFG
    gpu, cpu = mx.gpu(0), mx.cpu()
    anchors = _ssd_anchors(torch, mx, gpu)
    n = anchors.shape[1]
    if n != 8732:
        fail("nd_tail: SSD-300 anchors %d, want 8732" % n)
    anchors_cpu = _ssd_anchors(torch, mx, cpu)
    out = {"anchors": n, "B": cfg["B"], "classes": cfg["classes"]}
    out["prior_err"] = _same_outputs(torch, "MultiBoxPrior", anchors,
                                     anchors_cpu)
    label, logits, prob, loc = _ssd_inputs(cfg, n, seed)
    args = {}
    for name, ctx in (("gpu", gpu), ("cpu", cpu)):
        args[name] = [mx.nd.array(a, ctx=ctx) for a in (label, logits,
                                                        prob, loc)]
    tgt = {}
    for name, anc in (("gpu", anchors), ("cpu", anchors_cpu)):
        lab, lg = args[name][0], args[name][1]
        tgt[name], ms = _timed(torch, lambda: mx.nd.multibox_target(
            mx.nd.NDArray(anc), lab, lg,
            negative_mining_ratio=cfg["neg_ratio"]), iters=1)
        if name == "gpu":
            out["multibox_target_ms"] = ms
    out["multibox_target_err"] = _same_outputs(
        torch, "MultiBoxTarget", tgt["gpu"][:2], tgt["cpu"][:2])
    _same_outputs(torch, "MultiBoxTarget's matches", tgt["gpu"][2:],
                  tgt["cpu"][2:], exact=True)
    det = {}
    for name, anc in (("gpu", anchors), ("cpu", anchors_cpu)):
        center = mx.nd.NDArray(mx.ops.detection._center(anc))
        pr, lc = args[name][2], args[name][3]
        det[name], ms = _timed(torch, lambda: mx.nd.contrib.MultiBoxDetection(
            pr, lc, center, nms_threshold=cfg["nms_threshold"],
            nms_topk=cfg["nms_topk"]), iters=3 if name == "gpu" else 1)
        out["multibox_detection_ms_" + name] = ms
    keep_g = (det["gpu"]._data[..., 1] >= 0).cpu()
    keep_c = det["cpu"]._data[..., 1] >= 0
    if not torch.equal(keep_g, keep_c):
        fail("nd_tail: NMS keep-sets differ on %d rows"
             % int((keep_g != keep_c).sum()))
    out["kept_per_image"] = float(keep_c.sum(dim=1).float().mean())
    out["detection_err"] = _same_outputs(torch, "MultiBoxDetection",
                                         det["gpu"], det["cpu"])
    out["roi"] = _nd_tail_roi(torch, mx, seed)
    return out


def _nd_tail_roi(torch, mx, seed):
    cfg = ROI_CFG
    rng = np.random.RandomState(seed + 164)
    feats = rng.randn(cfg["images"], cfg["channels"], cfg["H"],
                      cfg["W"]).astype(np.float32)
    R = cfg["rois"] * cfg["images"]
    x1 = rng.uniform(0, cfg["img_w"] * 0.8, R)
    y1 = rng.uniform(0, cfg["img_h"] * 0.8, R)
    w = rng.uniform(16, cfg["img_w"] * 0.5, R)
    h = rng.uniform(16, cfg["img_h"] * 0.5, R)
    rois = np.stack([np.repeat(np.arange(cfg["images"]), cfg["rois"]), x1,
                     y1, np.minimum(x1 + w, cfg["img_w"] - 1),
                     np.minimum(y1 + h, cfg["img_h"] - 1)],
                    axis=1).astype(np.float32)
    scale = 1.0 / cfg["stride"]
    pooled = (cfg["pooled"], cfg["pooled"])
    f_g, r_g = (torch.from_numpy(a).cuda() for a in (feats, rois))
    out = {"rois": R, "channels": cfg["channels"],
           "map": [cfg["H"], cfg["W"]], "pooled": cfg["pooled"]}

    def align(f, r):
        return mx.nd.contrib.ROIAlign(f, r, pooled_size=pooled,
                                      spatial_scale=scale,
                                      sample_ratio=cfg["sample_ratio"])

    def pool(f, r):
        return mx.nd.ROIPooling(f, r, pooled_size=pooled,
                                spatial_scale=scale)

    # the CPU checks the first and the last RoIs of each image
    k = cfg["cpu_rois"] // 2
    pick = np.concatenate([np.arange(i * cfg["rois"], i * cfg["rois"] + k)
                           for i in range(cfg["images"])])
    for name, fn in (("roi_align", align), ("roi_pooling", pool)):
        torch.cuda.reset_peak_memory_stats()
        res, ms = _timed(torch, lambda: fn(f_g, r_g), iters=3)
        out[name + "_ms"] = ms
        out[name + "_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        want = fn(torch.from_numpy(feats), torch.from_numpy(rois[pick]))
        out[name + "_err"] = _same_outputs(
            torch, name, res._data[torch.from_numpy(pick).cuda()], want)
        del res
        torch.cuda.empty_cache()
    return out


def _synthetic_graph(cfg, rng):
    """A CSR graph with ogbn-arxiv's node and edge counts: a power-law
    out-degree, uniform targets, edge ids 0..E-1 in row order."""
    n, e = cfg["nodes"], cfg["edges"]
    deg = rng.zipf(1.8, n).astype(np.float64)
    deg = np.maximum(1, np.round(deg / deg.sum() * e)).astype(np.int64)
    deg[np.argmax(deg)] -= deg.sum() - e
    indptr = np.concatenate([[0], np.cumsum(deg)])
    return indptr, rng.randint(0, n, e).astype(np.int64)


def _nd_tail_dgl(torch, mx, seed):
    """Part d: GraphSAGE's 2-hop sampling on an ogbn-arxiv-sized graph."""
    cfg = DGL_CFG
    rng = np.random.RandomState(seed + 165)
    t0 = time.perf_counter()
    indptr, cols = _synthetic_graph(cfg, rng)
    build_s = time.perf_counter() - t0
    eids = np.arange(cfg["edges"], dtype=np.int64)
    with mx.cpu():
        g = mx.nd.sparse.csr_matrix((eids, cols, indptr),
                                    shape=(cfg["nodes"], cfg["nodes"]))
    prob = (rng.rand(cfg["nodes"]) + 0.1).astype(np.float32)
    feats = torch.from_numpy(rng.randn(cfg["nodes"], cfg["feat"]).astype(
        np.float32)).pin_memory()
    seeds = rng.choice(cfg["nodes"], cfg["seeds"], replace=False)
    out = {"nodes": cfg["nodes"], "edges": cfg["edges"],
           "seeds": cfg["seeds"], "fanouts": list(cfg["fanouts"]),
           "graph_build_s": build_s}
    for kind in ("uniform", "non_uniform"):
        t0 = time.perf_counter()
        frontier, sampled_edges = seeds, 0
        with mx.cpu():
            for fan in cfg["fanouts"]:
                cap = min(cfg["nodes"], len(frontier) * (fan + 1))
                if kind == "uniform":
                    ids, sub, _layer = \
                        mx.nd.contrib.dgl_csr_neighbor_uniform_sample(
                            g, mx.nd.array(frontier.astype(np.int64)),
                            num_hops=1, num_neighbor=fan,
                            max_num_vertices=cap)
                else:
                    ids, sub, _p, _layer = \
                        mx.nd.contrib.dgl_csr_neighbor_non_uniform_sample(
                            g, mx.nd.array(prob),
                            mx.nd.array(frontier.astype(np.int64)),
                            num_hops=1, num_neighbor=fan,
                            max_num_vertices=cap)
                ids = ids.asnumpy()
                verts = ids[:ids[-1]]
                sampled_edges += _check_sampled(sub, verts, indptr, cols)
                frontier = verts
        host_ms = (time.perf_counter() - t0) * 1e3
        rows = torch.from_numpy(frontier.astype(np.int64))
        batch = feats[rows].pin_memory()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        on_card = batch.to("cuda", non_blocking=True)
        ev[1].record()
        torch.cuda.synchronize()
        if not torch.equal(on_card.cpu(), batch):
            fail("nd_tail: the sampled features changed on the way")
        out[kind] = {"host_ms_per_batch": host_ms,
                     "sampled_vertices": int(len(frontier)),
                     "sampled_edges": sampled_edges,
                     "h2d_ms": ev[0].elapsed_time(ev[1]),
                     "h2d_mb": batch.numel() * 4 / 1e6}
    return out


def _check_sampled(sub, verts, indptr, cols):
    """Every sampled edge (row vertex, column, edge id) is an edge of the
    parent graph; returns the number checked."""
    sp = sub.indptr.asnumpy().astype(np.int64)
    sc = sub.indices.asnumpy().astype(np.int64)
    se = sub.data.asnumpy().astype(np.int64)
    rows = np.repeat(np.arange(len(sp) - 1), np.diff(sp))
    src = verts[rows]
    ok = (se >= indptr[src]) & (se < indptr[src + 1]) & (cols[se] == sc)
    if not ok.all():
        fail("nd_tail: %d sampled edges are not in the graph"
             % int((~ok).sum()))
    return int(len(se))


def _parity_cases():
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "parity_cases.py")
    spec = importlib.util.spec_from_file_location("parity_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _nd_tail_parity(torch, mx):
    """Part e: every parity case on the card against the CPU."""
    cases = _parity_cases().CASES
    worst, bad = 0.0, []
    for name, args, kwargs in cases:
        outs = []
        try:
            for ctx in (mx.cpu(), mx.gpu(0)):
                with ctx:
                    arrs = [mx.nd.array(a, dtype=np.asarray(a).dtype)
                            for a in args]
                    outs.append(getattr(mx.nd, name)(*arrs, **dict(kwargs)))
            worst = max(worst, _same_outputs(
                torch, name, outs[1], outs[0], tol=TOL_NP_CASE[0]))
        except (Exception, SystemExit) as e:
            bad.append("%s: %s" % (name, str(e).splitlines()[0]))
    if bad:
        fail("nd_tail: %d of %d parity cases: %s" % (len(bad), len(cases),
                                                     bad))
    return {"cases": len(cases), "worst_rel_err": worst}


def phase_nd_tail(torch, mx, fa, seed, smi):
    """The rest of the nd front door on the card (see the module doc)."""
    t0 = time.perf_counter()
    _reset_flash(fa)
    part_s = {}

    def part(name, fn, *args):
        t = time.perf_counter()
        res = fn(*args)
        part_s[name] = time.perf_counter() - t
        emit({"phase": "nd_tail", "part": name, "result": res})
        return res

    part("a_sparse_embedding", _nd_tail_sparse_embedding, torch, mx, seed)
    part("b_csr", _nd_tail_csr, torch, mx, seed)
    part("c_detection", _nd_tail_detection, torch, mx, seed)
    part("d_dgl", _nd_tail_dgl, torch, mx, seed)
    part("e_parity", _nd_tail_parity, torch, mx)
    unknown = mx.config.check_unknown(warn=False)
    launches = _flash_counts(fa)
    if any(launches.values()):
        fail("nd_tail: flash kernels launched %s" % launches)
    emit({"phase": "nd_tail", "config_unknown": unknown,
          "config_vars": len(mx.config.ENV_VARS), "launches": launches,
          "part_s": part_s, "phase_s": time.perf_counter() - t0,
          "card": smi})
    return launches


# ---- the operational planes (autotune, recorder, watchdog, monitor,
# profiler) around BERT-base ---------------------------------------------------

PLANES_CFG = dict(
    # the flash site's keys: BERT's f32 (the served and trained shape),
    # its bf16 recipe's B=16, the GPT LM's causal D=32
    tune_keys=((8, 12, 512, 512, 64, "float32", False),
               (16, 12, 512, 512, 64, "bfloat16", False),
               (8, 8, 1024, 1024, 32, "bfloat16", True)),
    tune_budget_ms=20000.0, tune_repeats=10, tune_warmup=3,
    T=512, vocab=30522, n_req=32, B=8, M=76, train_steps=3,
    slow_step_sleep_s=2.5, watch_timeout_s=2.0, deadline_burst=8)
# the kernels as torch.profiler names them (their __global__ functions)
PLANE_KERNELS = {"flash_fwd": "flash_fwd_kernel",
                 "flash_bwd_dq": "flash_bwd_dq_kernel",
                 "flash_bwd_dkv": "flash_bwd_dkv_kernel"}


def _plane_dumps(mx, reason):
    """The set of dumps of ``reason`` this process wrote, once every dump
    thread has ended."""
    for t in threading.enumerate():
        if t.name == "mx-trace-dump":
            t.join(timeout=60)
    return {p for r, p in mx.trace.last_dumps() if r == reason}


def _planes_tune(mx, cfg, store):
    """Part a: ``autotune.tune`` of the flash site at each key, with a
    fresh store, under ``MXNET_AUTOTUNE=search``."""
    from mxnet_tpu_torch import autotune

    autotune.enable("search", root=store)
    out = []
    t0 = time.perf_counter()
    try:
        for key in cfg["tune_keys"]:
            res = autotune.tune("flash_attention", key,
                                budget_ms=cfg["tune_budget_ms"],
                                repeats=cfg["tune_repeats"],
                                warmup=cfg["tune_warmup"])
            row = res.as_dict()
            if not res.committed or res.budget_exhausted:
                fail("ops_planes: the tune at %s did not commit (budget "
                     "exhausted: %s)" % (key, res.budget_exhausted))
            out.append(row)
    finally:
        autotune.disable()
    tune_s = time.perf_counter() - t0
    return {"keys": out, "tune_s": tune_s,
            "against_kernel_times": _tune_against_events(mx, out)}


TILE_MARGIN = 0.05   # tiles closer than this are a tie


def _tune_against_events(mx, rows):
    """Each key's winner against the tiles' CUDA-event times from
    ``_tile_cases`` (phase ``kernels``' case at that key, or the same case
    run here where that phase has none): where the two differ by more than
    ``TILE_MARGIN`` the faster must win, and every record must hold the
    device clock."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import flash_attention as fa

    out = []
    for row in rows:
        key = tuple(row["key"])
        B, H, Tq, Tk, D, dname, causal = key
        source = "kernels"
        if key not in TILE_MS:
            source = "ops_planes"
            gen = torch.Generator(device="cuda").manual_seed(17)
            q, k, v = (torch.randn(B, H, T, D, device="cuda", generator=gen,
                                   dtype=getattr(torch, dname))
                       for T in (Tq, Tk, Tk))
            _fwd_case(torch, F, fa, q, k, v, causal, 0.0, dname, 20)
            del q, k, v
        times = TILE_MS[key]
        fastest = min(times, key=times.get)
        slowest = max(times, key=times.get)
        gap = times[slowest] / times[fastest] - 1.0
        winner = "%dx%d" % tuple(row["config"])
        res = {"key": list(key), "tile_ms": times, "source": source,
               "winner": winner, "gap": gap, "clock": row.get("clock")}
        out.append(res)
        if row.get("clock") != "cuda_events":
            fail("ops_planes: the tune at %s ranked on the %s clock"
                 % (key, row.get("clock")))
        if gap > TILE_MARGIN and winner != fastest:
            fail("ops_planes: the tune at %s chose %s where the CUDA-event "
                 "times rank %s first: %s" % (key, winner, fastest, times))
    return out


_PLANES_SERVE = r"""
import json, os, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
print(json.dumps(chip_smoke._planes_serve_child(int(sys.argv[2]))))
"""


def _planes_serve_child(seed, cfg=PLANES_CFG):
    """Part b, in a child process started with ``MXNET_AUTOTUNE=1`` on
    part a's store: BERT-base fp32 serves the serve recipe's requests in
    full batches of 8 (a long ``max_wait_us``, so both passes batch
    alike), tuned; then the same requests with autotune off.  Returns the
    lookups by provenance, the flash launches by tile, and whether every
    answer is bit-identical."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autotune
    from mxnet_tpu_torch.gluon.model_zoo import bert
    from mxnet_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    T, vocab, n_req = cfg["T"], cfg["vocab"], cfg["n_req"]
    block = bert.bert_12_768_12(vocab_size=vocab, max_length=T)
    mx.convert.load_jax_params(block, bert_params(block, seed))
    rng = np.random.default_rng(seed + 1)
    lengths = rng.integers(64, T + 1, n_req)
    reqs = [(rng.integers(0, vocab, L).astype(np.int32),
             (np.arange(L) >= L // 2).astype(np.int32)) for L in lengths]

    def serve_all():
        srv = mx.serve.Server(block, config=mx.serve.ServeConfig(
            max_batch_size=8, max_wait_us=5_000_000,
            sample_shapes=[((T,), (T,))], dtype="int32"))
        try:
            mx.telemetry.reset()
            fa.flash_attention.launches = 0
            fa.flash_attention.launches_by_tile = {}
            with ThreadPoolExecutor(max_workers=n_req) as pool:
                outs = list(pool.map(srv.submit, reqs))
            stats = {
                "launches": fa.flash_attention.launches,
                "launches_by_tile": {"%dx%d" % t: n for t, n in
                                     fa.flash_attention.launches_by_tile
                                     .items()},
                "batches": int(mx.telemetry.value("serve_batches_total")),
                "lookups": {r: mx.telemetry.value(
                    "autotune_lookup_total",
                    {"site": "flash_attention", "result": r})
                    for r in ("tuned", "default")},
                "fallbacks": mx.telemetry.value("autotune_fallback_total")}
        finally:
            srv.shutdown()
        return outs, stats

    if autotune.mode() != "on":
        raise SystemExit("the child was not started with MXNET_AUTOTUNE=1")
    t0 = time.perf_counter()
    tuned, tuned_stats = serve_all()
    key = (8, 12, T, T, 64, "float32", False)
    winner, prov = autotune.lookup_info("flash_attention", key, None)
    autotune.disable()
    plain, plain_stats = serve_all()
    same = all(a.tobytes() == b.tobytes() and a.shape == b.shape
               for ta, tb in zip(tuned, plain) for a, b in zip(ta, tb))
    finite = all(np.isfinite(a).all() for t in tuned for a in t)
    return {"tuned": tuned_stats, "untuned": plain_stats,
            "winner": winner, "provenance": prov,
            "bit_identical": bool(same), "finite": bool(finite),
            "serve_s": time.perf_counter() - t0}


def _planes_serve(mx, seed, store):
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, MXNET_AUTOTUNE="1", MXNET_AUTOTUNE_DIR=store)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", _PLANES_SERVE, here,
                          str(seed)], capture_output=True, text=True,
                         env=env, timeout=600)
    if out.returncode:
        fail("ops_planes: the serving child exited %d: %s"
             % (out.returncode, out.stderr[-2000:]))
    res = json.loads(out.stdout.strip().splitlines()[-1])
    res["child_s"] = time.perf_counter() - t0
    t, u = res["tuned"], res["untuned"]
    if res["provenance"] != "tuned" or t["lookups"]["tuned"] != \
            12 * t["batches"] or t["lookups"]["default"]:
        fail("ops_planes: served lookups not all tuned: %s" % res)
    if not res["bit_identical"] or not res["finite"]:
        fail("ops_planes: tuned answers differ from the untuned ones")
    if t["launches"] != 12 * t["batches"] or u["launches"] != \
            12 * u["batches"] or t["batches"] != 4 or u["batches"] != 4:
        fail("ops_planes: flash launches %s" % res)
    if t["launches_by_tile"] != {"%dx%d" % tuple(res["winner"]):
                                 t["launches"]}:
        fail("ops_planes: the tuned launches ran %s, not the winner %s"
             % (t["launches_by_tile"], res["winner"]))
    return res


def _planes_train(torch, mx, fa, seed, cfg, tmp):
    """Part c: ``train`` steps of fp32 BERT-base (B=8, T=512, Adam) with
    the monitor publishing to a JSONL stream, a watchdog, the flight
    recorder, ``mx.profiler`` and autotune (on the tuned store) all on;
    then a poisoned gradient (one divergence dump naming the group), a
    step held up on the host (one slow_step dump, from a detector with
    min_samples 2), and a watch around a blocked wait (one watchdog
    fire with stacks)."""
    from mxnet_tpu_torch import monitor, profiler, telemetry, trace
    from mxnet_tpu_torch.gluon.model_zoo import bert

    B, T, M, vocab = cfg["B"], cfg["T"], cfg["M"], cfg["vocab"]
    stream = os.path.join(tmp, "monitor.jsonl")
    os.environ["MXNET_MONITOR_STREAM"] = stream
    os.environ["MXNET_MONITOR_SENTINEL"] = "warn"
    net = bert.bert_12_768_12(pretraining=True, vocab_size=vocab,
                              max_length=T, dropout=DROPOUT_P)
    net.initialize()
    mx.convert.load_jax_params(net, bert_params(net, seed))
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 1e-4})
    rng = np.random.default_rng(seed + 2)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in _train_batch(rng, B, T, M, vocab).items()}
    mx.random.seed(seed)
    monitor.reset()
    monitor.enable()
    trace.clear()
    wd = trace.watchdog.install(timeout=120.0, poll=0.25)
    telemetry.reset()
    profiler.set_config(filename=os.path.join(tmp, "profile.json"))
    counters = (fa.flash_attention, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    out = {}
    try:
        # the main path: the train steps, counted and profiled
        profiler.set_state("run")
        for c in counters:
            c.launches = 0
        losses = []
        t0 = time.perf_counter()
        for _ in range(cfg["train_steps"]):
            loss = _train_step(mx, bert, net, batch)
            trainer.step(1)
            losses.append(loss.item())
        launches = {c.__name__: c.launches for c in counters}
        train_s = time.perf_counter() - t0
        profiler.set_state("stop")
        dump_path = profiler.dump()
        stats = profiler.device_op_stats(top=40)
        with open(dump_path) as f:
            names = [e["name"] for e in json.load(f)["traceEvents"]]
        found = {k: sum(v in n for n in names)
                 for k, v in PLANE_KERNELS.items()}
        if not all(found.values()):
            fail("ops_planes: the profile lacks a flash kernel: %s" % found)
        flash_rows = [r for r in stats
                      if any(v in r["name"] for v in PLANE_KERNELS.values())]
        ranks = [i for i, r in enumerate(stats)
                 if any(v in r["name"] for v in PLANE_KERNELS.values())]
        if not all(np.isfinite(losses)):
            fail("ops_planes: nonfinite loss %s" % losses)
        if not monitor.flush(60):
            fail("ops_planes: the monitor's publisher did not drain")
        with open(stream) as f:
            lines = [json.loads(x) for x in f]
        if len(lines) != cfg["train_steps"]:
            fail("ops_planes: %d stream lines for %d steps"
                 % (len(lines), cfg["train_steps"]))
        out.update(losses=losses, launches=launches, train_s=train_s,
                   profile={"path_events": len(names),
                            "kernel_events": found,
                            "flash_ranks": ranks,
                            "flash_rows": flash_rows, "top": stats[:8]},
                   stream_lines=len(lines),
                   grad_global_norm=[x["grad_global_norm"] for x in lines])

        # a nonfinite gradient in one group: one divergence dump
        before = _plane_dumps(mx, "divergence")
        loss = _train_step(mx, bert, net, batch)
        name, p = next(iter(net.collect_params().items()))
        p.grad.view(-1)[0] = float("nan")
        trainer.step(1)
        if not monitor.flush(60):
            fail("ops_planes: the monitor's publisher did not drain")
        div = sorted(_plane_dumps(mx, "divergence") - before)
        if len(div) != 1:
            fail("ops_planes: %d divergence dumps for one poisoned step"
                 % len(div))
        with open(div[0]) as f:
            meta = json.load(f)["traceEvents"][0]["args"]
        if meta.get("kind") != "nonfinite_grads" or name not in \
                str(meta.get("group")):
            fail("ops_planes: the divergence dump names %s, not %s"
                 % (meta.get("group"), name))
        out["divergence"] = {"path": div[0], "group": meta["group"],
                             "poisoned": name}
        # restore finite weights for the timing steps below
        mx.convert.load_jax_params(net, bert_params(net, seed))
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": 1e-4})

        # a step held up on the host: one slow_step dump, from a detector
        # whose window holds this drill's own steps
        trace.anomaly.STEP_DETECTOR = trace.anomaly.SlowStepDetector(
            factor=3.0, min_samples=2)
        before = _plane_dumps(mx, "slow_step")
        durs = []
        for i in range(4):
            if i == 3:
                trainer.allreduce_grads = \
                    lambda: time.sleep(cfg["slow_step_sleep_s"])
            _train_step(mx, bert, net, batch).item()
            t1 = time.perf_counter()
            trainer.step(1)
            durs.append(time.perf_counter() - t1)
        del trainer.allreduce_grads
        slow = sorted(_plane_dumps(mx, "slow_step") - before)
        if len(slow) != 1:
            fail("ops_planes: %d slow_step dumps for one delayed step "
                 "(step host s %s)" % (len(slow), durs))
        out["slow_step"] = {"path": slow[0], "step_host_s": durs}

        # a watch around a blocked host wait: one fire, stacks and a dump
        fires0 = telemetry.value("trace_watchdog_fires_total",
                                 {"scope": "planes_blocked_wait"})
        with trace.watchdog.watch("planes_blocked_wait",
                                  timeout=cfg["watch_timeout_s"]):
            threading.Event().wait(cfg["watch_timeout_s"] * 1.5)
        fires = telemetry.value("trace_watchdog_fires_total",
                                {"scope": "planes_blocked_wait"}) - fires0
        scope, stacks, trace_path = wd.last_report or (None, None, None)
        if fires != 1 or scope != "planes_blocked_wait" or not stacks \
                or not trace_path:
            fail("ops_planes: the watchdog fired %s times (%s)"
                 % (fires, wd.last_report))
        with open(stacks) as f:
            text = f.read()
        if "planes_blocked_wait" not in text or "_planes_train" not in text:
            fail("ops_planes: the watchdog's stacks lack the blocked wait")
        out["watchdog"] = {"fires": fires, "stacks": stacks,
                           "trace": trace_path}
    finally:
        if profiler.state() == "run":
            profiler.set_state("stop")
        trace.watchdog.uninstall()
        monitor.disable()
        monitor.shutdown(timeout=60)
        monitor.reset()
        trace.anomaly.STEP_DETECTOR = trace.anomaly.SlowStepDetector()
        for k in ("MXNET_MONITOR_STREAM", "MXNET_MONITOR_SENTINEL"):
            os.environ.pop(k, None)
    return out


def _planes_deadlines(torch, mx, cfg):
    """Part d: requests whose deadline has passed when the scheduler
    looks: a burst of misses on a Server fires one deadline_burst dump."""
    from mxnet_tpu_torch.gluon import nn

    block = nn.Dense(16, in_units=16)
    block.initialize()
    srv = mx.serve.Server(block, config=mx.serve.ServeConfig(
        max_batch_size=4, sample_shapes=[(16,)]))
    before = _plane_dumps(mx, "deadline_burst")
    n = cfg["deadline_burst"] + 3
    misses = 0
    try:
        futs = [srv.submit_async(np.ones(16, np.float32), timeout_ms=0.0)
                for _ in range(n)]
        for f in futs:
            try:
                f.result(timeout=60)
            except mx.serve.RequestTimeout:
                misses += 1
    finally:
        srv.shutdown()
    dumps = sorted(_plane_dumps(mx, "deadline_burst") - before)
    if misses != n or len(dumps) != 1:
        fail("ops_planes: %d deadline misses gave %d deadline_burst dumps"
             % (misses, len(dumps)))
    return {"misses": misses, "dumps": dumps}


def phase_ops_planes(torch, mx, fa, seed, smi, cfg=PLANES_CFG):
    """The operational planes around BERT-base on the card: (a) the flash
    site tuned at three keys, (b) a tuned server in a child process,
    bit-identical to the untuned one, (c) training with every plane on,
    the divergence, slow-step and watchdog drills, (d) a deadline burst.
    Every file goes under ``$TMPDIR``."""
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="mx-planes-")
    store = os.path.join(tmp, "autotune")
    os.environ["MXNET_TRACE_DUMP_DIR"] = os.path.join(tmp, "dumps")
    os.environ["MXNET_TRACE_DUMP_MIN_SECONDS"] = "0"
    try:
        t0 = time.perf_counter()
        tune = _planes_tune(mx, cfg, store)
        emit({"phase": "ops_planes", "part": "tune", **tune, "card": smi})
        serve = _planes_serve(mx, seed, store)
        emit({"phase": "ops_planes", "part": "serve", **serve, "card": smi})
        from mxnet_tpu_torch import autotune

        autotune.enable("on", root=store)
        try:
            train = _planes_train(torch, mx, fa, seed, cfg, tmp)
        finally:
            autotune.disable()
        emit({"phase": "ops_planes", "part": "train", **train, "card": smi})
        dead = _planes_deadlines(torch, mx, cfg)
        emit({"phase": "ops_planes", "part": "deadlines", **dead,
              "phase_s": time.perf_counter() - t_phase, "card": smi})
    finally:
        os.environ.pop("MXNET_TRACE_DUMP_MIN_SECONDS", None)
        os.environ.pop("MXNET_TRACE_DUMP_DIR", None)
        shutil.rmtree(tmp, ignore_errors=True)
    launches = dict(train["launches"])
    launches["flash_attention"] += serve["tuned"]["launches"] + \
        serve["untuned"]["launches"]
    return launches


# ---------------------------------------------------------------------------
# phase resilience: fault handling and the SLO engine around BERT-base
# ---------------------------------------------------------------------------

RESIL_CFG = dict(B=8, T=512, M=76, vocab=30522, steps=6, every=3,
                 seed_base=7000, n_req=32, page_target_s=0.010,
                 ok_target_s=10.0, deadline_s=1.0, health_s=5.0,
                 child_timeout_s=400)
# the card's dense bf16 peak, the figure attribution's MFU divides by
PEAK_TFLOPS_H100 = 989.0


def _resil_model(mx, bert, seed, cfg, captured):
    """The ``train`` recipe's net (BERT-base pretraining, dropout 0.1,
    ``bert_params`` weights) with Adam at 1e-4, as a ``GluonStepLoop``
    (through ``trainer.capture`` when ``captured``)."""
    net = pretrain_step(mx, bert, seed, vocab_size=cfg["vocab"],
                        max_length=cfg["T"], dropout=DROPOUT_P)
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 1e-4})

    def loss_fn(out, labels, weights, nsp):
        return bert.pretraining_loss(out[0], out[1], labels, weights, nsp)

    program = trainer.capture(net, loss_fn) if captured else None
    loop = mx.resilience.GluonStepLoop(net, trainer, loss_fn,
                                       step_program=program)
    return net, trainer, program, loop


def _resil_batches(torch, mx, seed, cfg):
    """``batches(step)``: the step's own ``_train_batch`` on the card, and
    the port's generators seeded from the step, so a replay repeats the
    dropout masks as it repeats the data."""
    cache = {}

    def batches(step):
        if step not in cache:
            host = _train_batch(np.random.default_rng(seed + 100 + step),
                                cfg["B"], cfg["T"], cfg["M"], cfg["vocab"])
            cache[step] = (
                tuple(torch.from_numpy(host[k]).cuda()
                      for k in ("ids", "types", "pos")),
                tuple(torch.from_numpy(host[k]).cuda()
                      for k in ("labels", "weights", "nsp")))
        mx.random.seed(cfg["seed_base"] + step)
        return cache[step]

    return batches


def _digest(torch, net, trainer):
    """SHA-256 over the bytes of every parameter and every Adam state."""
    import hashlib

    h = hashlib.sha256()
    for p in net.collect_params().values():
        h.update(p.detach().contiguous().cpu().numpy().tobytes())
    for i in sorted(trainer._states):
        for t in _state_leaves(trainer._states[i]):
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _resil_reference(torch, mx, bert, seed, cfg, captured):
    """Part a: ``steps`` uninterrupted steps from the same init."""
    net, trainer, program, loop = _resil_model(mx, bert, seed, cfg,
                                               captured)
    batches = _resil_batches(torch, mx, seed, cfg)
    t0 = time.perf_counter()
    losses, step_s = [], []
    for s in range(cfg["steps"]):
        t1 = time.perf_counter()
        losses.append(loop.step(*batches(s)).item())   # synchronizes
        step_s.append(time.perf_counter() - t1)
    out = {"losses": losses, "digest": _digest(torch, net, trainer),
           "step_s": step_s, "s": time.perf_counter() - t0}
    if program is not None:
        out["paths"] = program.report()["paths"]
    del net, trainer, program, loop
    torch.cuda.empty_cache()
    return out


def _attribution_lines(path):
    with open(path) as f:
        return [json.loads(x) for x in f]


def _shares(recs):
    keys = sorted({k for r in recs for k in r["shares"]})
    return {k: round(float(np.mean([r["shares"].get(k, 0.0)
                                    for r in recs])), 4) for k in keys}


def _resil_transient(torch, mx, bert, seed, cfg, tmp, captured, ref):
    """Parts b and c: one planned transient (``trainer_step@4`` stitched,
    ``step_capture@4`` captured) under the supervisor, with the obs plane
    and attribution on."""
    from mxnet_tpu_torch import obs, telemetry, trace
    from mxnet_tpu_torch.resilience import inject, supervisor

    name = "captured" if captured else "stitched"
    root = os.path.join(tmp, "ckpt-" + name)
    stream = os.path.join(tmp, "attribution-%s.jsonl" % name)
    os.environ["MXNET_OBS_ATTRIBUTION"] = stream
    obs.enable()
    obs.attribution.reset()
    telemetry.reset()
    dumps0 = _plane_dumps(mx, "restart")
    net, trainer, program, loop = _resil_model(mx, bert, seed, cfg,
                                               captured)
    sup = supervisor.Supervisor(
        loop, mx.checkpoint.CheckpointManager(root),
        checkpoint_every=cfg["every"],
        backoff=supervisor.Backoff(base=0.0))
    inject.plan(("step_capture@4:transient" if captured
                 else "trainer_step@4:transient"))
    t0 = time.perf_counter()
    try:
        losses = sup.run(_resil_batches(torch, mx, seed, cfg), cfg["steps"])
    finally:
        inject.clear()
        obs.disable()
        os.environ.pop("MXNET_OBS_ATTRIBUTION", None)
    run_s = time.perf_counter() - t0
    obs.attribution.reset()
    digest = _digest(torch, net, trainer)
    rec = supervisor.recent_restarts()[-1]
    dumps = sorted(_plane_dumps(mx, "restart") - dumps0)
    recs = _attribution_lines(stream)
    out = {"losses": losses, "digest_equal": digest == ref["digest"],
           "losses_equal": losses == ref["losses"],
           "restarts": sup.restarts, "restart": rec,
           "restarts_counted": telemetry.value(
               "resilience_restarts_total", {"kind": "transient"}),
           "restart_dumps": len(dumps), "records": len(recs),
           "record_steps": [r["step"] for r in recs],
           "shares": _shares(recs), "run_s": run_s}
    if sup.restarts != 1 or rec["kind"] != "transient" or \
            rec["restored_step"] != cfg["every"] - 1 or \
            out["restarts_counted"] != 1 or len(dumps) != 1:
        fail("resilience %s: restarts %s, record %s, counted %s, dumps %s"
             % (name, sup.restarts, rec, out["restarts_counted"], dumps))
    if not out["digest_equal"] or not out["losses_equal"]:
        fail("resilience %s: the supervised run is not bit-identical to "
             "the uninterrupted one (losses %s vs %s)"
             % (name, losses, ref["losses"]))
    # every step executed, the replays included: 4 before the fault, then
    # the steps after the restored one
    executed = 4 + cfg["steps"] - cfg["every"]
    if len(recs) != executed or any(
            set(obs.attribution.SCHEMA_KEYS) - set(r) for r in recs):
        fail("resilience %s: %d attribution records for %d steps executed"
             % (name, len(recs), executed))
    if captured:
        rep = program.report()
        out["paths"] = rep["paths"]
        out["fallbacks"] = rep["fallbacks"]
        if rep["fallbacks"] or rep["paths"]["stitched"]:
            fail("resilience captured: the fault was replayed stitched: %s"
                 % rep)
        flops = [r["flops"] for r in recs]
        if not all(flops) or any(r["mfu"] is None for r in recs):
            fail("resilience captured: records without flops or mfu: %s"
                 % recs[:2])
        flash = _flash_train_flops(cfg)
        peak = PEAK_TFLOPS_H100 * 1e12
        # the reference's pure replays (step 0 runs eagerly, step 1
        # captures), each timed to its synchronizing loss read
        wall = float(np.median(ref["step_s"][2:]))
        out.update({
            "flops_counted": flops[0],
            "flash_flops_not_counted": flash,
            "record_mfu_median": float(np.median(
                [r["mfu"] for r in recs])),
            "record_total_s_median": float(np.median(
                [r["total_s"] for r in recs])),
            "step_wall_s_median": wall,
            "mfu_without_flash": flops[0] / wall / peak,
            "mfu_with_flash": (flops[0] + flash) / wall / peak,
            "mfu_peak_tflops": PEAK_TFLOPS_H100,
            "mfu_note": "flops counted by FlopCounterMode over the eager "
                        "pass, without the flash kernels (ctypes "
                        "launches); with_flash adds their 12 B H T^2 D a "
                        "layer.  record_mfu is the records' own: the host "
                        "time of the call, which for a graph replay is "
                        "its enqueue; the mfu_* pair divides by the step's "
                        "time of the reference's graph replays, each to "
                        "its synchronizing loss read"})

    del net, trainer, program, loop, sup
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    return out


def _flash_train_flops(cfg, layers=12, heads=12, head_dim=64):
    """The attention products the flash kernels do in one training step
    (forward Q K^T and P V, backward dP, dS K, dS^T Q and P^T dO; no
    recompute counted): 12 B H T^2 D a layer."""
    return float(layers * 12 * cfg["B"] * heads * cfg["T"] ** 2 * head_dim)


def _resil_divergence(torch, mx, bert, seed, cfg, tmp, ref):
    """Part d: the monitor's skip_step sentinel and a gradient poisoned
    once at step ``every`` (the step after a save): one divergence dump
    naming the group, one restore, no nonfinite checkpoint on disk."""
    from mxnet_tpu_torch import autograd, monitor
    from mxnet_tpu_torch.resilience import supervisor

    root = os.path.join(tmp, "ckpt-divergence")
    net, trainer, program, loop = _resil_model(mx, bert, seed, cfg, False)
    poison_at = cfg["every"]
    name, param = next(iter(net.collect_params().items()))
    state = {"armed": True, "steps": []}
    plain = loop.step

    def step(x, y):
        state["steps"].append(trainer.step_count)
        if not (state["armed"] and trainer.step_count == poison_at):
            return plain(x, y)
        state["armed"] = False
        with autograd.record():
            loss = loop._loss_fn(net(*x), *y)
        autograd.backward(loss)
        param.grad.view(-1)[0] = float("nan")
        trainer.step(x[0].shape[0])
        return loss.mean()

    loop.step = step
    os.environ["MXNET_MONITOR_SENTINEL"] = "skip_step"
    monitor.reset()
    monitor.enable()
    dumps0 = _plane_dumps(mx, "divergence")
    sup = supervisor.Supervisor(
        loop, mx.checkpoint.CheckpointManager(root),
        checkpoint_every=cfg["every"], restore_on_divergence=True,
        backoff=supervisor.Backoff(base=0.0))
    t0 = time.perf_counter()
    try:
        losses = sup.run(_resil_batches(torch, mx, seed, cfg), cfg["steps"])
    finally:
        monitor.disable()
        monitor.shutdown(timeout=60)
        monitor.reset()
        os.environ.pop("MXNET_MONITOR_SENTINEL", None)
    run_s = time.perf_counter() - t0
    digest = _digest(torch, net, trainer)
    dumps = sorted(_plane_dumps(mx, "divergence") - dumps0)
    group = None
    if len(dumps) == 1:
        with open(dumps[0]) as f:
            group = json.load(f)["traceEvents"][0]["args"].get("group")
    mgr = mx.checkpoint.CheckpointManager(root)
    saved = mgr.steps()
    nonfinite = []
    for s in saved:
        _, tree = mgr.restore(step=s, ctx=mx.cpu())
        leaves = [t for v in (tree["params"], tree["states"])
                  for t in _flat_tensors(list(v.values()))]
        if not all(bool(torch.isfinite(t).all()) for t in leaves
                   if isinstance(t, torch.Tensor) and t.is_floating_point()):
            nonfinite.append(s)
        del tree, leaves
    out = {"divergence_restores": sup.divergence_restores,
           "divergence_dumps": len(dumps), "group": group,
           "poisoned": name, "steps_run": state["steps"],
           "saved_steps": saved, "nonfinite_checkpoints": nonfinite,
           "digest_equal": digest == ref["digest"],
           "losses_equal": losses == ref["losses"], "run_s": run_s}
    if len(dumps) != 1 or name not in str(group) or \
            sup.divergence_restores != 1:
        fail("resilience divergence: %s" % out)
    rec = supervisor.recent_restarts()[-1]
    out["restore"] = rec
    if rec["kind"] != "divergence" or rec["step"] != poison_at + 1 or \
            rec["restored_step"] != poison_at - 1:
        fail("resilience divergence: the restore did not come at the "
             "boundary after the poisoned step (it reached the supervisor "
             "after the next save): %s, steps %s" % (rec, state["steps"]))
    if nonfinite or not out["digest_equal"]:
        fail("resilience divergence: %s" % out)
    del net, trainer, loop, sup
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    return out


_RESIL_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
print(json.dumps(chip_smoke._resil_child(sys.argv[2], sys.argv[3],
                                         int(sys.argv[4]))), flush=True)
"""


def _resil_requests(seed, cfg):
    rng = np.random.default_rng(seed + 1)
    lengths = rng.integers(64, cfg["T"] + 1, cfg["n_req"])
    return [(rng.integers(0, cfg["vocab"], L).astype(np.int32),
             (np.arange(L) >= L // 2).astype(np.int32)) for L in lengths]


def _resil_child(role, root, seed, cfg=RESIL_CFG):
    """Part e in a process of its own.  ``A``: arms the SIGTERM handler,
    serves BERT-base to a client thread that keeps submitting, and runs
    the supervised stitched loop (a line a step) with
    ``exit_on_preempt=True``; after the preemption exit it reports what
    was submitted and answered and exits with that code.  ``B``: resumes
    the loop from ``root`` and finishes the steps."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import bert
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.resilience import preempt, supervisor

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    _reset_flash(fa)

    class Manager(mx.checkpoint.CheckpointManager):
        """Times the emergency save: its snapshot, commit and wait."""
        emergency_s = None

        def save_async(self, step, tree):
            self._t_async = time.perf_counter()
            return super().save_async(step, tree)

        def wait(self):
            out = super().wait()
            if getattr(self, "_t_async", None) is not None:
                self.emergency_s = time.perf_counter() - self._t_async
            return out

    net, trainer, _, loop = _resil_model(mx, bert, seed, cfg, False)
    inner = _resil_batches(torch, mx, seed, cfg)

    def batches(step):
        print(json.dumps({"child": role, "step": step}), flush=True)
        return inner(step)

    mgr = Manager(root)
    out = {"role": role}
    if role == "B":
        sup = supervisor.Supervisor(loop, mgr,
                                    checkpoint_every=cfg["every"])
        out["resumed_from"] = mgr.latest_step()
        out["losses"] = sup.run(batches, cfg["steps"])
        out["digest"] = _digest(torch, net, trainer)
        out["launches"] = _flash_counts(fa)
        out["wall_s"] = time.perf_counter() - t_start
        return out

    if not preempt.install():
        raise SystemExit("the SIGTERM handler could not be armed")
    block = bert.bert_12_768_12(vocab_size=cfg["vocab"], max_length=cfg["T"])
    mx.convert.load_jax_params(block, bert_params(block, seed))
    srv = mx.serve.Server(block, config=mx.serve.ServeConfig(
        max_batch_size=8, sample_shapes=[((cfg["T"],), (cfg["T"],))],
        dtype="int32"))
    reqs = _resil_requests(seed, cfg)
    futs, stop = [], threading.Event()
    counts = {"submitted": 0, "overloaded": 0, "closed": 0}

    def client():
        i = 0
        while not stop.is_set():
            try:
                futs.append(srv.submit_async(reqs[i % len(reqs)]))
                counts["submitted"] += 1
                i += 1
            except mx.serve.ServerOverloaded:
                counts["overloaded"] += 1
                time.sleep(0.005)
            except mx.serve.ServerClosed:
                counts["closed"] += 1
                return
            time.sleep(0.002)

    th = threading.Thread(target=client, name="resil-client")
    th.start()
    sup = supervisor.Supervisor(loop, mgr, checkpoint_every=cfg["every"],
                                exit_on_preempt=True)
    code = None
    try:
        sup.run(batches, cfg["steps"])
    except SystemExit as exc:
        code = exc.code
    stop.set()
    th.join(timeout=60)
    answered = errors = 0
    for f in futs:
        try:
            f.result(timeout=60)
            answered += 1
        except Exception:  # noqa: BLE001 - counted, the check is below
            errors += 1
    srv.shutdown(timeout=60)
    out.update({"exit_code": code, "preempted": sup.preempted,
                "emergency_checkpoint": sup.emergency_checkpoint,
                "emergency_step": mgr.latest_step(),
                "emergency_save_s": mgr.emergency_s,
                "accepted": counts["submitted"], "answered": answered,
                "dropped": errors, "overloaded": counts["overloaded"],
                "client_alive": th.is_alive(),
                "launches": _flash_counts(fa),
                "wall_s": time.perf_counter() - t_start})
    print(json.dumps(out), flush=True)
    sys.stdout.flush()
    sys.exit(code if code is not None else 1)


def _resil_sigterm(torch, mx, seed, cfg, tmp, ref):
    """Part e: child A is sent a real SIGTERM after its step-1 line; child
    B resumes from the emergency checkpoint to the uninterrupted digest."""
    import signal

    from mxnet_tpu_torch.resilience import preempt

    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(tmp, "ckpt-sigterm")
    env = dict(os.environ, MXNET_PREEMPT_GRACE_SECONDS="120")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-c", _RESIL_CHILD, here, "A", root, str(seed)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    lines, sent = [], None
    killer = threading.Timer(cfg["child_timeout_s"], proc.kill)
    killer.start()
    try:
        for line in proc.stdout:
            lines.append(line.strip())
            if sent is None and '"step": 1}' in line:
                proc.send_signal(signal.SIGTERM)
                sent = time.perf_counter()
        rc = proc.wait(timeout=60)
        err = proc.stderr.read()
    finally:
        killer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    a_s = time.perf_counter() - t0
    try:
        a = json.loads(lines[-1])
    except (IndexError, ValueError):
        fail("resilience sigterm: child A printed no summary (rc %s): %s"
             % (rc, err[-3000:]))
    if sent is None or rc != preempt.exit_code() or \
            a["exit_code"] != preempt.exit_code():
        fail("resilience sigterm: child A exited %s after SIGTERM at %s "
             "(want %d): %s %s" % (rc, sent, preempt.exit_code(), a,
                                   err[-2000:]))
    if a["emergency_step"] != 1 or not a["preempted"] or \
            not a["emergency_checkpoint"] or a["dropped"] or \
            a["answered"] != a["accepted"] or not a["accepted"] or \
            a["client_alive"]:
        fail("resilience sigterm: child A %s" % a)
    t1 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-c", _RESIL_CHILD, here, "B", root, str(seed)],
        capture_output=True, text=True, timeout=cfg["child_timeout_s"],
        env=env)
    b_s = time.perf_counter() - t1
    if out.returncode:
        fail("resilience sigterm: child B exited %d: %s"
             % (out.returncode, out.stderr[-3000:]))
    b = json.loads(out.stdout.strip().splitlines()[-1])
    if b["resumed_from"] != 1 or b["digest"] != ref["digest"] or \
            b["losses"] != ref["losses"][2:]:
        fail("resilience sigterm: child B resumed from %s to another "
             "digest (losses %s vs %s)" % (b["resumed_from"], b["losses"],
                                           ref["losses"][2:]))
    shutil.rmtree(root, ignore_errors=True)
    return {"child_a": {k: a[k] for k in (
                "exit_code", "emergency_step", "emergency_save_s",
                "accepted", "answered", "dropped", "overloaded",
                "launches", "wall_s")},
            "child_a_lines": [x for x in lines if '"step"' in x],
            "child_a_process_s": a_s,
            "child_b": {k: b[k] for k in ("resumed_from", "losses",
                                          "launches", "wall_s")},
            "child_b_process_s": b_s, "digest_equal": True}


def _resil_slo(torch, mx, seed, cfg):
    """Part f: two SLOs on ``serve_request_seconds`` (q=0.99) of an
    in-process BERT-base server, evaluated once before the requests: a
    10 ms target (below one forward) pages, a 10 s one stays OK; /statz,
    /healthz and the telemetry log line show them."""
    import urllib.request

    from mxnet_tpu_torch import obs, telemetry
    from mxnet_tpu_torch.gluon.model_zoo import bert

    block = bert.bert_12_768_12(vocab_size=cfg["vocab"], max_length=cfg["T"])
    mx.convert.load_jax_params(block, bert_params(block, seed))
    srv = mx.serve.Server(block, config=mx.serve.ServeConfig(
        max_batch_size=8, sample_shapes=[((cfg["T"],), (cfg["T"],))],
        dtype="int32"))
    obs.enable()
    obs.slo_engine.clear()
    telemetry.reset()
    page, ok = "serve_p99_10ms", "serve_p99_10s"
    try:
        obs.slo(page, histogram="serve_request_seconds", q=0.99,
                target=cfg["page_target_s"])
        obs.slo(ok, histogram="serve_request_seconds", q=0.99,
                target=cfg["ok_target_s"])
        obs.slo_engine.evaluate()          # the baseline sample
        reqs = _resil_requests(seed, cfg)
        with ThreadPoolExecutor(max_workers=len(reqs)) as pool:
            outs = list(pool.map(srv.submit, reqs))
        if not all(np.isfinite(o).all() for out in outs for o in out):
            fail("resilience slo: nonfinite answers")
        host, port = srv.start_http()

        def get(path):
            try:
                with urllib.request.urlopen(
                        "http://%s:%d%s" % (host, port, path),
                        timeout=60) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        code_h, health = get("/healthz")
        code_s, statz = get("/statz")
        line = telemetry.log_line()
        p99 = telemetry.histogram_quantiles("serve_request_seconds",
                                            (0.5, 0.99))
    finally:
        srv.shutdown(timeout=60)
        obs.slo_engine.clear()
        obs.disable()
    slo = statz.get("slo") or {}
    out = {"healthz": [code_h, health.get("status"), health.get("slo")],
           "statz_slo": slo, "obs_slo_state_in_log_line":
               "obs_slo_state=2" in line,
           "request_p50_s": p99.get(0.5), "request_p99_s": p99.get(0.99),
           "requests": len(outs)}
    if code_h != 200 or health.get("status") != "degraded" or \
            health.get("slo") != {page: "PAGE", ok: "OK"} or \
            slo.get(page, {}).get("state") != "PAGE" or \
            slo.get(ok, {}).get("state") != "OK" or \
            not out["obs_slo_state_in_log_line"]:
        fail("resilience slo: %s" % out)
    del srv, block
    torch.cuda.empty_cache()
    return out


def _resil_deadlines(torch, mx, cfg):
    """Part g: a collective deadline around a wait that never returns, and
    the device health probe, healthy and blocked."""
    from mxnet_tpu_torch import dist, resilience, telemetry

    release = threading.Event()
    dumps0 = _plane_dumps(mx, "dist_timeout")
    n0 = telemetry.value("dist_collective_timeouts_total",
                         {"site": "resilience_drill"})
    t0 = time.perf_counter()
    try:
        dist.run_with_deadline(lambda: release.wait(600),
                               site="resilience_drill",
                               timeout=cfg["deadline_s"])
        fail("resilience deadline: run_with_deadline returned")
    except dist.DistTimeout as exc:
        late = time.perf_counter() - t0
        kind = mx.resilience.classify(exc)
    finally:
        release.set()
    dumps = sorted(_plane_dumps(mx, "dist_timeout") - dumps0)
    counted = telemetry.value("dist_collective_timeouts_total",
                              {"site": "resilience_drill"}) - n0
    t1 = time.perf_counter()
    health = resilience.health_check(timeout=cfg["health_s"])
    health_s = time.perf_counter() - t1
    block = threading.Event()
    t2 = time.perf_counter()
    try:
        hung = resilience.health_check(timeout=cfg["deadline_s"],
                                       probe=lambda d: block.wait(600))
    finally:
        block.set()
    hung_s = time.perf_counter() - t2
    out = {"timeout_after_s": late, "classified": kind,
           "dist_timeout_dumps": len(dumps), "counted": counted,
           "health": health, "health_s": health_s, "hung": hung,
           "hung_s": hung_s}
    if not 1.0 <= late <= 3.0 or kind != "transient" or len(dumps) != 1 \
            or counted != 1 or health != {"cuda:0": "ok"} or \
            not all(v.startswith("error: timeout") for v in hung.values()) \
            or hung_s > cfg["deadline_s"] + 2.0:
        fail("resilience deadlines: %s" % out)
    return out


def phase_resilience(torch, mx, fa, seed, smi, cfg=RESIL_CFG):
    """Fault handling and the SLO engine around BERT-base (the ``train``
    and ``serve`` recipes): (a) the uninterrupted stitched and captured
    references, (b) a stitched transient, (c) a captured one, (d) a
    divergence restore, (e) a real SIGTERM across two processes, (f) two
    SLOs on a server, (g) a collective deadline and the health probe.
    Every file goes under ``$TMPDIR``."""
    from mxnet_tpu_torch.gluon.model_zoo import bert

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="mx-resilience-")
    os.environ["MXNET_TRACE_DUMP_DIR"] = os.path.join(tmp, "dumps")
    os.environ["MXNET_TRACE_DUMP_MIN_SECONDS"] = "0"
    _reset_flash(fa)
    try:
        t0 = time.perf_counter()
        ref_s = _resil_reference(torch, mx, bert, seed, cfg, False)
        ref_c = _resil_reference(torch, mx, bert, seed, cfg, True)
        emit({"phase": "resilience", "part": "reference",
              "stitched": ref_s, "captured": ref_c,
              "s": time.perf_counter() - t0, "card": smi})
        for name, captured, ref in (("stitched", False, ref_s),
                                    ("captured", True, ref_c)):
            t0 = time.perf_counter()
            res = _resil_transient(torch, mx, bert, seed, cfg, tmp,
                                   captured, ref)
            emit({"phase": "resilience", "part": "transient_" + name,
                  **res, "s": time.perf_counter() - t0, "card": smi})
        t0 = time.perf_counter()
        res = _resil_divergence(torch, mx, bert, seed, cfg, tmp, ref_s)
        emit({"phase": "resilience", "part": "divergence", **res,
              "s": time.perf_counter() - t0, "card": smi})
        launches = _flash_counts(fa)
        t0 = time.perf_counter()
        sig = _resil_sigterm(torch, mx, seed, cfg, tmp, ref_s)
        emit({"phase": "resilience", "part": "sigterm", **sig,
              "s": time.perf_counter() - t0, "card": smi})
        _reset_flash(fa)
        t0 = time.perf_counter()
        res = _resil_slo(torch, mx, seed, cfg)
        emit({"phase": "resilience", "part": "slo", **res,
              "s": time.perf_counter() - t0, "card": smi})
        res = _resil_deadlines(torch, mx, cfg)
        emit({"phase": "resilience", "part": "deadlines", **res,
              "phase_s": time.perf_counter() - t_phase, "card": smi})
    finally:
        os.environ.pop("MXNET_TRACE_DUMP_MIN_SECONDS", None)
        os.environ.pop("MXNET_TRACE_DUMP_DIR", None)
        shutil.rmtree(tmp, ignore_errors=True)
    # the in-process drills (first runs and replays), the children's own
    # counts and the SLO part's served forwards
    served = _flash_counts(fa)
    total = {n: launches[n] + sig["child_a"]["launches"][n]
             + sig["child_b"]["launches"][n] + served[n] for n in launches}
    if not all(total.values()):
        fail("resilience: a flash kernel never launched: %s" % total)
    return total


_TRAP_PROBE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from mxnet_tpu_torch import profiler
print(json.dumps({"kernels": len(profiler._probe_device_events())}))
"""


def phase_profiler_trap(torch, mx, fa, seed, smi):
    """Part e of ``ops_planes``, after ``phase_decode``: ``mx.profiler``
    once more in this process.  Either a session records the flash
    kernels, or ``set_state('run')`` refuses it because torch's profiler
    records no device activity here (and a fresh process does); a session
    that runs and holds no kernel fails the run."""
    from mxnet_tpu_torch import profiler

    t0 = time.perf_counter()
    out = {"autograd_profiler_enabled": bool(
        torch.autograd.profiler._is_profiler_enabled),
        "kineto_session_open": bool(
            torch._C._autograd._profiler_enabled()),
        "threads": sorted(t.name for t in threading.enumerate())}
    q = torch.randn(8, 12, 512, 64, device="cuda", requires_grad=True)
    try:
        profiler.set_state("run")
    except mx.MXNetError as exc:
        out["run"] = "refused"
        out["error"] = str(exc)
        here = os.path.dirname(os.path.abspath(__file__))
        child = subprocess.run([sys.executable, "-c", _TRAP_PROBE, here],
                               capture_output=True, text=True, timeout=300)
        out["fresh_process_kernels"] = json.loads(
            child.stdout.strip().splitlines()[-1])["kernels"] \
            if child.returncode == 0 else None
        out["probe_in_new_thread"] = _probe_in_thread(profiler)
        if not out["fresh_process_kernels"]:
            fail("ops_planes: the profiler refused here and a fresh "
                 "process records no kernel either: %s" % out)
    else:
        fa.flash_attention(q, q, q).sum().backward()
        profiler.set_state("stop")
        stats = profiler.device_op_stats(top=40)
        found = {k: sum(r["occurrences"] for r in stats if v in r["name"])
                 for k, v in PLANE_KERNELS.items()}
        out["run"] = "recorded"
        out["kernel_events"] = found
        if not all(found.values()):
            fail("ops_planes: a profile after the decode phase holds no "
                 "flash kernel: %s" % out)
    out["trap_s"] = time.perf_counter() - t0
    emit({"phase": "ops_planes", "part": "profiler_trap", **out,
          "card": smi})
    return out


def _probe_in_thread(profiler):
    """Kernels a probe session sees from a thread of its own (whether
    the fault follows the thread)."""
    got = []
    t = threading.Thread(target=lambda: got.append(
        len(profiler._probe_device_events())), name="mx-trap-probe")
    t.start()
    t.join(timeout=120)
    return got[0] if got else None


def _kernel_entry(name, launches, case, ms, plain_ms, bound_key, errs):
    """One kernel route's summary from its case: ``bound_key`` None for
    the forward's bound (``bound_ms``), else "dq"/"dkv"; ``errs`` the
    case's error key (forward) or output names (backward)."""
    source, replaces = KERNELS[name]
    prefix = "" if bound_key is None else bound_key + "_"
    if isinstance(errs, str):
        err = case[errs]
    else:
        err = max(case["max_abs_err"][o] for o in errs)
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches,
             "dtype": case["dtype"], "shape": case["shape"],
             "dropout_p": case["dropout_p"], "max_abs_err": err,
             "ms": case[ms], "plain_ms": case[plain_ms],
             "bound_ms": case[prefix + "bound_ms"],
             "bound_by": case[prefix + "bound_by"],
             "library_ms": case["library_ms"],
             "library_backend": case["library_backend"]}
    if prefix + "bound_3xtf32_ms" in case:
        entry["bound_3xtf32_ms"] = case[prefix + "bound_3xtf32_ms"]
    return entry


def run_phase(fn, *args):
    """Call a phase; print its seconds in the script on a line of its own."""
    t0 = time.perf_counter()
    out = fn(*args)
    emit({"phase_time": fn.__name__, "s": time.perf_counter() - t0})
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import _ext
    from mxnet_tpu_torch.ops import flash_attention as fa

    # full-fp32 matrix products on the card: TF32 keeps ~3 digits
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    emit({"phase": "device", "name": name, "count": count,
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    _ext.build(force=True)
    emit({"phase": "build", "nvcc_s": time.perf_counter() - t0,
          "sources": [str(s.relative_to(_ext.LIBRARY.parents[2]))
                      for s in _ext.SOURCES],
          "ptxas": ptxas_report(_ext.build_log)})

    fwd_cases, bwd_cases = run_phase(phase_kernels, torch, fa, args.seed)
    common = (torch, mx, fa, args.seed, smi)
    serve_launches = run_phase(phase_serve, *common)
    train_launches, train_fp32 = run_phase(phase_train, *common)
    # the planes' profile must hold kernels: before checkpoint_resume and
    # decode, after which torch's profiler records none in this process
    planes_launches = run_phase(phase_ops_planes, *common)
    resil_launches = run_phase(phase_resilience, *common)
    bf16_launches = run_phase(phase_train_bf16, *common)
    resnet_launches = run_phase(phase_train_resnet, *common)
    captured_launches = run_phase(phase_train_captured, *common)
    run_phase(phase_train_captured_resnet, *common)
    nd_launches = run_phase(phase_nd_imperative, *common)
    lstm_launches = run_phase(phase_train_lstm, *common)
    gpt_launches, gpt_fwd, gpt_bwd = run_phase(phase_train_gpt_lm, *common)
    run_phase(phase_rnn_parts, *common)
    data_launches = run_phase(phase_data_pipeline, *common)
    vision_launches = run_phase(phase_train_vision, *common)
    zoo_launches = run_phase(phase_vision_zoo, *common)
    amp_launches = run_phase(phase_train_amp_fp16, *common, train_fp32)
    ckpt_launches = run_phase(phase_checkpoint_resume, *common)
    run_phase(phase_decode, *common)
    run_phase(phase_profiler_trap, *common)
    np_launches = run_phase(phase_np_front, *common)
    tail_launches = run_phase(phase_nd_tail, *common)

    # each route's numbers at its main path's shape, not causal: f32 at
    # (8, 12, 512, 512, 64), the forward as served (no dropout), the
    # backward as trained (p = 0.1); bf16 at the bf16 recipe's B=16 with
    # p = 0.1; fp16 as train_amp_fp16 runs it, B=8 with p = 0.1
    def case(cases, B, dname, p):
        return next(c for c in cases if c["shape"] == [B, 12, 512, 512, 64]
                    and c["dtype"] == dname and not c["causal"]
                    and c["dropout_p"] == p)

    route_cases = {"float32": (8, 0.0), "bfloat16": (16, DROPOUT_P),
                   "float16": (8, DROPOUT_P)}
    nd_fwd = nd_launches["flash_attention"]
    ck_f32, ck_bf16 = ckpt_launches["float32"], ckpt_launches["bfloat16"]
    fwd_launches = {"float32": serve_launches
                    + train_launches["flash_attention"]
                    + captured_launches["flash_attention"]
                    + nd_fwd["float32"] + ck_f32["flash_attention"]
                    + np_launches["flash_attention"]
                    + planes_launches["flash_attention"]
                    + resil_launches["flash_attention"],
                    "bfloat16": bf16_launches["flash_attention"]
                    + nd_fwd["bfloat16"]
                    + gpt_launches["flash_attention"]
                    + ck_bf16["flash_attention"],
                    "float16": amp_launches["flash_attention"]}
    routes = {dname: _kernel_entry(
        "flash_fwd", fwd_launches[dname], case(fwd_cases, B, dname, p),
        "ms", "plain_ms", None, "max_abs_err_o")
        for dname, (B, p) in route_cases.items()}
    # gpt_lm's route: bf16, causal, (8, 8, 1024, 1024, 32), no dropout
    routes["bfloat16_causal_d32"] = _kernel_entry(
        "flash_fwd", gpt_launches["flash_attention"], gpt_fwd, "ms",
        "plain_ms", None, "max_abs_err_o")
    entries = [dict(routes["float32"], routes=routes)]
    entries[0]["launches"] = sum(fwd_launches.values())
    entries[0]["launches_by_path"] = {
        "serve": serve_launches, "train": train_launches["flash_attention"],
        "train_bf16": bf16_launches["flash_attention"],
        "train_resnet": resnet_launches["flash_attention"],
        "train_captured_recorded": captured_launches["flash_attention"],
        "nd_imperative": sum(nd_fwd.values()),
        "train_lstm": lstm_launches["flash_attention"],
        "train_gpt_lm": gpt_launches["flash_attention"],
        "data_pipeline": data_launches["flash_attention"],
        "train_vision": vision_launches["flash_attention"],
        "vision_zoo": zoo_launches["flash_attention"],
        "train_amp_fp16": amp_launches["flash_attention"],
        "checkpoint_resume": ck_f32["flash_attention"]
        + ck_bf16["flash_attention"],
        "np_front": np_launches["flash_attention"],
        "nd_tail": tail_launches["flash_attention"],
        "ops_planes": planes_launches["flash_attention"],
        "resilience": resil_launches["flash_attention"]}
    for kname, short, outs in (("flash_bwd_dq", "dq", ("dq",)),
                               ("flash_bwd_dkv", "dkv", ("dk", "dv"))):
        nd_k = nd_launches[kname]
        launches = {"float32": train_launches[kname]
                    + captured_launches[kname] + nd_k["float32"]
                    + ck_f32[kname] + np_launches[kname]
                    + planes_launches[kname] + resil_launches[kname],
                    "bfloat16": bf16_launches[kname] + nd_k["bfloat16"]
                    + gpt_launches[kname] + ck_bf16[kname],
                    "float16": amp_launches[kname]}
        routes = {dname: _kernel_entry(
            kname, launches[dname],
            case(bwd_cases, B, dname, DROPOUT_P), short + "_ms",
            "plain_%s_ms" % short, short, outs)
            for dname, (B, _) in route_cases.items()}
        routes["bfloat16_causal_d32"] = _kernel_entry(
            kname, gpt_launches[kname], gpt_bwd, short + "_ms",
            "plain_%s_ms" % short, short, outs)
        entries.append(dict(routes["float32"], routes=routes))
        entries[-1]["launches"] = sum(launches.values())
        entries[-1]["launches_by_path"] = {
            "train": train_launches[kname],
            "train_bf16": bf16_launches[kname],
            "train_resnet": resnet_launches[kname],
            "train_captured_recorded": captured_launches[kname],
            "nd_imperative": sum(nd_k.values()),
            "train_lstm": lstm_launches[kname],
            "train_gpt_lm": gpt_launches[kname],
            "data_pipeline": data_launches[kname],
            "train_vision": vision_launches[kname],
            "vision_zoo": zoo_launches[kname],
            "train_amp_fp16": amp_launches[kname],
            "checkpoint_resume": ck_f32[kname] + ck_bf16[kname],
            "np_front": np_launches[kname],
            "nd_tail": tail_launches[kname],
            "ops_planes": planes_launches[kname],
            "resilience": resil_launches[kname]}
    emit({"kernels": entries})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
