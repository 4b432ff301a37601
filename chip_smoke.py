#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``paddle_tpu_torch``).

Drives the port's main path on one NVIDIA card and checks it:

  python3 chip_smoke.py [--ref-tokens FILE]

(``--ref-tokens``: another tree's greedy tokens of the serve lines, from
``python -m paddle_tpu_torch.kernels.paged_probe --root DIR --serve
FILE``; each serve line then reports ``greedy_equal_share_vs_parent``.)

Phases, in order (any failure exits non-zero and prints no result):

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. builds every kernel of the path from ``paddle_tpu_torch/kernels/
   csrc`` with ``nvcc`` for sm_90a (timed);
3. each kernel against its plain PyTorch version at the shapes the
   main path gives it (max_abs_err <= 1e-5), then timed beside its
   plain version, one PyTorch library call and its bound; the
   paged-attention rows (B1-B6) are also timed with the card's queue
   kept ahead of the host (``device_ms``, ``library_device_ms``: what
   they are judged by). B1/B2's row-tile kernel: two launches
   bit-equal, and rows launched alone bit-equal to the same rows in the
   80-row launch;
4. two full-width mixed steps with the kernel (under CUDA sync-debug
   "error": the step must not sync the host) against the same steps
   with the plain attention (logits and pools);
5. the main path: a chunked-prefill ``DecodeEngine`` at GPT-2-small
   width (the repo's ``bench.py`` decoder widths, 12 layers, random
   weights from a seed) serving 48 seeded requests, half of them
   sharing a 128-token prefix. The launch counts are zeroed just
   before the requests go in and read just after they all return;
   one request served solo must give the same greedy tokens.

The quantized slice adds, in the same run:

3b. the paged-attention kernel's bfloat16 lane and its quantized lane
   (int8 and fp8-e4m3 pools with random nonzero per-block scales), and
   the quantized matmul (int8 and fp8-e4m3) at the decoder's four
   projection shapes with M=80, each against its plain version, the
   a-priori error bound and itself (two launches bit-equal), and a
   library yardstick the port never calls, which quantizes x inside the
   timed call as the kernel does (beside it the same call on x quantized
   beforehand);
4b. a full-width int8 KV + int8 weight mixed step with the kernels
   (under sync-debug "error") against the same step with the plain
   versions, from the same zero pools;
5b. the slice's main path: the same engine with an int8 KV pool and
   int8 projection weights (``quant_plan="int8"``) serving the same 48
   requests, with exact launch counts of both kernels, a leak-free
   pool and solo == batched; then the first 16 requests on fp8-e4m3
   KV + fp8 weights and on bfloat16 KV with fp32 weights.

The whole-prompt slice adds, in the same run:

3c. the decode-step kernel (``paged_attention``, B3/B4) at the decode
   shape (16 slots, ragged contexts 0-512) and the row-tiled chunk
   kernel (``paged_attention_chunk``, B5/B6) at two whole-mode prefill
   shapes (rung 384 from position 0; rung 256 after a 128-token prefix
   hit; both with rung padding rows), every lane (float32, bfloat16,
   int8, fp8-e4m3) against its plain version, timed beside it, an SDPA
   yardstick on gathered K/V and its bound; and the chunk kernel at one
   row per slot against the decode kernel; B3/B4 launch B1/B2's row-tile
   kernel, so two launches and the mixed form on identity slots are held
   bit-equal to them;
4c. a full-width ``decode_step`` (16 ragged slots) and the two
   full-width ``prefill`` calls with the kernels (under sync-debug
   "error") against the same calls with the plain versions, in fp32 and
   with int8 KV + int8 weights (phase 4b's quantized gates);
5c. the slice's main paths: ``prefill_mode="whole"`` engines with the
   rungs (16, 32, 64, 128, 256, 384) serving the same 48 requests with
   continuous admission (fp32, and int8 KV + int8 weights) and with
   static admission (fp32), and the first 16 requests on fp8 and bf16
   KV. Launch counts are exact (B3/B4: layers x decode steps, B5/B6:
   layers x prefills, B7: 4 x layers x both, B1/B2: none); every request
   without the shared prefix gives the same greedy tokens continuous,
   static and served solo. Agreement with the chunked runs is reported;
   then ``profile_whole``: a decode step and a rung-384 prefill under
   ``torch.profiler``.

The speculative-decoding and beam slice adds, in the same run:

5g. the first 16 requests of the burst through speculative engines:
   ``serve_spec`` (chunked, fp32, γ 3, draft ``SPEC_DRAFT_CFG`` with
   weights from seed 7), ``serve_spec_self`` (whole, fp32, γ 4, the
   target as its own draft: the accept, γ-cap and rollback paths every
   round) and ``serve_spec_quant`` (whole, int8 KV for both models +
   int8 target weights, the small draft, γ 3). Launch counts are exact
   (whole: B3/B4 the draft's layers x γ x verify rounds, B5/B6 the
   target's layers x rounds + both models' layers x prefills, B7 four a
   target layer a call; chunked: B1 both models' layers x mixed steps,
   B3 the draft's layers x γ x rounds, B5 the target's layers x
   rounds), pools leak-free and consistent. Tokens are compared with
   the plain run of the same pool and weights (``serve``,
   ``serve_whole``, ``serve_whole_quant``): equal, or, for a request
   that differs, the plain run's tokens replayed teacher-forced through
   ``mixed_step`` on the card must show a near-tie at the first
   differing position (the two tokens' logits within ``_near_tie``'s
   bound); then ``serve_beam``: ``generate_beam(K=4,
   max_new_tokens=32)`` over requests 1 and 3 (the second hits the
   first's shared 128-token prefix in the prefix cache) on a whole-mode
   fp32 engine and a chunked engine with an int8 pool (the quantized
   copy-on-write, the prefix through the mixed step), each against
   ``impl="dense"`` on the same engine (``_beam_check``: fp32 beams
   equal or near-ties; the int8 pool's beams equal, bit for bit in
   their route, to ``_beams_by_value``: the same kernels over per-beam
   pool regions regathered by value, nothing shared; against the fp32
   dense lane reported only), with exact launch counts (B3/B4 layers x
   32 a call), ms a call, and the same calls on a twin engine with every copy checked on
   the card (payload bytes and scale rows equal the source block's; > 0
   copies) giving the same beams.

The serving telemetry plane (``obs/``: ``Telemetry``, the tracer, the
flight recorder, the alert rules, the profiler; the engine's lifecycle
ledger and serving-goodput decomposition) adds, in the same run:

5h. ``serve_telemetry``: the 48 requests through the chunked fp32
   engine with ``Telemetry(trace_path=<tmp>/trace.jsonl,
   flight=FlightRecorder(<tmp>, install_signal=False))`` and the ledger
   on: launch counts exactly as ``serve``'s, the pool leak-free and
   consistent, tokens equal to ``serve``'s (or a near-tie, as 5g
   holds them), 48 closed ``serving_request`` spans in the trace read
   back (one per request id), ``decode_ttft_ms`` counting 48, every
   retired ledger's four TTFT parts summing to its TTFT within 1e-3 ms
   and its submit <= admit <= first token <= finish, the components
   reconciling the loop wall within 10%, 0 < ``decode_goodput`` <= 1,
   the alert rules evaluated, every metric name of the live registry in
   a metric table of ``docs/observability.md`` / ``docs/serving.md``;
   it prints the verdict, the components, the TTFT attribution and
   ``requestz(n=3)``'s timelines. ``profile_telemetry``: the first 16
   requests again on that engine under ``tel.profiler``: the capture's
   ``paged_attention_rows_kernel`` events, counted by
   ``parse_device_trace``, equal the B1 launches of the window; device
   busy ms and the idle fraction beside the ``profile`` line's.
   ``serve_telemetry_spec_quant``: ``serve_spec_quant``'s engine (whole,
   int8 KV + weights, γ 3, the small draft) with telemetry, the first 16
   requests: 5g's launch counts, the ledger's ``spec`` events' accepted
   tokens equal to the engine's count, ``spec_overhead`` > 0, tokens as
   ``serve_spec_quant``'s (or near-ties under its bound).
   ``serve_telemetry_beam``: one ``generate_beam(K=4, 32 new)`` of
   request 1 on a fresh chunked int8 engine of ``serve_beam``'s: the
   beam mini-ledger's ``cow`` events equal the copies made, ``cow_copy``
   > 0, the beams ``serve_beam``'s. ``ledger_overhead``: the first 16
   requests on fresh chunked fp32 engines in turns (plain, telemetry and
   ledger, telemetry and ledger, plain): tokens/s and step ms p50 of
   each and the on / off ratio (reported, not gated), tokens equal in
   all four.

The training slice adds, in the same run:

3d. the flash-attention forward (B8) and its dq and dk/dv backward
   kernels (B9), fp32 and bf16 lanes, against their plain versions at
   the training shape [16, 12, 512, 64] causal, at a ragged T = 500 and
   at a non-causal cross shape (Tq 200, Tk 512); fp32 to 1e-5 (out,
   lse) and 1e-4 (dq, dk, dv), bf16 no further from the fp32 plain
   result than 1.5x the bf16 plain version + 1e-3; a query with no key
   gives zeros and lse NEG_INF; two forward launches bit-equal; each
   kernel timed beside its plain version, its bound and an SDPA
   yardstick (forward; backward) that the port never calls; then the
   same checks and timings at head_dim 128, the kernels' widest
   capacity ([4, 8, 512, 128] causal, ragged T = 500, cross Tq 200 / Tk
   512, and head_dim 96 inside that capacity: records named "_d128");
4d. one full-width training step (the transformer LM at bench.py's
   GPT-2-small widths, batch 16 x 512, 12 layers) in fp32 and in bf16
   with the kernels (under sync-debug "error") against the same step
   through the plain flash versions: the loss and every gradient leaf
   within relative L2 1e-4 (fp32) / 2e-2 (bf16); then the same with 6
   heads of 128 (``TRAIN_D128_CFG``);
5d. the slice's main path: ``make_train_step(cfg, lr=0.01)`` in bf16
   with ``attn_impl="flash"`` (``train_transformer``), 3 warm-up + 20
   timed steps (tokens/s, step ms p50, peak memory, every loss finite),
   each flash kernel launched exactly 12 x steps, then
   ``make_kstep_train_step`` with K = 8; then the same steps with
   ``attn_impl="xla"`` (``train_xla``: plain attention, tokens/s and
   loss agreement reported) and a short fp32 run; then short runs of
   the 6 x 128 heads' model in bf16 and fp32 (``train_d128``,
   ``train_d128_fp32``: the head_dim-128 records' launches); then
   ``profile_train``: two steps under ``torch.profiler``, with B8 and
   B9's device time per step.

The seq2seq slice adds, in the same run:

3e. the fused GRU forward (B12, ``gru_fwd``) and backward (B13: the
   reverse recurrence ``gru_bwd`` and the dW reduction ``gru_dw``), fp32
   and bf16 lanes, against their plain versions at the training shape (T
   30, B 512, D 512), the generation shape (B 128) and a ragged training
   batch (lengths 0..30); fp32 to 1e-5 (hs, gates) / 1e-4 (dx, dh0; dW
   by relative L2), bf16 no further from the fp32 plain result than 1.5x
   the bf16 plain version + 1e-3 (the bf16 recurrences on the resident
   route of ``fused_rnn.lstm_cluster_plan`` with three gates, the fp32
   ones on its grid route, whose plans at D 256 / 512 / 768 are
   printed); two launches of each kernel on the same inputs held
   bit-equal, each timed beside its plain version and its bound (``ms``,
   and ``device_ms`` with the card's queue kept ahead of the host, and µs
   a step; the fp32 recurrences' bound at 3xTF32, the CUDA-core one
   beside it; no PyTorch call computes this GRU; the dW reduction beside
   its yardstick, two ``torch.matmul`` calls with fp32 sums on pre-built
   operands), the recurrences' records with their plan (route, tile,
   clusters, waves; grid: the group's clusters, row tiles); and the fp32
   recurrences at hidden 640 (a D the grid route does not take: the
   streaming kernels, rows ``gru_{fwd,bwd}_stream_d640``) held the same
   way;
4e. one full-width seq2seq training step (bench.py's bench_seq2seq
   config, half the sources ragged) in fp32 and bf16 through the kernels
   (under sync-debug "error") against the same step through their plain
   versions: the loss and every gradient by relative L2 (fp32 1e-4; bf16
   no further from the fp32 plain gradient than 1.5x the bf16 plain
   path + 1e-2);
5e. the slice's main paths: ``train_seq2seq`` (bf16, Adam, 3 + 20
   steps over bench.py's 4 seeded batches: tokens/s, step ms, MFU, peak
   memory, every loss finite; each GRU kernel launched exactly 2 x
   steps, the recurrences also under ``gru_{fwd,bwd}_cluster``),
   ``train_seq2seq_fp32`` (2 + 5 steps, the fp32 lanes, ``_grid``),
   ``train_seq2seq_640_fp32`` (hidden 640, 1 + 2 steps, ``_stream``),
   ``generate_beam`` (bench_beam: fp32, batch 128, beam 5, length 30;
   one call under sync-debug "error", 2 ``gru_fwd`` and
   ``gru_fwd_grid`` launches per call, deterministic; best-beam
   agreement with the plain GRU reported) and ``profile_seq2seq`` (one
   bf16 step under ``torch.profiler``; B12 + B13's recurrences a step).

The text-classification slice adds, in the same run:

3f. the fused LSTM kernels: B10 (``lstm_fwd``), B11 (the reverse
   recurrence ``lstm_bwd`` and the dW reduction ``lstm_dw``), B14
   (``lstm_proj_fwd``: the input projection inside the recurrence) and
   B15 (``lstm_proj_bwd``: the recurrence with dxe and db;
   ``lstm_proj_dw``: dWx and dW), fp32 and bf16 lanes, against their
   plain versions at the flagship's two layer shapes (T 100, B 128,
   D 512; E 128 and E 512) and a ragged batch (lengths 0..100); fp32 to
   1e-5 (forwards absolute, backwards relative to their largest entry,
   weight sums by relative L2), bf16 no further from the fp32 plain
   result than 1.5x the bf16 plain version + 1e-3; each kernel timed
   (L2 flushed) beside its plain version and its bound (no PyTorch call
   computes this LSTM; the dW reductions beside their yardstick, one
   ``torch.matmul`` with fp32 sums on pre-built ``hprev`` or
   ``[xe | hprev]``, and two launches on the same inputs held
   bit-equal), B14/B15 at both layers. The recurrences' bf16 lane takes
   the resident route, their fp32 lane the grid route
   (``fused_rnn.lstm_cluster_plan`` of the call's one dtype; the fp32
   plans at D 256, 512 and 768 are printed first: units, group,
   clusters held). B14/B15's rows add the plan (tile
   rows, clusters, CTAs a cluster, the card's co-resident clusters),
   ``device_ms`` with the card's queue kept ahead of the host, µs a step
   of each recurrence alone, and (bf16) the cluster exchange alone
   (``lstm_exchange``: the forward's, the backward's and the barrier's µs
   a step over 100 empty steps); the route's pre-pass (``lstm_proj_xg``)
   and post-pass (``lstm_proj_dxe``) are rows of their own in each lane,
   each against its plain version (fp32: within 1e-5 of its largest
   entry), two launches bit-equal, beside a PyTorch GEMM of the lane
   (the bf16 pre-pass also beside the fp32-out one). The fp32
   recurrences' bound is their cheapest exact tensor-core form (three
   tf32 products), the CUDA-core one beside it (``bound_cuda_core_ms``).
   B10/B11's rows add the plan, ``device_ms`` and µs a step (each
   wrapper is its recurrence alone), and hold, at the uniform layers'
   shape and the ragged batch: each call counted under ``lstm_fwd`` /
   ``lstm_bwd`` and its route's name, B10 bit-equal to B14's recurrence
   (``lstm_cluster_fwd``) on float(x), B11's dx, dh0, dc0 to
   ``lstm_cluster_bwd``'s, two launches of each bit-equal. Past D 512
   the bf16 grid route at D 1024 and 1280 and the bf16 streaming route at
   D 640, and the fp32 streaming route at D 640 (a D the fp32 grid route
   does not take: T 100, B 128, E 128), for B10/B11 and B14/B15, forward
   and backward at the lane's gate, each counted under its route's name,
   rows of their own (``lstm_{fwd,bwd}_bf16_grid``, ...,
   ``lstm_{fwd,bwd}_stream``, ``lstm_proj_{fwd,bwd}_stream`` for fp32);
4f. one full-width flagship training step (bench.py's bench_lstm:
   ``lstm_benchmark_net`` with ``fused_lstm``, batch 128 x 100, vocab
   5147, emb 128, hidden 512, 2 layers) in fp32 and under AMP, and the
   composed route (fc + ``dynamic_lstm``: under AMP B10/B11 on the
   resident route) in both, through the kernels (under sync-debug
   "error"; each route's kernels launched twice, on the route's names)
   against the same step through their plain versions: the loss and
   every gradient by relative L2 (fp32 1e-4; AMP no further from the
   fp32 plain gradient than 1.5x the AMP plain path + 1e-2);
5f. the slice's main paths: ``train_lstm`` (bench_lstm: fused_lstm,
   AMP, Adam 0.002, 3 + 20 steps: ms per batch, words/s, MFU against
   bench.py's analytic FLOPs, peak memory, every loss finite; each
   B14/B15 kernel launched exactly 2 x steps, on the route the plan
   gives: in bf16 the resident one, its pre- and post-pass too; its ms
   per batch over ``train_lstm_composed``'s), ``train_lstm_composed``
   (fc + dynamic_lstm: B10/B11, 2 x steps, on the resident route's
   ``lstm_{fwd,bwd}_cluster`` names), ``train_lstm_ragged`` (ragged LoD,
   so fused_lstm falls back to B10/B11, the same names), short fp32 runs
   of both routes (the fp32 lanes' launches, on the ``_grid`` names, with
   the passes), short fp32 runs at hidden 640 (``train_lstm_640_fp32``,
   ``train_lstm_640_composed_fp32``: the fp32 streaming route's),
   ``train_lstm_wide`` (hidden 1024, AMP, 1 + 3 steps: B14/B15's bf16
   streaming route, 2 x steps each), ``train_lstm_wide_ragged`` (the
   same on ragged LoD: B10/B11's bf16 streaming route), ``profile_lstm``
   (three steps under ``torch.profiler``: the kernels' device ms a step,
   the pre-pass, the recurrences and the post-pass by name, the device's
   busy and idle share) and ``profile_lstm_composed`` (the same for the
   composed route: B10/B11's recurrences and B11's dW by name).

The framework core adds, in the same run:

6a. ``exec_mlp``: the MNIST MLP (``models.mnist.mlp`` at bench.py's
   784-128-64-10, batch 64, ``Adam(0.01).minimize``) through the layers
   DSL and ``Executor(CUDAPlace(0))`` on seeded host batches with a class
   signal: the startup program, 3 + 20 timed steps (ms a step p50 from
   CUDA events, the host's enqueue ms a step and µs per registry op, and
   the forward's alone; every loss finite, the last below the first),
   then 5 steps equal to
   the same 5 on ``CPUPlace`` from a copy of the state (losses and every
   persistable within 1e-5, Adam's eps-regime elements within 1e-4), a
   step under sync-debug "error", ``run_multi(K=8)`` bit-equal to 8
   ``run``s, and three steps under ``torch.profiler`` (device busy ms,
   idle share);
6b. ``exec_text``: the classifier's op list as a Program
   (``text.build_program(TextConfig())``, bench_lstm's widths, Adam
   0.002) through ``Executor(CUDAPlace(0), amp=True)``: 3 + 20 steps at
   uniform lengths and 1 + 3 on ragged LoD, the launch counts zeroed just
   before each run and read just after (B14/B15, then B10/B11, on the
   resident route's names, exactly twice a step), every step's loss
   equal to ``make_train_step``'s from the same parameters (rtol 1e-4),
   ms a batch beside ``train_lstm``'s, and three uniform steps under
   ``torch.profiler`` beside ``profile_lstm``'s.

The training entry point adds:

6c. ``trainer_lstm``: ``text.lstm_benchmark_net(fused_proj=True)`` built
   by the layers DSL at bench_lstm's widths (vocab 5147, emb 128, hidden
   512, 2 layers, batch 128 x 100, ``Adam(0.002)``), its op list and
   ``fingerprint`` equal to ``text.build_program(TextConfig())``'s,
   trained by ``Trainer(..., metrics=[acc], executor=
   Executor(CUDAPlace(0), amp=True))`` over ``reader.batch`` of a seeded
   sample generator: 3 + 20 batches at K = 1 (every cost bit-equal to
   ``Executor.run`` over ``build_program`` from the same startup state
   on the same feeds), the same with ``double_buffer=True`` and with
   ``steps_per_call=8`` (3 groups); one pass over ``datasets.imdb``'s
   ragged surrogate (batch 128, lengths 20-100) and one bucketed pass
   (``bucket_by_sequence_length`` over boundaries 25 / 50 / 75 / 100 and
   runtime ``seq_lens``, bench_lstm_bucketed's plane). The launch counts
   are zeroed before each run and read after: B14/B15 on uniform
   batches, B10/B11 on ragged ones, exactly twice a step. One step of
   the DSL program on the kernels against the plain versions (the 4f
   AMP gate); ``reader.device_buffered`` alone under sync-debug "error";
   ms a batch of each run beside ``exec_text``'s and ``train_lstm``'s,
   and five Trainer steps under ``torch.profiler``;
6d. ``exec_gru``: a DSL program ``embedding -> fc(3 x 512) ->
   dynamic_gru(512) -> sequence_pool("last") -> fc -> softmax cross
   entropy`` at the seq2seq encoder's shape (batch 512 x 30, half the
   rows ragged) through ``Executor(CUDAPlace(0))``, under AMP (bf16) and
   in fp32: B12/B13 (``gru_fwd``, ``gru_bwd``, ``gru_dw`` and the route's
   names) launched once a step through the ``dynamic_gru`` op, each
   step's loss against the plain versions' (the 4e gates: relative 1e-4
   in fp32, 1e-2 in bf16), ms a step, and three steps under
   ``torch.profiler``.

The image-classification path (bench.py's ``_bench_image_model``:
the layers DSL, ``Momentum(0.01, momentum=0.9).minimize``,
``Executor(CUDAPlace(0), amp=True)``, ``RandomState(0)`` images, two
feeds alternated; no hand-written kernel, every launch count stays 0)
adds:

6e. ``exec_resnet50``: ``resnet_imagenet(depth=50, class_dim=1000)`` at
   224 x 224: batch 64, 3 + 20 steps (ms a batch p50 by CUDA events and
   by the host clock, images/s, MFU with bench.py's 3.8 GMACs an image x
   2 x 3 over 989 TFLOP/s, peak memory, every loss finite), batch 128
   and 256 1 + 5 steps each, three batch-64 steps under
   ``torch.profiler`` (device busy, idle share, device and registry ops
   a step, top device ops); one fp32 step at batch 2 on the card (cuDNN
   deterministic) and the port on the CPU from one startup state, each
   against the same step in float64 (the loss, every gradient,
   parameter update and running statistic within the IMAGE_PARITY_*
   gates, the card no more than 2x the CPU's distance); AMP's first
   loss at batch 64 within 2e-2 of fp32's;
6f. ``exec_image``: AlexNet, VGG-16 and GoogLeNet (224 x 224, 1000
   classes) and SmallNet (32 x 32, 10 classes) at batch 64, 1 + 5 steps
   each; ResNet-50 with the space-to-depth stem as 6e's batch 64 (3 + 20
   steps, profiled);
6g. ``trainer_image``: the book's ``recognize_digits_conv`` and
   ``smallnet_cifar`` through ``Trainer`` on the card over the mnist and
   cifar-10 surrogates, 8 batches of 64 each (events in order, costs
   finite, ms a batch).

The rest of training's core (no hand-written kernel of its own: the
schedules, the clip, the decay and the other optimizers are eager ops)
adds:

6h. ``trainer_lstm_recipe``: 6c's flagship through the ``Trainer`` with
   ``Adam(ExponentialDecay(0.002, decay_steps=10, decay_rate=0.5),
   global_clip_norm=5.0)``, ``L2Decay(8e-4)`` on every parameter and a
   ``ModelAverage(0.999)``: 3 + 20 batches at K = 1 and 3 groups at
   K = 8, B14/B15 exactly twice a batch, every cost finite; checking
   steps between them: the fetched learning rate within 1 ulp of the
   closed form in float32 at every step (K = 1 and K = 8), the clipped
   global norm at most 5 (1 + 1e-6); ``ModelAverage.apply()`` and its
   restore under sync-debug "error" (the restore the live tensors, bit
   for bit); ms a batch beside 6c's K = 1; registry ops a step, device
   busy and idle share under ``torch.profiler``; K = 1 of the plain
   flagship and of the recipe in turns (plain, recipe, recipe, plain:
   the host's speed drifts within a call); then each of the six
   other optimizers (the same schedule and clip) 1 + 5 batches from the
   recipe's startup parameters; then every new op (the optimizers'
   updates, ``lr_schedule``, ``ema_update``, the pruning pair, the
   clip's and the decay's ops) on the card against the same op on the
   CPU at the flagship's parameter shapes, relative L2 <= 1e-6;
   ``exec_resnet50_recipe``: 6e's batch-64 ResNet-50 with He et al.'s
   recipe (``Momentum(PiecewiseDecay([8, 16], [0.1, 0.01, 0.001]),
   0.9)``, ``L2Decay(1e-4)`` on every parameter): 3 + 20 steps, the
   fetched learning rate the piecewise value at every step, three steps
   profiled, ms a batch, images/s, MFU, registry ops a step and host us
   an op beside 6e's, and 6e's run and the recipe's in turns (recipe,
   plain, plain, recipe).

Then it prints the ``profile`` lines, the ``kernels`` JSON line (every
lane of every kernel; the paged-attention and B7 lanes add their 5g
launches, ``launches_5g``, and B1, B2, B4, B6 and B7 their 5h ones,
``launches_5h``), the ``serve`` (5g's ``serve_spec*`` and
``serve_beam`` and 5h's lines among them), ``train``, seq2seq, LSTM,
``exec_mlp``, ``exec_text``, ``trainer_lstm``, ``exec_gru``,
``exec_resnet50``, ``exec_image``, ``trainer_image``,
``trainer_lstm_recipe`` and ``exec_resnet50_recipe`` lines and, last,
``{"ok": true, "device": {...}}``. Float32 matmuls run in full float32
(TF32 off). With no CUDA card it exits non-zero at once.
"""
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12         # fp32 outside the tensor cores
H100_INT8_OPS = 1979e12         # dense int8 tensor-core TOP/s (and fp8)
H100_TF32_FLOPS = 495e12        # dense tf32 tensor-core FLOP/s
H100_BF16_FLOPS = 989e12        # dense bf16 tensor-core FLOP/s
ATTN_TOL = 1e-5                 # fp32, kernel vs plain: sum order only
LOGIT_TOL = 1e-4                # through 12 layers of fp32 matmuls
# quant_matmul, kernel vs plain, relative to max|out|: the int8 sums are
# exact on both sides and the fp32 epilogue is the same ops in the same
# order; the e4m3 products are exact in fp32 and only the order of the
# K <= 3072 fp32 sums differs (kernel: sequential per thread; plain: a
# cuBLAS fp32 GEMM)
QMM_TOL = {"int8": 1e-6, "fp8-e4m3": 1e-5}
# the quantized mixed step, kernels vs plain: the attention kernel's
# fp32 sums differ from the plain version's in the last bit, which moves
# a later int8 activation or K/V value across a rounding midpoint now and
# then, and each flip perturbs every later layer by a quantum, so from
# the second layer on the two paths drift apart at the level of the
# model's own quantization noise. What is held: layer 0's K/V (nothing
# upstream differs) equal byte for byte, every scale equal, and the
# kernel path no worse an approximation of the fp32 step than the plain
# path: max|logits - fp32| <= QUANT_ERR_RATIO * the plain path's + 1e-3
QUANT_ERR_RATIO = 1.5
# B7's two kernels (the row quantization, the product) as torch.profiler
# names them: profile_quant reports their device ms per step
B7_PROFILE_NAMES = ("quantize_rows_kernel", "qmm_kernel")
# the paged-attention kernels as torch.profiler names them: B1-B4's
# row-tile kernel (the mixed and decode steps) and B5/B6's chunk kernel;
# the profiles report their device ms per step
PAGED_PROFILE_NAMES = ("paged_attention_rows_kernel",
                       "paged_attention_chunk")


def _check(ok, what):
    """A failed check ends the run (not ``assert``: it must hold under
    ``python -O`` too)."""
    if not ok:
        raise RuntimeError(f"chip smoke check failed: {what}")


def _say(*parts):
    print(*parts, flush=True)


def _card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


# cycles the card sleeps ahead of a queue_ahead window (about 1 ms at the
# H100's clocks): longer than the host takes to enqueue the timed call
QUEUE_AHEAD_CYCLES = 2_000_000


def _time_ms(fn, flush, reps=20, queue_ahead=False):
    """Median device ms of ``fn()`` over ``reps`` runs, each timed with
    CUDA events after the L2 cache is flushed (a serving step meets
    every layer's pool cold). With ``queue_ahead``, a
    ``torch.cuda._sleep`` after the flush holds the stream while the host
    enqueues the start event, ``fn``'s kernels and the end event, so the
    window holds device time alone however slowly the host enqueues
    (``torch.autograd.grad`` goes through the autograd engine)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        if queue_ahead:
            torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def _attention_case(dev, T, H, d, B, P, S, N, seed=0):
    """Random pools and a mixed step's row layout: rows 0..S-1 are
    decode rows (ctx 0, 1, block edges, the full table, random), the
    rest are two prefill chunks that share a slot each; every table
    entry is a valid block id, so pages past a row's count are stale."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    q = torch.randn((T, H, d), generator=g, device=dev)
    k = torch.randn((N, H, B, d), generator=g, device=dev)
    v = torch.randn((N, H, B, d), generator=g, device=dev)
    tables = rng.integers(0, N, (S, P)).astype(np.int32)
    slots = np.arange(T, dtype=np.int32) % S
    ctx = rng.integers(1, P * B + 1, T).astype(np.int32)
    ctx[:6] = [0, 1, B, B + 1, P * B, 0]
    half = (T - S) // 2
    slots[S:S + half], slots[S + half:] = 3, 7
    ctx[S:S + half] = np.arange(100, 100 + half) + 1
    ctx[S + half:] = np.arange(300, 300 + T - S - half) + 1
    return q, k, v, tables, slots, ctx


def _quant_pools(dev, dtype, N, H, B, d, seed=0):
    """Pools of a bfloat16 or 1-byte payload at the main path's shapes;
    1-byte payloads get random nonzero per-block scales [N, H] that
    dequantize to magnitudes of at most about 2, as calibrated K/V."""
    g = torch.Generator(device=dev).manual_seed(100 + seed)
    shape = (N, H, B, d)
    if dtype == "bfloat16":
        return [torch.randn(shape, generator=g, device=dev).to(
            torch.bfloat16) for _ in range(2)] + [None, None]
    if dtype == "int8":
        pools = [torch.randint(-127, 128, shape, generator=g, device=dev,
                               dtype=torch.int8) for _ in range(2)]
        qmax = 127.0
    else:
        pools = [((torch.rand(shape, generator=g, device=dev) * 2 - 1)
                  * 448.0).to(torch.float8_e4m3fn) for _ in range(2)]
        qmax = 448.0
    scales = [(0.5 + 1.5 * torch.rand((N, H), generator=g, device=dev))
              / qmax for _ in range(2)]
    return pools + scales


def _attention_bound(tables, slots, ctx, H, d, B, P, elem_bytes=4,
                     scaled=False, n_index=2, s_per_flop=None):
    """Least bytes/ops of this call: each K/V position that some row
    needs is read once per slot however many rows read it
    (``elem_bytes`` per element), q/out once, the table entries needed
    once, ``n_index`` int32 arrays of one entry per row (row slots,
    contexts), and for a quantized pool the K and V scales of each
    needed block once. ``slots``/``ctx`` are per row. The products are
    priced at the fp32 CUDA-core rate, or at ``s_per_flop`` seconds for
    each fp32 FLOP (B5/B6: ``CHUNK_S_PER_FLOP``)."""
    keys, pages = [], []
    for t in range(len(ctx)):
        n = min(int(ctx[t]), P * B)
        pos = np.arange(n)
        keys.append(tables[slots[t], pos // B].astype(np.int64) * B
                    + pos % B)
        pages.append(slots[t] * P + np.arange(-(-n // B)))
    n_keys = np.unique(np.concatenate(keys)).size
    page_ids = np.unique(np.concatenate(pages))
    n_pages = page_ids.size
    n_blocks = np.unique(tables.reshape(-1)[page_ids]).size
    T = len(ctx)
    nbytes = (n_keys * H * d * elem_bytes * 2 + 2 * T * H * d * 4
              + n_pages * 4 + n_index * T * 4
              + (n_blocks * H * 4 * 2 if scaled else 0))
    flops = 4.0 * np.minimum(ctx, P * B).sum() * H * d
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    if s_per_flop is None:
        s_per_flop = 1.0 / H100_FP32_FLOPS
    t_ops = flops * s_per_flop * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# pool dtype -> (kernels-line name, TPU kernel body it replaces)
ATTN_LANES = {
    "float32": ("paged_attention_mixed",
                "paddle_tpu/kernels/paged_attention.py:314"),
    "bfloat16": ("paged_attention_mixed_bf16",
                 "paddle_tpu/kernels/paged_attention.py:314"),
    "int8": ("paged_attention_mixed_quant_int8",
             "paddle_tpu/kernels/paged_attention.py:332"),
    "fp8-e4m3": ("paged_attention_mixed_quant_fp8",
                 "paddle_tpu/kernels/paged_attention.py:332"),
}


def check_attention(pa, dev, flush, shape, dtype="float32"):
    """Phase 3: kernel vs plain at the main path's shapes, and times,
    for one pool dtype (float32: B1; bfloat16: B1's bf16 lane; int8 and
    fp8-e4m3 with per-block scales: B2)."""
    from paddle_tpu_torch import kernels
    T, H, d, B, P, S, N = (shape[k] for k in "THdBPSN")
    q, k, v, tables_np, slots_np, ctx_np = _attention_case(
        dev, T, H, d, B, P, S, N)
    ks = vs = None
    if dtype != "float32":
        del k, v
        k, v, ks, vs = _quant_pools(dev, dtype, N, H, B, d)
    tables, slots, ctx = (torch.from_numpy(a).to(dev)
                          for a in (tables_np, slots_np, ctx_np))
    args = (q, k, v, tables, slots, ctx)
    kw = {} if ks is None else {"k_scale": ks, "v_scale": vs}
    got = pa.paged_attention_mixed(*args, **kw)
    torch.cuda.synchronize()
    want = pa.paged_attention_mixed_reference(*args, **kw)
    err = float((got - want).abs().max())
    _check(err <= ATTN_TOL, f"paged_attention_mixed {dtype} max_abs_err "
           f"{err}")
    _check(not got[ctx == 0].any(), "ctx 0 rows must be exact zeros")
    again = pa.paged_attention_mixed(*args, **kw)
    # rows launched alone: a decode row, the first, a middle and the last
    # row of the two chunks
    half = (T - S) // 2
    alone = {t: pa.paged_attention_mixed(
        q[t:t + 1], k, v, tables, slots[t:t + 1], ctx[t:t + 1], **kw)
        for t in (4, S, S + half // 2, S + half - 1, S + half, T - 1)}
    torch.cuda.synchronize()
    _check(torch.equal(got, again), f"paged_attention_mixed {dtype}: two "
           "launches on the same inputs differ")
    for t, one in alone.items():
        _check(torch.equal(one[0], got[t]), f"paged_attention_mixed "
               f"{dtype}: row {t} alone differs from the row in the launch")

    def kernel():
        return pa.paged_attention_mixed(*args, **kw)
    plain_ms = _time_ms(
        lambda: pa.paged_attention_mixed_reference(*args, **kw), flush)
    # library yardstick: SDPA over the pre-gathered (and dequantized)
    # dense K/V with the length mask (rows with ctx 0 are let see key 0
    # to stay finite)
    kd, vd = _dense_kv(k, v, ks, vs, tables[slots.long()])
    mask = (torch.arange(P * B, device=dev)[None, :]
            < ctx.clamp(min=1)[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library():
        return sdpa(q[:, :, None], kd, vd, attn_mask=mask)
    bound_ms, bound_by = _attention_bound(
        tables_np, slots_np, ctx_np, H, d, B, P,
        elem_bytes=k.element_size(), scaled=ks is not None)
    kernels.reset_launches()
    name, replaces = ATTN_LANES[dtype]
    return _lane_record(
        name, replaces, "paddle_tpu_torch/kernels/csrc/paged_attention.cu",
        err, None, plain_ms, None, (bound_ms, bound_by),
        dict(_device_times(kernel, library, flush),
             two_launches_bit_equal=True, rows_alone_bit_equal=len(alone),
             shape=dict(shape, dtype=dtype)))


# pool dtype -> (kernels-line name, TPU kernel function it replaces), for
# the decode-step kernel (B3/B4) and the chunk kernel (B5/B6)
DECODE_LANES = {
    "float32": ("paged_attention",
                "paddle_tpu/kernels/paged_attention.py:173"),
    "bfloat16": ("paged_attention_bf16",
                 "paddle_tpu/kernels/paged_attention.py:173"),
    "int8": ("paged_attention_quant_int8",
             "paddle_tpu/kernels/paged_attention.py:213"),
    "fp8-e4m3": ("paged_attention_quant_fp8",
                 "paddle_tpu/kernels/paged_attention.py:213"),
}
CHUNK_LANES = {
    "float32": ("paged_attention_chunk",
                "paddle_tpu/kernels/paged_attention.py:564"),
    "bfloat16": ("paged_attention_chunk_bf16",
                 "paddle_tpu/kernels/paged_attention.py:564"),
    "int8": ("paged_attention_chunk_quant_int8",
             "paddle_tpu/kernels/paged_attention.py:603"),
    "fp8-e4m3": ("paged_attention_chunk_quant_fp8",
                 "paddle_tpu/kernels/paged_attention.py:603"),
}
# the whole-mode prefill shapes: (rung G, prefix-hit start, true length)
CHUNK_SHAPES = ((384, 0, 370), (256, 128, 250))
# the least tensor-core time of one fp32 FLOP of the chunk kernel at
# fp32 parity: 3xTF32 for fp32 pools. bf16, int8 and e4m3 payloads have
# at most 8 significant bits, exact in bf16, so there the cheaper of two
# tf32 products (q or P split into tf32 hi + lo) and three bf16 products
# (q or P split into three bf16 pieces, each product exact in fp32)
_EXACT_PAYLOAD_S = min(2.0 / H100_TF32_FLOPS, 3.0 / H100_BF16_FLOPS)
CHUNK_S_PER_FLOP = {"float32": 3.0 / H100_TF32_FLOPS,
                    "bfloat16": _EXACT_PAYLOAD_S, "int8": _EXACT_PAYLOAD_S,
                    "fp8-e4m3": _EXACT_PAYLOAD_S}


def _pools_for(dev, dtype, N, H, B, d, seed=0):
    """float32 pools (randn) or ``_quant_pools``: ``(k, v, ks, vs)``."""
    if dtype == "float32":
        g = torch.Generator(device=dev).manual_seed(200 + seed)
        return [torch.randn((N, H, B, d), generator=g, device=dev)
                for _ in range(2)] + [None, None]
    return _quant_pools(dev, dtype, N, H, B, d, seed)


def _dense_kv(k, v, ks, vs, tables):
    """The library yardstick's input: every row's table gathered into a
    dense [rows, H, P*B, d] K and V (dequantized), outside the timing."""
    gather = tables.long()
    kd, vd = k[gather].float(), v[gather].float()
    if ks is not None:
        kd = kd * ks[gather][:, :, :, None, None]
        vd = vd * vs[gather][:, :, :, None, None]
    R, P, H, B, d = kd.shape
    return (kd.permute(0, 2, 1, 3, 4).reshape(R, H, P * B, d),
            vd.permute(0, 2, 1, 3, 4).reshape(R, H, P * B, d))


def _lane_record(name, replaces, source, err, kernel_ms, plain_ms,
                 library_ms, bound, extra):
    return dict({"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "max_abs_err": err, "ms": kernel_ms,
                 "plain_ms": plain_ms, "bound_ms": bound[0],
                 "bound_by": bound[1], "library_ms": library_ms}, **extra)


def _device_times(kernel, library, flush):
    """The paged-attention rows' times: the kernel and its SDPA yardstick
    by ``_time_ms`` (``ms``, ``library_ms``: the ctypes wrapper's host
    time can land in the window) and with the card's queue kept ahead of
    the host (``device_ms``, ``library_device_ms``: what a row is judged
    by)."""
    return {"ms": _time_ms(kernel, flush),
            "library_ms": _time_ms(library, flush),
            "device_ms": _time_ms(kernel, flush, queue_ahead=True),
            "library_device_ms": _time_ms(library, flush, queue_ahead=True)}


def check_decode_attention(pa, dev, flush, shape, dtype,
                           identity_bits=True):
    """Phase 3c: the decode-step kernel (B3, B4 on 1-byte pools) against
    its plain version at the decode shape: 16 slots, ragged contexts
    including 0, 1, block edges and the full 512-key table; two launches
    bit-equal and, with ``identity_bits``, ``paged_attention_mixed`` on
    identity slots bit-equal to it (one kernel behind both)."""
    S, H, d, B, P, N = (shape[k] for k in "SHdBPN")
    g = torch.Generator(device=dev).manual_seed(4)
    rng = np.random.default_rng(4)
    q = torch.randn((S, H, d), generator=g, device=dev)
    k, v, ks, vs = _pools_for(dev, dtype, N, H, B, d, seed=4)
    tables_np = rng.integers(0, N, (S, P)).astype(np.int32)
    lens_np = rng.integers(1, P * B + 1, S).astype(np.int32)
    lens_np[:7] = [0, 1, B - 1, B, B + 1, 2 * B, P * B]
    tables, lens = (torch.from_numpy(a).to(dev)
                    for a in (tables_np, lens_np))
    kw = {} if ks is None else {"k_scale": ks, "v_scale": vs}
    args = (q, k, v, tables, lens)
    got = pa.paged_attention(*args, **kw)
    torch.cuda.synchronize()
    want = pa.paged_attention_reference(*args, **kw)
    err = float((got - want).abs().max())
    name, replaces = DECODE_LANES[dtype]
    _check(err <= ATTN_TOL, f"{name} max_abs_err {err}")
    _check(not got[lens == 0].any(), "ctx 0 slots must be exact zeros")
    again = pa.paged_attention(*args, **kw)
    # the same rows through the mixed form on identity slots
    mixed = pa.paged_attention_mixed(
        q, k, v, tables, torch.arange(S, dtype=torch.int32, device=dev),
        lens, **kw)
    torch.cuda.synchronize()
    _check(torch.equal(got, again), f"{name}: two launches on the same "
           "inputs differ")
    _check(torch.equal(got, mixed) or not identity_bits, f"{name}: the "
           "mixed form on identity slots gives other bits")

    def kernel():
        return pa.paged_attention(*args, **kw)
    plain_ms = _time_ms(lambda: pa.paged_attention_reference(*args, **kw),
                        flush)
    kd, vd = _dense_kv(k, v, ks, vs, tables)
    mask = (torch.arange(P * B, device=dev)[None, :]
            < lens.clamp(min=1)[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library():
        return sdpa(q[:, :, None], kd, vd, attn_mask=mask)
    bound = _attention_bound(tables_np, np.arange(S), lens_np, H, d, B, P,
                             elem_bytes=k.element_size(),
                             scaled=ks is not None, n_index=1)
    # the chunk kernel at one row per slot against this kernel
    one = pa.paged_attention_chunk(q[:, None].contiguous(), k, v, tables,
                                   lens[:, None].contiguous(), **kw)
    torch.cuda.synchronize()
    g1_err = float((one[:, 0] - got).abs().max())
    _check(g1_err <= ATTN_TOL, f"chunk kernel at G=1 vs {name}: {g1_err}")
    return _lane_record(
        name, replaces, "paddle_tpu_torch/kernels/csrc/paged_attention.cu",
        err, None, plain_ms, None, bound,
        dict(_device_times(kernel, library, flush),
             chunk_g1_vs_decode_max_abs_err=g1_err,
             two_launches_bit_equal=True,
             mixed_on_identity_bit_equal=bool(torch.equal(got, mixed)),
             shape=dict(S=S, H=H, d=d, B=B, P=P, N=N, dtype=dtype)))


def check_chunk_attention(pa, dev, flush, shape, dtype):
    """Phase 3c: the chunk kernel (B5, B6 on 1-byte pools) against its
    plain version at the whole-mode prefill shapes of ``CHUNK_SHAPES``
    (one slot, rung G rows, the last G - true_len of them padding with
    context 0). The record's times are the rung-384 shape's; the
    rung-256 prefix-hit shape's are under ``at_prefix_hit``."""
    H, d, B, P, N = (shape[k] for k in "HdBPN")
    name, replaces = CHUNK_LANES[dtype]
    k, v, ks, vs = _pools_for(dev, dtype, N, H, B, d, seed=5)
    kw = {} if ks is None else {"k_scale": ks, "v_scale": vs}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    recs = []
    for G, start, true_len in CHUNK_SHAPES:
        g = torch.Generator(device=dev).manual_seed(G)
        rng = np.random.default_rng(G)
        q = torch.randn((1, G, H, d), generator=g, device=dev)
        tables_np = rng.permutation(N)[:P].astype(np.int32)[None]
        ctx_np = np.zeros((1, G), np.int32)
        ctx_np[0, :true_len] = start + np.arange(true_len) + 1
        tables, ctx = (torch.from_numpy(a).to(dev)
                       for a in (tables_np, ctx_np))
        args = (q, k, v, tables, ctx)
        got = pa.paged_attention_chunk(*args, **kw)
        torch.cuda.synchronize()
        want = pa.paged_attention_chunk_reference(*args, **kw)
        err = float((got - want).abs().max())
        _check(err <= ATTN_TOL, f"{name} G={G} max_abs_err {err}")
        _check(not got[ctx == 0].any(), "padding rows must be exact zeros")
        again = pa.paged_attention_chunk(*args, **kw)
        torch.cuda.synchronize()
        _check(torch.equal(got, again), f"{name} G={G}: two launches on "
               "the same inputs differ")

        def kernel():
            return pa.paged_attention_chunk(*args, **kw)
        kernel_ms = _time_ms(kernel, flush)
        plain_ms = _time_ms(
            lambda: pa.paged_attention_chunk_reference(*args, **kw), flush,
            reps=5)
        kd, vd = _dense_kv(k, v, ks, vs, tables)
        # the causal offset mask: row g sees keys < ctx[g] (padding rows
        # are let see key 0 to stay finite)
        mask = (torch.arange(P * B, device=dev)[None, None, :]
                < ctx.clamp(min=1)[:, :, None])[:, None]
        qh = q.permute(0, 2, 1, 3)                     # [1, H, G, d]

        def library():
            return sdpa(qh, kd, vd, attn_mask=mask)
        library_ms = _time_ms(library, flush)
        # the same two with the card's queue kept ahead of the host, so
        # the ctypes wrapper's host time stays out of the window
        device_ms = _time_ms(kernel, flush, queue_ahead=True)
        library_device_ms = _time_ms(library, flush, queue_ahead=True)
        bkw = dict(elem_bytes=k.element_size(), scaled=ks is not None,
                   n_index=1)
        rows = (tables_np, np.zeros(G, np.int64), ctx_np[0], H, d, B, P)
        bound = _attention_bound(*rows, s_per_flop=CHUNK_S_PER_FLOP[dtype],
                                 **bkw)
        recs.append(_lane_record(
            name, replaces,
            "paddle_tpu_torch/kernels/csrc/paged_attention_chunk.cu", err,
            kernel_ms, plain_ms, library_ms, bound,
            {"device_ms": device_ms, "library_device_ms": library_device_ms,
             "two_launches_bit_equal": True,
             "bound_cuda_core_ms": _attention_bound(*rows, **bkw)[0],
             "shape": dict(S=1, G=G, start=start, true_len=true_len, H=H,
                           d=d, B=B, P=P, N=N, dtype=dtype)}))
    rec = recs[0]
    rec["max_abs_err"] = max(r["max_abs_err"] for r in recs)
    rec["at_prefix_hit"] = {k_: recs[1][k_] for k_ in (
        "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
        "bound_by", "bound_cuda_core_ms", "library_ms",
        "library_device_ms", "two_launches_bit_equal", "shape")}
    return rec


def _qmm_library(lane, x, wq, ws):
    """One PyTorch call computing the same product, as two callables and
    a note: the yardstick, which quantizes x inside the timed call as the
    kernel does (amax, clamp, divide, round or cast: four small launches
    at M = 80) and then calls ``torch._int_mm`` + the epilogue (int8) or
    ``torch._scaled_mm`` with row-wise scales (fp8; it writes bf16:
    row-wise scaling refuses an fp32 output); and the same library call
    on x quantized outside the timing (the series before PR 8)."""
    qmax = 127.0 if lane == "int8" else 448.0

    def quantize():
        sx = x.abs().amax(dim=1, keepdim=True).clamp_min(1e-8) / qmax
        if lane == "int8":
            return torch.round(x / sx).clamp(-127, 127).to(torch.int8), sx
        return (x / sx).to(torch.float8_e4m3fn), sx

    if lane == "int8":
        def product(xq, sx):
            return torch._int_mm(xq, wq).float() * sx * ws
        note = ("quantize x (amax, clamp, divide, round) + torch._int_mm "
                "+ the epilogue")
    else:
        wt = wq.t().contiguous().t()               # column-major operand
        sb = ws.reshape(1, -1)

        def product(xq, sx):
            return torch._scaled_mm(xq, wt, scale_a=sx, scale_b=sb,
                                    out_dtype=torch.bfloat16)
        note = ("quantize x (amax, clamp, divide, cast) + "
                "torch._scaled_mm, row-wise scales, bf16 out")
    pre = quantize()
    return (lambda: product(*quantize()), lambda: product(*pre), note)


def check_quant_matmul(qm, dev, flush, cfg, lane, M=80):
    """Phase 3b: the quantized matmul against its plain version and the
    a-priori bound at the decoder's four projection shapes (one call
    each per layer), with times. ``ms``, ``plain_ms``, ``bound_ms`` and
    ``library_ms`` are means over the four shapes: per launch on the
    main path, where each shape is launched once per layer."""
    hd = cfg.n_heads * cfg.head_dim
    shapes = [("wqkv", cfg.d_model, 3 * hd), ("wo", hd, cfg.d_model),
              ("w1", cfg.d_model, cfg.d_ff), ("w2", cfg.d_ff, cfg.d_model)]
    g = torch.Generator(device=dev).manual_seed(3)
    per, notes = [], set()
    for name, K, N in shapes:
        x = torch.randn((M, K), generator=g, device=dev)
        w = 0.02 * torch.randn((K, N), generator=g, device=dev)
        wq, ws = qm.quantize_weight(w, lane)
        got = qm.quant_matmul(x, wq, ws)
        again = qm.quant_matmul(x, wq, ws)
        torch.cuda.synchronize()
        _check(torch.equal(got, again),
               f"quant_matmul {lane} {name}: two launches differ")
        want = qm.quant_matmul_reference(x, wq, ws)
        err = float((got - want).abs().max())
        tol = QMM_TOL[lane] * float(want.abs().max())
        _check(err <= tol, f"quant_matmul {lane} {name} max_abs_err {err} "
               f"> {tol}")
        exact = (x.double() @ w.double())
        bound = qm.quant_matmul_error_bound(x, w, lane).double()
        _check(bool(((got.double() - exact).abs() <= bound).all()),
               f"quant_matmul {lane} {name} outside its error bound")
        kernel_ms = _time_ms(lambda: qm.quant_matmul(x, wq, ws), flush)
        plain_ms = _time_ms(lambda: qm.quant_matmul_reference(x, wq, ws),
                            flush)
        try:
            fn, pre_fn, note = _qmm_library(lane, x, wq, ws)
            library_ms = _time_ms(fn, flush)
            pre_ms = _time_ms(pre_fn, flush)
            notes.add(note)
        except (RuntimeError, ValueError) as exc:   # yardstick only
            library_ms = pre_ms = None
            notes.add(f"library call refused: {str(exc)[:120]}")
        nbytes = M * K * 4 + K * N + N * 4 + M * N * 4
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = 2.0 * M * K * N / H100_INT8_OPS * 1e3
        per.append({"proj": name, "K": K, "N": N, "max_abs_err": err,
                    "tol": tol, "ms": kernel_ms, "plain_ms": plain_ms,
                    "library_ms": library_ms,
                    "library_prequantized_ms": pre_ms,
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops
                    else "operations"})
    from paddle_tpu_torch import kernels
    kernels.reset_launches()

    def mean(key):
        vals = [p[key] for p in per]
        return None if None in vals else float(np.mean(vals))

    by = {p["bound_by"] for p in per}
    return {"name": f"quant_matmul_{'int8' if lane == 'int8' else 'fp8'}",
            "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/quant_matmul.cu",
            "replaces": "paddle_tpu/kernels/quant_matmul.py:"
            + ("84" if lane == "int8" else "94"),
            "max_abs_err": max(p["max_abs_err"] for p in per),
            "ms": mean("ms"), "plain_ms": mean("plain_ms"),
            "bound_ms": mean("bound_ms"),
            "bound_by": by.pop() if len(by) == 1 else "bytes",
            "library_ms": mean("library_ms"),
            "library_prequantized_ms": mean("library_prequantized_ms"),
            "library_note": "; ".join(sorted(notes)), "M": M,
            "two_launches_bit_equal": True, "per_shape": per}


def _mixed_script(cfg, kv, rows, slots_n, dev):
    """Two full-width mixed steps: a 128-token prompt in two chunks,
    then a decode row of another slot joins."""
    T = rows
    rng = np.random.default_rng(1)
    tables = np.zeros((slots_n, kv.blocks_for(cfg.max_seq_len)), np.int32)
    tables[0, :9] = np.arange(10, 19)
    tables[1, :1] = [40]
    prompt = rng.integers(1, cfg.vocab_size, 129).astype(np.int32)
    steps = []
    for i in range(2):
        toks = np.zeros(T, np.int32)
        row_slots = np.zeros(T, np.int32)
        pos = np.zeros(T, np.int32)
        valid = np.zeros(T, bool)
        toks[slots_n:] = prompt[64 * i:64 * (i + 1)]
        pos[slots_n:] = np.arange(64 * i, 64 * (i + 1))
        valid[slots_n:] = True
        if i == 1:
            toks[1], row_slots[1], valid[1] = prompt[128], 1, True
        steps.append((toks, row_slots, pos, valid))
    steps = [[torch.from_numpy(a).to(dev) for a in step] for step in steps]
    return steps, torch.from_numpy(tables).to(dev)


def _run_mixed(dm, make_pools, cfg, params, kv, steps, tables, cal):
    """The script with the kernels (under sync-debug "error") and with
    the plain versions, each from fresh zero pools."""
    results = []
    for impl in (None, "reference"):
        k_pool, v_pool = make_pools(kv, None, *cal)
        for toks, row_slots, pos, valid in steps:
            # the kernel path must not sync the host: the engine's one
            # fence per step is reading the argmax back, after the step
            torch.cuda.set_sync_debug_mode("error" if impl is None else 0)
            try:
                logits, _, _ = dm.mixed_step(cfg, params, k_pool, v_pool,
                                             toks, row_slots, pos, valid,
                                             tables, attn_impl=impl)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        results.append((logits[valid], k_pool, v_pool))
    return results


def check_mixed_step(dm, make_pools, cfg, params, kv, rows, slots_n):
    """Phase 4: two full-width mixed steps with the kernel, and again
    with the plain attention, from the same zero pools."""
    steps, tables = _mixed_script(cfg, kv, rows, slots_n,
                                  params["embed"].device)
    (lk, kk, vk), (lr, kr, vr) = _run_mixed(dm, make_pools, cfg, params,
                                            kv, steps, tables, (None, None))
    _check(bool(torch.isfinite(lk).all()), "non-finite logits")
    err = float((lk - lr).abs().max())
    pool_err = max(float((kk - kr).abs().max()),
                   float((vk - vr).abs().max()))
    _check(err <= LOGIT_TOL, f"mixed_step logits differ by {err}")
    _check(pool_err <= LOGIT_TOL, f"mixed_step pools differ by {pool_err}")
    same = float((lk.argmax(-1) == lr.argmax(-1)).float().mean())
    return {"logits_max_abs_err": err, "pool_max_abs_err": pool_err,
            "argmax_agreement": same, "rows": int(lk.shape[0])}, lr


def check_quant_mixed_step(dm, make_pools, cfg, qparams, kv, cal, rows,
                           slots_n, fp32_logits):
    """Phase 4b: the same two steps with int8 KV and int8 weights, the
    kernels (quant_matmul and the quantized attention lane, under
    sync-debug "error") against their plain versions, from the same
    zero pools under the same calibration; ``fp32_logits`` are the
    plain fp32 step's (see QUANT_ERR_RATIO)."""
    steps, tables = _mixed_script(cfg, kv, rows, slots_n,
                                  qparams["embed"].device)
    (lk, kk, vk), (lr, kr, vr) = _run_mixed(dm, make_pools, cfg, qparams,
                                            kv, steps, tables, cal)
    _check(bool(torch.isfinite(lk).all()), "non-finite quantized logits")
    err = float((lk - lr).abs().max())
    err_k = float((lk - fp32_logits).abs().max())
    err_r = float((lr - fp32_logits).abs().max())
    rec = {"logits_max_abs_err": err, "kernel_err_vs_fp32": err_k,
           "plain_err_vs_fp32": err_r, "err_ratio_limit": QUANT_ERR_RATIO,
           "argmax_agreement": float(
               (lk.argmax(-1) == lr.argmax(-1)).float().mean()),
           "argmax_agreement_vs_fp32": float(
               (lk.argmax(-1) == fp32_logits.argmax(-1)).float().mean()),
           "rows": int(lk.shape[0])}
    for name, a, b in (("k", kk, kr), ("v", vk, vr)):
        diff = (a[0].int() - b[0].int()).abs().reshape(cfg.n_layers, -1)
        rec[f"{name}_quanta_apart_max_per_layer"] = \
            diff.amax(1).tolist()
        rec[f"{name}_elems_apart_per_layer"] = (diff != 0).sum(1).tolist()
        _check(not diff[0].any(), f"layer 0 {name} payloads differ")
        _check(torch.equal(a[1], b[1]), f"per-block {name} scales differ")
    rec["written_block_layers"] = int((kk[1] != 0).any(-1).sum())
    _check(err_k <= QUANT_ERR_RATIO * err_r + 1e-3,
           f"quantized mixed_step: kernel path error vs fp32 {err_k} > "
           f"{QUANT_ERR_RATIO} x the plain path's {err_r}")
    return rec


def _whole_script(cfg, kv, slots_n, dev, seed=3):
    """The whole-mode calls at full width: request A's rung-384 prefill
    (370 real tokens) into slot 0, request B's rung-256 prefill (250
    tail tokens) into slot 1 after a 128-token prefix hit on A's first
    eight blocks, then one decode step over 16 slots with ragged
    contexts 1-512 (slot 2 inactive) whose earlier pages read A's
    blocks. Every array is on the card before any call."""
    rng = np.random.default_rng(seed)
    P = kv.blocks_for(cfg.max_seq_len)
    tables = rng.integers(1200, kv.num_blocks, (slots_n, P)).astype(
        np.int32)                                 # stale past each need
    tables[0, :24] = np.arange(10, 34)
    tables[1, :8] = tables[0, :8]                 # the prefix hit
    tables[1, 8:24] = np.arange(100, 116)
    lens = np.array([370, 378, 0, 1, 15, 16, 17, 100, 200, 255, 256, 300,
                     383, 400, 480, 511], np.int32)[:slots_n]
    for s in range(2, slots_n):
        own = int(lens[s]) // kv.block_size       # the page it writes
        tables[s, :own] = np.resize(np.arange(10, 34), own)
        tables[s, own] = 300 + s
    active = lens > 0
    prompt = rng.integers(1, cfg.vocab_size, 400).astype(np.int32)
    pa_ = np.zeros(384, np.int32)
    pa_[:370] = prompt[:370]
    pb = np.zeros(256, np.int32)
    pb[:250] = prompt[128:378]
    toks = rng.integers(1, cfg.vocab_size, slots_n).astype(np.int32)

    def dev_(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return {"prefills": [(dev_(pa_), 370, 0, dev_(tables[0])),
                         (dev_(pb), 250, 128, dev_(tables[1]))],
            "decode": (dev_(toks), dev_(tables), dev_(lens),
                       dev_(active)),
            "active": active}


def _run_whole(dm, make_pools, cfg, params, kv, script, cal):
    """The script with the kernels (under sync-debug "error") and with
    the plain versions, each from fresh zero pools. Returns, per run,
    the logits of every real row ([2 + active slots, vocab]) and the
    pools."""
    results = []
    for impl in (None, "reference"):
        k_pool, v_pool = make_pools(kv, None, *cal)
        rows = []
        torch.cuda.set_sync_debug_mode("error" if impl is None else 0)
        try:
            for toks, true_len, start, row in script["prefills"]:
                lg, _, _ = dm.prefill(cfg, params, k_pool, v_pool, toks,
                                      true_len, start, row, attn_impl=impl,
                                      write_limit=cfg.max_seq_len)
                rows.append(lg[None])
            toks, tables, lens, active = script["decode"]
            lg, _, _ = dm.decode_step(cfg, params, k_pool, v_pool, toks,
                                      tables, lens, active, attn_impl=impl)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        rows.append(lg[active])        # a mask select reads back: after
        results.append((torch.cat(rows), k_pool, v_pool))
    return results


def check_whole_steps(dm, make_pools, cfg, params, kv, slots_n):
    """Phase 4c: the full-width whole-mode calls with the kernels (B3,
    B5) against the plain versions, from the same zero pools: fp32
    logits within LOGIT_TOL and the pools within ATTN_TOL."""
    script = _whole_script(cfg, kv, slots_n, params["embed"].device)
    (lk, kk, vk), (lr, kr, vr) = _run_whole(dm, make_pools, cfg, params,
                                            kv, script, (None, None))
    _check(bool(torch.isfinite(lk).all()), "non-finite whole-mode logits")
    err = float((lk - lr).abs().max())
    pool_err = max(float((kk - kr).abs().max()),
                   float((vk - vr).abs().max()))
    _check(err <= LOGIT_TOL, f"whole-mode logits differ by {err}")
    _check(pool_err <= ATTN_TOL, f"whole-mode pools differ by {pool_err}")
    return {"logits_max_abs_err": err, "pool_max_abs_err": pool_err,
            "argmax_agreement": float(
                (lk.argmax(-1) == lr.argmax(-1)).float().mean()),
            "rows": int(lk.shape[0])}, lr, script


def check_quant_whole_steps(dm, make_pools, cfg, qparams, kv, cal, script,
                            fp32_logits):
    """Phase 4c: the same calls with int8 KV and int8 weights (B4, B6,
    B7) against their plain versions from the same zero pools under one
    calibration, with phase 4b's gates: layer 0's payloads equal byte for
    byte, every scale equal, and the kernel path's error against the
    fp32 calls at most QUANT_ERR_RATIO x the plain path's (+ 1e-3)."""
    (lk, kk, vk), (lr, kr, vr) = _run_whole(dm, make_pools, cfg, qparams,
                                            kv, script, cal)
    _check(bool(torch.isfinite(lk).all()), "non-finite quantized logits")
    err_k = float((lk - fp32_logits).abs().max())
    err_r = float((lr - fp32_logits).abs().max())
    rec = {"logits_max_abs_err": float((lk - lr).abs().max()),
           "kernel_err_vs_fp32": err_k, "plain_err_vs_fp32": err_r,
           "err_ratio_limit": QUANT_ERR_RATIO,
           "argmax_agreement": float(
               (lk.argmax(-1) == lr.argmax(-1)).float().mean()),
           "rows": int(lk.shape[0])}
    for name, a, b in (("k", kk, kr), ("v", vk, vr)):
        diff = (a[0].int() - b[0].int()).abs().reshape(cfg.n_layers, -1)
        rec[f"{name}_quanta_apart_max_per_layer"] = diff.amax(1).tolist()
        _check(not diff[0].any(), f"whole: layer 0 {name} payloads differ")
        _check(torch.equal(a[1], b[1]), f"whole: {name} scales differ")
    _check(err_k <= QUANT_ERR_RATIO * err_r + 1e-3,
           f"quantized whole calls: kernel path error vs fp32 {err_k} > "
           f"{QUANT_ERR_RATIO} x the plain path's {err_r}")
    return rec


def profile_steps(dm, make_pools, cfg, params, kv, rows, slots_n,
                  n_steps=8, cal=(None, None), key="profile", named=()):
    """Phase 6: where a full-width mixed step's time goes. Runs
    ``n_steps`` steps of 16 decode rows + 64 prefill rows under
    ``torch.profiler`` and returns host wall ms per step, device-busy
    ms per step (the sum of the card's kernel and copy times), the
    idle share, and the costliest device ops."""
    rng = np.random.default_rng(2)
    pages = kv.blocks_for(cfg.max_seq_len)
    tables = np.arange(slots_n * pages, dtype=np.int32).reshape(
        slots_n, pages)
    k_pool, v_pool = make_pools(kv, None, *cal)
    plans = []
    for i in range(n_steps + 2):
        toks = rng.integers(1, cfg.vocab_size, rows).astype(np.int32)
        row_slots = np.zeros(rows, np.int32)
        row_slots[:slots_n] = np.arange(slots_n)
        pos = np.zeros(rows, np.int32)
        pos[:slots_n] = 200 + i                  # decode rows
        pos[0] = 480 + i                         # clear of the chunk
        pos[slots_n:] = (64 * i) % 448 + np.arange(rows - slots_n)
        plans.append((toks, row_slots, pos, np.ones(rows, bool)))

    def step(plan):
        logits, _, _ = dm.mixed_step(cfg, params, k_pool, v_pool, *plan,
                                     tables)
        return torch.argmax(logits, dim=-1).cpu()

    return {key: dict({"rows": rows}, **_profile(
        [lambda plan=plan: step(plan) for plan in plans], named))}


def _profile(calls, named=()):
    """Run ``calls[:2]`` to warm up, then the rest under
    ``torch.profiler``: host wall ms per call, device-busy ms per call
    (the sum of the card's kernel and copy times), the idle share, the
    device ops and device-to-host copies per call, the costliest device
    ops and, for each substring in ``named``, the device ms per call of
    the ops whose names hold it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for call in calls[:2]:
        call()
    torch.cuda.synchronize()
    n_steps = len(calls) - 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for call in calls[2:]:
            call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    busy_ms = sum(by_name.values()) / n_steps
    top = sorted(by_name.items(), key=lambda kv_: -kv_[1])[:8]
    return {
        "steps": n_steps, "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_ms or None,
        "device_idle_share": (1.0 - busy_ms / wall_ms) if busy_ms
        else None,
        "device_kernels_per_step": sum(
            1 for e in prof.events()
            if e.device_type == DeviceType.CUDA) / n_steps,
        "dtoh_copies_per_step": sum(
            1 for e in prof.events() if e.device_type == DeviceType.CUDA
            and "DtoH" in e.name) / n_steps,
        "top_device_ms_per_step": [[n[:60], ms / n_steps]
                                   for n, ms in top],
        **({"named_device_ms_per_step": {
            sub: sum(ms for n, ms in by_name.items() if sub in n) / n_steps
            for sub in named}} if named else {})}


def profile_whole(dm, make_pools, cfg, params, kv, slots_n, n_steps=8,
                  named=PAGED_PROFILE_NAMES):
    """Where the whole-mode time goes: ``n_steps`` decode steps over 16
    active slots (contexts 200+), then ``n_steps`` rung-384 prefills
    (370 real tokens, each into its own blocks), each call ending in the
    engine's small read-back; ``named`` as ``_profile``'s."""
    rng = np.random.default_rng(6)
    dev = params["embed"].device
    pages = kv.blocks_for(cfg.max_seq_len)
    tables = torch.from_numpy(np.arange(slots_n * pages, dtype=np.int32)
                              .reshape(slots_n, pages)).to(dev)
    k_pool, v_pool = make_pools(kv, None)
    active = torch.ones(slots_n, dtype=torch.bool, device=dev)
    dec = [(torch.from_numpy(rng.integers(1, cfg.vocab_size, slots_n)
                             .astype(np.int32)).to(dev),
            torch.full((slots_n,), 200 + i, dtype=torch.int32, device=dev))
           for i in range(n_steps + 2)]
    pre = []
    for i in range(n_steps + 2):
        toks = np.zeros(384, np.int32)
        toks[:370] = rng.integers(1, cfg.vocab_size, 370)
        row = (slots_n * pages + 24 * i + np.arange(pages)).astype(
            np.int32) % kv.num_blocks
        pre.append((torch.from_numpy(toks).to(dev),
                    torch.from_numpy(row).to(dev)))

    def decode(toks, lens):
        lg, _, _ = dm.decode_step(cfg, params, k_pool, v_pool, toks,
                                  tables, lens, active)
        return torch.argmax(lg, dim=-1).cpu()

    def prefill(toks, row):
        lg, _, _ = dm.prefill(cfg, params, k_pool, v_pool, toks, 370, 0,
                              row)
        return torch.argmax(lg).cpu()

    return {"profile_whole": {
        "decode_step": dict({"slots": slots_n}, **_profile(
            [lambda a=a: decode(*a) for a in dec], named)),
        "prefill_384": dict({"rung": 384, "true_len": 370}, **_profile(
            [lambda a=a: prefill(*a) for a in pre], named))}}


def _requests(cfg, n_requests=48, seed=0):
    """The seeded burst: prompts of 16-384 tokens, every other one
    behind a shared 128-token prefix, and 16-48 new tokens each."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, cfg.vocab_size, 128).astype(np.int32)
    prompts, max_new = [], []
    for i in range(n_requests):
        n = int(rng.integers(16, 385))
        p = rng.integers(1, cfg.vocab_size, n).astype(np.int32)
        if i % 2:                                  # shared prefix
            p = np.concatenate([prefix, p[:max(n - 128, 1)]])
        prompts.append(p)
        max_new.append(int(rng.integers(16, 49)))
    return prompts, max_new


def serve(DecodeEngine, kernels, cfg, params, n_requests=48, seed=0,
          key="serve", engine_kw=None, n_serve=None, reference=None,
          solo_index=1, check=None):
    """Phase 5 (and 5b, 5c, 5h): a main path. ``engine_kw`` adds the
    engine's KV dtype / quant plan / prefill mode / admission /
    telemetry; ``n_serve`` serves only the first requests of the burst;
    ``reference`` (token lists of other runs, by name) is compared, not
    gated; request ``solo_index`` (None: none) served solo on a fresh
    engine must give the same tokens; ``check(eng, prompts, max_new,
    results)`` runs on the open engine after the launch check and
    returns fields for the record. Returns the serve record, the launch
    counts of the run and the generated tokens."""
    prompts, max_new = _requests(cfg, n_requests, seed)
    prompts, max_new = prompts[:n_serve], max_new[:n_serve]
    kw = dict(block_size=16, num_blocks=2048, max_slots=16, eos_id=0,
              **(engine_kw or {}))
    eng = DecodeEngine(cfg, params, **kw)
    eng.warmup()
    torch.cuda.synchronize()
    kernels.reset_launches()                       # the main path: go
    t0 = time.perf_counter()
    futs = [eng.submit(p, m) for p, m in zip(prompts, max_new)]
    results = [f.result(timeout=900) for f in futs]
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)              # read just after
    st = eng.stats()
    for r, m in zip(results, max_new):
        _check(1 <= len(r.tokens) <= m, f"{len(r.tokens)} tokens, max {m}")
    steps = int(st["steps_total"])
    prefills = int(st["prefills_total"])
    L = cfg.n_layers
    quant_kv = eng.kv.quantized
    want = dict.fromkeys(kernels.LAUNCHES, 0)
    if eng.prefill_mode == "chunked":     # one mixed step per turn
        want["paged_attention_mixed_quant" if quant_kv
             else "paged_attention_mixed"] = L * steps
        dense_calls = steps
    else:             # decode steps, plus one prefill per admission
        want["paged_attention_quant" if quant_kv
             else "paged_attention"] = L * steps
        want["paged_attention_chunk_quant" if quant_kv
             else "paged_attention_chunk"] = L * prefills
        dense_calls = steps + prefills
    if eng.quant_plan:
        want["quant_matmul"] = 4 * L * dense_calls
    _check(launches == want, f"{key}: launches {launches} over {steps} "
           f"steps and {prefills} prefills, want {want}")
    if len(prompts) > kw["max_slots"]:   # some wait while the prefix lands
        _check(st["prefix"]["hit_tokens"] > 0, "the shared prefix never hit")
    extra = check(eng, prompts, max_new, results) if check else {}
    eng.pool.assert_consistent()
    eng.close()
    _check(eng.pool.check_leaks() == [] and eng.pool.blocks_in_use == 0,
           f"leaked blocks: {eng.pool.check_leaks()}")
    hbm_bytes = eng.kv.hbm_bytes
    del eng
    if solo_index is not None:
        # one request served solo, on a fresh engine: the same tokens
        j = solo_index
        solo_eng = DecodeEngine(cfg, params, **kw)
        solo = solo_eng.generate(prompts[j], max_new[j], timeout=600)
        solo_eng.close()
        del solo_eng
        _check(solo.tokens.tolist() == results[j].tokens.tolist(),
               f"{key}: solo and batched greedy tokens differ")
    tokens = [r.tokens.tolist() for r in results]
    n_tok = int(sum(len(t) for t in tokens))
    rec = {
        "requests": len(prompts), "generated_tokens": n_tok,
        "prompt_tokens": int(sum(p.size for p in prompts)),
        "wall_s": wall, "tokens_per_s": n_tok / wall,
        "ttft_ms_p50": st["ttft_ms_p50"], "ttft_ms_p99": st["ttft_ms_p99"],
        "tpot_ms_p50": st["tpot_ms_p50"],
        "steps": steps, "prefills": prefills,
        "step_ms_p50": st["step_ms_p50"],
        "prefill_mode": st["prefill_mode"], "admission": st["admission"],
        "prefix_hit_rate": st["prefix"]["hit_rate"],
        "preempted": st["preempted_total"],
        "kv_high_water_blocks": st["kv"]["high_water"],
        "solo_equals_batched": solo_index is not None or None,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    if st["prefill_mode"] == "chunked":
        rec["mixed_rows"] = st["chunked_prefill"]["mixed_rows"]
    else:
        rec["prompt_rungs"] = st["prompt_rungs"]
    if engine_kw:
        rec.update({"kv_dtype": st["quant"]["kv_dtype"],
                    "weights_quantized": st["quant"]["weights_quantized"],
                    "kv_hbm_bytes": hbm_bytes, "launches": launches})
    for name, ref in (reference or {}).items():
        rec[f"greedy_equal_share_vs_{name}"] = float(np.mean(
            [a == b for a, b in zip(tokens, ref)]))
    rec.update(extra)
    return {key: rec}, launches, tokens


def solo_tokens(DecodeEngine, cfg, params, indices, engine_kw,
                n_requests=48, seed=0):
    """The burst's requests ``indices`` served one at a time on one
    fresh engine (each alone in the engine while it runs)."""
    prompts, max_new = _requests(cfg, n_requests, seed)
    eng = DecodeEngine(cfg, params, block_size=16, num_blocks=2048,
                       max_slots=16, eos_id=0, **engine_kw)
    out = {j: eng.generate(prompts[j], max_new[j],
                           timeout=600).tokens.tolist() for j in indices}
    eng.close()
    return out


# --------------------------------------------- speculation and beams (5g)

# the speculative lines' draft: same vocab and context as the target,
# a quarter of its width and two layers
SPEC_DRAFT_CFG = dict(vocab_size=32000, d_model=256, n_heads=4,
                      head_dim=64, n_layers=2, d_ff=1024, max_seq_len=512)
SPEC_N = 16                     # the burst's first requests
SERVE_BEAM_K, SERVE_BEAM_NEW = 4, 32
BEAM_REQUESTS = (1, 3)          # both behind the shared prefix
# beam scores are sums of SERVE_BEAM_NEW log-probs near -log(32000) each
# (|score| ~ 330, whose fp32 ulp is 3.05e-5); the fp32 paged lane's
# log-probs lie within 2 x LOGIT_TOL of the dense lane's (log-softmax
# moves a gap by at most twice a logit's error), so two fp32 beams of
# one sequence agree within SERVE_BEAM_NEW x (ulp + 2 x LOGIT_TOL)
BEAM_FP32_TOL = SERVE_BEAM_NEW * (3.05e-5 + 2 * LOGIT_TOL)


def _near_tie(fp32_eps, quant_eps=None):
    """The bound under which two routes' greedy tokens may differ: the
    two tokens' logits within 4 x the largest logit distance between two
    routes (each route's logits lie within eps of the model's, so a flip
    needs the two tokens within 2 eps on any one route, and within 4 eps
    on the replay, a third route). fp32: eps = LOGIT_TOL, the gate on
    12-layer logits whose attention agrees within ATTN_TOL. int8 (KV and
    weights): eps = the quantized step's kernel-vs-plain logit distance
    measured by 4b / 4c in this run: an ulp of attention moves an int8
    K/V value or activation by a quantum there."""
    return 4.0 * (fp32_eps if quant_eps is None else quant_eps)


def _replay_logits(dm, make_pools, cfg, params, kv_dtype, cal, tokens):
    """Teacher-forced logits of ``tokens`` at positions 0..n-1 in ONE
    ``mixed_step`` on the card (pools of ``kv_dtype`` under ``cal``)."""
    n = len(tokens)
    kv = cfg.kv_config(16, n // 16 + 2, kv_dtype)
    k, v = make_pools(kv, None, *cal)
    dev = params["embed"].device
    logits, _, _ = dm.mixed_step(
        cfg, params, k, v, torch.tensor(tokens, device=dev),
        torch.zeros(n, dtype=torch.int32, device=dev),
        torch.arange(n, dtype=torch.int32, device=dev),
        torch.ones(n, dtype=torch.bool, device=dev),
        torch.arange(kv.num_blocks, dtype=torch.int32, device=dev)[None])
    return logits


def _compare_greedy(dm, make_pools, cfg, params, kv_dtype, cal, prompts,
                    plain, got, bound, key):
    """Equal tokens, or a near-tie at the first differing position of
    each request that differs (``_near_tie``); any other divergence
    fails. Returns the comparison's record."""
    ties = []
    for j, (a, b) in enumerate(zip(plain, got)):
        if a == b:
            continue
        i = next(i for i in range(min(len(a), len(b))) if a[i] != b[i])
        seq = list(prompts[j]) + list(a[:i])
        lg = _replay_logits(dm, make_pools, cfg, params, kv_dtype, cal,
                            seq)[-1].double()
        top = torch.topk(lg, 2).values
        gap = float((lg[a[i]] - lg[b[i]]).abs())
        ties.append({"request": j, "position": i, "tokens": [a[i], b[i]],
                     "logit_gap": gap,
                     "replay_top2_gap": float(top[0] - top[1])})
        _check(gap <= bound, f"{key}: request {j} diverges from the plain "
               f"run at token {i} ({a[i]} vs {b[i]}) with a logit gap "
               f"{gap} > the near-tie bound {bound}")
    return {"equal_share": float(np.mean([a == b for a, b in
                                          zip(plain, got)])),
            "near_ties": len(ties), "near_tie_bound": bound,
            "near_tie_detail": ties}


def serve_spec(DecodeEngine, kernels, dm, make_pools, cfg, params, key,
               engine_kw, draft_cfg, draft_params, plain, bound, cal=(
                   None, None), check=None):
    """Phase 5g (and 5h): the burst's first SPEC_N requests through a
    speculative engine (``engine_kw`` adds the mode, γ, pool, weights
    and telemetry); exact launch counts, a leak-free pool, and the
    tokens against ``plain`` (the plain run's of the same pool and
    weights, or 5g's) by ``_compare_greedy``; ``check(eng)`` runs on the
    open engine after the launch check and returns fields for the
    record. Returns the line's record, its launches and its tokens."""
    prompts, max_new = _requests(cfg)
    prompts, max_new = prompts[:SPEC_N], max_new[:SPEC_N]
    kw = dict(block_size=16, num_blocks=2048, max_slots=16, eos_id=0,
              **engine_kw)
    eng = DecodeEngine(cfg, params, draft_cfg=draft_cfg,
                       draft_params=draft_params, **kw)
    n_entries = eng.warmup()
    torch.cuda.synchronize()
    kernels.reset_launches()                       # the main path: go
    t0 = time.perf_counter()
    futs = [eng.submit(p, m) for p, m in zip(prompts, max_new)]
    results = [f.result(timeout=900) for f in futs]
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)              # read just after
    st = eng.stats()
    spec = st["speculation"]
    rounds, steps = spec["verify_steps"], int(st["steps_total"])
    prefills = int(st["prefills_total"])
    L, Ld, gamma = cfg.n_layers, draft_cfg.n_layers, eng.speculate_k
    q = "_quant" if eng.kv.quantized else ""
    want = dict.fromkeys(kernels.LAUNCHES, 0)
    want["paged_attention" + q] = Ld * gamma * rounds
    if eng.prefill_mode == "chunked":
        want["paged_attention_mixed" + q] = (L + Ld) * (steps - rounds)
        want["paged_attention_chunk" + q] = L * rounds
        target_calls = steps
    else:
        want["paged_attention_chunk" + q] = L * rounds + (L + Ld) * prefills
        target_calls = rounds + prefills
    if eng.quant_plan:
        want["quant_matmul"] = 4 * L * target_calls
    _check(launches == want, f"{key}: launches {launches} over {rounds} "
           f"rounds, {steps} steps, {prefills} prefills, want {want}")
    extra = check(eng) if check else {}
    eng.pool.assert_consistent()
    tparams, kv_dtype = eng.params, eng.kv.dtype
    eng.close()
    _check(eng.pool.check_leaks() == [] and eng.pool.blocks_in_use == 0,
           f"{key}: leaked blocks {eng.pool.check_leaks()}")
    del eng
    tokens = [r.tokens.tolist() for r in results]
    for r, m in zip(results, max_new):
        _check(1 <= len(r.tokens) <= m, f"{len(r.tokens)} tokens, max {m}")
    cmp_ = _compare_greedy(dm, make_pools, cfg, tparams, kv_dtype, cal,
                           prompts, plain[:SPEC_N], tokens, bound, key)
    n_tok = int(sum(len(t) for t in tokens))
    rec = {"requests": len(prompts), "generated_tokens": n_tok,
           "wall_s": wall, "tokens_per_s": n_tok / wall,
           "ttft_ms_p50": st["ttft_ms_p50"], "tpot_ms_p50": st["tpot_ms_p50"],
           "step_ms_p50": st["step_ms_p50"], "gamma": gamma,
           "draft_layers": Ld, "verify_rounds": rounds,
           "slot_rounds": spec["rounds"],
           "mean_accept_len": spec["mean_accept_len"],
           "tokens_per_slot_round": n_tok / max(1, spec["rounds"]),
           "mixed_steps": (steps - rounds
                           if st["prefill_mode"] == "chunked" else 0),
           "prefills": prefills, "warmup_entries": n_entries,
           "prefill_mode": st["prefill_mode"],
           "kv_dtype": st["quant"]["kv_dtype"],
           "weights_quantized": st["quant"]["weights_quantized"],
           "launches": launches, "vs_plain": cmp_,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, **extra}
    return {key: rec}, launches, tokens


def _oracle_logprobs(dm, cfg, params, prompt, seq, n):
    """The dense lane's log-prob of each of a beam's first ``n`` tokens,
    teacher-forced through ``make_dense_beam_step_fn`` after the dense
    prefill of the prompt minus its last token (the BOS)."""
    dev = params["embed"].device
    kc, vc = dm.dense_prefill(cfg, params, np.asarray(prompt[:-1]),
                              len(prompt) - 1)
    state = (kc[None], vc[None], torch.full((1,), len(prompt) - 1,
                                            dtype=torch.int32, device=dev))
    step = dm.make_dense_beam_step_fn(cfg, params)
    tok, out = int(prompt[-1]), []
    for t in range(n):
        lp, state = step(state, torch.tensor([tok], device=dev))
        tok = int(seq[t])
        out.append(float(lp[0, tok]))
    return np.asarray(out)


def _beam_check(dm, cfg, params, prompt, paged, ref, tol, near_ties=True):
    """Each paged beam against ``ref``'s beam of the same rank: the same
    sequence and length with scores within ``tol``, or (``near_ties``,
    against the dense lane) a near-tie: the dense lane's own score of
    the paged beam within ``tol`` of the dense beam's. Returns the
    record."""
    K = paged.sequences.shape[1]
    ties = []
    for i in range(K):
        ps, pl = paged.sequences[0, i], int(paged.lengths[0, i])
        if pl == int(ref.lengths[0, i]) and (ps == ref.sequences[0, i]).all():
            err = abs(float(paged.scores[0, i]) - float(ref.scores[0, i]))
            _check(err <= tol, f"beam {i}: paged score off the "
                   f"reference's by {err} > {tol}")
            continue
        _check(near_ties, f"beam {i}: the paged sequence differs from the "
               "reference's")
        oracle = float(_oracle_logprobs(dm, cfg, params, prompt, ps,
                                        pl).sum())
        gap = abs(oracle - float(ref.scores[0, i]))
        ties.append({"beam": i, "oracle_score": oracle,
                     "dense_score": float(ref.scores[0, i]),
                     "paged_score": float(paged.scores[0, i]), "gap": gap})
        _check(gap <= tol, f"beam {i}: paged sequence differs from the "
               f"dense lane's and scores {gap} off it (> {tol})")
    return {"beams_equal": K - len(ties), "near_ties": ties,
            "score_max_abs_diff": float(np.abs(paged.scores
                                               - ref.scores).max())}


def _beams_by_value(dm, make_pools, beam_search, eng, params, cal, prompt,
                    hit):
    """The paged lane's beams with nothing shared and nothing copied on
    write: ``decode.beam_search`` (the dense lane's search) over
    per-beam regions of a pool of the engine's dtype, regathered by
    value every step and stepped by the same ``decode_step`` kernels.
    The prefix goes in through the mixed step along the engine's own
    chunked route (``T``-row calls from position 0 over the ``hit``
    tokens the prefix cache supplied, then from ``hit`` over the tail),
    so every value matches the paged lane's bit for bit where the
    copy-on-write is right."""
    cfg, K, new = eng.cfg, SERVE_BEAM_K, SERVE_BEAM_NEW
    dev = params["embed"].device
    prefix = np.asarray(prompt[:-1], np.int32)
    n0, T = int(prefix.size), eng._mixed_rows
    nb = eng.kv.blocks_for(n0 + new)
    k, v = make_pools(cfg.kv_config(eng.kv.block_size, nb, eng.kv.dtype),
                      None, *cal)
    table = torch.arange(nb, dtype=torch.int32, device=dev)[None]
    for lo, hi in ((0, hit), (hit, n0)):
        for c in range(lo, hi, T):
            take = min(T, hi - c)
            rows = np.zeros((3, T), np.int32)
            rows[0, :take] = prefix[c:c + take]
            rows[1, :take] = np.arange(c, c + take)
            rows[2, :take] = 1
            r = torch.from_numpy(rows).to(dev)
            dm.mixed_step(cfg, params, k, v, r[0], torch.zeros_like(r[0]),
                          r[1], r[2].bool(), table,
                          write_limit=eng.max_context)
    lead = [x[None].repeat(K, *[1] * x.dim()) for x in (k[0], k[1], v[0],
                                                         v[1])]
    tables = (torch.arange(K, device=dev)[:, None] * nb
              + torch.arange(nb, device=dev)[None]).to(torch.int32)
    ones = torch.ones((K,), dtype=torch.bool, device=dev)

    def step(state, tokens):
        *parts, lens = state
        flat = [x.transpose(0, 1).reshape(x.shape[1], K * nb, *x.shape[3:])
                .contiguous() for x in parts]
        logits, _, _ = dm.decode_step(
            cfg, params, (flat[0], flat[1], k[2]), (flat[2], flat[3], v[2]),
            tokens, tables, lens, ones)
        back = [x.reshape(x.shape[0], K, nb, *x.shape[2:]).transpose(0, 1)
                for x in flat]
        return torch.log_softmax(logits, dim=-1), (*back, lens + 1)

    res = beam_search(step, (*lead, torch.full((K,), n0, dtype=torch.int32,
                                                 device=dev)),
                      batch_size=1, beam_size=K, max_len=new,
                      bos_id=int(prompt[-1]), eos_id=eng.eos_id,
                      vocab_size=cfg.vocab_size)
    return type(res)(*[x.cpu().numpy() for x in res])


def serve_beam(DecodeEngine, kernels, dm, make_pools, beam_search, cfg,
               params, rungs, int8_cal):
    """Phase 5g's beam line (its paged beams returned too, by engine
    name and call): ``generate_beam`` over requests
    BEAM_REQUESTS on a whole-mode fp32 engine and a chunked engine with
    an int8 pool (``int8_cal``: its calibration probe's absmax), each
    against ``impl="dense"`` on the same engine (``_beam_check``; the
    int8 pool's beams are held to ``_beams_by_value`` instead and only
    compared with the fp32 dense lane: a quantized K/V moves every
    log-prob, by up to 0.12 in 4c's logits, so over near-flat random
    logits the two searches prune other prefixes), with exact launch
    counts; a twin engine takes the same calls with every
    copy-on-write checked on the card (the copied payload bytes and
    scale rows equal the source's) and must give the same beams."""
    prompts, _ = _requests(cfg)
    out, launch_sum = {}, dict.fromkeys(kernels.LAUNCHES, 0)
    beams = {}
    for name, kw, tol in (
            ("whole_fp32", dict(prefill_mode="whole"), BEAM_FP32_TOL),
            ("chunked_int8", dict(kv_config=cfg.kv_config(16, 2048, "int8")),
             BEAM_FP32_TOL)):
        eng, twin = (DecodeEngine(cfg, params, block_size=16,
                                  num_blocks=2048, max_slots=16, eos_id=0,
                                  prompt_rungs=rungs, autostart=False, **kw)
                     for _ in range(2))
        T = eng._mixed_rows
        quant = eng.kv.quantized
        q = "_quant" if quant else ""
        copies_checked = [0]
        real_copy = twin._cow_copy

        def checked_copy(src, dst, eng=twin, real_copy=real_copy,
                         quant=quant, copies_checked=copies_checked):
            real_copy(src, dst)
            for pool in (eng._k_pool, eng._v_pool):
                pay = pool[0].view(torch.uint8) if quant else pool
                for a, b in zip(src, dst):
                    if a == b:
                        continue
                    _check(torch.equal(pay[:, b], pay[:, a]) and (
                        not quant or torch.equal(pool[1][:, b],
                                                 pool[1][:, a])),
                           f"CoW: block {b} is not a copy of block {a}")
                    copies_checked[0] += 1
        twin._cow_copy = checked_copy
        calls = []
        for j in BEAM_REQUESTS:
            p = prompts[j]
            hits0 = eng.stats()["prefix"]["hit_tokens"]
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            paged = eng.generate_beam(p, beam_size=SERVE_BEAM_K,
                                      max_new_tokens=SERVE_BEAM_NEW)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = dict(kernels.LAUNCHES)
            hit = int(eng.stats()["prefix"]["hit_tokens"] - hits0)
            tail = len(p) - 1 - hit
            want = dict.fromkeys(kernels.LAUNCHES, 0)
            want["paged_attention" + q] = cfg.n_layers * SERVE_BEAM_NEW
            if eng.prefill_mode == "whole":
                want["paged_attention_chunk" + q] = cfg.n_layers
            else:
                want["paged_attention_mixed" + q] = \
                    cfg.n_layers * -(-tail // T)
            _check(launches == want, f"serve_beam {name}: launches "
                   f"{launches}, want {want}")
            for k, v in launches.items():
                launch_sum[k] += v
            t0 = time.perf_counter()
            dense = eng.generate_beam(p, beam_size=SERVE_BEAM_K,
                                      max_new_tokens=SERVE_BEAM_NEW,
                                      impl="dense")
            torch.cuda.synchronize()
            dense_ms = (time.perf_counter() - t0) * 1e3
            _check(kernels.LAUNCHES == launches, "the dense lane launched "
                   "a kernel")
            again = twin.generate_beam(p, beam_size=SERVE_BEAM_K,
                                       max_new_tokens=SERVE_BEAM_NEW)
            _check(all(np.array_equal(x, y) for x, y in zip(paged, again)),
                   f"serve_beam {name}: the twin engine gave other beams")
            if quant:
                rec = _beam_check(dm, cfg, params, p, paged, _beams_by_value(
                    dm, make_pools, beam_search, eng, params, int8_cal, p,
                    hit), tol, near_ties=False)
                rec["vs_dense"] = {
                    "best_beam_equal": bool(
                        paged.lengths[0, 0] == dense.lengths[0, 0]
                        and (paged.sequences[0, 0]
                             == dense.sequences[0, 0]).all()),
                    "score_diffs": (paged.scores - dense.scores)[0].tolist()}
            else:
                rec = _beam_check(dm, cfg, params, p, paged, dense, tol)
            rec.update({"request": j, "prompt_tokens": len(p),
                        "prefix_hit_tokens": hit, "ms": ms,
                        "dense_ms": dense_ms, "launches": launches,
                        "lengths": paged.lengths[0].tolist(),
                        "scores": paged.scores[0].tolist(),
                        "dense_scores": dense.scores[0].tolist()})
            calls.append(rec)
            beams.setdefault(name, []).append(paged)
        _check(calls[1]["prefix_hit_tokens"] >= 112,   # 7-8 blocks of 16
               "the second beam call missed the shared prefix")
        _check(copies_checked[0] > 0, f"serve_beam {name}: no block copied")
        for e in (eng, twin):
            e.pool.assert_consistent()
            e.close()
            _check(e.pool.check_leaks() == [] and e.pool.blocks_in_use == 0,
                   f"serve_beam {name}: leaked blocks")
        out[name] = {"calls": calls, "cow_copies": eng.cow_copies,
                     "cow_copies_checked": copies_checked[0],
                     "score_tol": tol, "kv_dtype": eng.kv.dtype,
                     "prefill_mode": eng.prefill_mode,
                     "beam_size": SERVE_BEAM_K,
                     "max_new_tokens": SERVE_BEAM_NEW}
        del eng, twin
    return {"serve_beam": out}, launch_sum, beams


# ---------------------------------------------------- telemetry plane (5h)

TEL_N = 16                      # the burst's first requests (shorter lines)
# B1-B4's row-tile kernel as torch.profiler names it (PAGED_PROFILE_NAMES)
ROWS_KERNEL = PAGED_PROFILE_NAMES[0]


def _doc_metric_names():
    """The metric names the docs' contract tables declare
    (``docs/observability.md``, ``docs/serving.md``), read by
    ``tools/check_metric_contract.py`` (os, re and sys only)."""
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "tools"))
    from check_metric_contract import doc_metric_names
    return set(doc_metric_names(os.path.join(root, "docs")))


def _telemetry(tmp):
    """A telemetry session streaming its trace under ``tmp``, with a
    flight recorder there (no SIGTERM handler: the smoke owns none)."""
    from paddle_tpu_torch.obs import FlightRecorder, Telemetry
    return Telemetry(trace_path=os.path.join(tmp, "trace.jsonl"),
                     flight=FlightRecorder(os.path.join(tmp, "flight"),
                                           install_signal=False))


def _ledger_checks(eng, tel, key, doc_names):
    """What 5h holds of an engine that served with telemetry and the
    ledger: each retired request's four TTFT parts sum to its TTFT
    within 1e-3 ms and its submit <= admit <= first token <= finish;
    the loop's components reconcile its wall within 10%; 0 <
    ``decode_goodput`` <= 1; every lowercase metric name of the live
    registry is in a docs contract table (the synthetic ``ALERTS``
    series is outside the contract by its own rule). Returns the
    decomposition's record."""
    # let the loop close its last turn: a snapshot taken mid-turn holds
    # that turn's components but not yet its wall
    time.sleep(0.2)
    leds = [led for led in eng.retired_ledgers() if "ttft_parts" in led]
    _check(leds, f"{key}: no retired ledger")
    for led in leds:
        parts = sum(led["ttft_parts"].values())
        _check(abs(parts - led["ttft_ms"]) <= 1e-3,
               f"{key}: request {led['request_id']}'s TTFT parts sum to "
               f"{parts}, its TTFT is {led['ttft_ms']}")
        ts = {e[0]: float(e[1]) for e in led["events"]}
        seq = [ts["submit"], ts["admit"], ts["first_token"], ts["finish"]]
        _check(seq == sorted(seq), f"{key}: request {led['request_id']}'s "
               f"timeline is not monotonic: {seq}")
    snap = eng.goodput_snapshot()
    cov = sum(snap["components"].values()) / snap["loop_wall_ms"]
    _check(abs(cov - 1.0) <= 0.10, f"{key}: the components cover {cov} "
           "of the loop wall (10% allowed)")
    g = eng.stats()["goodput"]
    _check(0.0 < g["decode_goodput"] <= 1.0,
           f"{key}: decode_goodput {g['decode_goodput']}")
    names = {m.name for m in tel.registry.metrics()
             if m.name == m.name.lower()}
    missing = sorted(names - doc_names)
    _check(not missing, f"{key}: metrics outside the docs contract: "
           f"{missing}")
    t = g["ttft"]
    return {"verdict": g["verdict"], "decode_goodput": g["decode_goodput"],
            "coverage": g["coverage"], "loop_wall_ms": g["loop_wall_ms"],
            "turns": g["turns"], "components_ms": g["components"],
            "ttft_attribution": {k: t[k] for k in (
                "requests", "ttft_ms_p50", "ttft_ms_p99", "p50", "p99",
                "dominant_p99", "prefill_stall_share_p99")},
            "ledgers_checked": len(leds),
            "metric_names_in_contract": len(names)}


def profile_telemetry(eng, tel, kernels, prompts, max_new, tmp, card):
    """5h's capture: ``prompts`` served on the open engine under
    ``tel.profiler``; ``parse_device_trace`` of the capture must count
    as many row-tile kernel events as B1's wrapper launched in the
    window, with device-busy ms > 0 and an idle fraction in [0, 1]."""
    from paddle_tpu_torch.obs.profiler import parse_device_trace
    torch.cuda.synchronize()
    l0 = kernels.LAUNCHES["paged_attention_mixed"]
    log_dir = tel.profiler.start(os.path.join(tmp, "profile"))
    t0 = time.perf_counter()
    futs = [eng.submit(p, m) for p, m in zip(prompts, max_new)]
    for f in futs:
        f.result(timeout=600)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    artifact = tel.profiler.stop()
    launched = kernels.LAUNCHES["paged_attention_mixed"] - l0
    prof = parse_device_trace(log_dir, program="decode_step")
    _check(prof is not None, "profile_telemetry: no device event in the "
           "capture")
    seen = sum(n for name, n in prof.event_counts.items()
               if ROWS_KERNEL in name)
    _check(seen == launched > 0, f"profile_telemetry: the capture holds "
           f"{seen} {ROWS_KERNEL} events, the window launched {launched}")
    _check(prof.device_ms_total > 0.0 and prof.idle_frac is not None
           and 0.0 <= prof.idle_frac <= 1.0,
           f"profile_telemetry: device busy {prof.device_ms_total} ms, "
           f"idle fraction {prof.idle_frac}")
    return {"requests": len(prompts), "wall_ms": wall_ms,
            "device_busy_ms": prof.device_ms_total,
            "idle_frac": prof.idle_frac, "device_events": prof.spans,
            "rows_kernel_events": seen, "rows_kernel_launches": launched,
            "op_kind_ms": {k: round(v, 4)
                           for k, v in sorted(prof.op_kind_ms.items())},
            "artifact_mb": os.path.getsize(artifact) / 1e6, "card": card}


def serve_telemetry(DecodeEngine, kernels, dm, make_pools, cfg, params,
                    plain, tmp, doc_names, card):
    """5h's main line and its capture (see the module docstring).
    Returns its record (``profile_telemetry`` inside) and the launches
    of the burst and of the capture."""
    from paddle_tpu_torch.obs.trace import read_trace
    tel = _telemetry(tmp)
    trace = os.path.join(tmp, "trace.jsonl")
    held = {}

    def check(eng, prompts, max_new, results):
        rec = _ledger_checks(eng, tel, "serve_telemetry", doc_names)
        tel.flush()
        roots = [r for r in read_trace(trace) if r.get("type") == "span"
                 and r.get("name") == "serving_request"]
        ids = sorted(r["args"]["request_id"] for r in roots)
        _check(ids == sorted(r.request_id for r in results),
               f"serve_telemetry: {len(roots)} closed serving_request "
               f"spans for {len(results)} requests")
        n_ttft = eng.registry.find("decode_ttft_ms").count
        _check(n_ttft == len(prompts), f"serve_telemetry: decode_ttft_ms "
               f"counted {n_ttft}")
        evals = tel.registry.find("alert_evaluations_total")
        _check(evals is not None and evals.value > 0,
               "serve_telemetry: the alert rules were never evaluated")
        rz = eng.requestz(n=3)
        rec.update({"request_spans_closed": len(roots),
                    "alert_evaluations": evals.value,
                    "requestz_slowest": [
                        {"request_id": r["request_id"],
                         "ttft_ms": r["ttft_ms"],
                         "ttft_parts": r["ttft_parts"],
                         "timeline": r["timeline"]}
                        for r in rz["requests"]]})
        held["profile"] = profile_telemetry(
            eng, tel, kernels, prompts[:TEL_N], max_new[:TEL_N], tmp,
            card)
        held["profile_launches"] = held["profile"]["rows_kernel_launches"]
        return rec

    rec, launches, tokens = serve(
        DecodeEngine, kernels, cfg, params, key="serve_telemetry",
        engine_kw=dict(telemetry=tel), solo_index=None, check=check)
    tel.close()
    prompts, _ = _requests(cfg)
    line = rec["serve_telemetry"]
    line["vs_serve"] = _compare_greedy(
        dm, make_pools, cfg, params, "float32", (None, None), prompts,
        plain, tokens, _near_tie(LOGIT_TOL), "serve_telemetry")
    line["profile_telemetry"] = held["profile"]
    line["card"] = card
    return rec, launches, held["profile_launches"]


def spec_ledger_check(tel, doc_names):
    """5h's check of a speculative engine with telemetry: the ledger's
    ``spec`` events' accepted tokens sum to the engine's count, and
    speculation cost more than it won (``spec_overhead`` > 0)."""
    def check(eng):
        rec = _ledger_checks(eng, tel, "serve_telemetry_spec_quant",
                             doc_names)
        acc = sum(e[3] for led in eng.retired_ledgers()
                  for e in led["events"] if e[0] == "spec")
        _check(acc == eng._spec_accepted, f"serve_telemetry_spec_quant: "
               f"the ledger accepts {acc}, the engine "
               f"{eng._spec_accepted}")
        over = eng.goodput_snapshot()["components"]["spec_overhead"]
        _check(over > 0.0, "serve_telemetry_spec_quant: no spec_overhead")
        rec.update({"ledger_accepted": acc, "spec_overhead_ms": over})
        return rec
    return check


def serve_telemetry_beam(DecodeEngine, kernels, cfg, params, rungs, ref,
                         card):
    """5h's beam line: ``generate_beam(K=4, 32 new)`` of request
    BEAM_REQUESTS[0] on a fresh chunked int8 engine of ``serve_beam``'s
    (ledger on): its launches as ``serve_beam`` counts them, the beam
    mini-ledger's ``cow`` events equal to the copies made (> 0), a
    ``cow_copy`` component > 0, and the beams ``ref``'s (``serve_beam``'s
    first call on the same engine)."""
    prompts, _ = _requests(cfg)
    p = prompts[BEAM_REQUESTS[0]]
    eng = DecodeEngine(cfg, params, block_size=16, num_blocks=2048,
                       max_slots=16, eos_id=0, prompt_rungs=rungs,
                       kv_config=cfg.kv_config(16, 2048, "int8"),
                       autostart=False)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = eng.generate_beam(p, beam_size=SERVE_BEAM_K,
                            max_new_tokens=SERVE_BEAM_NEW)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = dict(kernels.LAUNCHES)
    want = dict.fromkeys(kernels.LAUNCHES, 0)
    want["paged_attention_quant"] = cfg.n_layers * SERVE_BEAM_NEW
    want["paged_attention_mixed_quant"] = \
        cfg.n_layers * -(-(len(p) - 1) // eng._mixed_rows)
    _check(launches == want, f"serve_telemetry_beam: launches {launches}, "
           f"want {want}")
    (led,) = eng.retired_ledgers()
    cows = sum(e[2] for e in led["events"] if e[0] == "cow")
    _check(cows == eng.cow_copies > 0, f"serve_telemetry_beam: {cows} "
           f"copies in the ledger, {eng.cow_copies} made")
    cow_ms = eng.goodput_snapshot()["components"]["cow_copy"]
    _check(cow_ms > 0.0, "serve_telemetry_beam: no cow_copy time")
    _check(np.array_equal(res.sequences, ref.sequences)
           and np.array_equal(res.lengths, ref.lengths),
           "serve_telemetry_beam: other beams than serve_beam's")
    eng.pool.assert_consistent()
    eng.close()
    _check(eng.pool.check_leaks() == [] and eng.pool.blocks_in_use == 0,
           "serve_telemetry_beam: leaked blocks")
    return {"serve_telemetry_beam": {
        "request": BEAM_REQUESTS[0], "ms": ms, "launches": launches,
        "cow_events": len([e for e in led["events"] if e[0] == "cow"]),
        "cow_copies": cows, "cow_copy_ms": cow_ms,
        "ledger_total_ms": led["total_ms"],
        "scores_max_abs_diff_vs_serve_beam": float(
            np.abs(res.scores - ref.scores).max()),
        "card": card}}, launches


def ledger_overhead(DecodeEngine, kernels, cfg, params, card):
    """5h's cost line: the first TEL_N requests on fresh chunked fp32
    engines in turns, plain (no telemetry, ``ledger=False``), with
    telemetry and the ledger twice, plain again; tokens/s and step ms
    p50 of each and the on / off ratios (host-timed, so reported, not
    gated); the tokens equal in all four. Returns the record and the B1
    launches of the four runs."""
    from paddle_tpu_torch.obs import Telemetry
    prompts, max_new = _requests(cfg)
    prompts, max_new = prompts[:TEL_N], max_new[:TEL_N]
    runs, tokens, n_b1 = [], [], 0
    for on in (False, True, True, False):
        tel = Telemetry(trace_path=None) if on else None
        eng = DecodeEngine(cfg, params, block_size=16, num_blocks=2048,
                           max_slots=16, eos_id=0, telemetry=tel,
                           ledger=on)
        eng.warmup()
        torch.cuda.synchronize()
        b0 = kernels.LAUNCHES["paged_attention_mixed"]
        t0 = time.perf_counter()
        futs = [eng.submit(p, m) for p, m in zip(prompts, max_new)]
        toks = [f.result(timeout=600).tokens.tolist() for f in futs]
        wall = time.perf_counter() - t0
        n_b1 += kernels.LAUNCHES["paged_attention_mixed"] - b0
        st = eng.stats()
        eng.close()
        _check(eng.pool.check_leaks() == [] and eng.pool.blocks_in_use == 0,
               "ledger_overhead: leaked blocks")
        if tel is not None:
            tel.close()
        n_tok = sum(len(t) for t in toks)
        runs.append({"telemetry_and_ledger": on, "wall_s": wall,
                     "tokens_per_s": n_tok / wall,
                     "step_ms_p50": st["step_ms_p50"],
                     "steps": st["steps_total"]})
        tokens.append(toks)
    _check(all(t == tokens[0] for t in tokens),
           "ledger_overhead: the four runs gave other tokens")

    def mean(field, on):
        return float(np.mean([r[field] for r in runs
                              if r["telemetry_and_ledger"] == on]))
    return {"ledger_overhead": {
        "requests": TEL_N, "runs": runs,
        "tokens_per_s_on_over_off": mean("tokens_per_s", True)
        / mean("tokens_per_s", False),
        "step_ms_p50_on_over_off": mean("step_ms_p50", True)
        / mean("step_ms_p50", False),
        "card": card}}, n_b1


# ---------------------------------------------------------------- training

FLASH_FWD_TOL = 1e-5            # fp32 out and lse, kernel vs plain
FLASH_GRAD_TOL = 1e-4           # fp32 dq/dk/dv: sums over up to 512 rows
# bf16 lanes: the kernel's error against the fp32 plain result, at most
# this ratio of the bf16 plain version's error + 1e-3 (both round the
# same fp32 math to bf16 once; the sums run in another order)
FLASH_BF16_RATIO = 1.5
# one full-width training step, kernels vs plain flash versions: the
# loss and every gradient leaf by relative L2 (fp32: sum order through
# 12 layers; bf16: every eager op rounds to bf16, and the flash outputs
# differ by an ulp now and then, which later bf16 ops amplify)
TRAIN_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# bench.py:800-806: the flagship LM at GPT-2-small widths, batch 16 x 512
TRAIN_CFG = dict(vocab_size=32000, d_model=768, n_heads=12, n_layers=12,
                 d_ff=3072, max_len=512)
TRAIN_B, TRAIN_T, TRAIN_LR = 16, 512, 0.01
# 3d's shapes: (B, H, Tq, Tk, causal, head_dim); "main" is what training
# gives B8/B9
FLASH_SHAPES = {"main": (16, 12, 512, 512, True, 64),
                "ragged": (4, 12, 500, 500, True, 64),
                "cross": (4, 12, 200, 512, False, 64)}
# the same forms at head_dim 128, the kernels' widest capacity (what
# TRAIN_D128_CFG gives them, at batch 4 x 8 heads), and an fp32 head_dim
# 96 inside that capacity; their records carry the suffix "_d128"
FLASH_WIDE_SHAPES = {"main": (4, 8, 512, 512, True, 128),
                     "ragged": (4, 8, 500, 500, True, 128),
                     "cross": (4, 8, 200, 512, False, 128),
                     "d96": (4, 8, 512, 512, True, 96)}
# the flagship LM with 6 heads of 128 (d_model // n_heads = 128): the d128
# records' main path
TRAIN_D128_CFG = dict(TRAIN_CFG, n_heads=6)
FLASH_KERNELS = {
    "flash_attention_fwd": "paddle_tpu/kernels/flash_attention.py:44",
    "flash_attention_dq": "paddle_tpu/kernels/flash_attention.py:93",
    "flash_attention_dkv": "paddle_tpu/kernels/flash_attention.py:133",
}


def _flash_case(dev, dtype, B, H, Tq, Tk, d=64, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def randn(T):
        return torch.randn((B, H, T, d), generator=g, device=dev).to(dtype)

    return randn(Tq), randn(Tk), randn(Tk), randn(Tq)


def _flash_bound(name, dtype, B, H, Tq, Tk, d, causal):
    """Least time of one call: its inputs read once and outputs written
    once (q/k/v/do at the payload's width, lse/delta fp32) over the HBM
    rate, against the products its visible (query, key) pairs need (fwd:
    q.k and p.v; dq: q.k, do.v, ds.k; dk/dv: those two and p^T.do,
    ds^T.q; 2 FLOPs each per element of d) over the rate of the cheapest
    form that keeps the lane's precision: bf16 on the tensor cores; fp32
    (forward and backward) as 3xTF32, three tf32 tensor-core products
    for each product."""
    e = 2 if dtype == torch.bfloat16 else 4
    rows = np.arange(Tq)
    pairs = B * H * float(np.minimum(rows + 1, Tk).sum() if causal
                          else Tq * Tk)
    bh = B * H
    if name == "flash_attention_fwd":
        nbytes = bh * ((2 * Tq + 2 * Tk) * d * e + Tq * 4)
        flops = 4.0 * d * pairs
    elif name == "flash_attention_dq":
        nbytes = bh * ((3 * Tq + 2 * Tk) * d * e + 2 * Tq * 4)
        flops = 6.0 * d * pairs
    else:
        nbytes = bh * ((2 * Tq + 4 * Tk) * d * e + 2 * Tq * 4)
        flops = 8.0 * d * pairs
    if dtype == torch.bfloat16:
        t_ops = flops / H100_BF16_FLOPS * 1e3
    else:
        t_ops = 3.0 * flops / H100_TF32_FLOPS * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _flash_calls(fa, q, k, v, do, causal, plain=False):
    """Forward, then dq and dk/dv from the forward's lse and delta:
    the kernels, or (``plain``) the plain versions on the same inputs."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    if plain:
        fwd, dq_fn, dkv_fn = (fa.flash_attention_fwd_reference,
                              fa.flash_attention_dq_reference,
                              fa.flash_attention_dkv_reference)
    else:
        fwd, dq_fn, dkv_fn = (fa.flash_attention_fwd, fa.flash_attention_dq,
                              fa.flash_attention_dkv)
    out, lse = fwd(q, k, v, causal, scale)
    delta = torch.sum(do.float() * out.float(), dim=-1)
    dq = dq_fn(q, k, v, do, lse, delta, causal, scale)
    dk, dv = dkv_fn(q, k, v, do, lse, delta, causal, scale)
    return {"out": out, "lse": lse, "delta": delta, "dq": dq, "dk": dk,
            "dv": dv}


def _flash_errors(fa, q, k, v, do, causal):
    """max |kernel - plain| per output (the plain backward from the
    kernel's lse and delta, so each kernel is held on its own inputs);
    for bf16, also each output's error against the fp32 plain result
    and the bf16 plain version's error against it."""
    got = _flash_calls(fa, q, k, v, do, causal)
    torch.cuda.synchronize()
    scale = 1.0 / np.sqrt(q.shape[-1])
    ref = dict(zip(("out", "lse"), fa.flash_attention_fwd_reference(
        q, k, v, causal, scale)))
    args = (q, k, v, do, got["lse"], got["delta"], causal, scale)
    ref["dq"] = fa.flash_attention_dq_reference(*args)
    ref["dk"], ref["dv"] = fa.flash_attention_dkv_reference(*args)
    errs = {n: float((got[n].float() - ref[n].float()).abs().max())
            for n in ("out", "lse", "dq", "dk", "dv")}
    if q.dtype != torch.bfloat16:
        return errs, None
    f = [t.float() for t in (q, k, v, do)]
    exact = dict(zip(("out", "lse"), fa.flash_attention_fwd_reference(
        *f[:3], causal, scale)))
    fargs = (*f, got["lse"], got["delta"], causal, scale)
    exact["dq"] = fa.flash_attention_dq_reference(*fargs)
    exact["dk"], exact["dv"] = fa.flash_attention_dkv_reference(*fargs)
    vs_fp32 = {n: (float((got[n].float() - exact[n]).abs().max()),
                   float((ref[n].float() - exact[n]).abs().max()))
               for n in ("out", "dq", "dk", "dv")}
    return errs, vs_fp32


def check_flash(fa, kernels, dev, flush, dtype, shapes=None, suffix=""):
    """Phase 3d: B8 (forward) and B9 (dq, dk/dv), one lane, against
    their plain versions at ``shapes`` (default ``FLASH_SHAPES``: the
    training shape [16, 12, 512, 64] causal, a ragged T = 500 and a
    non-causal cross shape Tq 200 / Tk 512; ``FLASH_WIDE_SHAPES`` the
    same at head_dim 128, and 96); a query with no key gives zeros and
    lse NEG_INF; then each kernel timed at the "main" shape beside its
    plain version, its bound and an SDPA yardstick the port never calls
    (``ms`` / ``library_ms`` by ``_time_ms``, ``device_ms`` /
    ``library_device_ms`` with the card's queue kept ahead of the host);
    two launches of each kernel on the main shape must be bit-equal.
    Returns one kernels-line record per kernel, named with ``suffix``
    (and "_bf16" for the bf16 lane)."""
    shapes = FLASH_SHAPES if shapes is None else shapes
    lane = "bf16" if dtype == torch.bfloat16 else "fp32"
    tag = f"{lane}{suffix}"
    worst = {n: 0.0 for n in ("out", "lse", "dq", "dk", "dv")}
    worst_vs = {}
    for key, (B, H, Tq, Tk, causal, d) in shapes.items():
        q, k, v, do = _flash_case(dev, dtype, B, H, Tq, Tk, d)
        errs, vs_fp32 = _flash_errors(fa, q, k, v, do, causal)
        for n, e in errs.items():
            worst[n] = max(worst[n], e)
        _check(errs["lse"] <= FLASH_FWD_TOL,
               f"flash {tag} {key}: lse differs by {errs['lse']}")
        if vs_fp32 is None:
            _check(errs["out"] <= FLASH_FWD_TOL,
                   f"flash {tag} {key}: out differs by {errs['out']}")
            for n in ("dq", "dk", "dv"):
                _check(errs[n] <= FLASH_GRAD_TOL,
                       f"flash {tag} {key}: {n} differs by {errs[n]}")
        else:
            for n, (err, plain_err) in vs_fp32.items():
                _check(err <= FLASH_BF16_RATIO * plain_err + 1e-3,
                       f"flash {tag} {key}: {n} is {err} from fp32, the "
                       f"plain version {plain_err}")
                w = worst_vs.get(n, (0.0, 0.0))
                worst_vs[n] = (max(w[0], err), max(w[1], plain_err))
        del q, k, v, do
    B, H, Tq, Tk, causal, d = shapes["main"]
    q, k, v, _do = _flash_case(dev, dtype, 1, 2, 70, 0, d)
    out, lse = fa.flash_attention_fwd(q, k, v, True, 0.125)
    torch.cuda.synchronize()
    _check(not out.any() and bool((lse == fa.NEG_INF).all()),
           f"flash {tag}: a query with no key must give 0 and NEG_INF")

    q, k, v, do = _flash_case(dev, dtype, B, H, Tq, Tk, d)
    saved = _flash_calls(fa, q, k, v, do, causal)
    scale = 1.0 / np.sqrt(q.shape[-1])
    again = fa.flash_attention_fwd(q, k, v, causal, scale)
    torch.cuda.synchronize()
    fwd_bit_equal = (torch.equal(again[0], saved["out"])
                     and torch.equal(again[1], saved["lse"]))
    _check(fwd_bit_equal, f"flash {tag}: two forward launches differ")
    del again
    bwd_args = (q, k, v, do, saved["lse"], saved["delta"], causal, scale)
    dq_again = fa.flash_attention_dq(*bwd_args)
    dk_again, dv_again = fa.flash_attention_dkv(*bwd_args)
    torch.cuda.synchronize()
    bit_equal = {
        "flash_attention_fwd": fwd_bit_equal,
        "flash_attention_dq": torch.equal(dq_again, saved["dq"]),
        "flash_attention_dkv": (torch.equal(dk_again, saved["dk"])
                                and torch.equal(dv_again, saved["dv"]))}
    _check(bit_equal["flash_attention_dq"],
           f"flash {tag}: two dq launches differ")
    _check(bit_equal["flash_attention_dkv"],
           f"flash {tag}: two dk/dv launches differ")
    del dq_again, dk_again, dv_again
    timed = {
        "flash_attention_fwd": (
            lambda: fa.flash_attention_fwd(q, k, v, causal, scale),
            lambda: fa.flash_attention_fwd_reference(q, k, v, causal,
                                                     scale)),
        "flash_attention_dq": (
            lambda: fa.flash_attention_dq(*bwd_args),
            lambda: fa.flash_attention_dq_reference(*bwd_args)),
        "flash_attention_dkv": (
            lambda: fa.flash_attention_dkv(*bwd_args),
            lambda: fa.flash_attention_dkv_reference(*bwd_args)),
    }
    # yardsticks: SDPA forward (is_causal: top-left, Tq == Tk), and its
    # backward, which gives dq, dk and dv in one call
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    o = sdpa(qs, ks, vs, is_causal=True)
    lib_fns = {"fwd": lambda: sdpa(q, k, v, is_causal=True),
               "bwd": lambda: torch.autograd.grad(
                   o, (qs, ks, vs), do, retain_graph=True)}
    lib_ms = {n: _time_ms(fn, flush) for n, fn in lib_fns.items()}
    lib_device_ms = {n: _time_ms(fn, flush, queue_ahead=True)
                     for n, fn in lib_fns.items()}
    del o, qs, ks, vs, lib_fns
    err_of = {"flash_attention_fwd": max(worst["out"], worst["lse"]),
              "flash_attention_dq": worst["dq"],
              "flash_attention_dkv": max(worst["dk"], worst["dv"])}
    recs = {}
    for name, (kernel_fn, plain_fn) in timed.items():
        side = "fwd" if name == "flash_attention_fwd" else "bwd"
        bound = _flash_bound(name, dtype, B, H, Tq, Tk, d, causal)
        rec = _lane_record(
            f"{name}{suffix}" if lane == "fp32" else f"{name}{suffix}_bf16",
            FLASH_KERNELS[name],
            "paddle_tpu_torch/kernels/csrc/flash_attention.cu",
            err_of[name], _time_ms(kernel_fn, flush),
            _time_ms(plain_fn, flush, reps=5), lib_ms[side], bound,
            {"shape": [B, H, Tq, Tk, d], "causal": causal,
             "dtype": str(dtype).replace("torch.", ""),
             "checked_shapes": {key: list(sh) for key, sh in
                                shapes.items()}})
        rec["device_ms"] = _time_ms(kernel_fn, flush, queue_ahead=True)
        rec["library_device_ms"] = lib_device_ms[side]
        rec["two_launches_bit_equal"] = bit_equal[name]
        if name != "flash_attention_fwd":
            rec["library_note"] = ("SDPA backward: dq, dk and dv in one "
                                   "call")
        if worst_vs:
            rec["err_vs_fp32_and_plain_bf16_err"] = {
                n: worst_vs[n] for n in (("out",) if name.endswith("fwd")
                                         else ("dq",) if
                                         name.endswith("dq")
                                         else ("dk", "dv"))}
        recs[name] = rec
    recs["flash_attention_dq"]["sdpa_fwd_bwd_ms"] = (lib_ms["fwd"]
                                                     + lib_ms["bwd"])
    kernels.reset_launches()
    return recs


def _param_paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for key in sorted(tree)
                for p in _param_paths(tree[key], f"{prefix}{key}/")]
    if isinstance(tree, list):
        return [p for i, item in enumerate(tree)
                for p in _param_paths(item, f"{prefix}{i}/")]
    return [prefix.rstrip("/")]


def _loss_and_grads(tt, params, tok, tgt, cfg):
    live = [p.detach().requires_grad_() for p in tt._leaves(params)]
    loss = tt.loss_fn(tt._rebuild(params, live), tok, tgt, cfg)
    return loss.detach(), torch.autograd.grad(loss, live)


def _train_batches(dev, n=4, seed=0):
    """``n`` seeded batches of random tokens and random targets, on the
    card (bench.py's LM feed)."""
    rng = np.random.default_rng(seed)

    def batch():
        return torch.from_numpy(rng.integers(
            0, TRAIN_CFG["vocab_size"], (TRAIN_B, TRAIN_T)).astype(
                np.int32)).to(dev)

    return [batch() for _ in range(n)], [batch() for _ in range(n)]


def check_train_step(tt, kernels, dev, dtype, model=None):
    """Phase 4d: one full-width training step's loss and gradients with
    the flash kernels (under sync-debug "error": the step must not sync
    the host) against the same step through their plain versions
    (``attn_impl="flash_reference"``), from the same params and batch;
    ``model`` the config's widths (default ``TRAIN_CFG``)."""
    model = TRAIN_CFG if model is None else model
    cfg = tt.TransformerConfig(**model, dtype=dtype, attn_impl="flash")
    plain_cfg = tt.TransformerConfig(**model, dtype=dtype,
                                     attn_impl="flash_reference")
    params = tt.init_params(cfg, seed=0, device=dev)
    toks, tgts = _train_batches(dev, n=1, seed=1)
    torch.cuda.synchronize()
    kernels.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss, grads = _loss_and_grads(tt, params, toks[0], tgts[0], cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    L = cfg.n_layers
    for name in FLASH_KERNELS:
        _check(kernels.LAUNCHES[name] == L,
               f"4d: {name} launched {kernels.LAUNCHES[name]}, want {L}")
    p_loss, p_grads = _loss_and_grads(tt, params, toks[0], tgts[0],
                                      plain_cfg)
    torch.cuda.synchronize()
    kernels.reset_launches()
    _check(bool(torch.isfinite(loss)), f"4d: loss {float(loss)}")
    tol = TRAIN_REL_TOL[dtype]
    loss_rel = abs(float(loss) - float(p_loss)) / abs(float(p_loss))
    _check(loss_rel <= tol, f"4d {dtype}: loss {float(loss)} vs plain "
           f"{float(p_loss)}")
    worst, worst_path = 0.0, None
    for path, g, pg in zip(_param_paths(params), grads, p_grads):
        _check(bool(torch.isfinite(g).all()), f"4d: non-finite grad {path}")
        rel = float(torch.linalg.vector_norm((g - pg).float())
                    / torch.linalg.vector_norm(pg.float()).clamp_min(1e-30))
        if rel > worst:
            worst, worst_path = rel, path
    _check(worst <= tol, f"4d {dtype}: grad {worst_path} relative L2 "
           f"{worst} > {tol}")
    return {"dtype": str(dtype).replace("torch.", ""),
            "head_dim": cfg.head_dim, "loss": float(loss),
            "plain_loss": float(p_loss), "loss_rel_err": loss_rel,
            "grad_max_rel_l2": worst, "grad_worst_leaf": worst_path,
            "grad_leaves": len(grads), "tol": tol,
            "sync_debug": "error"}


def _train_flops(cfg):
    """Model FLOPs of one step: 6 per matmul weight per token (forward
    and backward), plus attention: q.k and p.v over the causal pairs,
    three times over (forward, backward)."""
    D, Fd, V, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    n_mm = L * (4 * D * D + 2 * D * Fd) + V * D
    pairs = TRAIN_T * (TRAIN_T + 1) / 2
    attn = L * 3 * 4 * TRAIN_B * cfg.n_heads * pairs * cfg.head_dim
    return 6.0 * n_mm * TRAIN_B * TRAIN_T + attn


def train(tt, kernels, dev, key="train_transformer", dtype=torch.bfloat16,
          attn_impl="flash", warmup=3, steps=20, kstep=8, kstep_calls=2,
          reference=None, model=None):
    """Phase 5d: a training run. ``make_train_step(cfg, lr=0.01)`` at
    bench.py's shape: ``warmup`` steps, then ``steps`` timed in one
    window (tokens/s; step ms p50 from CUDA events between steps, no
    host syncs), every loss read back once at the end and held finite.
    The launch counts are zeroed just before the first step and read
    just after the last: each flash kernel runs once per layer and step
    (none for ``attn_impl="xla"``). With ``kstep``, then
    ``make_kstep_train_step`` with that K, ``kstep_calls`` timed calls
    after one warm-up call, its launches exact too. ``reference``: the
    per-step losses of another run, compared (reported, not gated).
    ``model``: the config's widths (default ``TRAIN_CFG``)."""
    model = TRAIN_CFG if model is None else model
    cfg = tt.TransformerConfig(**model, dtype=dtype, attn_impl=attn_impl)
    params = tt.init_params(cfg, seed=0, device=dev)
    velocity = tt._rebuild(params, [torch.zeros_like(p)
                                    for p in tt._leaves(params)])
    toks, tgts = _train_batches(dev)
    step = tt.make_train_step(cfg, lr=TRAIN_LR)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    L = cfg.n_layers
    per_step = L if attn_impl == "flash" else 0
    kernels.reset_launches()                       # the main path: go
    losses = []
    for i in range(warmup):
        params, velocity, loss = step(params, velocity, toks[i % 4],
                                      tgts[i % 4])
        losses.append(loss)
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(steps + 1)]
    t0 = time.perf_counter()
    for i in range(steps):
        events[i].record()
        j = (warmup + i) % 4
        params, velocity, loss = step(params, velocity, toks[j], tgts[j])
        losses.append(loss)
    events[steps].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)              # read just after
    n = warmup + steps
    want = dict.fromkeys(kernels.LAUNCHES, 0)
    for name in FLASH_KERNELS:
        want[name] = per_step * n
    _check(launches == want, f"{key}: launches {launches} over {n} steps, "
           f"want {want}")
    loss_list = torch.stack(losses).cpu().tolist()
    _check(all(np.isfinite(loss_list)), f"{key}: non-finite loss "
           f"{loss_list}")
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(steps)]
    tokens = TRAIN_B * TRAIN_T
    flops = _train_flops(cfg)
    rec = {"dtype": str(dtype).replace("torch.", ""),
           "attn_impl": attn_impl, "head_dim": cfg.head_dim,
           "batch": [TRAIN_B, TRAIN_T],
           "layers": L, "lr": TRAIN_LR, "warmup_steps": warmup,
           "timed_steps": steps, "wall_s": wall,
           "tokens_per_s": tokens * steps / wall,
           "step_ms_p50": float(np.median(step_ms)),
           "step_ms_min": float(np.min(step_ms)),
           "model_tflop_per_step": flops / 1e12,
           "model_tflops_per_s": flops * steps / wall / 1e12,
           "mfu_vs_bf16_peak": flops * steps / wall / H100_BF16_FLOPS,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "loss_first": loss_list[0], "loss_last": loss_list[-1],
           "losses_finite": len(loss_list), "launches": launches}
    if reference is not None:
        m = min(len(reference), len(loss_list))
        rec["loss_max_abs_diff_vs_flash"] = float(np.max(np.abs(
            np.asarray(loss_list[:m]) - np.asarray(reference[:m]))))
    if kstep:
        fn = tt.make_kstep_train_step(cfg, lr=TRAIN_LR)
        tk_ = torch.stack([toks[i % 4] for i in range(kstep)])
        gk_ = torch.stack([tgts[i % 4] for i in range(kstep)])
        kernels.reset_launches()                   # the K-step path: go
        params, velocity, kl = fn(params, velocity, tk_, gk_)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        klosses = [kl]
        for _ in range(kstep_calls):
            params, velocity, kl = fn(params, velocity, tk_, gk_)
            klosses.append(kl)
        torch.cuda.synchronize()
        kwall = time.perf_counter() - t0
        klaunch = dict(kernels.LAUNCHES)           # read just after
        kn = kstep * (kstep_calls + 1)
        kwant = dict.fromkeys(kernels.LAUNCHES, 0)
        for name in FLASH_KERNELS:
            kwant[name] = per_step * kn
        _check(klaunch == kwant, f"{key} kstep: launches {klaunch}, want "
               f"{kwant}")
        kvals = torch.cat(klosses).cpu().tolist()
        _check(all(np.isfinite(kvals)), f"{key} kstep: non-finite loss")
        rec.update({"kstep_k": kstep, "kstep_timed_calls": kstep_calls,
                    "kstep_tokens_per_s": tokens * kstep * kstep_calls
                    / kwall, "kstep_loss_last": kvals[-1],
                    "kstep_launches": klaunch})
    del params, velocity
    kernels.reset_launches()
    return {key: rec}, launches, loss_list


def profile_train(tt, dev, n_steps=2):
    """Where a full-width bf16 training step's time goes: ``n_steps``
    steps under ``torch.profiler`` after two warm-up steps, with B8 and
    B9's device ms per step."""
    cfg = tt.TransformerConfig(**TRAIN_CFG, attn_impl="flash")
    params = tt.init_params(cfg, seed=0, device=dev)
    velocity = tt._rebuild(params, [torch.zeros_like(p)
                                    for p in tt._leaves(params)])
    toks, tgts = _train_batches(dev)
    step = tt.make_train_step(cfg, lr=TRAIN_LR)

    def call(i):
        loss = step(params, velocity, toks[i % 4], tgts[i % 4])[2]
        return loss.cpu()

    return {"profile_train": dict(
        {"batch": [TRAIN_B, TRAIN_T], "dtype": "bfloat16"},
        **_profile([lambda i=i: call(i) for i in range(n_steps + 2)],
                   named=("tc::fwd_kernel", "tc::dq_kernel",
                          "tc::dkv_kernel")))}


# ----------------------------------------------------------------- seq2seq

# the B12/B13 kernels: forward; backward recurrence; backward dW reduction
GRU_KERNELS = {
    "gru_fwd": "paddle_tpu/kernels/fused_rnn.py:450",
    "gru_bwd": "paddle_tpu/kernels/fused_rnn.py:481",
    "gru_dw": "paddle_tpu/kernels/fused_rnn.py:481",
}
GRU_SOURCE = "paddle_tpu_torch/kernels/csrc/fused_rnn.cu"
# the recurrences' routes (fused_rnn.lstm_cluster_plan with ng=3): the
# launch names each adds to gru_fwd and gru_bwd
GRU_ROUTE_NAMES = {"resident": ("gru_fwd_cluster", "gru_bwd_cluster"),
                   "grid": ("gru_fwd_grid", "gru_bwd_grid"),
                   "streaming": ("gru_fwd_stream", "gru_bwd_stream")}
GRU_FWD_TOL = 1e-5              # fp32 hs and gates, kernel vs plain
GRU_GRAD_TOL = 1e-4             # fp32 dx and dh0
GRU_DW_REL = 1e-4               # fp32 dW, relative L2
GRU_LIBRARY_NOTE = ("none: no PyTorch call computes this GRU (torch.nn.GRU "
                    "/ cuDNN applies the reset gate after the recurrent "
                    "product, this GRU before it)")
# bench.py:882-884 (bench_seq2seq) and :941-942 (bench_beam): emb 256,
# hidden 512, vocab 8000; training batch 512 x 30 -> 30 in bf16, Adam
S2S_CFG = dict(src_vocab=8000, tgt_vocab=8000, emb_dim=256, hidden_dim=512)
S2S_B, S2S_S, S2S_T, S2S_LR = 512, 30, 30, 1e-3
BEAM_B, BEAM_K = 128, 5
# 3e's shapes (T, B, D, ragged): what training and generation give B12/B13
GRU_SHAPES = {"train": (30, 512, 512, False), "beam": (30, 128, 512, False),
              "ragged": (30, 512, 512, True)}
# the fp32 lane's grid route takes D 256, 512 and 768 (3e holds it at
# GRU_SHAPES' D 512 and prints its plans at all three); its streaming
# route is held at hidden 640 (GRU_STREAM_FP32: T, B, D), whose rows'
# launches come from a short fp32 run at that width (S2S_640_CFG)
GRU_F32_GRID_D = (256, 512, 768)
GRU_STREAM_FP32 = (30, 512, 640)


def _gru_route_wanted(dtype, D):
    """The route 3e and 5e hold the GRU's recurrences to at hidden D:
    fp32 the grid at GRU_F32_GRID_D and streaming elsewhere, bf16
    resident to D 512 and streaming past it."""
    if dtype == torch.float32:
        return "grid" if D in GRU_F32_GRID_D else "streaming"
    return "resident" if D <= 512 else "streaming"


S2S_640_CFG = dict(S2S_CFG, hidden_dim=640)
# 4e: one full-width seq2seq step, kernels vs plain GRU versions: the loss
# and every gradient by relative L2, each leaf's norm floored at
# S2S_NORM_FLOOR x the whole gradient's norm: a leaf that cancels below
# that is at fp32's noise floor, where its value moves with the last bit
# of any input (att_dec_w at init: the query's term is the same at every
# source position up to tanh's curvature and the softmax ignores a common
# shift, so its gradient is ~1e-9 of the whole).
# fp32: sum order only. bf16: each kernel-path gradient no further from
# the fp32 plain gradient than S2S_BF16_RATIO x the bf16 plain path's +
# 1e-2 (the plain path's own bf16 error sets the gate: both round every
# eager op to bf16)
S2S_REL_TOL = 1e-4
S2S_BF16_RATIO = 1.5
S2S_NORM_FLOOR = 1e-6


def _gru_case(dev, T, B, D, ragged, seed=0):
    """Seeded GRU inputs at one shape (fp32): x, w, lens, h0, dhs; ragged
    lengths are drawn from 0..T with 0 and T present."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    if ragged:
        lens = torch.randint(0, T + 1, (B, 1), generator=g,
                             device=dev).float()
        lens[0], lens[1] = 0.0, float(T)
    else:
        lens = torch.full((B, 1), float(T), device=dev)
    return (randn(T, B, 3 * D, scale=0.5), randn(D, 3 * D, scale=0.05),
            lens, randn(B, D, scale=0.3), randn(T, B, D))


def _gru_bound(name, dtype, T, B, D, cuda_cores=False):
    """Least time of one call: its inputs read once and outputs written
    once (payload at the lane's width, lens fp32) over the HBM rate,
    against its products (2 FLOPs per multiply-add: fwd h@W_ur and rh@W_c;
    bwd dc@W_c^T and dur@W_ur^T; dW the same two as outer products) over
    the lane's peak: bf16 tensor cores; the fp32 recurrences at their
    cheapest exact tensor-core form, three tf32 products (3xTF32;
    ``cuda_cores``: the fp32 CUDA cores, the bound they were held to
    before it), the fp32 dW at the CUDA cores."""
    e = 2 if dtype == torch.bfloat16 else 4
    tb = T * B
    if name == "gru_fwd":   # x, W, h0 -> hs, gates (+ lens)
        nbytes = e * (tb * 3 * D + 3 * D * D + B * D + tb * D
                      + tb * 3 * D) + 4 * B
    elif name == "gru_bwd":  # gates, hprev, W, dhs -> dx, dh0 (+ lens)
        nbytes = e * (tb * 3 * D + tb * D + 3 * D * D + tb * D
                      + tb * 3 * D + B * D) + 4 * B
    else:                    # hprev, r, dx -> dW
        nbytes = e * (tb * D + tb * D + tb * 3 * D + 3 * D * D)
    flops = 2.0 * tb * D * 3 * D
    if dtype == torch.bfloat16:
        s_per_flop = 1.0 / H100_BF16_FLOPS
    elif name != "gru_dw" and not cuda_cores:
        s_per_flop = CHUNK_S_PER_FLOP["float32"]
    else:
        s_per_flop = 1.0 / H100_FP32_FLOPS
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops * s_per_flop * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _grad_norm(grads):
    return float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads.values()])))


def _rel_l2(a, b, floor=1e-30):
    """||a - b|| / ||b||, with ||b|| floored at ``floor``."""
    return float(torch.linalg.vector_norm((a.float() - b.float()))
                 / max(float(torch.linalg.vector_norm(b.float())), floor))


def _max_err(a, b):
    return float((a.float() - b.float()).abs().max())


# The dW reductions' yardstick: the same function as one torch.matmul per
# column block over the T*B rows, on operands built outside the timed
# call (as the attention rows pre-gather K/V), with fp32 sums as the
# kernels take them (TF32 is off for the whole run)
_FP32_SUMS = ("fp32 sums (allow_bf16_reduced_precision_reduction False, "
              "TF32 off)")
DW_LIBRARY_NOTES = {
    "lstm_dw": "torch.matmul(hprev.T, dx), hprev = [h0; hs[:-1]] "
               "pre-built; " + _FP32_SUMS,
    "lstm_proj_dw": "torch.matmul([xe | hprev].T, dx), [xe | hprev] "
                    "pre-built; " + _FP32_SUMS,
    "gru_dw": "two torch.matmul calls: hprev.T @ dx[:, :2D] and "
              "bf16(r * hprev).T @ dx[:, 2D:], hprev and bf16(r * hprev) "
              "pre-built; " + _FP32_SUMS,
}


def _dw_library_call(name, hs, h0, dx, xe=None, gates=None):
    """The yardstick call of a dW entry (DW_LIBRARY_NOTES), its operands
    built now, and its result as the entry returns it."""
    T, B, D = hs.shape
    G = dx.shape[-1]
    hprev = torch.cat([h0[None], hs[:-1]]).reshape(T * B, D)
    d = dx.reshape(T * B, G)
    if name == "lstm_dw":
        return lambda: torch.matmul(hprev.t(), d)
    if name == "lstm_proj_dw":
        xh = torch.cat([xe.reshape(T * B, -1), hprev], dim=1)
        return lambda: torch.matmul(xh.t(), d)
    rh = (gates[..., D:2 * D].reshape(T * B, D).float()
          * hprev.float()).to(dx.dtype)
    return lambda: (torch.matmul(hprev.t(), d[:, :2 * D]),
                    torch.matmul(rh.t(), d[:, 2 * D:]))


def _dw_yardstick(name, kernel_fn, library_fn, flush):
    """Two launches of a dW entry on the same inputs must give the same
    bits; then its yardstick, checked against the kernel's result (the
    same function: relative L2 <= 1e-2) and timed with fp32 sums.
    Returns the record's extra keys."""
    def whole(out, dim):   # [dWx; dW] rows, or gru's two column blocks
        return torch.cat(out, dim=dim) if isinstance(out, tuple) else out

    first, second = whole(kernel_fn(), 0), whole(kernel_fn(), 0)
    _check(torch.equal(first, second),
           f"{name}: two launches on the same inputs differ")
    mm = torch.backends.cuda.matmul
    prev = mm.allow_bf16_reduced_precision_reduction
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        err = _rel_l2(whole(library_fn(), 1), first)
        _check(err <= 1e-2, f"{name}: the yardstick differs from the "
               f"kernel by {err} (relative L2)")
        ms = _time_ms(library_fn, flush)
    finally:
        mm.allow_bf16_reduced_precision_reduction = prev
    return {"library_ms": ms, "library_note": DW_LIBRARY_NOTES[name],
            "library_rel_l2_vs_kernel": err, "bit_equal_two_launches": True}


def _gru_errors(fr, x, w, lens, h0, dhs, dtype):
    """Each kernel (forward; backward recurrence; dW) against its plain
    version on the kernel's own inputs, one lane. fp32: max |kernel -
    plain| (dW: relative L2). bf16: each output's error against the fp32
    plain result beside the bf16 plain version's, as (kernel, plain)."""
    xs, ws, h0s, dhss = (t.to(dtype) for t in (x, w, h0, dhs))
    hs, gates = fr.gru_fwd(xs, ws, lens, h0s)
    dx, dh0 = fr.gru_bwd_data(gates, hs, ws, lens, h0s, dhss)
    dw = fr.gru_dw(gates, hs, h0s, dx)
    torch.cuda.synchronize()
    r_hs, r_gates = fr.gru_fwd_reference(xs, ws, lens, h0s)
    r_dx, r_dh0 = fr.gru_bwd_data_reference(gates, hs, ws, lens, h0s, dhss)
    r_dw = fr.gru_dw_reference(gates, hs, h0s, dx)
    got = {"hs": hs, "gates": gates, "dx": dx, "dh0": dh0}
    plain = {"hs": r_hs, "gates": r_gates, "dx": r_dx, "dh0": r_dh0}
    if dtype == torch.float32:
        errs = {n: _max_err(got[n], plain[n]) for n in got}
        errs["dw_rel_l2"] = _rel_l2(dw, r_dw)
        return errs, got
    f = [t.float() for t in (xs, ws, h0s, dhss)]
    e_hs, e_gates = fr.gru_fwd_reference(f[0], f[1], lens, f[2])
    e_dx, e_dh0 = fr.gru_bwd_data_reference(gates.float(), hs.float(), f[1],
                                            lens, f[2], f[3])
    e_dw = fr.gru_dw_reference(gates.float(), hs.float(), f[2], dx.float())
    exact = {"hs": e_hs, "gates": e_gates, "dx": e_dx, "dh0": e_dh0}
    errs = {n: (_max_err(got[n], exact[n]), _max_err(plain[n], exact[n]))
            for n in got}
    errs["dw_rel_l2"] = (_rel_l2(dw, e_dw), _rel_l2(r_dw, e_dw))
    return errs, got


def _gru_plan(fr, dtype, B, D, dev):
    """The GRU recurrences' plan at one shape, as a record: route, tile
    rows (bb), clusters and waves of clusters (grid: the group's clusters
    of 16 CTAs and their units, all held at once, and the row tiles
    looped inside each step)."""
    plan = fr._cluster_plan(dtype, B, D, dev, ng=3)
    if plan.route == "grid":
        return {"route": plan.route, "clusters": plan.group,
                "cluster_ctas": plan.cluster, "units_per_cta": plan.units,
                "row_tiles": plan.tiles, "max_clusters": plan.max_clusters,
                "smem_bytes": plan.smem}
    if plan.route != "resident":
        return {"route": plan.route}
    return {"route": plan.route, "bb": plan.bb, "clusters": plan.tiles,
            "cluster_ctas": plan.cluster, "max_clusters": plan.max_clusters,
            "waves": -(-plan.tiles // plan.max_clusters),
            "smem_bytes": plan.smem}


def check_gru(fr, kernels, dev, flush, dtype):
    """Phase 3e: B12 (gru_fwd) and B13 (gru_bwd: the reverse recurrence;
    gru_dw: the dW reduction), one lane, against their plain versions at
    the training shape (T 30, B 512, D 512), the generation shape (B
    128) and a ragged training batch (lengths 0..30: a zero-length row
    keeps h0 and gets no gradient). fp32: hs/gates to 1e-5, dx/dh0 to
    1e-4, dW to 1e-4 relative L2; bf16: no further from the fp32 plain
    result than 1.5x the bf16 plain version + 1e-3. Then each kernel,
    two launches of it bit-equal, timed beside its plain version and its
    bound (fp32 gru_fwd at the generation shape, which runs it;
    everything else at the training shape): ``ms`` by ``_time_ms``, and
    ``device_ms`` with the card's queue kept ahead of the host (the
    ctypes wrapper's host time otherwise lands in the window). The plan
    must give ``_gru_route_wanted``'s route at each shape (fp32: the
    grid); the recurrences' records carry it (``_gru_plan``). Returns one
    kernels-line record per kernel."""
    lane = "bf16" if dtype == torch.bfloat16 else "fp32"
    worst = {}
    for key, (T, B, D, ragged) in GRU_SHAPES.items():
        plan, want = (fr._cluster_plan(dtype, B, D, dev, ng=3),
                      _gru_route_wanted(dtype, D))
        _check(plan.route == want, f"gru {lane} {key}: route {plan}, want "
               f"{want}")
        x, w, lens, h0, dhs = _gru_case(dev, T, B, D, ragged)
        errs, got = _gru_errors(fr, x, w, lens, h0, dhs, dtype)
        for n, e in errs.items():
            if dtype == torch.float32:
                worst[n] = max(worst.get(n, 0.0), e)
                tol = (GRU_FWD_TOL if n in ("hs", "gates") else GRU_DW_REL
                       if n == "dw_rel_l2" else GRU_GRAD_TOL)
                _check(e <= tol, f"gru fp32 {key}: {n} differs by {e}")
            else:
                err, plain_err = e
                w_ = worst.get(n, (0.0, 0.0))
                worst[n] = (max(w_[0], err), max(w_[1], plain_err))
                _check(err <= FLASH_BF16_RATIO * plain_err + 1e-3,
                       f"gru bf16 {key}: {n} is {err} from fp32, the plain "
                       f"version {plain_err}")
        if ragged:
            zero = lens[:, 0] == 0
            _check(bool((got["hs"][:, zero].float()
                         == h0[zero].to(dtype).float()).all()),
                   f"gru {lane}: a zero-length row must keep h0")
            _check(not got["dx"][:, zero].any(),
                   f"gru {lane}: a zero-length row must get no gradient")
        del x, w, lens, h0, dhs, got
    recs = {}
    for name in GRU_KERNELS:
        T, B, D, _r = GRU_SHAPES["beam" if (name == "gru_fwd" and
                                            lane == "fp32") else "train"]
        x, w, lens, h0, dhs = (t.to(dtype) if t.shape[-1] != 1 else t
                               for t in _gru_case(dev, T, B, D, False))
        hs, gates = fr.gru_fwd(x, w, lens, h0)
        dx, _dh0 = fr.gru_bwd_data(gates, hs, w, lens, h0, dhs)
        kernel_fn, plain_fn = {
            "gru_fwd": (lambda: fr.gru_fwd(x, w, lens, h0),
                        lambda: fr.gru_fwd_reference(x, w, lens, h0)),
            "gru_bwd": (lambda: fr.gru_bwd_data(gates, hs, w, lens, h0, dhs),
                        lambda: fr.gru_bwd_data_reference(gates, hs, w, lens,
                                                          h0, dhs)),
            "gru_dw": (lambda: fr.gru_dw(gates, hs, h0, dx),
                       lambda: fr.gru_dw_reference(gates, hs, h0, dx)),
        }[name]
        err_of = {"gru_fwd": ("hs", "gates"), "gru_bwd": ("dx", "dh0"),
                  "gru_dw": ("dw_rel_l2",)}[name]
        extra = {"shape": [T, B, D],
                 "dtype": str(dtype).replace("torch.", ""),
                 "library_note": GRU_LIBRARY_NOTE, "library_ms": None}
        if name == "gru_dw":
            extra.update(_dw_yardstick(name, kernel_fn, _dw_library_call(
                name, hs, h0, dx, gates=gates), flush), err_is="relative L2")
        else:
            first, second = kernel_fn(), kernel_fn()
            _check(all(torch.equal(a, b) for a, b in zip(first, second)),
                   f"{name} {lane}: two launches on the same inputs differ")
            del first, second
            extra.update(plan=_gru_plan(fr, dtype, B, D, dev),
                         bit_equal_two_launches=True)
        extra["device_ms"] = _time_ms(kernel_fn, flush, queue_ahead=True)
        if name != "gru_dw":
            extra["us_per_step"] = extra["device_ms"] / T * 1e3
            if lane == "fp32":
                extra["bound_cuda_core_ms"] = _gru_bound(
                    name, dtype, T, B, D, cuda_cores=True)[0]
        rec = _lane_record(
            name if lane == "fp32" else f"{name}_bf16", GRU_KERNELS[name],
            GRU_SOURCE,
            max(worst[n] if lane == "fp32" else worst[n][0] for n in err_of),
            _time_ms(kernel_fn, flush), _time_ms(plain_fn, flush, reps=5),
            extra.pop("library_ms"), _gru_bound(name, dtype, T, B, D), extra)
        if lane == "bf16":
            rec["err_vs_fp32_and_plain_bf16_err"] = {n: worst[n]
                                                     for n in err_of}
        recs[name] = rec
        del x, w, lens, h0, dhs, hs, gates, dx
    # the fp32 forward also at the training shape (the fp32 train run)
    if lane == "fp32":
        T, B, D, _r = GRU_SHAPES["train"]
        x, w, lens, h0, _d = _gru_case(dev, T, B, D, False)
        recs["gru_fwd"]["train_shape_ms"] = _time_ms(
            lambda: fr.gru_fwd(x, w, lens, h0), flush)
        recs["gru_fwd"]["train_shape_device_ms"] = _time_ms(
            lambda: fr.gru_fwd(x, w, lens, h0), flush, queue_ahead=True)
        recs["gru_fwd"]["train_shape_us_per_step"] = \
            recs["gru_fwd"]["train_shape_device_ms"] / T * 1e3
        recs["gru_fwd"]["train_shape_bound_ms"] = _gru_bound(
            "gru_fwd", dtype, T, B, D)[0]
        recs["gru_fwd"]["train_shape_bound_cuda_core_ms"] = _gru_bound(
            "gru_fwd", dtype, T, B, D, cuda_cores=True)[0]
        recs["gru_fwd"]["train_shape_plan"] = _gru_plan(fr, dtype, B, D, dev)
    # B13 as the JAX kernel counts it: the recurrence and dW together
    recs["gru_bwd"]["b13_ms"] = recs["gru_bwd"]["ms"] + recs["gru_dw"]["ms"]
    recs["gru_bwd"]["b13_device_ms"] = (recs["gru_bwd"]["device_ms"]
                                        + recs["gru_dw"]["device_ms"])
    T, B, D, _r = GRU_SHAPES["train"]
    tb, e = T * B, 2 if dtype == torch.bfloat16 else 4
    b13_bytes = e * (2 * tb * 3 * D + 2 * tb * D + 2 * 3 * D * D + B * D)
    b13_ops = 4.0 * tb * D * 3 * D
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_FP32_FLOPS
    recs["gru_bwd"]["b13_bound_ms"] = max(b13_bytes / H100_BYTES_PER_S,
                                          b13_ops / peak) * 1e3
    kernels.reset_launches()
    return recs


def check_gru_stream_fp32(fr, kernels, dev, flush, shape=GRU_STREAM_FP32):
    """Phase 3e, the GRU's fp32 lane at a D its grid route does not take
    (hidden 640): the plan must stream; one forward and one reverse
    recurrence count once under ``gru_fwd`` / ``gru_bwd`` and their
    ``_stream`` names and launch nothing else; each within GRU_FWD_TOL /
    GRU_GRAD_TOL of its plain version, two launches bit-equal, timed
    beside its plain version and its bound. Returns kernels-line records
    ``gru_{fwd,bwd}_stream_d{D}``."""
    T, B, D = shape
    plan = fr._cluster_plan(torch.float32, B, D, dev, ng=3)
    _check(plan.route == "streaming", f"gru fp32 D {D}: route {plan}, want "
           "streaming")
    x, w, lens, h0, dhs = _gru_case(dev, T, B, D, True)
    torch.cuda.synchronize()
    before = dict(kernels.LAUNCHES)
    hs, gates = fr.gru_fwd(x, w, lens, h0)
    dx, dh0 = fr.gru_bwd_data(gates, hs, w, lens, h0, dhs)
    torch.cuda.synchronize()
    moved = {n: k - before[n] for n, k in kernels.LAUNCHES.items()
             if k != before[n]}
    want = dict.fromkeys(("gru_fwd", "gru_bwd", *GRU_ROUTE_NAMES[
        "streaming"]), 1)
    _check(moved == want, f"gru fp32 D {D}: launches {moved}, want {want}")
    calls = {"gru_fwd": ((hs, gates), lambda: fr.gru_fwd(x, w, lens, h0),
                         lambda: fr.gru_fwd_reference(x, w, lens, h0),
                         GRU_FWD_TOL),
             "gru_bwd": ((dx, dh0), lambda: fr.gru_bwd_data(
                 gates, hs, w, lens, h0, dhs),
                 lambda: fr.gru_bwd_data_reference(gates, hs, w, lens, h0,
                                                   dhs), GRU_GRAD_TOL)}
    recs = {}
    for name, (got, kernel_fn, plain_fn, tol) in calls.items():
        err = max(_max_err(a, p) for a, p in zip(got, plain_fn()))
        _check(err <= tol, f"gru fp32 D {D}: {name} differs by {err}")
        _check(all(torch.equal(a, b) for a, b in zip(got, kernel_fn())),
               f"gru fp32 D {D}: {name}: two launches on the same inputs "
               "differ")
        device_ms = _time_ms(kernel_fn, flush, reps=5, queue_ahead=True)
        key = f"{name}_stream_d{D}"
        recs[key] = _lane_record(
            key, GRU_KERNELS[name], GRU_SOURCE, err,
            _time_ms(kernel_fn, flush, reps=5),
            _time_ms(plain_fn, flush, reps=3), None,
            _gru_bound(name, torch.float32, T, B, D),
            {"shape": [T, B, D], "dtype": "float32", "plan": {
                "route": plan.route}, "device_ms": device_ms,
             "us_per_step": device_ms / T * 1e3,
             "bound_cuda_core_ms": _gru_bound(name, torch.float32, T, B, D,
                                              cuda_cores=True)[0],
             "bit_equal_two_launches": True,
             "library_note": GRU_LIBRARY_NOTE})
    kernels.reset_launches()
    return recs


def _s2s_batches(dev, n=4, seed=0, ragged=False):
    """bench.py:891-900's feed: ``n`` seeded batches of random tokens
    (ids 2..7999), all-ones masks; ``ragged`` gives the first half of the
    rows source lengths 1..30 (row 0: 1, row 1: 30)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        b = {"src": rng.randint(2, 8000, (S2S_B, S2S_S)),
             "src_mask": np.ones((S2S_B, S2S_S), np.float32),
             "tgt_in": rng.randint(2, 8000, (S2S_B, S2S_T)),
             "tgt_out": rng.randint(2, 8000, (S2S_B, S2S_T)),
             "tgt_mask": np.ones((S2S_B, S2S_T), np.float32)}
        if ragged:
            half = S2S_B // 2
            lens = rng.randint(1, S2S_S + 1, half)
            lens[0], lens[1] = 1, S2S_S
            b["src_mask"][:half] = (np.arange(S2S_S)[None]
                                    < lens[:, None]).astype(np.float32)
        out.append({k: torch.from_numpy(np.asarray(
            v, np.int32 if v.dtype.kind == "i" else np.float32)).to(dev)
                    for k, v in b.items()})
    return out


def _s2s_grads(s2s, params, b, cfg):
    live = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = s2s.decode_train_loss(live, b["src"], b["src_mask"], b["tgt_in"],
                                 b["tgt_out"], b["tgt_mask"], cfg)
    grads = torch.autograd.grad(loss, list(live.values()))
    return loss.detach(), dict(zip(live, grads))


def check_s2s_step(s2s, fr, kernels, dev):
    """Phase 4e: one full-width seq2seq training step (bench_seq2seq's
    config, half the sources ragged) in fp32 and in bf16, through the
    GRU kernels (under sync-debug "error": the step must not sync the
    host; two launches of each kernel: the encoder's two directions)
    against the same step through their plain versions
    (``fused_rnn.plain_versions()``), from the same params and batch."""
    batch = _s2s_batches(dev, n=1, seed=1, ragged=True)[0]
    recs, exact = [], None
    for dtype in (torch.float32, torch.bfloat16):
        torch.cuda.empty_cache()
        cfg = s2s.Seq2SeqConfig(**S2S_CFG, dtype=dtype)
        params = s2s.init_params(cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        kernels.reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            loss, grads = _s2s_grads(s2s, params, batch, cfg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        for name in GRU_KERNELS:
            _check(kernels.LAUNCHES[name] == 2,
                   f"4e: {name} launched {kernels.LAUNCHES[name]}, want 2")
        with fr.plain_versions():
            p_loss, p_grads = _s2s_grads(s2s, params, batch, cfg)
        torch.cuda.synchronize()
        kernels.reset_launches()
        _check(bool(torch.isfinite(loss)), f"4e: loss {float(loss)}")
        loss_rel = abs(float(loss) - float(p_loss)) / abs(float(p_loss))
        rec = {"dtype": str(dtype).replace("torch.", ""),
               "loss": float(loss), "plain_loss": float(p_loss),
               "loss_rel_err": loss_rel, "sync_debug": "error",
               "ragged_rows": S2S_B // 2}
        if exact is None:
            exact = p_grads
            floor = S2S_NORM_FLOOR * _grad_norm(exact)
        rels = {}
        for k, g in grads.items():
            _check(bool(torch.isfinite(g).all()), f"4e: non-finite grad {k}")
            rels[k] = (_rel_l2(g, p_grads[k], floor),
                       _rel_l2(g, p_grads[k]))
        worst_k = max(rels, key=lambda k: rels[k][0])
        worst = rels[worst_k][0]
        unfloored_k = max(rels, key=lambda k: rels[k][1])
        rec.update({
            "grad_max_rel_l2": worst, "grad_worst_leaf": worst_k,
            "grad_max_rel_l2_unfloored": rels[unfloored_k][1],
            "grad_worst_leaf_unfloored": unfloored_k,
            "leaf_norm_over_grad_norm": float(torch.linalg.vector_norm(
                p_grads[unfloored_k].float())) / _grad_norm(p_grads),
            "norm_floor": S2S_NORM_FLOOR})
        if dtype == torch.float32:
            _check(loss_rel <= S2S_REL_TOL and worst <= S2S_REL_TOL,
                   f"4e fp32: loss rel {loss_rel}, grad {worst_k} rel "
                   f"{worst} > {S2S_REL_TOL}")
            rec["tol"] = S2S_REL_TOL
        else:
            gate = {}
            for k, g in grads.items():
                err = _rel_l2(g, exact[k], floor)
                plain_err = _rel_l2(p_grads[k], exact[k], floor)
                gate[k] = (err, plain_err)
                _check(err <= S2S_BF16_RATIO * plain_err + 1e-2,
                       f"4e bf16: grad {k} is {err} from the fp32 plain "
                       f"gradient, the bf16 plain path {plain_err}")
            rec["grad_rel_l2_vs_fp32_plain_and_plain_bf16"] = gate
            _check(loss_rel <= 1e-2, f"4e bf16: loss rel {loss_rel}")
        recs.append(rec)
        del params, grads
    return recs


def _s2s_flops(cfg):
    """bench.py:924-929: model FLOPs of one training step (3 x forward,
    2 per multiply-add) per target token, times B x T."""
    e, h, v = cfg.emb_dim, cfg.hidden_dim, cfg.tgt_vocab
    macs_tok = (2 * 3 * h * (e + h) + 3 * h * (e + 3 * h)
                + h * h + 2 * S2S_S * h + h * v)
    return 3 * 2 * macs_tok * S2S_B * S2S_T


def train_s2s(s2s, kernels, dev, key="train_seq2seq", dtype=torch.bfloat16,
              warmup=3, steps=20, widths=S2S_CFG):
    """Phase 5e: a seq2seq training run. ``make_train_step(cfg,
    lr=1e-3)`` (Adam) at bench_seq2seq's shape over its 4 seeded batches:
    ``warmup`` steps, then ``steps`` timed in one window (tokens/s: B x T
    target tokens per step; step ms p50 from CUDA events between steps,
    no host syncs), every loss read back once at the end and held
    finite. The launch counts are zeroed just before the first step and
    read just after the last: each GRU kernel runs twice per step, the
    recurrences each under their route's name too (``GRU_ROUTE_NAMES``
    of ``lstm_cluster_plan`` with ng=3, which must be
    ``_gru_route_wanted``'s: the bf16 run's resident, the fp32 run's grid;
    at ``widths`` S2S_640_CFG the fp32 run's streaming)."""
    cfg = s2s.Seq2SeqConfig(**widths, dtype=dtype)
    route = kernels.fused_rnn._cluster_plan(
        dtype, S2S_B, widths["hidden_dim"], dev, ng=3).route
    want = _gru_route_wanted(dtype, widths["hidden_dim"])
    _check(route == want, f"{key}: GRU route {route}, want {want}")
    params = s2s.init_params(cfg, seed=0, device=dev)
    opt, step = s2s.make_train_step(cfg, lr=S2S_LR)
    state = opt.init(params)
    batches = _s2s_batches(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()                       # the main path: go
    losses = []
    for i in range(warmup):
        params, state, loss = step(params, state, batches[i % 4])
        losses.append(loss)
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    t0 = time.perf_counter()
    for i in range(steps):
        events[i].record()
        params, state, loss = step(params, state, batches[(warmup + i) % 4])
        losses.append(loss)
    events[steps].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)              # read just after
    n = warmup + steps
    want = dict.fromkeys(kernels.LAUNCHES, 0)
    for name in (*GRU_KERNELS, *GRU_ROUTE_NAMES[route]):
        want[name] = 2 * n
    _check(launches == want, f"{key}: launches {launches} over {n} steps, "
           f"want {want}")
    loss_list = torch.stack(losses).cpu().tolist()
    _check(all(np.isfinite(loss_list)), f"{key}: non-finite loss "
           f"{loss_list}")
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(steps)]
    flops = _s2s_flops(cfg)
    del params, state
    kernels.reset_launches()
    return {key: {
        "dtype": str(dtype).replace("torch.", ""),
        "batch": [S2S_B, S2S_S, S2S_T], "widths": widths, "lr": S2S_LR,
        "warmup_steps": warmup, "timed_steps": steps, "wall_s": wall,
        "tokens_per_s": S2S_B * S2S_T * steps / wall,
        "step_ms_p50": float(np.median(step_ms)),
        "step_ms_min": float(np.min(step_ms)),
        "model_tflop_per_step": flops / 1e12,
        "mfu_vs_bf16_peak": flops * steps / wall / H100_BF16_FLOPS,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "loss_first": loss_list[0], "loss_last": loss_list[-1],
        "losses_finite": len(loss_list), "gru_route": route,
        "launches": launches}}, launches


def generate_beam(s2s, fr, kernels, dev, calls=6, hold_route=True):
    """Phase 5e: beam-search generation at bench_beam's config (fp32,
    batch 128, beam 5, source and output length 30, 2 seeded sources).
    One call under sync-debug "error" (nothing in the search may sync),
    then ``calls`` timed calls alternating the sources (ms per batch;
    emitted tokens/s: batch x max_len per call). The launch counts are
    zeroed just before the first call and read just after the last: two
    ``gru_fwd`` launches per call (the encoder), each also under its
    route's name, which must be the grid's at B 128, D 512
    (``gru_fwd_grid``; ``hold_route`` False takes the plan's route, as a
    probe timing another tree does). Two calls on one source give the
    same sequences; agreement of the best beam with the plain-GRU path
    is reported, not gated."""
    cfg = s2s.Seq2SeqConfig(**S2S_CFG)
    params = s2s.init_params(cfg, seed=0, device=dev)
    rng = np.random.RandomState(0)
    srcs = [torch.from_numpy(rng.randint(2, 8000, (BEAM_B, S2S_S)).astype(
        np.int32)).to(dev) for _ in range(2)]
    mask = torch.ones((BEAM_B, S2S_S), device=dev)

    def gen(src):
        return s2s.generate(params, src, mask, cfg, beam_size=BEAM_K,
                            max_len=S2S_T)

    gen(srcs[1])                                   # allocator warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()                       # the main path: go
    torch.cuda.set_sync_debug_mode("error")
    try:
        first = gen(srcs[0])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(calls):
        out = gen(srcs[i % 2])
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / calls
    launches = dict(kernels.LAUNCHES)              # read just after
    want = dict.fromkeys(kernels.LAUNCHES, 0)
    route = fr._cluster_plan(torch.float32, BEAM_B, S2S_CFG["hidden_dim"],
                             dev, ng=3).route
    wanted = _gru_route_wanted(torch.float32, S2S_CFG["hidden_dim"])
    _check(route == wanted or not hold_route, f"generate_beam: GRU route "
           f"{route}, want {wanted}")
    for name in ("gru_fwd", GRU_ROUTE_NAMES[route][0]):
        want[name] = 2 * (calls + 1)
    _check(launches == want, f"generate_beam: launches {launches}, want "
           f"{want}")
    again = gen(srcs[0])
    _check(torch.equal(first.sequences, again.sequences)
           and torch.equal(first.lengths, again.lengths),
           "generate_beam: two calls on one source differ")
    with fr.plain_versions():
        plain = gen(srcs[0])
    seqs, lens = first.sequences.cpu(), first.lengths.cpu()
    _check(tuple(seqs.shape) == (BEAM_B, BEAM_K, S2S_T)
           and bool(((lens >= 1) & (lens <= S2S_T)).all())
           and bool(torch.isfinite(first.scores).all())
           and bool((first.scores[:, :-1] >= first.scores[:, 1:]).all()),
           "generate_beam: malformed result")
    best_equal = float((seqs[:, 0] == plain.sequences[:, 0].cpu())
                       .all(dim=1).float().mean())
    del params, out
    kernels.reset_launches()
    return {"generate_beam": {
        "dtype": "float32", "batch": BEAM_B, "beam": BEAM_K,
        "src_len": S2S_S, "max_len": S2S_T, "widths": S2S_CFG,
        "timed_calls": calls, "ms_per_batch": wall * 1e3,
        "emitted_tokens_per_s": BEAM_B * S2S_T / wall,
        "mean_best_length": float(lens[:, 0].float().mean()),
        "deterministic": True, "sync_debug": "error",
        "best_beam_equal_share_vs_plain_gru": best_equal,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches}}, launches


GRU_RECURRENCE_KERNELS = ("gru_cluster_fwd_kernel", "gru_cluster_bwd_kernel",
                          "gru_grid_fwd_f32_kernel",
                          "gru_grid_bwd_f32_kernel", "gru_fwd_kernel",
                          "gru_bwd_kernel")


def profile_s2s(s2s, dev, dtype=torch.bfloat16):
    """Where a full-width seq2seq training step's time goes (bf16, or the
    fp32 lane): one step under ``torch.profiler`` after two warm-up
    steps, with B12 and B13's device ms per step (each kernel by name:
    the recurrences on any route, the dW reduction and its ordered sum)
    and the two recurrences' sum
    (``gru_recurrences_device_ms_per_step``)."""
    cfg = s2s.Seq2SeqConfig(**S2S_CFG, dtype=dtype)
    state = {"p": s2s.init_params(cfg, seed=0, device=dev)}
    opt, step = s2s.make_train_step(cfg, lr=S2S_LR)
    state["o"] = opt.init(state["p"])
    batches = _s2s_batches(dev)

    def call(i):
        state["p"], state["o"], loss = step(state["p"], state["o"],
                                            batches[i % 4])
        return loss.cpu()

    rec = dict({"batch": [S2S_B, S2S_S, S2S_T],
                "dtype": str(dtype).replace("torch.", "")},
               **_profile([lambda i=i: call(i) for i in range(3)],
                          named=GRU_RECURRENCE_KERNELS + ("dw_wgmma",
                                                          "sum_partials")))
    named = rec.get("named_device_ms_per_step", {})
    rec["gru_recurrences_device_ms_per_step"] = sum(
        named.get(k, 0.0) for k in GRU_RECURRENCE_KERNELS)
    return {"profile_seq2seq": rec}


# -------------------------------------------------------------------- LSTM

# the B10/B11 (dynamic_lstm) and B14/B15 (fused_lstm) kernels: each
# wrapper and the TPU kernel function it replaces
LSTM_KERNELS = {
    "lstm_fwd": "paddle_tpu/kernels/fused_rnn.py:215",
    "lstm_bwd": "paddle_tpu/kernels/fused_rnn.py:266",
    "lstm_dw": "paddle_tpu/kernels/fused_rnn.py:266",
    "lstm_proj_fwd": "paddle_tpu/kernels/fused_rnn.py:663",
    "lstm_proj_bwd": "paddle_tpu/kernels/fused_rnn.py:700",
    "lstm_proj_dw": "paddle_tpu/kernels/fused_rnn.py:700",
}
LSTM_COMPOSED = ("lstm_fwd", "lstm_bwd", "lstm_dw")
LSTM_PROJ = ("lstm_proj_fwd", "lstm_proj_bwd", "lstm_proj_dw")
# the recurrences' routes (fused_rnn.lstm_cluster_plan): the
# launch names each adds to LSTM_COMPOSED (B10/B11) and to LSTM_PROJ
# (B14/B15, with the resident route's pre- and post-pass kernels)
LSTM_COMPOSED_ROUTE_NAMES = {
    "resident": ("lstm_fwd_cluster", "lstm_bwd_cluster"),
    "grid": ("lstm_fwd_grid", "lstm_bwd_grid"),
    "streaming": ("lstm_fwd_stream", "lstm_bwd_stream")}
LSTM_ROUTE_NAMES = {
    "resident": ("lstm_proj_fwd_cluster", "lstm_proj_bwd_cluster",
                 "lstm_proj_xg", "lstm_proj_dxe"),
    "grid": ("lstm_proj_fwd_grid", "lstm_proj_bwd_grid", "lstm_proj_xg",
             "lstm_proj_dxe"),
    "streaming": ("lstm_proj_fwd_stream", "lstm_proj_bwd_stream")}
# the routes' suffixes of the launch names
LSTM_ROUTE_SUFFIX = {"resident": "_cluster", "grid": "_grid",
                     "streaming": "_stream"}
LSTM_PASSES = {"lstm_proj_xg": "paddle_tpu/kernels/fused_rnn.py:663",
               "lstm_proj_dxe": "paddle_tpu/kernels/fused_rnn.py:700"}
LSTM_PASS_NOTES = {
    "lstm_proj_xg": "torch.addmm(b, xe, wx, out_dtype=torch.float32): bf16 "
                    "operands, fp32 sums and fp32 out, the pre-pass's own "
                    "function, but a slow path on an H100 (several times "
                    "the time to write xg once, nearly flat in E): judge "
                    "the pass by bound_ms / device_ms; "
                    "library_bf16_out_device_ms: torch.addmm(b, xe, wx) in "
                    "bf16 (bf16 out, half the bytes written: another "
                    "function)",
    "lstm_proj_dxe": "torch.matmul(dx, wx.t()) in bf16 (fp32 sums, bf16 "
                     "out)"}
XG_REL_TOL = 1e-5               # fp32 sums of exact bf16 products
DXE_REL_TOL = 2.0 ** -7         # one bf16 rounding of the fp32 sum
# the fp32 lane's passes (3xTF32 against fp32 sums): fp32 parity
F32_PASS_REL_TOL = 1e-5
F32_PASS_NOTES = {
    "lstm_proj_xg": "torch.addmm(b, xe, wx) in fp32 (full fp32: TF32 off), "
                    "the pre-pass's function",
    "lstm_proj_dxe": "torch.matmul(dx, wx.t()) in fp32 (TF32 off)"}
LSTM_LIBRARY_NOTE = ("none: no PyTorch call computes this LSTM "
                     "(torch.nn.LSTM / cuDNN has two bias vectors, its own "
                     "gate layout, and no length mask that keeps c)")
# fp32, kernel vs plain: sum order only. hs, cs and the gates are bounded
# by 1 in size (c by the step count) and held absolutely; the backward
# outputs grow with the 100 steps' upstream gradients and are held
# relative to their largest entry; dW by relative L2
LSTM_FWD_TOL = 1e-5
LSTM_GRAD_REL = 1e-5
LSTM_DW_REL = 1e-5
# bench.py:78-82 and :161-173 (bench_lstm): the IMDB LSTM classifier,
# batch 128 x 100 tokens, emb 128, hidden 512, vocab 5147, 2 layers,
# fused_lstm, Adam(0.002), AMP
TEXT_CFG = dict(vocab_size=5147, emb_dim=128, hid_dim=512, num_layers=2)
TEXT_B, TEXT_T, TEXT_LR = 128, 100, 0.002
# 3f's shapes (T, B, D, E, ragged): the flagship's two layers (E 128, the
# embedding; E 512, layer 1's h) and a ragged batch with lengths 0..T
LSTM_SHAPES = {"layer1": (100, 128, 512, 128, False),
               "layer2": (100, 128, 512, 512, False),
               "ragged": (100, 128, 512, 128, True)}
# the classifier past D 512 (5f), where W's slices no longer fit a
# 16-CTA cluster: at hidden 1024 (train_lstm_wide, train_lstm_wide_ragged)
# and at the reference's published hidden 1280 (its benchmark/README.md's
# widest LSTM, batch 128 x 100: train_lstm_1280 and its ragged run) the
# bf16 recurrences take the grid route (W resident across 4 / 5 clusters
# of 16 CTAs); at hidden 640, a D neither W-resident route takes
# (train_lstm_640 and its ragged run), the streaming route
TEXT_WIDE_CFG = dict(TEXT_CFG, hid_dim=1024)
TEXT_1280_CFG = dict(TEXT_CFG, hid_dim=1280)
TEXT_640_CFG = dict(TEXT_CFG, hid_dim=640)
# 3f past D 512: (route, (T, B, D, E), the rows' key suffix, the E of a
# second layer B14/B15 are also held at, or None): the grid route at the
# hidden-1024 model's first layer and the hidden-1280 model's two, the
# streaming route at hidden 640's first
LSTM_WIDE_CHECKS = (
    ("grid", (TEXT_T, TEXT_B, 1024, TEXT_CFG["emb_dim"]), "", None),
    ("grid", (TEXT_T, TEXT_B, 1280, TEXT_CFG["emb_dim"]), "_d1280", 1280),
    ("streaming", (TEXT_T, TEXT_B, 640, TEXT_CFG["emb_dim"]), "", None))
# the fp32 lane's grid route takes D 256, 512 and 768 (3f holds it at
# LSTM_SHAPES' D 512 and prints its plans at all three); its streaming
# route is held at hidden 640's first layer
LSTM_F32_GRID_D = (256, 512, 768)
LSTM_WIDE_CHECKS_FP32 = (
    ("streaming", (TEXT_T, TEXT_B, 640, TEXT_CFG["emb_dim"]), "", None),)
# each row of those checks and the 5f run whose launches it reports (the
# launch name is the row's key without its suffix)
LSTM_WIDE_ROWS = {
    "lstm_proj_fwd_grid": "train_lstm_wide",
    "lstm_proj_bwd_grid": "train_lstm_wide",
    "lstm_fwd_grid": "train_lstm_wide_ragged",
    "lstm_bwd_grid": "train_lstm_wide_ragged",
    "lstm_proj_fwd_grid_d1280": "train_lstm_1280",
    "lstm_proj_bwd_grid_d1280": "train_lstm_1280",
    "lstm_fwd_grid_d1280": "train_lstm_1280_ragged",
    "lstm_bwd_grid_d1280": "train_lstm_1280_ragged",
    "lstm_proj_fwd_stream": "train_lstm_640",
    "lstm_proj_bwd_stream": "train_lstm_640",
    "lstm_fwd_stream": "train_lstm_640_ragged",
    "lstm_bwd_stream": "train_lstm_640_ragged"}
LSTM_WIDE_ROWS_FP32 = {
    "lstm_proj_fwd_stream": "train_lstm_640_fp32",
    "lstm_proj_bwd_stream": "train_lstm_640_fp32",
    "lstm_fwd_stream": "train_lstm_640_composed_fp32",
    "lstm_bwd_stream": "train_lstm_640_composed_fp32"}


def _lstm_case(dev, T, B, D, E, ragged, seed=0):
    """Seeded fp32 LSTM inputs at one shape: the gates x [T, B, 4D] (B10),
    xe [T, B, E], wx, b (B14), w, lens (ragged: 0..T with 0 and T
    present), h0, c0 and the upstream dhs, dcs."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    if ragged:
        lens = torch.randint(0, T + 1, (B, 1), generator=g,
                             device=dev).float()
        lens[0], lens[1] = 0.0, float(T)
    else:
        lens = torch.full((B, 1), float(T), device=dev)
    return {"x": randn(T, B, 4 * D, scale=0.5),
            "w": randn(D, 4 * D, scale=0.05), "lens": lens,
            "h0": randn(B, D, scale=0.3), "c0": randn(B, D, scale=0.3),
            "dhs": randn(T, B, D), "dcs": randn(T, B, D),
            "xe": randn(T, B, E, scale=0.5),
            "wx": randn(E, 4 * D, scale=0.05), "b": randn(4 * D, scale=0.1)}


def _lstm_bound(name, dtype, T, B, D, E, cuda_cores=False):
    """Least time of one call: its inputs read once and outputs written
    once (payload at the lane's width; lens and db fp32) over the HBM
    rate, against its products (2 FLOPs per multiply-add) over the lane's
    peak: bf16 tensor cores; fp32 recurrences (B10, B11's, B14, B15's) at
    their cheapest exact tensor-core form, three tf32 products (3xTF32;
    ``cuda_cores``: the fp32 CUDA cores, the bound they were held to before
    it), the fp32 dW reductions at the CUDA cores."""
    e = 2 if dtype == torch.bfloat16 else 4
    tb, G = T * B, 4 * D
    if name == "lstm_fwd":        # x, W, h0, c0 -> hs, cs, gates
        nbytes = e * (tb * G + D * G + 2 * B * D + 2 * tb * D + tb * G)
        flops = 2.0 * tb * D * G
    elif name == "lstm_bwd":      # gates, cs, W, c0, dhs, dcs -> dx, dh0, dc0
        nbytes = e * (tb * G + tb * D + D * G + B * D + 2 * tb * D
                      + tb * G + 2 * B * D)
        flops = 2.0 * tb * G * D
    elif name == "lstm_dw":       # hprev, dx -> dW
        nbytes = e * (tb * D + tb * G + D * G)
        flops = 2.0 * tb * D * G
    elif name == "lstm_proj_fwd":  # xe, Wx, b, W, h0, c0 -> hs, cs, gates
        nbytes = e * (tb * E + E * G + G + D * G + 2 * B * D + 2 * tb * D
                      + tb * G)
        flops = 2.0 * tb * (E + D) * G
    elif name == "lstm_proj_bwd":  # gates, cs, Wx, W, c0, dhs, dcs ->
        # dxe, dx, dh0, dc0 (+ db fp32)
        nbytes = e * (tb * G + tb * D + E * G + D * G + B * D + 2 * tb * D
                      + tb * E + tb * G + 2 * B * D) + 4 * G
        flops = 2.0 * tb * G * (D + E)
    else:                          # lstm_proj_dw: xe, hprev, dx -> dWx, dW
        nbytes = e * (tb * E + tb * D + tb * G + (E + D) * G)
        flops = 2.0 * tb * (E + D) * G
    nbytes += 4 * B                # lens
    if dtype == torch.bfloat16:
        s_per_flop = 1.0 / H100_BF16_FLOPS
    elif name in LSTM_WIDE_NAMES and not cuda_cores:
        s_per_flop = CHUNK_S_PER_FLOP["float32"]
    else:
        s_per_flop = 1.0 / H100_FP32_FLOPS
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops * s_per_flop * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _pass_bound(name, T, B, D, E, dtype=torch.bfloat16):
    """Least time of the W-resident routes' pre-pass (xe, Wx, b -> xg
    fp32) or post-pass (dx, Wx -> dxe in dx's dtype): bytes over the HBM
    rate against the product at the bf16 tensor-core rate (fp32: three
    tf32 products)."""
    tb, G = T * B, 4 * D
    e = 2 if dtype == torch.bfloat16 else 4
    if name == "lstm_proj_xg":
        nbytes = e * (tb * E + E * G + G) + 4 * tb * G
    else:
        nbytes = e * (tb * G + E * G + tb * E)
    s_per_flop = (1.0 / H100_BF16_FLOPS if dtype == torch.bfloat16
                  else CHUNK_S_PER_FLOP["float32"])
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = 2.0 * tb * E * G * s_per_flop * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def lstm_exchange(fr, dev, flush, plan, D, T=100):
    """The resident recurrences' cluster exchange alone at the plan's
    tile (fused_rnn.lstm_cluster_probe): device µs a step of the
    forward's (h slice to every CTA, one barrier), the backward's
    (reduce-scatter, two barriers) and the barrier alone, each over T
    steps less an empty launch."""
    out = {"T": T, "bb": plan.bb, "tiles": plan.tiles}
    for mode, name in ((0, "fwd"), (1, "bwd"), (2, "barrier")):
        full = _time_ms(lambda: fr.lstm_cluster_probe(
            D, plan.bb, plan.tiles, T, mode, dev), flush, reps=10,
            queue_ahead=True)
        empty = _time_ms(lambda: fr.lstm_cluster_probe(
            D, plan.bb, plan.tiles, 0, mode, dev), flush, reps=10,
            queue_ahead=True)
        out[f"{name}_us_per_step"] = (full - empty) * 1e3 / T
    return out


def _lstm_resident(fr, dev, flush, c, o, T, B, D, E):
    """B14/B15 on a W-resident route at one layer: bf16 on the resident
    route, fp32 on the grid route (``c``'s dtype). The plan, device ms of
    each wrapper (pre-pass + recurrence; recurrence + post-pass) and of
    each recurrence alone (µs a step), and kernel-line records of the
    pre-pass and the post-pass against their plain versions (two launches
    bit-equal), each beside its same-function PyTorch call timed both
    ways (``library_ms``; ``library_device_ms`` with the queue kept
    ahead, as ``device_ms``), the bf16 pre-pass also beside a bf16-out
    addmm (``LSTM_PASS_NOTES``; fp32: ``F32_PASS_NOTES``)."""
    dtype = c["w"].dtype
    bf = dtype == torch.bfloat16
    plan = fr._cluster_plan(dtype, B, D, dev)
    _check(plan.route == ("resident" if bf else "grid"),
           f"lstm {dtype} D {D}: route {plan}")
    xe, wx, b, w, lens, h0, c0 = (c[k] for k in ("xe", "wx", "b", "w",
                                                "lens", "h0", "c0"))
    dhs, dcs = c["dhs"], c["dcs"]
    xg = fr.lstm_proj_xg(xe, wx, b)
    bargs = (o["p_gates"], o["p_cs"], w, lens, h0, c0, dhs, dcs)
    dx = fr.lstm_cluster_bwd(*bargs)[0]
    rec_fwd = _time_ms(lambda: fr.lstm_cluster_fwd(xg, w, lens, h0, c0),
                       flush, reps=10, queue_ahead=True)
    rec_bwd = _time_ms(lambda: fr.lstm_cluster_bwd(*bargs), flush, reps=10,
                       queue_ahead=True)
    out = {"plan": {"route": plan.route, "bb": plan.bb,
                    "clusters": plan.tiles, "cluster_ctas": plan.cluster,
                    "max_clusters": plan.max_clusters,
                    "smem_bytes": plan.smem, "units": plan.units,
                    "group": plan.group},
           "device_ms": {
               "lstm_proj_fwd": _time_ms(
                   lambda: fr.lstm_proj_fwd(xe, wx, b, w, lens, h0, c0),
                   flush, reps=10, queue_ahead=True),
               "lstm_proj_bwd": _time_ms(
                   lambda: fr.lstm_proj_bwd_data(o["p_gates"], o["p_cs"],
                                                 wx, w, lens, h0, c0, dhs,
                                                 dcs),
                   flush, reps=10, queue_ahead=True),
               "recurrence_fwd": rec_fwd, "recurrence_bwd": rec_bwd},
           "us_per_step": {"fwd": rec_fwd * 1e3 / T,
                           "bwd": rec_bwd * 1e3 / T}}
    mm = torch.backends.cuda.matmul
    xe2 = xe.reshape(T * B, E)
    dx2 = dx.reshape(T * B, 4 * D)
    passes = {
        "lstm_proj_xg": (lambda: fr.lstm_proj_xg(xe, wx, b),
                         lambda: fr.lstm_proj_xg_reference(xe, wx, b),
                         (lambda: torch.addmm(b, xe2, wx,
                                              out_dtype=torch.float32))
                         if bf else (lambda: torch.addmm(b, xe2, wx)),
                         XG_REL_TOL if bf else F32_PASS_REL_TOL),
        "lstm_proj_dxe": (lambda: fr.lstm_proj_dxe(dx, wx),
                          lambda: fr.lstm_proj_dxe_reference(dx, wx),
                          lambda: torch.matmul(dx2, wx.t()),
                          DXE_REL_TOL if bf else F32_PASS_REL_TOL)}
    out["passes"] = {}
    for name, (kernel_fn, plain_fn, lib_fn, tol) in passes.items():
        got, again, want = kernel_fn(), kernel_fn(), plain_fn()
        _check(torch.equal(got, again),
               f"{name}: two launches on the same inputs differ")
        err = _max_err(got, want)
        scale = float(want.float().abs().max())
        _check(err <= tol * max(scale, 1e-30),
               f"{name}: {err} from its plain version (max |plain| "
               f"{scale}, tolerance {tol} of it)")
        prev = mm.allow_bf16_reduced_precision_reduction
        mm.allow_bf16_reduced_precision_reduction = False
        try:
            lib_ms = _time_ms(lib_fn, flush)
            lib_device_ms = _time_ms(lib_fn, flush, queue_ahead=True)
        finally:
            mm.allow_bf16_reduced_precision_reduction = prev
        out["passes"][name] = _lane_record(
            f"{name}_bf16" if bf else f"{name}_fp32", LSTM_PASSES[name],
            GRU_SOURCE, err, _time_ms(kernel_fn, flush),
            _time_ms(plain_fn, flush, reps=5), lib_ms,
            _pass_bound(name, T, B, D, E, dtype),
            {"shape": [T, B, D, E], "dtype": str(dtype).replace("torch.", ""),
             "err_is": f"max abs, <= {tol} x max|plain|",
             "device_ms": _time_ms(kernel_fn, flush, queue_ahead=True),
             "library_device_ms": lib_device_ms,
             "library_note": (LSTM_PASS_NOTES if bf
                              else F32_PASS_NOTES)[name],
             "bit_equal_two_launches": True})
    if bf:
        prev = mm.allow_bf16_reduced_precision_reduction
        mm.allow_bf16_reduced_precision_reduction = False
        try:
            out["passes"]["lstm_proj_xg"]["library_bf16_out_device_ms"] = \
                _time_ms(lambda: torch.addmm(b, xe2, wx), flush,
                         queue_ahead=True)
        finally:
            mm.allow_bf16_reduced_precision_reduction = prev
    del xg, dx, dx2
    return out


def _lstm_composed_resident(fr, kernels, dev, flush, lc, got, T, B, D,
                            timed=True, route="resident"):
    """B10 and B11's recurrence on a W-resident route at one shape
    (``lc`` the inputs, bf16 on the resident route or fp32 on the grid
    route, ``got`` ``_lstm_run``'s kernel outputs): the route the plan
    and dtypes give must be ``route``; one call of each counts under its
    wrapper's and its route's name and nothing else; B10 is bit-equal to
    ``lstm_cluster_fwd`` (B14's recurrence) on ``float(x)``, B11's dx,
    dh0, dc0 to ``lstm_cluster_bwd``'s; two launches of each bit-equal.
    ``timed``: device ms of each (the card's queue kept ahead of the
    host) and µs a step, with the plan."""
    x, w, lens, h0, c0 = (lc[k] for k in ("x", "w", "lens", "h0", "c0"))
    plan = fr._cluster_plan(x.dtype, B, D, dev)
    _check(plan.route == route, f"B10/B11 {x.dtype} B {B} D {D}: plan "
           f"{plan}")
    bargs = (got["gates"], got["cs"], w, lens, h0, c0, lc["dhs"], lc["dcs"])
    torch.cuda.synchronize()
    before = dict(kernels.LAUNCHES)
    fwd = fr.lstm_fwd(x, w, lens, h0, c0)
    bwd = fr.lstm_bwd_data(*bargs)
    torch.cuda.synchronize()
    moved = {n: k - before[n] for n, k in kernels.LAUNCHES.items()
             if k != before[n]}
    want = dict.fromkeys(LSTM_COMPOSED[:2]
                         + LSTM_COMPOSED_ROUTE_NAMES[route], 1)
    _check(moved == want, f"B10/B11 {x.dtype}: launches {moved}, want "
           f"{want}")
    ref_b = fr.lstm_cluster_bwd(*bargs)
    same = {"fwd_vs_cluster_fwd_on_float_x": all(
                torch.equal(a, b_) for a, b_ in zip(
                    fwd, fr.lstm_cluster_fwd(x.float(), w, lens, h0, c0))),
            "bwd_vs_cluster_bwd": all(
                torch.equal(a, b_) for a, b_ in zip(
                    bwd, (ref_b[0], ref_b[2], ref_b[3]))),
            "fwd_two_launches": all(torch.equal(a, b_) for a, b_ in zip(
                fwd, fr.lstm_fwd(x, w, lens, h0, c0))),
            "bwd_two_launches": all(torch.equal(a, b_) for a, b_ in zip(
                bwd, fr.lstm_bwd_data(*bargs)))}
    _check(all(same.values()), f"B10/B11 {x.dtype} B {B} D {D}: bits "
           f"{same}")
    _check(all(torch.equal(a, b_) for a, b_ in zip(
        fwd, (got["hs"], got["cs"], got["gates"]))),
        f"B10 {x.dtype}: _lstm_run's launch differs from this one")
    del fwd, bwd, ref_b
    if not timed:
        return {}
    dev_f = _time_ms(lambda: fr.lstm_fwd(x, w, lens, h0, c0), flush,
                     reps=10, queue_ahead=True)
    dev_b = _time_ms(lambda: fr.lstm_bwd_data(*bargs), flush, reps=10,
                     queue_ahead=True)
    plan_rec = {"route": plan.route, "bb": plan.bb, "clusters": plan.tiles,
                "cluster_ctas": plan.cluster,
                "max_clusters": plan.max_clusters, "smem_bytes": plan.smem,
                "units": plan.units, "group": plan.group}
    # the wrapper is the recurrence alone: no pass beside it
    return {name: {"plan": plan_rec, "device_ms": ms,
                   "recurrence_device_ms": ms, "us_per_step": ms * 1e3 / T,
                   "bit_equal": same}
            for name, ms in (("lstm_fwd", dev_f), ("lstm_bwd", dev_b))}


def _rel_max(a, b):
    """max |a - b| over max |b| (floored at 1)."""
    return _max_err(a, b) / max(1.0, float(b.float().abs().max()))


def _lstm_run(fr, c, kernel=True, ref=None):
    """Each LSTM kernel (or, ``kernel=False``, its plain version) on the
    inputs ``c``; a backward reads the saved tensors of ``ref`` (default:
    this run's own forward), so that plain and kernel see the same."""
    x, w, lens, h0, c0 = c["x"], c["w"], c["lens"], c["h0"], c["c0"]
    dhs, dcs, xe, wx, b = c["dhs"], c["dcs"], c["xe"], c["wx"], c["b"]
    k = kernel
    o = {}
    o["hs"], o["cs"], o["gates"] = (fr.lstm_fwd if k else
                                    fr.lstm_fwd_reference)(x, w, lens, h0,
                                                           c0)
    r = ref or o
    o["dx"], o["dh0"], o["dc0"] = (fr.lstm_bwd_data if k else
                                   fr.lstm_bwd_data_reference)(
        r["gates"], r["cs"], w, lens, h0, c0, dhs, dcs)
    o["dw"] = (fr.lstm_dw if k else fr.lstm_dw_reference)(r["hs"], h0,
                                                          r["dx"])
    o["p_hs"], o["p_cs"], o["p_gates"] = (fr.lstm_proj_fwd if k else
                                          fr.lstm_proj_fwd_reference)(
        xe, wx, b, w, lens, h0, c0)
    o["dxe"], o["p_dx"], o["db"], o["p_dh0"], o["p_dc0"] = (
        fr.lstm_proj_bwd_data if k else fr.lstm_proj_bwd_data_reference)(
        r["p_gates"], r["p_cs"], wx, w, lens, h0, c0, dhs, dcs)
    o["dwx"], o["p_dw"] = (fr.lstm_proj_dw if k else
                           fr.lstm_proj_dw_reference)(xe, r["p_hs"], h0,
                                                      r["p_dx"])
    return o


# the outputs of each kernel, and how an output is held: "abs" (max abs,
# fp32 LSTM_FWD_TOL), "rel" (max abs over max |plain|, LSTM_GRAD_REL),
# "l2" (relative L2, LSTM_DW_REL)
LSTM_OUTPUTS = {
    "lstm_fwd": {"hs": "abs", "cs": "abs", "gates": "abs"},
    "lstm_bwd": {"dx": "rel", "dh0": "rel", "dc0": "rel"},
    "lstm_dw": {"dw": "l2"},
    "lstm_proj_fwd": {"p_hs": "abs", "p_cs": "abs", "p_gates": "abs"},
    "lstm_proj_bwd": {"dxe": "rel", "p_dx": "rel", "db": "rel",
                      "p_dh0": "rel", "p_dc0": "rel"},
    "lstm_proj_dw": {"dwx": "l2", "p_dw": "l2"},
}
_LSTM_MEASURE = {"abs": _max_err, "rel": _rel_max, "l2": _rel_l2}


def _lstm_errors(fr, c, dtype):
    """Each LSTM kernel against its plain version on the kernel's own
    inputs, one lane. fp32: each output's error (LSTM_OUTPUTS' measure).
    bf16: each output's error against the fp32 plain result beside the
    bf16 plain version's, as (kernel, plain)."""
    lc = {k: (v.to(dtype) if k != "lens" else v) for k, v in c.items()}
    got = _lstm_run(fr, lc)
    torch.cuda.synchronize()
    plain = _lstm_run(fr, lc, kernel=False, ref=got)
    how = {n: m for outs in LSTM_OUTPUTS.values() for n, m in outs.items()}
    if dtype == torch.float32:
        return {n: _LSTM_MEASURE[m](got[n], plain[n])
                for n, m in how.items()}, got
    fc = {k: v.float() for k, v in lc.items()}
    exact = _lstm_run(fr, fc, kernel=False,
                      ref={k: v.float() for k, v in got.items()})
    return {n: (_LSTM_MEASURE[m](got[n], exact[n]),
                _LSTM_MEASURE[m](plain[n], exact[n]))
            for n, m in how.items()}, got


def check_lstm(fr, kernels, dev, flush, dtype):
    """Phase 3f: B10 (lstm_fwd), B11 (lstm_bwd: the reverse recurrence;
    lstm_dw: the dW reduction), B14 (lstm_proj_fwd) and B15
    (lstm_proj_bwd: the recurrence with dxe and db; lstm_proj_dw: dWx and
    dW), one lane, against their plain versions at the flagship's two
    layer shapes (T 100, B 128, D 512; E 128 and E 512) and a ragged batch
    (lengths 0..100: a zero-length row keeps h0 and c0 and gets no
    gradient). fp32: LSTM_FWD_TOL / LSTM_GRAD_REL / LSTM_DW_REL; bf16: no
    further from the fp32 plain result than 1.5x the bf16 plain version +
    1e-3. Then each kernel timed (L2 flushed) beside its plain version
    and its bound: B10/B11 at T 100, B 128, D 512, B14/B15 at layer 1
    (E 128) and layer 2 (E 512). Returns one kernels-line record per
    kernel."""
    lane = "bf16" if dtype == torch.bfloat16 else "fp32"
    worst = {}
    tol = {"abs": LSTM_FWD_TOL, "rel": LSTM_GRAD_REL, "l2": LSTM_DW_REL}
    how = {n: m for outs in LSTM_OUTPUTS.values() for n, m in outs.items()}
    # the recurrences' W-resident route: bf16 resident, fp32 grid
    route = "resident" if lane == "bf16" else "grid"
    for key, (T, B, D, E, ragged) in LSTM_SHAPES.items():
        c = _lstm_case(dev, T, B, D, E, ragged)
        errs, got = _lstm_errors(fr, c, dtype)
        if ragged:   # the uniform shape: timed below
            _lstm_composed_resident(
                fr, kernels, dev, flush,
                {k: (v if k == "lens" else v.to(dtype))
                 for k, v in c.items()}, got, T, B, D, timed=False,
                route=route)
        for n, e in errs.items():
            if dtype == torch.float32:
                worst[n] = max(worst.get(n, 0.0), e)
                _check(e <= tol[how[n]],
                       f"lstm fp32 {key}: {n} differs by {e}")
            else:
                err, plain_err = e
                w_ = worst.get(n, (0.0, 0.0))
                worst[n] = (max(w_[0], err), max(w_[1], plain_err))
                _check(err <= FLASH_BF16_RATIO * plain_err + 1e-3,
                       f"lstm bf16 {key}: {n} is {err} from fp32, the "
                       f"plain version {plain_err}")
        if ragged:
            zero = c["lens"][:, 0] == 0
            for hs_, cs_, dx_ in (("hs", "cs", "dx"),
                                  ("p_hs", "p_cs", "p_dx")):
                _check(bool((got[hs_][:, zero].float()
                             == c["h0"][zero].to(dtype).float()).all())
                       and bool((got[cs_][:, zero].float()
                                 == c["c0"][zero].to(dtype).float()).all()),
                       f"lstm {lane}: a zero-length row must keep h0, c0")
                _check(not got[dx_][:, zero].any(),
                       f"lstm {lane}: a zero-length row must get no "
                       "gradient")
        del c, got
    recs = {}
    for key in ("layer1", "layer2"):
        T, B, D, E, _r = LSTM_SHAPES[key]
        c = {k: (v.to(dtype) if k != "lens" else v)
             for k, v in _lstm_case(dev, T, B, D, E, False).items()}
        o = _lstm_run(fr, c)
        x, w, lens, h0, c0 = c["x"], c["w"], c["lens"], c["h0"], c["c0"]
        dhs, dcs, xe, wx, b = (c["dhs"], c["dcs"], c["xe"], c["wx"],
                               c["b"])
        calls = {
            "lstm_fwd": (lambda: fr.lstm_fwd(x, w, lens, h0, c0),
                         lambda: fr.lstm_fwd_reference(x, w, lens, h0, c0)),
            "lstm_bwd": (lambda: fr.lstm_bwd_data(
                o["gates"], o["cs"], w, lens, h0, c0, dhs, dcs),
                lambda: fr.lstm_bwd_data_reference(
                    o["gates"], o["cs"], w, lens, h0, c0, dhs, dcs)),
            "lstm_dw": (lambda: fr.lstm_dw(o["hs"], h0, o["dx"]),
                        lambda: fr.lstm_dw_reference(o["hs"], h0, o["dx"])),
            "lstm_proj_fwd": (lambda: fr.lstm_proj_fwd(xe, wx, b, w, lens,
                                                       h0, c0),
                              lambda: fr.lstm_proj_fwd_reference(
                                  xe, wx, b, w, lens, h0, c0)),
            "lstm_proj_bwd": (lambda: fr.lstm_proj_bwd_data(
                o["p_gates"], o["p_cs"], wx, w, lens, h0, c0, dhs, dcs),
                lambda: fr.lstm_proj_bwd_data_reference(
                    o["p_gates"], o["p_cs"], wx, w, lens, h0, c0, dhs,
                    dcs)),
            "lstm_proj_dw": (lambda: fr.lstm_proj_dw(xe, o["p_hs"], h0,
                                                     o["p_dx"]),
                             lambda: fr.lstm_proj_dw_reference(
                                 xe, o["p_hs"], h0, o["p_dx"])),
        }
        # B10/B11 do not depend on E: timed once, at layer 1
        names = LSTM_KERNELS if key == "layer1" else LSTM_PROJ
        # B14/B15 take the W-resident route (bf16: resident, fp32: grid):
        # device ms, µs a step, the plan, and its pre- and post-pass
        # kernels; B10/B11's the same recurrences, with no passes
        res_keys = {"lstm_proj_fwd": "fwd", "lstm_proj_bwd": "bwd"}
        composed_res = (_lstm_composed_resident(fr, kernels, dev, flush, c,
                                                o, T, B, D, route=route)
                        if key == "layer1" else {})
        res = _lstm_resident(fr, dev, flush, c, o, T, B, D, E)
        for pname, prec in res["passes"].items():
            if key == "layer1":
                recs[pname] = prec
            else:
                recs[pname].update({f"layer2_{k}": prec[k] for k in (
                    "ms", "device_ms", "bound_ms", "bound_by",
                    "library_ms", "library_device_ms",
                    "library_bf16_out_device_ms", "max_abs_err",
                    "shape")
                    if k in prec})
        for name in names:
            kernel_fn, plain_fn = calls[name]
            extra = {"library_note": LSTM_LIBRARY_NOTE, "library_ms": None}
            if name in ("lstm_dw", "lstm_proj_dw"):
                extra = _dw_yardstick(name, kernel_fn, _dw_library_call(
                    name, o["p_hs" if "proj" in name else "hs"], h0,
                    o["p_dx" if "proj" in name else "dx"], xe=xe), flush)
            ms = _time_ms(kernel_fn, flush, reps=10)
            bound = _lstm_bound(name, dtype, T, B, D, E)
            if lane == "fp32" and name in LSTM_WIDE_NAMES:
                extra["bound_cuda_core_ms"] = _lstm_bound(
                    name, dtype, T, B, D, E, cuda_cores=True)[0]
            if key == "layer2":
                recs[name].update({"layer2_ms": ms,
                                   "layer2_bound_ms": bound[0],
                                   "layer2_library_ms": extra["library_ms"],
                                   "layer2_shape": [T, B, D, E]})
                if "bound_cuda_core_ms" in extra:
                    recs[name]["layer2_bound_cuda_core_ms"] = \
                        extra["bound_cuda_core_ms"]
                if name in res_keys:
                    recs[name].update({
                        "layer2_device_ms": res["device_ms"][name],
                        "layer2_us_per_step": res["us_per_step"][
                            res_keys[name]]})
                continue
            outs = LSTM_OUTPUTS[name]
            rec = _lane_record(
                name if lane == "fp32" else f"{name}_bf16",
                LSTM_KERNELS[name], GRU_SOURCE,
                max(worst[n] if lane == "fp32" else worst[n][0]
                    for n in outs),
                ms, _time_ms(plain_fn, flush, reps=3),
                extra.pop("library_ms"), bound,
                dict({"shape": [T, B, D] + ([E] if "proj" in name else []),
                      "dtype": str(dtype).replace("torch.", ""),
                      "err_is": {n: outs[n] for n in outs}}, **extra))
            if lane == "bf16":
                rec["err_vs_fp32_and_plain_bf16_err"] = {n: worst[n]
                                                         for n in outs}
            rec.update(composed_res.get(name, {}))
            if name in LSTM_WIDE_NAMES:
                rec["recurrence_bound_ms"] = _recurrence_bound(
                    name, T, B, D, dtype)[0]
            if name in res_keys:
                rec.update({"plan": res["plan"],
                            "device_ms": res["device_ms"][name],
                            "us_per_step": res["us_per_step"][
                                res_keys[name]],
                            "recurrence_device_ms": res["device_ms"][
                                "recurrence_" + res_keys[name]]})
                if name == "lstm_proj_fwd" and route == "resident":
                    rec["exchange"] = lstm_exchange(
                        fr, dev, flush, fr._cluster_plan(dtype, B, D, dev),
                        D, T)
            recs[name] = rec
        del c, o, calls
    kernels.reset_launches()
    return recs


def _recurrence_bound(name, T, B, D, dtype=torch.bfloat16):
    """Least time of a W-resident recurrence alone (what ``us_per_step``
    reads): B10's or B14's forward (x in the lane's dtype / the
    pre-pass's xg fp32, W, h0, c0 -> hs, cs, gates) or B11's or B15's
    reverse (gates, cs, W, c0, dhs, dcs -> dx, dh0, dc0; B15 also db
    fp32): its bytes over the HBM rate against its product (2 T B D 4D
    FLOPs) at the bf16 tensor-core rate (fp32: three tf32 products)."""
    tb, G = T * B, 4 * D
    e = 2 if dtype == torch.bfloat16 else 4
    if name in ("lstm_fwd", "lstm_proj_fwd"):
        nbytes = ((e if name == "lstm_fwd" else 4) * tb * G
                  + e * (D * G + 2 * B * D + 2 * tb * D + tb * G))
    else:
        nbytes = (e * (tb * G + tb * D + D * G + B * D + 2 * tb * D + tb * G
                       + 2 * B * D)
                  + (4 * G if name == "lstm_proj_bwd" else 0))
    s_per_flop = (1.0 / H100_BF16_FLOPS if dtype == torch.bfloat16
                  else CHUNK_S_PER_FLOP["float32"])
    t_bytes = (nbytes + 4 * B) / H100_BYTES_PER_S * 1e3
    t_ops = 2.0 * tb * D * G * s_per_flop * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


LSTM_WIDE_NAMES = ("lstm_fwd", "lstm_bwd", "lstm_proj_fwd", "lstm_proj_bwd")


def check_lstm_wide(fr, kernels, dev, flush, route, shape, sfx="",
                    names=LSTM_WIDE_NAMES, dtype=torch.bfloat16):
    """Phase 3f, the LSTM recurrences' bf16 lane past D 512 (or, with
    ``dtype`` float32, the fp32 lane at a D its grid route does not take)
    at one shape (T, B, D, E) on ``route``: the grid route (W resident
    across a group of 16-CTA clusters) or the streaming one (W, and
    B14/B15's Wx, read from L2 every step). The plan must give ``route``;
    one forward and one backward (from the kernel's own gates) of each of
    ``names`` (B10/B11, B14/B15) count once under its wrapper's name and
    its route's (``_grid``: with B14/B15's pre- and post-pass) and launch
    nothing else; every output no further from the fp32 plain result than
    1.5x the bf16 plain version + 1e-3 (3f's bf16 gate, LSTM_OUTPUTS'
    measures; fp32: within 3f's fp32 tolerances of the plain version). On
    the grid route also: two launches of each bit-equal,
    B10 bit-equal to B14's recurrence (``lstm_cluster_fwd``) on
    float(x), B11's dx, dh0, dc0 to B15's recurrence's, and each
    recurrence's device ms alone beside its bound (``_recurrence_bound``).
    Then each wrapper timed beside its plain version and its bound.
    Returns kernels-line records keyed by the route's launch names +
    ``sfx``."""
    T, B, D, E = shape
    bf = dtype == torch.bfloat16
    lane = "bf16" if bf else "fp32"
    tol = {"abs": LSTM_FWD_TOL, "rel": LSTM_GRAD_REL, "l2": LSTM_DW_REL}
    plan = fr._cluster_plan(dtype, B, D, dev)
    _check(plan.route == route, f"lstm {lane} D {D}: route {plan}, want "
           f"{route}")
    rsfx = LSTM_ROUTE_SUFFIX[route]
    c = {k: (v if k == "lens" else v.to(dtype))
         for k, v in _lstm_case(dev, T, B, D, E, False).items()}
    x, xe, wx, b, w, lens, h0, c0 = (c[k] for k in (
        "x", "xe", "wx", "b", "w", "lens", "h0", "c0"))
    fwd = {"lstm_fwd": (fr.lstm_fwd, (x, w, lens, h0, c0)),
           "lstm_proj_fwd": (fr.lstm_proj_fwd, (xe, wx, b, w, lens, h0, c0))}
    torch.cuda.synchronize()
    before = dict(kernels.LAUNCHES)
    got = {n: k(*a) for n, (k, a) in fwd.items()
           if n in names or n.replace("fwd", "bwd") in names}
    bargs = {n.replace("fwd", "bwd"): (o[2], o[1])
             + ((wx,) if "proj" in n else ()) + (w, lens, h0, c0, c["dhs"],
                                                 c["dcs"])
             for n, o in got.items()}
    kerns = {"lstm_fwd": fr.lstm_fwd, "lstm_bwd": fr.lstm_bwd_data,
             "lstm_proj_fwd": fr.lstm_proj_fwd,
             "lstm_proj_bwd": fr.lstm_proj_bwd_data}
    for n in bargs:
        got[n] = kerns[n](*bargs[n])
    torch.cuda.synchronize()
    moved = {n: k - before[n] for n, k in kernels.LAUNCHES.items()
             if k != before[n]}
    want = dict.fromkeys(names + tuple(n + rsfx for n in names), 1)
    if route == "grid" and "lstm_proj_fwd" in names:
        want.update(lstm_proj_xg=1, lstm_proj_dxe=1)
    _check(moved == want, f"lstm {lane} D {D}: launches {moved}, want "
           f"{want}")
    fargs = {"lstm_fwd": fwd["lstm_fwd"][1],
             "lstm_proj_fwd": fwd["lstm_proj_fwd"][1], **bargs}
    bits = {}
    rec_fns = {}
    if route == "grid" and "lstm_proj_bwd" in names:
        xg = fr.lstm_proj_xg(xe, wx, b)
        pb = bargs["lstm_proj_bwd"]
        rec_fns = {"lstm_proj_fwd": lambda: fr.lstm_cluster_fwd(
                       xg, w, lens, h0, c0),
                   "lstm_proj_bwd": lambda: fr.lstm_cluster_bwd(
                       pb[0], pb[1], *pb[3:])}
    if route == "grid":
        bits = {f"{n}_two_launches": all(torch.equal(a, b_) for a, b_ in zip(
            got[n], kerns[n](*fargs[n]))) for n in names}
        if "lstm_fwd" in names:
            ref_b = fr.lstm_cluster_bwd(*bargs["lstm_bwd"])
            bits["b10_vs_b14_recurrence_on_float_x"] = all(
                torch.equal(a, b_) for a, b_ in zip(
                    got["lstm_fwd"], fr.lstm_cluster_fwd(x.float(), w, lens,
                                                         h0, c0)))
            bits["b11_vs_b15_recurrence"] = all(
                torch.equal(a, b_) for a, b_ in zip(
                    got["lstm_bwd"], (ref_b[0], ref_b[2], ref_b[3])))
            del ref_b
        _check(all(bits.values()), f"lstm {lane} grid D {D}: bits {bits}")

    def f32(args):
        return [a if a is lens else a.float() for a in args]

    refs = {"lstm_fwd": fr.lstm_fwd_reference,
            "lstm_bwd": fr.lstm_bwd_data_reference,
            "lstm_proj_fwd": fr.lstm_proj_fwd_reference,
            "lstm_proj_bwd": fr.lstm_proj_bwd_data_reference}
    plan_rec = plan._asdict()
    recs = {}
    for name in names:
        ref, args = refs[name], fargs[name]
        plain = ref(*args)
        outs = LSTM_OUTPUTS[name]
        gate = {}
        if bf:
            exact = ref(*f32(args))
            for n, g, p, e in zip(outs, got[name], plain, exact):
                gate[n] = (_LSTM_MEASURE[outs[n]](g, e),
                           _LSTM_MEASURE[outs[n]](p, e))
                _check(gate[n][0] <= FLASH_BF16_RATIO * gate[n][1] + 1e-3,
                       f"lstm bf16 {route} D {D} E {E}: {n} is "
                       f"{gate[n][0]} from fp32, the plain version "
                       f"{gate[n][1]}")
            del exact
        else:
            for n, g, p in zip(outs, got[name], plain):
                gate[n] = (_LSTM_MEASURE[outs[n]](g, p), 0.0)
                _check(gate[n][0] <= tol[outs[n]],
                       f"lstm fp32 {route} D {D} E {E}: {n} differs by "
                       f"{gate[n][0]}")
        del plain
        kernel_fn = (lambda k=kerns[name], a=args: k(*a))
        ms = _time_ms(kernel_fn, flush, reps=10)
        device_ms = _time_ms(kernel_fn, flush, reps=10, queue_ahead=True)
        extra = {"shape": [T, B, D] + ([E] if "proj" in name else []),
                 "dtype": str(dtype).replace("torch.", ""),
                 "plan": plan_rec, "device_ms": device_ms,
                 "err_is": dict(outs), "library_note": LSTM_LIBRARY_NOTE}
        if bf:
            extra["err_vs_fp32_and_plain_bf16_err"] = gate
        else:
            extra["bound_cuda_core_ms"] = _lstm_bound(
                name, dtype, T, B, D, E, cuda_cores=True)[0]
        if route == "grid":
            rec_ms = (_time_ms(rec_fns[name], flush, reps=10,
                               queue_ahead=True) if name in rec_fns
                      else device_ms)
            extra.update({"recurrence_device_ms": rec_ms,
                          "us_per_step": rec_ms * 1e3 / T,
                          "recurrence_bound_ms": _recurrence_bound(
                              name, T, B, D, dtype)[0],
                          "bit_equal": bits})
        else:
            extra["us_per_step"] = device_ms * 1e3 / T
        recs[f"{name}{rsfx}{sfx}"] = _lane_record(
            f"{name}{'_bf16' if bf else ''}{rsfx}{sfx}", LSTM_KERNELS[name],
            GRU_SOURCE,
            max(e for e, _p in gate.values()), ms,
            _time_ms(lambda r=ref, a=args: r(*a), flush, reps=3), None,
            _lstm_bound(name, dtype, T, B, D, E), extra)
    del c, got, bargs, fargs, rec_fns
    kernels.reset_launches()
    return recs


def _lstm_route_names(dev, fused_proj, amp, ragged=False,
                      D=TEXT_CFG["hid_dim"]):
    """The launch names a classifier step's two LSTM layers add to, once
    each: the composed route's three (fc + dynamic_lstm, or a ragged
    batch: B10/B11) or B14/B15's, each with those of the route
    ``lstm_cluster_plan`` gives layers of width D (the flagship's) in the
    step's dtype (every tensor of the step's recurrences in it)."""
    from paddle_tpu_torch.kernels import fused_rnn as fr
    dtype = torch.bfloat16 if amp else torch.float32
    route = fr._cluster_plan(dtype, TEXT_B, D, dev).route
    if not fused_proj or ragged:
        return LSTM_COMPOSED + LSTM_COMPOSED_ROUTE_NAMES[route]
    return LSTM_PROJ + LSTM_ROUTE_NAMES[route]


def _text_feeds(dev, n=4, seed=0, ragged=False):
    """bench.py:177-185's feed: ``n`` seeded batches of TEXT_B sequences
    of random word ids (0..5146) and 0/1 labels, on the card. Uniform:
    every sequence TEXT_T long (bench_lstm's LoD); ``ragged``: lengths
    1..TEXT_T (the first 1, the second TEXT_T)."""
    from paddle_tpu_torch.core.lod import LoD, LoDTensor
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        if ragged:
            lens = rng.randint(1, TEXT_T + 1, TEXT_B)
            lens[0], lens[1] = 1, TEXT_T
        else:
            lens = np.full(TEXT_B, TEXT_T)
        words = rng.randint(0, TEXT_CFG["vocab_size"], (int(lens.sum()), 1))
        out.append({"words": LoDTensor(torch.from_numpy(words).to(dev),
                                       LoD.from_lengths([lens.tolist()])),
                    "label": torch.from_numpy(
                        rng.randint(0, 2, (TEXT_B, 1))).to(dev)})
    return out


def _text_grads(tx, params, feed, cfg):
    live = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = tx.loss_fn(live, feed, cfg)
    grads = torch.autograd.grad(loss, list(live.values()))
    return loss.detach(), dict(zip(live, grads))


def check_text_step(tx, fr, kernels, dev, widths=TEXT_CFG,
                    fused_routes=(True, False), fp32_kernels=True):
    """Phase 4f: one full-width flagship training step (bench_lstm's
    config: fused_lstm, batch 128 x 100) in fp32 and under AMP, and the
    composed route (fc + dynamic_lstm) in both, through the LSTM kernels
    (under sync-debug "error": the step must not sync the host; each
    route's three kernels launched twice, one per layer) against the same
    step through their plain versions (``fused_rnn.plain_versions()``),
    from the same params and feed: the loss, and every gradient by
    relative L2 with each leaf's norm floored at S2S_NORM_FLOOR x the
    whole gradient's (fp32: S2S_REL_TOL; AMP: no further from the fp32
    plain gradient than S2S_BF16_RATIO x the AMP plain path's + 1e-2).
    ``widths`` another model's (hidden 1280: the grid route),
    ``fused_routes`` the routes held; with ``fp32_kernels`` False the
    fp32 step runs through the plain versions alone, as the AMP gate's
    reference, and the AMP step is the one held."""
    feed = _text_feeds(dev, n=1, seed=1)[0]
    recs = []
    for fused_proj in fused_routes:
        exact = None
        for amp in (False, True):
            route = _lstm_route_names(dev, fused_proj, amp,
                                      D=widths["hid_dim"])
            torch.cuda.empty_cache()
            cfg = tx.TextConfig(**widths, fused_proj=fused_proj, amp=amp)
            params = tx.init_params(cfg, seed=0, device=dev)
            if not (amp or fp32_kernels):
                with fr.plain_versions():
                    _p_loss, exact = _text_grads(tx, params, feed, cfg)
                floor = S2S_NORM_FLOOR * _grad_norm(exact)
                del params
                continue
            torch.cuda.synchronize()
            kernels.reset_launches()
            torch.cuda.set_sync_debug_mode("error")
            try:
                loss, grads = _text_grads(tx, params, feed, cfg)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            want = dict.fromkeys(kernels.LAUNCHES, 0)
            want.update(dict.fromkeys(route, 2))
            _check(kernels.LAUNCHES == want,
                   f"4f: launches {kernels.LAUNCHES}, want {want}")
            with fr.plain_versions():
                p_loss, p_grads = _text_grads(tx, params, feed, cfg)
            torch.cuda.synchronize()
            kernels.reset_launches()
            _check(bool(torch.isfinite(loss)), f"4f: loss {float(loss)}")
            loss_rel = abs(float(loss) - float(p_loss)) / abs(float(p_loss))
            rec = {"fused_proj": fused_proj, "amp": amp,
                   "hid_dim": widths["hid_dim"],
                   "loss": float(loss), "plain_loss": float(p_loss),
                   "loss_rel_err": loss_rel, "sync_debug": "error"}
            if exact is None:
                exact = p_grads
                floor = S2S_NORM_FLOOR * _grad_norm(exact)
            rels = {}
            for k, g in grads.items():
                _check(bool(torch.isfinite(g).all()),
                       f"4f: non-finite grad {k}")
                rels[k] = _rel_l2(g, p_grads[k], floor)
            worst_k = max(rels, key=rels.get)
            rec.update({"grad_max_rel_l2": rels[worst_k],
                        "grad_worst_leaf": worst_k,
                        "norm_floor": S2S_NORM_FLOOR})
            if not amp:
                _check(loss_rel <= S2S_REL_TOL
                       and rels[worst_k] <= S2S_REL_TOL,
                       f"4f fp32: loss rel {loss_rel}, grad {worst_k} rel "
                       f"{rels[worst_k]} > {S2S_REL_TOL}")
                rec["tol"] = S2S_REL_TOL
            else:
                gate = {}
                for k, g in grads.items():
                    err = _rel_l2(g, exact[k], floor)
                    plain_err = _rel_l2(p_grads[k], exact[k], floor)
                    gate[k] = (err, plain_err)
                    _check(err <= S2S_BF16_RATIO * plain_err + 1e-2,
                           f"4f amp: grad {k} is {err} from the fp32 plain "
                           f"gradient, the AMP plain path {plain_err}")
                rec["grad_rel_l2_vs_fp32_plain_and_plain_amp"] = gate
                _check(loss_rel <= 1e-2, f"4f amp: loss rel {loss_rel}")
            recs.append(rec)
            del params, grads, p_grads
    return recs


def timed_steps(step, params, state, feeds, warmup=3, steps=20):
    """A training loop as 5f times it: ``warmup`` steps, then ``steps``
    in one window with CUDA events between steps and no host syncs, over
    ``feeds`` in turn. Returns ``(params, state, losses, step_ms,
    wall_s)``: every step's loss (a card tensor), each timed step's ms
    and the window's host seconds."""
    losses = []
    for i in range(warmup):
        params, state, loss, _acc = step(params, state,
                                         feeds[i % len(feeds)])
        losses.append(loss)
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    t0 = time.perf_counter()
    for i in range(steps):
        events[i].record()
        params, state, loss, _acc = step(params, state,
                                         feeds[(warmup + i) % len(feeds)])
        losses.append(loss)
    events[steps].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(steps)]
    return params, state, losses, step_ms, wall


def train_text(tx, kernels, dev, key="train_lstm", fused_proj=True,
               amp=True, ragged=False, warmup=3, steps=20, widths=TEXT_CFG):
    """Phase 5f: a flagship training run. ``make_train_step(cfg, "adam",
    0.002)`` at bench_lstm's shape over 4 seeded feeds: ``warmup`` steps,
    then ``steps`` timed in one window (tokens/s: B x T words per step;
    ms per batch p50 from CUDA events between steps, no host syncs;
    model FLOP utilization from bench.py's analytic count, scaled to the
    words of a ragged batch), every loss
    read back once at the end and held finite. The launch counts are
    zeroed just before the first step and read just after the last:
    each kernel of the route (fused_lstm on uniform lengths: B14/B15 on
    the route ``lstm_cluster_plan`` gives ``widths``' hidden size; fc +
    dynamic_lstm, or any ragged batch: B10/B11) runs twice a step."""
    cfg = tx.TextConfig(**widths, fused_proj=fused_proj, amp=amp)
    params = tx.init_params(cfg, seed=0, device=dev)
    opt, step = tx.make_train_step(cfg, "adam", TEXT_LR)
    state = opt.init(params)
    feeds = _text_feeds(dev, ragged=ragged)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()                       # the main path: go
    params, state, losses, step_ms, wall = timed_steps(
        step, params, state, feeds, warmup, steps)
    launches = dict(kernels.LAUNCHES)              # read just after
    n = warmup + steps
    want = dict.fromkeys(kernels.LAUNCHES, 0)
    route = _lstm_route_names(dev, fused_proj, amp, ragged,
                              widths["hid_dim"])
    want.update(dict.fromkeys(route, 2 * n))
    _check(launches == want, f"{key}: launches {launches} over {n} steps, "
           f"want {want}")
    loss_list = torch.stack(losses).cpu().tolist()
    _check(all(np.isfinite(loss_list)), f"{key}: non-finite loss "
           f"{loss_list}")
    words = sum(int(f["words"].lod.total_size()) for f in feeds) / 4
    # bench.py's count is per padded batch; a ragged batch needs only its
    # words' share of it
    flops = tx.train_flops(cfg, TEXT_B, TEXT_T) * words / (TEXT_B * TEXT_T)
    del params, state
    kernels.reset_launches()
    return {key: {
        "amp": amp, "fused_proj": fused_proj, "ragged": ragged,
        "batch": [TEXT_B, TEXT_T], "widths": widths, "lr": TEXT_LR,
        "optimizer": "adam", "warmup_steps": warmup, "timed_steps": steps,
        "wall_s": wall, "tokens_per_s": words * steps / wall,
        "ms_per_batch_p50": float(np.median(step_ms)),
        "ms_per_batch_min": float(np.min(step_ms)),
        "model_tflop_per_step": flops / 1e12,
        "mfu_vs_bf16_peak": flops * steps / wall / H100_BF16_FLOPS,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "loss_first": loss_list[0], "loss_last": loss_list[-1],
        "losses_finite": len(loss_list), "launches": launches}}, launches


def profile_text(tx, dev, fused_proj=True, widths=TEXT_CFG):
    """Where a flagship training step's time goes (AMP; fused_lstm, or
    with ``fused_proj=False`` the composed route, fc + dynamic_lstm:
    ``profile_lstm_composed``; at other ``widths``, the published
    hidden-1280 model's: ``profile_lstm_wide``): three steps under
    ``torch.profiler`` after two warm-up steps, with the LSTM kernels'
    device ms per step by name and the device's busy and idle share."""
    cfg = tx.TextConfig(**widths, fused_proj=fused_proj)
    state = {"p": tx.init_params(cfg, seed=0, device=dev)}
    opt, step = tx.make_train_step(cfg, "adam", TEXT_LR)
    state["o"] = opt.init(state["p"])
    feeds = _text_feeds(dev)

    def call(i):
        state["p"], state["o"], loss, _acc = step(state["p"], state["o"],
                                                  feeds[i % 4])
        return loss.cpu()

    key = ("profile_lstm_wide" if widths is not TEXT_CFG else
           "profile_lstm" if fused_proj else "profile_lstm_composed")
    return {key: dict(
        {"batch": [TEXT_B, TEXT_T], "amp": True, "fused_proj": fused_proj,
         "widths": widths},
        **_profile([lambda i=i: call(i) for i in range(5)],
                   named=("lstm_xg_kernel", "lstm_cluster_fwd_kernel",
                          "lstm_cluster_bwd_kernel", "lstm_grid_fwd_kernel",
                          "lstm_grid_bwd_kernel", "lstm_dxe_kernel",
                          "lstm_fwd_kernel", "lstm_bwd_kernel",
                          "dw_wgmma", "sum_partials")))}


# 6a: bench.py:1157-1168's MNIST MLP (784-128-64-10, batch 64,
# Adam(0.01)) through the port's layers DSL and Executor
MLP_B, MLP_DIM, MLP_LR = 64, 784, 0.01
MLP_TOL = 1e-5                  # fp32, card vs CPU: sum order only
# Adam's first update of an element is lr * g / (|g| + 3.2e-7): where
# that first nonzero gradient is a near-cancelled sum (|g| < 1e-6), the
# ~1e-9 by which two fp32 sum orders round it moves the update by up to
# lr * 1e-9 / 3.2e-7 = 3e-5; such elements are held to 1e-4
ADAM_EPS_REGIME, ADAM_EPS_REGIME_TOL = 1e-6, 1e-4
TEXT_EXEC_RTOL = 1e-4           # Executor vs make_train_step, per-step loss


def _mlp_program(minimize=True):
    """``models.mnist.mlp`` with ``Adam(MLP_LR).minimize`` (or, without
    ``minimize``, its forward alone, the same names) in fresh programs:
    (main, startup, loss, the @GRAD names, the op count a step: the
    registry ops of the main block)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.framework import program as prog
    from paddle_tpu_torch.models import mnist
    prog._name_counters.clear()
    main, start = pt.Program(), pt.Program()
    with pt.program_guard(main, start):
        img = pt.layers.data("img", [MLP_DIM])
        label = pt.layers.data("label", [1], dtype="int64")
        _, loss, _ = mnist.mlp(img, label)
        if minimize:
            pt.optimizer.Adam(MLP_LR).minimize(loss)
    grads = [p.name + "@GRAD" for p in main.global_block().all_parameters()]
    n_ops = sum(op.type != "backward" for op in main.global_block().ops)
    return main, start, loss, grads, n_ops


def _mlp_feeds(n, seed=0):
    """``n`` host batches with a class signal, numpy arrays as a user
    feeds them: the layout of the JAX package's ``datasets/mnist.py``
    synthetic surrogate (a class prototype plus noise, clipped to [-1,
    1]) with a weaker signal (prototypes randn x 0.1 under noise randn x
    1.0, where the surrogate's 0.8 / 0.5 drives the loss to 0 within
    three Adam steps): 23 steps take the loss from 2.6 to about 1.6."""
    protos = np.random.RandomState(0xC0FFEE).randn(10, MLP_DIM) * 0.1
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        label = rng.randint(0, 10, (MLP_B, 1)).astype(np.int64)
        img = protos[label[:, 0]] + rng.randn(MLP_B, MLP_DIM)
        out.append({"img": np.clip(img, -1, 1).astype(np.float32),
                    "label": label})
    return out


def _scope_copy(scope, names, device):
    """A new Scope holding copies of ``names`` on ``device``."""
    from paddle_tpu_torch.core.scope import Scope
    out = Scope()
    for n in names:
        out.set_tensor(n, scope.find_var(n).array.detach().to(device,
                                                              copy=True))
    return out


def exec_mlp(dev, warmup=3, steps=20, k=8):
    """Phase 6a (``exec_mlp``): the MNIST MLP at bench.py's widths on
    ``CUDAPlace(0)``: the startup program (seed 0), then ``warmup`` +
    ``steps`` timed steps (CUDA events between steps, no host reads; the
    host's enqueue time per step and per op, and the same for the
    forward alone), every loss finite and the last below the first;
    then, from the state they leave, 5 steps held
    against the same 5 on ``CPUPlace`` from a copy of it (losses and
    every persistable within MLP_TOL, Adam's eps-regime elements within
    ADAM_EPS_REGIME_TOL); one step under sync-debug "error" (no host
    sync); ``run_multi(K=k)`` against k ``run``s from one state (losses
    and every persistable bit-equal); three steps under
    ``torch.profiler``."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.scope import Scope
    main, start, loss, grads, n_ops = _mlp_program()
    exe = pt.Executor(pt.CUDAPlace(0))
    scope = Scope()
    start.random_seed = 0
    exe.run(start, scope=scope)
    names = sorted(scope.local_var_names())
    feeds = _mlp_feeds(warmup + steps + 6 + k)
    # the timed window, from the startup state
    losses = []
    for f in feeds[:warmup]:
        losses.append(exe.run(main, feed=f, fetch_list=[loss], scope=scope,
                              return_numpy=False)[0].array)
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    t0 = time.perf_counter()
    for i, f in enumerate(feeds[warmup:warmup + steps]):
        events[i].record()
        losses.append(exe.run(main, feed=f, fetch_list=[loss], scope=scope,
                              return_numpy=False)[0].array)
    events[steps].record()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(steps)]
    loss_list = torch.stack(losses).cpu().tolist()
    _check(all(np.isfinite(loss_list)), f"exec_mlp: losses {loss_list}")
    _check(loss_list[-1] < loss_list[0],
           f"exec_mlp: last loss {loss_list[-1]} not below the first "
           f"{loss_list[0]}")
    # the forward alone (its program, the same scope): the host's share
    # of the backward segment and the updates is the difference
    fwd, _, fwd_loss, _, fwd_ops = _mlp_program(minimize=False)
    for f in feeds[:warmup]:
        exe.run(fwd, feed=f, fetch_list=[fwd_loss], scope=scope,
                return_numpy=False)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for f in feeds[warmup:warmup + steps]:
        exe.run(fwd, feed=f, fetch_list=[fwd_loss], scope=scope,
                return_numpy=False)
    fwd_host_ms = (time.perf_counter() - t1) * 1e3 / steps
    torch.cuda.synchronize()
    feeds = feeds[warmup + steps:]
    # card == CPU over 5 steps from the same state
    cpu_scope = _scope_copy(scope, names, "cpu")
    cpu_exe = pt.Executor(pt.CPUPlace())
    opening, loss_errs = {}, []
    for f in feeds[:5]:
        got = exe.run(main, feed=f, fetch_list=[loss], scope=scope)
        want = cpu_exe.run(main, feed=f, fetch_list=[loss] + grads,
                           scope=cpu_scope)
        for g, v in zip(grads, want[1:]):
            seen = opening.get(g)
            opening[g] = v if seen is None else np.where(seen != 0, seen, v)
        loss_errs.append(abs(float(got[0]) - float(want[0])))
        _check(loss_errs[-1] <= MLP_TOL * (1 + abs(float(want[0]))),
               f"exec_mlp: card loss {float(got[0])} vs CPU {float(want[0])}")
    worst, regime = 0.0, 0
    for n in names:
        a = scope.find_var(n).array.cpu().numpy()
        b = cpu_scope.find_var(n).array.numpy()
        g = np.abs(opening.get(n + "@GRAD", np.zeros(1)))
        tiny = np.broadcast_to((g > 0) & (g < ADAM_EPS_REGIME), a.shape)
        regime += int(tiny.sum())
        err = np.abs(a - b)
        _check(bool((err[tiny] <= ADAM_EPS_REGIME_TOL).all()),
               f"exec_mlp: {n} eps-regime elements off the CPU by "
               f"{err[tiny].max(initial=0.0)}")
        bad = (err > MLP_TOL * (1 + np.abs(b))) & ~tiny
        worst = max(worst, float(err[~tiny].max(initial=0.0)))
        _check(not bad.any(), f"exec_mlp: {n} off the CPU by {worst} at "
               f"{int(bad.sum())} elements")
    # one step with no host sync
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        exe.run(main, feed=feeds[5], fetch_list=[loss], scope=scope,
                return_numpy=False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    # run_multi(K) == K runs, from one state
    a, b = _scope_copy(scope, names, dev), _scope_copy(scope, names, dev)
    ea, eb = pt.Executor(pt.CUDAPlace(0)), pt.Executor(pt.CUDAPlace(0))
    one = [ea.run(main, feed=f, fetch_list=[loss], scope=a,
                  return_numpy=False)[0].array for f in feeds[6:]]
    multi = eb.run_multi(main, feeds[6:], fetch_list=[loss], scope=b,
                         return_numpy=False)[0]
    torch.cuda.synchronize()
    _check(torch.equal(multi, torch.stack(one)),
           f"exec_mlp: run_multi losses {multi.tolist()} vs runs "
           f"{torch.stack(one).tolist()}")
    for n in names:
        _check(torch.equal(a.find_var(n).array, b.find_var(n).array),
               f"exec_mlp: run_multi {n} differs from {k} runs")
    _check(ea._step_ctr == eb._step_ctr == k,
           f"exec_mlp: step counters {ea._step_ctr} / {eb._step_ctr}")
    prof = _profile([lambda f=f: exe.run(main, feed=f, fetch_list=[loss],
                                         scope=scope)
                     for f in feeds[:5]])
    host_ms = host_s * 1e3 / steps
    return {"exec_mlp": {
        "widths": [MLP_DIM, 128, 64, 10], "batch": MLP_B,
        "optimizer": f"adam {MLP_LR}", "place": "CUDAPlace(0)",
        "warmup_steps": warmup, "timed_steps": steps,
        "ms_per_step_p50": float(np.median(step_ms)),
        "ms_per_step_min": float(np.min(step_ms)),
        "wall_ms_per_step": wall * 1e3 / steps,
        "host_enqueue_ms_per_step": host_ms, "ops_per_step": n_ops,
        "host_us_per_op": host_ms * 1e3 / n_ops,
        "forward_only_host_enqueue_ms_per_step": fwd_host_ms,
        "forward_ops_per_step": fwd_ops,
        "forward_host_us_per_op": fwd_host_ms * 1e3 / fwd_ops,
        "loss_first": loss_list[0], "loss_last": loss_list[-1],
        "losses_finite": len(loss_list),
        "card_vs_cpu_steps": 5, "card_vs_cpu_loss_max_abs_err":
        max(loss_errs), "card_vs_cpu_persistable_max_abs_err": worst,
        "adam_eps_regime_elements": regime, "tol": MLP_TOL,
        "sync_debug": "error", "run_multi_k": k,
        "run_multi_equal_runs": True, "profile": prof}}


def exec_text(tx, kernels, dev, train_lstm_ms, warmup=3, steps=20,
              ragged_warmup=1, ragged_steps=3):
    """Phase 6b (``exec_text``): ``text.build_program(TextConfig())`` (the
    classifier at bench.py's widths, Adam 0.002) through
    ``Executor(CUDAPlace(0), amp=True)``: the startup program (seed 0),
    then ``warmup`` + ``steps`` steps at uniform lengths, timed as 5f
    times the hand-written list (ms a batch p50 beside ``train_lstm``'s),
    and ``ragged_warmup`` + ``ragged_steps`` on ragged LoD from the same
    start. The launch counts are zeroed just before each run and read
    just after: B14/B15 (uniform) and B10/B11 (ragged) on their routes,
    twice a step each. Every step's loss equals ``make_train_step(cfg,
    "adam", TEXT_LR)``'s from the same parameters and feeds within
    TEXT_EXEC_RTOL (the same ops on the same kernels; the updates'
    arithmetic in another order). Then five uniform steps, the last
    three under ``torch.profiler``."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.scope import Scope
    cfg = tx.TextConfig(**TEXT_CFG)
    main, start = tx.build_program(cfg)   # Adam(TEXT_LR)
    names = [n for n, _, _ in tx.param_specs(cfg)]
    rec = {"batch": [TEXT_B, TEXT_T], "widths": TEXT_CFG, "amp": True,
           "optimizer": f"adam {TEXT_LR}", "place": "CUDAPlace(0)",
           "train_lstm_ms_per_batch_p50": train_lstm_ms}
    for key, ragged, n_warm, n_timed in (("uniform", False, warmup, steps),
                                         ("ragged", True, ragged_warmup,
                                          ragged_steps)):
        exe = pt.Executor(pt.CUDAPlace(0), amp=True)
        scope = Scope()
        start.random_seed = 0
        exe.run(start, scope=scope)
        params = {n: scope.find_var(n).array.clone() for n in names}
        feeds = _text_feeds(dev, ragged=ragged)
        n = n_warm + n_timed
        torch.cuda.synchronize()
        kernels.reset_launches()                   # the main path: go
        losses = []
        for i in range(n_warm):
            losses.append(exe.run(main, feed=feeds[i % 4],
                                  fetch_list=[tx.LOSS], scope=scope,
                                  return_numpy=False)[0].array)
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(n_timed + 1)]
        for i in range(n_timed):
            events[i].record()
            losses.append(exe.run(main, feed=feeds[(n_warm + i) % 4],
                                  fetch_list=[tx.LOSS], scope=scope,
                                  return_numpy=False)[0].array)
        events[n_timed].record()
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)          # read just after
        want = dict.fromkeys(kernels.LAUNCHES, 0)
        want.update(dict.fromkeys(_lstm_route_names(dev, True, True,
                                                     ragged), 2 * n))
        _check(launches == want, f"exec_text {key}: launches {launches} "
               f"over {n} steps, want {want}")
        step_ms = [events[i].elapsed_time(events[i + 1])
                   for i in range(n_timed)]
        # the hand-written list's step from the same parameters
        opt, step = tx.make_train_step(cfg, "adam", TEXT_LR)
        state = opt.init(params)
        ref = []
        for i in range(n):
            params, state, loss, _acc = step(params, state, feeds[i % 4])
            ref.append(loss)
        kernels.reset_launches()
        got = torch.stack(losses).cpu().tolist()
        ref = torch.stack(ref).cpu().tolist()
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, ref))
        _check(all(np.isfinite(got)) and rel <= TEXT_EXEC_RTOL,
               f"exec_text {key}: losses {got} vs make_train_step {ref}")
        if not ragged:   # where the uniform step's time goes
            rec["profile"] = _profile(
                [lambda i=i: exe.run(main, feed=feeds[i % 4],
                                     fetch_list=[tx.LOSS], scope=scope)
                 for i in range(5)],
                named=("lstm_xg_kernel", "lstm_cluster_fwd_kernel",
                       "lstm_cluster_bwd_kernel", "lstm_dxe_kernel",
                       "dw_wgmma"))
        rec[key] = {"steps": n, "launches": {k: v for k, v in
                                             launches.items() if v},
                    "loss_first": got[0], "loss_last": got[-1],
                    "loss_max_rel_err_vs_make_train_step": rel,
                    "rtol": TEXT_EXEC_RTOL,
                    "ms_per_batch_p50": float(np.median(step_ms)),
                    "ms_per_batch_min": float(np.min(step_ms))}
        del exe, scope, params, state
    rec["ms_per_batch_vs_train_lstm"] = (rec["uniform"]["ms_per_batch_p50"]
                                         / train_lstm_ms)
    return {"exec_text": rec}


# 6c: bench_lstm's flagship through the training entry point
TRAINER_BOUNDS = (25, 50, 75, 100)      # bench_lstm_bucketed's buckets


def _flagship_net(seq_lens=False):
    """``lstm_benchmark_net(fused_proj=True)`` at TEXT_CFG's widths, built
    by the layers DSL in fresh default programs and a fresh global scope:
    (its feed variables, loss, accuracy)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.scope import reset_global_scope
    from paddle_tpu_torch.framework import program as prog
    from paddle_tpu_torch.models import text as tx
    prog.fresh_programs()
    reset_global_scope()
    words = pt.layers.data("words", [1], dtype="int64", lod_level=1)
    label = pt.layers.data("label", [1], dtype="int64")
    feeds = [words, label]
    sl = None
    if seq_lens:
        sl = pt.layers.data("seq_lens", [], dtype="int32")
        feeds.append(sl)
    _, loss, acc = tx.lstm_benchmark_net(
        words, label, input_dim=TEXT_CFG["vocab_size"],
        emb_dim=TEXT_CFG["emb_dim"], hid_dim=TEXT_CFG["hid_dim"],
        num_layers=TEXT_CFG["num_layers"], seq_lens=sl, fused_proj=True)
    return feeds, loss, acc


def _lstm_trainer(state=None, seq_lens=False):
    """``_flagship_net`` in a ``Trainer`` with ``Adam(TEXT_LR)`` on
    ``Executor(CUDAPlace(0), amp=True)``; its startup state ``state``
    (name -> card tensor, copied) or, with None, its startup program's
    (seed 0)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.scope import global_scope
    feeds, loss, acc = _flagship_net(seq_lens)
    tr = pt.Trainer(cost=loss, optimizer=pt.optimizer.Adam(TEXT_LR),
                    feed_list=feeds, metrics=[acc],
                    executor=pt.Executor(pt.CUDAPlace(0), amp=True))
    if state is None:
        tr.startup_program.random_seed = 0
        tr._init_params()
    else:
        for n, v in state.items():
            global_scope().set_tensor(n, v.clone())
        tr._initialized = True
    return tr


def _uniform_batches(n, seed):
    """A reader creator: ``reader.batch`` of a seeded sample generator,
    ``n`` batches of TEXT_B (TEXT_T word ids, 0/1 label) samples."""
    import paddle_tpu_torch as pt

    def samples():
        rng = np.random.RandomState(seed)
        for _ in range(n * TEXT_B):
            yield (rng.randint(0, TEXT_CFG["vocab_size"], TEXT_T).tolist(),
                   int(rng.randint(0, 2)))
    return pt.reader.batch(samples, TEXT_B)


def _trainer_run(trainer, reader, kernels, want_names, **kw):
    """One ``trainer.train`` pass over ``reader``, the launch counts
    zeroed just before and read just after: (per-batch costs, the
    EndIteration host times after the start, the launches), each of
    ``want_names`` launched exactly twice a batch and nothing else."""
    import paddle_tpu_torch as pt
    costs, stamps = [], []

    def handler(e):
        if isinstance(e, pt.event.EndIteration):
            stamps.append(time.perf_counter())
            costs.append(e.cost)

    torch.cuda.synchronize()
    kernels.reset_launches()                     # the main path: go
    t0 = time.perf_counter()
    trainer.train(reader, num_passes=1, event_handler=handler, log_period=0,
                  **kw)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)            # read just after
    kernels.reset_launches()
    want = dict.fromkeys(kernels.LAUNCHES, 0)
    want.update(dict.fromkeys(want_names, 2 * len(costs)))
    _check(launches == want, f"trainer_lstm: launches {launches} over "
           f"{len(costs)} batches, want {want}")
    _check(len(costs) > 0 and all(np.isfinite(costs)),
           f"trainer_lstm: costs {costs}")
    return costs, [t0] + stamps, {k: v for k, v in launches.items() if v}


def _batch_ms(stamps, skip, per=1):
    """ms a batch: the p50 of the gaps between result times after the
    first ``skip`` gaps (``per`` results a gap, a K-group's)."""
    gaps = np.diff(stamps[::per])[skip:] * 1e3
    return float(np.median(gaps)) / per


def _trainer_step_vs_plain(fr, tr, state, batch, dev):
    """One step of the Trainer's program from ``state`` on the kernels,
    and the same step through their plain versions, AMP and fp32 (the
    fp32 plain gradient is the reference): 4f's AMP gate on the loss
    and on every gradient (relative L2, each leaf floored)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.scope import Scope
    main = tr.main_program
    params = [p.name for p in main.global_block().all_parameters()]
    feed = tr.feeder.feed(batch)
    out = {}
    for key, amp, plain in (("kernels", True, False), ("plain", True, True),
                            ("fp32_plain", False, True)):
        scope = Scope()
        for n, v in state.items():
            scope.set_tensor(n, v.clone())
        exe = pt.Executor(pt.CUDAPlace(0), amp=amp)
        with fr.plain_versions() if plain else contextlib.nullcontext():
            got = exe.run(main, feed=feed, scope=scope, fetch_list=[
                tr.cost] + [n + "@GRAD" for n in params],
                return_numpy=False)
        out[key] = (float(got[0].array), dict(zip(params, (
            g.array for g in got[1:]))))
        del scope, exe
    loss, grads = out["kernels"]
    p_loss, p_grads = out["plain"]
    exact = out["fp32_plain"][1]
    floor = S2S_NORM_FLOOR * _grad_norm(exact)
    loss_rel = abs(loss - p_loss) / abs(p_loss)
    _check(loss_rel <= 1e-2, f"trainer_lstm: step loss rel {loss_rel}")
    gate = {}
    for k, g in grads.items():
        _check(bool(torch.isfinite(g).all()), f"trainer_lstm: grad {k}")
        err = _rel_l2(g, exact[k], floor)
        plain_err = _rel_l2(p_grads[k], exact[k], floor)
        gate[k] = (err, plain_err)
        _check(err <= S2S_BF16_RATIO * plain_err + 1e-2,
               f"trainer_lstm: grad {k} is {err} from the fp32 plain "
               f"gradient, the AMP plain path {plain_err}")
    return {"loss": loss, "plain_loss": p_loss, "loss_rel_err": loss_rel,
            "grad_rel_l2_vs_fp32_plain_and_plain_amp": gate}


def trainer_lstm(tx, fr, kernels, dev, train_lstm_ms, exec_text_ms,
                 warmup=3, steps=20, k=8, groups=3):
    """Phase 6c (``trainer_lstm``), as the module docstring sets out."""
    import itertools

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.scope import (Scope, global_scope,
                                             reset_global_scope)
    from paddle_tpu_torch.framework import program as prog
    rec = {"batch": [TEXT_B, TEXT_T], "widths": TEXT_CFG, "amp": True,
           "optimizer": f"adam {TEXT_LR}", "place": "CUDAPlace(0)",
           "train_lstm_ms_per_batch_p50": train_lstm_ms,
           "exec_text_ms_per_batch_p50": exec_text_ms}
    uniform = _lstm_route_names(dev, True, True)
    ragged = _lstm_route_names(dev, True, True, ragged=True)
    tr = _lstm_trainer()
    state = {n: global_scope().find_var(n).array.clone()
             for n in global_scope().local_var_names()}
    # the DSL's program is build_program's, op for op and name for name
    main, start = tr.main_program, tr.startup_program
    prog._name_counters.clear()
    b_main, b_start = tx.build_program(tx.TextConfig(**TEXT_CFG))
    ops = [(o.type, o.inputs, o.outputs, o.attrs)
           for o in main.global_block().ops]
    _check(ops == [(o.type, o.inputs, o.outputs, o.attrs)
                   for o in b_main.global_block().ops]
           and main.fingerprint() == b_main.fingerprint()
           and start.fingerprint() == b_start.fingerprint(),
           "trainer_lstm: the DSL's program is not build_program's")
    rec.update({"fingerprint": main.fingerprint(), "ops": len(ops),
                "program_equals_build_program": True})
    # K = 1: 3 + 20 batches
    reader = _uniform_batches(warmup + steps, seed=3)
    costs, stamps, launches = _trainer_run(tr, reader, kernels, uniform)
    rec["k1"] = {"batches": len(costs), "launches": launches,
                 "ms_per_batch_p50": _batch_ms(stamps, warmup),
                 "cost_first": costs[0], "cost_last": costs[-1]}
    # every cost bit-equal to build_program's through the Executor
    scope = Scope()
    for n, v in state.items():
        scope.set_tensor(n, v.clone())
    exe = pt.Executor(pt.CUDAPlace(0), amp=True)
    want = [float(exe.run(b_main, feed=tr.feeder.feed(b), scope=scope,
                          fetch_list=[tx.LOSS])[0]) for b in reader()]
    kernels.reset_launches()
    _check(costs == want, f"trainer_lstm: Trainer costs {costs[:3]} vs "
           f"build_program's {want[:3]}")
    rec["k1"]["costs_bit_equal_build_program"] = True
    del scope, exe
    # one step on the kernels against the plain versions
    first = next(iter(reader()))
    rec["step_vs_plain"] = _trainer_step_vs_plain(fr, tr, state, first, dev)
    # double_buffer, then steps_per_call=k, from the same state
    tr = _lstm_trainer(state)
    db, stamps, _ = _trainer_run(tr, reader, kernels, uniform,
                                 double_buffer=True)
    _check(db == costs, f"trainer_lstm: double_buffer costs {db[:3]} vs "
           f"{costs[:3]}")
    rec["double_buffer"] = {"batches": len(db), "costs_equal_k1": True,
                            "ms_per_batch_p50": _batch_ms(stamps, warmup)}
    tr = _lstm_trainer(state)
    kc, stamps, _ = _trainer_run(tr, _uniform_batches(k * groups, seed=4),
                                 kernels, uniform, steps_per_call=k)
    _check(len(kc) == k * groups, f"trainer_lstm: {len(kc)} K={k} results")
    rec[f"k{k}"] = {"batches": len(kc), "groups": groups,
                    "ms_per_batch_p50": _batch_ms(stamps, 1, per=k),
                    "cost_first": kc[0], "cost_last": kc[-1]}
    # device_buffered alone makes no host sync
    items = [tr.feeder.feed(b) for b in itertools.islice(reader(), 3)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = list(pt.reader.device_buffered(lambda: iter(items), 2)())
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    _check(len(got) == 3 and all(g["label"].device == dev
                                 and g["words"].array.device == dev
                                 for g in got),
           "trainer_lstm: device_buffered items not on the card")
    rec["device_buffered_sync_debug"] = "error"
    # one pass over the imdb surrogate: ragged, B10/B11
    tr = _lstm_trainer(state)
    imdb = pt.reader.batch(pt.datasets.imdb.train(), TEXT_B, drop_last=True)
    ic, stamps, launches = _trainer_run(tr, imdb, kernels, ragged)
    rec["imdb_ragged"] = {"batches": len(ic), "launches": launches,
                          "ms_per_batch_p50": _batch_ms(stamps, 1),
                          "cost_first": ic[0], "cost_last": ic[-1]}
    # a bucketed pass: padded to the bucket bound, runtime seq_lens
    tr = _lstm_trainer(state, seq_lens=True)
    full = pt.reader.bucket_by_sequence_length(
        pt.reader.map_readers(lambda s: (s[0], s[1], len(s[0])),
                              pt.datasets.imdb.train()),
        TRAINER_BOUNDS, TEXT_B)
    bc, stamps, launches = _trainer_run(
        tr, lambda: (b for b in full() if len(b) == TEXT_B), kernels,
        uniform)
    rec["bucketed"] = {"batches": len(bc), "bounds": TRAINER_BOUNDS,
                       "launches": launches,
                       "ms_per_batch_p50": _batch_ms(stamps, 1),
                       "cost_first": bc[0], "cost_last": bc[-1]}
    # five Trainer steps (the last three profiled)
    tr = _lstm_trainer(state)
    batches = list(itertools.islice(reader(), 5))
    rec["profile"] = _profile(
        [lambda b=b: tr.train_one_batch(b) for b in batches],
        named=("lstm_xg_kernel", "lstm_cluster_fwd_kernel",
               "lstm_cluster_bwd_kernel", "lstm_dxe_kernel", "dw_wgmma"))
    kernels.reset_launches()
    k1 = rec["k1"]["ms_per_batch_p50"]
    rec["k1_ms_per_batch_vs_exec_text"] = k1 / exec_text_ms
    rec["k1_ms_per_batch_vs_train_lstm"] = k1 / train_lstm_ms
    _say(f"trainer_lstm: ms a batch K=1 {k1:.2f}, double_buffer "
         f"{rec['double_buffer']['ms_per_batch_p50']:.2f}, K={k} "
         f"{rec[f'k{k}']['ms_per_batch_p50']:.2f}, imdb ragged "
         f"{rec['imdb_ragged']['ms_per_batch_p50']:.2f}, bucketed "
         f"{rec['bucketed']['ms_per_batch_p50']:.2f}; exec_text "
         f"{exec_text_ms:.2f}, train_lstm {train_lstm_ms:.2f}; idle share "
         f"{rec['profile']['device_idle_share']}")
    del tr, state
    reset_global_scope()
    return {"trainer_lstm": rec}


# 6d: a dynamic_gru program at the seq2seq encoder's shape
GRU_PROG_CLASSES = 2


def _gru_program():
    """``embedding -> fc(3 x hidden) -> dynamic_gru(hidden) ->
    sequence_pool("last") -> fc -> softmax cross entropy`` at S2S_CFG's
    source vocab, embedding and hidden widths, ``Adam(S2S_LR)``, built by
    the layers DSL in fresh programs: (main, startup, loss)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.framework import program as prog
    main, start = prog.fresh_programs()
    words = pt.layers.data("words", [1], dtype="int64", lod_level=1)
    label = pt.layers.data("label", [1], dtype="int64")
    emb = pt.layers.embedding(words, size=[S2S_CFG["src_vocab"],
                                           S2S_CFG["emb_dim"]])
    H = S2S_CFG["hidden_dim"]
    hidden = pt.layers.dynamic_gru(pt.layers.fc(emb, 3 * H), H)
    logits = pt.layers.fc(pt.layers.sequence_pool(hidden, "last"),
                          GRU_PROG_CLASSES)
    loss = pt.layers.mean(pt.layers.softmax_with_cross_entropy(logits,
                                                               label))
    pt.optimizer.Adam(S2S_LR).minimize(loss)
    return main, start, loss


def _gru_program_feeds(n, seed=0):
    """``n`` host feeds of S2S_B sequences: the first half S2S_S long,
    the second half 1..S2S_S (seeded), random ids and 0/1 labels."""
    from paddle_tpu_torch.core.lod import LoD, LoDTensor
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        lens = np.full(S2S_B, S2S_S)
        lens[S2S_B // 2:] = rng.randint(1, S2S_S + 1, S2S_B - S2S_B // 2)
        words = rng.randint(0, S2S_CFG["src_vocab"], (int(lens.sum()), 1))
        out.append({"words": LoDTensor(words, LoD.from_lengths(
            [lens.tolist()])), "label": rng.randint(0, GRU_PROG_CLASSES,
                                                    (S2S_B, 1))})
    return out


def exec_gru(fr, kernels, dev, warmup=1, steps=5):
    """Phase 6d (``exec_gru``): the program of ``_gru_program`` through
    ``Executor(CUDAPlace(0))`` under AMP and in fp32, from its startup
    program (seed 0): ``warmup`` + ``steps`` steps, timed by CUDA events,
    the launch counts zeroed just before and read just after (each GRU
    kernel once a step, the recurrences also under their route's name),
    then the same steps from the same state through the plain versions:
    every step's loss within the 4e gates (relative S2S_REL_TOL in fp32,
    1e-2 in bf16); then five steps, the last three under
    ``torch.profiler``."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.scope import Scope
    recs = {}
    for amp in (True, False):
        dtype = torch.bfloat16 if amp else torch.float32
        key = "bf16" if amp else "fp32"
        main, start, loss = _gru_program()
        route = fr._cluster_plan(dtype, S2S_B, S2S_CFG["hidden_dim"], dev,
                                 ng=3).route
        want_route = _gru_route_wanted(dtype, S2S_CFG["hidden_dim"])
        _check(route == want_route, f"exec_gru {key}: GRU route {route}, "
               f"want {want_route}")
        exe = pt.Executor(pt.CUDAPlace(0), amp=amp)
        scope = Scope()
        start.random_seed = 0
        exe.run(start, scope=scope)
        state = {n: scope.find_var(n).array.clone()
                 for n in scope.local_var_names()}
        feeds = _gru_program_feeds(warmup + steps)
        torch.cuda.synchronize()
        kernels.reset_launches()                   # the main path: go
        losses = [exe.run(main, feed=f, fetch_list=[loss], scope=scope,
                          return_numpy=False)[0].array
                  for f in feeds[:warmup]]
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(steps + 1)]
        for i, f in enumerate(feeds[warmup:]):
            events[i].record()
            losses.append(exe.run(main, feed=f, fetch_list=[loss],
                                  scope=scope, return_numpy=False)[0].array)
        events[steps].record()
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)          # read just after
        kernels.reset_launches()
        n = warmup + steps
        want = dict.fromkeys(kernels.LAUNCHES, 0)
        want.update(dict.fromkeys((*GRU_KERNELS, *GRU_ROUTE_NAMES[route]),
                                  n))
        _check(launches == want, f"exec_gru {key}: launches {launches} "
               f"over {n} steps, want {want}")
        step_ms = [events[i].elapsed_time(events[i + 1])
                   for i in range(steps)]
        got = torch.stack(losses).float().cpu().tolist()
        plain_scope = Scope()
        for nm, v in state.items():
            plain_scope.set_tensor(nm, v)
        with fr.plain_versions():
            ref = [float(exe.run(main, feed=f, fetch_list=[loss],
                                 scope=plain_scope)[0]) for f in feeds]
        kernels.reset_launches()
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, ref))
        tol = 1e-2 if amp else S2S_REL_TOL
        _check(all(np.isfinite(got)) and rel <= tol,
               f"exec_gru {key}: losses {got} vs plain {ref}")
        recs[key] = {"steps": n, "launches": {k: v for k, v in
                                              launches.items() if v},
                     "route": route, "loss_first": got[0],
                     "loss_last": got[-1],
                     "loss_max_rel_err_vs_plain": rel, "rtol": tol,
                     "ms_per_step_p50": float(np.median(step_ms)),
                     "ms_per_step_min": float(np.min(step_ms)),
                     "profile": _profile(
                         [lambda f=f: exe.run(main, feed=f,
                                              fetch_list=[loss],
                                              scope=scope)
                          for f in feeds[:5]],
                         named=GRU_RECURRENCE_KERNELS + ("dw_",))}
        kernels.reset_launches()
        _say(f"exec_gru {key}: ms a step {recs[key]['ms_per_step_p50']:.2f}"
             f", device busy "
             f"{recs[key]['profile']['device_busy_ms_per_step']}, idle "
             f"share {recs[key]['profile']['device_idle_share']}")
        del exe, scope, plain_scope, state
        torch.cuda.empty_cache()
    return {"exec_gru": {"batch": [S2S_B, S2S_S], "ragged_rows": S2S_B // 2,
                         "emb_dim": S2S_CFG["emb_dim"],
                         "hidden_dim": S2S_CFG["hidden_dim"],
                         "optimizer": f"adam {S2S_LR}",
                         "place": "CUDAPlace(0)", **recs}}


# 6e-6g: bench.py's image-classification workloads (_bench_image_model,
# :582-646: the layers DSL, Momentum(0.01, momentum=0.9).minimize,
# Executor(amp=True), images from np.random.RandomState(0), two feeds
# alternated) through the port. No hand-written kernel lies on this path
# (convolutions are cuDNN's, pooling and batch norm PyTorch ops): the
# launch counts stay 0.
IMAGE_LR, IMAGE_MU = 0.01, 0.9
# name -> (builder over models.image, image side, classes, bench.py's
# forward GMACs an image: :649-675, :696, :718, :748, :770)
IMAGE_MODELS = {
    "resnet50": (lambda im, i, l: im.resnet_imagenet(
        i, l, class_dim=1000, depth=50), 224, 1000, 3.8),
    "resnet50_s2d": (lambda im, i, l: im.resnet_imagenet(
        i, l, class_dim=1000, depth=50, s2d_stem=True), 224, 1000, 3.8),
    "alexnet": (lambda im, i, l: im.alexnet(i, l, class_dim=1000), 224,
                1000, 0.7),
    "vgg16": (lambda im, i, l: im.vgg16(i, l, class_dim=1000), 224, 1000,
              15.5),
    "googlenet": (lambda im, i, l: im.googlenet(i, l, class_dim=1000), 224,
                  1000, 1.5),
    "smallnet": (lambda im, i, l: im.smallnet_mnist_cifar(i, l, class_dim=10),
                 32, 10, 0.01235),
}
IMAGE_B = 64
# 6e's parity step (ResNet-50, batch 2, 224 x 224, fp32, TF32 off, cuDNN
# deterministic) on the card and the port on the CPU from one state, each
# held against the same step in float64 (_plain_step64, on the CPU). An
# fp32 step's gradients lie a few percent from the float64 ones (batch
# norm's backward over 2 x 7 x 7 values a channel cancels), so the card
# and the CPU are each held against the exact step, and the card's
# distance against the CPU's. The CPU's own distance (seed-0 state,
# tests/test_torch_image.py's float64 test): the loss 3.2e-6 relative,
# each gradient and update at most 0.030 relative L2, all the gradients
# together 0.024, each running statistic's batch part at most 4.0e-5. The
# gates stand 2-30x above those readings (the test holds them there):
IMAGE_PARITY_LOSS_REL = 5e-5
IMAGE_PARITY_GRAD_REL_L2 = 0.1       # each gradient and parameter update
IMAGE_PARITY_ALL_GRADS_REL_L2 = 0.06
IMAGE_PARITY_STAT_REL_L2 = 5e-4
IMAGE_PARITY_CARD_OVER_CPU = 2.0     # card's all-gradients distance / CPU's
AMP_FIRST_LOSS_REL = 2e-2       # AMP's first loss vs fp32's, batch 64


def _image_program(name, recipe=False):
    """IMAGE_MODELS[name] with Momentum(IMAGE_LR, IMAGE_MU).minimize, or
    with ``recipe`` He et al.'s (a piecewise learning rate, weight decay
    on every parameter: 6h), in fresh default programs and a fresh
    global scope (the s2d stem's mask is written there): (main, startup,
    loss, acc, registry ops a step)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.scope import reset_global_scope
    from paddle_tpu_torch.framework import program as prog
    from paddle_tpu_torch.models import image
    main, start = prog.fresh_programs()
    reset_global_scope()
    build, hw, _, _ = IMAGE_MODELS[name]
    img = pt.layers.data("img", [3, hw, hw])
    label = pt.layers.data("label", [1], dtype="int64")
    _, loss, acc = build(image, img, label)
    lr = IMAGE_LR
    if recipe:
        for p in main.global_block().all_parameters():
            p.regularizer = pt.regularizer.L2Decay(RESNET_DECAY)
        lr = pt.lr_scheduler.PiecewiseDecay(RESNET_BOUNDARIES, RESNET_VALUES)
    pt.optimizer.Momentum(lr, momentum=IMAGE_MU).minimize(loss)
    n_ops = sum(op.type != "backward" for op in main.global_block().ops)
    return main, start, loss, acc, n_ops


def _image_feeds(name, bs, dev=None):
    """bench.py's two feeds: ``RandomState(0)`` images in [0, 1) and
    labels, staged on ``dev`` (as bench.py stages them on the chip)."""
    _, hw, classes, _ = IMAGE_MODELS[name]
    rng = np.random.RandomState(0)
    feeds = [{"img": rng.rand(bs, 3, hw, hw).astype(np.float32),
              "label": rng.randint(0, classes, (bs, 1)).astype(np.int64)}
             for _ in range(2)]
    if dev is None:
        return feeds
    return [{k: torch.from_numpy(v).to(dev) for k, v in f.items()}
            for f in feeds]


def _image_train(kernels, dev, name, bs, warmup, steps, amp=True,
                 recipe=False):
    """``warmup`` + ``steps`` steps of IMAGE_MODELS[name] at batch ``bs``
    from its startup program (seed 0) on ``Executor(CUDAPlace(0),
    amp=amp)``, the two feeds alternated, the launch counts zeroed just
    before and read just after (none may launch): ms a batch p50 by CUDA
    events and by the host clock (the gaps between ``run``'s returns),
    the wall ms a batch (the timed steps and the final sync), images/s
    and MFU (bench.py's 2 x 3 x GMACs an image over 989 TFLOP/s) from
    the wall, peak memory, every loss finite; with ``recipe`` (6h) the
    learning rate fetched at every step, each the piecewise value.
    Returns (record, exe, main, loss, feeds)."""
    import paddle_tpu_torch as pt
    main, start, loss, _, n_ops = _image_program(name, recipe)
    fetch = [loss] + ([_var_named(main, r"learning_rate_\d+")]
                      if recipe else [])
    _, hw, classes, gmacs = IMAGE_MODELS[name]
    exe = pt.Executor(pt.CUDAPlace(0), amp=amp)
    start.random_seed = 0
    exe.run(start)
    feeds = _image_feeds(name, bs, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()                     # the path: go
    got = [exe.run(main, feed=feeds[i % 2], fetch_list=fetch,
                   return_numpy=False) for i in range(warmup)]
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    stamps = [time.perf_counter()]
    for i in range(steps):
        events[i].record()
        got.append(exe.run(main, feed=feeds[i % 2], fetch_list=fetch,
                           return_numpy=False))
        stamps.append(time.perf_counter())
    events[steps].record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - stamps[0]
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    _check(not launches, f"{name}: kernels launched {launches}")
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(steps)]
    loss_list = torch.stack([g[0].array for g in got]).float().cpu().tolist()
    _check(all(np.isfinite(loss_list)), f"{name}: losses {loss_list}")
    wall_ms = wall_s * 1e3 / steps
    flops = gmacs * 1e9 * 2 * 3 * bs
    p50 = float(np.median(step_ms))
    rec = {"batch": bs, "image": [3, hw, hw], "classes": classes,
           "optimizer": f"momentum {IMAGE_LR} mu {IMAGE_MU}",
           "amp": amp, "warmup_steps": warmup, "timed_steps": steps,
           "ms_per_batch_p50": p50, "ms_per_batch_min": float(min(step_ms)),
           "host_ms_per_batch_p50": float(np.median(np.diff(stamps))) * 1e3,
           "wall_ms_per_batch": wall_ms,
           "images_per_s": bs / (wall_ms / 1e3),
           "images_per_s_p50": bs / (p50 / 1e3),
           "gmacs_per_image": gmacs,
           "mfu": flops / (wall_ms / 1e3) / H100_BF16_FLOPS,
           "mfu_p50": flops / (p50 / 1e3) / H100_BF16_FLOPS,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "registry_ops_per_step": n_ops, "loss_first": loss_list[0],
           "loss_last": loss_list[-1], "losses_finite": len(loss_list),
           "kernel_launches": 0}
    if recipe:
        lrs = torch.cat([g[1].array for g in got]).cpu().tolist()
        want = [float(resnet_lr(i)) for i in range(len(lrs))]
        _check(lrs == want, f"{name}: lr {lrs}, the piecewise values {want}")
        rec.update({"optimizer": f"momentum piecewise {RESNET_BOUNDARIES} "
                    f"{RESNET_VALUES} mu {IMAGE_MU}, l2_decay {RESNET_DECAY}",
                    "lr_per_step": lrs, "lr_equals_piecewise": True})
    _say(f"{name} batch {bs}{'' if amp else ' fp32'}: ms a batch p50 "
         f"{p50:.2f} (host {rec['host_ms_per_batch_p50']:.2f}, wall "
         f"{wall_ms:.2f}), "
         f"{rec['images_per_s']:.1f} images/s, MFU {rec['mfu']:.4f}, peak "
         f"{rec['peak_memory_gib']:.2f} GiB")
    return rec, exe, main, loss, feeds


def _release():
    from paddle_tpu_torch.core.scope import reset_global_scope
    reset_global_scope()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _plain_step64(main, state, feed):
    """One training step of ``main`` (an image program of conv2d,
    batch_norm, relu, pool2d, elementwise_add, mul, softmax,
    softmax_with_cross_entropy, mean, top_k and accuracy ops, then
    ``momentum`` updates) in float64 on the CPU, written from the ops'
    definitions apart from the port: the loss's gradients by autograd,
    batch norm over the batch with the biased variance, its running
    statistics ``mom * old + (1 - mom) * batch``, velocity ``mu * v + g``
    and ``p - lr * v``. ``state`` maps every persistable to a tensor;
    returns (loss, the persistables after the step)."""
    import torch.nn.functional as F
    block = main.global_block()
    env = {n: torch.as_tensor(v).detach().to("cpu", torch.float64,
                                             copy=True)
           for n, v in state.items()}
    params = [p.name for p in block.all_parameters() if p.trainable]
    for n in params:
        env[n].requires_grad_(True)
    for n, v in feed.items():
        v = torch.as_tensor(v)
        env[n] = v.to(torch.float64) if v.is_floating_point() else v
    new = {}
    per_channel = (1, -1, 1, 1)
    for op in block.ops:
        t, a = op.type, op.attrs

        def x(slot):
            return env[op.inputs[slot][0]]

        if t == "backward":
            loss = env[op.inputs["Loss"][0]]
            break
        if t == "conv2d":
            out = {"Output": F.conv2d(x("Input"), x("Filter"), None,
                                      a["strides"], a["paddings"],
                                      a["dilations"], a["groups"])}
        elif t == "batch_norm":
            xi = x("X")
            m = xi.mean((0, 2, 3))
            var = ((xi - m.reshape(per_channel)) ** 2).mean((0, 2, 3))
            y = ((xi - m.reshape(per_channel))
                 / torch.sqrt(var.reshape(per_channel) + a["epsilon"])
                 * x("Scale").reshape(per_channel)
                 + x("Bias").reshape(per_channel))
            mom = a["momentum"]
            new[op.outputs["MeanOut"][0]] = (
                mom * x("Mean") + (1 - mom) * m.detach())
            new[op.outputs["VarianceOut"][0]] = (
                mom * x("Variance") + (1 - mom) * var.detach())
            out = {"Y": y}
        elif t == "relu":
            out = {"Out": F.relu(x("X"))}
        elif t == "pool2d" and a["global_pooling"]:
            fn = torch.amax if a["pooling_type"] == "max" else torch.mean
            out = {"Out": fn(x("X"), (2, 3), keepdim=True)}
        elif t == "pool2d" and a["pooling_type"] == "max":
            out = {"Out": F.max_pool2d(x("X"), a["ksize"], a["strides"],
                                       a["paddings"])}
        elif t == "elementwise_add":
            xi, y = x("X"), x("Y")
            ax = a["axis"] if a["axis"] >= 0 else xi.dim() - y.dim()
            y = y.reshape((1,) * ax + tuple(y.shape)
                          + (1,) * (xi.dim() - ax - y.dim()))
            out = {"Out": xi + y}
        elif t == "mul":
            xi, y = x("X"), x("Y")
            k, j = a["x_num_col_dims"], a["y_num_col_dims"]
            prod = xi.reshape(int(np.prod(xi.shape[:k])), -1) @ y.reshape(
                int(np.prod(y.shape[:j])), -1)
            out = {"Out": prod.reshape(tuple(xi.shape[:k])
                                       + tuple(y.shape[j:]))}
        elif t == "softmax":
            out = {"Out": torch.softmax(x("X"), -1)}
        elif t == "softmax_with_cross_entropy" and not a["soft_label"]:
            logp = torch.log_softmax(x("Logits"), -1)
            out = {"Softmax": logp.exp(),
                   "Loss": -logp.gather(1, x("Label").reshape(-1, 1))}
        elif t == "mean":
            out = {"Out": x("X").mean().reshape(1)}
        elif t in ("top_k", "accuracy"):
            continue
        else:
            raise NotImplementedError(f"_plain_step64: op {t} {a}")
        for slot, v in out.items():
            env[op.outputs[slot][0]] = v
    grads = dict(zip(params, torch.autograd.grad(
        loss.sum(), [env[n] for n in params])))
    for op in block.ops:
        if op.type != "momentum":
            continue
        p, vel = op.inputs["Param"][0], op.inputs["Velocity"][0]
        g, lr = grads[p], float(env[op.inputs["LearningRate"][0]])
        mu = op.attrs["mu"]
        v_out = mu * env[vel] + g
        step = g + mu * v_out if op.attrs["use_nesterov"] else v_out
        new[vel] = v_out
        new[p] = env[p].detach() - lr * step
    out = {n: new.get(n, env[n]).detach() for n in state}
    return float(loss.detach().reshape(())), out


def _step_distances(main, init, after, ref, loss, ref_loss):
    """How far one step's persistables ``after`` (and its ``loss``) lie
    from ``ref`` (and ``ref_loss``), both from ``init``: the loss's
    relative error; each velocity's (after one step, the gradient's) and
    each parameter update's relative L2, the most and where; all the
    velocities together; each running statistic's batch part (new -
    momentum x old), the most."""
    block = main.global_block()
    stats = {op.inputs[s][0]: op.attrs["momentum"] for op in block.ops
             if op.type == "batch_norm" for s in ("Mean", "Variance")}
    params = [p.name for p in block.all_parameters()]
    vel = sorted(n for n in ref if n.startswith("velocity_"))

    def dist(a, b):
        return _rel_l2(a.double(), b.double())

    def worst(errs):
        name = max(errs, key=errs.get)
        return errs[name], name

    grad, grad_at = worst({n: dist(after[n], ref[n]) for n in vel})
    update, update_at = worst({n: dist(after[n] - init[n], ref[n] - init[n])
                               for n in params})
    stat, stat_at = worst({n: dist(after[n] - m * init[n],
                                   ref[n] - m * init[n])
                           for n, m in stats.items()})
    return {"loss_rel": abs(loss - ref_loss) / abs(ref_loss),
            "grad_max_rel_l2": grad, "grad_max_at": grad_at,
            "all_grads_rel_l2": dist(torch.cat([after[n].reshape(-1)
                                                for n in vel]),
                                     torch.cat([ref[n].reshape(-1)
                                                for n in vel])),
            "update_max_rel_l2": update, "update_max_at": update_at,
            "stat_max_rel_l2": stat, "stat_max_at": stat_at,
            "n_stats": len(stats), "n_params": len(params)}


def _within_parity_gates(d):
    return (d["loss_rel"] <= IMAGE_PARITY_LOSS_REL
            and max(d["grad_max_rel_l2"], d["update_max_rel_l2"])
            <= IMAGE_PARITY_GRAD_REL_L2
            and d["all_grads_rel_l2"] <= IMAGE_PARITY_ALL_GRADS_REL_L2
            and d["stat_max_rel_l2"] <= IMAGE_PARITY_STAT_REL_L2)


def _image_parity(dev):
    """ResNet-50's one fp32 step at batch 2, 224 x 224, from one startup
    state (seed 0) on ``CUDAPlace(0)`` (cuDNN deterministic for this
    step only) and on ``CPUPlace``, each against the same step in float64
    (``_plain_step64``): the loss, every velocity (the gradient),
    parameter update and running statistic's batch part within the
    IMAGE_PARITY_* gates, the card's distance at most
    IMAGE_PARITY_CARD_OVER_CPU times the CPU's; the card against the CPU
    is reported."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.scope import Scope
    main, start, loss, _, _ = _image_program("resnet50")
    exe = pt.Executor(pt.CUDAPlace(0))
    scope = Scope()
    start.random_seed = 0
    exe.run(start, scope=scope)
    names = sorted(scope.local_var_names())
    cpu_scope = _scope_copy(scope, names, "cpu")
    init = {n: cpu_scope.find_var(n).array.clone() for n in names}
    feed = _image_feeds("resnet50", 2)[0]
    torch.backends.cudnn.deterministic = True
    try:
        (got,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    finally:
        torch.backends.cudnn.deterministic = False
    t0 = time.perf_counter()
    (want,) = pt.Executor(pt.CPUPlace()).run(main, feed=feed,
                                             fetch_list=[loss],
                                             scope=cpu_scope)
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref_loss, ref = _plain_step64(main, init, feed)
    f64_s = time.perf_counter() - t0
    card = {n: scope.find_var(n).array.cpu() for n in names}
    cpu = {n: cpu_scope.find_var(n).array for n in names}
    got, want = float(got), float(want)
    d_card = _step_distances(main, init, card, ref, got, ref_loss)
    d_cpu = _step_distances(main, init, cpu, ref, want, ref_loss)
    d_pair = _step_distances(main, init, card, cpu, got, want)
    _say(f"resnet50 parity: card vs float64 {json.dumps(d_card)}; CPU vs "
         f"float64 {json.dumps(d_cpu)}; card vs CPU {json.dumps(d_pair)}")
    _check(d_card["n_stats"] == 106 and d_card["n_params"] == 161,
           f"resnet50 parity: {d_card['n_stats']} stats, "
           f"{d_card['n_params']} params")
    _check(np.isfinite(got) and _within_parity_gates(d_card),
           f"resnet50 parity: card vs float64 {d_card}")
    _check(_within_parity_gates(d_cpu),
           f"resnet50 parity: CPU vs float64 {d_cpu}")
    _check(d_card["all_grads_rel_l2"]
           <= IMAGE_PARITY_CARD_OVER_CPU * d_cpu["all_grads_rel_l2"],
           f"resnet50 parity: card {d_card['all_grads_rel_l2']} vs CPU "
           f"{d_cpu['all_grads_rel_l2']} from float64")
    for n in names:     # what no op writes (the learning rate) is unchanged
        if not torch.equal(init[n].double(), ref[n]):
            continue
        _check(torch.equal(card[n], init[n]) and torch.equal(cpu[n], init[n]),
               f"resnet50 parity: {n} moved")
    del scope, cpu_scope, init, card, cpu, ref, exe
    _release()
    hw = IMAGE_MODELS["resnet50"][1]
    return {"batch": 2, "image": [3, hw, hw], "dtype": "float32",
            "cudnn_deterministic": True, "loss_card": got, "loss_cpu": want,
            "loss_float64": ref_loss, "card_vs_float64": d_card,
            "cpu_vs_float64": d_cpu, "card_vs_cpu": d_pair,
            "tol": {"loss_rel": IMAGE_PARITY_LOSS_REL,
                    "grad_and_update_rel_l2": IMAGE_PARITY_GRAD_REL_L2,
                    "all_grads_rel_l2": IMAGE_PARITY_ALL_GRADS_REL_L2,
                    "stat_rel_l2": IMAGE_PARITY_STAT_REL_L2,
                    "card_over_cpu_all_grads": IMAGE_PARITY_CARD_OVER_CPU},
            "cpu_step_s": cpu_s, "float64_step_s": f64_s}


def _image_train_profiled(kernels, dev, name, recipe=False):
    """``_image_train`` of ``name`` at batch IMAGE_B, 3 + 20 steps, then
    three more under ``torch.profiler`` (its record's ``profile``)."""
    rec, exe, main, loss, feeds = _image_train(kernels, dev, name, IMAGE_B,
                                               3, 20, recipe=recipe)
    prof = _profile([lambda f=f: exe.run(main, feed=f, fetch_list=[loss])
                     for f in (feeds * 3)[:5]])
    prof["registry_ops_per_step"] = rec["registry_ops_per_step"]
    rec["profile"] = prof
    del exe, main, loss, feeds
    _release()
    _say(f"{name} profile: device busy {prof['device_busy_ms_per_step']}"
         f" ms a step, idle share {prof['device_idle_share']}, "
         f"{prof['device_kernels_per_step']} device ops a step")
    return rec


def exec_resnet50(kernels, dev):
    """Phase 6e (``exec_resnet50``): bench_resnet50 through the port:
    ResNet-50 at 224 x 224, 1000 classes, ``Momentum(0.01, 0.9)``,
    ``Executor(CUDAPlace(0), amp=True)``: batch 64 3 + 20 steps, batch 128
    and 256 1 + 5 each; three batch-64 steps under ``torch.profiler``;
    the parity step (the card and the CPU each against float64); AMP's
    first loss against fp32's."""
    runs = {f"batch_{IMAGE_B}": _image_train_profiled(kernels, dev,
                                                      "resnet50")}
    for bs in (128, 256):
        runs[f"batch_{bs}"] = _image_train(kernels, dev, "resnet50", bs, 1,
                                           5)[0]
        _release()
    parity = _image_parity(dev)
    fp32 = _image_train(kernels, dev, "resnet50", IMAGE_B, 0, 1,
                        amp=False)[0]["loss_first"]
    _release()
    amp_first = runs[f"batch_{IMAGE_B}"]["loss_first"]
    amp_rel = abs(amp_first - fp32) / abs(fp32)
    _check(amp_rel <= AMP_FIRST_LOSS_REL,
           f"resnet50: AMP first loss {amp_first} vs fp32 {fp32}")
    return {"exec_resnet50": {
        "model": "resnet_imagenet(depth=50, class_dim=1000)",
        "place": "CUDAPlace(0)", "mfu_peak_flops": H100_BF16_FLOPS,
        **runs, "parity_card_vs_cpu": parity,
        "amp_vs_fp32_first_loss": {"amp": amp_first, "fp32": fp32,
                                   "rel_err": amp_rel,
                                   "tol": AMP_FIRST_LOSS_REL}}}


def exec_image(kernels, dev):
    """Phase 6f (``exec_image``): bench.py's AlexNet, VGG-16 and GoogLeNet
    (224 x 224, 1000 classes) and SmallNet (32 x 32, 10 classes) at batch
    64, 1 + 5 steps each, and ResNet-50 with the space-to-depth stem as
    ``exec_resnet50`` runs the 7 x 7 stem at batch 64 (3 + 20 steps, three
    profiled)."""
    out = {}
    for name in ("alexnet", "vgg16", "googlenet", "smallnet"):
        out[name] = _image_train(kernels, dev, name, IMAGE_B, 1, 5)[0]
        _release()
    out["resnet50_s2d"] = _image_train_profiled(kernels, dev, "resnet50_s2d")
    return {"exec_image": {"place": "CUDAPlace(0)", "amp": True, **out}}


def _image_trainer_run(kernels, name, n_batches, bs=64):
    """The book's ``recognize_digits_conv`` (``mnist.conv``, Adam 0.01) or
    ``smallnet_cifar`` (SmallNet, Momentum 0.01) through ``Trainer`` on
    ``CUDAPlace(0)``, one pass over ``n_batches`` batches of the dataset's
    surrogate (images reshaped as test_book.py reshapes them): the
    events in order, every cost finite, ms a batch (the p50 of the gaps
    between EndIteration events after the first)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.scope import reset_global_scope
    from paddle_tpu_torch.framework import program as prog
    from paddle_tpu_torch.models import image, mnist
    prog.fresh_programs()
    reset_global_scope()
    if name == "recognize_digits_conv":
        shape, raw = (1, 28, 28), pt.datasets.mnist.train(n_batches * bs)
        img = pt.layers.data("img", list(shape))
        label = pt.layers.data("label", [1], dtype="int64")
        _, loss, acc = mnist.conv(img, label)
        opt = pt.optimizer.Adam(0.01)
    else:
        shape, raw = (3, 32, 32), pt.datasets.cifar.train10(n_batches * bs)
        img = pt.layers.data("img", list(shape))
        label = pt.layers.data("label", [1], dtype="int64")
        _, loss, acc = image.smallnet_mnist_cifar(img, label)
        opt = pt.optimizer.Momentum(0.01)

    def shaped():
        for im, lab in raw():
            yield im.reshape(shape), lab

    tr = pt.Trainer(cost=loss, optimizer=opt, feed_list=[img, label],
                    metrics=[acc], place=pt.CUDAPlace(0))
    kinds, costs, stamps = [], [], []

    def handler(e):
        kinds.append(type(e).__name__)
        if isinstance(e, pt.event.EndIteration):
            stamps.append(time.perf_counter())
            costs.append(e.cost)

    kernels.reset_launches()
    tr.train(pt.reader.batch(shaped, bs), num_passes=1,
             event_handler=handler, log_period=0)
    torch.cuda.synchronize()
    _check(not any(kernels.LAUNCHES.values()),
           f"trainer_image {name}: kernels launched")
    _check(kinds == ["BeginPass"] + ["BeginIteration", "EndIteration"]
           * n_batches + ["EndPass"], f"trainer_image {name}: events {kinds}")
    _check(all(np.isfinite(costs)), f"trainer_image {name}: costs {costs}")
    del tr
    _release()
    return {"batch": bs, "image": list(shape), "batches": n_batches,
            "optimizer": "adam 0.01" if name == "recognize_digits_conv"
            else "momentum 0.01", "cost_first": float(costs[0]),
            "cost_last": float(costs[-1]),
            "ms_per_batch_p50": float(np.median(np.diff(stamps)[1:])) * 1e3}


def trainer_image(kernels):
    """Phase 6g (``trainer_image``): the two conv book models through the
    ``Trainer`` on the card, over the mnist and cifar-10 surrogates."""
    out = {name: _image_trainer_run(kernels, name, 8)
           for name in ("recognize_digits_conv", "smallnet_cifar")}
    for name, rec in out.items():
        _say(f"trainer_image {name}: ms a batch {rec['ms_per_batch_p50']:.2f}"
             f", cost {rec['cost_first']:.4f} -> {rec['cost_last']:.4f}")
    return {"trainer_image": {"place": "CUDAPlace(0)", **out}}


# 6h: the rest of training's core on its two card paths: the flagship
# and ResNet-50 trained to a full recipe (a learning-rate schedule,
# global-norm clipping, weight decay and, on the flagship, a model
# average), the six other optimizers, and each new op on the card
# against the same op on the CPU
RECIPE_LR = dict(base_lr=0.002, decay_steps=10, decay_rate=0.5)
RECIPE_CLIP = 5.0
RECIPE_DECAY = 8e-4
RECIPE_AVERAGE = 0.999
# He et al. 2016 ("Deep Residual Learning", 3.4): momentum 0.9, weight
# decay 1e-4, the learning rate cut 10x in steps; the steps here fall
# within the phase's 23 (3 + 20)
RESNET_BOUNDARIES, RESNET_VALUES = [8, 16], [0.1, 0.01, 0.001]
RESNET_DECAY = 1e-4
OPTIM_OP_REL_L2 = 1e-6
OTHER_OPTIMIZERS = ("Adagrad", "Adamax", "DecayedAdagrad", "AdaDelta",
                    "RMSProp", "Ftrl")


def _recipe_schedule(pt):
    return pt.lr_scheduler.ExponentialDecay(
        RECIPE_LR["base_lr"], decay_steps=RECIPE_LR["decay_steps"],
        decay_rate=RECIPE_LR["decay_rate"])


def recipe_lr(step):
    """The recipe's learning rate at ``step`` in float32, as the JAX
    package's compiled step evaluates the closed form ``base * rate **
    (step / decay_steps)``: the division by the constant a product with
    its float32 reciprocal (``ops/optimizer_ops.lr_schedule``), the power
    rounded once to float32, then the product."""
    r = np.float32(1.0 / RECIPE_LR["decay_steps"])
    power = np.float64(np.float32(RECIPE_LR["decay_rate"])) ** np.float64(
        np.float32(step) * r)
    return np.float32(RECIPE_LR["base_lr"]) * np.float32(power)


def resnet_lr(step):
    """The piecewise learning rate at ``step``: values[#boundaries <=
    step], in float32."""
    import bisect
    return np.float32(RESNET_VALUES[bisect.bisect_right(RESNET_BOUNDARIES,
                                                        step)])


def ulps(a, b):
    """ulps between positive float32 values."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


def _recipe_trainer(make_opt, state=None, average=True):
    """``_flagship_net`` with ``L2Decay(RECIPE_DECAY)`` set on every
    parameter before the Trainer's ``minimize`` with ``make_opt(pt)``, on
    ``Executor(CUDAPlace(0), amp=True)``; with ``average`` a
    ``ModelAverage(RECIPE_AVERAGE)`` created after that ``minimize``.
    Its startup program (seed 0) runs, then the parameters in ``state``
    (name -> card tensor) are copied in. Returns (trainer, average)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.scope import global_scope
    feeds, loss, acc = _flagship_net()
    main = pt.default_main_program()
    for p in main.global_block().all_parameters():
        p.regularizer = pt.regularizer.L2Decay(RECIPE_DECAY)
    tr = pt.Trainer(cost=loss, optimizer=make_opt(pt), feed_list=feeds,
                    metrics=[acc],
                    executor=pt.Executor(pt.CUDAPlace(0), amp=True))
    ma = pt.optimizer.ModelAverage(RECIPE_AVERAGE) if average else None
    tr.startup_program.random_seed = 0
    tr._init_params()
    for n, v in (state or {}).items():
        global_scope().set_tensor(n, v.clone())
    return tr, ma


def _var_named(main, pattern):
    import re
    return next(n for n in main.global_block().vars
                if re.fullmatch(pattern, n))


def _recipe_checks(tr, batches, k):
    """Checking steps of the recipe trainer (not timed; they train on):
    one ``Executor.run`` a batch fetching the learning rate, the global
    norm before the clip and every clipped gradient, then ``k`` batches
    in one ``run_multi`` fetching the learning rate. Each lr within 1
    ulp of ``recipe_lr`` at its step; each clipped global norm at most
    RECIPE_CLIP (1 + 1e-6)."""
    from paddle_tpu_torch.core.scope import global_scope
    main, exe = tr.main_program, tr.exe
    lr = tr.optimizer._lr_var.name
    step = tr.optimizer._global_step_var.name
    norm = _var_named(main, r"global_norm_\d+")
    grads = [p.name + "@GRAD" for p in main.global_block().all_parameters()]
    first = int(global_scope().find_var(step).array.item())
    lrs, norms = [], []
    for b in batches[:2]:
        got = exe.run(main, feed=tr.feeder.feed(b),
                      fetch_list=[lr, norm] + grads, return_numpy=False)
        clipped = torch.sqrt(sum(torch.sum(g.array.double() ** 2)
                                 for g in got[2:])).item()
        lrs.append(float(got[0].array.item()))
        norms.append((float(got[1].array.item()), clipped))
    multi = exe.run_multi(main, [tr.feeder.feed(b) for b in batches[2:2 + k]],
                          fetch_list=[lr])[0].reshape(-1).tolist()
    lrs += multi
    want = [float(recipe_lr(first + i)) for i in range(len(lrs))]
    worst = int(max(ulps(lrs, want)))
    _check(worst <= 1, f"recipe: lr {lrs} vs the closed form {want}")
    _check(all(c <= RECIPE_CLIP * (1 + 1e-6) for _, c in norms),
           f"recipe: clipped global norms {norms} over {RECIPE_CLIP}")
    return {"first_step": first, "lr": lrs, "closed_form": want,
            "lr_max_ulps": worst, "k": k,
            "global_norm_before_and_after_clip": norms,
            "clip_norm": RECIPE_CLIP}


def _model_average_swap(ma):
    """``ma.apply()`` and its restore under sync-debug "error": inside,
    each parameter is a copy of its shadow; after, the live tensors
    themselves, bit-equal to before."""
    from paddle_tpu_torch.core.scope import global_scope
    scope = global_scope()
    live = {p: scope.find_var(p).array for p, _ in ma._pairs}
    saved = {p: t.clone() for p, t in live.items()}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with ma.apply():
            inside = {p: scope.find_var(p).array for p, _ in ma._pairs}
        after = {p: scope.find_var(p).array for p, _ in ma._pairs}
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    _check(all(torch.equal(inside[p], scope.find_var(a).array)
               and inside[p] is not scope.find_var(a).array
               for p, a in ma._pairs), "recipe: apply() is not the shadows")
    _check(all(after[p] is live[p] and torch.equal(after[p], saved[p])
               for p in live), "recipe: the restore is not the live weights")
    drift = max(float((scope.find_var(a).array - saved[p]).abs().max())
                for p, a in ma._pairs)
    return {"sync_debug": "error", "pairs": len(ma._pairs),
            "restore_bit_equal": True, "max_abs_shadow_minus_live": drift}


def optim_op_cases(shapes, seed=0):
    """Every op the training plane adds, on parameters of ``shapes``
    with seeded gradients and state: [(case, op, inputs as numpy,
    attrs)]: the six optimizers' updates, proximal_gd / _adagrad,
    ema_update, the pruning pair, the decay's sign, the clip's
    squared_l2_norm and elementwise_mul by its factor, each a parameter;
    then the clip's sum, sqrt, elementwise_max and elementwise_div over
    the parameters' norms, assign, increment and lr_schedule (every
    strategy) at steps 0-60."""
    rng = np.random.RandomState(seed)
    lr = np.array([0.01], np.float32)
    cases = []
    for i, shape in enumerate(shapes):
        def rand(scale):
            return (rng.randn(*shape) * scale).astype(np.float32)

        def pos(scale):
            return ((rng.rand(*shape) + 0.1) * scale).astype(np.float32)

        p, g = rand(0.1), rand(1e-3)
        u = {"Param": p, "Grad": g}
        for name, op, ins, attrs in (
                ("adagrad", "adagrad", {"Moment": pos(1e-6),
                                        "LearningRate": lr}, {}),
                ("adamax", "adamax", {"LearningRate": lr,
                                      "Moment": rand(1e-4),
                                      "InfNorm": pos(1e-3),
                                      "Beta1Pow": np.array([0.9 ** 4],
                                                           np.float32)}, {}),
                ("decayed_adagrad", "decayed_adagrad",
                 {"Moment": pos(1e-6), "LearningRate": lr}, {}),
                ("adadelta", "adadelta", {"AvgSquaredGrad": pos(1e-6),
                                          "AvgSquaredUpdate": pos(1e-8)},
                 {}),
                ("rmsprop", "rmsprop", {"MeanSquare": pos(1e-6),
                                        "Moment": rand(1e-4),
                                        "LearningRate": lr},
                 {"momentum": 0.5}),
                ("ftrl", "ftrl", {"SquaredAccumulator": pos(1e-6),
                                  "LinearAccumulator": rand(1e-2),
                                  "LearningRate": lr},
                 {"l1": 1e-3, "l2": 1e-3}),
                ("proximal_gd", "proximal_gd", {"LearningRate": lr},
                 {"l1": 0.01, "l2": 0.01}),
                ("proximal_adagrad", "proximal_adagrad",
                 {"Moment": pos(1e-6), "LearningRate": lr},
                 {"l1": 0.01, "l2": 0.01})):
            cases.append((f"{name}_{i}", op, dict(u, **ins), attrs))
        cases += [
            (f"ema_update_{i}", "ema_update", {"Param": p, "Avg": rand(0.1)},
             {"decay": RECIPE_AVERAGE}),
            (f"magnitude_prune_mask_{i}", "magnitude_prune_mask",
             {"Param": p}, {"sparsity_ratio": 0.6}),
            (f"apply_mask_{i}", "apply_mask", {"Param": p, "Mask": (
                rng.rand(*shape) > 0.6).astype(np.float32)}, {}),
            (f"sign_{i}", "sign", {"X": p}, {}),
            (f"squared_l2_norm_{i}", "squared_l2_norm", {"X": g}, {}),
            (f"clip_mul_{i}", "elementwise_mul",
             {"X": g, "Y": np.array([0.37], np.float32)}, {})]
    norms = [np.array([rng.rand() * 4], np.float32) for _ in shapes]
    clip = np.array([RECIPE_CLIP], np.float32)
    cases += [("clip_sum", "sum", {"X": norms}, {}),
              ("clip_sqrt", "sqrt", {"X": norms[0] * 9}, {}),
              ("clip_max", "elementwise_max", {"X": norms[0] * 9, "Y": clip},
               {}),
              ("clip_div", "elementwise_div", {"X": clip, "Y": norms[0] * 9},
               {}),
              ("assign", "assign", {"X": rng.randn(*shapes[0]).astype(
                  np.float32)}, {}),
              ("increment", "increment", {"X": np.array([41.0], np.float32)},
               {"step": 1.0})]
    schedules = {
        "exponential": dict(strategy="exponential_decay", base_lr=0.002,
                            decay_steps=10.0, decay_rate=0.5),
        "natural_exp": dict(strategy="natural_exp_decay", base_lr=0.1,
                            decay_steps=7.0, decay_rate=0.3, staircase=True),
        "inverse_time": dict(strategy="inverse_time_decay", base_lr=0.1,
                             decay_steps=3.0, decay_rate=0.7),
        "polynomial": dict(strategy="polynomial_decay", base_lr=0.1,
                           decay_steps=25.0, end_lr=0.001, power=1.5,
                           cycle=True),
        "piecewise": dict(strategy="piecewise_decay",
                          boundaries=[float(b) for b in RESNET_BOUNDARIES],
                          values=RESNET_VALUES),
        "linear": dict(strategy="linear_decay", base_lr=0.1,
                       decay_rate=0.001, end_lr=0.05)}
    for name, attrs in schedules.items():
        for step in (0, 1, 8, 16, 37, 60):
            cases.append((f"lr_schedule_{name}_{step}", "lr_schedule",
                          {"Step": np.array([step], np.float32)}, attrs))
    return cases


def optim_ops_card_vs_cpu(dev, shapes):
    """Each of ``optim_op_cases(shapes)`` through ``registry.run_op`` on
    the card and on the CPU: every output's relative L2 distance (0
    where both are 0) at most OPTIM_OP_REL_L2. Returns {op: the worst
    distance over its cases}."""
    from paddle_tpu_torch.framework import registry
    worst = {}
    for case, op, ins, attrs in optim_op_cases(shapes):
        outs = {}
        for where in ("cuda", "cpu"):
            d = dev if where == "cuda" else torch.device("cpu")
            live = {s: [torch.from_numpy(np.ascontiguousarray(a)).to(d)
                        for a in (v if isinstance(v, list) else [v])]
                    for s, v in ins.items()}
            outs[where] = registry.run_op(op, live, attrs, device=d)[0]
        for slot, vals in outs["cpu"].items():
            for want, got in zip(vals, outs["cuda"][slot]):
                _check(got.device.type == dev.type and got.dtype == want.dtype
                       and got.shape == want.shape, f"{case} {slot}")
                w, g = want.double(), got.double().cpu()
                den = float(torch.linalg.vector_norm(w))
                err = float(torch.linalg.vector_norm(g - w))
                rel = err / den if den else err
                _check(rel <= OPTIM_OP_REL_L2,
                       f"{case} {slot}: card vs CPU relative L2 {rel}")
                worst[op] = max(worst.get(op, 0.0), rel)
    return worst


def trainer_lstm_recipe(kernels, dev, trainer_rec, warmup=3, steps=20,
                        k=8, groups=3):
    """Phase 6h's ``trainer_lstm_recipe``, as the module docstring sets
    out."""
    import itertools
    from paddle_tpu_torch.core.scope import global_scope, reset_global_scope

    def recipe(pt):
        return pt.optimizer.Adam(_recipe_schedule(pt),
                                 global_clip_norm=RECIPE_CLIP)

    base = trainer_rec["trainer_lstm"]
    uniform = _lstm_route_names(dev, True, True)
    # the host's speed drifts within a call: K = 1 of the plain flagship
    # (6c's Trainer) and of the recipe in turns, plain / recipe / recipe
    # / plain, each 3 + 20 batches
    turns = {"plain": [], "recipe": []}

    def plain_k1():
        ptr = _lstm_trainer()
        _, pst, _ = _trainer_run(ptr, _uniform_batches(warmup + steps, seed=3),
                                 kernels, uniform)
        turns["plain"].append(_batch_ms(pst, warmup))
        del ptr

    plain_k1()
    tr, ma = _recipe_trainer(recipe)
    main = tr.main_program
    params = [p.name for p in main.global_block().all_parameters()]
    state = {n: global_scope().find_var(n).array.clone() for n in params}
    n_ops = sum(op.type != "backward" for op in main.global_block().ops)
    types = [op.type for op in main.global_block().ops]
    rec = {"batch": [TEXT_B, TEXT_T], "widths": TEXT_CFG, "amp": True,
           "optimizer": f"adam, exponential_decay {RECIPE_LR}, "
           f"global_clip_norm {RECIPE_CLIP}, l2_decay {RECIPE_DECAY}, "
           f"model_average {RECIPE_AVERAGE}", "place": "CUDAPlace(0)",
           "parameters": len(params), "registry_ops_per_step": n_ops,
           "trainer_lstm_registry_ops_per_step": base["ops"] - 1,
           "ops_by_type": {t: types.count(t) for t in (
               "squared_l2_norm", "elementwise_mul", "scale", "sum",
               "lr_schedule", "increment", "ema_update")}}
    # K = 1: 3 + 20 batches
    costs, stamps, launches = _trainer_run(
        tr, _uniform_batches(warmup + steps, seed=3), kernels, uniform)
    rec["k1"] = {"batches": len(costs), "launches": launches,
                 "ms_per_batch_p50": _batch_ms(stamps, warmup),
                 "cost_first": costs[0], "cost_last": costs[-1]}
    turns["recipe"].append(rec["k1"]["ms_per_batch_p50"])
    _, stamps, _ = _trainer_run(tr, _uniform_batches(warmup + steps, seed=9),
                                kernels, uniform)
    turns["recipe"].append(_batch_ms(stamps, warmup))
    # the checking steps: lr against the closed form (K = 1 and K = k),
    # the clipped global norm
    checks = list(_uniform_batches(2 + k, seed=6)())
    rec["checks"] = _recipe_checks(tr, checks, k)
    kernels.reset_launches()
    # K = k: 3 groups
    kc, stamps, _ = _trainer_run(tr, _uniform_batches(k * groups, seed=4),
                                 kernels, uniform, steps_per_call=k)
    _check(len(kc) == k * groups, f"recipe: {len(kc)} K={k} results")
    step = int(global_scope().find_var(
        tr.optimizer._global_step_var.name).array.item())
    last_lr = float(global_scope().find_var(
        tr.optimizer._lr_var.name).array.item())
    _check(step == 2 * (warmup + steps) + 2 + k + k * groups
           and ulps(last_lr, recipe_lr(step - 1)) <= 1,
           f"recipe: after K={k} step {step}, lr {last_lr}")
    rec[f"k{k}"] = {"batches": len(kc), "groups": groups,
                    "ms_per_batch_p50": _batch_ms(stamps, 1, per=k),
                    "cost_first": kc[0], "cost_last": kc[-1],
                    "global_step_after": step, "lr_after": last_lr}
    # the model average: the swap on the device, and an evaluation with
    # the averaged weights
    rec["model_average"] = _model_average_swap(ma)
    with ma.apply():
        avg_cost = tr.test(_uniform_batches(2, seed=7))["cost"]
    _check(np.isfinite(avg_cost), f"recipe: averaged cost {avg_cost}")
    rec["model_average"]["test_cost_averaged"] = avg_cost
    # five Trainer steps (the last three profiled)
    batches = list(itertools.islice(_uniform_batches(5, seed=8)(), 5))
    rec["profile"] = _profile(
        [lambda b=b: tr.train_one_batch(b) for b in batches],
        named=("lstm_xg_kernel", "lstm_cluster_fwd_kernel",
               "lstm_cluster_bwd_kernel", "lstm_dxe_kernel", "dw_wgmma"))
    rec["profile"]["registry_ops_per_step"] = n_ops
    kernels.reset_launches()
    del tr, ma
    plain_k1()
    rec["k1_in_turns_ms_per_batch_p50"] = turns
    rec["k1_in_turns_recipe_over_plain"] = (
        sum(turns["recipe"]) / sum(turns["plain"]))
    # the six other optimizers (the same schedule and clip), 1 + 5
    # batches each from the recipe's startup parameters
    others = {}
    for name in OTHER_OPTIMIZERS:
        def make(pt, name=name):
            return getattr(pt.optimizer, name)(_recipe_schedule(pt),
                                               global_clip_norm=RECIPE_CLIP)
        tr6, _ = _recipe_trainer(make, state, average=False)
        oc, stamps, launches = _trainer_run(
            tr6, _uniform_batches(6, seed=5), kernels, uniform)
        others[name] = {"batches": len(oc), "launches": launches,
                        "ms_per_batch_p50": _batch_ms(stamps, 1),
                        "cost_first": oc[0], "cost_last": oc[-1]}
        del tr6
    rec["other_optimizers"] = others
    reset_global_scope()
    # each new op on the card against the CPU, at the flagship's
    # parameter shapes
    shapes = [tuple(state[n].shape) for n in params]
    rec["op_card_vs_cpu_rel_l2"] = optim_ops_card_vs_cpu(dev, shapes)
    rec["op_card_vs_cpu_tol"] = OPTIM_OP_REL_L2
    rec["parameter_shapes"] = shapes
    k1 = rec["k1"]["ms_per_batch_p50"]
    rec["trainer_lstm_k1_ms_per_batch_p50"] = base["k1"]["ms_per_batch_p50"]
    rec["k1_ms_per_batch_vs_trainer_lstm"] = (
        k1 / base["k1"]["ms_per_batch_p50"])
    rec["trainer_lstm_profile"] = {
        key: base["profile"][key] for key in (
            "wall_ms_per_step", "device_busy_ms_per_step",
            "device_idle_share", "device_kernels_per_step")}
    _say(f"trainer_lstm_recipe: ms a batch K=1 {k1:.2f} (trainer_lstm "
         f"{base['k1']['ms_per_batch_p50']:.2f}; in turns {turns}), K={k} "
         f"{rec[f'k{k}']['ms_per_batch_p50']:.2f}; {n_ops} registry ops a "
         f"step; device busy {rec['profile']['device_busy_ms_per_step']} "
         f"ms, idle share {rec['profile']['device_idle_share']}; lr within "
         f"{rec['checks']['lr_max_ulps']} ulp; worst op card vs CPU "
         f"{max(rec['op_card_vs_cpu_rel_l2'].values()):.2e}")
    del state
    torch.cuda.empty_cache()
    return {"trainer_lstm_recipe": rec}


def exec_resnet50_recipe(kernels, dev, resnet_rec):
    """Phase 6h's ``exec_resnet50_recipe``: 6e's batch-64 run with He et
    al.'s recipe (``Momentum(PiecewiseDecay(RESNET_BOUNDARIES,
    RESNET_VALUES), 0.9)``, ``L2Decay(RESNET_DECAY)`` on every parameter
    the builder creates): 3 + 20 steps, the fetched lr at each against
    the piecewise values, three more under ``torch.profiler``; host us a
    registry op; 6e's numbers beside, and 6e's run and the recipe's in
    turns (recipe / plain / plain / recipe: the host's speed drifts
    within a call)."""
    rec = _image_train_profiled(kernels, dev, "resnet50", recipe=True)
    turns = {"recipe": [rec], "plain": []}
    for recipe in (False, False, True):
        turns["recipe" if recipe else "plain"].append(_image_train(
            kernels, dev, "resnet50", IMAGE_B, 3, 20, recipe=recipe)[0])
        _release()
    rec["in_turns"] = {side: {key: [r[key] for r in runs] for key in (
        "ms_per_batch_p50", "host_ms_per_batch_p50", "wall_ms_per_batch",
        "images_per_s")} for side, runs in turns.items()}
    rec["in_turns_recipe_over_plain_ms"] = (
        sum(rec["in_turns"]["recipe"]["ms_per_batch_p50"])
        / sum(rec["in_turns"]["plain"]["ms_per_batch_p50"]))
    base = resnet_rec["exec_resnet50"][f"batch_{IMAGE_B}"]
    for r in (rec, base):
        r["host_us_per_registry_op"] = (r["host_ms_per_batch_p50"] * 1e3
                                        / r["registry_ops_per_step"])
    rec["exec_resnet50"] = {key: base[key] for key in (
        "ms_per_batch_p50", "host_ms_per_batch_p50", "wall_ms_per_batch",
        "images_per_s", "mfu", "registry_ops_per_step",
        "host_us_per_registry_op")}
    rec["exec_resnet50"]["profile"] = {key: base["profile"][key] for key in (
        "wall_ms_per_step", "device_busy_ms_per_step", "device_idle_share",
        "device_kernels_per_step")}
    _say(f"exec_resnet50_recipe: ms a batch p50 {rec['ms_per_batch_p50']:.2f}"
         f" (exec_resnet50 {base['ms_per_batch_p50']:.2f}), "
         f"{rec['registry_ops_per_step']} registry ops "
         f"({base['registry_ops_per_step']}), host "
         f"{rec['host_us_per_registry_op']:.1f} us an op; in turns "
         f"{rec['in_turns_recipe_over_plain_ms']:.3f}x plain; lr "
         f"{rec['lr_per_step']}")
    return {"exec_resnet50_recipe": rec}


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description="Chip smoke of the port.")
    ap.add_argument("--ref-tokens", type=argparse.FileType(),
                    help="greedy tokens of another tree's serve lines "
                    "(paddle_tpu_torch.kernels.paged_probe --serve): each "
                    "serve line reports greedy_equal_share_vs_parent")
    args = ap.parse_args(argv)
    ref_tokens = json.load(args.ref_tokens) if args.ref_tokens else {}

    def parent(key):
        return {"parent": ref_tokens[key]} if key in ref_tokens else {}

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on the "
              "card", file=sys.stderr)
        return 1
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_rnn as fr
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.kernels import quant_matmul as qm
    from paddle_tpu_torch.decode import beam_search
    from paddle_tpu_torch.serving import (DecodeEngine, DecoderConfig,
                                          init_params, make_pools)
    from paddle_tpu_torch.serving import decode_model as dm
    from paddle_tpu_torch.serving.decode_engine import _probe_kv_absmax
    from paddle_tpu_torch.models import seq2seq as s2s
    from paddle_tpu_torch.models import text as tx
    from paddle_tpu_torch.models import transformer as tt
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    card = _card_line()
    _say(card)

    t0 = time.perf_counter()
    built = _build.build()
    _say(f"build: {time.perf_counter() - t0:.3f} s, nvcc ran for "
         f"{built or 'none (cached)'}")
    for name, log in _build.build_logs.items():
        entry = ""  # the kernel ptxas reports on, mangled
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else ""
            elif "registers" in line or "spill" in line:
                _say(f"ptxas {name} {entry}: {line.strip()}")

    cfg = DecoderConfig(vocab_size=32000, d_model=768, n_heads=12,
                        head_dim=64, n_layers=12, d_ff=3072,
                        max_seq_len=512)
    kv = cfg.kv_config(block_size=16, num_blocks=2048)
    max_slots, budget = 16, 64
    shape = {"T": max_slots + budget, "H": cfg.n_heads,
             "d": cfg.head_dim, "B": kv.block_size,
             "P": kv.blocks_for(cfg.max_seq_len), "S": max_slots,
             "N": kv.num_blocks}
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    krec = check_attention(pa, dev, flush, shape)
    _say(f"kernel check: paged_attention_mixed max_abs_err "
         f"{krec['max_abs_err']:.3e} <= {ATTN_TOL}")
    lanes = {"float32": krec}
    for dtype in ("bfloat16", "int8", "fp8-e4m3"):
        lanes[dtype] = check_attention(pa, dev, flush, shape, dtype)
        _say(f"kernel check: {lanes[dtype]['name']} max_abs_err "
             f"{lanes[dtype]['max_abs_err']:.3e} <= {ATTN_TOL}")
    qrecs = {}
    for lane in ("int8", "fp8-e4m3"):
        qrecs[lane] = check_quant_matmul(qm, dev, flush, cfg, lane,
                                         M=shape["T"])
        _say(f"kernel check: {qrecs[lane]['name']} max_abs_err "
             f"{qrecs[lane]['max_abs_err']:.3e} (<= {QMM_TOL[lane]} of "
             f"max|out| per shape, and within quant_matmul_error_bound); "
             f"library: {qrecs[lane]['library_note']}")
    # 3c: the decode-step kernel (B3/B4) and the chunk kernel (B5/B6)
    dlanes, clanes = {}, {}
    for dtype in ("float32", "bfloat16", "int8", "fp8-e4m3"):
        dlanes[dtype] = check_decode_attention(pa, dev, flush, shape, dtype)
        clanes[dtype] = check_chunk_attention(pa, dev, flush, shape, dtype)
        for rec in (dlanes[dtype], clanes[dtype]):
            _say(f"kernel check: {rec['name']} max_abs_err "
                 f"{rec['max_abs_err']:.3e} <= {ATTN_TOL}")
    # 3d: the flash-attention forward (B8) and backward (B9), both lanes,
    # at head_dim 64 (the flagship's) and at the kernels' 128 capacity
    flanes, fwide = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        flanes[dtype] = check_flash(fa, kernels, dev, flush, dtype)
        fwide[dtype] = check_flash(fa, kernels, dev, flush, dtype,
                                   FLASH_WIDE_SHAPES, "_d128")
        for rec in (*flanes[dtype].values(), *fwide[dtype].values()):
            _say(f"kernel check: {rec['name']} max_abs_err "
                 f"{rec['max_abs_err']:.3e}")
    # 3e: the GRU forward (B12) and backward (B13: recurrence, dW)
    glanes = {}
    for D in GRU_F32_GRID_D:
        _say(f"gru plan fp32 D {D}: " + json.dumps(
            fr._cluster_plan(torch.float32, S2S_B, D, dev, ng=3)._asdict()))
    for dtype in (torch.float32, torch.bfloat16):
        glanes[dtype] = check_gru(fr, kernels, dev, flush, dtype)
        if dtype == torch.float32:   # hidden 640: the streaming route
            glanes[dtype].update(check_gru_stream_fp32(fr, kernels, dev,
                                                       flush))
        for rec in glanes[dtype].values():
            _say(f"kernel check: {rec['name']} max_abs_err "
                 f"{rec['max_abs_err']:.3e}")
    # 3f: the LSTM kernels, B10/B11 (dynamic_lstm) and B14/B15 (fused_lstm)
    llanes = {}
    for D in LSTM_F32_GRID_D:
        _say(f"lstm plan fp32 D {D}: " + json.dumps(
            fr._cluster_plan(torch.float32, TEXT_B, D, dev)._asdict()))
    for dtype in (torch.float32, torch.bfloat16):
        llanes[dtype] = check_lstm(fr, kernels, dev, flush, dtype)
        # bf16 past D 512: the grid route at hidden 1024 and 1280 (both
        # of the 1280 model's layers), the streaming route at hidden 640;
        # fp32 at hidden 640, a D its grid route does not take: streaming
        for route, lshape, sfx, e2 in (LSTM_WIDE_CHECKS
                                       if dtype == torch.bfloat16
                                       else LSTM_WIDE_CHECKS_FP32):
            wide = check_lstm_wide(fr, kernels, dev, flush, route, lshape,
                                   sfx, dtype=dtype)
            if e2:
                layer2 = check_lstm_wide(fr, kernels, dev, flush, route,
                                         lshape[:3] + (e2,), sfx,
                                         names=LSTM_WIDE_NAMES[2:])
                for k, rec in layer2.items():
                    wide[k].update({f"layer2_{f}": rec[f] for f in (
                        "ms", "device_ms", "plain_ms", "bound_ms",
                        "bound_by", "max_abs_err", "recurrence_device_ms",
                        "us_per_step", "shape",
                        "err_vs_fp32_and_plain_bf16_err") if f in rec})
            llanes[dtype].update(wide)
            _say(f"lstm plan {str(dtype)[6:]} D {lshape[2]}: "
                 + json.dumps(next(iter(wide.values()))["plan"]))
        for rec in llanes[dtype].values():
            _say(f"kernel check: {rec['name']} max_abs_err "
                 f"{rec['max_abs_err']:.3e}")
    kernels.reset_launches()
    del flush
    _say(f"kernel phases done at {time.perf_counter() - t0:.1f} s")

    params = init_params(cfg, seed=0)
    mrec, fp32_logits = check_mixed_step(dm, make_pools, cfg, params, kv,
                                         shape["T"], max_slots)
    _say("mixed_step check: " + json.dumps(mrec))
    kv8 = cfg.kv_config(block_size=16, num_blocks=2048, dtype="int8")
    qparams = dm.quantize_decoder_params(cfg, params, "int8")
    cal = _probe_kv_absmax(cfg, qparams)
    mqrec = check_quant_mixed_step(dm, make_pools, cfg, qparams, kv8, cal,
                                   shape["T"], max_slots, fp32_logits)
    _say("quant mixed_step check: " + json.dumps(mqrec))
    # 4c: the whole-mode calls, fp32 and int8 KV + int8 weights
    wrec, fp32_whole, script = check_whole_steps(dm, make_pools, cfg,
                                                 params, kv, max_slots)
    _say("whole-mode steps check: " + json.dumps(wrec))
    wqrec = check_quant_whole_steps(dm, make_pools, cfg, qparams, kv8, cal,
                                    script, fp32_whole)
    _say("quant whole-mode steps check: " + json.dumps(wqrec))
    # 4d: one full-width training step, kernels vs plain flash versions,
    # with 12 heads of 64 and with 6 heads of 128
    for model in (TRAIN_CFG, TRAIN_D128_CFG):
        for dtype in (torch.float32, torch.bfloat16):
            torch.cuda.empty_cache()
            _say("train step check: " + json.dumps(
                check_train_step(tt, kernels, dev, dtype, model)))
    # 4e: one full-width seq2seq step, kernels vs plain GRU versions
    for rec in check_s2s_step(s2s, fr, kernels, dev):
        _say("seq2seq step check: " + json.dumps(rec))
    # 4f: one full-width flagship LSTM step, kernels vs plain versions;
    # then the published hidden-1280 classifier's AMP step (the grid
    # route) against its plain path
    for rec in check_text_step(tx, fr, kernels, dev):
        _say("lstm step check: " + json.dumps(rec))
    for rec in check_text_step(tx, fr, kernels, dev, widths=TEXT_1280_CFG,
                               fused_routes=(True,), fp32_kernels=False):
        _say("lstm step check 1280: " + json.dumps(rec))
    del qparams, fp32_logits, fp32_whole, script
    _say(f"step phases done at {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    srec, launches, fp32_tokens = serve(DecodeEngine, kernels, cfg, params,
                                        reference=parent("serve"))
    krec["launches"] = launches["paged_attention_mixed"]
    torch.cuda.synchronize()
    prec = profile_steps(dm, make_pools, cfg, params, kv, shape["T"],
                         max_slots, named=PAGED_PROFILE_NAMES[:1])

    # the slice's main path: int8 KV + int8 weights, the same 48 requests
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sqrec, qlaunch, q_tokens = serve(
        DecodeEngine, kernels, cfg, params, key="serve_quant",
        engine_kw=dict(kv_config=kv8, quant_plan="int8"),
        reference=dict(parent("serve_quant"), fp32=fp32_tokens))
    lanes["int8"]["launches"] = qlaunch["paged_attention_mixed_quant"]
    qrecs["int8"]["launches"] = qlaunch["quant_matmul"]
    # short runs: fp8 KV + fp8 weights, and bf16 KV with fp32 weights
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    s8rec, f8launch, f8_tokens = serve(
        DecodeEngine, kernels, cfg, params, key="serve_fp8", n_serve=16,
        engine_kw=dict(kv_config=cfg.kv_config(16, 2048, "fp8-e4m3"),
                       quant_plan="fp8-e4m3"), reference=parent("serve_fp8"))
    lanes["fp8-e4m3"]["launches"] = f8launch["paged_attention_mixed_quant"]
    qrecs["fp8-e4m3"]["launches"] = f8launch["quant_matmul"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sbrec, bflaunch, bf_tokens = serve(
        DecodeEngine, kernels, cfg, params, key="serve_bf16", n_serve=16,
        engine_kw=dict(kv_config=cfg.kv_config(16, 2048, "bfloat16")),
        reference=parent("serve_bf16"))
    lanes["bfloat16"]["launches"] = bflaunch["paged_attention_mixed"]
    torch.cuda.synchronize()
    qparams = dm.quantize_decoder_params(cfg, params, "int8")
    pqrec = profile_steps(dm, make_pools, cfg, qparams, kv8, shape["T"],
                          max_slots, cal=cal, key="profile_quant",
                          named=B7_PROFILE_NAMES + PAGED_PROFILE_NAMES[:1])
    del qparams
    _say(f"chunked serving phases done at {time.perf_counter() - t0:.1f} s")

    # 5c: the slice's main paths, whole-prompt prefill
    rungs = (16, 32, 64, 128, 256, 384)
    whole = dict(prefill_mode="whole", prompt_rungs=rungs)
    whole_runs = {}
    # (key, engine options, requests, the chunked run of the same pool
    # and weights)
    for key, kw, n_serve, chunked in (
            ("serve_whole", {}, None, fp32_tokens),
            ("serve_whole_static", dict(admission="static"), None,
             fp32_tokens),
            ("serve_whole_quant", dict(kv_config=kv8, quant_plan="int8"),
             None, q_tokens),
            ("serve_whole_fp8",
             dict(kv_config=cfg.kv_config(16, 2048, "fp8-e4m3"),
                  quant_plan="fp8-e4m3"), 16, f8_tokens),
            ("serve_whole_bf16",
             dict(kv_config=cfg.kv_config(16, 2048, "bfloat16")), 16,
             bf_tokens)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        refs = dict(parent(key), chunked=chunked)
        if "serve_whole" in whole_runs:
            refs["whole_fp32"] = whole_runs["serve_whole"][2]
        whole_runs[key] = serve(DecodeEngine, kernels, cfg, params,
                                key=key, engine_kw=dict(whole, **kw),
                                n_serve=n_serve, reference=refs,
                                solo_index=None)
    # requests without the shared prefix (even index): the same greedy
    # tokens continuous, static and served solo
    even = list(range(0, 48, 2))
    solo = solo_tokens(DecodeEngine, cfg, params, even, whole)
    cont = whole_runs["serve_whole"][2]
    stat = whole_runs["serve_whole_static"][2]
    for j in even:
        _check(cont[j] == stat[j] == solo[j],
               f"request {j}: whole continuous / static / solo tokens "
               "differ")
    for key in ("serve_whole", "serve_whole_static"):
        whole_runs[key][0][key]["no_prefix_equal_solo_and_across"] = \
            len(even)
    for dtype, key in (("float32", "serve_whole"),
                       ("int8", "serve_whole_quant"),
                       ("fp8-e4m3", "serve_whole_fp8"),
                       ("bfloat16", "serve_whole_bf16")):
        launch = whole_runs[key][1]
        sfx = "_quant" if dtype in ("int8", "fp8-e4m3") else ""
        dlanes[dtype]["launches"] = launch["paged_attention" + sfx]
        clanes[dtype]["launches"] = launch["paged_attention_chunk" + sfx]
    torch.cuda.synchronize()
    pwrec = profile_whole(dm, make_pools, cfg, params, kv, max_slots)
    _say(f"whole serving phases done at {time.perf_counter() - t0:.1f} s")

    # 5g: speculative decoding (a small draft; the target as its own
    # draft; int8) and copy-on-write beams, against the plain runs above
    dcfg = DecoderConfig(**SPEC_DRAFT_CFG)
    dparams = init_params(dcfg, seed=7)
    quant_eps = max(mqrec["logits_max_abs_err"], wqrec["logits_max_abs_err"])
    spec_runs = {}
    for key, kw, (dc, dp), plain, bound, scal in (
            ("serve_spec", dict(speculate_k=3), (dcfg, dparams),
             fp32_tokens, _near_tie(LOGIT_TOL), (None, None)),
            ("serve_spec_self", dict(whole, speculate_k=4), (cfg, params),
             whole_runs["serve_whole"][2], _near_tie(LOGIT_TOL),
             (None, None)),
            ("serve_spec_quant", dict(whole, speculate_k=3, kv_config=kv8,
                                      quant_plan="int8"), (dcfg, dparams),
             whole_runs["serve_whole_quant"][2],
             _near_tie(LOGIT_TOL, quant_eps), cal)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        spec_runs[key] = serve_spec(DecodeEngine, kernels, dm, make_pools,
                                    cfg, params, key, kw, dc, dp, plain,
                                    bound, scal)
        spec_runs[key][0][key]["card"] = card
    del dparams
    torch.cuda.empty_cache()
    sbeam_rec, sbeam_launch, sbeams = serve_beam(
        DecodeEngine, kernels, dm, make_pools, beam_search, cfg, params,
        rungs, _probe_kv_absmax(cfg, params))
    sbeam_rec["serve_beam"]["card"] = card
    # B1-B7's launches on these paths, beside each lane's main-path count
    spec_l = {k: v[1] for k, v in spec_runs.items()}
    for rec, name, keys in (
            (krec, "paged_attention_mixed", ("serve_spec",)),
            (lanes["int8"], "paged_attention_mixed_quant", ()),
            (dlanes["float32"], "paged_attention",
             ("serve_spec", "serve_spec_self")),
            (dlanes["int8"], "paged_attention_quant", ("serve_spec_quant",)),
            (clanes["float32"], "paged_attention_chunk",
             ("serve_spec", "serve_spec_self")),
            (clanes["int8"], "paged_attention_chunk_quant",
             ("serve_spec_quant",)),
            (qrecs["int8"], "quant_matmul", ("serve_spec_quant",))):
        rec["launches_5g"] = dict({k: spec_l[k][name] for k in keys},
                                  serve_beam=sbeam_launch[name])
    _say(f"speculative and beam phases done at "
         f"{time.perf_counter() - t0:.1f} s")

    # 5h: the serving telemetry plane: the chunked fp32 burst with
    # telemetry and its capture, the int8 speculative line, the int8
    # beam, and the ledger's cost in turns
    doc_names = _doc_metric_names()
    tel_dir = tempfile.mkdtemp(prefix="chip_smoke_telemetry_")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    stel_rec, stel_launch, ptel_launch = serve_telemetry(
        DecodeEngine, kernels, dm, make_pools, cfg, params, fp32_tokens,
        os.path.join(tel_dir, "serve"), doc_names, card)
    stel_rec["serve_telemetry"]["profile_telemetry"]["profile_line"] = {
        k: prec["profile"][k] for k in ("wall_ms_per_step",
                                        "device_busy_ms_per_step",
                                        "device_idle_share")}
    torch.cuda.empty_cache()
    tel_spec = _telemetry(os.path.join(tel_dir, "spec"))
    dparams = init_params(dcfg, seed=7)
    sqtel_rec, sqtel_launch, _ = serve_spec(
        DecodeEngine, kernels, dm, make_pools, cfg, params,
        "serve_telemetry_spec_quant",
        dict(whole, speculate_k=3, kv_config=kv8, quant_plan="int8",
             telemetry=tel_spec), dcfg, dparams,
        spec_runs["serve_spec_quant"][2], _near_tie(LOGIT_TOL, quant_eps),
        cal, check=spec_ledger_check(tel_spec, doc_names))
    tel_spec.close()
    sqtel_rec["serve_telemetry_spec_quant"]["card"] = card
    del dparams
    torch.cuda.empty_cache()
    btel_rec, btel_launch = serve_telemetry_beam(
        DecodeEngine, kernels, cfg, params, rungs,
        sbeams["chunked_int8"][0], card)
    torch.cuda.empty_cache()
    lo_rec, lo_launch = ledger_overhead(DecodeEngine, kernels, cfg, params,
                                        card)
    krec["launches_5h"] = {
        "serve_telemetry": stel_launch["paged_attention_mixed"],
        "profile_telemetry": ptel_launch, "ledger_overhead": lo_launch}
    for rec, name, runs in (
            (lanes["int8"], "paged_attention_mixed_quant",
             {"serve_telemetry_beam": btel_launch}),
            (dlanes["int8"], "paged_attention_quant",
             {"serve_telemetry_spec_quant": sqtel_launch,
              "serve_telemetry_beam": btel_launch}),
            (clanes["int8"], "paged_attention_chunk_quant",
             {"serve_telemetry_spec_quant": sqtel_launch}),
            (qrecs["int8"], "quant_matmul",
             {"serve_telemetry_spec_quant": sqtel_launch})):
        rec["launches_5h"] = {k: v[name] for k, v in runs.items()}
    shutil.rmtree(tel_dir)
    _say(f"telemetry phases done at {time.perf_counter() - t0:.1f} s")

    # 5d: the training slice's main path: bf16 with the flash kernels,
    # then the same steps with the plain attention ("xla") and a short
    # fp32 run (the fp32 lanes' launches); then the 6 x 128 heads' model
    # in both lanes (the head_dim-128 instantiations' launches)
    del params
    train_runs = {}
    for key, kw in (("train_transformer", {}),
                    ("train_xla", dict(attn_impl="xla", kstep=None)),
                    ("train_fp32", dict(dtype=torch.float32, warmup=2,
                                        steps=5, kstep=None)),
                    ("train_d128", dict(model=TRAIN_D128_CFG, warmup=2,
                                        steps=10, kstep=None)),
                    ("train_d128_fp32", dict(model=TRAIN_D128_CFG,
                                             dtype=torch.float32, warmup=2,
                                             steps=5, kstep=None))):
        torch.cuda.empty_cache()
        ref = (train_runs["train_transformer"][2] if key == "train_xla"
               else None)
        train_runs[key] = train(tt, kernels, dev, key=key, reference=ref,
                                **kw)
    for dtype, key, wkey in (
            (torch.float32, "train_fp32", "train_d128_fp32"),
            (torch.bfloat16, "train_transformer", "train_d128")):
        for name, rec in flanes[dtype].items():
            rec["launches"] = train_runs[key][1][name]
        for name, rec in fwide[dtype].items():
            rec["launches"] = train_runs[wkey][1][name]
            rec["launches_run"] = wkey
    torch.cuda.empty_cache()
    ptrec = profile_train(tt, dev)
    _say(f"training phases done at {time.perf_counter() - t0:.1f} s")

    # 5e: the seq2seq slice's main paths: bf16 training through B12/B13,
    # a short fp32 run (the fp32 lanes of B13), beam-search generation
    s2s_runs = {}
    for key, kw in (("train_seq2seq", {}),
                    ("train_seq2seq_fp32", dict(dtype=torch.float32,
                                                warmup=2, steps=5)),
                    ("train_seq2seq_640_fp32", dict(
                        dtype=torch.float32, warmup=1, steps=2,
                        widths=S2S_640_CFG))):
        torch.cuda.empty_cache()
        s2s_runs[key] = train_s2s(s2s, kernels, dev, key=key, **kw)
    torch.cuda.empty_cache()
    beam_rec, beam_launch = generate_beam(s2s, fr, kernels, dev)
    for dtype, key in ((torch.float32, "train_seq2seq_fp32"),
                       (torch.bfloat16, "train_seq2seq")):
        for name, rec in glanes[dtype].items():
            if "_stream_d" in name:   # the hidden-640 run's launches
                rec["launches"] = s2s_runs["train_seq2seq_640_fp32"][1][
                    name.split("_d")[0]]
                rec["launches_run"] = "train_seq2seq_640_fp32"
            else:
                rec["launches"] = s2s_runs[key][1][name]
    # fp32 B12's main path is generation (timed at its shape)
    fwd32 = glanes[torch.float32]["gru_fwd"]
    fwd32["launches_train_seq2seq_fp32"] = fwd32["launches"]
    fwd32["launches"] = beam_launch["gru_fwd"]
    torch.cuda.empty_cache()
    psrec = profile_s2s(s2s, dev)
    _say(f"seq2seq phases done at {time.perf_counter() - t0:.1f} s")

    # 5f: the text-classification slice's main paths: the flagship
    # (fused_lstm, AMP) through B14/B15, the composed and the ragged
    # routes through B10/B11, short fp32 runs (the fp32 lanes)
    text_runs = {}
    for key, kw in (
            ("train_lstm", {}),
            ("train_lstm_composed", dict(fused_proj=False)),
            ("train_lstm_ragged", dict(ragged=True)),
            ("train_lstm_fp32", dict(amp=False, warmup=2, steps=5)),
            ("train_lstm_composed_fp32", dict(fused_proj=False, amp=False,
                                              warmup=2, steps=5)),
            ("train_lstm_wide", dict(widths=TEXT_WIDE_CFG, warmup=1,
                                     steps=3)),
            ("train_lstm_wide_ragged", dict(widths=TEXT_WIDE_CFG,
                                            ragged=True, warmup=1,
                                            steps=3)),
            ("train_lstm_1280", dict(widths=TEXT_1280_CFG, warmup=1,
                                     steps=3)),
            ("train_lstm_1280_ragged", dict(widths=TEXT_1280_CFG,
                                            ragged=True, warmup=1,
                                            steps=3)),
            ("train_lstm_640", dict(widths=TEXT_640_CFG, warmup=1,
                                    steps=3)),
            ("train_lstm_640_ragged", dict(widths=TEXT_640_CFG, ragged=True,
                                           warmup=1, steps=3)),
            ("train_lstm_640_fp32", dict(widths=TEXT_640_CFG, amp=False,
                                         warmup=1, steps=2)),
            ("train_lstm_640_composed_fp32", dict(
                widths=TEXT_640_CFG, fused_proj=False, amp=False, warmup=1,
                steps=2))):
        torch.cuda.empty_cache()
        text_runs[key] = train_text(tx, kernels, dev, key=key, **kw)
    for dtype, proj_key, comp_key, wide_rows in (
            (torch.float32, "train_lstm_fp32", "train_lstm_composed_fp32",
             LSTM_WIDE_ROWS_FP32),
            (torch.bfloat16, "train_lstm", "train_lstm_composed",
             LSTM_WIDE_ROWS)):
        for name, rec in llanes[dtype].items():
            if name in wide_rows:
                key = wide_rows[name]
                rec["launches"] = text_runs[key][1][name.replace("_d1280",
                                                                 "")]
                rec["launches_run"] = key
                continue
            key = (proj_key if name in LSTM_PROJ or name in LSTM_PASSES
                   else comp_key)
            rec["launches"] = text_runs[key][1][name]
            rec["launches_run"] = key
            if name in LSTM_WIDE_NAMES:
                rec["launches_by_route"] = {
                    r: text_runs[key][1][f"{name}{sfx}"]
                    for r, sfx in LSTM_ROUTE_SUFFIX.items()}
    torch.cuda.empty_cache()
    plrec = profile_text(tx, dev)
    torch.cuda.empty_cache()
    pcrec = profile_text(tx, dev, fused_proj=False)
    torch.cuda.empty_cache()
    plwrec = profile_text(tx, dev, widths=TEXT_1280_CFG)
    wide = text_runs["train_lstm_1280"][0]["train_lstm_1280"]
    wide.update({"device_busy_ms_per_step_profiled":
                 plwrec["profile_lstm_wide"]["device_busy_ms_per_step"],
                 "device_idle_share_profiled":
                 plwrec["profile_lstm_wide"]["device_idle_share"]})
    fused = text_runs["train_lstm"][0]["train_lstm"]
    composed = text_runs["train_lstm_composed"][0]["train_lstm_composed"]
    fused["ms_per_batch_vs_composed"] = (fused["ms_per_batch_p50"]
                                         / composed["ms_per_batch_p50"])
    for run, prof in ((fused, plrec["profile_lstm"]),
                      (composed, pcrec["profile_lstm_composed"])):
        run.update({"device_busy_ms_per_step_profiled":
                    prof["device_busy_ms_per_step"],
                    "device_idle_share_profiled": prof["device_idle_share"]})
    _say(f"lstm phases done at {time.perf_counter() - t0:.1f} s")

    # 6: the framework core: the MNIST MLP through the layers DSL and the
    # Executor, then the classifier's op list as a Program through it
    torch.cuda.empty_cache()
    mlp_rec = exec_mlp(dev)
    torch.cuda.empty_cache()
    xtext_rec = exec_text(tx, kernels, dev, fused["ms_per_batch_p50"])
    xtext_rec["exec_text"]["profile_lstm"] = {
        k: plrec["profile_lstm"][k] for k in (
            "wall_ms_per_step", "device_busy_ms_per_step",
            "device_idle_share", "device_kernels_per_step")}
    _say(f"executor phases done at {time.perf_counter() - t0:.1f} s")

    # 6c / 6d: the training entry point: the flagship through the Trainer,
    # and a dynamic_gru program through the Executor
    torch.cuda.empty_cache()
    trainer_rec = trainer_lstm(
        tx, fr, kernels, dev, fused["ms_per_batch_p50"],
        xtext_rec["exec_text"]["uniform"]["ms_per_batch_p50"])
    torch.cuda.empty_cache()
    gru_prog_rec = exec_gru(fr, kernels, dev)
    _say(f"trainer phases done at {time.perf_counter() - t0:.1f} s")

    # 6e-6g: the image-classification path: ResNet-50 at bench.py's batch
    # 64 (and 128, 256), the other image models, the conv book models
    # through the Trainer
    torch.cuda.empty_cache()
    resnet_rec = exec_resnet50(kernels, dev)
    image_rec = exec_image(kernels, dev)
    trainer_image_rec = trainer_image(kernels)
    _say(f"image phases done at {time.perf_counter() - t0:.1f} s")

    # 6h: the rest of training's core: the flagship and ResNet-50 trained
    # to a full recipe, the other optimizers, the new ops card vs CPU
    torch.cuda.empty_cache()
    recipe_rec = trainer_lstm_recipe(kernels, dev, trainer_rec)
    resnet_recipe_rec = exec_resnet50_recipe(kernels, dev, resnet_rec)
    _release()
    _say(f"recipe phases done at {time.perf_counter() - t0:.1f} s")

    _say(json.dumps(prec))
    _say(json.dumps(pqrec))
    _say(json.dumps(pwrec))
    _say(json.dumps(ptrec))
    _say(json.dumps(psrec))
    _say(json.dumps(plrec))
    _say(json.dumps(pcrec))
    _say(json.dumps(plwrec))
    _say(json.dumps({"kernels": [
        krec, lanes["bfloat16"], lanes["int8"], lanes["fp8-e4m3"],
        *(dlanes[d] for d in ("float32", "bfloat16", "int8", "fp8-e4m3")),
        *(clanes[d] for d in ("float32", "bfloat16", "int8", "fp8-e4m3")),
        qrecs["int8"], qrecs["fp8-e4m3"],
        *(flanes[d][n] for d in (torch.float32, torch.bfloat16)
          for n in FLASH_KERNELS),
        *(fwide[d][n] for d in (torch.float32, torch.bfloat16)
          for n in FLASH_KERNELS),
        *(glanes[d][n] for d in (torch.float32, torch.bfloat16)
          for n in GRU_KERNELS),
        *(glanes[torch.float32][f"{n}_stream_d{GRU_STREAM_FP32[2]}"]
          for n in ("gru_fwd", "gru_bwd")),
        *(llanes[d][n] for d in (torch.float32, torch.bfloat16)
          for n in LSTM_KERNELS),
        *(llanes[d][n] for d in (torch.float32, torch.bfloat16)
          for n in LSTM_PASSES),
        *(llanes[torch.float32][n] for n in LSTM_WIDE_ROWS_FP32),
        *(llanes[torch.bfloat16][n] for n in LSTM_WIDE_ROWS)]}))
    _say(json.dumps(srec))
    for rec in (sqrec, s8rec, sbrec):
        _say(json.dumps(rec))
    for key in whole_runs:
        _say(json.dumps(whole_runs[key][0]))
    for key in spec_runs:
        _say(json.dumps(spec_runs[key][0]))
    _say(json.dumps(sbeam_rec))
    for rec in (stel_rec, sqtel_rec, btel_rec, lo_rec):
        _say(json.dumps(rec))
    for key in train_runs:
        _say(json.dumps(train_runs[key][0]))
    for key in s2s_runs:
        _say(json.dumps(s2s_runs[key][0]))
    _say(json.dumps(beam_rec))
    for key in text_runs:
        _say(json.dumps(text_runs[key][0]))
    _say(json.dumps(mlp_rec))
    _say(json.dumps(xtext_rec))
    _say(json.dumps(trainer_rec))
    _say(json.dumps(gru_prog_rec))
    _say(json.dumps(resnet_rec))
    _say(json.dumps(image_rec))
    _say(json.dumps(trainer_image_rec))
    _say(json.dumps(recipe_rec))
    _say(json.dumps(resnet_recipe_rec))
    _say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
