"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for Hopper.

The port is built slice by slice beside the JAX package, which stays
the reference it is held against. The framework core: the Program IR,
the layers DSL, ``optimizer`` (SGD, Momentum, Adam, Adagrad, Adamax,
DecayedAdagrad, AdaDelta, RMSProp, Ftrl, ``ModelAverage``; a number or
an ``lr_scheduler`` schedule as the learning rate, ``global_clip_norm=``
through ``clip``, ``regularizer``'s weight decay) and the eager
``Executor`` (``framework.executor``; feeds, fetches
and the Scope, the ``backward`` pseudo-op through ``torch.autograd``,
AMP, ``run_multi``, ``prepare_infer``), used as in the JAX package::

    import paddle_tpu_torch as pt
    x = pt.layers.data("x", [8])
    label = pt.layers.data("label", [1], dtype="int64")
    logits = pt.layers.fc(pt.layers.fc(x, 32, act="relu"), 3)
    loss = pt.layers.mean(pt.layers.softmax_with_cross_entropy(logits, label))
    pt.optimizer.Adam(0.01).minimize(loss)
    exe = pt.Executor(pt.CUDAPlace(0))
    exe.run(pt.default_startup_program())

The training entry point, as in the JAX package: the text nets and the
book models built by the DSL (``models.text``, ``models.book``,
``nets``), ``Trainer.train(reader, num_passes, event_handler)`` with
its ``event``s, the ``DataFeeder``, the ``reader`` decorators (the
card-side double buffer ``reader.device_buffered`` among them), the
``datasets`` (the JAX package's thirteen), ``reader.provider`` and
checkpoints (``io``, the
JAX package's on-disk format)::

    trainer = pt.Trainer(cost=loss, optimizer=pt.optimizer.Adam(0.01),
                         feed_list=[x, label], place=pt.CUDAPlace(0))
    trainer.train(pt.reader.batch(sample_reader, 64), num_passes=1)

The observability planes (``obs``): ``Telemetry`` sessions for the
Executor, the Trainer and the decode engine, the training health
monitor (``Trainer(health=)``), the numerics observatory
(``Trainer(numerics=pt.obs.NumericsSpec(...))``), the cost plane
(``Executor.cost_report``, a ``CostReport`` with the hand-written
kernels' FLOPs ledger), the profiler, alerts and the flight recorder::

    tel = pt.obs.Telemetry(trace_path="trace.jsonl")
    trainer = pt.Trainer(..., health="warn",
                         numerics=pt.obs.NumericsSpec(sample_every=8))
    trainer.train(reader, telemetry=tel, profile_steps=(5, 8))

Fixed-shape serving of a program built with the DSL, as in the JAX
package: ``ServingEngine`` (micro-batching up a ``BucketLadder``, a pad
worker and a dispatch worker over ``Executor.prepare_infer``'s session)
and the synchronous ``Inferencer`` / ``infer`` over a
``save_inference_model`` directory::

    eng = pt.ServingEngine(program=main.clone(for_test=True),
                           feed_names=["x"], fetch_names=[y.name],
                           executor=pt.Executor(pt.CUDAPlace(0)),
                           ladder=pt.BucketLadder(max_batch=8))
    rows = eng.infer({"x": batch})

The other slices so far are generative serving: ``serving.DecodeEngine``
with chunked or whole-prompt prefill and continuous or static admission
over a block-paged KV cache (float32, bfloat16, or int8 / fp8-e4m3 with
per-block scales), with fp32 or quantized projection weights; training
the transformer LM (``models.transformer``: bf16 compute over fp32
master weights, SGD with momentum); the seq2seq NMT model
(``models.seq2seq``: Adam training, beam-search generation through
``decode.beam_search``); and the IMDB LSTM classifier (``models.text``,
also as a Program for the Executor). Their kernels (the mixed-step,
decode-step and chunk forms of paged attention in
``kernels.paged_attention``, ``kernels.quant_matmul``, the
flash-attention forward and backward in ``kernels.flash_attention``,
and the GRU and LSTM recurrences in ``kernels.fused_rnn``) are written
by hand in CUDA C++ for sm_90a.

Entry points run on the CUDA card by default (``Executor()`` and
``default_place()`` raise without one); ``CPUPlace()`` /
``device="cpu"`` is the explicit opt-in the tests use, where every
kernel wrapper takes its plain PyTorch version. Nothing here imports
JAX or ``paddle_tpu``.
"""
from paddle_tpu_torch.core import CPUPlace, CUDAPlace, LoD, LoDTensor, Scope
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.framework.executor import Executor
from paddle_tpu_torch.framework.program import (Program,
                                                default_main_program,
                                                default_startup_program,
                                                program_guard)
from paddle_tpu_torch import (datasets, event, initializer, io, layers,
                              lr_scheduler, nets, obs, optimizer, reader,
                              regularizer)
from paddle_tpu_torch.data_feeder import DataFeeder
from paddle_tpu_torch.inference import Inferencer, infer
from paddle_tpu_torch.param_attr import ParamAttr
from paddle_tpu_torch.serving import BucketLadder, ServingEngine
from paddle_tpu_torch.trainer import Trainer

__all__ = ["BucketLadder", "CPUPlace", "CUDAPlace", "DataFeeder",
           "Executor", "Inferencer", "LoD", "LoDTensor", "ParamAttr",
           "Program", "Scope", "ServingEngine", "Trainer", "datasets",
           "default_main_program", "default_startup_program", "event",
           "infer", "initializer", "io", "layers", "lr_scheduler", "nets",
           "obs", "optimizer", "program_guard", "reader", "regularizer",
           "resolve_device"]
