"""Operators of the port, registered in ``framework.registry`` on
import: ``math`` (mul, matmul, the elementwise ops, scale, sum, mean,
cast, concat, split, stack, reshape, transpose, lookup_table, top_k,
sign, assign, increment, isfinite, tensor_stats, and the initializers'
fill_constant, uniform_random, gaussian_random), ``activation``
(softmax, relu, sigmoid, tanh, sqrt),
``loss`` (softmax_with_cross_entropy, square_error_cost,
squared_l2_norm and the ``nll_from_logits`` helper of the transformer
and seq2seq models), ``metric`` (accuracy), ``nn`` (conv,
pooling, batch and layer norm, dropout, lrn, pad and the rest of the
JAX package's ``ops/nn.py``), ``optimizer_ops`` (the JAX package's
whole: every optimizer's update, lr_schedule, ema_update and the
pruning pair), ``sequence`` (sequence_pool, sequence_conv) and ``rnn``
(dynamic_lstm and fused_lstm over the fused LSTM kernels, dynamic_gru
over the fused GRU kernels, and the helpers of the fused recurrence:
its engagement predicate, ragged reversal)."""
from paddle_tpu_torch.ops import (activation, loss, math, metric, nn,
                                  optimizer_ops, rnn, sequence)

__all__ = ["activation", "loss", "math", "metric", "nn", "optimizer_ops",
           "rnn", "sequence"]
