"""Operators of the port, registered in ``framework.registry`` on
import: ``math`` (mul, matmul, the elementwise ops, scale, sum, mean,
concat, split, lookup_table, top_k, and the initializers'
fill_constant, uniform_random, gaussian_random), ``activation``
(softmax, relu, sigmoid, tanh), ``loss`` (softmax_with_cross_entropy,
square_error_cost and the ``nll_from_logits`` helper of the transformer
and seq2seq models), ``metric`` (accuracy), ``optimizer_ops`` (sgd,
adam), ``sequence`` (sequence_pool, sequence_conv) and ``rnn``
(dynamic_lstm and fused_lstm over the fused LSTM kernels, dynamic_gru
over the fused GRU kernels, and the helpers of the fused recurrence:
its engagement predicate, ragged reversal)."""
from paddle_tpu_torch.ops import (activation, loss, math, metric,
                                  optimizer_ops, rnn, sequence)

__all__ = ["activation", "loss", "math", "metric", "optimizer_ops", "rnn",
           "sequence"]
