"""Operators of the port, registered in ``framework.registry`` on
import: ``math`` (mul, elementwise_add, sum, mean, lookup_table, top_k,
and the initializers' fill_constant, uniform_random, gaussian_random),
``activation`` (softmax, relu), ``loss`` (softmax_with_cross_entropy
and the ``nll_from_logits`` helper of the transformer and seq2seq
models), ``metric`` (accuracy), ``optimizer_ops`` (sgd, adam),
``sequence`` (sequence_pool) and ``rnn`` (dynamic_lstm and fused_lstm
over the fused LSTM kernels, and the helpers of the fused recurrence:
its engagement predicate, ragged reversal)."""
from paddle_tpu_torch.ops import (activation, loss, math, metric,
                                  optimizer_ops, rnn, sequence)

__all__ = ["activation", "loss", "math", "metric", "optimizer_ops", "rnn",
           "sequence"]
