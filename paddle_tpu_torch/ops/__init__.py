"""Operators of the port: ``loss.nll_from_logits`` (the transformer's
and the seq2seq model's loss) and the ``rnn`` helpers of the fused
recurrence (its engagement predicate, ragged reversal); the registered
ops wait for the Program/Executor slices."""
