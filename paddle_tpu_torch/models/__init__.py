"""Models of the port: ``models.transformer``, the transformer LM (pure
functions over a params tree, trained with SGD + momentum);
``models.seq2seq``, the GRU encoder-decoder NMT model with attention
(trained with Adam, generating by beam search); and ``models.text``, the
IMDB LSTM text classifier (``lstm_benchmark_net``: ops run one at a time
as the JAX Executor runs them, trained with SGD or Adam, AMP)."""
from paddle_tpu_torch.models import seq2seq, text, transformer

__all__ = ["seq2seq", "text", "transformer"]
