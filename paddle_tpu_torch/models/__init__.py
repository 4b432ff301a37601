"""Models of the port: ``models.transformer``, the transformer LM (pure
functions over a params tree, trained with SGD + momentum), and
``models.seq2seq``, the GRU encoder-decoder NMT model with attention
(trained with Adam, generating by beam search)."""
from paddle_tpu_torch.models import seq2seq, transformer

__all__ = ["seq2seq", "transformer"]
