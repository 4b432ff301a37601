"""Models of the port: ``models.transformer``, the transformer LM (pure
functions over a params tree, trained with SGD + momentum);
``models.seq2seq``, the GRU encoder-decoder NMT model with attention
(trained with Adam, generating by beam search); ``models.text``, the
IMDB LSTM text classifier (``lstm_benchmark_net``: ops run one at a time
as the Executor runs them, trained with SGD or Adam, AMP; and as a
``Program`` for the Executor, ``build_program``) and the text nets built
by the layers DSL; ``models.mnist``, the MNIST MLP built by the layers
DSL, and its LeNet-style ``conv`` net; ``models.image``, the image
classifiers (AlexNet, VGG-16, ResNet, GoogLeNet, SmallNet) built by the
layers DSL; and ``models.book``, the book models' graph builders."""
from paddle_tpu_torch.models import (book, image, mnist, seq2seq, text,
                                     transformer)

__all__ = ["book", "image", "mnist", "seq2seq", "text", "transformer"]
