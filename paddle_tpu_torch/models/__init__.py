"""Models of the port: ``models.transformer``, the transformer LM (pure
functions over a params tree, trained with SGD + momentum)."""
from paddle_tpu_torch.models import transformer

__all__ = ["transformer"]
