"""paddle_tpu_torch.nn — the Layers the BERT serving path uses."""
from .layer import Layer
from .container import LayerList, Sequential
from .layers import Dropout, Embedding, LayerNorm, Linear

__all__ = ["Layer", "LayerList", "Sequential", "Dropout", "Embedding",
           "LayerNorm", "Linear"]
