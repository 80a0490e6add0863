"""paddle_tpu_torch.nn — the Layers the BERT and ResNet paths use."""
from .layer import Layer
from .container import LayerList, Sequential
from .layers import (AdaptiveAvgPool2D, BatchNorm, BatchNorm1D, BatchNorm2D,
                     Conv2D, Dropout, Embedding, Flatten, LayerNorm, Linear,
                     MaxPool2D, ReLU)

__all__ = ["Layer", "LayerList", "Sequential", "AdaptiveAvgPool2D",
           "BatchNorm", "BatchNorm1D", "BatchNorm2D", "Conv2D", "Dropout",
           "Embedding", "Flatten", "LayerNorm", "Linear", "MaxPool2D",
           "ReLU"]
