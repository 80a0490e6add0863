"""paddle_tpu_torch.models — the model zoo (BERT and the ResNets)."""
from .bert import (Bert, BertConfig, BertEmbeddings, BertForPretraining,
                   MultiHeadAttention, TransformerEncoderLayer)
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34,
                     resnet50, resnet101, resnet152)

__all__ = ["Bert", "BertConfig", "BertEmbeddings", "BertForPretraining",
           "MultiHeadAttention", "TransformerEncoderLayer", "BasicBlock",
           "BottleneckBlock", "ResNet", "resnet18", "resnet34", "resnet50",
           "resnet101", "resnet152"]
