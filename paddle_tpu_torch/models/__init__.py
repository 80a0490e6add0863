"""paddle_tpu_torch.models — the model zoo (this slice: BERT)."""
from .bert import (Bert, BertConfig, BertEmbeddings, BertForPretraining,
                   MultiHeadAttention, TransformerEncoderLayer)

__all__ = ["Bert", "BertConfig", "BertEmbeddings", "BertForPretraining",
           "MultiHeadAttention", "TransformerEncoderLayer"]
