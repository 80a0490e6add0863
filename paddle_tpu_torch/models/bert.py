"""BERT — counterpart of ``paddle_tpu/models/bert.py``.

Same configuration knobs, module names and parameter layouts as the JAX
model, so ``state_dict()`` keys match (and ``parameters()`` come in the
same order), and weights carry across with
:func:`paddle_tpu_torch.convert.load_jax_state`. Self-attention runs the
port's flash-attention kernels (forward, in-kernel attention dropout,
dQ and dK/dV backward) and every LayerNorm the port's layer-norm kernels
(forward and backward); the dense projections are ``torch.matmul``, cast
to bf16 under :func:`paddle_tpu_torch.amp.auto_cast`. The model serves
(``Bert``) and trains (``BertForPretraining.loss``, then ``backward()``
and an optimizer step); recompute and mixture-of-experts layers are not
ported yet and raise.
"""
from __future__ import annotations

import torch

from .. import nn
from ..ops import loss as L
from ..ops import math as M
from ..ops import nn_ops as F
from ..ops.kernels.flash_attention import flash_attention


class BertConfig:
    def __init__(self, vocab_size=30522, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, hidden_dropout_prob=0.1,
                 attention_probs_dropout_prob=0.1,
                 max_position_embeddings=512, type_vocab_size=2,
                 layer_norm_eps=1e-12, use_flash_attention=True,
                 use_recompute=False, moe_num_experts=0, moe_every=2,
                 moe_capacity_factor=1.25):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.layer_norm_eps = layer_norm_eps
        self.use_flash_attention = use_flash_attention
        self.use_recompute = use_recompute
        self.moe_num_experts = moe_num_experts
        self.moe_every = moe_every
        self.moe_capacity_factor = moe_capacity_factor

    @staticmethod
    def base(**kw):
        return BertConfig(**kw)

    @staticmethod
    def tiny(**kw):
        d = dict(vocab_size=1024, hidden_size=128, num_hidden_layers=2,
                 num_attention_heads=2, intermediate_size=512,
                 max_position_embeddings=128)
        d.update(kw)
        return BertConfig(**d)


class MultiHeadAttention(nn.Layer):
    """Self-attention: one fused QKV projection, then flash attention."""

    def __init__(self, config: BertConfig):
        super().__init__()
        d = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.head_dim = d // self.num_heads
        self.qkv = nn.Linear(d, 3 * d)
        self.out = nn.Linear(d, d)
        self.dropout_p = config.attention_probs_dropout_prob
        self.use_flash = config.use_flash_attention

    def forward(self, x, attn_mask=None):
        b, s, d = x.shape
        qkv = self.qkv(x).reshape(b, s, 3, self.num_heads, self.head_dim)
        # 3, B, H, S, D: views with strides; the kernel reads them in place
        # (unbind rather than three selects: its backward is one stack)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        if self.use_flash:
            ctx = flash_attention(q, k, v, attn_mask=attn_mask,
                                  dropout_p=self.dropout_p,
                                  training=self.training)
        elif x.device.type != "cpu":
            # on the card attention runs only through the kernel
            raise NotImplementedError(
                "BertConfig.use_flash_attention=False runs plain attention "
                "on the CPU only; on the card attention is the "
                "flash_attention kernel")
        else:
            ctx = F.scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask, dropout_p=self.dropout_p,
                training=self.training)
        ctx = ctx.transpose(1, 2).reshape(b, s, d)
        return self.out(ctx)


class TransformerEncoderLayer(nn.Layer):
    def __init__(self, config: BertConfig, layer_idx=0):
        super().__init__()
        if config.moe_num_experts > 0:
            raise NotImplementedError(
                "BertConfig.moe_num_experts > 0: mixture-of-experts layers "
                "are not ported yet (see ROADMAP.md)")
        d = config.hidden_size
        self.attention = MultiHeadAttention(config)
        self.attn_norm = nn.LayerNorm(d, epsilon=config.layer_norm_eps)
        self.ffn1 = nn.Linear(d, config.intermediate_size)
        self.ffn2 = nn.Linear(config.intermediate_size, d)
        self.ffn_norm = nn.LayerNorm(d, epsilon=config.layer_norm_eps)
        self.dropout = nn.Dropout(config.hidden_dropout_prob)

    def forward(self, x, attn_mask=None):
        x = self.attn_norm(x + self.dropout(self.attention(x, attn_mask)))
        h = self.ffn2(F.gelu(self.ffn1(x)))
        return self.ffn_norm(x + self.dropout(h))


class BertEmbeddings(nn.Layer):
    def __init__(self, config: BertConfig):
        super().__init__()
        d = config.hidden_size
        self.word_embeddings = nn.Embedding(config.vocab_size, d)
        self.position_embeddings = nn.Embedding(
            config.max_position_embeddings, d)
        self.token_type_embeddings = nn.Embedding(config.type_vocab_size, d)
        self.norm = nn.LayerNorm(d, epsilon=config.layer_norm_eps)
        self.dropout = nn.Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None):
        s = input_ids.shape[1]
        pos = torch.arange(s, dtype=torch.int32,
                           device=input_ids.device).unsqueeze(0)
        emb = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if token_type_ids is not None:
            emb = emb + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.norm(emb))


class Bert(nn.Layer):
    """Encoder stack + pooler. Returns ``(sequence_output, pooled)``."""

    def __init__(self, config: BertConfig):
        super().__init__()
        if config.use_recompute:
            raise NotImplementedError(
                "BertConfig.use_recompute rematerializes activations for "
                "the backward pass; it is not ported yet (ROADMAP.md)")
        self.config = config
        self.embeddings = BertEmbeddings(config)
        self.encoder = nn.LayerList(
            [TransformerEncoderLayer(config, layer_idx=i)
             for i in range(config.num_hidden_layers)])
        self.pooler = nn.Linear(config.hidden_size, config.hidden_size)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        if attention_mask is not None:
            # [B, S] -> additive [B, 1, 1, S], f32 whatever the weights' dtype
            am = (1.0 - attention_mask.to(torch.float32)) * -1e9
            am = am[:, None, None, :]
        else:
            am = None
        x = self.embeddings(input_ids, token_type_ids)
        for layer in self.encoder:
            x = layer(x, am)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return x, pooled


class BertForPretraining(nn.Layer):
    """MLM + NSP heads and their pretraining loss."""

    def __init__(self, config: BertConfig):
        super().__init__()
        self.bert = Bert(config)
        d = config.hidden_size
        self.mlm_transform = nn.Linear(d, d)
        self.mlm_norm = nn.LayerNorm(d, epsilon=config.layer_norm_eps)
        self.mlm_bias = self.create_parameter((config.vocab_size,),
                                              is_bias=True)
        self.nsp = nn.Linear(d, 2)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        h = self.mlm_norm(F.gelu(self.mlm_transform(seq)))
        # tied output embedding: the word embedding table, transposed; an
        # AMP-listed matmul, so bf16 under auto_cast (the f32 bias then
        # makes the logits f32, as in the reference)
        logits = M.matmul(h, self.bert.embeddings.word_embeddings.weight,
                          transpose_y=True) + self.mlm_bias
        return logits, self.nsp(pooled)

    def loss(self, logits, nsp_logits, mlm_labels, nsp_labels,
             ignore_index=-1):
        """Masked-LM cross entropy over the positions whose label is not
        ``ignore_index``, plus next-sentence cross entropy."""
        mlm = L.cross_entropy(logits, mlm_labels, ignore_index=ignore_index)
        nsp = L.cross_entropy(nsp_logits, nsp_labels)
        return mlm + nsp
