"""RoBERTa-style text / fusion encoder (`xfm_tpu/models/text_encoder.py`).

Parameter names are the reference torch names (`roberta.embeddings.*`,
`roberta.encoder.layer.{i}.attention.self.query.*`, `lm_head.*` with the
decoder tied to the word embeddings). No decode cache yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.precision import act_dense, dense, layer_norm, post_layer_norm
from ..ops.activations import gelu
from ..ops.attention import dot_product_attention, mask_to_bias
from ..ops.dropout import dropout


@dataclasses.dataclass(frozen=True)
class TextConfig:
    vocab_size: int = 50265
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 1
    fusion_layer: int = 12          # first layer with cross-attention
    encoder_width: int = 768        # width of the cross-attended states
    dtype: torch.dtype = torch.float32
    fused_ln: bool = False          # the post-LN sites through K4
    fused_mlp: bool = False         # output.dense through K5

    @classmethod
    def roberta_base(cls, **kw):
        return cls(**{**dict(vocab_size=50265, max_position_embeddings=514,
                             pad_token_id=1, layer_norm_eps=1e-5,
                             type_vocab_size=1),
                      **kw})


def roberta_position_ids(input_ids: torch.Tensor,
                         pad_token_id: int) -> torch.Tensor:
    """Pad-offset positions: non-pad tokens count from pad_token_id + 1,
    pads stay at pad_token_id."""
    mask = (input_ids != pad_token_id).to(torch.int64)
    return torch.cumsum(mask, dim=1) * mask + pad_token_id


class Embeddings(nn.Module):
    def __init__(self, c: TextConfig):
        super().__init__()
        self.c = c
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings,
                                                c.hidden_size)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size,
                                                  c.hidden_size)
        self.LayerNorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(self, input_ids, deterministic: bool = True):
        """Word + roberta pad-offset position + token type 0 embeddings,
        normalized, then dropout."""
        c = self.c
        position_ids = roberta_position_ids(input_ids, c.pad_token_id)
        x = (F.embedding(input_ids, self.word_embeddings.weight).to(c.dtype)
             + F.embedding(position_ids,
                           self.position_embeddings.weight).to(c.dtype)
             + self.token_type_embeddings.weight[0].to(c.dtype))
        return dropout(layer_norm(x, self.LayerNorm, c.dtype),
                       c.hidden_dropout_prob, deterministic)


class _SelfProj(nn.Module):
    def __init__(self, c: TextConfig, kv_width: int):
        super().__init__()
        self.query = nn.Linear(c.hidden_size, c.hidden_size)
        self.key = nn.Linear(kv_width, c.hidden_size)
        self.value = nn.Linear(kv_width, c.hidden_size)


class _SelfOutput(nn.Module):
    def __init__(self, c: TextConfig):
        super().__init__()
        self.dense = nn.Linear(c.hidden_size, c.hidden_size)
        self.LayerNorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)


class SelfAttention(nn.Module):
    """Self- or cross-attention with the BERT post-LN output. Cross k/v
    project from `encoder_width` features; with `kv_row_idx` they are
    projected once per unique kv row and gathered per hidden row. With
    `kv_group_size` gs (cross-attention only) kv_source holds U unique rows
    and the B = U·gs hidden rows come in contiguous runs of gs per kv row:
    q is viewed, without a copy, as [U, gs·Nq, H, D] against the per-unique
    k/v (the retrieval rerank's formulation), and the bias's first row of
    each group stands for the group. Unless `deterministic`, the
    probabilities and the output projection take their dropouts."""

    def __init__(self, c: TextConfig, is_cross: bool = False):
        super().__init__()
        self.c = c
        self.is_cross = is_cross
        self.self = _SelfProj(c, c.encoder_width if is_cross
                              else c.hidden_size)
        self.output = _SelfOutput(c)

    def forward(self, hidden, kv_source, attention_bias,
                kv_row_idx: Optional[torch.Tensor] = None,
                kv_group_size: Optional[int] = None, prob_gate=None,
                deterministic: bool = True):
        c = self.c
        if prob_gate is not None:
            raise NotImplementedError(
                "kv_group_size with prob_gate (GradCAM) unsupported"
                if kv_group_size else "prob_gate (GradCAM) is not ported yet")
        H = c.num_attention_heads
        D = c.hidden_size // H
        B, Nq = hidden.shape[:2]
        q = dense(hidden, self.self.query, c.dtype).reshape(B, Nq, H, D)
        U, Nk = kv_source.shape[:2]
        k = dense(kv_source, self.self.key, c.dtype).reshape(U, Nk, H, D)
        v = dense(kv_source, self.self.value, c.dtype).reshape(U, Nk, H, D)
        if kv_row_idx is not None:
            k = k.index_select(0, kv_row_idx)
            v = v.index_select(0, kv_row_idx)
        if kv_group_size and self.is_cross:
            gs = int(kv_group_size)
            bias = attention_bias
            if bias is not None and bias.shape[0] == B:
                bias = bias[::gs]
            ctx = dot_product_attention(
                q.view(U, gs * Nq, H, D), k, v, bias=bias,
                deterministic=deterministic,
                dropout_rate=c.attention_probs_dropout_prob)
        else:
            ctx = dot_product_attention(
                q, k, v, bias=attention_bias, deterministic=deterministic,
                dropout_rate=c.attention_probs_dropout_prob)
        out = dropout(dense(ctx.reshape(B, Nq, c.hidden_size),
                            self.output.dense, c.dtype),
                      c.hidden_dropout_prob, deterministic)
        return post_layer_norm(out, hidden, self.output.LayerNorm, c.dtype,
                               c.fused_ln)


class _Intermediate(nn.Module):
    def __init__(self, c: TextConfig):
        super().__init__()
        self.dense = nn.Linear(c.hidden_size, c.intermediate_size)


class _Output(nn.Module):
    def __init__(self, c: TextConfig):
        super().__init__()
        self.dense = nn.Linear(c.intermediate_size, c.hidden_size)
        self.LayerNorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)


class TransformerLayer(nn.Module):
    def __init__(self, c: TextConfig, has_cross_attention: bool = False):
        super().__init__()
        self.c = c
        self.attention = SelfAttention(c)
        if has_cross_attention:
            self.crossattention = SelfAttention(c, is_cross=True)
        self.has_cross_attention = has_cross_attention
        self.intermediate = _Intermediate(c)
        self.output = _Output(c)

    def forward(self, hidden, attention_bias=None, encoder_hidden_states=None,
                encoder_attention_bias=None, encoder_row_idx=None,
                encoder_group_size=None, deterministic: bool = True):
        c = self.c
        x = self.attention(hidden, hidden, attention_bias,
                           deterministic=deterministic)
        if self.has_cross_attention and encoder_hidden_states is not None:
            x = self.crossattention(x, encoder_hidden_states,
                                    encoder_attention_bias, encoder_row_idx,
                                    encoder_group_size,
                                    deterministic=deterministic)
        h = dense(x, self.intermediate.dense, c.dtype)
        h = act_dense(h, self.output.dense, c.hidden_act, c.dtype,
                      c.fused_mlp)
        h = dropout(h, c.hidden_dropout_prob, deterministic)
        return post_layer_norm(h, x, self.output.LayerNorm, c.dtype,
                               c.fused_ln)


class _Encoder(nn.Module):
    def __init__(self, c: TextConfig):
        super().__init__()
        self.layer = nn.ModuleList(
            TransformerLayer(c, has_cross_attention=(i >= c.fusion_layer))
            for i in range(c.num_hidden_layers))


class _Roberta(nn.Module):
    def __init__(self, c: TextConfig):
        super().__init__()
        self.embeddings = Embeddings(c)
        self.encoder = _Encoder(c)


class MLMHead(nn.Module):
    """dense → GELU(erf) → LayerNorm → vocab decoder tied to the word
    embeddings (decoder.weight) and to `bias` (decoder.bias)."""

    def __init__(self, c: TextConfig, word_embeddings: nn.Embedding):
        super().__init__()
        self.c = c
        self.dense = nn.Linear(c.hidden_size, c.hidden_size)
        self.layer_norm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.bias = nn.Parameter(torch.zeros(c.vocab_size))
        self.decoder = nn.Linear(c.hidden_size, c.vocab_size)
        self.decoder.weight = word_embeddings.weight
        self.decoder.bias = self.bias

    def forward(self, hidden):
        c = self.c
        x = gelu(dense(hidden, self.dense, c.dtype))
        x = layer_norm(x, self.layer_norm, c.dtype)
        return x.float() @ self.decoder.weight.float().T + self.bias


class TextTransformer(nn.Module):
    """Encoder stack with mode-sliced layer ranges: 'text' = [0,
    fusion_layer), 'fusion' = [fusion_layer, N), 'multi_modal' = [0, N).
    `inputs_embeds` bypasses the embeddings."""

    def __init__(self, c: TextConfig, with_mlm: bool = False):
        super().__init__()
        self.c = c
        self.roberta = _Roberta(c)
        self.with_mlm = with_mlm
        if with_mlm:
            self.lm_head = MLMHead(c, self.roberta.embeddings.word_embeddings)

    def mlm_logits(self, hidden, masked_pos=None):
        if masked_pos is not None:
            hidden = gather_positions(hidden, masked_pos)
        return self.lm_head(hidden)

    def forward(self, input_ids=None, attention_mask=None,
                inputs_embeds=None, encoder_hidden_states=None,
                encoder_attention_mask=None, mode: str = "multi_modal",
                encoder_row_idx=None, deterministic: bool = True,
                encoder_group_size=None):
        c = self.c
        x = (inputs_embeds if inputs_embeds is not None
             else self.roberta.embeddings(input_ids, deterministic))
        bias = mask_to_bias(attention_mask) if attention_mask is not None \
            else None
        ebias = None
        if encoder_hidden_states is not None:
            if encoder_attention_mask is None:
                nrows = (encoder_row_idx.shape[0]
                         if encoder_row_idx is not None
                         else encoder_hidden_states.shape[0])
                encoder_attention_mask = torch.ones(
                    nrows, encoder_hidden_states.shape[1],
                    dtype=torch.int64, device=encoder_hidden_states.device)
            ebias = mask_to_bias(encoder_attention_mask)
        if mode == "text":
            lo, hi = 0, c.fusion_layer
        elif mode == "fusion":
            lo, hi = c.fusion_layer, c.num_hidden_layers
        else:
            lo, hi = 0, c.num_hidden_layers
        for layer in self.roberta.encoder.layer[lo:hi]:
            x = layer(x, bias, encoder_hidden_states, ebias, encoder_row_idx,
                      encoder_group_size, deterministic)
        return x


def gather_positions(hidden: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
    """[B, N, C] rows at positions [B, M] → [B, M, C]."""
    return torch.take_along_dim(hidden, positions[..., None], dim=1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int = -100) -> torch.Tensor:
    """Mean cross-entropy over non-ignored labels, in f32."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.take_along_dim(logp, safe[..., None], dim=-1)[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / valid.sum().clamp(min=1)
