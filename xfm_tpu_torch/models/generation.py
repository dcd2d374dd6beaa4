"""VQA as constrained generation (`xfm_tpu/models/generation.py`
`make_decoder_config`, `shift_lm_loss`, `XFMForVQA`).

The answer decoder is a causal `TextTransformer` (`is_decoder`) whose
every layer from `decoder_fusion_start_at` cross-attends to the fusion
encoder's output (its k/v projected from the text width), with its own LM
head tied to its own word embeddings. Training takes the weighted causal
LM loss of a flat [B · max_answers] answer layout, each answer gathered to
its question's states by `ques_idx`. The eval ranks a fixed answer list:
the first-token probabilities of every answer from one BOS step, the top k
of them, the k candidates of each question decoded as one contiguous
group against its question's once-projected k/v (the JAX package's
default grouped form), and the chain-rule re-rank.

Both top-k's take a stable descending sort, so that tied probabilities
(answers that share a first token have equal ones) keep the lower index
first, as `jax.lax.top_k` does: the CPU, the card and the JAX package
choose the same candidates in the same order. No KV cache, `generate` or
beam search yet (captioning).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops.dropout import dropout_generator
from .text_encoder import TextConfig, TextTransformer, per_sample_lm_loss
from .xfm import XFMBase, XFMConfig, config_from_yaml


def make_decoder_config(xfm_cfg: XFMConfig, num_dec_layers: int = 12,
                        decoder_fusion_start_at: int = 0) -> TextConfig:
    """The text config made causal, `num_dec_layers` deep, cross-attending
    from `decoder_fusion_start_at` to the fusion output (encoder_width =
    the text width)."""
    return dataclasses.replace(
        xfm_cfg.text, num_hidden_layers=num_dec_layers,
        fusion_layer=decoder_fusion_start_at,
        encoder_width=xfm_cfg.text.hidden_size, is_decoder=True)


def shift_lm_loss(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int = -100,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Causal shift (position t predicts label t + 1), then
    `per_sample_lm_loss` → [N]."""
    return per_sample_lm_loss(logits[:, :-1], labels[:, 1:], ignore_index,
                              label_smoothing)


def stable_topk(x: torch.Tensor, k: int):
    """The k largest of each row in descending order, ties by the lower
    index first (`jax.lax.top_k`'s order) → (values, indices)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


class XFMForVQA(XFMBase):
    """XFMBase (vision, text and fusion encoders under the reference's
    names) and `text_decoder` (`text_decoder.roberta.*`,
    `text_decoder.lm_head.*`)."""

    def __init__(self, c: XFMConfig, num_dec_layers: int = 12,
                 decoder_fusion_start_at: int = 0, pad_token_id: int = 1):
        super().__init__(c)
        self.pad_token_id = pad_token_id
        self.text_decoder = TextTransformer(
            make_decoder_config(c, num_dec_layers, decoder_fusion_start_at),
            with_mlm=True)

    @classmethod
    def from_yaml(cls, cfg: dict, config: Optional[XFMConfig] = None,
                  pad_token_id: int = 1) -> "XFMForVQA":
        """The model a task YAML describes: `config` (by default
        `config_from_yaml(cfg)`, with no contrastive, matching or MLM
        heads) and the decoder `num_dec_layers` deep, cross-attending from
        `decoder_fusion_start_at`."""
        return cls(config or config_from_yaml(cfg),
                   num_dec_layers=cfg.get("num_dec_layers", 12),
                   decoder_fusion_start_at=cfg.get("decoder_fusion_start_at",
                                                   0),
                   pad_token_id=pad_token_id)

    def encode_question(self, images, q_ids, q_atts,
                        deterministic: bool = True) -> torch.Tensor:
        """Vision → text encoder → fusion encoder (the text encoder trained
        through it) → the question states [B, T, C]."""
        image_embeds = self.get_vision_embeds(images,
                                              deterministic=deterministic)
        image_atts = torch.ones(image_embeds.shape[:2], dtype=torch.int64,
                                device=image_embeds.device)
        text_embeds = self.get_text_embeds(q_ids, q_atts, deterministic)
        return self.get_cross_embeds(image_embeds, image_atts, text_embeds,
                                     q_atts, deterministic=deterministic,
                                     is_pretrain=False)

    def decode_answers(self, answer_ids, answer_atts, question_states,
                       question_atts, deterministic: bool = True,
                       question_group_size: Optional[int] = None
                       ) -> torch.Tensor:
        """The decoder over the answers against the question states → f32
        logits [N, L, V]. With `question_group_size` gs the states hold U
        questions and the U·gs answer rows come in contiguous runs of gs a
        question."""
        hidden = self.text_decoder(
            answer_ids, attention_mask=answer_atts,
            encoder_hidden_states=question_states,
            encoder_attention_mask=question_atts,
            deterministic=deterministic,
            encoder_group_size=question_group_size)
        return self.text_decoder.mlm_logits(hidden)

    def loss(self, images, q_ids, q_atts, answer_ids, answer_atts, ques_idx,
             weights, generator: Optional[torch.Generator] = None,
             deterministic: bool = True) -> torch.Tensor:
        """Σ weights · (each answer's summed causal LM loss, pads ignored)
        / B. Unless `deterministic`, the dropout masks come from
        `generator`."""
        with dropout_generator(generator):
            question = self.encode_question(images, q_ids, q_atts,
                                            deterministic)
            logits = self.decode_answers(
                answer_ids, answer_atts, question.index_select(0, ques_idx),
                q_atts.index_select(0, ques_idx), deterministic)
        labels = torch.where(answer_ids == self.pad_token_id,
                             torch.full_like(answer_ids, -100), answer_ids)
        per = shift_lm_loss(logits, labels)
        return (weights * per).sum() / images.shape[0]

    def forward(self, *args, **kwargs):
        return self.loss(*args, **kwargs)

    @torch.no_grad()
    def rank(self, images, q_ids, q_atts, answer_ids, answer_atts, k: int):
        """The eval of one batch: `encode_question`, then `rank_answer` with
        every question token attended (as the JAX package's eval calls
        it)."""
        question = self.encode_question(images, q_ids, q_atts)
        question_atts = torch.ones(question.shape[:2], dtype=torch.int64,
                                   device=question.device)
        return self.rank_answer(question, question_atts, answer_ids,
                                answer_atts, k)

    @torch.no_grad()
    def rank_answer(self, question_states, question_atts, answer_ids,
                    answer_atts, k: int):
        """answer_ids [A, L], each starting with BOS → (top-k answer ids,
        their probabilities), [Q, k] each: the first-token probabilities of
        every answer after BOS, their top k, each question's k candidates
        decoded as one group, the candidates' log p₁ − loss softmaxed and
        ranked again."""
        nq = question_states.shape[0]
        start = answer_ids[:1, :1].expand(nq, 1)
        logits0 = self.decode_answers(start, None, question_states,
                                      question_atts)[:, 0, :]
        probs0 = torch.softmax(logits0.float(), dim=-1)
        prob_first = probs0.index_select(1, answer_ids[:, 1])
        topk_probs, topk_ids = stable_topk(prob_first, k)
        flat = topk_ids.reshape(-1)
        cand_ids = answer_ids.index_select(0, flat)
        cand_atts = answer_atts.index_select(0, flat)
        logits = self.decode_answers(
            cand_ids, cand_atts, question_states,
            question_atts.repeat_interleave(k, dim=0),
            question_group_size=k)
        labels = torch.where(cand_ids == self.pad_token_id,
                             torch.full_like(cand_ids, -100), cand_ids)
        loss = shift_lm_loss(logits, labels)
        log_probs_sum = (torch.log(topk_probs.reshape(-1) + 1e-30)
                         - loss).reshape(nq, k)
        probs, rerank = stable_topk(torch.softmax(log_probs_sum, dim=-1), k)
        return torch.take_along_dim(topk_ids, rerank, dim=1), probs
