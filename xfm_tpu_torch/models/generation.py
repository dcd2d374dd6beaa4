"""VQA as constrained generation and COCO captioning
(`xfm_tpu/models/generation.py` `make_decoder_config`, `shift_lm_loss`,
`XFMForVQA`, `XFMForCaptioning`, `top_k_top_p_filtering`, `generate`,
`beam_generate`).

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
choose the same candidates in the same order.

The caption model is the vision tower and a causal decoder that
cross-attends to the image patches (its cross k/v from the vision width);
nothing else, as the JAX module's parameter tree holds nothing else.
`generate` (greedy or sampled, with the training prompt forced into the
first slots) and `beam_generate` decode step by step in plain Python loops
over a `DecodeCache`, under `torch.no_grad()`: the JAX package's scanned
decode, step for step. Each image's n samples or K beams are contiguous
rows that cross-attend to the image's once-projected k/v
(`encoder_group_size`); the beam's reorder gathers the self k/v only.
Random draws come from a `torch.Generator` (the Gumbel-max form of
`jax.random.categorical`), so a sampled sequence repeats for one seed but
does not follow JAX's random stream.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
from torch import nn

from ..data.device_aug import maybe_normalize
from ..ops.dropout import dropout_generator
from .text_encoder import (DecodeCache, TextConfig, TextTransformer,
                           per_sample_lm_loss)
from .xfm import XFMBase, XFMConfig, config_from_yaml, vision_tower


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


class XFMForCaptioning(nn.Module):
    """The vision tower (`vision_encoder.*`) and a causal decoder
    (`text_decoder.roberta.*`, `text_decoder.lm_head.*`) `num_dec_layers`
    deep, cross-attending to the image embeds from
    `decoder_fusion_start_at` with k/v from the vision width, and
    `max_decode_len` self k/v slots in a decode cache (0: the position
    table's). The train loss is each caption's summed causal LM loss (pads
    and the first `prompt_length` positions ignored, `label_smoothing`
    mixed in), meaned over the batch."""

    def __init__(self, c: XFMConfig, num_dec_layers: int = 12,
                 decoder_fusion_start_at: int = 0, pad_token_id: int = 1,
                 prompt_length: int = 0, label_smoothing: float = 0.0,
                 max_decode_len: int = 0):
        super().__init__()
        self.config = c
        self.pad_token_id = pad_token_id
        self.prompt_length = prompt_length
        self.label_smoothing = label_smoothing
        self.vision_encoder = vision_tower(c)
        self.text_decoder = TextTransformer(dataclasses.replace(
            make_decoder_config(c, num_dec_layers, decoder_fusion_start_at),
            encoder_width=c.vision_width, decode_cache_len=max_decode_len),
            with_mlm=True)

    @classmethod
    def from_yaml(cls, cfg: dict, config: Optional[XFMConfig] = None,
                  pad_token_id: int = 1) -> "XFMForCaptioning":
        """The model `Captioning.yaml` describes (`xfm_tpu/tasks/
        captioning.py` `build_model`): `config` (by default
        `config_from_yaml(cfg)`), the decoder's depth and first
        cross-attending layer, `prompt_length`, `label_smoothing`, and a
        decode cache of `max_length` + `prompt_length` + 2 slots."""
        return cls(config or config_from_yaml(cfg),
                   num_dec_layers=cfg.get("num_dec_layers", 12),
                   decoder_fusion_start_at=cfg.get("decoder_fusion_start_at",
                                                   0),
                   pad_token_id=pad_token_id,
                   prompt_length=cfg.get("prompt_length", 0),
                   label_smoothing=cfg.get("label_smoothing", 0.0),
                   max_decode_len=int(cfg.get("max_length", 20))
                   + int(cfg.get("prompt_length", 0)) + 2)

    def encode_images(self, images,
                      deterministic: bool = True) -> torch.Tensor:
        """NHWC images → the vision embeds [B, 1 + patches, C]."""
        return self.vision_encoder(maybe_normalize(images),
                                   deterministic=deterministic)

    def decode(self, text_ids, text_atts, image_embeds,
               deterministic: bool = True,
               image_group_size: Optional[int] = None) -> torch.Tensor:
        """The decoder over the texts against every image token → f32
        logits [N, L, V]; with `image_group_size` gs each image's gs rows
        are contiguous."""
        image_atts = torch.ones(image_embeds.shape[:2], dtype=torch.int64,
                                device=image_embeds.device)
        hidden = self.text_decoder(
            text_ids, attention_mask=text_atts,
            encoder_hidden_states=image_embeds,
            encoder_attention_mask=image_atts, deterministic=deterministic,
            encoder_group_size=image_group_size)
        return self.text_decoder.mlm_logits(hidden)

    def loss(self, images, text_ids, text_atts,
             generator: Optional[torch.Generator] = None,
             deterministic: bool = True) -> torch.Tensor:
        """The mean over the batch of each caption's summed causal LM loss.
        Unless `deterministic`, the dropout masks come from `generator`."""
        with dropout_generator(generator):
            logits = self.decode(text_ids, text_atts,
                                 self.encode_images(images, deterministic),
                                 deterministic)
        labels = torch.where(text_ids == self.pad_token_id,
                             torch.full_like(text_ids, -100), text_ids)
        if self.prompt_length:
            pos = torch.arange(labels.shape[1], device=labels.device)[None]
            labels = torch.where(pos < self.prompt_length,
                                 torch.full_like(labels, -100), labels)
        return shift_lm_loss(logits, labels,
                             label_smoothing=self.label_smoothing).mean()

    def forward(self, *args, **kwargs):
        return self.loss(*args, **kwargs)

    def decode_step(self, tokens, image_embeds, cache: DecodeCache,
                    encoder_group_size: Optional[int] = None
                    ) -> torch.Tensor:
        """One cached decode step of the tokens [N, Nq] after the cache's
        `index` tokens (positions after them; the cross k/v projected at the
        first step and read from the cache after it) → the f32 logits of
        the last position [N, V]."""
        image_atts = torch.ones(image_embeds.shape[:2], dtype=torch.int64,
                                device=image_embeds.device)
        hidden = self.text_decoder(
            tokens, encoder_hidden_states=image_embeds,
            encoder_attention_mask=image_atts, decode=cache,
            past_length=cache.index, cross_from_cache=cache.index > 0,
            encoder_group_size=encoder_group_size)
        return self.text_decoder.mlm_logits(hidden[:, -1:])[:, 0]


def top_k_top_p_filtering(logits: torch.Tensor, top_k: int = 0,
                          top_p: float = 1.0) -> torch.Tensor:
    """f32 logits with those outside the top k, and outside the nucleus
    whose mass before each kept token is < top_p, set to the f32 minimum;
    ties at the threshold all stay (the JAX package's threshold form)."""
    neg = torch.finfo(torch.float32).min
    logits = logits.float()
    if top_k > 0:
        kth = torch.topk(logits, min(top_k, logits.shape[-1]),
                         dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, neg),
                             logits)
    if top_p < 1.0:
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_desc, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < top_p
        thresh = torch.where(keep, sorted_desc,
                             torch.full_like(sorted_desc, float("inf"))
                             ).min(dim=-1, keepdim=True).values
        logits = torch.where(logits < thresh, torch.full_like(logits, neg),
                             logits)
    return logits


def _gumbel_argmax(logp: torch.Tensor,
                   generator: torch.Generator) -> torch.Tensor:
    """A draw from the categorical over log-probabilities [N, V]: argmax of
    logp plus Gumbel noise from `generator`."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(logp.shape, generator=generator, device=logp.device)
    return torch.argmax(logp - torch.log(-torch.log(u.clamp(min=tiny))),
                        dim=-1)


@torch.no_grad()
def generate(model: XFMForCaptioning, images, *, bos_id: int, eos_id: int,
             pad_id: int, max_len: int = 20, min_len: int = 0,
             greedy: bool = True, top_k: int = 0,
             top_p: float = 1.0,
             generator: Optional[torch.Generator] = None,
             num_return_sequences: int = 1,
             prompt_ids: Sequence[int] = ()):
    """Greedy or sampled decoding → (sequences [B·n, max_len] int64, each
    token's log-probability [B·n, max_len] f32). Each image's n samples are
    contiguous rows. EOS is blocked while fewer than `min_len` tokens are
    out; the first len(prompt_ids) slots are forced to the prompt with
    log-probability 0; after EOS a row takes pads at 0. A sampled draw
    (`greedy=False`, after the top-k / top-p filter) comes from
    `generator`."""
    image_embeds = model.encode_images(images)
    n = num_return_sequences
    gs = n if n > 1 else None
    B = image_embeds.shape[0] * n
    dev = image_embeds.device
    P = len(prompt_ids)
    prompt = torch.tensor(list(prompt_ids) or [0], dtype=torch.int64,
                          device=dev)
    if not greedy and generator is None:
        raise ValueError("sampling draws from a torch.Generator")

    def select(logits, done, pos):
        logits = logits.float()
        if min_len > 0 and pos < min_len:
            logits = logits.clone()
            logits[:, eos_id] = -1e9
        if not greedy and (top_k > 0 or top_p < 1.0):
            logits = top_k_top_p_filtering(logits, top_k, top_p)
        logp = torch.log_softmax(logits, dim=-1)
        nxt = (torch.argmax(logp, dim=-1) if greedy
               else _gumbel_argmax(logp, generator))
        tok_logp = torch.take_along_dim(logp, nxt[:, None], dim=-1)[:, 0]
        if P and pos <= P:
            nxt = prompt[min(max(pos - 1, 0), P - 1)].expand(B)
            tok_logp = torch.zeros_like(tok_logp)
        nxt = torch.where(done, torch.full_like(nxt, pad_id), nxt)
        tok_logp = torch.where(done, torch.zeros_like(tok_logp), tok_logp)
        return nxt, tok_logp, done | (nxt == eos_id)

    cache = DecodeCache()
    tok = torch.full((B, 1), bos_id, dtype=torch.int64, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    seqs, lps = [], []
    for i in range(max_len):
        logits = model.decode_step(tok, image_embeds, cache, gs)
        nxt, tok_logp, done = select(logits, done, i + 1)
        seqs.append(nxt)
        lps.append(tok_logp)
        tok = nxt[:, None]
    return torch.stack(seqs, 1), torch.stack(lps, 1)


@torch.no_grad()
def beam_generate(model: XFMForCaptioning, images, *, bos_id: int,
                  eos_id: int, pad_id: int, max_len: int = 20,
                  min_len: int = 0, num_beams: int = 3,
                  length_penalty: float = 1.0,
                  prompt_ids: Sequence[int] = (),
                  image_group: bool = True) -> torch.Tensor:
    """Beam search → the best sequence of each image [B, max_len] int64,
    by score / length^length_penalty. Each image's K beams are contiguous
    rows cross-attending to its once-projected k/v (`image_group`; False
    repeats the image embeds K times instead, the same search). EOS is
    blocked at the first step where `min_len` > 1 and later while the
    length with BOS is below `min_len`; a finished beam continues with pads
    at 0. With a prompt every beam takes its tokens and only beam 0 keeps
    a live score, so the first free step expands K candidates of one
    beam."""
    image_embeds = model.encode_images(images)
    B, K = image_embeds.shape[0], num_beams
    dev = image_embeds.device
    gs = K
    if not image_group:
        image_embeds, gs = image_embeds.repeat_interleave(K, dim=0), None
    P = len(prompt_ids)
    cache = DecodeCache()
    bos = torch.full((B * K, 1), bos_id, dtype=torch.int64, device=dev)
    logits = model.decode_step(bos, image_embeds, cache, gs)
    logp = torch.log_softmax(logits.float(), -1).reshape(B, K, -1)[:, 0]
    if min_len > 1:
        logp[:, eos_id] = -1e9
    V = logp.shape[-1]
    scores, tok = stable_topk(logp, K)
    if P:
        tok = torch.full((B, K), prompt_ids[0], dtype=torch.int64,
                         device=dev)
        scores = torch.tensor([0.0] + [-1e9] * (K - 1),
                              device=dev).expand(B, K)
    seqs = torch.full((B, K, max_len), pad_id, dtype=torch.int64,
                      device=dev)
    seqs[:, :, 0] = tok
    done = tok == eos_id
    pad_only = torch.full((V,), -1e9, device=dev)
    pad_only[pad_id] = 0.0
    base = torch.arange(B, device=dev)[:, None] * K
    for i in range(max_len - 1):
        logits = model.decode_step(tok.reshape(B * K, 1), image_embeds,
                                   cache, gs)
        logp = torch.log_softmax(logits.float(), -1).reshape(B, K, V)
        if min_len > 0 and i + 2 < min_len:
            logp[..., eos_id] = -1e9
        logp = torch.where(done[..., None], pad_only, logp)
        new_scores, idx = stable_topk(
            (scores[..., None] + logp).reshape(B, K * V), K)
        beam_idx = idx // V
        new_tok = idx % V
        if i + 1 < P:
            new_tok = torch.full_like(new_tok, prompt_ids[i + 1])
            new_scores = scores
            beam_idx = torch.arange(K, device=dev).expand(B, K)
        cache.reorder((base + beam_idx).reshape(-1))
        seqs = torch.take_along_dim(seqs, beam_idx[..., None], dim=1)
        done = torch.take_along_dim(done, beam_idx, dim=1) | (
            new_tok == eos_id)
        seqs[:, :, i + 1] = new_tok
        scores, tok = new_scores, new_tok
    lengths = (seqs != pad_id).sum(-1).float()
    adj = scores / lengths.clamp(min=1.0) ** length_penalty
    best = torch.argmax(adj, dim=1)
    return torch.take_along_dim(seqs, best[:, None, None], dim=1)[:, 0]
