"""SASRec — self-attentive sequential recommendation (Kang & McAuley, ICDM
2018): the port of ``skrx.models.SASRec``.

Same config fields, defaults and checks, and the JAX package's parameters
(Glorot-uniform matrices, zero biases, unit LayerNorm scales):
``item_emb`` (N, d), ``pos_emb`` (L, d), ``blocks.<i>`` with ``ln1_s``,
``ln1_b``, ``att.{q, k, v}.{w, b}``, ``ln2_s``, ``ln2_b``, ``ffn.{ff1,
ff2}.{w, b}``, and the final ``ln_f_s``, ``ln_f_b``.

One training row per user with training items: ``items[:-1]`` in,
``items[1:]`` out, both pre-padded (and cut) to ``max_len`` with the pad
id N. The encoder (:func:`sasrec_encode`) looks the ids up in the item
table with a zero pad row, scaled by sqrt(d), adds the positions, drops
out, zeroes the pad positions, and runs ``num_blocks`` pre-LN blocks
(``ops.attention``'s causal attention with the reference's masks, then
the FFN, pad positions zeroed after each) and a final LayerNorm. A step
takes the sigmoid cross-entropy of every target position against its
positive and one negative, averaged over the real targets (pad targets
and padded rows weigh 0), plus ``l2_emb`` times half the squares of the
item and position tables, and one Adam step with b2 = 0.98. Negatives come
each epoch from ``sample_negatives(num_neg=L, num_trials=8)``, excluded
against the user's positives, pad where the target is pad. The dropout
masks (embedding, attention probabilities, both FFN layers) are the loss's
argument (:func:`sasrec_draws`: from the epoch's step generator).
``compute_dtype="bfloat16"`` runs the encoder on bf16 copies of the f32
parameters; the logits and the loss stay f32.

A user's vector is the encoder's last position over the last ``max_len``
training items; ``predict`` is ``uv @ (item_emb * sqrt(d)).T``. It is a
tower (``_topk_factors``: ``(uv, item_emb * sqrt(d), None)``).

Under a mesh SASRec trains data-parallel: each rank takes its data index's
slice of the batch and of the step's dropout masks (drawn at the whole
batch's shape), the mean divides by the whole batch's target positions,
``l2_emb`` counts once and the gradients sum over the data axis;
``predict_topk`` ranks the catalog split over the model axis.
"""
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..convert import sasrec_params_from_jax
from ..ops.attention import (dropout, feedforward_conv1, keep_mask,
                             layer_norm, multihead_attention_kyubyong)
from ..ops.initializers import get_initializer
from ..ops.sampling import sample_negatives
from ..parallel import batch_total, global_rows, local_rows, once
from ..run_config import RunConfig
from ..utils import ModelConfig, pad_sequences
from .common import (CachedUserVecChunkMixin, EpochTrainedRecommender,
                     NestedParamsMixin, add_param_tree, cast_tree,
                     gather_rows, make_train_step)
from .pipeline import RowsEpochPipeline

__all__ = ["SASRec", "SASRecConfig", "sasrec_encode", "sasrec_loss",
           "sasrec_draws", "SASRecEpochPipeline"]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class SASRecConfig(ModelConfig):
    lr: float = 0.001
    l2_emb: float = 0.0
    hidden_units: int = 64
    dropout_rate: float = 0.5
    max_len: int = 50
    num_blocks: int = 2
    num_heads: int = 1
    batch_size: int = 128
    epochs: int = 1000
    early_stop: int = 100
    compute_dtype: str = "float32"   # float32 | bfloat16 (the blocks)

    def _validate(self):
        ok = (isinstance(self.lr, float) and self.lr > 0
              and isinstance(self.l2_emb, float) and self.l2_emb >= 0
              and isinstance(self.hidden_units, int) and self.hidden_units > 0
              and isinstance(self.dropout_rate, float)
              and 0 <= self.dropout_rate < 1
              and isinstance(self.max_len, int) and self.max_len > 0
              and isinstance(self.num_blocks, int) and self.num_blocks > 0
              and isinstance(self.num_heads, int) and self.num_heads > 0
              and self.hidden_units % self.num_heads == 0
              and isinstance(self.batch_size, int) and self.batch_size > 0
              and self.compute_dtype in DTYPES)
        if not ok:
            raise ValueError(f"invalid SASRec config: {self}")


Draws = Tuple[torch.Tensor, List[Tuple[torch.Tensor,
                                       Tuple[torch.Tensor, torch.Tensor]]]]


def sasrec_draws(generator: torch.Generator, batch: int,
                 cfg: SASRecConfig) -> Optional[Draws]:
    """One step's dropout keep masks: the embedding's (B, L, d), and per
    block the attention probabilities' (B, heads, L, L) and the two FFN
    layers' (B, L, d). None at rate 0."""
    rate = cfg.dropout_rate
    if rate <= 0:
        return None
    big_l, d, h = cfg.max_len, cfg.hidden_units, cfg.num_heads
    emb = keep_mask(generator, (batch, big_l, d), rate)
    blocks = [(keep_mask(generator, (batch, h, big_l, big_l), rate),
               (keep_mask(generator, (batch, big_l, d), rate),
                keep_mask(generator, (batch, big_l, d), rate)))
              for _ in range(cfg.num_blocks)]
    return emb, blocks


def _item_table(p, d: int) -> torch.Tensor:
    """The item table with a zero pad row (id N), scaled by sqrt(d)."""
    emb = p["item_emb"]
    return torch.cat([emb, emb.new_zeros((1, d))]) * (d ** 0.5)


def sasrec_encode(p, cfg: SASRecConfig, pad_id: int, seq_ids: torch.Tensor,
                  draws: Optional[Draws] = None) -> torch.Tensor:
    """(B, L, d) f32 hidden states of ``seq_ids`` (B, L) under the params
    tree ``p``; ``draws`` the dropout masks (None: no dropout)."""
    p = cast_tree(p, DTYPES[cfg.compute_dtype])
    rate, d = cfg.dropout_rate, cfg.hidden_units
    emb_keep, block_keeps = draws if draws is not None \
        else (None, [(None, None)] * cfg.num_blocks)
    seq = gather_rows(_item_table(p, d), seq_ids) + p["pos_emb"][None]
    seq = dropout(seq, rate, emb_keep)
    mask = (seq_ids != pad_id).to(seq.dtype)[:, :, None]
    seq = seq * mask
    for blk, (att_keep, ff_keeps) in zip(p["blocks"], block_keeps):
        q = layer_norm(seq, blk["ln1_s"], blk["ln1_b"])
        seq = multihead_attention_kyubyong(blk["att"], q, seq, cfg.num_heads,
                                           causal=True, dropout_rate=rate,
                                           keep=att_keep)
        h = layer_norm(seq, blk["ln2_s"], blk["ln2_b"])
        seq = feedforward_conv1(blk["ffn"], h, rate, ff_keeps) * mask
    return layer_norm(seq, p["ln_f_s"], p["ln_f_b"]).float()


def sasrec_loss(p, cfg: SASRecConfig, pad_id: int, seqs: torch.Tensor,
                poss: torch.Tensor, neg: torch.Tensor, w: torch.Tensor,
                draws: Optional[Draws]) -> torch.Tensor:
    """One batch's loss: sigmoid cross-entropy of each real target position
    against its positive and negative, plus the ``l2_emb`` term."""
    hidden = sasrec_encode(p, cfg, pad_id, seqs, draws)
    table = _item_table(p, cfg.hidden_units)
    pos_logits = torch.sum(hidden * gather_rows(table, poss), -1)
    neg_logits = torch.sum(hidden * gather_rows(table, neg), -1)
    is_target = (poss != pad_id).float() * w[:, None]
    pos_loss = -torch.log(torch.sigmoid(pos_logits) + 1e-24) * is_target
    neg_loss = -torch.log(1 - torch.sigmoid(neg_logits) + 1e-24) * is_target
    loss = torch.sum(pos_loss + neg_loss) / torch.clamp(
        batch_total(is_target), min=1.0)
    if cfg.l2_emb > 0:
        loss = loss + cfg.l2_emb * 0.5 * once(
            torch.sum(p["item_emb"] ** 2) + torch.sum(p["pos_emb"] ** 2))
    return loss


class SASRecEpochPipeline(RowsEpochPipeline):
    """(users, seqs (B, L), poss (B, L), neg (B, L), weight) batches:
    :class:`RowsEpochPipeline` over the users' rows, with one negative a
    position drawn each epoch (``sample_negatives``, excluded against the
    user's positives), pad where the target is pad."""

    def __init__(self, train_data, users, seqs, poss, batch_size: int,
                 device: torch.device, mesh=None):
        super().__init__([users, seqs, poss], batch_size, device, mesh)
        self.num_items = train_data.num_items
        self.max_len = seqs.shape[1]
        self._pos_table = torch.as_tensor(
            train_data.to_padded_positive_table().table, device=device)

    def _batch(self, generator, idx):
        users, seqs, poss, w = super()._batch(generator, idx)
        neg = sample_negatives(generator, users, self._pos_table,
                               self.num_items, num_neg=self.max_len,
                               num_trials=8).long()
        neg = torch.where(poss != self.num_items, neg, self.num_items)
        return users, seqs, poss, neg, w


class SASRec(NestedParamsMixin, CachedUserVecChunkMixin,
             EpochTrainedRecommender):

    def __init__(self, run_config: RunConfig, model_config: Dict,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__(run_config, SASRecConfig(**model_config), device)
        cfg = self.config
        self.pad_id = pad = self.num_items
        big_l, d = cfg.max_len, cfg.hidden_units
        user_pos = self.dataset.train_data.to_user_dict_by_time()
        users = np.asarray(list(user_pos), dtype=np.int64)
        seqs = pad_sequences([user_pos[u][:-1] for u in users], value=pad,
                             max_len=big_l, padding="pre", truncating="pre")
        poss = pad_sequences([user_pos[u][1:] for u in users], value=pad,
                             max_len=big_l, padding="pre", truncating="pre")
        self.pipeline = SASRecEpochPipeline(self.dataset.train_data, users,
                                            seqs, poss, cfg.batch_size,
                                            self.device, mesh=self.mesh)
        test_seqs = pad_sequences(
            [user_pos[u][-big_l:] if u in user_pos else [pad]
             for u in range(self.num_users)],
            value=pad, max_len=big_l, padding="pre", truncating="pre")
        self.test_seqs = torch.as_tensor(test_seqs.astype(np.int64),
                                         device=self.device)

        gen = torch.Generator().manual_seed(run_config.seed)
        xavier = get_initializer("xavier_uniform")

        def lin():
            return {"w": xavier((d, d), gen), "b": torch.zeros(d)}
        tree = {
            "item_emb": xavier((self.num_items, d), gen),
            "pos_emb": xavier((big_l, d), gen),
            "blocks": [{"ln1_s": torch.ones(d), "ln1_b": torch.zeros(d),
                        "att": {"q": lin(), "k": lin(), "v": lin()},
                        "ln2_s": torch.ones(d), "ln2_b": torch.zeros(d),
                        "ffn": {"ff1": lin(), "ff2": lin()}}
                       for _ in range(cfg.num_blocks)],
            "ln_f_s": torch.ones(d), "ln_f_b": torch.zeros(d)}
        add_param_tree(self, tree, self.device)
        self.optimizer = torch.optim.Adam(self.parameters(), lr=cfg.lr,
                                          betas=(0.9, 0.98), eps=1e-8)
        self.train_step = make_train_step(self.optimizer, self._loss,
                                          self.sync_gradients)

    def step_draws(self, batch: int) -> Optional[Draws]:
        """The next training step's dropout masks, from the epoch's step
        generator."""
        return sasrec_draws(self.step_generator(), batch, self.config)

    def _loss(self, users, seqs, poss, neg, w, draws=None) -> torch.Tensor:
        """The batch's loss under the dropout masks ``draws``, by default
        the next drawn."""
        if draws is None:       # drawn at the whole batch's shape
            draws = local_rows(self.step_draws(global_rows(seqs.shape[0])))
        return sasrec_loss(self.params_tree(), self.config, self.pad_id,
                           seqs, poss, neg, w, draws)

    def _user_vectors(self, users: torch.Tensor) -> torch.Tensor:
        return sasrec_encode(self.params_tree(), self.config, self.pad_id,
                             self.test_seqs[users])[:, -1, :]

    def _score_user_chunk(self, uv: torch.Tensor, item_lo: int,
                          item_hi: int) -> torch.Tensor:
        d = self.config.hidden_units
        return uv @ (self.item_emb[item_lo:item_hi] * (d ** 0.5)).T

    def _topk_factors(self, uv):
        return uv, self.item_emb.detach() * (self.config.hidden_units
                                              ** 0.5), None

    @torch.no_grad()
    def predict(self, users) -> torch.Tensor:
        """(B, N) f32 scores of the users' last hidden states."""
        return self.predict_chunk(users, 0, self.num_items)

    def load_jax_params(self, params: Dict) -> None:
        """Copy a JAX SASRec's ``params`` (arrays taken with
        ``np.asarray``) into this model."""
        self._copy_params(sasrec_params_from_jax(params))
