"""BERT4Rec — bidirectional transformer with masked-item modelling (Sun et
al., CIKM 2019): the port of ``skrx.models.BERT4Rec``.

Same config fields, defaults and checks, and the JAX package's parameters
(a normal truncated at 2 sigma times ``init_range``, zero biases, unit
LayerNorm scales): ``tok_emb`` (N + 2, d) (ids N and N + 1 the mask and
pad tokens), ``pos_emb`` (L, d), ``ln_e_s``, ``ln_e_b``, ``blocks.<i>``
with ``{q, k, v, att_out}.{w, b}``, ``ln1_s``, ``ln1_b``, ``ff1`` (d, 4d),
``ff2`` (4d, d), ``ln2_s``, ``ln2_b``; the MLM head's ``mlm_dense``,
``mlm_ln_s``, ``mlm_ln_b`` and ``out_bias`` (N + 2,), its output tied to
``tok_emb``.

Training examples are sliding windows of each user's time-ordered training
items (``max_seq_len`` long, stepped back by ``sliding_step`` from the
end, then the first; a shorter history is one window), post-padded with
the pad id. A step masks each row (:func:`bert4rec_mask`: from a (B, L)
tensor of uniforms, a real position whose draw is below
``masked_lm_prob``, at most round(L p) of them by the smallest draws, the
last real position when none was picked), runs the post-LN encoder
(:func:`bert4rec_encode`: the pad keys at -1e9, GELU with the tanh
approximation, as ``jax.nn.gelu``), and takes the mean negative
log-likelihood of the masked tokens over the catalog and both special
tokens. The optimizer is optax's ``clip_by_global_norm(5.0)`` then
``adamw(eps=1e-6, weight_decay=0.01)``, the decay on every leaf but the
LayerNorm and bias ones, at a learning rate of 100 linear warm-up steps
from 0 and a linear decay to 0 over the rest of ``epochs`` epochs
(:class:`~skrx_torch.ops.optim.OptaxAdamW`). The uniforms and the dropout
masks are the loss's arguments (:func:`bert4rec_draws`: from the epoch's
step generator). ``compute_dtype="bfloat16"`` runs the encoder on bf16
copies of the f32 parameters.

A user's test row is its training and test items in time order with the
last one replaced by the mask token (the reference's quirk, kept: for a
user with several test items the earlier ones are visible), the last L - 1
of them before the mask; its vector is the MLM head's transform of the
encoder's state at the mask, and ``predict`` is ``uv @ tok_emb[:N].T +
out_bias[:N]``: a tower with a bias (``_topk_factors``). ``verbose``
(10) sets the evaluation period of ``fit()``.

Under a mesh BERT4Rec trains data-parallel: each rank takes its data
index's slice of the windows and of the step's uniforms and dropout masks
(drawn at the whole batch's shape), the mean divides by the whole batch's
masked positions, and the gradients sum over the data axis before the
global-norm clip.
"""
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..convert import adam_state_from_jax, bert4rec_params_from_jax
from ..ops.attention import dense, dropout, keep_mask, layer_norm
from ..ops.initializers import get_initializer
from ..ops.optim import OptaxAdamW, warmup_linear_decay
from ..parallel import batch_total, global_rows, local_rows
from ..run_config import RunConfig
from ..utils import ModelConfig
from .common import (CachedUserVecChunkMixin, EpochTrainedRecommender,
                     NestedParamsMixin, add_param_tree, cast_tree,
                     dotted_jax_leaves, gather_rows, make_train_step)
from .pipeline import RowsEpochPipeline

__all__ = ["BERT4Rec", "BERT4RecConfig", "bert4rec_windows",
           "bert4rec_test_tokens", "bert4rec_mask", "bert4rec_encode",
           "bert4rec_loss", "bert4rec_draws", "decays"]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class BERT4RecConfig(ModelConfig):
    max_seq_len: int = 5
    masked_lm_prob: float = 0.4
    sliding_step: int = 1
    dupe_factor: int = 10       # kept for config parity (masks are drawn
    #                             anew each epoch)
    att_drop: float = 0.2
    h_drop: float = 0.5
    h_size: int = 64
    att_heads: int = 2
    init_range: float = 0.02
    h_act: str = "gelu"
    n_layers: int = 2
    lr: float = 1e-4
    batch_size: int = 256
    epochs: int = 3000
    early_stop: int = 80
    verbose: int = 10           # evaluate every `verbose` epochs
    compute_dtype: str = "float32"

    def _validate(self):
        ok = (isinstance(self.max_seq_len, int) and self.max_seq_len > 0
              and 0 < self.masked_lm_prob < 1
              and isinstance(self.sliding_step, int) and self.sliding_step > 0
              and isinstance(self.h_size, int) and self.h_size > 0
              and self.h_size % self.att_heads == 0
              and isinstance(self.lr, float) and self.lr > 0
              and isinstance(self.batch_size, int) and self.batch_size > 0
              and self.compute_dtype in DTYPES)
        if not ok:
            raise ValueError(f"invalid BERT4Rec config: {self}")


def bert4rec_windows(user_pos, max_len: int, step: int,
                     pad_id: int) -> np.ndarray:
    """(W, max_len) int32 training windows, users ascending: a history no
    longer than ``max_len`` as one window, a longer one as the windows
    starting at len - max_len, len - max_len - step, ... (> 0), then 0;
    post-padded with ``pad_id``."""
    starts, rows = [], []
    offset = 0
    flat = []
    for seq in user_pos.values():
        n = len(seq)
        if n <= max_len:
            begs = np.zeros(1, np.int64)
        else:
            begs = np.append(np.arange(n - max_len, 0, -step), 0)
        starts.append(offset + begs)
        rows.append(np.minimum(n - begs, max_len))
        flat.append(seq)
        offset += n
    starts, lens = np.concatenate(starts), np.concatenate(rows)
    items = np.concatenate(flat).astype(np.int32)
    cols = np.arange(max_len)
    idx = starts[:, None] + cols[None, :]
    real = cols[None, :] < lens[:, None]
    return np.where(real, items[np.where(real, idx, 0)],
                    pad_id).astype(np.int32)


def bert4rec_test_tokens(num_users: int, user_pos, test_pos, max_len: int,
                         mask_id: int, pad_id: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """(U, max_len) int32 test rows and (U,) int32 mask positions: a user's
    training then test items with the last dropped, the last max_len - 1
    of them, then the mask token, post-padded."""
    tokens = np.full((num_users, max_len), pad_id, dtype=np.int32)
    mask_pos = np.zeros(num_users, dtype=np.int32)
    empty = np.zeros(0, dtype=np.int32)
    for u in range(num_users):
        doc = np.concatenate([user_pos.get(u, empty),
                              test_pos.get(u, empty)]).astype(np.int32)
        hist = doc[:-1][-(max_len - 1):] if max_len > 1 and len(doc) \
            else doc[:0]
        tokens[u, :len(hist)] = hist
        tokens[u, len(hist)] = mask_id
        mask_pos[u] = len(hist)
    return tokens, mask_pos


Draws = Tuple[torch.Tensor, Optional[torch.Tensor],
              List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]]


def bert4rec_draws(generator: torch.Generator, batch: int,
                   cfg: BERT4RecConfig) -> Draws:
    """One step's draws: the (B, L) masking uniforms, the embedding's (B,
    L, d) dropout keep mask and per layer the attention probabilities'
    (B, heads, L, L), the attention output's and the FFN's (B, L, d)."""
    big_l, d, h = cfg.max_seq_len, cfg.h_size, cfg.att_heads
    scores = torch.rand((batch, big_l), generator=generator,
                        device=generator.device)
    emb = keep_mask(generator, (batch, big_l, d), cfg.h_drop)
    blocks = [(keep_mask(generator, (batch, h, big_l, big_l), cfg.att_drop),
               keep_mask(generator, (batch, big_l, d), cfg.h_drop),
               keep_mask(generator, (batch, big_l, d), cfg.h_drop))
              for _ in range(cfg.n_layers)]
    return scores, emb, blocks


def bert4rec_mask(tokens: torch.Tensor, scores: torch.Tensor, prob: float,
                  max_preds: int, pad_id: int) -> torch.Tensor:
    """(B, L) bool: the positions a step masks, from its uniforms."""
    real = tokens != pad_id
    do_mask = (scores < prob) & real
    sel = torch.where(do_mask, -scores, torch.inf)
    kth = torch.sort(sel, dim=1).values[:, max_preds - 1:max_preds]
    do_mask = do_mask & (sel <= kth)
    any_mask = torch.any(do_mask, dim=1)
    last_real = torch.clamp(torch.sum(real, dim=1) - 1, min=0)
    force = F.one_hot(last_real, tokens.shape[1]).bool() & real \
        & ~any_mask[:, None]
    return do_mask | force


def _act(cfg: BERT4RecConfig):
    if cfg.h_act == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    return torch.relu


def bert4rec_encode(p, cfg: BERT4RecConfig, pad_id: int,
                    tokens: torch.Tensor, draws=None) -> torch.Tensor:
    """(B, L, d) f32 states of ``tokens`` under the params tree ``p``;
    ``draws`` the dropout masks (the embedding's and a triple a layer;
    None: no dropout)."""
    p = cast_tree(p, DTYPES[cfg.compute_dtype])
    act, d, heads = _act(cfg), cfg.h_size, cfg.att_heads
    b, t = tokens.shape
    hd = d // heads
    emb_keep, block_keeps = draws if draws is not None \
        else (None, [(None, None, None)] * cfg.n_layers)
    x = gather_rows(p["tok_emb"], tokens) + p["pos_emb"][None, :t, :]
    x = dropout(layer_norm(x, p["ln_e_s"], p["ln_e_b"]), cfg.h_drop,
                emb_keep)
    key_ok = (tokens != pad_id)[:, None, None, :]
    for blk, (att_keep, ctx_keep, ff_keep) in zip(p["blocks"], block_keeps):
        q = dense(x, blk["q"]).reshape(b, t, heads, hd).transpose(1, 2)
        k = dense(x, blk["k"]).reshape(b, t, heads, hd).permute(0, 2, 3, 1)
        v = dense(x, blk["v"]).reshape(b, t, heads, hd).transpose(1, 2)
        logits = torch.where(key_ok, torch.matmul(q, k) / (hd ** 0.5), -1e9)
        probs = dropout(torch.softmax(logits, dim=-1), cfg.att_drop,
                        att_keep)
        ctx = torch.matmul(probs, v).transpose(1, 2).reshape(b, t, d)
        ctx = dropout(dense(ctx, blk["att_out"]), cfg.h_drop, ctx_keep)
        x = layer_norm(x + ctx, blk["ln1_s"], blk["ln1_b"])
        ff = dense(act(dense(x, blk["ff1"])), blk["ff2"])
        ff = dropout(ff, cfg.h_drop, ff_keep)
        x = layer_norm(x + ff, blk["ln2_s"], blk["ln2_b"])
    return x.float()


def _mlm_transform(p, cfg: BERT4RecConfig, hidden: torch.Tensor
                   ) -> torch.Tensor:
    h = _act(cfg)(dense(hidden, p["mlm_dense"]))
    return layer_norm(h, p["mlm_ln_s"], p["mlm_ln_b"])


def bert4rec_loss(p, cfg: BERT4RecConfig, num_items: int,
                  tokens: torch.Tensor, w: torch.Tensor, draws: Draws
                  ) -> torch.Tensor:
    """One batch's masked-LM loss under the step's draws."""
    mask_id, pad_id = num_items, num_items + 1
    scores, emb_keep, block_keeps = draws
    max_preds = max(int(round(cfg.max_seq_len * cfg.masked_lm_prob)), 1)
    do_mask = bert4rec_mask(tokens, scores, cfg.masked_lm_prob, max_preds,
                            pad_id)
    inp = torch.where(do_mask, mask_id, tokens)
    hidden = bert4rec_encode(p, cfg, pad_id, inp, (emb_keep, block_keeps))
    logits = _mlm_transform(p, cfg, hidden) @ p["tok_emb"].T + p["out_bias"]
    log_probs = torch.log_softmax(logits, dim=-1)
    tgt = torch.gather(log_probs, -1, tokens[..., None])[..., 0]
    weight = do_mask.float() * w[:, None]
    return -torch.sum(tgt * weight) / torch.clamp(batch_total(weight),
                                                  min=1.0)


def decays(jax_path: str) -> bool:
    """Whether optax's mask of the JAX package decays the leaf at
    ``jax_path`` (``blocks/0/q/w``): every leaf but those whose path holds
    "ln" and the bias leaves (``b``, ``bias`` or a name holding
    "bias")."""
    leaf = jax_path.rsplit("/", 1)[-1]
    is_bias = leaf in ("b", "bias") or "bias" in leaf
    return not ("ln" in jax_path or is_bias)


class BERT4Rec(NestedParamsMixin, CachedUserVecChunkMixin,
               EpochTrainedRecommender):

    def __init__(self, run_config: RunConfig, model_config: Dict,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__(run_config, BERT4RecConfig(**model_config), device)
        cfg = self.config
        n = self.num_items
        self.mask_id, self.pad_id = n, n + 1
        big_l, d = cfg.max_seq_len, cfg.h_size
        user_pos = self.dataset.train_data.to_user_dict_by_time()
        windows = bert4rec_windows(user_pos, big_l, cfg.sliding_step,
                                   self.pad_id)
        self.pipeline = RowsEpochPipeline([windows], cfg.batch_size,
                                          self.device, mesh=self.mesh)
        tokens, mask_pos = bert4rec_test_tokens(
            self.num_users, user_pos,
            self.dataset.test_data.to_user_dict_by_time(), big_l,
            self.mask_id, self.pad_id)
        self.test_tokens = torch.as_tensor(tokens.astype(np.int64),
                                           device=self.device)
        self.test_mask_pos = torch.as_tensor(mask_pos.astype(np.int64),
                                             device=self.device)

        gen = torch.Generator().manual_seed(run_config.seed)
        tn = get_initializer("truncated_normal")
        scale = cfg.init_range / 0.01       # the initializer's sigma is 0.01

        def w(shape):
            return tn(shape, gen) * scale

        def lin(n_in, n_out):
            return {"w": w((n_in, n_out)), "b": torch.zeros(n_out)}
        vocab = n + 2
        tree = {
            "tok_emb": w((vocab, d)), "pos_emb": w((big_l, d)),
            "ln_e_s": torch.ones(d), "ln_e_b": torch.zeros(d),
            "mlm_dense": lin(d, d),
            "mlm_ln_s": torch.ones(d), "mlm_ln_b": torch.zeros(d),
            "out_bias": torch.zeros(vocab),
            "blocks": [{"q": lin(d, d), "k": lin(d, d), "v": lin(d, d),
                        "att_out": lin(d, d),
                        "ln1_s": torch.ones(d), "ln1_b": torch.zeros(d),
                        "ff1": lin(d, 4 * d), "ff2": lin(4 * d, d),
                        "ln2_s": torch.ones(d), "ln2_b": torch.zeros(d)}
                       for _ in range(cfg.n_layers)]}
        add_param_tree(self, tree, self.device)
        named = dotted_jax_leaves(self)
        groups = [{"params": [self.get_parameter(name) for path, (name, _)
                              in named.items() if decays(path) == flag],
                   "decay": flag} for flag in (True, False)]
        num_steps = max(self.pipeline.num_batches * cfg.epochs, 1)
        self.optimizer = OptaxAdamW(
            groups, warmup_linear_decay(cfg.lr, 100, num_steps),
            b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.01, max_norm=5.0)
        self.train_step = make_train_step(self.optimizer, self._loss,
                                          self.sync_gradients)

    def step_draws(self, batch: int) -> Draws:
        """The next training step's uniforms and dropout masks, from the
        epoch's step generator."""
        return bert4rec_draws(self.step_generator(), batch, self.config)

    def _loss(self, tokens, w, draws=None) -> torch.Tensor:
        """The batch's loss under ``draws``, by default the next drawn."""
        if draws is None:       # drawn at the whole batch's shape
            draws = local_rows(self.step_draws(global_rows(tokens.shape[0])))
        return bert4rec_loss(self.params_tree(), self.config, self.num_items,
                             tokens, w, draws)

    def _user_vectors(self, users: torch.Tensor) -> torch.Tensor:
        p = self.params_tree()
        hidden = bert4rec_encode(p, self.config, self.pad_id,
                                 self.test_tokens[users])
        pos = self.test_mask_pos[users]
        h = hidden[torch.arange(len(users), device=hidden.device), pos]
        return _mlm_transform(p, self.config, h)

    def _score_user_chunk(self, uv: torch.Tensor, item_lo: int,
                          item_hi: int) -> torch.Tensor:
        return uv @ self.tok_emb[item_lo:item_hi].T \
            + self.out_bias[None, item_lo:item_hi]

    def _topk_factors(self, uv):
        n = self.num_items
        return uv, self.tok_emb.detach()[:n], self.out_bias.detach()[:n]

    @torch.no_grad()
    def predict(self, users) -> torch.Tensor:
        """(B, N) f32 scores over the real items."""
        return self.predict_chunk(users, 0, self.num_items)

    def load_jax_params(self, params: Dict) -> None:
        """Copy a JAX BERT4Rec's ``params`` (arrays taken with
        ``np.asarray``) into this model."""
        self._copy_params(bert4rec_params_from_jax(params))

    def load_jax_opt_state(self, count: int, mu: np.ndarray,
                           nu: np.ndarray) -> None:
        """Set the optimizer's state from the adamw part of a JAX
        BERT4Rec's ``opt_state``: its ``count`` and ``mu``, ``nu`` raveled
        in JAX's order (the schedule's count is the same number)."""
        leaves = self._jax_leaves()
        shapes = {key: tuple(self.get_parameter(name).shape)
                  for key, (name, _) in leaves.items()}
        for key, state in adam_state_from_jax(count, mu, nu, shapes).items():
            param = self.get_parameter(leaves[key][0])
            self.optimizer.state[param] = {
                "exp_avg": state["exp_avg"].to(self.device),
                "exp_avg_sq": state["exp_avg_sq"].to(self.device)}
        self.optimizer.count = int(count)
