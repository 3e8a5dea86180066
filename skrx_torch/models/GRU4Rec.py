"""GRU4Rec — session-based recommendation with GRUs (Hidasi et al., ICLR
2016): the port of ``skrx.models.GRU4Rec``.

Same config fields, defaults and checks, and the JAX package's parameters:
``input_emb`` (N, layers[0]) and ``item_emb`` (N, layers[-1]) from a
normal truncated at 2 sigma times 0.01, ``item_bias`` (N,) zeros, and one
TF ``GRUCell`` a layer, ``cells.<i>`` (:mod:`skrx_torch.ops.rnn`).

Training walks the users' time-ordered sequences session-parallel: B rows,
each on one session; each step feeds every row's current item and
predicts its next, and a row whose session runs out takes the next session
of the epoch's permutation and zeroes its states. The (in, out, reset)
schedule of an epoch is built on the host in numpy
(:func:`build_walker_schedule`, the JAX package's, whose step count
:func:`walker_num_steps` sizes) and uploaded once; JAX walks it on the
device inside ``lax.scan``. The states JAX zeroes on the replace-only
slots that it skips are zeroed again at the next emitted step, so the
emitted steps see the same states. A step scores each row's output
against the step's targets (the B next items; GRU4RecPlus appends sampled
negatives), ``final_act(out @ item_emb[y].T + item_bias[y])`` with the
positives on the diagonal, takes the TOP1 or BPR loss plus ``reg`` times
half the squares of the step's input, item and bias rows, and one dense
Adam step (``optax.adam``'s constants). The loss of an epoch is the mean
over its steps.

``predict`` runs the stacked cells over every user's whole padded
training history (a masked step: a row keeps its state past its end) and
scores ``final_act(state @ item_emb.T + item_bias)``. The states are
cached by the parameters' identities and version counters, so a step or a
loaded state computes them anew. With the linear ``final_act`` (the
default) GRU4Rec is a dot model with a bias (``_chunk_embeddings``,
``_chunk_bias``): fused evaluation and fused serving take it. A non-linear
one sets ``_topk_score_fn`` and keeps the predict route.

Under a mesh the walker's B lanes split over the data axis (the batch
size must divide by it): each rank steps its lanes' states, the step's
targets are the whole batch's (gathered over the data axis, with the
sampled negatives every rank draws alike), each row's positive sits at its
global lane, the means divide by the whole batch, the target rows' L2
counts once and the gradients sum over the data axis.
"""
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..convert import gru4rec_params_from_jax
from ..ops.initializers import get_initializer
from ..ops.rnn import ACTIVATIONS, gru_init, stacked_gru_step
from ..parallel import (batch_mean, batch_offset, batch_total,
                        data_sharding, gather_batch_ids, global_rows,
                        local_rows, once)
from ..run_config import RunConfig
from ..utils import ModelConfig
from .base import TorchRecommender
from .common import (ChunkedDotPredictMixin, NestedParamsMixin, adam_l2,
                     gather_rows, param_tree)
from .pipeline import epoch_generator

__all__ = ["GRU4Rec", "GRU4RecConfig", "build_walker_schedule",
           "walker_num_steps", "FINAL_ACTS", "gru4rec_loss_from_logits",
           "gru4rec_loss"]

FINAL_ACTS = {"linear": lambda x: x, "relu": torch.relu,
              "leaky_relu": lambda x: torch.where(x > 0, x, 0.2 * x)}


class GRU4RecConfig(ModelConfig):
    lr: float = 0.001
    reg: float = 0.0
    layers: List[int] = None   # default [64]
    batch_size: int = 128
    loss: str = "top1"         # top1 | bpr
    hidden_act: str = "tanh"   # relu | tanh
    final_act: str = "linear"  # linear | relu | leaky_relu
    epochs: int = 500
    early_stop: int = 100

    def _validate(self):
        if self.layers is None:
            self.layers = [64]
        ok = (isinstance(self.lr, float) and self.lr > 0
              and isinstance(self.reg, float) and self.reg >= 0
              and isinstance(self.layers, list) and len(self.layers) > 0
              and isinstance(self.batch_size, int) and self.batch_size > 0
              and self.loss in ("top1", "bpr")
              and self.hidden_act in ACTIVATIONS
              and self.final_act in FINAL_ACTS)
        if not ok:
            raise ValueError(f"invalid {type(self).__name__}: {self}")


def build_walker_schedule(items: np.ndarray, offsets: np.ndarray,
                          perm: np.ndarray, batch_size: int
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The session-parallel walker's emitted steps over the sessions
    ``items[offsets[s]:offsets[s + 1]]`` in the order ``perm``: (in (T,
    B) int32, out (T, B) int32, reset (T, B) bool), as the JAX package's
    ``build_walker_schedule`` (the reference's loop, GRU4Rec.py:174-207).
    A row whose session ends takes the next one in row order; the walk ends
    when a row finds none left."""
    b = batch_size
    n_sessions = len(offsets) - 1
    _, n_steps = walker_num_steps(np.diff(offsets), perm, b)
    in_s = np.zeros((n_steps, b), np.int32)
    out_s = np.zeros((n_steps, b), np.int32)
    reset_s = np.zeros((n_steps, b), bool)
    if n_steps == 0:
        return in_s, out_s, reset_s
    iters = np.arange(b) % n_sessions
    maxiter = min(b, n_sessions) - 1
    start = offsets[perm[iters]].copy()
    end = offsets[perm[iters] + 1].copy()
    reset = np.ones(b, dtype=bool)
    t = 0
    while True:
        min_len = int((end - start).min())
        if min_len > 1:
            span = start[None, :] + np.arange(min_len)[:, None]
            seg = items[span]                           # (min_len, B)
            in_s[t:t + min_len - 1] = seg[:-1]
            out_s[t:t + min_len - 1] = seg[1:]
            reset_s[t] = reset
            t += min_len - 1
            reset = np.zeros(b, dtype=bool)
        start = start + min_len - 1
        mask = np.where((end - start) <= 1)[0]
        for idx in mask:
            maxiter += 1
            if maxiter >= n_sessions:
                return in_s, out_s, reset_s
            iters[idx] = maxiter
            start[idx] = offsets[perm[maxiter]]
            end[idx] = offsets[perm[maxiter] + 1]
        if len(mask):
            reset[mask] = True


def walker_num_steps(lengths: np.ndarray, perm: np.ndarray,
                     batch_size: int) -> Tuple[int, int]:
    """(slots, emitted) of the walker over sessions of ``lengths`` in the
    order ``perm``, as the JAX package's ``walker_num_steps``: JAX's scan
    runs ``slots`` iterations (a stretch of min_len > 1 emits min_len - 1
    steps; one of min_len 1 only replaces rows), of which ``emitted`` are
    training steps."""
    b = batch_size
    n = len(perm)
    if n == 0:
        return 0, 0
    iters = np.arange(b) % n
    maxiter = min(b, n) - 1
    rem = lengths[perm[iters]].astype(np.int64).copy()
    slots = emitted = 0
    while True:
        m = int(rem.min())
        slots += max(m - 1, 1)
        emitted += m - 1
        rem -= m - 1
        for idx in np.where(rem <= 1)[0]:
            maxiter += 1
            if maxiter >= n:
                return slots, emitted
            rem[idx] = lengths[perm[maxiter]]


def diagonal_positives(logits: torch.Tensor) -> torch.Tensor:
    """(B, 1): each row's positive, at its global row (lane) of the
    (B, Y) logits, the diagonal on one device."""
    rows = torch.arange(logits.shape[0], device=logits.device)
    return logits[rows, batch_offset(logits.shape[0]) + rows][:, None]


def gru4rec_loss_from_logits(logits: torch.Tensor, loss: str
                             ) -> torch.Tensor:
    """TOP1 (with the -sigmoid(pos^2)/B correction) or BPR on (B, Y)
    logits whose diagonal holds the positives (a rank's rows under a mesh,
    the means over the whole batch)."""
    b = global_rows(logits.shape[0])
    pos = diagonal_positives(logits)
    if loss == "bpr":
        return batch_mean(-torch.nn.functional.logsigmoid(pos - logits))
    loss1 = torch.mean(torch.sigmoid(logits - pos), dim=-1)
    loss2 = torch.mean(torch.sigmoid(logits ** 2), dim=-1) \
        - torch.sigmoid(torch.square(pos[:, 0])) / b
    return batch_mean(loss1 + loss2)


def gru4rec_loss(p, cfg: GRU4RecConfig, loss_from_logits: Callable,
                 in_idx: torch.Tensor, out_idx: torch.Tensor,
                 states: Sequence[torch.Tensor],
                 neg: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(one step's loss, the new states) under the params tree ``p``: the
    rows' outputs scored against the step's targets (the next items, then
    ``neg``), ``loss_from_logits`` of them plus ``reg`` times half the
    squares of the step's input, item and bias rows. Under a mesh the rows
    are the rank's lanes and the targets the whole batch's."""
    x = gather_rows(p["input_emb"], in_idx)
    out, new_states = stacked_gru_step(p["cells"], x, states,
                                       ACTIVATIONS[cfg.hidden_act])
    out_idx = gather_batch_ids(out_idx)
    y = out_idx if neg is None else torch.cat([out_idx, neg])
    items = gather_rows(p["item_emb"], y)
    bias = gather_rows(p["item_bias"], y)
    logits = FINAL_ACTS[cfg.final_act](out @ items.T + bias)
    reg = 0.5 * (torch.sum(x ** 2) + once(torch.sum(items ** 2)
                                          + torch.sum(bias ** 2)))
    return loss_from_logits(logits) + cfg.reg * reg, new_states


class GRU4Rec(NestedParamsMixin, ChunkedDotPredictMixin, TorchRecommender):
    config_class = GRU4RecConfig

    def __init__(self, run_config: RunConfig, model_config: Dict,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__(run_config, self.config_class(**model_config),
                         device)
        cfg = self.config
        pairs = self.dataset.train_data.to_user_item_pairs_by_time()
        _, idx = np.unique(pairs[:, 0], return_index=True)
        offsets = np.zeros(len(idx) + 1, dtype=np.int64)
        offsets[:-1] = np.sort(idx)
        offsets[-1] = len(pairs)
        self._items_flat = pairs[:, 1].astype(np.int32)
        self._offsets = offsets
        self._n_sessions = len(offsets) - 1
        self._sess_lens = np.diff(offsets)
        self._hidden_act = ACTIVATIONS[cfg.hidden_act]
        self._final_act = FINAL_ACTS[cfg.final_act]
        if cfg.final_act != "linear":
            fact = self._final_act

            def _score(uv, items, bias):
                return fact(uv @ items.T + bias[None, :])
            self._topk_score_fn = _score

        gen = torch.Generator().manual_seed(run_config.seed)
        tn = get_initializer("truncated_normal")
        l1, ln = cfg.layers[0], cfg.layers[-1]
        n = self.num_items
        self.input_emb = nn.Parameter(tn((n, l1), gen).to(self.device))
        self.item_emb = nn.Parameter(tn((n, ln), gen).to(self.device))
        self.item_bias = nn.Parameter(torch.zeros(n, device=self.device))
        self.cells = param_tree(
            [gru_init(gen, l1 if i == 0 else cfg.layers[i - 1], width)
             for i, width in enumerate(cfg.layers)], self.device)
        self._init_extra()
        self.optimizer = adam_l2(self.parameters(), cfg.lr)
        self._build_predict_tables(pairs[:, 0])
        if self.mesh is not None:
            data_sharding(self.mesh, cfg.batch_size)     # it must divide

    _topk_score_fn = None

    def _init_extra(self) -> None:
        pass

    # -------------------------------------------------------- training

    def _loss_from_logits(self, logits: torch.Tensor) -> torch.Tensor:
        return gru4rec_loss_from_logits(logits, self.config.loss)

    def _loss(self, in_idx: torch.Tensor, out_idx: torch.Tensor,
              states: List[torch.Tensor], neg: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """(the step's loss, the new states) for the states after this
        step's reset; ``neg`` the step's sampled negatives."""
        return gru4rec_loss(self.params_tree(), self.config,
                            self._loss_from_logits, in_idx, out_idx, states,
                            neg)

    def draw_negatives(self, generator: torch.Generator
                       ) -> Optional[torch.Tensor]:
        """One step's sampled negatives (GRU4RecPlus); None here."""
        return None

    def train_step(self, in_idx, out_idx, states, neg=None):
        """One Adam step: (the loss before it, the new states, detached)."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, new_states = self._loss(in_idx, out_idx, states, neg)
        loss.backward()
        for p in self.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.sync_gradients()
        self.optimizer.step()
        return loss.detach(), [s.detach() for s in new_states]

    def epoch_schedule(self, epoch: int) -> Tuple[torch.Tensor, ...]:
        """Epoch ``epoch``'s walker schedule on the device: (in, out) (T, B)
        int64 and reset (T, B) f32. The session order is the JAX package's,
        ``default_rng((seed, epoch)).permutation``."""
        rng = np.random.default_rng((self.run_config.seed, epoch))
        perm = rng.permutation(self._n_sessions)
        in_s, out_s, reset_s = build_walker_schedule(
            self._items_flat, self._offsets, perm, self.config.batch_size)
        ids = torch.as_tensor(np.stack([in_s, out_s]).astype(np.int64),
                              device=self.device)
        return ids[0], ids[1], torch.as_tensor(reset_s.astype(np.float32),
                                               device=self.device)

    step_limit: Optional[int] = None   # steps of an epoch run (all: None)

    def _train_epoch(self, epoch: int) -> Optional[float]:
        in_s, out_s, reset_s = self.epoch_schedule(epoch)
        n_steps = in_s.shape[0]
        if self.step_limit is not None:
            n_steps = min(n_steps, self.step_limit)
        if n_steps == 0:
            return 0.0
        gen = epoch_generator(self.run_config.seed + 1, epoch, self.device,
                              stream=1)
        # under a mesh the rank's lanes (columns) of the schedule
        in_s, out_s, reset_s = (local_rows(t.T).T for t in (in_s, out_s,
                                                              reset_s))
        b = in_s.shape[1]
        states = [torch.zeros((b, n), device=self.device)
                  for n in self.config.layers]
        total = torch.zeros((), device=self.device)
        for t in range(n_steps):
            keep = (1.0 - reset_s[t])[:, None]
            states = [s * keep for s in states]
            loss, states = self.train_step(in_s[t], out_s[t], states,
                                           self.draw_negatives(gen))
            total += loss
        return float(batch_total(total) / n_steps)

    # ---------------------------------------------------------- scoring

    def _build_predict_tables(self, user_ids: np.ndarray) -> None:
        """Each user's training items in time order, time-major (T, U),
        and their mask (``user_ids``: the user of each time-ordered
        pair); users without items have none."""
        sess = np.repeat(np.arange(self._n_sessions), self._sess_lens)
        pos = np.arange(len(sess)) - self._offsets[sess]
        max_len = int(self._sess_lens.max(initial=1))
        seq = np.zeros((max_len, self.num_users), np.int32)
        mask = np.zeros((max_len, self.num_users), bool)
        seq[pos, user_ids] = self._items_flat
        mask[pos, user_ids] = True
        self._pred_seq = torch.as_tensor(seq, device=self.device)
        self._pred_mask = torch.as_tensor(mask, device=self.device)

    _PREDICT_CACHE_ATTRS = ("_final_emb", "_uv_cache", "_states_cache")
    _states_cache = None

    @torch.no_grad()
    def _compute_user_states(self) -> torch.Tensor:
        """(U, layers[-1]): the top state after each user's whole training
        history (zeros for a user without one)."""
        states = [torch.zeros((self.num_users, n), device=self.device)
                  for n in self.config.layers]
        for t in range(self._pred_seq.shape[0]):
            x = torch.index_select(self.input_emb, 0, self._pred_seq[t])
            _, new_states = stacked_gru_step(self.cells, x, states,
                                             self._hidden_act)
            m = self._pred_mask[t][:, None]
            states = [torch.where(m, ns, s)
                      for ns, s in zip(new_states, states)]
        return states[-1]

    def _user_states(self) -> torch.Tensor:
        """The cached user states, computed anew when a parameter is
        another tensor or was updated in place."""
        refs = tuple(self.parameters())
        versions = [p._version for p in refs]
        cached = self._states_cache
        if (cached is None or len(cached[0]) != len(refs)
                or any(a is not b for a, b in zip(cached[0], refs))
                or cached[1] != versions):
            cached = (refs, versions, self._compute_user_states())
            self._states_cache = cached
        return cached[2]

    def _chunk_embeddings(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._user_states(), self.item_emb

    def _chunk_bias(self) -> torch.Tensor:
        return self.item_bias

    @torch.no_grad()
    def predict(self, users) -> torch.Tensor:
        """(B, N) f32 ``final_act(state @ item_emb.T + item_bias)``."""
        return self.predict_chunk(users, 0, self.num_items)

    @torch.no_grad()
    def predict_chunk(self, users, item_lo: int, item_hi: int
                      ) -> torch.Tensor:
        return self._final_act(super().predict_chunk(users, item_lo,
                                                     item_hi))

    # ------------------------------------------------------- conversion

    def load_jax_params(self, params: Dict) -> None:
        """Copy a JAX GRU4Rec's (or GRU4RecPlus's) ``params`` (arrays taken
        with ``np.asarray``) into this model."""
        self._copy_params(gru4rec_params_from_jax(params))
