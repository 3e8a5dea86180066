"""Epoch pipelines on the model's device: the port of
``skrx.models.pipeline`` (``PairwiseEpochPipeline``,
``SequentialPairwiseEpochPipeline``, ``InteractionEpochPipeline``,
``UserVecEpochPipeline``).

Per epoch, as in the JAX package: one permutation of the (padded) training
examples, drawn from a generator seeded from ``(seed + 1, epoch)``; padded
rows carry weight 0. The pairwise pipeline also draws fresh negatives,
excluded against each user's positives. JAX runs the epoch as one
``lax.scan``; here a plain loop of steps runs on the device, building each
step's negatives or interaction rows as it goes (a whole epoch of them would
not fit at Gowalla scale), and the host waits once, for the epoch's mean
loss. JAX's scan chunking (``max_scan_steps``) has no counterpart in such a
loop.

Under a mesh (``mesh=``, every pipeline) every rank
draws the same global epoch from the same seeded generator, the
permutation and the negatives, and takes its data index's rows of each
batch (the batch size must divide by the data axis); ``run_epoch`` sums
the ranks' step losses over the data axis, so the epoch's loss is the
single device's.
"""
import math
from typing import Callable, Tuple

import numpy as np
import torch

from ..io.data_iterator import _generate_time_order_positive_items
from ..io.dataset import ImplicitFeedback
from ..ops.sampling import sample_negatives
from ..parallel import data_sharding
from ..parallel.distributed import all_reduce_sum

__all__ = ["PairwiseEpochPipeline", "SequentialPairwiseEpochPipeline",
           "InteractionEpochPipeline", "UserVecEpochPipeline",
           "RowsEpochPipeline",
           "pad_to_batches", "epoch_generator"]


def pad_to_batches(arr: np.ndarray, batch_size: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad axis 0 up to a multiple of batch_size (repeating row 0) and return
    (padded, weights): 1.0 for real rows, 0.0 for padding."""
    n = len(arr)
    if n == 0:
        raise ValueError("empty training data — nothing to batch")
    padded_n = max(math.ceil(n / batch_size), 1) * batch_size
    weights = np.zeros(padded_n, dtype=np.float32)
    weights[:n] = 1.0
    if padded_n == n:
        return arr, weights
    pad = np.repeat(arr[:1], padded_n - n, axis=0)
    return np.concatenate([arr, pad], axis=0), weights


def epoch_generator(seed: int, epoch: int, device: torch.device,
                    stream: int = 0) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, epoch) (numpy's
    SeedSequence mixes the pair). ``stream`` > 0 gives another generator of
    the same (seed, epoch), independent of stream 0 (the SeedSequence's
    spawn key): a model draws its in-epoch randomness (edge pruning,
    dropout) from stream 1 and leaves the pipeline's draws as they are."""
    state = np.random.SeedSequence(
        [seed, epoch], spawn_key=(stream,) if stream else ()
    ).generate_state(2)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]) << 32 | int(state[1]))
    return gen


class _ShuffledEpochPipeline:
    """Shared epoch mechanism: the padded examples' users and weights on
    ``device``, one permutation of them an epoch from the generator, and
    :meth:`run_epoch`. A subclass gives each step's batch
    (:meth:`_batch`)."""

    def __init__(self, users: np.ndarray, batch_size: int,
                 device: torch.device, mesh=None):
        self.num_examples = len(users)
        padded, weights = pad_to_batches(users, batch_size)
        self.batch_size = batch_size
        self.num_batches = len(padded) // batch_size
        self.device = device
        self.mesh = mesh
        # this rank's rows of every batch: its data index's
        self._data_rows = None
        if mesh is not None and mesh.data_size > 1:
            blocks = data_sharding(mesh, batch_size)
            self._data_rows = slice(blocks.lo, blocks.hi)
        self._users = self._put(padded)
        self._w = torch.as_tensor(weights, device=device)

    def _put(self, ids: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(ids.astype(np.int64), device=self.device)

    def _batch(self, generator: torch.Generator, idx: torch.Tensor):
        raise NotImplementedError

    def batches(self, generator: torch.Generator):
        """The epoch's batches, shuffled (and sampled) from ``generator``."""
        perm = torch.randperm(len(self._users), generator=generator,
                              device=self.device)
        b = self.batch_size
        for step in range(self.num_batches):
            batch = self._batch(generator, perm[step * b:(step + 1) * b])
            yield batch if self._data_rows is None else \
                tuple(t[self._data_rows] for t in batch)

    def run_epoch(self, generator: torch.Generator,
                  train_step: Callable) -> float:
        """Run ``train_step(batch) -> loss`` over the batches of one epoch;
        returns the mean over steps of the step losses (one device
        sync; under a mesh the ranks' losses summed over the data axis)."""
        total = torch.zeros((), device=self.device)
        for batch in self.batches(generator):
            total += train_step(batch)
        if self.mesh is not None:
            all_reduce_sum(total, self.mesh.data_group, self.mesh.data_size)
        return float(total / self.num_batches)


class InteractionEpochPipeline(_ShuffledEpochPipeline):
    """(users (B,), pos (B,), weight (B,)) batches of the training pairs,
    without negatives (SelfCF), on ``device``."""

    def __init__(self, train_data: ImplicitFeedback, batch_size: int,
                 device: torch.device, mesh=None):
        pairs = train_data.to_user_item_pairs()
        super().__init__(pairs[:, 0], batch_size, device, mesh)
        self._pos = self._put(pad_to_batches(pairs[:, 1], batch_size)[0])

    def _batch(self, generator, idx):
        return self._users[idx], self._pos[idx], self._w[idx]


class PairwiseEpochPipeline(InteractionEpochPipeline):
    """(users (B,), pos (B,), neg (B, num_neg), weight (B,)) batches for
    BPR-style models, on ``device``."""

    def __init__(self, train_data: ImplicitFeedback, batch_size: int,
                 device: torch.device, num_neg: int = 1, num_trials: int = 8,
                 mesh=None):
        super().__init__(train_data, batch_size, device, mesh)
        self._init_negatives(train_data, num_neg, num_trials)

    def _init_negatives(self, train_data: ImplicitFeedback, num_neg: int,
                        num_trials: int) -> None:
        self.num_items = train_data.num_items
        self.num_neg = num_neg
        self.num_trials = num_trials
        self._pos_table = torch.as_tensor(
            train_data.to_padded_positive_table().table, device=self.device)

    def _batch(self, generator, idx):
        users, pos, w = super()._batch(generator, idx)
        neg = sample_negatives(generator, users, self._pos_table,
                               self.num_items, self.num_neg, self.num_trials)
        return users, pos, neg.long(), w


class SequentialPairwiseEpochPipeline(PairwiseEpochPipeline):
    """(users (B,), pos (B,) or (B, num_next), neg (B, num_next), weight
    (B,), prev (B, num_previous)) batches of the examples of
    :func:`~skrx_torch.io.data_iterator._generate_time_order_positive_items`
    over each user's time-ordered training sequence (pre-padded with
    ``pad`` when given), on ``device``. ``pos`` is (B,) when ``num_next``
    is 1. Each next slot gets one negative, excluded against all of the
    user's positives and drawn anew every epoch; ``prev`` follows the
    epoch's permutation with the rest of the example."""

    def __init__(self, train_data: ImplicitFeedback, batch_size: int,
                 device: torch.device, num_previous: int = 1,
                 num_next: int = 1, pad=None, num_trials: int = 8,
                 mesh=None):
        _, users, prev, nxt = _generate_time_order_positive_items(
            train_data.to_user_dict_by_time(), num_previous=num_previous,
            num_next=num_next, pad=pad)
        # the examples are these windows, not the training pairs that
        # InteractionEpochPipeline's constructor reads
        _ShuffledEpochPipeline.__init__(self, users, batch_size, device,
                                        mesh)
        pos = nxt if num_next > 1 else nxt[:, 0]
        self._pos = self._put(pad_to_batches(pos, batch_size)[0])
        self._prev = self._put(pad_to_batches(prev, batch_size)[0])
        self._init_negatives(train_data, num_next, num_trials)

    def _batch(self, generator, idx):
        return (*super()._batch(generator, idx), self._prev[idx])


class UserVecEpochPipeline(_ShuffledEpochPipeline):
    """(users (B,), rows (B, N) f32 0/1, weight (B,)) batches for the
    autoencoders (CDAE, MultVAE), on ``device``. The users are those with at
    least one training positive, padded with weight 0. A batch's rows are
    scattered on the device from the padded positive table, so the (U, N)
    interaction matrix is never built."""

    def __init__(self, train_data: ImplicitFeedback, batch_size: int,
                 device: torch.device, mesh=None):
        pp = train_data.to_padded_positive_table()
        super().__init__(np.nonzero(pp.lengths > 0)[0], batch_size, device,
                         mesh)
        self.num_items = train_data.num_items
        self.pos_table = torch.as_tensor(pp.table, device=device)

    def rows_for(self, users: torch.Tensor) -> torch.Tensor:
        """(B, N) f32 0/1 interaction rows of ``users`` (int64 on the
        pipeline's device): each user's padded table row set to 1 in a
        (B, N + 1) matrix whose pad column (id N) is dropped."""
        table_rows = self.pos_table[users].long()
        rows = torch.zeros((users.shape[0], self.num_items + 1),
                           device=self.device)
        rows.scatter_(1, table_rows, 1.0)
        return rows[:, :self.num_items]

    def _batch(self, generator, idx):
        users = self._users[idx]
        return users, self.rows_for(users), self._w[idx]


class RowsEpochPipeline(_ShuffledEpochPipeline):
    """(rows[0] (B, ...), rows[1] (B, ...), ..., weight (B,)) batches of
    per-example integer rows, padded with weight 0, on ``device``: SASRec's
    (user, input sequence, target sequence), BERT4Rec's windows."""

    def __init__(self, rows, batch_size: int, device: torch.device,
                 mesh=None):
        super().__init__(rows[0], batch_size, device, mesh)
        self._rows = [self._users] + [
            self._put(pad_to_batches(r, batch_size)[0]) for r in rows[1:]]

    def _batch(self, generator, idx):
        return (*(r[idx] for r in self._rows), self._w[idx])
