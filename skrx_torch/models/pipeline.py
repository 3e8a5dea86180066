"""Epoch pipeline of pairwise (BPR) training on the model's device: the
port of ``skrx.models.pipeline.PairwiseEpochPipeline``.

Per epoch, as in the JAX package: one permutation of the (padded) training
pairs and fresh negatives excluded against each user's positives, drawn
from a generator seeded from ``(seed + 1, epoch)``; padded rows carry weight
0. JAX runs the epoch as one ``lax.scan``; here a plain loop of steps runs
on the device, sampling each step's negatives as it goes (a whole epoch of
(pairs, max_positives) table rows would not fit at Gowalla scale), and the
host waits once, for the epoch's mean loss.
"""
import math
from typing import Callable, Tuple

import numpy as np
import torch

from ..io.dataset import ImplicitFeedback
from ..ops.sampling import sample_negatives

__all__ = ["PairwiseEpochPipeline", "pad_to_batches", "epoch_generator"]


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


class PairwiseEpochPipeline:
    """(users (B,), pos (B,), neg (B, num_neg), weight (B,)) batches for
    BPR-style models, on ``device``."""

    def __init__(self, train_data: ImplicitFeedback, batch_size: int,
                 device: torch.device, num_neg: int = 1, num_trials: int = 8):
        pairs = train_data.to_user_item_pairs()
        users, weights = pad_to_batches(pairs[:, 0], batch_size)
        pos, _ = pad_to_batches(pairs[:, 1], batch_size)
        self.num_items = train_data.num_items
        self.num_neg = num_neg
        self.num_trials = num_trials
        self.batch_size = batch_size
        self.num_batches = len(users) // batch_size
        self.num_examples = len(pairs)
        self.device = device
        self._users = torch.as_tensor(users.astype(np.int64), device=device)
        self._pos = torch.as_tensor(pos.astype(np.int64), device=device)
        self._w = torch.as_tensor(weights, device=device)
        self._pos_table = torch.as_tensor(
            train_data.to_padded_positive_table().table, device=device)

    def batches(self, generator: torch.Generator):
        """The epoch's batches, shuffled and sampled from ``generator``."""
        perm = torch.randperm(len(self._users), generator=generator,
                              device=self.device)
        b = self.batch_size
        for step in range(self.num_batches):
            idx = perm[step * b:(step + 1) * b]
            users = self._users[idx]
            neg = sample_negatives(generator, users, self._pos_table,
                                   self.num_items, self.num_neg,
                                   self.num_trials)
            yield users, self._pos[idx], neg.long(), self._w[idx]

    def run_epoch(self, generator: torch.Generator,
                  train_step: Callable) -> float:
        """Run ``train_step(batch) -> loss`` over one epoch; returns the mean
        over steps of the step losses (one device sync)."""
        total = torch.zeros((), device=self.device)
        for batch in self.batches(generator):
            total += train_step(batch)
        return float(total / self.num_batches)
