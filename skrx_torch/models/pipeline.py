"""Epoch pipelines on the model's device: the port of
``skrx.models.pipeline`` (``PairwiseEpochPipeline``,
``SequentialPairwiseEpochPipeline``, ``InteractionEpochPipeline``,
``UserVecEpochPipeline``).

Per epoch, as in the JAX package: one permutation of the (padded) training
examples, drawn from a generator seeded from ``(seed + 1, epoch)``; padded
rows carry weight 0. The pairwise pipeline also draws fresh negatives,
excluded against each user's positives. Each step builds its negatives or
interaction rows as it goes (a whole epoch of them would not fit at
Gowalla scale), and the host waits once, for the epoch's mean loss.

JAX runs the epoch as one program, a ``lax.scan`` of the step under
``jit``. Its counterpart here is :class:`EpochProgram`:
``run_epoch(..., captured=True)`` holds one whole step (its slice of the
permutation, its draws, the loss, the backward and the optimizer's update,
the loss added into a sum on the device) in a CUDA graph, captured once per
pipeline and step, and replays it once for each batch; the host submits a
replay a step and reads nothing back until the epoch's end. It takes a step
whose tensors stay in place (``train_step.state``), on a CUDA device,
without a mesh: :class:`~skrx_torch.models.common.FlatTrainStep`, the
dense-Adam step on one device of BPRMF, LightGCN, FPMC, TransRec, SGAT and
MGCN (JAX's ``make_flat_train_step``), and
:class:`~skrx_torch.models.common.LeafTrainStep`, the per-leaf dense-Adam
step of SelfCF, BM3 and SLMRec (interaction batches) and of CDAE and
MultVAE (user rows). A step's own draws (a model's ``step_generator()``:
SelfCF's edge mask, the dropout masks, CDAE's negatives, MultVAE's noise)
come from the program's step generator, which the graph registers beside
the pipeline's: JAX's key in the scan's carry. The pairwise batches (one
negative a user, or SGAT's ``num_next`` = 3 a window beside its (B, 5)
previous items) and the user rows draw nothing back to the host.
``captured=False`` runs the steps as a plain loop: the route on the CPU,
under a mesh, under lazy Adam, and of every other model. JAX's scan
chunking (``max_scan_steps``) has no counterpart: a replay holds one step,
whatever the epoch's length.

Under a mesh (``mesh=``, every pipeline) every rank
draws the same global epoch from the same seeded generator, the
permutation and the negatives, and takes its data index's rows of each
batch (the batch size must divide by the data axis); ``run_epoch`` sums
the ranks' step losses over the data axis, so the epoch's loss is the
single device's.
"""
import math
import time
from typing import Callable, Tuple

import numpy as np
import torch

from ..io.data_iterator import _generate_time_order_positive_items
from ..io.dataset import ImplicitFeedback
from ..ops.kernels.runtime import WARMUP_STEPS, CapturedStep
from ..ops.sampling import sample_negatives
from ..parallel import data_sharding
from ..parallel.distributed import all_reduce_sum

__all__ = ["PairwiseEpochPipeline", "SequentialPairwiseEpochPipeline",
           "InteractionEpochPipeline", "UserVecEpochPipeline",
           "RowsEpochPipeline", "EpochProgram", "mark_written",
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
        # train step -> its EpochProgram
        self._programs = {}
        self.last_run = None

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

    def run_epoch(self, generator: torch.Generator, train_step: Callable,
                  captured: bool = False,
                  step_generator: torch.Generator = None) -> float:
        """Run ``train_step(batch) -> loss`` over the batches of one epoch;
        returns the mean over steps of the step losses (one device
        sync; under a mesh the ranks' losses summed over the data axis).
        ``captured``: the epoch as one program, each step a replay of a
        CUDA graph (:class:`EpochProgram`; a CUDA device, no mesh, a step
        with ``state``), else a loop of eager steps. ``step_generator``:
        the generator of the step's own draws; the captured route replays
        them from :meth:`program`'s step generator, which takes its state
        over and gives it back (the step must draw from that one), the
        eager loop leaves them to the step. Either way ``last_run`` then
        says how the epoch ran: its ``route``, and ``replays``,
        ``warmup_steps`` and ``capture_seconds`` (0 where it replayed a
        graph captured before) of a captured one."""
        if captured:
            return self._run_captured(generator, train_step, step_generator)
        total = torch.zeros((), device=self.device)
        for batch in self.batches(generator):
            total += train_step(batch)
        if self.mesh is not None:
            all_reduce_sum(total, self.mesh.data_group, self.mesh.data_size)
        self.last_run = {"route": "eager", "steps": self.num_batches}
        return float(total / self.num_batches)

    def program(self, train_step: Callable) -> "EpochProgram":
        """The :class:`EpochProgram` of ``train_step`` on this pipeline,
        made at the first call."""
        program = self._programs.get(train_step)
        if program is None:
            program = self._programs[train_step] = EpochProgram(self,
                                                                train_step)
        return program

    def _run_captured(self, generator: torch.Generator,
                      train_step: Callable,
                      step_generator: torch.Generator = None) -> float:
        if self.device.type != "cuda":
            raise ValueError(f"a captured epoch runs on a CUDA device, not "
                             f"{self.device}; run_epoch(captured=False) "
                             f"runs its steps eagerly")
        if self.mesh is not None:
            raise ValueError("a mesh's epoch runs eagerly: its steps call "
                             "the process group's collectives")
        state = getattr(train_step, "state", None)
        if state is None:
            raise TypeError("a captured epoch needs a step whose tensors "
                            "stay in place (train_step.state; "
                            "FlatTrainStep, LeafTrainStep under Adam)")
        state = tuple(state)
        program = self.program(train_step)
        capture_s, warmup = 0.0, 0
        # captured anew when the step's tensors were replaced (an
        # optimizer's load_state_dict): the graph holds their addresses
        if program.graph is None or any(
                a is not b for a, b in zip(program.state, state)):
            t0 = time.perf_counter()
            program.graph = CapturedStep(
                program.step, self.device,
                keep=(*state, program.index, program.total),
                generators=(program.generator, program.step_generator))
            capture_s, warmup = time.perf_counter() - t0, WARMUP_STEPS
            program.state = state
        loss = program.run(generator, program.graph.replay, step_generator)
        mark_written(state)
        self.last_run = {"route": "captured", "replays": self.num_batches,
                         "warmup_steps": warmup,
                         "capture_seconds": capture_s}
        return loss


def mark_written(tensors) -> None:
    """Move the version counters of ``tensors``, which a CUDA graph's
    replays wrote without them: caches of derived tables key on the
    counters (serving's packed items, FPMC's concatenated tables, a
    tower's user vectors), and a parameter that is a view of a flat vector
    shares its counter."""
    for t in tensors:
        torch.autograd.graph.increment_version(t)


class EpochProgram:
    """One epoch of ``pipeline`` as a program of one step, the counterpart
    of the JAX package's scanned epoch (``PairwiseEpochPipeline.
    _epoch_impl`` and the interaction and user-row pipelines'): the
    epoch's permutation, the step index and the sum of the losses live in
    buffers on the pipeline's device, and :meth:`step` runs one whole step
    from them (the index's slice of the permutation, the batch and its
    draws from the program's generator, ``train_step`` with its own draws
    from ``step_generator``, the loss added in, the index moved on)
    without reading anything back to the host, so that a CUDA graph can
    hold it (``graph``, a :class:`~skrx_torch.ops.kernels.runtime.
    CapturedStep` of the step's tensors ``state``). :meth:`run` runs an
    epoch: eagerly, or a graph's replay a step."""

    def __init__(self, pipeline: "_ShuffledEpochPipeline",
                 train_step: Callable):
        dev = pipeline.device
        self.pipeline, self.train_step = pipeline, train_step
        self.generator = torch.Generator(device=dev)
        # the step's own draws (JAX's key in the scan's carry)
        self.step_generator = torch.Generator(device=dev)
        self.perm = torch.zeros(len(pipeline._users), dtype=torch.int64,
                                device=dev)
        self.index = torch.zeros(1, dtype=torch.int64, device=dev)
        self.total = torch.zeros((), device=dev)
        self.graph, self.state = None, ()

    def step(self) -> None:
        p = self.pipeline
        idx = self.perm.view(-1, p.batch_size).index_select(0, self.index)[0]
        self.total.add_(self.train_step(p._batch(self.generator, idx)))
        self.index.add_(1)

    def run(self, generator: torch.Generator,
            replay: Callable[[], None] = None,
            step_generator: torch.Generator = None) -> float:
        """One epoch from ``generator``'s state and ``step_generator``'s
        (the program's generators take them over; None leaves the step
        generator as it is): the permutation drawn into its buffer, then
        ``pipeline.num_batches`` steps, each ``replay()`` (a graph of
        :meth:`step`) or :meth:`step` itself; both generators are left
        where the epoch's draws end, as the eager loop leaves them.
        Returns the mean step loss, the eager loop's bits."""
        p = self.pipeline
        self.generator.set_state(generator.get_state())
        if step_generator is not None:
            self.step_generator.set_state(step_generator.get_state())
        self.perm.copy_(torch.randperm(len(self.perm),
                                       generator=self.generator,
                                       device=p.device))
        self.index.zero_()
        self.total.zero_()
        for _ in range(p.num_batches):
            (replay or self.step)()
        generator.set_state(self.generator.get_state())
        if step_generator is not None:
            step_generator.set_state(self.step_generator.get_state())
        return float(self.total / p.num_batches)


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
