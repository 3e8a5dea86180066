"""Row-wise lazy Adam for embedding tables, and optax's Adagrad: the port of
``skrx.ops.optim`` (plus the ``optax.adagrad`` step that CML trains with).

Lazy Adam updates only the rows a batch touches, with
``torch.optim.SparseAdam``-like semantics but JAX's state: a step count per
row (``counts``, int32) for the bias correction, and the moments of
untouched rows frozen. Every gathered row counts as touched, the padded rows
of weight 0 included. Duplicate rows of a batch are summed first
(:func:`dedup_rows`): the rows are sorted (stable) and each run of equal
rows summed by one segment reduction (``torch.segment_reduce``), which adds
a segment's rows in an order the rows fix. Nothing adds through atomics (as
``index_add_`` does on a card), so two runs from one seed give bit-equal
tables, and no step waits on the host. The tables are updated in place as
the tensors themselves (never through ``.data``), so their version counters
move and caches keyed on them (serving's packed table) see the step. The
loss is taken over gathered rows (leaf tensors), so no (N, d) gradient or
moment update is ever formed. Plain PyTorch: no kernel until the card shows
a need.

Beside them, optax's pieces that BERT4Rec and SRGNN train with, written
out because torch's differ: ``clip_by_global_norm`` (torch's
``clip_grad_norm_`` adds 1e-6 to the norm and always rescales), the
warm-up and linear decay schedule indexed by update count (the first
update has lr 0; ``LambdaLR`` steps after the update), ``OptaxAdamW``
(``optax.adamw``: Adam, then the decayed weights of the masked leaves,
then the schedule) and the staircase exponential decay.
"""
import math
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import torch

__all__ = ["LazyAdamState", "lazy_adam_init", "dedup_rows",
           "lazy_adam_row_update", "LazyAdam", "make_lazy_train_step",
           "OptaxAdagrad", "clip_by_global_norm_", "warmup_linear_decay",
           "staircase_exponential_decay", "OptaxAdamW"]


class LazyAdamState(NamedTuple):
    m: torch.Tensor        # (N, D) or (N,) first moment
    v: torch.Tensor        # second moment
    counts: torch.Tensor   # (N,) int32 steps taken by each row


def lazy_adam_init(table: torch.Tensor) -> LazyAdamState:
    return LazyAdamState(torch.zeros_like(table), torch.zeros_like(table),
                         torch.zeros(table.shape[0], dtype=torch.int32,
                                     device=table.device))


def dedup_rows(rows: torch.Tensor, grads: torch.Tensor, drop_id: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum the gradients of duplicate row ids, as JAX's ``dedup_rows``.

    rows: (K,) ints (entries equal to ``drop_id`` are ignored downstream);
    grads: (K, D) or (K,). Returns ``(unique (K,) int64, summed)``: the
    distinct rows ascending with each one's summed gradient in the first
    slots, ``drop_id`` and zeros in the slots after the last."""
    k = rows.shape[0]
    rows_s, order = torch.sort(rows.long(), stable=True)
    is_first = torch.ones(k, dtype=torch.bool, device=rows.device)
    is_first[1:] = rows_s[1:] != rows_s[:-1]
    seg = torch.cumsum(is_first, 0) - 1                  # (K,) in [0, K)
    # K segments, the ones after the last distinct row empty (sum 0); the
    # lengths add up to K by construction, so no check (a host sync) runs
    lengths = torch.zeros(k, dtype=torch.int64, device=rows.device)
    lengths.scatter_add_(0, seg, torch.ones_like(seg))
    summed = torch.segment_reduce(grads[order], "sum", lengths=lengths,
                                  unsafe=True)
    # every write to a slot carries the same row id
    unique = torch.full((k,), drop_id, dtype=torch.int64, device=rows.device)
    unique.scatter_(0, seg, rows_s)
    return unique, summed


def lazy_adam_row_update(state: LazyAdamState, table: torch.Tensor,
                         rows: torch.Tensor, grads: torch.Tensor, lr: float,
                         b1: float = 0.9, b2: float = 0.999,
                         eps: float = 1e-8, weight_decay: float = 0.0
                         ) -> Tuple[LazyAdamState, torch.Tensor]:
    """One Adam step on the given rows of ``table`` only, in place.

    rows: (K,) ints, which may repeat or equal ``table.shape[0]`` (dropped);
    grads: (K, D) matching the table's trailing dims, or (K,) for a 1-D
    table. ``weight_decay`` adds ``wd * row`` to the summed gradient of each
    touched row (untouched rows do not decay). The bias correction
    ``1 - b ** t`` is taken in f32 from the row's int32 count. Returns the
    (updated) state and table."""
    drop = table.shape[0]
    rows_u, g = dedup_rows(rows, grads, drop)
    valid = rows_u < drop
    safe = torch.clamp(rows_u, max=drop - 1)
    # slots after the distinct rows write slot 0's values to slot 0's row
    # (or, when every row is dropped, row N-1's own values back): every
    # write to a row carries the same bits
    src = torch.where(valid, torch.arange(len(rows_u), device=rows_u.device),
                      0)
    with torch.no_grad():
        t_rows = table[safe]
        if weight_decay:
            g = g + weight_decay * t_rows
        m_rows, v_rows = state.m[safe], state.v[safe]
        t = state.counts[safe] + 1
        m_new = b1 * m_rows + (1 - b1) * g
        v_new = b2 * v_rows + (1 - b2) * torch.square(g)
        t_f = t.to(table.dtype)
        c1, c2 = 1 - b1 ** t_f, 1 - b2 ** t_f
        if g.dim() == 2:
            c1, c2 = c1[:, None], c2[:, None]
        delta = -lr * (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
        keep = valid[:, None] if g.dim() == 2 else valid
        new_rows = torch.where(keep, t_rows + delta, t_rows)
        m_new = torch.where(keep, m_new, m_rows)
        v_new = torch.where(keep, v_new, v_rows)
        t = torch.where(valid, t, state.counts[safe])
        idx = safe[src]
        table.index_copy_(0, idx, new_rows[src])
        state.m.index_copy_(0, idx, m_new[src])
        state.v.index_copy_(0, idx, v_new[src])
        state.counts.index_copy_(0, idx, t[src])
    return state, table


class LazyAdam:
    """Row-wise lazy Adam over named tables: ``update(name, rows, grads)``
    applies :func:`lazy_adam_row_update`. It has no dense step: ``step()``
    raises, so a path that reaches for one fails instead of updating every
    row."""

    def __init__(self, tables: Dict[str, torch.Tensor], lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        self.tables = dict(tables)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay = weight_decay
        self.states = {name: lazy_adam_init(t.detach())
                       for name, t in self.tables.items()}

    def update(self, name: str, rows: torch.Tensor,
               grads: torch.Tensor) -> None:
        lazy_adam_row_update(self.states[name], self.tables[name], rows,
                             grads, self.lr, self.b1, self.b2, self.eps,
                             self.weight_decay)

    def step(self, *args, **kwargs):
        raise TypeError("lazy Adam updates the rows a batch gathers "
                        "(LazyAdam.update); it has no dense step")

    def state_dict(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {name: s._asdict() for name, s in self.states.items()}

    def load_state_dict(self, state: Dict[str, Dict[str, torch.Tensor]]
                        ) -> None:
        """Copy each table's (m, v, counts) into the live state, in place
        (shapes and dtypes must match)."""
        if set(state) != set(self.states):
            raise ValueError(f"expected states of {sorted(self.states)}, got "
                             f"{sorted(state)}")
        for name, live in self.states.items():
            for field in LazyAdamState._fields:
                value, target = state[name][field], getattr(live, field)
                if target.shape != value.shape or target.dtype != value.dtype:
                    raise ValueError(f"{name}.{field}: {value.dtype} "
                                     f"{tuple(value.shape)}, expected "
                                     f"{target.dtype} {tuple(target.shape)}")
                target.copy_(value)


def make_lazy_train_step(lr: float,
                         gathers: Sequence[Tuple[str, Callable]],
                         loss_fn: Callable,
                         params: Dict[str, torch.Tensor],
                         weight_decay: float = 0.0,
                         sync: Optional[Callable[[], None]] = None):
    """A train step with row-wise lazy Adam on embedding tables and dense
    Adam (L2 ``weight_decay`` on the gradient, ``adam_l2``) on the rest.

    gathers: ``(table_key, rows_fn)`` pairs; ``rows_fn(batch)`` gives the
    (K,) rows gathered from ``params[table_key]``. A table may appear more
    than once; its row sets are concatenated into one update, so
    overlapping rows sum as dense Adam would. ``loss_fn(gathered, dense,
    batch)`` gets the gathered row blocks (leaf tensors) in ``gathers``
    order and a dict of the other parameters.

    Returns ``(train_step, (lazy, dense_opt))``: ``train_step(batch) ->
    loss`` updates ``params`` in place; ``lazy`` is the :class:`LazyAdam`
    of the tables, ``dense_opt`` the ``torch.optim.Adam`` of the rest (None
    when there is none).

    Inside a data-parallel block (:func:`~skrx_torch.parallel.
    data_parallel`, a rank's slice of each batch) each gather's rows and
    row gradients are all-gathered over the data axis, in data-index order,
    so every rank applies the whole batch's row update to its replicated
    tables, as one device would; ``sync`` (the model's ``sync_gradients``)
    sums the dense parameters' gradients before their step."""
    from ..models.common import make_optimizer
    from ..parallel.batch import gather_batch_ids

    table_keys: List[str] = []
    for key, _ in gathers:
        if key not in table_keys:
            table_keys.append(key)
    dense_keys = [k for k in params if k not in table_keys]
    lazy = make_optimizer("lazy_adam", {k: params[k] for k in table_keys},
                          lr, weight_decay)
    dense_opt = (make_optimizer("adam", {k: params[k] for k in dense_keys},
                                lr, weight_decay)
                 if dense_keys else None)

    def train_step(batch):
        rows = [rows_fn(batch) for _, rows_fn in gathers]
        gathered = [params[k].detach()[r].requires_grad_(True)
                    for (k, _), r in zip(gathers, rows)]
        dense = {k: params[k] for k in dense_keys}
        if dense_opt is not None:
            dense_opt.zero_grad(set_to_none=True)
        loss = loss_fn(gathered, dense, batch)
        loss.backward()
        by_table: Dict[str, list] = {}
        for (k, _), r, leaf in zip(gathers, rows, gathered):
            by_table.setdefault(k, []).append(
                (gather_batch_ids(r), gather_batch_ids(leaf.grad)))
        for k, items in by_table.items():
            lazy.update(k, torch.cat([r for r, _ in items]),
                        torch.cat([g for _, g in items]))
        if dense_opt is not None:
            if sync is not None:
                sync()
            dense_opt.step()
        return loss.detach()

    return train_step, (lazy, dense_opt)


class OptaxAdagrad(torch.optim.Optimizer):
    """``optax.adagrad(lr)``: the accumulator starts at
    ``initial_accumulator_value`` (0.1) and each step adds ``g**2`` to it,
    then ``p -= lr * g * rsqrt(acc + eps)`` (eps 1e-7 inside the root; a
    zero accumulator gives a zero update). ``torch.optim.Adagrad`` starts
    at 0 and divides by ``sqrt(acc) + eps``: another update."""

    def __init__(self, params, lr: float,
                 initial_accumulator_value: float = 0.1, eps: float = 1e-7):
        if lr <= 0 or initial_accumulator_value < 0 or eps < 0:
            raise ValueError(f"invalid Adagrad settings: lr={lr}, "
                             f"initial_accumulator_value="
                             f"{initial_accumulator_value}, eps={eps}")
        super().__init__(params, dict(
            lr=lr, initial_accumulator_value=initial_accumulator_value,
            eps=eps))
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p]["sum_of_squares"] = torch.full_like(
                    p, group["initial_accumulator_value"],
                    memory_format=torch.preserve_format)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("OptaxAdagrad takes no closure")
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                acc = self.state[p]["sum_of_squares"]
                acc.add_(g * g)
                inv = torch.where(acc > 0, torch.rsqrt(acc + group["eps"]),
                                  torch.zeros_like(acc))
                p.add_(-group["lr"] * (inv * g))
        return None


@torch.no_grad()
def clip_by_global_norm_(grads: Sequence[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm``, in place: the gradients are left as
    they are when their global norm is below ``max_norm``, else scaled by
    ``max_norm / norm``. Returns the norm (a device scalar; nothing waits
    on the host)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, torch.where(norm < max_norm,
                                           torch.ones_like(norm),
                                           max_norm / norm))
    return norm


def warmup_linear_decay(lr: float, warmup: int, total: int
                        ) -> Callable[[int], float]:
    """optax's ``join_schedules([linear_schedule(0, lr, warmup),
    linear_schedule(lr, 0, max(total - warmup, 1))], [warmup])``: the lr
    of the update after ``count`` updates (count 0: lr 0)."""
    decay = max(total - warmup, 1)

    def schedule(count: int) -> float:
        if count < warmup:
            return lr * count / warmup
        return lr - lr * min(count - warmup, decay) / decay
    return schedule


def staircase_exponential_decay(lr: float, steps: int, rate: float
                                ) -> Callable[[int], float]:
    """``optax.exponential_decay(lr, steps, rate, staircase=True)``: the
    lr of the update after ``count`` updates."""
    if steps <= 0 or rate == 0:
        return lambda count: lr
    return lambda count: lr * rate ** math.floor(count / steps)


class OptaxAdamW(torch.optim.Optimizer):
    """``optax.chain(clip_by_global_norm(max_norm), optax.adamw(schedule,
    b1, b2, eps, weight_decay, mask))``: the gradients clipped by their
    global norm over every parameter, then per parameter ``m / c1 /
    (sqrt(v / c2) + eps)``, plus ``weight_decay * p`` on the parameters of
    groups with ``decay`` True, times ``-schedule(count)``, where
    ``count`` is the number of updates before this one (the first takes
    ``schedule(0)``). ``torch.optim.AdamW`` decays before the moments'
    step and scales the decay by lr alone; this is optax's order.
    ``max_norm`` None skips the clip."""

    def __init__(self, groups, schedule: Callable[[int], float],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
                 weight_decay: float = 0.0, max_norm=None):
        super().__init__(groups, dict(decay=True))
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.max_norm = weight_decay, max_norm
        self.count = 0
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p]["exp_avg"] = torch.zeros_like(p)
                self.state[p]["exp_avg_sq"] = torch.zeros_like(p)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("OptaxAdamW takes no closure")
        params = [p for g in self.param_groups for p in g["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.max_norm is not None:
            clip_by_global_norm_([p.grad for p in params], self.max_norm)
        t = self.count + 1
        # optax's bias corrections, 1 - b ** t in f32
        c1 = float(1 - torch.tensor(self.b1, dtype=torch.float32) ** t)
        c2 = float(1 - torch.tensor(self.b2, dtype=torch.float32) ** t)
        lr = float(self.schedule(self.count))
        for group in self.param_groups:
            ps = group["params"]
            if not ps:
                continue
            grads = [p.grad for p in ps]
            ms = [self.state[p]["exp_avg"] for p in ps]
            vs = [self.state[p]["exp_avg_sq"] for p in ps]
            torch._foreach_mul_(ms, self.b1)
            torch._foreach_add_(ms, grads, alpha=1 - self.b1)
            torch._foreach_mul_(vs, self.b2)
            torch._foreach_addcmul_(vs, grads, grads, value=1 - self.b2)
            denom = torch._foreach_div(vs, c2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            upd = torch._foreach_div(ms, c1)
            torch._foreach_div_(upd, denom)
            if group["decay"] and self.weight_decay:
                torch._foreach_add_(upd, ps, alpha=self.weight_decay)
            torch._foreach_add_(ps, upd, alpha=-lr)
        self.count = t
        return None

    def state_dict(self):
        state = super().state_dict()
        state["count"] = self.count
        return state

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        self.count = int(state_dict.pop("count"))
        super().load_state_dict(state_dict)
