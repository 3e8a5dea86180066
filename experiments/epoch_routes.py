"""The epoch as one program, alone: phases 4 and 6 of ``chip_smoke.py``
cut to their training, and whether the train path's row sums read the
device from the host (which a CUDA graph cannot hold).

Usage, from the root of a checkout, on a machine with a card:

    python3 experiments/epoch_routes.py

Builds the kernels and the phase-3 data (Gowalla scale, seed 2021) under
``build/epoch_routes_data``. BPRMF and LightGCN at their defaults: fit()
for 2 epochs, each on the captured route with one replay a step
(``chip_smoke.traced_routes``, ``check_routes``; LightGCN's segsum
launches counted exactly, warm-up included), then ``chip_smoke.
epoch_routes``: one epoch on each route from one state, bit for bit, and
each route's seconds and busy share. Then ``ordered_row_sum``,
``ordered_gather``'s backward and a plain gather's backward (``table[ids]``,
the gathers of BPRMF's and LightGCN's losses) at those models' batch
(1,024 user rows; 2,048 item rows, d = 64 and 1-D) under
``torch.cuda.set_sync_debug_mode("error")``: a call that reads the device
from the host raises there. Last, Adam's arithmetic: a fresh BPRMF's
first ten batches through its flat step (capturable Adam), and through a
per-parameter Adam over copies of its initial tables, capturable (as
every Adam of the port on a card) and not, each table's largest gap to
the flat step's.
Prints the card's name and power limit and the seconds taken; exits 2
without CUDA (~3 min on an H100).
"""
import os
import shutil
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def sync_reads(dev: torch.device) -> dict:
    """(sum, rows) -> "no host read", or the error of the host read."""
    from skrx_torch.ops.scatter import ordered_gather, ordered_row_sum
    import chip_smoke as cs
    gen = torch.Generator(dev).manual_seed(cs.SEED)
    out = {}
    for tag, k, d, n in (("1,024 user rows, d=64", 1024, 64, cs.USERS),
                         ("2,048 item rows, d=64", 2048, 64, cs.ITEMS),
                         ("2,048 item rows, 1-D", 2048, None, cs.ITEMS)):
        shape = (k, d) if d else (k,)
        ids = torch.randint(0, n, (k,), device=dev, generator=gen)
        rows = torch.randn(shape, device=dev, generator=gen)
        table = torch.randn((n, *shape[1:]), device=dev, generator=gen,
                            requires_grad=True)
        calls = {"ordered_row_sum": lambda: ordered_row_sum(ids, rows, n),
                 "ordered_gather backward":
                     lambda: ordered_gather(table, ids).sum().backward(),
                 "table[ids] backward":
                     lambda: table[ids].sum().backward()}
        for name, fn in calls.items():
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                fn()
                out[name, tag] = "no host read"
            except RuntimeError as err:
                out[name, tag] = str(err).splitlines()[0][:160]
            finally:
                torch.cuda.set_sync_debug_mode(0)
    return out


def adam_arithmetic(m, steps: int = 10) -> dict:
    """Fresh BPRMF ``m``'s first ``steps`` batches of epoch 0 through its
    flat step, and through per-parameter Adams (capturable and not) over
    copies of its initial tables: (variant, table) -> largest gap."""
    import chip_smoke as cs
    from skrx_torch.models.BPRMF import bprmf_gathered_loss
    from skrx_torch.models.common import make_train_step
    from skrx_torch.models.pipeline import epoch_generator
    names = m._JAX_PARAMS
    init = {k: m.get_parameter(k).detach().clone() for k in names}
    gen = epoch_generator(cs.SEED + 1, 0, m.device)
    batches = [b for b, _ in zip(m.pipeline.batches(gen), range(steps))]
    for b in batches:
        m.train_step(b)
    gaps = {}
    for capturable in (True, False):
        leaf = {k: v.clone().requires_grad_(True) for k, v in init.items()}

        def loss_fn(users, pos, neg, w):
            neg = neg[:, 0]
            return bprmf_gathered_loss(
                leaf["user_emb"][users], leaf["item_emb"][pos],
                leaf["item_emb"][neg], leaf["item_bias"][pos],
                leaf["item_bias"][neg], w, m.config.reg)
        adam = torch.optim.Adam([leaf[k] for k in names], lr=m.config.lr,
                                betas=(0.9, 0.999), eps=1e-8,
                                capturable=capturable)
        step = make_train_step(adam, loss_fn)
        for b in batches:
            step(b)
        for k in names:
            gaps[f"capturable={capturable}", k] = float(
                (leaf[k].detach() - m.get_parameter(k).detach()).abs().max())
    return gaps


def main() -> int:
    if not torch.cuda.is_available():
        print("epoch_routes: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from skrx_torch import ModelRegistry, RunConfig
    from skrx_torch.io import synthetic
    from skrx_torch.ops.kernels import _build

    t0 = time.perf_counter()
    card = cs.card_line()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    _build.load("segsum")                 # builds every kernel
    root = os.path.join(ROOT, "build", "epoch_routes_data")
    shutil.rmtree(root, ignore_errors=True)
    path = synthetic.make_dataset_dir(root, num_users=cs.USERS,
                                      num_items=cs.ITEMS,
                                      num_ratings=cs.RATINGS, seed=cs.SEED)
    print(f"kernels and data ready in {time.perf_counter() - t0:.1f} s",
          flush=True)
    cwd = os.getcwd()
    os.chdir(root)                        # model construction writes log/
    reg = ModelRegistry()
    try:
        for name, kernel in (("BPRMF", None), ("LightGCN", "segsum")):
            reg.load_skrx_model(name)
            m = reg.get_model(name)[0](
                RunConfig(recommender=name, data_dir=path, seed=cs.SEED),
                {"epochs": cs.EPOCHS, "early_stop": cs.EPOCHS})
            runs = cs.traced_routes(m)
            _, launched = cs.counted(m.fit)
            warm = cs.check_routes(name, m, runs, card)
            losses = [h["loss"] for h in m.history]
            print(f"{name} fit(): losses {losses}, seconds "
                  f"{[h['train_seconds'] for h in m.history]}, launches "
                  f"{launched}", flush=True)
            if name == "LightGCN":
                layers = m.config.n_layers
                evals = sum("report" in h for h in m.history)
                expect = 2 * layers * (cs.EPOCHS * m.pipeline.num_batches
                                       + warm) + layers * evals
                cs.require(launched["segsum"] == expect,
                           f"segsum {launched['segsum']}, not {expect}")
            cs.epoch_routes(m, name, card, kernel)
            del m
        for (name, tag), result in sync_reads(torch.device("cuda", 0)
                                              ).items():
            print(f"host read check, {name} at {tag}: {result}", flush=True)
        bpr = reg.get_model("BPRMF")[0](
            RunConfig(recommender="BPRMF", data_dir=path, seed=cs.SEED), {})
        for (variant, key), gap in adam_arithmetic(bpr).items():
            print(f"BPRMF 10 steps, the flat step against a per-parameter "
                  f"Adam ({variant}): {key} largest gap {gap}  [{card}]",
                  flush=True)
    finally:
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)
    print(f"{time.perf_counter() - t0:.1f} s  [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
