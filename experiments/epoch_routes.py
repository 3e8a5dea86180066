"""The epoch as one program, alone: the route checks of ``chip_smoke.py``
phases 4, 6, 11, 12 and 14 cut to their training, and whether a step, and
the train path's row sums, read the device from the host (which a CUDA
graph cannot hold).

Usage, from the root of a checkout, on a machine with a card:

    python3 experiments/epoch_routes.py [--models BPRMF,SGAT,...]

Builds the kernels and the phase-3 data (Gowalla scale, seed 2021, with
phase 14's 4,096-d image and 384-d text features) under
``build/epoch_routes_data``. Each model of MODELS (BPRMF, LightGCN, FPMC,
TransRec, SGAT, MGCN with a flat step; SelfCF, BM3, SLMRec, CDAE, MultVAE
with a per-leaf step drawing from the epoch program's step generator;
``--models`` picks some) at its defaults, and SLMRec once more under
``ssl_task="FD+FM"`` (its default FAC draws nothing): two steps of its
own under ``torch.cuda.set_sync_debug_mode("error")`` (a step that reads
the device from the host raises there; the op's frames are printed);
fit() for 2 epochs, evaluation cut to 4,096 test users, each epoch on the
captured route with one replay a step (``chip_smoke.fit_counted``: segsum
launched exactly, the capture's warm-up steps included);
``chip_smoke.check_fresh`` for the models whose serving reads cached or
frozen tables; then ``chip_smoke.epoch_routes``: one whole epoch on each
route from one state, bit for bit (both generators too), and each
route's seconds and busy share. Then ``ordered_row_sum``, ``ordered_gather``'s backward and a
plain gather's backward (``table[ids]``) at BPRMF's and LightGCN's batch
(1,024 user rows; 2,048 item rows, d = 64 and 1-D) under the same check.
Last, Adam's arithmetic: a fresh BPRMF's first ten batches through its
flat step (capturable Adam), and through a per-parameter Adam over copies
of its initial tables, capturable (as every Adam of the port on a card)
and not, each table's largest gap to the flat step's.
Prints the card's name and power limit and the seconds taken; exits 2
without CUDA (~10 min on an H100 for all six models).
"""
import argparse
import gc
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


# the models on the captured route: those whose one-device dense-Adam
# step is a flat one, then those with a per-leaf step that draws
MODELS = ("BPRMF", "LightGCN", "FPMC", "TransRec", "SGAT", "MGCN", "SelfCF",
          "BM3", "SLMRec", "CDAE", "MultVAE")
# each model's runs: (tag, config over its defaults)
RUNS = {"SLMRec": (("SLMRec", {}), ("SLMRec FD+FM", {"ssl_task": "FD+FM"}))}
# the models whose serving reads cached or frozen tables
FRESH = ("FPMC", "TransRec", "SGAT", "MGCN", "SelfCF", "BM3", "SLMRec",
         "CDAE", "MultVAE")


def segsum_counts(name: str, m) -> tuple:
    """(propagations, fixed-index sums) of model m's step, as phases 6, 11,
    12 and 14 count them: SLMRec's FD and FM tasks propagate two more
    sets of its three towers a step (not in an evaluation)."""
    cfg = m.config
    if name in ("LightGCN", "SelfCF", "BM3"):
        return cfg.n_layers, (0, 0, 0)
    if name == "SLMRec":
        props = 3 * cfg.layer_num
        return props, (0 if cfg.ssl_task == "FAC" else 4 * props, 0, 0)
    if name == "SGAT":
        return cfg.n_layers, (6 * cfg.n_layers, 0, 2 * cfg.n_layers)
    if name == "MGCN":
        return 2 * cfg.n_layers + 2 + cfg.n_ui_layers, (0, 0, 0)
    return 0, (0, 0, 0)


def step_host_reads(m) -> str:
    """Two train steps of model m on one batch under
    ``set_sync_debug_mode("error")``: "no host read", or the error and the
    frames of the port's code that made the read."""
    import traceback

    from skrx_torch.models.pipeline import epoch_generator
    import chip_smoke as cs
    batch = next(m.pipeline.batches(epoch_generator(cs.SEED, 0, m.device)))
    # the step's own draws, as an epoch's
    m._step_gen = epoch_generator(cs.SEED, 0, m.device, stream=1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            m.train_step(batch)
        return "no host read"
    except RuntimeError as err:
        frames = [f"{os.path.relpath(f.filename, ROOT)}:{f.lineno} {f.line}"
                  for f in traceback.extract_tb(err.__traceback__)
                  if "skrx_torch" in f.filename]
        return f"{str(err).splitlines()[0][:160]}; at {frames[-4:]}"
    finally:
        torch.cuda.set_sync_debug_mode(0)
        m._step_gen = None


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", default=",".join(MODELS))
    args = ap.parse_args()
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
    synthetic.write_mm_features(path, cs.ITEMS, cs.SEED, cs.IMG_DIM,
                                cs.TXT_DIM)
    print(f"kernels and data ready in {time.perf_counter() - t0:.1f} s",
          flush=True)
    cwd = os.getcwd()
    os.chdir(root)                        # model construction writes log/
    reg = ModelRegistry()
    try:
        for name in args.models.split(","):
            reg.load_skrx_model(name)
            cls = reg.get_model(name)[0]
            for tag, over in RUNS.get(name, ((name, {}),)):
                t1 = time.perf_counter()

                def build():
                    return cs.cut_eval(cls(
                        RunConfig(recommender=name, data_dir=path,
                                  seed=cs.SEED),
                        {"epochs": cs.EPOCHS, "early_stop": cs.EPOCHS,
                         **over}))
                probe = build()
                print(f"{tag} built in {time.perf_counter() - t1:.1f} s; "
                      f"its step under the sync check: "
                      f"{step_host_reads(probe)}", flush=True)
                del probe
                gc.collect()
                torch.cuda.empty_cache()
                m = build()
                props, sums = segsum_counts(name, m)
                fresh = name in FRESH
                before = cs.derived_tables(name, m) if fresh else None
                cs.fit_counted(m, m.pipeline.num_batches, props, tag, sums,
                               route="captured", card=card)
                if fresh:
                    cs.check_fresh(name, m, before)
                print(f"{tag} fit(): seconds "
                      f"{[h['train_seconds'] for h in m.history]}",
                      flush=True)
                cs.epoch_routes(m, tag, card, "segsum" if props else None)
                print(f"{tag} took {time.perf_counter() - t1:.1f} s  "
                      f"[{card}]", flush=True)
                del m
                gc.collect()
                torch.cuda.empty_cache()
        for (name, tag), result in sync_reads(torch.device("cuda", 0)
                                              ).items():
            print(f"host read check, {name} at {tag}: {result}", flush=True)
        reg.load_skrx_model("BPRMF")
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
