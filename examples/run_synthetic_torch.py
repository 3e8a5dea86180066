"""Minimal end-to-end example of the PyTorch port: generate data with
latent user-item structure, train Pop and BPRMF, compare them, serve
recommendations. The port of ``examples/run_synthetic.py``.

Run on a card: python examples/run_synthetic_torch.py
On the CPU:    python examples/run_synthetic_torch.py --device cpu
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from skrx_torch import RunConfig
from skrx_torch.io import synthetic
from skrx_torch.models.BPRMF import BPRMF
from skrx_torch.models.Pop import Pop
from skrx_torch.serve import TopKRecommender


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device the models run on")
    ap.add_argument("--epochs", type=int, default=40)
    args = ap.parse_args(argv)

    work = tempfile.mkdtemp(prefix="skrx_torch_example_")
    os.chdir(work)                       # the models write log/ here
    data_dir = synthetic.make_dataset_dir(work, num_users=300, num_items=500,
                                          num_ratings=10000, seed=42,
                                          latent_dim=6, latent_strength=8.0)

    def run_cfg(name):
        return RunConfig(recommender=name, data_dir=data_dir,
                         file_column="UIRT", sep="\t",
                         metric=("Recall", "NDCG"), top_k=(10, 20),
                         test_batch_size=128, seed=2021)

    pop = Pop(run_cfg("Pop"), {}, device=args.device)
    pop_best = pop.fit()

    bprmf = BPRMF(run_cfg("BPRMF"),
                  dict(lr=0.01, reg=0.01, n_dim=32, batch_size=512,
                       epochs=args.epochs, early_stop=15),
                  device=args.device)
    mf_best = bprmf.fit()

    print(f"\nPop    NDCG@10 = {pop_best['NDCG@10']:.4f}")
    print(f"BPRMF  NDCG@10 = {mf_best['NDCG@10']:.4f}")

    server = TopKRecommender(bprmf, k=5)
    ids, scores = server.recommend([0, 1, 2])
    for u, row in zip([0, 1, 2], ids):
        print(f"user {u}: top-5 recommendations {row.tolist()}")
    return {"Pop": pop_best, "BPRMF": mf_best, "ids": ids, "scores": scores}


if __name__ == "__main__":
    main()
