"""Command line of the PyTorch/CUDA port (``skrx_torch``), with the flags of
``run_skrx.py``:

    python run_skrx_torch.py --recommender LightGCN --data_dir <dir> \
        --lr 0.001 --epochs 100 [--config run.ini] [--hyperopt True]

Every flag is ``--key value``, the value a Python literal or a string
(``true``/``false`` in any case are bools). Keys of ``RunConfig`` set the
run; every other key is a hyper-parameter of the model's config. ``--config
<ini>`` reads the same keys from an ini file first (all sections); flags
given on the command line win. The model is the port's
``skrx_torch.models.<recommender>``, or ``unarchived_models/<recommender>
.py`` (or a package of that name) under the working directory. numpy's,
``random``'s and the host generator's seeds are set from ``--seed``; the
search (``--hyperopt True``) or the one ``fit()`` runs through
``HyperOpt``, which returns the best ``MetricReport``. Logs go to
``log/<data>/<model>/`` under the working directory.

The run is on ``cuda:<gpu_id>``; without CUDA it raises. ``main(argv,
device="cpu")`` runs it on the CPU.

A mesh, ``--mesh_shape "(d,m)"``, runs as d * m ranks of one process each,
started by torchrun:

    torchrun --standalone --nproc_per_node 2 run_skrx_torch.py \
        --recommender LightGCN --data_dir <dir> --mesh_shape "(1,2)"

Each rank starts its process group (``WORLD_SIZE`` > 1) before the model
is built, on ``cuda:<LOCAL_RANK mod cards>``; ranks that share a card run
gloo. Only rank 0 writes the logs. Ranks already joined by a process group
(``skrx_torch.parallel.run_ranks``) call ``main`` as it is.
"""
import os
import random
import sys
from typing import List, Optional, Union

import numpy as np
import torch

import torch.distributed as dist

from skrx_torch import RunConfig
from skrx_torch.parallel import initialize_distributed
from skrx_torch.utils import (ModelRegistry, merge_config_with_cmd_args,
                              merge_config_with_ini, set_host_seed)
from skrx_torch.utils.hyperopt_driver import HyperOpt


def _set_random_seed(seed: int = 2020) -> None:
    np.random.seed(seed)
    random.seed(seed)
    set_host_seed(seed)


def main(argv: Optional[List[str]] = None,
         device: Optional[Union[str, torch.device]] = None):
    """Run the command line ``argv`` (``sys.argv[1:]`` when None) and
    return the best ``MetricReport``."""
    run_dict = {"recommender": "BPRMF",
                "data_dir": "",
                "file_column": "UIRT",
                "sep": "\t",
                "hyperopt": False,
                "gpu_id": 0,
                "metric": ("Precision", "Recall", "MAP", "NDCG"),
                "top_k": (10, 20, 30, 40, 50),
                "test_thread": 4,
                "test_batch_size": 64,
                "seed": 2021}
    run_keys = set(RunConfig().to_dict())
    argv = list(sys.argv[1:] if argv is None else argv)
    model_params = {}
    if "--config" in argv:
        i = argv.index("--config")
        ini_all = merge_config_with_ini({}, argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
        run_dict.update({k: v for k, v in ini_all.items() if k in run_keys})
        model_params.update({k: v for k, v in ini_all.items()
                             if k not in run_keys})
    cli = merge_config_with_cmd_args({}, argv)
    run_dict.update({k: v for k, v in cli.items() if k in run_keys})
    model_params.update({k: v for k, v in cli.items() if k not in run_keys})
    run_config = RunConfig(**run_dict)
    model_name = run_config.recommender

    registry = ModelRegistry()
    registry.load_skrx_model(model_name)
    if os.path.exists("unarchived_models"):
        registry.load_model_from_dir("unarchived_models", model_name)
    model_class, config_class = registry.get_model(model_name)

    _set_random_seed(run_config.seed)
    started = False
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 \
            and not dist.is_initialized():
        device = initialize_distributed(device=device)
        started = True
    try:
        return HyperOpt(run_config, model_class, config_class, model_params,
                        device=device).run()
    finally:
        if started:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
