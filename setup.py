"""Package build for skrx (scikit-recommender-tpu).

The reference builds Cython extensions at install time (skrec setup.py:47-148);
skrx ships pure Python — the native C++ helper library is compiled on demand
at first use (skrx/native/lib.py), and the compute path is JAX/XLA/Pallas.
"""
from setuptools import find_packages, setup

setup(
    name="scikit-recommender-tpu",
    version="0.1.0",
    description="TPU-native recommender framework (JAX/XLA/Pallas) with the "
                "capabilities of scikit-recommender",
    packages=find_packages(include=["skrx", "skrx.*",
                                    "skrx_torch", "skrx_torch.*"]),
    package_data={"skrx.native": ["csrc/*.cc"],
                  "skrx_torch.ops.kernels": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=[
        "numpy>=1.17",
        "scipy",
        "pandas",
        "jax",
        "optax",
        "orbax-checkpoint",
    ],
    extras_require={"search": ["hyperopt"]},
)
