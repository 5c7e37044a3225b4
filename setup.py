"""tgt_tpu — TPU-native Triplet Graph Transformer framework."""
import os

from setuptools import find_packages, setup
from setuptools.command.build_py import build_py


class BuildWithNative(build_py):
    """Build the C++ data-prep library alongside the package (best effort —
    the ctypes loader also auto-builds on first import)."""

    def run(self):
        try:
            import subprocess
            here = os.path.dirname(os.path.abspath(__file__))
            subprocess.run(["bash", os.path.join(here, "csrc", "build.sh")],
                           check=False, timeout=180)
        except Exception:
            pass
        super().run()


setup(
    name="tgt_tpu",
    version="0.1.0",
    description=("TPU-native graph-transformer framework: EGT/TGT models, "
                 "triplet interaction, Pallas kernels, pjit distribution; "
                 "tgt_torch, its PyTorch/CUDA port for Hopper"),
    packages=find_packages(include=["tgt_tpu", "tgt_tpu.*",
                                    "tgt_torch", "tgt_torch.*"]),
    package_data={"tgt_tpu.data": ["libtgt_native.so"],
                  "tgt_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "pyyaml"],
    extras_require={
        "data": ["pyarrow", "scikit-learn"],
        "prep": ["ogb", "rdkit"],
        "test": ["pytest", "torch", "scipy"],
    },
    entry_points={
        "console_scripts": [
            "tgt-train=tgt_tpu.cli.execute:_train_main",
            "tgt-predict=tgt_tpu.cli.execute:_predict_main",
            "tgt-evaluate=tgt_tpu.cli.execute:_evaluate_main",
        ],
    },
    cmdclass={"build_py": BuildWithNative},
)
