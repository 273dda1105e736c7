"""Package build (re-design of the reference's setup.py).

The reference builds a CUDA extension via torch's BuildExtension
(setup.py:12-67). Here device code is XLA (no extension needed); the one
native piece is the host-side C++ point packer, built as an ordinary shared
library either lazily at import (data/native.py) or eagerly here via
``python setup.py build_native``.
"""
import subprocess
import sys
from pathlib import Path

from setuptools import Command, find_packages, setup

ROOT = Path(__file__).parent


class BuildNative(Command):
    """Compile data/csrc/pointpack.cpp -> pointpack.so with g++."""
    description = 'build the native host point packer'
    user_options = []

    def initialize_options(self):
        pass

    def finalize_options(self):
        pass

    def run(self):
        src = ROOT / 'mm_training_tpu' / 'data' / 'csrc' / 'pointpack.cpp'
        out = src.with_suffix('.so')
        cmd = ['g++', '-O3', '-shared', '-fPIC', '-std=c++17',
               str(src), '-o', str(out)]
        print(' '.join(cmd))
        subprocess.run(cmd, check=True)


setup(
    name='mm_training_tpu',
    version='0.1.0',
    description=('TPU-native multimodal BEV 3D-detection training framework '
                 '(JAX/XLA) with the capabilities of aimotive/mm_training'),
    packages=find_packages(include=['mm_training_tpu*']),
    package_data={'mm_training_tpu.data': ['csrc/*.cpp'],
                  'mm_training_tpu_torch': ['csrc/*.cu']},
    python_requires='>=3.10',
    install_requires=[
        'jax', 'flax', 'optax', 'orbax-checkpoint', 'numpy', 'scipy',
    ],
    extras_require={
        'full': ['opencv-python', 'tensorboardX', 'laspy', 'pillow'],
        'dev': ['pytest'],
    },
    cmdclass={'build_native': BuildNative},
)
