from setuptools import setup, find_packages

meta = {}
with open('celldetection_tpu/__meta__.py') as f:
    exec(f.read(), meta)

setup(
    name=meta['__title__'],
    version=meta['__version__'],
    description=meta['__summary__'],
    license=meta['__license__'],
    packages=find_packages(include=('celldetection_tpu', 'celldetection_tpu.*',
                                    'celldetection_tpu_torch', 'celldetection_tpu_torch.*')),
    # the port's CUDA sources (nvcc) and host C++ (g++), compiled at first use
    package_data={'celldetection_tpu_torch': ['csrc/*.cu', 'csrc/*.cuh', 'native/*.cpp']},
    python_requires='>=3.10',
    install_requires=[
        'jax', 'flax', 'optax', 'orbax-checkpoint', 'numpy', 'opencv-python',
        'scipy', 'h5py', 'pyyaml', 'pandas', 'imageio', 'msgpack',
    ],
    extras_require={
        # torch checkpoint import/export + host-executed encoders, and the
        # PyTorch/CUDA port (celldetection_tpu_torch)
        'torch': ['torch'],
        'viz': ['matplotlib'],
    },
    entry_points={
        'console_scripts': [
            'cdt-inference-cpn=celldetection_tpu.runtime.cpn_inference:main',
            'cdt-inference-cpn-torch=celldetection_tpu_torch.runtime.cpn_inference:main',
        ]
    },
)
