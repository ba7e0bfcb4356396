from setuptools import find_packages, setup

setup(
    name="pytorch_ddp_resnet_tpu",
    version="0.1.0",
    description="TPU-native JAX re-implementation of a DDP ResNet trainer "
                "(spec-driven ResNet/WRN on CIFAR/ImageNet, SPMD data "
                "parallelism over a device mesh).",
    packages=find_packages(exclude=["tests"]),
    # native/fastimage.cpp is compiled on demand at runtime (native/__init__)
    # with the system toolchain; ship the source so installed packages can
    # build it, and degrade to PIL when g++/libjpeg are absent.
    # the PyTorch port's CUDA kernels are compiled with nvcc at first use
    # (pytorch_ddp_resnet_tpu_torch/ops/cuda/build.py): ship the sources
    package_data={"pytorch_ddp_resnet_tpu.native": ["*.cpp"],
                  "pytorch_ddp_resnet_tpu_torch.ops.cuda": ["csrc/*.cu",
                                                            "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
        "pyyaml",
        "torch",
    ],
    extras_require={
        "data": ["filelock", "pillow"],
        "test": ["pytest", "torch", "tensorboard"],
    },
)
