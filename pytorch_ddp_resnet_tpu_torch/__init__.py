"""PyTorch / CUDA port of pytorch_ddp_resnet_tpu for NVIDIA Hopper GPUs.

Serving slice: spec-built ResNets in eval mode, int8 post-training
quantized serving on hand-written CUDA kernels (ops/cuda/), and the
Predictor entry point (algos/predict.py). Imports torch, never jax.
"""
