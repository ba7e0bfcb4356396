"""PyTorch / CUDA port of pytorch_ddp_resnet_tpu for NVIDIA Hopper GPUs.

Spec-built ResNets and WRNs: int8 post-training quantized serving through
the Predictor entry point (algos/predict.py), and training through
``setup`` and the train step (algos/train.py, algos/steps.py) in bf16, on
the fused bf16 block-halves, in int8 QAT and in int8 fully quantized
training, on hand-written CUDA kernels (ops/cuda/). Imports torch, never
jax.
"""
