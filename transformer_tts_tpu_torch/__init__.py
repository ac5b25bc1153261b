"""PyTorch/CUDA port of ``transformer_tts_tpu`` for NVIDIA Hopper.

It mirrors the JAX package's module paths and imports nothing of it, nor
JAX. Each TPU kernel on a ported path is a hand-written CUDA kernel under
``csrc/``, built with ``nvcc`` at first use (ops/cuda_build.py), beside a
plain PyTorch version that CPU tensors take.

Ported so far: FastSpeech 2 synthesis with transformer stacks
(models/fastspeech2.py, infer/synthesize.py, cli/synthesize.py) and the
flash-attention forward kernel (ops/flash_attention.py).
"""
