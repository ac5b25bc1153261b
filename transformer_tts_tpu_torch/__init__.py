"""PyTorch/CUDA port of ``transformer_tts_tpu`` for NVIDIA Hopper.

It mirrors the JAX package's module paths and imports nothing of it, nor
JAX. Each TPU kernel on a ported path is a hand-written CUDA kernel under
``csrc/``, built with ``nvcc`` at first use (ops/cuda_build.py), beside a
plain PyTorch version that CPU tensors take.

Ported so far: FastSpeech 2 with transformer or conformer stacks
(models/fastspeech2.py), its synthesis (infer/synthesize.py,
cli/synthesize.py) and, with transformer stacks, its training
(train/trainer.py, cli/train.py); the AR Transformer-TTS
(models/transformer_tts.py): its KV-cached synthesis and teacher-forced
training through the same entry points. Kernels: the flash-attention
forward and backward, non-causal and causal, with in-kernel dropout
(ops/flash_attention.py: K1, K1-d, K2, K3), and the relative-position
forward (ops/flash_relpos.py: K4).
"""
