"""umx-tpu-torch: the PyTorch/CUDA port of umx-tpu for one NVIDIA H100.

Runs the CLI demix path (ggml weights → STFT → Open-Unmix mask network
→ Wiener-EM → iSTFT → overlap-add) with the BLSTM recurrence and the
two Wiener-EM passes as hand-written CUDA kernels (``csrc/``), built
with nvcc at first use (``_build.py``).  Every kernel has a plain
PyTorch version beside it that runs for CPU tensors.

The package imports torch, numpy and scipy only; it never imports jax
or ``umx_tpu``, which stays in the repository as its numerical
reference.
"""

__version__ = "0.1.0"
