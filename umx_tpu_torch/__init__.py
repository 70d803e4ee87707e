"""umx-tpu-torch: the PyTorch/CUDA port of umx-tpu for one NVIDIA H100.

Runs the CLI demix path (ggml weights → STFT → Open-Unmix mask network
→ Wiener-EM → iSTFT → overlap-add) with the BLSTM recurrence and the
two Wiener-EM passes as hand-written CUDA kernels (``csrc/``), built
with nvcc at first use (``_build.py``).  Every kernel has a plain
PyTorch version beside it that runs for CPU tensors.

The package imports torch, numpy and scipy only; it never imports jax
or ``umx_tpu``, which stays in the repository as its numerical
reference.  Importing it builds no kernel and does not initialise CUDA.

It exports the names ``umx_tpu`` exports, with the same meaning.  The JAX
package's ``UMX_TPU_PLATFORM`` override is JAX's own (it picks the JAX
backend) and has no counterpart: here every entry point takes a
``device=`` (``--device`` on the command lines), the GPU unless the CPU
is asked for.
"""

__version__ = "0.1.0"

from umx_tpu_torch.config import (  # noqa: F401
    TARGETS,
    DSPConfig,
    EngineConfig,
    ModelConfig,
    SegmentConfig,
    WienerConfig,
)
from umx_tpu_torch.engine.separator import Separator, segment_forward  # noqa: F401
from umx_tpu_torch.models.umx import (  # noqa: F401
    LSTMState,
    UMXParams,
    init_lstm_state,
    params_from_ggml,
    synthetic_params,
    umx_forward,
    umx_post,
    umx_pre,
    umx_recurrence,
)

__all__ = [
    "TARGETS", "DSPConfig", "EngineConfig", "ModelConfig", "SegmentConfig", "WienerConfig",
    "Separator", "segment_forward", "LSTMState", "UMXParams", "init_lstm_state",
    "params_from_ggml", "synthetic_params", "umx_forward", "umx_post", "umx_pre",
    "umx_recurrence",
]
