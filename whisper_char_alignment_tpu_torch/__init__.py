"""PyTorch/CUDA port of the Whisper word-alignment framework.

The same pipeline as ``whisper_char_alignment_tpu`` (the JAX reference, which
stays beside it): teacher-forced Whisper cross-attention capture, median filter
+ softmax + head selection, and monotonic DTW word boundaries, run on one
NVIDIA Hopper GPU. Every kernel the JAX package wrote in Pallas for the TPU is
a CUDA C++ kernel here (``csrc/``), each with a plain PyTorch version of the
same function beside its wrapper (``ops/*_cuda.py``).

The package imports ``torch`` and never ``jax``, and nothing of the JAX
package: the jax-free host modules it needs are copies. Entry points
(``api.align``, ``api.align_long``, ``api.transcribe``, ``transcribe.
transcribe`` and ``transcribe_batched``, ``runner.AlignmentPipeline``) run
on ``cuda`` unless the caller passes ``device="cpu"``; the command-line
tools (``cli/infer_ali``, ``cli/eval_ali``, ``cli/probe_oracle``,
``cli/transcribe`` with the ``utils/writers`` output formats, and the HTTP
server ``cli/serve``) take the JAX CLIs' flags and run on the CPU with
``WCA_PLATFORM=cpu``.
"""

from . import constants
from .config import AlignConfig, ModelDims, MODEL_DIMS

__version__ = "0.1.0"
