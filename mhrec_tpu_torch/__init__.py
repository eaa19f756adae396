"""mhrec_tpu_torch — the PyTorch / CUDA port of mhrec_tpu for one NVIDIA H100.

The JAX package ``mhrec_tpu`` is the reference; this package imports nothing
from it. Ported so far: the serving path (``run.py --val_only True``) of the
HSTU model: config, data windows, the HSTU trunk with its multi-head prior
decoding, streamed full-corpus scoring and the evaluator, with hand-written
CUDA forward kernels for the fused STU block and the pointwise HSTU
attention (``ops/hstu_attention_cuda.py``, sources in ``csrc/``).
"""

__version__ = "0.1.0"
