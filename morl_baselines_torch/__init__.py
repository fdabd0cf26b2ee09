"""morl_baselines_torch — PyTorch/CUDA port of morl_baselines_tpu.

A second package beside the JAX one, ported slice by slice and held against
it by the parity tests (``tests/test_torch_*.py``).  It imports torch, numpy
and scipy only, never JAX or the JAX package.  Entry points run on CUDA
unless the caller passes ``device="cpu"``; the one TPU kernel of the JAX
package, the Pareto non-dominated mask, is a hand-written CUDA kernel here
(``ops/pareto_kernel.py``, ``csrc/pareto_nd.cu``).
"""

__version__ = "0.1.0"
