"""repro_torch — the AutoAnalyzer (Liu & Zhan et al., 2011: automatic
performance debugging of SPMD programs) ported to PyTorch and CUDA for an
NVIDIA H100.  The JAX package ``repro`` beside it is the reference; this
package imports nothing of it, nor JAX."""

__version__ = "0.1.0"
