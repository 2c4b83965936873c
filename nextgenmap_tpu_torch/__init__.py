"""nextgenmap_tpu_torch: the PyTorch/CUDA port of nextgenmap_tpu.

The single-end main path runs on one NVIDIA GPU (Hopper, sm_90a) with two
hand-written CUDA kernels, ``csrc/sw_score.cu`` (banded SW score) and
``csrc/gather_windows.cu`` (corridor gather); every other device step is
plain PyTorch.  ``nextgenmap_tpu`` (JAX) stays the reference: the tests hold
each module of the port against its counterpart on the same inputs.  The
port imports no JAX; it reuses the reference's jax-free host modules
(config, genome, k-mer index cache, FASTA/FASTQ IO, native SAM formatter).
"""

__version__ = "0.1.0"
