"""nextgenmap_tpu_torch: the PyTorch/CUDA port of nextgenmap_tpu.

Every mapping path runs on one NVIDIA GPU (Hopper, sm_90a) with two
hand-written CUDA kernels, ``csrc/sw_score.cu`` (banded SW score) and
``csrc/gather_windows.cu`` (corridor gather); every other device step is
plain PyTorch.  ``nextgenmap_tpu`` (JAX) stays the reference: the tests hold
each module of the port against its counterpart on the same inputs.  The
port imports neither JAX nor anything of ``nextgenmap_tpu``: it keeps its own
copies of the host modules it needs (config, genome, k-mer index,
FASTA/FASTQ IO, the native host IO library), each at the path that mirrors
its original.
"""

__version__ = "0.1.0"
