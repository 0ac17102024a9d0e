"""spaln_tpu_torch — spaln_tpu ported to PyTorch, with its device DP as
hand-written CUDA kernels for NVIDIA Hopper (H100).

The module tree mirrors spaln_tpu, so the counterpart of every module is
found at the same path.  Host modules that are pure numpy are carried
over unchanged; the banded spliced DP of every geometry bucket runs as
three CUDA kernels (ops/dp_spliced_cuda.py, csrc/spliced_dp.cu) when the
device is ``cuda``, and as their plain PyTorch versions on the CPU.

Package layout:
  seq/      sequence codec, FASTA IO, formatted genome store
  score/    substitution matrices, splice PSSMs, intron-length model
  ops/      DP parameters, scalar oracle, batch layer, CUDA kernels
  seed/     k-mer machinery, Wilber-Lipman HSP chains, block index
  align/    batched cDNA driver, genome mapper, gene structures
  out/      GFF3/exon/intron/... writers
  csrc/     CUDA C++ sources of the kernels
"""

__version__ = "0.1.0"
