"""PyTorch + CUDA port of the column-wise N:M pruning system.

The JAX package ``repro`` is the reference; this package keeps its layout
(``core/``, ``kernels/<family>/{ref,kernel,ops}.py``, ``models/``) so every
module has an obvious twin.  It imports ``torch`` and numpy only, never JAX
and nothing of ``repro``.

Entry points run on the CUDA card unless the caller passes ``device="cpu"``;
kernel wrappers launch the hand-written Hopper kernels (``csrc/``) for CUDA
tensors and run their plain PyTorch versions for CPU tensors.
"""
