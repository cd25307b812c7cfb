"""merlin-zkevm-prover, PyTorch/CUDA port (NVIDIA Hopper).

The second package beside ``merlin_zkevm_prover_tpu`` (JAX/Pallas), which is
the reference and is never imported from here.  Module paths mirror the
reference's (``ops/``, ``stark/``, ``models/``, ``utils/``), so the
counterpart of a module is found by its path.  Plain tensor code is
PyTorch; every kernel the reference wrote in Pallas is a CUDA C++ kernel
under ``csrc/``, built at first use into ``build/`` and bound with ctypes.

Field elements are one ``torch.int64`` word each, read as unsigned.  Entry
points run on the GPU unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
