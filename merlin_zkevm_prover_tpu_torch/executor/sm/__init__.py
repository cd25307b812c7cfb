"""Secondary state machines (reference src/sm/): trace fillers that expand
the Main SM's `required` action lists into per-SM committed columns.

The Arith, Binary, Memory and MemAlign fillers are host numpy, as in the
JAX package; PoseidonG fills its columns on the card (kernel S1).  The
Storage SM (``StorageExecutor``) joins them in the next slice of the port,
with the main executor: its micro-ROM is read from the reference's files."""

from .arith_executor import ArithExecutor
from .binary_executor import BinaryExecutor
from .mem_align_executor import MemAlignExecutor
from .memory_executor import MemoryExecutor
from .poseidon_g_executor import PoseidonGExecutor

__all__ = [
    "ArithExecutor",
    "BinaryExecutor",
    "MemAlignExecutor",
    "MemoryExecutor",
    "PoseidonGExecutor",
]
