"""Compressed linear algebra (port of systemml_tpu/compress/).

`colgroup.py` and `block.py` are copies of the JAX package's host-side
column groups and compression planner (numpy only); `device.py` mirrors a
compressed block onto the device and runs the compressed ops there, the
compressed mmchain through kernel K6 (csrc/cla_chain.cu); `rewrite.py`
marks loop-invariant matmult inputs at compile time and compresses them
at loop entry.
"""

from systemml_tpu_torch.compress.block import (CompressedMatrixBlock,
                                               compress, is_compressed)

__all__ = ["CompressedMatrixBlock", "compress", "is_compressed"]
