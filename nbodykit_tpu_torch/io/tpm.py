"""TPMBinaryFile: Martin White's TPM snapshot format.

A copy of ``nbodykit_tpu/io/tpm.py`` (numpy only): the port keeps its
own, so it imports nothing of the JAX package.

Reference: ``nbodykit/io/tpm.py:3`` — a 28-byte header followed by
column-appended Position (3 floats), Velocity (3 floats) and ID (u8).
"""

from .binary import BinaryFile


class TPMBinaryFile(BinaryFile):
    """TPM snapshot reader (precision 'f4' or 'f8')."""

    def __init__(self, path, precision='f4'):
        if precision not in ('f4', 'f8'):
            raise ValueError("precision must be 'f4' or 'f8'")
        dtype = [('Position', (precision, 3)),
                 ('Velocity', (precision, 3)),
                 ('ID', 'u8')]
        BinaryFile.__init__(self, path, dtype=dtype, header_size=28)
