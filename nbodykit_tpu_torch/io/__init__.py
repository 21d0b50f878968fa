"""IO layer: partitioned, column-addressable file readers and the
bigfile store (counterpart of ``nbodykit_tpu/io/``).

Every reader implements the FileType contract (``read(columns, start,
stop)`` -> structured numpy array), so the file catalogs can load any
format onto the device; multi-file datasets compose with FileStack.
"""

from .base import FileType
from .stack import FileStack
from .binary import BinaryFile
from .csv import CSVFile
from .bigfile import BigFile, BigFileWriter, ChecksumMismatch
from .hdf import HDFFile
from .fits import FITSFile
from .tpm import TPMBinaryFile
from .gadget import Gadget1File

__all__ = ['FileType', 'FileStack', 'BinaryFile', 'CSVFile', 'BigFile',
           'BigFileWriter', 'ChecksumMismatch', 'HDFFile', 'FITSFile',
           'TPMBinaryFile', 'Gadget1File']
