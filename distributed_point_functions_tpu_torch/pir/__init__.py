"""Two-server PIR on the port's kernels: dense, and sparse over a
cuckoo-hashed database of string keys."""

from .client import DenseDpfPirClient
from .cuckoo_database import CuckooHashedDpfPirDatabase, CuckooHashingParams
from .database import DenseDpfPirDatabase
from .server import DenseDpfPirServer, DpfPirServer
from .sparse_client import CuckooHashingSparseDpfPirClient, KeyNotFound
from .sparse_server import CuckooHashingSparseDpfPirServer

__all__ = [
    "CuckooHashedDpfPirDatabase",
    "CuckooHashingParams",
    "CuckooHashingSparseDpfPirClient",
    "CuckooHashingSparseDpfPirServer",
    "DenseDpfPirClient",
    "DenseDpfPirDatabase",
    "DenseDpfPirServer",
    "DpfPirServer",
    "KeyNotFound",
]
