"""ctypes bindings to the port's native C++ host library (`csrc/host/`).

The host side of the main path runs here: the client's batched dense-PIR
key generation (`keygen_batch_dense`), the server's walk of the shared
all-zeros prefix while it stages a key batch (`evaluate_seeds`), and the
sparse database's cuckoo table build (`cuckoo_build`, SHA256 hashing on
all cores). The sources are the port's own copy of the JAX package's
native oracle: AES-128 (AES-NI when the CPU has it, a bytewise body
otherwise), the MMO hash, batched seed walks, keygen and the cuckoo build.

The library builds at first use with `g++ -O2 -fPIC` (only `aesni.cc`
with `-maes`), one compiler per source, all started together, into
`distributed_point_functions_tpu_torch/build/<hash>/`, keyed on a hash of
the sources and flags, in a private directory renamed into place when
whole (as `ops/cuda_lib.py` builds the CUDA library). A failed build or
load raises: there is no numpy fallback behind it. The numpy versions
(`dpf.DistributedPointFunction._generate_keys_batch_plain`,
`pir.dense_eval._walk_zeros_host_plain`) are the plain versions the tests
hold this library against.
"""

from __future__ import annotations

import ctypes
import hashlib
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from . import keys as fixed_keys

_PKG = Path(__file__).resolve().parent
HOST_SRC = _PKG / "csrc" / "host"
BUILD_ROOT = _PKG / "build"

SOURCES = ("aes128.cc", "aesni.cc", "dpf_kernels.cc", "keygen.cc", "cuckoo_build.cc")
HEADERS = ("aes128.h", "sha256.h")
LIB_NAME = "libdpf_native.so"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-pthread")
# The one unit built with AES-NI; the library checks the CPU at run time
# (`AesNiSupported`), so it loads on machines without it.
AESNI_SOURCES = ("aesni.cc",)

_lib: Optional[ctypes.CDLL] = None
_keys_ctx = None
# Serializes the build and load: two threads racing `get_lib()` on a cold
# checkout must not load a half-written library.
_lib_lock = threading.Lock()


def _cxx() -> str:
    for name in ("g++", "c++"):
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError("g++ not found: the port's host library builds from "
                       "csrc/host/ at first use")


def build_dir() -> Path:
    """`build/<hash of sources, headers and flags>`."""
    h = hashlib.sha256(b"host")
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((HOST_SRC / name).read_bytes())
    h.update(" ".join(CXX_FLAGS + AESNI_SOURCES).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile every source in parallel and link the library; returns its
    path (an existing build of the same hash is reused)."""
    out = build_dir()
    lib_path = out / LIB_NAME
    if lib_path.exists():
        return lib_path
    cxx = _cxx()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix=f".{out.name}-", dir=BUILD_ROOT))
    try:
        jobs = []
        for src in SOURCES:
            flags = CXX_FLAGS + (("-maes",) if src in AESNI_SOURCES else ())
            obj = work / f"{src}.o"
            jobs.append((src, obj, subprocess.Popen(
                [cxx, *flags, "-c", str(HOST_SRC / src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, _, proc in jobs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src}:\n{log[-4000:]}")
        if failed:
            raise RuntimeError("g++ failed for the host library:\n" + "\n".join(failed))
        subprocess.run(
            [cxx, "-shared", "-pthread", *[str(o) for _, o, _ in jobs],
             "-o", str(work / LIB_NAME)],
            check=True, capture_output=True,
        )
        try:
            work.rename(out)
        except OSError:
            # Another process put the same build in place first.
            if not lib_path.exists():
                raise
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib_path


_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    "dpf_create_keys": ([ctypes.c_char_p] * 3, ctypes.c_void_p),
    "dpf_mmo_hash": ([_P, ctypes.c_int, _P, _P, _I64], None),
    "dpf_evaluate_seeds": ([_P] * 7 + [_I64, ctypes.c_int, _I64, ctypes.c_int], None),
    "dpf_keygen_batch_dense": ([ctypes.c_char_p] * 3 + [_P] * 3
                               + [ctypes.c_int, _I64] + [_P] * 3, None),
    "dpf_cuckoo_hash_buckets": ([_P, _P, _I64, _P, _P, ctypes.c_int, _I64, _P],
                                ctypes.c_int),
    "dpf_cuckoo_build": ([_P, _P, _I64, _P, _P, ctypes.c_int, _I64, _I64,
                          ctypes.c_uint64, _P], ctypes.c_int),
}


def get_lib() -> ctypes.CDLL:
    """The loaded host library, built at first use. Thread-safe."""
    global _lib, _keys_ctx
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _keys_ctx = ctypes.c_void_p(lib.dpf_create_keys(
                bytes(fixed_keys.PRG_KEY_LEFT), bytes(fixed_keys.PRG_KEY_RIGHT),
                bytes(fixed_keys.PRG_KEY_VALUE)))
            _lib = lib
        return _lib


def _u8(arr) -> np.ndarray:
    return np.ascontiguousarray(arr, dtype=np.uint8)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def mmo_hash_bytes(which: int, data: bytes) -> bytes:
    """MMO hash of the 16-byte blocks of `data`; which: 0 = left, 1 =
    right, 2 = value. Bytes in and out, no numpy: the cost of key
    generation's few-block hashes is the call itself."""
    lib = get_lib()
    out = ctypes.create_string_buffer(len(data))
    lib.dpf_mmo_hash(_keys_ctx, which, data, out, len(data) // 16)
    return out.raw


def mmo_hash(which: int, blocks: np.ndarray) -> np.ndarray:
    """`mmo_hash_bytes` of uint8[n, 16] blocks."""
    out = mmo_hash_bytes(which, _u8(blocks).reshape(-1, 16).tobytes())
    return np.frombuffer(out, dtype=np.uint8).reshape(-1, 16).copy()


def evaluate_seeds(seeds: np.ndarray, control: np.ndarray, paths: np.ndarray,
                   cw_seeds: np.ndarray, cw_left: np.ndarray,
                   cw_right: np.ndarray, per_seed_cw: bool,
                   paths_rightshift: int = 0):
    """Walk a batch of seeds down their paths; returns the new (seeds,
    control), the inputs untouched.

    seeds/paths: uint8[n, 16]; control: uint8[n]; cw_seeds: uint8[L, m, 16]
    with m == 1 (shared corrections) or m == n (per seed); cw_left/right:
    uint8[L, m].
    """
    lib = get_lib()
    seeds = _u8(seeds).reshape(-1, 16).copy()
    n = seeds.shape[0]
    control = _u8(control).copy()
    paths = _u8(paths).reshape(-1, 16)
    cw_seeds = _u8(cw_seeds)
    num_levels = cw_seeds.shape[0] if cw_seeds.ndim == 3 else 0
    m = n if per_seed_cw else 1
    cw_seeds_flat = cw_seeds.reshape(-1, 16)
    cw_left = _u8(cw_left).reshape(-1)
    cw_right = _u8(cw_right).reshape(-1)
    if control.shape != (n,) or paths.shape != (n, 16) or any(
            a.shape[0] != num_levels * m for a in (cw_seeds_flat, cw_left, cw_right)):
        raise ValueError(
            f"evaluate_seeds: {n} seeds need control [{n}], paths [{n}, 16] "
            f"and {num_levels} levels of {m} corrections")
    lib.dpf_evaluate_seeds(
        _keys_ctx, _ptr(seeds), _ptr(control), _ptr(paths),
        _ptr(cw_seeds_flat), _ptr(cw_left), _ptr(cw_right),
        n, num_levels, m, paths_rightshift,
    )
    return seeds, control


def keygen_batch_dense(root_seeds: np.ndarray, alphas: np.ndarray,
                       betas: np.ndarray, levels: int):
    """Batched dense-PIR key generation (`csrc/host/keygen.cc`).

    root_seeds: uint8[2, n, 16] party-major; alphas: uint64[n]; betas:
    uint8[n, 16]. Returns (cw_seeds uint8[levels, n, 16], cw_ctrl
    uint8[levels, n, 2] (left, right), last_vc uint8[n, 16]), equal to
    `DistributedPointFunction._generate_keys_batch_plain` on the same seeds.
    """
    lib = get_lib()
    alphas = np.ascontiguousarray(alphas, dtype=np.uint64)
    n = alphas.shape[0]
    root_seeds = _u8(root_seeds)
    betas = _u8(betas)
    if root_seeds.shape != (2, n, 16) or betas.shape != (n, 16):
        raise ValueError("root_seeds must be uint8[2, n, 16] and betas uint8[n, 16]")
    cw_seeds = np.empty((levels, n, 16), dtype=np.uint8)
    cw_ctrl = np.empty((levels, n, 2), dtype=np.uint8)
    last_vc = np.empty((n, 16), dtype=np.uint8)
    lib.dpf_keygen_batch_dense(
        bytes(fixed_keys.PRG_KEY_LEFT), bytes(fixed_keys.PRG_KEY_RIGHT),
        bytes(fixed_keys.PRG_KEY_VALUE), _ptr(root_seeds), _ptr(alphas),
        _ptr(betas), levels, n, _ptr(cw_seeds), _ptr(cw_ctrl), _ptr(last_vc),
    )
    return cw_seeds, cw_ctrl, last_vc


def _framed(items) -> tuple:
    """(uint8 concatenation, uint64[n + 1] offsets) of byte strings."""
    offsets = np.zeros(len(items) + 1, dtype=np.uint64)
    np.cumsum(np.fromiter(map(len, items), dtype=np.uint64, count=len(items)),
              out=offsets[1:])
    return np.frombuffer(b"".join(items), dtype=np.uint8), offsets


def cuckoo_hash_buckets(keys, seeds, num_buckets: int) -> np.ndarray:
    """int64[n, len(seeds)]: hash function i's bucket of key k,
    SHA256(seeds[i] || key) mod num_buckets (`hashing/sha256_hash_family.py`)."""
    lib = get_lib()
    keys_concat, key_offsets = _framed(keys)
    seeds_concat, seed_offsets = _framed(list(seeds))
    n = key_offsets.shape[0] - 1
    out = np.empty((n, len(seeds)), dtype=np.int64)
    rc = lib.dpf_cuckoo_hash_buckets(
        _ptr(keys_concat), _ptr(key_offsets), n, _ptr(seeds_concat),
        _ptr(seed_offsets), len(seeds), num_buckets, _ptr(out))
    if rc != 0:
        raise ValueError(f"dpf_cuckoo_hash_buckets rejected its arguments (rc={rc})")
    return out


def cuckoo_build(keys, seeds, num_buckets: int, max_relocations: int,
                 rng_seed: int = 0x5EED) -> np.ndarray:
    """The cuckoo table of `keys` (`csrc/host/cuckoo_build.cc`): int64[num_buckets],
    the index of the key in each bucket or -1, equal to the JAX package's
    `native.cuckoo_build` for the same arguments.

    `seeds[i]`: hash function i's whole SHA256 prefix (the family seed
    followed by the function's derivation seed, `hashing/hash_family.py`).
    Raises `RuntimeError` when a key cannot be placed within
    `max_relocations` evictions, as `CuckooHashTable.insert` with no stash
    does."""
    lib = get_lib()
    keys_concat, key_offsets = _framed(keys)
    seeds_concat, seed_offsets = _framed(list(seeds))
    out = np.empty(num_buckets, dtype=np.int64)
    rc = lib.dpf_cuckoo_build(
        _ptr(keys_concat), _ptr(key_offsets), key_offsets.shape[0] - 1,
        _ptr(seeds_concat), _ptr(seed_offsets), len(seeds), num_buckets,
        max_relocations, rng_seed, _ptr(out))
    if rc == -1:
        raise RuntimeError("cuckoo insertion failed: relocation budget exhausted")
    if rc != 0:
        raise ValueError(f"dpf_cuckoo_build rejected its arguments (rc={rc})")
    return out
