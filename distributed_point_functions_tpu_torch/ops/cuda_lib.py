"""Build, load and count the port's hand-written CUDA kernels.

The sources under `csrc/` compile with `nvcc` for `sm_90a` into one shared
library with a plain C interface, loaded with `ctypes` (no PyTorch
headers, so a build takes seconds). The build happens at first use, from
the sources in the checkout only, into
`distributed_point_functions_tpu_torch/build/<hash>/`, keyed on a hash
of the sources and flags: a fresh checkout builds once, and an edited
source builds anew. Each `.cu` compiles in its own `nvcc` process, all
started together; `-Xptxas -v` reports registers and spills per kernel
into `<source>.log` beside the objects (`ptxas_report`). A build runs in
a private directory that is renamed into place when it is whole, so
processes that build the same sources at once never share a file.

`LAUNCHES` counts kernel launches per wrapper. Each wrapper calls
`count(name)` where it launches its kernel and nowhere else, so a run can
show that the main path went through the kernels (`chip_smoke.py`).
`count` and `reset_launch_counts` take one lock: the serving runtime
launches from several batch workers at once, and an unlocked `+=` on a
dict entry can lose a count between its read and its write. A thread
inside `counting_into(counts)` also adds its launches to `counts`: a
serving session counts its own batch worker's launches so, apart from
another session's in the same process.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "build"

SOURCES = ("expand_planes.cu", "expand_fused.cu", "inner_product.cu",
           "path_level.cu", "repeat_tiles.cu", "leaf_blocks.cu")
LIB_NAME = "libdpf_kernels.so"
HEADERS = ("aes_generated.cuh", "expand_body.cuh", "split_aes.cuh")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + (
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES = {
    "expand_level": 0, "value_hash": 0, "xor_inner_product": 0,
    "walk_descend": 0, "expand_head": 0, "expand_tail": 0, "path_level": 0,
    "xor_counts": 0, "repeat_tiles": 0, "leaf_blocks": 0,
}

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_SIGNATURES = {
    "dpf_expand_level": [_P] * 7 + [_I64, _I64, _P],
    "dpf_value_hash": [_P] * 4 + [_I64, _I64, _P],
    "dpf_xor_inner_product": [_P] * 3 + [_I64] * 4 + [ctypes.c_int] * 2 + [_P],
    "dpf_xor_counts": [_P] * 3 + [_I64] * 3 + [ctypes.c_int, _P],
    "dpf_repeat_tiles": [_P] * 2 + [_I64] * 3 + [_P],
    "dpf_walk_descend": [_P] * 8 + [_I64] * 3 + [ctypes.c_int] * 2 + [_P],
    "dpf_expand_head": [_P] * 7 + [_I64] * 2 + [ctypes.c_int, _P],
    "dpf_expand_tail": [_P] * 8 + [_I64] * 3 + [ctypes.c_int, _P],
    "dpf_path_walk": [_P] * 7 + [ctypes.c_int] + [_P] * 2 + [_I64] * 2
                     + [ctypes.c_int, _P],
    "dpf_leaf_blocks": [_P] * 3 + [_I64] * 3 + [_P],
}

_lock = threading.Lock()
_lib = None
_count_lock = threading.Lock()
_scope = threading.local()


def count(name: str) -> None:
    """Add one launch of kernel `name` (a key of `LAUNCHES`), and to the
    calling thread's `counting_into` dict if it has one."""
    with _count_lock:
        LAUNCHES[name] += 1
        counts = getattr(_scope, "counts", None)
        if counts is not None:
            counts[name] = counts.get(name, 0) + 1


@contextlib.contextmanager
def counting_into(counts: dict):
    """Add this thread's launches to `counts` as well while open."""
    outer = getattr(_scope, "counts", None)
    _scope.counts = counts
    try:
        yield counts
    finally:
        _scope.counts = outer


def read_counts(counts: dict) -> dict:
    """A copy of a `counting_into` dict, taken under the count lock."""
    with _count_lock:
        return dict(counts)


def reset_launch_counts() -> None:
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            candidates.append(os.path.join(os.environ[env], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels build from csrc/ at first use"
    )


def build_dir() -> Path:
    """`build/<hash of sources, headers and flags>`."""
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile every source in parallel, link one library; returns its
    path (an existing build of the same hash is reused)."""
    out = build_dir()
    lib_path = out / LIB_NAME
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix=f".{out.name}-", dir=BUILD_ROOT))
    try:
        jobs = []
        for src in SOURCES:
            obj = work / f"{src}.o"
            log = open(work / f"{src}.log", "w")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(CSRC / src),
                   "-o", str(obj)]
            jobs.append((src, obj, log, subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT)))
        failed = []
        for src, _, log, proc in jobs:
            rc = proc.wait()
            log.close()
            if rc != 0:
                failed.append(src)
        if failed:
            logs = "\n".join(
                (work / f"{src}.log").read_text()[-4000:] for src in failed
            )
            raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
        subprocess.run(
            [nvcc, "-shared", *ARCH, *[str(o) for _, o, _, _ in jobs],
             "-o", str(work / LIB_NAME)],
            check=True, capture_output=True,
        )
        try:
            os.rename(work, out)
        except OSError:
            # Another process put the same build in place first.
            if not lib_path.exists():
                raise
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib_path


def ptxas_report() -> str:
    """The `-Xptxas -v` lines (registers, spills) of the current build."""
    lines = []
    for src in SOURCES:
        log = build_dir() / f"{src}.log"
        if log.exists():
            lines += [
                f"{src}: {ln.strip()}"
                for ln in log.read_text().splitlines()
                if "ptxas info" in ln or "bytes stack frame" in ln
            ]
    return "\n".join(lines)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, kernel: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {kernel} failed: error {err}")
