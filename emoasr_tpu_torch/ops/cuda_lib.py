"""Build and load the port's hand-written CUDA kernels.

Each source in `emoasr_tpu_torch/csrc/` is compiled by `nvcc` for Hopper
(`sm_90a`) into a shared library with a plain C interface, and loaded with
`ctypes`.  Nothing is built when a module is imported: a kernel builds at
its first launch, or when `build_all` builds every kernel at once (one
`nvcc` process per source, all started together).  The libraries go to
`build/kernels/` at the repository root, named by a hash of their source
and of the headers beside it (`csrc/*.cuh`), so an edited source or header
builds anew and an unchanged one is reused.

A failed build raises with nvcc's output; a failed launch raises with the
CUDA error string.  There is no fallback to the plain PyTorch version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List, Sequence, Tuple

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
REPO_ROOT = os.path.dirname(os.path.dirname(CSRC_DIR))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "kernels")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

# ctypes argument types of the launchers: pointers (and the stream) as
# c_void_p, ints as c_int, strides as c_int64, 32-bit unsigned words as
# c_uint32, floats as c_float
P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_int64
U = ctypes.c_uint32
F = ctypes.c_float


def aligned16(x):
    """`x` contiguous in storage that starts on a 16-byte boundary (a copy
    where it does not), for kernels that move rows as 16-byte words."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


class CudaKernel:
    """One `csrc/<source>` built into its own shared library.

    `signatures` maps each exported C function to its ctypes argument types;
    every exported launcher returns the `cudaError_t` of
    `cudaGetLastError()` after its launch.  `launches` counts the launches
    made through `launch` and `counts` the same by launcher name;
    `reset_counts` sets both to 0.  `defines` are preprocessor definitions
    (`NAME=VALUE`) for a source that builds into more than one library, each
    under its own `name`, so that nvcc compiles the variants side by side.
    """

    def __init__(self, source: str, signatures: Dict[str, List], defines: Sequence[str] = (),
                 name: str = ""):
        self.source = source
        self.signatures = signatures
        self.defines = tuple(defines)
        self.name = name or os.path.splitext(source)[0]
        self.launches = 0
        self.counts: Dict[str, int] = {name: 0 for name in signatures}
        self._lib = None
        self._lock = threading.Lock()

    @property
    def src_path(self) -> str:
        return os.path.join(CSRC_DIR, self.source)

    def lib_path(self) -> str:
        h = hashlib.sha1(" ".join([*NVCC_FLAGS, *self.defines]).encode())
        headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
        for path in [self.src_path] + [os.path.join(CSRC_DIR, f) for f in headers]:
            with open(path, "rb") as f:
                h.update(f.read())
        return os.path.join(BUILD_DIR, f"lib{self.name}-{h.hexdigest()[:12]}.so")

    def _start_build(self) -> Tuple[subprocess.Popen, str, str]:
        out = self.lib_path()
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [find_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in self.defines), "-o", tmp, self.src_path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        return proc, tmp, out

    @staticmethod
    def _finish_build(proc: subprocess.Popen, tmp: str, out: str, source: str):
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source} (exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)  # atomic: a concurrent reader sees all or nothing

    def _load(self, path: str):
        lib = ctypes.CDLL(path)
        for name, argtypes in self.signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = I
        lib.emo_error_string.argtypes = [I]
        lib.emo_error_string.restype = ctypes.c_char_p
        self._lib = lib

    def lib(self):
        """The loaded library, built first if needed."""
        if self._lib is None:
            with self._lock:
                if self._lib is None:
                    path = self.lib_path()
                    if not os.path.exists(path):
                        self._finish_build(*self._start_build(), self.name)
                    self._load(path)
        return self._lib

    def launch(self, name: str, *args) -> None:
        """Call launcher `name`, raise on a CUDA error, count the launch."""
        lib = self.lib()
        err = getattr(lib, name)(*args)
        if err != 0:
            msg = lib.emo_error_string(err).decode()
            raise RuntimeError(f"{self.name}:{name} launch failed: {msg} (cudaError {err})")
        self.launches += 1
        self.counts[name] += 1

    def reset_counts(self) -> None:
        self.launches = 0
        for name in self.counts:
            self.counts[name] = 0


def build_all(kernels: Iterable[CudaKernel]) -> None:
    """Build every kernel that is not built yet, one nvcc per source, all
    at once, then load them."""
    kernels = list(kernels)
    jobs = []
    for k in kernels:
        if k._lib is None and not os.path.exists(k.lib_path()):
            jobs.append((k, *k._start_build()))
    errors = []
    for k, proc, tmp, out in jobs:
        try:
            CudaKernel._finish_build(proc, tmp, out, k.name)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    for k in kernels:
        k.lib()

