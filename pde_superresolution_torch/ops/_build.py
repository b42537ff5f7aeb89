"""Build ``csrc/*.cu`` with ``nvcc`` on first use and load it with ctypes.

Each source compiles to an object file in its own ``nvcc`` process, all
started together, and the objects link into one shared library with a plain
C interface. The build lands in ``pde_superresolution_torch/_build/<key>/``
(git-ignored), keyed by the contents of ``csrc/`` and the flags, so an
edited source rebuilds and an unchanged one loads the existing library.
Nothing is downloaded or prebuilt. Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIBRARY_NAME = "libpde_kernels.so"


@dataclasses.dataclass(frozen=True)
class Build:
    library: Path
    seconds: float  # wall time of this process's compile + link (0 if reused)
    logs: dict  # source name -> nvcc output (ptxas registers, smem, spills)
    source_seconds: dict = dataclasses.field(default_factory=dict)  # name -> its nvcc's wall time


def find_nvcc() -> str:
    for candidate in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if candidate and os.path.isfile(candidate):
            return candidate
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _build_key() -> str:
    digest = hashlib.sha256(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    for path in sorted(SOURCE_DIR.iterdir()):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return digest.hexdigest()[:16]


@functools.cache
def build() -> Build:
    """Compile every source in parallel and link the library, once per
    process and once per source version on disk."""
    sources = sorted(SOURCE_DIR.glob("*.cu"))
    out_dir = BUILD_DIR / _build_key()
    library = out_dir / LIBRARY_NAME
    if library.is_file():
        return Build(library, 0.0, {})
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    start = time.perf_counter()
    # object files of this process alone: ranks that start together (torchrun)
    # each build, and the last atomic rename below wins
    objects = {src: out_dir / f"{src.stem}.{os.getpid()}.o" for src in sources}
    outputs = {src: out_dir / f"{src.stem}.{os.getpid()}.log" for src in sources}
    procs = {}
    for src in sources:
        with open(outputs[src], "w") as log:
            procs[src] = subprocess.Popen(
                [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", str(src), "-o", str(objects[src])],
                stdout=log, stderr=subprocess.STDOUT, text=True,
            )
    source_seconds = {}
    while len(source_seconds) < len(procs):  # each source's own time: the slowest bounds the build
        for src, proc in procs.items():
            if src.name not in source_seconds and proc.poll() is not None:
                source_seconds[src.name] = time.perf_counter() - start
        time.sleep(0.05)
    logs = {src.name: outputs[src].read_text() for src in sources}
    for path in outputs.values():
        path.unlink()
    failed = [src.name for src, proc in procs.items() if proc.returncode != 0]
    if failed:
        raise RuntimeError(
            f"nvcc failed for {failed}:\n" + "\n".join(logs[n] for n in failed)
        )
    tmp = out_dir / f"{LIBRARY_NAME}.{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objects.values())],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    for obj in objects.values():
        obj.unlink()
    os.replace(tmp, library)  # atomic: a concurrent loader sees all or nothing
    return Build(library, time.perf_counter() - start, logs, source_seconds)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every C entry's signature."""
    lib = ctypes.CDLL(str(build().library))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.pde_fused_rhs.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr,  # u, c[0..2], f, out
        i32, i32,  # batch, nx
        ctypes.POINTER(i32),  # meta: see fused_rhs.cu
        f32, f32,  # dx, eta
        ptr,  # stream
    ]
    lib.pde_fused_rhs.restype = i32
    lib.pde_fused_learned_rk4.argtypes = [
        ptr, ptr, ptr,  # u, weights, out
        i32, i32,  # batch, num_steps
        ctypes.POINTER(i32),  # meta: see fused_learned_rk4.cu
        ctypes.POINTER(i32),  # the weights' bytes, then the blocks' byte offsets
        ctypes.POINTER(f32),  # dx, eta, dt/2, dt, dt/6
        ctypes.POINTER(ptr),  # forcing: amp, rot_c, rot_s, sin0, cos0
        i32,  # shared-memory bytes
        ptr,  # stream
    ]
    lib.pde_fused_learned_rk4.restype = i32
    lib.pde_fused_rk4.argtypes = [
        ptr, ptr,  # u, out
        i32, i32,  # batch, num_steps
        ctypes.POINTER(i32),  # meta: see fused_rk4.cu
        ctypes.POINTER(f32),  # coefficients [3][33], by tap
        ctypes.POINTER(f32),  # dx, eta, dt/2, dt, dt/6
        ptr,  # a wide scheme's coefficients (or null)
        ptr,  # stream
    ]
    lib.pde_fused_rk4.restype = i32
    lib.pde_empty_kernel.argtypes = [ptr]  # stream
    lib.pde_empty_kernel.restype = i32
    lib.pde_cuda_error_string.argtypes = [i32]
    lib.pde_cuda_error_string.restype = ctypes.c_char_p
    return lib


def error_string(code: int) -> str:
    return load_library().pde_cuda_error_string(code).decode()
