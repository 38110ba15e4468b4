"""Builds the package's CUDA sources into one shared library at first use,
and the checks every kernel wrapper makes around a launch.

``csrc/*.cu`` (with the ``*.cuh`` they include) are compiled by ``nvcc`` for
``sm_90a`` into ``build/librlmpc_kernels_<hash>.so`` beside the package and
loaded with ``ctypes``. The name carries a hash of the sources and flags, so
an edited source is rebuilt and an unchanged one is reused. Each ``.cu`` is
compiled to an object by its own ``nvcc`` process, all started together, and
one more ``nvcc`` links them.

A failed compile raises with the compiler's stderr; nothing here gives way to
another implementation. Set ``RLMPC_TORCH_BUILD_DIR`` to build elsewhere.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

MAX_SHARED_BYTES = 232448   # dynamic shared memory a block may ask for on sm_90

_lib = None
build_seconds = 0.0   # wall time of the build this process did (0 = reused)
build_log = ""        # nvcc's output (registers, shared memory, spills)


def build_dir() -> Path:
    env = os.environ.get("RLMPC_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build"


def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of rl_mpc_locomotion_tpu_torch are "
        "compiled at first use and need the CUDA toolkit")


def _sources():
    cu = sorted(CSRC_DIR.glob("*.cu"))
    cuh = sorted(CSRC_DIR.glob("*.cuh"))
    if not cu:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return cu, cuh


def _source_hash(files) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _compile(out: Path, cu_files) -> None:
    global build_seconds, build_log
    nvcc = _find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tag = f"{out.stem}.{os.getpid()}"
    objs, procs = [], []
    for src in cu_files:
        obj = out.parent / f"{tag}.{src.stem}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    logs, failed = [], []
    for src, proc in procs:
        so, se = proc.communicate()
        logs.append(so + se)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src.name}:\n{so}{se}")
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = out.parent / f"{tag}.so"
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp, out)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    build_log = "".join(logs)
    build_seconds = time.perf_counter() - t0


def load_library() -> ctypes.CDLL:
    """The compiled kernels, built on the first call of a process. Each
    wrapper module sets the argument types of its own entries; the shared
    ones (error string, shared-memory size of the QP entries) are set
    here."""
    global _lib
    if _lib is None:
        cu, cuh = _sources()
        out = build_dir() / f"librlmpc_kernels_{_source_hash(cu + cuh)}.so"
        if not out.exists():
            _compile(out, cu)
        lib = ctypes.CDLL(str(out))
        lib.rlmpc_error_string.argtypes = [ctypes.c_int]
        lib.rlmpc_error_string.restype = ctypes.c_char_p
        lib.rlmpc_qp_shared_bytes.argtypes = [ctypes.c_int] * 3
        lib.rlmpc_qp_shared_bytes.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_launch(err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error (0 = launched)."""
    if err != 0:
        msg = load_library().rlmpc_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} "
                           f"(cudaError {err})")


def check_shared(shared: int, sizes: str) -> None:
    """Raise unless a kernel's shared-memory need (-1 = sizes it does not
    take) fits a block."""
    if shared < 0 or shared > MAX_SHARED_BYTES:
        raise ValueError(
            f"QP sizes {sizes} do not fit the kernel (shared memory "
            f"{shared} B, limit {MAX_SHARED_BYTES} B)")


def check_tensors(want: dict, got: dict) -> None:
    """Every tensor of ``got`` has the shape ``want`` names for it, is
    float32 and contiguous, and lies on the first tensor's device; raises
    on anything a kernel does not take."""
    device = next(iter(got.values())).device
    for name, shape in want.items():
        t = got[name]
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name}: on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")


def kernel_device(t) -> str:
    """'cpu' (take the plain version) or 'cuda' (launch); raises on any
    other device."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def stream_of(t) -> int:
    """PyTorch's current stream on ``t``'s card, as a cudaStream_t."""
    return torch.cuda.current_stream(t.device).cuda_stream
