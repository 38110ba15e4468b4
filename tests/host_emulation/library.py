"""Builds tests/host_emulation/emulate.cpp (the package's CUDA sources
compiled as C++ for the host) with g++ and loads it with ctypes, argument
types set for every rlmpc_emulate_* entry. A test instrument, not part of
the package: the CPU tests run each kernel's own source through it against
the kernel's plain version."""
import ctypes
import pathlib
import shutil
import subprocess

HERE = pathlib.Path(__file__).resolve().parent
CSRC = HERE.parents[1] / "rl_mpc_locomotion_tpu_torch" / "csrc"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
ARGTYPES = {
    "rlmpc_emulate_fused_solve_chain": [_P] * 17 + [_I] * 9 + [_F] * 5,
    "rlmpc_emulate_fused_solve": [_P] * 16 + [_I] * 7 + [_F] * 4,
    "rlmpc_emulate_scaled_solve": [_P] * 12 + [_I] * 5 + [_F] * 2,
    "rlmpc_emulate_stripped_solve": [_P] * 4 + [_I] * 7 + [_F] * 4,
    "rlmpc_emulate_bm_dma": [_P] * 3 + [_I] * 4,
    "rlmpc_emulate_mpc_assembly": [_P] * 18 + [_I] * 3 + [_F],
}


def build(out_dir):
    """The emulation library built into ``out_dir``, or None without g++."""
    if shutil.which("g++") is None:
        return None
    out = pathlib.Path(out_dir) / "libemu.so"
    done = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC",
         "-I", str(CSRC), "-o", str(out), str(HERE / "emulate.cpp")],
        capture_output=True, text=True, timeout=300)
    if done.returncode != 0:
        raise RuntimeError(f"g++ failed on the host emulation:\n{done.stderr}")
    lib = ctypes.CDLL(str(out))
    for name, argtypes in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.rlmpc_emulate_compact_solves.argtypes = []
    lib.rlmpc_emulate_compact_solves.restype = ctypes.c_ulonglong
    lib.rlmpc_emulate_reset_compact_solves.argtypes = []
    lib.rlmpc_emulate_reset_compact_solves.restype = None
    return lib
