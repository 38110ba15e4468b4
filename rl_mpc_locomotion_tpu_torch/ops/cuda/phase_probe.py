"""Phase timers of the QP solve as CUDA kernels: the solve cut after a stage,
and the batch-major tile load.

Counterparts of the two kernels of ``scripts/profile.py``:

- ``stripped_solve`` / ``_stripped_kernel_runner``: the prebuilt-P solve
  (``fused_qp.fused_solve_batch``) cut after one of ``STAGES``; the time of a
  stage is the difference of two launches. Output after the stage:
  ``q (+ scaling) + row 0 of K`` for dma / mask / ruiz / kgj (K the raw,
  masked, scaled Hessian, then ``K^-1``), ``x`` (scaled) after 1 or 50 ADMM
  steps for admm1 / admm50. The stage settings are the TPU runner's: mask all
  ones, 3 Ruiz passes, rho 0.1, sigma 1e-6, relax 1.6, bounds +-1 in the
  scaled problem, cold start.
- ``bm_dma`` / ``make_bm_dma``: each robot's padded ``(n, np)`` tile brought
  into shared memory whole, then ``q + P[:, :, 0]`` (column 0) or, with
  ``transpose``, ``q + P[:, 0, :n]`` (row 0). The kernel copies a tile with
  one Hopper bulk copy, so on the card ``p_pad`` must start on a 16-byte
  boundary and ``n * np`` be a multiple of 4; the wrapper raises otherwise.

I/O is batch-major ``(B, ...)`` like the rest of the port; the JAX runner's
feature-major ``(N, B)`` layout (robots in the lanes of a TPU tile) is not
carried over. The kernels are ``csrc/phase_probe.cu``. Each wrapper launches
its kernel for CUDA tensors, or raises; CPU tensors take the plain version
beside it, which is also what the kernel is compared with.
``launch_count()`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .admm_kernel import _admm_math, spd_inverse
from .fused_qp import _assemble_k_reference, _mask_reference, _ruiz_reference

STAGES = ("dma", "mask", "ruiz", "kgj", "admm1", "admm50")
# the settings of scripts/profile.py's stripped runner
RUIZ_ITERS, RHO, SIGMA, RELAX, BOUND = 3, 0.1, 1e-6, 1.6, 1.0

_STAGE_CODE = {"dma": (0, 0), "mask": (1, 0), "ruiz": (2, 0), "kgj": (3, 0),
               "admm1": (4, 1), "admm50": (4, 50)}

_launches = {"stripped_solve": 0, "bm_dma": 0}
_bound = None


def launch_count(entry: str | None = None) -> int:
    """Kernel launches since the last ``reset_launch_count()``: of one entry
    (``"stripped_solve"``, ``"bm_dma"``) or of both."""
    return sum(_launches.values()) if entry is None else _launches[entry]


def reset_launch_count() -> None:
    for k in _launches:
        _launches[k] = 0


def _library():
    global _bound
    if _bound is None:
        lib = _build.load_library()
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rlmpc_stripped_solve.argtypes = (
            [ptr] * 4 + [i32] * 7 + [f32] * 4 + [ptr])
        lib.rlmpc_stripped_solve.restype = i32
        lib.rlmpc_bm_dma.argtypes = [ptr] * 3 + [i32] * 4 + [ptr]
        lib.rlmpc_bm_dma.restype = i32
        lib.rlmpc_bm_dma_shared_bytes.argtypes = [i32] * 2
        lib.rlmpc_bm_dma_shared_bytes.restype = i32
        _bound = lib
    return _bound


def stripped_solve(stage: str, p_mat, q_vec, c_blocks):
    """The prebuilt-P solve cut after ``stage`` (one of ``STAGES``).

    p_mat (B,n,n) SPD, q_vec (B,n), c_blocks (B,nb,5,3), float32,
    n = 3*nb. Returns (B,n): see the module docstring for what each stage
    leaves. CUDA tensors go through the kernel, or raise; CPU tensors go
    through the plain version.
    """
    if stage not in _STAGE_CODE:
        raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
    if p_mat.dim() != 3:
        raise ValueError(f"p_mat must be (B,n,n), got {tuple(p_mat.shape)}")
    b, n = p_mat.shape[0], p_mat.shape[-1]
    if b < 1 or n < 3 or n % 3 != 0:
        raise ValueError(f"need B >= 1 and n divisible by 3, got B={b} n={n}")
    nb, m = n // 3, 5 * (n // 3)
    _build.check_tensors(
        {"p_mat": (b, n, n), "q_vec": (b, n), "c_blocks": (b, nb, 5, 3)},
        {"p_mat": p_mat, "q_vec": q_vec, "c_blocks": c_blocks})
    if _build.kernel_device(p_mat) == "cpu":
        return stripped_solve_reference(stage, p_mat, q_vec, c_blocks)

    lib = _library()
    _build.check_shared(lib.rlmpc_qp_shared_bytes(n, m, nb),
                        f"n={n} m={m} nb={nb}")
    code, admm_iters = _STAGE_CODE[stage]
    out = torch.empty((b, n), dtype=torch.float32, device=p_mat.device)
    with torch.cuda.device(p_mat.device):
        err = lib.rlmpc_stripped_solve(
            p_mat.data_ptr(), q_vec.data_ptr(), c_blocks.data_ptr(),
            out.data_ptr(), b, n, m, nb, code, RUIZ_ITERS, admm_iters, RHO,
            SIGMA, RELAX, BOUND, _build.stream_of(p_mat))
    _build.check_launch(err, "stripped_solve")
    _launches["stripped_solve"] += 1
    return out


def stripped_solve_reference(stage: str, p_mat, q_vec, c_blocks):
    """The kernel's stages in plain PyTorch, with the fused solve's plain
    phases; same arguments and returns as ``stripped_solve``."""
    if stage not in _STAGE_CODE:
        raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
    if stage == "dma":
        return q_vec + p_mat[:, 0, :]
    k_mat, q_s = _mask_reference(p_mat, q_vec, torch.ones_like(q_vec))
    if stage == "mask":
        return q_s + k_mat[:, 0, :]
    k_mat, q_s, cs, _, _, _ = _ruiz_reference(k_mat, q_s, c_blocks, RUIZ_ITERS)
    if stage == "ruiz":
        return q_s + k_mat[:, 0, :]
    b, m = q_vec.shape[0], 5 * c_blocks.shape[1]
    rho = torch.full((b, m), RHO, dtype=q_vec.dtype, device=q_vec.device)
    k_inv = spd_inverse(_assemble_k_reference(k_mat, cs, rho, SIGMA))
    if stage == "kgj":
        return q_s + k_inv[:, 0, :]
    zeros = torch.zeros_like
    x, _, _ = _admm_math(
        _STAGE_CODE[stage][1], SIGMA, RELAX,
        lambda rhs: torch.einsum('bij,bj->bi', k_inv, rhs), cs, q_s,
        torch.full_like(rho, -BOUND), torch.full_like(rho, BOUND), rho,
        zeros(q_s), zeros(rho), zeros(rho))
    return x


def bm_dma(p_pad, q_vec, transpose: bool = False):
    """Each robot's padded tile p_pad (B,n,np), np >= n, into shared memory
    whole; returns ``q_vec + p_pad[:, :, 0]`` or, with ``transpose``,
    ``q_vec + p_pad[:, 0, :n]``, (B,n). CUDA tensors go through the kernel,
    which takes a tile only as whole 16-byte bulk copies (n*np a multiple of
    4, p_pad 16-byte aligned), or raise; CPU tensors of any shape and
    alignment go through the plain version."""
    if p_pad.dim() != 3:
        raise ValueError(f"p_pad must be (B,n,np), got {tuple(p_pad.shape)}")
    b, n, np_ = p_pad.shape
    if b < 1 or n < 1 or np_ < n:
        raise ValueError(f"need B >= 1 and np >= n, got {tuple(p_pad.shape)}")
    _build.check_tensors({"p_pad": (b, n, np_), "q_vec": (b, n)},
                         {"p_pad": p_pad, "q_vec": q_vec})
    if _build.kernel_device(p_pad) == "cpu":
        return bm_dma_reference(p_pad, q_vec, transpose)
    if (n * np_) % 4 or p_pad.data_ptr() % 16:
        raise ValueError(
            f"a tile is one bulk copy: n*np must be a multiple of 4 and "
            f"p_pad 16-byte aligned, got n={n} np={np_} at "
            f"{p_pad.data_ptr() % 16} bytes past a 16-byte boundary")
    lib = _library()
    _build.check_shared(lib.rlmpc_bm_dma_shared_bytes(n, np_),
                        f"n={n} np={np_}")
    out = torch.empty((b, n), dtype=torch.float32, device=p_pad.device)
    with torch.cuda.device(p_pad.device):
        err = lib.rlmpc_bm_dma(p_pad.data_ptr(), q_vec.data_ptr(),
                               out.data_ptr(), b, n, np_, int(bool(transpose)),
                               _build.stream_of(p_pad))
    _build.check_launch(err, "bm_dma")
    _launches["bm_dma"] += 1
    return out


def bm_dma_reference(p_pad, q_vec, transpose: bool = False):
    """``bm_dma`` in plain PyTorch."""
    n = q_vec.shape[1]
    return q_vec + (p_pad[:, 0, :n] if transpose else p_pad[:, :, 0])
