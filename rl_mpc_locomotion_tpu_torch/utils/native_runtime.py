"""ctypes bindings for the native runtime (``native/runtime.cc``).

Counterpart of ``rl_mpc_locomotion_tpu/utils/native_runtime.py``:

- ``TelemetryLogger``: a wait-free ring buffer of float frames, drained to a
  binary file by a background thread, so the control loop never writes to
  disk (the reference's Logger.py pickled frames on the control thread).
- ``Gamepad``: a ``/dev/input/js*`` reader with the reference's command
  mapping (gamepad_reader.py): left stick vx / vy, right stick x yaw rate,
  LB cycles the gait, RB the FSM mode, LB+RB is the e-stop.

The shared library is compiled from ``native/runtime.cc`` with the host's
C++ compiler at first use, into ``build/native/`` beside the package (or
``$RLMPC_TORCH_BUILD_DIR/native``), under a name that carries a hash of the
source; ``native/`` itself is left as it is. Where no compiler or no
joystick exists, the logger buffers frames in Python and pickles them on
``flush`` (``TelemetryLogger.available`` says which path a logger took),
and the gamepad is inert. Neither touches the GPU.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pickle
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "runtime.cc"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-pthread")

_lib = None
_lib_lock = threading.Lock()
build_error = None   # why the library is unavailable, if it is


def _library_path() -> Path:
    from ..ops.cuda._build import build_dir
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes())
    return build_dir() / "native" / f"librlmpc_runtime_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (c++ / g++ / $CXX)")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.parent / f"{out.stem}.{os.getpid()}.so"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed on {SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, out)


def _load_library() -> Optional[ctypes.CDLL]:
    """The runtime library, compiled on the first call of a process; None
    (and the reason in ``build_error``) where it cannot be built."""
    global _lib, build_error
    with _lib_lock:
        if _lib is not None or build_error is not None:
            return _lib
        try:
            out = _library_path()
            if not out.exists():
                _compile(out)
            lib = ctypes.CDLL(str(out))
        except (OSError, RuntimeError, subprocess.TimeoutExpired) as exc:
            build_error = str(exc)
            return None
        lib.rt_logger_create.restype = ctypes.c_void_p
        lib.rt_logger_create.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                         ctypes.c_int]
        lib.rt_logger_push.restype = ctypes.c_int
        lib.rt_logger_push.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_float),
                                       ctypes.c_int]
        lib.rt_logger_dropped.restype = ctypes.c_uint64
        lib.rt_logger_dropped.argtypes = [ctypes.c_void_p]
        lib.rt_logger_flush.argtypes = [ctypes.c_void_p]
        lib.rt_logger_destroy.argtypes = [ctypes.c_void_p]
        lib.rt_gamepad_open.restype = ctypes.c_void_p
        lib.rt_gamepad_open.argtypes = [ctypes.c_char_p]
        lib.rt_gamepad_connected.restype = ctypes.c_int
        lib.rt_gamepad_connected.argtypes = [ctypes.c_void_p]
        lib.rt_gamepad_state.argtypes = [ctypes.c_void_p,
                                         ctypes.POINTER(ctypes.c_int16),
                                         ctypes.POINTER(ctypes.c_uint8)]
        lib.rt_gamepad_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


class TelemetryLogger:
    """Fixed-size float-frame logger: the native ring buffer when the
    library builds, frames buffered in Python and pickled otherwise."""

    MAGIC = 0x524C4D43

    def __init__(self, path: str, frame_size: int, capacity: int = 4096,
                 field_names: Optional[list] = None):
        self.path = path
        self.frame_size = frame_size
        self.field_names = field_names
        lib = _load_library()
        self._handle = None
        self._fallback_frames = []
        if lib is not None:
            self._lib = lib
            self._handle = lib.rt_logger_create(path.encode(), frame_size,
                                                capacity)
        if field_names:
            with open(path + ".meta", "w") as f:
                f.write("\n".join(field_names))

    @property
    def available(self) -> bool:
        """True when the native ring buffer backs this logger."""
        return self._handle is not None

    def push(self, frame) -> bool:
        frame = np.ascontiguousarray(frame, dtype=np.float32).reshape(-1)
        if frame.shape[0] != self.frame_size:
            raise ValueError(f"frame of {frame.shape[0]} floats, the logger "
                             f"takes {self.frame_size}")
        if self._handle is not None:
            ptr = frame.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            return bool(self._lib.rt_logger_push(self._handle, ptr,
                                                 self.frame_size))
        self._fallback_frames.append(frame.copy())
        return True

    @property
    def dropped(self) -> int:
        if self._handle is not None:
            return int(self._lib.rt_logger_dropped(self._handle))
        return 0

    def flush(self):
        if self._handle is not None:
            self._lib.rt_logger_flush(self._handle)
        elif self._fallback_frames:
            with open(self.path, "wb") as f:
                pickle.dump(np.stack(self._fallback_frames), f)

    def close(self):
        if self._handle is not None:
            self._lib.rt_logger_destroy(self._handle)
            self._handle = None
        else:
            self.flush()

    @staticmethod
    def read(path: str) -> np.ndarray:
        """A log read back as (n_frames, frame_size), native or pickled."""
        with open(path, "rb") as f:
            header = np.fromfile(f, dtype=np.uint32, count=3)
            if len(header) == 3 and header[0] == TelemetryLogger.MAGIC:
                frame_size = int(header[2])
                data = np.fromfile(f, dtype=np.float32)
                n = len(data) // frame_size
                return data[:n * frame_size].reshape(n, frame_size)
        with open(path, "rb") as f:  # the Python path's pickle
            return pickle.load(f)


# gamepad_reader.py's command mapping
_MAX_VX, _MAX_VY, _MAX_WZ = 1.0, 0.6, 1.2
_GAITS = [0, 6, 1]          # trot, walk, bound (gait ids 0 / 6 / 1)
_MODES = [2, 1, 0]          # recovery, locomotion, passive


class Gamepad:
    """Gamepad with the reference's stick and button semantics. Inert (zero
    commands, ``connected`` False) when no joystick device exists."""

    def __init__(self, device: str = "/dev/input/js0"):
        self._lib = None
        self._handle = None
        self.gait_idx = 0
        self.mode_idx = 0
        self.estop_flagged = False
        self._prev_lb = False
        self._prev_rb = False
        if os.path.exists(device):
            lib = _load_library()
            if lib is not None:
                self._lib = lib
                self._handle = lib.rt_gamepad_open(device.encode())
                if not lib.rt_gamepad_connected(self._handle):
                    lib.rt_gamepad_close(self._handle)
                    self._handle = None

    @property
    def connected(self) -> bool:
        return self._handle is not None

    def fake_event(self, mode_idx: Optional[int] = None,
                   estop: bool = False):
        """Force a state change (the reference uses it to trigger recovery
        on unsafe locomotion)."""
        if mode_idx is not None:
            self.mode_idx = mode_idx % len(_MODES)
        if estop:
            self.estop_flagged = True

    def _raw_state(self):
        axes = (ctypes.c_int16 * 8)()
        buttons = (ctypes.c_uint8 * 16)()
        self._lib.rt_gamepad_state(self._handle, axes, buttons)
        return (np.ctypeslib.as_array(axes).copy(),
                np.ctypeslib.as_array(buttons).copy())

    def get_command(self):
        """(vx, vy, wz) from the sticks, after handling the LB / RB edges;
        zeros when disconnected."""
        if self._handle is None:
            return np.zeros(3, np.float32)
        axes, buttons = self._raw_state()
        lb, rb = bool(buttons[4]), bool(buttons[5])
        if lb and rb:
            self.estop_flagged = True
        else:
            if lb and not self._prev_lb:
                self.gait_idx = (self.gait_idx + 1) % len(_GAITS)
            if rb and not self._prev_rb:
                self.mode_idx = (self.mode_idx + 1) % len(_MODES)
        self._prev_lb, self._prev_rb = lb, rb
        # float before negation: int16 -(-32768) overflows to -32768
        ax = axes.astype(np.float32) / 32768.0
        return np.array([-ax[1] * _MAX_VX, -ax[0] * _MAX_VY,
                         -ax[3] * _MAX_WZ], np.float32)

    def get_gait(self) -> int:
        return _GAITS[self.gait_idx]

    def get_mode(self) -> int:
        return _MODES[self.mode_idx]

    def close(self):
        if self._handle is not None:
            self._lib.rt_gamepad_close(self._handle)
            self._handle = None
