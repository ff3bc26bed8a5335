"""Builds the hand-written CUDA kernels into one shared library, at first use.

Each ``csrc/*.cu`` exposes plain C functions and compiles on its own
(``nvcc -c``, all sources at once, in parallel); one link step makes
``build/kernels-<hash>/libreprotorch_kernels.so`` at the repository root,
which ``ctypes`` loads.  The hash covers every source and the flags, so an
edited source rebuilds and an unchanged one is reused.  Nothing here runs at
import time: the CPU tests import every kernel module without ``nvcc``.

Thread safety: the cluster runtime launches kernels from many threads, so
the first build and load run under one lock (exactly one build per
process) and the launch counters rise under another (:func:`count`).

CUDA graphs: a launch made while the current stream captures a graph runs
no kernel then, but once at each replay.  So :func:`count` adds nothing for
it; it goes into the :class:`LaunchRecord` that :func:`recording` opened
on this thread, and :meth:`LaunchRecord.replay` adds the recorded launches
at each replay.  A counted launch under capture outside :func:`recording`
raises: its replays would count nothing.

Flags: ``sm_90a`` (Hopper), ``-O3`` and NO ``--use_fast_math``: the kernels'
bit-equality with their plain versions rests on IEEE rounding and on the
explicit ``__f*_rn`` intrinsics.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC"]
LIB_NAME = "libreprotorch_kernels.so"


@dataclasses.dataclass
class KernelInfo:
    """One kernel of the port: where it lives, what it replaces, and how
    often its wrapper launched it (a plain counter, raised only at a
    launch, through :func:`count`)."""

    name: str
    source: str     # path in the repository
    replaces: str   # file:line of the TPU kernel
    launches: int = 0


_LIB = None
_LIB_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
BUILD_SECONDS: float | None = None


class LaunchRecord:
    """The launches one CUDA graph capture recorded, kernel by kernel: what
    each replay of the graph launches."""

    def __init__(self):
        self.launches: dict[str, list] = {}   # name -> [KernelInfo, n]

    def add(self, info: KernelInfo, n: int) -> None:
        self.launches.setdefault(info.name, [info, 0])[1] += n

    def replay(self, times: int = 1) -> None:
        """Count ``times`` replays of the graph: every recorded launch's
        counter rises by its count per replay, times ``times``."""
        with _COUNT_LOCK:
            for info, n in self.launches.values():
                info.launches += n * times


# the LaunchRecord open on each thread (recording())
_CAPTURE = threading.local()


@contextlib.contextmanager
def recording():
    """Open a :class:`LaunchRecord` on this thread for the launches made
    under CUDA graph capture until the block ends; yields it."""
    record = LaunchRecord()
    outer = getattr(_CAPTURE, "record", None)
    _CAPTURE.record = record
    try:
        yield record
    finally:
        _CAPTURE.record = outer


def count(info: KernelInfo, n: int = 1) -> None:
    """Raise a kernel's launch counter by ``n``, atomically across
    threads; under CUDA graph capture record the launch instead (see the
    module's docstring).  A stream can capture only once CUDA is
    initialized, which it never is in a build of torch without CUDA."""
    if torch.cuda.is_initialized() \
            and torch.cuda.is_current_stream_capturing():
        record = getattr(_CAPTURE, "record", None)
        if record is None:
            raise RuntimeError(f"{info.name}: launched under CUDA graph "
                               f"capture outside build.recording(); its "
                               f"replays would count nothing")
        record.add(info, n)
        return
    with _COUNT_LOCK:
        info.launches += n


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return str(path)


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile (if needed) and return the path of the shared library."""
    global BUILD_SECONDS
    sources = sorted(CSRC.glob("*.cu"))
    out_dir = BUILD_ROOT / f"kernels-{_digest(sources)}"
    lib = out_dir / LIB_NAME
    if lib.exists():
        BUILD_SECONDS = 0.0
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    extra = ["-Xptxas", "-v"] if verbose else []
    # per-process object names: concurrent first uses cannot clobber each
    # other, and the library appears with one atomic rename
    objs = [out_dir / f"{src.stem}.{os.getpid()}.o" for src in sources]
    procs = []
    for src, obj in zip(sources, objs):
        procs.append((src, subprocess.Popen(
            [nvcc, *FLAGS, *extra, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, proc in procs:
        out, _ = proc.communicate()
        if verbose and out:
            print(out)
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = out_dir / (LIB_NAME + f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *FLAGS, "-shared", "-o", str(tmp),
         *[str(o) for o in objs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    os.replace(tmp, lib)
    for obj in objs:
        obj.unlink()
    BUILD_SECONDS = time.perf_counter() - t0
    return lib


def _declare(lib) -> None:
    """Declare every C function's argument and result types."""
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.scatter_add.argtypes = [p, i64, p, p, i64, p]
    f32 = ctypes.c_float
    lib.scatter_add_rows.argtypes = [p, i64, p, p, i64, i64, p, p, i64, p]
    lib.block_topk.argtypes = [p, p, p, i64, i32, p]
    lib.row_topk.argtypes = [p, i64, p, p, i64, i32, i32, p]
    lib.samomentum_row_topk.argtypes = [p, i64, p, i64, p, i64, f32, f32,
                                        f32, p, p, i64, i32, i32, p]
    lib.samomentum_fused.argtypes = [p, p, p, p, p, f32, f32, f32, i64, i64,
                                     p]
    lib.samomentum_accumulate.argtypes = [p, i64, p, i64, p, i64, f32, p,
                                          f32, i64, i64, p]
    lib.fma_rows.argtypes = [p, i64, f32, i32] * 3 + [p, i64, i64, p]
    lib.segment_quantize.argtypes = [p, i64, i32, i64, p, p, i32, i32, i32,
                                     i32, f32, f32, p, p, i64, p, i64, i32,
                                     p, p, i32, p, p]
    for fn in (lib.scatter_add, lib.scatter_add_rows, lib.block_topk,
               lib.row_topk, lib.samomentum_row_topk, lib.samomentum_fused,
               lib.samomentum_accumulate, lib.fma_rows,
               lib.segment_quantize):
        fn.restype = ctypes.c_int


def library():
    """The loaded kernel library, built and loaded once per process (the
    first caller builds, concurrent first callers wait for it), with every
    C function's signature declared."""
    global _LIB
    if _LIB is None:
        with _LIB_LOCK:
            if _LIB is None:
                lib = ctypes.CDLL(str(build()))
                _declare(lib)
                _LIB = lib
    return _LIB


# The raw binding PyTorch's own generated kernels launch on: the public
# torch.cuda.current_stream() builds a Stream object at every call, which
# costs more host time than a small kernel's launch.
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream() -> int:
    """The current device's current CUDA stream as a pointer-sized
    integer."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(torch.cuda.current_device())
    return torch.cuda.current_stream().cuda_stream


def check(rc: int, name: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, device, *,
            contiguous: bool = True) -> None:
    """Validate one kernel operand before its pointer leaves Python (a
    kernel that takes strides checks them itself: ``contiguous=False``)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
