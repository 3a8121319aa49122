"""Build, load and launch the port's CUDA kernels.

Every source under ``clip_for_dl_tpu_torch/csrc/`` is compiled by its own
``nvcc`` for ``sm_90a``, all of them started together, and the objects are
linked into one shared library with a plain C interface, loaded with ctypes.
The sources include no PyTorch header, so the build takes seconds.
The TMA tensor maps of B4, B8 and B9 (``csrc/wgmma_tiles.cuh``) are encoded
with libcuda's ``cuTensorMapEncodeTiled``, fetched at run time through the
runtime's ``cudaGetDriverEntryPoint``, so the link needs no ``-lcuda``.
It runs on first use, never at import (the CPU tests import every module),
into ``_kernel_build/`` beside this package, under a name that hashes the
sources and flags, so an edited source is rebuilt and a stale library is
never loaded.

Each wrapper checks its tensors, allocates outputs with ``torch.empty`` and
calls :func:`launch`, which passes PyTorch's current stream, raises if the C
function returns a CUDA error, and counts the launch in :data:`LAUNCHES`.

The launch path runs on every call of every wrapper, and at one request the
host's time in it is longer than the kernels' (a B1 call takes ~0.036 ms
from the host for ~0.004 ms on the card, on an NVIDIA H100 80GB HBM3 at
700 W). So once the library is loaded :func:`launch` takes no lock but the
count's, keeps each entry point's ctypes function in :data:`_entries`
(dropped whenever :func:`use_library` swaps the library), reads the raw
stream handle instead of building a ``torch.cuda.Stream``, and switches
the current device only when the tensors lie on another one;
:func:`check_tensor` makes one pass of comparisons and builds a message
only when one fails.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections import Counter
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_kernel_build"
# -Xptxas -v: ptxas' per-kernel registers, shared memory and spills go to
# build_info["log"]
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo",
    "-Xptxas", "-v",
)

# kernel entry point -> launches; only :func:`launch` adds to it
LAUNCHES: Counter = Counter()

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PREP = (_P,) * 12 + (_I,) * 8  # img, y taps x4, x taps x4, scale, bias, out, B,
# H_in, W_in, C_in, H_out, W_out, C_out, out_type (0 fp32, 1 bf16, 2 fp16)
_SIGNATURES = {
    # img, txt, out, B, C, D, inv_temp, eps, img_type, txt_type (0 fp32,
    # 1 bf16, 2 fp16), stream
    "cxr_similarity": (_P, _P, _P, _I, _I, _I, _F, _F, _I, _I, _P),
    # uint8 images, the staged body; fp32 images, the staged body; either
    # (src_type 0 uint8, 1 fp32), the direct body
    "cxr_image_prep": _PREP + (_P,),
    "cxr_image_prep_f32src": _PREP + (_P,),
    "cxr_image_prep_direct": _PREP + (_I, _P),
    # attention, each in bf16 (the name), fp16 (_f16) and fp32 (_f32):
    # qkv, bias, seeds, out, B, N, H, D, scale, rate, 1/(1-rate), stream
    **{"cxr_flash_fwd_packed" + x: (_P,) * 4 + (_I,) * 4 + (_F,) * 3 + (_P,)
       for x in ("", "_f16", "_f32")},
    # qkv, do, bias, seeds, dqkv, stats, B, N, H, D, scale, rate, 1/(1-rate),
    # stream
    **{"cxr_flash_bwd_packed" + x: (_P,) * 6 + (_I,) * 4 + (_F,) * 3 + (_P,)
       for x in ("", "_f16", "_f32")},
    # q, k, v, bias, seeds, out, strides (12 int64 in host memory), B, N, H,
    # D, scale, rate, 1/(1-rate), stream
    **{"cxr_flash_fwd" + x: (_P,) * 7 + (_I,) * 4 + (_F,) * 3 + (_P,)
       for x in ("", "_f16", "_f32")},
    # q, k, v, do, bias, seeds, dq, dk, dv, stats, strides (21 int64 in host
    # memory), B, N, H, D, scale, rate, 1/(1-rate), stream
    **{"cxr_flash_bwd" + x: (_P,) * 11 + (_I,) * 4 + (_F,) * 3 + (_P,)
       for x in ("", "_f16", "_f32")},
    # x, w1, b1, w2, b2, y, g (scratch), R, H, F, stream
    "cxr_mlp_fwd": (_P,) * 7 + (_I,) * 3 + (_P,),
    # x, w1, b1, w2, dy, dx, g, dh, R, H, F, stream
    "cxr_mlp_bwd": (_P,) * 8 + (_I,) * 3 + (_P,),
    # x, ln_scale, ln_bias, w1, b1, w2, b2, out, y, g (scratch), R, H, F, eps,
    # approximate, stream
    "cxr_mlp_block": (_P,) * 10 + (_I,) * 3 + (_F, _I, _P),
}

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# entry point -> its ctypes function in _lib; filled by launch, emptied by
# use_library
_entries: dict = {}
build_info: dict = {}
# the device type the kernels run on; the CPU tests of the wrappers' routing
# set it to "cpu" (with launch replaced)
CARD = "cuda"


def _nvcc() -> str:
    # torch looks in $CUDA_HOME, $CUDA_PATH, beside nvcc on PATH, /usr/local/cuda
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = Path(CUDA_HOME or "") / "bin" / "nvcc"
    if not CUDA_HOME or not nvcc.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(nvcc)


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _compile(nvcc: str, path: Path) -> str:
    """One nvcc per source, all running at once, then one link; returns the
    compilers' output. Raises if any step fails."""
    tmp_dir = path.with_suffix(f".{os.getpid()}.d")
    tmp_dir.mkdir(exist_ok=True)
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = tmp_dir / (src.stem + ".o")
        procs.append((src.name, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = "", []
    for name, _, proc in procs:
        out, _ = proc.communicate()
        log += f"== {name}\n{out}"
        if proc.returncode != 0:
            failed.append(name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
    tmp = tmp_dir / path.name
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)],
                          capture_output=True, text=True)
    log += link.stdout + link.stderr
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
    os.replace(tmp, path)
    shutil.rmtree(tmp_dir, ignore_errors=True)
    return log


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library; returns the handle.
    The compiler's output of a fresh build lands in ``build_info["log"]``."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        nvcc = _nvcc()
        digest = hashlib.sha256(" ".join((nvcc,) + NVCC_FLAGS).encode())
        for src in _sources():
            digest.update(src.name.encode())
            digest.update(src.read_bytes())
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        path = BUILD_DIR / f"libcxr_kernels-{digest.hexdigest()[:16]}.so"
        log = ""
        if not path.exists():
            log = _compile(nvcc, path)
        lib = load(path)
        build_info.update(path=str(path), log=log)
        _lib = lib
        return lib


def load(path, signatures=None) -> ctypes.CDLL:
    """The kernel library at ``path``, every entry point's signature set:
    this checkout's, or ``signatures`` (another checkout's, whose C
    interface may differ)."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in (signatures or _SIGNATURES).items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.cxr_error_string.argtypes = [ctypes.c_int]
    lib.cxr_error_string.restype = ctypes.c_char_p
    return lib


def use_library(lib) -> None:
    """Launch every kernel from ``lib`` from now on: another build, such as
    another checkout's, called with this checkout's arguments
    (``tools/compare_builds.other_library``). The cached entry points of the
    library it replaces are dropped."""
    global _lib
    with _lock:
        _lib = lib
        _entries.clear()


def _entry(name: str):
    """The ctypes function of entry point ``name``, from the library
    :func:`build` loads, cached in :data:`_entries`."""
    build()
    with _lock:  # _lib is the library in use, another build's after use_library
        fn = _entries.get(name)
        if fn is None:
            fn = _entries[name] = getattr(_lib, name)
        return fn


try:  # the stream handle as an int, without a torch.cuda.Stream object
    _raw_stream = torch._C._cuda_getCurrentRawStream
except AttributeError:  # a torch without it, or built without CUDA
    def _raw_stream(index: int) -> int:
        return torch.cuda.current_stream(index).cuda_stream


def launch(name: str, device: torch.device, *args, key: Optional[str] = None) -> None:
    """Call kernel entry point ``name`` on ``device``'s current stream, and
    count it in :data:`LAUNCHES` under ``key`` (``name`` when None: a
    wrapper names another key where one entry point runs instances that
    are counted apart)."""
    fn = _entries.get(name) or _entry(name)
    index = device.index
    if index is None or index == torch.cuda.current_device():
        err = fn(*args, _raw_stream(torch.cuda.current_device() if index is None else index))
    else:
        with torch.cuda.device(device):
            err = fn(*args, _raw_stream(index))
    if err != 0:
        msg = build().cxr_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
    with _count_lock:  # the service launches from its batcher thread
        LAUNCHES[key or name] += 1


def reset_launches() -> None:
    with _count_lock:
        LAUNCHES.clear()


def check_device(t: torch.Tensor, name: str, device: Optional[torch.device] = None) -> None:
    """Raise unless ``t`` lies on the card (on ``device`` when given)."""
    if t.device.type != CARD:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def check_tensor(t: torch.Tensor, name: str, dtype, shape=None,
                 device: Optional[torch.device] = None, align: int = 16) -> None:
    """Raise unless ``t`` is a contiguous, ``align``-byte aligned CUDA
    tensor of ``dtype`` (and ``shape``/``device`` when given)."""
    dev = t.device
    if (dev.type == CARD and (device is None or dev == device) and t.dtype == dtype
            and (shape is None or t.shape == shape) and t.is_contiguous()
            and not t.data_ptr() % align):
        return
    check_device(t, name, device)
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    raise ValueError(f"{name}: data must be {align}-byte aligned")
