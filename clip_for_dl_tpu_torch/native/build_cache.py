"""Shared libraries built at first use and kept by content.

The port compiles two libraries on the machine that runs it: the CUDA
kernels (``ops/_build.py``, nvcc) and the image decoder
(``native/decoder.py``, g++). Each lands in ``_kernel_build/`` beside the
package under a name that hashes the compiler, its flags and every source,
so an edited source is rebuilt and a stale library is never loaded; a build
writes a temporary file and renames it into place, so processes that build
at once share one library.
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Callable, Iterable, Sequence, Tuple

BUILD_DIR = Path(__file__).resolve().parent.parent / "_kernel_build"


def cached_library(stem: str, compiler: str, flags: Sequence[str], sources: Iterable[Path],
                   compile: Callable[[str, Path], str],
                   build_dir: Path = BUILD_DIR) -> Tuple[Path, str]:
    """The path of library ``stem`` built from ``sources`` by ``compiler``
    with ``flags``, and the compiler's output ("" when the library was
    there). ``compile(compiler, path)`` runs only when it is missing, must
    write ``path`` through a temporary file renamed into place, and returns
    its output."""
    digest = hashlib.sha256(" ".join((compiler, *flags)).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    build_dir.mkdir(parents=True, exist_ok=True)
    path = build_dir / f"lib{stem}-{digest.hexdigest()[:16]}.so"
    return path, ("" if path.exists() else compile(compiler, path))


__all__ = ["BUILD_DIR", "cached_library"]
