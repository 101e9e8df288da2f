"""Compile a native library only when what it was built from changed.

The libraries are built with ``-march=native``, so a library compiled on one
host can fault (SIGILL) or misbehave on another that copies the checkout.
Each library is keyed on a hash of its sources, its compiler flags and the
host CPU (model name and ISA flags); the key is stored beside the ``.so`` as
``<name>.buildkey`` and a mismatch rebuilds.
"""

from __future__ import annotations

import hashlib
import os
import platform
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as fh:
            lines = fh.read().splitlines()
    except OSError:
        return f"{platform.machine()} {platform.processor()}"
    return "\n".join(sorted({ln for ln in lines if ln.startswith(("model name", "flags"))}))


def build_key(sources: Sequence[Path], flags: Sequence[str]) -> str:
    h = hashlib.sha256()
    for src in sources:
        h.update(Path(src).read_bytes())
    h.update("\0".join(flags).encode())
    h.update(_cpu_model().encode())
    return h.hexdigest()


def _key_file(so: Path) -> Path:
    return so.with_name(so.name + ".buildkey")


def is_current(so: Path, sources: Sequence[Path], flags: Sequence[str]) -> bool:
    try:
        return so.exists() and _key_file(so).read_text() == build_key(sources, flags)
    except OSError:
        return False


def _write_atomic(path: Path, write) -> None:
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=path.name, suffix=".tmp")
    os.close(fd)
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def build(so: Path, sources: Sequence[Path], flags: Sequence[str], force: bool = False) -> bool:
    """Compile ``sources`` into ``so`` with g++ unless its stored key matches.

    Returns True when it compiled. The library and then its key are each
    replaced atomically, so concurrent builders never load a half-written
    file.
    """
    if not force and is_current(so, sources, flags):
        return False
    key = build_key(sources, flags)

    def compile_to(tmp):
        subprocess.run(
            ["g++", *flags, *map(str, sources), "-o", tmp],
            check=True, capture_output=True, text=True,
        )

    _write_atomic(so, compile_to)
    _write_atomic(_key_file(so), lambda tmp: Path(tmp).write_text(key))
    return True
