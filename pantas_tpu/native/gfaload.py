"""Self-building import shim for the native GFA loader extension.

Unlike the ctypes engines, ``gfaload`` is a real CPython extension (it
builds Python dicts/sets/objects directly), compiled on first use with g++
against the interpreter's headers and loaded from its file path.
"""

from __future__ import annotations

import importlib.util
import sysconfig
from pathlib import Path

from pantas_tpu.native import buildkey

_SRC = Path(__file__).parent / "gfaload.cpp"
_SO = Path(__file__).parent / "gfaload_ext.so"

_mod = None
_failed = False


def _flags():
    inc = sysconfig.get_paths()["include"]
    # -pthread: the parallel scan spawns std::thread
    return ["-O3", "-march=native", "-std=c++17", "-pthread", "-shared", "-fPIC", f"-I{inc}"]


def build_extension(force: bool = False) -> bool:
    """Compile ``gfaload_ext.so`` unless its build key matches; True if built."""
    return buildkey.build(_SO, [_SRC], _flags(), force=force)


def get_module():
    """The compiled extension module, or None if unavailable."""
    global _mod, _failed
    if _mod is not None or _failed:
        return _mod
    try:
        build_extension()
        spec = importlib.util.spec_from_file_location("gfaload_ext", _SO)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _mod = mod
    except Exception:
        _failed = True
        _mod = None
    return _mod
