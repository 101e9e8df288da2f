"""Native libraries rebuild when their sources, flags or host CPU change.

A checkout copied to another host must not load a ``-march=native``
library compiled for this one.
"""

import pytest

from pantas_tpu.native import buildkey

FLAGS = ["-O1", "-shared", "-fPIC"]


@pytest.mark.parametrize("change", ["source", "flags", "cpu"])
def test_build_key_forces_rebuild(tmp_path, monkeypatch, change):
    src = tmp_path / "k.cpp"
    src.write_text('extern "C" int k() { return 1; }\n')
    so = tmp_path / "libk.so"
    assert buildkey.build(so, [src], FLAGS) is True
    assert so.exists() and (tmp_path / "libk.so.buildkey").exists()
    assert buildkey.build(so, [src], FLAGS) is False  # key matches: reuse
    flags = FLAGS
    if change == "source":
        src.write_text('extern "C" int k() { return 2; }\n')
    elif change == "flags":
        flags = FLAGS + ["-DVARIANT"]
    else:
        monkeypatch.setattr(buildkey, "_cpu_model", lambda: "another host CPU")
    assert not buildkey.is_current(so, [src], flags)
    assert buildkey.build(so, [src], flags) is True
    assert buildkey.is_current(so, [src], flags)


def test_missing_key_rebuilds(tmp_path):
    """A library with no key beside it (built by an older tree, or copied
    without its key) is rebuilt, not trusted."""
    src = tmp_path / "k.cpp"
    src.write_text('extern "C" int k() { return 1; }\n')
    so = tmp_path / "libk.so"
    so.write_bytes(b"not a library")
    assert not buildkey.is_current(so, [src], FLAGS)
    assert buildkey.build(so, [src], FLAGS) is True
    assert so.read_bytes()[:4] == b"\x7fELF"
