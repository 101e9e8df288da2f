"""CLI device paths fail loudly: too few devices for ``--mesh`` is an error,
and a device error is never rerun through the Python tokenizer feed."""

import io

import pytest

from fixtures_call import write_call_fixtures
from fixtures_micro import write_micro

from pantas_tpu import cli
from pantas_tpu.coverage import augment_gfa


@pytest.fixture(autouse=True)
def _no_persistent_cache(monkeypatch):
    # the CLI turns the compile cache on process-wide; keep it off in the
    # test worker
    from pantas_tpu import compile_cache

    monkeypatch.setattr(compile_cache, "enable_persistent_cache", lambda: None)


@pytest.mark.parametrize("stage", ["call", "augment-1d", "augment-2d"])
def test_mesh_needs_enough_devices(tmp_path, capsys, stage):
    # conftest gives 8 virtual CPU devices; ask for 16
    if stage == "call":
        gfa, gtf = write_call_fixtures(tmp_path)["splice"]
        rc = cli._cmd_call([gfa, gtf, "--engine", "device", "--mesh", "16",
                            "-o", str(tmp_path / "ev.csv")])
        spec = "16"
    else:
        gfa, gaf = write_micro(tmp_path)
        spec = "16" if stage == "augment-1d" else "4x4"
        rc = cli._cmd_augment([gaf, gfa, "--engine", "device", "--mesh", spec,
                               "-o", str(tmp_path / "aug.gfa")])
    assert rc == 1
    err = capsys.readouterr().err
    assert f"--mesh {spec} needs 16 devices; JAX has 8 (cpu)" in err


def test_device_error_is_not_rerun(tmp_path, monkeypatch):
    from pantas_tpu.coverage import device

    def boom(self, slots, pad_to=None):
        raise RuntimeError("device step failed")

    fed = []
    monkeypatch.setattr(device.DeviceCoverage, "add_slots", boom)
    monkeypatch.setattr(device, "augment_gfa_device", lambda *a, **k: fed.append(a))
    gfa, gaf = write_micro(tmp_path)
    with pytest.raises(RuntimeError, match="device step failed"):
        cli._cmd_augment([gaf, gfa, "--engine", "device", "-o", str(tmp_path / "a.gfa")])
    assert fed == []


def test_native_unsupported_uses_python_feed(tmp_path, monkeypatch, capsys):
    """Only a graph the native parser cannot take selects the Python feed,
    and that output is still byte-identical to the host engine."""
    from pantas_tpu.native import gafcov

    def unsupported(self, tensors):
        raise gafcov.NativeUnsupported("native path requires integer segment ids")

    monkeypatch.setattr(gafcov.NativeCoverage, "__init__", unsupported)
    gfa, gaf = write_micro(tmp_path)
    out = tmp_path / "a.gfa"
    assert cli._cmd_augment([gaf, gfa, "--engine", "device", "-o", str(out)]) == 0
    assert "python tokenizer feed" in capsys.readouterr().err
    host = io.StringIO()
    augment_gfa(gaf, gfa, out=host, log=io.StringIO())
    assert out.read_text() == host.getvalue()
