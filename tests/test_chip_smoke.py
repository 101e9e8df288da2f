"""``chip_smoke.py`` on the CPU: it refuses to report success without a GPU,
and its phases hold their equality checks at a tiny size."""

import filecmp
import os
import shutil
import subprocess
import sys

import pytest

from conftest import REPO_ROOT

sys.path.insert(0, str(REPO_ROOT / "scripts"))

import chip_smoke  # noqa: E402
import stress_build  # noqa: E402


@pytest.mark.parametrize("where", ["cpu-platform", "script-alone"])
def test_chip_smoke_refuses_without_gpu(tmp_path, where):
    env = dict(os.environ, JAX_PLATFORMS="cpu", TMPDIR=str(tmp_path))
    env.pop("PYTHONPATH", None)
    script = REPO_ROOT / "chip_smoke.py"
    if where == "script-alone":
        script = tmp_path / "chip_smoke.py"
        shutil.copy(REPO_ROOT / "chip_smoke.py", script)
    proc = subprocess.run(
        [sys.executable, str(script), "--mbp", "0.1", "--reads", "10"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert not any(p.name.startswith("chip_smoke_") for p in tmp_path.iterdir())


def test_chip_smoke_phases_cpu(tmp_path, monkeypatch):
    """Every single-card phase at 0.3 Mbp: exact scatter, byte-identical
    device/native augment, identical device/host call rows, and quant +
    remap producing rows. The child processes run on the CPU here."""
    monkeypatch.setattr(chip_smoke, "PLATFORM", "cpu")
    data = chip_smoke.prepare(tmp_path, mbp=0.3, reads=3000, seed=1)
    assert len(data["gafs"]) == 2

    sc = chip_smoke.scatter_phase(
        data["gfa"], data["gafs"][0], widths=(1 << 14, 1 << 16), batch=1 << 12
    )
    assert sc["platform"] == "cpu"
    assert sc["real"]["exact"] and sc["real"]["batches"] > 1
    assert sc["real"]["width"] >= sc["real"]["graph_slots"]
    assert [s["width"] for s in sc["synthetic"]] == [1 << 14, 1 << 16]
    assert all(s["exact"] for s in sc["synthetic"])

    aug = chip_smoke.augment_phase(data, tmp_path)
    assert [r["identical"] for r in aug["replicates"]] == [True, True]
    call = chip_smoke.call_phase(data, tmp_path)
    assert all(r["identical"] and r["rows"] > 0 for r in call["replicates"])
    fin = chip_smoke.finish_phase(data, tmp_path)
    assert fin["quant_rows"] > 0 and fin["remap_rows"] > 0

    # the row comparison is a real check: one changed row breaks it
    dev = tmp_path / "call1.device.csv"
    lines = dev.read_text().splitlines(keepends=True)
    lines[-1] = lines[-1].replace(",", ";", 1)
    dev.write_text("".join(lines))
    assert not chip_smoke.same_rows(dev, tmp_path / "call1.host.csv")


def test_gen_inputs_takes_a_seed(tmp_path):
    kw = dict(mbp=0.05, n_var=200, n_genes=4, n_samples=3, n_chroms=1)
    for name, seed in (("a", 3), ("b", 3), ("c", 4)):
        (tmp_path / name).mkdir()
        stress_build.gen_inputs(tmp_path / name, seed=seed, **kw)
    for f in ("g.fa", "g.vcf"):
        assert filecmp.cmp(tmp_path / "a" / f, tmp_path / "b" / f, shallow=False)
        assert not filecmp.cmp(tmp_path / "a" / f, tmp_path / "c" / f, shallow=False)
