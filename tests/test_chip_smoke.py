"""``chip_smoke.py`` refuses to report without a GPU or without the
repository, and holds every family it checks to a stated floor."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(cwd: Path, script: Path) -> subprocess.CompletedProcess:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _no_ok_line(out: str) -> bool:
    for line in out.splitlines():
        try:
            if json.loads(line).get("ok"):
                return False
        except (ValueError, AttributeError):
            continue
    return True


@pytest.mark.parametrize("alone", [False, True])
def test_fails_without_gpu_or_repo(tmp_path, alone):
    script = ROOT / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    r = _run(script.parent, script)
    assert r.returncode != 0
    assert _no_ok_line(r.stdout)


def test_every_family_has_a_floor():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    assert set(chip_smoke.RECALL_FLOOR) == set(chip_smoke.FAMILIES) | {
        "ivpq_join"}
    assert all(0.0 < v <= 1.0 for v in chip_smoke.RECALL_FLOOR.values())
