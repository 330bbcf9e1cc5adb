"""chip_smoke.py and bench.py: the GPU-only measurement entry points.

On the CPU both must refuse (nonzero exit, no result printed under a
device's name). Every chip_smoke phase is rehearsed here at TINY sizes on
the CPU backend — the same code path the card runs at BASELINE.json sizes —
and the four-card phases run on four of the suite's virtual CPU devices.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
from types import SimpleNamespace

import jax
import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_without_gpu(script):
    res = _run([os.path.join(REPO, script)], REPO)
    assert res.returncode != 0
    assert res.stdout.strip() == "", res.stdout
    assert "no GPU" in res.stderr


def test_chip_smoke_alone_refuses(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = _run(["chip_smoke.py"], str(tmp_path))
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "not beside this script" in res.stderr


def test_last_line_builder():
    devs = [SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
            ] * 4
    line = cs.last_line(devs)
    assert line == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}
    assert json.loads(json.dumps(line)) == line


def test_four_phase_selection():
    assert cs.phases_for(False) == cs.ONE_CARD_PHASES
    assert cs.phases_for(True) == cs.FOUR_CARD_PHASES
    assert not set(cs.ONE_CARD_PHASES) & set(cs.FOUR_CARD_PHASES)
    assert all(p.startswith("four_") for p in cs.FOUR_CARD_PHASES)
    assert set(cs.PHASES) == set(cs.ONE_CARD_PHASES + cs.FOUR_CARD_PHASES)

def test_check_limits():
    assert cs.check("e", 1e-4, 1e-3)["ok"]
    assert not cs.check("e", 2e-3, 1e-3)["ok"]
    assert cs.check("n", 1024, 1024, kind="min")["ok"]
    assert not cs.check("n", 1000, 1024, kind="min")["ok"]
    c = cs.check("fast", 0.2, 5e-2, gated=False)
    assert not c["ok"] and not c["gated"]


def test_failed_phase_is_reported_not_raised(monkeypatch):
    def boom(ctx):
        raise ValueError("broken phase")
    monkeypatch.setitem(cs.PHASES, "render", boom)
    ctx = cs.Ctx(cs.TINY, 0, "/nonexistent", jax.devices())
    line = cs.run_phase("render", ctx, "card")
    assert line["ok"] is False and "broken phase" in line["error"]


@pytest.fixture
def tiny_ctx():
    work = tempfile.mkdtemp(prefix="chip_smoke_test_")
    yield cs.Ctx(cs.TINY, 0, work, jax.devices())
    shutil.rmtree(work, ignore_errors=True)


@pytest.mark.parametrize("name", cs.ONE_CARD_PHASES + cs.FOUR_CARD_PHASES)
def test_phase_rehearsal_on_cpu(name, tiny_ctx):
    line = cs.run_phase(name, tiny_ctx, "cpu rehearsal")
    assert line["ok"], json.dumps(line, default=str)[:2000]
    assert line["phase"] == name and line["device_kind"]
    json.dumps(line, default=cs._json_default)


@pytest.mark.gpu
def test_render_phase_on_card(gpu_devices, tmp_path):
    ctx = cs.Ctx(cs.TINY, 0, str(tmp_path), gpu_devices)
    line = cs.run_phase("render", ctx, "card")
    assert line["ok"], line


def test_main_prints_phase_lines_then_result(monkeypatch, capsys):
    """main()'s own flow, with the GPU gate pointed at the CPU devices and
    the sizes at TINY: one JSON line per phase, a summary naming the card,
    and the result line last."""
    from spectral_tpu.utils import gpu
    monkeypatch.setattr(gpu, "require_gpu", lambda: jax.devices())
    monkeypatch.setattr(gpu, "card_identity", lambda: "Test Card, 1.00 W")
    monkeypatch.setattr(cs, "FULL", cs.TINY)
    assert cs.main(["--four"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln.get("phase") for ln in lines[:-2]] == list(cs.FOUR_CARD_PHASES)
    assert all(ln["card"] == "Test Card, 1.00 W" for ln in lines[:-1])
    assert lines[-2]["summary"] == "chip_smoke" and lines[-2]["ok"]
    assert lines[-1] == cs.last_line(jax.devices())
