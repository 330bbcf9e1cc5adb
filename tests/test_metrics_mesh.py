"""Coverage fill for parallel/mesh.py and utils/metrics.py (the next two
covlite gaps after r5's native-build/cache fills): device-count refusal,
subset meshes, plain device order, JSON logging, and the
profiler wrappers' failure containment."""

import json
import logging

import jax
import numpy as np
import pytest

from spectral_tpu.parallel import mesh as pm
from spectral_tpu.utils import metrics as mt


# ---- parallel/mesh.py ------------------------------------------------------

def test_make_mesh_default_uses_all_devices():
    m = pm.make_mesh()
    assert m.shape == {"data": len(jax.devices())}


def test_make_mesh_too_many_devices_refuses():
    with pytest.raises(ValueError, match="needs"):
        pm.make_mesh(shape=(10 ** 4,))


def test_make_mesh_subset_and_2d():
    # subset: fewer devices than available -> plain reshape branch
    m = pm.make_mesh(shape=(2,))
    assert m.shape == {"data": 2}
    m2 = pm.make_mesh(shape=(2, 2), axis_names=("data", "time"))
    assert m2.shape == {"data": 2, "time": 2}


def test_make_mesh_topology_helper_fallback():
    """No topology helper: the cards of one host are joined all to all, so
    every mesh — all devices or a subset, 1-D or 2-D — is a plain reshape
    of jax.devices() in order."""
    devs = jax.devices()
    m = pm.make_mesh(shape=(len(devs),))
    assert list(m.devices.ravel()) == list(devs)
    m2 = pm.make_mesh(shape=(2, 2), axis_names=("data", "time"))
    assert list(m2.devices.ravel()) == list(devs[:4])


def test_batch_sharding_spec():
    from jax.sharding import PartitionSpec as P
    m = pm.make_mesh()
    sh = pm.batch_sharding(m, ndim=3)
    assert sh.spec == P("data", None, None)


# ---- utils/metrics.py ------------------------------------------------------

@pytest.fixture
def fresh_logger():
    saved = list(mt.logger.handlers)
    mt.logger.handlers = []
    yield mt.logger
    mt.logger.handlers = saved


def test_configure_logging_plain_and_idempotent(fresh_logger):
    mt.configure_logging(level=logging.DEBUG)
    assert len(fresh_logger.handlers) == 1
    # second call only adjusts the level, never stacks handlers
    mt.configure_logging(level=logging.WARNING)
    assert len(fresh_logger.handlers) == 1
    assert fresh_logger.level == logging.WARNING


def test_configure_logging_json_lines(fresh_logger):
    mt.configure_logging(json_lines=True)
    fmt = fresh_logger.handlers[0].formatter
    rec = logging.LogRecord("spectral_tpu", logging.INFO, __file__, 1,
                            "hello", None, None)
    payload = json.loads(fmt.format(rec))
    assert payload["msg"] == "hello" and payload["lvl"] == "INFO"
    # dict args merge into the payload (structured logging; logging
    # unwraps a single-mapping args tuple to the mapping itself)
    rec2 = logging.LogRecord("spectral_tpu", logging.INFO, __file__, 1,
                             "m", ({"clips": 3},), None)
    assert json.loads(fmt.format(rec2))["clips"] == 3


def test_throughput_meter_units():
    m = mt.ThroughputMeter()
    m.add(16000 * 60, fs=16000.0, n_frames=100)
    r = m.report()
    assert r["audio_hours"] == pytest.approx(1 / 60.0, abs=1e-4)
    assert r["frames_per_s"] > 0 and r["wall_s"] >= 0  # rounds to 0.0 fast


def test_timed_context(fresh_logger, caplog):
    with caplog.at_level(logging.INFO, logger="spectral_tpu"):
        with mt.timed("stage") as out:
            np.zeros(4).sum()
    assert out["seconds"] >= 0
    assert any("stage took" in r.message for r in caplog.records)


def test_trace_annotation_and_profiler_wrappers(tmp_path, monkeypatch):
    # the annotation is a no-op wrapper; body must run either way
    ran = []
    with mt.trace_annotation("x"):
        ran.append(1)
    assert ran == [1]
    # profiler start failure is contained, not raised
    import jax.profiler as jp

    def boom(*a, **k):
        raise RuntimeError("no profiler backend")
    monkeypatch.setattr(jp, "start_trace", boom)
    assert mt.start_profiler_trace(str(tmp_path)) is False
    monkeypatch.setattr(jp, "stop_trace", boom)
    mt.stop_profiler_trace()                      # must not raise

