"""Communication-pattern guards on the compiled sharded programs.

Pixel/value parity tests cannot catch a sharding regression: if an
in_spec change makes XLA all-gather the whole batch onto every device,
the numbers still match — only the HLO (and the interconnect bill at scale)
reveals it. These tests compile the sharded entry points on the 8-device
CPU mesh and assert the collective inventory the designs promise:

* dp export pipeline — embarrassingly parallel, ZERO collectives;
* share_max pipeline — the shared normalization base is the only
  cross-device value: all-reduces of SCALARS, nothing else;
* sharded EM step — one tupled all-reduce of the sufficient statistics
  (shapes bounded by (K, K)); the (B, T, D) data is never gathered.

(How-to-Scale-Your-Model discipline: pick shardings so the collectives
ride tiny reductions, then pin that in a test.)
"""

import re

import numpy as np
import pytest
import jax

from spectral_tpu.config import SpecConfig
from spectral_tpu.models import hmm

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs the 8-device test mesh")

_COLLECTIVE = re.compile(
    r"=\s*(\(?[^)=]*\)?)\s*(all-gather|all-reduce|all-to-all|"
    r"reduce-scatter|collective-permute)(?:-start)?\(")
_SHAPE = re.compile(r"[a-z0-9]+\[([\d,]*)\]")


def _collectives(compiled_text):
    """[(op, [shape dims...])] for every collective op definition."""
    out = []
    for m in _COLLECTIVE.finditer(compiled_text):
        shapes = [tuple(int(d) for d in g.split(",") if d)
                  for g in _SHAPE.findall(m.group(1))]
        out.append((m.group(2), shapes))
    return out


def _mesh():
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:8]).reshape(8), ("data",))


def test_dp_export_pipeline_has_zero_collectives():
    from spectral_tpu.parallel.sharding import shard_pipeline
    fn = shard_pipeline(_mesh(), 1000.0,
                        SpecConfig.north_star(256, 128, log_scale=True))
    x = jax.ShapeDtypeStruct((16, 4000), np.float32)
    txt = fn.lower(x).compile().as_text()
    assert _collectives(txt) == []


def test_share_max_pipeline_reduces_only_scalars():
    from spectral_tpu.parallel.sharding import shard_pipeline
    fn = shard_pipeline(_mesh(), 1000.0,
                        SpecConfig.north_star(256, 128, log_scale=True),
                        share_max=True)
    x = jax.ShapeDtypeStruct((16, 4000), np.float32)
    cols = _collectives(fn.lower(x).compile().as_text())
    assert cols, "share_max must communicate the shared base"
    for op, shapes in cols:
        assert op == "all-reduce", cols
        assert all(s == () for s in shapes), \
            f"share_max should reduce scalars, got {cols}"


def test_freq_tp_pipeline_shards_the_contraction():
    # dp x tp (freq_axis='model'): the DFT contraction itself must be
    # partitioned over frequency — the compiled program must contain a dot
    # whose output frequency dim is the PER-SHARD size, and the only
    # collectives are the output-boundary all-gathers of freq shards (plus
    # scalar/row reductions for normalization) — never a gather of
    # anything bigger than one output tensor's shard.
    from spectral_tpu.parallel.mesh import make_mesh
    from spectral_tpu.parallel.sharding import shard_pipeline
    from spectral_tpu.core.stft import num_frames

    mesh = make_mesh((4, 2), ("data", "model"))
    cfg = SpecConfig.north_star(510, 128, log_scale=True)  # F=256: 2 | F
    fn = shard_pipeline(mesh, 1000.0, cfg, freq_axis="model")
    B, n = 16, 4000
    txt = fn.lower(jax.ShapeDtypeStruct((B, n), np.float32)).compile(
    ).as_text()

    T = num_frames(n, 510, 128)
    F, F_shard, B_shard = 256, 128, B // 4
    # a dot producing the per-shard freq block proves tp took hold: XLA
    # flattens the freq-major einsum to (B_shard*T, F_shard) — observed
    # "%dot.2 = f32[112,128] dot(...)" with the DFT matrix rhs coming from
    # a dynamic-slice fusion (each chip slices only its own matrix rows)
    per_shard_dot = re.compile(
        rf"=\s*f32\[{B_shard * T},{F_shard}\](?:\{{[\d,]*\}})?\s*dot\(")
    assert per_shard_dot.search(txt), \
        "no per-shard DFT contraction found — tp constraint ignored"
    cols = _collectives(txt)
    assert any(op == "all-gather" for op, _ in cols), \
        "freq shards must be gathered at the batch-sharded output boundary"
    per_shard_out = B_shard * F * T            # one gathered output tensor
    for op, shapes in cols:
        # collective-permute: the packed image's row flip over the SHARDED
        # freq axis — jnp.flip across shards lowers to a ppermute swapping
        # shard pairs (one shard-sized u32 block), the textbook lowering
        assert op in ("all-gather", "all-reduce", "collective-permute"), cols
        for s in shapes:
            assert np.prod(s, dtype=int) <= per_shard_out, \
                f"collective moves more than an output gather: {cols}"


def test_sharded_em_step_reduces_only_sufficient_stats():
    from spectral_tpu.parallel.distributed_em import make_sharded_em_step
    step = make_sharded_em_step(_mesh())
    K, D, B, T = 4, 2, 16, 64
    p = hmm.HMMParams(jax.ShapeDtypeStruct((K,), np.float32),
                      jax.ShapeDtypeStruct((K, K), np.float32),
                      jax.ShapeDtypeStruct((K, D), np.float32),
                      jax.ShapeDtypeStruct((K, D), np.float32))
    X = jax.ShapeDtypeStruct((B, T, D), np.float32)
    cols = _collectives(step.lower(p, X).compile().as_text())
    assert cols, "the sharded E-step must all-reduce its statistics"
    for op, shapes in cols:
        assert op == "all-reduce", cols
        for s in shapes:
            assert np.prod(s, dtype=int) <= K * K, \
                f"collective moves more than sufficient stats: {cols}"


def test_time_sharded_stft_moves_only_the_halo():
    # sequence parallelism over one recording's sample axis: the ONLY
    # cross-chip traffic is the nearest-neighbour halo exchange of
    # nperseg - hop samples (a collective-permute) — never an all-gather
    # of the signal or the spectrogram. The tail-frame zeroing and the
    # per-shard framing are all local.
    from spectral_tpu.parallel.sharding import time_sharded_spectrogram
    cfg = SpecConfig.north_star(256, 64)           # halo = 192
    fn = time_sharded_spectrogram(_mesh(), 1000.0, cfg)
    txt = fn.lower(
        jax.ShapeDtypeStruct((8 * 1024,), np.float32)).compile().as_text()
    cols = _collectives(txt)
    assert cols, "the overlapped framing must exchange a halo"
    for op, shapes in cols:
        assert op == "collective-permute", cols
        for s in shapes:
            assert np.prod(s, dtype=int) <= 192, \
                f"halo exchange moves more than nperseg-hop samples: {cols}"
    # no-overlap framing (hop == nperseg): embarrassingly parallel,
    # zero collectives
    fn0 = time_sharded_spectrogram(_mesh(), 1000.0,
                                   SpecConfig.north_star(128, 128))
    txt0 = fn0.lower(
        jax.ShapeDtypeStruct((8 * 512,), np.float32)).compile().as_text()
    assert _collectives(txt0) == []
