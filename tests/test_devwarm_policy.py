"""Device routing (utils/devwarm): the calibrated gate, the host-only and
required-device modes, the per-run record in tmp/device.json, the
persistent compile cache location, and device errors that propagate
instead of falling back to the host."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from metamdbg_tpu.utils import devwarm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def reset_devwarm(monkeypatch):
    """Isolate each test from devwarm's module-level state."""
    monkeypatch.setattr(devwarm, "_ctx", {})
    monkeypatch.delenv("METAMDBG_TPU_HOST_ONLY", raising=False)
    monkeypatch.delenv("METAMDBG_TPU_REQUIRE_DEVICE", raising=False)
    return monkeypatch


def _calibrate(context, device_s, host_s):
    for _ in range(devwarm._CAL_BATCHES * 2):
        with devwarm.gate(context, 1000) as g:
            time.sleep(device_s if g.device else host_s)


def test_require_device_overrides_slow_gate(reset_devwarm):
    _calibrate("t-ctx", device_s=0.01, host_s=0.001)
    with devwarm.gate("t-ctx", 100) as g:
        assert g.device is False        # calibrated: host is faster
    reset_devwarm.setenv("METAMDBG_TPU_REQUIRE_DEVICE", "1")
    assert devwarm.use_device("t-ctx") is True
    with devwarm.gate("t-ctx", 100) as g:
        assert g.device is True


def test_host_only_never_probes(reset_devwarm):
    def boom():
        raise AssertionError("host-only must never open the backend")

    reset_devwarm.setattr(devwarm, "init_backend", boom)
    reset_devwarm.setenv("METAMDBG_TPU_HOST_ONLY", "1")
    assert devwarm.use_device("t-ctx") is False
    with devwarm.gate("t-ctx", 100) as g:
        assert g.device is False
    assert devwarm.telemetry()["backend"] is None


def test_gate_calibrates_then_picks_faster_mode(reset_devwarm):
    modes = []
    # device batches measure 10x slower per item than host batches
    for _ in range(devwarm._CAL_BATCHES * 2):
        with devwarm.gate("cal-ctx", 1000) as g:
            modes.append(g.device)
            time.sleep(0.01 if g.device else 0.001)
    # calibration interleaved both modes, host first
    assert modes[0] is False and any(modes) and not all(modes)
    # steady state: host wins (device is 10x slower)
    decisions = []
    for _ in range(8):
        with devwarm.gate("cal-ctx", 1000) as g:
            decisions.append(g.device)
            time.sleep(0.01 if g.device else 0.001)
    assert not any(decisions)
    tel = devwarm.telemetry()["contexts"]["cal-ctx"]
    assert tel["host_batches"] > tel["device_batches"]
    assert tel["device_s_per_item"] > tel["host_s_per_item"]


def test_gate_prefers_device_when_measured_faster(reset_devwarm):
    _calibrate("dev-ctx", device_s=0.001, host_s=0.01)
    decisions = []
    for _ in range(8):
        with devwarm.gate("dev-ctx", 1000) as g:
            decisions.append(g.device)
            time.sleep(0.001 if g.device else 0.01)
    assert all(decisions)


def test_gate_explores_losing_mode(reset_devwarm):
    _calibrate("ex-ctx", device_s=0.004, host_s=0.001)
    seen_device = 0
    for _ in range(devwarm._EXPLORE_EVERY + 2):
        with devwarm.gate("ex-ctx", 1000) as g:
            seen_device += g.device
            time.sleep(0.004 if g.device else 0.001)
    assert seen_device >= 1  # the loser is re-tried periodically


def test_device_json_records_backend(reset_devwarm, tmp_path):
    import jax

    devwarm.init_backend()
    path = tmp_path / "device.json"
    devwarm.dump_telemetry(str(path))
    tel = json.loads(path.read_text())
    dev = jax.devices()
    assert tel["device_mode"] == "device-auto"
    assert tel["backend"] == {"platform": dev[0].platform,
                              "device_kind": dev[0].device_kind,
                              "device_count": len(dev)}


_CACHE_PROBE = """
import jax, jax.numpy as jnp
from metamdbg_tpu.utils import devwarm
devwarm.enable_compile_cache()
jax.jit(lambda x: jnp.sin(x) * 3 + 1)(jnp.arange(8.0)).block_until_ready()
print(jax.config.jax_compilation_cache_dir)
"""


def _cache_dir_from(cwd, env_dir=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"] = "0"
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    out = subprocess.run([sys.executable, "-c", _CACHE_PROBE], cwd=cwd,
                         env=env, capture_output=True, text=True, timeout=120,
                         check=True)
    return out.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("env_set", [True, False], ids=["env", "default"])
def test_compile_cache_dir(tmp_path, env_set):
    if env_set:
        want = str(tmp_path / "jaxcache")
        assert _cache_dir_from(str(tmp_path), want) == want
        assert os.listdir(want), "nothing was cached in the env directory"
    else:
        a = tmp_path / "a"
        b = tmp_path / "b"
        a.mkdir()
        b.mkdir()
        got_a = _cache_dir_from(str(a))
        assert got_a == _cache_dir_from(str(b))
        assert got_a == os.path.join(REPO, ".jax_cache")


# -- a device batch that raises makes its stage raise (no host fallback) ---

class _DeviceBoom(RuntimeError):
    pass


def _boom(*_a, **_k):
    raise _DeviceBoom("device kernel failed")


def _overlapping_minimizer_reads(n_reads=12, seed=5):
    rng = np.random.default_rng(seed)
    base = rng.integers(1, 1 << 30, size=400, dtype=np.uint32)
    base_pos = np.cumsum(rng.integers(150, 250, size=400)).astype(np.uint32)
    reads = []
    for i in range(n_reads):
        a = int(rng.integers(0, 200))
        b = a + 150
        reads.append((base[a:b].copy(), (base_pos[a:b] - base_pos[a]).copy()))
    return reads


def _stage_batch_sketching(mp, tmp_path):
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import datagen

    from metamdbg_tpu.pipeline.asm import Pipeline
    from metamdbg_tpu.sketch import batch, read_selection

    fq = str(tmp_path / "reads.fastq")
    datagen.make_test_fastq(fq, genome_len=20_000, coverage=3,
                            mean_length=3000, seed=3)
    mp.setattr(batch.BatchSketcher, "sketch_many", _boom)
    pipe = Pipeline(str(tmp_path / "out"), [fq])
    pipe.mean_read_length = 0
    read_selection.run_read_selection([fq], pipe.tmp_dir,
                                      pipe.make_params(4, 4))


def _stage_row_counting(mp, tmp_path):
    from metamdbg_tpu.count import kminmers
    from metamdbg_tpu.kernels import count_jax

    mp.setattr(kminmers, "_DEVICE_COUNT_MIN_ROWS", 1)
    mp.setattr(count_jax, "count_unique_rows_device", _boom)
    reads = [m for m, _ in _overlapping_minimizer_reads()]
    kminmers.count_kminmers(reads, 4)


def _stage_correction_chain(mp, tmp_path):
    from metamdbg_tpu.correction import mapper
    from metamdbg_tpu.io import records
    from metamdbg_tpu.kernels import chain_jax

    mp.setattr(chain_jax, "chain_dp_device", _boom)
    reads = [records.MinimizerRead(i, m, p, np.zeros(m.shape[0], np.uint8),
                                   None)
             for i, (m, p) in enumerate(_overlapping_minimizer_reads())]
    mapper.run_read_mapper(reads, 10_000, 62)


def _stage_contig_chain(mp, tmp_path):
    from metamdbg_tpu.basespace import contig_mapper
    from metamdbg_tpu.io import records
    from metamdbg_tpu.kernels import chain_jax

    mp.setattr(chain_jax, "chain_contig_device", _boom)
    reads = _overlapping_minimizer_reads()
    contig_file = str(tmp_path / "contigs.bin")
    read_file = str(tmp_path / "reads.bin")
    with records.ReadDataWriter(contig_file, with_quality=False) as w:
        w.write(records.MinimizerRead(0, reads[0][0], None, None, None))
    with records.ReadDataWriter(read_file, with_quality=True) as w:
        for i, (m, p) in enumerate(reads):
            w.write(records.MinimizerRead(
                i, m, p, np.zeros(m.shape[0], np.uint8),
                np.full(m.shape[0], 30, np.uint8), 30.0, int(p[-1]) + 100))
    contig_mapper.map_reads_to_contigs(read_file, contig_file,
                                       str(tmp_path / "out.bin"), 200.0)


def _stage_tiling_sketch(mp, tmp_path):
    from metamdbg_tpu.basespace import tiling
    from metamdbg_tpu.sketch import batch, native_sketch

    mp.setattr(native_sketch, "available", lambda: False)
    mp.setattr(batch.BatchSketcher, "sketch_many", _boom)
    rng = np.random.default_rng(1)
    reads = {i: np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 3000)]
             for i in range(3)}
    tiling.ContigTiler(reads, 200.0, 1000).prewarm_sketches([0, 1, 2])


_STAGES = {
    "batch sketching": _stage_batch_sketching,
    "device row counting": _stage_row_counting,
    "correction chain DP": _stage_correction_chain,
    "contig chain DP": _stage_contig_chain,
    "tiling batch sketching": _stage_tiling_sketch,
}


@pytest.mark.parametrize("context", sorted(_STAGES))
def test_device_error_propagates(reset_devwarm, tmp_path, context):
    reset_devwarm.setenv("METAMDBG_TPU_REQUIRE_DEVICE", "1")
    routed = []
    real_gate, real_use = devwarm.gate, devwarm.use_device

    def spy_gate(ctx, items):
        routed.append(ctx)
        return real_gate(ctx, items)

    def spy_use(ctx):
        routed.append(ctx)
        return real_use(ctx)

    reset_devwarm.setattr(devwarm, "gate", spy_gate)
    reset_devwarm.setattr(devwarm, "use_device", spy_use)
    with pytest.raises(_DeviceBoom):
        _STAGES[context](reset_devwarm, tmp_path)
    assert context in routed
