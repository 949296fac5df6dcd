"""Backend set-up and host/device routing for the compute stages.

Every stage with a device kernel also has a bit-identical host twin, so
where a batch runs changes its speed, never its output. `init_backend()`
opens the default JAX backend once, on the calling thread, and records its
platform, device kind and device count. `gate(context, items)` then routes
each batch of a stage:

- under METAMDBG_TPU_HOST_ONLY to the host (the oracle run; no device is
  ever opened);
- under METAMDBG_TPU_REQUIRE_DEVICE to the device;
- otherwise to whichever side is measured faster for that context. Each
  context keeps seconds-per-item EWMAs for both sides, calibrates them on
  its first batches, and re-tries the losing side every `_EXPLORE_EVERY`
  batches, so a side that got faster is found again.

A device batch that raises propagates to the caller: there is no fallback
to the host. `telemetry()` is the per-run record written to
tmp/device.json.
"""

import json
import logging
import os
import time

log = logging.getLogger("metamdbg_tpu")

_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")

_CAL_BATCHES = 3             # observations per mode before trusting EWMAs
_EXPLORE_EVERY = 64          # re-try the losing mode every N batches
_DEVICE_WIN_MARGIN = 0.95    # device must be a measured >=5% win
_EWMA_ALPHA = 0.35

_backend: "dict | None" = None   # platform, device_kind, device_count
_ctx: dict = {}                  # context -> _CtxStats


class _CtxStats:
    __slots__ = ("n_dev", "n_host", "dev_spi", "host_spi", "since_explore")

    def __init__(self):
        self.n_dev = 0
        self.n_host = 0
        self.dev_spi = None     # EWMA seconds-per-item, device batches
        self.host_spi = None
        self.since_explore = 0

    def observe(self, device: bool, items: int, seconds: float):
        spi = seconds / max(items, 1)
        if device:
            self.n_dev += 1
            self.dev_spi = spi if self.dev_spi is None else \
                (1 - _EWMA_ALPHA) * self.dev_spi + _EWMA_ALPHA * spi
        else:
            self.n_host += 1
            self.host_spi = spi if self.host_spi is None else \
                (1 - _EWMA_ALPHA) * self.host_spi + _EWMA_ALPHA * spi


def _stats(context: str) -> _CtxStats:
    st = _ctx.get(context)
    if st is None:
        st = _ctx[context] = _CtxStats()
    return st


def _host_only() -> bool:
    return bool(os.environ.get("METAMDBG_TPU_HOST_ONLY"))


def enable_compile_cache():
    """Point JAX's persistent compilation cache at one fixed directory.

    When JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and this
    sets nothing. Otherwise the cache lives in `.jax_cache` at the root of
    the checkout, a path that does not depend on the working directory,
    the platform, the process or the time, so every run finds it again.
    Must run before the first compile to take effect."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax
    jax.config.update("jax_compilation_cache_dir", _CACHE_DIR)


def init_backend() -> "dict | None":
    """Open the default JAX backend once and return its description
    (None under METAMDBG_TPU_HOST_ONLY). Errors opening it propagate."""
    global _backend
    if _host_only():
        return None
    if _backend is None:
        # multi-host runs must initialize jax.distributed before any XLA call
        from ..parallel import ensure_distributed
        ensure_distributed()
        enable_compile_cache()
        import jax
        devices = jax.devices()
        _backend = {"platform": devices[0].platform,
                    "device_kind": devices[0].device_kind,
                    "device_count": len(devices)}
        log.info("JAX backend: %s (%s) x%d", _backend["platform"],
                 _backend["device_kind"], _backend["device_count"])
    return _backend


def reset_telemetry():
    """Forget the per-context routing record (a new pipeline run)."""
    _ctx.clear()


def use_device(context: str) -> bool:
    """Device unless host-only, for a context whose host twin runs lazily
    later (so there is no batch wall to calibrate against)."""
    device = not _host_only()
    if device:
        init_backend()
    st = _stats(context)
    if device:
        st.n_dev += 1
    else:
        st.n_host += 1
    return device


class _Gate:
    """Context manager for one calibrated batch: `.device` says where to
    run; the batch wall is recorded into the per-mode EWMA on exit."""

    __slots__ = ("context", "items", "device", "_t0")

    def __init__(self, context: str, items: int, device: bool):
        self.context = context
        self.items = items
        self.device = device
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            _stats(self.context).observe(
                self.device, self.items, time.perf_counter() - self._t0)
        return False


def gate(context: str, items: int) -> _Gate:
    """Route one batch of `items` work units for `context`.

    Returns a context manager whose `.device` attribute is the routing
    decision; run the device path or its bit-identical host twin under it
    and the batch wall feeds the calibration. Default policy: alternate
    the modes (host first) until each has `_CAL_BATCHES` measurements, then
    take the measured faster mode (the device needs a >=5% margin), with
    one batch of the losing mode every `_EXPLORE_EVERY` batches."""
    if _host_only():
        return _Gate(context, items, False)
    init_backend()
    if os.environ.get("METAMDBG_TPU_REQUIRE_DEVICE"):
        return _Gate(context, items, True)
    st = _stats(context)
    need_host = st.n_host < _CAL_BATCHES or st.host_spi is None
    need_dev = st.n_dev < _CAL_BATCHES or st.dev_spi is None
    if need_host or need_dev:
        if need_host and need_dev:
            return _Gate(context, items, st.n_dev < st.n_host)
        return _Gate(context, items, need_dev)
    dev_wins = st.dev_spi < st.host_spi * _DEVICE_WIN_MARGIN
    st.since_explore += 1
    if st.since_explore >= _EXPLORE_EVERY:
        st.since_explore = 0
        return _Gate(context, items, not dev_wins)
    return _Gate(context, items, dev_wins)


def telemetry() -> dict:
    """Routing snapshot: mode, backend, per-context batches and rates."""
    if _host_only():
        mode = "host-only"
    elif os.environ.get("METAMDBG_TPU_REQUIRE_DEVICE"):
        mode = "device-required"
    else:
        mode = "device-auto"
    return {
        "device_mode": mode,
        "backend": None if _host_only() else _backend,
        "contexts": {
            name: {
                "device_batches": st.n_dev,
                "host_batches": st.n_host,
                "device_s_per_item": st.dev_spi,
                "host_s_per_item": st.host_spi,
            }
            for name, st in sorted(_ctx.items())
        },
    }


def dump_telemetry(path: str):
    """Write the telemetry snapshot as JSON."""
    with open(path, "w") as f:
        json.dump(telemetry(), f, indent=1)
