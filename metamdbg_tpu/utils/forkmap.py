"""Minimal fork-based parallel map for CPU-bound host stages.

multiprocessing.Pool costs seconds per use here: terminate/join wrangles
handler threads, and cleanly-exiting children run inherited interpreter
teardown (a hazard once the parent holds a live device client). This
utility forks workers directly: inputs reach children by copy-on-write
(nothing is pickled inward), each child writes its pickled results to a
pipe and dies via os._exit (no atexit, no teardown), the parent reads in
worker order so the result list is exactly [fn(x) for x in items].

Any child failure falls back to recomputing everything sequentially —
callers rely on deterministic output, never on partial parallel results.

Children must not start OpenMP teams: libgomp's thread pool does not
survive fork(), so a parallel region of more than one thread in a forked
child waits forever for the parent's pool threads. Native engine wrappers
size their teams with `native_threads`, which is 1 inside a worker.
"""

import logging
import os
import pickle

log = logging.getLogger("metamdbg_tpu")

_in_worker = False


def native_threads(n_threads: "int | None" = None) -> int:
    """OpenMP team size for a native engine call: `n_threads` (None: all
    cores), or 1 inside a fork_map worker."""
    if _in_worker:
        return 1
    return int(n_threads) if n_threads is not None else (os.cpu_count() or 1)


def fork_map(fn, items, n_workers: int):
    """Parallel [fn(x) for x in items] over forked workers (order kept)."""
    items = items if isinstance(items, list) else list(items)
    n = min(int(n_workers), len(items))
    if n <= 1 or not hasattr(os, "fork"):
        return [fn(x) for x in items]

    step = (len(items) + n - 1) // n
    bounds = [(w * step, min((w + 1) * step, len(items))) for w in range(n)]
    procs = []
    ok = True
    for lo, hi in bounds:
        try:
            r, w = os.pipe()
            pid = os.fork()
        except OSError as exc:
            log.warning("fork_map: fork failed (%s); sequential", exc)
            ok = False
            break
        if pid == 0:
            global _in_worker
            _in_worker = True
            code = 0
            try:
                os.close(r)
                payload = pickle.dumps([fn(items[i]) for i in range(lo, hi)],
                                       protocol=pickle.HIGHEST_PROTOCOL)
                with os.fdopen(w, "wb") as f:
                    f.write(payload)
            except BaseException:
                code = 1
            finally:
                os._exit(code)
        os.close(w)
        procs.append((pid, r))

    out = []
    for pid, r in procs:
        data = b""
        try:
            with os.fdopen(r, "rb") as f:
                data = f.read()
        finally:
            _, status = os.waitpid(pid, 0)
        if not ok:
            continue
        if status != 0:
            log.warning("fork_map: worker exit status %d; sequential", status)
            ok = False
            continue
        try:
            out.extend(pickle.loads(data))
        except Exception as exc:
            log.warning("fork_map: result decode failed (%s); sequential",
                        exc)
            ok = False
    if not ok:
        return [fn(x) for x in items]
    return out
