"""fork_map workers and native OpenMP engines."""

import os
import subprocess
import sys

import numpy as np

from metamdbg_tpu.utils.forkmap import fork_map, native_threads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_native_threads_is_one_in_worker():
    assert native_threads(8) == 8
    assert native_threads() == (os.cpu_count() or 1)
    assert fork_map(lambda n: native_threads(n), [8, 8, 8, 8], 4) == [1] * 4


_ENGINE_AFTER_FORK = """
import numpy as np
from metamdbg_tpu.sketch import native_sketch
from metamdbg_tpu.utils.forkmap import fork_map
assert native_sketch.available()
rng = np.random.default_rng(0)
codes = [rng.integers(0, 4, 5000).astype(np.uint8) for _ in range(64)]
bads = [np.zeros(5000, bool) for _ in codes]
def run(_):
    return [v.tolist() for v, _, _ in native_sketch.sketch_batch_native(
        codes, bads, 15, 0.02, n_threads=4)]
want = run(0)  # the parent's OpenMP team exists before the fork
assert fork_map(run, [0, 1, 2, 3], 4) == [want] * 4
print("ok")
"""


def test_openmp_engine_in_worker_after_parent_team():
    """A worker forked after the parent ran an OpenMP team must not start
    a team of its own (libgomp's pool does not survive fork: it hangs)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", _ENGINE_AFTER_FORK],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")
