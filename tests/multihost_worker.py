"""Worker for tests/test_multihost.py: one of N OS processes in a real
jax.distributed run (CPU backend, 4 virtual devices per process).

Runs the PRODUCTION first-pass entry (graph.stage.run_graph_first_pass with
parallel.production_mesh()) on a shared read file and writes the artifacts
into its own directory; the parent byte-compares them against a
single-process run. Must be launched with METAMDBG_TPU_DISTRIBUTED=1 and
the METAMDBG_TPU_COORDINATOR/NUM_PROCESSES/PROCESS_ID env vars set.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=4").strip()


def main_polish():
    """polish mode: argv = ('polish', batch.pkl, out.pkl) — run the
    distributed window-POA fan-out (parallel/polish_mesh.py) and dump this
    process's reassembled result list."""
    import pickle

    from metamdbg_tpu import parallel
    from metamdbg_tpu.parallel.polish_mesh import polish_windows_distributed

    parallel.ensure_distributed()
    with open(sys.argv[2], "rb") as f:
        batch = pickle.load(f)
    res = polish_windows_distributed(batch, n_threads=1)
    with open(sys.argv[3], "wb") as f:
        pickle.dump(res, f)
    import jax
    print(f"process {jax.process_index()} polished "
          f"{len(batch)} windows", flush=True)


def main():
    if sys.argv[1] == "polish":
        return main_polish()
    read_file_dir, out_dir, k = sys.argv[1], sys.argv[2], int(sys.argv[3])

    import jax

    from metamdbg_tpu import parallel
    from metamdbg_tpu.graph import stage
    from metamdbg_tpu.utils import devwarm

    parallel.ensure_distributed()
    assert devwarm.init_backend() is not None
    mesh = parallel.production_mesh()
    assert mesh is not None, "mesh must form in a distributed run"
    n_expected = int(os.environ["METAMDBG_TPU_NUM_PROCESSES"]) * 4
    assert mesh.devices.size == n_expected, mesh.devices
    assert jax.process_count() > 1, "distributed init did not happen"

    os.makedirs(out_dir, exist_ok=True)
    reads = stage.load_minimizer_reads(
        os.path.join(read_file_dir, "read_data_corrected.txt"))
    stage.run_graph_first_pass(out_dir, k, 0, reads=reads, mesh=mesh)
    print(f"process {jax.process_index()} done", flush=True)


if __name__ == "__main__":
    main()
