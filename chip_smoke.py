"""On-chip smoke test of `python -m metamdbg_tpu asm` on a CUDA GPU.

    python chip_smoke.py              # one card: phases 0-3
    python chip_smoke.py --cards 4    # four cards: the mesh path only

Phase 0 checks the environment (nvidia-smi, a CUDA backend) and rebuilds
the native host libraries from the committed sources. Phase 1 runs the
`gpu`-marked tests (tests/test_gpu_kernels.py) in this process: every
device kernel at production shapes against its host twin, bitwise.
Phases 2 (HiFi) and 3 (ONT) generate a synthetic metagenome from its seed
(tools/scale_run.py DATASETS, tests/datagen.py), assemble it three ways
through the CLI entry point -- every gate on the device, the default
calibrated routing, and a host-only child process that never opens the
card -- and compare the outputs byte for byte.

With --cards 4 the script runs only what exists across cards: the ONT
assembly with the first-pass count table and the correction pair join on
a 4-GPU mesh, its host-only twin, and __graft_entry__.dryrun_multichip(4).

The device runs happen in this process, so one process holds the card(s);
the host-only child runs with JAX_PLATFORMS=cpu. Every line but the last
is a JSON object with a `phase` key; the last line is the result. Any
failure exits non-zero before the result is printed.
"""

import argparse
import contextlib
import glob
import gzip
import hashlib
import json
import logging
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke")
OUT = os.path.join(ROOT, "chiprun_out", "smoke")

# Genome counts kept from each tools/scale_run.py data set (the smallest
# genomes, last in its list): what fits one card's run in the time limit.
HIFI_GENOMES = 7        # 315 Mbp of the set's 1105.5 Mbp
ONT_GENOMES = 2         # 127.5 Mbp of the set's 533.5 Mbp
MIN_MBP = {"hifi": 300, "ont": 80}

_T0 = time.perf_counter()


def emit(phase: str, file_only=None, **fields):
    """Print one JSON record; OUT/smoke.jsonl also gets `file_only`."""
    fields = {"phase": phase, **fields,
              "elapsed_s": time.perf_counter() - _T0}
    print(json.dumps(fields), flush=True)
    with open(os.path.join(OUT, "smoke.jsonl"), "a") as f:
        f.write(json.dumps({**fields, **(file_only or {})}) + "\n")


def result_line(devices) -> str:
    """The contract's last line for the JAX devices the run used."""
    d = devices[0]
    if d.platform != "gpu":
        raise RuntimeError(f"expected a CUDA GPU, JAX reports {d.platform}")
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def dataset_plan(platform: str, n_genomes: int) -> dict:
    """The genomes kept from a tools/scale_run.py data set and its size."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import scale_run

    cfg = scale_run.DATASETS[platform]
    n_all = len(cfg["sizes"])
    kept = list(range(n_all - n_genomes, n_all))
    mbp = [cfg["sizes"][i] * cfg["coverages"][i] / 1e6 for i in range(n_all)]
    plan = {"platform": platform, "genomes": kept, "of": n_all,
            "read_mbp": sum(mbp[i] for i in kept),
            "full_read_mbp": sum(mbp), "cfg": cfg}
    if plan["read_mbp"] < MIN_MBP[platform]:
        raise ValueError(f"{platform} cut to {plan['read_mbp']} Mbp, below "
                         f"{MIN_MBP[platform]} Mbp")
    return plan


def write_reads(plan: dict, path: str):
    """Reads of the kept genomes, exactly as datagen.metagenome_reads
    samples them for the whole set (per-genome seeds)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import datagen

    cfg = plan["cfg"]
    genomes = datagen.make_metagenome(n_genomes=len(cfg["sizes"]),
                                      sizes=cfg["sizes"], seed=cfg["seed"])
    n_bases = 0
    with open(path, "wb", buffering=1 << 24) as f:
        for gi in plan["genomes"]:
            for rid, (_, seq, qual) in enumerate(datagen.sample_reads(
                    genomes[gi], cfg["coverages"][gi], cfg["mean_len"],
                    cfg["error_rate"], seed=cfg["seed"] + 1 + gi,
                    mean_quality=cfg["mean_q"], ins_rate=cfg["ins"],
                    del_rate=cfg["dele"])):
                f.write(b"@g%d_%d\n" % (gi, rid) + seq.tobytes() + b"\n+\n"
                        + qual.tobytes() + b"\n")
                n_bases += seq.shape[0]
    return n_bases


class _CompileCounter:
    """Counts XLA backend compiles (and their seconds) in this process."""

    def __init__(self):
        import jax
        self.n = 0
        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, name, secs, **_kw):
        if name == "/jax/core/compile/backend_compile_duration":
            self.n += 1
            self.seconds += secs

    def snapshot(self):
        return self.n, self.seconds


class _ForkGuard(logging.Handler):
    """Runs every fork_map child under a transfer guard that refuses any
    host<->device transfer, and records fork_map's warnings: a child that
    touched JAX fails, and fork_map then logs it and recomputes."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.forking_calls = 0
        self.warnings = []
        from metamdbg_tpu.utils import forkmap
        real = forkmap.fork_map

        def guarded(fn, items, n_workers):
            import jax
            items = items if isinstance(items, list) else list(items)
            if min(int(n_workers), len(items)) > 1:
                self.forking_calls += 1

            def child(x):
                with jax.transfer_guard("disallow_explicit"):
                    return fn(x)
            return real(child, items, n_workers)

        forkmap.fork_map = guarded
        logging.getLogger("metamdbg_tpu").addHandler(self)

    def emit(self, record):
        if record.getMessage().startswith("fork_map:"):
            self.warnings.append(record.getMessage())


def _count_calls(*targets) -> dict:
    """Wrap module-level functions to count their calls (by name)."""
    import importlib

    calls = {}
    for mod_name, fn_name in targets:
        mod = importlib.import_module(mod_name)
        real = getattr(mod, fn_name)
        calls[fn_name] = 0

        def counted(*a, _real=real, _name=fn_name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        setattr(mod, fn_name, counted)
    return calls


def _spans(out_dir: str) -> list:
    spans = []
    with open(os.path.join(out_dir, "tmp", "memoryTrack.txt")) as f:
        for line in f:
            name, secs, rss = line.rstrip("\n").split("\t")
            spans.append([name, float(secs.rstrip("s")),
                          float(rss.rstrip("GB"))])
    return spans


def _artifacts(out_dir: str) -> dict:
    """sha256 of each compared artifact (contigs decompressed)."""
    tmp = os.path.join(out_dir, "tmp")
    names = ["read_data_init.txt", "contigs.nodepath"]
    names += sorted(os.path.basename(p) for p in
                    glob.glob(os.path.join(tmp, "kminmerData_*"))
                    + glob.glob(os.path.join(tmp, "unitigGraph.*")))
    digests = {}
    for n in names:
        with open(os.path.join(tmp, n), "rb") as f:
            digests[n] = hashlib.sha256(f.read()).hexdigest()
    with gzip.open(os.path.join(out_dir, "contigs.fasta.gz"), "rb") as f:
        digests["contigs.fasta"] = hashlib.sha256(f.read()).hexdigest()
    if not any(n.startswith("kminmerData_") for n in digests) or \
            not any(n.startswith("unitigGraph.") for n in digests):
        raise RuntimeError(f"missing graph artifacts in {tmp}")
    return digests


_MODE_ENV = {
    "device-required": {"METAMDBG_TPU_REQUIRE_DEVICE": "1"},
    "device-auto": {},
    "host-only": {"METAMDBG_TPU_HOST_ONLY": "1", "JAX_PLATFORMS": "cpu"},
}


def _asm_argv(flag, reads, out_dir, threads):
    return ["asm", "--out-dir", out_dir, flag, reads, "--threads",
            str(threads)]


def _mode_env(mode: str) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("METAMDBG_TPU_REQUIRE_DEVICE",
                        "METAMDBG_TPU_HOST_ONLY")}
    env["METAMDBG_TPU_KEEP_TMP"] = "1"
    env.update(_MODE_ENV[mode])
    return env


def _asm_in_process(argv, env):
    """`python -m metamdbg_tpu asm ...` through its entry point, here."""
    from metamdbg_tpu.__main__ import main

    saved = dict(os.environ)
    os.environ.clear()
    os.environ.update(env)
    root = logging.getLogger()
    handlers = list(root.handlers)
    try:
        with contextlib.redirect_stdout(sys.stderr):
            main(argv)
    finally:
        os.environ.clear()
        os.environ.update(saved)
        for h in root.handlers[:]:
            if h not in handlers:
                root.removeHandler(h)
                h.close()


def _record(phase, mode, out_dir, wall, compiled, concurrent):
    """Print one run's record: wall, stage spans, routing, device memory,
    XLA compiles (device modes only)."""
    import jax

    with open(os.path.join(out_dir, "tmp", "device.json")) as f:
        device = json.load(f)
    spans = _spans(out_dir)
    stages = {}
    for name, secs, _ in spans:
        key = "k_ladder" if name[0] == "k" and name[1].isdigit() else name
        stages[key] = stages.get(key, 0.0) + secs
    peak = None
    if mode != "host-only":
        peak = [(d.memory_stats() or {}).get("peak_bytes_in_use")
                for d in jax.devices()]
    emit(phase, mode=mode, wall_s=wall, concurrent_with=concurrent,
         stage_s=stages, k_passes=sum(n.endswith("_createGraph")
                                      for n, _, _ in spans),
         peak_rss_gb_process=max(r for _, _, r in spans), device=device,
         peak_bytes_in_use=peak,
         xla_compiles=None if compiled is None else compiled[0],
         xla_compile_s=None if compiled is None else compiled[1],
         file_only={"spans": spans})


def assemble_and_compare(phase, plan, modes, compiles, threads):
    """Generate the reads, start the host-only twin as a child (it runs
    beside the device runs, which take turns in this process), and compare
    every device mode's artifacts with the host-only ones."""
    flag = "--in-hifi" if plan["platform"] == "hifi" else "--in-ont"
    work = os.path.join(WORK, phase)
    subprocess.run(["rm", "-rf", work], check=True)
    os.makedirs(work)
    reads = os.path.join(work, "reads.fastq")
    t0 = time.perf_counter()
    n_bases = write_reads(plan, reads)
    emit(phase, dataset=f"tools/scale_run.py DATASETS[{plan['platform']!r}]",
         genomes_kept=plan["genomes"], genomes_of=plan["of"],
         read_bases=n_bases, full_read_mbp=plan["full_read_mbp"],
         cut="smallest genomes kept; scale cut only, read length, error "
             "profile and coverages as in the source",
         datagen_s=time.perf_counter() - t0)

    def out(mode):
        return os.path.join(work, mode)

    device_modes = [m for m in modes if m != "host-only"]
    log = open(os.path.join(OUT, f"{phase}_host-only.log"), "wb")
    t_host = time.time()
    child = subprocess.Popen(
        [sys.executable, "-m", "metamdbg_tpu"]
        + _asm_argv(flag, reads, out("host-only"), threads),
        env=_mode_env("host-only"), cwd=ROOT, stdout=log,
        stderr=subprocess.STDOUT)
    try:
        for mode in device_modes:
            n0, s0 = compiles.snapshot()
            t0 = time.perf_counter()
            _asm_in_process(_asm_argv(flag, reads, out(mode), threads),
                            _mode_env(mode))
            n1, s1 = compiles.snapshot()
            _record(phase, mode, out(mode), time.perf_counter() - t0,
                    (n1 - n0, s1 - s0), "host-only child")
        rc = child.wait()
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        log.close()
    if rc:
        raise RuntimeError(f"{phase}: host-only run exited {rc}")
    # the child's own wall: its log's last write ("Done!") since its start
    host_wall = os.path.getmtime(
        os.path.join(out("host-only"), "metaMDBG.log")) - t_host
    _record(phase, "host-only", out("host-only"), host_wall, None,
            device_modes)

    ref = _artifacts(out("host-only"))
    for mode in device_modes:
        dig = _artifacts(out(mode))
        differing = sorted(n for n in set(dig) | set(ref)
                           if dig.get(n) != ref.get(n))
        emit(phase, compare=f"{mode} vs host-only", files=len(dig),
             identical=not differing, differing=differing)
        if differing:
            raise RuntimeError(f"{phase}: {mode} output differs from host-only")
    emit(phase, digests=ref)
    subprocess.run(["rm", "-rf", work], check=True)


def run_gpu_tests():
    """Phase 1: the gpu-marked kernel tests, in this process."""
    import pytest

    class Collect:
        def __init__(self):
            self.reports = []

        def pytest_runtest_logreport(self, report):
            if report.when == "call" or report.outcome != "passed":
                self.reports.append(report)

    col = Collect()
    os.environ["METAMDBG_TPU_TESTS_ON_DEVICE"] = "1"
    log_path = os.path.join(OUT, "pytest_gpu.log")
    with open(log_path, "w") as log, contextlib.redirect_stdout(log):
        rc = pytest.main(["-m", "gpu", "-p", "no:cacheprovider", "-q",
                          os.path.join(ROOT, "tests", "test_gpu_kernels.py")],
                         plugins=[col])
    for r in col.reports:
        emit("kernels", test=r.nodeid, outcome=r.outcome,
             seconds=r.duration, **dict(r.user_properties))
    passed = sum(r.outcome == "passed" for r in col.reports)
    if rc != 0 or passed == 0 or passed != len(col.reports):
        raise RuntimeError(f"gpu kernel tests: exit {rc}, {passed} of "
                           f"{len(col.reports)} passed (see {log_path})")


def phase0(cards: int):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    os.environ["JAX_PLATFORMS"] = "cuda"
    t0 = time.perf_counter()
    make = subprocess.run(["make", "-B", "-C", os.path.join(ROOT, "native")],
                          capture_output=True, text=True)
    if make.returncode:
        raise RuntimeError("native build failed:\n" + make.stdout[-3000:]
                           + make.stderr[-3000:])
    make_s = time.perf_counter() - t0
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu" or len(devices) < cards:
        raise RuntimeError(f"need {cards} GPU(s), JAX reports {devices}")
    emit("env", nvidia_smi=smi, jax=jax.__version__,
         platform=devices[0].platform, device_kind=devices[0].device_kind,
         device_count=len(devices), host_cores=os.cpu_count(),
         native_make_s=make_s)
    return devices


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)
    os.makedirs(OUT, exist_ok=True)
    if os.path.exists(os.path.join(OUT, "smoke.jsonl")):
        os.remove(os.path.join(OUT, "smoke.jsonl"))
    sys.path.insert(0, ROOT)

    devices = phase0(args.cards)
    threads = os.cpu_count() or 1
    compiles = _CompileCounter()
    fork_guard = _ForkGuard()
    if args.cards == 1:
        run_gpu_tests()
        modes = ("device-required", "device-auto", "host-only")
        assemble_and_compare("hifi", dataset_plan("hifi", HIFI_GENOMES),
                             modes, compiles, threads)
        assemble_and_compare("ont", dataset_plan("ont", ONT_GENOMES),
                             modes, compiles, threads)
    else:
        from metamdbg_tpu.parallel import production_mesh
        mesh = production_mesh()
        if mesh is None or mesh.devices.size != 4 or any(
                d.platform != "gpu" for d in mesh.devices.flat):
            raise RuntimeError(f"production_mesh() is {mesh}, not 4 GPUs")
        emit("mesh", devices=[str(d) for d in mesh.devices.flat])
        mesh_calls = _count_calls(
            ("metamdbg_tpu.parallel.count_table", "count_table"),
            ("metamdbg_tpu.parallel.pair_join", "pair_join_mesh"))
        assemble_and_compare("ont", dataset_plan("ont", ONT_GENOMES),
                             ("device-auto", "host-only"), compiles, threads)
        emit("mesh", calls=mesh_calls)
        if not all(mesh_calls.values()):
            raise RuntimeError(f"the mesh path did not run: {mesh_calls}")
        import __graft_entry__
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            __graft_entry__.dryrun_multichip(4)
        emit("dryrun_multichip", cards=4, ok=True,
             seconds=time.perf_counter() - t0)
    emit("fork_map", forking_calls=fork_guard.forking_calls,
         child_failures=fork_guard.warnings,
         note="children run under jax.transfer_guard('disallow_explicit')")
    if fork_guard.warnings:
        raise RuntimeError("a fork_map child failed (touched JAX?)")
    print(result_line(devices[:args.cards]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
