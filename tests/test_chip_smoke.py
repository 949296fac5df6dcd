"""chip_smoke.py's contract pieces that run without a GPU."""

import json
import os
import sys
from types import SimpleNamespace

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("count", [1, 4])
def test_result_line_contract(count):
    devs = [SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
            ] * count
    line = chip_smoke.result_line(devs)
    assert line == ('{"ok": true, "device": {"platform": "gpu", "kind": '
                    '"NVIDIA H100 80GB HBM3", "count": %d}}' % count)
    assert json.loads(line)["device"]["count"] == count


def test_result_line_refuses_non_gpu():
    with pytest.raises(RuntimeError):
        chip_smoke.result_line([SimpleNamespace(platform="cpu",
                                                device_kind="cpu")])


@pytest.mark.parametrize("platform,n,genomes,mbp", [
    ("hifi", chip_smoke.HIFI_GENOMES, list(range(7, 14)), 315.0),
    ("ont", chip_smoke.ONT_GENOMES, [4, 5], 127.5),
])
def test_dataset_plan_cut(platform, n, genomes, mbp):
    plan = chip_smoke.dataset_plan(platform, n)
    assert plan["genomes"] == genomes
    assert plan["read_mbp"] == pytest.approx(mbp)
    assert plan["read_mbp"] >= chip_smoke.MIN_MBP[platform]


@pytest.mark.parametrize("platform", ["hifi", "ont"])
def test_dataset_plan_refuses_cut_below_floor(platform):
    with pytest.raises(ValueError):
        chip_smoke.dataset_plan(platform, 1)
