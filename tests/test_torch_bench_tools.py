"""The PyTorch port's benchmark tools on the CPU, run in-process on 4x4
streams with budgets under a second: tools/bench_configs_torch.py (one
JSON line per config, the reference tree's configs absent, a tampered
checksum makes its line not bit-exact and the tool exit 1),
tools/bench_scaling_torch.py (one line per axis, no efficiency on a
device list that repeats a device) and tools/count_graphs_torch.py (the
graph keys a stream's decode uses, with and without pinned caps)."""

import importlib.util
import json
from pathlib import Path

import pytest

ROOT = Path(__file__).parents[1]
CHECKSUMS = ROOT / "h264bsd_tpu_torch" / "testdata" / \
    "reference_checksums.json"
# the tiny cuts: config 3's all-I stream, config 4's IPPP stream and
# config 5's streams as 4x4 (and 2x4) recorded entries
CONFIG_ENTRIES = ["intra720p=intra_2x4", "gop=ippp_4x4",
                  "framepipe=ippp_4x4",
                  "multistream=ippp_4x4,fuzz_ippp_4x4_s2"]


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(capsys):
    return [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]


def test_bench_configs_prints_one_line_per_config(capsys):
    tool = _tool("bench_configs_torch")
    rc = tool.main(["--device", "cpu", "--budget", "0.2", "--streams", "2",
                    "--entries", *CONFIG_ENTRIES])
    recs = _lines(capsys)
    assert rc == 0
    assert [r["config"] for r in recs] == list(tool.CONFIGS)
    for r in recs:
        assert r["device"] == {"name": "cpu", "power_limit": None}
        if r["baseline_config"] in (1, 2):
            # the reference tree's streams: absent without it
            assert r["absent"] is True and "value" not in r
            continue
        assert r["bit_exact"] is True and r["value"] > 0
        assert r["median"] > 0 and r["fps_all"] > 0 and r["runs"]
        assert r["timed_s"] > 0
    by_name = {r["config"]: r for r in recs}
    assert by_name["gop"]["pictures"] == 4 * 4     # four copies
    assert by_name["framepipe"]["positions"] == 2
    assert by_name["multistream"]["pictures"] == 4 + 3


@pytest.mark.parametrize("config,entry", [("intra720p", "intra_2x4"),
                                          ("gop", "ippp_4x4"),
                                          ("multistream", "ippp_4x4")])
def test_bench_configs_fails_on_a_tampered_checksum(tmp_path, capsys,
                                                    config, entry):
    ref = json.loads(CHECKSUMS.read_text())
    ref[entry]["checksums"][-1] ^= 1
    path = tmp_path / "checksums.json"
    path.write_text(json.dumps(ref))
    tool = _tool("bench_configs_torch")
    rc = tool.main(["--device", "cpu", "--budget", "0.2", "--streams", "2",
                    "--only", config, "--checksums", str(path),
                    "--entries", *CONFIG_ENTRIES])
    rec, = _lines(capsys)
    assert rc != 0
    assert rec["config"] == config and rec["bit_exact"] is False
    assert rec["value"] is None and rec["runs"] == []


def test_bench_scaling_gives_no_efficiency_on_repeated_devices(capsys):
    tool = _tool("bench_scaling_torch")
    rc = tool.main(["--device", "cpu", "--devices", "1", "2", "--budget",
                    "0.2", "--gop-copies", "2", "--ms-per-dev", "1",
                    "--entries", "gop=ippp_4x4",
                    "multistream=ippp_4x4,fuzz_ippp_4x4_s2",
                    "rowshard=ippp_4x4"])
    head, *recs = _lines(capsys)
    assert rc == 0
    assert head["cuda_device_count"] == 0
    assert [r["axis"] for r in recs] == ["gop", "multistream", "rowshard"]
    for r in recs:
        assert r["bit_exact"] is True
        assert set(r["fps"]) == {"1", "2"} and all(
            v > 0 for v in r["fps"].values())
        assert r["distinct_devices"] is False and r["efficiency"] is None
    by_axis = {r["axis"]: r for r in recs}
    # weak scaling: one stream per position
    assert by_axis["multistream"]["pictures"] == {"1": 4, "2": 7}
    assert by_axis["gop"]["pictures"] == {"1": 8, "2": 8}


def test_count_graphs_reports_the_keys_of_a_stream(capsys):
    tool = _tool("count_graphs_torch")
    rc = tool.main(["--device", "cpu", "ippp_4x4", "fuzz_ippp_4x4_s1"])
    recs = _lines(capsys)
    assert rc == 0
    assert [(r["stream"], r["pin"]) for r in recs] == [
        ("ippp_4x4", False), ("ippp_4x4", True),
        ("fuzz_ippp_4x4_s1", False), ("fuzz_ippp_4x4_s1", True)]
    for r in recs:
        assert r["bit_exact"] is True and r["graph_keys"] >= 1
        # on the CPU every frame runs eagerly
        assert r["graph_captures"] == r["graph_replays"] == 0
        assert r["eager_frames"] >= r["pictures"] > 0
        assert "capture_ms" not in r
