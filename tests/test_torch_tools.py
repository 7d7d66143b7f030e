"""The PyTorch port's tools on the CPU, against the JAX package where it
has the same tool: frame_checksum_device (the JAX package's
_frame_checksum_device and frame_checksum_host), the profiling wrapper
(utils/profiling.py), the golden-oracle copy (utils/golden.py), the CLI
(h264bsd_tpu_torch/cli.py against tools/h264dec.py, byte for byte), and
the bench script (bench_torch.py), which must exit non-zero on a
checksum mismatch."""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264bsd_tpu.models.decoder import \
    _frame_checksum_device as j_checksum
from h264bsd_tpu.utils import golden as jgolden
from h264bsd_tpu_torch import cli
from h264bsd_tpu_torch.models.decoder import (Decoder, benchmark_stream,
                                              frame_checksum_device,
                                              frame_checksum_host)
from h264bsd_tpu_torch.utils import golden, streamgen
from h264bsd_tpu_torch.utils.profiling import StageTimers, device_trace
from h264bsd_tpu_torch.utils.recorded import make_recorded_stream

ROOT = Path(__file__).parents[1]
CHECKSUMS = ROOT / "h264bsd_tpu_torch" / "testdata" / \
    "reference_checksums.json"


def _planes(rng, h, w, fill=None):
    shapes = ((h, w), (h // 2, w // 2), (h // 2, w // 2))
    if fill is not None:
        return [np.full(s, fill, np.uint8) for s in shapes]
    return [rng.integers(0, 256, s, np.uint8) for s in shapes]


@pytest.mark.parametrize("h,w,fill", [(64, 64, None), (1088, 1920, None),
                                      (1088, 1920, 255)])
def test_frame_checksum_device_matches_host_and_jax(h, w, fill):
    """Seeded planes at 4x4 MBs and 1920x1088 (all-255 planes: the
    largest products and sum, the int64 headroom), whole and truncated
    as the reference app dumps 1080p: frame_checksum_host and the JAX
    package's device checksum."""
    planes = _planes(np.random.default_rng(h + w), h, w, fill)
    whole = h * w * 3 // 2
    for n_trunc in (whole, whole - 8 * w * 3 // 2):
        host = frame_checksum_host(b"".join(p.tobytes()
                                            for p in planes)[:n_trunc])
        got = frame_checksum_device(*map(torch.from_numpy, planes),
                                    n_trunc)
        assert got.dtype == torch.int64 and got.dim() == 0
        assert int(got) == host
        assert int(j_checksum(*map(jnp.asarray, planes),
                              n_trunc=n_trunc)) == host


def test_stage_timers_and_device_trace(tmp_path):
    """StageTimers accumulates per stage; device_trace on the CPU yields
    the profiler and leaves a Chrome trace that records the work."""
    timers = StageTimers()
    for _ in range(3):
        with timers.stage("parse"):
            pass
    with timers.stage("dispatch"):
        pass
    assert timers.counts == {"parse": 3, "dispatch": 1}
    assert "parse:" in timers.report() and "x3" in timers.report()

    with device_trace(tmp_path / "trace", device="cpu") as prof:
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    assert isinstance(prof, torch.profiler.profile)
    traces = list((tmp_path / "trace").glob("trace_*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)


def test_golden_copy_matches_jax(tmp_path, monkeypatch):
    """The golden-oracle copy: the same streams and the reference app's
    dump quirk; without a reference tree both skip under pytest (and
    raise FileNotFoundError outside it). The copy takes the tree only
    from H264BSD_REFERENCE: unset, it looks for none, and the reference
    binary (bench_torch.py's vs_baseline) is not built."""
    assert golden.STREAMS == jgolden.STREAMS
    frame = bytes(range(256)) * (1920 * 1088 * 3 // 2 // 256)
    for name in golden.STREAMS:
        assert golden.truncate_frame(frame, name) == \
            jgolden.truncate_frame(frame, name)
    for mod in (golden, jgolden):
        monkeypatch.setattr(mod, "REFERENCE", tmp_path / "absent")
        with pytest.raises(pytest.skip.Exception, match="not available"):
            mod.stream_path("640x360")
    monkeypatch.setattr(golden, "REFERENCE", None)
    for need_tree in (golden.stream_path, golden.reference_binary,
                      golden.resilient_binary):
        with pytest.raises(pytest.skip.Exception, match="is not set"):
            need_tree(*(["640x360"] if need_tree is golden.stream_path
                        else []))
    monkeypatch.delitem(sys.modules, "pytest")
    with pytest.raises(FileNotFoundError, match="is not set"):
        golden.reference_binary()


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "h264dec", ROOT / "tools" / "h264dec.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cli_matches_jax_cli(tmp_path, capsys):
    """One 4x4 streamgen file through the port's CLI on the CPU and the
    JAX package's tools/h264dec.py: byte-equal -o and --rgba files and
    --render .ppm files, the same printed lines but the fps, and -c of
    the port's dump against the JAX dump reports 0 differing pixels (and
    a corrupted dump differing ones, with exit code 1)."""
    stream = tmp_path / "s.h264"
    stream.write_bytes(streamgen.make_ippp_stream(4, 4, 4))
    outs = {}
    for tag, run in (("jax", _jax_cli().main), ("torch", cli.main)):
        d = tmp_path / tag
        args = ["-o", str(d / "o.yuv"), "--rgba", str(d / "o.rgba"),
                "--render", str(d / "ppm"), str(stream)]
        d.mkdir()
        assert run(args + (["--device", "cpu"] if tag == "torch"
                           else [])) == 0
        lines = capsys.readouterr().out.splitlines()
        outs[tag] = (d, [ln.split(" pictures decoded.")[0] for ln in lines])
    (jd, jlines), (td, tlines) = outs["jax"], outs["torch"]
    assert tlines == jlines == ["Decoded headers. Image size (cropped) "
                                "64x64.", "Test file complete. 4"]
    for name in ("o.yuv", "o.rgba"):
        assert (td / name).read_bytes() == (jd / name).read_bytes(), name
    ppms = sorted(p.name for p in (jd / "ppm").iterdir())
    assert ppms == sorted(p.name for p in (td / "ppm").iterdir())
    assert len(ppms) == 4
    for p in ppms:
        assert (td / "ppm" / p).read_bytes() == (jd / "ppm" / p).read_bytes()

    assert cli.main(["-c", str(jd / "o.yuv"), "--device", "cpu",
                     str(stream)]) == 0
    assert "Binary comparison OK: 0 differing pixels" in \
        capsys.readouterr().out
    bad = bytearray((jd / "o.yuv").read_bytes())
    bad[100] ^= 1
    (tmp_path / "bad.yuv").write_bytes(bytes(bad))
    assert cli.main(["-c", str(tmp_path / "bad.yuv"), "--device", "cpu",
                     str(stream)]) == 1
    out = capsys.readouterr().out
    assert "frame 0: 1 differing pixels" in out
    assert "Binary comparison FAILED: 1 differing pixels" in out


def test_benchmark_stream_verifies_before_it_times():
    """benchmark_stream on the CPU: with the recorded checksums every
    picture matches and the timed passes run; with one checksum changed
    nothing is timed and no fps is given."""
    entry = json.loads(CHECKSUMS.read_text())["ippp_4x4"]
    data = make_recorded_stream(entry)
    r = benchmark_stream(data, entry["checksums"], repeats=2, device="cpu")
    assert r["bit_exact"] and r["pictures"] == 4 and len(r["runs"]) == 2
    assert r["fps"] == max(r["runs"]) and r["captures"] == 0
    assert r["fps_all"] == pytest.approx(8 / r["timed_s"])
    bad = list(entry["checksums"])
    bad[1] ^= 1
    r = benchmark_stream(data, bad, repeats=2, device="cpu")
    assert not r["bit_exact"] and r["runs"] == [] and r["fps"] is None


@pytest.mark.parametrize("dirty_pass", [0, 1])
def test_benchmark_stream_checks_the_timed_passes(monkeypatch, dirty_pass):
    """A timed pass that goes wrong after a correct verification pass: the
    Decoder's restart before timed pass `dirty_pass` hands back a ring
    that turns dirty under the pass (filled with 77 once its first
    picture is out, so the P pictures predict from it). That pass's
    checksums differ: bit_exact is false and no fps is given."""
    entry = json.loads(CHECKSUMS.read_text())["ippp_4x4"]
    restart, make_output = Decoder.restart, Decoder._make_output
    n_restarts = []

    def dirty_restart(self):
        restart(self)
        n_restarts.append(1)
        # restart 1 starts the verification pass, restart 2 timed pass 0
        self._dirty = len(n_restarts) == dirty_pass + 2

    def dirtying_output(self, out, g):
        pic = make_output(self, out, g)
        if getattr(self, "_dirty", False):
            for plane in self._dpb:
                plane.fill_(77)
            self._dirty = False
        return pic

    monkeypatch.setattr(Decoder, "restart", dirty_restart)
    monkeypatch.setattr(Decoder, "_make_output", dirtying_output)
    r = benchmark_stream(make_recorded_stream(entry), entry["checksums"],
                         repeats=3, device="cpu")
    assert r["pictures"] == 4 and r["cold_fps"] > 0
    assert not r["bit_exact"] and r["failed_pass"] == dirty_pass
    assert r["runs"] == [] and r["fps"] is None and r["fps_all"] is None


@pytest.mark.parametrize("corrupt", [False, True])
def test_bench_script_exits_nonzero_on_a_checksum_mismatch(tmp_path,
                                                           corrupt):
    """bench_torch.py on ippp_4x4 on the CPU: against the recorded
    checksums it prints one bit-exact JSON line with an fps and exits 0;
    against a copy with one value changed it prints "bit_exact": false
    with no fps and exits non-zero."""
    ref = json.loads(CHECKSUMS.read_text())
    if corrupt:
        ref["ippp_4x4"]["checksums"][2] ^= 1
    path = tmp_path / "checksums.json"
    path.write_text(json.dumps(ref))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "bench_torch.py"), "--device", "cpu",
         "--stream", "ippp_4x4", "--budget", "0", "--checksums",
         str(path)], capture_output=True, text=True, cwd=tmp_path,
        timeout=120)
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["stream"] == "ippp_4x4" and rec["pictures"] == 4
    if corrupt:
        assert proc.returncode != 0
        assert rec["bit_exact"] is False and rec["value"] is None
        assert rec["runs"] == []
    else:
        assert proc.returncode == 0, proc.stderr
        assert rec["bit_exact"] is True and rec["value"] > 0
        # all the pictures over all the seconds of the timed passes
        assert rec["fps_all"] == pytest.approx(
            4 * len(rec["runs"]) / sum(4 / f for f in rec["runs"]))
        assert rec["vs_baseline"] is None or rec["vs_baseline"] > 0
        assert rec["device"] == {"name": "cpu", "power_limit": None}
