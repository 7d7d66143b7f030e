"""The port's copy of the instrumented-reference trace reader
(h264bsd_tpu_torch/utils/reftrace.py) against the JAX package's, on a
synthetic trace in the format of tools/make_ref_tracer.py's docstring:
MB records (tag 1), pre- and post-deblock frames (2, 3) and picture
records (4) over three pictures, read by both readers and compared field
by field, dtypes included; max_pics, with_frames, a truncated final
record and a bad tag. The tracer build needs the reference tree: without
H264BSD_REFERENCE it skips under pytest and raises FileNotFoundError
outside it, as the golden copy does."""

import struct
import sys

import numpy as np
import pytest

from h264bsd_tpu.utils import reftrace as jreftrace
from h264bsd_tpu_torch.utils import golden, reftrace

FRAME_BYTES = 2 * 384        # a 2-MB picture's uncropped YUV


def _mb_record(rng, mb_num):
    return (struct.pack("<I", 1)
            + struct.pack("<4I", mb_num, rng.integers(0, 3),
                          rng.integers(0, 32), rng.integers(0, 52))
            + rng.integers(-2**15, 2**15, 28, dtype=np.int16).tobytes()
            + rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
            + rng.integers(0, 2**32, 4, dtype=np.uint32).tobytes()
            + rng.integers(-2**15, 2**15, 32, dtype=np.int16).tobytes()
            + struct.pack("<Ii", rng.integers(0, 48), rng.integers(-26, 26))
            + rng.integers(0, 2**32, 8, dtype=np.uint32).tobytes()
            + rng.integers(-2**31, 2**31, 26 * 16,
                           dtype=np.int32).tobytes())


def _synthetic_trace(seed=0):
    """Three pictures: MB records (one MB written twice, as a redundant
    slice does), both frames and the picture record each."""
    rng = np.random.default_rng(seed)
    out = b""
    for pic in range(3):
        for mb_num in (0, 1, 1):
            out += _mb_record(rng, mb_num)
        for tag in (2, 3):
            out += struct.pack("<II", tag, FRAME_BYTES) + rng.integers(
                0, 256, FRAME_BYTES, dtype=np.uint8).tobytes()
        out += struct.pack("<IiIII", 4, 2 * pic - 1, pic, pic == 0, 2 - pic)
    return out


def _same_value(a, b):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b


def _assert_same_pictures(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for name in ("pre_deblock", "post_deblock", "poc", "frame_num",
                     "is_idr", "nal_ref_idc"):
            _same_value(getattr(g, name), getattr(w, name))
        assert list(g.mbs) == list(w.mbs)
        for k in w.mbs:
            for name in w.mbs[k].__dataclass_fields__:
                _same_value(getattr(g.mbs[k], name), getattr(w.mbs[k], name))


def test_constants_and_record_types_match_jax():
    assert np.array_equal(reftrace.ZIG2RAS, jreftrace.ZIG2RAS)
    assert reftrace.ZIG2RAS.dtype == jreftrace.ZIG2RAS.dtype
    for ours, theirs in ((reftrace.TraceMb, jreftrace.TraceMb),
                         (reftrace.TracePicture, jreftrace.TracePicture)):
        assert {k: str(f.type) for k, f in
                ours.__dataclass_fields__.items()} == \
            {k: str(f.type) for k, f in theirs.__dataclass_fields__.items()}


@pytest.mark.parametrize("max_pics", [None, 1, 2, 3, 5])
@pytest.mark.parametrize("with_frames", [False, True])
def test_read_trace_matches_jax(tmp_path, max_pics, with_frames):
    path = tmp_path / "trace.bin"
    path.write_bytes(_synthetic_trace())
    got = reftrace.read_trace(path, max_pics, with_frames)
    want = jreftrace.read_trace(path, max_pics, with_frames)
    assert len(want) == min(3, max_pics or 3)
    _assert_same_pictures(got, want)
    assert all(bool(p.pre_deblock) == with_frames for p in got)
    assert all(sorted(p.mbs) == [0, 1] for p in got)


# byte counts cut off the end of the trace: inside the last picture
# record, inside a frame's data, inside an MB record, and 1-3 bytes of a
# fourth picture's first tag
@pytest.mark.parametrize("cut", [-1, -17, -FRAME_BYTES // 2, -1700, 1, 3])
def test_truncated_final_record_reads_as_jax(tmp_path, cut):
    whole = _synthetic_trace(1)
    data = whole[:cut] if cut < 0 else whole + b"\x01\x00\x00"[:cut]
    path = tmp_path / "trace.bin"
    path.write_bytes(data)
    for with_frames in (False, True):
        outcomes = []
        for reader in (reftrace.read_trace, jreftrace.read_trace):
            try:
                outcomes.append(reader(path, None, with_frames))
            except Exception as exc:
                outcomes.append(type(exc))
        got, want = outcomes
        if isinstance(want, type):
            assert got is want
        else:
            _assert_same_pictures(got, want)


def test_bad_tag_raises_like_jax(tmp_path):
    path = tmp_path / "trace.bin"
    path.write_bytes(_synthetic_trace(2) + struct.pack("<I", 7) + b"\0" * 16)
    for reader in (reftrace.read_trace, jreftrace.read_trace):
        with pytest.raises(ValueError, match="bad trace tag 7"):
            reader(path)
    # the pictures before the bad record are not returned either
    path.write_bytes(struct.pack("<I", 0))
    for reader in (reftrace.read_trace, jreftrace.read_trace):
        with pytest.raises(ValueError, match="bad trace tag 0"):
            reader(path)


def test_tracer_needs_the_reference_tree(tmp_path, monkeypatch):
    """build_tracer and trace_stream skip without H264BSD_REFERENCE under
    pytest, and raise FileNotFoundError outside it; nothing is built."""
    monkeypatch.setattr(golden, "REFERENCE", None)
    monkeypatch.setattr(reftrace, "TRACE_DIR", tmp_path / "trace")
    for need_tree in (reftrace.build_tracer,
                      lambda: reftrace.trace_stream("640x360")):
        with pytest.raises(pytest.skip.Exception, match="is not set"):
            need_tree()
    monkeypatch.delitem(sys.modules, "pytest")
    with pytest.raises(FileNotFoundError, match="is not set"):
        reftrace.build_tracer()
    assert not (tmp_path / "trace").exists()


def test_instrumented_source_matches_the_tool(tmp_path, monkeypatch):
    """The port's copy of the hooks and patches instruments a reference
    source tree as tools/make_ref_tracer.py does: both run on a stand-in
    tree holding the patched lines (the tool's compiler calls replaced
    by no-ops), and give the same files, but for the default path of the
    trace file (the tool's an absolute one, the port's relative to the
    working directory; TRACE_OUT sets it in both)."""
    import importlib.util
    import subprocess
    from pathlib import Path

    ref = tmp_path / "reference"
    (ref / "src").mkdir(parents=True)
    (ref / "posix").mkdir()
    (ref / "posix" / "test_h264bsd.c").write_text("int main(void);\n")
    by_file = {}
    for name, old, _ in reftrace.PATCHES:
        by_file.setdefault(name, []).append(old)
    for name, olds in by_file.items():
        (ref / "src" / name).write_text(
            "/* head */\n" + "\n/* between */\n".join(olds) + "\n")
    (ref / "src" / "h264bsd_util.c").write_text("/* untouched */\n")

    spec = importlib.util.spec_from_file_location(
        "make_ref_tracer",
        Path(__file__).parents[1] / "tools" / "make_ref_tracer.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr(tool, "REF", ref)
    monkeypatch.setattr(tool, "OUT", tmp_path / "tool_out")
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: None)
    tool.main()
    monkeypatch.undo()

    monkeypatch.setattr(golden, "REFERENCE", ref)
    reftrace._instrumented_source(tmp_path / "port_src")
    want = {p.name: p.read_text()
            for p in (tmp_path / "tool_out" / "src").iterdir()}
    got = {p.name: p.read_text() for p in (tmp_path / "port_src").iterdir()}
    want["trace_hooks.c"] = want["trace_hooks.c"].replace(
        '"/tmp/ref_trace.bin"', '"ref_trace.bin"')
    assert got == want
    assert got["h264bsd_slice_data.c"] != \
        (ref / "src" / "h264bsd_slice_data.c").read_text()
