"""The PyTorch port's copy of the host front-end against the JAX
package's, and the port's import hygiene (no JAX, nothing of
h264bsd_tpu)."""

import subprocess
import sys
from pathlib import Path

import pytest

from h264bsd_tpu.frontend import binding as jfe
from h264bsd_tpu.models.decoder import caps_from_counts as jax_caps
from h264bsd_tpu.utils import streamgen
from h264bsd_tpu_torch.frontend import binding as tfe
from h264bsd_tpu_torch.models.decoder import WF_THRESH, caps_from_counts
from h264bsd_tpu_torch.ops.unpack import compact_blob_words

ROOT = Path(__file__).parents[1]


def _pictures(binding, data, max_pictures):
    """(stream_info, pic_info, blob_counts, blob_compact bytes) of the
    first `max_pictures` pictures, decoded NAL by NAL."""
    dec = binding.FrontendDecoder()
    out = []
    pos = 0
    while pos < len(data) and len(out) < max_pictures:
        status, read = dec.decode(data, 0, pos)
        pos += read
        if status == binding.PIC_RDY:
            g = dec.stream_info()
            n_mbs = g["width_mbs"] * g["height_mbs"]
            counts = [int(x) for x in dec.blob_counts()]
            caps = caps_from_counts(counts, n_mbs, counts[5] > WF_THRESH)
            assert caps == jax_caps(counts, n_mbs, counts[5] > WF_THRESH)
            words = compact_blob_words(counts, n_mbs, caps)[1]
            out.append((g, dec.pic_info(), counts,
                        dec.blob_compact(*caps, words * 4).tobytes()))
            while dec.next_output() is not None:
                pass
        elif status >= binding.ERROR and read == 0:
            break
    dec.close()
    return out


@pytest.mark.parametrize("maker,args,n_pics", [
    ("make_intra_stress_stream", (4, 4, 2), 2),
    # first picture only: three slices with deblocking controls 0/1/2
    ("make_deblock_control_stream", (), 1)])
def test_frontend_copy_matches(maker, args, n_pics):
    data = getattr(streamgen, maker)(*args)
    want = _pictures(jfe, data, n_pics)
    got = _pictures(tfe, data, n_pics)
    assert len(want) == len(got) == n_pics
    for (wg, wp, wc, wb), (gg, gp, gc, gb) in zip(want, got):
        assert gg == wg
        assert gp == wp
        assert gc == wc
        assert gb == wb


def test_port_imports_neither_jax_nor_the_jax_package():
    code = """
import importlib, pathlib, sys
for p in sorted(pathlib.Path("h264bsd_tpu_torch").rglob("*.py")):
    importlib.import_module(".".join(p.with_suffix("").parts)
                            .removesuffix(".__init__"))
import chip_smoke
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "h264bsd_tpu"))
assert not bad, bad
print(len([k for k in sys.modules if k.startswith("h264bsd_tpu_torch")]))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15
