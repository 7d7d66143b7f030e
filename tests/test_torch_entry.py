"""The PyTorch port's entry hooks (h264bsd_tpu_torch/models/entry.py) and
the dense path under them, on the CPU, against the JAX package, with
zero tolerance (integer codec): densify_residual on the main path's
blob, the dense reconstruct_frame and frame_step frame by frame on real
front-end output (the plain versions of K9, mc_recon, K2 or K7 and K1 or
K8), entry_fn_and_args on the example tensors, and the multi-device dry
run on CPU device lists (which asserts against the port's own
single-device results)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264bsd_tpu.models import entry as jentry
from h264bsd_tpu.ops.reconstruct import reconstruct_frame as j_reconstruct
from h264bsd_tpu.ops.unpack import densify_residual as j_densify
from h264bsd_tpu_torch.models import entry
from h264bsd_tpu_torch.models.decoder import Decoder
from h264bsd_tpu_torch.models.state import new_ring
from h264bsd_tpu_torch.ops.reconstruct import reconstruct_frame
from h264bsd_tpu_torch.ops.unpack import (blob_words, densify_residual,
                                          unpack_blob)
from h264bsd_tpu_torch.utils import streamgen
from h264bsd_tpu_torch.utils.motion_stream import make_motion_stream

STREAMS = {
    "conformance_4x4": lambda: streamgen.make_conformance_stream(4, 4),
    "pcm_4x4": lambda: streamgen.make_pcm_stream(4, 4),
    "motion_6x4": lambda: make_motion_stream(6, 4, 4, seed=0),
}


def _frames(data):
    """Each picture of `data` as the port's front-end parses it
    (entry.dense_frames): (dense tensor dict with pcm_*, ring slot,
    geometry, the main path's prep of the same picture)."""
    dec = Decoder(device="cpu")
    try:
        return [(t, slot, g, dec._prepare())
                for t, slot, g, _ in entry.dense_frames(data, dec._fe)]
    finally:
        dec.close()


def _equal(got, want, what):
    for g, w, plane in zip(got, want, ("y", "cb", "cr")):
        assert np.array_equal(g.numpy(), np.asarray(w)), f"{what}: {plane}"


def test_densify_residual_matches_jax_on_the_blob():
    """The sparse residual of every picture of motion_6x4, as the main
    path unpacks it from its blob, scattered dense: the JAX package's
    densify_residual, and the front-end's own dense coefficients."""
    frames = _frames(STREAMS["motion_6x4"]())
    assert len(frames) == 4
    for k, (t, _, _, prep) in enumerate(frames):
        n = prep["n_mbs"]
        _, _, ids, levels, *_ = unpack_blob(blob_words(prep["blob"], "cpu"),
                                            n, *prep["caps"])
        got = densify_residual(ids, levels, n)
        want = j_densify(jnp.asarray(ids.reshape(-1).numpy()),
                         jnp.asarray(levels.numpy()), n)
        for g, w, dense, name in zip(got, want, ("coeff", "luma_dc",
                                                 "chroma_dc"),
                                     ("coeff", "luma_dc", "chroma_dc")):
            assert g.dtype == torch.int32
            assert np.array_equal(g.numpy(), np.asarray(w)), (k, name)
            assert np.array_equal(g.numpy(), t[dense]), (k, name)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_frame_step_matches_jax(name):
    """Every frame of the stream through the port's reconstruct_frame and
    frame_step and through the JAX package's, on rings that start equal:
    the same pre-deblock planes and the same ring after every frame."""
    frames = _frames(STREAMS[name]())
    g = frames[0][2]
    w_mbs, h_mbs = g["width_mbs"], g["height_mbs"]
    ring = new_ring(g["dpb_slots"], h_mbs, w_mbs, "cpu")
    jring = tuple(jnp.asarray(p.numpy()) for p in ring)
    for k, (t, slot, _, _) in enumerate(frames):
        tj = {f: jnp.asarray(v) for f, v in t.items()}
        y, cb, cr, _ = reconstruct_frame(t, *ring, w_mbs, h_mbs)
        _equal((y, cb, cr), j_reconstruct(tj, *jring, w_mbs, h_mbs),
               f"{name} frame {k} before deblocking")
        entry.frame_step(t, *ring, slot, w_mbs, h_mbs)
        jring = jentry.frame_step(tj, *jring, jnp.int32(slot), w_mbs, h_mbs)
        _equal(ring, jring, f"{name} frame {k} ring")


def test_entry_fn_and_args_matches_jax():
    """The 4x4 example: the same example tensors, and the same ring after
    the step."""
    fn, args = entry.entry_fn_and_args(device="cpu")
    jfn, jargs = jentry.entry_fn_and_args()
    for f, v in args[0].items():
        assert np.array_equal(v.numpy(), np.asarray(jargs[0][f])), f
    _equal(fn(*args), jfn(*jargs), "entry step")
    _equal(entry.entry_fn_check(device="cpu"), args[1:4], "entry_fn_check")


def test_example_tensors_match_jax_and_take_no_rng():
    """example_tensors with a batch axis equals the JAX package's; it draws
    no random values, so a Generator given as rng is refused."""
    got = entry.example_tensors(6, batch=2, device="cpu")
    want = jentry.example_tensors(6, batch=2)
    assert sorted(got) == sorted(want) == sorted(entry.TENSOR_SPECS)
    for f, v in got.items():
        assert v.shape == (2, 6) + entry.TENSOR_SPECS[f][0], f
        assert np.array_equal(v.numpy(), np.asarray(want[f])), f
    with pytest.raises(ValueError, match="rng must be None"):
        entry.example_tensors(6, rng=np.random.default_rng(0),
                              device="cpu")


@pytest.mark.parametrize("n_devices", [2, 4])
def test_multichip_dryrun_on_cpu_devices(n_devices, capsys):
    """Every phase of the dry run (batched dense row-sharded step, blob
    row-sharded step, framepipe) equals the single-device result on a
    list of CPU devices; the list used is printed."""
    entry.run_multichip_dryrun(n_devices, devices=["cpu"] * n_devices)
    assert f"devices {['cpu'] * n_devices}" in capsys.readouterr().out


def test_entry_points_need_a_device_without_a_card(monkeypatch):
    """device=None means the card: without one the entry points raise and
    never run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.entry_fn_and_args()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.run_multichip_dryrun(2)
