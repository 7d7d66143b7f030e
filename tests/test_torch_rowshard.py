"""The PyTorch port's row-sharded frame steps (h264bsd_tpu_torch/parallel/
rowshard.py), on the CPU, against the JAX package, with zero tolerance:
every frame of a stream decoded stripe by stripe over 2 and 4 positions
(the blob step on the main path's transfer format, the dense step on the
front-end's dense tensors through K9's idct_blocks, and the batched
step over a stream axis and a row axis) gives the pictures of the JAX
package's single-device decode, and every replica holds the same ring.
One case runs the JAX package's own row-sharded blob step on the
virtual CPU mesh of tests/conftest.py beside the port's, frame by frame.
Also: mc_recon's plain version with an MB-row offset against the JAX
package's inter_predict_frame, and the dense residual transform against
the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from h264bsd_tpu.models import decoder as jdec
from h264bsd_tpu.ops.inter import inter_predict_frame as j_inter
from h264bsd_tpu.ops.transform import residual_transform as j_residual
from h264bsd_tpu.parallel.rowshard import \
    make_row_sharded_blob_step as j_blob_step
from h264bsd_tpu.utils import streamgen
from h264bsd_tpu_torch.frontend import binding as fe
from h264bsd_tpu_torch.models.decoder import Decoder, pin_caps_for_stream
from h264bsd_tpu_torch.models.state import new_ring
from h264bsd_tpu_torch.ops.cuda_mc import mc_recon_plain
from h264bsd_tpu_torch.ops.cuda_transform import residual_transform_cuda
from h264bsd_tpu_torch.ops.inter import inter_predict_frame
from h264bsd_tpu_torch.ops.reconstruct import build_pcm_tensors
from h264bsd_tpu_torch.parallel.mesh import Mesh
from h264bsd_tpu_torch.parallel.rowshard import (
    make_batched_row_sharded_step, make_row_sharded_blob_step,
    make_row_sharded_step)
from h264bsd_tpu_torch.utils.kernel_cases import (mc_recon_case,
                                                  mc_recon_inputs,
                                                  mc_recon_stripe)
from h264bsd_tpu_torch.utils.motion_stream import make_motion_stream

STREAMS = {
    "ippp_4x4": lambda: streamgen.make_ippp_stream(4, 4, 4),
    "motion_6x4": lambda: make_motion_stream(6, 4, 4, seed=0),
    # four slices per picture: slice edges inside and across stripes
    "conformance_8x8": lambda: streamgen.make_conformance_stream(
        8, 8, 2, slices_per_frame=4),
}
# the batched step's second stream, beside ippp_4x4
QP30 = lambda: streamgen.make_ippp_stream(4, 4, 4, qp=30)  # noqa: E731


@pytest.fixture(scope="module")
def jax_pictures():
    """Each stream's pictures from the JAX package's decoder, once."""
    cache = {}

    def get(name, make):
        if name not in cache:
            cache[name] = [p.yuv_bytes() for p in
                           jdec.decode_stream(make(), pipelined=False)]
        return cache[name]
    return get


def _replicas(mesh, geom, device="cpu"):
    ring = new_ring(geom["dpb_slots"], geom["height_mbs"],
                    geom["width_mbs"], device)
    return tuple(mesh.replicate(p) for p in ring)


def _sharded_decode(data, n_row, kind):
    """Decode `data` frame by frame through a row-sharded step over n_row
    CPU positions; returns its pictures in display order (read from
    position 0's ring; every replica holds the same bytes)."""
    mesh = Mesh(["cpu"] * n_row, ("row",))
    dec = Decoder(caps_pin=pin_caps_for_stream(data), device="cpu")
    dpb, steps, out, pos = None, {}, [], 0
    while pos < len(data):
        status, read = dec._fe.decode(data, len(out), pos)
        pos += read
        if status == fe.HDRS_RDY:
            dpb = None
        elif status == fe.PIC_RDY:
            prep = dec._prepare()
            w, h, n = prep["w_mbs"], prep["h_mbs"], prep["n_mbs"]
            if dpb is None:
                dpb = _replicas(mesh, prep["geom"])
            pcm = build_pcm_tensors(n, *prep["ipcm"])
            slot = prep["info"]["slot"]
            if kind == "blob":
                if prep["caps"] not in steps:
                    steps[prep["caps"]] = make_row_sharded_blob_step(
                        mesh, "row", w, h, prep["caps"])
                steps[prep["caps"]](prep["blob"], *map(torch.from_numpy, pcm),
                                    *dpb, slot)
            else:
                t = dec._fe.tensors(n)
                t["pcm_y"], t["pcm_cb"], t["pcm_cr"] = pcm
                make_row_sharded_step(mesh, "row", w, h)(t, *dpb, slot)
            while (o := dec._fe.next_output()) is not None:
                pics = [b"".join(p[k][o["slot"]].numpy().tobytes()
                                 for p in dpb) for k in range(n_row)]
                assert all(x == pics[0] for x in pics), "replicas differ"
                out.append(pics[0])
        elif status >= fe.ERROR and read == 0:
            break
    dec.close()
    return out


# the dense step shares the stripe phases with the blob step and differs
# in its residual route alone (held by test_dense_residual_transform_
# matches_jax), so it runs on one stream
CASES = [(name, "blob") for name in sorted(STREAMS)] + [("motion_6x4",
                                                         "dense")]


@pytest.mark.parametrize("n_row", [2, 4])
@pytest.mark.parametrize("name,kind", CASES)
def test_row_sharded_step_matches_jax(jax_pictures, name, kind, n_row):
    want = jax_pictures(name, STREAMS[name])
    got = _sharded_decode(STREAMS[name](), n_row, kind)
    assert len(got) == len(want) > 1
    for k, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"picture {k}"


@pytest.mark.parametrize("n_row", [2, 4])
def test_batched_row_sharded_step_matches_jax(jax_pictures, n_row):
    """Two 4x4 streams over a (stream 2, row n_row) mesh, frame by frame:
    stream b's ring on the positions of stream block b."""
    makers = {"ippp_4x4": STREAMS["ippp_4x4"], "ippp_4x4_qp30": QP30}
    mesh = Mesh([["cpu"] * n_row] * 2, ("stream", "row"))
    fes = [fe.FrontendDecoder() for _ in makers]
    datas = [make() for make in makers.values()]
    step = make_batched_row_sharded_step(mesh, "stream", "row", 4, 4)
    dpb = None
    out = [[] for _ in makers]
    pos = [0, 0]
    while True:
        frames = []
        for b, (d, data) in enumerate(zip(fes, datas)):
            while pos[b] < len(data):
                status, read = d.decode(data, len(out[b]), pos[b])
                pos[b] += read
                if status == fe.PIC_RDY:
                    t = d.tensors(16)
                    t["pcm_y"], t["pcm_cb"], t["pcm_cr"] = \
                        build_pcm_tensors(16, *d.ipcm())
                    frames.append((t, d.pic_info()["slot"],
                                   d.stream_info()))
                    break
        if not frames:
            break
        assert len(frames) == 2         # the streams run in lockstep
        if dpb is None:
            g = frames[0][2]
            ring = new_ring(2 * g["dpb_slots"], 4, 4, "cpu")
            dpb = tuple(mesh.shard(p.view(2, g["dpb_slots"],
                                          *p.shape[1:]), "stream")
                        for p in ring)
        tensors = {f: np.stack([t[f] for t, _, _ in frames])
                   for f in frames[0][0]}
        step(tensors, *dpb, [s for _, s, _ in frames])
        for b, d in enumerate(fes):
            while (o := d.next_output()) is not None:
                pics = [b"".join(p[b][r][0][o["slot"]].numpy().tobytes()
                                 for p in dpb) for r in range(n_row)]
                assert all(x == pics[0] for x in pics)
                out[b].append(pics[0])
    for d in fes:
        d.close()
    for b, (name, make) in enumerate(makers.items()):
        assert out[b] == jax_pictures(name, make), name


def test_blob_step_matches_the_jax_row_sharded_step():
    """The JAX package's make_row_sharded_blob_step (XLA paths, 2 shards
    of the virtual CPU mesh) and the port's, frame by frame on one blob
    shape (caps pinned to one tier): the same blob bytes and the same
    ring after every frame."""
    data = make_motion_stream(6, 4, 4, seed=0)
    jmesh = JMesh(np.array(jax.devices()[:2]), ("row",))
    mesh = Mesh(["cpu"] * 2, ("row",))
    jd = jdec.Decoder(caps_pin=jdec.pin_caps_for_stream(data, 100.0))
    td = Decoder(caps_pin=pin_caps_for_stream(data, 100.0), device="cpu")
    jstep = step = None
    pos = frames = 0
    while pos < len(data):
        status, read = jd._fe.decode(data[pos:], 0)
        tstatus, tread = td._fe.decode(data, 0, pos)
        assert (status, read) == (tstatus, tread)
        pos += read
        if status != fe.PIC_RDY:
            continue
        jp, tp = jd._prepare(), td._prepare()
        np.testing.assert_array_equal(jp["blob"], tp["blob"])
        assert jp["caps"] == tp["caps"]
        n, slot = tp["n_mbs"], tp["info"]["slot"]
        if step is None:
            g = tp["geom"]
            # replicated over the mesh as the step returns it, so that the
            # step compiles once
            jring = tuple(jax.device_put(
                jnp.zeros((g["dpb_slots"], 64 // s, 96 // s), jnp.uint8),
                NamedSharding(jmesh, P())) for s in (1, 2, 2))
            tring = _replicas(mesh, g)
            jstep = j_blob_step(jmesh, "row", 6, 4, jp["caps"])
            step = make_row_sharded_blob_step(mesh, "row", 6, 4, tp["caps"])
        pcm = build_pcm_tensors(n, *tp["ipcm"])
        jring = jstep(jnp.asarray(jp["blob"]),
                      *(jnp.asarray(p) for p in pcm), *jring,
                      jnp.int32(slot), jnp.asarray(jp["used_slots"]))
        step(tp["blob"], *map(torch.from_numpy, pcm), *tring, slot)
        for k, (jr, tr) in enumerate(zip(jring, tring)):
            for r in tr:
                np.testing.assert_array_equal(
                    r.numpy(), np.asarray(jr), f"frame {frames} plane {k}")
        while jd._fe.next_output() is not None:
            pass
        while td._fe.next_output() is not None:
            pass
        frames += 1
    jd.close()
    td.close()
    assert frames == 4


@pytest.mark.parametrize("make", [
    lambda m: make_row_sharded_step(m, "row", 4, 5),
    lambda m: make_row_sharded_blob_step(m, "row", 4, 5, None),
    lambda m: make_batched_row_sharded_step(
        Mesh([["cpu"] * 2], ("stream", "row")), "stream", "row", 4, 5)])
def test_non_divisible_heights_raise(make):
    with pytest.raises(ValueError, match="not divisible"):
        make(Mesh(["cpu"] * 2, ("row",)))


# the JAX functions compiled once (their integer results do not depend on
# it; op-by-op dispatch costs several times their compile on the CPU)
_j_inter = jax.jit(j_inter, static_argnums=(5, 6),
                   static_argnames=("mb_row_offset",))
_j_residual = jax.jit(j_residual)


@pytest.mark.parametrize("first_row", [0, 3, 6])
def test_mc_recon_with_a_row_offset_matches_jax(first_row):
    """mc_recon_plain on a stripe at mb_row_offset, against the JAX
    package's inter_predict_frame at the same offset with the inter
    combine, and against the whole frame's rows there; MVs reach across
    the stripe's edges and the frame's."""
    dims, rows = (6, 9), 3
    args = mc_recon_inputs(mc_recon_case(21, *dims, 4, 0.25, pcm=True,
                                         motion="edge"), "cpu")
    stripe = mc_recon_stripe(args, dims[0], first_row, rows)
    got = mc_recon_plain(*stripe, dims[0], rows, mb_row_offset=first_row)
    whole = mc_recon_plain(*args, *dims)
    for g, f, s in zip(got, whole, (16, 8, 8)):
        assert torch.equal(g, f[first_row * s:(first_row + rows) * s])
    ring, (mv, ref, cls, res_l, res_c, pcm) = stripe[:3], stripe[3:]
    jpred = _j_inter(*(jnp.asarray(p.numpy()) for p in ring),
                     jnp.asarray(mv.numpy().astype(np.int32)),
                     jnp.asarray(ref.numpy().astype(np.int32)), dims[0],
                     rows, mb_row_offset=first_row)
    tpred = inter_predict_frame(*ring, mv, ref, dims[0], rows,
                                mb_row_offset=first_row)
    for j, t in zip(jpred, tpred):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    inter = np.isin(cls.numpy(), (1, 2))[:, None, None]
    for j, r, p, g, s in zip(jpred, (res_l, res_c[:, 0], res_c[:, 1]), pcm,
                             got, (16, 8, 8)):
        want = np.where(inter, np.clip(np.asarray(j) + r.numpy(), 0, 255),
                        0)
        want = np.where((cls.numpy() == 5)[:, None, None], p.numpy(), want)
        want = want.reshape(rows, dims[0], s, s).transpose(0, 2, 1, 3)
        np.testing.assert_array_equal(
            g.numpy(), want.reshape(rows * s, dims[0] * s))


def test_dense_residual_transform_matches_jax():
    """The dense residual transform (the dense stripe step's, through
    idct_blocks) on a frame's dense coefficients from the front-end,
    against the JAX package's residual_transform: residuals and the
    empty-block mask."""
    d = fe.FrontendDecoder()
    data = streamgen.make_intra_stress_stream(8, 8)
    pos, frames = 0, 0
    while pos < len(data):
        status, read = d.decode(data, 0, pos)
        pos += read
        if status != fe.PIC_RDY:
            continue
        t = d.tensors(64)
        args = [t[f] for f in ("coeff", "luma_dc", "chroma_dc", "qp_y",
                               "chroma_qp_offset", "nnz", "nnz_dc")]
        is_i16 = t["mb_class"] == 4
        jres, jempty = _j_residual(
            *(jnp.asarray(a.astype(np.int32)) for a in args),
            jnp.asarray(is_i16))
        tres, tempty = residual_transform_cuda(
            *(torch.from_numpy(a.astype(np.int32)) for a in args),
            torch.from_numpy(is_i16))
        np.testing.assert_array_equal(tres.numpy(), np.asarray(jres))
        np.testing.assert_array_equal(tempty.numpy(), np.asarray(jempty))
        while d.next_output() is not None:
            pass
        frames += 1
    d.close()
    assert frames > 0
