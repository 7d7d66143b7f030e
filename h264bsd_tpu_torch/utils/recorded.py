"""The streams whose per-picture checksums the port is held to.

testdata/reference_checksums.json (written by
tools/record_torch_port_checksums.py from the JAX package's decodes)
names each stream by its generator: a function of utils/streamgen.py,
utils/motion_stream.py or utils/sei_stream.py, its arguments and, for a
loss case, the NAL unit removed from the generated bytes, and for a
corrupted stream the seed of its byte flips (corrupt).
make_recorded_stream regenerates it here with the port's own modules.
"""

from __future__ import annotations

import numpy as np

from . import motion_stream, sei_stream, streamgen

MODULES = {"streamgen": streamgen, "motion_stream": motion_stream,
           "sei_stream": sei_stream}


def drop_nal(data: bytes, k: int) -> bytes:
    """The stream without its k-th NAL unit (0 is the first, the SPS of a
    streamgen stream), as a packet lost in transit."""
    starts = []
    at = data.find(b"\x00\x00\x00\x01")
    while at >= 0:
        starts.append(at)
        at = data.find(b"\x00\x00\x00\x01", at + 4)
    starts.append(len(data))
    return data[:starts[k]] + data[starts[k + 1]:]


def corrupt(data: bytes, seed: int) -> bytes:
    """The stream with 1-4 bytes flipped, drawn from
    numpy.random.default_rng(seed): each at a position drawn uniformly
    over [4, len) (everything after the first start code, parameter sets
    included), XORed with a value in 1-255, as damage in transit."""
    rng = np.random.default_rng(seed)
    out = bytearray(data)
    for _ in range(int(rng.integers(1, 5))):
        out[int(rng.integers(4, len(out)))] ^= int(rng.integers(1, 256))
    return bytes(out)


def make_recorded_stream(entry: dict, modules: dict = MODULES) -> bytes:
    """The bytes of a reference_checksums.json entry: {"maker", "args",
    optional "module" (default "streamgen"), "kwargs", "drop_nal",
    "corrupt": {"seed"}}, the flips applied after the NAL unit is
    dropped. `modules` maps module names to the modules that generate
    them."""
    fn = getattr(modules[entry.get("module", "streamgen")], entry["maker"])
    data = fn(*entry["args"], **entry.get("kwargs", {}))
    if "drop_nal" in entry:
        data = drop_nal(data, entry["drop_nal"])
    if "corrupt" in entry:
        data = corrupt(data, entry["corrupt"]["seed"])
    return data
