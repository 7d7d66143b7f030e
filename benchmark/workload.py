"""The benchmark's one generator of inputs: a cell's configuration (its
file under configs/) and traffic mix (its file under traffic/) and the
run's --seed give the streams the program decodes and the syntax records
the reference decodes again.

A configuration fixes the picture size in MBs, the number of concurrent
streams, the GOP (an IDR picture, then P pictures), the references and
the QPs (one per stream, drawn from `qp`). A traffic mix fixes how many
distinct GOPs each stream has (`gops`: the stream cycles through them
until the window ends, so the window never restarts a decoder) and how
the loop drives them (drivers.py). Every seed gives each stream the same
number of GOPs of the same size and structure; only the content differs.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np

import streamgen

HERE = Path(__file__).resolve().parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def config_of(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def traffic_of(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


@dataclass
class Streams:
    """The cell's inputs. gops[i][g]: (bytes, [streamgen.Picture]) of GOP
    g of stream i; qp[i]: stream i's QP."""
    width_mbs: int
    height_mbs: int
    gop_len: int
    num_ref_frames: int
    qp: list
    gops: list

    @property
    def n_streams(self):
        return len(self.gops)

    @property
    def n_gops(self):
        return len(self.gops[0])

    def cycle(self, i: int, n_pictures: int) -> bytes:
        """Stream i: its GOPs in turn, whole cycles, at least n_pictures
        pictures."""
        per = self.gop_len * self.n_gops
        reps = max(1, math.ceil(n_pictures / per))
        return b"".join(data for data, _ in self.gops[i]) * reps

    def gop_of(self, n: int):
        """(GOP, index in it) of the stream's n-th output picture."""
        return (n // self.gop_len) % self.n_gops, n % self.gop_len


def _gop_task(args):
    w, h, n, seed, qp, refs = args
    return streamgen.make_motion_gop(w, h, n, seed, qp, refs)


def make_streams(config: dict, traffic: dict, seed: int, pool=None) -> Streams:
    """Draw the cell's streams from seed: the streams' QPs, config["qp"]
    repeated to the number of streams in an order drawn from the seed (so
    every seed decodes the same mix of QPs), and each GOP's own seed;
    then write the GOPs (in pool, a multiprocessing pool, when given)."""
    rng = np.random.default_rng(seed)
    n, g = config["streams"], traffic["gops"]
    qps = [int(q) for q in rng.permutation(np.resize(config["qp"], n))]
    seeds = rng.integers(0, 2 ** 62, size=(n, g))
    tasks = [(config["width_mbs"], config["height_mbs"], config["gop_len"],
              int(seeds[i, k]), qps[i], config["num_ref_frames"])
             for i in range(n) for k in range(g)]
    done = pool.map(_gop_task, tasks) if pool is not None else \
        [_gop_task(t) for t in tasks]
    return Streams(config["width_mbs"], config["height_mbs"],
                   config["gop_len"], config["num_ref_frames"], qps,
                   [done[i * g:(i + 1) * g] for i in range(n)])
