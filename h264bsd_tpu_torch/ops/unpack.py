"""Device-side unpacking of the host front-end's compact transfer blob.

Per frame the host sends one blob (FrameTensors::build_blob_compact,
mbparse.cpp): a 16-word count header, packed per-MB records (8 B/MB),
the per-slice parameter table, per-MB slice ids for multi-slice
pictures, and sparse streams behind them at their real counts: MV/ref
exceptions at 8x8-quad grain, three weight classes of residual blocks
(4-byte single-coefficient records, 12-byte short blocks, 20-byte full
blocks with a wide-escape list) and nibble-packed intra payloads.
Everything is re-densified here with gathers and scatters on the device.

The section offsets are computed on the device from the blob's own count
header, as the JAX package's lax.dynamic_slice_in_dim does, so one
captured CUDA graph serves every frame of a blob shape. Each section is
gathered at its cap size, its start clamped so the slice fits the blob,
and entries past the real count are remapped to the padding id, so the
outputs have the same shapes and values as the JAX package's. All words
are handled as int64 masked to 32 bits.
"""

from __future__ import annotations

import numpy as np
import torch

from .consts import const

_U32 = 0xFFFFFFFF

# raster block b <-> quad-grouped position 4*q + j, where q is the 8x8
# quadrant (2*(b//8) + (b%4)//2) and j the raster position within it
# (2*((b//4)%2) + b%2). The permutation is an involution.
QUAD_PERM = np.array([0, 1, 4, 5, 2, 3, 6, 7,
                      8, 9, 12, 13, 10, 11, 14, 15])


def _spare_ids(ids, n_rows):
    """Map ids >= n_rows (padding) to one distinct spare row each."""
    cap = ids.shape[0]
    spare = n_rows + torch.arange(cap, device=ids.device)
    return torch.where(ids < n_rows, ids, spare)


def scatter_unique(base_rows, ids, updates, n_rows):
    """Scatter per-row updates into `base_rows` ((n_rows,) + row shape);
    padding ids (>= n_rows) land in distinct spare rows that are cut
    off. Returns a new (n_rows, ...) tensor."""
    cap = ids.shape[0]
    buf = torch.cat([base_rows, base_rows.new_zeros(
        (cap,) + tuple(base_rows.shape[1:]))], dim=0)
    buf[_spare_ids(ids.long(), n_rows)] = updates.to(base_rows.dtype)
    return buf[:n_rows]


def scatter_present(ids, updates, n_rows, dtype=None):
    """Scatter rows into a zeros buffer and return (buf, present):
    buf[(n_rows,) + row shape] with updates at their ids, present
    (n_rows,) bool marking written rows. Padding ids drop into spare
    rows."""
    cap = ids.shape[0]
    dtype = dtype or updates.dtype
    safe = _spare_ids(ids.long(), n_rows)
    buf = updates.new_zeros((n_rows + cap,) + tuple(updates.shape[1:]),
                            dtype=dtype)
    buf[safe] = updates.to(dtype)
    pres = torch.zeros(n_rows + cap, dtype=torch.bool, device=ids.device)
    pres.index_fill_(0, safe, True)
    return buf[:n_rows], pres[:n_rows]


def _sext(v, bits):
    """Sign-extend the low `bits` bits of an int64 tensor."""
    m = 1 << (bits - 1)
    return ((v & ((1 << bits) - 1)) ^ m) - m


def _bytes_of(words):
    """(k,) words -> (k, 4) unsigned byte values (little-endian, the
    host's memory order)."""
    shifts = torch.arange(0, 32, 8, device=words.device)
    return (words[:, None] >> shifts[None, :]) & 0xFF


def unpack_meta(packed, slice_table, mv_exc_ids, mv_exc_payload,
                intra_mbs, intra_payload, n_mbs, slice_ids=None,
                sparse_ids=None):
    """Rebuild the per-MB tensor dict from the compact streams.

    packed: (nMB, 2) record words (qp | flags<<8 | modes<<16 | ref<<24,
    then mv_base x13 | y13<<13 | nnz_dc<<26); slice_table: (S, 4) int8;
    slice_ids: (nMB,) table indices or None for single-slice pictures;
    mv_exc_*: quad-grained motion (ids = mb*4 + quadrant, payload
    (cap, 4) words); intra_*: sparse intra modes; sparse_ids: the
    residual block ids (mb*26 + b), from which the per-AC-block nnz bits
    are derived (I_PCM MBs are OR-ed in from mb_class). Padding entries
    carry out-of-range ids and are dropped. Dtypes follow the JAX
    package: uint8 / int8 / int16 as there, uint32 fields as int64.
    """
    n = n_mbs
    dev = packed.device
    w0 = packed[:, 0]
    t = {}
    if slice_ids is None or slice_ids.shape[0] == 0:
        t["slice_id"] = torch.zeros(n, dtype=torch.int64, device=dev)
    else:
        t["slice_id"] = slice_ids.long()
    t["qp_y"] = (w0 & 0xFF).to(torch.uint8)
    flags = (w0 >> 8) & 0xFF
    t["mb_class"] = (flags & 7).to(torch.uint8)
    t["disable_dblk"] = ((flags >> 3) & 3).to(torch.uint8)
    av3 = (flags >> 5) & 7
    t["mb_avail"] = ((av3 & 3) | ((av3 >> 2) << 3)).to(torch.int32)
    modes = (w0 >> 16) & 0xFF
    t["i16_mode"] = (modes & 3).to(torch.int32)
    t["chroma_mode"] = ((modes >> 2) & 3).to(torch.int32)
    ref_base = _sext(w0 >> 24, 8)
    w1 = packed[:, 1]
    mv_base = torch.stack([_sext(w1, 13), _sext(w1 >> 13, 13)], dim=-1)
    t["nnz_dc"] = ((w1[:, None] >> (26 + torch.arange(3, device=dev)))
                   & 1).to(torch.int32)

    # per-AC-block nnz bits: presence of each sparse residual AC block
    # id, then OR in I_PCM MBs (class 5)
    if sparse_ids is None:
        sparse_ids = torch.zeros(0, dtype=torch.int64, device=dev)
    sid = sparse_ids.reshape(-1).long()
    s_mb = sid // 26
    s_b = sid % 26
    is_ac = (sid < n * 26) & (s_b < 24)
    pres = torch.zeros(n * 24 + sid.shape[0], dtype=torch.bool, device=dev)
    pres.index_fill_(0, torch.where(
        is_ac, s_mb * 24 + s_b,
        n * 24 + torch.arange(sid.shape[0], device=dev)), True)
    nnz = pres[:n * 24].reshape(n, 24).to(torch.int32)
    t["nnz"] = torch.where((t["mb_class"] == 5)[:, None], 1, nnz).to(
        torch.int32)

    # per-slice deblock parameters; concealed MBs override them with
    # zeros (ConcealMb conceal.c:388-392)
    rows = slice_table.long()[t["slice_id"]]
    rows = torch.where((t["mb_class"] == 6)[:, None], 0, rows)
    t["filter_off_a"] = rows[:, 0].to(torch.int8)
    t["filter_off_b"] = rows[:, 1].to(torch.int8)
    t["chroma_qp_offset"] = rows[:, 2].to(torch.int8)

    # dense MV/ref from quad-grained exceptions: one raw-payload scatter
    # plus presence, merged with the per-MB base; QUAD_PERM maps the
    # quad-grouped block order back to raster (its own inverse)
    raw, qpres = scatter_present(mv_exc_ids.reshape(-1), mv_exc_payload,
                                 n * 4, torch.int64)        # (n*4, 4)
    qp_ = qpres[:, None]
    mvx = torch.where(qp_, _sext(raw, 13),
                      mv_base[:, 0].repeat_interleave(4)[:, None])
    mvy = torch.where(qp_, _sext(raw >> 13, 13),
                      mv_base[:, 1].repeat_interleave(4)[:, None])
    ref_qg = torch.where(qp_, ((raw >> 26) & 0x3F) - 1,
                         ref_base.repeat_interleave(4)[:, None])
    perm = const("QUAD_PERM", QUAD_PERM, dev, torch.int64)
    mv_qg = torch.stack([mvx, mvy], dim=-1).to(torch.int16)
    t["mv"] = mv_qg.reshape(n, 16, 2)[:, perm]
    t["ref_slot"] = ref_qg.to(torch.int8).reshape(n, 16)[:, perm]

    # dense intra modes/avail from the nibble payloads (mode | avail << 4)
    nib = scatter_unique(torch.zeros((n, 16), dtype=torch.uint8, device=dev),
                         intra_mbs.reshape(-1), intra_payload, n)
    t["i4_modes"] = nib & 0xF
    t["i4_avail"] = nib >> 4
    return t


def widen_words(words32):
    """int32 blob words -> int64 masked to 32 bits (the unsigned words)."""
    return words32.long() & _U32


def blob_words(blob: np.ndarray, device) -> torch.Tensor:
    """Ship a host u8 blob (4-byte aligned) to `device` as int32 words
    and widen them there to int64 masked to 32 bits."""
    w = torch.from_numpy(np.ascontiguousarray(blob).view(np.int32))
    return widen_words(w.to(device, non_blocking=True))


def _sections(n, caps):
    """The blob's sections behind the 16-word header, in order
    (FrameTensors::build_blob_compact): (words gathered, header word of
    the section's real count or -1, words the section advances per
    counted entry, or in all when the count is -1)."""
    single, short, full, wide, exc, intra, stab, sid = caps
    return [(n * 2, -1, n * 2),                  # packed per-MB records
            (stab, 6, 1),                         # slice table
            (sid // 2, -1, sid // 2),             # per-MB slice ids
            (exc * 4, 4, 4),                      # exception payloads
            (single, 0, 1),                       # single records
            (short * 2, 1, 2),                    # short levels
            (intra * 4, 5, 4),                    # intra payloads
            (full * 4, 2, 4),                     # full levels
            (short, 1, 1),                        # short ids
            (exc, 4, 1),                          # exception ids
            (intra, 5, 1),                        # intra MB ids
            (full, 2, 1),                         # full ids
            (wide, 3, 1),                         # wide escape ids
            (wide, 3, 1)]                         # wide escape values


def _gather_index(n, caps, device):
    """Cached per (n, caps, device): the sections' tables (count word
    index with 7 = none, advance multiplier, words) and, per gathered
    word, its section and its position in the section."""
    key = f"unpack{n}:{caps}"
    secs = _sections(n, caps)
    lengths = np.array([s[0] for s in secs], np.int64)
    cidx = np.array([s[1] if s[1] >= 0 else 7 for s in secs], np.int64)
    mult = np.array([s[2] for s in secs], np.int64)
    fixed = np.where(cidx == 7, mult, 0)
    mult = np.where(cidx == 7, 0, mult)
    sec = np.repeat(np.arange(len(secs)), lengths)
    pos = np.arange(lengths.sum()) - np.repeat(np.cumsum(lengths) - lengths,
                                               lengths)
    tables = np.stack([cidx, mult, fixed, lengths])
    return (const(key + "tables", tables, device),
            const(key + "sec", sec, device),
            const(key + "pos", pos, device), lengths.tolist())


def unpack_blob(words, n_mbs, single_cap, short_cap, full_cap, wide_cap,
                exc_cap, intra_cap, stab_cap, sid_cap=0):
    """Split the compact blob (int64 words, see blob_words) into the
    eight streams, with the section offsets taken from the blob's count
    header on the device (no host read, so the same work serves every
    frame of a blob shape).

    Returns (packed, slice_table, sparse_ids, sparse_levels, exc_ids,
    exc_payload, intra_ids, intra_payload, slice_ids) with the JAX
    package's shapes: every section cap-sized, ids past the real count
    set to the padding id."""
    n = n_mbs
    dev = words.device
    caps = (single_cap, short_cap, full_cap, wide_cap, exc_cap, intra_cap,
            stab_cap, sid_cap)
    tables, sec, pos, lengths = _gather_index(n, caps, dev)
    cidx, mult, fixed, length = tables
    hdr = words[:16]
    counts = torch.cat([hdr[:7], hdr.new_zeros(1)])   # [7]: no count
    # section starts: 16 + the advances of the sections before, clamped
    # as dynamic_slice clamps so every slice fits the blob
    adv = counts[cidx] * mult + fixed
    off = 16 + torch.cumsum(adv, 0) - adv
    start = torch.minimum(off, words.shape[0] - length).clamp(min=0)
    (packed, stab, sw, epay, sgl, sht, ipay, full, sht_ids, eids, iids,
     ids, wide_ids, wide_vals) = words[start[sec] + pos].split(lengths)
    c_sgl, c_sht, c_full, c_wide, c_exc, c_intra = counts[:6]

    def mask_ids(ids, cnt, pad):
        keep = torch.arange(ids.shape[0], device=dev) < cnt
        return torch.where(keep, ids, pad)

    packed = packed.reshape(n, 2)
    stab = _sext(_bytes_of(stab).reshape(stab_cap, 4), 8).to(torch.int8)
    sids = None
    if sid_cap:
        sids = torch.stack([sw & 0xFFFF, sw >> 16], dim=-1).reshape(-1)[:n]
    epay = epay.reshape(-1, 4)

    # single records: word = id << 12 | pos << 8 | (value & 0xFF)
    sgl_val = _sext(sgl, 8)
    sgl_pos = (sgl >> 8) & 15
    sht8 = _sext(_bytes_of(sht), 8).reshape(short_cap, 8)
    sht_lv = torch.cat([sht8, torch.zeros_like(sht8)], dim=1)
    ipay = _bytes_of(ipay).to(torch.uint8).reshape(-1, 16)
    lv8 = _sext(_bytes_of(full), 8).reshape(-1)
    # padded full entries may carry bytes of following sections; zero
    # them so the wide-escape scatter base is clean
    lv8 = torch.where(torch.arange(full_cap * 16, device=dev) < c_full * 16,
                      lv8, 0)

    sht_ids = mask_ids(sht_ids, c_sht, n * 26)
    eids = mask_ids(eids, c_exc, n * 4)
    iids = mask_ids(iids, c_intra, n)
    ids = mask_ids(ids, c_full, n * 26)
    wide_ids = mask_ids(wide_ids, c_wide, full_cap * 16)
    sgl_ids = mask_ids(sgl >> 12, c_sgl, n * 26)
    sgl_lv = torch.where(sgl_pos[:, None] == torch.arange(16, device=dev),
                         sgl_val[:, None], 0)

    # wide escapes: int32 values, narrowed to int16 as the JAX package does
    flat = torch.cat([lv8, torch.zeros(wide_cap, dtype=torch.int64,
                                       device=dev)])
    flat[_spare_ids(wide_ids, full_cap * 16)] = _sext(wide_vals, 16)
    full_lv = flat[:full_cap * 16].reshape(full_cap, 16)

    all_ids = torch.cat([sgl_ids, sht_ids, ids])
    all_lv = torch.cat([sgl_lv, sht_lv, full_lv]).to(torch.int16)
    return packed, stab, all_ids, all_lv, eids, epay, iids, ipay, sids


def compact_blob_words(counts, n_mbs, caps):
    """(real_words, need_words) of a compact blob: real_words is the
    written compact size; need_words keeps every cap-sized section slice
    in bounds (see unpack_blob). counts = blob_counts order; caps =
    unpack caps."""
    c0, c1, c2, c3, c4, c5, c6 = (int(x) for x in counts[:7])
    sgl, sht, full, wide, exc, intra, stab, sid = caps
    c0, c1, c2, c3, c4, c5, c6 = (min(c0, sgl), min(c1, sht),
                                  min(c2, full), min(c3, wide),
                                  min(c4, exc), min(c5, intra),
                                  min(c6, stab))
    # section order mirrors build_blob_compact: header, packed, stab,
    # sid, then variable sections by descending cap size
    sizes_real = [16, n_mbs * 2, c6, sid // 2, 4 * c4, c0, 2 * c1,
                  4 * c5, 4 * c2, c1, c4, c5, c2, c3, c3]
    sizes_cap = [16, n_mbs * 2, stab, sid // 2, 4 * exc, sgl, 2 * sht,
                 4 * intra, 4 * full, sht, exc, intra, full, wide, wide]
    real = sum(sizes_real)
    need = 0
    off = 0
    for r, c in zip(sizes_real, sizes_cap):
        need = max(need, off + c)
        off += r
    return real, max(need, real)
