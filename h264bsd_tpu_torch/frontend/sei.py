"""SEI message decoding (host-side control plane).

The reference ships a complete SEI parser as dead code — h264bsd_sei.c is
never called; h264bsdDecode logs "SEI MESSAGE, NOT DECODED" and skips the
NAL (reference decoder.c:464-466). The rebuild goes further: the C++
front-end queues each SEI NAL's RBSP payload and this module decodes the
messages into plain dicts, covering every payload type the reference's
parser handles (h264bsd_sei.c:385-1694) plus raw passthrough for reserved
types. SEI NALs are rare and tiny, so this is host Python: nothing here
runs on the device. (The port's own copy of the JAX package's
frontend/sei.py.)

Spec-correctness deviations from the reference's (dead) code, both noted
at the parser in question:
 * buffering_period uses each HRD's own cpb_cnt / delay length (the
   reference passes the VCL HRD's values for both loops,
   h264bsd_sei.c:223-230);
 * dec_ref_pic_marking_repetition is fully decoded (the reference
   unconditionally returns HANTRO_NOK after two fields,
   h264bsd_sei.c:1008-1013).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

SEI_NAMES = {
    0: "buffering_period", 1: "pic_timing", 2: "pan_scan_rect",
    3: "filler_payload", 4: "user_data_registered_itu_t_t35",
    5: "user_data_unregistered", 6: "recovery_point",
    7: "dec_ref_pic_marking_repetition", 8: "spare_pic", 9: "scene_info",
    10: "sub_seq_info", 11: "sub_seq_layer_characteristics",
    12: "sub_seq_characteristics", 13: "full_frame_freeze",
    14: "full_frame_freeze_release", 15: "full_frame_snapshot",
    16: "progressive_refinement_segment_start",
    17: "progressive_refinement_segment_end",
    18: "motion_constrained_slice_group_set",
}

# numClockTS per pic_struct (H.264 Table D-1; reference h264bsd_sei.c:70)
_NUM_CLOCK_TS = (1, 1, 1, 2, 2, 3, 3, 2, 3)


class SeiParseError(ValueError):
    pass


class _Bits:
    """MSB-first bit reader over a bytes window."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # bit position

    def u(self, n: int) -> int:
        end = self.pos + n
        if end > 8 * len(self.data):
            raise SeiParseError("end of payload")
        v = 0
        p = self.pos
        while n:
            byte = self.data[p >> 3]
            avail = 8 - (p & 7)
            take = min(avail, n)
            v = (v << take) | ((byte >> (avail - take)) & ((1 << take) - 1))
            p += take
            n -= take
        self.pos = p
        return v

    def flag(self) -> bool:
        return self.u(1) == 1

    def ue(self) -> int:
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            if zeros > 32:
                raise SeiParseError("invalid exp-golomb code")
        return (1 << zeros) - 1 + (self.u(zeros) if zeros else 0)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k & 1 else -(k // 2)

    def bytes_left(self) -> int:
        return len(self.data) - ((self.pos + 7) >> 3)

    def more_data(self) -> bool:
        """RBSP has more than trailing bits left (h264bsdMoreRbspData
        util.c:152: more than one bit, or the last bits are not the
        stop-bit pattern)."""
        total = 8 * len(self.data)
        if self.pos >= total:
            return False
        # strip trailing zero bits then the stop bit
        last = total
        while last > self.pos and not (self.data[(last - 1) >> 3]
                                       >> (7 - ((last - 1) & 7))) & 1:
            last -= 1
        return last - 1 > self.pos


@dataclass
class SeiMessage:
    payload_type: int
    name: str
    payload: bytes                  # raw payload bytes
    fields: dict = field(default_factory=dict)


def _parse_buffering_period(b: _Bits, hrd_lookup):
    sps_id = b.ue()
    if sps_id > 31:
        raise SeiParseError("seq_parameter_set_id > 31")
    out = {"seq_parameter_set_id": sps_id}
    hrd = hrd_lookup(sps_id) if hrd_lookup else None
    if hrd is None:
        return out  # HRD geometry unknown: header only
    for which in ("nal", "vcl"):
        if not hrd[f"{which}_hrd_present"]:
            continue
        # spec-correct: each HRD's own cpb_cnt and delay length (the
        # reference's dead code reuses the VCL values for both,
        # h264bsd_sei.c:223-230)
        n = hrd[f"{which}_cpb_cnt"]
        ln = hrd[f"{which}_initial_len"]
        delays = [(b.u(ln), b.u(ln)) for _ in range(n)]
        out[f"{which}_initial_cpb_removal_delay"] = [d for d, _ in delays]
        out[f"{which}_initial_cpb_removal_delay_offset"] = \
            [o for _, o in delays]
    return out


def _parse_pic_timing(b: _Bits, hrd):
    out = {}
    if hrd is None:
        return out
    if hrd["nal_hrd_present"] or hrd["vcl_hrd_present"]:
        out["cpb_removal_delay"] = b.u(hrd["cpb_removal_delay_length"])
        out["dpb_output_delay"] = b.u(hrd["dpb_output_delay_length"])
    if hrd["pic_struct_present"]:
        pic_struct = b.u(4)
        if pic_struct > 8:
            raise SeiParseError("pic_struct > 8")
        out["pic_struct"] = pic_struct
        out["clock_timestamps"] = []
        for _ in range(_NUM_CLOCK_TS[pic_struct]):
            if not b.flag():
                out["clock_timestamps"].append(None)
                continue
            ts = {"ct_type": b.u(2), "nuit_field_based_flag": b.flag(),
                  "counting_type": b.u(5), }
            if ts["counting_type"] > 6:
                raise SeiParseError("counting_type > 6")
            full = b.flag()
            ts["discontinuity_flag"] = b.flag()
            ts["cnt_dropped_flag"] = b.flag()
            ts["n_frames"] = b.u(8)
            ts["seconds"] = ts["minutes"] = ts["hours"] = None
            if full:
                ts["seconds"], ts["minutes"], ts["hours"] = \
                    b.u(6), b.u(6), b.u(5)
            elif b.flag():                       # seconds_flag
                ts["seconds"] = b.u(6)
                if b.flag():                     # minutes_flag
                    ts["minutes"] = b.u(6)
                    if b.flag():                 # hours_flag
                        ts["hours"] = b.u(5)
            tol = hrd["time_offset_length"]
            if tol:
                raw = b.u(tol)
                # sign-extend tol-bit value (h264bsd_sei.c:652-659)
                ts["time_offset"] = raw - (1 << tol) if raw >> (tol - 1) \
                    else raw
            else:
                ts["time_offset"] = 0
            out["clock_timestamps"].append(ts)
    return out


def _parse_pan_scan_rect(b: _Bits):
    out = {"pan_scan_rect_id": b.ue(), "cancel": b.flag()}
    if not out["cancel"]:
        cnt = b.ue() + 1
        if cnt > 3:
            raise SeiParseError("pan_scan_cnt > 3")
        out["rects"] = [{"left": b.se(), "right": b.se(), "top": b.se(),
                         "bottom": b.se()} for _ in range(cnt)]
        rep = b.ue()
        if rep > 16384 or (cnt > 1 and rep > 1):
            raise SeiParseError("invalid repetition period")
        out["repetition_period"] = rep
    return out


def _parse_recovery_point(b: _Bits):
    out = {"recovery_frame_cnt": b.ue(), "exact_match_flag": b.flag(),
           "broken_link_flag": b.flag(),
           "changing_slice_group_idc": b.u(2)}
    if out["changing_slice_group_idc"] > 2:
        raise SeiParseError("changing_slice_group_idc > 2")
    return out


def _parse_marking_repetition(b: _Bits):
    # fully decoded (spec D.2.8); the reference's dead code bails with
    # HANTRO_NOK after original_frame_num (h264bsd_sei.c:1008-1013)
    out = {"original_idr_flag": b.flag(), "original_frame_num": b.ue()}
    if out["original_idr_flag"]:
        out["no_output_of_prior_pics_flag"] = b.flag()
        out["long_term_reference_flag"] = b.flag()
    elif b.flag():  # adaptive_ref_pic_marking_mode_flag
        ops = []
        while (op := b.ue()) != 0:
            if op > 6:
                raise SeiParseError("invalid MMCO op")
            entry = {"op": op}
            if op in (1, 3):
                entry["difference_of_pic_nums"] = b.ue() + 1
            if op == 2:
                entry["long_term_pic_num"] = b.ue()
            if op in (3, 6):
                entry["long_term_frame_idx"] = b.ue()
            if op == 4:
                entry["max_long_term_frame_idx_plus1"] = b.ue()
            ops.append(entry)
        out["mmco_ops"] = ops
    return out


def _parse_spare_pic(b: _Bits, pic_size_in_map_units):
    out = {"target_frame_num": b.ue()}
    if b.flag():  # spare_field_flag: fields rejected (h264bsd_sei.c:1045)
        raise SeiParseError("spare_field_flag set")
    n = b.ue() + 1
    if n > 16:
        raise SeiParseError("num_spare_pics > 16")
    pics = []
    for _ in range(n):
        pic = {"delta_spare_frame_num": b.ue(), "spare_area_idc": b.ue()}
        if pic["spare_area_idc"] > 2:
            raise SeiParseError("spare_area_idc > 2")
        if pic["spare_area_idc"] == 1:
            if not pic_size_in_map_units:
                raise SeiParseError("spare map without known pic size")
            pic["spare_unit_flag"] = [b.flag()
                                      for _ in range(pic_size_in_map_units)]
        elif pic["spare_area_idc"] == 2:
            if not pic_size_in_map_units:
                raise SeiParseError("spare map without known pic size")
            runs, total = [], 0
            while total < pic_size_in_map_units:
                r = b.ue()
                runs.append(r)
                total += r + 1
            pic["zero_run_length"] = runs
        pics.append(pic)
    out["spare_pics"] = pics
    return out


def _parse_scene_info(b: _Bits):
    if not b.flag():
        return {"scene_info_present_flag": False}
    out = {"scene_info_present_flag": True, "scene_id": b.ue(),
           "scene_transition_type": b.ue()}
    if out["scene_transition_type"] > 6:
        raise SeiParseError("scene_transition_type > 6")
    if out["scene_transition_type"]:
        out["second_scene_id"] = b.ue()
    return out


def _parse_sub_seq_info(b: _Bits):
    out = {"sub_seq_layer_num": b.ue(), "sub_seq_id": b.ue(),
           "first_ref_pic_flag": b.flag(),
           "leading_non_ref_pic_flag": b.flag(),
           "last_pic_flag": b.flag()}
    if out["sub_seq_layer_num"] > 255 or out["sub_seq_id"] > 65535:
        raise SeiParseError("sub_seq id out of range")
    if b.flag():
        out["sub_seq_frame_num"] = b.ue()
    return out


def _parse_sub_seq_layer_characteristics(b: _Bits):
    n = b.ue() + 1
    if n > 256:
        raise SeiParseError("num_sub_seq_layers > 256")
    return {"layers": [{"accurate_statistics_flag": b.flag(),
                        "average_bit_rate": b.u(16),
                        "average_frame_rate": b.u(16)} for _ in range(n)]}


def _parse_sub_seq_characteristics(b: _Bits):
    out = {"sub_seq_layer_num": b.ue(), "sub_seq_id": b.ue()}
    if out["sub_seq_layer_num"] > 255 or out["sub_seq_id"] > 65535:
        raise SeiParseError("sub_seq id out of range")
    if b.flag():
        out["sub_seq_duration"] = b.u(32)
    if b.flag():
        out["accurate_statistics_flag"] = b.flag()
        out["average_bit_rate"] = b.u(16)
        out["average_frame_rate"] = b.u(16)
    n = b.ue()
    if n > 255:
        raise SeiParseError("num_referenced_subseqs > 255")
    out["referenced_subseqs"] = [
        {"ref_sub_seq_layer_num": b.ue(), "ref_sub_seq_id": b.ue(),
         "ref_sub_seq_direction": b.u(1)} for _ in range(n)]
    return out


def _parse_motion_constrained_sgs(b: _Bits, num_slice_groups):
    n = b.ue() + 1
    if num_slice_groups and n > num_slice_groups:
        raise SeiParseError("more groups in set than slice groups")
    # ceilLog2NumSliceGroups table, h264bsd_sei.c:71 (1 group still reads
    # one bit)
    bits = 1 if num_slice_groups <= 2 else 2 if num_slice_groups <= 4 else 3
    ids = [b.u(bits) for _ in range(n)]
    if any(i > n - 1 for i in ids):
        raise SeiParseError("slice_group_id outside set")
    out = {"slice_group_ids": ids,
           "exact_sample_value_match_flag": b.flag(),
           "pan_scan_rect_flag": b.flag()}
    if out["pan_scan_rect_flag"]:
        out["pan_scan_rect_id"] = b.ue()
    return out


def parse_sei_rbsp(rbsp: bytes,
                   hrd_lookup: Callable[[int], dict | None] | None = None,
                   active_hrd: dict | None = None,
                   pic_size_in_map_units: int = 0,
                   num_slice_groups: int = 1) -> list[SeiMessage]:
    """Decode every SEI message in one SEI NAL's RBSP payload.

    hrd_lookup(sps_id) supplies the HRD geometry buffering_period needs
    (the message names its SPS); active_hrd supplies pic_timing's (taken
    from the active SPS). Both come from FrontendDecoder.sps_hrd(). A
    message whose payload cannot be decoded is returned with an "error"
    field and its raw payload; parsing continues with the next message
    (the payload-size framing makes messages independent)."""
    top = _Bits(rbsp)
    messages: list[SeiMessage] = []
    while True:
        ptype = 0
        while (v := top.u(8)) == 0xFF:
            ptype += 255
        ptype += v
        psize = 0
        while (v := top.u(8)) == 0xFF:
            psize += 255
        psize += v
        if top.pos & 7 or psize > top.bytes_left():
            raise SeiParseError("corrupt SEI framing")
        start = top.pos >> 3
        payload = rbsp[start:start + psize]
        top.pos += 8 * psize

        b = _Bits(payload)
        msg = SeiMessage(ptype, SEI_NAMES.get(ptype, f"reserved_{ptype}"),
                         payload)
        try:
            if ptype == 0:
                msg.fields = _parse_buffering_period(b, hrd_lookup)
            elif ptype == 1:
                msg.fields = _parse_pic_timing(b, active_hrd)
            elif ptype == 2:
                msg.fields = _parse_pan_scan_rect(b)
            elif ptype == 3:
                pass                               # filler: bytes only
            elif ptype == 4:
                country = b.u(8)
                ext = b.u(8) if country == 0xFF else None
                msg.fields = {"country_code": country,
                              "country_code_extension": ext,
                              "data": payload[2 if ext is not None else 1:]}
            elif ptype == 5:
                if psize < 16:
                    raise SeiParseError("user data shorter than UUID")
                msg.fields = {"uuid": payload[:16], "data": payload[16:]}
            elif ptype == 6:
                msg.fields = _parse_recovery_point(b)
            elif ptype == 7:
                msg.fields = _parse_marking_repetition(b)
            elif ptype == 8:
                msg.fields = _parse_spare_pic(b, pic_size_in_map_units)
            elif ptype == 9:
                msg.fields = _parse_scene_info(b)
            elif ptype == 10:
                msg.fields = _parse_sub_seq_info(b)
            elif ptype == 11:
                msg.fields = _parse_sub_seq_layer_characteristics(b)
            elif ptype == 12:
                msg.fields = _parse_sub_seq_characteristics(b)
            elif ptype == 13:
                msg.fields = {"repetition_period": b.ue()}
            elif ptype == 14:
                pass                               # no payload
            elif ptype == 15:
                msg.fields = {"snapshot_id": b.ue()}
            elif ptype == 16:
                msg.fields = {"progressive_refinement_id": b.ue(),
                              "num_refinement_steps": b.ue() + 1}
            elif ptype == 17:
                msg.fields = {"progressive_refinement_id": b.ue()}
            elif ptype == 18:
                msg.fields = _parse_motion_constrained_sgs(
                    b, num_slice_groups)
        except SeiParseError as exc:
            msg.fields = {"error": str(exc)}
        messages.append(msg)
        if not top.more_data():
            return messages
