"""SPS / PPS / slice-header syntax (norm 7.3.2; reference
headers_and_parameter_sets.cpp).

Parsing covers exactly the envelope the reference decoder accepts
(Baseline, CAVLC, frame_mbs_only, ChromaArrayType 1). Writing reproduces the
reference encoder's hardwired choices byte-for-byte (profile 66 / level 41 /
log2_max_frame_num 9 / poc type 0 / 1 ref frame / no VUI,
headers_and_parameter_sets.cpp:305-392,478-513) so that our parameter sets
are diffable against reference streams.

A copy of h264_fer_tpu/bitstream/params.py, plus `parameter_sets`, which
writes the SPS and PPS NAL units that open every stream.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from . import nal as nal_mod
from .bitio import BitReader, BitWriter
from .expgolomb import read_se, read_ue, write_se, write_ue

P_SLICE = 0
B_SLICE = 1
I_SLICE = 2
SP_SLICE = 3
SI_SLICE = 4


@dataclass
class SPS:
    profile_idc: int = 66
    constraint_set0_flag: int = 1
    constraint_set1_flag: int = 1
    constraint_set2_flag: int = 0
    level_idc: int = 41
    seq_parameter_set_id: int = 0
    log2_max_frame_num: int = 9
    pic_order_cnt_type: int = 0
    log2_max_pic_order_cnt_lsb: int = 10
    max_num_ref_frames: int = 1
    gaps_in_frame_num_value_allowed_flag: int = 0
    pic_width_in_mbs: int = 0
    pic_height_in_map_units: int = 0
    frame_mbs_only_flag: int = 1
    mb_adaptive_frame_field_flag: int = 0
    direct_8x8_inference_flag: int = 1
    frame_cropping_flag: int = 0
    vui_parameters_present_flag: int = 0

    @property
    def max_frame_num(self) -> int:
        return 1 << self.log2_max_frame_num

    @property
    def width(self) -> int:
        return self.pic_width_in_mbs * 16

    @property
    def height(self) -> int:
        return self.pic_height_in_map_units * 16

    def write(self, w: BitWriter) -> None:
        """Reference sps_write, headers_and_parameter_sets.cpp:305-392."""
        w.write(self.profile_idc, 8)
        w.write_flag(self.constraint_set0_flag)
        w.write_flag(self.constraint_set1_flag)
        w.write_flag(self.constraint_set2_flag)
        w.write(0, 5)
        w.write(self.level_idc, 8)
        write_ue(w, self.seq_parameter_set_id)
        write_ue(w, self.log2_max_frame_num - 4)
        write_ue(w, self.pic_order_cnt_type)
        if self.pic_order_cnt_type == 0:
            write_ue(w, self.log2_max_pic_order_cnt_lsb - 4)
        else:
            raise NotImplementedError("encoder emits pic_order_cnt_type 0 only")
        write_ue(w, self.max_num_ref_frames)
        w.write_flag(self.gaps_in_frame_num_value_allowed_flag)
        write_ue(w, self.pic_width_in_mbs - 1)
        write_ue(w, self.pic_height_in_map_units - 1)
        w.write_flag(self.frame_mbs_only_flag)
        if not self.frame_mbs_only_flag:
            w.write_flag(self.mb_adaptive_frame_field_flag)
        w.write_flag(self.direct_8x8_inference_flag)
        w.write_flag(self.frame_cropping_flag)
        w.write_flag(self.vui_parameters_present_flag)

    @classmethod
    def parse(cls, r: BitReader) -> "SPS":
        """Reference fill_sps, headers_and_parameter_sets.cpp:398-475."""
        s = cls()
        s.profile_idc = r.read(8)
        s.constraint_set0_flag = r.read(1)
        s.constraint_set1_flag = r.read(1)
        s.constraint_set2_flag = r.read(1)
        r.read(5)
        s.level_idc = r.read(8)
        s.seq_parameter_set_id = read_ue(r)
        s.log2_max_frame_num = read_ue(r) + 4
        s.pic_order_cnt_type = read_ue(r)
        if s.pic_order_cnt_type == 0:
            s.log2_max_pic_order_cnt_lsb = read_ue(r) + 4
        elif s.pic_order_cnt_type == 1:
            r.read(1)
            read_se(r)
            read_se(r)
            for _ in range(read_ue(r)):
                read_se(r)
        s.max_num_ref_frames = read_ue(r)
        s.gaps_in_frame_num_value_allowed_flag = r.read(1)
        s.pic_width_in_mbs = read_ue(r) + 1
        s.pic_height_in_map_units = read_ue(r) + 1
        s.frame_mbs_only_flag = r.read(1)
        if not s.frame_mbs_only_flag:
            s.mb_adaptive_frame_field_flag = r.read(1)
        s.direct_8x8_inference_flag = r.read(1)
        s.frame_cropping_flag = r.read(1)
        s.vui_parameters_present_flag = r.read(1)
        return s


@dataclass
class PPS:
    pic_parameter_set_id: int = 0
    seq_parameter_set_id: int = 0
    entropy_coding_mode_flag: int = 0
    bottom_field_pic_order_in_frame: int = 0
    num_slice_groups: int = 1
    num_ref_idx_l0_active: int = 1
    num_ref_idx_l1_active: int = 1
    weighted_pred_flag: int = 0
    weighted_bipred_idc: int = 0
    pic_init_qp: int = 26
    pic_init_qs: int = 26
    chroma_qp_index_offset: int = 0
    deblocking_filter_control_present_flag: int = 0
    constrained_intra_pred_flag: int = 0
    redundant_pic_cnt_present_flag: int = 0

    def write(self, w: BitWriter, compat_weighted_bipred_quirk: bool = True) -> None:
        """Reference pps_write, headers_and_parameter_sets.cpp:478-513.

        The reference writes `num_ref_idx_l1_active` (== 1) into the 2-bit
        weighted_bipred_idc field (headers_and_parameter_sets.cpp:504) — a
        benign quirk (the field is ignored for P slices). We reproduce it by
        default so our PPS bytes equal the reference's.
        """
        write_ue(w, self.pic_parameter_set_id)
        write_ue(w, self.seq_parameter_set_id)
        w.write_flag(self.entropy_coding_mode_flag)
        w.write_flag(self.bottom_field_pic_order_in_frame)
        write_ue(w, self.num_slice_groups - 1)
        write_ue(w, self.num_ref_idx_l0_active - 1)
        write_ue(w, self.num_ref_idx_l1_active - 1)
        w.write_flag(self.weighted_pred_flag)
        if compat_weighted_bipred_quirk:
            w.write(self.num_ref_idx_l1_active, 2)
        else:
            w.write(self.weighted_bipred_idc, 2)
        write_se(w, self.pic_init_qp - 26)
        write_se(w, self.pic_init_qs - 26)
        write_se(w, self.chroma_qp_index_offset)
        w.write_flag(self.deblocking_filter_control_present_flag)
        w.write_flag(self.constrained_intra_pred_flag)
        w.write_flag(self.redundant_pic_cnt_present_flag)

    @classmethod
    def parse(cls, r: BitReader) -> "PPS":
        """Reference fill_pps, headers_and_parameter_sets.cpp:519-537."""
        p = cls()
        p.pic_parameter_set_id = read_ue(r)
        p.seq_parameter_set_id = read_ue(r)
        p.entropy_coding_mode_flag = r.read(1)
        p.bottom_field_pic_order_in_frame = r.read(1)
        p.num_slice_groups = read_ue(r) + 1
        p.num_ref_idx_l0_active = read_ue(r) + 1
        p.num_ref_idx_l1_active = read_ue(r) + 1
        p.weighted_pred_flag = r.read(1)
        p.weighted_bipred_idc = r.read(2)
        p.pic_init_qp = read_se(r) + 26
        p.pic_init_qs = read_se(r) + 26
        p.chroma_qp_index_offset = read_se(r)
        p.deblocking_filter_control_present_flag = r.read(1)
        p.constrained_intra_pred_flag = r.read(1)
        p.redundant_pic_cnt_present_flag = r.read(1)
        return p


@dataclass
class SliceHeader:
    first_mb_in_slice: int = 0
    slice_type: int = I_SLICE
    pic_parameter_set_id: int = 0
    frame_num: int = 0
    idr_pic_id: int = 0
    pic_order_cnt_lsb: int = 0
    num_ref_idx_active_override_flag: int = 0
    num_ref_idx_l0_active_minus1: int = 0
    ref_pic_list_modification_flag_l0: int = 0
    # list of (modification_of_pic_nums_idc, argument) pairs, ending idc==3
    ref_pic_list_modifications: list = field(default_factory=list)
    no_output_of_prior_pics_flag: int = 0
    long_term_reference_flag: int = 0
    adaptive_ref_pic_marking_mode_flag: int = 0
    # list of (memory_management_control_operation, args tuple)
    mmco_ops: list = field(default_factory=list)
    slice_qp_delta: int = 0
    disable_deblocking_filter_idc: int = 0
    slice_alpha_c0_offset_div2: int = 0
    slice_beta_offset_div2: int = 0

    def write(self, w: BitWriter, sps: SPS, pps: PPS, nal_unit_type: int,
              nal_ref_idc: int = 1) -> None:
        """Reference shd_write, headers_and_parameter_sets.cpp:172-239."""
        write_ue(w, self.first_mb_in_slice)
        write_ue(w, self.slice_type)
        write_ue(w, self.pic_parameter_set_id)
        w.write(self.frame_num, sps.log2_max_frame_num)
        if nal_unit_type == 5:
            write_ue(w, self.idr_pic_id)
        w.write(self.pic_order_cnt_lsb, sps.log2_max_pic_order_cnt_lsb)
        if self.slice_type % 5 in (P_SLICE, B_SLICE, SP_SLICE):
            w.write_flag(self.num_ref_idx_active_override_flag)
            if self.num_ref_idx_active_override_flag:
                write_ue(w, self.num_ref_idx_l0_active_minus1)
            w.write_flag(self.ref_pic_list_modification_flag_l0)
            if self.ref_pic_list_modification_flag_l0:
                raise NotImplementedError(
                    "encoder never emits ref pic list modifications "
                    "(reference headers_and_parameter_sets.cpp:15)")
        if nal_ref_idc != 0:
            if nal_unit_type == 5:
                w.write_flag(self.no_output_of_prior_pics_flag)
                w.write_flag(self.long_term_reference_flag)
            else:
                w.write_flag(self.adaptive_ref_pic_marking_mode_flag)
                if self.adaptive_ref_pic_marking_mode_flag:
                    raise NotImplementedError("encoder never emits MMCO ops")
        write_se(w, self.slice_qp_delta)
        if pps.deblocking_filter_control_present_flag:
            write_ue(w, self.disable_deblocking_filter_idc)
            if self.disable_deblocking_filter_idc != 1:
                write_se(w, self.slice_alpha_c0_offset_div2)
                write_se(w, self.slice_beta_offset_div2)

    @classmethod
    def parse(cls, r: BitReader, sps: SPS, pps: PPS, nal_unit_type: int,
              nal_ref_idc: int) -> "SliceHeader":
        """Reference fill_shd, headers_and_parameter_sets.cpp:245-298."""
        h = cls()
        h.first_mb_in_slice = read_ue(r)
        h.slice_type = read_ue(r)
        h.pic_parameter_set_id = read_ue(r)
        h.frame_num = r.read(sps.log2_max_frame_num)
        if nal_unit_type == 5:
            h.idr_pic_id = read_ue(r)
        h.pic_order_cnt_lsb = r.read(sps.log2_max_pic_order_cnt_lsb)
        if h.slice_type % 5 in (P_SLICE, B_SLICE, SP_SLICE):
            h.num_ref_idx_active_override_flag = r.read(1)
            if h.num_ref_idx_active_override_flag:
                h.num_ref_idx_l0_active_minus1 = read_ue(r)
            # ref_pic_list_modification (7.3.3.1)
            h.ref_pic_list_modification_flag_l0 = r.read(1)
            if h.ref_pic_list_modification_flag_l0:
                while True:
                    idc = read_ue(r)
                    if idc == 3:
                        h.ref_pic_list_modifications.append((3, 0))
                        break
                    arg = read_ue(r)
                    h.ref_pic_list_modifications.append((idc, arg))
        if nal_ref_idc != 0:
            # dec_ref_pic_marking (7.3.3.3)
            if nal_unit_type == 5:
                h.no_output_of_prior_pics_flag = r.read(1)
                h.long_term_reference_flag = r.read(1)
            else:
                h.adaptive_ref_pic_marking_mode_flag = r.read(1)
                if h.adaptive_ref_pic_marking_mode_flag:
                    while True:
                        op = read_ue(r)
                        if op == 0:
                            h.mmco_ops.append((0, ()))
                            break
                        args = []
                        if op in (1, 3):
                            args.append(read_ue(r))
                        if op == 2:
                            args.append(read_ue(r))
                        if op in (3, 6):
                            args.append(read_ue(r))
                        if op == 4:
                            args.append(read_ue(r))
                        h.mmco_ops.append((op, tuple(args)))
        h.slice_qp_delta = read_se(r)
        if pps.deblocking_filter_control_present_flag:
            h.disable_deblocking_filter_idc = read_ue(r)
            if h.disable_deblocking_filter_idc != 1:
                h.slice_alpha_c0_offset_div2 = read_se(r)
                h.slice_beta_offset_div2 = read_se(r)
        return h

    def slice_qp_y(self, pps: PPS) -> int:
        return pps.pic_init_qp + self.slice_qp_delta


def parameter_sets(sps: SPS, pps: PPS) -> bytes:
    """The SPS and PPS NAL units."""
    out = b""
    for ps, nal_type in ((sps, nal_mod.NAL_SPS), (pps, nal_mod.NAL_PPS)):
        w = BitWriter()
        ps.write(w)
        w.rbsp_trailing_bits()
        out += nal_mod.write_nal_unit(1, nal_type, w.getvalue())
    return out
