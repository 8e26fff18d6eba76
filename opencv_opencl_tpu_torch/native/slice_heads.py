"""The H.264 slice headers that the native entropy coders take as packed bits.

The port's copies of ``_BitWriter`` (``opencv_opencl_tpu/io/h264_pcm.py``,
the parts a slice header uses), ``_slice_head_cavlc``
(``io/h264_cavlc.py``) and ``_slice_head_p`` (``io/h264_inter.py``): the
bitstream layout stays in Python, the C++ library owns the hot loop, and
the same arguments give the same bits as the JAX package's.
"""

from __future__ import annotations

import numpy as np

__all__ = ["BitWriter", "slice_head_cavlc", "slice_head_p", "packed"]


class BitWriter:
    def __init__(self) -> None:
        self._bits: list[int] = []

    def u(self, value: int, n: int) -> "BitWriter":
        for i in range(n - 1, -1, -1):
            self._bits.append((value >> i) & 1)
        return self

    def ue(self, value: int) -> "BitWriter":
        # Exp-Golomb: leading zeros + binary(value+1)
        code = value + 1
        n = code.bit_length()
        return self.u(code, 2 * n - 1)

    def se(self, value: int) -> "BitWriter":
        return self.ue(2 * value - 1 if value > 0 else -2 * value)


def _deblock(w: BitWriter, deblock: bool, slice_local: bool) -> None:
    if deblock:
        # disable_deblocking_filter_idc: 0 = filter everywhere,
        # 2 = filter but not across slice boundaries (GDR+deblock)
        w.ue(2 if slice_local else 0)
        w.se(0)                # slice_alpha_c0_offset_div2
        w.se(0)                # slice_beta_offset_div2
    else:
        w.ue(1)                # disable_deblocking_filter_idc: OFF


def slice_head_cavlc(w: BitWriter, idr_pic_id: int, qp: int,
                     first_mb: int = 0, deblock: bool = False,
                     slice_local: bool = False) -> None:
    """IDR I slice header."""
    w.u(0, 1).u(3, 2).u(5, 5)  # nal header: IDR slice
    w.ue(first_mb)             # first_mb_in_slice
    w.ue(7)                    # slice_type: I (all slices of picture)
    w.ue(0)                    # pic_parameter_set_id
    w.u(0, 4)                  # frame_num
    w.ue(idr_pic_id)
    w.u(0, 1)                  # no_output_of_prior_pics_flag
    w.u(0, 1)                  # long_term_reference_flag
    w.se(qp - 26)              # slice_qp_delta
    _deblock(w, deblock, slice_local)


def slice_head_p(w: BitWriter, qp: int, frame_num: int,
                 first_mb: int = 0, active_refs: int = 1,
                 deblock: bool = False, slice_local: bool = False) -> None:
    """Non-IDR P slice header (POC type 2: no POC syntax, sliding-window
    marking); ``active_refs`` > 1 overrides the PPS's single active
    reference."""
    w.u(0, 1).u(2, 2).u(1, 5)  # nal: ref_idc=2, non-IDR slice
    w.ue(first_mb)             # first_mb_in_slice
    w.ue(5)                    # slice_type: P (all slices of picture)
    w.ue(0)                    # pic_parameter_set_id
    w.u(frame_num & 0xF, 4)    # frame_num (log2_max_frame_num = 4)
    if active_refs > 1:
        w.u(1, 1)              # num_ref_idx_active_override_flag
        w.ue(active_refs - 1)  # num_ref_idx_l0_active_minus1
    else:
        w.u(0, 1)              # num_ref_idx_active_override_flag
    w.u(0, 1)                  # ref_pic_list_modification_flag_l0
    w.u(0, 1)                  # adaptive_ref_pic_marking_mode_flag
    w.se(qp - 26)              # slice_qp_delta
    _deblock(w, deblock, slice_local)


def packed(w: BitWriter) -> tuple[np.ndarray, int]:
    """The header's bits packed MSB first, and their count."""
    return np.packbits(np.asarray(w._bits, dtype=np.uint8)), len(w._bits)
