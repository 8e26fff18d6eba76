"""CPB/HRD leaky-bucket rate control (spec Annex C / E) for the in-repo
encoders.

The reference's VCU runs a buffer-model-constrained controller —
``control-rate=low-latency cpb-size=500 initial-delay=250``
(``OpenCVequalHist.cpp:313-314``): the decoder waits
``initial-delay`` ms, then removes one picture per tick, and the
encoder must never produce a burst the channel cannot deliver by a
picture's removal deadline.  The proportional/windowed QP controllers
in io.h264_cavlc / io.h264_inter shape the AVERAGE rate but have no
buffer model — a burst of large frames can violate any declared CPB.
This module adds the missing hard constraint:

- :class:`CpbModel` — the encoder-side schedule model.  Frame k is
  produced at ``k/fps`` and transmitted at the declared bit rate over
  a busy channel; its transmission-completion slack
  ``S_k = max(S_{k-1} - 1/fps, 0) + b_k/R`` must stay within the
  initial delay (else the decoder underflows its removal deadline —
  the low-latency violation), and no single picture may exceed the
  declared CPB size.  ``budget_bits()`` is the largest next-frame size
  that keeps both; encoders re-encode at a higher QP when an AU
  exceeds it (QP +6 halves intra bits, so the loop converges in a few
  steps).
- :class:`HrdParams` — writes the declared model into the SPS VUI
  (E.1.1/E.1.2: timing_info + nal_hrd_parameters with
  ``low_delay_hrd_flag=1``), so the stream *carries* the contract the
  encoder enforces.

tests/test_h264_hrd.py verifies zero violations from first principles:
an independent decoder-side simulation (arrival curve vs. removal
schedule) over adversarial content, not the encoder's own model.

The port's own copy of ``opencv_opencl_tpu/io/h264_hrd.py``: the same
CPB arithmetic.
"""

from __future__ import annotations

from fractions import Fraction

__all__ = ["CpbModel", "HrdParams"]


class HrdParams:
    """Declared HRD: bit rate, CPB size, initial delay, frame rate.

    Values are rounded UP to the spec's representable grid
    (BitRate = value * 2^(6+scale), CpbSize = value * 2^(4+scale);
    scale 0 here) so the declared channel is never slower than the
    model the encoder enforced."""

    def __init__(self, bitrate_kbps: int, cpb_ms: int,
                 initial_delay_ms: int, fps: float) -> None:
        if cpb_ms < 1 or initial_delay_ms < 1:
            raise ValueError("cpb/initial-delay must be >= 1 ms")
        if initial_delay_ms > cpb_ms:
            raise ValueError(
                f"initial-delay ({initial_delay_ms} ms) cannot exceed "
                f"cpb-size ({cpb_ms} ms)")
        self.bitrate_bps = int(bitrate_kbps) * 1000
        self.cpb_ms = int(cpb_ms)
        self.initial_delay_ms = int(initial_delay_ms)
        self.fps = float(fps)
        # representable grid, rounded up
        self.decl_bitrate = -(-self.bitrate_bps // 64) * 64
        cpb_bits = self.bitrate_bps * self.cpb_ms // 1000
        self.decl_cpb_bits = -(-cpb_bits // 16) * 16

    def write_vui(self, w) -> None:
        """vui_parameters() with timing + NAL HRD (E.1.1/E.1.2);
        ``w`` is an io.h264_pcm._BitWriter positioned at
        vui_parameters_present_flag."""
        w.u(1, 1)                    # vui_parameters_present_flag
        w.u(0, 1)                    # aspect_ratio_info_present_flag
        w.u(0, 1)                    # overscan_info_present_flag
        w.u(0, 1)                    # video_signal_type_present_flag
        w.u(0, 1)                    # chroma_loc_info_present_flag
        w.u(1, 1)                    # timing_info_present_flag
        fr = Fraction(self.fps).limit_denominator(65535)
        w.u(fr.denominator, 32)      # num_units_in_tick
        w.u(2 * fr.numerator, 32)    # time_scale (field units)
        w.u(1, 1)                    # fixed_frame_rate_flag
        w.u(1, 1)                    # nal_hrd_parameters_present_flag
        w.ue(0)                      # cpb_cnt_minus1
        w.u(0, 4)                    # bit_rate_scale
        w.u(0, 4)                    # cpb_size_scale
        w.ue(self.decl_bitrate // 64 - 1)      # bit_rate_value_minus1
        w.ue(self.decl_cpb_bits // 16 - 1)     # cpb_size_value_minus1
        w.u(0, 1)                    # cbr_flag: VBR channel
        w.u(23, 5)                   # initial_cpb_removal_delay_length-1
        w.u(23, 5)                   # cpb_removal_delay_length_minus1
        w.u(23, 5)                   # dpb_output_delay_length_minus1
        w.u(24, 5)                   # time_offset_length
        w.u(0, 1)                    # vcl_hrd_parameters_present_flag
        w.u(1, 1)                    # low_delay_hrd_flag (E.1: present
        #                              when nal/vcl hrd present)
        w.u(0, 1)                    # pic_struct_present_flag
        w.u(0, 1)                    # bitstream_restriction_flag


class CpbModel:
    """Encoder-side leaky-bucket schedule (seconds domain, exact
    rationals so long runs cannot drift).

    ``slack`` is how far transmission completion lags the capture
    tick; a frame is DELIVERABLE iff slack stays <= initial_delay.
    ``budget_bits()`` returns the largest next-frame size honoring
    both the deadline and the one-picture CPB cap; ``add_frame``
    advances the schedule and records violations (which the encoders
    prevent by re-encoding — see tests for the proof)."""

    def __init__(self, bitrate_kbps: int, cpb_ms: int,
                 initial_delay_ms: int, fps: float) -> None:
        self.params = HrdParams(bitrate_kbps, cpb_ms, initial_delay_ms,
                                fps)
        self.rate = Fraction(self.params.bitrate_bps)      # bits/s
        self.tick = 1 / Fraction(self.params.fps).limit_denominator(
            65535)
        self.delay = Fraction(self.params.initial_delay_ms, 1000)
        self.cpb_bits = (self.params.bitrate_bps
                         * self.params.cpb_ms // 1000)
        self.slack = Fraction(0)
        self.frames = 0
        self.violations = 0

    def budget_bits(self) -> int:
        """Largest next-frame bit count that keeps the schedule."""
        room = (self.delay - max(self.slack - self.tick, 0)) * self.rate
        return min(int(room), self.cpb_bits)

    def add_frame(self, bits: int) -> bool:
        """Advance the schedule by one frame; True if it violated."""
        self.slack = (max(self.slack - self.tick, 0)
                      + Fraction(bits) / self.rate)
        self.frames += 1
        bad = self.slack > self.delay or bits > self.cpb_bits
        if bad:
            self.violations += 1
        return bad
