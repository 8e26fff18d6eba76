"""Package entry point: environment report + available apps/presets."""

from __future__ import annotations


def main() -> None:
    from opencv_opencl_tpu_torch.models.presets import PRESETS
    from opencv_opencl_tpu_torch.utils.envinfo import print_env_report

    print_env_report()
    print("\nApps (python -m opencv_opencl_tpu_torch.apps.<name>):")
    for name, ref in [
        ("histeq_image", "singlecolor.cpp"),
        ("clahe_image", "clahe1frame.cpp"),
        ("m2_bench", "m2.cpp"),
        ("parity_bench", "1frameMeasure.cpp"),
        ("clahe_video", "CLAHECompare.cpp / clahevideo.cpp"),
        ("airplan_mp4", "AirplanMP4.cpp"),
        ("relay", "OpenCVequalHist family / OpenCLequalHist / improvement"),
        ("sender", "webrtc/sender.cpp family (+ --audio, --test-source)"),
        ("rtp_receiver", "PC-side RTP player/recorder (extension)"),
        ("multi_relay", "N streams / one card serving (extension)"),
        ("h26x_stream", "replay recorded H.26x ES over RTP (extension)"),
    ]:
        print(f"  {name:<14} <- {ref}")
    print("\nPresets (relay --preset=<name>):")
    for name, p in PRESETS.items():
        print(f"  {name:<14} {p.width}x{p.height}@{p.fps:g} "
              f"{p.enhancer.op:<7} <- {p.reference}")


if __name__ == "__main__":
    main()
