"""Package entry point: environment report + available apps/presets."""

from __future__ import annotations


def main() -> None:
    from opencv_opencl_tpu_torch.models.presets import PRESETS
    from opencv_opencl_tpu_torch.utils.envinfo import print_env_report

    print_env_report()
    print("\nApps (python -m opencv_opencl_tpu_torch.apps.<name>):")
    for name, ref in [
        ("relay", "OpenCVequalHist family / OpenCLequalHist / improvement"),
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
