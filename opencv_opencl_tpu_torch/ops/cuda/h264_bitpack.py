"""The CAVLC bit-packing kernels of the H.264 device encoders, beside their
plain PyTorch versions.

Counterparts of ``opencv_opencl_tpu/ops/h264_bitpack.py:347 pack_i_mbs`` and
``:548 pack_p_mbs``, XLA programs (no Pallas kernels).  The kernels are CUDA
C++ for Hopper in ``opencv_opencl_tpu_torch/csrc/h264_bitpack.cu``:

==========  ========================================  ====================
wrapper     plain version                             replaces
==========  ========================================  ====================
pack_i_mbs  ``ops.h264_bitpack.pack_i_mbs_plain``     h264_bitpack.py:347
            (``pack_i_kernel``, H7)
pack_p_mbs  ``ops.h264_bitpack.pack_p_mbs_plain``     h264_bitpack.py:548
            (``pack_p_kernel``, H8)
==========  ========================================  ====================

As in ``ops/cuda/natural.py``: each wrapper takes its plain version only
for tensors on the CPU; for CUDA tensors it launches its kernel on the
current stream or raises, and counts its launches in ``<wrapper>.launches``.
The kernels read the level tensors where they lie (the segments of a level
buffer of ``ops/cuda/h264_levels.py``, int16, contiguous); :func:`pack_i_into`
and :func:`pack_p_into` write into words and counts the caller owns.

Both kernels are laid out by :func:`pack_plan`: a warp walks a run of
``run`` MBs of one MB row (first reading the MB left of its run for the
left context), four warps a block.  :func:`pack_i_floor_into` and
:func:`pack_p_floor_into` launch their read-and-store floors, the same
loads and stores without tokens (not counted).  Neither kernel keeps an
MB's words in shared memory, so ``nw_mb`` takes any value from 1, as in the
JAX package.
"""

from __future__ import annotations

import torch

from opencv_opencl_tpu_torch.ops import h264_bitpack as bitpack
from opencv_opencl_tpu_torch.ops.cuda import _build
from opencv_opencl_tpu_torch.ops.cuda.natural import _on_card, _raise_on, _stream

__all__ = ["pack_i_mbs", "pack_p_mbs", "pack_i_into", "pack_p_into", "pack_i_floor_into",
           "pack_p_floor_into", "pack_plan", "PACK_RUN", "PACK_P_RUN", "launch_counts",
           "reset_launch_counts"]

# the MBs of a row a warp walks, H7 and H8 (a P frame's MBs are lighter, so
# H8 needs more warps in flight to hide each MB's chain: runs of 3 were the
# fastest of 1-16 at 4K, scripts/torch_kernel_turns.py --h264 --pack-runs),
# and the warps a block (kPackWarps)
PACK_RUN = 16
PACK_P_RUN = 3
PACK_WARPS = 4
# csrc/h264_bitpack.cu's table layout
_VLC_LAYOUT = {"ct_len": 0, "ct_code": 204, "cdc_len": 408, "cdc_code": 428,
               "tz_len": 448, "tz_code": 704, "tzc_len": 960, "tzc_code": 976,
               "rb_len": 992, "rb_code": 1112, "cbp_inter": 1232, "cbp_intra": 1280}
_VLC_SIZE = 1328
# the VLC table on the card, by device
_VLC: dict = {}


def _vlc(device: torch.device) -> torch.Tensor:
    key = str(device)
    if key not in _VLC:
        table = bitpack.vlc_table()
        if bitpack.VLC_OFFSETS != _VLC_LAYOUT or table.size != _VLC_SIZE:
            raise RuntimeError("the VLC table's layout differs from the kernels'")
        _VLC[key] = torch.from_numpy(table).to(device)
    return _VLC[key]


def _levels(device, mb_h: int, mb_w: int, **fields) -> dict:
    """The named level tensors as contiguous int16 on ``device``, each of
    its shape (None stays None)."""
    out = {}
    for name, (t, shape) in fields.items():
        if t is None:
            out[name] = None
            continue
        if tuple(t.shape) != (mb_h, mb_w) + shape:
            raise ValueError(f"{name} must be {(mb_h, mb_w) + shape}, got {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, the levels on {device}")
        out[name] = t.to(torch.int16).contiguous()
    return out


def _outputs(words: torch.Tensor, nbits: torch.Tensor, mb_h: int, mb_w: int, nw_mb: int,
             device) -> None:
    if nw_mb < 1:
        raise ValueError(f"nw_mb must be at least 1, got {nw_mb}")
    if (words.dtype != torch.uint32 or tuple(words.shape) != (mb_h, mb_w, nw_mb)
            or not words.is_contiguous() or words.device != device):
        raise ValueError(f"words must be a contiguous uint32 {(mb_h, mb_w, nw_mb)} tensor "
                         f"on {device}")
    if (nbits.dtype != torch.int32 or tuple(nbits.shape) != (mb_h, mb_w)
            or not nbits.is_contiguous() or nbits.device != device):
        raise ValueError(f"nbits must be a contiguous int32 {(mb_h, mb_w)} tensor on {device}")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def pack_plan(mb_h: int, mb_w: int, run: int = PACK_RUN) -> dict:
    """H7's and H8's launch for an (mb_h, mb_w) MB grid: the MBs a warp
    walks along a row (fewer where the row is shorter), the runs a row, the
    warps, and the (blocks, threads)."""
    run = max(1, min(run, mb_w))
    runs = -(-mb_w // run)
    warps = mb_h * runs
    return {"run": run, "runs": runs, "warps": warps,
            "grid": (-(-warps // PACK_WARPS), 32 * PACK_WARPS)}


def pack_i_into(zdc, acz, czdc, cacz, imode, words: torch.Tensor, nbits: torch.Tensor,
                i4modes=None, cmode=None) -> None:
    """Launch ``pack_i_kernel`` over CUDA level tensors into ``words``
    (mb_h, mb_w, nw_mb) uint32 and ``nbits`` (mb_h, mb_w) int32."""
    _pack_i(zdc, acz, czdc, cacz, imode, words, nbits, i4modes, cmode, floor=False)
    pack_i_mbs.launches += 1


def pack_i_floor_into(zdc, acz, czdc, cacz, imode, words: torch.Tensor, nbits: torch.Tensor,
                      i4modes=None, cmode=None) -> None:
    """H7's read-and-store floor: :func:`pack_i_into`'s loads and stores
    with no tokens (the words are no bit string; the counts zero); not
    counted."""
    _pack_i(zdc, acz, czdc, cacz, imode, words, nbits, i4modes, cmode, floor=True)


def _pack_i(zdc, acz, czdc, cacz, imode, words, nbits, i4modes, cmode, floor: bool,
            run: int = PACK_RUN) -> None:
    mb_h, mb_w = zdc.shape[:2]
    dev = zdc.device
    if not _on_card(zdc):
        raise ValueError(f"pack_i_into launches on a CUDA device, got {dev}")
    if imode is None:
        raise ValueError("pack_i_into needs imode")
    lv = _levels(dev, mb_h, mb_w, zdc=(zdc, (16,)), acz=(acz, (16, 16)),
                 czdc=(czdc, (2, 4)), cacz=(cacz, (2, 4, 16)), imode=(imode, ()),
                 i4modes=(i4modes, (16,)), cmode=(cmode, ()))
    nw = words.shape[-1] if words.ndim == 3 else 0
    _outputs(words, nbits, mb_h, mb_w, nw, dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.pack_i_launch(
            *(_ptr(lv[k]) for k in ("zdc", "acz", "czdc", "cacz", "imode", "i4modes",
                                    "cmode")),
            mb_h, mb_w, _vlc(dev).data_ptr(), nw, pack_plan(mb_h, mb_w, run)["run"],
            int(floor), words.data_ptr(), nbits.data_ptr(), _stream(dev))
    _raise_on(err, "pack_i_kernel")


def pack_i_mbs(zdc, acz, czdc, cacz, imode, nw_mb: int = 64, i4modes=None, cmode=None):
    """:func:`ops.h264_bitpack.pack_i_mbs`: the kernel for CUDA levels, the
    plain version for CPU ones."""
    if not _on_card(zdc):
        return bitpack.pack_i_mbs_plain(zdc, acz, czdc, cacz, imode, nw_mb, i4modes, cmode)
    mb_h, mb_w = zdc.shape[:2]
    words = torch.empty((mb_h, mb_w, nw_mb), dtype=torch.uint32, device=zdc.device)
    nbits = torch.empty((mb_h, mb_w), dtype=torch.int32, device=zdc.device)
    pack_i_into(zdc, acz, czdc, cacz, imode, words, nbits, i4modes, cmode)
    return words, nbits


def pack_p_into(mode, zdc, acz, czdc, cacz, mv, ref, active_refs: int, words: torch.Tensor,
                nbits: torch.Tensor, pmode=None, mv4=None, ref4=None) -> None:
    """Launch ``pack_p_kernel`` over CUDA level tensors into ``words`` and
    ``nbits`` (as :func:`pack_i_into`)."""
    _pack_p(mode, zdc, acz, czdc, cacz, mv, ref, active_refs, words, nbits, pmode, mv4, ref4,
            floor=False)
    pack_p_mbs.launches += 1


def pack_p_floor_into(mode, zdc, acz, czdc, cacz, mv, ref, active_refs: int,
                      words: torch.Tensor, nbits: torch.Tensor, pmode=None, mv4=None,
                      ref4=None) -> None:
    """H8's read-and-store floor: :func:`pack_p_into`'s loads and stores
    with no tokens (a coded MB's words are no bit string; the counts zero);
    not counted."""
    _pack_p(mode, zdc, acz, czdc, cacz, mv, ref, active_refs, words, nbits, pmode, mv4, ref4,
            floor=True)


def _pack_p(mode, zdc, acz, czdc, cacz, mv, ref, active_refs, words, nbits, pmode, mv4, ref4,
            floor: bool, run: int = PACK_P_RUN) -> None:
    mb_h, mb_w = mode.shape[:2]
    dev = mode.device
    if not _on_card(mode):
        raise ValueError(f"pack_p_into launches on a CUDA device, got {dev}")
    if int(active_refs) not in (1, 2):
        raise ValueError(f"active_refs must be 1 or 2, got {active_refs}")
    parts = pmode is not None
    if parts and mv4 is None:
        raise ValueError("pmode needs mv4")
    lv = _levels(dev, mb_h, mb_w, mode=(mode, ()), zdc=(zdc, (16,)), acz=(acz, (16, 16)),
                 czdc=(czdc, (2, 4)), cacz=(cacz, (2, 4, 16)),
                 mv=(mv4 if parts else mv, (4, 2) if parts else (2,)),
                 ref=(ref4 if parts else ref, (4,) if parts else ()),
                 pmode=(pmode, ()))
    nw = words.shape[-1] if words.ndim == 3 else 0
    _outputs(words, nbits, mb_h, mb_w, nw, dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.pack_p_launch(
            *(_ptr(lv[k]) for k in ("mode", "zdc", "acz", "czdc", "cacz", "mv", "ref",
                                    "pmode")),
            int(active_refs), mb_h, mb_w, _vlc(dev).data_ptr(), nw,
            pack_plan(mb_h, mb_w, run)["run"], int(floor), words.data_ptr(),
            nbits.data_ptr(), _stream(dev))
    _raise_on(err, "pack_p_kernel")


def pack_p_mbs(mode, zdc, acz, czdc, cacz, mv, ref, active_refs: int, nw_mb: int = 64,
               pmode=None, mv4=None, ref4=None):
    """:func:`ops.h264_bitpack.pack_p_mbs`: the kernel for CUDA levels, the
    plain version for CPU ones."""
    if not _on_card(mode):
        return bitpack.pack_p_mbs_plain(mode, zdc, acz, czdc, cacz, mv, ref, active_refs,
                                        nw_mb, pmode, mv4, ref4)
    mb_h, mb_w = mode.shape[:2]
    words = torch.empty((mb_h, mb_w, nw_mb), dtype=torch.uint32, device=mode.device)
    nbits = torch.empty((mb_h, mb_w), dtype=torch.int32, device=mode.device)
    pack_p_into(mode, zdc, acz, czdc, cacz, mv, ref, active_refs, words, nbits, pmode, mv4,
                ref4)
    return words, nbits


_WRAPPERS = (pack_i_mbs, pack_p_mbs)


def reset_launch_counts() -> None:
    for fn in _WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in _WRAPPERS}


reset_launch_counts()
