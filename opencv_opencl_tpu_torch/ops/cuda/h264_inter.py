"""The sub-pel plane and motion search kernels of the H.264 device GOP
encoder, beside their plain PyTorch versions.

Counterparts of XLA programs of ``opencv_opencl_tpu/ops/h264_levels.py``
(no Pallas kernels).  The kernels are CUDA C++ for Hopper in
``opencv_opencl_tpu_torch/csrc/h264_inter.cu``:

=============  =============================================  ==================
wrapper        plain version                                  replaces
=============  =============================================  ==================
subpel_planes  ``ops.h264_levels.subpel_planes_plain``        h264_levels.py:703
               (``subpel_planes_kernel``, H3)                 (:733, :738)
motion_search  ``ops.h264_levels.motion_search_plain``        h264_levels.py:838
               (``motion_search_kernel``, H4)                 (:958, :1086,
                                                              :1399)
motion_search  ``ops.h264_levels.motion_search_parts_plain``  h264_levels.py:1197
_parts         (``parts_search_kernel``, H6)
=============  =============================================  ==================

``subpel_planes_kernel`` computes the base planes of 8 x 512 positions a
block and stores each plane row's 16-byte units of the flat plane, a warp
a row; :func:`planes_plan` lays the launch out.  ``motion_search_kernel``
and ``parts_search_kernel`` take several MBs of one MB row a block and cut
their candidates into tiles of one sub-sample plane, one integer dx and up
to 8 integer dy; :func:`search_plan_of` and :func:`parts_plan_of` lay the
launches out,
:func:`search_tiles` and :func:`refine_tiles` make the tiles and
:func:`candidate_index` / :func:`refine_index` their candidates' indices
(all on the host, once a configuration).

As in ``ops/cuda/natural.py``: each wrapper takes its plain version only
for tensors on the CPU; for CUDA tensors it launches its kernel on the
current stream or raises, and counts its launches in ``<wrapper>.launches``.
:func:`search_into` is the launcher the GOP encoder calls (the planes, then
:func:`search_stack_into`): it writes the MV field and the reference index
straight into a frame's level buffer; :func:`parts_search_into` is its
``parts`` counterpart (the planes, then :func:`parts_stack_into`), writing
the partition modes and the quadrant fields there.
"""

from __future__ import annotations

import numpy as np
import torch

from opencv_opencl_tpu_torch.ops import h264_levels as levels
from opencv_opencl_tpu_torch.ops.cuda import _build
from opencv_opencl_tpu_torch.ops.cuda.natural import _on_card, _raise_on, _stream

__all__ = ["subpel_planes", "motion_search", "search_into", "search_stack_into",
           "planes_into", "motion_search_parts", "parts_search_into",
           "parts_stack_into", "search_tiles", "refine_tiles", "candidate_index",
           "refine_index", "search_shared_bytes", "search_plan_of",
           "parts_shared_bytes", "parts_plan_of", "planes_plan", "planes_floor_into",
           "launch_counts", "reset_launch_counts"]

# motion_search_kernel's layout (csrc/h264_inter.cu): the dy a first-stage
# tile holds at most, threads a block, MBs a block at most, a MB's bytes
# besides the window (its 256 samples, keys and winner), fastsub's window
# a MB (16 planes x 17 rows of 48 bytes)
TILE_ROWS = 8
SEARCH_THREADS = 256
SEARCH_MBS = 8
_MB_BYTES = 256 + 32
_REFINE_MB = 16 * 17 * 48
# the shared memory a block may take so that two blocks fit an SM
SEARCH_SHARED_BUDGET = 232448 // 2
# parts_search_kernel's layout (H4's tiles, four quadrant sums a
# candidate): a MB's bytes besides the window (its 256 samples, nine keys
# and four winners)
_PARTS_MB_BYTES = 256 + 4 * 24
# subpel_planes_kernel's layout: the rows and columns of positions whose
# base planes a block computes, the columns whose 16-byte units it stores
# (a warp stores a row's 31), threads a block
PLANE_BASE_ROWS, PLANE_BASE_COLS = 8, 512
PLANE_COLS = PLANE_BASE_COLS - 16
PLANE_THREADS = 256

# candidate and tile tables on the card, by (device, search, subpel, nrefs)
_TABLES: dict = {}


def _check_plane(t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.uint8 or t.ndim != 2 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 2-D uint8 plane, got "
                         f"{t.dtype} {tuple(t.shape)} strides {t.stride()}")


def planes_plan(H: int, W: int, margin: int, nplanes: int) -> dict:
    """The launch of ``subpel_planes_kernel`` (and its write floor) for an
    H x W reference: a block computes the base planes of ``PLANE_BASE_ROWS``
    x ``PLANE_BASE_COLS`` positions and owns ``rows`` of them (one fewer
    with 16 planes, whose averages read the row below) and ``cols``
    (``PLANE_COLS``: a 16-byte unit that starts in them ends inside the
    computed columns); the blocks cover the (H + 2m, W + 2m) planes."""
    rows = PLANE_BASE_ROWS - (nplanes == 16)
    oh, ow = H + 2 * margin, W + 2 * margin
    return {"rows": rows, "cols": PLANE_COLS, "blocks_x": -(-ow // PLANE_COLS),
            "blocks_y": -(-oh // rows), "threads": PLANE_THREADS}


def _check_planes_call(ry: torch.Tensor, margin: int, nplanes: int, out: torch.Tensor,
                       name: str) -> None:
    if not _on_card(ry):
        raise ValueError(f"{name} launches on a CUDA device, got {ry.device}")
    _check_plane(ry, "ry")
    if nplanes not in (1, 4, 16) or margin < 0:
        raise ValueError(f"nplanes must be 1, 4 or 16 and margin >= 0, got "
                         f"{nplanes}, {margin}")
    H, W = ry.shape
    shape = (nplanes, H + 2 * margin, W + 2 * margin)
    if (tuple(out.shape) != shape or out.dtype != torch.uint8
            or not out.is_contiguous() or out.device != ry.device):
        raise ValueError(f"out must be a contiguous uint8 {shape} tensor on {ry.device}")


def planes_into(ry: torch.Tensor, margin: int, nplanes: int,
                out: torch.Tensor) -> None:
    """Launch ``subpel_planes_kernel``: the ``nplanes`` (1, 4 or 16)
    planes of the CUDA luma plane ``ry`` into ``out``, a contiguous uint8
    (nplanes, H + 2*margin, W + 2*margin) tensor (or a slice of a larger
    stack of that shape; any byte alignment)."""
    _check_planes_call(ry, margin, nplanes, out, "planes_into")
    H, W = ry.shape
    lib = _build.load()
    with torch.cuda.device(ry.device):
        err = lib.subpel_planes_launch(ry.data_ptr(), H, W, margin, nplanes,
                                       out.data_ptr(), _stream(ry.device))
    _raise_on(err, "subpel_planes_kernel")
    subpel_planes.launches += 1


def planes_floor_into(ry: torch.Tensor, margin: int, nplanes: int,
                      out: torch.Tensor) -> None:
    """``subpel_floor_kernel``: :func:`planes_into`'s grid and stores with
    every plane written from G and no filter arithmetic, what the stores
    alone cost.  For timing; no encoder calls it, and it is not counted in
    :func:`launch_counts`."""
    _check_planes_call(ry, margin, nplanes, out, "planes_floor_into")
    H, W = ry.shape
    lib = _build.load()
    with torch.cuda.device(ry.device):
        err = lib.subpel_floor_launch(ry.data_ptr(), H, W, margin, nplanes,
                                      out.data_ptr(), _stream(ry.device))
    _raise_on(err, "subpel_floor_kernel")


def subpel_planes(ry: torch.Tensor, margin: int, nplanes: int) -> torch.Tensor:
    """:func:`ops.h264_levels.subpel_planes`: the kernel for a CUDA plane,
    the plain version for a CPU one."""
    if not isinstance(ry, torch.Tensor) or ry.dtype != torch.uint8 or ry.ndim != 2:
        raise ValueError("ry must be a 2-D uint8 tensor")
    if not _on_card(ry):
        return levels.subpel_planes_plain(ry, margin, nplanes)
    H, W = ry.shape
    out = torch.empty((nplanes, H + 2 * margin, W + 2 * margin), dtype=torch.uint8,
                      device=ry.device)
    planes_into(ry.contiguous(), margin, nplanes, out)
    return out


def _fractions(subpel: int) -> list[int]:
    """The sub-sample fractions (in quarter samples) a side of the first
    stage's lattice: full-pel (and fastsub's first stage) 0; half-pel 0, 2;
    quarter-pel 0..3."""
    return {0: [0], 3: [0], 1: [0, 2], 2: [0, 1, 2, 3]}[subpel]


def search_tiles(search: int, subpel: int, nrefs: int) -> tuple[np.ndarray, np.ndarray]:
    """The first stage's window slots and tiles.  A slot is one (reference,
    fraction fy, fraction fx) the lattice uses; ``slot_planes`` (int32) its
    plane in the stacked reference planes.  A tile, a row (slot, fy * 4 +
    fx, ay0, ax * 16 + cnt) of ``tiles`` (T, 4) int32, is the candidates
    (4 * (ay0 + d) + fy, 4 * ax + fx) for d < cnt (cnt <= ``TILE_ROWS``):
    every candidate of ``search_candidates(search, subpel)`` of every
    reference in exactly one tile.  Integer offsets run -search..search, to
    search - 1 where the fraction is not 0; a column of dy is cut into the
    fewest tiles of at most TILE_ROWS, evenly; dx is the fastest axis."""
    fracs = _fractions(subpel)
    P, _ = levels.search_plan(search, subpel)
    slots, tiles = [], []
    for r in range(nrefs):
        for fy in fracs:
            for fx in fracs:
                slot = len(slots)
                slots.append(r * P + int(levels._plane_of(fy, fx, P)))
                cy = 2 * search + 1 - (fy > 0)
                nt = -(-cy // TILE_ROWS)
                for t in range(nt):
                    a0 = -search + t * cy // nt
                    a1 = -search + (t + 1) * cy // nt
                    for ax in range(-search, search + 1 - (fx > 0)):
                        tiles.append((slot, fy * 4 + fx, a0, ax * 16 + a1 - a0))
    return np.asarray(slots, np.int32), np.asarray(tiles, np.int32).reshape(-1, 4)


def refine_tiles() -> np.ndarray:
    """fastsub's tiles, (28, 4) int32 rows (plane, fy * 4 + fx, ay0, ax * 16
    + cnt) in integer samples relative to the full-pel winner: the offsets
    (4 * (ay0 + d) + fy, 4 * ax + fx), d < cnt, are the 49 of
    ``fastsub_offsets()``, each once; the plane is the fraction's of 16."""
    tiles = []
    for fy in range(4):
        a0, cnt = (0, 1) if fy == 0 else (-1, 2)
        for fx in range(4):
            for ax in ((0,) if fx == 0 else (-1, 0)):
                tiles.append((fy * 4 + fx, fy * 4 + fx, a0, ax * 16 + cnt))
    return np.asarray(tiles, np.int32)


def candidate_index(search: int, subpel: int) -> np.ndarray:
    """The first stage's candidate index by quarter-pel offset: entry
    (qy + 4 search) * (8 search + 1) + qx + 4 search, int16, -1 where there
    is no candidate."""
    side = 8 * search + 1
    inv = np.full(side * side, -1, np.int16)
    for i, (qy, qx) in enumerate(levels.search_candidates(search, subpel).tolist()):
        inv[(qy + 4 * search) * side + qx + 4 * search] = i
    return inv


def refine_index() -> np.ndarray:
    """fastsub's offset index by offset: entry (oy + 3) * 7 + ox + 3, int16."""
    inv = np.full(49, -1, np.int16)
    for j, (oy, ox) in enumerate(levels.fastsub_offsets().tolist()):
        inv[(oy + 3) * 7 + ox + 3] = j
    return inv


def _window_bytes(mbs: int, search: int, nslots: int) -> int:
    """The first stage's windows: every slot's 2 search + 16 rows of the
    stack's 16-byte units holding 16 mbs + 2 search columns, with room for a
    row's lead into its first unit and 5 words read anywhere."""
    pitch = (16 * mbs + 2 * search + 34 + 15) // 16 * 16
    return nslots * (2 * search + 16) * pitch


def search_shared_bytes(mbs: int, search: int, nslots: int, refine: bool) -> int:
    """``motion_search_kernel``'s dynamic shared memory (the launcher
    refuses any other count): ``mbs`` MBs' samples, keys and winners, then
    the larger of the first stage's windows (:func:`_window_bytes`) and
    fastsub's (16 planes x 17 rows of 48 bytes a MB)."""
    return _MB_BYTES * mbs + max(_window_bytes(mbs, search, nslots),
                                 _REFINE_MB * mbs if refine else 0)


def _fill_mbs(mb_w: int, ntiles: int, shared_of) -> tuple[int, int]:
    """(mbs, shared bytes): the MBs of one row a block (1..``SEARCH_MBS``,
    at most mb_w) whose tiles fill the block's threads best in whole rounds
    (ties to more MBs, which share more of the window), within
    ``SEARCH_SHARED_BUDGET``."""
    best = None
    for mbs in range(1, min(SEARCH_MBS, mb_w) + 1):
        shared = shared_of(mbs)
        if shared > SEARCH_SHARED_BUDGET and mbs > 1:
            continue
        items = mbs * ntiles
        fill = items / (-(-items // SEARCH_THREADS) * SEARCH_THREADS)
        if best is None or fill >= best[0]:
            best = (fill, mbs, shared)
    return best[1], best[2]


def search_plan_of(mb_w: int, search: int, subpel: int, nrefs: int) -> dict:
    """The launch of ``motion_search_kernel``: ``mbs`` MBs of one MB row a
    block (:func:`_fill_mbs`); then blocks along a row, threads, shared
    bytes, tiles and window slots."""
    slots, tiles = search_tiles(search, subpel, nrefs)
    refine = subpel == 3
    mbs, shared = _fill_mbs(mb_w, len(tiles), lambda mbs: search_shared_bytes(
        mbs, search, len(slots), refine))
    return {"mbs": mbs, "blocks_x": -(-mb_w // mbs), "threads": SEARCH_THREADS,
            "shared": shared, "tiles": len(tiles), "slots": len(slots),
            "refine_tiles": len(refine_tiles()) if refine else 0}


def parts_shared_bytes(mbs: int, search: int, nslots: int) -> int:
    """``parts_search_kernel``'s dynamic shared memory (the launcher
    refuses any other count): ``mbs`` MBs' samples, nine keys and four
    winners, then the first stage's windows (:func:`_window_bytes`)."""
    return _PARTS_MB_BYTES * mbs + _window_bytes(mbs, search, nslots)


def parts_plan_of(mb_w: int, search: int, subpel: int, nrefs: int) -> dict:
    """The launch of ``parts_search_kernel``: H4's tiles for the sub-pel
    modes 0-2, ``mbs`` MBs of one row a block (:func:`_fill_mbs`); blocks
    along a row, threads, shared bytes, tiles and window slots."""
    slots, tiles = search_tiles(search, subpel, nrefs)
    mbs, shared = _fill_mbs(mb_w, len(tiles), lambda mbs: parts_shared_bytes(
        mbs, search, len(slots)))
    return {"mbs": mbs, "blocks_x": -(-mb_w // mbs), "threads": SEARCH_THREADS,
            "shared": shared, "tiles": len(tiles), "slots": len(slots)}


def _tables(device: torch.device, search: int, subpel: int, nrefs: int = 1) -> dict:
    """The search's tables on the card, made once a configuration:
    candidates (n, 2) and fastsub offsets (49, 2) int32, the first stage's
    slots, tiles and candidate index, fastsub's tiles and offset index."""
    key = (str(device), search, subpel, nrefs)
    if key not in _TABLES:
        slots, tiles = search_tiles(search, subpel, nrefs)
        host = {"cands": levels.search_candidates(search, subpel),
                "slots": slots, "tiles": tiles, "inv": candidate_index(search, subpel)}
        if subpel == 3:
            host.update(offs=levels.fastsub_offsets(), rtiles=refine_tiles(),
                        rinv=refine_index())
        _TABLES[key] = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                        for k, v in host.items()}
    return _TABLES[key]


def search_into(y: torch.Tensor, refs, search: int, subpel: int,
                clean_rows: int | None, mv: torch.Tensor, ref: torch.Tensor | None,
                pred_y: torch.Tensor, pred_cb: torch.Tensor,
                pred_cr: torch.Tensor) -> None:
    """Build each reference's plane stack (``subpel_planes_kernel``), then
    :func:`search_stack_into`."""
    levels._check_search(y, refs, search, subpel, clean_rows)
    if not _on_card(y):
        raise ValueError(f"search_into launches on a CUDA device, got {y.device}")
    H, W = y.shape
    P, margin = levels.search_plan(search, subpel)
    stack = torch.empty((len(refs) * P, H + 2 * margin, W + 2 * margin),
                        dtype=torch.uint8, device=y.device)
    for i, r in enumerate(refs):
        _check_plane(r[0], "ry")
        planes_into(r[0], margin, P, stack[i * P:(i + 1) * P])
    search_stack_into(y, stack, refs, search, subpel, clean_rows, mv, ref,
                      pred_y, pred_cb, pred_cr)


def search_stack_into(y: torch.Tensor, stack: torch.Tensor, refs, search: int,
                      subpel: int, clean_rows: int | None, mv: torch.Tensor,
                      ref: torch.Tensor | None, pred_y: torch.Tensor,
                      pred_cb: torch.Tensor, pred_cr: torch.Tensor) -> None:
    """Launch ``motion_search_kernel`` over CUDA planes and the references'
    stacked planes ``stack`` ((len(refs) * P, H + 2m, W + 2m) uint8,
    :func:`ops.h264_levels.search_plan`'s P and m): ``mv`` (mb_h, mb_w, 2)
    and ``ref`` (mb_h, mb_w, two references only) int16 and the prediction
    planes are written in place (``mv`` and ``ref`` may be strided views of
    a level buffer, each MB's values contiguous)."""
    levels._check_search(y, refs, search, subpel, clean_rows)
    if not _on_card(y):
        raise ValueError(f"search_stack_into launches on a CUDA device, got {y.device}")
    if y.stride(1) != 1:
        raise ValueError(f"y must have unit pixel stride, got {y.stride()}")
    H, W = y.shape
    mb_h, mb_w = H // 16, W // 16
    P, margin = levels.search_plan(search, subpel)
    shape = (len(refs) * P, H + 2 * margin, W + 2 * margin)
    if (tuple(stack.shape) != shape or stack.dtype != torch.uint8
            or not stack.is_contiguous() or stack.device != y.device):
        raise ValueError(f"stack must be a contiguous uint8 {shape} tensor on {y.device}")
    for r in refs:
        for name, t in zip(("ry", "rcb", "rcr"), r):
            _check_plane(t, name)
    for name, t, shape in (("pred_y", pred_y, (H, W)), ("pred_cb", pred_cb, (H // 2, W // 2)),
                           ("pred_cr", pred_cr, (H // 2, W // 2))):
        _check_plane(t, name)
        if tuple(t.shape) != shape or t.device != y.device:
            raise ValueError(f"{name} must be {shape} on {y.device}")
    two = len(refs) > 1
    if (mv.dtype != torch.int16 or tuple(mv.shape) != (mb_h, mb_w, 2)
            or mv.stride(2) != 1 or mv.stride(1) != 2 or mv.stride(0) != 2 * mb_w):
        raise ValueError("mv must be an int16 (mb_h, mb_w, 2) tensor with "
                         "contiguous rows")
    if two and (ref is None or ref.dtype != torch.int16
                or tuple(ref.shape) != (mb_h, mb_w) or not ref.is_contiguous()):
        raise ValueError("ref must be a contiguous int16 (mb_h, mb_w) tensor "
                         "with two references")
    tab = _tables(y.device, search, subpel, len(refs))
    plan = search_plan_of(mb_w, search, subpel, len(refs))
    refine = subpel == 3
    lib = _build.load()
    second = refs[1] if two else refs[0]
    with torch.cuda.device(y.device):
        err = lib.motion_search_launch(
            y.data_ptr(), y.stride(0), mb_h, mb_w, stack.data_ptr(), P, margin, search,
            tab["slots"].data_ptr(), plan["slots"], tab["tiles"].data_ptr(), plan["tiles"],
            tab["inv"].data_ptr(), tab["cands"].data_ptr(),
            tab["rtiles"].data_ptr() if refine else None, plan["refine_tiles"],
            tab["rinv"].data_ptr() if refine else None,
            tab["offs"].data_ptr() if refine else None, plan["mbs"], plan["shared"],
            -1 if clean_rows is None else int(clean_rows),
            refs[0][1].data_ptr(), refs[0][2].data_ptr(), second[1].data_ptr(),
            second[2].data_ptr(), mv.data_ptr(), ref.data_ptr() if two else None,
            pred_y.data_ptr(), pred_cb.data_ptr(), pred_cr.data_ptr(),
            _stream(y.device))
    _raise_on(err, "motion_search_kernel")
    motion_search.launches += 1


def motion_search(y: torch.Tensor, refs, search: int, subpel: int = 0,
                  clean_rows: int | None = None):
    """:func:`ops.h264_levels.motion_search`: the kernels for CUDA planes,
    the plain version for CPU ones."""
    levels._check_search(y, refs, search, subpel, clean_rows)
    if not _on_card(y):
        return levels.motion_search_plain(y, refs, search, subpel, clean_rows)
    H, W = y.shape
    mb_h, mb_w = H // 16, W // 16
    dev = y.device
    refs = [tuple(t.contiguous() for t in r) for r in refs]
    mv = torch.empty((mb_h, mb_w, 2), dtype=torch.int16, device=dev)
    ref = (torch.empty((mb_h, mb_w), dtype=torch.int16, device=dev)
           if len(refs) > 1 else None)
    pred = (torch.empty((H, W), dtype=torch.uint8, device=dev),
            torch.empty((H // 2, W // 2), dtype=torch.uint8, device=dev),
            torch.empty((H // 2, W // 2), dtype=torch.uint8, device=dev))
    search_into(y if y.stride(1) == 1 else y.contiguous(), refs, search, subpel,
                clean_rows, mv, ref, *pred)
    return (mv, ref, *pred) if ref is not None else (mv, *pred)


def parts_search_into(y: torch.Tensor, refs, search: int, subpel: int, qp: int,
                      pmode: torch.Tensor, mv: torch.Tensor, ref: torch.Tensor | None,
                      pred_y: torch.Tensor, pred_cb: torch.Tensor,
                      pred_cr: torch.Tensor) -> None:
    """Build each reference's plane stack (``subpel_planes_kernel``), then
    :func:`parts_stack_into`."""
    levels._check_parts(y, refs, search, subpel)
    if not _on_card(y):
        raise ValueError(f"parts_search_into launches on a CUDA device, got {y.device}")
    H, W = y.shape
    P, margin = levels.search_plan(search, subpel)
    stack = torch.empty((len(refs) * P, H + 2 * margin, W + 2 * margin),
                        dtype=torch.uint8, device=y.device)
    for i, r in enumerate(refs):
        _check_plane(r[0], "ry")
        planes_into(r[0], margin, P, stack[i * P:(i + 1) * P])
    parts_stack_into(y, stack, refs, search, subpel, qp, pmode, mv, ref,
                     pred_y, pred_cb, pred_cr)


def parts_stack_into(y: torch.Tensor, stack: torch.Tensor, refs, search: int,
                     subpel: int, qp: int, pmode: torch.Tensor, mv: torch.Tensor,
                     ref: torch.Tensor | None, pred_y: torch.Tensor,
                     pred_cb: torch.Tensor, pred_cr: torch.Tensor) -> None:
    """Launch ``parts_search_kernel`` over CUDA planes and the references'
    stacked planes ``stack`` (as :func:`search_stack_into` takes them):
    ``pmode`` (mb_h, mb_w), ``mv`` (mb_h, mb_w, 4, 2) and ``ref`` (mb_h,
    mb_w, 4; two references only), contiguous int16 (the segments of a
    ``parts`` level buffer will do), and the prediction planes are written
    in place."""
    n = levels._check_parts(y, refs, search, subpel)
    if not _on_card(y):
        raise ValueError(f"parts_stack_into launches on a CUDA device, got {y.device}")
    if y.stride(1) != 1:
        raise ValueError(f"y must have unit pixel stride, got {y.stride()}")
    H, W = y.shape
    mb_h, mb_w = H // 16, W // 16
    P, margin = levels.search_plan(search, subpel)
    shape = (len(refs) * P, H + 2 * margin, W + 2 * margin)
    if (tuple(stack.shape) != shape or stack.dtype != torch.uint8
            or not stack.is_contiguous() or stack.device != y.device):
        raise ValueError(f"stack must be a contiguous uint8 {shape} tensor on {y.device}")
    for r in refs:
        for name, t in zip(("ry", "rcb", "rcr"), r):
            _check_plane(t, name)
    for name, t, shape in (("pred_y", pred_y, (H, W)), ("pred_cb", pred_cb, (H // 2, W // 2)),
                           ("pred_cr", pred_cr, (H // 2, W // 2))):
        _check_plane(t, name)
        if tuple(t.shape) != shape or t.device != y.device:
            raise ValueError(f"{name} must be {shape} on {y.device}")
    two = len(refs) > 1
    for name, t, shape in (("pmode", pmode, (mb_h, mb_w)), ("mv", mv, (mb_h, mb_w, 4, 2)),
                           ("ref", ref, (mb_h, mb_w, 4))):
        if name == "ref" and not two:
            continue
        if (t is None or t.dtype != torch.int16 or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != y.device):
            raise ValueError(f"{name} must be a contiguous int16 {shape} tensor "
                             f"on {y.device}")
    plan = parts_plan_of(mb_w, search, subpel, len(refs))
    tab = _tables(y.device, search, subpel, len(refs))
    lam = levels.PART_LAMBDA[min(max(int(qp), 0), 51)]
    lib = _build.load()
    second = refs[1] if two else refs[0]
    with torch.cuda.device(y.device):
        err = lib.parts_search_launch(
            y.data_ptr(), y.stride(0), mb_h, mb_w, stack.data_ptr(), P, margin, search,
            tab["slots"].data_ptr(), plan["slots"], tab["tiles"].data_ptr(), plan["tiles"],
            tab["inv"].data_ptr(), tab["cands"].data_ptr(), n, plan["mbs"],
            plan["shared"], lam,
            refs[0][1].data_ptr(), refs[0][2].data_ptr(), second[1].data_ptr(),
            second[2].data_ptr(), pmode.data_ptr(), mv.data_ptr(),
            ref.data_ptr() if two else None,
            pred_y.data_ptr(), pred_cb.data_ptr(), pred_cr.data_ptr(),
            _stream(y.device))
    _raise_on(err, "parts_search_kernel")
    motion_search_parts.launches += 1


def motion_search_parts(y: torch.Tensor, refs, search: int, subpel: int, qp: int):
    """:func:`ops.h264_levels.motion_search_parts`: the kernels for CUDA
    planes, the plain version for CPU ones."""
    levels._check_parts(y, refs, search, subpel)
    if not _on_card(y):
        return levels.motion_search_parts_plain(y, refs, search, subpel, qp)
    H, W = y.shape
    mb_h, mb_w = H // 16, W // 16
    dev = y.device
    refs = [tuple(t.contiguous() for t in r) for r in refs]
    pmode = torch.empty((mb_h, mb_w), dtype=torch.int16, device=dev)
    mv = torch.empty((mb_h, mb_w, 4, 2), dtype=torch.int16, device=dev)
    ref = (torch.empty((mb_h, mb_w, 4), dtype=torch.int16, device=dev)
           if len(refs) > 1 else None)
    pred = (torch.empty((H, W), dtype=torch.uint8, device=dev),
            torch.empty((H // 2, W // 2), dtype=torch.uint8, device=dev),
            torch.empty((H // 2, W // 2), dtype=torch.uint8, device=dev))
    parts_search_into(y if y.stride(1) == 1 else y.contiguous(), refs, search, subpel,
                      qp, pmode, mv, ref, *pred)
    return (pmode, mv, ref, *pred)


_WRAPPERS = (subpel_planes, motion_search, motion_search_parts)


def reset_launch_counts() -> None:
    for fn in _WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in _WRAPPERS}


reset_launch_counts()
