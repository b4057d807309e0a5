"""Attention over the paged KV pool: the hand-written CUDA kernel, its plain
PyTorch version, and the dispatch between them by device.

The kernel (``csrc/paged_attention.cu``) replaces the TPU kernel
``paged_flash_attention`` of ``distributed_llm_pipeline_tpu/ops/
paged_attention.py`` and computes the same function: q ``[B, T, H, Hd]``
against pools ``[N, bs, K, Hd]`` through int32 ``tables [B, NT]`` and int32
``lengths [B]``. Row b's query t sits at absolute position ``lengths[b] + t``;
logical column c lives at physical block ``tables[b, c // bs]``, offset
``c % bs``, and attends iff ``c <= lengths[b] + t`` and, on a windowed layer,
``lengths[b] + t - c < window``. Scores, softcap, scale and int8 pools
(f32 scales ``[N, bs, K, 1]``) follow ``ops/flash_attention.py``.

The kernel splits each row's pages into runs (split-KV, flash-decoding):
``split_plan`` chooses the runs and the query tiles from shapes alone, so
the wrapper never reads ``lengths`` or ``tables`` on the host and its
workspace (``workspace_numel``) has a size a CUDA graph can capture.

Dispatch: ``paged_attention_any`` sends a CUDA tensor to the kernel and a
CPU tensor to the plain version (gather the logical window, then the dense
plain attention). There is no fallback: a kernel that cannot take its
inputs, or cannot build or launch, raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .flash_attention import PAGED_HEAD_DIMS, _scale, flash_attention_plain

# kernel launches since the last reset (chip_smoke.py reads it to prove the
# served path ran the kernel); only the CUDA wrapper below increments it
launches = 0

_fn = None


class SplitPlan(NamedTuple):
    """How ``csrc/paged_tile.cuh`` cuts one launch: folded query rows per
    block, query tiles per (row, kv head), runs of pages per row, pages per
    run and warps per block. The grid is (q_tiles, splits, B·K)."""
    rows_per_block: int
    q_tiles: int
    splits: int
    pages_per_split: int
    warps: int


class TileGeometry(NamedTuple):
    """The kernel's tiling at one head width, as ``csrc/paged_tile.cuh``
    defines it (``tile_geometry`` reads it from the library): columns a
    staged K/V tile holds, warps sharing a 16-row query tile (each keeping
    128 output dims), and warps a block may have."""
    tile_columns: int
    dim_slices: int
    max_warps: int


@functools.lru_cache(maxsize=None)
def tile_geometry(lib: str, head_dim: int) -> TileGeometry:
    """``lib``'s tiling at ``head_dim`` (``paged_attention``,
    ``latent_attention`` or ``flash_attention``), read once from its
    ``*_geometry`` entry."""
    from .cuda_build import load_library

    fn = getattr(load_library(lib), f"dlp_{lib}_geometry")
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 3)()
    if fn(head_dim, out) != 0:
        raise ValueError(f"{lib}: no kernel at head width {head_dim}")
    return TileGeometry(*out)


def pages_per_split(n_tables: int, splits: int) -> tuple[int, int]:
    """(pages per run, runs) for up to ``splits`` runs over ``n_tables``
    pages: every page in exactly one run, no run empty (more runs than
    pages give one page a run)."""
    pps = -(-n_tables // max(1, splits))
    return pps, -(-n_tables // pps)


@functools.lru_cache(maxsize=None)
def split_plan(B: int, T: int, H: int, K: int, NT: int, bs: int,
               geometry: TileGeometry, sm_count: int) -> SplitPlan:
    """The launch's cut, from shapes and the kernel's tiling only (reading
    ``lengths`` would cost a host sync a layer). The dense cache's kernel
    (``ops/flash_attention.py``) is cut the same way over virtual pages of
    ``bs`` columns, ``NT = ceil(S / bs)``. A query tile is up to
    ``max_warps`` warps of 16 folded rows (fewer where ``dim_slices`` warps
    share a row tile); a run holds at least one staged tile of columns.
    Where even one tile a run leaves SMs idle the query tiles narrow (down
    to 4 rows: a decode step of one latent stream). Below 8 warps an SM the pages split into
    runs, aiming at 16 warps an SM: runs past a row's end exit at once, and
    short runs keep each block's serial walk short while an SM overlaps
    several blocks."""
    rows = T * (H // K)
    ds = geometry.dim_slices
    rpb = min(16 * (geometry.max_warps // ds), 1 << max(0, rows - 1).bit_length())
    min_pps = -(-geometry.tile_columns // bs)
    max_splits = -(-NT // min_pps)

    def base(rpb: int) -> int:
        return B * K * -(-rows // rpb)

    while rpb > 4 and base(rpb) * max_splits < sm_count:
        rpb //= 2
    warps = -(-rpb // 16) * ds
    n = base(rpb) * warps
    want = 1 if n >= 8 * sm_count else min(max_splits, -(-16 * sm_count // n))
    pps, splits = pages_per_split(NT, want)
    if pps < min_pps:
        pps, splits = min_pps, -(-NT // min_pps)
    return SplitPlan(rpb, -(-rows // rpb), splits, pps, warps)


def workspace_numel(plan: SplitPlan, B: int, T: int, H: int, head_dim: int) -> int:
    """f32 values of the runs' partials: each output row's accumulator and
    its (max, sum), per run; none for a single run."""
    return plan.splits * B * T * H * (head_dim + 2) if plan.splits > 1 else 0


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """The card's SM count (read once per device, never per launch)."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def plan_launch(q: torch.Tensor, tables: torch.Tensor, bs: int, K: int,
                geometry: TileGeometry) -> tuple[SplitPlan, torch.Tensor | None]:
    """The split plan of a launch and its workspace (``torch.empty``, sized
    by shapes only)."""
    B, T, H, head_dim = q.shape
    plan = split_plan(B, T, H, K, tables.shape[-1], bs, geometry,
                      sm_count(q.device.index))
    n = workspace_numel(plan, B, T, H, head_dim)
    ws = torch.empty(n, dtype=torch.float32, device=q.device) if n else None
    return plan, ws


def check_aligned(name: str, *tensors: torch.Tensor) -> None:
    """The kernel stages q and the pools with 16-byte ``cp.async``: a view
    at a storage offset off that grain would fault on the card and end the
    process's CUDA context, so it raises here instead."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} tensor at an "
                             "address that is not a multiple of 16 bytes")


def c_entry(lib: str, symbol: str, n_dims: int):
    """A split-KV entry point (``csrc/paged_attention.cu`` or
    ``csrc/latent_attention.cu``), built at first use: nine pointers, the
    ``n_dims`` shape ints, the dtype flags, scale, softcap, window, the plan
    and the stream."""
    from .cuda_build import load_library

    fn = getattr(load_library(lib), symbol)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p] * 9 + [i] * (n_dims + 2) + [f, f, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _kernel():
    """The C entry point, built from ``csrc/paged_attention.cu`` at first use."""
    global _fn
    if _fn is None:
        _fn = c_entry("paged_attention", "dlp_paged_attention", 7)
    return _fn


def paged_flash_attention(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, tables: torch.Tensor,
                          lengths: torch.Tensor, n_rep: int, *,
                          scale: float = 0.0, softcap: float = 0.0,
                          window: int | None = None,
                          k_scale: torch.Tensor | None = None,
                          v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """The CUDA kernel. Raises on any input the kernel does not take, and
    when the launch fails."""
    global launches
    B, T, H, Hd = q.shape
    N, bs, K = k_pool.shape[:3]
    NT = tables.shape[-1]
    dev = q.device
    if not (q.is_cuda and all(t.device == dev for t in
                              (k_pool, v_pool, tables, lengths))):
        raise ValueError("paged_flash_attention: q, pools, tables and lengths "
                         "must be on one CUDA device")
    if (k_pool.shape != (N, bs, K, Hd) or v_pool.shape != k_pool.shape
            or H != K * n_rep):
        raise ValueError(f"paged_flash_attention: shapes q {tuple(q.shape)}, "
                         f"pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)}, "
                         f"n_rep {n_rep}")
    if tables.shape != (B, NT) or tables.dtype != torch.int32 \
            or not tables.is_contiguous():
        raise ValueError("paged_flash_attention: tables must be contiguous "
                         f"int32 [{B}, NT], got {tables.dtype} {tuple(tables.shape)}")
    if lengths.shape != (B,) or lengths.dtype != torch.int32 \
            or not lengths.is_contiguous():
        raise ValueError("paged_flash_attention: lengths must be contiguous "
                         f"int32 [{B}], got {lengths.dtype} {tuple(lengths.shape)}")
    if Hd not in PAGED_HEAD_DIMS:
        raise ValueError(f"paged_flash_attention: head_dim {Hd} not in "
                         f"{PAGED_HEAD_DIMS}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"paged_flash_attention: q dtype {q.dtype} "
                         "(float32 or bfloat16)")
    quant = k_scale is not None
    if (v_scale is not None) != quant:
        raise ValueError("paged_flash_attention: k_scale and v_scale go together")
    if quant:
        for s in (k_scale, v_scale):
            if (s.dtype != torch.float32 or s.shape != (N, bs, K, 1)
                    or s.device != dev or not s.is_contiguous()):
                raise ValueError("paged_flash_attention: scales must be "
                                 f"contiguous float32 [N, bs, K, 1] on {dev}")
        if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
            raise ValueError("paged_flash_attention: scales need int8 pools")
    elif k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(f"paged_flash_attention: pool dtype {k_pool.dtype}/"
                         f"{v_pool.dtype} must match q's {q.dtype} (or be int8 "
                         "with scales)")
    if not (q.is_contiguous() and k_pool.is_contiguous()
            and v_pool.is_contiguous()):
        raise ValueError("paged_flash_attention: q and the pools must be contiguous")
    check_aligned("paged_flash_attention", q, k_pool, v_pool)
    window = 0 if window is None else int(window)
    if window < 0:
        raise ValueError(f"paged_flash_attention: window {window} < 0")
    out = torch.empty_like(q)
    plan, ws = plan_launch(q, tables, bs, K, tile_geometry("paged_attention", Hd))
    with torch.cuda.device(dev):
        rc = _kernel()(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None,
            tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            ws.data_ptr() if ws is not None else None,
            B, T, NT, bs, H, K, Hd, 0 if q.dtype == torch.float32 else 1,
            int(quant), _scale(scale, Hd), float(softcap), window,
            plan.rows_per_block, plan.pages_per_split, plan.splits,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_flash_attention: kernel launch failed "
                           f"(cudaError {rc}, {plan})")
    launches += 1
    return out


def gather_paged_kv(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """The logical KV window: pool ``[N, bs, ...]`` gathered by tables
    ``[B, NT]`` → ``[B, NT * bs, ...]``."""
    g = pool[tables.long()]                       # [B, NT, bs, ...]
    return g.reshape((g.shape[0], g.shape[1] * g.shape[2]) + g.shape[3:])


def paged_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, tables: torch.Tensor,
                          lengths: torch.Tensor, n_rep: int, *,
                          scale: float = 0.0, softcap: float = 0.0,
                          window: int | None = None,
                          k_scale: torch.Tensor | None = None,
                          v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device: gather each
    row's logical window, then the dense plain attention with per-row
    lengths (the reference's ``paged_attention_ref``)."""
    ks = vs = None
    if k_scale is not None:
        ks, vs = gather_paged_kv(k_scale, tables), gather_paged_kv(v_scale, tables)
    return flash_attention_plain(
        q, gather_paged_kv(k_pool, tables), gather_paged_kv(v_pool, tables),
        lengths, n_rep, scale=scale, softcap=softcap, window=window,
        k_scale=ks, v_scale=vs)


def paged_attention_any(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, tables: torch.Tensor,
                        lengths: torch.Tensor, n_rep: int, scale: float = 0.0,
                        softcap: float = 0.0, window: int | None = None,
                        k_scale: torch.Tensor | None = None,
                        v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Paged attention by q's device: the CUDA kernel for a CUDA tensor
    (prefill, mixed and decode steps alike), the plain version for a CPU
    tensor."""
    kw = dict(scale=scale, softcap=softcap, window=window, k_scale=k_scale,
              v_scale=v_scale)
    if q.is_cuda:
        return paged_flash_attention(q, k_pool, v_pool, tables, lengths, n_rep,
                                     **kw)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, tables, lengths, n_rep,
                                     **kw)
    raise ValueError(f"paged_attention_any: no attention for device {q.device}")
