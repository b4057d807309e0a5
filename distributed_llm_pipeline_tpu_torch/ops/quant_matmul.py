"""Q8_0 and int8 weights kept quantized on the device, the W8A8 integer-dot
path, and ``proj``: the one call site of every weight matmul.

The counterpart of ``distributed_llm_pipeline_tpu/ops/quant_matmul.py`` for
the Q8_0 and int8 formats. A pack is a small ``nn.Module`` whose buffers hold
the format's fields, laid out out-features-major (``[F, ·]``) to match the
port's ``F.linear`` weights ``[F, D]``: each output row's codes are contiguous
along the contraction axis D. The fields are the JAX package's, transposed:

    Q8_0  w = qs · scale, per 32-row block along D
        qs     int8 [F, D]
        scale  bf16 [F, D/32]   (bf16 even where the GGUF stores fp16 d)
    int8  w = qs · gs, per g-row group along D (g = 256, else 128, 64, 32)
        qs     int8 [F, D]
        gs     f32  [F, D/g]

Two kernels serve a pack (``csrc/dequant_matmul.cu``, the GEMM of
``csrc/kquant_gemm.cuh``; ``csrc/w8a8_matmul.cu``), picked by M, the product
of the leading dimensions of x, as the reference's ``q8_0_matmul`` picks
them:

- M ≤ ``W8A8_MAX_M`` (decode, short prompts, the head of one position):
  activations are quantized per (row × group) to int8 (``quantize_acts``,
  group 256 where D allows it, else 32), one int32 dot per 32-row sub-block,
  times its scale, summed over the group, times the activation scale. A
  small launch quantizes the activations into a workspace ahead of the
  persistent GEMV (``gemv_plan``); at a D the GEMV does not take
  (``gemv_takes``) the per-row kernel quantizes them in its prologue.
- M > ``W8A8_MAX_M`` (prefill, mixed steps): the weight tile is dequantized
  in the activation dtype (``q · scale`` rounded to bf16 on the serving
  path) and multiplied with f32 accumulation. A pack kind without a
  fused-dequant kernel (Q5_KS, as in the reference) dequantizes the whole
  weight and takes one dense product instead (``dequant_linear``).

An int8 pack takes its own kernel at every M (``int8_matmul``, as the
reference's ``int8_matmul`` has no cutover): the activations quantized per
(row × g) (``quantize_acts``), one exact int32 dot per group, times
``xs · gs``, summed over groups. M ≤ ``INT8_W8A8_MAX_M`` runs the W8A8
kernel above with the int8 decoder (sub-block 32, the f32 group scale);
larger M one quantize launch and an int8 tensor-core GEMM
(``csrc/int8_matmul.cu``, cut by ``int8_plan``).

Affine packs (Q4_K, Q5_KS, Q2_KS and the byte-code Q4_K8 and Q5_K: ``w = a ·
q − b``, ``QuantPack.offsets``) add the
offset term to both: ``− Σ_s (S[m, s] · xs[m, g(s)]) · b[f, s]`` with S the
exact integer sum of the quantized activations over each sub-block (W8A8),
and ``− bf16(Σ_sub x) @ bᵀ`` with the block sums taken in f32 (fused
dequant), as the reference's kernels compute them.

Dispatch picks by x's device: a CUDA tensor goes to the kernels, a CPU tensor
to their plain versions below. There is no fallback: a kernel that cannot
take its inputs, or cannot build or launch, raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .paged_attention import check_aligned, sm_count

QBLOCK = 32      # ggml Q8_0 block length
GROUP = 256      # activation group of the W8A8 path where D allows it
W8A8_MAX_M = 32  # decode/prefill cutover: M ≤ this takes the W8A8 kernel
# int8's own cutover between its two routes: the W8A8 kernel up to here, its
# GEMM above (on the H100 the GEMM's one 64-row tile beats the W8A8 kernel
# from M ≈ 5 on: PERF.md)
INT8_W8A8_MAX_M = 4

# kernel launches since the last reset, by TPU kernel name (chip_smoke.py
# reads them to prove the served path ran the kernels); only the CUDA
# wrappers below increment them
launches = {"q8_0_matmul": 0, "gw8a8_matmul": 0, "int8_matmul": 0,
            "q6_k_matmul": 0, "q6_k_w8a8_matmul": 0,
            "q4_k_matmul": 0, "q4_k_w8a8_matmul": 0, "q5_ks_w8a8_matmul": 0,
            "q2_ks_w8a8_matmul": 0, "q3_ks_w8a8_matmul": 0,
            "q5_k_matmul": 0, "q4_k8_w8a8_matmul": 0, "q5_k_w8a8_matmul": 0,
            "q6_k8_w8a8_matmul": 0}

# the launch counter of each pack kind's kernel (above, at or below
# W8A8_MAX_M): None where the kind has no fused-dequant kernel (M > W8A8_MAX_M
# then takes ``dequant_linear``); int8 counts its one kernel on both sides
_NAMES = {"q8_0": ("q8_0_matmul", "gw8a8_matmul"),
          "int8": ("int8_matmul", "int8_matmul"),
          "q6_k": ("q6_k_matmul", "q6_k_w8a8_matmul"),
          "q4_k": ("q4_k_matmul", "q4_k_w8a8_matmul"),
          "q5_ks": (None, "q5_ks_w8a8_matmul"),
          "q2_ks": (None, "q2_ks_w8a8_matmul"),
          "q3_ks": (None, "q3_ks_w8a8_matmul"),
          # the byte-code packs of tp > 1 meshes; their W8A8 forms are the
          # reference's gw8a8_matmul over byte codes
          "q4_k8": (None, "q4_k8_w8a8_matmul"),
          "q5_k": ("q5_k_matmul", "q5_k_w8a8_matmul"),
          "q6_k8": (None, "q6_k8_w8a8_matmul")}


def route(kind: str, M: int) -> str | None:
    """The launch counter that a matmul of M rows against a ``kind`` pack
    moves on the card; None for ``dequant_linear``, which launches none."""
    return _NAMES[kind][M <= W8A8_MAX_M]


def act_group(D: int, bands: int = 1) -> int:
    """The W8A8 activation group of a pack of contraction D whose layout
    pairs ``bands`` bands of D/bands rows in a byte (1 for one plane):
    ``GROUP`` where it divides a band, else 32, so that no group straddles a
    band. The packs' ``group`` and ``gemv_plan`` both take it from here."""
    return GROUP if (D // bands) % GROUP == 0 else QBLOCK


class QuantPack(nn.Module):
    """A projection weight kept quantized: one buffer per field of the
    format, out-features-major. Subclasses name the format (``kind``), its
    fields, the sub-block of one scale (``sub``), the dense shape and the
    activation group the fields give, and the codes they hold.

    ``shape`` is (F, D) of the dense weight the pack represents; ``group``
    is the activation group of its W8A8 path. A pack's fields do not change
    after construction; ``.to()`` moves them."""

    kind = ""
    fields: tuple[str, ...] = ()
    sub = 0

    def __init__(self, **tensors: torch.Tensor):
        super().__init__()
        if set(tensors) != set(self.fields):
            raise ValueError(f"{self.kind} pack fields {sorted(tensors)}, "
                             f"expected {sorted(self.fields)}")
        for name in self.fields:
            self.register_buffer(name, tensors[name])
        self.shape = self._dense_shape()
        self.group = self._act_group()
        self._placed = None   # (device, field pointers), checked for a kernel
        # ((device, field pointers), the GEMM's tensor maps, the fields they
        # address)
        self._gemm_maps = None

    def _dense_shape(self) -> tuple[int, int]:
        raise NotImplementedError

    def _act_group(self) -> int:
        raise NotImplementedError

    def _apply(self, fn, recurse=True):
        self._placed = self._gemm_maps = None   # .to() and .cuda() replace the buffers
        return super()._apply(fn, recurse)

    def kernel_ptrs(self, device: torch.device) -> tuple[int, ...]:
        """The fields' data pointers for a kernel on ``device``, in
        ``fields`` order: checked (on ``device``, contiguous, 16-byte aligned
        for the kernels' vector loads) once for each placement of the pack,
        then reused by every launch."""
        placed = self._placed
        if placed is None or placed[0] != device:
            for name in self.fields:
                t = self._buffers[name]
                if t.device != device or not t.is_contiguous():
                    raise ValueError(f"{self.kind} pack field {name} must be "
                                     f"contiguous on {device}")
                check_aligned(f"{self.kind} pack field {name}", t)
            placed = self._placed = (device, tuple(
                self._buffers[name].data_ptr() for name in self.fields))
        return placed[1]

    def codes_and_scales(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Int8 codes [F, D] in logical row order and one scale per
        ``sub``-row sub-block [F, D/sub]: ``w = codes · scale``, less the
        offsets of an affine pack."""
        raise NotImplementedError

    def offsets(self) -> torch.Tensor | None:
        """One offset per sub-block [F, D/sub] of an affine pack
        (``w = codes · scale − offset``), None for a symmetric one."""
        return None

    def dequant(self, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """The dense [F, D] weight the pack represents: ``codes · scale``
        (``− offset``) in f32, then ``dtype`` (the reference's
        ``dequant_q8_0`` and ``dequant_pack``)."""
        codes, sc = self.codes_and_scales()
        Fo, D = codes.shape
        w = codes.float().reshape(Fo, D // self.sub, self.sub) * sc.float()[..., None]
        off = self.offsets()
        if off is not None:
            w = w - off.float()[..., None]
        return w.reshape(Fo, D).to(dtype)

    def nbytes(self) -> int:
        return sum(b.numel() * b.element_size() for b in self.buffers())

    def extra_repr(self) -> str:
        return f"kind={self.kind}, shape={self.shape}"


class Q8_0Pack(QuantPack):
    kind = "q8_0"
    fields = ("qs", "scale")
    sub = QBLOCK

    def _dense_shape(self) -> tuple[int, int]:
        return tuple(self.qs.shape)

    def _act_group(self) -> int:
        return act_group(self.shape[1])

    def codes_and_scales(self) -> tuple[torch.Tensor, torch.Tensor]:
        return self.qs, self.scale


class Int8Pack(QuantPack):
    kind = "int8"
    fields = ("qs", "gs")

    @property
    def sub(self) -> int:   # one scale per activation group
        return self.group

    def _dense_shape(self) -> tuple[int, int]:
        return tuple(self.qs.shape)

    def _act_group(self) -> int:
        return self.shape[1] // self.gs.shape[1]

    def codes_and_scales(self) -> tuple[torch.Tensor, torch.Tensor]:
        return self.qs, self.gs


def _pow2_group(D: int) -> int | None:
    for g in (128, 64, 32):
        if D % g == 0:
            return g
    return None


def pack_int8(w: torch.Tensor | np.ndarray) -> Int8Pack:
    """Quantize a dense weight ``w [F, D]`` to int8 per g-row group along D,
    on the host: g = 256 where D allows it, else the largest power of two
    of 128, 64, 32 dividing D (a caller falls back to Q8_0 below that). The
    reference's ``pack_int8`` in numpy: ``gs = amax / 127`` (an f32
    division), codes rounded half to even against ``1 / gs``."""
    wn = np.ascontiguousarray(torch.as_tensor(w).detach().to("cpu", torch.float32)
                              .numpy().T)                        # [D, F]
    D, Fo = wn.shape
    group = GROUP if D % GROUP == 0 else _pow2_group(D)
    if group is None:
        raise ValueError(f"no int8 group divides contraction dim {D}")
    wb = wn.reshape(D // group, group, Fo)
    gs = (np.max(np.abs(wb), axis=-2) / 127.0).astype(np.float32)   # [D/g, F]
    inv = np.where(gs > 0, 1.0 / np.maximum(gs, 1e-30), 0.0)
    qs = np.clip(np.round(wb * inv[..., None, :]), -127, 127)
    return Int8Pack(qs=torch.from_numpy(np.ascontiguousarray(qs.reshape(D, Fo).T)
                                        .astype(np.int8)),
                    gs=torch.from_numpy(np.ascontiguousarray(gs.T)))


def _bf16(a: np.ndarray) -> torch.Tensor:
    """f32 values rounded to bf16 (round to nearest even, as ml_dtypes)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16)


def pack_q8_0(w: torch.Tensor | np.ndarray) -> Q8_0Pack:
    """Quantize a dense weight ``w [F, D]`` to Q8_0 along D, on the host.

    The codes are computed against the ROUNDED stored scale, so the
    dequantized error stays within scale/2 despite bf16's coarse mantissa
    (the reference's ``pack_q8_0``)."""
    wt = torch.as_tensor(w).detach().to("cpu", torch.float32)
    Fo, D = wt.shape
    if D % QBLOCK:
        raise ValueError(f"contraction dim {D} not a multiple of {QBLOCK}")
    wb = wt.reshape(Fo, D // QBLOCK, QBLOCK)
    scale = (wb.abs().amax(dim=-1) / 127.0).to(torch.bfloat16)   # [F, D/32]
    sf = scale.float()
    inv = torch.where(sf > 0, 1.0 / sf, torch.zeros_like(sf))
    qs = torch.round(wb * inv[..., None]).clamp_(-127, 127)
    return Q8_0Pack(qs=qs.reshape(Fo, D).to(torch.int8), scale=scale)


def pack_q8_0_from_gguf(raw, shape: tuple[int, int]) -> Q8_0Pack:
    """A pack straight from raw GGUF Q8_0 blocks (34 B: fp16 d, then 32
    int8) laid row-major over the (F, D) disk layout: the exact stored
    integers, the fp16 scale rounded to bf16. ``shape`` is (D, F), as the
    reference takes it."""
    D, Fo = shape
    if D % QBLOCK:
        raise ValueError(f"Q8_0 needs D % {QBLOCK} == 0, got {D}")
    blk = np.frombuffer(np.ascontiguousarray(raw), np.uint8).reshape(-1, 34)
    d = blk[:, 0:2].copy().view(np.float16).astype(np.float32)
    qs = blk[:, 2:34].view(np.int8).reshape(Fo, D)
    return Q8_0Pack(qs=torch.from_numpy(qs.copy()),
                    scale=_bf16(d.reshape(Fo, D // QBLOCK)))


# f32(1/127): the reference's ``amax / 127.0`` as it serves, under jit, where
# XLA folds a division by a constant into a product with its reciprocal
INV127 = float(np.float32(1.0) / np.float32(127.0))


def quantize_acts(x: torch.Tensor, group: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(row × group) symmetric int8 activation quantization:
    [M, D] → (int8 [M, D], f32 scales [M, D/group]). The amax is taken in
    f32, ``xs = amax · f32(1/127)``, ``inv = 1/max(xs, 1e-30)`` (an IEEE
    division; 0 where xs is 0), then round half to even and clip to ±127:
    the reference's ``quantize_acts`` bit for bit, as its jitted serving
    path computes it."""
    M, D = x.shape
    xf = x.float().reshape(M, D // group, group)
    xs = xf.abs().amax(dim=-1) * INV127
    inv = torch.where(xs > 0, 1.0 / xs.clamp_min(1e-30), torch.zeros_like(xs))
    xq = torch.round(xf * inv[..., None]).clamp_(-127, 127).to(torch.int8)
    return xq.reshape(M, D), xs


def gw8a8_plain(xq: torch.Tensor, xs: torch.Tensor, codes: torch.Tensor,
                sc: torch.Tensor, sb: int, out_dtype: torch.dtype,
                off: torch.Tensor | None = None) -> torch.Tensor:
    """The W8A8 kernels' function in plain PyTorch (the reference's
    ``gw8a8_band_accum``): pre-quantized ``xq [M, D]`` with scales
    ``xs [M, D/ag]`` against int8 ``codes [F, D]`` with one scale per
    ``sb``-row sub-block ``sc [F, D/sb]``. Each sub-block's integer dot is
    exact in f32 (|dot| ≤ 32·127² < 2²⁴); times its scale, summed over the
    group, times the activation scale, summed over groups. With offsets
    ``off [F, D/sb]`` (``w = codes · sc − off``) it subtracts
    ``Σ_s (S[m, s] · xs[m, g(s)]) · off[f, s]``, S the exact integer sum of
    ``xq`` over sub-block s."""
    M, D = xq.shape
    Fo = codes.shape[0]
    ag = D // xs.shape[1]
    spg, n_g = ag // sb, D // ag
    xg = xq.float().reshape(M, n_g, spg, sb)
    cg = codes.float().reshape(Fo, n_g, spg, sb)
    scg = sc.float().reshape(Fo, n_g, spg)
    acc = torch.zeros(M, Fo, dtype=torch.float32, device=xq.device)
    for g in range(n_g):
        p = torch.einsum("msk,fsk->msf", xg[:, g], cg[:, g])      # int dots
        acc += (p * scg[:, g].t()[None]).sum(1) * xs[:, g:g + 1]
    if off is not None:
        S = xq.float().reshape(M, D // sb, sb).sum(-1)
        acc -= (S * xs.repeat_interleave(spg, dim=1)) @ off.float().t()
    return acc.to(out_dtype)


def int8_matmul_plain(x: torch.Tensor, pack: Int8Pack,
                      out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The int8 kernel's function (the reference's grouped einsum,
    ``int8_matmul``'s CPU path): ``quantize_acts`` per (row × group), one
    exact integer dot P per group (|P| ≤ 256·127² < 2²⁴, so f32 holds it),
    then ``Σ_g P · (xs[m, g] · gs[f, g])`` in group order → [M, F] in
    ``out_dtype`` (default x's)."""
    xq, xs = quantize_acts(x, pack.group)
    M, D = xq.shape
    g = pack.group
    xg = xq.float().reshape(M, D // g, g)
    qg = pack.qs.float().reshape(pack.shape[0], D // g, g)
    gs = pack.gs.float()
    acc = torch.zeros(M, pack.shape[0], dtype=torch.float32, device=x.device)
    for j in range(D // g):
        acc += (xg[:, j] @ qg[:, j].t()) * (xs[:, j:j + 1] * gs[:, j][None])
    return acc.to(out_dtype or x.dtype)


def dequant_matmul_plain(x: torch.Tensor, pack: QuantPack,
                         out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The fused-dequant kernels' function (``q8_0_matmul``,
    ``q6_k_matmul``, ``q4_k_matmul``, ``q5_k_matmul``): the weight dequantized in x's dtype
    (``code · scale`` rounded once, as the kernels round each tile), then
    ``x [M, D] @ wᵀ`` with f32 accumulation → [M, F] in ``out_dtype``
    (default x's). An affine pack's offsets are not folded into the weight:
    ``− bf16(Σ_sub x) @ offᵀ`` follows, the block sums taken in f32 and
    rounded to x's dtype, the product accumulated in f32 (the reference's
    ``_q4k_kernel``)."""
    cd = x.dtype
    codes, sc = pack.codes_and_scales()
    Fo, D = codes.shape
    w = (codes.to(cd).reshape(Fo, D // pack.sub, pack.sub)
         * sc.to(cd)[..., None]).reshape(Fo, D)
    out = x.float() @ w.float().t()
    off = pack.offsets()
    if off is not None:
        xsum = x.float().reshape(x.shape[0], D // pack.sub, pack.sub).sum(-1).to(cd)
        out = out - xsum.float() @ off.to(cd).float().t()
    return out.to(out_dtype or cd)


def dequant_linear(x: torch.Tensor, pack: QuantPack,
                   out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """M > ``W8A8_MAX_M`` for a pack kind without a fused-dequant kernel
    (Q5_KS, Q2_KS, Q3_KS, Q4_K8, Q6_K8): the dense weight in x's dtype (``pack.dequant``), then one
    dense product, as the reference's einsum over ``dequant_pack``. A plain
    large product outside any kernel, on every device."""
    return proj(x, pack.dequant(x.dtype), out_dtype)


def w8a8_plain(x: torch.Tensor, pack: QuantPack,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The W8A8 kernels' function (``gw8a8_matmul`` on a Q8_0 pack and
    ``<kind>_w8a8_matmul`` on the K-quant packs) from unquantized x [M, D]:
    ``quantize_acts`` with the pack's group, then ``gw8a8_plain`` over the
    pack's codes and offsets → [M, F] in ``out_dtype`` (default x's)."""
    xq, xs = quantize_acts(x, pack.group)
    codes, sc = pack.codes_and_scales()
    return gw8a8_plain(xq, xs, codes, sc, pack.sub, out_dtype or x.dtype,
                       pack.offsets())


# --------------------------------------------------------------------------
# the CUDA kernels (csrc/dequant_matmul.cu, csrc/w8a8_matmul.cu,
# csrc/int8_matmul.cu)

_fns: dict[str, ctypes._CFuncPtr] = {}


def _entry(lib: str, name: str, n_ptr: int, n_int: int):
    """A C entry point of ``csrc/<lib>.cu``, built at first use: ``n_ptr``
    pointers, then ``n_int`` ints, then the stream; returns a cudaError."""
    fn = _fns.get(name)
    if fn is None:
        from .cuda_build import load_library

        fn = getattr(load_library(lib), name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _launch(fn, dev: torch.device, what: str, *args) -> None:
    """Call a kernel's C entry on ``dev``'s current stream; raise when the
    launch is refused."""
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            _launch(fn, dev, what, *args)
        return
    rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed (cudaError {rc})")


def _check_x(x: torch.Tensor, pack: QuantPack, dtypes: tuple, what: str,
             kernel: int) -> torch.Tensor:
    """x [M, D] for a kernel (``_NAMES`` index ``kernel``) against ``pack``:
    a CUDA tensor of one of ``dtypes``, made contiguous, at a 16-byte
    aligned address (the kernels load and stage x 16 bytes at a time; a
    misaligned load would end the process's CUDA context)."""
    if _NAMES.get(pack.kind, (None, None))[kernel] is None:
        raise ValueError(f"{what}: no kernel for pack kind {pack.kind!r}")
    if not x.is_cuda:
        raise ValueError(f"{what}: x must be a CUDA tensor")
    if x.dtype not in dtypes:
        raise ValueError(f"{what}: x dtype {x.dtype} (the kernel takes {dtypes})")
    if x.dim() != 2 or x.shape[1] != pack.shape[1]:
        raise ValueError(f"{what}: x {tuple(x.shape)} against a pack of "
                         f"[F, D] = {list(pack.shape)}")
    x = x.contiguous()
    check_aligned(what, x)
    return x


def _out_flag(out_dtype: torch.dtype, what: str) -> int:
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: out dtype {out_dtype} (float32 or bfloat16)")
    return int(out_dtype == torch.bfloat16)


def _check_acts(acts, M: int, D: int, group: int, dev: torch.device,
                what: str) -> tuple[torch.Tensor, torch.Tensor]:
    xq, xs = acts
    if (xq.shape != (M, D) or xq.dtype != torch.int8 or xs.shape != (M, D // group)
            or xs.dtype != torch.float32 or xq.device != dev or xs.device != dev
            or not (xq.is_contiguous() and xs.is_contiguous())):
        raise ValueError(f"{what}: acts must be contiguous int8 [{M}, {D}] and "
                         f"float32 [{M}, {D // group}] on {dev}")
    return xq, xs


def w8a8_matmul(x: torch.Tensor, pack: QuantPack, out_dtype: torch.dtype,
                acts: tuple[torch.Tensor, torch.Tensor] | None = None
                ) -> torch.Tensor:
    """The W8A8 CUDA kernel: x [M ≤ 32, D] (f32 or bf16) against a pack of
    any kind in ``_NAMES`` → [M, F] in ``out_dtype``, x quantized per (row ×
    ``pack.group``). ``acts``, int8 [M, D] and f32 [M, D/group] tensors,
    receive those activations when given (the check that they equal
    ``quantize_acts``). Where ``gemv_takes`` the kind and D, the persistent
    GEMV, cut by ``gemv_plan``, x quantized first by its own launch into a
    workspace; else ``w8a8_kernel``, which quantizes x in its prologue."""
    what = "w8a8_matmul"
    x = _check_x(x, pack, (torch.float32, torch.bfloat16), what, 1)
    M, D = x.shape
    Fo, group, dev = pack.shape[0], pack.group, x.device
    if not 0 < M <= W8A8_MAX_M:
        raise ValueError(f"{what}: M = {M} outside 1..{W8A8_MAX_M}")
    xq_ptr = xs_ptr = None
    if acts is not None:
        xq, xs = _check_acts(acts, M, D, group, dev, what)
        xq_ptr, xs_ptr = xq.data_ptr(), xs.data_ptr()
    ptrs = pack.kernel_ptrs(dev)
    out = torch.empty(M, Fo, dtype=out_dtype, device=dev)
    ws_arg, cut = (), ()
    if pack.kind in GEMV_KINDS:   # its entry takes a workspace and the plan
        ws, cut = None, (0,) * 6
        # where gemv_takes refuses the shape (a byte-code pack's D % 256 !=
        # 0), neither: the entry then runs w8a8_kernel
        if gemv_takes(pack.kind, D):
            p = gemv_plan(pack.kind, M, D, Fo, sm_count(dev.index))
            # the activations' images; held until both kernels are queued
            ws = torch.empty(p.ws_bytes, dtype=torch.uint8, device=dev)
            cut = (p.grid, p.rows_per_block, p.rows_per_tile, p.stages, p.m_slice, p.smem)
        ws_arg = (None if ws is None else ws.data_ptr(),)
    fn = _entry("w8a8_matmul", f"dlp_w8a8_{pack.kind}", 4 + len(ptrs) + len(ws_arg),
                6 + len(cut))
    _launch(fn, dev, what, x.data_ptr(), *ptrs, out.data_ptr(), xq_ptr, xs_ptr, *ws_arg,
            int(x.dtype == torch.bfloat16), _out_flag(out_dtype, what), M, D, Fo, group, *cut)
    launches[_NAMES[pack.kind][1]] += 1
    return out


# --------------------------------------------------------------------------
# the persistent W8A8 GEMV's cut (csrc/w8a8_matmul.cu, gemv_kernel)

GEMV_WARPS = 8
GEMV_SMEM_MAX = 232448   # a block's shared memory on the H100 (227 KB)
GEMV_SM_SMEM = 233472    # an SM's (228 KB), of which the card keeps 1 KB a block
GEMV_RING = 96 << 10     # the ring's bytes a block, about
GEMV_MAX_STAGES = 8


class GemvPack(NamedTuple):
    """A pack kind's span view (``csrc/quant_tile.cuh``) as the GEMV's cut
    sees it: the bands its layout pairs in a byte (1: one plane of byte
    codes; the activation group divides D/bands, ``act_group``), the rows a
    scale, each field's bytes a row as a divisor of D, whether it has
    offsets (the x image then holds -(float(S) · xs) per sub-block), and
    the register rows of x up to which a lane takes 4 rows of a tile, else
    2 (its ``ROWS``)."""
    bands: int
    sub: int
    fields: tuple[int, ...]
    affine: bool
    four_rows_to: int = 0


_GEMV_PACKS = {"q6_k": GemvPack(4, 16, (2, 4, 8), False),
               "q5_ks": GemvPack(2, 32, (2, 8, 16, 16), True),
               "q2_ks": GemvPack(4, 16, (4, 8, 8), True, 8),
               "q4_k": GemvPack(2, 32, (2, 16, 16), True),
               "q3_ks": GemvPack(4, 16, (4, 8, 8), False, 8),
               "q8_0": GemvPack(1, 32, (1, 16), False),
               "q4_k8": GemvPack(1, 32, (1, 16, 16), True),
               "q5_k": GemvPack(1, 32, (1, 16, 16), True),
               "q6_k8": GemvPack(1, 16, (1, 8), False)}
GEMV_KINDS = tuple(_GEMV_PACKS)


def gemv_takes(kind: str, D: int) -> bool:
    """Whether ``w8a8_matmul`` runs the persistent GEMV for a ``kind`` pack
    of contraction D, by shape alone: a GEMV kind with D a multiple of 256.
    A byte-code pack of another D (a tp shard's D = 1056; Q8_0 at D =
    2080), whose rows of scales are no multiple of 16 bytes and whose spans
    of 64 columns do not tile D, runs ``w8a8_kernel``, as int8 does at
    every D; the K-quant packs' D is always such a multiple."""
    return kind in _GEMV_PACKS and D % 256 == 0


class GemvPlan(NamedTuple):
    """How one launch of the persistent GEMV is cut: ``grid`` blocks, each
    the output rows ``[b · rows_per_block, (b + 1) · rows_per_block)`` (the
    last block fewer), walked in tiles of ``rows_per_tile`` rows: each lane
    takes ``lane_rows`` rows of a tile, each row taken by ``warps_per_row``
    of the 8 warps; a ring of ``stages`` tiles; x quantized ``m_slice`` rows
    a pass, ``passes`` passes, per activation group ``group``; ``smem``
    bytes of shared memory a block, ``blocks_per_sm`` blocks an SM (the grid
    is that times the SMs, or fewer where F has fewer rows); ``ws_bytes``
    of workspace for the passes' images of x."""
    grid: int
    rows_per_block: int
    rows_per_tile: int
    lane_rows: int
    warps_per_row: int
    stages: int
    m_slice: int
    passes: int
    group: int
    smem: int
    blocks_per_sm: int
    ws_bytes: int


def gemv_mt(m_slice: int) -> int:
    """The kernel's register rows of x (its template MT) for ``m_slice``:
    the power of two at or above it; the rows past the pass's are zeros."""
    return 1 << (m_slice - 1).bit_length()


def gemv_lane_rows(kind: str, m_slice: int) -> int:
    """Rows of a tile one lane takes (the decoder's ``ROWS``): 4 where their
    codes and sums fit the registers beside ``gemv_mt(m_slice)`` rows of x,
    else 2."""
    return 4 if gemv_mt(m_slice) <= _GEMV_PACKS[kind].four_rows_to else 2


def gemv_image(kind: str, D: int, group: int, m_slice: int) -> int:
    """The bytes of the GEMV's x region (one pass's image): xq, xs (rounded
    up to 16 bytes) and, for an affine pack, -(float(S) · xs) of
    ``gemv_mt(m_slice)`` rows."""
    mt, pk = gemv_mt(m_slice), _GEMV_PACKS[kind]
    return (mt * D + -(-(mt * (D // group) * 4) // 16) * 16
            + (mt * (D // pk.sub) * 4 if pk.affine else 0))


def gemv_smem(kind: str, D: int, group: int, rows_per_tile: int, stages: int,
              m_slice: int) -> int:
    """The shared memory bytes the GEMV takes (its ``gemv_layout``): the
    ring, the x region, the warps' sums of two tiles, one mbarrier a stage
    and one for x."""
    row = sum(D // n for n in _GEMV_PACKS[kind].fields)
    return (stages * rows_per_tile * row + gemv_image(kind, D, group, m_slice)
            + 2 * GEMV_WARPS * gemv_lane_rows(kind, m_slice) * gemv_mt(m_slice) * 4
            + 8 * (stages + 1))


@functools.lru_cache(maxsize=None)
def gemv_plan(kind: str, M: int, D: int, F: int, sm_count: int) -> GemvPlan:
    """The GEMV's cut, from shapes only (no value is read from the card). A
    row of the pack is D/64 spans of 64 weights; a warp's lanes take one
    span each of ``lane_rows`` rows, ``warps_per_row`` warps sharing a row
    where it has more than 32 spans (2 at D = 4096, 4 at 8192, at most 8),
    so a tile is ``8 / warps_per_row · lane_rows`` rows. Two blocks an SM
    where both fit the SM's shared memory with all M rows of x and a ring of
    two stages (one where a block has one tile), else one; the rows split
    evenly over that many blocks a card. The ring about ``GEMV_RING``
    bytes, no more stages than a block has tiles, fewer where x needs the
    room (at least 1). Where even one block cannot hold all M
    rows of x, the fewest passes, rows shared evenly among them. Raises
    ``ValueError`` on what the kernel refuses."""
    if kind not in _GEMV_PACKS:
        raise ValueError(f"gemv_plan: no GEMV for pack kind {kind!r} (of {GEMV_KINDS})")
    if not 0 < M <= W8A8_MAX_M or F < 1 or D < 256 or D % 256 or sm_count < 1:
        raise ValueError(f"gemv_plan: M={M}, D={D}, F={F} (the GEMV takes M in "
                         f"1..{W8A8_MAX_M}, F >= 1 and D a multiple of 256)")
    pk = _GEMV_PACKS[kind]
    group = act_group(D, pk.bands)
    wpr = 1 << min(3, max(0, (D // 64 // 32).bit_length() - 1))
    row = sum(D // n for n in pk.fields)

    def cut(ms: int, per_sm: int) -> tuple[int, int, int, int] | None:
        """(rows_per_block, rows_per_tile, stages, smem) at ``ms`` rows of x
        a pass and ``per_sm`` blocks an SM; None where it does not fit."""
        rows_per_tile = GEMV_WARPS // wpr * gemv_lane_rows(kind, ms)
        rows_per_block = -(-F // (sm_count * per_sm))
        tiles = -(-rows_per_block // rows_per_tile)
        stages = max(1, min(GEMV_MAX_STAGES, GEMV_RING // (rows_per_tile * row), tiles))
        # two blocks an SM keep a tile in flight under each one's compute
        least = 1 if per_sm == 1 else min(2, tiles)
        limit = GEMV_SMEM_MAX if per_sm == 1 else GEMV_SM_SMEM // per_sm - 1024
        while True:
            need = gemv_smem(kind, D, group, rows_per_tile, stages, ms)
            if need <= limit:
                return rows_per_block, rows_per_tile, stages, need
            if stages <= least:
                return None
            stages -= 1

    per_sm, m_slice = 1, M
    if cut(M, 2):
        per_sm = 2
    elif not cut(M, 1):
        passes = 2   # the fewest whose even share of M fits
        while passes < M and not cut(-(-M // passes), 1):
            passes += 1
        m_slice = -(-M // passes)
        if not cut(m_slice, 1):
            raise ValueError(f"gemv_plan: D={D} leaves no room for a row of x")
    rows_per_block, rows_per_tile, stages, need = cut(m_slice, per_sm)
    passes = -(-M // m_slice)
    return GemvPlan(-(-F // rows_per_block), rows_per_block, rows_per_tile,
                    gemv_lane_rows(kind, m_slice), wpr, stages, m_slice, passes, group, need,
                    per_sm, passes * gemv_image(kind, D, group, m_slice))


# --------------------------------------------------------------------------
# the fused-dequant GEMM's cut (csrc/kquant_gemm.cuh)

# the pack kinds of the GEMM: every kind with a fused-dequant kernel
GEMM_KINDS = ("q4_k", "q6_k", "q5_k", "q8_0")
GEMM_WIDE_M = 64   # M above this takes 128 rows of x a block, 64 up to it
MAX_SPLITS = 16


class GemmGeometry(NamedTuple):
    """The GEMM's tiling for one pack kind and block height, as
    ``csrc/kquant_gemm.cuh`` defines it (``gemm_geometry`` reads it from the
    library): rows of x and of W (output columns) a block, packed positions
    a k-step covers in each band, bands (Q4_K 2, Q6_K 4: a k-step takes the
    same positions of every band; the one plane of Q5_K and Q8_0 1, 128
    positions a step), columns of the affine offset term a k-step (0: none), ring
    stages, threads, dynamic shared memory bytes, blocks an SM holds (the
    card's occupancy query), and the multiple of which D must be."""
    bm: int
    bn: int
    positions: int
    bands: int
    tail_cols: int
    stages: int
    threads: int
    smem: int
    blocks_per_sm: int
    d_align: int = 256


class GemmPlan(NamedTuple):
    """How one launch is cut: ``bm`` rows of x and ``bn`` output columns a
    block, the grid (``tiles_n``, ``tiles_m``, ``splits``), the k-steps of
    the weight (``main_steps``) and of the offset term (``tail_steps``), and
    the k-steps each split runs (the last may run fewer)."""
    bm: int
    bn: int
    tiles_m: int
    tiles_n: int
    main_steps: int
    tail_steps: int
    splits: int
    steps_per_split: int


@functools.lru_cache(maxsize=None)
def gemm_geometry(kind: str, bm: int) -> GemmGeometry:
    """The library's tiling for ``kind`` (one of ``GEMM_KINDS``) over ``bm``
    rows of x a block, read once from its ``*_geometry`` entry."""
    from .cuda_build import load_library

    fn = getattr(load_library("dequant_matmul"), f"dlp_dequant_matmul_{kind}_geometry")
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(GemmGeometry._fields))()
    rc = fn(bm, out)
    if rc != 0:
        raise RuntimeError(f"dequant_matmul: {kind} geometry query failed (cudaError {rc})")
    return GemmGeometry(*out)


def gemm_bm(M: int) -> int:
    """Rows of x a block: 64 up to ``GEMM_WIDE_M`` rows, 128 above."""
    return 64 if M <= GEMM_WIDE_M else 128


@functools.lru_cache(maxsize=None)
def gemm_plan(M: int, D: int, F: int, geometry: GemmGeometry, sm_count: int) -> GemmPlan:
    """The launch's cut, from shapes and the kernel's tiling only (no value
    is read from the card). Output tiles of ``bm × bn``; where there are
    fewer tiles than the card has block slots (SMs × blocks an SM holds),
    split-K: the split count s (at most ``MAX_SPLITS``, no split empty) that
    minimises waves × k-steps a block, ``ceil(tiles · s / slots) ·
    ceil(steps / s)``, the smallest on a tie. The weight's last k-step is
    ragged where ``bands · positions`` does not divide D (Q5_K, Q8_0: only
    its slabs inside D are loaded and multiplied). Raises ``ValueError`` on
    what the kernel refuses."""
    g = geometry
    if M < 1 or F < 1 or D < g.d_align or D % g.d_align:
        raise ValueError(f"dequant_matmul: M={M}, D={D}, F={F} (the GEMM takes M, F ≥ 1 "
                         f"and D a multiple of {g.d_align})")
    tiles_m, tiles_n = -(-M // g.bm), -(-F // g.bn)
    if tiles_m > 65535:
        raise ValueError(f"dequant_matmul: M={M} needs {tiles_m} row tiles (at most 65535)")
    main = -(-D // (g.bands * g.positions))
    tail = -(-(D // 32) // g.tail_cols) if g.tail_cols else 0
    total = main + tail
    slots = max(1, sm_count * g.blocks_per_sm)
    tiles = tiles_m * tiles_n
    best = (0, 1, total)
    for s in range(1, min(MAX_SPLITS, total) + 1 if tiles < slots else 1):
        sps = -(-total // s)
        if -(-total // sps) != s:   # no split may be empty
            continue
        cost = -(-tiles * s // slots) * sps
        if s == 1 or cost < best[0]:
            best = (cost, s, sps)
    _, splits, sps = best
    return GemmPlan(g.bm, g.bn, tiles_m, tiles_n, main, tail, splits, sps)


def scale_rows(t: torch.Tensor) -> torch.Tensor:
    """A Q5_K pack's ``a`` or ``b`` or a Q8_0 pack's ``scale`` [F, D/32] as
    the GEMM's tensor maps read it: rows a multiple of 8 values (16 bytes,
    the least row pitch TMA takes) apart. The field itself where D/32 is
    such a multiple (D % 256 == 0); else a copy padded with zeros (a
    tensor-parallel shard: D = 1056 gives 66-byte rows; Q8_0 at D = 2080
    130-byte rows), at most 7 values a row."""
    n = t.shape[1]
    if n % 8 == 0:
        return t
    padded = torch.zeros(t.shape[0], -(-n // 8) * 8, dtype=t.dtype, device=t.device)
    padded[:, :n] = t
    return padded


def gemm_pack_maps(pack: QuantPack, dev: torch.device) -> ctypes.Array:
    """The GEMM's tensor maps of ``pack``'s fields (host memory), encoded
    once for each placement of the pack, as ``kernel_ptrs`` checks it once.
    A Q5_K pack's scales and offsets and a Q8_0 pack's scales go through
    ``scale_rows``; a padded copy lives in the cache beside the maps, made
    once per placement, never per call."""
    key = (dev, pack.kernel_ptrs(dev))
    cached = pack._gemm_maps
    if cached is None or cached[0] != key:
        from .cuda_build import load_library

        lib = load_library("dequant_matmul")
        fn = getattr(lib, f"dlp_dequant_matmul_{pack.kind}_pack_maps")
        fields = [pack._buffers[name] for name in pack.fields]
        fn.argtypes = [ctypes.c_void_p] * (len(fields) + 1) + [ctypes.c_int] * 2
        fn.restype = ctypes.c_int
        buf = ctypes.create_string_buffer(lib.dlp_dequant_matmul_pack_maps_bytes())
        if pack.kind in ("q5_k", "q8_0"):
            fields[1:] = [scale_rows(t) for t in fields[1:]]
        rc = fn(*(t.data_ptr() for t in fields), buf, pack.shape[1], pack.shape[0])
        if rc != 0:
            raise RuntimeError(f"dequant_matmul: {pack.kind} tensor maps failed (cudaError {rc})")
        cached = pack._gemm_maps = (key, buf, fields)
    return cached[1]


def gemm_workspace(plan: GemmPlan, M: int, D: int, F: int,
                   affine: bool) -> tuple[int, int]:
    """(bf16 values of the block sums, f32 values of the split partials) a
    launch needs: ``M × ⌈D/32⌉₃₂`` for an affine pack (Q4_K, Q5_K; else 0) and
    ``splits × M × F`` when it splits (else 0). Shapes only."""
    xs = M * (-(-(D // 32) // 32) * 32) if affine else 0
    return xs, plan.splits * M * F if plan.splits > 1 else 0


def dequant_matmul(x: torch.Tensor, pack: QuantPack,
                   out_dtype: torch.dtype) -> torch.Tensor:
    """The fused-dequant CUDA kernel: bf16 x [M, D] against a Q8_0, Q6_K,
    Q4_K or Q5_K (byte-code) pack, each weight value dequantized to bf16 and
    multiplied on the tensor cores with f32 accumulation (an affine pack's
    offset term too) → [M, F] in ``out_dtype``: the GEMM of
    ``csrc/kquant_gemm.cuh`` cut by ``gemm_plan``, with its workspaces
    allocated here. One count per call."""
    what = "dequant_matmul"
    if pack.kind == "int8":   # its M > 32 route is int8_matmul's GEMM
        raise ValueError(f"{what}: no kernel for pack kind 'int8'")
    x = _check_x(x, pack, (torch.bfloat16,), what, 0)
    M, D = x.shape
    Fo, dev = pack.shape[0], x.device
    flag = _out_flag(out_dtype, what)
    maps = gemm_pack_maps(pack, dev)
    plan = gemm_plan(M, D, Fo, gemm_geometry(pack.kind, gemm_bm(M)), sm_count(dev.index))
    n_xs, n_part = gemm_workspace(plan, M, D, Fo, plan.tail_steps > 0)
    xs = torch.empty(n_xs, dtype=torch.bfloat16, device=dev) if n_xs else None
    part = torch.empty(n_part, dtype=torch.float32, device=dev) if n_part else None
    out = torch.empty(M, Fo, dtype=out_dtype, device=dev)
    fn = _entry("dequant_matmul", f"dlp_dequant_matmul_{pack.kind}", 5, 7)
    _launch(fn, dev, what, x.data_ptr(), ctypes.addressof(maps), out.data_ptr(),
            None if xs is None else xs.data_ptr(),
            None if part is None else part.data_ptr(),
            flag, M, D, Fo, plan.bm, plan.splits, plan.steps_per_split)
    launches[_NAMES[pack.kind][0]] += 1
    return out


# --------------------------------------------------------------------------
# the int8 GEMM's cut (csrc/int8_matmul.cu)

INT8_BM = 128       # rows of x a block: two consumer warpgroups of 64
INT8_BNS = (128, 64)  # rows of qs (output columns) a block, the wider first
INT8_KSTEP = 128    # columns of a k-step: 128 / group whole groups, or half of a 256 group
INT8_GROUPS = (256, 128, 64, 32)


class Int8Geometry(NamedTuple):
    """The int8 GEMM's tiling for one group and block width, as
    ``csrc/int8_matmul.cu`` defines it (``int8_geometry`` reads it from the
    library): rows of x and of qs a block, columns a k-step, ring stages,
    threads, dynamic shared memory bytes, blocks an SM holds."""
    bm: int
    bn: int
    kstep: int
    stages: int
    threads: int
    smem: int
    blocks_per_sm: int


class Int8Plan(NamedTuple):
    """How one int8 GEMM launch is cut: ``bm`` rows of x and ``bn`` output
    columns a block, the grid (``tiles_n``, ``tiles_m``), the weight group,
    the groups of D (``groups``, each summed in order within one block) and
    the k-steps of ``INT8_KSTEP`` columns that carry them (a group of 256
    spans two; the last ragged where the step does not divide D). There is
    no split-K: ``splits`` is 1."""
    bm: int
    bn: int
    tiles_m: int
    tiles_n: int
    group: int
    groups: int
    steps: int
    splits: int = 1


@functools.lru_cache(maxsize=None)
def int8_geometry(group: int, bn: int) -> Int8Geometry:
    """The library's tiling for ``group`` and ``bn``, read once from its
    ``dlp_int8_matmul_geometry`` entry."""
    from .cuda_build import load_library

    fn = load_library("int8_matmul").dlp_int8_matmul_geometry
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(Int8Geometry._fields))()
    rc = fn(group, bn, out)
    if rc != 0:
        raise RuntimeError(f"int8_matmul: geometry query failed (cudaError {rc})")
    return Int8Geometry(*out)


@functools.lru_cache(maxsize=None)
def int8_plan(M: int, D: int, F: int, group: int, sm_count: int) -> Int8Plan:
    """The int8 GEMM's cut, from shapes only: output tiles of ``INT8_BM`` ×
    bn, bn 64 where that whole grid fits one wave of the card (one block an
    SM), else 128: a thin grid takes narrower tiles to fill more SMs, never
    split-K, so each output's groups stay in one block, summed in group
    order. Raises ``ValueError`` on what the kernel refuses."""
    if M < 1 or F < 1 or group not in INT8_GROUPS or D < group or D % group:
        raise ValueError(f"int8_matmul: M={M}, D={D}, F={F}, group={group} (the GEMM "
                         f"takes M, F >= 1 and D a multiple of a group of {INT8_GROUPS})")
    tiles_m = -(-M // INT8_BM)
    if tiles_m > 65535:
        raise ValueError(f"int8_matmul: M={M} needs {tiles_m} row tiles (at most 65535)")
    bn = INT8_BNS[1] if tiles_m * -(-F // INT8_BNS[1]) <= sm_count else INT8_BNS[0]
    return Int8Plan(INT8_BM, bn, tiles_m, -(-F // bn), group, D // group,
                    -(-D // INT8_KSTEP))


def int8_matmul(x: torch.Tensor, pack: Int8Pack, out_dtype: torch.dtype,
                acts: tuple[torch.Tensor, torch.Tensor] | None = None
                ) -> torch.Tensor:
    """The int8 CUDA kernel: x [M, D] (f32 or bf16) against an int8 pack →
    [M, F] in ``out_dtype``, at any M. M ≤ ``INT8_W8A8_MAX_M`` runs the W8A8
    kernel with the int8 decoder (it quantizes x in its prologue); above,
    one launch quantizes x per (row × group) into int8 codes and f32
    scales, then the int8 tensor-core GEMM of ``csrc/int8_matmul.cu``, cut
    by ``int8_plan``, consumes them.
    ``acts`` receive the quantized activations when given, as for
    ``w8a8_matmul``. One count per call, whichever route."""
    what = "int8_matmul"
    if pack.kind != "int8":
        raise ValueError(f"{what}: pack kind {pack.kind!r} (int8 only)")
    x = _check_x(x, pack, (torch.float32, torch.bfloat16), what, 0)
    M, D = x.shape
    if M <= INT8_W8A8_MAX_M:
        return w8a8_matmul(x, pack, out_dtype, acts)
    Fo, group, dev = pack.shape[0], pack.group, x.device
    if acts is None:
        acts = (torch.empty(M, D, dtype=torch.int8, device=dev),
                torch.empty(M, D // group, dtype=torch.float32, device=dev))
    xq, xs = _check_acts(acts, M, D, group, dev, what)
    plan = int8_plan(M, D, Fo, group, sm_count(dev.index))
    out = torch.empty(M, Fo, dtype=out_dtype, device=dev)
    quant = _entry("int8_matmul", "dlp_int8_quantize_acts", 3, 4)
    gemm = _entry("int8_matmul", "dlp_int8_matmul", 5, 6)
    _launch(quant, dev, what, x.data_ptr(), xq.data_ptr(), xs.data_ptr(),
            int(x.dtype == torch.bfloat16), M, D, group)
    _launch(gemm, dev, what, xq.data_ptr(), xs.data_ptr(), *pack.kernel_ptrs(dev),
            out.data_ptr(), _out_flag(out_dtype, what), M, D, Fo, group, plan.bn)
    launches["int8_matmul"] += 1
    return out


# --------------------------------------------------------------------------
# dispatch

def quant_matmul_plain(x: torch.Tensor, pack: QuantPack,
                       out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The kernels' dispatch with their plain versions, on any device:
    x [..., D] → [..., F]; an int8 pack at every M, else W8A8 for
    M ≤ ``W8A8_MAX_M``, fused dequant above (``dequant_linear`` for a kind
    without that kernel)."""
    *lead, D = x.shape
    xf = x.reshape(-1, D)
    if pack.kind == "int8":
        plain = int8_matmul_plain
    elif xf.shape[0] <= W8A8_MAX_M:
        plain = w8a8_plain
    else:
        plain = dequant_matmul_plain if _NAMES[pack.kind][0] else dequant_linear
    return plain(xf, pack, out_dtype).reshape(*lead, -1)


def quant_matmul(x: torch.Tensor, pack: QuantPack,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """x [..., D] against a pack → [..., F] in ``out_dtype`` (default x's):
    the CUDA kernels for a CUDA tensor (an int8 pack's at every M; else W8A8
    for M ≤ ``W8A8_MAX_M``, fused dequant above, ``dequant_linear`` for a
    kind without that kernel), their plain versions for a CPU tensor."""
    if x.device.type == "cpu":
        return quant_matmul_plain(x, pack, out_dtype)
    if not x.is_cuda:
        raise ValueError(f"quant_matmul: no kernel for device {x.device}")
    *lead, D = x.shape
    xf = x.reshape(-1, D)
    od = out_dtype or x.dtype
    if pack.kind == "int8":
        out = int8_matmul(xf, pack, od)
    elif xf.shape[0] <= W8A8_MAX_M:
        out = w8a8_matmul(xf, pack, od)
    elif _NAMES[pack.kind][0] is None:
        out = dequant_linear(xf, pack, od)
    else:
        out = dequant_matmul(xf, pack, od)
    return out.reshape(*lead, -1)


def proj(x: torch.Tensor, w: torch.Tensor | QuantPack,
         out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """x [..., D] against a dense weight [F, D] or a pack: the single call
    site of every weight matmul. ``out_dtype`` overrides the output dtype:
    the head asks for f32 logits, accumulated in f32 without an f32 copy of
    the weight on the card."""
    if isinstance(w, QuantPack):
        return quant_matmul(x, w, out_dtype)
    if out_dtype is None or out_dtype == x.dtype:
        return F.linear(x, w)
    if x.is_cuda:   # cuBLAS keeps its f32 accumulator for the output
        out = torch.mm(x.reshape(-1, x.shape[-1]), w.t(), out_dtype=out_dtype)
        return out.reshape(*x.shape[:-1], w.shape[0])
    # the CPU has no mixed-dtype product: widen both (bf16 products are
    # exact in f32), accumulate in f32
    return F.linear(x.float(), w.float()).to(out_dtype)
