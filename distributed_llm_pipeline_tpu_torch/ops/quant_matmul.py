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

Two kernels serve a pack (``csrc/dequant_matmul.cu``, ``csrc/w8a8_matmul.cu``),
picked by M, the product of the leading dimensions of x, as the reference's
``q8_0_matmul`` picks them:

- M ≤ ``W8A8_MAX_M`` (decode, short prompts, the head of one position):
  activations are quantized per (row × group) to int8 (``quantize_acts``,
  group 256 where D allows it, else 32), one int32 dot per 32-row sub-block,
  times its scale, summed over the group, times the activation scale. The
  kernel quantizes the activations itself, in its prologue.
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
(``csrc/int8_matmul.cu``).

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

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

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

    def _dense_shape(self) -> tuple[int, int]:
        raise NotImplementedError

    def _act_group(self) -> int:
        raise NotImplementedError

    def _apply(self, fn, recurse=True):
        self._placed = None   # .to() and .cuda() replace the buffers
        return super()._apply(fn, recurse)

    def kernel_ptrs(self, device: torch.device) -> tuple[int, ...]:
        """The fields' data pointers for a kernel on ``device``, in
        ``fields`` order: checked (on ``device``, contiguous) once for each
        placement of the pack, then reused by every launch."""
        placed = self._placed
        if placed is None or placed[0] != device:
            for name in self.fields:
                t = self._buffers[name]
                if t.device != device or not t.is_contiguous():
                    raise ValueError(f"{self.kind} pack field {name} must be "
                                     f"contiguous on {device}")
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
        return GROUP if self.shape[1] % GROUP == 0 else QBLOCK

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
    a CUDA tensor of one of ``dtypes``, made contiguous."""
    if _NAMES.get(pack.kind, (None, None))[kernel] is None:
        raise ValueError(f"{what}: no kernel for pack kind {pack.kind!r}")
    if not x.is_cuda:
        raise ValueError(f"{what}: x must be a CUDA tensor")
    if x.dtype not in dtypes:
        raise ValueError(f"{what}: x dtype {x.dtype} (the kernel takes {dtypes})")
    if x.dim() != 2 or x.shape[1] != pack.shape[1]:
        raise ValueError(f"{what}: x {tuple(x.shape)} against a pack of "
                         f"[F, D] = {list(pack.shape)}")
    return x.contiguous()


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
    any kind in ``_NAMES`` → [M, F] in ``out_dtype``. The kernel quantizes x
    per (row × ``pack.group``) in its prologue. ``acts``, int8 [M, D] and f32
    [M, D/group] tensors, receive those activations when given (the check
    that they equal ``quantize_acts``)."""
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
    fn = _entry("w8a8_matmul", f"dlp_w8a8_{pack.kind}", 4 + len(ptrs), 6)
    _launch(fn, dev, what, x.data_ptr(), *ptrs, out.data_ptr(), xq_ptr, xs_ptr,
            int(x.dtype == torch.bfloat16), _out_flag(out_dtype, what), M, D, Fo, group)
    launches[_NAMES[pack.kind][1]] += 1
    return out


def dequant_matmul(x: torch.Tensor, pack: QuantPack,
                   out_dtype: torch.dtype) -> torch.Tensor:
    """The fused-dequant CUDA kernel: bf16 x [M, D] against a Q8_0, Q6_K,
    Q4_K or Q5_K (byte-code) pack, each weight tile dequantized to bf16 in shared memory and
    multiplied on the tensor cores with f32 accumulation (an affine pack's
    offset term too) → [M, F] in ``out_dtype``."""
    what = "dequant_matmul"
    if pack.kind == "int8":   # its M > 32 route is int8_matmul's GEMM
        raise ValueError(f"{what}: no kernel for pack kind 'int8'")
    x = _check_x(x, pack, (torch.bfloat16,), what, 0)
    M, D = x.shape
    Fo, dev = pack.shape[0], x.device
    ptrs = pack.kernel_ptrs(dev)
    out = torch.empty(M, Fo, dtype=out_dtype, device=dev)
    fn = _entry("dequant_matmul", f"dlp_dequant_matmul_{pack.kind}", 2 + len(ptrs), 4)
    _launch(fn, dev, what, x.data_ptr(), *ptrs, out.data_ptr(),
            _out_flag(out_dtype, what), M, D, Fo)
    launches[_NAMES[pack.kind][0]] += 1
    return out


def int8_matmul(x: torch.Tensor, pack: Int8Pack, out_dtype: torch.dtype,
                acts: tuple[torch.Tensor, torch.Tensor] | None = None
                ) -> torch.Tensor:
    """The int8 CUDA kernel: x [M, D] (f32 or bf16) against an int8 pack →
    [M, F] in ``out_dtype``, at any M. M ≤ ``INT8_W8A8_MAX_M`` runs the W8A8
    kernel with the int8 decoder (it quantizes x in its prologue); above,
    one launch
    quantizes x per (row × group) into int8 codes and f32 scales, then the
    int8 tensor-core GEMM of ``csrc/int8_matmul.cu`` consumes them.
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
    out = torch.empty(M, Fo, dtype=out_dtype, device=dev)
    quant = _entry("int8_matmul", "dlp_int8_quantize_acts", 3, 4)
    gemm = _entry("int8_matmul", "dlp_int8_matmul", 5, 5)
    _launch(quant, dev, what, x.data_ptr(), xq.data_ptr(), xs.data_ptr(),
            int(x.dtype == torch.bfloat16), M, D, group)
    _launch(gemm, dev, what, xq.data_ptr(), xs.data_ptr(), *pack.kernel_ptrs(dev),
            out.data_ptr(), _out_flag(out_dtype, what), M, D, Fo, group)
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
