"""The two tensor-core device kernels alone: the conv-GEMM and the
weight-gradient GEMM of ``csrc/tc_gemm.cu``, with their plain PyTorch
versions, the plain version of the 3xTF32 arithmetic and the plans by
which the chains dispatch their products.

The kernels serve every launch chain of ``csrc/`` (the flow block's, the
WN stack's and the text side's).  A TF32 operand keeps 10 mantissa bits,
so each f32 value is split into ``big`` (rounded to 10 mantissa bits) and
``small`` (the exact remainder, cut to 10 bits) and a product accumulates
``small_a big_b + big_a small_b + big_a big_b`` in f32: three tensor-core
passes for one, f32-accurate.  ``big`` is rounded to nearest, not
truncated: truncation shrinks every term alike, a bias of 5e-7 of each
output.  Bound: operations over a third of the TF32 peak.

:func:`conv_product` and :func:`weight_gradient` run one device kernel
with the bare epilogue, for tests and ``chip_smoke.py``; nothing on the
model's path calls them (the chains reach the kernels in C).  ``mode``:
"auto" as the flow chains dispatch (the tensor-core kernel's 128-row tile
where the shape fits, else the CUDA-core kernel), "text" as the text
chains dispatch (split-K allowed: shares of the K walk added in split
order by a second pass, where that makes fewer waves), "serve" as the
serving flow block's chain dispatches (the tensor cores in 128- or 64-row
tiles, a lone sentence's K walk in finer shares), "tc" the tensor-core
kernel over the whole K walk or an error, "core" the CUDA-core kernel.

The layout helpers are the plain versions of what the kernels do to the
weights: :func:`split_weights_plain` the K-major 3xTF32 split that
``split_weights_kernel`` writes before a chain's tensor-core conv-GEMMs
(or once at load, for the serving flow block),
:func:`physical_cols` the row order in which a paired epilogue's tile
reads it.
"""

import typing

import torch

from .. import kernels
from .conv import _shifted, offsets

_MODES = {"auto": 0, "tc": 1, "core": 2, "text": 3, "serve": 4}
# split-K's limits (csrc/common.cuh kSplitKCols, csrc/tc_gemm.cu): partial
# sums a row over all shares, shares, 32-deep slices a share, rows
SPLIT_K_COLS, SPLIT_K_MAX, SPLIT_K_MIN_SLICES, SPLIT_K_MIN_ROWS = 1536, 4, 4, 512
# the serving chain's for a lone sentence, below LONE_SENTENCE_ROWS rows
# (kLoneSplits, kLoneSplitKCols, kLoneSentenceRows)
LONE_SPLIT_K_COLS, LONE_SPLIT_K_MAX, LONE_SPLIT_K_MIN_SLICES = 3072, 8, 2
LONE_SENTENCE_ROWS = 1024
_TF32_MASK = -8192  # 0xffffe000 as int32: clears the low 13 mantissa bits
_TF32_HALF = 0x1000  # half of the last kept bit


def tf32_split(v: torch.Tensor) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """f32 ``v`` -> (big, small), both exact TF32 values: ``big`` is ``v``
    rounded to 10 mantissa bits (to nearest, ties away from zero, as the
    kernels do it: half of the last kept bit added to the bit pattern's
    magnitude, then the low 13 bits cleared), ``small`` the
    remainder ``v - big`` (exact in f32) with its low 13 bits cleared;
    ``big + small`` equals ``v`` to within 2^-21 of it."""
    v = v.to(torch.float32).contiguous()
    big = ((v.view(torch.int32) + _TF32_HALF) & _TF32_MASK).view(torch.float32)
    small = ((v - big).contiguous().view(torch.int32) & _TF32_MASK).view(torch.float32)
    return big, small


def matmul_3xtf32_plain(
    a: torch.Tensor, b: typing.Optional[torch.Tensor], slice_k: typing.Optional[int] = None,
    splits: int = 1, b_split: typing.Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``a @ b`` as the tensor-core kernels compute it: both operands split
    by :func:`tf32_split`, three products added small terms first (each
    product exact in float64, the sum rounded to f32 once).  ``slice_k``:
    each ``slice_k``-deep slice of the K walk summed alone and rounded to
    f32, the slices added in f32 in order (the kernels' short chains);
    ``splits``: the K walk's slices cut into that many shares, each summed
    so, the shares added in f32 in split order (split-K's second pass).
    ``b_split``: B's K-major split as the kernels read it ([2, N, K],
    :func:`split_weights_plain`), in place of ``b``."""
    a_big, a_small = (t.double() for t in tf32_split(a))
    if b_split is not None:
        b_big, b_small = (t.T.double() for t in b_split)
    else:
        b_big, b_small = (t.double() for t in tf32_split(b))
    if slice_k is None and splits == 1:
        return (a_small @ b_big + a_big @ b_small + a_big @ b_big).to(torch.float32)
    k = a.shape[-1]
    step = slice_k or k
    n_slices = -(-k // step)
    per_split = -(-n_slices // splits)
    total = None
    for s0 in range(0, n_slices, per_split):
        acc = None
        for sl in range(s0, min(s0 + per_split, n_slices)):
            ks = slice(sl * step, min((sl + 1) * step, k))
            part = (a_small[..., ks] @ b_big[ks] + a_big[..., ks] @ b_small[ks]
                    + a_big[..., ks] @ b_big[ks]).to(torch.float32)
            acc = part if acc is None else acc + part
        total = acc if total is None else total + acc
    return total


def matmul_1xtf32_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with both operands rounded to TF32 once: what a single
    tensor-core pass computes at best, for comparison."""
    return (tf32_split(a)[0].double() @ tf32_split(b)[0].double()).to(torch.float32)


def _shares_cost(
    rows: int, kdim: int, n: int, sms: int, tile_rows: int,
    limits: typing.Tuple[int, int, int] = (SPLIT_K_MAX, SPLIT_K_MIN_SLICES, SPLIT_K_COLS),
) -> typing.Tuple[int, int]:
    """(K shares, waves of ``tile_rows``-row blocks times 32-deep slices a
    block) of a split-K product (csrc/tc_gemm.cu ``best_shares``): the
    share count, at most ``limits`` = (shares, slices a share at least,
    partial sums a row), whose cost is least (ties to fewer)."""
    max_splits, min_slices, max_cols = limits
    bn = 128 if n % 128 == 0 else 64
    tiles = -(-rows // tile_rows) * -(-n // bn)
    slices = -(-kdim // 32)
    best, best_cost = 1, -(-tiles // sms) * slices
    if n % 4 == 0:
        for s in range(2, max_splits + 1):
            per = -(-slices // s)
            splits = -(-slices // per)
            if per < min_slices or splits * n > max_cols:
                break
            cost = -(-tiles * splits // sms) * per
            if cost < best_cost:
                best, best_cost = splits, cost
    return best, best_cost


def text_product_plan(rows: int, kdim: int, n: int, sms: int) -> typing.Tuple[bool, int]:
    """A text chain's conv-GEMM of ``rows`` x ``kdim`` x ``n`` (operands the
    tensor-core kernel can take) -> (whether it takes the tensor cores, its
    K shares): the plain version of ``conv_gemm_tc_fits`` and
    ``conv_gemm_tc_plan``.  Shares: the count, within the chains' limits
    above (none below SPLIT_K_MIN_ROWS rows), whose waves of 128-row blocks
    times 32-deep slices a block is least (ties to fewer); the tensor
    cores: at least 64 columns, 32 deep, and blocks for a quarter of the
    ``sms``."""
    best = _shares_cost(rows, kdim, n, sms, 128)[0] if rows >= SPLIT_K_MIN_ROWS else 1
    bn = 128 if n % 128 == 0 else 64
    blocks = -(-rows // 128) * -(-n // bn) * best
    return n >= 64 and kdim >= 32 and 4 * blocks >= sms, best


def inverse_product_plan(rows: int, kdim: int, n: int, sms: int) -> typing.Tuple[int, int]:
    """A conv-GEMM of the serving inverse chain (csrc/block.cu, which sets
    ``ConvGemm::small_batch``) -> (rows of its tile, 0 where it is declined
    to the CUDA cores; K shares): the tensor cores, in 128- or 64-row
    tiles, whichever with its best share count makes the fewest waves
    times slices a block (ties to fewer shares, then to 64 rows); a lone
    sentence (below LONE_SENTENCE_ROWS rows) with shares as short as 64
    deep, up to 8, a batch within the chains' limits."""
    if n < 64 or kdim < 32:
        return 0, 1
    limits = ((LONE_SPLIT_K_MAX, LONE_SPLIT_K_MIN_SLICES, LONE_SPLIT_K_COLS)
              if rows < LONE_SENTENCE_ROWS else (SPLIT_K_MAX, SPLIT_K_MIN_SLICES, SPLIT_K_COLS))
    (s64, c64), (s128, c128) = (_shares_cost(rows, kdim, n, sms, tr, limits) for tr in (64, 128))
    return (64, s64) if (c64, s64) <= (c128, s128) else (128, s128)


def block_inverse_products(
    rows: int, c: int, h: int, n_layers: int, taps: int, sms: int
) -> typing.List[dict]:
    """The plan of one serving flow block over ``rows`` rows, by
    :func:`inverse_product_plan`: per product (start, per WN layer the
    in-layer conv and the res/skip, end, the folded A) its name, [rows, K,
    N], tile rows (0: the CUDA cores) and K shares."""
    shapes = [("start", c // 2, h)]
    for l in range(n_layers):
        shapes += [(f"in_{l}", taps * h, 2 * h), (f"res_skip_{l}", h, 2 * h)]
    shapes += [("end", h, c), ("fold_a", c, c)]
    out = []
    for name, kdim, n in shapes:
        tile_rows, splits = inverse_product_plan(rows, kdim, n, sms)
        out.append({"name": name, "shape": [rows, kdim, n], "tile_rows": tile_rows,
                    "splits": splits})
    return out


def plan_counts(plan: typing.List[dict], chains: int = 1) -> typing.Dict[str, int]:
    """Device products of ``chains`` calls of a chain whose every product
    asks for the tensor cores, from its plan (:func:`block_inverse_products`):
    ``kernels.product_counts``'s conv-GEMM keys."""
    on = sum(p["tile_rows"] > 0 for p in plan)
    return {"tc_gemm": chains * on, "core_gemm": chains * (len(plan) - on),
            "declined_gemm": chains * (len(plan) - on)}


def _text_chain_counts(
    rows: int, sms: int, forward: int, backward: int,
    convs: typing.Sequence[typing.Tuple[int, int]],
    transposed: typing.Sequence[typing.Tuple[int, int]],
) -> typing.Dict[str, int]:
    """Device products of ``forward`` forward chains and ``backward``
    backward chains (each recomputes the forward) of a text stack over
    ``rows`` rows, by :func:`text_product_plan`: ``convs`` (K, N) run in
    both, ``transposed`` (K, N) and one weight gradient per conv in the
    backward; every product asks for the tensor cores and takes them where
    the plan says so, else it is declined to the CUDA cores; a weight
    gradient takes them from 256 rows, 32 columns and 32 deep."""
    counts = dict(tc_gemm=0, tc_wgrad=0, core_gemm=0, core_wgrad=0,
                  declined_gemm=0, declined_wgrad=0)
    gemms = [(k, n, forward + backward) for k, n in convs]
    gemms += [(k, n, backward) for k, n in transposed]
    for kdim, n, chains in gemms:
        on = text_product_plan(rows, kdim, n, sms)[0]
        counts["tc_gemm" if on else "core_gemm"] += chains
        counts["declined_gemm"] += 0 if on else chains
    for kdim, n in convs:
        on = rows >= 256 and n >= 32 and kdim >= 32
        counts["tc_wgrad" if on else "core_wgrad"] += backward
        counts["declined_wgrad"] += 0 if on else backward
    return counts


def prenet_products(
    rows: int, h: int, n_layers: int, taps: int, sms: int, forward: int, backward: int
) -> typing.Dict[str, int]:
    """Device products of ``forward`` prenet forward chains and ``backward``
    backward chains (csrc/text.cu, csrc/text_train.cu): forward, the
    ``n_layers`` convs [rows, taps * h, h] and the projection [rows, h, h];
    backward, those again, as many transposed products of the same shapes
    (the convs' input gradients, the projection's), and ``n_layers + 1``
    weight gradients.  Operands are taken to be what the kernels can read
    (h a multiple of 4)."""
    convs = [(taps * h, h)] * n_layers + [(h, h)]
    return _text_chain_counts(rows, sms, forward, backward, convs, convs)


def duration_products(
    rows: int, c_in: int, f: int, taps: int, sms: int, forward: int, backward: int
) -> typing.Dict[str, int]:
    """Device products of ``forward`` duration-stack forward chains and
    ``backward`` backward chains (csrc/text.cu, csrc/text_train.cu):
    forward, the two convs [rows, taps * c_in, f] and [rows, taps * f, f];
    backward, those again, the two transposed convs [rows, taps * f, c_in]
    and [rows, taps * f, f], and two weight gradients.  Operands are taken
    to be what the kernels can read (c_in and f multiples of 4)."""
    convs = [(taps * c_in, f), (taps * f, f)]
    return _text_chain_counts(rows, sms, forward, backward, convs,
                              [(taps * f, c_in), (taps * f, f)])


def split_weights_plain(w: torch.Tensor) -> torch.Tensor:
    """w [K, N] -> [2, N, K]: the K-major layout the tensor-core conv-GEMM
    reads, ``[0]`` the big and ``[1]`` the small TF32 part."""
    return torch.stack(tf32_split(w.T.contiguous()))


def physical_cols(n: int, split: int) -> torch.Tensor:
    """Row of the K-major weights that tile row (logical column) ``i`` of a
    paired epilogue reads: the pair (j, j + split) sits at columns 2j and
    2j + 1, so one thread's accumulator fragment holds both."""
    i = torch.arange(n)
    return (i >> 1) + (i & 1) * split


def im2col_plain(
    a: torch.Tensor, taps: int, dilation: int = 1, tap_sign: int = 1,
    a_mask: typing.Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """a [b, t, c] -> [b, t, taps * c]: column ``tap * c + ch`` of row i is
    ``a[i + tap_sign * (tap - taps // 2) * dilation, ch]`` times ``a_mask``
    [b, t, 1] of that source row, zero outside [0, t): the gather both
    kernels do while staging."""
    if a_mask is not None:
        a = a * a_mask
    return torch.cat([_shifted(a, tap_sign * o) for o in offsets(taps, dilation)], dim=-1)


def transposed_weights_plain(w: torch.Tensor, taps: int) -> torch.Tensor:
    """A forward conv's w [taps * n, c] -> [taps * c, n], per tap the
    transposed block: the B of its input gradient, which the kernels read
    from ``w`` as it lies."""
    n = w.shape[0] // taps
    return w.reshape(taps, n, -1).transpose(1, 2).reshape(-1, n)


def conv_product_plain(
    a, w, taps=1, dilation=1, tap_sign=1, a_mask=None, w_t=False
) -> torch.Tensor:
    """Plain version of :func:`conv_product`."""
    if w_t:
        w = transposed_weights_plain(w, taps)
    return im2col_plain(a, taps, dilation, tap_sign, a_mask) @ w


def weight_gradient_plain(a, dy, taps=1, dilation=1, a_mask=None, dy_mask=None) -> torch.Tensor:
    """Plain version of :func:`weight_gradient`."""
    cols = im2col_plain(a, taps, dilation, 1, a_mask)
    if dy_mask is not None:
        dy = dy * dy_mask
    return cols.reshape(-1, cols.shape[-1]).T @ dy.reshape(-1, dy.shape[-1])


def _scratch(x_like: torch.Tensor, floats: int) -> torch.Tensor:
    return x_like.new_empty((max(floats, 1 << 22),))


def conv_product(
    a: torch.Tensor,
    w: torch.Tensor,
    taps: int = 1,
    dilation: int = 1,
    tap_sign: int = 1,
    a_mask: typing.Optional[torch.Tensor] = None,
    mode: str = "auto",
    w_t: bool = False,
) -> torch.Tensor:
    """a [b, t, c], w [taps * c, n] -> im2col(a) @ w [b, t, n] by one
    conv-GEMM launch (no bias, no tail); with ``w_t`` w is a forward conv's
    [taps * n, c] and the product's B its per-tap transpose.  CPU tensors
    take the plain version."""
    if kernels.route(a) == "plain":
        return conv_product_plain(a, w, taps, dilation, tap_sign, a_mask, w_t)
    batch, t, c = a.shape
    kernels.check_operands(a.device, a=a, w=w, a_mask=a_mask)
    n = w.shape[0] // taps if w_t else w.shape[1]
    kernels.check_shape("w", w, (taps * n, c) if w_t else (taps * c, n))
    if a_mask is not None:
        kernels.check_shape("a_mask", a_mask, (batch, t, 1))
    out = a.new_empty((batch, t, n))
    # the weights' split, then split-K's partial sums (kSplitKCols a row;
    # the serving chain's kLoneSplitKCols)
    part_cols = LONE_SPLIT_K_COLS if mode == "serve" else SPLIT_K_COLS
    scratch = _scratch(a, 2 * w.numel() + 4 + part_cols * batch * t)
    kernels.TC_CONV_GEMM(
        a, w, a_mask, out, scratch, scratch.numel(), batch, t, c, c, taps, dilation,
        tap_sign, n, int(w_t), _MODES[mode],
    )
    return out


def conv_product_tiled(
    a: torch.Tensor, w: torch.Tensor, taps: int, tile_rows: int, splits: int
) -> torch.Tensor:
    """a [b, t, c], w [taps * c, n] -> im2col(a) @ w [b, t, n] on the tensor
    cores in ``tile_rows``-row tiles (128 or 64) and ``splits`` K shares,
    whatever the plans would take (``scripts/torch-serve-plan-sweep.py``).
    CPU tensors take the plain version."""
    if kernels.route(a) == "plain":
        return conv_product_plain(a, w, taps)
    batch, t, c = a.shape
    kernels.check_operands(a.device, a=a, w=w)
    n = w.shape[1]
    kernels.check_shape("w", w, (taps * c, n))
    out = a.new_empty((batch, t, n))
    scratch = _scratch(a, 2 * w.numel() + 4 + splits * n * batch * t)
    kernels.TC_CONV_GEMM_TILED(
        a, w, out, scratch, scratch.numel(), batch, t, c, taps, n, tile_rows, splits)
    return out


def weight_gradient(
    a: torch.Tensor,
    dy: torch.Tensor,
    taps: int = 1,
    dilation: int = 1,
    a_mask: typing.Optional[torch.Tensor] = None,
    dy_mask: typing.Optional[torch.Tensor] = None,
    mode: str = "auto",
) -> torch.Tensor:
    """a [b, t, c], dy [b, t, n] -> im2col(a)^T @ dy [taps * c, n], summed
    over all b * t rows in a fixed order (the same bits from run to run).
    CPU tensors take the plain version."""
    if kernels.route(a) == "plain":
        return weight_gradient_plain(a, dy, taps, dilation, a_mask, dy_mask)
    batch, t, c = a.shape
    n = dy.shape[-1]
    kernels.check_operands(a.device, a=a, dy=dy, a_mask=a_mask, dy_mask=dy_mask)
    kernels.check_shape("dy", dy, (batch, t, n))
    for name, m in (("a_mask", a_mask), ("dy_mask", dy_mask)):
        if m is not None:
            kernels.check_shape(name, m, (batch, t, 1))
    out = a.new_empty((taps * c, n))
    scratch = _scratch(a, taps * c * n)
    kernels.TC_WGRAD(
        a, dy, a_mask, dy_mask, out, scratch, scratch.numel(), batch, t, c, c, taps,
        dilation, n, n, _MODES[mode],
    )
    return out


def split_weights(w: torch.Tensor) -> torch.Tensor:
    """w [K, N] -> [2, N, K] by the kernel that runs before each
    tensor-core conv-GEMM; CPU tensors take :func:`split_weights_plain`."""
    if kernels.route(w) == "plain":
        return split_weights_plain(w)
    kernels.check_operands(w.device, w=w)
    kdim, n = w.shape
    out = w.new_empty((2, n, kdim))
    kernels.SPLIT_WEIGHTS(w, out[0], out[1], kdim, n)
    return out
