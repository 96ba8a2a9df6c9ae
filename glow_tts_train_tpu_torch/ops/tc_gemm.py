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
tiles, a lone sentence's K walk in finer shares), "walk" as the WN reverse
walk dispatches its transposed conv (the tap-staged kernel where
:func:`walk_transposed_plan` takes it), "tc" the tensor-core kernel over
the whole K walk, tap by tap, or an error, "core" the CUDA-core kernel.
:func:`weight_gradient` also gives the bias row (the column sums of dY,
the weight gradient of a column of ones) and reads dY's K-major split, as
the walk's dW_in does.  :func:`walk_products` is the plan of the WN
reverse walk and of the flow block's backward around it: every product,
the unit and mode it takes, its tiles and splits, and the device
operations of a call.

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

_MODES = {"auto": 0, "tc": 1, "core": 2, "text": 3, "serve": 4, "walk": 5}
# split-K's limits (csrc/common.cuh kSplitKCols, csrc/tc_gemm.cu): partial
# sums a row over all shares, shares, 32-deep slices a share, rows
SPLIT_K_COLS, SPLIT_K_MAX, SPLIT_K_MIN_SLICES, SPLIT_K_MIN_ROWS = 1536, 4, 4, 512
# the serving chain's for a lone sentence, below LONE_SENTENCE_ROWS rows
# (kLoneSplits, kLoneSplitKCols, kLoneSentenceRows)
LONE_SPLIT_K_COLS, LONE_SPLIT_K_MAX, LONE_SPLIT_K_MIN_SLICES = 3072, 8, 2
LONE_SENTENCE_ROWS = 1024
# kernels.product_counts of the WN reverse walk's modes, for the chains
# that ask for none of them
WALK_MODES_NONE = {"tap_staged_gemm": 0, "bias_wgrad": 0, "split_dy_wgrad": 0}
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


# the tap-staged conv-GEMM (csrc/tc_gemm.cu kTapStages, kTapTileRows,
# kMaxBlockSmem, kAStride): B ring stages, tile rows, a block's shared
# memory, floats a staged row
TAP_STAGES, TAP_TILE_ROWS, MAX_BLOCK_SMEM, A_STRIDE = 4, 64, 232448, 36
# the weight-gradient kernels' output tile rows (im2col columns) and rows a
# slice; the split-dY kernel's stages and raw A row (kGK, kGM,
# kGSplitStages, kGAStride); the conv-GEMM's stages at 128 and 64 columns
WGRAD_TILE, WGRAD_SLICE, WGRAD_SPLIT_STAGES, WGRAD_A_STRIDE = 128, 32, 4, 136
# the weight-gradient partial sums of a backward call (block_train.cu
# bwd_scratch): at least 1 << 22 floats
WALK_WG_FLOATS = 1 << 22


def _bn(n: int) -> int:
    return 128 if n % 128 == 0 else 64


def tap_staged_smem(bn: int, tile_rows: int, taps: int, dilation: int) -> int:
    """Shared memory of the tap-staged conv-GEMM (``conv_gemm_tap_smem``):
    the B ring and two A stages of the tile's rows and their halo."""
    return (TAP_STAGES * 2 * bn * 128 + 2 * (tile_rows + (taps - 1) * dilation) * A_STRIDE * 4
            + 1024)


def wgrad_split_smem(bn: int) -> int:
    """Shared memory of the weight gradient that reads dY's K-major split
    (``wgrad_split_smem``)."""
    return WGRAD_SPLIT_STAGES * (2 * bn * 128 + WGRAD_SLICE * WGRAD_A_STRIDE * 4) + 1024


def gate_stash_smem(bn: int, tile_rows: int = 128) -> int:
    """Shared memory the gate backward's epilogue uses when it also writes
    d_xin K-major (``tile_epilogue``): the accumulator tile and the staging
    of d_xin's two halves, and the room to align."""
    return 4 * (tile_rows * (bn + 8) + 2 * bn * tile_rows) + 1024


def conv_gemm_tc_smem(bn: int, tile_rows: int = 128) -> int:
    """Shared memory of the conv-GEMM (``conv_gemm_tc_smem``)."""
    return (4 if bn == 128 else 3) * (2 * bn * 128 + tile_rows * A_STRIDE * 4) + 1024


def flow_product_on_tc(rows: int, kdim: int, n: int, sms: int) -> bool:
    """Whether a flow chain's conv-GEMM (no split-K) of operands the kernel
    can read takes the tensor cores: at least 64 columns, 32 deep, and
    128-row tiles for a quarter of the SMs (``conv_gemm_tc_plan``)."""
    return n >= 64 and kdim >= 32 and 4 * -(-rows // 128) * -(-n // _bn(n)) >= sms


def walk_transposed_plan(
    rows: int, c_in: int, n: int, taps: int, dilation: int, sms: int
) -> typing.Dict[str, typing.Any]:
    """The WN reverse walk's transposed conv [rows, taps * c_in, n]
    (``conv_gemm_tc_plan`` with ``ConvGemm::tap_staged``) -> {"mode":
    "tap_staged", "tap_by_tap" or "core", "tile_rows", "bn", "smem"}: the
    tap-staged kernel in 64-row tiles where the channels come in 32-wide
    slices, the taps keep its A ring (taps >= TAP_STAGES - 2), the halo is
    shorter than the tile, its stages fit a block and its blocks fill a
    quarter of the SMs; else the flow chains' tap-by-tap walk, or the CUDA
    cores where that declines."""
    bn = _bn(n)
    smem = tap_staged_smem(bn, TAP_TILE_ROWS, taps, dilation)
    if (c_in % 32 == 0 and 1 < taps and taps >= TAP_STAGES - 2
            and (taps - 1) * dilation < TAP_TILE_ROWS and smem <= MAX_BLOCK_SMEM
            and 4 * -(-rows // TAP_TILE_ROWS) * -(-n // bn) >= sms):
        return {"mode": "tap_staged", "tile_rows": TAP_TILE_ROWS, "bn": bn, "smem": smem}
    if flow_product_on_tc(rows, taps * c_in, n, sms):
        return {"mode": "tap_by_tap", "tile_rows": 128, "bn": bn, "smem": conv_gemm_tc_smem(bn)}
    return {"mode": "core", "tile_rows": 0, "bn": 0, "smem": 0}


def wgrad_plan(
    rows: int, kdim: int, n: int, sms: int, bias: bool = False, on_tc: bool = True,
    scratch_floats: int = WALK_WG_FLOATS,
) -> typing.Tuple[int, int]:
    """(row splits, device launches) of a weight gradient over ``rows`` rows
    of ``kdim`` im2col columns and ``n`` dY columns (``wgrad_tc`` /
    ``wgrad``): on the tensor cores one wave of one block an SM, at least
    256 rows a split, within the scratch, with the bias row one more output
    row; on the CUDA cores about four waves of 64 x 64 tiles, at least 64
    rows a split, and the bias row one column-sum launch.  Partial sums of
    more than one split take a second pass."""
    if on_tc:
        kout = kdim + int(bias)
        tiles = -(-n // _bn(n)) * -(-kout // WGRAD_TILE)
        per_split = kout * n
        splits = max(1, sms // tiles)
        splits = min(splits, max(1, rows // 256))
    else:
        tiles = -(-n // 64) * -(-kdim // 64)
        per_split = kdim * n
        splits = -(-4 * sms // tiles)
        splits = min(splits, max(1, -(-rows // 64)))
    splits = min(splits, max(1, scratch_floats // per_split))
    per = -(-rows // splits)
    per = -(-per // 32) * 32
    splits = max(1, -(-rows // per))
    launches = 1 + int(splits > 1) + int(bias and not on_tc)
    return splits, launches


def wgrad_on_tc(rows: int, kdim: int, n: int) -> bool:
    """Whether a chain's weight gradient (operands the kernel can read)
    takes the tensor cores (``wgrad_tc_fits``)."""
    return n >= 32 and kdim >= 32 and rows >= 256


def walk_products(
    rows: int, c: int, h: int, n_layers: int, taps: int, dilation_rate: int, sms: int,
    recompute: bool = False, with_g: bool = False,
) -> typing.Dict[str, typing.Any]:
    """The plan of one backward call over ``rows`` rows (csrc/block_train.cu):
    the WN stack's alone (``c`` 0: ``gtt_wn_bwd_store``, with ``recompute``
    ``gtt_wn_bwd``) or the flow block's (``c`` channels:
    ``gtt_block_bwd_store``, ``gtt_block_bwd``).  -> {"products": per
    product its name, kind ("conv_gemm"/"wgrad"), shape ([rows, K, N]; a
    weight gradient's [K, rows, N]), unit ("tc"/"core"), mode, tile rows,
    row splits, bias row, launches; "splits": the weight matrices split in
    the call's one presplit launch; "launches": the device operations of a
    call (kernels, fills and copies); "counts": ``kernels.product_counts``
    of a call}.  Operands are taken to be what the kernels can read (h and
    c multiples of 4).  dW_in reads d_xin's K-major split where the gate
    backward that writes it and dW_in both take the tensor cores."""
    h2, c2 = 2 * h, c // 2
    products: typing.List[dict] = []

    def conv(name, kdim, n, mode=None, ask=True):
        on = ask and flow_product_on_tc(rows, kdim, n, sms)
        p = {"name": name, "kind": "conv_gemm", "shape": [rows, kdim, n],
             "unit": "tc" if on else "core", "mode": mode or ("whole K" if on else "core"),
             "tile_rows": 128 if on else 0, "splits": 1, "bias": False, "launches": 1,
             "asks": ask}
        products.append(p)
        return p

    def wgrad(name, kdim, n, bias=True, split=False):
        on = wgrad_on_tc(rows, kdim, n)
        splits, launches = wgrad_plan(rows, kdim, n, sms, bias, on)
        products.append({"name": name, "kind": "wgrad", "shape": [kdim, rows, n],
                         "unit": "tc" if on else "core",
                         "mode": ("split dY" if split else "whole K") if on else "core",
                         "tile_rows": WGRAD_TILE if on else 0, "splits": splits, "bias": bias,
                         "launches": launches, "asks": True})

    fixed = 3 if c == 0 else 2  # the walk's fills (and the WN stack's dout copy)
    if recompute:  # the forward-save chain first
        fixed += 1 if c == 0 else 0  # x -> xs
        if c:
            conv("fwd zp", c, c, ask=False)
            conv("fwd start", c2, h)
        for l in range(n_layers):
            conv(f"fwd in_{l}", taps * h, h2)
            conv(f"fwd res_skip_{l}", h, h2)
    if c:
        conv("coupling", h, c2)
        wgrad("dW_e", h, c)
        conv("dskip", c, h)
    for l in reversed(range(n_layers)):
        gate = conv(f"gate_{l}", h2, h)
        wgrad(f"dW_rs_{l}", h, h2)
        # the gate backward also writes d_xin K-major where it and dW_in
        # both take the tensor cores
        split = gate["unit"] == "tc" and wgrad_on_tc(rows, taps * h, h2)
        if split:
            gate["mode"] = "whole K, d_xin K-major"
        wgrad(f"dW_in_{l}", taps * h, h2, split=split)
        t = walk_transposed_plan(rows, h2, h, taps, dilation_rate ** l, sms)
        conv(f"transposed_{l}", taps * h2, h, mode=t["mode"].replace("_", " "))
        products[-1].update(unit="core" if t["mode"] == "core" else "tc",
                            tile_rows=t["tile_rows"])
    if c:
        wgrad("dW_s", c2, h)
        conv("dzp", h, c2)
        wgrad("dA", c, c)
        conv("dx", c, c)
    convs = [p for p in products if p["kind"] == "conv_gemm"]
    split = sum(p["unit"] == "tc" for p in convs)
    presplit = -(-split // 24)  # kMaxSplits matrices a launch
    dg = n_layers if with_g else 0
    counts = {
        "tc_gemm": sum(p["unit"] == "tc" for p in convs),
        "tc_wgrad": sum(p["unit"] == "tc" for p in products if p["kind"] == "wgrad"),
        "core_gemm": sum(p["unit"] == "core" for p in convs),
        "core_wgrad": sum(p["unit"] == "core" for p in products if p["kind"] == "wgrad"),
        "declined_gemm": sum(p["unit"] == "core" and p["asks"] for p in convs),
        "declined_wgrad": sum(p["unit"] == "core" for p in products if p["kind"] == "wgrad"),
        "tap_staged_gemm": sum(p["mode"] == "tap staged" for p in convs),
        "bias_wgrad": sum(p["unit"] == "tc" and p["bias"] for p in products
                          if p["kind"] == "wgrad"),
        "split_dy_wgrad": sum(p["mode"] == "split dY" for p in products),
    }
    return {"products": products, "splits": split,
            "launches": presplit + fixed + dg + sum(p["launches"] for p in products),
            "counts": counts}


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
                  declined_gemm=0, declined_wgrad=0, **WALK_MODES_NONE)
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


def weight_gradient_plain(a, dy, taps=1, dilation=1, a_mask=None, dy_mask=None, bias=False):
    """Plain version of :func:`weight_gradient`."""
    cols = im2col_plain(a, taps, dilation, 1, a_mask)
    if dy_mask is not None:
        dy = dy * dy_mask
    dy = dy.reshape(-1, dy.shape[-1])
    out = cols.reshape(-1, cols.shape[-1]).T @ dy
    return (out, dy.sum(0)) if bias else out


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


def conv_product_walk(
    a: torch.Tensor, w: torch.Tensor, taps: int, dilation: int, tile_rows: int, tap_staged: bool
) -> torch.Tensor:
    """The transposed conv of the WN reverse walk, sum_k a[t - off_k] W_k^T
    of a forward conv's w [taps * n, c] -> [b, t, n], on the tensor cores in
    ``tile_rows``-row tiles (128 or 64), tap-staged or tap by tap, whatever
    :func:`walk_transposed_plan` would take (``scripts/torch-wn-walk-sweep.py``).
    CPU tensors take the plain version."""
    if kernels.route(a) == "plain":
        return conv_product_plain(a, w, taps, dilation, -1, w_t=True)
    batch, t, c = a.shape
    kernels.check_operands(a.device, a=a, w=w)
    n = w.shape[0] // taps
    kernels.check_shape("w", w, (taps * n, c))
    out = a.new_empty((batch, t, n))
    scratch = _scratch(a, 2 * w.numel() + 4)
    kernels.TC_CONV_GEMM_WALK(
        a, w, out, scratch, scratch.numel(), batch, t, c, taps, dilation, n, tile_rows,
        int(tap_staged))
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
    bias: bool = False,
    dy_split: typing.Optional[torch.Tensor] = None,
):
    """a [b, t, c], dy [b, t, n] -> im2col(a)^T @ dy [taps * c, n], summed
    over all b * t rows in a fixed order (the same bits from run to run);
    with ``bias`` -> (that, the column sums of dy times dy_mask [n]: on the
    tensor cores the bias row of the same product).  ``dy_split``: dy's
    K-major split [2, n, ldt] (:func:`split_weights` of dy as [b * t, n],
    zero rows after it up to ldt, a multiple of 4), which the tensor-core
    kernel reads in place of dy.  CPU tensors take the plain version."""
    if kernels.route(a) == "plain":
        return weight_gradient_plain(a, dy, taps, dilation, a_mask, dy_mask, bias)
    batch, t, c = a.shape
    n = dy.shape[-1]
    kernels.check_operands(a.device, a=a, dy=dy, a_mask=a_mask, dy_mask=dy_mask,
                           dy_split=dy_split)
    kernels.check_shape("dy", dy, (batch, t, n))
    for name, m in (("a_mask", a_mask), ("dy_mask", dy_mask)):
        if m is not None:
            kernels.check_shape(name, m, (batch, t, 1))
    ldt = batch * t
    if dy_split is not None:
        ldt = dy_split.shape[-1]
        if ldt < batch * t:
            raise ValueError(f"dy_split: {ldt} rows for {batch * t}")
        kernels.check_shape("dy_split", dy_split, (2, n, ldt))
    out = a.new_empty((taps * c, n))
    db = a.new_empty((n,)) if bias else None
    scratch = _scratch(a, (taps * c + 1) * n)
    kernels.TC_WGRAD(
        a, dy, a_mask, dy_mask, out, db, dy_split, scratch, scratch.numel(), batch, t, c, c,
        taps, dilation, n, n, ldt, _MODES[mode],
    )
    return (out, db) if bias else out


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
