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
:func:`walk_transposed_plan` takes it), "fwd" as the WN forward chains
dispatch their products (the TMA-fed kernel where :func:`forward_conv_plan`
takes it), "tc" the tensor-core kernel over the whole K walk, tap by tap,
or an error, "core" the CUDA-core kernel.
:func:`weight_gradient` also gives the bias row (the column sums of dY,
the weight gradient of a column of ones) and reads dY's K-major split, as
the walk's dW_in does.  :func:`walk_products` is the plan of the WN
reverse walk and of the flow block's backward around it, and
:func:`forward_products` of the WN stack's and the flow block's forward
calls: every product, the unit and mode it takes, its tiles and splits,
and the device operations of a call.

The layout helpers are the plain versions of what the kernels do to the
weights: :func:`split_weights_plain` the K-major 3xTF32 split that
``split_weights_kernel`` writes before a chain's tensor-core conv-GEMMs
(or once at load, for the serving flow block), in tile order for the
TMA-fed kernel's paired epilogue, :func:`physical_cols` the row order in
which a paired epilogue's tile reads it.
"""

import typing

import torch

from .. import kernels
from .conv import _shifted, offsets

_MODES = {"auto": 0, "tc": 1, "core": 2, "text": 3, "serve": 4, "walk": 5, "fwd": 6}
# split-K's limits (csrc/common.cuh kSplitKCols, csrc/tc_gemm.cu): partial
# sums a row over all shares, shares, 32-deep slices a share, rows
SPLIT_K_COLS, SPLIT_K_MAX, SPLIT_K_MIN_SLICES, SPLIT_K_MIN_ROWS = 1536, 4, 4, 512
# the serving chain's for a lone sentence, below LONE_SENTENCE_ROWS rows
# (kLoneSplits, kLoneSplitKCols, kLoneSentenceRows)
LONE_SPLIT_K_COLS, LONE_SPLIT_K_MAX, LONE_SPLIT_K_MIN_SLICES = 3072, 8, 2
LONE_SENTENCE_ROWS = 1024
# kernels.product_counts of the flow chains' modes (the WN reverse walk's
# and the WN forward's TMA-fed conv), for the chains that ask for none of them
WALK_MODES_NONE = {"tap_staged_gemm": 0, "bias_wgrad": 0, "split_dy_wgrad": 0, "tma_gemm": 0}
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


# the TMA-fed conv-GEMM (csrc/tc_gemm.cu kTmaTileRows, kTmaCluster,
# kTmaOneTap, tma_stages): tile rows, row tiles a cluster, whether the 1x1
# res/skip product takes it, B stages in 128- and 64-row tiles
TMA_TILE_ROWS, TMA_CLUSTER, TMA_ONE_TAP = 64, 1, True
TMA_STAGES = {128: 4, 64: 2}


def tma_smem(tile_rows: int, taps: int, dilation: int) -> int:
    """Shared memory of the TMA-fed conv-GEMM (``conv_gemm_tma_smem``): the
    B ring of 32 KB stages, two A stages of the tile's rows and their halo
    (128 bytes a row, each stage 1024-byte aligned), the barriers and the
    room to align."""
    a_stage = -(-(tile_rows + (taps - 1) * dilation) * 128 // 1024) * 1024
    return TMA_STAGES[tile_rows] * 2 * 128 * 128 + 2 * a_stage + 128 + 1024


def forward_conv_plan(
    rows: int, c_in: int, n: int, taps: int, dilation: int, sms: int
) -> typing.Dict[str, typing.Any]:
    """A product of the WN forward chains [rows, taps * c_in, n]
    (``conv_gemm_tc_plan`` with ``ConvGemm::tma_ring``) -> {"mode": "tma",
    "tap_by_tap" or "core", "tile_rows", "cluster", "bn", "smem"}: the
    TMA-fed kernel in TMA_TILE_ROWS-row tiles and clusters of TMA_CLUSTER
    where it has taps (or TMA_ONE_TAP), 32-channel slices, 128-column tiles,
    a halo shorter than the tile, its stages within a block and blocks for
    a quarter of the SMs; else the tap-by-tap walk, or the CUDA cores where
    that declines."""
    smem = tma_smem(TMA_TILE_ROWS, taps, dilation)
    if ((taps > 1 or TMA_ONE_TAP) and c_in % 32 == 0 and n % 128 == 0
            and (taps - 1) * dilation < TMA_TILE_ROWS and smem <= MAX_BLOCK_SMEM
            and 4 * -(-rows // TMA_TILE_ROWS) * (n // 128) >= sms):
        return {"mode": "tma", "tile_rows": TMA_TILE_ROWS, "cluster": TMA_CLUSTER, "bn": 128,
                "smem": smem}
    if flow_product_on_tc(rows, taps * c_in, n, sms):
        return {"mode": "tap_by_tap", "tile_rows": 128, "cluster": 1, "bn": _bn(n),
                "smem": conv_gemm_tc_smem(_bn(n))}
    return {"mode": "core", "tile_rows": 0, "cluster": 0, "bn": 0, "smem": 0}


def _forward_convs(
    rows: int, c: int, h: int, n_layers: int, taps: int, dilation_rate: int, sms: int,
    coupling: bool,
) -> typing.List[dict]:
    """The conv-GEMMs of a forward chain in launch order: the flow block's
    zp (on the CUDA cores by design) and start product, per WN layer the
    in-layer conv and the res/skip, and the block's coupling product."""
    products = []

    def conv(name, c_in, n, taps_=1, dilation=1, ask=True, wn=False):
        # only the WN layers' products ask for the TMA-fed kernel
        if wn:
            plan = forward_conv_plan(rows, c_in, n, taps_, dilation, sms)
        elif ask and flow_product_on_tc(rows, taps_ * c_in, n, sms):
            plan = {"mode": "tap_by_tap", "tile_rows": 128, "cluster": 1}
        else:
            plan = {"mode": "core", "tile_rows": 0, "cluster": 0}
        on = plan["mode"] != "core"
        products.append({
            "name": name, "kind": "conv_gemm", "shape": [rows, taps_ * c_in, n],
            "unit": "tc" if on else "core",
            "mode": {"tma": "TMA ring", "tap_by_tap": "whole K", "core": "core"}[plan["mode"]],
            "tile_rows": plan["tile_rows"], "cluster": plan["cluster"], "splits": 1,
            "bias": False, "launches": 1, "asks": ask})

    if c:
        conv("zp", c, c, ask=False)
        conv("start", c // 2, h)
    for l in range(n_layers):
        conv(f"in_{l}", h, 2 * h, taps, dilation_rate ** l, wn=True)
        conv(f"res_skip_{l}", h, 2 * h, wn=True)
    if c and coupling:
        conv("coupling", h, c)
    return products


def product_counts_of(products: typing.List[dict]) -> typing.Dict[str, int]:
    """``kernels.product_counts`` of a call that launches ``products``."""
    convs = [p for p in products if p["kind"] == "conv_gemm"]
    wgrads = [p for p in products if p["kind"] == "wgrad"]
    return {
        "tc_gemm": sum(p["unit"] == "tc" for p in convs),
        "tc_wgrad": sum(p["unit"] == "tc" for p in wgrads),
        "core_gemm": sum(p["unit"] == "core" for p in convs),
        "core_wgrad": sum(p["unit"] == "core" for p in wgrads),
        "declined_gemm": sum(p["unit"] == "core" and p["asks"] for p in convs),
        "declined_wgrad": sum(p["unit"] == "core" for p in wgrads),
        "tap_staged_gemm": sum(p["mode"] == "tap staged" for p in convs),
        "bias_wgrad": sum(p["unit"] == "tc" and p["bias"] for p in wgrads),
        "split_dy_wgrad": sum(p["mode"] == "split dY" for p in wgrads),
        "tma_gemm": sum(p["mode"] == "TMA ring" for p in convs),
    }


def forward_products(
    rows: int, c: int, h: int, n_layers: int, taps: int, dilation_rate: int, sms: int,
    save: bool = False,
) -> typing.Dict[str, typing.Any]:
    """The plan of one forward call over ``rows`` rows (csrc/block_train.cu):
    the WN stack's (``c`` 0: ``gtt_wn_forward``, with ``save``
    ``gtt_wn_fwd_save``, rows 5 and 6 of PERF.md's table) or the flow
    block's (``c`` channels: ``gtt_block_fwd``, ``gtt_block_fwd_save``, rows
    9 and 10).  -> {"products": per conv-GEMM its name, shape [rows, K, N],
    unit ("tc"/"core"), mode ("TMA ring", "whole K" tap by tap, "core"),
    tile rows and cluster; "splits": the weight matrices split in the call's
    one presplit launch, its first operation; "launches": the device
    operations of a call (the split, the WN stack's input copy, the
    products, the block's ld sums and, saving, its z copy); "counts":
    ``kernels.product_counts`` of a call}.  Operands are taken to be what
    the kernels can read (h and c multiples of 4)."""
    products = _forward_convs(rows, c, h, n_layers, taps, dilation_rate, sms, coupling=True)
    split = sum(p["unit"] == "tc" for p in products)
    fixed = 1 if c == 0 else 2 + int(save)  # x -> state; or ld's two sums and z <- zp
    return {"products": products, "splits": split,
            "launches": -(-split // 24) + fixed + len(products),
            "counts": product_counts_of(products)}


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
    if recompute:  # the forward-save chain first, as forward_products plans it
        fixed += 1 if c == 0 else 0  # x -> xs
        for p in _forward_convs(rows, c, h, n_layers, taps, dilation_rate, sms, coupling=False):
            products.append(dict(p, name="fwd " + p["name"]))
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
    return {"products": products, "splits": split,
            "launches": presplit + fixed + dg + sum(p["launches"] for p in products),
            "counts": product_counts_of(products)}


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


# the TMA-fed wgmma bf16 products (csrc/bf16_gemm.cu): a stage's 64 x 64
# chunks of 128-byte rows; the conv-GEMM's tile rows (one consumer
# warpgroup, two blocks an SM), the weight gradient's im2col columns (two
# consumer warpgroups) and row slice
BF16_CHUNK_BYTES, BF16_CONV_TILE, BF16_WGRAD_TILE, BF16_SLICE = 64 * 128, 64, 128, 64


def bf16_ring(kind: str, chunks: int) -> typing.Tuple[int, int]:
    """(stages, shared memory) of a TMA-fed bf16 kernel whose B tile is
    ``chunks`` 64-column chunks (``ConvRing``, ``WgradRing``): a
    conv-GEMM's stage holds A's one chunk and B's, 96 KB of stages (two
    blocks an SM); a weight gradient's A's two chunks and B's, 4 stages;
    then the stages' full and empty barriers and the room to align."""
    a, stages = (1, 12 // (1 + chunks)) if kind == "conv_gemm" else (2, 4)
    return stages, stages * (a + chunks) * BF16_CHUNK_BYTES + 2 * stages * 8 + 1024


def bf16_conv_chunks(c_in: int, n: int, lda: int, ldb: int, w_t: bool, paired: bool,
                     b_offset: int = 0) -> int:
    """``tma_conv_chunks`` of a bf16 chain's conv-GEMM that asks for the
    TMA-fed kernel: 64-column chunks a tile (a paired epilogue's one of each
    half, else up to 3), or 0 where the mma.sync kernel takes it: fewer
    than 64 channels or columns, rows (c_in, lda, ldb) not whole 16-byte
    groups, or B starting ``b_offset`` elements into its tensor off a
    16-byte boundary."""
    if (c_in < 64 or n < 64 or c_in % 8 or lda % 8 or (not w_t and ldb % 8)
            or b_offset % 8 or (paired and w_t)):
        return 0
    return 2 if paired else min(3, -(-n // 64))


# the text chains' split-K on the TMA-fed conv-GEMM (csrc/bf16_gemm.cu
# kTmaMaxShares, kTmaMinSlices, kTmaSplitCols): shares, 64-deep slices a
# share at least, partial sums a row over all shares
TMA_MAX_SHARES, TMA_MIN_SLICES, TMA_SPLIT_COLS = 4, 2, 768
# the bf16 product units a bare product may take (bf16_conv_product): the
# mma.sync kernel, the 64-row TMA-fed one, the text chains' plan on it; and
# the codes of the units a WN forward product may take (bf16_wn_product):
# those two kernels and the warp-specialised one
BF16_UNITS = ("mma", "tma", "text")
_BF16_UNIT_CODE = {"mma": 0, "tma": 1, "ws": 2}

# the warp-specialised unit (csrc/bf16_gemm.cu WsLayout): a block's shared
# memory, at most 8 ring stages
WS_SMEM_MAX, WS_MAX_STAGES = 232448, 8


def bf16_ws_layout(chunks: int, rows: int, bufs: int) -> typing.Dict[str, int]:
    """``WsLayout`` of the warp-specialised bf16 conv-GEMM whose units are
    ``rows`` 64-row tiles by ``chunks`` 64-column chunks with ``bufs``
    accumulator buffers: a stage (the rows' A boxes and B's chunks), an
    accumulator buffer (f32 rows of 64 chunks + 8), the ring's stages (as
    many as fit, at most 8), the block's shared memory and threads."""
    stage = (rows + chunks) * BF16_CHUNK_BYTES
    buf = 64 * rows * (64 * chunks + 8) * 4
    fixed = bufs * buf + 8 * (2 * WS_MAX_STAGES + 2 * bufs) + 1024
    stages = min(WS_MAX_STAGES, (WS_SMEM_MAX - fixed) // stage)
    return {"stage_bytes": stage, "buf_bytes": buf, "stages": stages,
            "smem": stages * stage + bufs * buf + 8 * (2 * stages + 2 * bufs) + 1024,
            "threads": 128 * rows + 256 + 128}


def bf16_ws_plan(batch: int, t: int, c_in: int, n: int, sms: int, gate: bool,
                 last: bool = False, taps: int = 1) -> typing.Dict[str, typing.Any]:
    """``ws_plan`` and the launch of a bf16 flow chain's WN forward product
    on the warp-specialised unit (csrc/bf16_gemm.cu): the in-layer conv
    (``gate``: the paired epilogue over ``n`` = 2h columns) or res/skip
    (``last``: only the skip half, from column n / 2) -> {"chunks" (0: the
    64-row unit's shape rules refuse it, :func:`bf16_conv_chunks`), "rows"
    (64-row tiles a unit: two for the gate, B read once for both),
    "bufs" (accumulator buffers), "col0", "n" (the columns computed),
    "col_tiles", "units", "blocks" (one an SM at most, a whole number of
    column tiles' blocks), the layout's "stages" and "smem", and "steps"
    (K steps a unit)}."""
    chunks = bf16_conv_chunks(c_in, n, c_in, n, False, gate)
    plan: typing.Dict[str, typing.Any] = {"chunks": chunks}
    if not chunks:
        return plan
    rows, bufs = (2, 1) if gate else (1, 2)
    col0 = n // 2 if last and not gate else 0
    col_tiles = -(-(n // 2) // 64) if gate else -(-(n - col0) // (64 * chunks))
    row_tiles = batch * -(-t // BF16_CONV_TILE)
    units = -(-row_tiles // rows) * col_tiles
    layout = bf16_ws_layout(chunks, rows, bufs)
    plan.update(rows=rows, bufs=bufs, col0=col0, n=n - col0, col_tiles=col_tiles, units=units,
                blocks=min(units, max(1, sms // col_tiles) * col_tiles),
                stages=layout["stages"], smem=layout["smem"],
                threads=layout["threads"], steps=taps * -(-c_in // 64))
    return plan


def bf16_ws_order(batch: int, t: int, plan: typing.Dict[str, typing.Any]) -> typing.List[list]:
    """The warp-specialised unit's static order: per block (``plan``'s
    "blocks"), its units in order (unit ``b``, then every blocks-th), each
    as its row tiles [(sample, first row)] and its column tile (the
    kernels' loops over ``blockIdx.x + i * gridDim.x``; ``ws_col_tile``:
    the column tile turned by the unit's round)."""
    tiles_t = -(-t // BF16_CONV_TILE)
    row_tiles, rows, col_tiles = batch * tiles_t, plan["rows"], plan["col_tiles"]
    order = []
    for blk in range(plan["blocks"]):
        units = []
        for u in range(blk, plan["units"], plan["blocks"]):
            ru, ct = u // col_tiles, (u % col_tiles + u // plan["blocks"]) % col_tiles
            tiles = [(rt // tiles_t, (rt % tiles_t) * BF16_CONV_TILE)
                     for rt in range(ru * rows, min(row_tiles, (ru + 1) * rows))]
            units.append((tiles, ct))
        order.append(units)
    return order


def bf16_text_conv_plan(batch: int, t: int, c_in: int, taps: int, n: int, sms: int,
                        lda: int = 0, ldb: int = 0, w_t: bool = False) -> typing.Tuple[int, int]:
    """``tma_conv_plan`` of a text chain's bf16 conv-GEMM (split-K scratch
    given) over ``batch`` samples of ``t`` rows -> (chunks a tile, 0 where
    the mma.sync kernel takes it; split-K shares): among 1 to
    :func:`bf16_conv_chunks`' chunks and 1 to TMA_MAX_SHARES shares (each
    at least TMA_MIN_SLICES 64-deep slices, shares * n within
    TMA_SPLIT_COLS), the pair whose waves of blocks (two an SM, a sample's
    64-row tiles ending at its last row) times slices a block is least;
    ties to the fewest columns past ``n`` in the last column tile (a tile's
    wgmma runs its whole width), then more chunks, then fewer shares."""
    most = bf16_conv_chunks(c_in, n, lda or c_in, ldb or n, w_t, False)
    if not most:
        return 0, 1
    row_tiles = batch * -(-t // BF16_CONV_TILE)
    steps = taps * -(-c_in // 64)
    slots = 2 * sms
    best, plan = None, (most, 1)
    for chunks in range(most, 0, -1):
        col_tiles = -(-n // (64 * chunks))
        tiles = row_tiles * col_tiles
        pad = col_tiles * 64 * chunks - n
        for shares in range(1, TMA_MAX_SHARES + 1):
            per = -(-steps // shares)
            if shares > 1 and (per < TMA_MIN_SLICES or shares * n > TMA_SPLIT_COLS):
                break
            if -(-steps // per) != shares:
                continue
            cost = (-(-(tiles * shares) // slots) * per, pad)
            if best is None or cost < best:
                best, plan = cost, (chunks, shares)
    return plan


def bf16_wgrad_plan(batch: int, t: int, c_in: int, taps: int, n: int, lda: int, sms: int,
                    scratch_floats: int = WALK_WG_FLOATS) -> typing.Tuple[int, int]:
    """``tma_wgrad_plan`` of a bf16 chain's weight gradient that asks for
    the TMA-fed kernel over ``batch`` samples of ``t`` rows -> (chunks
    a tile, 0 where the mma.sync kernel takes it; row splits): at least 64
    im2col columns and 64 dY columns, whole 16-byte groups, channels in
    whole 64-wide boxes where there are taps; the row slices (64 rows of
    one sample) split for one wave of one block an SM at most, within the
    scratch."""
    kdim = taps * c_in
    if (kdim < 64 or n < 64 or c_in % 8 or lda % 8 or n % 8 or (taps > 1 and c_in % 64)):
        return 0, 1
    chunks = min(3, -(-n // 64))
    tiles = -(-n // (64 * chunks)) * -(-kdim // BF16_WGRAD_TILE)
    slices = batch * -(-t // BF16_SLICE)
    splits = min(max(1, sms // tiles), slices)
    splits = min(splits, max(1, scratch_floats // (kdim * n)))
    return chunks, splits


def bf16_block_products(
    batch: int, t: int, c: int, h: int, n_layers: int, taps: int, dilation_rate: int, sms: int,
    backward: bool = False, with_g: bool = False, recompute: bool = False, saves: bool = True,
) -> typing.Dict[str, typing.Any]:
    """The plan of one call of a bf16 chain of the flow block (``c``
    channels) or of the WN stack alone (``c`` 0) over ``batch`` samples of
    ``t`` rows (csrc/block_train.cu, csrc/bf16_gemm.cu): the plain version
    of its products' dispatch.  A forward (``backward`` False) with
    ``saves`` is the forward-save call (``gtt_block_fwd_save_bf16``, bf16
    row 10; ``gtt_wn_fwd_save_bf16``, row 6), without it the forward that
    saves nothing (``gtt_block_fwd_bf16``, row 9; ``gtt_wn_forward_bf16``,
    row 5): the same products.  A backward from saves
    (``gtt_block_bwd_store_bf16``, row 12; ``gtt_wn_bwd_store_bf16``, row
    8) or, ``recompute``, recomputing the forward (``gtt_block_bwd_bf16``,
    row 11; ``gtt_wn_bwd_bf16``, row 7): the forward-save chain's products
    (the block's up to skipm, no coupling) and then the store backward's,
    each weight gradient two launches (the product; one reduction of its
    row splits, its bias's tile sums and, for dW_in, the conditioning's,
    so ``with_g`` adds none).
    Every product asks for the TMA-fed kernels, the folded A (zp) too, as
    JAX rounds zp to bf16 right after it (the f32 chains keep it on the
    CUDA cores: :func:`forward_products`); the WN forward's in-layer conv
    and res/skip take the warp-specialised unit (:func:`bf16_ws_plan`; a
    last layer's res/skip only its skip half, N = h), the rest the 64-row
    one.
    -> {"products": per product its name, kind ("conv_gemm"/"wgrad"), shape
    ([rows, K, N]; a weight gradient's [K, rows, N]), unit ("tma": the
    64-row TMA-fed wgmma kernel, "ws": the warp-specialised one, "mma": the
    mma.sync kernel), chunks (64-column chunks a tile), tiles (blocks of a
    launch), stages, shared memory (a block's), row splits, launches and,
    a conv-GEMM, "column_pairs" (its epilogue's columns a thread in pairs
    64 apart); on "ws" also its row tiles a unit, accumulator buffers,
    first column and units; "launches": the device operations of a call;
    "counts": ``kernels.product_counts`` of a call}."""
    rows, c2, h2 = batch * t, c // 2, 2 * h
    products: typing.List[dict] = []

    def ws_conv(name, n, gate, last=False):
        """An in-layer conv (``gate``) or res/skip product on the
        warp-specialised unit where the 64-row unit's shape rules take it."""
        plan = bf16_ws_plan(batch, t, h, n, sms, gate, last, taps if gate else 1)
        if not plan["chunks"]:
            conv(name, h, n, h, paired=gate, k_taps=taps if gate else 1)
            return
        products.append({
            "name": name, "kind": "conv_gemm", "shape": [rows, (taps if gate else 1) * h,
                                                         plan["n"]],
            "unit": "ws", "chunks": plan["chunks"], "tiles": plan["blocks"],
            "rows": plan["rows"], "bufs": plan["bufs"], "col0": plan["col0"],
            "units": plan["units"], "stages": plan["stages"], "smem": plan["smem"],
            "splits": 1, "launches": 1, "column_pairs": False})

    def conv(name, c_in, n, lda, ldb=0, w_t=False, paired=False, k_taps=1, b_offset=0,
             pairs=False):
        chunks = bf16_conv_chunks(c_in, n, lda, ldb or n, w_t, paired, b_offset)
        n_tiles = (-(-(n // 2) // 64) if paired else -(-n // (64 * chunks))) if chunks else 0
        stages, smem = bf16_ring("conv_gemm", chunks) if chunks else (0, 0)
        products.append({
            "name": name, "kind": "conv_gemm", "shape": [rows, k_taps * c_in, n],
            "unit": "tma" if chunks else "mma", "chunks": chunks,
            "tiles": n_tiles * batch * -(-t // BF16_CONV_TILE), "stages": stages,
            "smem": smem, "splits": 1, "launches": 1,
            # the epilogue's columns: a thread's in pairs 64 apart (the
            # transposed conv's f32 gx, on three chunks a tile) or neighbouring
            "column_pairs": bool(pairs and chunks == 3)})

    def wgrad(name, c_in, n, lda, k_taps=1):
        chunks, splits = bf16_wgrad_plan(batch, t, c_in, k_taps, n, lda, sms)
        tiles = (-(-n // (64 * chunks)) * -(-(k_taps * c_in) // BF16_WGRAD_TILE) * splits
                 if chunks else 0)
        stages, smem = bf16_ring("wgrad", chunks) if chunks else (0, 0)
        products.append({
            "name": name, "kind": "wgrad", "shape": [k_taps * c_in, rows, n],
            "unit": "tma" if chunks else "mma", "chunks": chunks, "tiles": tiles,
            "stages": stages, "smem": smem, "splits": splits,
            # the product, then one reduction: its splits, its bias's tile
            # sums and (dW_in) dg's
            "launches": 2})

    def forward(coupling):
        if c:
            conv("zp", c, c, c)
            conv("start", c2, h, c)
        for l in range(n_layers):
            ws_conv(f"in_{l}", h2, True)
            ws_conv(f"res_skip_{l}", h2, False, last=l == n_layers - 1)
        if c and coupling:
            conv("coupling", h, c, h, paired=True)

    if not backward:
        forward(True)
        # the block: ld's two sums and, saving, z <- zp; the stack: x's copy
        fixed = 2 + int(saves) if c else 1
    else:
        fixed = 0
        if recompute:
            forward(False)
            fixed += 0 if c else 1  # the stack: x's copy into xs
        if c:
            conv("coupling", h, c2, h, ldb=c, b_offset=c2)
            wgrad("dW_e", h, c, h)
            conv("dskip", c, h, c, w_t=True)
        for l in reversed(range(n_layers)):
            conv(f"gate_{l}", h2, h, h2, w_t=True)
            wgrad(f"dW_rs_{l}", h, h2, h)
            wgrad(f"dW_in_{l}", h, h2, h, k_taps=taps)
            conv(f"transposed_{l}", h2, h, h2, w_t=True, k_taps=taps, pairs=True)
        if c:
            wgrad("dW_s", c2, h, c)
            conv("dzp", h, c2, h, w_t=True)
            wgrad("dA", c, c, c)
            conv("dx", c, c, c, w_t=True)
        # the block: g_rs's copy and gx zeroed; the stack: g_rs's copy and
        # its skip half's tile sums from dout in one launch, gx zeroed (dg
        # in dW_in's reduction)
        fixed += 2
    # core_gemm: a product on the CUDA cores (none: the folded A is on wgmma)
    counts = {"core_gemm": 0, "bf16_gemm": 0, "bf16_wgrad": 0, "bf16_tma_gemm": 0,
              "bf16_tma_wgrad": 0, "bf16_ws_gemm": 0}
    for p in products:
        unit = {"tma": "_tma", "ws": "_ws"}.get(p["unit"], "")
        counts[f"bf16{unit}_{'gemm' if p['kind'] == 'conv_gemm' else 'wgrad'}"] += 1
    return {"products": products, "launches": fixed + sum(p["launches"] for p in products),
            "counts": counts}


# rows of a bf16 flow chain's column-sum tiles (csrc/common.cuh
# kSumTileRows): a conv-GEMM tile of either bf16 unit, 64 rows of one sample
BF16_SUM_TILE = 64


def tile_sums_plain(values: torch.Tensor, batch: int, t: int) -> torch.Tensor:
    """The column sums a bf16 flow chain's cotangent epilogue keeps in
    place of the f32 cotangent (csrc/bf16_gemm.cu, ``ConvGemm::sums``):
    ``values`` [batch * t, n] -> [batch, ceil(t / 64), n] f32, tile i of
    sample b the sum of its rows 64 i .. min(t, 64 i + 64) - 1 (a tile
    never crosses a sample)."""
    n = values.shape[-1]
    tiles = -(-t // BF16_SUM_TILE)
    v = values.reshape(batch, t, n).float()
    # rows past t as zeros: a sum with them added is the sum without
    v = torch.nn.functional.pad(v, (0, 0, 0, tiles * BF16_SUM_TILE - t))
    return v.reshape(batch, tiles, BF16_SUM_TILE, n).sum(2)


def sums_of_tiles_plain(sums: torch.Tensor) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """A bf16 flow chain's bias gradient and conditioning gradient from
    tile sums [batch, tiles, n] (:func:`tile_sums_plain`), as the weight
    gradient's reduction adds them (``wgrad_reduce_kernel``) -> (the bias
    [n]: each sample's part, then the samples in order; the per-sample
    parts [batch, n]: each sample's tiles in order; dg is these rounded
    to bf16)."""
    batch, tiles, n = sums.shape
    per_sample = torch.zeros(batch, n)
    for i in range(tiles):
        per_sample = per_sample + sums[:, i]
    total = torch.zeros(n)
    for b in range(batch):
        total = total + per_sample[b]
    return total, per_sample


class _Bf16TextChain:
    """The products of one call of a text chain's bf16 dispatch over
    ``batch`` samples of ``t`` rows (csrc/bf16_gemm.cu): each conv-GEMM by
    :func:`bf16_text_conv_plan`, each weight gradient by
    :func:`bf16_wgrad_plan` within ``wg_floats`` of scratch."""

    def __init__(self, batch: int, t: int, sms: int, wg_floats: int):
        self.batch, self.t, self.sms, self.wg_floats = batch, t, sms, wg_floats
        self.products: typing.List[dict] = []

    def conv(self, name, c_in, n, k_taps=1, w_t=False):
        batch, t = self.batch, self.t
        chunks, shares = bf16_text_conv_plan(batch, t, c_in, k_taps, n, self.sms, w_t=w_t)
        stages, smem = bf16_ring("conv_gemm", chunks) if chunks else (0, 0)
        # either unit's tiles: 64 rows of one sample
        tiles = (batch * -(-t // BF16_CONV_TILE) * -(-n // (64 * chunks)) * shares if chunks
                 else batch * -(-t // BF16_CONV_TILE) * -(-n // 64))
        self.products.append({
            "name": name, "kind": "conv_gemm", "shape": [batch * t, k_taps * c_in, n],
            "unit": "tma" if chunks else "mma", "chunks": chunks, "shares": shares,
            "tiles": tiles, "stages": stages, "smem": smem,
            "launches": 1 + int(shares > 1)})

    def wgrad(self, name, c_in, n, k_taps=1):
        chunks, splits = bf16_wgrad_plan(self.batch, self.t, c_in, k_taps, n, c_in, self.sms,
                                         self.wg_floats)
        tiles = (-(-n // (64 * chunks)) * -(-(k_taps * c_in) // BF16_WGRAD_TILE) * splits
                 if chunks else 0)
        stages, smem = bf16_ring("wgrad", chunks) if chunks else (0, 0)
        self.products.append({
            "name": name, "kind": "wgrad", "shape": [k_taps * c_in, self.batch * self.t, n],
            "unit": "tma" if chunks else "mma", "chunks": chunks, "splits": splits,
            "tiles": tiles, "stages": stages, "smem": smem,
            # the product and, split, its splits' sum (the bias gradients
            # are the chain's column sums)
            "launches": 1 + int(chunks > 0 and splits > 1)})

    def plan(self, fixed: int) -> typing.Dict[str, typing.Any]:
        """-> {"products", "launches": ``fixed`` device operations besides
        the products' plus theirs, "counts"}."""
        counts = {"bf16_gemm": 0, "bf16_wgrad": 0, "bf16_tma_gemm": 0, "bf16_tma_wgrad": 0}
        for p in self.products:
            tma = "_tma" if p["unit"] == "tma" else ""
            counts[f"bf16{tma}_{'gemm' if p['kind'] == 'conv_gemm' else 'wgrad'}"] += 1
        return {"products": self.products,
                "launches": fixed + sum(p["launches"] for p in self.products),
                "counts": counts}


def bf16_encoder_products(batch: int, t: int, h: int, f: int, taps: int, sms: int,
                          backward: bool = False) -> typing.Dict[str, typing.Any]:
    """The plan of one call of the text encoder layer's bf16 forward
    (``gtt_encoder_layer_bf16``, bf16 row 2) or backward
    (``gtt_encoder_layer_bwd_bf16``, bf16 row 13, which runs the forward's
    chain first) over ``batch`` samples of ``t`` rows at width ``h``, FFN
    width ``f`` and ``taps`` (csrc/encoder.cu, csrc/encoder_train.cu,
    csrc/bf16_gemm.cu): the plain version of its products' dispatch.  ->
    {"products": per product its name, kind ("conv_gemm"/"wgrad"), shape
    ([rows, K, N]; a weight gradient's [K, rows, N]), unit ("tma" the
    TMA-fed wgmma kernel, "mma" the mma.sync kernel), chunks (64-column
    chunks a tile), shares (a conv-GEMM's split-K) or splits (a weight
    gradient's row splits), tiles (blocks of a launch), stages, shared
    memory (a block's) and launches (a split product's sum pass
    included); "launches": the device operations of a call; "counts":
    ``kernels.product_counts`` of a call}."""
    chain = _Bf16TextChain(batch, t, sms, max(WALK_WG_FLOATS, taps * h * f))
    conv, wgrad = chain.conv, chain.wgrad
    conv("qkv", h, 3 * h)
    conv("out_proj", h, h)
    conv("ffn1", h, f, taps)
    conv("ffn2", f, h, taps)
    fixed = 4  # xm's masked copy, the attention core, the two norms
    if backward:
        wgrad("dW2", f, h, taps)
        conv("dffn", h, f, taps, w_t=True)
        wgrad("dW1", h, f, taps)
        conv("dx1", f, h, taps, w_t=True)
        wgrad("dWo", h, h)
        conv("datt", h, h, w_t=True)
        wgrad("dW_qkv", h, 3 * h)
        conv("dx", 3 * h, h, w_t=True)
        # the norms' backwards, dc2's column sums and the other five bias
        # and norm gradients' in one launch, the attention backward's score
        # pass and products, the rel-pos tables' partial sums and their sum
        fixed += 8
    return chain.plan(fixed)


def bf16_prenet_products(batch: int, t: int, h: int, n_layers: int, taps: int, sms: int,
                         backward: bool = False) -> typing.Dict[str, typing.Any]:
    """The plan of one call of the prenet's bf16 forward
    (``gtt_prenet_bf16``, bf16 row 1) or backward (``gtt_prenet_bwd_bf16``,
    bf16 row 14, which runs the forward's chain first) over ``batch``
    samples of ``t`` rows at width ``h`` (csrc/text.cu, csrc/text_train.cu,
    csrc/bf16_gemm.cu): the plain version of its products' dispatch, as
    :func:`bf16_encoder_products` gives it."""
    chain = _Bf16TextChain(batch, t, sms, max(WALK_WG_FLOATS, taps * h * h))
    conv, wgrad = chain.conv, chain.wgrad
    for l in range(n_layers):
        conv(f"conv_{l}", h, h, taps)
    conv("proj", h, h)
    # x * mask's bf16 copy (with layers), a norm a layer
    fixed = int(n_layers > 0) + n_layers
    if backward:
        wgrad("dWp", h, h)
        conv("dproj", h, h, w_t=True)
        for l in reversed(range(n_layers)):
            wgrad(f"dW_{l}", h, h, taps)
            conv(f"transposed_{l}", h, h, taps, w_t=True)
        # dout * mask's bf16 copy, dbp's two sums; a layer its norm's
        # backward and one launch of its norm's and bias's column sums
        fixed += 3 + 2 * n_layers
    return chain.plan(fixed)


def bf16_duration_products(batch: int, t: int, c_in: int, f: int, taps: int, sms: int,
                           backward: bool = False) -> typing.Dict[str, typing.Any]:
    """The plan of one call of the duration stack's bf16 forward
    (``gtt_duration_stack_bf16``, bf16 row 3) or backward
    (``gtt_duration_stack_bwd_bf16``, bf16 row 15, which runs the forward's
    chain first) over ``batch`` samples of ``t`` rows, ``c_in`` input
    channels and width ``f`` (csrc/text.cu, csrc/text_train.cu,
    csrc/bf16_gemm.cu): the plain version of its products' dispatch, as
    :func:`bf16_encoder_products` gives it."""
    chain = _Bf16TextChain(batch, t, sms, max(WALK_WG_FLOATS, taps * max(c_in, f) * f))
    conv, wgrad = chain.conv, chain.wgrad
    conv("conv_0", c_in, f, taps)
    conv("conv_1", f, f, taps)
    fixed = 3  # x * mask's bf16 copy, the two norms
    if backward:
        wgrad("dW_1", f, f, taps)
        conv("transposed_1", f, f, taps, w_t=True)
        wgrad("dW_0", c_in, f, taps)
        conv("transposed_0", f, c_in, taps, w_t=True)
        fixed += 2 * 2  # a layer its norm's backward and one launch of column sums
    return chain.plan(fixed)


def bf16_conv_product_plain(a, w, taps=1, dilation=1, tap_sign=1, w_t=False) -> torch.Tensor:
    """Plain version of :func:`bf16_conv_product`: bf16 operands, exact
    products summed in f32."""
    return conv_product_plain(a.float(), w.float(), taps, dilation, tap_sign, w_t=w_t)


def bf16_conv_product(
    a: torch.Tensor, w: torch.Tensor, taps: int = 1, dilation: int = 1, tap_sign: int = 1,
    w_t: bool = False, unit: str = "tma", mask: typing.Optional[torch.Tensor] = None,
    sums: bool = False,
):
    """a [b, t, c] bf16, w bf16 [taps * c, n] (or with ``w_t`` a forward
    conv's [taps * n, c], B its per-tap transpose) -> im2col(a) @ B [b, t,
    n] f32 by one bf16 product on ``unit``: "tma" the 64-row TMA-fed wgmma
    kernel over the whole K walk a block (an error where the shape does not
    fit),
    "text" the same kernel by the text chains' plan (:func:`bf16_text_conv_plan`:
    chunks a tile and split-K shares, added in split order by the
    epilogue's pass; dilation 1), "mma" the mma.sync one.  ``mask`` [b, t,
    1] f32: the output's rows times it, in the epilogue.  ``sums`` ("tma"
    and "mma"): -> (out, its tile sums [b, ceil(t / 64), n] f32 as a flow
    chain's cotangent epilogue keeps them, :func:`tile_sums_plain`).  CPU
    tensors take the plain version."""
    if kernels.route(a) == "plain":
        out = bf16_conv_product_plain(a, w, taps, dilation, tap_sign, w_t)
        if mask is not None:
            out = out * mask
        return (out, tile_sums_plain(out.reshape(-1, out.shape[-1]), *a.shape[:2])) if sums else out
    if unit not in BF16_UNITS:
        raise ValueError(f"unit {unit!r}: one of {BF16_UNITS}")
    batch, t, c = a.shape
    kernels.check_operands(a.device, ("a", "w"), a=a, w=w, mask=mask)
    n = w.shape[0] // taps if w_t else w.shape[1]
    kernels.check_shape("w", w, (taps * n, c) if w_t else (taps * c, n))
    if mask is not None:
        kernels.check_shape("mask", mask, (batch, t, 1))
    out = torch.empty((batch, t, n), dtype=torch.float32, device=a.device)
    if unit == "text":
        if dilation != 1:
            raise ValueError("the text chains' products have dilation 1")
        if mask is not None or sums:
            raise ValueError("the text chains' products keep no tile sums and take no mask")
        part = kernels.scratch(SPLIT_K_COLS * batch * t, a)
        kernels.BF16_TEXT_PRODUCT(a, w, out, part, part.numel(), batch, t, c, taps, tap_sign, n,
                                  int(w_t))
        return out
    tile_sums = (torch.empty((batch, -(-t // BF16_SUM_TILE), n), dtype=torch.float32,
                             device=a.device) if sums else None)
    kernels.BF16_CONV_PRODUCT(a, w, out, mask, tile_sums, batch, t, c, taps, dilation, tap_sign,
                              n, int(w_t), _BF16_UNIT_CODE[unit])
    return (out, tile_sums) if sums else out


def bf16_wn_product_plain(kind, a, w, bias, taps=1, dilation=1, drop=None, saves=False, g=None,
                          x_l=None, skip=None, mask=None, layer=0, n_layers=1, skip_mask=False,
                          out=None):
    """Plain version of :func:`bf16_wn_product` (``skip`` updated in place
    as the kernel updates it; ``out`` written where given)."""
    from . import bf16, wn_cuda

    batch, t, h = a.shape
    acc = bf16_conv_product_plain(a, w, taps, dilation) + bias
    if kind == "gate":
        if drop is not None and drop[0] > 0.0:
            p, seed, site, n_sites = drop
            seeds = seed + torch.arange(batch, dtype=torch.int64)
            keep = wn_cuda.regen_keep(seeds, site, n_sites, (t, 2 * h), p, a.device)
            acc = acc * keep * wn_cuda.drop_args(p)[2]
        if g is not None:
            acc = acc + g.float()[:, None, :]
        th, sg = torch.tanh(acc[..., :h]), torch.sigmoid(acc[..., h:])
        acts = (th * sg).to(bf16.BF16)
        return (acts, th.to(bf16.BF16), sg.to(bf16.BF16)) if saves else (acts,)
    rs = acc.to(bf16.BF16).float()
    last = layer == n_layers - 1
    x_next = None
    if not last:
        x_next = ((x_l.float() + rs[..., :h]).to(bf16.BF16).float() * mask).to(bf16.BF16)
        if out is not None:
            out.copy_(x_next)
            x_next = out
    total = rs[..., h:] if layer == 0 else skip + rs[..., h:]
    skip.copy_(total)
    skipm = ((total.to(bf16.BF16).float() * mask).to(bf16.BF16)
             if last and skip_mask else None)
    return x_next, skip, skipm


def bf16_wn_product(
    kind: str, a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, taps: int = 1,
    dilation: int = 1, drop: typing.Optional[tuple] = None, saves: bool = False,
    g: typing.Optional[torch.Tensor] = None, x_l: typing.Optional[torch.Tensor] = None,
    skip: typing.Optional[torch.Tensor] = None, mask: typing.Optional[torch.Tensor] = None,
    layer: int = 0, n_layers: int = 1, skip_mask: bool = False, unit: str = "ws",
    out: typing.Optional[torch.Tensor] = None,
):
    """One layer's product of the bf16 WN forward with its own epilogue
    (``wn_layer_products`` in csrc/common.cu), alone on ``unit`` ("ws",
    "tma" or "mma", as :func:`bf16_conv_product`), h channels:

    * ``kind`` "gate", the in-layer conv: ``a`` x [b, t, h] bf16, ``w``
      [taps * h, 2h] bf16, ``bias`` [2h] f32; ``drop`` (p, seed, site,
      n_sites) or None; ``g`` [b, 2h] bf16 or None -> (acts,) or, with
      ``saves``, (acts, th, sg), each [b, t, h] bf16.
    * "res_skip": ``a`` acts [b, t, h] bf16, ``w`` [h, 2h] bf16, ``bias``
      [2h] f32, ``x_l`` [b, t, h] bf16, ``skip`` [b, t, h] f32 (written at
      ``layer`` 0, else added to, in place), ``mask`` [b, t, 1] f32 ->
      (the next x, bf16, into ``out`` where given (it may be ``x_l``), None
      at the last layer of ``n_layers``; skip; with ``skip_mask`` at the
      last layer its masked bf16 copy, else None).

    CPU tensors take the plain version."""
    if kind not in ("gate", "res_skip"):
        raise ValueError(f"kind {kind!r}: 'gate' or 'res_skip'")
    if kernels.route(a) == "plain":
        return bf16_wn_product_plain(kind, a, w, bias, taps, dilation, drop, saves, g, x_l, skip,
                                     mask, layer, n_layers, skip_mask, out)
    if unit not in _BF16_UNIT_CODE:
        raise ValueError(f"unit {unit!r}: one of {tuple(_BF16_UNIT_CODE)}")
    batch, t, h = a.shape
    gate = kind == "gate"
    kernels.check_operands(a.device, ("a", "w", "g", "x_l", "out"), a=a, w=w, bias=bias, g=g,
                           x_l=x_l, skip=skip, mask=mask, out=out)
    kernels.check_shape("w", w, ((taps if gate else 1) * h, 2 * h))
    kernels.check_shape("bias", bias, (2 * h,))
    bf = torch.bfloat16

    def empty():
        return torch.empty((batch, t, h), dtype=bf, device=a.device)

    if gate:
        acts = empty()
        th, sg = (empty(), empty()) if saves else (None, None)
        from . import wn_cuda

        p, seed, site, n_sites = drop if drop is not None else (0.0, 0, 0, 1)
        on, threshold, scale = wn_cuda.drop_args(p)
        if g is not None:
            kernels.check_shape("g", g, (batch, 2 * h))
        kernels.BF16_WN_PRODUCT(a, w, bias, acts, th, sg, g, None, batch, t, h, taps, dilation,
                                0, 0, 0, 0, on, seed, n_sites, site, threshold, scale,
                                _BF16_UNIT_CODE[unit])
        return (acts, th, sg) if saves else (acts,)
    for name, v in (("x_l", x_l), ("skip", skip)):
        if v is None:
            raise ValueError(f"res_skip needs {name}")
        kernels.check_shape(name, v, (batch, t, h))
    kernels.check_shape("mask", mask, (batch, t, 1))
    last = layer == n_layers - 1
    x_next = None if last else (empty() if out is None else out)
    skipm = empty() if last and skip_mask else None
    kernels.BF16_WN_PRODUCT(a, w, bias, x_next, skip, skipm, x_l, mask, batch, t, h, 1, 1, 1,
                            int(not last), int(layer == 0), int(last and skip_mask), 0, 0, 1, 0,
                            0, 1.0, _BF16_UNIT_CODE[unit])
    return x_next, skip, skipm



def bf16_weight_gradient_plain(a, dy, taps=1, dilation=1) -> torch.Tensor:
    """Plain version of :func:`bf16_weight_gradient`."""
    return weight_gradient_plain(a.float(), dy.float(), taps, dilation)


def bf16_weight_gradient(
    a: torch.Tensor, dy: torch.Tensor, taps: int = 1, dilation: int = 1, unit: str = "tma",
    bias_sums: typing.Optional[typing.Tuple[torch.Tensor, torch.Tensor]] = None,
    g_sums: typing.Optional[torch.Tensor] = None,
):
    """a [b, t, c], dy [b, t, n], both bf16 -> im2col(a)^T @ dy [taps * c, n]
    f32 over all b * t rows by one bf16 weight gradient on ``unit`` (as
    :func:`bf16_conv_product`), its row splits added in a fixed order.
    With ``bias_sums`` (lo, hi), tile sums [b, tiles, s] and [b, tiles, n -
    s] of dy's columns below s and from s, and/or ``g_sums`` [b, tiles, n]
    -> (dW, the bias gradient [n] f32 or None, dg [b, n] bf16 or None), as
    a flow chain's weight gradient takes them in its reduction's launch
    (:func:`sums_of_tiles_plain`'s order).  CPU tensors take the plain
    version."""
    with_sums = bias_sums is not None or g_sums is not None
    if kernels.route(a) == "plain":
        out = bf16_weight_gradient_plain(a, dy, taps, dilation)
        if not with_sums:
            return out
        bias = None if bias_sums is None else sums_of_tiles_plain(torch.cat(bias_sums, -1))[0]
        dg = None if g_sums is None else sums_of_tiles_plain(g_sums)[1].to(torch.bfloat16)
        return out, bias, dg
    batch, t, c = a.shape
    n = dy.shape[-1]
    lo, hi = bias_sums if bias_sums is not None else (None, None)
    kernels.check_operands(a.device, ("a", "dy"), a=a, dy=dy, lo=lo, hi=hi, g_sums=g_sums)
    kernels.check_shape("dy", dy, (batch, t, n))
    tiles = -(-t // BF16_SUM_TILE)
    split = 0 if lo is None else lo.shape[-1]
    if lo is not None:
        kernels.check_shape("bias_sums[0]", lo, (batch, tiles, split))
        kernels.check_shape("bias_sums[1]", hi, (batch, tiles, n - split))
    if g_sums is not None:
        kernels.check_shape("g_sums", g_sums, (batch, tiles, n))
    out = torch.empty((taps * c, n), dtype=torch.float32, device=a.device)
    bias = None if lo is None else torch.empty((n,), dtype=torch.float32, device=a.device)
    dg = None if g_sums is None else torch.empty((batch, n), dtype=torch.bfloat16, device=a.device)
    scratch = kernels.scratch(WALK_WG_FLOATS, a)
    kernels.BF16_WGRAD_PRODUCT(a, dy, out, scratch, lo, hi, g_sums, bias, dg, scratch.numel(),
                               batch, t, c, taps, dilation, n, split, int(unit == "tma"))
    return (out, bias, dg) if with_sums else out


def split_weights_plain(w: torch.Tensor, pair: int = 0) -> torch.Tensor:
    """w [K, N] -> [2, N, K]: the K-major layout the tensor-core conv-GEMM
    reads, ``[0]`` the big and ``[1]`` the small TF32 part; with ``pair`` (a
    paired epilogue's split) its rows in tile order, row i holding column
    ``physical_cols(N, pair)[i]``, as the TMA-fed kernel reads them."""
    out = torch.stack(tf32_split(w.T.contiguous()))
    return out[:, physical_cols(w.shape[1], pair)] if pair else out


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


FWD_KERNELS = {"tap_by_tap": 0, "tap_staged": 1, "tma": 2, "tap_staged_bn64": 3}


def gate_plain(pre: torch.Tensor) -> torch.Tensor:
    """The WN gate of a pre-activation [..., 2h] without bias, dropout or
    conditioning: tanh of the first half times sigmoid of the second."""
    h = pre.shape[-1] // 2
    return torch.tanh(pre[..., :h]) * torch.sigmoid(pre[..., h:])


def conv_product_fwd(
    a: torch.Tensor, w: torch.Tensor, taps: int, dilation: int, kernel: str, tile_rows: int,
    cluster: int = 1, gate: bool = False,
) -> torch.Tensor:
    """The WN forward's in-layer conv a [b, t, c], w [taps * c, n] ->
    im2col(a) @ w [b, t, n] (with ``gate`` its gated activations [b, t,
    n / 2]) on the tensor cores by ``kernel``: "tap_by_tap", "tap_staged"
    (its 64-column tiles: "tap_staged_bn64") or "tma" (in clusters of
    ``cluster`` row tiles), in ``tile_rows``-row
    tiles (128 or 64), whatever :func:`forward_conv_plan` would take
    (``scripts/torch-wn-fwd-sweep.py``).  CPU tensors take the plain
    version."""
    if kernels.route(a) == "plain":
        out = conv_product_plain(a, w, taps, dilation)
        return gate_plain(out) if gate else out
    batch, t, c = a.shape
    kernels.check_operands(a.device, a=a, w=w)
    n = w.shape[1]
    kernels.check_shape("w", w, (taps * c, n))
    out = a.new_empty((batch, t, n // 2 if gate else n))
    scratch = _scratch(a, 2 * w.numel() + 4)
    kernels.TC_CONV_GEMM_FWD(
        a, w, out, scratch, scratch.numel(), batch, t, c, taps, dilation, n, int(gate),
        FWD_KERNELS[kernel], tile_rows, cluster)
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


def split_weights(w: torch.Tensor, pair: int = 0) -> torch.Tensor:
    """w [K, N] -> [2, N, K] by the kernel that splits a chain's weights
    (in tile order with ``pair``); CPU tensors take
    :func:`split_weights_plain`."""
    if kernels.route(w) == "plain":
        return split_weights_plain(w, pair)
    kernels.check_operands(w.device, w=w)
    kdim, n = w.shape
    out = w.new_empty((2, n, kdim))
    kernels.SPLIT_WEIGHTS(w, out[0], out[1], kdim, n, pair)
    return out
