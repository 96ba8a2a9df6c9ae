"""Monotonic alignment search: CUDA kernel (``csrc/mas.cu``) and its plain
PyTorch version, with the semantics of glow_tts_train_tpu ops/mas.py
(``maximum_path`` :37, the column scan :193, the numpy oracle :252).

Forward, per sample, column by column: ``v[x] = max(v[x], v[x-1]) +
logp[x, y]`` in f32 (v[-1] is the -1e9 sentinel, cells above the diagonal
hold -1e9), recording "stay" (``v[x] >= v[x-1]``: ties stay) per cell,
forced to stay outside the mask.  Backtrace from (t_x - 1, t_y - 1): mark
the cell, then move up a row unless the direction says stay, never at
row 0, always where row == column.  The path is 0/1 [b, t_x, t_y] with
no gradient.

:func:`maximum_path` replaces the three TPU kernels of ``mas_pallas.py``:
``_kernel`` (:41, shapes that fit VMEM) and the streaming pair
``_fwd_stream_kernel`` (:127) / ``_bwd_stream_kernel`` (:155).  On the
card every shape takes one kernel, a block a sample.  Bound: the serial
column recurrence (t_y dependent steps), not FLOPs or bytes, so one warp
scans a sample with its value column in registers (lane ``l`` owns 16 text
rows at most, consecutive), a shuffle and a ballot a mel frame and no
block barrier; wider texts take a band of rows per warp, the bands joined
through shared memory with one barrier a frame (t_x up to about 2,400: the
staging ring's shared memory).  Three more warps stage logp ahead into
shared memory by ``cp.async``; the mask is read only for the lengths (its
first column and first row: it is rectangular per sample).  The stay bits
are the ballots, ``t_x * t_y / 8`` bytes a sample, in shared memory where
they fit, else in a device-memory buffer (``kernels.mas_bits_words``); the
backtrace takes a step per move, 32 columns at a time, and records each
row's run of path columns; a second kernel writes the whole path from the
runs, zeros included, over all SMs.  The add is a plain f32 add (no FMA
contraction), so paths equal the numpy oracle bit for bit.
"""

import torch

from .. import kernels

_MAX_NEG = -1e9


@torch.no_grad()
def maximum_path_plain(logp: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`maximum_path`: the JAX column scan as a
    torch loop over columns, vectorised over batch and text."""
    b, t_x, t_y = logp.shape
    device = logp.device
    maskf = mask.to(torch.float32)
    value = logp.to(torch.float32) * maskf
    t_x_len = maskf[:, :, 0].sum(1).to(torch.int64)
    t_y_len = maskf[:, 0, :].sum(1).to(torch.int64)
    x_range = torch.arange(t_x, device=device)
    v = torch.zeros((b, t_x), dtype=torch.float32, device=device)
    neg = torch.full((b, 1), _MAX_NEG, dtype=torch.float32, device=device)
    stays = []
    for y in range(t_y):
        v0 = torch.cat([neg, v[:, :-1]], dim=1)
        stay = v >= v0
        v = torch.where(x_range[None, :] <= y, torch.where(stay, v, v0) + value[:, :, y], _MAX_NEG)
        stays.append(stay)
    direction = torch.stack(stays, dim=1)  # [b, t_y, t_x]
    direction = torch.where(maskf.transpose(1, 2) > 0, direction, True).to(torch.int64)
    path = torch.zeros((b, t_x, t_y), dtype=torch.float32, device=device)
    index = torch.clamp(t_x_len - 1, min=0)
    batch = torch.arange(b, device=device)
    for y in range(t_y - 1, -1, -1):
        active = y < t_y_len
        path[batch, index, y] = active.to(torch.float32)
        d = direction[batch, y, index]
        d = torch.where(index == 0, 1, torch.where(index == y, 0, d))
        index = torch.where(active, torch.clamp(index + d - 1, min=0), index)
    return (path * maskf).to(logp.dtype)


@torch.no_grad()
def maximum_path(logp: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Best monotonic alignment path: logp, mask [b, t_x, t_y] (mask 0/1,
    rectangular per sample) -> 0/1 path [b, t_x, t_y], dtype of logp."""
    if kernels.route(logp) == "plain":
        return maximum_path_plain(logp, mask)
    kernels.check_operands(logp.device, logp=logp, mask=mask)
    kernels.check_shape("mask", mask, logp.shape)
    b, t_x, t_y = logp.shape
    words = kernels.mas_bits_words(b, t_x, t_y, logp.device)
    if words < 0:
        raise ValueError(f"maximum_path: the kernel's shared memory does not take t_x = {t_x}")
    path = torch.empty_like(logp)  # every element is written
    # the stay bits where shared memory cannot hold them; each row's run of
    # path columns (first, last)
    bits = torch.empty((words,), dtype=torch.int32, device=logp.device) if words else None
    runs = torch.empty((b, 2, t_x), dtype=torch.int32, device=logp.device)
    kernels.MAS(logp, mask, path, bits, runs, b, t_x, t_y)
    return path
