"""The flow decoder in the inverse (generation) direction
(glow_tts_train_tpu ops/flows.py), channels-last [b, t, c].

:func:`decoder_inv` is the serving path: squeeze, then the blocks in
reverse order through :func:`block_cuda.block_inverse` (the CUDA kernel for
CUDA tensors, its plain version for CPU tensors), then unsqueeze.  Each
block's bijectors (coupling, InvConvNear and ActNorm inverses) run in the
folded form of :func:`block_cuda.fold_block_params_inverse`.
"""

import typing

import torch

from . import block_cuda
from .conv import weight_norm_effective
from ..tree import tree_index

Params = typing.Dict[str, typing.Any]


def squeeze(
    x: torch.Tensor, x_mask: torch.Tensor, n_sqz: int = 2
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """Fold time into channels: [b, t, c] -> [b, t//n, c*n]; the mask is
    subsampled at stride n from n-1."""
    b, t, c = x.shape
    t_trunc = (t // n_sqz) * n_sqz
    x_sqz = x[:, :t_trunc].reshape(b, t_trunc // n_sqz, n_sqz * c)
    x_mask = x_mask[:, n_sqz - 1 :: n_sqz]
    return x_sqz * x_mask, x_mask


def unsqueeze(
    x: torch.Tensor, x_mask: torch.Tensor, n_sqz: int = 2
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of squeeze: [b, t, C] -> [b, t*n, C//n]."""
    b, t, c = x.shape
    x_unsqz = x.reshape(b, t * n_sqz, c // n_sqz)
    x_mask = torch.repeat_interleave(x_mask, n_sqz, dim=1)
    return x_unsqz * x_mask, x_mask


def decoder_store_inverse(blocks: Params, n_layers: int, n_split: int):
    """Stacked block params -> (per-block inverse folds, per-block
    effective speaker-conditioning convs or None), all folded once here:
    the s x s inverses, weight norm, and the actnorm/invconv affine."""
    n_blocks = blocks["actnorm"]["logs"].shape[0]
    folded, cond = [], []
    for i in range(n_blocks):
        bp = tree_index(blocks, i)
        folded.append(block_cuda.fold_block_params_inverse(bp, n_layers, n_split))
        if "cond" in bp["coupling"]["wn"]:
            c = bp["coupling"]["wn"]["cond"]
            cond.append(
                {"w": weight_norm_effective(c).contiguous(), "b": c["b"].to(torch.float32)}
            )
    return folded, (cond or None)


def decoder_inv(
    blocks: typing.Sequence[dict],
    x: torch.Tensor,
    x_mask: torch.Tensor,
    *,
    kernel_size: int,
    dilation_rate: int,
    n_sqz: int,
    sigmoid_scale: bool = False,
    g_all: typing.Optional[typing.Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """z -> mel: the inverse blocks in reverse order on ``decoder_store_inverse``
    folds.  g_all: per-block [b, L, 2h] conditioning, or None."""
    x, x_mask = squeeze(x, x_mask, n_sqz)
    x_mask = x_mask.contiguous()
    for i in reversed(range(len(blocks))):
        x = block_cuda.block_inverse(
            blocks[i], None if g_all is None else g_all[i], x, x_mask,
            kernel_size, dilation_rate, sigmoid_scale,
        )
    x, _ = unsqueeze(x, x_mask, n_sqz)
    return x
