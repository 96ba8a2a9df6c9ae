"""The logdet of each forward bijector of the port's flow decoder against
the log |det| of its autograd Jacobian on tiny shapes, as
``tests/test_flows.py`` holds the JAX package's decoder: ActNorm,
InvConvNear, the affine coupling, and the whole decoder fused
(``block_fuse`` true) and op by op, in both residual modes.  The params
are the port's random init perturbed away from it, so that no bijector is
near the identity; every frame is valid, so the Jacobian is square and
full rank."""

import numpy as np
import pytest
import torch

from glow_tts_train_tpu_torch import checkpoint, training
from glow_tts_train_tpu_torch.models import glow_tts as model
from glow_tts_train_tpu_torch.ops import flows
from glow_tts_train_tpu_torch.tree import tree_index, tree_map

from helpers import tiny_config

T = 4  # frames after the squeeze (8 mel frames before it)
RTOL = ATOL = 1e-3  # tests/test_flows.py's


def _hyper():
    return model.hyper_from_config(tiny_config(p_dropout=0.0, p_dropout_dec=0.0))


def _blocks(hp, seed=2):
    """The decoder's stacked block params, each leaf perturbed by 0.2 x a
    standard normal from a numpy seed."""
    flat = {k[len("model/"):]: v for k, v in checkpoint.random_params(hp, seed).items()}
    blocks = training.trainable_model(flat, hp, "cpu").tree()["decoder"]["blocks"]
    rng = np.random.default_rng(seed + 10)
    return tree_map(
        lambda a: a + 0.2 * torch.from_numpy(rng.standard_normal(tuple(a.shape)).astype(np.float32)),
        blocks,
    )


def _held(fn, x, mask):
    """fn(x) -> (z, logdet [1]); the logdet against slogdet of d z / d x."""
    shape = x.shape

    def f(flat):
        return fn(flat.reshape(shape), mask)[0].reshape(-1)

    jac = torch.autograd.functional.jacobian(f, x.reshape(-1))
    sign, expected = np.linalg.slogdet(jac.double().numpy())
    assert sign != 0
    with torch.no_grad():
        _, logdet = fn(x, mask)
    assert logdet.shape == (1,)
    np.testing.assert_allclose(float(logdet[0]), expected, rtol=RTOL, atol=ATOL)
    assert abs(expected) > 1e-2  # the bijector is not near the identity


def _inputs(c, t=T, seed=3):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal((1, t, c)).astype(np.float32))
    return x, torch.ones((1, t, 1))


@pytest.mark.parametrize("bijector", ["actnorm", "invconv", "coupling"])
def test_bijector_logdet_matches_the_jacobian(bijector):
    hp = _hyper()
    bp = tree_index(_blocks(hp), 0)
    c = hp.out_channels * hp.n_sqz
    x, mask = _inputs(c)
    if bijector == "actnorm":
        fn = lambda x, m: flows.actnorm_fwd(bp["actnorm"], x, m)  # noqa: E731
    elif bijector == "invconv":
        fn = lambda x, m: flows.invconv_apply(bp["invconv"], x, m)  # noqa: E731
    else:
        def fn(x, m):
            return flows.coupling_apply(
                bp["coupling"], x, m, None, hp.h_dec, hp.kernel_size_dec, hp.dilation_rate,
                hp.n_block_layers, hp.sigmoid_scale,
            )
    _held(fn, x, mask)


@pytest.mark.parametrize("residuals", ["store", "recompute"])
@pytest.mark.parametrize("block_fuse", [True, False], ids=["fused", "op_by_op"])
def test_decoder_logdet_matches_the_jacobian(block_fuse, residuals):
    hp = _hyper()
    blocks = _blocks(hp)
    x, mask = _inputs(hp.out_channels, t=T * hp.n_sqz)

    def fn(x, m):
        return flows.decoder_fwd(blocks, x, m, n_split=hp.n_split, block_fuse=block_fuse,
                                 wn_residuals=residuals, **model._decoder_kwargs(hp))

    _held(fn, x, mask)
