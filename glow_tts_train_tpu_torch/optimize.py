"""Noam-scheduled Adam with element-wise value clipping
(glow_tts_train_tpu optimize.py: ``optax.clip`` -> ``scale_by_adam`` ->
``scale_by_learning_rate``), written with plain tensor ops so that each
step rounds as the optax formula does:

    g = clip(g, -grad_clip, grad_clip)
    mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu;  count += 1
    update = (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)
    param -= lr(count - 1) * update

(``torch.optim.Adam`` places eps after the bias-corrected square root
differently.)  The schedule is evaluated at count + 1, as the reference's
step numbering starts at 1.
"""

import typing

import torch


def noam_schedule(dim_model: int, warmup_steps: int, base_lr: float) -> typing.Callable[[int], float]:
    """lr(count) = base_lr * d^-0.5 * min(step^-0.5, step * warmup^-1.5),
    step = count + 1, in f32 as the JAX schedule computes it."""

    def schedule(count: int) -> float:
        step = torch.tensor(count + 1.0, dtype=torch.float32)
        warm = torch.tensor(warmup_steps ** -1.5, dtype=torch.float32)
        scale = dim_model ** -0.5 * torch.minimum(step ** -0.5, step * warm)
        return float(base_lr * scale)

    return schedule


def learning_rate_fn(config) -> typing.Callable[[int], float]:
    if config.scheduler == "noam":
        return noam_schedule(config.model.hidden_channels, config.warmup_steps, config.learning_rate)
    return lambda count: config.learning_rate


def current_lr(config, step: int) -> float:
    """The lr applied at 1-indexed global step ``step`` (logging and
    checkpoint metadata)."""
    return learning_rate_fn(config)(max(step - 1, 0))


class AdamState(typing.NamedTuple):
    mu: typing.Dict[str, torch.Tensor]
    nu: typing.Dict[str, torch.Tensor]
    count: int  # updates applied so far (optax's shared count)


def adam_init(params: typing.Mapping[str, torch.Tensor]) -> AdamState:
    zeros = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
    return AdamState(zeros, {k: z.clone() for k, z in zeros.items()}, 0)


@torch.no_grad()
def adam_update(
    params: typing.Mapping[str, torch.Tensor],
    grads: typing.Mapping[str, torch.Tensor],
    state: AdamState,
    config,
) -> AdamState:
    """Clip, Adam and the scheduled step, applied to ``params`` in place;
    returns the new moments (updated in place too) and count."""
    b1, b2 = config.betas
    count = state.count + 1
    lr = learning_rate_fn(config)(state.count)
    # 1 - decay^count in f32, as optax's bias correction
    bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** count
    bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** count
    for k, p in params.items():
        g = torch.clamp(grads[k], -config.grad_clip, config.grad_clip)
        mu = state.mu[k].mul_(b1).add_((1.0 - b1) * g)
        nu = state.nu[k].mul_(b2).add_((1.0 - b2) * (g * g))
        update = (mu / bc1.to(mu.device)) / (torch.sqrt(nu / bc2.to(nu.device)) + config.eps)
        p.add_(-lr * update)
    return AdamState(state.mu, state.nu, count)
