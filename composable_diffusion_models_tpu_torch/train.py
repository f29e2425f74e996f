"""Training: the denoising loss, Adam, EMA, step chunks and resume.

Port of ``composable_diffusion_models_tpu.train``. The dataset lives on the
device and each step gathers its batch there; a chunk of steps is a Python
loop where the JAX package runs one ``lax.scan``, and it never waits for the
device (losses stay on it until the caller reads them).

Randomness keeps the JAX package's key structure (``rng``): the key of
chunk c is ``fold_in(key, c)``, of its step i ``fold_in(chunk_key, i)``,
split in two for the batch indices and the loss; the loss splits its key in
three for t, the noise and the label dropout. A key may be a
``rng.Replay`` of recorded draws instead: the same loop then hands out those.

Parameter trees are nested dicts of tensors (``convert.from_flax``); the
optimizer is ``optax.adam`` (eps outside the square root, both moments
bias-corrected), optionally after ``optax.clip_by_global_norm`` (g kept
below the bound, else g / ||g|| * bound): :class:`Adam`. Trees are updated
functionally, as in JAX: every step makes new tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from .rng import Draws, as_draws
from .schedules import DDPMSchedule, VPSchedule

Params = Any
Schedule = Union[VPSchedule, DDPMSchedule]
Key = Union[int, Draws]


# ------------------------------------------------------------------- trees
def flatten(tree: Params) -> Tuple[List[Tuple[str, ...]], List[torch.Tensor]]:
    """(key paths, leaves) in sorted key order, as JAX orders a dict."""
    paths, leaves = [], []

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], prefix + (k,))
        else:
            paths.append(prefix)
            leaves.append(node)
    walk(tree, ())
    return paths, leaves


def unflatten(paths, leaves) -> Params:
    tree: Dict[str, Any] = {}
    for path, leaf in zip(paths, leaves):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def tree_map(fn: Callable, *trees: Params) -> Params:
    paths, leaves = flatten(trees[0])
    others = [flatten(t)[1] for t in trees[1:]]
    return unflatten(paths, [fn(*xs) for xs in zip(leaves, *others)])


def value_and_grad(loss_fn: Callable, params: Params, *args):
    """(loss, grads) of ``loss_fn(params, *args)``: the loss detached and a
    tree of gradients like ``params`` (zeros for leaves the loss does not
    reach, as ``jax.grad`` gives)."""
    paths, leaves = flatten(params)
    leaves = [leaf.detach().requires_grad_(True) for leaf in leaves]
    with torch.enable_grad():
        loss = loss_fn(unflatten(paths, leaves), *args)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), unflatten(paths, grads)


# ------------------------------------------------------------------- loss
def make_loss_fn(apply_fn: Callable[..., torch.Tensor], schedule: Schedule,
                 t_min: float = 1e-3, uncond_prob: float = 0.0,
                 null_labels: Optional[Sequence[int]] = None,
                 time_first: bool = False, predict: str = "eps",
                 snr_gamma: Optional[float] = None):
    """Denoising MSE ``loss_fn(params, key, x0, labels=())``, key an int or
    a ``rng.Draws``. ``apply_fn(params, x, t, *labels)`` predicts
    ``predict``: "eps" (the noise), "x0" (the clean image) or "v" (alpha
    eps - sigma x0; needs the true-VP ``stable`` schedule). t ~ U(t_min, 1)
    on a ``VPSchedule``, U{0..T-1} on a ``DDPMSchedule``. ``uncond_prob``
    replaces each label by its ``null_labels`` entry with that probability
    (CFG dropout); ``time_first`` calls ``apply_fn(params, t, x, ...)``.
    ``snr_gamma`` weighs each sample by min(SNR, gamma)/SNR (eps),
    min(SNR, gamma) (x0) or min(SNR, gamma)/(SNR + 1) (v)."""
    if predict not in ("eps", "x0", "v"):
        raise ValueError(f"predict must be 'eps', 'x0' or 'v', "
                         f"got {predict!r}")
    discrete = isinstance(schedule, DDPMSchedule)
    if predict == "v" and (discrete or schedule.kind != "stable"):
        raise ValueError("predict='v' needs VPSchedule(kind='stable'): the "
                         "v identities assume alpha^2 + sigma^2 = 1")

    def loss_fn(params: Params, key: Key, x0: torch.Tensor,
                labels: Tuple[torch.Tensor, ...] = ()) -> torch.Tensor:
        kt, ke, kd = as_draws(key, x0.device).split(3)
        bs = x0.shape[0]
        if discrete:
            t = kt.randint((bs,), schedule.num_timesteps)
            xt, eps = schedule.q_sample(x0, t, eps=ke.normal(x0.shape,
                                                             x0.dtype))
            t_in = t.float()
        else:
            t = kt.uniform((bs,), t_min, 1.0)
            xt, eps = schedule.q_t(x0, t, eps=ke.normal(x0.shape, x0.dtype))
            t_in = t
        if uncond_prob > 0.0 and labels:
            if null_labels is None:
                raise ValueError("label dropout (uncond_prob > 0) needs "
                                 "null_labels")
            drop = kd.uniform((bs,)) < uncond_prob
            labels = tuple(
                torch.where(drop, torch.as_tensor(nl, dtype=lab.dtype,
                                                  device=lab.device), lab)
                for lab, nl in zip(labels, null_labels))
        out = (apply_fn(params, t_in, xt, *labels) if time_first
               else apply_fn(params, xt, t_in, *labels))
        if predict == "v":
            bc = (-1,) + (1,) * (x0.dim() - 1)
            target = (schedule.alpha(t).reshape(bc) * eps
                      - schedule.sigma(t).reshape(bc) * x0)
        else:
            target = x0 if predict == "x0" else eps
        sq = (out - target) ** 2
        if snr_gamma is None:
            return sq.mean()
        if discrete:
            a_t = schedule.sqrt_alphas_cumprod.to(t.device)[t]
            s_t = schedule.sqrt_one_minus_alphas_cumprod.to(t.device)[t]
        else:
            a_t, s_t = schedule.alpha(t), schedule.sigma(t)
        snr = (a_t / torch.clamp(s_t, min=1e-8)) ** 2
        if predict == "x0":
            w = torch.clamp(snr, max=snr_gamma)
        elif predict == "v":
            w = torch.clamp(snr, max=snr_gamma) / (snr + 1.0)
        else:
            w = torch.clamp(snr, max=snr_gamma) / torch.clamp(snr, min=1e-8)
        per_sample = sq.reshape(bs, -1).mean(dim=1)
        return (w * per_sample).mean()

    return loss_fn


# -------------------------------------------------------------- optimizer
_B1, _B2 = 0.9, 0.999  # optax.adam's moment decays


@dataclasses.dataclass(frozen=True)
class Adam:
    """``optax.adam(lr, eps=eps)``, after
    ``optax.clip_by_global_norm(clip_norm)`` when ``clip_norm`` is set. The
    state is {"count": int32 0-d, "mu": tree, "nu": tree} on the params'
    device (``convert.adam_from_optax`` makes one from optax's)."""

    lr: float
    eps: float = 1e-8
    clip_norm: Optional[float] = None

    def init(self, params: Params) -> Dict[str, Any]:
        leaf = flatten(params)[1][0]
        return {"count": torch.zeros((), dtype=torch.int32,
                                     device=leaf.device),
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def update(self, grads: Params, state: Dict[str, Any], params: Params):
        """(new params, new state), the arithmetic in optax's order."""
        paths, g = flatten(grads)
        p, mu, nu = (flatten(t)[1] for t in (params, state["mu"],
                                              state["nu"]))
        if self.clip_norm:
            norm = torch.sqrt(sum(torch.sum(x * x) for x in g))
            keep = norm < self.clip_norm
            g = [torch.where(keep, x, (x / norm) * self.clip_norm)
                 for x in g]
        # the in-place steps act on tensors made here, never on the inputs
        new_mu = torch._foreach_mul(g, 1.0 - _B1)
        torch._foreach_add_(new_mu, torch._foreach_mul(mu, _B1))
        new_nu = torch._foreach_mul(g, g)
        torch._foreach_mul_(new_nu, 1.0 - _B2)
        torch._foreach_add_(new_nu, torch._foreach_mul(nu, _B2))
        count = state["count"] + 1
        bc1 = 1.0 - torch.pow(_B1, count.float())
        bc2 = 1.0 - torch.pow(_B2, count.float())
        den = torch._foreach_div(new_nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(new_mu, bc1)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, -self.lr)
        new_p = torch._foreach_add(p, upd)
        mu, nu = new_mu, new_nu
        return unflatten(paths, new_p), {"count": count,
                                         "mu": unflatten(paths, mu),
                                         "nu": unflatten(paths, nu)}


def ema_update(ema_params: Params, params: Params,
               decay: float = 0.999) -> Params:
    """e * decay + p * (1 - decay), kept in the EMA's dtype (float32)."""
    paths, e = flatten(ema_params)
    p = [x.to(y.dtype) for x, y in zip(flatten(params)[1], e)]
    new = torch._foreach_mul(e, decay)
    torch._foreach_add_(new, torch._foreach_mul(p, 1.0 - decay))
    return unflatten(paths, new)


# ------------------------------------------------------------ train loops
def make_train_step(loss_fn: Callable, tx: Adam):
    """``step(params, opt_state, key, x0, labels=())`` -> (params,
    opt_state, loss): one optimizer step on the loss's gradients."""

    def step(params, opt_state, key, x0, labels=()):
        loss, grads = value_and_grad(loss_fn, params, key, x0, labels)
        params, opt_state = tx.update(grads, opt_state, params)
        return params, opt_state, loss

    return step


def make_train_chunk(apply_fn: Callable[..., torch.Tensor],
                     schedule: Schedule, tx: Adam, *, batch_size: int,
                     uncond_prob: float = 0.0,
                     null_labels: Optional[Sequence[int]] = None,
                     time_first: bool = False,
                     ema_decay: Optional[float] = None,
                     predict: str = "eps",
                     snr_gamma: Optional[float] = None):
    """``run_chunk(params, opt_state, ema, chunk_key, images, labels=(), *,
    length)`` -> (params, opt_state, ema, losses): ``length`` steps, each
    on a batch of ``batch_size`` drawn with replacement from the
    device-resident ``images``; step i's key is ``chunk_key.fold_in(i)``
    split into (batch indices, loss). With ``ema_decay`` set (truthy) the
    EMA tree is updated after every step; otherwise ``ema`` passes through
    (None)."""
    loss_step = make_train_step(
        make_loss_fn(apply_fn, schedule, uncond_prob=uncond_prob,
                     null_labels=null_labels, time_first=time_first,
                     predict=predict, snr_gamma=snr_gamma), tx)

    def run_chunk(params, opt_state, ema, chunk_key: Key, images,
                  labels=(), *, length: int):
        chunk_key = as_draws(chunk_key, images.device)
        losses = []
        for i in range(length):
            kb, kl = chunk_key.fold_in(i).split(2)
            idx = kb.randint((batch_size,), images.shape[0])
            params, opt_state, loss = loss_step(
                params, opt_state, kl, images[idx],
                tuple(lab[idx] for lab in labels))
            if ema_decay:
                ema = ema_update(ema, params, ema_decay)
            losses.append(loss)
        return params, opt_state, ema, torch.stack(losses)

    return run_chunk


def _chunk_lengths(steps: int, steps_per_scan: int) -> List[int]:
    """Full chunks and a shorter remainder (no step is dropped)."""
    per = min(steps_per_scan, steps)
    return [per] * (steps // per) + ([steps % per] if steps % per else [])


def train_expert(key: Key, apply_fn: Callable[..., torch.Tensor],
                 params: Params, schedule: Schedule, images: torch.Tensor,
                 labels: Tuple[torch.Tensor, ...] = (), *,
                 steps: int = 1000, batch_size: int = 128, lr: float = 2e-4,
                 uncond_prob: float = 0.0,
                 null_labels: Optional[Sequence[int]] = None,
                 time_first: bool = False, steps_per_scan: int = 100,
                 ema_decay: Optional[float] = None, predict: str = "eps",
                 snr_gamma: Optional[float] = None,
                 clip_norm: Optional[float] = None,
                 adam_eps: float = 1e-8) -> Tuple[Params, torch.Tensor]:
    """Train one expert on the device-resident ``images`` (and ``labels``).
    Returns (params, losses): with ``ema_decay`` set the EMA tree, else the
    final parameters; losses (steps,) on the device. Chunk c runs with key
    ``fold_in(key, c)``. ``clip_norm`` clips the gradients' global norm
    before Adam; ``adam_eps`` is Adam's epsilon."""
    tx = Adam(lr, eps=adam_eps, clip_norm=clip_norm)
    run_chunk = make_train_chunk(
        apply_fn, schedule, tx, batch_size=batch_size,
        uncond_prob=uncond_prob, null_labels=null_labels,
        time_first=time_first, ema_decay=ema_decay, predict=predict,
        snr_gamma=snr_gamma)
    key = as_draws(key, images.device)
    opt_state = tx.init(params)
    ema = params if ema_decay else None
    all_losses = []
    for c, length in enumerate(_chunk_lengths(steps, steps_per_scan)):
        params, opt_state, ema, losses = run_chunk(
            params, opt_state, ema, key.fold_in(c), images, labels,
            length=length)
        all_losses.append(losses)
    return (ema if ema_decay else params), torch.cat(all_losses)


def train_expert_resumable(key: Key, apply_fn: Callable[..., torch.Tensor],
                           params: Params, schedule: Schedule,
                           images: torch.Tensor, ckpt_mgr, name: str,
                           labels: Tuple[torch.Tensor, ...] = (), *,
                           steps: int = 1000, batch_size: int = 128,
                           lr: float = 2e-4, uncond_prob: float = 0.0,
                           null_labels: Optional[Sequence[int]] = None,
                           time_first: bool = False,
                           steps_per_scan: int = 100, keep: int = 3,
                           ema_decay: Optional[float] = None,
                           predict: str = "eps",
                           snr_gamma: Optional[float] = None,
                           clip_norm: Optional[float] = None,
                           adam_eps: float = 1e-8
                           ) -> Tuple[Params, torch.Tensor]:
    """:func:`train_expert` with preemption recovery: after every chunk the
    state {params, opt_state, step, key[, ema_params]} goes to
    ``ckpt_mgr.save_step`` (keep-latest-``keep``); on start the newest step
    checkpoint of ``name`` is restored and the chunks it covers are skipped.
    Chunk keys derive from (key, chunk index), so a killed and resumed run
    gives bitwise the parameters of an uninterrupted one. Returns (params
    or EMA, the losses of the chunks this call ran)."""
    tx = Adam(lr, eps=adam_eps, clip_norm=clip_norm)
    run_chunk = make_train_chunk(
        apply_fn, schedule, tx, batch_size=batch_size,
        uncond_prob=uncond_prob, null_labels=null_labels,
        time_first=time_first, ema_decay=ema_decay, predict=predict,
        snr_gamma=snr_gamma)
    draws = as_draws(key, images.device)
    seed = None if isinstance(key, Draws) else int(key)
    opt_state = tx.init(params)
    ema = params if ema_decay else None
    restored, start_step = ckpt_mgr.restore_latest(name, images.device)
    if restored is not None:
        if restored.get("key") != seed:
            raise ValueError(f"step checkpoints of {name!r} were written "
                             f"with key {restored.get('key')}, not {seed}")
        if ema_decay and "ema_params" not in restored:
            raise RuntimeError(
                f"could not restore step checkpoints for {name!r} with "
                "ema_decay set: they were written without EMA; finish the "
                "run with ema_decay=0 or start a fresh checkpoint dir")
        params, opt_state = restored["params"], restored["opt_state"]
        if ema_decay:
            ema = restored["ema_params"]
    all_losses = []
    chunk_end = 0
    for c, length in enumerate(_chunk_lengths(steps, steps_per_scan)):
        chunk_end += length
        if chunk_end <= start_step:  # the checkpoint covers this chunk
            continue
        params, opt_state, ema, losses = run_chunk(
            params, opt_state, ema, draws.fold_in(c), images, labels,
            length=length)
        all_losses.append(losses)
        state = {"params": params, "opt_state": opt_state,
                 "step": chunk_end, "key": seed}
        if ema_decay:
            state["ema_params"] = ema
        ckpt_mgr.save_step(name, state, chunk_end, keep=keep)
    losses = (torch.cat(all_losses) if all_losses
              else torch.zeros((0,), device=images.device))
    return (ema if ema_decay else params), losses


def one_step_denoise_val(apply_fn, params: Params, schedule: VPSchedule,
                         key: Key, shape: Tuple[int, ...],
                         t_val: float = 0.9,
                         labels: Tuple[torch.Tensor, ...] = (),
                         device="cpu") -> torch.Tensor:
    """A quick smoke validation: noise -> q_t at ``t_val`` -> the one-step
    x0 estimate (x_t - sigma eps_hat) / alpha, clipped to [-1, 1]."""
    k1, k2 = as_draws(key, device).split(2)
    noise = k1.normal(shape)
    t = torch.full((shape[0],), t_val, device=noise.device)
    xt, _ = schedule.q_t(noise, t, eps=k2.normal(shape))
    eps_hat = apply_fn(params, xt, t, *labels)
    a = schedule.alpha(t).reshape(-1, 1, 1, 1)
    s = schedule.sigma(t).reshape(-1, 1, 1, 1)
    return torch.clamp((xt - s * eps_hat) / a, -1.0, 1.0)
