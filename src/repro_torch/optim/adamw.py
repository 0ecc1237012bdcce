"""AdamW + LR schedules + global-norm clipping — the port of
``repro.optim.adamw``.

Parameters, gradients and moments are nested dicts of tensors (the
port's parameter tree). The update is functional: it returns new trees
and never writes into the ones it was given. The arithmetic and its
order are the reference's: float32 moments (or ``opt_dtype``), bias
corrections from the incremented step, and
``p_new = (p.f32 - lr·(m̂/(√v̂ + eps) + wd·p.f32)).to(p.dtype)``. A frozen
leaf (``trainable`` False) keeps p, m and v unchanged, bit for bit.
``step`` and the learning rate stay tensors on the parameters' device,
so a step never waits on the host.

Placed leaves (``runtime/placement``: DTensors on a ``("data", "model")``
mesh) are updated chunk by chunk, their moments placed like them (the
reference's ZeRO state "inherits the same specs"). :func:`global_norm`
sums each leaf's squares over the mesh dims it is sharded on and over no
other, then over leaves in the reference's order. A step given placed
parameters takes this rank's rows of the global batch (and of the draws),
gathers each weight on use and hands AdamW each chunk's gradient summed
over the data axes (``runtime/placement.py``).
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models.common import dtype_of, tree_leaves, tree_map
from repro_torch.runtime import placement as plc
from repro_torch.runtime.sharding import use_mesh

Params = Any


def init_opt_state(params: Params,
                   opt_dtype: Union[str, torch.dtype] = torch.float32) -> Dict:
    dt = dtype_of(opt_dtype) if isinstance(opt_dtype, str) else opt_dtype
    dev = plc.local(tree_leaves(params)[0]).device
    zeros = lambda p: plc.map_local(
        lambda l: torch.zeros(l.shape, dtype=dt, device=l.device), p)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def lr_at(tc: TrainConfig, step: Any) -> torch.Tensor:
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp((step + 1.0) / max(1, tc.warmup_steps), max=1.0)
    frac = torch.clamp((step - tc.warmup_steps)
                       / max(1, tc.total_steps - tc.warmup_steps), 0.0, 1.0)
    if tc.schedule == "cosine":
        decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
    elif tc.schedule == "linear":
        decay = 1.0 - frac
    else:
        decay = torch.ones_like(frac)
    return tc.learning_rate * warm * decay


def global_norm(tree: Params) -> torch.Tensor:
    leaves = tree_leaves(tree)
    sq = plc.sum_over_shards([torch.sum(torch.square(plc.local(x).float()))
                              for x in leaves], leaves)
    total = 0
    for s in sq:                    # summed in leaf order, as the reference
        total = total + s
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(grads: Params, max_norm: float
                        ) -> Tuple[Params, torch.Tensor]:
    g = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-12), max=1.0)
    return tree_map(lambda x: plc.map_local(
        lambda l: (l.float() * scale).to(l.dtype), x), grads), g


def adamw_update(params: Params, grads: Params, opt_state: Dict,
                 tc: TrainConfig, trainable: Optional[Params] = None
                 ) -> Tuple[Params, Dict, Dict[str, torch.Tensor]]:
    """One AdamW step. ``trainable``: optional tree of bools (or bool
    tensors) freezing leaves (the FlexiDiT LoRA recipe)."""
    step = opt_state["step"] + 1
    lr = lr_at(tc, step)
    if tc.grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, tc.grad_clip)
    else:
        gnorm = global_norm(grads)
    b1, b2, eps = tc.beta1, tc.beta2, tc.eps
    c1 = 1.0 - torch.pow(b1, step.float())
    c2 = 1.0 - torch.pow(b2, step.float())

    def upd(p, g, m, v, t=True):
        if t is False:                          # a frozen leaf: untouched
            return p, m, v
        if plc.is_placed(p):                    # chunk by chunk
            out = upd(p.to_local(), *(plc.local(x) for x in (g, m, v, t)))
            return tuple(plc.wrap(o, p) for o in out)
        gf = g.float()
        m_new = b1 * m.float() + (1 - b1) * gf
        v_new = b2 * v.float() + (1 - b2) * gf * gf
        mh = m_new / c1
        vh = v_new / c2
        delta = lr * (mh / (torch.sqrt(vh) + eps) + tc.weight_decay * p.float())
        p_new = (p.float() - delta).to(p.dtype)
        if t is not True:                       # a bool tensor
            keep = torch.as_tensor(t, dtype=torch.bool, device=p.device)
            p_new = torch.where(keep, p_new, p)
            m_new = torch.where(keep, m_new, m.float())
            v_new = torch.where(keep, v_new, v.float())
        return p_new, m_new.to(m.dtype), v_new.to(v.dtype)

    rest = (grads, opt_state["m"], opt_state["v"])
    if trainable is not None:
        rest += (trainable,)
    out = tree_map(upd, params, *rest)
    pick = lambda i: tree_map(lambda _p, o: o[i], params, out)
    new_state = {"m": pick(1), "v": pick(2), "step": step}
    return pick(0), new_state, {"lr": lr, "grad_norm": gnorm}


def value_and_grad(loss_fn: Callable[..., Tuple[torch.Tensor, Dict]],
                   params: Params, *args: Any, stacked: Any = None, **kw: Any
                   ) -> Tuple[Tuple[torch.Tensor, Dict], Params]:
    """``jax.value_and_grad(loss_fn, has_aux=True)(params, ...)`` on the
    port's tree: ``((loss, aux), grads)``, every floating leaf
    differentiated (a leaf the loss does not reach gets zeros), all
    returned detached.

    Placed leaves: the loss runs under their mesh (``use_mesh``) on a view
    that gathers each leaf on use (``placement.gathered``; ``stacked``, a
    tree of bools, marks the ``[L, ...]`` leaves gathered one layer at a
    time), and each gradient comes back placed like its leaf."""
    leaves: List[torch.Tensor] = []

    def track(p):
        p = plc.local(p)
        if not p.is_floating_point():
            return p
        leaf = p.detach().requires_grad_(True)
        leaves.append(leaf)
        return leaf

    mesh = plc.placed_mesh(params)
    with torch.enable_grad(), \
            (use_mesh(mesh) if mesh is not None else contextlib.nullcontext()):
        tracked = tree_map(track, params)
        view = (tracked if mesh is None
                else plc.gathered(tracked, params, stacked))
        loss, aux = loss_fn(view, *args, **kw)
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_id = {id(l): g if g is not None else torch.zeros_like(l)
             for l, g in zip(leaves, got)}

    def grad_of(t, p):
        g = by_id.get(id(t), torch.zeros_like(t))
        return plc.wrap(g, p) if plc.is_placed(p) else g

    grads = tree_map(grad_of, tracked, params)
    aux = {k: v.detach() if torch.is_tensor(v) else v for k, v in aux.items()}
    return (loss.detach(), aux), grads


class TrainStep:
    """``(params, opt_state, batch, generator) → (params, opt_state,
    metrics)``: draw the step's randomness from ``generator`` (``draw``),
    take gradients of ``loss_fn(params, batch, **draws)``, then AdamW.

    The draws are the loss's arguments, so a caller may hand in its own
    (``with_draws``), for example another package's draws. A step that
    draws nothing (the language models') needs no generator.

    With placed parameters the batch and the draws are the global ones,
    the same on every rank (drawn from one seed for the whole batch): the
    step takes this rank's rows of both. ``stacked`` (a tree of bools, set
    by the step builders from the model's schema) marks the leaves
    gathered one layer at a time.
    """

    def __init__(self, loss_fn: Callable[..., Tuple[torch.Tensor, Dict]],
                 draw: Callable[[Dict, torch.Generator], Dict],
                 tc: TrainConfig, trainable: Optional[Params] = None,
                 stacked: Any = None):
        self.loss_fn = loss_fn
        self.draw = draw
        self.tc = tc
        self.trainable = trainable
        self.stacked = stacked

    def loss_and_grads(self, params: Params, batch: Dict, **draws: Any
                       ) -> Tuple[Tuple[torch.Tensor, Dict], Params]:
        return value_and_grad(self.loss_fn, params, batch,
                              stacked=self.stacked, **draws)

    def grads(self, params: Params, batch: Dict, **draws: Any
              ) -> Tuple[Tuple[torch.Tensor, Dict], Params]:
        """``((loss, metrics), grads)`` of the global batch; with placed
        parameters computed on this rank's rows (of the draws too)."""
        mesh = plc.placed_mesh(params)
        if mesh is not None:
            rows = next(v.shape[0] for v in tree_leaves(batch)
                        if torch.is_tensor(v) and v.dim() > 0)
            batch = plc.take_rows(batch, rows, mesh)
            draws = {k: plc.take_rows(v, rows, mesh) for k, v in draws.items()}
        return self.loss_and_grads(params, batch, **draws)

    def with_draws(self, params: Params, opt_state: Dict, batch: Dict,
                   **draws: Any) -> Tuple[Params, Dict, Dict]:
        (_loss, metrics), grads = self.grads(params, batch, **draws)
        params, opt_state, om = adamw_update(params, grads, opt_state,
                                             self.tc, self.trainable)
        return params, opt_state, {**metrics, **om}

    def __call__(self, params: Params, opt_state: Dict, batch: Dict,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[Params, Dict, Dict]:
        return self.with_draws(params, opt_state, batch,
                               **self.draw(batch, generator))
