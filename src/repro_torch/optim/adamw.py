"""AdamW + LR schedules + global-norm clipping — the port of
``repro.optim.adamw``.

Parameters, gradients and moments are nested dicts of tensors (the
port's parameter tree). The update is in place, the counterpart of the
reference planner's ``jax.jit(step, donate_argnums=(0, 1))``: it writes
p, m, v and ``step`` into the trees it is handed and returns those same
objects; a caller that needs the old values copies them first. The
arithmetic and its order are the reference's (and the functional
update's this one replaced, bit for bit): float32 moments (or
``opt_dtype``), bias corrections from the incremented step, and
``p_new = (p.f32 - lr·(m̂/(√v̂ + eps) + wd·p.f32)).to(p.dtype)``; a float32
moment or parameter is computed in its own storage, any other in a
float32 copy written back once. A frozen leaf (``trainable`` False)
keeps p, m and v unchanged, bit for bit. ``step`` and the learning rate
stay tensors on the parameters' device, so a step never waits on the
host.

:class:`TrainStep` is a ``runtime.graphs`` runner (the counterpart of
``train.py``'s ``jax.jit`` of the step): on the card one CUDA graph per
step object, parameter tree and optimizer state (by identity, both
donated) and batch / draw shape; the draws are made on the host side and
copied in with the batch.

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
from repro_torch.runtime import graphs
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


def _work(x: torch.Tensor, keep: Optional[torch.Tensor]) -> torch.Tensor:
    """Where a leaf's new float32 value is computed: in ``x`` itself when
    it is float32 and unmasked, else in a float32 copy."""
    if x.dtype == torch.float32 and keep is None:
        return x
    return x.to(torch.float32, copy=True)


def adamw_update(params: Params, grads: Params, opt_state: Dict,
                 tc: TrainConfig, trainable: Optional[Params] = None
                 ) -> Tuple[Params, Dict, Dict[str, torch.Tensor]]:
    """One AdamW step written into ``params`` and ``opt_state`` (returned,
    the caller's objects). ``trainable``: optional tree of bools (or bool
    tensors on the parameters' device) freezing leaves (the FlexiDiT
    LoRA recipe)."""
    step = opt_state["step"].add_(1)
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
            return
        if plc.is_placed(p):                    # chunk by chunk
            upd(p.to_local(), *(plc.local(x) for x in (g, m, v, t)))
            return
        gf = g.float()
        keep = (None if t is True
                else torch.as_tensor(t, dtype=torch.bool, device=p.device))
        m_new = _work(m, keep).mul_(b1).add_(gf * (1 - b1))
        v_new = _work(v, keep).mul_(b2).add_(gf.mul(1 - b2).mul_(gf))
        den = (v_new / c2).sqrt_().add_(eps)
        delta = (m_new / c1).div_(den).add_(p.float() * tc.weight_decay).mul_(lr)
        p_new = _work(p, keep).sub_(delta)
        if keep is not None:
            p_new = torch.where(keep, p_new.to(p.dtype), p)
            m_new = torch.where(keep, m_new, m.float())
            v_new = torch.where(keep, v_new, v.float())
        for x, new in ((p, p_new), (m, m_new), (v, v_new)):
            if new is not x:
                x.copy_(new)

    rest = (grads, opt_state["m"], opt_state["v"])
    if trainable is not None:
        rest += (trainable,)
    tree_map(upd, params, *rest)
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}


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


class TrainStep(graphs.Captured):
    """``(params, opt_state, batch, generator) → (params, opt_state,
    metrics)``: draw the step's randomness from ``generator`` (``draw``),
    take gradients of ``loss_fn(params, batch, **draws)``, then AdamW,
    written into ``params`` and ``opt_state`` (both donated: returned as
    the caller's objects, updated in place).

    The draws are the loss's arguments, so a caller may hand in its own
    (``with_draws``), for example another package's draws. A step that
    draws nothing (the language models') needs no generator.

    The step is a ``runtime.graphs`` runner with ``donate=(0, 1)``: the
    draws are made eagerly on the host side (:meth:`split`) and copied,
    like the batch, into the graph's static buffers; the body
    (:meth:`update`) takes the gradients and writes AdamW's update. On the
    card one CUDA graph per key: this step object, the identity of the
    parameter tree and of the optimizer state, the batch's and the draws'
    shapes, and a ``trainable`` mask of Python bools by value (bool
    tensors are copied in). The metrics come back cloned. A call on
    another tree or state (a restore, a fresh copy) drops the graphs of
    the old ones before it captures, as they are dead after a step: the
    step object holds one tree's graphs, one a batch shape, and frees
    them when it goes.

    With placed parameters the batch and the draws are the global ones,
    the same on every rank (drawn from one seed for the whole batch): the
    step takes this rank's rows of both, and runs eagerly (Gloo
    collectives cannot be captured), under the same in-place contract.
    ``stacked`` (a tree of bools, set by the step builders from the
    model's schema) marks the leaves gathered one layer at a time.
    """

    one_tree = True                 # graphs.Captured: one tree's graphs

    def __init__(self, loss_fn: Callable[..., Tuple[torch.Tensor, Dict]],
                 draw: Callable[[Dict, torch.Generator], Dict],
                 tc: TrainConfig, trainable: Optional[Params] = None,
                 stacked: Any = None, name: str = "train_step"):
        super().__init__(None, name=name, donate=(0, 1))
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

    def update(self, params: Params, opt_state: Dict, batch: Dict,  # repro: traced
               draws: Dict, trainable: Optional[Params]
               ) -> Tuple[Params, Dict, Dict]:
        """The captured body: gradients, then AdamW in place."""
        (_loss, metrics), grads = self.grads(params, batch, **draws)
        params, opt_state, om = adamw_update(params, grads, opt_state,
                                             self.tc, trainable)
        return params, opt_state, {**metrics, **om}

    def split(self, params: Params, opt_state: Dict, batch: Dict,
              generator: Optional[torch.Generator] = None, *,
              draws: Optional[Dict] = None) -> Tuple[Any, Tuple[Any, ...]]:
        """The host side: the draws (unless handed in) and the mask on the
        parameters' device, outside the captured region."""
        leaves = tree_leaves(params)
        if len({id(x) for x in leaves}) != len(leaves):
            raise ValueError(f"{self.name}: a tensor appears twice in the "
                             f"parameter tree, and the update is written in "
                             f"place: copy one of them")
        if draws is None:
            draws = self.draw(batch, generator)
        mask = self.trainable
        if mask is not None:
            dev = plc.local(leaves[0]).device
            mask = tree_map(lambda t: t.to(dev) if torch.is_tensor(t) else t,
                            mask)
        return (), (params, opt_state, batch, draws, mask)

    def _body(self, static: Any, args: Tuple[Any, ...]) -> Any:
        return self.update(*args)

    def with_draws(self, params: Params, opt_state: Dict, batch: Dict,
                   **draws: Any) -> Tuple[Params, Dict, Dict]:
        return self(params, opt_state, batch, draws=draws)

    def __call__(self, params: Params, opt_state: Dict, batch: Dict,
                 generator: Optional[torch.Generator] = None, *,
                 draws: Optional[Dict] = None) -> Tuple[Params, Dict, Dict]:
        if plc.placed_mesh(params) is not None:
            return self.eager(params, opt_state, batch, generator, draws=draws)
        return super().__call__(params, opt_state, batch, generator,
                                draws=draws)
