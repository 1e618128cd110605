"""train_step / serve_step factories of the port.

Counterpart of the JAX package's ``training/trainer.py``.  ``make_train_step``
builds a closure: CE loss (+ MoE aux), gradients by autograd (B10 and B11
take their autograd forms, whose backward passes are B10 and B12;
``kernels/autograd.py``), gradient accumulation over microbatches in fp32,
optional int8 compression with error feedback, global-norm clipping and
AdamW.  PyTorch runs eagerly, so a Python loop over the microbatches takes
the place of ``lax.scan``.

As the reference does under microbatches, the step's metrics then report
the mean total loss as ``ce`` and a zero ``aux`` (its ``parts``).

The step writes the params, the moments and the residual IN PLACE
(``training/optimizer.py``, ``training/grad_compression.py``) and returns
them; the reference returns new arrays.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import transformer
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.grad_compression import (compress_tree,
                                                   decompress_tree)


class CompressedOptState(NamedTuple):
    """Optimizer state + the error-feedback residual tree.

    The int8 grad-compression scheme is only convergent when the
    quantisation error of step t is added back into the gradient of step
    t+1, so the residual must survive across steps: it rides in the
    opt_state slot, which every driver threads through ``train_step`` and
    checkpoints."""

    adam: opt_mod.AdamState
    resid: Any


def init_opt_state(params, train_cfg: TrainConfig):
    """Optimizer state for ``make_train_step``: plain AdamState, or
    AdamState + a zero error-feedback residual when compression is on."""
    adam = opt_mod.init_opt_state(params)
    if train_cfg.grad_compression == "int8":
        resid = T.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params)
        return CompressedOptState(adam=adam, resid=resid)
    return adam


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean CE over all positions. logits (..., V); targets (...) int."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.long()[..., None])[..., 0]
    nll = logz - gold
    if label_smoothing:
        smooth = logz - logits.mean(-1)
        nll = (1 - label_smoothing) * nll + label_smoothing * smooth
    return nll.mean()


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            train_cfg: TrainConfig, path: Optional[str] = None, plan=None):
    """(ce + the MoE balance coefficient x aux, {"ce", "aux"}) of a batch
    {tokens (B, S), targets (B, S)}; ``plan`` as in
    ``transformer.forward``."""
    logits, aux = transformer.forward(params, batch["tokens"], cfg,
                                      remat=train_cfg.remat, path=path,
                                      plan=plan)
    ce = cross_entropy(logits, batch["targets"], train_cfg.label_smoothing)
    moe_coef = cfg.moe.load_balance_coef if cfg.moe else 0.0
    return ce + moe_coef * aux, {"ce": ce, "aux": aux}


def loss_and_grads(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                   train_cfg: TrainConfig, path: Optional[str] = None,
                   plan=None):
    """(loss, {"ce", "aux"}, gradient tree) of ``loss_fn``, each gradient
    in its param's dtype.  The params themselves are left untouched: the
    graph is built on detached views of them that require gradients."""
    flat = T.leaves(params)
    views = [p.detach().requires_grad_() for p in flat]
    with torch.enable_grad():
        loss, parts = loss_fn(T.unflatten(params, iter(views)), batch, cfg,
                              train_cfg, path, plan)
        grads = torch.autograd.grad(loss, views, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return (loss.detach(), {k: v.detach() for k, v in parts.items()},
            T.unflatten(params, iter(grads)))


def _split_microbatches(batch: Dict[str, torch.Tensor], n: int):
    def split(x):
        B = x.shape[0]
        assert B % n == 0, (B, n)
        return x.reshape((n, B // n) + tuple(x.shape[1:]))
    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def make_train_step(cfg: ModelConfig, train_cfg: TrainConfig,
                    path: Optional[str] = None, plan=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics), batch {tokens, targets} on the params' device; ``plan`` (a
    ``ParallelPlan``) runs the MoE layers two-phase."""

    def train_step(params, opt_state, batch):
        n_mb = train_cfg.microbatches
        if n_mb > 1:
            acc = T.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)
            loss = 0.0
            for mb in _split_microbatches(batch, n_mb):
                mb_loss, _parts, grads = loss_and_grads(params, mb, cfg,
                                                        train_cfg, path, plan)
                for a, g in zip(T.leaves(acc), T.leaves(grads)):
                    a.add_(g.to(torch.float32) / n_mb)
                loss = loss + mb_loss / n_mb
                del grads
            grads = acc
            parts = {"ce": loss, "aux": torch.zeros_like(loss)}
        else:
            loss, parts, grads = loss_and_grads(params, batch, cfg,
                                                train_cfg, path, plan)

        if train_cfg.grad_compression == "int8":
            adam, resid = opt_state
            qtree, resid = compress_tree(grads, resid)
            del grads
            grads = decompress_tree(qtree)
            del qtree
            params, adam, stats = opt_mod.adamw_update(
                params, grads, adam, train_cfg)
            opt_state = CompressedOptState(adam=adam, resid=resid)
        else:
            params, opt_state, stats = opt_mod.adamw_update(
                params, grads, opt_state, train_cfg)
        metrics = {"loss": loss, **parts, **stats}
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, max_seq: Optional[int] = None,
                      path: Optional[str] = None, plan=None):
    def prefill_step(params, batch):
        return transformer.prefill(params, batch["tokens"], cfg,
                                   max_seq=max_seq, path=path, plan=plan)
    return prefill_step


def make_decode_step(cfg: ModelConfig, path: Optional[str] = None,
                     plan=None):
    def serve_step(params, cache, tokens):
        return transformer.decode_step(params, cache, tokens, cfg, path=path,
                                       plan=plan)
    return serve_step
