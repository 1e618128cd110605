"""GEMM-based algorithms: Logistic Regression and linear SVM (paper §4.2).

Inference follows Fig. 4: OP1 column-wise partial matvec into the shared
R array, OP2 row-wise combine with the bias (both in
``distribution.two_phase_matvec``, for a batch of queries at once), then
OP3, the activation (softmax / sign) and the ArgMax; ties go to the first
class, as ``jnp.argmax`` does.

Training (offline with scikit-learn in the paper) is full-batch gradient
descent with ``torch.autograd``, the JAX package's losses and
hyper-parameters: softmax cross-entropy with weight decay for LR, the
squared hinge one-vs-all with global-norm clipping for SVM.  The descent
(``_descend_lr``, ``_descend_svm``) is split from the initialisation so
that it can start from any weights, the JAX package's included.

Counterpart of the JAX package's ``core/gemm_based.py``.  No Pallas kernel
backs it there: the products are plain matrix products, here too.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.distribution import two_phase_matvec
from repro_torch.device import DeviceLike, resolve_device


class LinearModel(NamedTuple):
    W: torch.Tensor   # (n_class, d)
    b: torch.Tensor   # (n_class,)


def _queries(model: LinearModel, X) -> torch.Tensor:
    """Queries as float32 on the model's device."""
    if isinstance(X, np.ndarray):
        X = torch.from_numpy(np.ascontiguousarray(X))
    return torch.as_tensor(X, device=model.W.device).to(torch.float32)


# ---------------------------------------------------------------------------
# Inference (paper Fig. 4)
# ---------------------------------------------------------------------------


def lr_decision(model: LinearModel, x, n_cores: int = 8):
    """LR: OP1+OP2 two-phase matvec, OP3 softmax + argmax.  x: (d,) or
    (B, d).  Returns (class int32, probabilities (..., C))."""
    y = two_phase_matvec(model.W, _queries(model, x), model.b,
                         n_cores)                      # OP1 + OP2
    probs = torch.softmax(y, dim=-1)                   # OP3
    return torch.argmax(probs, dim=-1).to(torch.int32), probs


def svm_decision(model: LinearModel, x, n_cores: int = 8):
    """SVM: OP1+OP2 two-phase matvec, OP3 sign / argmax (one-vs-all).
    Returns (class int32, signs (..., C))."""
    y = two_phase_matvec(model.W, _queries(model, x), model.b, n_cores)
    return torch.argmax(y, dim=-1).to(torch.int32), torch.sign(y)


def lr_predict_batch(model: LinearModel, X, n_cores: int = 8):
    """X (B, d) -> classes (B,)."""
    return lr_decision(model, X, n_cores)[0]


def svm_predict_batch(model: LinearModel, X, n_cores: int = 8):
    """X (B, d) -> classes (B,)."""
    return svm_decision(model, X, n_cores)[0]


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def init_linear(generator: torch.Generator, n_class: int, d: int, *,
                device: DeviceLike = None) -> LinearModel:
    """W ~ N(0, 0.01²) drawn from ``generator`` (on its own device, so a
    seed gives the same weights wherever they land), b = 0."""
    W = torch.randn((n_class, d), generator=generator,
                    device=generator.device) * 0.01
    dev = resolve_device(device)
    return LinearModel(W=W.to(dev),
                       b=torch.zeros((n_class,), device=dev))


def _data(X, y, device: torch.device):
    if isinstance(X, np.ndarray):
        X = torch.from_numpy(np.ascontiguousarray(X))
    if isinstance(y, np.ndarray):
        y = torch.from_numpy(np.ascontiguousarray(y))
    return (torch.as_tensor(X, device=device).to(torch.float32),
            torch.as_tensor(y, device=device).long())


def _descend_lr(model: LinearModel, X: torch.Tensor, y: torch.Tensor,
                n_class: int, *, steps: int = 300, lr: float = 0.5,
                weight_decay: float = 1e-4) -> LinearModel:
    """``steps`` full-batch gradient steps of softmax cross-entropy plus
    ``weight_decay``·‖W‖², from ``model``."""
    onehot = F.one_hot(y, n_class).to(torch.float32)
    W = model.W.detach().clone().requires_grad_(True)
    b = model.b.detach().clone().requires_grad_(True)
    for _ in range(steps):
        logp = torch.log_softmax(X @ W.T + b, dim=-1)
        loss = -torch.mean(torch.sum(onehot * logp, dim=-1)) + \
            weight_decay * torch.sum(W ** 2)
        gW, gb = torch.autograd.grad(loss, (W, b))
        with torch.no_grad():
            W -= lr * gW
            b -= lr * gb
    return LinearModel(W=W.detach(), b=b.detach())


def _descend_svm(model: LinearModel, X: torch.Tensor, y: torch.Tensor,
                 n_class: int, *, steps: int = 300, lr: float = 0.02,
                 C: float = 1.0, grad_clip: float = 10.0) -> LinearModel:
    """``steps`` full-batch gradient steps of the one-vs-all squared hinge
    plus ‖W‖²/(2N), each scaled so the gradient's global norm is at most
    ``grad_clip``, from ``model``."""
    targets = 2.0 * F.one_hot(y, n_class).to(torch.float32) - 1.0
    W = model.W.detach().clone().requires_grad_(True)
    b = model.b.detach().clone().requires_grad_(True)
    for _ in range(steps):
        scores = X @ W.T + b                               # (N, C)
        margins = torch.clamp(1.0 - targets * scores, min=0.0)
        loss = C * torch.mean(torch.sum(margins ** 2, dim=-1)) + \
            0.5 * torch.sum(W ** 2) / X.shape[0]
        gW, gb = torch.autograd.grad(loss, (W, b))
        with torch.no_grad():
            gn = torch.sqrt(torch.sum(gW ** 2) + torch.sum(gb ** 2))
            scale = torch.clamp(grad_clip / (gn + 1e-9), max=1.0)
            W -= lr * scale * gW
            b -= lr * scale * gb
    return LinearModel(W=W.detach(), b=b.detach())


def train_lr(X, y, n_class: int, *, steps: int = 300, lr: float = 0.5,
             weight_decay: float = 1e-4,
             generator: Optional[torch.Generator] = None,
             device: DeviceLike = None) -> LinearModel:
    """Full-batch softmax regression on ``device`` (the card unless "cpu"
    is named), from ``init_linear(generator)`` (default seed 0)."""
    dev = resolve_device(device)
    X, y = _data(X, y, dev)
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    model = init_linear(gen, n_class, X.shape[1], device=dev)
    return _descend_lr(model, X, y, n_class, steps=steps, lr=lr,
                       weight_decay=weight_decay)


def train_svm(X, y, n_class: int, *, steps: int = 300, lr: float = 0.02,
              C: float = 1.0, grad_clip: float = 10.0,
              generator: Optional[torch.Generator] = None,
              device: DeviceLike = None) -> LinearModel:
    """One-vs-all linear SVM with the squared hinge (norm-clipped descent
    keeps it stable at high d), on ``device``, from
    ``init_linear(generator)`` (default seed 0)."""
    dev = resolve_device(device)
    X, y = _data(X, y, dev)
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    model = init_linear(gen, n_class, X.shape[1], device=dev)
    return _descend_svm(model, X, y, n_class, steps=steps, lr=lr, C=C,
                        grad_clip=grad_clip)
